"""decode_ms: the host decode (the program's stage "open + decode"),
mean milliseconds per request of the window."""


def read(r):
    return r.stage_ms_per_request("open + decode")
