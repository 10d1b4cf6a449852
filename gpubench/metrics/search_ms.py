"""search_ms: the quality search (the program's stage "jpeg quality
search": forward DCT, seven probes, emission), mean milliseconds per
request of the window."""


def read(r):
    return r.stage_ms_per_request("jpeg quality search")
