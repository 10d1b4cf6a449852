"""orient_ms: the host orientation pass (the program's stage "orient"),
mean milliseconds per request of the window."""


def read(r):
    return r.stage_ms_per_request("orient")
