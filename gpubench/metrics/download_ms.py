"""download_ms: the decoded image's copy to the host (the program's stage
"image down": K7's launch and the copy, which waits for K7), mean
milliseconds per request of the window."""

STAGES = ("image down",)


def read(r):
    seconds = [r.stages[s] for s in STAGES if s in r.stages]
    if not seconds or not r.requests:
        return None
    return 1e3 * sum(seconds) / r.requests
