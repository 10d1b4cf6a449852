"""nrgba_ms: the pipeline's host passes before the search (the program's
stages "validate" and "nrgba"), mean milliseconds per request of the
window."""

STAGES = ("validate", "nrgba")


def read(r):
    seconds = [r.stages[s] for s in STAGES if s in r.stages]
    if not seconds or not r.requests:
        return None
    return 1e3 * sum(seconds) / r.requests
