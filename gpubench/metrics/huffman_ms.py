"""huffman_ms: the host entropy decode (the program's stage "huffman
decode", inside "open + decode"), mean milliseconds per request of the
window."""

STAGES = ("huffman decode",)


def read(r):
    seconds = [r.stages[s] for s in STAGES if s in r.stages]
    if not seconds or not r.requests:
        return None
    return 1e3 * sum(seconds) / r.requests
