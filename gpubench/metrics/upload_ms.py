"""upload_ms: the copies to the card (the program's stages "blocks up",
the decode's int16 blocks and tables, and "image up", the search's
NRGBA image as float32), mean milliseconds per request of the window."""

STAGES = ("blocks up", "image up")


def read(r):
    seconds = [r.stages[s] for s in STAGES if s in r.stages]
    if not seconds or not r.requests:
        return None
    return 1e3 * sum(seconds) / r.requests
