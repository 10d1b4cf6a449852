"""fill_ms_per_image: a chunk's pinned RGB stack filled on the batch
engine's prep thread (the program's stage "prep"), mean milliseconds per
image of the window."""


def read(r):
    seconds = r.stages.get("prep")
    if seconds is None or not r.images:
        return None
    return 1e3 * seconds / r.images
