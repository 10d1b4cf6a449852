"""encode_ms_per_image: each item's container on the batch engine's
encode pool (the program's stage "encode", summed over the pool's
threads), mean milliseconds per image of the window."""


def read(r):
    seconds = r.stages.get("encode")
    if seconds is None or not r.images:
        return None
    return 1e3 * seconds / r.images
