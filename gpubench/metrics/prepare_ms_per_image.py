"""prepare_ms_per_image: the batch engine's serial pass over a call's
images before any chunk (the program's stage "batch prepare": validate,
NRGBA copy), mean milliseconds per image of the window."""


def read(r):
    seconds = r.stages.get("batch prepare")
    if seconds is None or not r.images:
        return None
    return 1e3 * seconds / r.images
