"""chunk_device_ms: one chunk through the device (the program's stage
"device": upload, forward DCT, seven lockstep probes, quantization,
emission and the pulls, until the chunk's streams finish), mean
milliseconds per chunk of the window (the chunks the batch counters
recorded)."""


def read(r):
    seconds = r.stages.get("device")
    chunks = len((r.counters or {}).get("chunk_items", []))
    if seconds is None or not chunks:
        return None
    return 1e3 * seconds / chunks
