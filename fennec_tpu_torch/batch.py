"""Batch compression of files (reference batch.go:58-166); counterpart of
fennec_tpu/batch.py.

compress_batch keeps input order, captures one error per bad item (one
bad file never aborts the batch), honours cooperative cancellation and
reports progress.  Homogeneous batches (no per-item options) go through
the device engines of engine/batched.py: in standard mode with JPEG
output every upright JPEG that qualifies takes the coefficient path,
grouped by geometry; the rest (PNGs, progressive, multi-scan and
EXIF-rotated files), and every file in target-size mode, are decoded on
the host and take the pixel path.  Otherwise, or when the fused path
fails for a reason other than an item or the device, a per-file worker
pool runs compress_file on the same device.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

from . import device as _device
from .api import compress_file
from .engine.batched import FusedChunkError, counters
from .types import (
    CanceledError,
    Context,
    Format,
    Options,
    Result,
    human_bytes,
)


@dataclasses.dataclass
class BatchItem:
    """One file to compress (reference batch.go:11-18)."""

    src: str
    dst: str
    opts: Optional[Options] = None


@dataclasses.dataclass
class BatchResult:
    """Result for a single batch item (reference batch.go:21-30)."""

    item: BatchItem
    result: Optional[Result] = None
    err: Optional[Exception] = None
    index: int = 0


@dataclasses.dataclass
class BatchOptions:
    """Batch configuration (reference batch.go:33-41).

    fused: None (auto) routes homogeneous batches of 8+ items through
    the device engines (engine/batched.py); True forces
    them for homogeneous batches (no per-item opts: a lockstep search
    needs one Options for the whole batch, so heterogeneous batches
    always use the per-file pool); False forces the per-file pool.
    """

    workers: int = 0  # 0 = os.cpu_count()
    default_opts: Options = dataclasses.field(default_factory=Options)
    on_item: Optional[Callable[[int, int], None]] = None
    fused: Optional[bool] = None
    # Resume support: skip items whose dst already exists and is
    # non-empty.
    skip_existing: bool = False


def compress_batch(ctx: Optional[Context], items: List[BatchItem],
                   batch_opts: Optional[BatchOptions] = None,
                   device: _device.MeshLike = None) -> List[BatchResult]:
    """Compress many files on `device`; results keep input order
    (reference batch.go:58-128).  Cancellation skips not-yet-started
    items (they get the context error); in-flight items finish.

    `device` may be a sequence of devices: the device engines spread
    their chunks over it (engine/batched.py), and with None a node with
    two or more cards spreads them over all of its cards (FENNEC_MESH=0
    turns that off).  The per-file pool and the per-image decode run on
    one device, a sequence's first."""
    if not items:
        return []
    batch_opts = batch_opts or BatchOptions()

    homogeneous = all(it.opts is None for it in items)
    use_fused = batch_opts.fused
    if use_fused is None:
        use_fused = homogeneous and len(items) >= 8
    if use_fused and homogeneous:
        return _compress_batch_fused(ctx, items, batch_opts, device)

    workers = batch_opts.workers if batch_opts.workers > 0 \
        else (os.cpu_count() or 1)
    workers = min(workers, len(items))

    results: List[Optional[BatchResult]] = [None] * len(items)
    completed = 0
    lock = threading.Lock()

    def work(idx: int) -> None:
        nonlocal completed
        item = items[idx]
        if ctx is not None and ctx.done():
            results[idx] = BatchResult(item=item, err=ctx.err(), index=idx)
            return
        if batch_opts.skip_existing and _dst_done(item.dst):
            results[idx] = BatchResult(item=item, result=None, index=idx)
            return
        item_opts = item.opts if item.opts is not None \
            else batch_opts.default_opts
        try:
            res = compress_file(ctx, item.src, item.dst, item_opts,
                                _one_device(device))
            results[idx] = BatchResult(item=item, result=res, index=idx)
        except Exception as e:  # per-item capture (batch.go:108-113)
            results[idx] = BatchResult(item=item, err=e, index=idx)
        counters.add_route("pool")
        if batch_opts.on_item is not None:
            with lock:
                completed += 1
                c = completed
            batch_opts.on_item(c, len(items))

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(work, range(len(items))))

    return [r for r in results if r is not None]


def _one_device(device: _device.MeshLike) -> _device.DeviceLike:
    """Where the parts of a batch that run on one device go: a mesh's
    first device, else `device` itself."""
    return device[0] if isinstance(device, (list, tuple)) else device


def _dst_done(dst: str) -> bool:
    try:
        return os.path.getsize(dst) > 0
    except OSError:
        return False


def _compress_batch_fused(ctx: Optional[Context], items: List[BatchItem],
                          batch_opts: BatchOptions,
                          device: _device.MeshLike) -> List[BatchResult]:
    """Parallel file reads → the device engines → streamed writes."""
    from .codecs import decode_image
    from .engine.batched import (
        compress_images_batched,
        compress_jpeg_bytes_batched,
        qualify_jpeg_bytes,
    )
    from .exif import Orientation, apply_orientation, read_orientation
    from .image import to_nrgba

    opts = batch_opts.default_opts
    n = len(items)
    results = [BatchResult(item=it, index=i) for i, it in enumerate(items)]
    raw: List[Optional[bytes]] = [None] * n
    orients = [1] * n
    sizes = [0] * n
    skipped = [False] * n
    # The engines stream each chunk's results (on_chunk) and each failed
    # item (on_error) as they become final: files land on disk and
    # on_item ticks during the batch, once per item, errored items
    # included (reference batch.go:108-124 fires per completed item).
    written = [False] * n
    progress = {"completed": 0}
    write_lock = threading.Lock()

    def _tick() -> None:
        if batch_opts.on_item is not None:
            with write_lock:
                progress["completed"] += 1
                c = progress["completed"]
            batch_opts.on_item(c, n)

    def _fail(i: int, exc: BaseException) -> None:
        if results[i].err is None and not written[i]:
            results[i].err = exc
            _tick()

    def load(i: int) -> None:
        if ctx is not None and ctx.done():
            results[i].err = ctx.err()
            return
        if batch_opts.skip_existing and _dst_done(items[i].dst):
            skipped[i] = True
            return
        try:
            with open(items[i].src, "rb") as f:
                data = f.read()
            raw[i] = data
            sizes[i] = len(data)
            orients[i] = int(read_orientation(data))
        except Exception as e:  # noqa: BLE001 — per-item capture
            _fail(i, e)

    workers = batch_opts.workers if batch_opts.workers > 0 \
        else (os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=min(workers, n)) as pool:
        list(pool.map(load, range(n)))

    def _write_now(i: int, res: Result) -> None:
        res.original_size = sizes[i]
        res.compute_stats()
        try:
            with open(items[i].dst, "wb") as f:
                f.write(res.compressed_data)
            results[i].result = res
        except Exception as e:  # noqa: BLE001 — per-item capture
            results[i].err = e
        written[i] = True
        _tick()

    def unfinished() -> List[int]:
        return [i for i in range(n) if not written[i] and not skipped[i]
                and results[i].err is None]

    live = unfinished()
    sub_opts = dataclasses.replace(opts, auto_orient=False)
    try:
        pixel_items = list(live)
        if opts.format == Format.JPEG and opts.target_size == 0:
            # Every upright qualifying JPEG takes the coefficient path,
            # grouped by geometry; the rest take the pixel path, as does
            # target-size mode (JAX batch.py:224).
            groups: dict = {}
            pixel_items = []
            for i in live:
                upright = (orients[i] <= int(Orientation.NORMAL)
                           or not opts.auto_orient)
                key = qualify_jpeg_bytes(raw[i]) if upright else None
                if key is None:
                    pixel_items.append(i)
                else:
                    groups.setdefault(key, []).append(i)
            for key, idxs in groups.items():
                _run_engine(lambda on_chunk, on_error, idxs=idxs, key=key:
                            compress_jpeg_bytes_batched(
                                ctx, [raw[i] for i in idxs], sub_opts,
                                on_chunk=on_chunk, qualify_key=key,
                                workers=batch_opts.workers, device=device,
                                on_error=on_error),
                            idxs, _write_now, _fail)
        decoded, decodable = [], []
        for i in pixel_items:
            if ctx is not None:
                ctx.raise_if_done()
            try:
                img = decode_image(raw[i], _one_device(device))
                if opts.auto_orient and orients[i] > int(Orientation.NORMAL):
                    img = apply_orientation(to_nrgba(img),
                                            Orientation(orients[i]))
            except Exception as e:  # noqa: BLE001 — per-item capture
                _fail(i, e)
                continue
            decoded.append(img)
            decodable.append(i)
        if decodable:
            _run_engine(lambda on_chunk, on_error:
                        compress_images_batched(
                            ctx, decoded, sub_opts,
                            workers=batch_opts.workers, on_chunk=on_chunk,
                            device=device, on_error=on_error),
                        decodable, _write_now, _fail)
    except CanceledError as e:
        # Normal cancellation: streamed chunks are on disk; every
        # remaining item gets the context error (batch.go:93-99).
        err = ctx.err() if ctx is not None and ctx.done() else e
        for i in unfinished():
            results[i].err = err
        return results
    except FusedChunkError as e:
        # The device is wedged (a sticky CUDA error): the engine failed
        # its own unfinished items; everything not yet started fails with
        # the same error, without touching the device again.
        warnings.warn(f"fennec: device unusable mid-batch ({e.cause!r}); "
                      f"failing {len(unfinished())} unfinished item(s) "
                      f"without device retry", RuntimeWarning)
        for i in unfinished():
            _fail(i, e.cause)
        return results
    except Exception as e:  # noqa: BLE001 — the fused path itself failed
        warnings.warn(f"fennec: fused batch path failed ({e!r}); falling "
                      f"back to the per-file pool", RuntimeWarning)
        # Only items not yet resolved re-run, and on_item continues from
        # the streamed count: the reference fires it once per item.
        pending = unfinished()
        if not pending:
            return results
        fallback = dataclasses.replace(batch_opts, fused=False)
        if batch_opts.on_item is not None:
            base = progress["completed"]
            cb = batch_opts.on_item
            fallback = dataclasses.replace(
                fallback, on_item=lambda c, _t, _b=base, _cb=cb: _cb(_b + c,
                                                                     n))
        sub = compress_batch(ctx, [items[i] for i in pending], fallback,
                             device)
        for i, br in zip(pending, sub):
            results[i].result, results[i].err = br.result, br.err
    return results


def _run_engine(call, idxs: List[int], write_now, fail) -> None:
    """Run one engine call over the items idxs, streaming its results and
    per-item errors to the batch's indices.  Item errors are final; a
    wedged device propagates to the caller."""
    def on_chunk(pairs) -> None:
        for j, res in pairs:
            write_now(idxs[j], res)

    try:
        call(on_chunk, lambda j, exc: fail(idxs[j], exc))
    except FusedChunkError as e:
        if e.wedged:
            raise


@dataclasses.dataclass
class BatchSummary:
    """Aggregate statistics (reference batch.go:130-137)."""

    total: int = 0
    succeeded: int = 0
    failed: int = 0
    total_saved: int = 0
    avg_ssim: float = 0.0

    def __str__(self) -> str:
        return (f"Batch: {self.succeeded}/{self.total} succeeded | "
                f"{human_bytes(self.total_saved)} saved | "
                f"Avg SSIM: {self.avg_ssim:.4f}")


def summarize(results: List[BatchResult]) -> BatchSummary:
    """Aggregate batch results (reference batch.go:140-158)."""
    s = BatchSummary(total=len(results))
    ssim_sum = 0.0
    scored = 0
    for r in results:
        if r.err is not None:
            s.failed += 1
            continue
        s.succeeded += 1
        if r.result is not None:
            s.total_saved += r.result.original_size - r.result.compressed_size
            ssim_sum += r.result.ssim
            scored += 1
    # Items skipped via skip_existing count as succeeded but carry no
    # Result; averaging over them would dilute avg_ssim toward zero.
    if scored > 0:
        s.avg_ssim = ssim_sum / scored
    return s
