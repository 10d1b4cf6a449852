"""Batch device work: the coefficient path's chunk, device Huffman
emission, and batched SSIM.

Counterpart of the part of fennec_tpu/parallel/batched.py the batch
engines run.  batched_decode_resize_search_quantize (:515) reconstructs a
chunk of same-geometry JPEGs from their quantized blocks, optionally
Lanczos-resizes them and runs the lockstep quality search; pixels never
leave the device.  batched_ssim (:1248) and batched_ssim_fast (:1306)
score a batch of image pairs with one K1 call on a CUDA device.
`_dense_to_imgs` (:663) is engine/compress.py's decode_jpeg_image here,
which already takes the whole batch.

Device Huffman emission (packed_hist_bits :238, batched_emit_std :458,
batched_emit_custom :1101, pull_emit_words :1074) over (B, NT, 64) int16
quantized blocks resident on the device, through kernel K3
(ops/jpeg_emit_cuda.py) on a CUDA device and its plain version on the
CPU.  emit_scans runs the whole flow with two pulls.  Optimal tables:
K3a (the histograms), K5 (ops/huffbuild_cuda.py: every image's K.2
tables, built on the device, the counterpart of the JAX package's fused
optimal emission, :265-456), one small pull of K5's header (the scan
bits, the overflow flag and the DHT specs, 832 bytes an image), then K3b
with the tables K5 left on the device.  Standard tables: K3a, one pull
of the bit count per image, K3b.  K3b finds its own bit offsets; the
last pull is exactly ceil(bits / 32) words per image.  The JAX package
switches its fused route with FENNEC_FUSED_OPT and FENNEC_TS_FUSED,
because on the TPU it lost to the host build; here there is no switch:
the tables are the same bit for bit either way, so the device build is
the one route.  The host-built flow (_optimal_tables, hist_bits,
emit_custom) stays for an image K5 flags (a code above 32 bits), which
is redone alone on the host builder and fails with its ValueError.

The coefficient path's upload layouts (JAX :542-807): an unresized chunk
goes up as sparse COO, dense int8 or CSR (engine/batched.py picks), each
with its exceptions, and kernel K6 (ops/coef_wire_cuda.py; its plain
version ops/coef_wire.py on the CPU) rebuilds the int16 blocks on the
shard's stream (unpack_wire); a resized chunk uploads the int16 blocks.
Then batched_decode_resize_search_quantize runs as it does on int16
blocks: the same integers, so the same outputs.  The pixel path's YCbCr
4:2:0 wire (JAX :179-233) is searched by batched_search_yuv420.

The data-parallel mesh (JAX :35-90, :1167-1398): data_mesh is the batch
engines' rule for spreading a node's cards, shard_data_call runs a
function over a DataMesh (parallel/mesh.py), one CUDA stream per shard
and one thread per device (_Shards), and the *_sharded functions are the
batched search, search-and-emit, size search and SSIM on a mesh, each
equal to its unsharded form.

The data×spatial mesh (JAX :1370-1454): quality_search_spatial_sharded
searches one image whose rows are split in bands over a DataSpatialMesh,
and batched_ssim_sharded(spatial=True) scores a batch with its rows split
so.  The JAX package runs each as one jit over row-sharded arrays and
lets XLA insert the halo exchanges and reductions; here every band is a
shard of _Shards, the runner shard_data_call uses too, that reads a halo of rows from the next bands once, runs K2 (or K1) on its
rows, and sends what it owns to the mesh's first device, where the
shards' parts are put together.  Shards are ordered by CUDA events
between streams, with no host sync inside the search; a device's shards
run in turn on one thread, each on its own stream.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..codecs.jpeg import forward_dct, quantize_coefs
from ..engine import compress as _compress
from ..engine.compress import (
    batched_quality_search_quantize,
    decode_jpeg_image,
)
from ..engine.size_search import size_bisect
from ..ops import dct as dct_ops
from ..ops.color import luminance
from ..ops.coef_wire_cuda import unpack_coo, unpack_csr, unpack_i8
from ..ops.huffbuild import specs_from_opt_header, split_opt_header
from ..ops.huffbuild_cuda import build_tables, pull_header
from ..ops.jpeg_emit import (
    finalize_scan_host,
    layout_on,
    std_tables_on,
)
from ..ops.jpeg_emit_cuda import (
    block_stats,
    check_inputs,
    check_tables,
    check_word_base,
    deposit,
)
from ..ops.jpeg_size import bits_std_from_hist
from ..ops.resize import box_band, lanczos_resize_device
from ..ops.ssim import WINDOW_SIZE, ssim_fast_dims, ssim_fast_images
from ..ops.ssim_cuda import ssim_window
from .mesh import DataMesh, DataSpatialMesh, Mesh, shard_bands, shard_rows


def batched_decode_resize_search_quantize(
        blocks: torch.Tensor, qtabs: torch.Tensor, h: int, w: int,
        in_subsample: bool, out_subsample: bool, targets: Sequence[float],
        resize_wh: Optional[torch.Tensor] = None,
        resize_wv: Optional[torch.Tensor] = None, emit: bool = False,
        optimize: bool = True):
    """blocks: (B, NT, 64) int16 decoded quantized blocks of B h×w JPEGs
    (y, cb, cr on MCU-padded grids) and (B, 2, 64) [luma, chroma] tables,
    on the device.  Decode, resize with the (W', W) and (H', H) Lanczos
    weights when given, search and re-quantize; returns what
    batched_quality_search_quantize returns (emit and optimize as
    there), on the host."""
    imgs = decode_jpeg_image(blocks, qtabs, h, w, in_subsample)
    if resize_wh is not None:
        imgs = lanczos_resize_device(imgs, resize_wh, resize_wv)
    return batched_quality_search_quantize(imgs, targets, out_subsample,
                                           emit, optimize)


# The K6 wrapper of each compact layout, by the name the engine tags a
# chunk with.
WIRE_UNPACK = {"coo": unpack_coo, "i8": unpack_i8, "csr": unpack_csr}


def unpack_wire(kind: str, *wire: torch.Tensor) -> torch.Tensor:
    """A chunk's uploaded coefficient sections → its (B, NT, 64) int16
    natural-order blocks on their device: "int16" is the blocks
    themselves; "coo", "i8" and "csr" go through K6 (its plain version on
    the CPU), their sections in the order ops/coef_wire.py takes them."""
    if kind == "int16":
        return wire[0]
    return WIRE_UNPACK[kind](*wire)


def batched_wire_search_quantize(kind: str, wire: Sequence[torch.Tensor],
                                 qtabs: torch.Tensor, h: int, w: int,
                                 in_subsample: bool, out_subsample: bool,
                                 targets: Sequence[float],
                                 resize_wh: Optional[torch.Tensor] = None,
                                 resize_wv: Optional[torch.Tensor] = None,
                                 emit: bool = False, optimize: bool = True):
    """batched_decode_resize_search_quantize of the blocks unpack_wire
    rebuilds from an uploaded chunk (JAX batched_search_coo :684,
    batched_search_csr :789, batched_decode_search_quantize_i8 :876)."""
    return batched_decode_resize_search_quantize(
        unpack_wire(kind, *wire), qtabs, h, w, in_subsample, out_subsample,
        targets, resize_wh, resize_wv, emit, optimize)


def _split_yuv420_wire(buf: torch.Tensor, h: int, w: int):
    """(B, ph·pw + 2·(ph/2)·(pw/2)) uint8 YCbCr 4:2:0 wire rows → (y (B,
    ph, pw), cb, cr (B, ph/2, pw/2)) views (JAX :179)."""
    bsz = buf.shape[0]
    ph, pw = h + (-h) % 16, w + (-w) % 16
    ny, nc = ph * pw, (ph // 2) * (pw // 2)
    return (buf[:, :ny].view(bsz, ph, pw),
            buf[:, ny:ny + nc].view(bsz, ph // 2, pw // 2),
            buf[:, ny + nc:ny + 2 * nc].view(bsz, ph // 2, pw // 2))


def batched_search_yuv420(buf: torch.Tensor, targets: Sequence[float],
                          h: int, w: int, emit: bool = False,
                          optimize: bool = True):
    """The lockstep search of B h × w images sent on the YCbCr 4:2:0 pixel
    wire, quantized and (with `emit`) Huffman-coded on the wire's device:
    the outputs of batched_quality_search_quantize (JAX
    batched_search_hist_yuv420 :194 and batched_search_opt_yuv420 :223,
    whose flavours are emit / optimize here)."""
    return _compress.batched_quality_search_quantize_yuv420(
        *_split_yuv420_wire(buf, h, w), targets, h, w, emit, optimize)


def batched_ssim_fast(imgs_a: torch.Tensor,
                      imgs_b: torch.Tensor) -> np.ndarray:
    """SSIMFast per pair of two (B, H, W, 4) image batches of one shape
    on one device (reference ssim.go:48-70, with ops/ssim.ssim_fast's
    routing of small images) → (B,) host floats.  On a CUDA device the
    windowed score is one K1 call for the batch."""
    return ssim_fast_images(imgs_a, imgs_b).cpu().numpy()


def batched_ssim(imgs_a: torch.Tensor, imgs_b: torch.Tensor) -> torch.Tensor:
    """Windowed SSIM per pair of two (B, H, W, C>=3) batches of one shape
    at full resolution (JAX :1248) → (B,) float32 on their device: one K1
    call on a CUDA device.  A side of 8 px or less has no window
    position: 1.0 (ssim.go:162-164)."""
    bsz, h, w = imgs_a.shape[:3]
    if h <= WINDOW_SIZE or w <= WINDOW_SIZE:
        return torch.ones((bsz,), dtype=torch.float32, device=imgs_a.device)
    return ssim_window(luminance(imgs_a.to(torch.float32)).contiguous(),
                       luminance(imgs_b.to(torch.float32)).contiguous())


# ── Device Huffman emission ─────────────────────────────────────────────────


def _padded(h: int, w: int, subsample: bool):
    mult = 16 if subsample else 8
    return h + (-h) % mult, w + (-w) % mult


def _checked_layout(packed: torch.Tensor, h: int, w: int, subsample: bool,
                    tables: torch.Tensor):
    """The geometry's scan layout on the blocks' device, after the one
    check_inputs of an emission."""
    lay = layout_on(*_padded(h, w, subsample), subsample, packed.device)
    check_inputs(packed, lay, tables)
    return lay


def packed_hist_bits(packed: torch.Tensor, h: int, w: int,
                     subsample: bool) -> torch.Tensor:
    """Symbol histograms and the exact standard-table bit count of
    quantized blocks (B, NT, 64) int16 of h×w images: one K3a launch.
    Returns (B, 545) int64 on their device, JAX :238's columns: 0 the
    standard-table bits, 1:33 the DC histograms (2, 16), 33:545 the AC
    histograms (2, 256)."""
    tables = std_tables_on(packed.device)
    lay = _checked_layout(packed, h, w, subsample, tables)
    hist = block_stats.launch(packed, lay, tables,
                              want_hist=True).hist.to(torch.int64)
    bsz = packed.shape[0]
    bits = bits_std_from_hist(hist[:, :32].reshape(bsz, 2, 16),
                              hist[:, 32:].reshape(bsz, 2, 256))
    return torch.cat([bits[:, None], hist], dim=1)


class DeviceScans(NamedTuple):
    """Emitted words on the device: image b owns words[base[b]:base[b+1]]
    and `bits[b]` of them; the last word is K3b's out-of-range flag."""

    words: torch.Tensor
    bits: np.ndarray
    base: np.ndarray


def _word_base(totals: np.ndarray) -> np.ndarray:
    """(B + 1,) int64 first word of each image's ceil(bits / 32) words."""
    base = np.zeros(totals.size + 1, dtype=np.int64)
    np.cumsum((totals + 31) // 32, out=base[1:])
    return base


def emit_std(packed: torch.Tensor, lay) -> DeviceScans:
    """Emit with the Annex-K tables (JAX batched_emit_std, :458): K3a for
    the bits per image, a pull of that one count per image, K3b.  `lay`
    is the geometry's layout, the blocks checked with it."""
    dev = packed.device
    tables = std_tables_on(dev)
    totals = block_stats.launch(packed, lay, tables).totals.cpu().numpy()
    base = _word_base(totals)
    # One image owns the whole buffer; a batch's bases go up.
    word_base = (None if totals.size == 1
                 else torch.from_numpy(base).to(dev))
    n_words = int(base[-1])
    check_word_base(word_base, n_words, totals.size, dev)
    words = deposit.launch(packed, lay, tables, word_base, n_words)
    return DeviceScans(words, totals, base)


def emit_custom(packed: torch.Tensor, lay, tables: np.ndarray,
                totals: np.ndarray) -> DeviceScans:
    """Emit with per-image tables (JAX batched_emit_custom, :1101):
    tables (B, 2, 272) int32 packed (code << 5 | length) on the host,
    totals (B,) the scans' bits under them, known on the host from the
    histograms (hist_bits).  One upload (the tables, and a batch's word
    bases behind them) and one K3b launch; no pull.  `lay` is the
    geometry's layout, the blocks checked with it."""
    dev = packed.device
    totals = np.asarray(totals, dtype=np.int64)
    bsz = totals.size
    base = _word_base(totals)
    tables = np.ascontiguousarray(tables, dtype=np.int32)
    n_tab = tables.size
    up = np.empty(n_tab + (0 if bsz == 1 else 2 * base.size), dtype=np.int32)
    up[:n_tab] = tables.reshape(-1)
    up[n_tab:].view(np.int64)[:] = base[:(up.size - n_tab) // 2]
    up_dev = torch.from_numpy(up).to(dev)
    tables_dev = up_dev[:n_tab].view(tables.shape)
    word_base = None if bsz == 1 else up_dev[n_tab:].view(torch.int64)
    check_tables(tables_dev, packed.shape[0], dev)
    n_words = int(base[-1])
    check_word_base(word_base, n_words, packed.shape[0], dev)
    words = deposit.launch(packed, lay, tables_dev, word_base, n_words)
    return DeviceScans(words, totals, base)


def pull_emit_words(scans: DeviceScans) -> np.ndarray:
    """The words of every image in one device→host copy (JAX :1074), as
    uint32; raises if K3b flagged a word outside its image's range."""
    host = scans.words.cpu().numpy().view(np.uint32)
    if host[-1]:
        raise RuntimeError("fennec: Huffman emission wrote outside its "
                           "words (block bits and scan bits disagree)")
    return host[:-1]


def hist_bits(dc_freq: np.ndarray, ac_freq: np.ndarray,
              tables: np.ndarray) -> np.ndarray:
    """Scan bits under packed tables (B, 2, 272) from the histograms
    (B, 2, 16) and (B, 2, 256): the dot product of the counts with each
    symbol's code length plus its magnitude bits → (B,) int64."""
    lens = (tables & 31).astype(np.int64)
    extra = np.arange(256, dtype=np.int64)
    return ((dc_freq * (lens[:, :, :16] + extra[:16])).sum(axis=(1, 2))
            + (ac_freq * (lens[:, :, 16:] + (extra & 15))).sum(axis=(1, 2)))


@dataclasses.dataclass
class HostScans:
    """A batch's emitted scans on the host: `specs` holds each image's
    optimal (dc_specs, ac_specs), None for the standard tables; `errors`
    the images whose optimal tables could not be built (K.2's 32-bit
    limit), which fail alone."""

    words: np.ndarray
    bits: np.ndarray
    base: np.ndarray
    specs: Optional[List] = None
    errors: Dict[int, BaseException] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def concat(cls, parts: Sequence["HostScans"]) -> "HostScans":
        """The scans of several batches as one batch, in order."""
        words, bits, bases, specs = [], [], [np.zeros(1, np.int64)], []
        errors: Dict[int, BaseException] = {}
        rows = offset = 0
        for part in parts:
            n_words = int(part.base[-1])
            words.append(part.words[:n_words])
            bits.append(part.bits)
            bases.append(part.base[1:] + offset)
            specs.extend(part.specs if part.specs is not None
                         else [None] * len(part.bits))
            errors.update({rows + j: e for j, e in part.errors.items()})
            rows += len(part.bits)
            offset += n_words
        return cls(np.concatenate(words), np.concatenate(bits),
                   np.concatenate(bases),
                   None if all(x is None for x in specs) else specs, errors)

    def scan(self, j: int) -> bytes:
        """Image j's entropy-coded segment: padded and byte-stuffed."""
        return finalize_scan_host(
            self.words[self.base[j]:self.base[j + 1]], int(self.bits[j]))

    def jpeg(self, j: int, w: int, h: int, quality: int,
             subsample: bool) -> bytes:
        """Image j's file, its blocks quantized at `quality`."""
        from ..codecs.jpeg import _dht_segment_custom, assemble_jpeg
        from ..ops.dct import all_quality_tables

        if j in self.errors:
            raise self.errors[j]
        dht = (None if self.specs is None
               else _dht_segment_custom(*self.specs[j]))
        return assemble_jpeg(w, h, all_quality_tables()[quality],
                             self.scan(j), subsample, dht=dht)


def _optimal_tables(dc_freq: np.ndarray, ac_freq: np.ndarray):
    """(specs, (B, 2, 272) packed tables, errors): the K.2 tables in one
    C call; when some image's code would exceed 32 bits, image by image,
    so that only those images fail."""
    from ..codecs.huffopt import specs_and_tables_batch

    try:
        specs, dcp, acp = specs_and_tables_batch(dc_freq, ac_freq)
        return specs, np.concatenate([dcp, acp], axis=2), {}
    except ValueError:
        pass
    bsz = dc_freq.shape[0]
    specs: List = [None] * bsz
    tables = np.zeros((bsz, 2, 272), dtype=np.int32)
    errors: Dict[int, BaseException] = {}
    for j in range(bsz):
        try:
            got, dcp, acp = specs_and_tables_batch(dc_freq[j:j + 1],
                                                   ac_freq[j:j + 1])
        except ValueError as exc:
            errors[j] = exc
            continue
        specs[j] = got[0]
        tables[j] = np.concatenate([dcp[0], acp[0]], axis=1)
    return specs, tables, errors


def _redo_flagged(hist: torch.Tensor, flagged: np.ndarray, specs: List,
                  errors: Dict[int, BaseException]) -> None:
    """The images K5 flagged (a code above 32 bits) redone alone on the
    host builder from their histograms, which raises its ValueError into
    `errors`: the JAX engines' redo rule.  The rest of the batch stands."""
    rows = np.nonzero(flagged)[0]
    if rows.size == 0:
        return
    got = hist[torch.from_numpy(rows).to(hist.device)].cpu().numpy()
    for r, j in enumerate(rows):
        one = got[r:r + 1].astype(np.int64)
        _s, _t, errs = _optimal_tables(one[:, :32].reshape(1, 2, 16),
                                       one[:, 32:].reshape(1, 2, 256))
        specs[j] = None
        errors[int(j)] = errs.get(0) or RuntimeError(
            "fennec: the device K.2 build flagged an image whose tables "
            "the host builder builds")


def emit_scans(packed: torch.Tensor, h: int, w: int, subsample: bool,
               optimize: bool) -> HostScans:
    """Huffman-code B quantized h×w images (B, NT, 64) int16 on their
    device, with per-image optimal tables or the standard ones.
    Optimal: K3a's histograms, K5's tables and header, one pull of the
    header (a batch's word bases go up from its bits), K3b with the
    tables K5 left on the device: three launches.  Standard: K3a, one bit
    count per image down, K3b.  Then one pull of the words."""
    std = std_tables_on(packed.device)
    lay = _checked_layout(packed, h, w, subsample, std)
    if not optimize:
        dev_scans = emit_std(packed, lay)
        return HostScans(pull_emit_words(dev_scans), dev_scans.bits,
                         dev_scans.base)
    dev = packed.device
    bsz = packed.shape[0]
    hist = block_stats.launch(packed, lay, std, want_hist=True).hist
    built = build_tables(hist, std)
    totals, flagged, bits16, nvals, vals = split_opt_header(
        pull_header(built.header))
    base = _word_base(totals)
    # One image owns the whole buffer; a batch's bases go up.
    word_base = None if bsz == 1 else torch.from_numpy(base).to(dev)
    n_words = int(base[-1])
    check_word_base(word_base, n_words, bsz, dev)
    words = deposit.launch(packed, lay, built.tables, word_base, n_words)
    specs = [specs_from_opt_header(bits16, nvals, vals, j)
             for j in range(bsz)]
    errors: Dict[int, BaseException] = {}
    _redo_flagged(hist, flagged, specs, errors)
    return HostScans(pull_emit_words(DeviceScans(words, totals, base)),
                     totals, base, specs, errors)


# ── Data-parallel mesh ──────────────────────────────────────────────────────
#
# The reference's CompressBatch saturates every core with a goroutine
# worker pool (batch.go:58-128).  The JAX package shards the engines'
# chunks over all local chips through one Mesh('data') axis; here each
# shard of a chunk runs on its device, on a CUDA stream of its own, and
# each device in a thread of its own.  Images are independent: no
# collective is needed.


def data_mesh(device: _device.MeshLike = None) -> Optional[DataMesh]:
    """The mesh the production batch engines spread a chunk over, or
    None for one device (JAX :35): device.resolve_mesh's rule.  A
    sequence of devices is always honoured; None (or a bare "cuda") is
    every visible card when there are two or more, unless FENNEC_MESH=0;
    one named device or the CPU is None.  FENNEC_MESH=1 forces nothing
    more: the JAX package uses it for the virtual devices of its CPU
    backend, and PyTorch has none."""
    return _device.resolve_mesh(device)


# One stream per (device, shard), made once: the caching allocator keeps
# a freed block for the stream that allocated it, so a new stream per
# chunk would strand the previous chunks' memory.
_streams: Dict[Tuple[str, int], "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def _shard_stream(dev: torch.device, k: int) -> "torch.cuda.Stream":
    with _streams_lock:
        got = _streams.get((str(dev), k))
        if got is None:
            got = _streams[(str(dev), k)] = torch.cuda.Stream(dev)
        return got


def _as_tensor(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _shard_arg(x, start: int, stop: int, dev: torch.device):
    """Rows [start, stop) of a batch-leading tensor, array or list; a
    tensor or array goes to `dev` (asynchronously from pinned memory)."""
    x = _as_tensor(x)
    if isinstance(x, torch.Tensor):
        return x[start:stop].to(dev, non_blocking=True)
    return x[start:stop]


def _whole_arg(x, dev: torch.device):
    x = _as_tensor(x)
    return x.to(dev, non_blocking=True) if isinstance(x, torch.Tensor) else x


def _concat(parts: list, dev: torch.device):
    """Shard outputs → one output in input order: tuples element by
    element; arrays and HostScans on the host, tensors on `dev`."""
    first = parts[0]
    if isinstance(first, tuple):
        return tuple(_concat(list(col), dev) for col in zip(*parts))
    if len(parts) == 1:
        return first
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    if isinstance(first, HostScans):
        return HostScans.concat(parts)
    raise TypeError(f"fennec: cannot concatenate shard outputs of type "
                    f"{type(first)}")


class _Shards:
    """The one runner of sharded work, on the data axis (shard_data_call)
    and the spatial axis alike: shard k on devices[k], each under its
    device and its own stream (_shard_stream(device, k)) on a card, which
    first waits for the caller's stream of that device.  A device runs
    its shards in turn on a thread of its own (on the calling thread when
    there is one device): launches are asynchronous, and threads for
    shards of one card only contend for it (on an H100, a 12 MP search
    over 4 bands of one card took 48-67 ms with a thread per band and
    17-19 ms on one thread; bench_sources/spatial_variants.py).  Tensors
    move between shards by `move`, which orders the streams by CUDA
    events; nothing waits on the host.  A context manager: the threads
    end with it."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        # "cuda" names the current card: an index, so devices compare.
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d
                        for d in devices]
        self.streams = [_shard_stream(d, k) if d.type == "cuda" else None
                        for k, d in enumerate(self.devices)]
        for d, st in zip(self.devices, self.streams):
            if st is not None:
                st.wait_stream(torch.cuda.current_stream(d))
        cards = len(set(self.devices))
        self.pool = (ThreadPoolExecutor(cards, thread_name_prefix="fennec-"
                                        "shard") if cards > 1 else None)

    def __enter__(self) -> "_Shards":
        return self

    def __exit__(self, *exc) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True)

    def _call(self, fn, k: int):
        st = self.streams[k]
        if st is None:
            return fn(k)
        with torch.cuda.device(self.devices[k]), torch.cuda.stream(st):
            return fn(k)

    def run(self, fn, shards: Optional[Sequence[int]] = None) -> list:
        """[fn(k) for each shard k (default: all)], each on its shard; once
        every one has stopped, the first error in shard order is
        raised."""
        ks = list(range(len(self.devices))) if shards is None else list(
            shards)
        groups: Dict[torch.device, List[int]] = {}
        for k in ks:
            groups.setdefault(self.devices[k], []).append(k)
        done: dict = {}

        def work(group: List[int]) -> None:
            for k in group:
                try:
                    done[k] = (True, self._call(fn, k))
                except BaseException as exc:  # noqa: BLE001 — raised below
                    done[k] = (False, exc)

        if self.pool is None or len(groups) == 1:
            for group in groups.values():
                work(group)
        else:
            wait([self.pool.submit(work, g) for g in groups.values()])
        for k in ks:
            if not done[k][0]:
                raise done[k][1]
        return [done[k][1] for k in ks]

    def stream_of(self, dev: torch.device, k: Optional[int]):
        """Shard k's stream, or the caller's stream of `dev` (k None)."""
        if dev.type != "cuda":
            return None
        return self.streams[k] if k is not None else \
            torch.cuda.current_stream(dev)

    def move(self, x: torch.Tensor, src: Optional[int],
             dst: Optional[int], dst_dev: Optional[torch.device] = None):
        """x, made on shard `src`'s stream (None: the caller's), for use
        on shard `dst`'s stream (None: the caller's, on dst_dev): after
        the work that made it, copied when the devices differ, and kept
        from the allocator until that stream is done with it."""
        dev = self.devices[dst] if dst is not None else dst_dev
        s_from = self.stream_of(x.device, src)
        s_to = self.stream_of(dev, dst)
        if x.device == dev:
            if s_to is not None and s_to != s_from:
                s_to.wait_stream(s_from)
                x.record_stream(s_to)
            return x
        if s_from is None:  # one kind of device in a mesh: both on the CPU
            return x.to(dev)
        with torch.cuda.stream(s_from), torch.cuda.stream(s_to):
            return x.to(dev, non_blocking=True)


def _moved(out, shards: _Shards, k: int, lead: torch.device):
    """Shard k's output (a tensor, array or HostScans, or a tuple of
    them) with its tensors handed to the caller's stream on `lead`
    (_Shards.move)."""
    if isinstance(out, tuple):
        return tuple(_moved(x, shards, k, lead) for x in out)
    if isinstance(out, torch.Tensor):
        return shards.move(out, k, None, lead)
    return out


def _data_axis(mesh: Mesh) -> DataMesh:
    return mesh.data_axis() if isinstance(mesh, DataSpatialMesh) else mesh


def shard_data_call(mesh: Mesh, fn, *args, replicated: int = 0):
    """fn(*args) over the mesh's "data" axis (JAX :59).

    Every arg is batch-leading (tensor, numpy array or list) and split by
    shard_rows, except the last `replicated`, which go whole to every
    shard.  Each non-empty shard runs fn on its device under its stream
    (_Shards: a thread per device, the shards of one device in turn);
    tensor and array args are copied to the shard's device first
    (asynchronously from pinned memory).  fn returns a tensor, array or
    HostScans, or a tuple of them; the shards' outputs come back
    concatenated in input order (tensors on the mesh's first device).
    The call returns once every shard's stream has finished: the batch
    engines time it, reuse the pinned buffers it read, and classify an
    asynchronous CUDA error by the chunk that raised it.

    A shard that raises does not stop the others: once all have stopped,
    the first error in shard order is raised.  Nothing is retried on
    another device.  On a DataSpatialMesh the batch goes over its data
    axis (its first spatial column)."""
    mesh = _data_axis(mesh)
    nshard = len(args) - replicated
    jobs = [(dev, start, stop) for dev, (start, stop)
            in zip(mesh.devices, shard_rows(len(args[0]), mesh))
            if stop > start] or [(mesh.devices[0], 0, 0)]
    with _Shards([dev for dev, _, _ in jobs]) as shards:
        def call(k: int):
            _, start, stop = jobs[k]
            dev, stream = shards.devices[k], shards.streams[k]
            out = fn(*[_shard_arg(a, start, stop, dev) if i < nshard
                       else _whole_arg(a, dev) for i, a in enumerate(args)])
            if stream is not None:
                stream.synchronize()
            return out

        lead = shards.devices[0]
        outs = [_moved(out, shards, k, lead)
                for k, out in enumerate(shards.run(call))]
    return _concat(outs, lead)


def _targets_list(targets) -> List[float]:
    """B per-image targets (a sequence, array or tensor) as floats."""
    return torch.as_tensor(targets, dtype=torch.float64).reshape(-1).tolist()


def _float_images(imgs) -> torch.Tensor:
    return _as_tensor(imgs).to(torch.float32)


def batched_quality_search(imgs, targets, subsample: bool = True):
    """(B, H, W, 4) images (any dtype) + B per-image targets → (quality
    int64, ssim float32, found bool), each (B,), on the images' device:
    the lockstep bisection, each probe one K2 and one K1 launch on a card
    (JAX :90)."""
    return _compress.batched_quality_search(_float_images(imgs),
                                            _targets_list(targets),
                                            subsample)


def batched_quality_search_sharded(mesh: DataMesh, imgs, targets,
                                   subsample: bool = True):
    """batched_quality_search with the batch over the mesh (JAX :1167):
    every shard searches its rows on its device; the outputs on the
    mesh's first device."""
    return shard_data_call(
        mesh, lambda im, t: batched_quality_search(im, t, subsample), imgs,
        _targets_list(targets))


def batched_search_emit(imgs, targets, subsample: bool = True):
    """Search, quantize at the winning quality and Huffman-code with the
    standard tables on the images' device (K3 on a card) → (q, ssim,
    found, HostScans) on the host: the unsharded form of
    batched_search_emit_sharded."""
    return batched_quality_search_quantize(
        _float_images(imgs), _targets_list(targets), subsample, emit=True,
        optimize=False)


def batched_search_emit_sharded(mesh: DataMesh, imgs, targets,
                                subsample: bool = True):
    """batched_search_emit with the batch over the mesh (JAX :1185):
    every shard searches, quantizes and emits its rows on its device.  K3
    sizes its words exactly, so there is no max_words."""
    return shard_data_call(
        mesh, lambda im, t: batched_search_emit(im, t, subsample), imgs,
        _targets_list(targets))


def batched_size_search(imgs, target_scan_bytes: int, lo0: int, hi0: int):
    """Target-size strategy S1 for a same-shape stack: the forward DCT of
    (B, H, W, 4) images (4:2:0) and size_search.size_bisect over the
    (B,) stack (K4 on a card) → (best_q int64, found bool), each (B,),
    on the images' device: the unsharded form of
    batched_size_search_sharded."""
    stack = _float_images(imgs)
    h, w = int(stack.shape[1]), int(stack.shape[2])
    coefs = forward_dct(stack, True)
    return size_bisect(coefs, h + (-h) % 16, w + (-w) % 16, True,
                       target_scan_bytes, lo0, hi0)


def batched_size_search_sharded(mesh: DataMesh, imgs,
                                target_scan_bytes: int, lo0: int, hi0: int):
    """batched_size_search with the batch over the mesh (JAX :1337)."""
    return shard_data_call(
        mesh, lambda im: batched_size_search(im, target_scan_bytes, lo0,
                                             hi0), imgs)


def batched_ssim_sharded(mesh: Mesh, imgs_a, imgs_b,
                         spatial: bool = False) -> torch.Tensor:
    """batched_ssim with the batch over the mesh's "data" axis (JAX
    :1370); the scores on the mesh's first device.  With spatial=True
    the rows of every image are split over the "spatial" axis too
    (ValueError on a mesh without one): each band's shard runs K1 on its
    rows and the next WINDOW_SIZE (7 that its windows read, and the one
    row past them that K1's shape implies: h rows give h - 8 window
    positions), and owns the positions whose top row is in its band; the
    bands' means, weighted by their positions, are summed in float64 in
    band order.  A band that owns no position adds nothing."""
    if not spatial:
        return shard_data_call(
            mesh, lambda a, b: batched_ssim(a.to(torch.float32),
                                            b.to(torch.float32)),
            imgs_a, imgs_b)
    if not isinstance(mesh, DataSpatialMesh):
        raise ValueError("fennec: the mesh has no 'spatial' axis; make one "
                         "with data_spatial_mesh")
    a, b = _as_tensor(imgs_a), _as_tensor(imgs_b)
    bsz, h, w = (int(n) for n in a.shape[:3])
    lead = mesh.devices[0][0]
    bands = shard_bands(h, mesh)
    if bsz == 0 or h <= WINDOW_SIZE or w <= WINDOW_SIZE:
        return torch.ones((bsz,), dtype=torch.float32, device=lead)
    positions = [max(0, min(stop, h - WINDOW_SIZE) - start)
                 for start, stop in bands]
    jobs = [(row[j], (i, j), start, stop, bands[j][0],
             min(bands[j][1] + WINDOW_SIZE, h))
            for i, ((start, stop), row) in enumerate(zip(
                shard_rows(bsz, mesh.data_axis()), mesh.devices))
            for j in range(len(bands)) if stop > start and positions[j]]
    shards = _Shards([job[0] for job in jobs])
    lead = shards.devices[0]  # job 0: data row 0's first band

    def score(k: int) -> torch.Tensor:
        _, _, start, stop, r0, r1 = jobs[k]
        dev = shards.devices[k]
        band = [x[start:stop, r0:r1].to(dev, non_blocking=True)
                for x in (a, b)]
        return batched_ssim(*(x.to(torch.float32) for x in band))

    with shards:
        means = [shards.move(m, k, None, lead)
                 for k, m in enumerate(shards.run(score))]
    out = torch.zeros((bsz,), dtype=torch.float64, device=lead)
    for (_, (i, j), start, stop, _, _), m in zip(jobs, means):
        out[start:stop] += m.to(torch.float64) * positions[j]
    return (out / (h - WINDOW_SIZE)).to(torch.float32)


def quality_search_spatial_sharded(mesh: DataSpatialMesh, img, target: float,
                                   subsample: bool = True):
    """The SSIM-guided quality search and the winner's quantization for
    ONE image whose rows are split in bands over the mesh's "spatial"
    axis (JAX :1400): the path for an image whose working set exceeds
    one card's memory.

    img: (H, W, 4) (or 3 channels, opaque) of any dtype, on the host or a
    device; H must split over the spatial axis in multiples of 16 (8
    without subsample), else ValueError.  Returns (q int64, ssim float32,
    found bool) as 0-d tensors and the winner's quantized blocks (qy,
    qcb, qcr), (N, 64) float32 in block-row order, all on the mesh's
    first device.  With a data axis wider than 1 the JAX program
    computes the same result on every data row; this runs the first
    row's devices only.

    Band k holds image rows [start, stop) and reads a halo past them as
    far as its last owned SSIMFast rectangle reaches, in whole MCU rows
    (ops/resize.box_band).  Once per search, on its device: its pixel rows
    and halo come from `img`, its forward DCT (whole MCU rows, so its
    blocks are the image's), the original's luminance of its owned
    output rows, and the coefficient rows of the halo from the next
    bands.  Each of the 7 probes: the quality goes from the first device
    to every band, each band runs K2 on its rows on its own stream (its
    plain version on the CPU; a thread per device, _Shards), the owned
    luminance rows come to the first device, where K1 scores the whole
    (at most 512 × 512) plane as the unsharded search does and the
    bisection takes its next step.  Then every band quantizes its blocks,
    read back from its own rows of its coefficient planes (a band keeps
    one copy of its coefficients), at the final quality."""
    if not isinstance(mesh, DataSpatialMesh):
        raise ValueError("fennec: the mesh has no 'spatial' axis; make one "
                         "with data_spatial_mesh")
    n_sp = mesh.shape["spatial"]
    src = _as_tensor(img)
    h, w = int(src.shape[0]), int(src.shape[1])
    mult = 16 if subsample else 8
    if (h // n_sp) % mult or h % n_sp:
        raise ValueError(f"fennec: H={h} must shard over spatial={n_sp} in "
                         f"multiples of {mult}")
    ds_h = ssim_fast_dims(w, h)[1]
    bands = [box_band(h, ds_h, start, stop, mult)
             for start, stop in shard_bands(h, mesh)]
    with _Shards(mesh.devices[0]) as shards:
        return _spatial_search(shards, bands, src, target, subsample,
                               shards.devices[0])


def _spatial_search(shards: _Shards, bands, src, target: float,
                    subsample: bool, lead: torch.device):
    """quality_search_spatial_sharded's work on band k = shard k."""
    from ..ops.probe_recon_cuda import probe_recon

    w = int(src.shape[1])
    div = 2 if subsample else 1

    def prepare(k: int):
        band, dev = bands[k], shards.devices[k]
        pix = src[band.start:band.end].to(dev, non_blocking=True)
        pix = pix.to(torch.float32)[None]
        if pix.shape[-1] == 3:
            pix = torch.cat([pix, torch.full_like(pix[..., :1], 255.0)],
                            dim=-1)
        coefs = forward_dct(pix[:, :band.stop - band.start], subsample)
        return pix, _compress.coef_planes(coefs, band.stop - band.start, w,
                                          subsample)

    prepared = shards.run(prepare)

    def halo(k: int):
        """Band k's coefficient rows [stop, end), from the bands after
        it, for its stream: three lists of pieces."""
        parts = ([], [], [])
        for j in range(k + 1, len(bands)):
            a = max(bands[k].stop, bands[j].start)
            b = min(bands[k].end, bands[j].stop)
            if b <= a:
                break
            for c, plane in enumerate(prepared[j][1]):
                d = div if c else 1
                piece = plane[:, (a - bands[j].start) // d:
                              (b - bands[j].start) // d]
                parts[c].append(shards.move(piece, j, k))
        return parts

    halos = [halo(k) for k in range(len(bands))]

    def inputs(k: int):
        pix, planes = prepared[k]
        halo_k = [torch.cat(p, dim=-2) if p else p_own[:, :0]
                  for p, p_own in zip(halos[k], planes)]
        return _compress.band_inputs(pix, bands[k], planes, halo_k,
                                     subsample)

    band_in = shards.run(inputs)
    del prepared, halos  # the pixels
    owners = [k for k, band in enumerate(bands) if band.d1 > band.d0]

    def check(k: int) -> None:
        # K2's one check and copy of a search, before the loop and after
        # every band's work is queued: the copy waits for its stream.
        dev = shards.devices[k]
        if dev.type == "cuda":
            band_in[k].k2_state = probe_recon.prepare(
                band_in[k], *probe_recon.card(dev, subsample))

    shards.run(check, owners)

    def gather(parts: list) -> torch.Tensor:
        """The owning bands' (1, rows, dw) parts as one plane on lead."""
        return torch.cat([shards.move(parts[i], k, None, lead)
                          for i, k in enumerate(owners)], dim=1)

    lum_orig = gather([band_in[k].lum_orig for k in owners])

    def probe(mid: torch.Tensor) -> torch.Tensor:
        mids = {k: shards.move(mid, None, k) for k in owners}
        return gather(shards.run(
            lambda k: _compress.probe_luminance(band_in[k], mids[k]),
            owners))

    t, lo0 = _compress._search_targets([target], lead)
    best_q, best_ssim, found = _compress.bisect(lum_orig, probe, t, lo0)

    final_q = torch.where(found, best_q, 100)
    finals = [shards.move(final_q, None, k) for k in range(len(bands))]

    def quantize(k: int):
        # The band's blocks are its own rows of its coefficient planes.
        rows = bands[k].stop - bands[k].start
        blocks = tuple(dct_ops.to_blocks(p[0, :rows // (div if c else 1)])
                       for c, p in enumerate(band_in[k].cplanes))
        return quantize_coefs(blocks, band_in[k].tables[finals[k]][0])

    blocks = shards.run(quantize)
    blocks = tuple(torch.cat([shards.move(x, k, None, lead)
                              for k, x in enumerate(col)])
                   for col in zip(*blocks))
    return best_q[0], best_ssim[0], found[0], blocks
