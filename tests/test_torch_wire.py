"""The coefficient batch path's compact upload routes of the PyTorch port
against the JAX package, on the CPU.

The plain versions of kernel K6 (fennec_tpu_torch/ops/coef_wire.py) take
the port's image-leading layout; the JAX rebuilds (_coo_to_natural,
_i8_zigzag_to_natural, _csr_to_slots) take the same logical arrays in
their flat layout (exception rows with an image index, CSR streams
concatenated with a base per image).  Both must give exactly the blocks
decode_jpeg_to_coefs gives each file: tolerance 0, they are integers.
Cases: photo content, noise at Q100 (values past int8 and more AC
nonzeros than COO slots), 4:4:4, ragged sizes (17x9, 513x700) and a
slot width R smaller than the census picks.

Then the engine: compress_jpeg_bytes_batched on each route is
byte-identical to per-image compress_bytes, the route read from the
counters' events; an out-of-memory halved chunk and a two-shard CPU mesh
on the COO and CSR routes; a corrupt file fails alone.
"""

import functools

import numpy as np
import pytest
import torch

import fennec_tpu as J
import fennec_tpu_torch as T
from fennec_tpu.parallel import batched as jpb
from fennec_tpu_torch import native
from fennec_tpu_torch.codecs import jpeg as tjpeg
from fennec_tpu_torch.engine import batched as tbatched
from fennec_tpu_torch.ops import coef_wire, coef_wire_cuda
from fennec_tpu_torch.ops.coef_wire_cuda import unpack_coo, unpack_csr
from fennec_tpu_torch.ops.dct import ZIGZAG
from fennec_tpu_torch.parallel import batched as pb

torch.set_num_threads(1)

CPU = "cpu"


def smooth(w, h, seed, noise=2.0):
    """Photo-like: slow waves and a gradient with mild per-pixel noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(x / 17 + seed),
                     128 + 90 * np.cos(y / 23),
                     (x + y) * 255 / (w + h)], axis=-1)
    img = np.empty((h, w, 4), np.uint8)
    img[..., :3] = np.clip(base + rng.normal(0, noise, (h, w, 3)), 0, 255)
    img[..., 3] = 255
    return img


def noise(w, h, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                               dtype=np.uint8)
    img[..., 3] = 255
    return img


def jpeg(img, quality=92, subsample=True):
    return J.codecs.jpeg.encode_jpeg(img, quality, subsample=subsample)


# (name, files of one geometry, R of the COO case: None = the census's)
CASES = {
    "photo": lambda: [jpeg(smooth(64, 48, s)) for s in range(3)],
    "noise_q100": lambda: [jpeg(noise(40, 32, s), 100) for s in range(2)],
    "444": lambda: [jpeg(smooth(48, 40, s, 6.0), 95, False)
                    for s in range(2)],
    "ragged_17x9": lambda: [jpeg(noise(17, 9, s), 97) for s in range(3)],
    "ragged_513x700": lambda: [jpeg(smooth(513, 700, 5, 5.0), 90)],
}
FORCED_R = {"photo": 2, "noise_q100": 16, "444": 4, "ragged_17x9": 6,
            "ragged_513x700": 2}


def dense_blocks(datas):
    out = []
    for d in datas:
        _, coefs = tjpeg.decode_jpeg_to_coefs(d)
        out.append(np.concatenate(coefs))
    return np.stack(out)


def pack_exceptions(parts):
    """Per-image (offsets, values) → the port's (B, E) rows and counts."""
    e = max((p[0].size for p in parts), default=0)
    off = np.zeros((len(parts), e), np.int32)
    val = np.zeros((len(parts), e), np.int16)
    n = np.zeros(len(parts), np.int32)
    for j, (ei, ev) in enumerate(parts):
        n[j] = ei.size
        off[j, :ei.size] = ei
        val[j, :ei.size] = ev
    return [torch.from_numpy(x) for x in (off, val, n)]


def jax_exceptions(parts):
    """The same exceptions as the JAX package's flat (image, offset,
    value) rows."""
    import jax.numpy as jnp

    ej = np.concatenate([np.full(p[0].size, j, np.int32)
                         for j, p in enumerate(parts)] + [np.zeros(0,
                                                                   np.int32)])
    ei = np.concatenate([p[0] for p in parts] + [np.zeros(0, np.int32)])
    ev = np.concatenate([p[1] for p in parts] + [np.zeros(0, np.int16)])
    return jnp.asarray(ej), jnp.asarray(ei), jnp.asarray(ev.astype(np.int32))


def coo_decode(datas, r):
    nt = dense_blocks(datas[:1]).shape[1]
    b = len(datas)
    dc = np.zeros((b, nt), np.int8)
    pos = np.zeros((b, nt, r), np.uint8)
    val = np.zeros((b, nt, r), np.int8)
    parts, hists = [], []
    for j, d in enumerate(datas):
        got = tjpeg.decode_jpeg_to_coefs_coo(d, dc[j], pos[j], val[j],
                                             max_exc=1 << 20)
        assert got is not None
        _, ei, ev, hist, _ = got
        parts.append((ei, ev))
        hists.append(hist)
    return dc, pos, val, parts, np.sum(hists, axis=0)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("forced", [False, True], ids=["census_r", "small_r"])
def test_coo_rebuild_matches_jax_and_decode(name, forced):
    datas = CASES[name]()
    want = dense_blocks(datas)
    b, nt = want.shape[:2]
    r = coef_wire_census_r(datas) if not forced else FORCED_R[name]
    dc, pos, val, parts, _ = coo_decode(datas, r)
    got = coef_wire.coo_to_natural(torch.from_numpy(dc),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(val),
                                   *pack_exceptions(parts))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    import jax.numpy as jnp

    ref = jpb._coo_to_natural(jnp.asarray(dc), jnp.asarray(pos),
                              jnp.asarray(val), *jax_exceptions(parts))
    np.testing.assert_array_equal(np.asarray(ref), want)
    # The wrapper takes the plain version for CPU tensors.
    before = unpack_coo.plain_calls
    again = unpack_coo(torch.from_numpy(dc), torch.from_numpy(pos),
                       torch.from_numpy(val), *pack_exceptions(parts))
    assert unpack_coo.plain_calls == before + 1 and unpack_coo.launches == 0
    assert torch.equal(again, got)


def coef_wire_census_r(datas):
    nt = dense_blocks(datas[:1]).shape[1]
    *_, hist = coo_decode(datas, 16)
    return tbatched._census_r(hist, len(datas), nt)[0]


def test_noise_needs_exceptions_and_overflow():
    """The Q100 noise case holds values past int8 and blocks with more
    AC nonzeros than 16 slots: both kinds of exception are exercised."""
    datas = CASES["noise_q100"]()
    dc, pos, val, parts, hist = coo_decode(datas, 16)
    assert hist[17:].sum() > 0
    assert all(p[0].size > 0 for p in parts)
    assert np.abs(dense_blocks(datas)).max() > 127


@pytest.mark.parametrize("name", sorted(CASES))
def test_i8_rebuild_matches_jax_and_decode(name):
    import jax.numpy as jnp

    datas = CASES[name]()
    want = dense_blocks(datas)
    b, nt = want.shape[:2]
    full = np.zeros((b, nt, 64), np.int8)
    parts, maxks = [], []
    for j, d in enumerate(datas):
        got = tjpeg.decode_jpeg_to_coefs_i8(d, full[j], max_exc=1 << 20)
        assert got is not None
        _, ei, ev, mk = got
        parts.append((ei, ev))
        maxks.append(mk)
    k = max(maxks)
    assert not full[:, :, k:].any()
    parts = [((ei // 64) * k + ei % 64, ev) for ei, ev in parts]
    i8 = np.ascontiguousarray(full[:, :, :k])
    got = coef_wire.i8_to_natural(torch.from_numpy(i8),
                                  *pack_exceptions(parts))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jpb._i8_zigzag_to_natural(jnp.asarray(i8), *jax_exceptions(parts))
    np.testing.assert_array_equal(np.asarray(ref), want)


def csr_sections(pos, val):
    occ = pos != 0
    counts = occ.sum(axis=2).astype(np.uint8)
    per_img = counts.sum(axis=1, dtype=np.int64)
    m = int(per_img.max())
    spos = np.zeros((pos.shape[0], m), np.uint8)
    sval = np.zeros((pos.shape[0], m), np.int8)
    for j in range(pos.shape[0]):
        spos[j, :per_img[j]] = pos[j][occ[j]]
        sval[j, :per_img[j]] = val[j][occ[j]]
    return counts, spos, sval, per_img


@pytest.mark.parametrize("name", sorted(CASES))
def test_csr_rebuild_matches_jax_and_decode(name):
    import jax.numpy as jnp

    datas = CASES[name]()
    want = dense_blocks(datas)
    dc, pos, val, parts, _ = coo_decode(datas, 16)
    counts, spos, sval, per_img = csr_sections(pos, val)
    got = coef_wire.csr_to_natural(
        torch.from_numpy(dc), torch.from_numpy(counts),
        torch.from_numpy(spos), torch.from_numpy(sval),
        *pack_exceptions(parts))
    np.testing.assert_array_equal(got.numpy(), want)
    again = unpack_csr(torch.from_numpy(dc), torch.from_numpy(counts),
                       torch.from_numpy(spos), torch.from_numpy(sval),
                       *pack_exceptions(parts))
    assert torch.equal(again, got)
    # JAX: the streams concatenated, each image's start in `base`.
    flat_pos = np.concatenate([spos[j, :per_img[j]]
                               for j in range(len(datas))])
    flat_val = np.concatenate([sval[j, :per_img[j]]
                               for j in range(len(datas))])
    base = (np.cumsum(per_img) - per_img).astype(np.int32)
    r_active = 1
    while r_active < max(int(counts.max()), 1):
        r_active *= 2
    jpos, jval = jpb._csr_to_slots(
        jnp.asarray(counts.astype(np.int8)), jnp.asarray(base),
        jnp.asarray(flat_pos.view(np.int8)), jnp.asarray(flat_val),
        r_active)
    ref = jpb._coo_to_natural(jnp.asarray(dc), jpos, jval,
                              *jax_exceptions(parts))
    np.testing.assert_array_equal(np.asarray(ref), want)


def test_exception_rows_past_count_and_outside_are_dropped():
    """Dead rows (past exc_n) and offsets outside the image change
    nothing: the JAX scatter's mode="drop"."""
    dc = torch.tensor([[5, -3]], dtype=torch.int8)
    pos = torch.tensor([[[1, 0], [2, 3]]], dtype=torch.uint8)
    val = torch.tensor([[[7, 0], [-1, 2]]], dtype=torch.int8)
    off = torch.tensor([[64 + 5, 1, 2 * 64, -1]], dtype=torch.int32)
    exc_val = torch.tensor([[300, 9, 11, 13]], dtype=torch.int16)
    n = torch.tensor([3], dtype=torch.int32)
    got = coef_wire.coo_to_natural(dc, pos, val, off, exc_val, n)
    want = np.zeros((1, 2, 64), np.int16)
    want[0, 0, ZIGZAG[0]] = 5
    want[0, 0, ZIGZAG[1]] = 9  # the exception, set after the pair's 7
    want[0, 1, ZIGZAG[0]] = -3
    want[0, 1, ZIGZAG[2]] = -1
    want[0, 1, ZIGZAG[3]] = 2
    want[0, 1, ZIGZAG[5]] = 300
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["pos_dtype", "exc_shape", "r_zero",
                                 "k_wide"])
def test_layout_checks_raise(bad):
    dc = torch.zeros((2, 3), dtype=torch.int8)
    pos = torch.zeros((2, 3, 2), dtype=torch.uint8)
    val = torch.zeros((2, 3, 2), dtype=torch.int8)
    exc = [torch.zeros((2, 1), dtype=torch.int32),
           torch.zeros((2, 1), dtype=torch.int16),
           torch.zeros((2,), dtype=torch.int32)]
    with pytest.raises(ValueError):
        if bad == "pos_dtype":
            unpack_coo(dc, pos.to(torch.int8), val, *exc)
        elif bad == "exc_shape":
            unpack_coo(dc, pos, val, exc[0][:1], exc[1][:1], exc[2])
        elif bad == "r_zero":
            unpack_coo(dc, pos[:, :, :0], val[:, :, :0], *exc)
        else:
            coef_wire.i8_to_natural(torch.zeros((2, 3, 65), dtype=torch.int8),
                                    *exc)


def test_int16_to_int8_exc_matches_numpy():
    rng = np.random.default_rng(3)
    src = rng.integers(-600, 600, (7, 64)).astype(np.int16)
    out = np.empty((7, 64), np.int8)
    ei, ev = native.int16_to_int8_exc(src, out)
    big = np.abs(src) > 127
    np.testing.assert_array_equal(ei, np.nonzero(big.reshape(-1))[0])
    np.testing.assert_array_equal(ev, src[big])
    np.testing.assert_array_equal(out, np.where(big, 0, src))


def test_decoders_check_the_buffer_against_the_grid():
    data = jpeg(smooth(64, 48, 1))
    with pytest.raises(ValueError):
        tjpeg.decode_jpeg_to_coefs_i8(data, np.zeros((5, 64), np.int8))
    nt = dense_blocks([data]).shape[1]
    with pytest.raises(ValueError):
        tjpeg.decode_jpeg_to_coefs_coo(
            data, np.zeros(nt, np.int8), np.zeros((nt, 4), np.int8),
            np.zeros((nt, 4), np.int8))
    # Data the C++ decoder rejects (here: more exceptions than allowed)
    # is "does not apply": None, and the dense route takes the file.
    data = jpeg(noise(40, 32, 1), 100)
    nt = dense_blocks([data]).shape[1]
    assert tjpeg.decode_jpeg_to_coefs_coo(
        data, np.zeros(nt, np.int8), np.zeros((nt, 4), np.uint8),
        np.zeros((nt, 4), np.int8), max_exc=0) is None
    assert tjpeg.decode_jpeg_to_coefs_i8(
        data, np.zeros((nt, 64), np.int8), max_exc=0) is None


# ── The engine ──────────────────────────────────────────────────────────────


@pytest.fixture(autouse=True)
def fresh_counters(monkeypatch):
    for var in ("FENNEC_UPLOAD", "FENNEC_COO"):
        monkeypatch.delenv(var, raising=False)
    tbatched.counters.reset()
    yield


def route_run(datas, opts, **kw):
    tbatched.counters.reset()
    got = tbatched.compress_jpeg_bytes_batched(None, datas, opts, device=CPU,
                                               **kw)
    snap = tbatched.counters.snapshot()
    return got, {k: v for k, v in snap["events"].items()
                 if k.startswith("upload_")}, snap


def per_image(datas, opts):
    return [T.compress_bytes(None, d, opts, device=CPU).compressed_data
            for d in datas]


PHOTOS = [jpeg(smooth(64, 48, s)) for s in range(5)]
NOISE = [jpeg(noise(40, 32, s), 100) for s in range(3)]


@pytest.mark.parametrize("route,env,datas,kw,events", [
    ("coo", {}, "photos", {"chunk_size": 2}, {"upload_coo": 3}),
    ("i8_noise", {}, "noise", {}, {"upload_i8": 1}),
    ("csr", {"FENNEC_UPLOAD": "csr"}, "photos", {"chunk_size": 2},
     {"upload_csr": 3}),
    ("coo_off", {"FENNEC_COO": "0"}, "photos", {}, {"upload_i8": 1}),
    ("dense", {"FENNEC_UPLOAD": "dense"}, "photos", {"chunk_size": 3},
     {"upload_i8": 2}),
    ("resize", {}, "photos", {}, {"upload_int16": 1}),
    ("device_entropy", {}, "photos", {}, {"upload_coo": 1}),
], ids=lambda x: x if isinstance(x, str) else None)
def test_route_bytes_equal_per_image(monkeypatch, route, env, datas, kw,
                                     events):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    datas = PHOTOS if datas == "photos" else NOISE
    opts = T.Options(format=T.JPEG)
    if route == "resize":
        opts = T.Options(format=T.JPEG, max_width=40)
    if route == "device_entropy":
        opts = T.Options(format=T.JPEG, device_entropy=True)
    got, ev, _ = route_run(datas, opts, **kw)
    assert ev == events
    assert [r.compressed_data for r in got] == per_image(datas, opts)


def test_coo_uploads_fewer_bytes_than_int16():
    opts = T.Options(format=T.JPEG)
    _, ev, snap = route_run(PHOTOS, opts)
    assert ev == {"upload_coo": 1}
    assert snap["uploaded_bytes"] < len(PHOTOS) * 48 * 2 * 64 * 2 / 2


def test_a_corrupt_file_fails_alone_on_the_dense_route():
    datas = list(PHOTOS[:3])
    datas[1] = datas[1][:len(datas[1]) - 200]  # cut inside the scan
    datas.insert(2, datas[0][:300])  # cut inside the header
    opts = T.Options(format=T.JPEG)
    errors = {}
    tbatched.counters.reset()
    try:
        got = tbatched.compress_jpeg_bytes_batched(
            None, datas, opts, device=CPU, qualify_key=(64, 48, True),
            on_error=errors.__setitem__)
    except tbatched.FusedChunkError as exc:
        got = None
        assert exc.failed_ids == sorted(errors)
    assert 2 in errors
    want = per_image([datas[0], datas[3]], opts)
    assert got is None or got[0].compressed_data == want[0]
    ev = tbatched.counters.snapshot()["events"]
    assert ev == {"upload_i8": 1}


def test_sticky_coo_writes_pinned_rows_at_the_census_r(monkeypatch):
    """After a COO chunk, the next chunks decode straight into their
    upload tensors at the last census's R."""
    seen = []
    real = tbatched._CoefWire._sticky

    def spy(self, ids):
        seen.append(self.sticky_r)
        return real(self, ids)

    monkeypatch.setattr(tbatched._CoefWire, "_sticky", spy)
    got, ev, _ = route_run(PHOTOS, T.Options(format=T.JPEG), chunk_size=2)
    assert ev == {"upload_coo": 3} and len(seen) == 2 and all(seen)
    assert [r.compressed_data for r in got] == \
        per_image(PHOTOS, T.Options(format=T.JPEG))


def oom_above(real, limit, sizes):
    def fn(blocks, *rest):
        sizes.append(blocks.shape[0])
        if blocks.shape[0] > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(blocks, *rest)

    return fn


@pytest.mark.parametrize("env,event", [({}, "upload_coo"),
                                       ({"FENNEC_UPLOAD": "csr"},
                                        "upload_csr")])
def test_oom_halves_a_compact_chunk(monkeypatch, env, event):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    opts = T.Options(format=T.JPEG)
    sizes = []
    monkeypatch.setattr(pb, "batched_decode_resize_search_quantize",
                        oom_above(pb.batched_decode_resize_search_quantize,
                                  2, sizes))
    got, ev, snap = route_run(PHOTOS, opts)
    assert ev == {event: 1}
    assert sizes == [5, 2, 3, 1, 2]
    assert snap["chunk_items"] == [2, 1, 2]
    assert [r.compressed_data for r in got] == per_image(PHOTOS, opts)


@pytest.mark.parametrize("env,event", [({}, "upload_coo"),
                                       ({"FENNEC_UPLOAD": "csr"},
                                        "upload_csr")])
def test_two_shard_cpu_mesh_equals_one_device(monkeypatch, env, event):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    opts = T.Options(format=T.JPEG)
    one, ev1, _ = route_run(PHOTOS, opts)
    tbatched.counters.reset()
    two = tbatched.compress_jpeg_bytes_batched(None, PHOTOS, opts,
                                               device=[CPU, CPU])
    ev2 = tbatched.counters.snapshot()["events"]
    assert ev1 == {event: 1} and ev2 == {event: 1}
    assert [r.compressed_data for r in two] == \
        [r.compressed_data for r in one]


def test_unknown_upload_layout_raises(monkeypatch):
    monkeypatch.setenv("FENNEC_UPLOAD", "bogus")
    with pytest.raises(ValueError):
        tbatched.compress_jpeg_bytes_batched(None, PHOTOS[:1],
                                             T.Options(format=T.JPEG),
                                             device=CPU)


def test_compress_batch_goes_through_coo(tmp_path):
    items = []
    for i, d in enumerate(PHOTOS):
        src = tmp_path / f"in{i}.jpg"
        src.write_bytes(d)
        items.append(T.BatchItem(src=str(src), dst=str(tmp_path / f"o{i}.jpg")))
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, default_opts=T.Options(format=T.JPEG)), device=CPU)
    snap = tbatched.counters.snapshot()
    assert snap["routes"] == {"coefficient": 5}
    assert snap["events"].get("upload_coo") == 1
    want = per_image(PHOTOS, T.Options(format=T.JPEG))
    assert [open(r.item.dst, "rb").read() for r in res] == want


# ── K6's tile engine, modelled ──────────────────────────────────────────────
#
# A plain-Python model of csrc/coef_wire.cu's walk, step for step: the
# persistent CTAs' tiles of TILE blocks, each section's span staged as the
# aligned 16-byte chunks that cover it from a base address of any
# alignment (a chunk must hold a byte of its section: the kernel reads no
# other memory), COO's p / R as a multiply by ceil(2^32 / R), int8's
# gather through the inverse zigzag, CSR's per-image scan (tile sums of
# masked words as __dp4a sums them), its spans and its binary search of a
# pair's block, and the exception units.  Held to the plain versions on
# chip_smoke.k6_cases and on the decoded CASES, at two sets of addresses.

INV = np.argsort(ZIGZAG)  # the zigzag position of natural index n
WALK_GRIDS = (1, 7)


@functools.lru_cache(maxsize=1)
def chip_smoke():
    """The chip_smoke.py module of this checkout (pure numpy and torch
    where these tests call it)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=1)
def k6_cases():
    return chip_smoke().k6_cases()


def cover(n):
    """Shared bytes that hold the chunks covering n bytes (the kernel's
    cover)."""
    return (n + 30 + 15) // 16 * 16


class Section:
    """A section's bytes at address `addr`: reads are whole aligned
    16-byte chunks, and every chunk read must hold one of its bytes;
    bytes around the section read as 0xA5."""

    def __init__(self, t: torch.Tensor, addr: int):
        self.raw = t.contiguous().view(-1).view(torch.uint8).numpy()
        self.addr = addr
        self.padded = np.concatenate([np.full(16, 0xA5, np.uint8), self.raw,
                                      np.full(32, 0xA5, np.uint8)])

    def chunks(self, lo, hi):
        """(first chunk's address, count, head) covering bytes [lo, hi)."""
        a = (self.addr + lo) & ~15
        e = (self.addr + hi + 15) & ~15
        return a, (e - a) // 16 if hi > lo else 0, self.addr + lo - a

    def stage(self, lo, hi):
        """The staged chunks of [lo, hi) as one byte array, and the head:
        where byte lo lands in it."""
        a, n, head = self.chunks(lo, hi)
        start = a - self.addr
        assert n == 0 or (start + 16 > 0
                          and start + 16 * (n - 1) < self.raw.size), \
            "a chunk outside its section"
        return self.padded[start + 16:start + 16 + 16 * n], head


def walk(tiles, grid):
    """The tiles in the order the persistent CTAs take them."""
    return [g for c in range(min(grid, tiles)) for g in range(c, tiles, grid)]


def model_exceptions(out, exc, nt, width):
    """exceptions_kernel: units of 128 rows of one image, live rows with
    an offset inside the image set at their natural position."""
    off, val, n = (x.numpy() for x in exc)
    bsz, e = off.shape
    per = -(-e // 128)
    for u in range(bsz * per):
        img, first = u // per, (u % per) * 128
        live = min(max(int(n[img]), 0), e)
        if first >= live:
            continue
        o = off[img, first:min(first + 128, live)].astype(np.int64)
        v = val[img, first:min(first + 128, live)]
        ok = (o >= 0) & (o < nt * width)
        out[img * nt + o[ok] // width, ZIGZAG[o[ok] % width]] = v[ok]


def model_coo(secs, addrs, grid):
    dc, pos, val, *exc = secs
    bsz, nt, r = pos.shape
    nblocks, magic = bsz * nt, ((1 << 32) + r - 1) // r
    mem = [Section(t, a) for t, a in zip((dc, pos, val), addrs)]
    out = np.full((nblocks, 64), 0x5A5A, np.int16)
    writes = np.zeros(nblocks, np.int64)
    for g in walk(-(-nblocks // coef_wire_cuda.TILE), grid):
        b0 = g * coef_wire_cuda.TILE
        b1 = min(b0 + coef_wire_cuda.TILE, nblocks)
        n = b1 - b0
        (dcs, hd), (ps, hp), (vs, hv) = (m.stage(b0 * w, b1 * w) for m, w in
                                         zip(mem, (1, r, r)))
        tile = np.zeros((n, 64), np.int16)
        tile[:, 0] = dcs[hd:hd + n].view(np.int8)
        p = np.arange(n * r, dtype=np.int64)
        q = ps[hp + p] & 63
        j = (p * magic) >> 32
        live = q != 0
        tile[j[live], ZIGZAG[q[live]]] = vs[hv + p[live]].view(np.int8)
        out[b0:b1] = tile
        writes[b0:b1] += 1
    assert (writes == 1).all()
    model_exceptions(out, exc, nt, 64)
    return out.reshape(bsz, nt, 64)


def model_i8(secs, addrs, grid):
    i8, *exc = secs
    bsz, nt, k = i8.shape
    nblocks = bsz * nt
    mem = Section(i8, addrs[0])
    out = np.full((nblocks, 64), 0x5A5A, np.int16)
    writes = np.zeros(nblocks, np.int64)
    for g in walk(-(-nblocks // coef_wire_cuda.TILE), grid):
        b0 = g * coef_wire_cuda.TILE
        b1 = min(b0 + coef_wire_cuda.TILE, nblocks)
        wire, head = mem.stage(b0 * k, b1 * k)
        blk = wire[head:head + (b1 - b0) * k].view(np.int8).reshape(-1, k)
        out[b0:b1] = np.where(INV < k, blk[:, np.minimum(INV, k - 1)], 0)
        writes[b0:b1] += 1
    assert (writes == 1).all()
    model_exceptions(out, exc, nt, k)
    return out.reshape(bsz, nt, 64)


def span_sums(sec, lo, hi):
    """span_sum over arrays of spans [lo, hi) (at most TILE bytes each):
    each span's covering chunks read, each 4-byte word masked to the
    span, the bytes kept summed."""
    x0 = sec.addr + lo
    a = x0 & ~15
    first, end = x0 - a, x0 - a + hi - lo
    padded = np.concatenate([np.full(16, 0xA5, np.uint8), sec.raw,
                             np.full(96, 0xA5, np.uint8)]).astype(np.int64)
    total = np.zeros(lo.shape, np.int64)
    for i in range((coef_wire_cuda.TILE + 30) // 16):
        read = 16 * i < end
        start = a + 16 * i - sec.addr
        assert ((start < sec.raw.size) & (start + 16 > 0))[read].all(), \
            "a chunk outside its section"
        for k in range(4):
            f = np.clip(first - 16 * i - 4 * k, 0, 4)
            ln = np.clip(end - 16 * i - 4 * k, 0, 4)
            for b in range(4):
                keep = read & (f <= b) & (b < ln)
                total += np.where(keep, padded[np.where(
                    keep, start + 4 * k + b + 16, 0)], 0)
    return total


def csr_bases(counts, addr):
    """csr_scan_kernel: (B, tiles + 1) each tile's first pair in its
    image, then the image's pairs."""
    bsz, nt = counts.shape
    tile_n = coef_wire_cuda.TILE
    t = np.arange(-(-nt // tile_n), dtype=np.int64)
    row = np.arange(bsz, dtype=np.int64)[:, None] * nt
    sums = span_sums(Section(counts, addr), row + t * tile_n,
                     row + np.minimum((t + 1) * tile_n, nt))
    return np.concatenate([np.zeros((bsz, 1), np.int64),
                           np.cumsum(sums, axis=1)], axis=1)


def model_csr(secs, addrs, grid):
    dc, counts, spos, sval, *exc = secs
    bsz, nt = dc.shape
    m = spos.shape[1]
    tile_n = coef_wire_cuda.TILE
    tiles = -(-nt // tile_n)
    base = csr_bases(counts, addrs[1])
    mem = [Section(t, a) for t, a in zip((dc, counts, spos, sval), addrs)]
    out = np.full((bsz * nt, 64), 0x5A5A, np.int16)
    writes = np.zeros(bsz * nt, np.int64)
    for g in walk(bsz * tiles, grid):
        img, t = divmod(g, tiles)
        b0 = img * nt + t * tile_n
        b1 = img * nt + min((t + 1) * tile_n, nt)
        n = b1 - b0
        (dcs, hd), (cs, hc) = (s.stage(b0, b1) for s in mem[:2])
        lo, hi = min(base[img, t], m), min(base[img, t + 1], m)
        staged = min(hi, lo + tile_n * 64)
        (ps, hp), (vs, hv) = (s.stage(img * m + lo, img * m + staged)
                              for s in mem[2:])
        tile = np.zeros((n, 64), np.int16)
        tile[:, 0] = dcs[hd:hd + n].view(np.int8)
        cnt = cs[hc:hc + n].astype(np.int64)
        start = np.full(64, np.iinfo(np.int32).max, np.int64)
        start[:n] = np.cumsum(cnt) - cnt
        q = np.arange(hi - lo, dtype=np.int64)
        j = np.zeros(q.size, np.int64)
        for step in (32, 16, 8, 4, 2, 1):
            j = np.where(start[j + step] <= q, j + step, j)
        inside = q < staged - lo
        pq = np.where(inside, ps[hp + np.minimum(q, staged - lo - 1)],
                      spos[img].numpy()[np.minimum(lo + q, m - 1)]) & 63
        v = np.where(inside, vs[hv + np.minimum(q, staged - lo - 1)],
                     sval[img].numpy().view(np.uint8)[
                         np.minimum(lo + q, m - 1)]).view(np.int8)
        live = pq != 0
        tile[j[live], ZIGZAG[pq[live]]] = v[live]
        out[b0:b1] = tile
        writes[b0:b1] += 1
    assert (writes == 1).all()
    model_exceptions(out, exc, nt, 64)
    return out.reshape(bsz, nt, 64)


MODELS = {"coo": model_coo, "i8": model_i8, "csr": model_csr}
PLAIN = {"coo": coef_wire.coo_to_natural, "i8": coef_wire.i8_to_natural,
         "csr": coef_wire.csr_to_natural}
# Each byte section's address: 16-byte aligned, and skewed (heads 3, 7,
# 13, 9 into their chunks).
ADDRS = {"aligned": (0, 0, 0, 0), "skewed": (3, 7, 13, 9)}


@pytest.mark.parametrize("index", range(27))
def test_k6_model_matches_plain_on_the_card_cases(index):
    """The model of K6 bit for bit against the plain version on
    chip_smoke.k6_cases (every R and K, tiles cut short, CSR with an
    image of no pairs and a second round of the scan, E = 0, exception
    rows at DC and the last coefficient, dead rows, offsets outside the
    image, rows in no order, rows 1.. of a chunk), aligned and skewed,
    walked by one CTA and by seven."""
    tag, layout, secs = k6_cases()[index]
    if tag.endswith("_rows1"):
        secs = [x[1:] for x in secs]
    want = PLAIN[layout](*secs).numpy()
    for grid, addrs in zip(WALK_GRIDS, ADDRS.values()):
        np.testing.assert_array_equal(MODELS[layout](secs, addrs, grid),
                                      want)


def test_k6_cases_are_all_tested():
    assert len(k6_cases()) == 27


def wire_of(name):
    """Each layout's sections of CASES[name], built as the engine builds
    them: COO at the census's R, int8 cut at K, CSR from the census."""
    datas = CASES[name]()
    r = coef_wire_census_r(datas)
    dc, pos, val, parts, _ = coo_decode(datas, 16)
    counts, spos, sval, _ = csr_sections(pos, val)
    coo_parts = []
    for j, (ei, ev) in enumerate(parts):
        blk, slot = np.nonzero(pos[j, :, r:])
        coo_parts.append((np.concatenate([ei, (blk * 64 + pos[j, blk, slot + r])
                                          .astype(np.int32)]),
                          np.concatenate([ev, val[j, blk, slot + r]
                                          .astype(np.int16)])))
    full = np.zeros((len(datas), pos.shape[1], 64), np.int8)
    i8_parts, k = [], 1
    for j, d in enumerate(datas):
        _, ei, ev, mk = tjpeg.decode_jpeg_to_coefs_i8(d, full[j],
                                                      max_exc=1 << 20)
        i8_parts.append((ei, ev))
        k = max(k, mk)
    t = torch.from_numpy
    return dense_blocks(datas), {
        "coo": [t(dc), t(np.ascontiguousarray(pos[:, :, :r])),
                t(np.ascontiguousarray(val[:, :, :r])),
                *pack_exceptions(coo_parts)],
        "i8": [t(np.ascontiguousarray(full[:, :, :k])),
               *pack_exceptions([((ei // 64) * k + ei % 64, ev)
                                 for ei, ev in i8_parts])],
        "csr": [t(dc), t(counts), t(spos), t(sval), *pack_exceptions(parts)]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_k6_model_matches_plain_and_decoder(name):
    """The model of K6 on each layout of the decoded CASES equals the
    plain version and the C++ decoder's blocks, aligned and skewed."""
    want, sections = wire_of(name)
    for layout, secs in sections.items():
        np.testing.assert_array_equal(PLAIN[layout](*secs).numpy(), want)
        for grid, addrs in zip(WALK_GRIDS, ADDRS.values()):
            np.testing.assert_array_equal(
                MODELS[layout](secs, addrs, grid), want)


@pytest.mark.parametrize("bsz,nt", [(1, 1), (1, 63), (1, 64), (1, 65),
                                    (3, 101), (64, 6144), (2, 70_000)])
@pytest.mark.parametrize("grid", [1, 7, 132 * 6])
def test_k6_walk_covers_every_block_once(bsz, nt, grid):
    """The flat walk (COO, int8) and the per-image walk (CSR) cover every
    block of the chunk exactly once."""
    tile_n = coef_wire_cuda.TILE
    flat = np.zeros(bsz * nt, np.int64)
    for g in walk(-(-bsz * nt // tile_n), grid):
        flat[g * tile_n:min((g + 1) * tile_n, bsz * nt)] += 1
    tiles = -(-nt // tile_n)
    per_image = np.zeros(bsz * nt, np.int64)
    for g in walk(bsz * tiles, grid):
        img, t = divmod(g, tiles)
        per_image[img * nt + t * tile_n:img * nt + min((t + 1) * tile_n,
                                                       nt)] += 1
    assert (flat == 1).all() and (per_image == 1).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_k6_csr_spans_start_at_the_plain_starts(name):
    """The scan's tile bases, summed from masked words at any head, are
    the plain csr_slots' starts at each tile's first block; the last is
    the image's pairs."""
    _, sections = wire_of(name)
    counts = sections["csr"][1]
    start = (torch.cumsum(counts.long(), 1) - counts.long()).numpy()
    tile_n = coef_wire_cuda.TILE
    for addr in range(16):
        base = csr_bases(counts, addr)
        np.testing.assert_array_equal(base[:, :-1], start[:, ::tile_n])
        np.testing.assert_array_equal(base[:, -1], counts.long().sum(1))


def test_k6_stages_hold_every_span():
    """At every head, the chunks that cover a span hold all its bytes,
    each holds one of them, and they fit the stage the kernel gives the
    span (cover of its longest)."""
    for head in range(16):
        for length in list(range(0, 130)) + [4031, 4032, 4095, 4096]:
            sec = Section(torch.zeros(length + 32, dtype=torch.uint8), head)
            a, n, h = sec.chunks(5, 5 + length)
            if length == 0:
                assert n == 0
                continue
            assert a <= head + 5 < a + 16 and h == head + 5 - a
            assert a + 16 * n >= head + 5 + length > a + 16 * (n - 1)
            assert 16 * n <= cover(length)


def test_k6_coo_magic_divides():
    """p * ceil(2^32 / R) >> 32 is p // R for every pair of a tile."""
    p = np.arange(coef_wire_cuda.TILE * 63, dtype=np.int64)
    for r in range(1, 64):
        magic = ((1 << 32) + r - 1) // r
        np.testing.assert_array_equal((p * magic) >> 32, p // r)
