"""The probe reconstruction (kernel K2's function) on the CPU, against the
JAX package.

On a CUDA device engine/compress.probe_luminance launches kernel K2
(csrc/probe_recon.cu); on the CPU it runs probe_luminance_plain, which
these tests hold to the JAX package's probe (_reconstruct_rgb_planes →
_box_down_plane → luminance of fennec_tpu/engine/compress.py, jitted on
the CPU) on the same numpy inputs.  Tolerance: the two frameworks sum the
IDCT's and the box mean's products in different orders, so a value within
an ulp of k + 0.5 may round to the other level; levels are otherwise
equal.  Stated below: at most 1 pixel in 1 000 differs, none by more than
one level per channel (1.0 in luminance), and windowed SSIM agrees within
1e-5.

Also here, all in pure Python or plain torch: the rectangles K2 reads
(ops/filters.box_bounds, box_cover) against box_weights' nonzero spans;
K2's exact integer box mean (box_mean_exact) against the float32 matrix
products of _box_down_plane, which may differ only where the exact mean
is k + 1/2; the wrapper's checks; and the kernel's source and build
flags.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import make_noise_image, make_test_image
from fennec_tpu.engine import compress as jcomp
from fennec_tpu.ops import dct as jdct
from fennec_tpu.ops.resize import box_resize_weights as jax_box_weights
from fennec_tpu_torch.engine import compress as tcomp
from fennec_tpu_torch.ops import probe_recon_cuda as k2
from fennec_tpu_torch.ops import resize as tresize
from fennec_tpu_torch.ops.filters import box_bounds, box_cover, box_weights
from fennec_tpu_torch.ops.ssim import batched_ssim_plain, ssim_fast_dims

torch.set_num_threads(1)
CPU = torch.device("cpu")
LEVEL_ATOL = 1.0 + 1e-3  # every channel one level off
DIFF_SHARE = 1e-3
SSIM_ATOL = 1e-5


def photo_like(w, h, seed):
    """Gradient plus noise, opaque: compressible but not flat."""
    img = make_test_image(w, h).astype(np.int32)
    noise = make_noise_image(w, h, seed=seed).astype(np.int32)
    out = np.clip((3 * img + noise) // 4, 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out


@jax.jit
def _jax_lum(r, g, b):
    return 0.299 * r + 0.587 * g + 0.114 * b


def jax_probe(inp, quality, subsample):
    """The JAX package's probe on the port's coefficient planes, image by
    image: reconstruction, box-down of r, g, b, luminance."""
    h, w = inp.h, inp.w
    ds_w, ds_h = ssim_fast_dims(w, h)
    recon = jax.jit(jcomp._reconstruct_rgb_planes, static_argnums=(4, 5, 6))
    down = jax.jit(jcomp._box_down_plane)
    tables = jdct.all_quality_tables().astype(np.float32)
    out = []
    for j, q in enumerate(quality):
        planes = [jnp.asarray(p[j].numpy()) for p in inp.cplanes]
        rgb = recon(*planes, jnp.asarray(tables[q]), subsample, h, w)
        if (ds_w, ds_h) != (w, h):
            wh, wv = jax_box_weights(w, h, ds_w, ds_h)
            rgb = [down(p, jnp.asarray(wh), jnp.asarray(wv)) for p in rgb]
        out.append(np.asarray(_jax_lum(*rgb)))
    return np.stack(out)


# (w, h, subsample, per-image qualities): both samplings, with and
# without the SSIMFast downsample, ragged sizes, under 8 px, a side that
# SSIMFast scales up to 8 rows.
PROBE_CASES = {
    "40x24_420": (40, 24, True, [60]),
    "40x24_444": (40, 24, False, [35]),
    "batch_70x50_420": (70, 50, True, [5, 50, 92]),
    "ragged_17x9_420": (17, 9, True, [80]),
    "ragged_9x17_444": (9, 17, False, [100]),
    "one_px_420": (1, 1, True, [50]),
    "five_px_444": (5, 3, False, [1]),
    "box_600x530_420": (600, 530, True, [30, 85]),
    "box_530x600_444": (530, 600, False, [55]),
    "box_odd_700x513_420": (700, 513, True, [70]),
    "box_wide_1000x9_420": (1000, 9, True, [60]),
    "box_up_600x3_444": (600, 3, False, [40]),
}


def search_inputs_of(w, h, subsample, n):
    imgs = np.stack([photo_like(w, h, seed=11 * k + w) for k in range(n)])
    x = torch.from_numpy(imgs).to(torch.float32)
    inp, _ = tcomp.prepare_search(x, subsample)
    return inp


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_probe_luminance_plain_matches_jax(name):
    w, h, subsample, quals = PROBE_CASES[name]
    inp = search_inputs_of(w, h, subsample, len(quals))
    q = torch.tensor(quals)
    got = tcomp.probe_luminance_plain(inp, q)
    ds_w, ds_h = ssim_fast_dims(w, h)
    assert got.shape == (len(quals), ds_h, ds_w)
    assert got.dtype == torch.float32
    want = jax_probe(inp, quals, subsample)
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= LEVEL_ATOL
    assert (diff > 1e-4).sum() <= max(1, DIFF_SHARE * diff.size)
    if min(ds_w, ds_h) > 8:
        s_t = batched_ssim_plain(inp.lum_orig, got.contiguous())
        s_j = batched_ssim_plain(inp.lum_orig, torch.from_numpy(want))
        assert float((s_t - s_j).abs().max()) <= SSIM_ATOL


@pytest.mark.parametrize("name", ["batch_70x50_420", "box_600x530_420"])
def test_probe_luminance_on_cpu_is_the_plain_version(name, monkeypatch):
    """CPU planes take the plain version, through probe_luminance and
    through the wrapper, and launch nothing; an image's luminance is the
    same alone and in its batch."""
    w, h, subsample, quals = PROBE_CASES[name]
    inp = search_inputs_of(w, h, subsample, len(quals))
    q = torch.tensor(quals)
    before = k2.probe_recon.launches
    want = tcomp.probe_luminance_plain(inp, q)
    assert torch.equal(tcomp.probe_luminance(inp, q), want)
    assert torch.equal(k2.probe_recon(inp, q), want)
    assert k2.probe_recon.launches == before
    assert inp.k2_state is None  # nothing prepared for a launch
    last = dataclasses.replace(
        inp, cplanes=tuple(p[-1:].contiguous() for p in inp.cplanes),
        lum_orig=inp.lum_orig[-1:].contiguous())
    assert torch.equal(tcomp.probe_luminance(last, q[-1:]), want[-1:])
    calls = []
    monkeypatch.setattr(tcomp, "probe_luminance_plain",
                        lambda i, qq: calls.append(1) or want)
    tcomp.probe_luminance(inp, q)
    assert calls == [1]


def test_search_inputs_carry_the_rectangles():
    small = search_inputs_of(70, 50, True, 1)
    assert small.box_rectangles is None and small.box_wh is None
    big = search_inputs_of(600, 530, True, 1)
    ds_w, ds_h = ssim_fast_dims(600, 530)
    want = tresize.box_rectangles(600, 530, ds_w, ds_h)[0]
    assert big.box_rectangles.dtype == torch.int32
    assert big.box_rectangles.shape == (2 * (ds_h + ds_w + 530 + 600),)
    np.testing.assert_array_equal(big.box_rectangles.numpy(), want)
    again = tresize.box_rectangles_device(600, 530, ds_w, ds_h, CPU)
    assert again is big.box_rectangles  # cached per geometry and device


# ── The rectangles ──────────────────────────────────────────────────────────


def spans_of(weights):
    """(s0, s1) of each row's nonzero span; (0, 0) for a row of zeros."""
    out = []
    for row in weights:
        nz = np.nonzero(row)[0]
        out.append((int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0))
    return out


def check_bounds(dst, src):
    s0, s1 = box_bounds(dst, src)
    assert s0.dtype == s1.dtype == np.int32 and s0.shape == s1.shape == (dst,)
    weights = box_weights(dst, src)
    for d, (a, b) in enumerate(spans_of(weights)):
        if b > a:
            assert (int(s0[d]), int(s1[d])) == (a, b)
            np.testing.assert_array_equal(weights[d, a:b], 1.0 / (b - a))
        else:
            assert s0[d] == s1[d]  # an empty rectangle
    assert (np.diff(s0) >= 0).all() and (np.diff(s1) >= 0).all()
    assert s0.min() >= 0 and s1.max() <= src
    lo, hi = box_cover(dst, src)
    for s in range(src):
        holds = [d for d in range(dst) if s0[d] <= s < s1[d]]
        assert holds == list(range(lo[s], hi[s]))


@pytest.mark.parametrize("dst,src", [(512, 4032), (384, 3024), (288, 1080),
                                     (512, 700), (375, 513), (8, 9), (8, 5),
                                     (8, 3), (8, 1), (1, 1), (8, 8),
                                     (300, 1000), (512, 513), (7, 50)])
def test_box_bounds_are_the_weights_spans(dst, src):
    check_bounds(dst, src)


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(st.integers(1, 96), st.integers(1, 400))
def test_box_bounds_sweep(dst, src):
    check_bounds(dst, src)


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(st.integers(513, 5000), st.integers(1, 5000))
def test_box_bounds_at_ssim_fast_geometries(w, h):
    """The geometries SSIMFast makes: every source pixel of a real
    downsample lies in exactly one rectangle of its axis."""
    ds_w, ds_h = ssim_fast_dims(w, h)
    for dst, src in ((ds_w, w), (ds_h, h)):
        s0, s1 = box_bounds(dst, src)
        lo, hi = box_cover(dst, src)
        assert (np.diff(s0) >= 0).all() and (np.diff(s1) >= 0).all()
        if src >= dst:
            np.testing.assert_array_equal(s1[:-1], s0[1:])
            assert s0[0] == 0 and (s1 > s0).all()
            inside = np.arange(src) < s1[-1]
            np.testing.assert_array_equal((hi - lo)[inside], 1)
            np.testing.assert_array_equal((hi - lo)[~inside], 0)


# ── The exact box mean ──────────────────────────────────────────────────────


@pytest.mark.parametrize("w,h,dw,dh", [(130, 70, 40, 21), (126, 63, 16, 8),
                                       (513, 700, 375, 512), (97, 9, 50, 8),
                                       (60, 3, 51, 8), (64, 64, 8, 8)])
def test_exact_box_mean_against_the_float_products(w, h, dw, dh):
    """K2's integer rule against _box_down_plane on integral planes: they
    may differ only where the exact mean is k + 1/2 (the float32 products
    round such a value by their own noise when 1 / count is inexact), and
    such rectangles are few."""
    rng = np.random.default_rng(w * h)
    planes = torch.from_numpy(rng.integers(0, 256, (3, h, w)).astype(
        np.float32))
    wh, wv = tresize.box_resize_weights(w, h, dw, dh)
    plain = tcomp._box_down_plane(planes, torch.from_numpy(wh),
                                  torch.from_numpy(wv))
    ys, xs = box_bounds(dh, h), box_bounds(dw, w)
    exact = k2.box_mean_exact(planes, *ys, *xs)
    assert exact.shape == plain.shape and exact.dtype == torch.float32
    # The rule, spelled out in numpy on integers.
    p = planes.numpy().astype(np.int64)
    ties = 0
    for dy in range(dh):
        for dx in range(dw):
            cell = p[:, ys[0][dy]:ys[1][dy], xs[0][dx]:xs[1][dx]]
            n = cell.shape[1] * cell.shape[2]
            sums = cell.reshape(3, -1).sum(1)
            want = (2 * sums + n) // (2 * n) if n else np.zeros(3)
            np.testing.assert_array_equal(exact[:, dy, dx].numpy(), want)
            off = exact[:, dy, dx].numpy() != plain[:, dy, dx].numpy()
            # A disagreement sits on an exact half: 2·sum ≡ n (mod 2n).
            assert all((2 * s) % (2 * n) == n for s in sums[off])
            ties += int(off.sum())
    assert ties <= 0.02 * exact.numel()


def test_exact_box_mean_rounds_half_up():
    plane = torch.tensor([[[1.0, 2.0], [2.0, 1.0], [0.0, 255.0]]])
    got = k2.box_mean_exact(plane, [0, 1, 2, 0], [1, 2, 3, 0], [0], [2])
    assert got[0, :, 0].tolist() == [2.0, 2.0, 128.0, 0.0]  # 1.5, 1.5, 127.5


# ── The wrapper's checks ────────────────────────────────────────────────────


def test_wrapper_checks_its_inputs():
    inp = search_inputs_of(600, 530, True, 2)
    q = torch.tensor([30, 60])
    out_hw = tuple(inp.lum_orig.shape[1:])
    args = (inp.tables, inp.dmat, True, 530, 600, inp.box_rectangles, out_hw)
    k2.check_inputs(inp.cplanes, q, *args)
    with pytest.raises(TypeError, match="float32"):
        k2.check_inputs([p.double() for p in inp.cplanes], q, *args)
    with pytest.raises(ValueError, match="plane"):
        k2.check_inputs([inp.cplanes[0], inp.cplanes[0], inp.cplanes[2]], q,
                        *args)
    with pytest.raises(ValueError, match="contiguous"):
        k2.check_inputs([inp.cplanes[0].transpose(1, 2).contiguous()
                         .transpose(1, 2), *inp.cplanes[1:]], q, *args)
    with pytest.raises(ValueError, match="quality"):
        k2.check_inputs(inp.cplanes, q.to(torch.int32), *args)
    with pytest.raises(ValueError, match="quality"):
        k2.check_inputs(inp.cplanes, q[:1], *args)
    with pytest.raises(ValueError, match="rectangles"):
        k2.check_inputs(inp.cplanes, q, inp.tables, inp.dmat, True, 530,
                        600, None, out_hw)
    with pytest.raises(ValueError, match="rectangles"):
        k2.check_inputs(inp.cplanes, q, inp.tables, inp.dmat, True, 530,
                        600, inp.box_rectangles[:-1].contiguous(), out_hw)
    with pytest.raises(ValueError, match="tables"):
        k2.check_inputs(inp.cplanes, q, inp.tables[:100].contiguous(),
                        inp.dmat, True, 530, 600, inp.box_rectangles,
                        out_hw)
    # No downsample: the rectangles are not looked at.
    small = search_inputs_of(70, 50, False, 1)
    k2.check_inputs(small.cplanes, torch.tensor([9]), small.tables,
                    small.dmat, False, 50, 70, None, (50, 70))
    with pytest.raises(ValueError, match="plane"):
        k2.check_inputs(small.cplanes, torch.tensor([9]), small.tables,
                        small.dmat, True, 50, 70, None, (50, 70))


# ── K2's units: the plan of whole rectangles ──────────────────────────────


def plan_parts(plan, nbands, nstrips):
    """box_plan's records: (bands, strips, each (n, 4) with the index of
    its first chunk record beside it, and every record)."""
    rec = plan.reshape(-1, 4)
    heads = rec[:2 * (nbands + nstrips)].reshape(-1, 2, 4)
    return heads[:nbands], heads[nbands:], rec


def emulate_box(rgb, w, h, subsample, bsz=1, ctas=264, sms=132):
    """The kernel's walk of one image's units, in numpy on integer r, g, b
    planes (3, h, w): per chunk the horizontal sums per (source row,
    rectangle column) of the rows and columns its records give, then the
    vertical sums into the unit's cells; per unit the rounded means.
    Asserts what the kernel relies on: chunks start on an MCU inside the
    image, every output is written by one unit, a unit fits the shared
    memory, a horizontal sum fits 16 bits."""
    dw, dh = ssim_fast_dims(w, h)
    plan, nbands, nstrips = k2.box_plan(w, h, dw, dh, subsample, bsz, ctas,
                                        sms)
    bands, strips, rec = plan_parts(plan, nbands, nstrips)
    y0, y1 = (v.astype(np.int64) for v in box_bounds(dh, h))
    x0, x1 = (v.astype(np.int64) for v in box_bounds(dw, w))
    rows, align = k2.chunk_rows(subsample), k2.mcu(subsample)
    out = np.full((3, dh, dw), -1)
    for (oy0, oy1, ay, ny), (rfirst, *_) in bands:
        assert oy1 - oy0 <= k2.MAX_UNIT_ROWS
        for (ox0, ox1, ax, nx), (cfirst, *_) in strips:
            assert ox1 - ox0 <= k2.MAX_UNIT_COLS
            assert (oy1 - oy0) * (ox1 - ox0) <= k2.MAX_CELLS
            acc = np.zeros((3, oy1 - oy0, ox1 - ox0), np.int64)
            for iy in range(ny):
                for ix in range(nx):
                    cy0, cx0 = ay + iy * rows, ax + ix * k2.CHUNK_W
                    assert cy0 % align == 0 and cx0 % align == 0
                    assert cy0 < h and cx0 < w
                    cy1, cx1 = min(cy0 + rows, h), min(cx0 + k2.CHUNK_W, w)
                    dya, dyb, ra, nr = rec[rfirst + iy]
                    dxa, dxb, _, _ = rec[cfirst + ix]
                    if dyb <= dya or dxb <= dxa:
                        continue
                    assert cy0 <= ra and ra + nr <= cy1 and nr > 0
                    hs = np.stack([rgb[:, ra:ra + nr, max(x0[dx], cx0):
                                       min(x1[dx], cx1)].sum(-1)
                                   for dx in range(dxa, dxb)], -1)
                    assert hs.max() < 1 << 16
                    for dy in range(dya, dyb):
                        ya = max(y0[dy], ra) - ra
                        yb = min(y1[dy], ra + nr) - ra
                        acc[:, dy - oy0, dxa - ox0:dxb - ox0] += (
                            hs[:, ya:yb].sum(1))
            n = ((y1 - y0)[oy0:oy1, None] * (x1 - x0)[None, ox0:ox1])
            assert (out[:, oy0:oy1, ox0:ox1] == -1).all()
            out[:, oy0:oy1, ox0:ox1] = np.where(
                n > 0, (2 * acc + n) // (2 * np.maximum(n, 1)), 0)
    return out


@pytest.mark.parametrize("w,h,subsample", [
    (600, 530, True), (530, 600, False), (700, 513, True), (513, 700, False),
    (1000, 9, True), (600, 3, False), (1920, 1080, True), (1920, 1080, False),
    (4032, 3024, True), (9000, 700, True), (513, 9000, False)])
def test_units_sum_every_rectangle_once(w, h, subsample):
    """The kernel's walk of box_plan's units, emulated on random integer
    planes, gives box_mean_exact's means: every rectangle whole, once."""
    rgb = np.random.default_rng(w * h).integers(0, 256, (3, h, w))
    ds_w, ds_h = ssim_fast_dims(w, h)
    want = k2.box_mean_exact(torch.from_numpy(rgb), *box_bounds(ds_h, h),
                             *box_bounds(ds_w, w)).numpy()
    np.testing.assert_array_equal(emulate_box(rgb, w, h, subsample), want)


def check_axis(groups, records, k, dst, src, align, chunk, limit):
    """The groups cover the outputs in order, each from the MCU of its
    first rectangle's first source index through its last one's end, in
    chunks inside the source; each chunk record is the outputs of its
    group that meet the chunk (box_cover) and the source indices their
    rectangles hold in it."""
    s0, s1 = box_bounds(dst, src)
    lo, hi = box_cover(dst, src)
    assert groups[0][0][0] == 0 and groups[-1][0][1] == dst
    for i, ((o0, o1, a, n), (first, *_)) in enumerate(groups):
        if i:
            assert o0 == groups[i - 1][0][1]
        assert 0 < o1 - o0 <= limit and n >= 1
        assert a == s0[o0] // align * align
        assert a + n * chunk >= s1[o1 - 1] and a + (n - 1) * chunk < src
        assert first == k
        for j in range(n):
            c0 = a + j * chunk
            c1 = min(c0 + chunk, src)
            meet = [d for d in range(o0, o1) if s0[d] < c1 and s1[d] > c0]
            d0, d1, r0, nr = records[k + j]
            if meet:
                assert (d0, d1) == (meet[0], meet[-1] + 1)
                assert (d0, d1) == (max(lo[c0], o0), min(hi[c1 - 1], o1))
                assert r0 == max(s0[d0], c0)
                assert r0 + nr == min(s1[d1 - 1], c1)
            else:
                assert (d0, d1, r0, nr) == (0, 0, 0, 0)
        k += n


@settings(max_examples=25, deadline=None, database=None, derandomize=True)
@given(st.integers(513, 5000), st.integers(1, 5000), st.booleans(),
       st.sampled_from([1, 3, 64]))
def test_box_plan_at_ssim_fast_geometries(w, h, subsample, bsz):
    """The plan's groups and chunk records against box_bounds and
    box_cover, at the geometries SSIMFast makes."""
    ds_w, ds_h = ssim_fast_dims(w, h)
    plan, nbands, nstrips = k2.box_plan(w, h, ds_w, ds_h, subsample, bsz,
                                        396, 132)
    assert plan.dtype == np.int32 and not plan.flags.writeable
    bands, strips, rec = plan_parts(plan, nbands, nstrips)
    widest = int((strips[:, 0, 1] - strips[:, 0, 0]).max())
    base = 2 * (nbands + nstrips)
    check_axis(bands, rec, base, ds_h, h, k2.mcu(subsample),
               k2.chunk_rows(subsample),
               min(k2.MAX_CELLS // widest, k2.MAX_UNIT_ROWS))
    check_axis(strips, rec, base + bands[:, 0, 3].sum(), ds_w, w,
               k2.mcu(subsample), k2.CHUNK_W, k2.MAX_UNIT_COLS)
    assert len(rec) == base + bands[:, 0, 3].sum() + strips[:, 0, 3].sum()


@pytest.mark.parametrize("dst,src,align,chunk,span,limit,want", [
    # 8 px rectangles from 0: 16 fit a 128-px chunk.
    (4, 32, 16, 128, 128, 128, [(0, 4, 0, 1)]),
    (32, 256, 16, 128, 128, 128, [(0, 16, 0, 1), (16, 32, 128, 1)]),
    # At most `limit` outputs a group.
    (32, 256, 16, 128, 128, 10, [(0, 10, 0, 1), (10, 20, 80, 1),
                                 (20, 30, 160, 1), (30, 32, 240, 1)]),
    # A rectangle longer than the span makes a group of its own.
    (2, 600, 16, 128, 128, 128, [(0, 1, 0, 3), (1, 2, 288, 3)]),
    # Scaled up: one group of one-row rectangles, empty ones first.
    (8, 3, 8, 16, 16, 128, [(0, 8, 0, 1)])])
def test_axis_plan_cases(dst, src, align, chunk, span, limit, want):
    got = k2.axis_plan(*box_bounds(dst, src), align, chunk, span, limit)
    assert got.dtype == np.int32
    assert [tuple(g) for g in got.tolist()] == want


def test_busiest_counts_the_round_robin():
    # 5 units of 2 chunks on 4 CTAs over 2 SMs: CTA 0 takes units 0 and
    # 4 (4 chunks), so SM 0 (CTAs 0 and 2) walks 6.
    assert k2.busiest(np.full(5, 2), 1, 4, 2) == (6, 4)
    assert k2.busiest(np.full(5, 2), 2, 4, 2) == (10, 6)
    assert k2.busiest(np.array([[3]]), 1, 396, 132) == (3, 3)


# ── The check once per search ───────────────────────────────────────────────


@pytest.mark.parametrize("name", ["box_600x530_420", "40x24_444"])
def test_prepare_checks_a_search_once(name):
    """prepare runs check_inputs on a search's inputs and gives what every
    probe launches with: the plan of box_plan (none without a downsample),
    the grid's units, the DCT matrix in host memory.  A copy made with
    dataclasses.replace starts without it."""
    w, h, subsample, quals = PROBE_CASES[name]
    inp = search_inputs_of(w, h, subsample, len(quals))
    state = k2.probe_recon.prepare(inp, 396, 132)
    ds_w, ds_h = ssim_fast_dims(w, h)
    assert state.bsz == len(quals) and state.out_hw == (ds_h, ds_w)
    assert state.ctas == 396
    np.testing.assert_array_equal(np.array(state.dmat, np.float32),
                                  inp.dmat.numpy().ravel())
    if (ds_w, ds_h) == (w, h):
        assert state.plan is None
        assert (state.nbands, state.nstrips) == (
            -(-h // k2.chunk_rows(subsample)), -(-w // k2.CHUNK_W))
    else:
        plan, nbands, nstrips = k2.box_plan(w, h, ds_w, ds_h, subsample,
                                            len(quals), 396, 132)
        np.testing.assert_array_equal(state.plan.numpy(), plan)
        assert (state.nbands, state.nstrips) == (nbands, nstrips)
        again = k2.probe_recon.prepare(inp, 396, 132)
        assert again.plan is state.plan  # uploaded once per geometry
    inp.k2_state = state
    assert dataclasses.replace(inp).k2_state is None
    with pytest.raises(TypeError, match="float32"):
        k2.probe_recon.prepare(dataclasses.replace(
            inp, cplanes=tuple(p.double() for p in inp.cplanes)), 396, 132)
    with pytest.raises(ValueError, match="dmat"):
        k2.probe_recon.prepare(dataclasses.replace(
            inp, dmat=inp.dmat[:4].contiguous()), 396, 132)


# ── The source and its build ────────────────────────────────────────────────

SOURCE = pathlib.Path(k2.SOURCE).read_text()
CODE = re.sub(r"//[^\n]*", "", SOURCE)  # without the comments


def test_built_for_hopper_without_contraction_or_fast_math():
    assert "arch=compute_90a,code=sm_90a" in k2.NVCC_FLAGS
    assert "--fmad=false" in k2.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in k2.NVCC_FLAGS)
    assert k2.SOURCE.endswith("csrc/probe_recon.cu")


def test_no_float_atomics_in_the_source():
    """No atomic at all: each rectangle's sums are owned by one CTA, in
    int32, and its mean is taken in integers."""
    assert "atomicAdd(float" not in SOURCE
    assert not re.findall(r"\batomic\w*\s*\(", CODE)
    assert re.search(r"int\* acc = ", CODE)
    assert re.search(r"\bint sum = 0;", CODE)
    assert "(2 * s + n) / (2 * n)" in CODE


def test_two_kernels_one_launch_site_each():
    """One kernel template, instantiated for 4:2:0 and for 4:4:4, one
    launch site each; no memset, no second kernel."""
    assert re.findall(r"__global__[^;{]*?(probe_\w+)\s*\(", CODE) == [
        "probe_recon_kernel"]
    assert len(re.findall(r"<<<", CODE)) == 2
    assert len(re.findall(r"probe_recon_kernel<1><<<", CODE)) == 1
    assert len(re.findall(r"probe_recon_kernel<0><<<", CODE)) == 1
    assert "cudaMemset" not in CODE


def test_arithmetic_is_spelled_out():
    """Division, the + 0.5 and the colour maths are intrinsics that the
    compiler may not contract; the IDCT's sums are fmaf in index order;
    no tensor-core or TF32 instruction."""
    for name in ("__fdiv_rn", "__fadd_rn", "__fmul_rn", "__fsub_rn", "fmaf"):
        assert name in CODE
    assert "wgmma" not in CODE and "mma.sync" not in CODE
    assert "tf32" not in CODE.lower()
    for const in ("1.402f", "0.344136286f", "0.714136286f", "1.772f",
                  "0.299f", "0.587f", "0.114f"):
        assert const in CODE
    # A chunk is whole MCUs and whole 16-byte vectors, as the wrapper's
    # plan cuts them, and the unit limits are the wrapper's.
    assert re.search(r"kRows = SUB \? 32 : 16;", CODE)
    assert (k2.chunk_rows(True), k2.chunk_rows(False)) == (32, 16)
    assert (k2.mcu(True), k2.mcu(False)) == (16, 8)
    for name, value in (("kChunkW", k2.CHUNK_W), ("kMaxCells", k2.MAX_CELLS),
                        ("kMaxUnitRows", k2.MAX_UNIT_ROWS),
                        ("kMaxUnitCols", k2.MAX_UNIT_COLS)):
        got = re.search(rf"constexpr int {name} = (\d+);", CODE)
        assert got and int(got.group(1)) == value, name
    assert k2.CHUNK_W % 16 == 0


def test_chunks_are_staged_asynchronously_and_zeros_skipped():
    """cp.async with a source size of 0 outside the planes, a ring of
    stages; a ballot per row of 32 blocks and a vote per term."""
    assert "cp.async.cg.shared.global" in CODE
    assert re.search(r"inside \? 16 : 0", CODE)
    assert re.search(r"constexpr int kStages = [23];", CODE)
    assert "cp.async.wait_group" in CODE
    assert "__ballot_sync" in CODE and "__any_sync" in CODE
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in CODE
