"""Kernels K7 (the decode's device stage) and K8 (the forward DCT and the
original's SSIMFast luminance) on the CPU: their plain versions against
the JAX package, and models of each kernel's tiling against the plain
versions.

Same numpy inputs to both.  Decoded pixels must be equal except at a
rounding tie (a value that rounds within 1e-3 of k + 1/2: the two sides
sum the IDCT in different orders); coefficients agree within 2e-3; the
luminance is equal except at a box-mean tie (an exact mean of k + 1/2,
which the float32 weight products land on either side of).

The models walk the work as csrc/decode_recon.cu and csrc/forward_dct.cu
do (MCU tiles cut by ops/decode_recon_cuda.tile_plan and
ops/forward_dct_cuda.tile_mcus, edge crops, replication through
sample_offsets' tables, edge-replicate padding by clamped coordinates,
the luminance's CTAs of LUM_COLS output columns across which rectangles
straddle), so the index arithmetic the card runs is tested where there
is no card.  Each runs at the kernel's tile size and at small tiles that
put several seams in a small image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fennec_tpu.codecs import jpeg as jjpeg
from fennec_tpu.engine import compress as jcomp
from fennec_tpu.ops import color as jcolor
from fennec_tpu_torch.codecs import jpeg as tjpeg
from fennec_tpu_torch.engine import compress as tcomp
from fennec_tpu_torch.ops import dct as tdct
from fennec_tpu_torch.ops import decode_recon_cuda as k7
from fennec_tpu_torch.ops import forward_dct_cuda as k8
from fennec_tpu_torch.ops import resize as tresize
from fennec_tpu_torch.ops.filters import box_bounds
from fennec_tpu_torch.ops.probe_recon_cuda import box_mean_exact
from fennec_tpu_torch.ops.ssim import ssim_fast_dims

torch.set_num_threads(1)

TIE = 1e-3  # how close to k + 1/2 a value that rounds apart must be
COEF_ATOL = 2e-3
F32 = np.float32

# (mode, [(h, v) per component]): every mode and sampling K7 takes.
FRAMES = {
    "gray": ("gray", [(1, 1)]),
    "ycbcr_420": ("ycbcr", [(2, 2), (1, 1), (1, 1)]),
    "ycbcr_422": ("ycbcr", [(2, 1), (1, 1), (1, 1)]),
    "ycbcr_440": ("ycbcr", [(1, 2), (1, 1), (1, 1)]),
    "ycbcr_444": ("ycbcr", [(1, 1), (1, 1), (1, 1)]),
    "rgb_444": ("rgb", [(1, 1), (1, 1), (1, 1)]),
    "cmyk_444": ("cmyk", [(1, 1)] * 4),
    "ycck_420": ("ycck", [(2, 2), (1, 1), (1, 1), (2, 2)]),
}


def near_tie(x) -> np.ndarray:
    """Values within TIE of k + 1/2."""
    x = np.asarray(x, dtype=np.float64)
    return np.abs(x - np.floor(x) - 0.5) <= TIE


def frame_inputs(sampling, h: int, w: int, seed: int, dc_ties: bool = True):
    """Random quantized blocks and tables of a frame: (blocks, tables,
    comps, hmax, vmax).  Sparse AC, and with dc_ties some blocks that hold
    only an odd DC at a table entry of 4 (each pixel exactly k + 1/2)."""
    rng = np.random.default_rng(seed)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks, tables, comps = [], [], []
    for ch, cv in sampling:
        bw, bh = mcus_x * ch, mcus_y * cv
        n = bw * bh
        b = np.zeros((n, 64), np.int16)
        b[:, 0] = rng.integers(-90, 90, n)
        ac = rng.random((n, 63)) < 0.12
        b[:, 1:] = np.where(ac, rng.integers(-12, 13, (n, 63)), 0)
        t = rng.integers(1, 40, 64).astype(np.int32)
        if dc_ties:
            flat = rng.random(n) < 0.2
            b[flat, 1:] = 0
            b[flat, 0] = 2 * rng.integers(-15, 15, flat.sum()) + 1
            t[0] = 4
        blocks.append(b)
        tables.append(t)
        comps.append(k7.Component(ch, cv, bw, bh))
    return blocks, tables, comps, hmax, vmax


def jax_frame(blocks, tables, comps, hmax, vmax, h, w, mode):
    """The JAX package's decode of the frame: (uint8 RGBA, its planes)."""
    planes = tuple(
        jjpeg._decode_plane_device(
            jnp.asarray(b, dtype=jnp.float32),
            jnp.asarray(t, dtype=jnp.float32), c.bh * 8, c.bw * 8,
            hmax // c.h, vmax // c.v)
        for b, t, c in zip(blocks, tables, comps))
    out = jjpeg._combine_planes_device(planes, h, w, mode)
    return (np.asarray(out).astype(np.uint8),
            [np.asarray(p)[:h, :w] for p in planes])


def rounding_inputs(planes, mode: str):
    """The values each output channel rounds, (h, w, n) float64, from a
    decode's cropped planes: a pixel may differ only where one is at a
    tie."""
    p = [np.asarray(x, np.float64) for x in planes]
    if mode in ("ycbcr", "ycck"):
        rgb = np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(
            np.stack(planes[:3], -1).astype(np.float32))), np.float64)
        p = [rgb[..., 0], rgb[..., 1], rgb[..., 2]] + p[3:]
    return np.stack(p, -1)


def assert_equal_but_ties(got, want, inputs, what: str) -> int:
    """got == want (uint8 or integral float RGBA) except at pixels where
    one of `inputs` (h, w, n) sits at a tie, and there by one level (CMYK:
    by k // 255 + 1).  Returns the number of such pixels."""
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    diff = np.any(got != want, axis=-1)
    if diff.any():
        tie = np.any(near_tie(inputs), axis=-1)
        assert tie[diff].all(), f"{what}: {int((diff & ~tie).sum())} pixels " \
            f"differ away from a tie"
        assert np.abs(got - want)[diff].max() <= 2, what
    return int(diff.sum())


# ── K7: plain against JAX ───────────────────────────────────────────────────


@pytest.mark.parametrize("kind", sorted(FRAMES))
@pytest.mark.parametrize("hw", [(37, 45), (9, 70)])
def test_reconstruct_plain_matches_jax(kind, hw):
    mode, sampling = FRAMES[kind]
    h, w = hw
    blocks, tables, comps, hmax, vmax = frame_inputs(sampling, h, w,
                                                     sum(hw) + len(kind))
    got = tjpeg.reconstruct_plain(
        [torch.from_numpy(b) for b in blocks],
        [torch.from_numpy(t) for t in tables], comps, hmax, vmax, h, w, mode)
    assert got.dtype == torch.uint8 and got.shape == (h, w, 4)
    want, planes = jax_frame(blocks, tables, comps, hmax, vmax, h, w, mode)
    assert_equal_but_ties(got.numpy(), want, rounding_inputs(planes, mode),
                          kind)


@pytest.mark.parametrize("sub", [True, False])
def test_decode_jpeg_image_plain_matches_jax(sub):
    h, w, bsz = 35, 51, 3
    samp = [(2, 2), (1, 1), (1, 1)] if sub else [(1, 1)] * 3
    blocks, qtabs = [], []
    for i in range(bsz):
        b, t, _c, _hm, _vm = frame_inputs(samp, h, w, 40 + i)
        blocks.append(np.concatenate(b))
        qtabs.append(np.stack([t[0], t[1]]))  # Cr takes Cb's table
    blocks, qtabs = np.stack(blocks), np.stack(qtabs)
    got = tcomp.decode_jpeg_image_plain(torch.from_numpy(blocks),
                                        torch.from_numpy(qtabs), h, w, sub)
    assert got.dtype == torch.float32 and got.shape == (bsz, h, w, 4)
    mult = 16 if sub else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = ny // 4 if sub else ny
    for i in range(bsz):
        f = blocks[i].astype(np.float32)
        want = jcomp.decode_jpeg_image_device(
            jnp.asarray(f[:ny]), jnp.asarray(f[ny:ny + nc]),
            jnp.asarray(f[ny + nc:]), jnp.asarray(qtabs[i], jnp.float32), h,
            w, sub)
        comps = [k7.Component(*s, (pw // 8) // (2 if sub and j else 1),
                              (ph // 8) // (2 if sub and j else 1))
                 for j, s in enumerate(samp)]
        _u8, planes = jax_frame(
            [blocks[i][:ny], blocks[i][ny:ny + nc], blocks[i][ny + nc:]],
            [qtabs[i][0], qtabs[i][1], qtabs[i][1]], comps, samp[0][0],
            samp[0][1], h, w, "ycbcr")
        assert_equal_but_ties(got[i].numpy(), np.asarray(want),
                              rounding_inputs(planes, "ycbcr"), f"image {i}")


def test_dc_tie_decodes_up_with_the_kron_matrix():
    """A flat block of quantized DC 1 at q = 4 is exactly 128.5 and
    decodes to 129, DC 101 to 179: the Kron matrix's row 0 is exactly
    0.125, so a DC-only block lands on c / 8 + 128 in any order of the
    sum.  The 8-point float32 matrix twice would not (d00 * d00 is
    0.12499999)."""
    table = np.full(64, 4, np.int32)
    comps = [k7.Component(1, 1, 1, 1)]
    assert tdct.dct_kron()[0].tolist() == [0.125] * 64
    d00 = tdct.dct_matrix().astype(np.float32)[0, 0]
    for dc, want in ((1, 129), (101, 179)):
        blocks = np.zeros((1, 64), np.int16)
        blocks[0, 0] = dc
        got = tjpeg.reconstruct_plain([torch.from_numpy(blocks)],
                                      [torch.from_numpy(table)], comps, 1, 1,
                                      8, 8, "gray")
        assert (got[..., :3] == want).all() and (got[..., 3] == 255).all()
        model = k7_model([blocks], [table], comps, 1, 1, 8, 8, "gray")
        assert (model[..., :3] == want).all()
    assert d00 * d00 != F32(0.125)


# ── K7: the tile walk ───────────────────────────────────────────────────────


def round_clamp(x):
    return np.clip(np.floor(x + F32(0.5)), F32(0), F32(255)).astype(F32)


def ycbcr_rgb(y, cb, cr):
    cbc, crc = cb - F32(128), cr - F32(128)
    return (y + F32(1.402) * crc,
            (y - F32(0.344136286) * cbc) - F32(0.714136286) * crc,
            y + F32(1.772) * cbc)


def colour(mode: str, v):
    """csrc/decode_recon.cu's colour() on arrays of float32 samples."""
    if mode == "gray":
        y = round_clamp(v[0])
        return y, y, y
    if mode == "rgb":
        return tuple(round_clamp(x) for x in v[:3])
    if mode == "ycbcr":
        return tuple(round_clamp(x) for x in ycbcr_rgb(*v[:3]))
    base = ycbcr_rgb(*v[:3]) if mode == "ycck" else v[:3]
    k = round_clamp(v[3]).astype(np.int64)
    return tuple(((round_clamp(b).astype(np.int64) * k) // 255).astype(F32)
                 for b in base)


def k7_model(blocks, tables, comps, hmax, vmax, h, w, mode,
             tile_blocks=k7.TILE_BLOCKS):
    """K7's walk in numpy, through the wrapper's plans: per tile of
    tile_plan's MCUs, the stage filled by stage_copies' spans (every slot
    once), each lane's conversion (conversion_lanes) dequantizing into
    the k-major buffer (kmajor_index) and setting the warp's mask bits
    (bit k of a slot's part k // 8 at 8 (k // 8 mod 4) + k mod 8 of lo or
    hi), the product's register tiles (register_tile) over the k of the
    warp's mask, + 128 into the pixel buffer (pixel_index, every live
    slot's 64 outputs once), then every pixel of the cropped tile read
    through sample_offsets and coloured.  (h, w, 4) uint8."""
    kron = np.asarray(tdct.dct_kron(), F32)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    tile, tiles_x = k7.tile_plan(comps, mcus_x, tile_blocks)
    assert tile * 8 * hmax <= k7.MAX_TILE_COLS
    ncomp = len(comps)
    raw = [np.ascontiguousarray(b).view(np.uint8).reshape(-1)
           for b in blocks]
    tab = np.ascontiguousarray(np.stack(tables).astype(np.int32)).view(
        np.uint8).reshape(-1)
    out = np.zeros((h, w, 4), np.uint8)
    seen = np.zeros((h, w), np.int64)
    warps = k7.THREADS // 32
    for my in range(mcus_y):
        for tx in range(tiles_x):
            mx0 = tx * tile
            nm = min(tile, mcus_x - mx0)
            base = k7.slot_base(comps, nm)
            nblk = base[-1]
            stage = np.zeros(k7.TILE_BLOCKS * 128 + 4 * 256, np.uint8)
            filled = np.zeros(stage.size, np.int64)
            for src, off, nbytes, dst in k7.stage_copies(
                    comps, [0] * ncomp, range(ncomp), 64, 0, my, mx0, nm):
                data = tab if src == "tables" else raw[src]
                stage[dst:dst + nbytes] = data[off:off + nbytes]
                filled[dst:dst + nbytes] += 1
            assert (filled[:nblk * 128] == 1).all()
            slots = stage[:k7.TILE_BLOCKS * 128].view(np.int16).reshape(
                -1, 64)
            qt = stage[k7.TILE_BLOCKS * 128:].view(np.int32).reshape(-1, 64)
            kmaj = np.full(64 * k7.TILE_BLOCKS, np.nan, F32)
            pix = np.full(k7.TILE_BLOCKS * k7.PIX_STRIDE, np.nan, F32)
            written = np.zeros(pix.size, np.int64)
            for warp in range(warps):
                lo = hi = 0
                for step in range(k7.WARP_BLOCKS // 4):
                    for b, part in k7.conversion_lanes(warp, step):
                        if b >= nblk:
                            continue
                        c = max(k for k in range(ncomp) if b >= base[k])
                        bits = 0
                        for j in range(8):
                            k = part * 8 + j
                            kmaj[k7.kmajor_index(k, b)] = F32(
                                F32(slots[b, k]) * F32(qt[c, k]))
                            bits |= int(slots[b, k] != 0) << j
                        if part < 4:
                            lo |= bits << (8 * part)
                        else:
                            hi |= bits << (8 * (part - 4))
                mask = hi << 32 | lo
                ks = [k for k in range(64) if mask >> k & 1]
                for lane in range(32):
                    tslots, outs = k7.register_tile(warp, lane)
                    for b in tslots:
                        if b >= nblk:
                            continue
                        assert all(kmaj[k7.kmajor_index(k, b)] == 0
                                   for k in range(64) if k not in ks)
                        coef = np.array([kmaj[k7.kmajor_index(k, b)]
                                         for k in ks], F32)
                        val = (coef @ kron[ks][:, outs]).astype(F32) \
                            + F32(128)
                        for o, v in zip(outs, val):
                            pix[k7.pixel_index(b, o)] = v
                            written[k7.pixel_index(b, o)] += 1
            live = np.array([k7.pixel_index(b, o) for b in range(nblk)
                             for o in range(64)])
            assert (written[live] == 1).all() and written.sum() == live.size
            y0, x0 = my * 8 * vmax, mx0 * 8 * hmax
            trows = min(8 * vmax, h - y0)
            tcols = min(nm * 8 * hmax, w - x0)
            v = []
            for c, comp in enumerate(comps):
                rows, cols = k7.sample_offsets(comp, hmax, vmax, nm)
                v.append(pix[base[c] * k7.PIX_STRIDE
                             + np.asarray(rows[:trows])[:, None]
                             + np.asarray(cols[:tcols])[None, :]])
            rgb = colour(mode, v)
            out[y0:y0 + trows, x0:x0 + tcols, :3] = np.stack(rgb, -1)
            out[y0:y0 + trows, x0:x0 + tcols, 3] = 255
            seen[y0:y0 + trows, x0:x0 + tcols] += 1
    assert (seen == 1).all(), "the tiles must cover every pixel once"
    return out


@pytest.mark.parametrize("kind", sorted(FRAMES))
@pytest.mark.parametrize("tile_blocks", [k7.TILE_BLOCKS, 13])
def test_k7_tile_walk_matches_plain(kind, tile_blocks):
    mode, sampling = FRAMES[kind]
    # Wide enough for two tiles a row at the kernel's tile (gray: 128
    # MCUs), ragged on both sides.
    h, w = (11, 1030) if kind == "gray" else (27, 347)
    if tile_blocks != k7.TILE_BLOCKS:
        h, w = 29, 83
    blocks, tables, comps, hmax, vmax = frame_inputs(sampling, h, w, 7)
    want = tjpeg.reconstruct_plain(
        [torch.from_numpy(b) for b in blocks],
        [torch.from_numpy(t) for t in tables], comps, hmax, vmax, h, w, mode)
    got = k7_model(blocks, tables, comps, hmax, vmax, h, w, mode,
                   tile_blocks)
    planes = [tdct.from_blocks(tdct.idct2d_blocks(
        torch.from_numpy(b).float() * torch.from_numpy(t).float()),
        c.bh * 8, c.bw * 8).numpy() + F32(128) for b, t, c in
        zip(blocks, tables, comps)]
    planes = [np.repeat(np.repeat(p, vmax // c.v, 0), hmax // c.h, 1)[:h, :w]
              for p, c in zip(planes, comps)]
    assert_equal_but_ties(got, want.numpy(), rounding_inputs(planes, mode),
                          kind)


def test_k7_tile_plan_bounds():
    """Every sampling K7 takes fits its shared buffers: a tile holds at
    most TILE_BLOCKS blocks and MAX_TILE_COLS pixel columns, at least one
    MCU; the offsets stay inside the component's run of slots."""
    for hs in range(1, 5):
        for vs in range(1, 5):
            for chroma in ((), ((1, 1),), ((1, 1), (1, 1)),
                           ((1, 1), (1, 1), (hs, vs))):
                comps = [k7.Component(hs, vs, 0, 0)] + [
                    k7.Component(a, b, 0, 0) for a, b in chroma]
                for mcus_x in (1, 7, 500):
                    tile, tiles_x = k7.tile_plan(comps, mcus_x)
                    per = sum(c.h * c.v for c in comps)
                    assert 1 <= tile <= mcus_x
                    assert tile * per <= k7.TILE_BLOCKS
                    assert tile * 8 * hs <= k7.MAX_TILE_COLS
                    assert (tiles_x - 1) * tile < mcus_x <= tiles_x * tile
                    base = k7.slot_base(comps, tile)
                    for c, comp in enumerate(comps):
                        rows, cols = k7.sample_offsets(comp, hs, vs, tile)
                        last = (base[c + 1] - 1) * k7.PIX_STRIDE + 63
                        assert (base[c] * k7.PIX_STRIDE + max(rows)
                                + max(cols)) <= last


# ── K8: plain against JAX ───────────────────────────────────────────────────


def rgba_alpha(h: int, w: int, seed: int, bsz: int = 1) -> np.ndarray:
    """Integral float32 RGBA with alpha below 255 on most pixels."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (bsz, h, w, 4)).astype(np.float32)
    img[..., 3] = np.where(rng.random((bsz, h, w)) < 0.3, 255.0,
                           img[..., 3])
    return img


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("hw", [(37, 45), (16, 8), (9, 131)])
def test_forward_dct_plain_matches_jax(sub, hw):
    h, w = hw
    img = rgba_alpha(h, w, sum(hw), bsz=2)
    got = tjpeg.forward_dct_plain(torch.from_numpy(img), sub)
    for i in range(2):
        want = jjpeg.forward_dct_device(jnp.asarray(img[i]), sub)
        for g, wt in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(wt),
                                       atol=COEF_ATOL, rtol=0)


def jax_lum_orig(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """The JAX search's original luminance of one (h, w, 4) image."""
    ds_w, ds_h = ssim_fast_dims(w, h)
    rgb = [jnp.asarray(img[..., c]) for c in range(3)]
    if (ds_w, ds_h) != (w, h):
        wh, wv = tresize.box_resize_weights(w, h, ds_w, ds_h)
        rgb = [jcomp._box_down_plane(p, jnp.asarray(wh), jnp.asarray(wv))
               for p in rgb]
    return np.asarray(0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2])


def exact_lum(img: np.ndarray, rect_rows, rect_cols) -> np.ndarray:
    """Luminance of the exact box means (box_mean_exact) of (B, H, W, 4)."""
    planes = torch.from_numpy(img[..., :3]).permute(0, 3, 1, 2)
    m = box_mean_exact(planes, *rect_rows, *rect_cols)
    return tcomp._luminance(m[:, 0], m[:, 1], m[:, 2]).numpy()


def box_ties(img: np.ndarray, rect_rows, rect_cols) -> np.ndarray:
    """(B, dh, dw): some channel's exact box mean is k + 1/2."""
    y0, y1 = (np.asarray(v, np.int64) for v in rect_rows)
    x0, x1 = (np.asarray(v, np.int64) for v in rect_cols)
    table = np.zeros((img.shape[0], img.shape[1] + 1, img.shape[2] + 1, 3),
                     np.int64)
    table[:, 1:, 1:] = img[..., :3].astype(np.int64).cumsum(1).cumsum(2)
    s = (table[:, y1][:, :, x1] - table[:, y1][:, :, x0]
         - table[:, y0][:, :, x1] + table[:, y0][:, :, x0])
    n = ((y1 - y0)[:, None] * (x1 - x0)[None, :])[None, :, :, None]
    return np.any((n > 0) & ((2 * s) % np.maximum(2 * n, 1) == n), axis=-1)


@pytest.mark.parametrize("hw", [(40, 700), (613, 97), (30, 50)])
def test_lum_orig_plain_matches_jax(hw):
    h, w = hw
    img = rgba_alpha(h, w, 3 + h, bsz=2)
    ds_w, ds_h = ssim_fast_dims(w, h)
    x = torch.from_numpy(img)
    box_wh = box_wv = None
    if (ds_w, ds_h) != (w, h):
        box_wh, box_wv = tresize.box_weights_device(w, h, ds_w, ds_h,
                                                    x.device)
    got = tcomp.lum_orig_plain(x, box_wh, box_wv, h).numpy()
    want = np.stack([jax_lum_orig(img[i], w, h) for i in range(2)])
    if box_wh is None:
        np.testing.assert_array_equal(got, want)
        return
    rows, cols = box_bounds(ds_h, h), box_bounds(ds_w, w)
    ties = box_ties(img, rows, cols)
    assert ((got == want) | ties).all()
    # Away from the ties the exact means (K8's rounding) agree too.
    assert ((got == exact_lum(img, rows, cols)) | ties).all()


# ── K8: the tile walks ──────────────────────────────────────────────────────


def to_ycc(p):
    """csrc/forward_dct.cu's to_ycc on (..., 4) float32 pixels."""
    a = p[..., 3] * F32(1.0 / 255.0)
    r, g, b = p[..., 0] * a, p[..., 1] * a, p[..., 2] * a
    y = (F32(0.299) * r + F32(0.587) * g) + F32(0.114) * b
    cb = ((F32(128) - F32(0.168735892) * r) - F32(0.331264108) * g) \
        + F32(0.5) * b
    cr = ((F32(128) + F32(0.5) * r) - F32(0.418687589) * g) \
        - F32(0.081312411) * b
    return y, cb, cr


def k8_dct_model(img: np.ndarray, sub: bool,
                 tile_blocks: int = k8.TILE_BLOCKS):
    """K8's DCT walk in numpy, through the wrapper's plans: per tile of
    tile_mcus MCUs, the stage filled by stage_rows' copies, every pixel (a
    2x2 quad in 4:2:0) read from the stage at clamped coordinates (the
    edge replicate) into its block of the run (4:2:0: each MCU's four luma
    blocks, then the tile's Cb, then Cr; 4:4:4: Y, Cb, Cr) at kmajor_index,
    the product's register tiles (register_tile; every (block,
    coefficient) once), each block stored at its place.  Three (B, N, 64)
    float32 arrays."""
    kt = np.asarray(tdct.dct_kron(), F32).T
    bsz, h, w, _ = img.shape
    mcu = 16 if sub else 8
    mcus_x, mcus_y = -(-w // mcu), -(-h // mcu)
    tile = k8.tile_mcus(sub, mcus_x, tile_blocks)
    tiles_x = -(-mcus_x // tile)
    nc = mcus_x * mcus_y
    ny = nc * (4 if sub else 1)
    outs = [np.full((bsz, n, 64), np.nan, F32) for n in (ny, nc, nc)]
    bpm = 6 if sub else 3
    flat = np.ascontiguousarray(img).view(np.uint8).reshape(-1)
    for b in range(bsz):
        for my in range(mcus_y):
            for tx in range(tiles_x):
                mx0 = tx * tile
                nm = min(tile, mcus_x - mx0)
                stage = np.zeros(k8.STAGE_BYTES, np.uint8)
                for src, nbytes, dst in k8.stage_rows(
                        h, w, sub, h * w * 4, b, my, mx0, tile):
                    stage[dst:dst + nbytes] = flat[src:src + nbytes]
                pixels = stage[:mcu * tile * mcu * 16].view(F32).reshape(
                    mcu, tile * mcu, 4)
                ylast = min(mcu, h - my * mcu) - 1
                xlast = min(nm * mcu, w - mx0 * mcu) - 1

                def at(y, x):
                    return pixels[np.minimum(y, ylast), np.minimum(x, xlast)]

                samp = np.full(64 * k8.TILE_BLOCKS, np.nan, F32)
                if sub:
                    qy, qx = np.mgrid[0:8, 0:nm * 8]
                    cbs, crs = {}, {}
                    for dy in (0, 1):
                        for dx in (0, 1):
                            yv, cb, cr = to_ycc(at(2 * qy + dy, 2 * qx + dx))
                            cbs[dy, dx], crs[dy, dx] = cb, cr
                            py, px = 2 * qy + dy, 2 * (qx & 7) + dx
                            blk = (qx >> 3) * 4 + (py >> 3) * 2 + (px >> 3)
                            pos = (py & 7) * 8 + (px & 7)
                            samp[kmajor(pos, blk)] = yv - F32(128)
                    pos = qy * 8 + (qx & 7)
                    for k, part in ((4, cbs), (5, crs)):
                        mean = (((part[0, 0] + part[0, 1]) + part[1, 0])
                                + part[1, 1]) * F32(0.25)
                        samp[kmajor(pos, k * nm + (qx >> 3))] = mean - F32(128)
                else:
                    py, px = np.mgrid[0:8, 0:nm * 8]
                    pos = py * 8 + (px & 7)
                    for k, v in enumerate(to_ycc(at(py, px))):
                        samp[kmajor(pos, k * nm + (px >> 3))] = v - F32(128)
                nblk = nm * bpm
                coef = np.full((k8.TILE_BLOCKS, 64), np.nan, F32)
                for warp in range(k8.THREADS // 32):
                    for lane in range(32):
                        blks, cols = k8.register_tile(warp, lane)
                        for blk in blks:
                            if blk >= nblk:
                                continue
                            x = samp[kmajor(np.arange(64), blk)]
                            assert np.isnan(coef[blk, cols]).all()
                            coef[blk, cols] = x @ kt[:, cols]
                for blk in range(nblk):
                    if sub and blk < 4 * nm:
                        m, by, bx = blk >> 2, (blk >> 1) & 1, blk & 1
                        cc = 0
                        idx = (my * 2 + by) * (2 * mcus_x) + (mx0 + m) * 2 \
                            + bx
                    else:
                        base = 4 * nm if sub else 0
                        cc, m = divmod(blk - base, nm)
                        cc += 1 if sub else 0
                        idx = my * mcus_x + mx0 + m
                    assert np.isnan(outs[cc][b, idx]).all()
                    outs[cc][b, idx] = coef[blk]
    for o in outs:
        assert not np.isnan(o).any(), "every block is stored once"
    return outs


kmajor = np.vectorize(k8.kmajor_index)


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("case", [((21, 347), k8.TILE_BLOCKS),
                                  ((37, 93), 13), ((5, 3), 13)])
def test_k8_dct_tile_walk_matches_plain(sub, case):
    (h, w), tile_blocks = case
    img = rgba_alpha(h, w, h * w, bsz=2)
    got = k8_dct_model(img, sub, tile_blocks)
    want = tjpeg.forward_dct_plain(torch.from_numpy(img), sub)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g, wt.numpy(), atol=COEF_ATOL, rtol=0)


def k8_lum_model(img: np.ndarray, rect: np.ndarray, ndh: int, dw: int):
    """K8's luminance walk: a CTA per (image, output row, lum_columns
    group); each source column of the group's span summed over the row's
    rectangle in integers and added into the rectangles of the group that
    hold it (the covers at the end of `rect`); floor((2 sum + n) / 2n),
    then BT.601 in float32."""
    bsz, h, w, _ = img.shape
    y0, y1 = rect[:ndh], rect[ndh:2 * ndh]
    x0, x1 = rect[2 * ndh:2 * ndh + dw], rect[2 * ndh + dw:2 * ndh + 2 * dw]
    clo = rect[2 * ndh + 2 * dw + 2 * h:][:w]
    chi = rect[2 * ndh + 2 * dw + 2 * h + w:][:w]
    out = np.zeros((bsz, ndh, dw), F32)
    pix = img[..., :3].astype(np.int64)
    for b in range(bsz):
        for dy in range(ndh):
            for d0, d1 in k8.lum_columns(dw):
                acc = np.zeros((3, d1 - d0), np.int64)
                for x in range(x0[d0], x1[d1 - 1]):
                    lo, hi = max(clo[x], d0), min(chi[x], d1)
                    if lo < hi:
                        s = pix[b, y0[dy]:y1[dy], x].sum(0)
                        acc[:, lo - d0:hi - d0] += s[:, None]
                n = (y1[dy] - y0[dy]) * (x1[d0:d1] - x0[d0:d1]).astype(
                    np.int64)
                m = np.where(n > 0, (2 * acc + n) // np.maximum(2 * n, 1),
                             0).astype(F32)
                out[b, dy, d0:d1] = (F32(0.299) * m[0] + F32(0.587) * m[1]) \
                    + F32(0.114) * m[2]
    return out


@pytest.mark.parametrize("hw", [(20, 700), (613, 41), (530, 530)])
def test_k8_lum_walk_matches_plain(hw):
    h, w = hw
    img = rgba_alpha(h, w, w, bsz=2)
    ds_w, ds_h = ssim_fast_dims(w, h)
    rect = tresize.box_rectangles(w, h, ds_w, ds_h)[0]
    got = k8_lum_model(img, rect, ds_h, ds_w)
    rows, cols = box_bounds(ds_h, h), box_bounds(ds_w, w)
    np.testing.assert_array_equal(got, exact_lum(img, rows, cols))
    wh, wv = tresize.box_weights_device(w, h, ds_w, ds_h, torch.device("cpu"))
    plain = tcomp.lum_orig_plain(torch.from_numpy(img), wh, wv, h).numpy()
    assert ((got == plain) | box_ties(img, rows, cols)).all()


@pytest.mark.parametrize("split", [(2, 0), (2, 1), (4, 2)])
def test_k8_lum_walk_on_a_band(split):
    """A band's rectangles (band_rectangles) in its own rows: the model on
    the band's pixels gives the band's rows of the whole image's
    luminance, and band_inputs' plain luminance away from ties."""
    n, k = split
    h, w = 96, 600
    img = rgba_alpha(h, w, 11 + k)
    ds_w, ds_h = ssim_fast_dims(w, h)
    band = tresize.box_band(h, ds_h, k * h // n, (k + 1) * h // n, 16)
    rect = tresize.band_rectangles(w, ds_w, band)
    pix = img[:, band.start:band.end]
    got = k8_lum_model(pix, rect, band.d1 - band.d0, ds_w)
    whole = k8_lum_model(img, tresize.box_rectangles(w, h, ds_w, ds_h)[0],
                         ds_h, ds_w)
    np.testing.assert_array_equal(got, whole[:, band.d0:band.d1])
    wh, wv, _r = tresize.band_box_device(w, ds_w, band, torch.device("cpu"))
    plain = tcomp.lum_orig_plain(torch.from_numpy(pix), wh, wv,
                                 band.stop - band.start).numpy()
    ties = box_ties(img, box_bounds(ds_h, h), box_bounds(ds_w, w))
    assert ((got == plain) | ties[:, band.d0:band.d1]).all()


# ── The wrappers on the CPU ─────────────────────────────────────────────────


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """A CPU tensor goes to the plain version, counted in plain_calls and
    never in launches; the entry points give the plain results."""
    img = rgba_alpha(24, 40, 5)
    x = torch.from_numpy(img)
    counts = [(w, w.launches, w.plain_calls) for w in
              (k8.forward_dct, k8.original_luminance, k7.decode_recon)]
    got = tjpeg.forward_dct(x, True)
    for g, wt in zip(got, tjpeg.forward_dct_plain(x, True)):
        assert torch.equal(g, wt)
    one = tjpeg.forward_dct(x[0], False)
    assert one[0].shape == (15, 64)
    inp = tcomp.search_inputs(x, got, True)
    assert torch.equal(inp.lum_orig, tcomp.lum_orig_plain(x, None, None, 24))
    blocks, tables, _c, _h, _v = frame_inputs([(2, 2), (1, 1), (1, 1)], 24,
                                              40, 9)
    packed = torch.from_numpy(np.concatenate(blocks))[None]
    qt = torch.from_numpy(np.stack([tables[0], tables[1]]))[None]
    dec = tcomp.decode_jpeg_image(packed, qt, 24, 40, True)
    assert torch.equal(dec, tcomp.decode_jpeg_image_plain(packed, qt, 24, 40,
                                                          True))
    for w, launches, plain in counts:
        assert w.launches == launches
    assert [w.plain_calls - p for w, _l, p in counts] == [2, 1, 1]


def test_decode_jpeg_through_the_wrapper_is_unchanged_on_the_cpu():
    """codecs/jpeg.decode_jpeg on the CPU gives what the plain planes
    give, through reconstruct_plain (every mode of a real file)."""
    from fennec_tpu_torch.codecs.jpeg import decode_jpeg, encode_jpeg

    img = rgba_alpha(29, 43, 2)[0].astype(np.uint8)
    img[..., 3] = 255
    for sub in (True, False):
        data = encode_jpeg(img, 85, sub, device="cpu")
        before = k7.decode_recon.plain_calls
        got = decode_jpeg(data, device="cpu")
        assert k7.decode_recon.plain_calls == before + 1
        hdr, coefs = tjpeg.decode_jpeg_to_coefs(data)
        want, _p = jax_frame(
            coefs, [hdr.qtables[c["tq"]] for c in hdr.comps],
            [k7.Component(c["h"], c["v"], -(-hdr.width // (8 * (2 if sub
             else 1))) * c["h"], -(-hdr.height // (8 * (2 if sub else 1)))
             * c["v"]) for c in hdr.comps], 2 if sub else 1,
            2 if sub else 1, hdr.height, hdr.width, "ycbcr")
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
