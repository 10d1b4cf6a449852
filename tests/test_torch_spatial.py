"""The data×spatial mesh of the port (parallel/mesh.DataSpatialMesh,
parallel/batched.quality_search_spatial_sharded and
batched_ssim_sharded(spatial=True)) on the CPU.

A mesh of CPU devices (["cpu"] * 8, each entry a shard of its own in a
thread of its own) stands in for the cards; JAX runs on conftest's 8
virtual CPU devices.  Tolerances, each case stating its own:

- Against the JAX package's spatial search (tests/test_parallel.py's
  input): the same quality and found flag, SSIM within 1e-5, and the
  winner's blocks equal apart from forward-DCT rounding ties (a
  coefficient one step off where the JAX value is within 1e-4 of a
  half-step; tests/test_torch_slice.py states why).
- Against the port's own unsharded search: the same quality and found
  flag, the same blocks bit for bit (a band is whole MCU rows and the
  forward DCT pads its block products, ops/dct.GEMM_ROW_MULTIPLE), SSIM
  within 1e-5.  The original's luminance of a band comes from float32
  products over the band's rows instead of the image's, so a pixel may
  round to the other level where the exact box mean is k + 1/2: each
  differing pixel must be one, and they are counted.
- Each band's probe (K2's function) against the same rows of the
  unsharded probe: equal but at such ties on the CPU's plain version;
  K2's walk of a band's plan, emulated in numpy, gives the exact box
  mean of the image's rows bit for bit, which is what makes the card's
  bands bit-equal (tests/test_torch_cuda.py holds K2 itself to that).
- batched_ssim_sharded(spatial=True) against batched_ssim and the JAX
  spatial SSIM within 1e-5 (the bands' means are combined in float64).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_noise_image
from fennec_tpu_torch import parallel as tpar
from fennec_tpu_torch.engine import compress as tcomp
from fennec_tpu_torch.ops import probe_recon_cuda as k2
from fennec_tpu_torch.ops import resize as tresize
from fennec_tpu_torch.ops.filters import box_bounds, box_weights
from fennec_tpu_torch.ops.ssim import ssim_fast_dims
from fennec_tpu_torch.parallel import batched as tpb
from fennec_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

SSIM_ATOL = 1e-5
TIE_ATOL = 1e-4  # of a coefficient's half-step (test_torch_slice.py)
PIXEL_TIE_ATOL = 1e-3  # of a box mean's half-step, in float64


def cpu_mesh(n_devices, spatial):
    return tmesh.data_spatial_mesh(n_devices, spatial, ["cpu"] * n_devices)


def photo(h, w, seed=7):
    """tests/test_parallel.py's photographic image (gradients and blocky
    noise), on integer levels."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / w, y * 255 / h,
                     (x + y) * 255 / (w + h)], axis=-1)
    noise = rng.normal(0, 12, (h // 8 + 1, w // 8 + 1, 3))
    noise = noise.repeat(8, axis=0).repeat(8, axis=1)[:h, :w]
    img = np.empty((h, w, 4), np.float32)
    img[..., :3] = np.floor(np.clip(base + noise, 0, 255))
    img[..., 3] = 255.0
    return img


def unsharded(img, target, subsample=True):
    """The port's unsharded search at B = 1: (q, ssim, found, blocks)."""
    q, s, f, blocks = tcomp.batched_quality_search_quantize(
        torch.from_numpy(np.asarray(img, np.float32))[None], [target],
        subsample)
    return int(q[0]), float(s[0]), bool(f[0]), blocks[0]


def blocks_of(res):
    return torch.cat(res[3]).numpy()


class Recorder:
    """Wraps engine/compress.probe_luminance: every band's (band,
    quality, luminance) of one sharded search."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.lock = threading.Lock()
        inner = tcomp.probe_luminance

        def probe(inp, quality):
            lum = inner(inp, quality)
            with self.lock:
                self.calls.append((inp.band, int(quality[0]), lum.clone()))
            return lum

        monkeypatch.setattr(tpb._compress, "probe_luminance", probe)


def exact_means(rgb, d0, d1):
    """float64 box means (d1 - d0, dw, 3) of integer planes (3, H, W) at
    output rows [d0, d1): the exact values the float32 products round."""
    _, h, w = rgb.shape
    ds_w, ds_h = ssim_fast_dims(w, h)
    means = box_weights(ds_h, h)[d0:d1] @ np.asarray(rgb, np.float64)
    return (means @ box_weights(ds_w, w).T).transpose(1, 2, 0)


def assert_lum_ties(got, want, exact_rgb):
    """got and want (rows, dw) luminance planes differ only where a
    channel's float64 box mean is within 1e-3 of k + 1/2; returns the
    number of differing pixels."""
    diff = np.argwhere(got != want)
    if len(diff):
        frac = np.abs(exact_rgb[tuple(diff.T)] % 1.0 - 0.5)
        assert frac.min(axis=-1).max() < PIXEL_TIE_ATOL, diff
        assert np.abs(got - want).max() <= 1.0 + 1e-3
    return len(diff)


# ── The mesh ────────────────────────────────────────────────────────────────


def test_data_spatial_mesh_shape():
    mesh = cpu_mesh(8, 4)
    assert mesh.axis_names == ("data", "spatial")
    assert mesh.shape == {"data": 2, "spatial": 4}
    assert mesh.devices == ((torch.device("cpu"),) * 4,) * 2
    assert mesh.data_axis().devices == (torch.device("cpu"),) * 2
    same = tmesh.make_mesh((2, 4), ("data", "spatial"), ["cpu"] * 9)
    assert same == mesh
    assert tpar.data_spatial_mesh is tmesh.data_spatial_mesh


@pytest.mark.parametrize("n,spatial", [(8, 3), (8, 0), (6, 4), (4, -2)])
def test_data_spatial_mesh_raises(n, spatial):
    # JAX mesh.py:37-41: spatial must divide the devices.
    with pytest.raises(ValueError, match="spatial"):
        tmesh.data_spatial_mesh(n, spatial, ["cpu"] * 8)


@pytest.mark.parametrize("devices", [
    ((),),                           # an empty row
    (("cpu",), ("cpu", "cpu")),      # rows of two lengths
    (("cpu",), ("cuda:0",)),         # two kinds of device
])
def test_bad_data_spatial_mesh_raises(devices):
    with pytest.raises(ValueError):
        tmesh.DataSpatialMesh(devices)


@pytest.mark.parametrize("h,spatial,want", [
    (128, 4, [(0, 32), (32, 64), (64, 96), (96, 128)]),
    (20, 4, [(0, 5), (5, 10), (10, 15), (15, 20)]),
    (64, 1, [(0, 64)])])
def test_shard_bands_are_contiguous_in_order(h, spatial, want):
    assert tmesh.shard_bands(h, cpu_mesh(8 if spatial < 8 else spatial,
                                          spatial)) == want


def test_shard_bands_raise_on_uneven_rows():
    with pytest.raises(ValueError):
        tmesh.shard_bands(30, cpu_mesh(8, 4))


# ── The bands' rectangles and K2's plan for a band ──────────────────────────


# (H, W, bands, bands whose last rectangle straddles their seam, 4:2:0):
# 1280 x 576 to 512 x 230 and 1536 x 512 to 512 x 171 (halos of one MCU
# row), 4000 x 3008 to 512 x 385 (7.81 rows a rectangle), the 12 MP
# portrait and the 64 MP square (every seam on a rectangle's edge), no
# downsample, and 9728 x 160 to 512 x 8 (20 rows a rectangle): bands of
# 16 rows of which two own no output row, and in 4:4:4 bands of 8 rows,
# twelve owning none and halos that reach over two bands.
BAND_CASES = [(h, w, n, straddles, sub) for h, w, n, straddles in [
    (576, 1280, 4, 2), (512, 1536, 4, 2), (3008, 4000, 4, 3),
    (3008, 4000, 2, 1), (4032, 3024, 4, 0), (8192, 8192, 4, 0),
    (128, 96, 4, 0), (160, 9728, 10, 8)] for sub in (True, False)] + [
    (160, 9728, 20, 8, False)]


@pytest.mark.parametrize("h,w,n,straddles,subsample", BAND_CASES)
def test_bands_own_every_output_row_once(h, w, n, straddles, subsample):
    """Bands own contiguous output rows in order, each once; a band reads
    its rows and a halo of whole MCU rows reaching its last rectangle."""
    ds_w, ds_h = ssim_fast_dims(w, h)
    mult = 16 if subsample else 8
    s0, s1 = box_bounds(ds_h, h)
    per = h // n
    bands = [tresize.box_band(h, ds_h, k * per, (k + 1) * per, mult)
             for k in range(n)]
    assert bands[0].d0 == 0 and bands[-1].d1 == ds_h
    for k, band in enumerate(bands):
        if k:
            assert band.d0 == bands[k - 1].d1
        assert all(band.start <= s0[d] < band.stop
                   for d in range(band.d0, band.d1))
        assert band.end % mult == 0 and band.stop <= band.end <= h
        if band.d1 > band.d0:
            assert band.end >= s1[band.d1 - 1]
            assert band.end - s1[band.d1 - 1] < mult
        else:
            assert band.end == band.stop
        y0, y1 = band.bounds()
        np.testing.assert_array_equal(y0, s0[band.d0:band.d1] - band.start)
        np.testing.assert_array_equal(y1, s1[band.d0:band.d1] - band.start)
    assert sum(b.end > b.stop for b in bands) == straddles


def emulate_band(rgb, band, w, ds_w, subsample, ctas=264, sms=132):
    """The kernel's walk of band_plan's units on one band's integer
    planes (3, band.rows, w), as tests/test_torch_probe_recon.emulate_box
    walks box_plan's: chunks from an MCU inside the band's rows, each
    output written by one unit, the means rounded in integers."""
    plan, nbands, nstrips = k2.band_plan(w, ds_w, band, subsample, 1, ctas,
                                         sms)
    rec = plan.reshape(-1, 4)
    heads = rec[:2 * (nbands + nstrips)].reshape(-1, 2, 4)
    y0, y1 = (v.astype(np.int64) for v in band.bounds())
    x0, x1 = (v.astype(np.int64) for v in box_bounds(ds_w, w))
    rows, align = k2.chunk_rows(subsample), k2.mcu(subsample)
    out = np.full((3, band.d1 - band.d0, ds_w), -1)
    for (oy0, oy1, ay, ny), (rfirst, *_) in heads[:nbands]:
        for (ox0, ox1, ax, nx), (cfirst, *_) in heads[nbands:]:
            assert (oy1 - oy0) * (ox1 - ox0) <= k2.MAX_CELLS
            acc = np.zeros((3, oy1 - oy0, ox1 - ox0), np.int64)
            for iy in range(ny):
                for ix in range(nx):
                    cy0, cx0 = ay + iy * rows, ax + ix * k2.CHUNK_W
                    assert cy0 % align == 0 and cy0 < band.rows
                    dya, dyb, ra, nr = rec[rfirst + iy]
                    dxa, dxb, _, _ = rec[cfirst + ix]
                    if dyb <= dya or dxb <= dxa:
                        continue
                    assert cy0 <= ra and ra + nr <= min(cy0 + rows,
                                                        band.rows)
                    cx1 = min(cx0 + k2.CHUNK_W, w)
                    hs = np.stack([rgb[:, ra:ra + nr, max(x0[dx], cx0):
                                       min(x1[dx], cx1)].sum(-1)
                                   for dx in range(dxa, dxb)], -1)
                    for dy in range(dya, dyb):
                        ya = max(y0[dy], ra) - ra
                        yb = min(y1[dy], ra + nr) - ra
                        acc[:, dy - oy0, dxa - ox0:dxb - ox0] += (
                            hs[:, ya:yb].sum(1))
            n = ((y1 - y0)[oy0:oy1, None] * (x1 - x0)[None, ox0:ox1])
            assert (out[:, oy0:oy1, ox0:ox1] == -1).all()
            out[:, oy0:oy1, ox0:ox1] = (2 * acc + n) // (2 * n)
    return out


@pytest.mark.parametrize("h,w,n,subsample", [
    (h, w, n, sub) for h, w, n, _, sub in BAND_CASES
    if h * w < 20e6 and ssim_fast_dims(w, h) != (w, h)])
def test_band_plan_gives_the_images_box_means(h, w, n, subsample):
    """K2's walk of each band's plan over the band's rows (its own and
    the halo) gives box_mean_exact of the whole image at the rows the
    band owns, bit for bit: every owned rectangle whole, once."""
    ds_w, ds_h = ssim_fast_dims(w, h)
    rgb = np.random.default_rng(h + w).integers(0, 256, (3, h, w))
    want = k2.box_mean_exact(torch.from_numpy(rgb), *box_bounds(ds_h, h),
                             *box_bounds(ds_w, w)).numpy()
    mult, per = k2.mcu(subsample), h // n
    for k in range(n):
        band = tresize.box_band(h, ds_h, k * per, (k + 1) * per, mult)
        if band.d1 == band.d0:
            continue  # no rows: the search launches nothing for it
        got = emulate_band(rgb[:, band.start:band.end], band, w, ds_w,
                           subsample)
        np.testing.assert_array_equal(got, want[:, band.d0:band.d1])


def test_band_rectangles_and_weights():
    """band_rectangles is box_rectangles' layout for the band's own rows;
    band_box_weights' rows are box_weights' owned rows, and every weight
    of them lies in the rows the band reads."""
    h, w = 576, 1280
    ds_w, ds_h = ssim_fast_dims(w, h)
    band = tresize.box_band(h, ds_h, 0, 144, 16)
    assert band.end > band.stop  # a straddling last rectangle
    rect = tresize.band_rectangles(w, ds_w, band)
    nd, rows = band.d1 - band.d0, band.rows
    assert rect.dtype == np.int32
    assert rect.shape == (2 * (nd + ds_w + rows + w),)
    y0, y1 = rect[:nd], rect[nd:2 * nd]
    lo, hi = rect[2 * nd + 2 * ds_w:][:rows], rect[2 * nd + 2 * ds_w:][
        rows:2 * rows]
    for r in range(rows):
        owners = [d for d in range(nd) if y0[d] <= r < y1[d]]
        assert list(range(lo[r], hi[r])) == owners
    wv = tresize.band_box_weights(band)
    full = box_weights(ds_h, h)
    assert wv.dtype == np.float32 and wv.shape == (nd, rows)
    np.testing.assert_array_equal(wv, full[band.d0:band.d1,
                                           band.start:band.end].astype(
                                               np.float32))
    assert full[band.d0:band.d1, :band.start].sum() == 0
    assert full[band.d0:band.d1, band.end:].sum() == 0
    wh, wv_dev, rect_dev = tresize.band_box_device(w, ds_w, band,
                                                   torch.device("cpu"))
    np.testing.assert_array_equal(wh.numpy(), box_weights(ds_w, w).astype(
        np.float32))
    np.testing.assert_array_equal(wv_dev.numpy(), wv)
    np.testing.assert_array_equal(rect_dev.numpy(), rect)
    again = tresize.band_box_device(w, ds_w, band, torch.device("cpu"))
    assert again[1] is wv_dev and again[2] is rect_dev  # cached by band


def test_band_plan_is_keyed_by_the_band():
    """Two bands of one shape but other rectangles get their own plans
    (the 4000 x 3008 image's bands 1 and 2 read 768 rows each)."""
    h, w = 3008, 4000
    ds_w, ds_h = ssim_fast_dims(w, h)
    b1, b2 = (tresize.box_band(h, ds_h, k * 752, (k + 1) * 752, 16)
              for k in (1, 2))
    assert b1.rows == b2.rows and b1.d1 - b1.d0 == b2.d1 - b2.d0
    assert not np.array_equal(b1.bounds()[0], b2.bounds()[0])
    p1 = k2.band_plan(w, ds_w, b1, True, 1, 264, 132)[0]
    p2 = k2.band_plan(w, ds_w, b2, True, 1, 264, 132)[0]
    assert p1 is not p2 and not p1.flags.writeable


# ── The search ──────────────────────────────────────────────────────────────


def test_search_matches_jax():
    """tests/test_parallel.py::TestSpatialShardedSearch's case, JAX on
    its data_spatial_mesh(8, spatial=4), the port on ["cpu"] * 8."""
    from fennec_tpu.codecs.jpeg import forward_dct_device
    from fennec_tpu.ops.dct import all_quality_tables
    from fennec_tpu.parallel import quality_search_spatial_sharded as jqs
    from fennec_tpu.parallel.mesh import data_spatial_mesh as j_mesh

    img = make_noise_image(96, 128, seed=11).astype(np.float32)
    jq, js, jf, jblocks = jqs(j_mesh(8, spatial=4), img, 0.92)
    q, s, f, blocks = tpar.quality_search_spatial_sharded(cpu_mesh(8, 4),
                                                          img, 0.92)
    assert q.shape == () and q.device == torch.device("cpu")
    assert int(q) == int(jq) and bool(f) == bool(jf)
    assert float(s) == pytest.approx(float(js), abs=SSIM_ATOL)
    final_q = int(q) if bool(f) else 100
    coefs = forward_dct_device(jnp.asarray(img), True)
    tabs = all_quality_tables()[final_q]
    for comp, (got, want) in enumerate(zip(blocks, jblocks)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == np.float32
        for blk, k in np.argwhere(got != want):
            assert abs(got[blk, k] - want[blk, k]) == 1
            x = float(np.asarray(coefs[comp])[blk, k]) / tabs[min(comp, 1)][k]
            assert abs(abs(x) % 1.0 - 0.5) < TIE_ATOL, (comp, blk, k, x)


# (H, W, spatial, target, subsample, channels): bands whose rectangles
# straddle their seams, over 4 and over 2 (seams on rectangle edges),
# no downsample, 4:4:4, a 3-channel uint8 image, a band that owns no
# output row, a halo over two bands, a target of 1.0 (clamped to 0.999)
# and one nothing meets.
SEARCH_CASES = [
    (576, 1280, 4, 0.97, True, 4), (576, 1280, 2, 0.99, True, 4),
    (512, 1536, 4, 0.99, False, 4), (128, 96, 4, 0.94, True, 4),
    (96, 80, 4, 0.97, False, 3), (160, 9728, 10, 0.97, True, 4),
    (160, 9728, 20, 0.99, False, 4), (160, 128, 2, 1.0, True, 4),
    (576, 1280, 4, 0.9999, True, 4)]


@pytest.mark.parametrize("h,w,n,target,subsample,channels", SEARCH_CASES)
def test_search_matches_unsharded(monkeypatch, h, w, n, target, subsample,
                                  channels):
    img = photo(h, w, seed=h + n)[..., :channels]
    arg = img.astype(np.uint8) if channels == 3 else img
    rec = Recorder(monkeypatch)
    got = tpar.quality_search_spatial_sharded(cpu_mesh(n, n), arg, target,
                                              subsample)
    monkeypatch.undo()
    q, s, f, blocks = unsharded(img if channels == 4 else np.concatenate(
        [img, np.full_like(img[..., :1], 255.0)], axis=-1), target,
        subsample)
    assert (int(got[0]), bool(got[2])) == (q, f)
    assert float(got[1]) == pytest.approx(s, abs=SSIM_ATOL)
    np.testing.assert_array_equal(blocks_of(got).astype(np.int16), blocks)
    # Seven probes of every band that owns rows, at the same qualities.
    ds_w, ds_h = ssim_fast_dims(w, h)
    owning = {b for b, _, _ in rec.calls}
    assert len(rec.calls) == 7 * len(owning)
    assert sorted(b.d0 for b in owning) == [
        b.d0 for b in (tresize.box_band(h, ds_h, k * (h // n),
                                        (k + 1) * (h // n),
                                        16 if subsample else 8)
                       for k in range(n)) if b.d1 > b.d0]
    assert sum(b.d1 - b.d0 for b in owning) == ds_h


@pytest.mark.parametrize("h,w,n", [(576, 1280, 4), (160, 9728, 10)])
def test_band_probes_and_original_match_unsharded(monkeypatch, h, w, n):
    """Every band's original luminance, and its probe luminance at the 7
    qualities the search probed, against the same rows of the unsharded
    search's: equal, apart from pixels where a channel's exact box mean
    is k + 1/2 and the float32 products over other rows round it the
    other way (the plain version; K2 on the card sums in integers and is
    bit-equal).  The ties are counted."""
    img = photo(h, w, seed=5)
    rec = Recorder(monkeypatch)
    tpar.quality_search_spatial_sharded(cpu_mesh(n, n), img, 0.99)
    monkeypatch.undo()
    inp, _ = tcomp.prepare_search(torch.from_numpy(img)[None], True)
    bands = sorted({b for b, _, _ in rec.calls})
    assert len(rec.calls) == 7 * len(bands)
    ties = 0
    for band, quality, lum in rec.calls:
        want = tcomp.probe_luminance_plain(inp, torch.tensor([quality]))
        rgb = tcomp._reconstruct_rgb_planes(
            *inp.cplanes, inp.tables[torch.tensor([quality])], inp.dmat,
            True, h, w)
        rgb = torch.cat(rgb).numpy()
        ties += assert_lum_ties(lum[0].numpy(),
                                want[0, band.d0:band.d1].numpy(),
                                exact_means(rgb, band.d0, band.d1))
    for band in bands:
        pix = torch.from_numpy(img[band.start:band.end])[None]
        coefs = tcomp.forward_dct(pix[:, :band.stop - band.start], True)
        planes = tcomp.coef_planes(coefs, band.stop - band.start, w, True)
        halo = [p[:, band.stop // (2 if c else 1):band.end // (2 if c else 1)]
                for c, p in enumerate(inp.cplanes)]
        got = tcomp.band_inputs(pix, band, planes, halo, True)
        for c, (mine, whole) in enumerate(zip(got.cplanes, inp.cplanes)):
            d = 2 if c else 1
            assert torch.equal(mine, whole[:, band.start // d:band.end // d])
        ties += assert_lum_ties(
            got.lum_orig[0].numpy(), inp.lum_orig[0, band.d0:band.d1].numpy(),
            exact_means(img[..., :3].transpose(2, 0, 1), band.d0, band.d1))
    assert ties <= 8 * len(rec.calls)


def test_first_data_row_only():
    """A data axis of 2 gives the data axis of 1's result (the JAX program
    computes it on every data row)."""
    img = photo(576, 1280, seed=3)
    one = tpar.quality_search_spatial_sharded(cpu_mesh(4, 4), img, 0.97)
    two = tpar.quality_search_spatial_sharded(cpu_mesh(8, 4), img, 0.97)
    assert int(one[0]) == int(two[0]) and float(one[1]) == float(two[1])
    assert torch.equal(torch.cat(one[3]), torch.cat(two[3]))


@pytest.mark.parametrize("h,w,n,subsample", [
    (40, 32, 4, True),    # 10 rows a band: not a multiple of 16
    (96, 32, 4, True),    # 24 rows a band
    (36, 32, 4, False),   # 9 rows a band: not a multiple of 8
    (30, 32, 4, False),   # 30 rows do not split in 4
])
def test_bad_band_height_raises(h, w, n, subsample):
    img = make_noise_image(w, h, seed=1).astype(np.float32)
    with pytest.raises(ValueError, match="multiples"):
        tpar.quality_search_spatial_sharded(cpu_mesh(8, n), img, 0.92,
                                            subsample)


def test_search_needs_a_spatial_axis():
    img = photo(64, 64)
    with pytest.raises(ValueError, match="spatial"):
        tpar.quality_search_spatial_sharded(tmesh.DataMesh(("cpu",) * 2),
                                            img, 0.92)


def test_a_failing_band_raises_after_every_band_stopped():
    """_Shards.run: every shard runs to its end; then the first error in
    shard order is raised."""
    done = []
    lock = threading.Lock()

    def job(k):
        if k in (1, 3):
            raise RuntimeError(f"band {k}")
        with lock:
            done.append(k)
        return k

    with tpb._Shards([torch.device("cpu")] * 4) as shards:
        with pytest.raises(RuntimeError, match="band 1"):
            shards.run(job)
        assert sorted(done) == [0, 2]
        assert shards.run(lambda k: 10 * k, [2, 3]) == [20, 30]


def test_a_thread_per_device_runs_its_shards_in_turn():
    """Shards of one device run in shard order on one thread of the pool
    (two devices, "cpu" and "cpu:0" standing for two cards, each on a
    thread of the pool's two)."""
    devices = [torch.device("cpu"), torch.device("cpu", 0)] * 2
    seen = []
    lock = threading.Lock()

    def job(k):
        with lock:
            seen.append((k, threading.current_thread().name))
        if k == 3:
            raise RuntimeError("band 3")
        return k

    with tpb._Shards(devices) as shards:
        with pytest.raises(RuntimeError, match="band 3"):
            shards.run(job)
        assert shards.run(lambda k: -k, [0, 2]) == [0, -2]
    first = dict(seen[:4])
    assert [k for k, _ in seen[:4] if k % 2 == 0] == [0, 2]
    assert [k for k, _ in seen[:4] if k % 2] == [1, 3]
    assert first[0] == first[2] and first[1] == first[3]
    assert all(name.startswith("fennec-shard") for name in first.values())


# ── batched_ssim_sharded(spatial=True) ──────────────────────────────────────


def test_ssim_spatial_matches_jax_and_port():
    """(4, 64, 64) over a 4 x 2 mesh: JAX's spatial SSIM on its
    data_spatial_mesh(8, spatial=2), the port's batched_ssim."""
    from fennec_tpu.parallel import batched as jpb
    from fennec_tpu.parallel.mesh import data_spatial_mesh as j_mesh

    a = np.stack([make_noise_image(64, 64, seed=i)
                  for i in range(4)]).astype(np.float32)
    b = np.clip(a + np.random.default_rng(0).normal(0, 9, a.shape), 0,
                255).astype(np.float32)
    want = tpb.batched_ssim(torch.from_numpy(a), torch.from_numpy(b))
    got = tpb.batched_ssim_sharded(cpu_mesh(8, 2), a, b, spatial=True)
    jgot = jpb.batched_ssim_sharded(j_mesh(8, spatial=2), jnp.asarray(a),
                                    jnp.asarray(b), spatial=True)
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=SSIM_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot),
                               atol=SSIM_ATOL, rtol=0)


# (B, H, W, data x spatial): bands of 5 rows (the last owns no window
# position and is only the third's halo), of 3 rows (two own none), of
# 4 rows with 7 images over 2 data rows, a side of 8 (no position: 1.0).
@pytest.mark.parametrize("shape,mesh_shape", [
    ((3, 20, 64), (1, 4)), ((2, 12, 40), (2, 4)), ((7, 16, 33), (2, 4)),
    ((2, 8, 40), (1, 4)), ((5, 64, 24), (4, 2))])
def test_ssim_spatial_bands_without_positions(shape, mesh_shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0, 255, shape + (4,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
    mesh = tmesh.make_mesh(mesh_shape, ("data", "spatial"), ["cpu"] * 8)
    want = tpb.batched_ssim(torch.from_numpy(a), torch.from_numpy(b))
    got = tpb.batched_ssim_sharded(mesh, a, b, spatial=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=SSIM_ATOL,
                               rtol=0)
    if shape[1] <= 8:
        assert torch.equal(got, torch.ones(shape[0]))


def test_ssim_on_a_spatial_mesh_without_spatial_split():
    """spatial=False on a data x spatial mesh splits the batch alone, as
    JAX replicates it over the spatial axis: bit-equal to one device."""
    a = np.stack([make_noise_image(40, 36, seed=i)
                  for i in range(5)]).astype(np.float32)
    b = np.clip(a + 9.0, 0, 255)
    want = tpb.batched_ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(tpb.batched_ssim_sharded(cpu_mesh(8, 4), a, b), want)


# ── At scale (slow lane) ────────────────────────────────────────────────────


@pytest.mark.slow
def test_search_at_scale_matches_unsharded():
    """4000 x 3008 over 4 bands of 752 rows (rectangles straddle every
    seam), as tests/test_parallel.py::TestSpatialShardedAtScale takes the
    JAX search past toy shapes."""
    img = photo(3008, 4000, seed=9)
    got = tpar.quality_search_spatial_sharded(cpu_mesh(4, 4), img, 0.94)
    q, s, f, blocks = unsharded(img, 0.94)
    assert (int(got[0]), bool(got[2])) == (q, f)
    assert float(got[1]) == pytest.approx(s, abs=SSIM_ATOL)
    np.testing.assert_array_equal(blocks_of(got).astype(np.int16), blocks)
