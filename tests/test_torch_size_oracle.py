"""The PyTorch port's size oracle, size bisection and palette quantizer
against the JAX package, on the CPU.

Scan-bit counts must be equal exactly: both packages get the JAX
package's quantized blocks, so a forward-DCT rounding tie (the two sum
matmuls in different orders) cannot make them differ.  The bisection
gets the JAX package's unquantized coefficients and must end at the same
(quality, found).  Palette indices and median-cut palettes must be equal
exactly: the map is integer arithmetic with a first-minimum tie-break.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_solid_image, make_test_image
from fennec_tpu.codecs.jpeg import (
    encode_scan_from_quantized,
    forward_dct_device,
    quantize_coefs_device,
)
from fennec_tpu.engine.size_search import size_bisect_device
from fennec_tpu.ops import quantize as jquant
from fennec_tpu.ops.dct import all_quality_tables
from fennec_tpu.ops.jpeg_size import mcu_order as jax_mcu_order
from fennec_tpu.ops.jpeg_size import scan_bits_device
from fennec_tpu_torch.engine.size_search import size_bisect
from fennec_tpu_torch.ops import quantize as tquant
from fennec_tpu_torch.ops.jpeg_size import mcu_order, scan_bits

torch.set_num_threads(1)

SHAPES = [(37, 23), (96, 80), (130, 75)]
# One compiled program per geometry instead of one per primitive.
jax_scan_bits = jax.jit(scan_bits_device, static_argnums=(3, 4, 5))


def jax_quantized(img, quality, subsample):
    """The JAX package's quantized (y, cb, cr) int32 blocks and the
    padded geometry."""
    h, w = img.shape[:2]
    coefs = forward_dct_device(jnp.asarray(img, dtype=jnp.float32),
                               subsample)
    qc = quantize_coefs_device(coefs, jnp.asarray(
        all_quality_tables()[quality]), subsample)
    mult = 16 if subsample else 8
    return ([np.asarray(c, dtype=np.int32) for c in qc],
            h + (-h) % mult, w + (-w) % mult)


def as_torch(blocks):
    return [torch.from_numpy(b.astype(np.float32)) for b in blocks]


@pytest.mark.parametrize("w,h", SHAPES)
@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
def test_scan_bits_equal_jax(w, h, subsample):
    img = make_noise_image(w, h, seed=w)
    for quality in (5, 90):
        blocks, ph, pw = jax_quantized(img, quality, subsample)
        want = int(jax_scan_bits(*(jnp.asarray(b) for b in blocks),
                                 ph, pw, subsample))
        got = int(scan_bits(*as_torch(blocks), ph, pw, subsample))
        assert got == want, (quality, got, want)


def test_scan_bits_batched_equal_per_image():
    """(B, N, 64) blocks give each image's own count."""
    imgs = [make_noise_image(96, 80, seed=s) for s in range(3)]
    per, stacks = [], [[], [], []]
    for img in imgs:
        blocks, ph, pw = jax_quantized(img, 50, True)
        per.append(int(scan_bits(*as_torch(blocks), ph, pw, True)))
        for k, b in enumerate(as_torch(blocks)):
            stacks[k].append(b)
    got = scan_bits(*(torch.stack(s) for s in stacks), ph, pw, True)
    assert got.tolist() == per


@pytest.mark.parametrize("bw,bh,hs,vs", [(12, 10, 2, 2), (5, 3, 1, 1),
                                          (4, 4, 2, 2)])
def test_mcu_order_equal_jax(bw, bh, hs, vs):
    np.testing.assert_array_equal(mcu_order(bw, bh, hs, vs),
                                  jax_mcu_order(bw, bh, hs, vs))


def stuffed_bytes(scan: bytes) -> int:
    return sum(1 for i in range(len(scan) - 1)
               if scan[i] == 0xFF and scan[i + 1] == 0x00)


@pytest.mark.parametrize("maker", ["noise", "gradient", "solid"])
def test_oracle_bytes_against_host_scan(maker):
    """The oracle's bytes never exceed the host encoder's scan and miss
    it by exactly the 0xFF stuffing bytes."""
    img = {"noise": lambda: make_noise_image(80, 64, seed=3),
           "gradient": lambda: make_test_image(80, 64),
           "solid": lambda: make_solid_image(32, 32, 120, 40, 200)}[maker]()
    for quality in (10, 60, 90):
        blocks, ph, pw = jax_quantized(img, quality, True)
        scan = encode_scan_from_quantized(*blocks, ph, pw, True)
        got = (int(scan_bits(*as_torch(blocks), ph, pw, True)) + 7) // 8
        assert got <= len(scan)
        assert got == len(scan) - stuffed_bytes(scan)


@pytest.mark.parametrize("target,lo,hi", [(4000, 1, 100), (1500, 10, 70),
                                          (300, 1, 40), (20, 1, 100),
                                          (99999, 60, 100)])
def test_size_bisect_equal_jax(target, lo, hi):
    img = make_noise_image(96, 96, seed=5)
    coefs = forward_dct_device(jnp.asarray(img, dtype=jnp.float32), True)
    jq, jf = size_bisect_device(coefs, 96, 96, True,
                                target_bytes=jnp.int32(target),
                                lo0=jnp.int32(lo), hi0=jnp.int32(hi))
    tc = [torch.from_numpy(np.array(c)) for c in coefs]
    tq, tf = size_bisect(tc, 96, 96, True, target, lo, hi)
    assert (int(tq), bool(tf)) == (int(jq), bool(jf))


def test_size_bisect_batched_equal_per_image():
    imgs = [make_noise_image(64, 48, seed=s) for s in range(4)]
    coefs = [forward_dct_device(jnp.asarray(im, dtype=jnp.float32), True)
             for im in imgs]
    stacked = [torch.stack([torch.from_numpy(np.array(c[k]))
                            for c in coefs]) for k in range(3)]
    targets = torch.tensor([600, 1500, 3000, 9000])
    q, found = size_bisect(stacked, 64, 48, True, targets, 1, 100)
    for i, c in enumerate(coefs):
        jq, jf = size_bisect_device(c, 64, 48, True,
                                    target_bytes=jnp.int32(int(targets[i])),
                                    lo0=jnp.int32(1), hi0=jnp.int32(100))
        assert (int(q[i]), bool(found[i])) == (int(jq), bool(jf))


# ── Palette quantization ────────────────────────────────────────────────────


@pytest.mark.parametrize("w,h", SHAPES + [(500, 400)])
def test_median_cut_levels_equal_jax(w, h):
    img = make_noise_image(w, h, seed=7)
    levels = (256, 128, 64, 32, 16)
    got = tquant.median_cut_levels(img, levels)
    want = jquant.median_cut_levels(img, levels)
    for lv in levels:
        np.testing.assert_array_equal(got[lv], want[lv])
    np.testing.assert_array_equal(tquant.median_cut(img, 64),
                                  jquant.median_cut(img, 64))


@pytest.mark.parametrize("colors", [256, 16])
def test_apply_palette_equal_jax(colors):
    img = make_noise_image(130, 75, seed=8)
    pal = jquant.median_cut(img, colors)
    got = tquant.apply_palette(img, pal, device="cpu")
    np.testing.assert_array_equal(got, jquant.apply_palette(img, pal))
    np.testing.assert_array_equal(
        tquant.palette_to_nrgba(got, pal), jquant.palette_to_nrgba(got, pal))


def test_apply_palette_tie_takes_first_entry():
    """Pixels equidistant from several entries map to the first one, as
    the reference's scan order and jnp.argmin do."""
    pal = np.array([[10, 10, 10, 255], [30, 10, 10, 255],
                    [20, 20, 10, 255], [20, 0, 10, 255]], np.uint8)
    img = np.zeros((2, 3, 4), np.uint8)
    img[..., 3] = 255
    img[0, 0, :3] = (20, 10, 10)  # distance 100 to all four entries
    img[0, 1, :3] = (25, 15, 10)  # ties entries 1 and 2
    img[0, 2, :3] = (15, 5, 10)   # ties entries 0 and 3
    img[1, :, :3] = pal[::-1][:3, :3]
    got = tquant.apply_palette(img, pal, device="cpu")
    np.testing.assert_array_equal(got, jquant.apply_palette(img, pal))
    assert got[0].tolist() == [0, 1, 0]
    assert got[1].tolist() == [3, 2, 1]


def test_chunked_palette_map_equals_unchunked():
    img = make_noise_image(120, 90, seed=9)
    pal = jquant.median_cut(img, 128)
    whole = tquant.apply_palette(img, pal, device="cpu")
    for rows in (1, 777, 4096):
        np.testing.assert_array_equal(
            tquant.apply_palette(img, pal, device="cpu", chunk_rows=rows),
            whole)
