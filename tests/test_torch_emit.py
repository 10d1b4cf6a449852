"""Device Huffman emission (kernel K3's plain version) of the PyTorch port
against the JAX package and the host C++ encoder, on the CPU.

The same numpy quantized blocks go to the JAX functions and to the
port's.  Held byte for byte, with no tolerance:

- the scan layout equals JAX _slot_permutation / _scan_layout;
- the symbol histograms equal native.jpeg_count_symbols and JAX
  scan_symbol_hist_device (through JAX packed_hist_bits, whose bit
  column is bits_std_from_hist); bits_std_from_hist equals scan_bits;
- the words, and the scan after finalize_scan_host, equal JAX
  emit_scan_device's (through JAX batched_emit_std and
  batched_emit_custom), with the standard and with per-image optimal
  tables;
- the files equal codecs/jpeg.encode_quantized (the C++ encoder), for
  4:2:0 and 4:4:4, 1×1, 17×9 and 600×400, and the edge cases of JAX's
  tests/test_jpeg_emit.py: maximal blocks, runs of 16 or more zeros,
  every magnitude boundary, DC swings of ±4094, all-zero blocks, 0xFF
  bytes in the scan and a last byte with 1-7 bits used;
- every engine, with device_entropy=True on the CPU, writes the bytes it
  writes with device_entropy=False.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_solid_image, make_test_image
import fennec_tpu_torch as T
from fennec_tpu.codecs import huffopt as jhuffopt
from fennec_tpu.codecs.jpeg import forward_dct_device, quantize_coefs_device
from fennec_tpu.ops import jpeg_emit as jemit
from fennec_tpu.ops import jpeg_size as jsize
from fennec_tpu.ops.dct import ZIGZAG, all_quality_tables
from fennec_tpu.parallel import batched as jpar
from fennec_tpu_torch import cli as tcli
from fennec_tpu_torch import native
from fennec_tpu_torch.codecs import huffopt as thuffopt
from fennec_tpu_torch.codecs.jpeg import (
    _build_comps,
    decode_jpeg_to_coefs,
    encode_quantized,
)
from fennec_tpu_torch.engine import batched as tbatched
from fennec_tpu_torch.engine.compress import device_entropy_on
from fennec_tpu_torch.ops import jpeg_emit as temit
from fennec_tpu_torch.ops import jpeg_size as tsize
from fennec_tpu_torch.ops.jpeg_emit_cuda import (
    block_stats,
    check_inputs,
    deposit,
)
from fennec_tpu_torch.parallel import batched as tpar

torch.set_num_threads(1)
CPU = torch.device("cpu")


def quantized(img, quality, subsample=True):
    """(qy, qcb, qcr) int32 numpy blocks of an image, quantized by the
    JAX package, and the padded geometry."""
    h, w = img.shape[:2]
    coefs = forward_dct_device(jnp.asarray(img, dtype=jnp.float32),
                               subsample)
    qt = all_quality_tables()[quality]
    qc = quantize_coefs_device(coefs, jnp.asarray(qt), subsample)
    mult = 16 if subsample else 8
    return ([np.asarray(c, dtype=np.int32) for c in qc],
            h + (-h) % mult, w + (-w) % mult)


def stack(*parts):
    """(1, NT, 64) int16 tensor of y|cb|cr numpy blocks."""
    return torch.from_numpy(np.concatenate(parts).astype(np.int16))[None]


def jax_scan(qy, qcb, qcr, h, w, subsample, tables=None):
    """(words uint32, bits) of JAX emit_scan_device, through its jitted
    batch wrappers (standard tables, or (2, 272) packed ones)."""
    packed = jnp.asarray(np.concatenate([qy, qcb, qcr]).astype(
        np.int16))[None]
    max_words = (qy.shape[0] + qcb.shape[0] + qcr.shape[0]) * 64 + 64
    if tables is None:
        wb = jpar.batched_emit_std(packed, h, w, subsample, max_words)
    else:
        wb = jpar.batched_emit_custom(packed, jnp.asarray(tables[None]), h,
                                      w, subsample, max_words)
    words, bits, ovf = jpar.pull_emit_words(wb, max_words)
    assert not ovf.any()
    return np.asarray(words[0]), int(bits[0])


def port_scan(qy, qcb, qcr, h, w, subsample, optimize):
    """The port's HostScans of one image."""
    return tpar.emit_scans(stack(qy, qcb, qcr), h, w, subsample, optimize)


# Images at their qualities: 4:2:0 and 4:4:4, 1×1, 17×9 (odd sides, MCU
# padding), 600×400, Q100 (DC size 11, AC size 10) and a flat image
# (all-zero AC blocks).
CASES = {
    "noise_80x64_q75": (lambda: make_noise_image(80, 64, seed=1), 75, True),
    "grad_48x48_q35": (lambda: make_test_image(48, 48), 35, True),
    "noise_37x21_q95_444": (lambda: make_noise_image(37, 21, seed=2), 95,
                            False),
    "one_px_q50": (lambda: make_noise_image(1, 1, seed=3), 50, True),
    "one_px_q50_444": (lambda: make_noise_image(1, 1, seed=4), 50, False),
    "odd_17x9_q100": (lambda: make_noise_image(17, 9, seed=5), 100, True),
    "odd_17x9_q10_444": (lambda: make_test_image(17, 9), 10, False),
    "photo_600x400_q75": (lambda: make_test_image(600, 400), 75, True),
    "noise_600x400_q90_444": (lambda: make_noise_image(600, 400, seed=6),
                              90, False),
    "solid_32x32_q60": (lambda: make_solid_image(32, 32, 200, 10, 99), 60,
                        True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, quality, subsample = CASES[request.param]
    img = make()
    (qy, qcb, qcr), ph, pw = quantized(img, quality, subsample)
    return dict(img=img, qy=qy, qcb=qcb, qcr=qcr, ph=ph, pw=pw,
                h=img.shape[0], w=img.shape[1], quality=quality,
                subsample=subsample)


@pytest.mark.parametrize("ph,pw,sub", [(16, 16, True), (48, 32, True),
                                       (400, 608, True), (8, 8, False),
                                       (24, 40, False)])
def test_layout_matches_jax(ph, pw, sub):
    lay = temit.scan_layout(ph, pw, sub)
    np.testing.assert_array_equal(lay.slot_row,
                                  jemit._slot_permutation(ph, pw, sub))
    # prev_row: the previous block of the same component in MCU order.
    layout, total = jemit._scan_layout(ph, pw, sub)
    base = 0
    for comp, (order, _inv, slot) in enumerate(layout):
        order = order.astype(np.int64)
        want = np.concatenate([[-1], base + order[:-1]])
        got = np.empty_like(want)
        got[np.arange(order.size)] = lay.prev_row[slot[order]]
        np.testing.assert_array_equal(got, want)
        base += order.size
    assert lay.ny == layout[0][0].size and lay.slot_row.size == total


def test_histograms_match_native_and_jax(case):
    c = case
    hb = tpar.packed_hist_bits(stack(c["qy"], c["qcb"], c["qcr"]), c["h"],
                               c["w"], c["subsample"])[0].numpy()
    dcf, acf = hb[1:33].reshape(2, 16), hb[33:].reshape(2, 256)
    comps = _build_comps(c["qy"], c["qcb"], c["qcr"], c["ph"], c["pw"],
                         c["subsample"])
    ndc, nac = native.jpeg_count_symbols(comps)
    np.testing.assert_array_equal(dcf, ndc)
    np.testing.assert_array_equal(acf, nac)
    jax_hb = jpar.packed_hist_bits(
        jnp.asarray(stack(c["qy"], c["qcb"], c["qcr"]).numpy()), c["h"],
        c["w"], c["subsample"])
    np.testing.assert_array_equal(hb, np.asarray(jax_hb)[0])


def test_bits_std_from_hist_equals_scan_bits(case):
    c = case
    hb = tpar.packed_hist_bits(stack(c["qy"], c["qcb"], c["qcr"]), c["h"],
                               c["w"], c["subsample"])[0]
    q = [torch.from_numpy(x) for x in (c["qy"], c["qcb"], c["qcr"])]
    want = int(tsize.scan_bits(*q, c["ph"], c["pw"], c["subsample"]))
    got = int(tsize.bits_std_from_hist(hb[1:33].reshape(2, 16),
                                       hb[33:].reshape(2, 256)))
    jax_bits = int(jsize.bits_std_from_hist(
        jnp.asarray(hb[1:33].numpy().reshape(2, 16)),
        jnp.asarray(hb[33:].numpy().reshape(2, 256))))
    assert got == want == jax_bits == int(hb[0])
    assert port_scan(c["qy"], c["qcb"], c["qcr"], c["h"], c["w"],
                     c["subsample"], False).bits[0] == want


@pytest.mark.parametrize("optimize", [False, True], ids=["std", "optimal"])
def test_words_match_jax_emit_scan_device(case, optimize):
    c = case
    got = port_scan(c["qy"], c["qcb"], c["qcr"], c["h"], c["w"],
                    c["subsample"], optimize)
    tables = None
    if optimize:
        dc, ac = native.jpeg_count_symbols(_build_comps(
            c["qy"], c["qcb"], c["qcr"], c["ph"], c["pw"], c["subsample"]))
        tables = temit.pack_tables(*thuffopt.specs_from_frequencies(dc, ac))
    words, bits = jax_scan(c["qy"], c["qcb"], c["qcr"], c["h"], c["w"],
                           c["subsample"], tables)
    n = (bits + 31) // 32
    assert int(got.bits[0]) == bits
    assert got.base.tolist() == [0, n]
    np.testing.assert_array_equal(got.words, words[:n])
    assert got.scan(0) == jemit.finalize_scan_host(words, bits)


@pytest.mark.parametrize("optimize", [False, True], ids=["std", "optimal"])
def test_bytes_match_host_encoder(case, optimize):
    c = case
    got = port_scan(c["qy"], c["qcb"], c["qcr"], c["h"], c["w"],
                    c["subsample"], optimize).jpeg(
        0, c["w"], c["h"], c["quality"], c["subsample"])
    want = encode_quantized(c["qy"], c["qcb"], c["qcr"], c["w"], c["h"],
                            c["quality"], c["subsample"], optimize)
    assert got == want


# ── Edge cases (JAX tests/test_jpeg_emit.py:79-160) ─────────────────────────


def geom(blocks_w=4, blocks_h=4):
    ph, pw = blocks_h * 16, blocks_w * 16
    return ph, pw, (ph // 8) * (pw // 8), (ph // 16) * (pw // 16)


def adversarial(kind):
    ph, pw, ny, nc = geom()
    rng = np.random.default_rng(0)
    qy = np.zeros((ny, 64), np.int32)
    qcb = np.zeros((nc, 64), np.int32)
    qcr = np.zeros((nc, 64), np.int32)
    if kind == "maximal":  # ~1650 bits a block
        sign = lambda shape: rng.choice([-1, 1], size=shape)  # noqa: E731
        qy = (sign((ny, 64)) * 1023).astype(np.int32)
        qy[:, 0] = rng.integers(-2047, 2048, ny)
        qcb = (sign((nc, 64)) * 255).astype(np.int32)
        qcr = (sign((nc, 64)) * 511).astype(np.int32)
    elif kind == "zrl_runs":  # three ZRLs, gaps of exactly 16/32/47
        qy[:, ZIGZAG[63]] = 5
        qy[1::3, ZIGZAG[17]] = -3
        qy[2::3, ZIGZAG[33]] = 7
        qcb[:, ZIGZAG[48]] = -1
        qcr[:, 0] = 1024
    elif kind == "magnitudes":  # ±(2^k - 1), ±2^k
        vals = []
        for k in range(1, 11):
            vals += [(1 << k) - 1, 1 << k, -((1 << k) - 1), -(1 << k)]
        qy[:, 1:] = np.resize(np.asarray(vals, np.int32),
                              ny * 63).reshape(ny, 63)
    elif kind == "dc_swings":  # diff ±4094: DC size 12
        qy[:, 0] = np.where(np.arange(ny) % 2 == 0, 2047, -2047)
    elif kind == "all_zero":
        pass
    elif kind == "sparse_fuzz":
        qy = (rng.integers(-300, 300, (ny, 64))
              * (rng.random((ny, 64)) < 0.15)).astype(np.int32)
        qcb = (rng.integers(-80, 80, (nc, 64))
               * (rng.random((nc, 64)) < 0.1)).astype(np.int32)
    return qy, qcb, qcr, ph, pw


ADVERSARIAL = ["maximal", "zrl_runs", "magnitudes", "dc_swings", "all_zero",
               "sparse_fuzz"]


@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_adversarial_blocks(kind):
    qy, qcb, qcr, ph, pw = adversarial(kind)
    got = port_scan(qy, qcb, qcr, ph, pw, True, False)
    words, bits = jax_scan(qy, qcb, qcr, ph, pw, True)
    assert got.scan(0) == jemit.finalize_scan_host(words, bits)
    want = encode_quantized(qy, qcb, qcr, pw, ph, 50, True, False)
    assert got.jpeg(0, pw, ph, 50, True) == want
    opt = port_scan(qy, qcb, qcr, ph, pw, True, True)
    assert opt.jpeg(0, pw, ph, 50, True) == encode_quantized(
        qy, qcb, qcr, pw, ph, 50, True, True)


def test_fuzz_roundtrip_decode():
    """The emitted file decodes back to the exact coefficients."""
    qy, qcb, qcr, ph, pw = adversarial("sparse_fuzz")
    data = port_scan(qy, qcb, qcr, ph, pw, True, True).jpeg(0, pw, ph, 50,
                                                            True)
    _hdr, coefs = decode_jpeg_to_coefs(data)
    for got, want in zip(coefs, (qy, qcb, qcr)):
        np.testing.assert_array_equal(np.asarray(got, np.int32), want)


def test_stuffing_and_partial_last_byte():
    """A scan holding 0xFF bytes and ending inside a byte: the words'
    bytes are stuffed and the last one 1-padded, as the encoder does."""
    found = set()
    for seed in range(40):
        img = make_noise_image(16, 16, seed=seed)
        (qy, qcb, qcr), ph, pw = quantized(img, 90)
        got = port_scan(qy, qcb, qcr, 16, 16, True, False)
        raw = got.words.astype(">u4").tobytes()[:(int(got.bits[0]) + 7) // 8]
        if b"\xff" in raw:
            found.add("ff")
        if int(got.bits[0]) % 8:
            found.add("partial")
        assert got.scan(0) == jemit.finalize_scan_host(
            got.words, int(got.bits[0]))
        assert got.jpeg(0, 16, 16, 90, True) == encode_quantized(
            qy, qcb, qcr, 16, 16, 90, True, False)
        if found == {"ff", "partial"}:
            break
    assert found == {"ff", "partial"}


def test_batch_equals_images_alone():
    """One buffer for a batch: image j's scan is the one it gets alone,
    with standard and with its own optimal tables."""
    imgs = [make_noise_image(40, 24, seed=s) for s in range(3)]
    imgs.append(make_solid_image(40, 24, 1, 2, 3))
    parts = [quantized(im, 70)[0] for im in imgs]
    packed = torch.cat([stack(*p) for p in parts])
    for optimize in (False, True):
        scans = tpar.emit_scans(packed, 24, 40, True, optimize)
        for j, p in enumerate(parts):
            alone = port_scan(*p, 24, 40, True, optimize)
            assert scans.scan(j) == alone.scan(0)
            assert scans.jpeg(j, 40, 24, 70, True) == encode_quantized(
                *p, 40, 24, 70, True, optimize)


def test_std_tables_are_annex_k():
    dc_l, ac_l, dc_c, ac_c = jemit._std_code_arrays()
    std = temit.std_tables_packed()[0]
    for cls, (dc, ac) in enumerate(((dc_l, ac_l), (dc_c, ac_c))):
        np.testing.assert_array_equal(std[cls, :16], (dc[0] << 5) | dc[1])
        np.testing.assert_array_equal(std[cls, 16:], (ac[0] << 5) | ac[1])


def test_specs_and_tables_batch_match_jax():
    rng = np.random.default_rng(4)
    dcf = rng.integers(0, 50, (3, 2, 16)).astype(np.int64)
    acf = (rng.integers(0, 400, (3, 2, 256))
           * (rng.random((3, 2, 256)) < 0.3)).astype(np.int64)
    acf[2, 1] = 0  # an empty class gets a minimal valid table
    got = thuffopt.specs_and_tables_batch(dcf, acf)
    want = jhuffopt.specs_and_tables_batch(dcf, acf)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for j in range(3):
        np.testing.assert_array_equal(
            np.concatenate([got[1][j], got[2][j]], axis=1),
            temit.pack_tables(*got[0][j]))


def test_hist_bits_is_the_scan_bits():
    img = make_noise_image(64, 32, seed=8)
    (qy, qcb, qcr), ph, pw = quantized(img, 85)
    packed = stack(qy, qcb, qcr)
    hb = tpar.packed_hist_bits(packed, 32, 64, True).numpy()
    dcf, acf = hb[:, 1:33].reshape(-1, 2, 16), hb[:, 33:].reshape(-1, 2, 256)
    specs, tables, errors = tpar._optimal_tables(dcf, acf)
    lay = temit.layout_on(ph, pw, True, CPU)
    stats = block_stats(packed, lay, torch.from_numpy(tables), True, False)
    assert not errors and stats.hist is None
    assert tpar.hist_bits(dcf, acf, tables)[0] == int(stats.bits.sum())
    assert int(stats.totals[0]) == int(stats.bits.sum())


def test_code_length_overflow_fails_alone(monkeypatch):
    """An image whose optimal code would pass 32 bits fails alone, with
    the builder's ValueError; the others of its batch are coded."""
    real = thuffopt.specs_and_tables_batch

    def fake(dcf, acf):
        if dcf.shape[0] > 1 or dcf[0, 0, 0] == 999:
            raise ValueError("fennec: optimal Huffman code length exceeds "
                             "32 bits")
        return real(dcf, acf)

    monkeypatch.setattr(thuffopt, "specs_and_tables_batch", fake)
    good = quantized(make_noise_image(16, 16, seed=1), 60)[0]
    packed = torch.cat([stack(*good), stack(*good)])
    hb = tpar.packed_hist_bits(packed, 16, 16, True).numpy()
    dcf = hb[:, 1:33].reshape(-1, 2, 16).copy()
    dcf[1, 0, 0] = 999
    specs, _tables, errors = tpar._optimal_tables(
        dcf, hb[:, 33:].reshape(-1, 2, 256))
    assert list(errors) == [1] and specs[0] is not None


def test_deposit_flags_words_outside_the_image():
    """Word counts that disagree with the blocks' bits set the flag word,
    and pulling the words raises instead of returning a broken scan."""
    (qy, qcb, qcr), ph, pw = quantized(make_noise_image(32, 16, seed=2), 80)
    packed = stack(qy, qcb, qcr)
    lay = temit.layout_on(ph, pw, True, CPU)
    tables = temit.std_tables_on(CPU)
    short = int(block_stats(packed, lay, tables).totals[0]) // 32 - 2
    words = deposit(packed, lay, tables, torch.tensor([0, short]), short)
    assert int(words[-1]) == 1
    with pytest.raises(RuntimeError, match="outside its words"):
        tpar.pull_emit_words(tpar.DeviceScans(words, np.array([0]),
                                              np.array([0, short])))


def test_wrapper_checks_inputs():
    lay = temit.layout_on(16, 16, True, CPU)
    tables = temit.std_tables_on(CPU)
    good = torch.zeros((1, 6, 64), dtype=torch.int16)
    check_inputs(good, lay, tables)
    for bad in (good.to(torch.int32), good[0], good.transpose(1, 0),
                torch.zeros((1, 6, 32), dtype=torch.int16),
                torch.zeros((1, 7, 64), dtype=torch.int16)):
        with pytest.raises((TypeError, ValueError)):
            check_inputs(bad, lay, tables)
    with pytest.raises(ValueError):
        check_inputs(good, lay, tables.to(torch.int64))
    with pytest.raises(ValueError):
        check_inputs(good, lay, torch.zeros((2, 2, 272), dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain version and launch
    nothing."""
    (qy, qcb, qcr), ph, pw = quantized(make_noise_image(24, 24, seed=3), 70)
    before = (block_stats.launches, deposit.launches)
    scans = port_scan(qy, qcb, qcr, 24, 24, True, True)
    assert (block_stats.launches, deposit.launches) == before
    assert scans.jpeg(0, 24, 24, 70, True) == encode_quantized(
        qy, qcb, qcr, 24, 24, 70, True, True)


# ── Routing and the engines ─────────────────────────────────────────────────


@pytest.mark.parametrize("setting,on_cpu,on_cuda", [
    (None, False, True), (True, True, True), (False, False, False)])
def test_routing_rule(setting, on_cpu, on_cuda):
    """None → K3 on a CUDA device and the host encoder on the CPU; True →
    device emission; False → the host encoder (JAX compress.py:663)."""
    opts = T.Options(device_entropy=setting)
    assert device_entropy_on(opts, torch.device("cpu")) is on_cpu
    assert device_entropy_on(opts, torch.device("cuda")) is on_cuda


def photo(w, h, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 0] = 255 * x // w
    img[..., 1] = 255 * y // h
    img[..., 2] = np.clip(128 + rng.normal(0, 25, (h, w)), 0, 255)
    img[..., 3] = 255
    return img


def count_emissions(monkeypatch):
    calls = []
    real = tpar.emit_scans

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tpar, "emit_scans", counted)
    return calls


OPTS = {"optimal_420": dict(), "std_420": dict(optimize_huffman=False),
        "optimal_444": dict(subsample=False),
        "std_444": dict(optimize_huffman=False, subsample=False)}


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_compress_image_device_entropy(monkeypatch, kind):
    calls = count_emissions(monkeypatch)
    img = photo(70, 50, 1)
    on = T.compress_image(None, img, T.Options(
        format=T.JPEG, device_entropy=True, **OPTS[kind]), device=CPU)
    off = T.compress_image(None, img, T.Options(
        format=T.JPEG, device_entropy=False, **OPTS[kind]), device=CPU)
    assert calls == [1]
    assert on.compressed_data == off.compressed_data
    assert (on.jpeg_quality, on.ssim) == (off.jpeg_quality, off.ssim)


@pytest.mark.parametrize("kind", sorted(OPTS))
def test_compress_images_device_entropy(monkeypatch, kind):
    calls = count_emissions(monkeypatch)
    imgs = [photo(48, 40, s) for s in range(3)] + [photo(20, 17, 9)]
    on = T.compress_images(None, imgs, T.Options(
        format=T.JPEG, device_entropy=True, **OPTS[kind]), device=CPU)
    off = T.compress_images(None, imgs, T.Options(
        format=T.JPEG, device_entropy=False, **OPTS[kind]), device=CPU)
    assert sorted(calls) == [1, 3]  # one emission per chunk
    assert [r.compressed_data for r in on] == [r.compressed_data
                                               for r in off]


@pytest.mark.parametrize("optimize", [True, False], ids=["optimal", "std"])
def test_compress_batch_device_entropy(monkeypatch, tmp_path, optimize):
    """Both routes of compress_batch: the coefficient path (JPEG files of
    one geometry) and the pixel path (PNG files)."""
    calls = count_emissions(monkeypatch)
    items = {}
    for i in range(4):
        src = tmp_path / f"in{i}.jpg"
        src.write_bytes(T.encode_to_bytes(photo(48, 32, i), T.JPEG, 92,
                                          device=CPU))
        items[src] = "jpg"
    for i in range(2):
        src = tmp_path / f"in{i}.png"
        src.write_bytes(T.encode_to_bytes(photo(40, 40, 10 + i), T.PNG, 0,
                                          device=CPU))
    outs = {}
    for setting in (True, False):
        tbatched.counters.reset()
        batch = [T.BatchItem(src=str(p), dst=str(tmp_path / f"{setting}_"
                                                 f"{p.stem}_{p.suffix[1:]}"
                                                 f".jpg"))
                 for p in sorted(tmp_path.glob("in*"))]
        res = T.compress_batch(None, batch, T.BatchOptions(
            fused=True, default_opts=T.Options(
                format=T.JPEG, device_entropy=setting,
                optimize_huffman=optimize)), device=CPU)
        assert all(r.err is None for r in res)
        assert tbatched.counters.snapshot()["routes"] == {
            "coefficient": 4, "pixel": 2}
        outs[setting] = [open(r.item.dst, "rb").read() for r in res]
    assert sorted(calls) == [2, 4]
    assert outs[True] == outs[False]


def test_resized_coefficient_chunk_keeps_the_host_encoder(monkeypatch):
    calls = count_emissions(monkeypatch)
    datas = [T.encode_to_bytes(photo(64, 48, s), T.JPEG, 90, device=CPU)
             for s in range(2)]
    opts = dict(format=T.JPEG, max_width=40)
    on = tbatched.compress_jpeg_bytes_batched(
        None, datas, T.Options(device_entropy=True, **opts), device=CPU)
    off = tbatched.compress_jpeg_bytes_batched(
        None, datas, T.Options(device_entropy=False, **opts), device=CPU)
    assert calls == []
    assert [r.compressed_data for r in on] == [r.compressed_data
                                               for r in off]


def test_target_size_device_entropy(monkeypatch):
    calls = count_emissions(monkeypatch)
    imgs = [photo(64, 48, s) for s in range(3)]
    on = T.compress_images(None, imgs, T.Options(
        format=T.JPEG, target_size=1800, device_entropy=True), device=CPU)
    assert calls  # every encode round of the bucket
    off = T.compress_images(None, imgs, T.Options(
        format=T.JPEG, target_size=1800, device_entropy=False), device=CPU)
    assert [r.compressed_data for r in on] == [r.compressed_data
                                               for r in off]
    assert all(r.compressed_size <= 1800 for r in on)


def test_cli_device_entropy_on(tmp_path):
    src = tmp_path / "a.jpg"
    src.write_bytes(T.encode_to_bytes(photo(56, 40, 3), T.JPEG, 90,
                                      device=CPU))
    outs = []
    for flag in ("on", "off"):
        out = tmp_path / f"{flag}.jpg"
        assert tcli.main(["--device-entropy", flag, "--device", "cpu",
                          str(src), str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_io_encode_device_entropy():
    img = photo(30, 20, 4)
    bufs = []
    for setting in (True, False):
        buf = io.BytesIO()
        T.encode(buf, img, T.JPEG, T.Options(device_entropy=setting),
                 device=CPU)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
