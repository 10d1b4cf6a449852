"""Optimal Huffman tables on the device (kernel K5's plain version,
ops/huffbuild.py) against the JAX package and the host C++ builder, and
the optimal emission through it, on the CPU.

The same numpy histograms go to JAX build_tables_device and to the
port's.  Held bit for bit, with no tolerance, on every case family of
tests/test_huffbuild_device.py (random dense, sparse with ties, single
symbols and empty classes, heavy skew, Fibonacci long codes) and on
Fibonacci codes past 32 bits, where both flag the image, and on real
histograms from K3a's plain version:

- tables, bits16, vals, nvals and the overflow flag equal JAX's;
- the same outputs equal codecs/huffopt.specs_and_tables_batch (the C++
  builder), which raises for a flagged image;
- scan_bits equals parallel/batched.hist_bits;
- K5's header carries the specs and the bits, and a flagged image gets
  the standard tables;
- emit_scans(optimize=True) writes the C++ encoder's bytes, an image
  whose code passes 32 bits fails alone with the builder's ValueError,
  and each optimal emission takes one plain build.
"""

import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_test_image
from fennec_tpu.ops.huffbuild import build_tables_device as jax_build
from fennec_tpu_torch.codecs import huffopt as thuffopt
from fennec_tpu_torch.codecs.jpeg import encode_quantized
from fennec_tpu_torch.ops import huffbuild as thb
from fennec_tpu_torch.ops.huffbuild_cuda import build_tables, check_hist
from fennec_tpu_torch.ops.jpeg_emit import std_tables_on, std_tables_packed
from fennec_tpu_torch.parallel import batched as tpar
from test_torch_emit import quantized, stack

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROWS = 8  # every family padded to one batch: one JAX compile


def _fib(n: int, cap: int, step: int = 0):
    """n terms of f_k = f_(k-1) + f_(k-2) + step from 1, 1, capped.  With
    step 1 there are no ties, so the chain deepens by one a term."""
    out = [1, 1]
    while len(out) < n:
        out.append(min(out[-1] + out[-2] + step, cap))
    return out[:n]


def _dense():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 50_000, (8, 2, 16)),
            rng.integers(0, 50_000, (8, 2, 256)))


def _sparse_ties():
    rng = np.random.default_rng(1)
    dc = np.zeros((8, 2, 16), np.int64)
    ac = np.zeros((8, 2, 256), np.int64)
    for j in range(8):
        for c in range(2):
            k = rng.integers(1, 12)
            dc[j, c, rng.choice(16, k, replace=False)] = rng.integers(1, 10, k)
            k = rng.integers(1, 80)
            ac[j, c, rng.choice(256, k, replace=False)] = rng.integers(1, 8, k)
    return dc, ac


def _single_and_empty():
    dc = np.zeros((5, 2, 16), np.int64)
    ac = np.zeros((5, 2, 256), np.int64)
    dc[0, 0, 5] = 100  # one DC symbol, every other class empty
    ac[1, 1, 0xF0] = 1  # one AC symbol (ZRL), tied with the reserved one
    dc[2] = 1  # all ties
    ac[3, 0, :8] = 7
    dc[4, 0, 3], ac[4, 0, 1] = 9, 4  # grey: both chroma classes empty
    return dc, ac


def _skewed():
    dc = np.zeros((2, 2, 16), np.int64)
    ac = np.zeros((2, 2, 256), np.int64)
    dc[0, 0] = [min(1 << s, 1 << 28) for s in range(16)]
    f = 1
    for s in range(40):
        ac[0, 0, s] = max(1, f)
        f = int(f * 1.6) + 1
        if f > 1 << 27:
            f = 1
    dc[1] = 1
    ac[1, :, ::3] = 2
    return dc, ac


def _fibonacci():
    dc = np.ones((2, 2, 16), np.int64)
    ac = np.zeros((2, 2, 256), np.int64)
    ac[0, 0, :36] = _fib(36, 1 << 29)  # lengths past 16: K.3 redistributes
    ac[1, 0, :34] = _fib(34, 1 << 30, 1)  # a code of 34 bits: flagged
    ac[:, 1, 0] = 1
    return dc, ac


def _real():
    dc, ac = [], []
    for img, sub in ((make_test_image(64, 48), True),
                     (make_noise_image(64, 48), True),
                     (make_noise_image(40, 24, seed=3), False)):
        (qy, qcb, qcr), ph, pw = quantized(img, 85, sub)
        hb = tpar.packed_hist_bits(stack(qy, qcb, qcr), *img.shape[:2],
                                   sub).numpy()
        dc.append(hb[0, 1:33].reshape(2, 16))
        ac.append(hb[0, 33:].reshape(2, 256))
    return np.stack(dc), np.stack(ac)


FAMILIES = {"random_dense": _dense, "sparse_ties": _sparse_ties,
            "single_and_empty": _single_and_empty, "skewed": _skewed,
            "fibonacci": _fibonacci, "real": _real}
FLAGGED = {"fibonacci": [1]}


def _padded(fam: str):
    """The family's histograms as (ROWS, ...) int64 arrays (its rows,
    then copies of its first row), and its row count."""
    dc, ac = (np.asarray(x, np.int64) for x in FAMILIES[fam]())
    n = dc.shape[0]
    pad = [0] * (ROWS - n)
    return (np.concatenate([dc, dc[pad]]), np.concatenate([ac, ac[pad]]), n)


@pytest.fixture(scope="module")
def jax_out():
    """JAX build_tables_device over every family in one call."""
    got = {}
    dcs, acs = zip(*(_padded(f)[:2] for f in FAMILIES))
    outs = [np.asarray(x) for x in jax_build(
        np.concatenate(dcs).astype(np.int32),
        np.concatenate(acs).astype(np.int32))]
    for k, fam in enumerate(FAMILIES):
        got[fam] = [x[k * ROWS:(k + 1) * ROWS] for x in outs]
    return got


def _port(dc, ac):
    return [x.numpy() for x in thb.build_tables_device(
        torch.from_numpy(dc), torch.from_numpy(ac))]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_matches_jax(jax_out, fam):
    dc, ac, n = _padded(fam)
    got = _port(dc, ac)
    want = jax_out[fam]
    flagged = np.zeros(ROWS, bool)
    flagged[FLAGGED.get(fam, [])] = True
    np.testing.assert_array_equal(want[4], flagged)
    np.testing.assert_array_equal(got[4], want[4])
    for name, g, w in zip(("tables", "bits16", "vals", "nvals"), got, want):
        assert g.dtype == w.dtype, name
        # A flagged image's specs and tables are never used.
        np.testing.assert_array_equal(g[~flagged], w[~flagged], err_msg=name)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_matches_host_builder(fam):
    dc, ac, n = _padded(fam)
    tables, bits16, vals, nvals, overflow = _port(dc, ac)
    for j in range(n):
        if overflow[j]:
            with pytest.raises(ValueError, match="32 bits"):
                thuffopt.specs_and_tables_batch(dc[j:j + 1], ac[j:j + 1])
            continue
        specs, dcp, acp = thuffopt.specs_and_tables_batch(dc[j:j + 1],
                                                          ac[j:j + 1])
        np.testing.assert_array_equal(
            tables[j], np.concatenate([dcp[0], acp[0]], axis=1))
        for t, (bt, vt) in enumerate(specs[0][0] + specs[0][1]):
            assert bits16[j, t].tolist() == bt
            assert vals[j, t, :nvals[j, t]].tolist() == vt
            assert not vals[j, t, nvals[j, t]:].any()
    assert overflow[:n].tolist() == [j in FLAGGED.get(fam, [])
                                     for j in range(n)]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_scan_bits_is_hist_bits(fam):
    dc, ac, _ = _padded(fam)
    tables = _port(dc, ac)[0]
    got = thb.scan_bits(torch.from_numpy(dc), torch.from_numpy(ac),
                        torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy(), tpar.hist_bits(dc, ac, tables))
    std = std_tables_packed()
    np.testing.assert_array_equal(
        thb.scan_bits(torch.from_numpy(dc), torch.from_numpy(ac),
                      torch.from_numpy(std)).numpy(),
        tpar.hist_bits(dc, ac, std))


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_k5_header(fam):
    """K5's plain version: the header's bits, flags and specs are the
    build's, and a flagged image gets the standard tables, the bits under
    them and zero specs."""
    dc, ac, _ = _padded(fam)
    hist = torch.from_numpy(np.concatenate(
        [dc.reshape(ROWS, 32), ac.reshape(ROWS, 512)], 1).astype(np.int32))
    before = build_tables.plain_calls, build_tables.launches
    built = build_tables(hist, std_tables_on(CPU))
    assert (build_tables.plain_calls, build_tables.launches) == (
        before[0] + 1, before[1])
    tables, bits16, vals, nvals, overflow = _port(dc, ac)
    bits, flagged, hb16, hnv, hvals = tpar.split_opt_header(
        built.header.numpy())
    np.testing.assert_array_equal(flagged, overflow)
    want_tables = np.where(overflow[:, None, None], std_tables_packed(),
                           tables)
    np.testing.assert_array_equal(built.tables.numpy(), want_tables)
    np.testing.assert_array_equal(bits, tpar.hist_bits(dc, ac, want_tables))
    for j in range(ROWS):
        if overflow[j]:
            assert not hb16[j].any() and not hnv[j].any()
            assert not hvals[j].any()
            continue
        dcs, acs = tpar.specs_from_opt_header(hb16, hnv, hvals, j)
        for t, (bt, vt) in enumerate(dcs + acs):
            assert bt == bits16[j, t].tolist()
            assert vt == vals[j, t, :nvals[j, t]].tolist()


def test_wrapper_checks_inputs():
    std = std_tables_on(CPU)
    good = torch.zeros((2, 544), dtype=torch.int32)
    check_hist(good, std)
    with pytest.raises(TypeError):
        build_tables(good.to(torch.int64), std)
    with pytest.raises(ValueError):
        build_tables(good[:, :543].contiguous(), std)
    with pytest.raises(ValueError):
        build_tables(torch.zeros((2, 1088), dtype=torch.int32)[:, ::2], std)
    with pytest.raises(ValueError):
        build_tables(good, std[:, :1].contiguous())


@pytest.mark.parametrize("sub", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("bsz", [1, 3])
def test_emit_scans_bytes_equal_host_encoder(sub, bsz):
    """emit_scans(optimize=True) through K5's plain version writes the
    bytes of the C++ encoder with optimal tables; one plain build per
    emission."""
    w, h, quality = 48, 40, 75
    blocks = []
    for k in range(bsz):
        (qy, qcb, qcr), _ph, _pw = quantized(
            make_noise_image(w, h, seed=10 + k) if k % 2
            else make_test_image(w, h), quality, sub)
        blocks.append((qy, qcb, qcr))
    packed = torch.cat([stack(*b) for b in blocks])
    before = build_tables.plain_calls
    scans = tpar.emit_scans(packed, h, w, sub, True)
    assert build_tables.plain_calls == before + 1
    assert not scans.errors
    for j, (qy, qcb, qcr) in enumerate(blocks):
        assert scans.jpeg(j, w, h, quality, sub) == encode_quantized(
            qy, qcb, qcr, w, h, quality, sub, True)


def test_overflow_fails_alone_through_emit_scans(monkeypatch):
    """An image whose optimal code passes 32 bits (flagged by the build;
    the histogram that does so needs some 10^7 symbols, so the flag is
    forced here) is coded with the standard tables by K3b and redone on
    the host builder, whose ValueError fails it alone; the others of its
    batch keep their bytes."""
    real_build = thb.build_tables_device
    real_host = thuffopt.specs_and_tables_batch

    def flag_second(dc, ac):
        out = list(real_build(dc, ac))
        out[4] = out[4].clone()
        out[4][1] = True
        return tuple(out)

    def host(dcf, acf):
        if dcf.shape[0] == 1 and np.array_equal(
                np.concatenate([dcf.ravel(), acf.ravel()]), marker):
            raise ValueError("fennec: optimal Huffman code length exceeds "
                             "32 bits")
        return real_host(dcf, acf)

    monkeypatch.setattr(thb, "build_tables_device", flag_second)
    monkeypatch.setattr(thuffopt, "specs_and_tables_batch", host)
    w, h, quality = 32, 16, 60
    good = quantized(make_noise_image(w, h, seed=1), quality)[0]
    other = quantized(make_noise_image(w, h, seed=2), quality)[0]
    packed = torch.cat([stack(*good), stack(*other), stack(*good)])
    hb = tpar.packed_hist_bits(packed, h, w, True).numpy()
    marker = hb[1, 1:]
    assert not np.array_equal(marker, hb[0, 1:])
    scans = tpar.emit_scans(packed, h, w, True, True)
    assert list(scans.errors) == [1]
    assert isinstance(scans.errors[1], ValueError)
    with pytest.raises(ValueError, match="32 bits"):
        scans.jpeg(1, w, h, quality, True)
    for j in (0, 2):
        assert scans.jpeg(j, w, h, quality, True) == encode_quantized(
            *good, w, h, quality, True, True)


def test_real_overflow_is_flagged_by_k5_plain():
    """The Fibonacci histogram past 32 bits through K5's plain version:
    flagged, standard tables, the bits under them."""
    dc, ac = _fibonacci()
    hist = torch.from_numpy(np.concatenate(
        [dc.reshape(2, 32), ac.reshape(2, 512)], 1).astype(np.int32))
    built = build_tables(hist, std_tables_on(CPU))
    bits, flagged, *_ = tpar.split_opt_header(built.header.numpy())
    assert flagged.tolist() == [False, True]
    np.testing.assert_array_equal(built.tables[1].numpy(),
                                  std_tables_packed()[0])
