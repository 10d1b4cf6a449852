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

And a model in plain Python of the kernel's K.2 (csrc/huffbuild.cu):
the live keys compacted in symbol order and sorted once, a two-queue walk
(leaves, merged keys in creation order) recording each node's parent
merge, each leaf's depth from its parent chain.  Its code sizes equal the
lockstep loop's (ops/huffbuild._merge_codesizes) and JAX's on every family
of chip_smoke.k5_families, and the lockstep loop's on hypothesis' tables
(ties from counts 0-3, single symbols, empty classes, counts near 2^24);
the merged keys it makes ascend, which is what makes the walk exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import make_noise_image, make_test_image
from fennec_tpu.ops.huffbuild import _merge_codesizes as jax_codesizes
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


# ── The kernel's K.2: one sort and a two-queue walk ─────────────────────────

_END = (1 << 64) - 1  # above every key


def walk_codesizes(freq) -> list:
    """K5's K.2 for one table, in plain Python: freq (257,) counts, the
    reserved symbol (1) at 256.  Returns the code sizes (257,), 0 for a
    symbol never coded."""
    keys = [(int(f) << 9) | (511 - s) for s, f in enumerate(freq) if f > 0]
    n = len(keys)
    leaf = sorted(keys)
    assert len(set(leaf)) == n  # distinct: a rank sort is exact
    lq = leaf + [_END, _END]  # queue L and two reads past its end
    mq = [_END] * (n + 1)  # queue M: merged keys in creation order
    up = [0] * (2 * n - 1)  # each node's parent merge
    li = mi = 0
    for k in range(n - 1):
        l0, l1, m0, m1 = lq[li], lq[li + 1], mq[mi], mq[mi + 1]
        a_leaf = l0 < m0
        a = l0 if a_leaf else m0
        x, y = (l1, m0) if a_leaf else (l0, m1)
        b_leaf = x < y
        b = x if b_leaf else y
        up[li if a_leaf else n + mi] = k
        up[li + a_leaf if b_leaf else n + mi + (not a_leaf)] = k
        mq[k] = a + (b & ~511)
        # The merged keys ascend, so queue M stays sorted.
        assert k == 0 or mq[k] > mq[k - 1]
        li += a_leaf + b_leaf
        mi += 2 - a_leaf - b_leaf
    sizes = [0] * 257
    root = n - 2
    for i in range(n):
        node, depth = up[i], 1
        while node != root:
            node, depth = up[n + node], depth + 1
        sizes[511 - (leaf[i] & 511)] = depth
    return sizes


def _freq(hist: np.ndarray) -> np.ndarray:
    """(B * 4, 257) int64 K.2 inputs of (B, 544) histograms, tables
    [dc-luma, dc-chroma, ac-luma, ac-chroma]: an empty class codes
    symbol 0, the reserved symbol at 256 (ops/huffbuild.py)."""
    b = hist.shape[0]
    freq = np.zeros((b, 4, 257), np.int64)
    freq[:, :2, :16] = hist[:, :32].reshape(b, 2, 16)
    freq[:, 2:, :256] = hist[:, 32:].reshape(b, 2, 256)
    freq[:, :, 0] += freq.sum(axis=2) == 0
    freq[:, :, 256] = 1
    return freq.reshape(b * 4, 257)


def _walk(freq: np.ndarray) -> np.ndarray:
    return np.array([walk_codesizes(row) for row in freq], np.int64)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


K5_FAMILIES = dict(_chip_smoke().k5_families())


@pytest.mark.parametrize("fam", list(K5_FAMILIES))
def test_walk_matches_lockstep(fam):
    """The two-queue walk gives the lockstep loop's code sizes on every
    family of chip_smoke.k5_families (the 162-live high-quality one
    included)."""
    freq = _freq(K5_FAMILIES[fam])
    want = thb._merge_codesizes(torch.from_numpy(freq)).numpy()
    np.testing.assert_array_equal(_walk(freq), want)


def _jax_rows(fam):
    """The family's images JAX's int32 K.2 can take: every table's count
    below 2^31 (counts_near_2^24 passes it, so the batch mixing it loses
    those rows; the port's int64 loop holds them above)."""
    hist = K5_FAMILIES[fam]
    return hist[_freq(hist).reshape(-1, 4, 257).sum(axis=2).max(axis=1)
                < 1 << 31]


JAX_FAMILIES = [f for f in K5_FAMILIES if len(_jax_rows(f))]


@pytest.fixture(scope="module")
def jax_k5():
    """JAX _merge_codesizes and build_tables_device over every JAX family's
    rows, in one call each."""
    rows = {f: _jax_rows(f) for f in JAX_FAMILIES}
    hist = np.concatenate(list(rows.values()))
    sizes = np.asarray(jax_codesizes(_freq(hist).astype(np.int32)))
    outs = [np.asarray(x) for x in jax_build(
        hist[:, :32].reshape(-1, 2, 16), hist[:, 32:].reshape(-1, 2, 256))]
    got, at = {}, 0
    for f, r in rows.items():
        b = len(r)
        got[f] = (sizes[4 * at:4 * (at + b)], [x[at:at + b] for x in outs])
        at += b
    return got


@pytest.mark.parametrize("fam", JAX_FAMILIES)
def test_walk_matches_jax(jax_k5, fam, monkeypatch):
    """The walk's code sizes equal JAX's K.2 loop's, and through the
    port's tail they give JAX build_tables_device's tables, specs and
    flags."""
    hist = _jax_rows(fam)
    sizes, want = jax_k5[fam]
    np.testing.assert_array_equal(_walk(_freq(hist)), sizes)
    monkeypatch.setattr(thb, "_merge_codesizes", lambda f: torch.from_numpy(
        _walk(f.numpy())))
    got = _port(hist[:, :32].reshape(-1, 2, 16).astype(np.int64),
                hist[:, 32:].reshape(-1, 2, 256).astype(np.int64))
    keep = ~want[4]
    np.testing.assert_array_equal(got[4], want[4])
    for name, g, w in zip(("tables", "bits16", "vals", "nvals"), got, want):
        np.testing.assert_array_equal(g[keep], w[keep], err_msg=name)


@st.composite
def _tables(draw):
    """A (257,) K.2 input: a DC or AC table of counts 0-3 (ties), one
    symbol, none (an empty class codes symbol 0), or counts near 2^24."""
    nsym = draw(st.sampled_from([16, 256]))
    kind = draw(st.sampled_from(["ties", "single", "empty", "near_2^24"]))
    freq = np.zeros(257, np.int64)
    if kind == "ties":
        freq[:nsym] = draw(st.lists(st.integers(0, 3), min_size=nsym,
                                    max_size=nsym))
    elif kind == "single":
        freq[draw(st.integers(0, nsym - 1))] = draw(st.integers(1, 1 << 30))
    elif kind == "near_2^24":
        freq[:nsym] = draw(st.lists(st.sampled_from(
            [0, (1 << 24) - 1, 1 << 24, (1 << 24) + 1]), min_size=nsym,
            max_size=nsym))
    freq[0] += freq.sum() == 0
    freq[256] = 1
    return freq


@settings(max_examples=50, deadline=None)
@given(_tables())
def test_walk_matches_lockstep_drawn(freq):
    want = thb._merge_codesizes(torch.from_numpy(freq[None])).numpy()[0]
    assert walk_codesizes(freq) == want.tolist()
