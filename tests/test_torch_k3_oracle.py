"""K3a's per-image total as the size oracle, on the CPU (the plain
versions), against the JAX package.

On a CUDA device engine/size_search.scan_bytes_at counts a scan's bits
with kernel K3a's per-image total over the packed int16 blocks; on the
CPU with ops/jpeg_size.scan_bits.  The two are different programs
(scan_bits clamps a size category to 12 and looks lengths up in length
tables; K3a clamps only the DC symbol and reads code << 5 | length), so
these tests hold K3a's plain version (block_stats_plain) to scan_bits and
to the JAX package's scan_bits_device on the same blocks: equal integers,
no tolerance.  The JAX functions run jitted on the CPU, as the package's
own tests run them.  Also here: the one packed quantize against the
three forms it replaced, the plain deposit finding its own offsets, the
layout's prev_slot, and the wrappers' new argument checks.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_solid_image, make_test_image
from fennec_tpu.codecs.jpeg import forward_dct_device, quantize_coefs_device
from fennec_tpu.ops.dct import all_quality_tables
from fennec_tpu.ops.jpeg_size import scan_bits_device
from fennec_tpu_torch.codecs.jpeg import forward_dct
from fennec_tpu_torch.engine import size_search
from fennec_tpu_torch.ops import dct as tdct
from fennec_tpu_torch.ops import jpeg_emit as temit
from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
from fennec_tpu_torch.ops.jpeg_size import scan_bits

torch.set_num_threads(1)
CPU = torch.device("cpu")
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


def k3_total(blocks, ph, pw, subsample):
    """K3a's per-image totals (plain version) of (y, cb, cr) numpy
    blocks, (N, 64) or (B, N, 64), under the standard tables."""
    parts = [np.asarray(b) for b in blocks]
    if parts[0].ndim == 2:
        parts = [p[None] for p in parts]
    packed = torch.from_numpy(np.concatenate(parts, axis=1).astype(np.int16))
    lay = temit.layout_on(ph, pw, subsample, CPU)
    stats = k3.block_stats(packed, lay, temit.std_tables_on(CPU))
    assert stats.bits is None and stats.hist is None
    assert stats.totals.dtype == torch.int64
    return stats.totals.tolist()


def as_float(blocks):
    return [torch.from_numpy(np.asarray(b).astype(np.float32))
            for b in blocks]


# The cases of test_torch_size_oracle.py (noise at Q5 and Q90, three odd
# geometries, both samplings) and of test_torch_emit.py (1x1, 17x9, Q100,
# a flat image).
ORACLE_CASES = {
    f"noise_{w}x{h}_q{q}_{'420' if sub else '444'}":
        (lambda w=w, h=h: make_noise_image(w, h, seed=w), q, sub)
    for w, h in [(37, 23), (96, 80), (130, 75)] for q in (5, 90)
    for sub in (True, False)}
ORACLE_CASES.update({
    "grad_48x48_q35": (lambda: make_test_image(48, 48), 35, True),
    "one_px_q50": (lambda: make_noise_image(1, 1, seed=3), 50, True),
    "one_px_q50_444": (lambda: make_noise_image(1, 1, seed=4), 50, False),
    "odd_17x9_q100": (lambda: make_noise_image(17, 9, seed=5), 100, True),
    "odd_17x9_q10_444": (lambda: make_test_image(17, 9), 10, False),
    "noise_600x400_q90_444": (lambda: make_noise_image(600, 400, seed=6),
                              90, False),
    "solid_32x32_q60": (lambda: make_solid_image(32, 32, 200, 10, 99), 60,
                        True),
})


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_k3a_total_equals_scan_bits_and_jax(name):
    make, quality, subsample = ORACLE_CASES[name]
    blocks, ph, pw = jax_quantized(make(), quality, subsample)
    want = int(jax_scan_bits(*(jnp.asarray(b) for b in blocks), ph, pw,
                             subsample))
    assert int(scan_bits(*as_float(blocks), ph, pw, subsample)) == want
    assert k3_total(blocks, ph, pw, subsample) == [want]


def test_k3a_total_batched_with_per_image_qualities():
    """A (B, NT, 64) stack quantized at per-image qualities gives each
    image the count scan_bits and the JAX package give it alone."""
    imgs = [make_noise_image(96, 80, seed=s) for s in range(4)]
    quals = [7, 50, 88, 100]
    per, stacks = [], [[], [], []]
    for img, q in zip(imgs, quals):
        blocks, ph, pw = jax_quantized(img, q, True)
        per.append(int(jax_scan_bits(*(jnp.asarray(b) for b in blocks), ph,
                                     pw, True)))
        for k, b in enumerate(blocks):
            stacks[k].append(b)
    stacked = [np.stack(s) for s in stacks]
    assert k3_total(stacked, ph, pw, True) == per
    assert scan_bits(*as_float(stacked), ph, pw, True).tolist() == per


def extreme_image(kind: str, w: int = 48, h: int = 32) -> np.ndarray:
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    if kind == "white":
        img[..., :3] = 255
    elif kind == "checker":  # a +-255 checkerboard, pixel by pixel
        y, x = np.mgrid[0:h, 0:w]
        img[..., :3] = (((x + y) & 1) * 255)[..., None]
    elif kind == "stripes":  # 8-pixel bars: the largest DC differences
        img[..., :3] = ((np.arange(w) // 8 & 1) * 255)[None, :, None]
    return img


@pytest.mark.parametrize("kind", ["black", "white", "checker", "stripes"])
@pytest.mark.parametrize("quality", [1, 100])
@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
def test_extreme_inputs_count_the_same_on_both_routes(kind, quality,
                                                      subsample):
    """All 0, all 255 and +-255 patterns at Q1 and Q100: the quantized
    values stay below 2^11 in magnitude (so the int16 cast is exact and
    scan_bits' clamp at size 12 never acts), and K3a's total, scan_bits
    and the JAX count are one integer."""
    img = extreme_image(kind)
    blocks, ph, pw = jax_quantized(img, quality, subsample)
    assert max(int(np.abs(b).max()) for b in blocks) < 1 << 11
    want = int(jax_scan_bits(*(jnp.asarray(b) for b in blocks), ph, pw,
                             subsample))
    assert int(scan_bits(*as_float(blocks), ph, pw, subsample)) == want
    assert k3_total(blocks, ph, pw, subsample) == [want]
    # The port's own quantize, packed: the float values survive the cast.
    coefs = forward_dct(torch.from_numpy(img[None]).to(torch.float32),
                        subsample)
    qt = size_search.quality_tables_on(CPU)[torch.tensor([quality])]
    packed = size_search.quantize_packed(coefs, qt)
    parts = size_search.quantize_at(coefs, torch.tensor([quality]))
    assert packed.dtype == torch.int16
    assert torch.equal(packed.to(torch.float32), torch.cat(parts, dim=1))
    assert int(packed.to(torch.int32).abs().max()) < 1 << 11
    lay = temit.layout_on(ph, pw, subsample, CPU)
    total = k3.block_stats(packed, lay, temit.std_tables_on(CPU)).totals
    assert total.tolist() == scan_bits(*parts, ph, pw, subsample).tolist()


def card_route_bytes(coefs, quality, ph, pw, subsample):
    """What scan_bytes_at computes on a CUDA device, with K3a's plain
    version in the kernel's place."""
    single = coefs[0].dim() == 2
    if single:
        coefs = [c[None] for c in coefs]
    qt = size_search.quality_tables_on(CPU)[quality.clamp(0, 100).reshape(-1)]
    packed = size_search.quantize_packed(coefs, qt)
    lay = temit.layout_on(ph, pw, subsample, CPU)
    bits = k3.oracle_stats(packed, lay, temit.std_tables_on(CPU)).totals
    bits = bits[0] if single else bits
    return torch.div(bits + 7, 8, rounding_mode="floor")


@pytest.mark.parametrize("subsample", [True, False], ids=["420", "444"])
def test_scan_bytes_at_routes_agree(subsample):
    """scan_bytes_at on CPU tensors (scan_bits) equals the card's route
    step by step: one image with a 0-d quality, and a batch at per-image
    qualities, the clamped ones (0, 101) included."""
    mult = 16 if subsample else 8
    imgs = [make_noise_image(64, 48, seed=s) for s in range(3)]
    imgs.append(make_solid_image(64, 48, 9, 200, 30))
    x = torch.from_numpy(np.stack(imgs)).to(torch.float32)
    coefs = forward_dct(x, subsample)
    ph, pw = 48 + (-48) % mult, 64 + (-64) % mult
    before = k3.oracle_stats.launches
    for quals in ([1, 35, 70, 100], [0, 101, 50, 50]):
        q = torch.tensor(quals)
        want = size_search.scan_bytes_at(coefs, q, ph, pw, subsample)
        got = card_route_bytes(coefs, q, ph, pw, subsample)
        assert want.shape == got.shape == (4,)
        assert want.tolist() == got.tolist()
    one = [c[1] for c in coefs]
    q = torch.tensor(35)
    want = size_search.scan_bytes_at(one, q, ph, pw, subsample)
    got = card_route_bytes(one, q, ph, pw, subsample)
    assert want.dim() == got.dim() == 0 and int(want) == int(got)
    assert k3.oracle_stats.launches == before  # the CPU launches nothing


def test_quantize_packed_equals_the_forms_it_replaced():
    """One packed quantize: equal to the cat-and-cast of quantize_at
    (target-size rounds), to per-component quantize_blocks at (B, 2, 64)
    tables (the coefficient and pixel paths), and to the JAX package's
    quantize on the same coefficients."""
    imgs = np.stack([make_noise_image(40, 24, seed=s) for s in range(3)])
    coefs = forward_dct(torch.from_numpy(imgs).to(torch.float32), True)
    quals = torch.tensor([12, 60, 97])
    tables = size_search.quality_tables_on(CPU)
    packed = size_search.quantize_packed(coefs, tables[quals])
    assert packed.dtype == torch.int16 and packed.is_contiguous()
    assert packed.shape == (3, sum(c.shape[1] for c in coefs), 64)
    old_rounds = torch.cat(size_search.quantize_at(coefs, quals),
                           dim=1).to(torch.int16)
    qt = tables[quals]
    old_paths = torch.cat([
        tdct.quantize_blocks(coefs[0], qt[:, None, 0]),
        tdct.quantize_blocks(coefs[1], qt[:, None, 1]),
        tdct.quantize_blocks(coefs[2], qt[:, None, 1])],
        dim=1).to(torch.int16)
    assert torch.equal(packed, old_rounds) and torch.equal(packed, old_paths)
    for j, q in enumerate(quals.tolist()):
        jq = quantize_coefs_device(
            tuple(jnp.asarray(c[j].numpy()) for c in coefs),
            jnp.asarray(all_quality_tables()[q]), True)
        want = np.concatenate([np.asarray(c) for c in jq]).astype(np.int16)
        np.testing.assert_array_equal(packed[j].numpy(), want)


@pytest.mark.parametrize("ph,pw,sub", [(16, 16, True), (48, 32, True),
                                       (400, 608, True), (8, 8, False),
                                       (24, 40, False)])
def test_layout_prev_slot_names_the_previous_block(ph, pw, sub):
    lay = temit.scan_layout(ph, pw, sub)
    first = lay.prev_row < 0
    np.testing.assert_array_equal(lay.prev_slot[first], -1)
    assert first.sum() == 3
    rest = ~first
    np.testing.assert_array_equal(lay.slot_row[lay.prev_slot[rest]],
                                  lay.prev_row[rest])
    assert (lay.prev_slot < np.arange(lay.prev_slot.size)).all()
    # K3 keeps a run's DCs in registers: a predecessor is never further
    # back than one MCU.
    back = np.arange(lay.prev_slot.size)[rest] - lay.prev_slot[rest]
    assert (back <= (6 if sub else 3)).all()
    on = temit.layout_on(ph, pw, sub, CPU)
    assert on.prev_slot.dtype == torch.int32
    np.testing.assert_array_equal(on.prev_slot.numpy(), lay.prev_slot)


def sparse_blocks(bsz, nt, seed):
    rng = np.random.default_rng(seed)
    blocks = (rng.integers(-300, 300, (bsz, nt, 64))
              * (rng.random((bsz, nt, 64)) < 0.12))
    blocks[:, :, 0] = rng.integers(-1000, 1000, (bsz, nt))
    blocks[:, ::5, 1:] = 0          # EOB only
    blocks[:, 1::5, 1:] = 0
    blocks[:, 1::5, 63] = 7         # a run of 62 zeros: three ZRLs
    blocks[:, 2::5, 40:] = 0
    return torch.from_numpy(blocks.astype(np.int16))


@pytest.mark.parametrize("bsz", [1, 3])
def test_plain_deposit_finds_its_own_offsets(bsz):
    """deposit_plain without offsets places every block at the exclusive
    sum of the bits before it: the words it wrote when torch.cumsum's
    offsets were handed to it."""
    packed = sparse_blocks(bsz, 24, 5 + bsz)  # 32x32, 4:2:0
    lay = temit.layout_on(32, 32, True, CPU)
    tables = temit.std_tables_on(CPU)
    stats = temit.block_stats_plain(packed, lay, tables, True, True)
    assert stats.totals.tolist() == stats.bits.sum(1).tolist()
    off = torch.cumsum(stats.bits, 1, dtype=torch.int64) - stats.bits
    base = torch.cat([torch.zeros(1, dtype=torch.int64),
                      torch.cumsum((stats.totals + 31) // 32, 0)])
    with_offsets = temit.deposit_plain(packed, lay, tables, base, off)
    alone = temit.deposit_plain(packed, lay, tables, base)
    assert torch.equal(alone, with_offsets) and int(alone[-1]) == 0
    through_wrapper = k3.deposit(packed, lay, tables, base, int(base[-1]))
    assert torch.equal(through_wrapper, alone)
    if bsz == 1:  # one image may leave its word bases out
        assert torch.equal(k3.deposit(packed, lay, tables, None,
                                      int(base[-1])), alone)


def test_block_stats_outputs_only_when_asked():
    packed = sparse_blocks(2, 24, 3)
    lay = temit.layout_on(32, 32, True, CPU)
    tables = temit.std_tables_on(CPU)
    full = k3.block_stats(packed, lay, tables, True, True)
    for want_bits in (False, True):
        for want_hist in (False, True):
            got = k3.block_stats(packed, lay, tables, want_bits, want_hist)
            assert (got.bits is not None) == want_bits
            assert (got.hist is not None) == want_hist
            assert torch.equal(got.totals, full.totals)
            if want_bits:
                assert torch.equal(got.bits, full.bits)
            if want_hist:
                assert torch.equal(got.hist, full.hist)


def test_wrappers_check_the_new_arguments():
    lay = temit.layout_on(16, 16, True, CPU)
    tables = temit.std_tables_on(CPU)
    good = torch.zeros((2, 6, 64), dtype=torch.int16)
    base = torch.tensor([0, 1, 2])
    k3.check_inputs(good, lay, tables)
    k3.check_word_base(base, 2, 2, CPU)
    k3.check_word_base(None, 5, 1, CPU)
    # The layout's third array.
    for bad in (lay.prev_slot.to(torch.int64), lay.prev_slot[:-1],
                lay.prev_slot.numpy()):
        with pytest.raises(ValueError, match="prev_slot"):
            k3.check_inputs(good, lay._replace(prev_slot=bad), tables)
    # Word bases: a batch needs them; shape, dtype and n_words.
    with pytest.raises(ValueError, match="word bases"):
        k3.deposit(good, lay, tables, None, 2)
    for bad in (base.to(torch.int32), base[:2], torch.tensor([[0, 1, 2]])):
        with pytest.raises(ValueError, match="word bases"):
            k3.deposit(good, lay, tables, bad, 2)
    for bad_n in (-1, 2.0, torch.tensor(2)):
        with pytest.raises(ValueError, match="n_words"):
            k3.deposit(good, lay, tables, base, bad_n)
    with pytest.raises(ValueError, match="tables"):
        k3.check_tables(tables.to(torch.int64), 2, CPU)
    with pytest.raises(ValueError, match="tables"):
        k3.check_tables(torch.zeros((3, 2, 272), dtype=torch.int32), 2, CPU)
    with pytest.raises(ValueError, match="tables"):
        k3.check_tables(tables.numpy(), 2, CPU)


def test_oracle_counts_its_launches_apart():
    """The size oracle's K3a is the emission kernel under a count of its
    own; on the CPU neither launches."""
    assert k3.oracle_stats is not k3.block_stats
    assert type(k3.oracle_stats) is type(k3.block_stats)
    before = (k3.block_stats.launches, k3.oracle_stats.launches,
              k3.deposit.launches)
    img = make_noise_image(48, 32, seed=2)
    coefs = forward_dct(torch.from_numpy(img[None]).to(torch.float32), True)
    size_search.size_bisect(coefs, 32, 48, True, 900, 1, 100)
    assert (k3.block_stats.launches, k3.oracle_stats.launches,
            k3.deposit.launches) == before


# ── K4: the quantize-and-count entry (the oracle's step in one launch) ──────


def port_coefs(img, subsample):
    """The port's unquantized (1, N, 64) coefficient blocks of one image
    and the padded geometry."""
    h, w = img.shape[:2]
    mult = 16 if subsample else 8
    coefs = forward_dct(torch.from_numpy(img[None]).to(torch.float32),
                        subsample)
    return coefs, h + (-h) % mult, w + (-w) % mult


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_quantize_count_plain_equals_scan_bits_and_jax(name):
    """K4's plain version (the packed quantize, then K3a's plain totals)
    from the float32 coefficients and a quality tensor: the integer
    scan_bits gives, and the one the JAX package's quantize and
    scan_bits_device give on the same coefficients."""
    make, quality, subsample = ORACLE_CASES[name]
    coefs, ph, pw = port_coefs(make(), subsample)
    lay = temit.layout_on(ph, pw, subsample, CPU)
    q = torch.tensor([quality])
    got = temit.quantize_count_plain(coefs, size_search.quality_tables_on(CPU),
                                     q, lay, temit.std_tables_on(CPU))
    assert got.dtype == torch.int64 and got.shape == (1,)
    parts = size_search.quantize_at(coefs, q)
    assert got.tolist() == scan_bits(*parts, ph, pw, subsample).tolist()
    jq = quantize_coefs_device(
        tuple(jnp.asarray(c[0].numpy()) for c in coefs),
        jnp.asarray(all_quality_tables()[quality]), subsample)
    assert got.tolist() == [int(jax_scan_bits(*jq, ph, pw, subsample))]
    # Through the wrapper, which takes the plain version on the CPU and
    # launches nothing.
    before = k3.quantize_count.launches
    assert k3.quantize_count(coefs, size_search.quality_tables_on(CPU), q,
                             lay, temit.std_tables_on(CPU)).tolist() == \
        got.tolist()
    assert k3.quantize_count.launches == before


def test_quantize_count_plain_batched_and_clamped():
    """Per-image qualities on the device, 0 and 101 clamped as
    scan_bytes_at clamps them."""
    imgs = np.stack([make_noise_image(64, 48, seed=s) for s in range(4)])
    coefs = forward_dct(torch.from_numpy(imgs).to(torch.float32), True)
    lay = temit.layout_on(48, 64, True, CPU)
    tables = size_search.quality_tables_on(CPU)
    for quals in ([1, 35, 70, 100], [0, 101, -5, 50]):
        q = torch.tensor(quals)
        bits = temit.quantize_count_plain(coefs, tables, q, lay,
                                          temit.std_tables_on(CPU))
        want = size_search.scan_bytes_at(coefs, q.clamp(0, 100), 48, 64,
                                         True)
        assert torch.div(bits + 7, 8, rounding_mode="floor").tolist() == \
            want.tolist()


def test_quantize_rounds_with_the_float32_add():
    """0.49999997 · q quantizes to 1 (the float32 sum 0.49999997 + 0.5 is
    1.0), as ops/dct.quantize_blocks has it and K4's kernel spells it
    out; roundf, rintf or an integer rule would give 0 there.  Exact
    halves go away from zero, on both signs."""
    q = np.float32(16.0)
    below = np.nextafter(np.float32(0.5), np.float32(0))  # 0.49999997
    assert np.float32(below) + np.float32(0.5) == np.float32(1.0)
    vals = np.zeros((1, 1, 64), np.float32)
    vals[0, 0, :6] = [below * q, -below * q, 0.5 * q, -0.5 * q, 1.5 * q,
                      0.25 * q]
    table = torch.full((1, 2, 64), float(q))
    coefs = (torch.from_numpy(vals), torch.zeros(1, 1, 64),
             torch.zeros(1, 1, 64))
    packed = size_search.quantize_packed(coefs, table)
    assert packed[0, 0, :6].tolist() == [1, -1, 1, -1, 2, 0]
    want = tdct.quantize_blocks(coefs[0], table[:, None, 0])
    assert torch.equal(packed[:, :1].to(torch.float32), want)
    assert np.round(below) == 0 and np.rint(np.float32(0.5)) == 0
    # The kernel's source spells the same three operations out.
    src = open(k3.SOURCE).read()
    body = src[src.index("__device__ __forceinline__ int quantize("):]
    body = body[:body.index("}")]
    assert "__fdiv_rn(c, q)" in body
    assert "floorf(__fadd_rn(fabsf(s), 0.5f))" in body
    code = re.sub(r"//[^\n]*", "", src)
    assert "roundf" not in code and "rintf" not in code
    assert not any("fast_math" in f for f in k3.NVCC_FLAGS)


def test_scan_bytes_at_is_one_entry_on_the_card():
    """The card's route of scan_bytes_at names K4 alone: no packed
    quantize, no K3a over int16 blocks; and quantize_packed stays one
    function under both of its names."""
    import inspect

    assert size_search.quantize_packed is temit.quantize_packed
    src = inspect.getsource(size_search._CardOracle)
    assert "quantize_count.launch" in src
    assert "quantize_packed" not in src and "oracle_stats" not in src
    assert ".item()" not in src and ".tolist()" not in src
    assert ".cpu()" not in src
    c_src = open(k3.SOURCE).read()
    assert "fennec_jpeg_quantize_count" in c_src
    # One launch site serves K3a and K4; K3b has its own.
    assert len(re.findall(r"<<<", c_src)) == 2


def test_check_coefs_refuses_what_the_kernel_cannot_take():
    coefs, ph, pw = port_coefs(make_noise_image(48, 32, seed=1), True)
    lay = temit.layout_on(ph, pw, True, CPU)
    tables = size_search.quality_tables_on(CPU)
    std = temit.std_tables_on(CPU)
    k3.check_coefs(coefs, tables, lay, std)
    with pytest.raises(TypeError, match="float32"):
        k3.check_coefs([c.double() for c in coefs], tables, lay, std)
    with pytest.raises(ValueError, match="contiguous"):
        k3.check_coefs([coefs[0].transpose(1, 2).contiguous().transpose(1, 2)
                        [:, :, :64], *coefs[1:]], tables, lay, std)
    with pytest.raises(ValueError, match="layout"):
        k3.check_coefs(coefs, tables, temit.layout_on(16, 16, True, CPU),
                       std)
    with pytest.raises(ValueError, match="quality tables"):
        k3.check_coefs(coefs, tables[:100].contiguous(), lay, std)
    with pytest.raises(ValueError, match="tables"):
        k3.check_coefs(coefs, tables, lay, std.expand(2, 2, 272).contiguous())
    with pytest.raises(ValueError, match="qualities"):
        k3.quantize_count(coefs, tables, torch.tensor([5, 6]), lay, std)
    with pytest.raises(ValueError, match="qualities"):
        k3.quantize_count(coefs, tables, torch.tensor([5], dtype=torch.int32),
                          lay, std)
