"""K4's bisection on the CPU: the step loop, the kernel's plain version
and a plain replay of the kernel's decision rule, against the JAX
package's size_bisect_device.

On a CUDA device engine/size_search.size_bisect is one launch of
csrc/jpeg_emit.cu's fennec_jpeg_size_bisect, which counts each step's
bits into a (7, B) table and replays the bisection's rule from it (every
CTA, after every step).  Here, with no card, the same inputs go through:

  size_bisect_steps   the step loop (scan_bits per step), the CPU route;
  size_bisect (K4)    the wrapper, which on a CPU tensor runs the
                      kernel's plain version (the loop over K4's plain
                      step, ops/jpeg_emit.quantize_count_plain);
  kernel_replay       the kernel's replay<> written out per image in
                      plain integers, applied to the step loop's table;

and each must give the JAX package's (best_q, found), exactly, from the
JAX package's own forward-DCT coefficients (so a rounding tie of the two
DCTs cannot make them differ).  The JAX program runs jitted on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import make_noise_image, make_test_image
from fennec_tpu.codecs.jpeg import forward_dct_device
from fennec_tpu.engine.size_search import size_bisect_device
from fennec_tpu_torch.engine import size_search
from fennec_tpu_torch.ops import jpeg_emit as temit
from fennec_tpu_torch.ops import jpeg_emit_cuda as k3

torch.set_num_threads(1)
CPU = torch.device("cpu")
STEPS = size_search.MAX_STEPS
MASK = (1 << 64) - 1


def wrap(v: int) -> int:
    """v as a two's-complement int64, as the kernel's wrap_add leaves it."""
    v &= MASK
    return v - (1 << 64) if v >> 63 else v


def kernel_replay(table, target, lo0, hi0):
    """fennec_jpeg_size_bisect's replay<true> for every image, in plain
    integers: walk the image's column of the (steps, B) table while
    lo <= hi (mid = (lo + hi) >> 1; fits when (bits + 7) >> 3 <= target),
    and mark the rows after that -1.  Returns (best_q, found, table)."""
    table = [list(map(int, row)) for row in table]
    best_q, found = [], []
    for b in range(len(lo0)):
        lo, hi, best, ok_any = int(lo0[b]), int(hi0[b]), 0, False
        for t, row in enumerate(table):
            if lo > hi:
                row[b] = -1
                continue
            mid = wrap(lo + hi) >> 1
            if wrap(row[b] + 7) >> 3 <= int(target[b]):
                best, ok_any, lo = mid, True, wrap(mid + 1)
            else:
                hi = wrap(mid - 1)
        best_q.append(best)
        found.append(ok_any)
    return best_q, found, table


GEOMETRIES = {
    "420_96x80": (make_noise_image, 96, 80, True),
    "444_64x48": (make_noise_image, 64, 48, False),
    "420_gradient_130x75": (lambda w, h, seed: make_test_image(w, h),
                            130, 75, True),
}

_cache: dict = {}


def batch(name: str, bsz: int):
    """The JAX package's (y, cb, cr) coefficients of bsz images of one
    geometry (jnp, each (N, 64)), the port's (B, N, 64) stacks of the same
    numbers, and the padded geometry."""
    key = (name, bsz)
    if key not in _cache:
        make, w, h, sub = GEOMETRIES[name]
        jax_coefs = [forward_dct_device(jnp.asarray(
            make(w, h, seed=s), dtype=jnp.float32), sub) for s in range(bsz)]
        stacks = [torch.stack([torch.from_numpy(np.array(c[k]))
                               for c in jax_coefs]) for k in range(3)]
        mult = 16 if sub else 8
        _cache[key] = (jax_coefs, stacks, h + (-h) % mult, w + (-w) % mult,
                       sub)
    return _cache[key]


def jax_bisect(coefs, ph, pw, sub, target, lo, hi):
    q, f = size_bisect_device(coefs, ph, pw, sub,
                              target_bytes=jnp.int32(target),
                              lo0=jnp.int32(lo), hi0=jnp.int32(hi))
    return int(q), bool(f)


def check_against_jax(name, targets, los, his):
    """Every route's (best_q, found) for B = len(targets) images equals
    the JAX program's, image by image; the step loop's table equals the
    kernel's plain version's; B = 1 gives 0-d results."""
    bsz = len(targets)
    jax_coefs, stacks, ph, pw, sub = batch(name, bsz)
    want = [jax_bisect(jax_coefs[i], ph, pw, sub, targets[i], los[i],
                       his[i]) for i in range(bsz)]
    t, lo, hi = (torch.tensor(v, dtype=torch.int64)
                 for v in (targets, los, his))
    if bsz == 1:  # one image: (N, 64) components, 0-d bounds and results
        coefs = [c[0] for c in stacks]
        t, lo, hi = t[0], lo[0], hi[0]
    else:
        coefs = stacks
    q, f, table = size_search.size_bisect_steps(coefs, ph, pw, sub, t, lo,
                                                hi)
    assert q.shape == t.shape and f.shape == t.shape and f.dtype == torch.bool
    assert table.shape == (STEPS,) + tuple(t.shape)
    q2, f2 = size_search.size_bisect(coefs, ph, pw, sub, t, lo, hi)
    assert torch.equal(q, q2) and torch.equal(f, f2)
    got = list(zip(q.reshape(-1).tolist(), f.reshape(-1).tolist()))
    assert got == want

    # The kernel's plain version through its wrapper (no launch on the CPU).
    lay = temit.layout_on(ph, pw, sub, CPU)
    bounds = torch.stack([torch.tensor(v, dtype=torch.int64)
                          for v in (targets, los, his)])
    before = k3.size_bisect.launches
    kq, kf, ktable = k3.size_bisect(
        stacks, size_search.quality_tables_on(CPU), lay,
        temit.std_tables_on(CPU), bounds, STEPS)
    assert k3.size_bisect.launches == before
    assert kq.tolist() == [w[0] for w in want]
    assert kf.tolist() == [w[1] for w in want]
    assert torch.equal(ktable, table.reshape(STEPS, bsz))

    # The kernel's replay from the table, with the rows of finished images
    # zeroed as the kernel holds them until its final pass.
    raw = torch.where(ktable < 0, 0, ktable).tolist()
    rq, rf, rtable = kernel_replay(raw, targets, los, his)
    assert list(zip(rq, rf)) == want
    assert rtable == ktable.tolist()
    return table.reshape(STEPS, bsz)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("targets,los,his", [
    ([4000], [1], [100]),
    ([20], [1], [100]),            # nothing fits
    ([10 ** 6], [1], [100]),       # everything fits
    ([900], [70], [20]),           # lo0 > hi0: nothing read
    ([1500, 300, 99999, 1, 2500], [10, 1, 60, 1, 40],
     [70, 40, 100, 100, 40]),
], ids=["one", "none_fits", "all_fit", "empty", "five"])
def test_routes_equal_jax(name, targets, los, his):
    check_against_jax(name, targets, los, his)


@settings(max_examples=12, deadline=None, database=None, derandomize=True)
@given(st.sampled_from(sorted(GEOMETRIES)),
       st.sampled_from([1, 5]).flatmap(lambda n: st.lists(
           st.tuples(st.integers(0, 6000), st.integers(-4, 106),
                     st.integers(-4, 106)), min_size=n, max_size=n)))
def test_drawn_targets_and_ranges_equal_jax(name, cases):
    """Targets and ranges drawn by hypothesis for one image (0-d) and for
    five, empty ranges and qualities outside [0, 100] (clamped for the
    count, kept in best_q) included."""
    targets, los, his = (list(v) for v in zip(*cases))
    check_against_jax(name, targets, los, his)


def test_table_rows_are_each_steps_bits():
    """Row s holds scan_bits at step s's mid for every image still
    searching, -1 for every other."""
    _, stacks, ph, pw, sub = batch("420_96x80", 5)
    lo = torch.tensor([1, 50, 80, 1, 30])
    hi = torch.tensor([100, 50, 20, 3, 100])
    table = size_search.size_bisect_steps(stacks, ph, pw, sub, 1200, lo,
                                          hi)[2]
    for s in range(STEPS):
        active = lo <= hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        bits = size_search.scan_bits(*size_search.quantize_at(stacks, mid),
                                     ph, pw, sub)
        assert torch.equal(table[s], torch.where(active, bits, -1))
        ok = active & (torch.div(bits + 7, 8, rounding_mode="floor") <= 1200)
        lo = torch.where(ok, mid + 1, lo)
        hi = torch.where(active & ~ok, mid - 1, hi)
    assert (table[:, 2] == -1).all()  # lo0 > hi0: never read


@pytest.mark.parametrize("seed", range(4))
def test_finished_image_ignores_later_counts(seed):
    """Once an image's range is empty its best_q and found are final: the
    kernel does not read it again, and whatever its later cells hold
    (zeros until the final pass, or anything) changes neither result, in
    the kernel's replay nor in the step rule replayed from the table."""
    _, stacks, ph, pw, sub = batch("420_96x80", 5)
    targets, los, his = [1500, 300, 99999, 1, 2500], [40, 1, 95, 7, 60], \
        [60, 40, 100, 9, 40]
    table = size_search.size_bisect_steps(
        stacks, ph, pw, sub, torch.tensor(targets), torch.tensor(los),
        torch.tensor(his))[2]
    want = kernel_replay(table.tolist(), targets, los, his)[:2]
    rng = np.random.default_rng(seed)
    noisy = table.clone()
    done = table < 0
    assert done.any()
    noisy[done] = torch.from_numpy(rng.integers(
        0, 1 << 40, int(done.sum()))).to(torch.int64)
    assert kernel_replay(noisy.tolist(), targets, los, his)[:2] == want
    rows = iter(noisy)
    q, f, _ = temit.bisect_steps(lambda mid: next(rows),
                                 torch.tensor(targets), torch.tensor(los),
                                 torch.tensor(his), STEPS)
    assert (q.tolist(), f.tolist()) == want


def test_bounds_checks():
    """The wrapper refuses bounds or steps the kernel cannot take."""
    _, stacks, ph, pw, sub = batch("420_96x80", 5)
    lay = temit.layout_on(ph, pw, sub, CPU)
    qt = size_search.quality_tables_on(CPU)
    std = temit.std_tables_on(CPU)
    good = torch.ones((3, 5), dtype=torch.int64)
    for bad in (good.to(torch.int32), good[:, :4], good[:2],
                good.t().contiguous().t(), good.numpy()):
        with pytest.raises(ValueError, match="bounds"):
            k3.size_bisect(stacks, qt, lay, std, bad, STEPS)
    for steps in (0, 9, 7.0):
        with pytest.raises(ValueError, match="steps"):
            k3.size_bisect(stacks, qt, lay, std, good, steps)
    with pytest.raises(TypeError, match="float32"):
        k3.size_bisect([c.double() for c in stacks], qt, lay, std, good,
                       STEPS)


def test_bisection_is_one_entry_on_the_card():
    """On a CUDA device size_bisect names K4's bisection alone: no step
    loop, no K4 step, no plain version, no host sync; the kernel is
    launched cooperatively (no `<<<`, which test_torch_k3_oracle counts
    for the other entries)."""
    import inspect

    src = inspect.getsource(size_search.size_bisect)
    body = src[:src.index("return best_q, found\n")]
    assert ".bisect(" in body and "size_bisect_steps" not in body
    assert "bisect_steps" not in inspect.getsource(
        size_search._CardOracle.bisect)
    c_src = open(k3.SOURCE).read()
    entry = c_src[c_src.index("int fennec_jpeg_size_bisect("):]
    entry = entry[:entry.index("\n}\n")]
    assert "cudaLaunchCooperativeKernel" in entry
    assert entry.count("cudaMemsetAsync") == 1
    for word in (".item()", ".tolist()", ".cpu()", "for _ in"):
        assert word not in inspect.getsource(size_search._CardOracle)
