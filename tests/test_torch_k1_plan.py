"""How kernel K1 cuts a call into CTAs, and how it is built.

launch_plan (fennec_tpu_torch/ops/ssim_cuda.py) is pure Python: the
kernel itself runs only on a card (tests/test_torch_cuda.py), but what it
covers, how many partial sums it leaves per image and how many CTAs it
gives the card are pinned here, at the main path's shapes and ragged
ones.
"""

import pathlib
import re

import numpy as np
import pytest

from fennec_tpu_torch.ops import ssim_cuda
from fennec_tpu_torch.ops.ssim_cuda import (
    BLOCK_ROWS,
    H100_CTAS_PER_SM,
    H100_SMS,
    NVCC_FLAGS,
    STRIP,
    WARPS,
    launch_plan,
)

# The main path's shapes (12 MP and 1080p probes, the batch chunk, the
# target-size calls, 4K, ssim() at full resolution on a 12 MP photo) and
# ragged ones (edges, a strip or band that is cut short, one window
# position).
SHAPES = [(1, 384, 512), (1, 288, 512), (4, 288, 512), (64, 500, 500),
          (1, 500, 500), (5, 499, 499), (1, 2160, 3840), (1, 3024, 4032),
          (1, 9, 9),
          (2, 9, 300), (1, 1000, 9), (3, 137, 261), (1, 2161, 3839)]
OCCUPANCY = [2, 4, 6, 8]  # CTAs of K1 per SM a card might hold
WINDOW = 8
HALO = WINDOW - 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_window_position_is_covered_once(shape):
    bsz, h, w = shape
    oh, ow = h - WINDOW, w - WINDOW
    plan = launch_plan(bsz, h, w)
    seen = np.zeros((oh, ow), np.int32)
    for band in range(plan.bands):
        for strip in range(plan.strips):
            y0, x0 = band * plan.band_rows, strip * STRIP
            assert y0 < oh and x0 < ow  # no CTA without a position
            seen[y0:y0 + plan.band_rows, x0:x0 + STRIP] += 1
    assert seen.min() == seen.max() == 1


@pytest.mark.parametrize("per_sm", OCCUPANCY)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_fills_one_wave(shape, per_sm):
    """The CTAs fit in one resident wave (unless one band per image is
    already more), and bands are as short as that wave allows."""
    bsz, h, w = shape
    plan = launch_plan(bsz, h, w, H100_SMS, per_sm)
    oh = h - WINDOW
    slots = H100_SMS * per_sm
    assert plan.strips == -(-(w - WINDOW) // STRIP)
    assert plan.bands == -(-oh // plan.band_rows)
    assert plan.bands == 1 or bsz * plan.strips * plan.bands <= slots
    wave = max(1, slots // (bsz * plan.strips))
    shorter = plan.band_rows - BLOCK_ROWS
    assert shorter < 1 or -(-oh // shorter) > wave


@pytest.mark.parametrize("per_sm", OCCUPANCY)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_partials_follow_the_image_not_the_plan(shape, per_sm):
    """Bands start on blocks of BLOCK_ROWS rows and the partial sums are
    one per warp, strip and block, so an image sums in the same order
    alone, in any batch and at any occupancy."""
    bsz, h, w = shape
    plan = launch_plan(bsz, h, w, H100_SMS, per_sm)
    assert plan.bands == 1 or plan.band_rows % BLOCK_ROWS == 0
    assert plan.partials == \
        -(-(h - WINDOW) // BLOCK_ROWS) * plan.strips * WARPS
    assert plan.partials == launch_plan(1, h, w, H100_SMS, 1).partials


@pytest.mark.parametrize("per_sm", OCCUPANCY)
@pytest.mark.parametrize("shape", [(1, 384, 512), (1, 288, 512),
                                   (1, 500, 500)], ids=str)
def test_small_probe_shapes_fill_every_sm(shape, per_sm):
    plan = launch_plan(*shape, H100_SMS, per_sm)
    assert shape[0] * plan.strips * plan.bands >= H100_SMS


@pytest.mark.parametrize("per_sm", OCCUPANCY)
@pytest.mark.parametrize("shape", [(1, 2160, 3840), (64, 500, 500),
                                   (1, 3024, 4032)], ids=str)
def test_halo_rows_stay_under_15_percent(shape, per_sm):
    bsz, h, w = shape
    plan = launch_plan(bsz, h, w, H100_SMS, per_sm)
    assert HALO * plan.bands / (h - WINDOW) <= 0.15


def test_plan_is_cached_and_pure():
    assert launch_plan(64, 500, 500) is launch_plan(64, 500, 500)
    assert launch_plan(1, 384, 512, H100_SMS, H100_CTAS_PER_SM) == \
        launch_plan(1, 384, 512)


SOURCE = pathlib.Path(ssim_cuda.SOURCE).read_text()


def test_built_without_fma_contraction():
    assert "--fmad=false" in NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS


@pytest.mark.parametrize("name,value", [("kStrip", STRIP),
                                        ("kBlockRows", BLOCK_ROWS)])
def test_source_layout_matches_the_plan(name, value):
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert int(found.group(1)) == value
    assert "constexpr int kThreads = kStrip / 2;" in SOURCE
    assert "constexpr int kWarps = kThreads / 32;" in SOURCE
    assert STRIP // 2 // 32 == WARPS


def test_no_float_atomics():
    """The only atomic is the integer ticket per image: a float atomic
    would sum partials in an order that changes from call to call."""
    calls = re.findall(r"\batomic\w*\s*\(([^,]*),", SOURCE)
    assert calls == ["&tickets[img]"]
    assert re.search(r"unsigned int\* __restrict__ tickets", SOURCE)


def test_one_launch_per_call():
    """One kernel and one launch site in the source."""
    assert len(re.findall(r"__global__", SOURCE)) == 1
    assert len(re.findall(r"<<<", SOURCE)) == 1
