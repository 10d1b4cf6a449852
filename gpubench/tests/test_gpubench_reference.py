"""The plain reference against hand-made good and bad outputs, the
writer and reader of JPEG files, and the control: the reference in TF32
put in the program's place has to come out not correct."""

import types

import numpy as np
import pytest
import torch

from tiny import CELLS, run_cell

from gpubench.harness import jpeg, plain, reference
from gpubench.harness.photo import photo, photos

TARGET = 0.94


def small_photo(seed=3, w=96, h=64):
    return photos(1, w, h, seed, "cpu")[0, ..., :3]


def good_result(rgb: torch.Tensor):
    """What a correct program returns: the reference's own answer."""
    scorer = plain.Scorer(rgb, "float64")
    q, path = plain.bisect_path(TARGET, lambda m: scorer(m) >= TARGET)
    h, w = rgb.shape[:2]
    data = jpeg.write(plain.quantize(scorer.planes, q), w, h, q)
    image = np.concatenate([rgb.to(torch.uint8).numpy(),
                            np.full((h, w, 1), 255, np.uint8)],
                           axis=-1)
    return types.SimpleNamespace(jpeg_quality=q, ssim=scorer(q),
                                 compressed_data=data, image=image)


def image_case(rgb):
    return reference.Case(rgb=rgb.numpy())


def test_the_writer_and_reader_agree_and_carry_the_orientation():
    rgb = small_photo()
    levels = plain.quantize(plain.forward(rgb, "float64"), 92)
    data = jpeg.write(levels, 96, 64, 92, orientation=6)
    f = jpeg.read(data)
    assert (f.width, f.height, f.orientation) == (96, 64, 6)
    for got, want in zip(f.levels, levels):
        assert np.array_equal(got, want.reshape(*want.shape[:2], 64).numpy())
    with pytest.raises(ValueError):
        jpeg.read(data[:-40] + data[-2:])


def test_the_device_generator_draws_the_frozen_picture():
    """photos() draws photo()'s picture: the same gradients and waves
    under noise of the same strength."""
    a = photo(64, 48, 1).astype(np.float64)
    b = photos(1, 64, 48, 1, "cpu")[0].numpy().astype(np.float64)
    assert a.shape == b.shape and (b[..., 3] == 255).all()
    assert photos(1, 64, 48, 1, "cpu").equal(photos(1, 64, 48, 1, "cpu"))
    assert abs(a.mean() - b.mean()) < 20 and abs(a.std() - b.std()) < 20


def test_a_good_answer_reads_near_zero():
    rgb = small_photo()
    out = reference.judge(image_case(rgb), good_result(rgb), TARGET, "cpu")
    assert out == {"search_gap": 0.0, "coef_mismatch_ppm": 0.0}


def test_bad_answers_read_high():
    rgb = small_photo()
    good = good_result(rgb)
    case = image_case(rgb)
    # Another quality, its file coded honestly: the path's gap is the
    # distance of a score on the wrong side of the target.
    scorer = plain.Scorer(rgb, "float64")
    q = good.jpeg_quality + 3
    other = types.SimpleNamespace(
        jpeg_quality=q, ssim=scorer(q), image=good.image,
        compressed_data=jpeg.write(plain.quantize(scorer.planes, q), 96, 64,
                                   q))
    assert reference.judge(case, other, TARGET, "cpu")["search_gap"] > 1e-4
    # The right quality with a wrong SSIM.
    lying = types.SimpleNamespace(**{**vars(good), "ssim": good.ssim + 0.01})
    assert reference.judge(case, lying, TARGET, "cpu")["search_gap"] >= 0.009
    # One level changed in the file.
    levels = list(plain.quantize(scorer.planes, good.jpeg_quality))
    levels[0] = levels[0].clone()
    levels[0][0, 0, 0, 1] += 1
    bent = types.SimpleNamespace(**{**vars(good), "compressed_data":
                                    jpeg.write(levels, 96, 64,
                                               good.jpeg_quality)})
    out = reference.judge(case, bent, TARGET, "cpu")
    assert 0 < out["coef_mismatch_ppm"] < 1e6
    # A file cut short, or another quality's tables.
    cut = types.SimpleNamespace(**{**vars(good), "compressed_data":
                                   good.compressed_data[:200] + b"\xff\xd9"})
    assert reference.judge(case, cut, TARGET,
                           "cpu")["coef_mismatch_ppm"] == 1e6
    wrong_q = types.SimpleNamespace(**{**vars(good), "jpeg_quality":
                                       good.jpeg_quality - 1})
    assert reference.judge(case, wrong_q, TARGET,
                           "cpu")["coef_mismatch_ppm"] == 1e6


def test_a_decode_off_by_one_reads_high():
    rgb = small_photo()
    levels = plain.quantize(plain.forward(rgb, "float64"), 92)
    host = [lv.reshape(*lv.shape[:2], 64).numpy() for lv in levels]
    case = reference.Case(levels=host, quality=92, orientation=6,
                          size=(96, 64))
    upright = reference.expected_pixels(case, "cpu")
    good = good_result(upright)
    assert reference.judge(case, good, TARGET,
                           "cpu")["decode_mismatch_ppm"] == 0.0
    bad_image = good.image.copy()
    bad_image[:8, :8, :3] ^= 1
    bad = types.SimpleNamespace(**{**vars(good), "image": bad_image})
    assert reference.judge(case, bad, TARGET,
                           "cpu")["decode_mismatch_ppm"] > 1000
    unrotated = types.SimpleNamespace(**{**vars(good),
                                         "image": good.image.transpose(
                                             1, 0, 2)})
    assert reference.judge(case, unrotated, TARGET,
                           "cpu")["decode_mismatch_ppm"] == 1e6


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The reference in TF32 in the program's place fails at least one
    of the cell's numbers (its readings at full size are in PERF.md)."""
    control = reference.Control("cpu", TARGET)
    rc, line = run_cell(workload, system=control, seconds=0.2)
    assert rc == 0
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
