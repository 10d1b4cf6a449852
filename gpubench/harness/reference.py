"""The comparison that decides `correct`, and the control that has to fail
it.

The reference is plain.py in float64 and jpeg.read, fed only what the
benchmark itself made: the levels of the input files it wrote, or the
pixels it handed to the program.  It reads the program's outputs only
to judge them.  For each request it compares three numbers, each held
to a limit of the cell's configuration:

  decode_mismatch_ppm  (file cells) pixel values, per million, where the
                       program's decoded and oriented image differs from
                       the reference's decode of the same file;
  search_gap           the largest SSIM error the program's answer
                       implies: how far, in SSIMFast, the reference's
                       score of a probe on the bisection path that ends
                       at the program's quality lies on the other side of
                       the target, or the reported SSIM lies from the
                       reference's score of that quality;
  coef_mismatch_ppm    levels, per million, where the program's file
                       differs from the reference's quantization of its
                       own input at the program's quality (every level
                       when the file is not a baseline 4:2:0 JPEG of the
                       right size and tables).

Control (the control's system): the same arithmetic in TF32 put in the
program's place, decoding its input files with jpeg.read and coding its
outputs with jpeg.write.
"""

from __future__ import annotations

import struct
import types
from typing import Optional

import numpy as np
import torch

from . import jpeg, plain

ALL_WRONG = 1e6


class Case:
    """What the benchmark knows of one request's input: the levels of the
    file it wrote (with their quality and EXIF orientation), or the
    pixels it handed over."""

    def __init__(self, levels=None, quality: int = 0, orientation: int = 1,
                 rgb: Optional[np.ndarray] = None, size=None):
        self.levels, self.quality = levels, quality
        self.orientation, self.rgb = orientation, rgb
        self.size = size  # (w, h) of the file

    @property
    def is_file(self) -> bool:
        return self.levels is not None


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """The upright image of an (H, W, C) image stored with EXIF
    `orientation` (1 upright, 3 rotated 180, 6 and 8 rotated 90)."""
    k = {1: 0, 3: 2, 6: -1, 8: 1}.get(orientation)
    if k is None:
        raise ValueError(f"orientation {orientation} is not in this mix")
    return torch.rot90(img, k=k, dims=(0, 1)) if k else img


def expected_pixels(case: Case, device) -> torch.Tensor:
    """The upright (H, W, 3) image the program should compress."""
    if not case.is_file:
        return torch.from_numpy(np.ascontiguousarray(case.rgb[..., :3])).to(
            device)
    w, h = case.size
    levels = [torch.from_numpy(lv.astype(np.int64)).to(device).reshape(
        *lv.shape[:2], 8, 8) for lv in case.levels]
    tables = plain.quality_table(case.quality).to(device)
    rgb = plain.reconstruct(levels, tables, h, w, "float64")
    return orient(rgb, case.orientation)


def search_gap(scorer: plain.Scorer, target: float, quality: int,
               ssim: float) -> float:
    """See the module docstring.  A quality no bisection path reaches
    reads 1."""
    paths = []
    if 1 <= quality <= 100:
        q, path = plain.bisect_path(target, lambda m: quality <= m)
        if q == quality:
            paths.append((path, True))
    if quality == 100:  # nothing met the target: every probe rejected
        paths.append((plain.bisect_path(target, lambda m: False)[1], False))
    best = 1.0
    for path, accepted in paths:
        gap = 0.0
        for mid, ok in path:
            s = scorer(mid)
            if (s >= target) != ok:
                gap = max(gap, abs(s - target))
        gap = max(gap, abs(ssim - (scorer(quality) if accepted else 1.0)))
        best = min(best, gap)
    return best


def coef_mismatch_ppm(data: bytes, planes, quality: int, w: int, h: int
                      ) -> float:
    """See the module docstring."""
    try:
        f = jpeg.read(bytes(data))
    except (ValueError, IndexError, KeyError, struct.error):
        return ALL_WRONG
    tables = plain.quality_table(quality).reshape(2, 64).numpy()
    if ((f.width, f.height) != (w, h)
            or [c[1:3] for c in f.comps] != [(2, 2), (1, 1), (1, 1)]
            or any(not np.array_equal(f.qtables.get(c[3]), tables[t])
                   for c, t in zip(f.comps, (0, 1, 1)))):
        return ALL_WRONG
    want = plain.quantize(planes, quality)
    diff = total = 0
    for got, ref in zip(f.levels, want):
        ref = ref.reshape(*ref.shape[:2], 64).cpu().numpy()
        if got.shape != ref.shape:
            return ALL_WRONG
        diff += int(np.count_nonzero(got != ref))
        total += ref.size
    return 1e6 * diff / total


def judge(case: Case, result, target: float, device) -> dict:
    """The numbers of one request's result (quality, ssim, compressed
    bytes and, for files, the decoded image) against the reference."""
    want = expected_pixels(case, device)
    out = {}
    if case.is_file:
        got = np.asarray(result.image)
        if got.shape[:2] != tuple(want.shape[:2]):
            out["decode_mismatch_ppm"] = ALL_WRONG
        else:
            ref = want.to(torch.uint8).cpu().numpy()
            out["decode_mismatch_ppm"] = (
                1e6 * np.count_nonzero(got[..., :3] != ref) / ref.size)
    scorer = plain.Scorer(want, "float64")
    h, w = want.shape[:2]
    out["search_gap"] = search_gap(scorer, target, int(result.jpeg_quality),
                                   float(result.ssim))
    out["coef_mismatch_ppm"] = coef_mismatch_ppm(
        result.compressed_data, scorer.planes, int(result.jpeg_quality), w, h)
    return out


class Control:
    """The reference in TF32 in the program's place, for the entry point
    the cells drive (compress_file)."""

    prec = "tf32"

    def __init__(self, device, target: float):
        self.device = torch.device(device)
        self.target = target

    def _compress(self, rgb: torch.Tensor, image: np.ndarray):
        scorer = plain.Scorer(rgb, self.prec)
        q, path = plain.bisect_path(self.target,
                                    lambda m: scorer(m) >= self.target)
        found = any(ok for _, ok in path)
        h, w = rgb.shape[:2]
        data = jpeg.write(plain.quantize(scorer.planes, q), w, h, q)
        return types.SimpleNamespace(
            jpeg_quality=q, ssim=scorer(q) if found else 1.0,
            compressed_data=data, image=image)

    def compress_file(self, src: str, dst: str):
        with open(src, "rb") as fh:
            f = jpeg.read(fh.read())
        levels = [torch.from_numpy(lv).to(self.device).reshape(
            *lv.shape[:2], 8, 8) for lv in f.levels]
        tables = torch.stack([torch.from_numpy(f.qtables[c[3]]).reshape(8, 8)
                              for c in f.comps[:2]]).to(self.device)
        rgb = orient(plain.reconstruct(levels, tables, f.height, f.width,
                                       self.prec), f.orientation)
        image = np.concatenate(
            [rgb.to(torch.uint8).cpu().numpy(),
             np.full((*rgb.shape[:2], 1), 255, np.uint8)], axis=-1)
        res = self._compress(rgb, image)
        with open(dst, "wb") as fh:
            fh.write(res.compressed_data)
        return res
