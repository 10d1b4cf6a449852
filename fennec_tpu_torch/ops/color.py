"""Colour transforms: BT.601 luminance and JPEG YCbCr, in torch.

Counterpart of fennec_tpu/ops/color.py.  Luminance is
0.299 R + 0.587 G + 0.114 B on the non-premultiplied channels (reference
ssim.go:207-220); values stay float32 in [0, 255].  Rounding is
floor(x + 0.5), half away from zero for pixels: never torch.round, which
rounds half to even.
"""

from __future__ import annotations

import torch

_LUMA_R = 0.299
_LUMA_G = 0.587
_LUMA_B = 0.114


def luminance(img: torch.Tensor) -> torch.Tensor:
    """BT.601 luminance of an (..., H, W, C>=3) float tensor → (..., H, W)."""
    return (_LUMA_R * img[..., 0] + _LUMA_G * img[..., 1]
            + _LUMA_B * img[..., 2])


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float RGB in [0,255] → (..., 3) YCbCr in [0,255]
    (ITU-T T.871 full range)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """(..., 3) float YCbCr in [0,255] → (..., 3) RGB (unclamped)."""
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 128.0, ycc[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5): Go's math.Round on the non-negative pixel domain
    (reference convert.go:149-158)."""
    return torch.floor(x + 0.5)


def clamp_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half away and clamp to [0, 255], staying float32."""
    return torch.clamp(round_half_away(x), 0.0, 255.0)
