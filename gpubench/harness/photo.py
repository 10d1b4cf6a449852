"""Photo-like test images.

photo() is chip_smoke.photo as it stood when the benchmark was defined,
frozen here: gradients, soft waves, 24 hard-edged rectangles, coarse
noise over 16 px cells and per-pixel noise of std `fine` (thousands of
colours, so AUTO picks JPEG).  photos() draws the same picture with a
torch.Generator on the target device, a batch at a time, so that set-up
makes 12 MP inputs on the card in milliseconds; the same seed gives the
same pixels on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

RECTANGLES = 24
CELL = 16


def photo(w: int, h: int, seed: int, fine: float = 3.0) -> np.ndarray:
    """Opaque photo-like (h, w, 4) uint8: gradients, soft waves, hard
    edges, coarse noise and per-pixel noise of std `fine` (thousands of
    colours, so AUTO picks JPEG)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 255.0 * x / w
    img[..., 1] = 255.0 * y / h
    img[..., 2] = 128.0 + 90.0 * np.sin(x / 97.0) * np.cos(y / 61.0)
    del x, y
    for _ in range(RECTANGLES):  # hard-edged rectangles
        x0, x1 = sorted(rng.integers(0, w, 2))
        y0, y1 = sorted(rng.integers(0, h, 2))
        img[y0:y1, x0:x1] += rng.uniform(-60, 60, 3).astype(np.float32)
    coarse = rng.normal(0, 10, (h // CELL + 1, w // CELL + 1, 3))
    img += np.repeat(np.repeat(coarse.astype(np.float32), CELL, 0),
                     CELL, 1)[:h, :w]
    img += rng.normal(0, fine, (h, w, 3)).astype(np.float32)
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = np.clip(img, 0, 255)
    out[..., 3] = 255
    return out


def photos(n: int, w: int, h: int, seed: int, device, fine: float = 3.0
           ) -> torch.Tensor:
    """n photo() pictures as one (n, h, w, 4) uint8 tensor on `device`,
    opaque like photo()'s, drawn from one torch.Generator seeded with
    `seed`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    base = torch.stack(torch.broadcast_tensors(
        255.0 * x / w, 255.0 * y / h,
        128.0 + 90.0 * torch.sin(x / 97.0) * torch.cos(y / 61.0)), dim=-1)
    img = base.expand(n, h, w, 3).clone()
    xs = torch.sort(torch.randint(0, w, (n, RECTANGLES, 2), generator=gen,
                                  device=dev), dim=-1).values.tolist()
    ys = torch.sort(torch.randint(0, h, (n, RECTANGLES, 2), generator=gen,
                                  device=dev), dim=-1).values
    ys = ys.tolist()
    shift = (torch.rand((n, RECTANGLES, 3), generator=gen, device=dev)
             * 120.0 - 60.0)
    for i in range(n):
        for r in range(RECTANGLES):
            (x0, x1), (y0, y1) = xs[i][r], ys[i][r]
            img[i, y0:y1, x0:x1] += shift[i, r]
    coarse = torch.randn((n, h // CELL + 1, w // CELL + 1, 3), generator=gen,
                         device=dev) * 10.0
    img += coarse.repeat_interleave(CELL, 1).repeat_interleave(
        CELL, 2)[:, :h, :w]
    img += torch.randn((n, h, w, 3), generator=gen, device=dev) * fine
    out = torch.full((n, h, w, 4), 255, dtype=torch.uint8, device=dev)
    out[..., :3] = img.clamp_(0, 255)
    return out
