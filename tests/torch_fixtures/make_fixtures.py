"""Regenerate the JPEG fixtures the port's card check decodes.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fixtures.py

The machine with the card has no PIL and no JAX, so the two inputs the
port cannot make itself are committed: a progressive JPEG (PIL) and a
baseline multi-scan JPEG (one scan per component, written by the JAX
package's own entropy coder, tests/test_multiscan.py).  Both are
1280x720 photo-like images made from a numpy seed.
"""

import io
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SEED = 20261016
W, H = 1280, 720


def photo(w: int, h: int, seed: int) -> np.ndarray:
    """Opaque (h, w, 4) uint8: gradients, soft waves, hard-edged
    rectangles and coarse noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 255.0 * x / w
    img[..., 1] = 255.0 * y / h
    img[..., 2] = 128.0 + 90.0 * np.sin(x / 97.0) * np.cos(y / 61.0)
    for _ in range(24):
        x0, x1 = sorted(rng.integers(0, w, 2))
        y0, y1 = sorted(rng.integers(0, h, 2))
        img[y0:y1, x0:x1] += rng.uniform(-60, 60, 3).astype(np.float32)
    coarse = rng.normal(0, 10, (h // 16 + 1, w // 16 + 1, 3))
    img += np.repeat(np.repeat(coarse.astype(np.float32), 16, 0), 16,
                     1)[:h, :w]
    img += rng.normal(0, 2.0, (h, w, 3)).astype(np.float32)
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = np.clip(img, 0, 255)
    out[..., 3] = 255
    return out


def main() -> None:
    from PIL import Image

    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE.parent.parent))
    from test_multiscan import build_multiscan_jpeg

    buf = io.BytesIO()
    Image.fromarray(photo(W, H, SEED)[..., :3], "RGB").save(
        buf, "JPEG", quality=85, progressive=True, subsampling=0)
    (HERE / "progressive_1280x720.jpg").write_bytes(buf.getvalue())
    (HERE / "multiscan_1280x720.jpg").write_bytes(
        build_multiscan_jpeg(photo(W, H, SEED + 1), 85))


if __name__ == "__main__":
    main()
