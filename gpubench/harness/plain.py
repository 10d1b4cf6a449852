"""The plain reference's arithmetic, in plain torch ops: JPEG's colour
transform, the 8x8 DCT, quantization, the decode model, and SSIMFast with
upstream fennec's quality bisection (compress.go:21-87, ssim.go:48-166).

It is written apart from the program under test and imports nothing of
it.  Every function takes `prec`:

  "float64"  the reference: every value in float64;
  "tf32"     the control: float32, and every matrix product's inputs
             rounded to TF32's 10-bit mantissa, as tensor cores round
             them.  The configurations state float32 with TF32 off, so
             this is the nearest precision below them.

Images are (H, W, 3) tensors of integral values 0..255; coefficient
planes are block grids (..., BH, BW, 8, 8) in natural order.
"""

from __future__ import annotations

import math

import torch

STD_LUMA_QUANT = (
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99)
STD_CHROMA_QUANT = (
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32

# ZIGZAG[i] is the natural index of the i-th coefficient in zigzag order.
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

SSIM_C1 = (0.01 * 255.0) ** 2
SSIM_C2 = (0.03 * 255.0) ** 2
WINDOW = 8
SSIM_FAST_MAX = 512
BISECT_STEPS = 7


def dtype_of(prec: str) -> torch.dtype:
    if prec not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {prec!r}")
    return torch.float64 if prec == "float64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) at TF32's 10-bit
    mantissa."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in `prec`."""
    if prec == "tf32":
        return torch.matmul(tf32(a), tf32(b))
    return torch.matmul(a, b)


def quality_table(quality: int) -> torch.Tensor:
    """(2, 8, 8) int64 [luma, chroma] tables at `quality`, libjpeg's
    scaling (scale 5000/q under 50, else 200 - 2q; clamped to 1..255)."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    base = torch.tensor([STD_LUMA_QUANT, STD_CHROMA_QUANT], dtype=torch.int64)
    return torch.clamp((base * scale + 50) // 100, 1, 255).reshape(2, 8, 8)


def dct_matrix(dtype: torch.dtype, device) -> torch.Tensor:
    """Orthonormal 8-point DCT-II matrix D: coefficients = D x."""
    k = torch.arange(8, dtype=torch.float64)[:, None]
    i = torch.arange(8, dtype=torch.float64)[None, :]
    d = torch.cos((2 * i + 1) * k * math.pi / 16) * math.sqrt(2 / 8)
    d[0] = math.sqrt(1 / 8)
    return d.to(dtype=dtype, device=device)


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., H/8, W/8, 8, 8)."""
    h, w = plane.shape[-2:]
    x = plane.reshape(*plane.shape[:-2], h // 8, 8, w // 8, 8)
    return x.transpose(-3, -2)


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(..., BH, BW, 8, 8) → (..., 8 BH, 8 BW)."""
    bh, bw = blocks.shape[-4:-2]
    return blocks.transpose(-3, -2).reshape(*blocks.shape[:-4], bh * 8,
                                            bw * 8)


def basis(dtype: torch.dtype, device) -> torch.Tensor:
    """(64, 64) K with K[8u + v, 8i + j] = D[u, i] D[v, j].  The entries
    that are exactly +-1/8 (products of the DC and the 4th basis
    functions) are set exactly, so that a block of those frequencies alone
    reconstructs to its exact value: such blocks land on exact halves,
    where a rounding one ulp off would move whole flat regions by a
    level."""
    k = torch.kron(dct_matrix(torch.float64, "cpu"),
                   dct_matrix(torch.float64, "cpu"))
    eighths = torch.round(k * 8) / 8
    k = torch.where((k - eighths).abs() < 1e-12, eighths, k)
    return k.to(dtype=dtype, device=device)


def fdct(blocks: torch.Tensor, prec: str) -> torch.Tensor:
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return mm(flat, basis(blocks.dtype, blocks.device).T,
              prec).reshape(blocks.shape)


def idct(blocks: torch.Tensor, prec: str) -> torch.Tensor:
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return mm(flat, basis(blocks.dtype, blocks.device),
              prec).reshape(blocks.shape)


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5) clamped to 0..255 (Go's rounding of a pixel)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def ycc_to_rgb(y, cb, cr) -> torch.Tensor:
    cb, cr = cb - 128.0, cr - 128.0
    return torch.stack([y + 1.402 * cr,
                        y - 0.344136286 * cb - 0.714136286 * cr,
                        y + 1.772 * cb], dim=-1)


def edge_pad(plane: torch.Tensor, mult: int) -> torch.Tensor:
    """Replicate the last row and column up to multiples of `mult`."""
    h, w = plane.shape[-2:]
    rows = torch.arange(h + (-h) % mult, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(w + (-w) % mult, device=plane.device).clamp(max=w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def forward(rgb: torch.Tensor, prec: str):
    """Unquantized 4:2:0 coefficient planes (y, cb, cr) of an (H, W, 3)
    image: JPEG's YCbCr, edge-padded to 16, chroma averaged over 2 x 2,
    minus 128, forward DCT."""
    x = rgb.to(dtype_of(prec))
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    y, cb, cr = (edge_pad(p, 16) for p in (y, cb, cr))
    ch, cw = cb.shape[0] // 2, cb.shape[1] // 2
    cb = cb.reshape(ch, 2, cw, 2).mean(dim=(1, 3))
    cr = cr.reshape(ch, 2, cw, 2).mean(dim=(1, 3))
    return tuple(fdct(to_blocks(p - 128.0), prec) for p in (y, cb, cr))


def quantize(planes, quality: int):
    """Quantized levels (int64) of coefficient planes at `quality`,
    rounding half away from zero."""
    t = quality_table(quality).to(planes[0].device)
    out = []
    for p, tab in zip(planes, (t[0], t[1], t[1])):
        s = p / tab.to(p.dtype)
        out.append((torch.sign(s) * torch.floor(torch.abs(s) + 0.5))
                   .to(torch.int64))
    return tuple(out)


def reconstruct(levels, tables, h: int, w: int, prec: str) -> torch.Tensor:
    """The decode model: (H, W, 3) integral RGB of 4:2:0 levels (y, cb,
    cr) dequantized by `tables` ((2, 8, 8) luma, chroma), inverse DCT,
    plus 128, chroma replicated 2 x 2, YCbCr to RGB, rounded."""
    dt = dtype_of(prec)
    planes = []
    for lv, tab in zip(levels, (tables[0], tables[1], tables[1])):
        deq = lv.to(dt) * tab.to(device=lv.device, dtype=dt)
        planes.append(from_blocks(idct(deq, prec)) + 128.0)
    y, cb, cr = planes
    cb = cb.repeat_interleave(2, 0).repeat_interleave(2, 1)
    cr = cr.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return round_u8(ycc_to_rgb(y[:h, :w], cb[:h, :w], cr[:h, :w]))


def ssim_fast_dims(w: int, h: int):
    """SSIMFast's downsampled size (ssim.go:52-60)."""
    if w <= SSIM_FAST_MAX and h <= SSIM_FAST_MAX:
        return w, h
    scale = SSIM_FAST_MAX / max(w, h)
    return (int(max(8, math.floor(w * scale + 0.5))),
            int(max(8, math.floor(h * scale + 0.5))))


def box_matrix(dst: int, src: int, dtype, device):
    """(dst, src) 0/1 matrix of boxDownsample's rectangles (ssim.go:
    244-284) and each rectangle's count."""
    ratio = src / dst
    m = torch.zeros((dst, src), dtype=dtype)
    for d in range(dst):
        a, b = int(d * ratio), min(int((d + 1) * ratio), src)
        if a >= b:
            a = b - 1
        m[d, max(a, 0):b] = 1.0
    return m.to(device), m.sum(dim=1).to(device)


def lum(rgb: torch.Tensor, prec: str) -> torch.Tensor:
    """SSIMFast's luminance of an (H, W, 3) integral image: over 512 px
    each channel box-averaged exactly (integer sums) and rounded, then
    BT.601 luminance."""
    h, w = rgb.shape[:2]
    dt = dtype_of(prec)
    x = rgb.to(dt).permute(2, 0, 1)
    dw, dh = ssim_fast_dims(w, h)
    if (dw, dh) != (w, h):
        mh, ch = box_matrix(dw, w, dt, rgb.device)
        mv, cv = box_matrix(dh, h, dt, rgb.device)
        sums = mm(mm(mv, x, prec), mh.T, prec)
        x = round_u8(sums / (cv[:, None] * ch[None, :]))
    return 0.299 * x[0] + 0.587 * x[1] + 0.114 * x[2]


def gauss_taps(dtype, device) -> torch.Tensor:
    xs = torch.arange(-4, 4, dtype=torch.float64)
    g = torch.exp(-(xs * xs) / (2 * 1.5 * 1.5))
    return (g / g.sum()).to(dtype=dtype, device=device)


def _band(n: int, g: torch.Tensor) -> torch.Tensor:
    """(n, n - 8) B with B[c + k, c] = g[k]: x @ B sums each window of 8
    along x's last axis, taps in order."""
    b = torch.zeros((n, n - WINDOW), dtype=g.dtype, device=g.device)
    c = torch.arange(n - WINDOW, device=g.device)
    for k in range(WINDOW):
        b[c + k, c] = g[k]
    return b


def windowed_ssim(a: torch.Tensor, b: torch.Tensor, prec: str) -> float:
    """Mean SSIM over 8 x 8 Gaussian windows (sigma 1.5) centred on
    [4, h-4) x [4, w-4) (ssim.go:73-166); 1.0 where no window fits.  The
    separable window sums are matrix products with banded matrices."""
    h, w = a.shape[-2:]
    if min(h, w) <= WINDOW:
        return 1.0
    g = gauss_taps(a.dtype, a.device)
    stats = torch.stack([a, b, a * a, b * b, a * b])
    stats = mm(_band(h, g).T, mm(stats, _band(w, g), prec), prec)
    mu_a, mu_b, aa, bb, ab = stats
    num = (2 * mu_a * mu_b + SSIM_C1) * (2 * (ab - mu_a * mu_b) + SSIM_C2)
    den = ((mu_a * mu_a + mu_b * mu_b + SSIM_C1)
           * (aa - mu_a * mu_a + bb - mu_b * mu_b + SSIM_C2))
    return float((num / den).mean())


def seed_lo(target: float) -> int:
    """The bisection's first lower bound (compress.go:35-43)."""
    for t, lo in ((0.99, 75), (0.97, 50), (0.94, 30), (0.90, 15)):
        if target >= t:
            return lo
    return 1


def bisect_path(target: float, decide):
    """Upstream fennec's bisection of JPEG quality: 7 probes over
    [seed_lo(target), 100], each accepted when decide(q) is true.
    Returns (quality, [(probe, accepted)]); quality is 100 when no probe
    was accepted."""
    lo, hi, best = seed_lo(target), 100, None
    path = []
    for _ in range(BISECT_STEPS):
        if lo > hi:
            break
        mid = (lo + hi) // 2
        ok = bool(decide(mid))
        path.append((mid, ok))
        if ok:
            best, hi = mid, mid - 1
        else:
            lo = mid + 1
    return (100 if best is None else best), path


class Scorer:
    """SSIMFast of an image's reconstructions at any quality against the
    image itself, as the search scores its probes."""

    def __init__(self, rgb: torch.Tensor, prec: str):
        self.prec = prec
        self.h, self.w = rgb.shape[:2]
        self.planes = forward(rgb, prec)
        self.lum0 = lum(rgb, prec)
        self.memo = {}

    def __call__(self, quality: int) -> float:
        if quality not in self.memo:
            levels = quantize(self.planes, quality)
            tables = quality_table(quality).to(self.lum0.device)
            rec = reconstruct(levels, tables, self.h, self.w, self.prec)
            self.memo[quality] = windowed_ssim(self.lum0, lum(rec, self.prec),
                                               self.prec)
        return self.memo[quality]
