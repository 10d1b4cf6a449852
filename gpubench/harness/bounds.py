"""Least device times: the H100's published peaks, the bound arithmetic
of chip_smoke.py (k1_bound, k2_bound, k3_bound, k5_bound, k78_bound,
bisect_bound) frozen here as it stood when the benchmark was defined,
and the work of one compressed image counted from its shapes.

A bound is the larger of operations over the peak rate and bytes over
the memory rate, each input byte read once and each output byte written
once.  image_bound_s counts what a request needs whatever kernels do it
(the decode's reconstruction, the forward DCT and the original's
luminance, seven probes of reconstruction and windowed SSIM, the
emission), so a kernel that is fused, renamed or redesigned leaves the
count as it was.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, dense rates, at its full 700 W.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
INT_ISSUE_PER_S = 33.4e12  # 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
SM_CLOCK_HZ = 1.98e9

K1_FLOPS_PER_POSITION = 174
K3A_INSTR_PER_BLOCK = 250
K3B_INSTR_PER_BLOCK = 380
K3A_INSTR_PER_NONZERO = 14
K3A_HIST_INSTR_PER_NONZERO = 22
K3B_INSTR_PER_NONZERO = 44
# K5's thread instructions per compare-exchange of its bitonic sort, per
# merge of the two-queue walk, per pointer-doubling round of a merge, and
# per table over its 32 lanes (chip_smoke.py reckons each from
# csrc/huffbuild.cu).
K5_INSTR_PER_EXCHANGE = 6
K5_INSTR_PER_MERGE = 24
K5_INSTR_PER_DOUBLING = 8
K5_INSTR_PER_TABLE = 32 * 400


def _bound(t_ops: float, t_bytes: float):
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k1_bound(shape):
    """(least ms, "operations" or "bytes") of windowed SSIM over a
    (B, H, W) pair: 174 flops per window position, 8 bytes a pixel."""
    bsz, h, w = shape
    flops = K1_FLOPS_PER_POSITION * bsz * (h - 8) * (w - 8)
    nbytes = 8 * bsz * h * w + 4 * bsz
    return _bound(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def k2_bound(coefs: int, lum_values: int, bsz: int, h: int, w: int,
             rectangles: int = 0):
    """(least ms, ...) of one probe's reconstruction: every float32
    coefficient read once, the luminance written once, the tables and
    the box rectangles read once; 34 flops a coefficient and 16 a pixel."""
    nbytes = 4 * coefs + 4 * lum_values + 4 * (101 * 128 + 64) \
        + 4 * rectangles
    flops = 34 * coefs + 16 * bsz * h * w
    return _bound(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def k3_bound(blocks: int, slots: int, nnz: int, bsz: int, n_words: int,
             kind: str):
    """(least ms, ...) of one emission launch over `blocks` blocks with
    `nnz` nonzero AC levels; kind "total", "hist" or "deposit"."""
    nbytes = blocks * 128 + slots * 12 + 2 * 272 * 4
    if kind == "deposit":
        nbytes += 4 * n_words + 8 * bsz
        instr = blocks * K3B_INSTR_PER_BLOCK + nnz * K3B_INSTR_PER_NONZERO
    elif kind == "hist":
        nbytes += bsz * (8 + 544 * 4)
        instr = blocks * K3A_INSTR_PER_BLOCK + nnz * K3A_HIST_INSTR_PER_NONZERO
    else:
        nbytes += bsz * 8
        instr = blocks * K3A_INSTR_PER_BLOCK + nnz * K3A_INSTR_PER_NONZERO
    return _bound(instr / INT_ISSUE_PER_S, nbytes / HBM_BYTES_PER_S)


def code_lengths(freq: np.ndarray) -> np.ndarray:
    """Annex K.2's code sizes of one frequency table (the reserved symbol
    included by the caller), before the limit to 16 bits."""
    freq = [int(f) for f in freq]
    size = [0] * len(freq)
    others = [-1] * len(freq)
    live = [i for i, f in enumerate(freq) if f > 0]
    while len(live) > 1:
        live.sort(key=lambda i: (freq[i], -i))
        v1, v2 = live[0], live[1]
        freq[v1] += freq[v2]
        freq[v2] = 0
        live.remove(v2)
        for v in (v1, v2):
            while True:
                size[v] += 1
                if others[v] < 0:
                    break
                v = others[v]
        while others[v1] >= 0:
            v1 = others[v1]
        others[v1] = v2
    return np.array(size)


def k5_bound(hist: np.ndarray, step: dict):
    """(least ms, ..., serial-chain ms) of one table build over (B, 544)
    histograms, the chain at `step`'s cycles of a link and a compare."""
    bsz = hist.shape[0]
    freq = np.zeros((bsz, 4, 257), np.int64)
    freq[:, :2, :16] = hist[:, :32].reshape(bsz, 2, 16)
    freq[:, 2:, :256] = hist[:, 32:].reshape(bsz, 2, 256)
    freq[:, :, 0] += freq.sum(axis=2) == 0  # an empty class codes 0
    freq[:, :, 256] = 1  # the reserved symbol
    chains = (freq > 0).sum(axis=2).ravel()
    width = np.maximum(32, 1 << np.ceil(np.log2(chains)).astype(np.int64))
    lg = np.log2(width).astype(np.int64)
    exchanges = int((width * lg * (lg + 1) // 4).sum())
    deepest = np.array([code_lengths(f).max() for f in
                        freq.reshape(-1, 257)]) - 1
    rounds = np.maximum(1, np.ceil(np.log2(np.maximum(deepest, 1))))
    nbytes = bsz * 4 * (544 + 2 * 272 + 208) + 4 * 2 * 272
    ops = (K5_INSTR_PER_EXCHANGE * exchanges
           + K5_INSTR_PER_MERGE * int((chains - 1).sum())
           + K5_INSTR_PER_DOUBLING * int((rounds * (chains - 1)).sum())
           + 4 * bsz * K5_INSTR_PER_TABLE)
    chain = (int((chains - 1).max()) * (step["link"] + step["compare"])
             / SM_CLOCK_HZ)
    return (*_bound(ops / INT_ISSUE_PER_S, nbytes / HBM_BYTES_PER_S),
            chain * 1e3)


def k78_bound(nbytes: float, fmas: float):
    """(bound ms, ...): the bytes over the memory rate, the multiply-adds
    (two operations each) over the float32 rate, the larger."""
    return _bound(2 * fmas / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def bisect_bound(coef_blocks: int, active_steps: int, images: int) -> dict:
    """A size bisection's least time from its bytes: 256 B of float32
    coefficients per block at every step an image was still searching
    ("reread") and every input read once ("once"), in ms."""
    per_image = coef_blocks * 256
    return {"reread_bound_ms": active_steps * per_image / HBM_BYTES_PER_S
            * 1e3,
            "bound_ms": images * per_image / HBM_BYTES_PER_S * 1e3}


def image_bound_s(h: int, w: int, out_bytes: int,
                  decode_nnz: int = -1, probes: int = 7) -> float:
    """Least device seconds of one h x w 4:2:0 image's request: the
    decode's reconstruction when decode_nnz >= 0 (its levels, 2 bytes
    each, read once, the RGB written once, 64 multiply-adds a nonzero),
    the forward DCT (the RGB read once, float32 coefficients written, 16
    multiply-adds a coefficient) with the original's luminance written,
    `probes` probes (k2_bound, then k1_bound on the luminance), and the
    emission (2 bytes a level read once, the file written once)."""
    ph, pw = h + (-h) % 16, w + (-w) % 16
    coefs = ph * pw * 3 // 2
    if max(h, w) > 512:
        scale = 512 / max(h, w)
        dh, dw = (max(8, int(np.floor(h * scale + 0.5))),
                  max(8, int(np.floor(w * scale + 0.5))))
    else:
        dh, dw = h, w
    ms = 0.0
    if decode_nnz >= 0:
        ms += k78_bound(2 * coefs + 3 * h * w, 64 * decode_nnz)[0]
    ms += k78_bound(3 * h * w + 4 * coefs + 4 * dh * dw, 16 * coefs)[0]
    per_probe = k2_bound(coefs, dh * dw, 1, h, w)[0]
    if dh > 8 and dw > 8:
        per_probe += k1_bound((1, dh, dw))[0]
    ms += probes * per_probe
    ms += (2 * coefs + out_bytes) / HBM_BYTES_PER_S * 1e3
    return ms / 1e3
