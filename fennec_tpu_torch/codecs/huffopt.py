"""Per-image optimal Huffman table construction (ITU T.81 Annex K.2).

The K.2 builder of fennec_tpu/codecs/huffopt.py, copied jax-free.  The
JAX package builds batches of specs in C++ and keeps this Python loop as
the parity oracle; the single-image path here runs the loop itself (one
image, four tables, about 2 ms on the host), so the native façade needs
no extra entry point.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def optimal_spec(freq: np.ndarray) -> Tuple[List[int], List[int]]:
    """(BITS[16], VALS) for the given symbol frequencies.

    Implements the one-reserved-symbol, 16-bit-limited code construction
    of T.81 K.2 (the libjpeg jpeg_gen_optimal_table procedure): pairwise
    merge of the two least-frequent chains, then redistribution of code
    lengths beyond 16 bits.
    """
    n = len(freq)
    if not np.any(np.asarray(freq) > 0):
        # No coded symbols: empty spec (the table is never referenced).
        return [0] * 16, []
    f = np.zeros(n + 1, dtype=np.int64)
    f[:n] = freq
    f[n] = 1  # reserved symbol: guarantees no all-ones code
    codesize = np.zeros(n + 1, dtype=np.int64)
    others = np.full(n + 1, -1, dtype=np.int64)

    while True:
        nz = np.nonzero(f > 0)[0]
        if nz.size <= 1:
            break
        fnz = f[nz]
        m1 = fnz.min()
        v1 = int(nz[fnz == m1].max())
        rest = nz[nz != v1]
        frest = f[rest]
        m2 = frest.min()
        v2 = int(rest[frest == m2].max())

        f[v1] += f[v2]
        f[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = int(others[v1])
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = int(others[v2])
            codesize[v2] += 1

    bits = np.zeros(33, dtype=np.int64)
    for s in range(n + 1):
        cs = int(codesize[s])
        if cs > 32:
            # libjpeg's jpeg_gen_optimal_table errors here: clamping
            # would oversubscribe bits[32] and break the Kraft invariant
            # the K.3 redistribution assumes, emitting a broken DHT.
            raise ValueError(
                "fennec: optimal Huffman code length exceeds 32 bits")
        if cs > 0:
            bits[cs] += 1

    # Limit code lengths to 16 bits (K.2 Figure K.3).
    i = 32
    while i > 16:
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        i -= 1
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved symbol's slot

    # VALS: real symbols ordered by (code length, symbol value).
    order = sorted((s for s in range(n) if codesize[s] > 0),
                   key=lambda s: (int(codesize[s]), s))
    return [int(b) for b in bits[1:17]], order


def specs_from_frequencies(dc_freq: np.ndarray, ac_freq: np.ndarray):
    """Build (dc_specs, ac_specs) lists for classes [luma, chroma] from
    (2, 16) and (2, 256) frequency arrays; classes with no symbols get a
    minimal valid table."""
    dc_specs, ac_specs = [], []
    for cls in range(2):
        dfi = dc_freq[cls].copy()
        afi = ac_freq[cls].copy()
        if dfi.sum() == 0:
            dfi[0] = 1
        if afi.sum() == 0:
            afi[0] = 1
        dc_specs.append(optimal_spec(dfi))
        ac_specs.append(optimal_spec(afi))
    return dc_specs, ac_specs
