"""Per-image optimal Huffman table construction (ITU T.81 Annex K.2).

The K.2 builder of fennec_tpu/codecs/huffopt.py, copied jax-free.  As in
the JAX package, the tables are built by the C++ builder
(native.jpeg_build_optimal_specs, which releases the GIL: the batch
engines encode on a thread pool), and this Python merge loop stays as the
parity oracle the tests hold it to.
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
    minimal valid table.  The C++ builder does the work."""
    from .. import native

    return _specs_from_raw(*native.jpeg_build_optimal_specs(
        np.reshape(dc_freq, (1, 2, 16)), np.reshape(ac_freq, (1, 2, 256))))[0]


def _specs_from_raw(bits: np.ndarray, vals: np.ndarray,
                    nvals: np.ndarray) -> list:
    """(B, 4, 16) / (B, 4, 256) / (B, 4) C-builder output → per-image
    (dc_specs, ac_specs); table order dc-luma, dc-chroma, ac-luma,
    ac-chroma."""
    out = []
    for j in range(bits.shape[0]):
        specs = [(bits[j, t].tolist(), vals[j, t, :nvals[j, t]].tolist())
                 for t in range(4)]
        out.append((specs[:2], specs[2:]))
    return out


def code_tables_batch(bits: np.ndarray, vals: np.ndarray,
                      nvals: np.ndarray, size: int) -> np.ndarray:
    """Canonical code tables of N specs at once (JAX :183-212): bits
    (N, 16), vals (N, V) in canonical (length, value) order, nvals (N,)
    → (N, size) int32, each entry code << 5 | length, 0 for an absent
    symbol.  The canonical walk in closed form: the k-th code is
    (2^L_k · Σ_{j<k} 2^(16-L_j)) >> 16, exact in int64 because lengths
    do not decrease."""
    n, v = vals.shape
    k = np.arange(v, dtype=np.int64)
    cum = np.cumsum(bits.astype(np.int64), axis=1)  # (N, 16)
    lens = 1 + np.sum(k[None, None, :] >= cum[:, :, None], axis=1)
    valid = k[None, :] < nvals[:, None].astype(np.int64)
    lens = np.where(valid, lens, 0)
    kraft = np.where(valid, np.int64(1) << (16 - lens), 0)
    pre = np.cumsum(kraft, axis=1) - kraft
    codes = ((np.int64(1) << lens) * pre) >> 16
    packed = ((codes << 5) | lens).astype(np.int32)
    out = np.zeros((n, size + 1), np.int32)  # invalid lanes: a spill column
    tgt = np.where(valid, vals.astype(np.int64), size)
    np.put_along_axis(out, tgt, np.where(valid, packed, 0), axis=1)
    return out[:, :size]


def specs_and_tables_batch(dc_freq: np.ndarray, ac_freq: np.ndarray):
    """Everything the optimal-table emission needs, in one C call (JAX
    :231-260): per-image (dc_specs, ac_specs) for the DHT segments, and
    the (B, 2, 16) DC and (B, 2, 256) AC packed code tables (code << 5 |
    length).  Raises ValueError like the builder when a code would
    exceed 32 bits."""
    from .. import native

    bits, vals, nvals = native.jpeg_build_optimal_specs(dc_freq, ac_freq)
    b = bits.shape[0]
    dcp = code_tables_batch(bits[:, :2].reshape(b * 2, 16),
                            vals[:, :2].reshape(b * 2, -1),
                            nvals[:, :2].reshape(-1), 16).reshape(b, 2, 16)
    acp = code_tables_batch(bits[:, 2:].reshape(b * 2, 16),
                            vals[:, 2:].reshape(b * 2, -1),
                            nvals[:, 2:].reshape(-1), 256).reshape(b, 2, 256)
    return _specs_from_raw(bits, vals, nvals), dcp, acp


def specs_from_frequencies_py(dc_freq: np.ndarray, ac_freq: np.ndarray):
    """The Python merge loop: specs_from_frequencies's parity oracle."""
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
