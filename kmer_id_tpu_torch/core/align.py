"""Banded affine-gap alignment verifier (the reference's optional SW check).

The reference carries a banded DP (beam=8) with affine gaps (GAPO=11, GAPX=1,
MATCH=5, MISMATCH=-4, free end gaps) used to verify reads against the hit
org's genome when ``gcount[target] < minalign`` (``newkmer_10nx.cpp:365-450,
530-587``).  All shipped configs set ``minalign = 0`` (``:27``), so the path
is disabled in production; moreover the reference's DP tables are neither
cleared between calls nor fully initialized inside the band's top-right edge,
making its exact cell values state/memory-dependent.  This implementation
computes the *intended* recurrence with clean boundaries:

    M[j][i] = max(M,I,D)[j-1][i-1] + (dna1[i-1]==dna2[j-1] ? MATCH : MISMATCH)
    I[j][i] = max(M[j-1][i] - GAPO, I[j-1][i] - GAPX)
    D[j][i] = max(M[j][i-1] - GAPO, D[j][i-1] - GAPX)
    score   = max(M,I,D)[len2][len1],   band |i-j| <= beam

vectorized across the band per row, with the in-row D dependency closed by
the running-max prefix trick (affine-gap chains from M[j][k] reduce to
``max_k (M[j][k] + k*GAPX)``).

The accept threshold and windowing logic (``minscr = 5*len(read)/2``,
position/strand-derived genome window, reverse-complement when strands
differ) live in engine/verify.py.

Copy of ``kmer_id_tpu/core/align.py``.
"""

from __future__ import annotations

import numpy as np

GAPO = 11
GAPX = 1
MATCH = 5
MISMATCH = -4
BEAM = 8
NINF = -(2 ** 30)


def banded_align_score(dna1: str, dna2: str, beam: int = BEAM) -> int:
    """Alignment score of dna1 (read) vs dna2 (genome window)."""
    n1, n2 = len(dna1), len(dna2)
    if n1 == 0 or n2 == 0:
        return 0
    a = np.frombuffer(dna1.encode("latin-1"), dtype=np.uint8)
    b = np.frombuffer(dna2.encode("latin-1"), dtype=np.uint8)
    # Row j covers columns i in [max(0, j-beam), min(n1, j+beam)] (0-based
    # cells; DP index i corresponds to dna1[i-1]).  Store full rows for
    # simplicity (n1 is read-sized); mask outside the band.
    cols = np.arange(n1 + 1)
    M = np.zeros(n1 + 1, dtype=np.int64)  # free end gaps: top row 0
    I = np.full(n1 + 1, NINF, dtype=np.int64)
    D = np.full(n1 + 1, NINF, dtype=np.int64)
    for j in range(1, n2 + 1):
        lo = max(1, j - beam)
        hi = min(n1, j + beam)
        prev_best = np.maximum(np.maximum(M, I), D)
        Mj = np.full(n1 + 1, NINF, dtype=np.int64)
        Ij = np.full(n1 + 1, NINF, dtype=np.int64)
        Dj = np.full(n1 + 1, NINF, dtype=np.int64)
        if j <= beam:
            Mj[0] = 0  # free leading gap in dna2
            Ij[0] = 0
        if lo <= hi:
            seg = slice(lo, hi + 1)
            sub = np.where(a[lo - 1 : hi] == b[j - 1], MATCH, MISMATCH)
            Mj[seg] = prev_best[lo - 1 : hi] + sub
            Ij[seg] = np.maximum(M[seg] - GAPO, I[seg] - GAPX)
            # D[j][i] = max_{k<i} (M[j][k] - GAPO - (i-1-k)*GAPX): close the
            # in-row chain with a running max of (M[j][k] + k*GAPX)
            chain = (Mj - GAPO) + cols * GAPX
            np.maximum.accumulate(chain, out=chain)
            Dj[seg] = chain[lo - 1 : hi] - (cols[seg] - 1) * GAPX
        M, I, D = Mj, Ij, Dj
    return int(max(M[n1], I[n1], D[n1]))
