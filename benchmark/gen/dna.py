"""30-mer keys as 2-bit words (A=0, C=1, G=2, T=3; base 0 in the top bits)."""

from __future__ import annotations

import numpy as np

KSIZE = 30
MASK60 = np.uint64((1 << 60) - 1)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def revcomp(keys: np.ndarray) -> np.ndarray:
    """Reverse complement of 30-mer keys (uint64): complement every 2-bit
    code, then reverse the order of the 32 codes of the word (the two zero
    codes above bit 60 land at the bottom and are shifted out)."""
    x = np.asarray(keys, dtype=np.uint64) ^ MASK60
    x = ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)) | (
        (x & np.uint64(0x3333333333333333)) << np.uint64(2))
    x = ((x >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F)) | (
        (x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4))
    return x.byteswap() >> np.uint64(4)


def key_chars(keys: np.ndarray) -> np.ndarray:
    """ASCII letters [n, 30] of keys (a column at a time: no [n, 30] array of
    64-bit words)."""
    keys = np.asarray(keys, np.uint64)
    out = np.empty((len(keys), KSIZE), dtype=np.uint8)
    for p in range(KSIZE):
        out[:, p] = ACGT[((keys >> np.uint64(2 * (KSIZE - 1 - p))) & np.uint64(3)).astype(np.uint8)]
    return out


def spread(n: int, lo: int, hi: int) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi]: every seed draws the
    same set and only permutes it, so the work of a request does not move
    with the seed."""
    return lo + (np.arange(n, dtype=np.int64) * (hi - lo + 1)) // max(n, 1)
