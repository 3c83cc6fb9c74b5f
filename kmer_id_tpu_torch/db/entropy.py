"""Vectorized probe complexity filter.

Reimplements ``check_entropy`` (``kmer_build_vf6.cpp:460-551``) over arrays of
packed keys instead of per-string loops:

* reject if any homopolymer run exceeds 11 bases (``:485-494,524``);
* base-composition entropies with +1 pseudocounts over three position-class
  groups — i mod 2 (2 classes), i mod 3 (3 classes), i mod 5 (5 classes)
  (``:499-519``); each group's mean entropy, normalized by log10(4), must be
  >= 0.80 (``:537-543``).

All arithmetic in float64 to match the reference's doubles.  (The reference's
trailing ``keyF`` debug check uses an uninitialized variable and only prints;
it does not affect acceptance and is not reproduced.)

Copy of ``kmer_id_tpu/db/entropy.py``.
"""

from __future__ import annotations

import numpy as np

from kmer_id_tpu_torch.core.codec import KSIZE

_MOD2 = np.arange(KSIZE) % 2
_MOD3 = np.arange(KSIZE) % 3
_MOD5 = np.arange(KSIZE) % 5
_LOG10_4 = np.log10(4.0)


def keys_to_codes(keys: np.ndarray) -> np.ndarray:
    """Unpack uint64 canonical keys to [M, KSIZE] base codes (MSB first)."""
    keys = np.asarray(keys, dtype=np.uint64)
    shifts = np.array([2 * (KSIZE - 1 - j) for j in range(KSIZE)], dtype=np.uint64)
    return ((keys[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)


def _group_entropy(codes: np.ndarray, classes: np.ndarray, nclasses: int) -> np.ndarray:
    """Mean normalized entropy over one position-class group; [M]."""
    m = codes.shape[0]
    ent_sum = np.zeros(m, dtype=np.float64)
    for cls in range(nclasses):
        cols = classes == cls
        sub = codes[:, cols]
        counts = np.ones((m, 4), dtype=np.float64)  # +1 pseudocount per base
        for b in range(4):
            counts[:, b] += (sub == b).sum(axis=1)
        total = counts.sum(axis=1, keepdims=True)
        p = counts / total
        ent_sum += -(p * np.log10(p)).sum(axis=1)
    return ent_sum / nclasses / _LOG10_4


def max_homopolymer(codes: np.ndarray) -> np.ndarray:
    """Longest run of identical bases per row; [M] int32."""
    m, k = codes.shape
    runs = np.ones((m, k), dtype=np.int32)
    for j in range(1, k):
        same = codes[:, j] == codes[:, j - 1]
        runs[:, j] = np.where(same, runs[:, j - 1] + 1, 1)
    return runs.max(axis=1)


def check_entropy_keys(
    keys: np.ndarray, min_entropy: float = 0.80, max_run: int = 11
) -> np.ndarray:
    """Boolean acceptance mask for an array of packed keys."""
    codes = keys_to_codes(keys)
    ok = max_homopolymer(codes) <= max_run
    e2 = _group_entropy(codes, _MOD2, 2)
    e3 = _group_entropy(codes, _MOD3, 3)
    e5 = _group_entropy(codes, _MOD5, 5)
    ok &= ~((e2 < min_entropy) | (e3 < min_entropy) | (e5 < min_entropy))
    return ok
