"""Vectorized PHRED quality trimming.

Behavioral spec (reference ``process_qual``, ``newkmer_10nx.cpp:714-760``;
the vf6 variant ``kmer_read_vf6.cpp:671-713`` sums raw quality chars against
``49*4`` where nx sums ``char-32`` against ``17*4`` — algebraically identical,
so one implementation serves all variants):

With PHRED+33 quality chars ``q[0..len-1]``, cutoff char ``'1'`` (= 32+17):

1. ``stop = len-1; start = 0``; advance ``start`` while ``q[start] < 49`` and
   ``start < stop`` (stop still at its initial value);
2. retreat ``stop`` while ``q[stop] < 49`` and ``stop > start``;
3. if ``start < stop-4``: advance ``start`` while the 4-wide window sum
   ``q[start]+...+q[start+3] < 196`` and ``start < stop-4``;
4. if (re-checked) ``start < stop-4``: retreat ``stop`` while
   ``q[stop-3]+...+q[stop] < 196`` and ``start < stop-4``;
5. the read is kept iff ``stop - start >= KSIZE`` (i.e. trimmed length >= 31 —
   a 30-base trimmed read is *dropped*, reproducing the reference off-by-one).

This module computes (start, stop, keep) for a whole padded batch with NumPy
prefix scans instead of per-read loops; parity with a literal transliteration
of the reference loops is asserted in tests/test_trim.py.

Copy of ``kmer_id_tpu/core/trim.py``.
"""

from __future__ import annotations

import numpy as np

from kmer_id_tpu_torch.core.codec import KSIZE

CUTOFF_CHAR = 49  # '1' == 32 + 17, newkmer_10nx.cpp:717-718
WINDOW = 4
WINDOW_CUT = 196  # 49 * 4 == (17 * 4) + 32 * 4


def trim_batch(qual: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Trim a padded batch of quality strings.

    Args:
      qual: uint8 array [B, L] of PHRED+33 quality chars (padding arbitrary).
      lengths: int array [B] of true read lengths (must be >= 1).

    Returns:
      (start, stop, keep): int32 [B] inclusive trim bounds and a bool mask of
      reads satisfying ``stop - start >= KSIZE``.
    """
    qual = np.asarray(qual, dtype=np.uint8)
    b, l = qual.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    cols = np.arange(l, dtype=np.int64)[None, :]
    inb = cols < lengths[:, None]
    good = (qual >= CUTOFF_CHAR) & inb

    stop0 = lengths - 1
    # start1 = min(first good index, stop0)
    any_good = good.any(axis=1)
    first_good = np.where(any_good, good.argmax(axis=1), np.int64(l))
    start1 = np.minimum(first_good, stop0)
    # stop1 = max(last good index, start1)
    last_good = np.where(any_good, l - 1 - good[:, ::-1].argmax(axis=1), np.int64(-1))
    stop1 = np.maximum(last_good, start1)

    # 4-wide window sums anchored at the window's first (W) / last (Wr) index.
    qi = qual.astype(np.int64) * inb  # zero outside the read; windows used
    cs = np.concatenate([np.zeros((b, 1), dtype=np.int64), np.cumsum(qi, axis=1)], axis=1)
    # W[i] = q[i..i+3] for i <= l-4 (only consulted with i+3 < length)
    wlen = l - WINDOW + 1
    if wlen <= 0:
        keep = (stop1 - start1) >= KSIZE
        return start1.astype(np.int32), stop1.astype(np.int32), keep

    W = cs[:, WINDOW:] - cs[:, :-WINDOW]  # [B, wlen] window starting at i
    passW = W >= WINDOW_CUT

    # Step 3: start2 = min(first i >= start1 with W[i] >= 196, stop1-4),
    # applied only when start1 < stop1 - 4.
    gate3 = start1 < stop1 - WINDOW
    maskW = passW & (np.arange(wlen)[None, :] >= start1[:, None])
    anyW = maskW.any(axis=1)
    firstW = np.where(anyW, maskW.argmax(axis=1), np.int64(l))
    start2 = np.where(gate3, np.minimum(firstW, stop1 - WINDOW), start1)

    # Step 4: stop2 = max(largest j <= stop1 with Wr[j] >= 196, start2+4),
    # applied only when start2 < stop1 - 4.  Wr[j] = W[j-3] for j >= 3.
    gate4 = start2 < stop1 - WINDOW
    # passWr over last-index j in [3, l-1]: passW shifted
    jcols = np.arange(wlen)[None, :] + WINDOW - 1  # last index of each window
    maskWr = passW & (jcols <= stop1[:, None])
    anyWr = maskWr.any(axis=1)
    lastWr = np.where(
        anyWr, wlen - 1 - maskWr[:, ::-1].argmax(axis=1) + WINDOW - 1, np.int64(-1)
    )
    stop2 = np.where(gate4, np.maximum(lastWr, start2 + WINDOW), stop1)

    keep = (stop2 - start2) >= KSIZE
    return start2.astype(np.int32), stop2.astype(np.int32), keep
