"""Host-side pieces of the engine (numpy only).

Copies of ``PendingBatch``, ``fold_host_many`` and ``fold_host`` from
``kmer_id_tpu/engine/classify.py``, which cannot be imported here because
that module imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PendingBatch:
    """In-flight device work for one batch."""

    packed: object  # device int32: [B] finals, or the legacy engine's summary
    codes: object  # the rows (Batch, or legacy ReadPlanes) for the overflow replay
    lengths: object
    n_rows: int


def fold_host_many(tax, seqs: list) -> np.ndarray:
    """Exact ordered msca fold of many reads' hit sequences, batched: one
    vectorized ``tax.msca`` step per hit rank over all reads."""
    r = len(seqs)
    out = np.zeros(r, dtype=np.int64)
    if r == 0:
        return out
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    h = int(lens.max(initial=0))
    if h == 0:
        return out
    plane = np.zeros((r, h), dtype=np.int64)
    for i, s in enumerate(seqs):
        plane[i, : len(s)] = s
    f = np.zeros(r, dtype=np.int64)
    for col in range(h):
        t = plane[:, col]
        use = t > 0
        if not use.any():
            continue
        merged = tax.msca(t, f)
        f = np.where(use, np.where(f > 0, merged, t), f)
    return f


def fold_host(tax, targets: np.ndarray) -> int:
    """Exact host-side ordered fold of an in-order window-target sequence.

    If every hit is an ancestor-or-self of the deepest hit the fold is
    order-free (= that hit); otherwise run the literal sequential msca fold
    (``newkmer_10nx.cpp:588-595``).
    """
    hits = targets[targets > 0]
    if hits.size == 0:
        return 0
    deepest = int(hits[int(np.argmax(tax.depth[hits]))])
    if bool(np.all(tax.is_anc_or_self(hits, deepest))):
        return deepest
    final = 0
    for t in hits.tolist():
        final = int(tax.msca(t, final)) if final > 0 else t
    return final
