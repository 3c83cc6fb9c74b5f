"""Host-side pieces of the engine (numpy only): :class:`Engine`, the
interface of every engine, and copies of ``PendingBatch``, ``fold_host_many``
and ``fold_host`` from ``kmer_id_tpu/engine/classify.py``, which cannot be
imported here because that module imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PendingBatch:
    """In-flight device work for one batch."""

    packed: object  # device int32: [B] finals, or the legacy engine's summary
    codes: object  # the rows (Batch, or legacy ReadPlanes) for the overflow replay
    held: list  # the device tensors the collect reads, as submit filled them
    n_rows: int


class Engine:
    """The calls the sample loop makes of every engine: ``new_seen()``,
    ``submit_batch(seen, batch)`` -> (seen, pending), ``collect_many(seen,
    pendings)`` -> (seen, [finals, ...]), ``process_long_many(seen, items)``
    -> (seen, [final, ...]) and ``ucount(seen)``; the legacy engine's
    ``detail_batch`` serves the ``minalign > 0`` replay.  An engine defines
    ``collect(seen, pending)`` and its own ``process_long_many`` or a
    one-read lane ``_long_one(seen, item)`` -> (seen, final); the rest is
    written here once."""

    def collect_many(self, seen, pendings: list):
        """:meth:`collect` of each pending batch, in order."""
        out = []
        for p in pendings:
            seen, finals = self.collect(seen, p)
            out.append(finals)
        return seen, out

    def process_long_many(self, seen, items: list):
        """``_long_one`` of each read, in order."""
        finals = []
        for item in items:
            seen, f = self._long_one(seen, item)
            finals.append(f)
        return seen, finals

    def process_batch(self, seen, batch):
        """One batch submitted and collected: (seen, finals)."""
        seen, pending = self.submit_batch(seen, batch)
        return self.collect(seen, pending)

    def process_long(self, seen, item):
        """One read longer than ``max_len``: (seen, final)."""
        seen, finals = self.process_long_many(seen, [item])
        return seen, finals[0]


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
