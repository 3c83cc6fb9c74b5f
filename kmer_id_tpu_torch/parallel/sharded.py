"""The sharded legacy engine: data-parallel reads x a sorted probe-key array
sharded by key range, on a (data x db) grid of ranks.

Port of ``kmer_id_tpu/parallel/sharded.py`` (``ShardedClassifier``, what
``--engine legacy`` runs on a grid):

* the sorted key words are padded to ``dbp`` equal ranges of
  ``shard_len`` keys with all-ones sentinels (above every 60-bit key), and
  db rank ``k`` holds range ``k``, so a key resolves on exactly one rank;
* per batch, each rank extracts the windows of its data rows
  (``csrc/gate.cu`` extract mode on a card), bisects its range
  (ops/lookup.py ``lookup_keys``), and the per-window targets are summed
  over db (``psum_db``; every rank but the owner adds 0);
* ``seen`` holds the rank's range plus a sink at ``shard_len``;
* the hit summary is ``compact_hits(..., 32)`` (its hit list by
  ``csrc/compact.cu``) and the finals ``resolve_finals``, whose rare
  overflow rows take the target plane again (another ``psum_db``: the
  members of one db group hold the same rows and summaries, so they take
  that branch together);
* ``ucount`` sums ``seen`` over data, counts the rank's probes per target
  and sums over db.
"""

from __future__ import annotations

import numpy as np
import torch

from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.probes import PackedDB
from kmer_id_tpu_torch.engine.classify import resolve_finals
from kmer_id_tpu_torch.engine.host import PendingBatch, fold_host
from kmer_id_tpu_torch.io.batch import Batch, LongRead
from kmer_id_tpu_torch.ops.fold import compact_hits
from kmer_id_tpu_torch.ops.gate import ReadPlanes, extract
from kmer_id_tpu_torch.ops.lookup import lookup_keys
from kmer_id_tpu_torch.ops.probe import mark_seen
from kmer_id_tpu_torch.ops.words import u32_tensor
from kmer_id_tpu_torch.parallel.fpsharded import GridRows
from kmer_id_tpu_torch.parallel.mesh import Grid

MAX_HITS = 32


class ShardedClassifier(GridRows):
    """The legacy engine on one rank of a (data x db) grid, with the JAX
    class's API: ``new_seen`` / ``submit_batch`` / ``collect`` /
    ``process_batch`` / ``process_long`` / ``ucount`` (and the grid's
    ``local_data_rows``, ``make_global_batch``)."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        grid: Grid,
        batch_size: int = 1024,
        max_len: int = 512,
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        self._grid_setup(grid, batch_size)
        self.max_len = max_len
        self.taxonomy = taxonomy
        self.num_targ = db.num_targ
        self.n_probes = len(db)
        target = np.asarray(db.target).astype(np.int32)
        ln = -(-len(db) // self.dbp)
        self.shard_len = ln
        self._bins = max(self.num_targ, int(target.max()) + 1)
        lo, hi = grid.db_index * ln, min((grid.db_index + 1) * ln, len(db))

        def part(a, fill):
            out = np.full(ln, fill, a.dtype)
            out[: max(hi - lo, 0)] = a[lo:hi]
            return out

        self._db = {
            "hi": u32_tensor(part(np.asarray(db.hi, np.uint32), np.uint32(0xFFFFFFFF)),
                             self.device),
            "lo": u32_tensor(part(np.asarray(db.lo, np.uint32), np.uint32(0xFFFFFFFF)),
                             self.device),
            "target": torch.from_numpy(part(target, 0)).to(self.device),
        }
        self._tax = {
            "anc": torch.from_numpy(np.ascontiguousarray(taxonomy.anc)).to(self.device),
            "depth": torch.from_numpy(np.ascontiguousarray(taxonomy.depth)).to(self.device),
        }

    def _step(self, reads: ReadPlanes, seen, mode: str):
        """The rank's rows: the hit summary (``compact``) or the per-window
        target plane (``targets``), targets summed over db; marks ``seen``."""
        ex = extract(reads)
        idx, found = lookup_keys(self._db, ex["hi"], ex["lo"])
        found = found & ex["valid"]
        n = self.shard_len
        t = self._db["target"].index_select(0, idx.clamp(max=n - 1).reshape(-1)).view(idx.shape)
        t_local = torch.where(found, t, 0)
        tgt = self.grid.psum_db(t_local)
        mark_seen(seen, torch.where(found & (t_local > 1), idx, n))
        if mode == "compact":
            return seen, compact_hits(self._tax["anc"], self._tax["depth"], tgt, MAX_HITS)
        return seen, tgt

    def new_seen(self) -> torch.Tensor:
        """The rank's probe marks; element ``shard_len`` is the miss sink."""
        return torch.zeros(self.shard_len + 1, dtype=torch.int8, device=self.device)

    def submit_batch(self, seen, batch: Batch):
        reads = self._reads(batch)
        seen, summary = self._step(reads, seen, "compact")
        return seen, PendingBatch(summary, reads, None, batch.n_rows)

    def collect(self, seen, pending: PendingBatch):
        """The whole batch's finals, on every rank."""

        def get_targets():
            nonlocal seen
            seen, tgt = self._step(pending.codes, seen, "targets")
            return tgt.cpu().numpy()

        finals = resolve_finals(self.taxonomy, pending.packed.cpu().numpy(), get_targets)
        return seen, self._gather_finals(finals, pending.n_rows)

    def process_batch(self, seen, batch: Batch):
        seen, pending = self.submit_batch(seen, batch)
        return self.collect(seen, pending)

    def _step_targets(self, reads: ReadPlanes, seen):
        return self._step(reads, seen, "targets")

    def process_long(self, seen, item: LongRead):
        """One read longer than ``max_len``: its chunk rows in groups of
        ``batch_size``, each rank's rows through the target plane, the
        planes gathered over data, folded on the host."""
        seen, seqs = self._long_targets(seen, [item])
        return seen, fold_host(self.taxonomy, seqs[0])

    def ucount(self, seen) -> np.ndarray:
        """Per-target counts (int64 [num_targ]) of the probes marked in the
        grid's ``seen`` sets (targets 0 and 1 are not counted)."""
        n = self.shard_len
        s = self.grid.psum_data(seen[:n].to(torch.int32))
        first = self.grid.db_index * n
        real = torch.arange(first, first + n, device=self.device) < self.n_probes
        t = self._db["target"]
        m = (s > 0) & real & (t > 1)
        u = self.grid.psum_db(torch.bincount(t[m].long(), minlength=self._bins))
        return u.cpu().numpy().astype(np.int64)
