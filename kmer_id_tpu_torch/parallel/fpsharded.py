"""The sharded fingerprint engine: data-parallel reads x a fingerprint DB
sharded by L1 bucket range, on a (data x db) grid of ranks.

Port of ``kmer_id_tpu/parallel/fpsharded.py`` (``ShardedFpClassifier``).
JAX runs it as one SPMD program over a mesh; here every rank of the grid
(parallel/mesh.py) runs it on its own device and rows, and the program's
collectives are the grid's:

* **Tables.**  Db rank ``k`` holds the L1 buckets ``[k * nb / dbp, (k + 1)
  * nb / dbp)`` of ``fptab`` and their ``rec`` rows, followed by the whole
  L2 (``fptab2`` and its ``rec`` rows, replicated), so one local ``rec``
  serves both levels; ``tinfo`` and ``chain3`` are replicated.  L2 is
  probed by db rank 0 only, so every slot is owned once.
* **Per-shard Bloom filter.**  Rank ``k``'s filter holds exactly the keys it
  owns (its L1 range, and every L2 key on rank 0); every shard's filter has
  the block count of the fullest shard's, as JAX's ``_shard_blooms`` builds
  them.  Only the rank's own filter is built.
* **Per batch** (:meth:`ShardedFpClassifier.submit_batch`), on the rank's
  rows: the window gate to ``SHARD_BLOOM_K`` = 24 windows per read on the
  shard filter (``csrc/gate.cu`` on a card), the shard mode of probe +
  verify to ``sh = min(8, max_hits)`` hits per read (``csrc/probe.cu``),
  then ONE ``all_gather_db`` of the narrow hit plane (pos, target, tin,
  tout | depth << 24), a stable sort by window position, the deepest hit,
  the consistency test and the ordered fold (``fold_targets_chain``).  A
  read with more than ``sh`` candidates on any shard, or more than 24
  passing windows, is flagged (``psum_db`` of the local flags) and replayed
  exactly through the per-window target plane (:meth:`_step_targets`, whose
  targets are summed over db).  The replay's trigger is the flagged count
  summed over data (``psum_data``), replicated, so every rank takes the
  same branch and calls the same collectives.  A DB without a filter
  probes every window (extract mode, then the every-window pass of the
  shard mode, ``csrc/probe.cu`` on a card).
* ``seen`` is local to the rank (slot ids are local) with the port's sink
  element; ``ucount`` sums it over data, resolves each local slot's target
  from its ``rec`` tin, counts per target and sums over db.

Every rank decodes the same stream; :meth:`collect` returns the whole
batch's finals on every rank (``all_gather_data``), so SampleProcessor's
read-order accounting runs identically everywhere and rank 0 writes the
files.  Long reads run on the grid too (:meth:`process_long_many`): each
rank runs its rows of every chunk group and the target planes are gathered
over data.  Left out: the ``KMER_SHARD_STAGE`` ablation hooks (TPU
profiling switches, not a user path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kmer_id_tpu_torch.core.codec import INVALID, KSIZE
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.fpdb import (
    EMPTY_HI,
    SLOTS,
    FpDB,
    bloom_blocks_for,
    build_bloom,
    build_fpdb,
    build_tinfo,
)
from kmer_id_tpu_torch.db.probes import PackedDB
from kmer_id_tpu_torch.engine.classify import held_rows
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
from kmer_id_tpu_torch.engine.host import Engine, fold_host, fold_host_many
from kmer_id_tpu_torch.io.batch import Batch
from kmer_id_tpu_torch.ops.compact import SENT
from kmer_id_tpu_torch.ops.fold import fold_targets_chain
from kmer_id_tpu_torch.ops.gate import SHARD_BLOOM_K, ReadPlanes, extract, window_gate
from kmer_id_tpu_torch.ops.probe import mark_seen, probe_hits, probe_hits_dense, probe_slots
from kmer_id_tpu_torch.ops.words import u32_tensor
from kmer_id_tpu_torch.parallel.mesh import Grid, slice_batch

SHARD_HITS = 8  # per-shard verified-hit budget: sh = min(SHARD_HITS, max_hits)
_SALTS = ("fp_s1", "fp_s2", "fp_s3", "fp_s4", "fp_s5")
_EMPTY = -1  # EMPTY_HI as an int32 bit pattern


def shard_bloom(f: FpDB, dbp: int, k: int) -> np.ndarray | None:
    """uint32 [nblk, 4]: db rank ``k``'s block-Bloom filter, byte-equal to
    ``kmer_id_tpu.parallel.fpsharded._shard_blooms(f, dbp, nb / dbp)[k]``:
    the keys of its L1 bucket range (and every L2 key on rank 0), at the
    block count of the fullest shard.  None when even one shard's keys
    exceed the filter budget (``bloom_blocks_for``).  With one shard that is
    the DB's own filter, every key at ``bloom_blocks_for(n_keys)`` blocks."""
    if dbp == 1:
        return f.bloom
    nbloc = f.nb // dbp
    occupied = f.rec[: f.nb * SLOTS, 0] != EMPTY_HI
    counts = occupied.reshape(dbp, nbloc * SLOTS).sum(axis=1)
    l2 = f.rec[f.nb * SLOTS :]
    l2occ = l2[l2[:, 0] != EMPTY_HI]
    counts[0] += len(l2occ)
    nblk = bloom_blocks_for(max(int(counts.max()), 1))
    if nblk is None:
        return None
    seg = f.rec[k * nbloc * SLOTS : (k + 1) * nbloc * SLOTS]
    occ = seg[seg[:, 0] != EMPTY_HI]
    if k == 0 and len(l2occ):
        occ = np.concatenate([occ, l2occ], axis=0)
    return build_bloom(np.ascontiguousarray(occ[:, 0]), np.ascontiguousarray(occ[:, 1]),
                       f.s4, f.s5, nblk=nblk)


def shard_tables(f: FpDB, taxonomy: Taxonomy, dbp: int, k: int, device) -> dict:
    """Db rank ``k``'s tables on ``device``: its L1 block of ``fptab``, the
    whole ``fptab2``, its local ``rec`` (its L1 rows, then every L2 row),
    ``tinfo``, ``chain3``, the salts, ``nb1`` (the global L1 bucket count)
    and, when the DB takes one, its shard filter ``bloom``."""
    nbloc = f.nb // dbp
    rows = slice(k * nbloc * SLOTS, (k + 1) * nbloc * SLOTS)
    db = {
        "fptab": u32_tensor(f.fptab[k * nbloc : (k + 1) * nbloc], device),
        "fptab2": u32_tensor(f.fptab2, device),
        "rec": u32_tensor(np.concatenate([f.rec[rows], f.rec[f.nb * SLOTS :]]), device),
        "tinfo": torch.from_numpy(build_tinfo(taxonomy)).to(device),
        "chain3": torch.from_numpy(taxonomy.chain_tables()[0]).to(device),
        "nb1": int(f.nb),
    }
    for name, s in zip(_SALTS, (f.s1, f.s2, f.s3, f.s4, f.s5)):
        db[name] = int(s)
    bloom = shard_bloom(f, dbp, k)
    if bloom is not None:
        db["bloom"] = u32_tensor(bloom, device)
    return db


def shard_tables_from_jax(arrays: dict, dbp: int, k: int, device) -> dict:
    """The JAX engine's state carried across: ``arrays`` holds its
    ``_fptab``, ``_fptab2``, ``_rec`` (every shard's local block, flat),
    ``_tinfo``, ``_chain3`` and ``_bloom`` (the flat per-shard filters, or
    None) as numpy, and ``_salts`` as five ints; returns db rank ``k``'s
    tables as :func:`shard_tables` makes them."""
    nb1 = len(arrays["_fptab"])
    nbloc = nb1 // dbp
    loc = len(arrays["_rec"]) // dbp
    db = {
        "fptab": u32_tensor(arrays["_fptab"][k * nbloc : (k + 1) * nbloc], device),
        "fptab2": u32_tensor(arrays["_fptab2"], device),
        "rec": u32_tensor(arrays["_rec"][k * loc : (k + 1) * loc], device),
        "tinfo": torch.from_numpy(np.array(arrays["_tinfo"], np.int32)).to(device),
        "chain3": torch.from_numpy(np.array(arrays["_chain3"], np.int32)).to(device),
        "nb1": nb1,
    }
    for name, s in zip(_SALTS, arrays["_salts"]):
        db[name] = int(s)
    if arrays["_bloom"] is not None:
        nblk = len(arrays["_bloom"]) // dbp
        db["bloom"] = u32_tensor(arrays["_bloom"][k * nblk : (k + 1) * nblk], device)
    return db


@dataclass
class ShardPending:
    """A submitted batch on one rank: its local finals (device int32, bit 30
    = replay), its rows (for the replay), the whole batch's row count and
    the replicated count of flagged reads (device)."""

    packed: torch.Tensor
    codes: ReadPlanes
    n_rows: int
    ovr_any: torch.Tensor

    @property
    def held(self) -> list:
        """The device tensors the collect reads (engine/host.py's
        ``PendingBatch.held``): a one-rank grid's collector takes them on
        its own stream."""
        return held_rows(self.packed, self.codes) + [self.ovr_any]


class GridRows(Engine):
    """What both sharded engines do with rows: this rank's data rows of a
    batch.  Needs ``grid``, ``batch_size``, ``max_len`` and ``device``."""

    def _grid_setup(self, grid: Grid, batch_size: int) -> None:
        if batch_size % grid.dp:
            raise ValueError(f"batch_size {batch_size} not divisible by data={grid.dp}")
        self.grid, self.dp, self.dbp = grid, grid.dp, grid.dbp
        self.device = grid.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device '{self.device}' requested but torch.cuda.is_available() "
                               "is False")
        self.batch_size = batch_size
        self.local_rows = batch_size // grid.dp
        self.row0 = grid.data_index * self.local_rows

    def local_data_rows(self) -> np.ndarray:
        """The batch rows of this rank's data shard, ascending."""
        return np.arange(self.row0, self.row0 + self.local_rows)

    def make_global_batch(self, local_codes, local_lengths):
        """This rank's rows (uint8 [B / dp, L], int32 [B / dp]) on its
        device, as (codes, lengths) for a ``Batch`` that :meth:`submit_batch`
        takes."""
        codes = torch.from_numpy(np.ascontiguousarray(local_codes, np.uint8)).to(self.device)
        lengths = torch.from_numpy(np.ascontiguousarray(local_lengths, np.int32)).to(self.device)
        return codes, lengths

    def _reads(self, batch: Batch) -> ReadPlanes:
        """This rank's rows of ``batch``: the rows of :meth:`make_global_batch`
        as given, a batch of B / dp rows (a rank's slice) as given, a
        whole batch of B rows sliced to this rank's."""
        if isinstance(batch.lengths, torch.Tensor):
            return ReadPlanes(batch.lengths, batch.codes.shape[1], codes=batch.codes)
        n = len(batch.lengths)
        if n == self.batch_size and self.dp > 1:
            width = batch.codes.shape[1] if batch.codes is not None else self.max_len
            batch = slice_batch(batch, self.row0, self.row0 + self.local_rows, width)
        elif n != self.local_rows:
            raise ValueError(f"a batch of {n} rows: expected {self.batch_size}, or this rank's "
                             f"{self.local_rows}")
        return ReadPlanes.from_batch(batch, self.device, self.max_len)

    def _gather_finals(self, finals: np.ndarray, n_rows: int) -> np.ndarray:
        """The whole batch's finals from every data shard's."""
        t = torch.from_numpy(np.ascontiguousarray(finals, np.int32)).to(self.device)
        return self.grid.all_gather_data(t).reshape(-1).cpu().numpy()[:n_rows]

    def _long_targets(self, seen, items: list):
        """Every chunk row's window targets, for reads longer than
        ``max_len``: their KSIZE-1-halo chunk rows in groups of
        ``batch_size``, each group's rows of this rank through
        ``_step_targets`` (the engine's exact per-window targets, summed
        over db), the planes gathered over data.  Returns (seen, each read's
        window targets in order: a row owns its windows up to the next
        row's first)."""
        planes, lens, row_item = FpClassifier.chunk_rows(self, items)
        parts = []
        for g in range(0, len(lens), self.batch_size):
            n = min(self.batch_size, len(lens) - g)
            plane = np.full((self.batch_size, self.max_len), INVALID, np.uint8)
            lengths = np.zeros(self.batch_size, np.int32)
            plane[:n], lengths[:n] = planes[g : g + n], lens[g : g + n]
            rows = self._reads(Batch(codes=plane, lengths=lengths, metas=None, n_rows=n))
            seen, t = self._step_targets(rows, seen)
            parts.append(self.grid.all_gather_data(t).reshape(self.batch_size, -1)[:n].cpu())
        if not parts:
            return seen, [np.zeros(0, np.int32) for _ in items]
        tg = torch.cat(parts).numpy()
        owned = lens.astype(np.int64) - KSIZE + 1
        flat = tg[np.arange(tg.shape[1])[None, :] < owned[:, None]]
        counts = np.bincount(row_item, weights=owned, minlength=len(items)).astype(np.int64)
        return seen, np.split(flat, np.cumsum(counts)[:-1])


class ShardedFpClassifier(GridRows):
    """The fingerprint engine on one rank of a (data x db) grid
    (engine/host.py's :class:`Engine`, with ``collect`` / ``collect_local``
    and the grid's ``local_data_rows`` / ``make_global_batch``).  Every
    rank of the grid makes the same calls in the same order (module doc)."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        grid: Grid,
        batch_size: int = 1024,
        max_len: int = 512,
        max_hits: int = 32,
        fpdb: FpDB | None = None,
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        if max_hits < 1:
            raise ValueError(f"max_hits {max_hits} < 1")
        self._grid_setup(grid, batch_size)
        self.max_len = max_len
        self.max_hits = max_hits
        self.taxonomy = taxonomy
        self.num_targ = db.num_targ
        self.packed_db = db
        f = fpdb if fpdb is not None else build_fpdb(db, taxonomy)
        self.fpdb = f
        if f.nb % self.dbp:
            raise ValueError(f"L1 buckets {f.nb} not divisible by db={self.dbp}")
        self.nbloc = f.nb // self.dbp
        self.loc_slots = (self.nbloc + f.nb2) * SLOTS
        self.b0 = grid.db_index * self.nbloc
        self.own2 = grid.db_index == 0
        self.sh = min(SHARD_HITS, max_hits)
        self._db = shard_tables(f, taxonomy, self.dbp, grid.db_index, self.device)
        self._slot_node = None  # [loc_slots] target node per local slot (lazy)

    # ------------------------------------------------------------ steps
    def _hits(self, reads: ReadPlanes, seen) -> tuple[dict, torch.Tensor]:
        """The rank's narrow hit plane (ops/probe.py shard mode) and its
        local replay flag per read."""
        db = self._db
        args = (self.sh, self.b0, self.nbloc, self.own2, seen)
        if "bloom" in db:
            wpos, whi, wlo, npass = window_gate(db, reads, SHARD_BLOOM_K)
            hits = probe_hits(db, wpos, whi, wlo, *args)
            return hits, (hits["ncand"] > self.sh) | (npass > SHARD_BLOOM_K)
        ex = extract(reads)  # no filter: every window
        hits = probe_hits_dense(db, ex["hi"], ex["lo"], ex["valid"], *args)
        return hits, hits["ncand"] > self.sh

    def _step_finals(self, reads: ReadPlanes, seen):
        """Per-read finals of the rank's rows (bit 30: replay) and the
        replicated count of flagged reads (fpsharded.py:348-412)."""
        hits, lov = self._hits(reads, seen)
        plane = torch.stack([hits[k] for k in ("posk", "tgt", "tin", "td")], dim=-1)
        rows = plane.shape[0]
        if self.dbp > 1:
            g = self.grid.all_gather_db(plane).permute(1, 0, 2, 3).reshape(rows, -1, 4)
            gp, order = torch.sort(g[..., 0], dim=1, stable=True)
            gt, gtin, gtd = (g[..., i].gather(1, order) for i in (1, 2, 3))
        else:
            gp, gt, gtin, gtd = plane.unbind(-1)
        hit = gp < SENT
        tout = gtd & 0xFFFFFF
        depth = (gtd >> 24) & 0xFF
        nh = hit.sum(dim=1, dtype=torch.int32)
        j = torch.where(hit, depth, -1).argmax(dim=1, keepdim=True)
        dtin = gtin.gather(1, j)
        dtgt = gt.gather(1, j)[:, 0]
        consistent = (~hit | ((gtin <= dtin) & (dtin <= tout))).all(dim=1)
        overflow = self.grid.psum_db(lov.to(torch.int32)) > 0
        finals = torch.where(consistent, torch.where(nh > 0, dtgt, 0), 0)
        if bool((~consistent & (nh > 0) & ~overflow).any()):  # host branch: the fold
            t_fold = torch.where((consistent | overflow)[:, None], 0, torch.where(hit, gt, 0))
            folded = fold_targets_chain(self._db["chain3"], t_fold, gtin, tout)
            finals = torch.where(consistent, finals, folded)
        finals = torch.where(overflow, finals | (1 << 30), finals)
        ovr_any = self.grid.psum_data(overflow.sum(dtype=torch.int32).reshape(1))
        return finals, ovr_any

    def _step_targets(self, reads: ReadPlanes, seen):
        """Exact per-window target plane of the rank's rows, summed over db
        (the replay and long-read path; fpsharded.py:414-457): every window
        probed (no gate), the verified slots marked in ``seen``."""
        db = self._db
        ex = extract(reads)
        slot, stin = probe_slots(db, ex["hi"], ex["lo"], ex["valid"],
                                 (self.b0, self.nbloc, self.own2))
        mark_seen(seen, torch.where(slot >= 0, slot, seen.shape[0] - 1))
        node = db["tinfo"][:, 0].index_select(0, stin.reshape(-1)).view(slot.shape)
        return seen, self.grid.psum_db(torch.where(slot >= 0, node, 0))

    # ------------------------------------------------------------ API
    def new_seen(self) -> torch.Tensor:
        """The rank's unique-k-mer set: int8 per local slot plus the sink."""
        return torch.zeros(self.loc_slots + 1, dtype=torch.int8, device=self.device)

    def submit_batch(self, seen, batch: Batch):
        reads = self._reads(batch)
        finals, ovr_any = self._step_finals(reads, seen)
        return seen, ShardPending(finals, reads, batch.n_rows, ovr_any)

    def _local_finals(self, seen, pending: ShardPending):
        """Finals of the rank's rows, flagged reads replayed (every rank
        takes the replay together: its trigger is replicated)."""
        arr = pending.packed.cpu().numpy()
        overflow = (arr & (1 << 30)) != 0
        finals = (arr & ~np.int32(1 << 30)).astype(np.int32)
        if int(pending.ovr_any) > 0:
            seen, tgt = self._step_targets(pending.codes, seen)
            tgt = tgt.cpu().numpy()
            for r in np.nonzero(overflow)[0]:
                finals[r] = fold_host(self.taxonomy, tgt[r][tgt[r] > 0])
        return seen, finals

    def collect(self, seen, pending: ShardPending):
        """The whole batch's finals, on every rank (one ``all_gather_data``)."""
        seen, finals = self._local_finals(seen, pending)
        return seen, self._gather_finals(finals, pending.n_rows)

    def collect_local(self, seen, pending: ShardPending):
        """(seen, batch rows of this rank, their finals), rows past the
        batch's ``n_rows`` left out."""
        seen, finals = self._local_finals(seen, pending)
        rows = self.local_data_rows()
        keep = rows < pending.n_rows
        return seen, rows[keep], finals[keep]

    def process_long_many(self, seen, items: list):
        """Reads longer than ``max_len``: the chunk rows of many reads in
        shared groups of ``batch_size`` rows; each rank runs its rows of a
        group through :meth:`_step_targets`, the target planes are gathered
        over data, and every rank folds every read the same."""
        seen, seqs = self._long_targets(seen, items)
        return seen, fold_host_many(self.taxonomy, [s[s > 0] for s in seqs]).tolist()

    def ucount(self, seen) -> np.ndarray:
        """Per-target unique-k-mer counts (int64 [num_targ]) of the grid's
        ``seen`` sets: summed over data, each local slot's target from its
        ``rec`` tin, counted, summed over db (L2 is marked on db rank 0
        only, so each slot counts once)."""
        rec = self._db["rec"]
        if self._slot_node is None:
            self._slot_node = self._db["tinfo"][:, 0].index_select(0, rec[:, 2] & 0xFFFFFF)
        node = self._slot_node
        s = self.grid.psum_data(seen[: self.loc_slots].to(torch.int32))
        m = (s > 0) & (rec[:, 0] != _EMPTY) & (node > 1) & (node < self.num_targ)
        u = torch.bincount(node[m].long(), minlength=self.num_targ)
        return self.grid.psum_db(u).cpu().numpy().astype(np.int64)
