"""Fingerprint-engine classifier, in PyTorch.

Port of ``kmer_id_tpu/engine/fpclassify.py``: the short-read path and the
long-read lane.  Per batch of short reads:

    packed 2-bit bases -> window gate (ops/gate.py: keys, validity,
      block-Bloom test, passing windows rank-compacted to BLOOM_K)
      -> probe + verify (ops/probe.py: fingerprint candidates from L1 and
      two L2 rows, ranked in window order to ``max_hits``, verified
      against the full key in ``rec``, (node, tout) from ``tinfo``, the
      ``seen`` marks, the deepest hit and the consistency test)
      -> final call on device -> finals int32 [B]

A batch with a read past ``BLOOM_K`` passing windows, and every batch on a
DB without a Bloom filter, skips the gate's compaction: gate.cu's extract
mode, then the every-window pass of probe + verify over all of a read's
windows.  On a card both passes are ``csrc/probe.cu``.

Finals carry bit 30 for reads with more candidates than ``max_hits``; the
host replays those exactly (:meth:`FpClassifier._finish_collect`).

Reads longer than ``max_len`` take the long-read lane
(:meth:`FpClassifier.process_long_many`): KSIZE-1-halo chunk rows of many
reads share one plane, :func:`fp_long_finals` reduces the rows of each read
to its final on device, and reads it flags (inconsistent or
candidate-overflowed) are folded on the host from the per-row summary plane
(:func:`_summary_plane`).

The JAX engine decides its batch-level branches inside one compiled program
(``lax.cond``).  Eager PyTorch decides them on the host, one ``.item()``
each per batch:

1. ``max(npass) > BLOOM_K`` — any read passing more Bloom windows than the
   budget sends the batch to the probe-every-window (dense) path;
2. ``max(ncand) > FAST_HITS`` — the full ``max_hits`` verify tier, only in
   the plain versions on the CPU (on a DB without a Bloom filter, and in
   the plain probe + verify): the probe + verify kernel's two passes rank
   straight to ``max_hits``, and the dense path always takes the full tier;
3. ``need_fold`` — any inconsistent read (a read without hits is consistent);
4. the fold's trip count (ops/fold.py), only when 3 holds.

A card batch takes 1 (on a Bloom DB), 3 and 4.

``seen`` (the per-sample unique-k-mer set, ``newkmer_10nx.cpp:596-603``) is
an int8 tensor over slot ids with one extra sink element at index
``n_slots``: the plain version's unverified lanes write their 1 there, so
every write stores 1 and duplicate indices cannot race (the kernel writes
only verified slots).  It is updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from kmer_id_tpu_torch.core.codec import INVALID, KSIZE
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.fpdb import FpDB, build_fpdb, build_tinfo
from kmer_id_tpu_torch.db.probes import PackedDB
from kmer_id_tpu_torch.io.batch import Batch, pack_codes
from kmer_id_tpu_torch.engine.host import Engine, PendingBatch, fold_host, fold_host_many
from kmer_id_tpu_torch.ops.fold import fold_targets_chain
from kmer_id_tpu_torch.ops.gate import BLOOM_K, ReadPlanes, extract, window_gate
from kmer_id_tpu_torch.ops.probe import (
    KERNEL_MAX_HITS,
    mark_seen,
    probe_slots,
    probe_verify,
    probe_verify_dense,
)
from kmer_id_tpu_torch.ops.words import u32_tensor
from kmer_id_tpu_torch.utils import timing

LONG_HITS = 8  # long-read lane: per-chunk verified-hit budget
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
_WORD_TABLES = ("fptab", "fptab2", "rec", "bloom")
_SALTS = ("fp_s1", "fp_s2", "fp_s3", "fp_s4", "fp_s5")


def device_tables(fpdb: FpDB, taxonomy: Taxonomy, device) -> dict:
    """The engine's tables on ``device``: the same arrays the JAX engine's
    ``FpClassifier._db`` holds, with uint32 tables as int32 bit patterns and
    the salts as Python ints.  ``bloom`` is present when the DB has one."""
    db = {
        "fptab": u32_tensor(fpdb.fptab, device),
        "fptab2": u32_tensor(fpdb.fptab2, device),
        "rec": u32_tensor(fpdb.rec, device),
        "tinfo": torch.from_numpy(build_tinfo(taxonomy)).to(device),
        "chain3": torch.from_numpy(taxonomy.chain_tables()[0]).to(device),
    }
    for i, s in enumerate((fpdb.s1, fpdb.s2, fpdb.s3, fpdb.s4, fpdb.s5)):
        db[_SALTS[i]] = int(s)
    if fpdb.bloom is not None:
        db["bloom"] = u32_tensor(fpdb.bloom, device)
    return db


def tables_from_jax(db: dict, device) -> dict:
    """The JAX engine's ``_db`` (every value converted to numpy) as this
    engine's tables on ``device``: the weights carried across from the
    reference."""
    out = {}
    for k, v in db.items():
        if k in _SALTS:
            out[k] = int(v)
        elif k in _WORD_TABLES:
            out[k] = u32_tensor(v, device)
        else:
            out[k] = torch.from_numpy(np.array(v, dtype=np.int32, order="C")).to(device)
    return out


def _compact_verify(db, reads: ReadPlanes, max_hits: int, seen=None):
    """Window gate + probe + verify (see the JAX engine's
    ``_compact_verify``) of a batch's read rows; returns the per-read dict of
    ops/probe.py.  A batch with a read past ``BLOOM_K`` passing windows (the
    dense path), and a DB without a Bloom filter (the JAX engine's two
    tiers), probe every window of extract's planes instead
    (``probe_verify_dense``)."""
    bloom = "bloom" in db
    if bloom:
        wpos, whi, wlo, npass = window_gate(db, reads)
        with timing.sync():
            dense = int(npass.max()) > BLOOM_K  # host branch 1
        if not dense:
            return probe_verify(db, wpos, whi, wlo, max_hits, seen)
    ex = extract(reads)
    return probe_verify_dense(db, ex["hi"], ex["lo"], ex["valid"], max_hits, seen,
                              tiered=not bloom)


def _summary_plane(cv):
    """int32 [B, 3 + mh]: col 0 the deepest verified slot (-1 if none), col 1
    the verified hit count, col 2 flags (bit 0 consistent, bit 1 candidate
    overflow), cols 3.. the verified slots in window order (-1 holes)."""
    nh = cv["nh"]
    flags = cv["consistent"].to(torch.int32) | (cv["overflow"].to(torch.int32) << 1)
    slots = torch.where(cv["ver"], cv["cand"], -1)
    deepest = torch.where(nh > 0, cv["deepest"], -1)
    return torch.cat([deepest[:, None], nh[:, None], flags[:, None], slots], dim=1)


def fp_summary_seen(db, reads: ReadPlanes, seen, max_hits: int):
    """Candidate compaction + verify + the per-read summary plane, the
    verified slots marked in ``seen`` (in place)."""
    return _summary_plane(_compact_verify(db, reads, max_hits, seen))


def fp_long_finals(db, reads: ReadPlanes, seg, seen, n_segs: int, max_hits: int):
    """Long-read lane: per-read finals on device from chunk rows.

    ``seg`` [rows] maps each chunk row to its read (a read's rows are
    contiguous).  A read whose hits are all ancestors-or-self of its deepest
    hit gets that hit's target; reads that are inconsistent or have a
    candidate-overflowed row get bit 30 and are resolved on the host from
    the summary plane, also returned.  The segment reductions start from
    JAX's empty-segment values (sum 0, max INT32_MIN, min INT32_MAX), so a
    segment without rows is consistent with no hits.  Marks ``seen`` in
    place.  Returns (finals int32 [n_segs], summary int32 [rows, 3 + mh]).
    """
    cv = _compact_verify(db, reads, max_hits, seen)
    ver, tin, tout, depth = cv["ver"], cv["tin"], cv["tout"], cv["depth"]
    dev = ver.device
    seg = seg.to(device=dev, dtype=torch.long)
    nh_seg = torch.zeros(n_segs, dtype=torch.int32, device=dev).index_add_(0, seg, cv["nh"])
    # deepest hit per read: max of (depth << 24 | tin), wrapped to int32 as
    # JAX computes it (under consistency the deepest node is unique)
    dkey = torch.where(ver, ((depth.long() << 24) | tin).to(torch.int32), -1)
    seg_dkey = torch.full((n_segs,), _INT32_MIN, dtype=torch.int32, device=dev)
    seg_dkey.scatter_reduce_(0, seg, dkey.amax(dim=1), "amax", include_self=True)
    dtin_seg = seg_dkey.clamp(min=0) & 0xFFFFFF
    dtin_row = dtin_seg.index_select(0, seg)[:, None]
    ok = ~ver | ((tin <= dtin_row) & (dtin_row <= tout))
    row_ok = (ok.all(dim=1) & ~cv["overflow"]).to(torch.int32)
    seg_ok = torch.full((n_segs,), _INT32_MAX, dtype=torch.int32, device=dev)
    seg_ok = seg_ok.scatter_reduce_(0, seg, row_ok, "amin", include_self=True) > 0
    dtgt = db["tinfo"][:, 0].index_select(0, dtin_seg)
    finals = torch.where(nh_seg > 0, dtgt, 0)
    finals = torch.where(seg_ok, finals, finals | (1 << 30))
    return finals, _summary_plane(cv)


def fp_finals(db, reads: ReadPlanes, seen, max_hits: int):
    """Per-read final call on device: the deepest hit's target for
    consistent reads, the ordered msca fold for the rest, bit 30 for
    candidate overflow.  Marks verified slots in ``seen`` (in place).
    Returns int32 [B]."""
    cv = _compact_verify(db, reads, max_hits, seen)
    nh, consistent = cv["nh"], cv["consistent"]
    finals = torch.where(nh > 0, cv["dtgt"], 0)
    # host branch 3: the fold only when some read is inconsistent (a read
    # without hits is consistent)
    with timing.sync():
        fold = bool((~consistent).any())
    if fold:
        # consistent rows' fold results are discarded: zero their hits so
        # the fold's trip count follows the inconsistent rows only
        t_fold = torch.where(consistent[:, None], 0, cv["t"])
        folded = fold_targets_chain(db["chain3"], t_fold, cv["tin"], cv["tout"])
        finals = torch.where(consistent, finals, folded)
    return torch.where(cv["overflow"], finals | (1 << 30), finals)


def fp_slots(db, reads: ReadPlanes):
    """Per-window verified slot ids (int32 [B, P], -1 = miss): the exact
    replay for candidate-overflow reads (ops/probe.py slots mode)."""
    ex = extract(reads)
    return probe_slots(db, ex["hi"], ex["lo"], ex["valid"])[0]


def _scatter_plane_seen(seen, plane):
    """Mark every verified slot of a [R, P] slots plane (-1 = miss)."""
    mark_seen(seen, torch.where(plane >= 0, plane, seen.shape[0] - 1))


def _slot_nodes(rec, tinfo):
    """[n_slots] target node of every slot, from its rec tin label."""
    return tinfo[:, 0].index_select(0, rec[:, 2] & 0xFFFFFF)


class FpClassifier(Engine):
    """Fingerprint engine on one torch device (engine/host.py's
    :class:`Engine`, with ``collect`` and a one-fetch ``collect_many``).

    ``max_hits`` is the per-read verified-hit budget.  On a CUDA device it
    must lie in [1, ``KERNEL_MAX_HITS``] = [1, 32]: the probe + verify
    kernel ranks with one warp lane per output column."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        batch_size: int = 8192,
        max_len: int = 512,
        max_hits: int = 32,
        fpdb: FpDB | None = None,
        device="cuda",
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False"
            )
        self.taxonomy = taxonomy
        self.batch_size = batch_size
        self.max_len = max_len
        self.max_hits = max_hits
        self.num_targ = db.num_targ
        f = fpdb if fpdb is not None else build_fpdb(db, taxonomy)
        self.fpdb = f
        self.slot_target = f.slot_target
        if self.device.type == "cuda" and not 1 <= max_hits <= KERNEL_MAX_HITS:
            raise ValueError(f"max_hits {max_hits} outside [1, {KERNEL_MAX_HITS}]: the probe + "
                             "verify kernel ranks with one warp lane per output column")
        self._db = device_tables(f, taxonomy, self.device)
        self._slot_node = None  # [n_slots] target node per slot (lazy)

    def new_seen(self) -> torch.Tensor:
        """Per-sample unique-k-mer set: int8 per slot plus the sink element
        (the reference's ``kmer_seen.clear()``, ``newkmer_10nx.cpp:1019``)."""
        return torch.zeros(self.fpdb.n_slots + 1, dtype=torch.int8, device=self.device)

    def _reads(self, batch: Batch) -> ReadPlanes:
        return ReadPlanes.from_batch(batch, self.device, self.max_len)

    def submit_batch(self, seen, batch: Batch):
        finals = fp_finals(self._db, self._reads(batch), seen, self.max_hits)
        return seen, PendingBatch(finals, batch, [finals], batch.n_rows)

    def _finish_collect(self, seen, arr: np.ndarray, pending: PendingBatch):
        overflow = (arr & (1 << 30)) != 0
        finals = (arr & ~np.int32(1 << 30)).astype(np.int32)
        # candidate-overflow reads: exact per-window slot-plane replay
        ovr = np.nonzero(overflow)[0]
        if len(ovr):
            with timing.span(timing.current(), "collect.replay"):
                plane_dev = fp_slots(self._db, self._reads(pending.codes))
                _scatter_plane_seen(seen, plane_dev)
                plane = plane_dev.cpu().numpy()
                for r in ovr:
                    s = plane[r]
                    s = s[s >= 0]
                    finals[r] = fold_host(self.taxonomy, self.slot_target[s])
        return seen, finals[: pending.n_rows]

    def collect(self, seen, pending: PendingBatch):
        return self._finish_collect(seen, timing.fetch(pending.packed), pending)

    def collect_many(self, seen, pendings: list):
        """:meth:`collect` of several pending batches with one
        device-to-host copy: their finals joined by one ``torch.cat`` and
        fetched once, then :meth:`_finish_collect` per batch.  Returns
        (seen, [finals, ...]) aligned with ``pendings``, each sliced to its
        batch's rows."""
        if len(pendings) == 1:
            seen, finals = self.collect(seen, pendings[0])
            return seen, [finals]
        fetched = timing.fetch(torch.cat([p.packed for p in pendings]))
        out, off = [], 0
        for p in pendings:
            n = p.packed.shape[0]
            seen, finals = self._finish_collect(seen, fetched[off : off + n], p)
            out.append(finals)
            off += n
        return seen, out

    def chunk_rows(self, items: list):
        """KSIZE-1-halo chunk rows of every read, so no window is lost or
        repeated at a join: (planes uint8 [R, max_len], lengths int32 [R],
        read index int64 [R]).  Reads shorter than KSIZE have no rows."""
        l = self.max_len
        step = l - KSIZE + 1
        planes, lens, row_item = [], [], []
        for idx, item in enumerate(items):
            codes = np.asarray(item.codes, dtype=np.uint8)
            w = len(codes) - KSIZE + 1
            if w <= 0:
                continue
            starts = np.arange(0, w, step)
            pos = starts[:, None] + np.arange(l)[None, :]
            planes.append(np.where(pos < len(codes), codes[np.minimum(pos, len(codes) - 1)],
                                   INVALID))
            lens.append(np.minimum(len(codes) - starts, l).astype(np.int32))
            row_item.append(np.full(len(starts), idx, dtype=np.int64))
        if not planes:
            return (np.zeros((0, l), np.uint8), np.zeros(0, np.int32), np.zeros(0, np.int64))
        return np.concatenate(planes), np.concatenate(lens), np.concatenate(row_item)

    @staticmethod
    def _row_batch(plane, lengths) -> Batch:
        """Chunk rows as a batch: packed words, or the u8 plane when the rows
        hold more invalid bases than the exception list takes."""
        packed, exc = pack_codes(plane, lengths)
        return Batch(codes=plane, lengths=lengths, metas=None, n_rows=len(plane),
                     packed=packed, exc=exc)

    def process_long_many(self, seen, items: list):
        """Reads longer than ``max_len``: the chunk rows of many reads in
        shared groups of at most ``batch_size`` rows, a read's rows always in
        one group.  Each group's per-read finals come from
        :func:`fp_long_finals`; all groups' finals are fetched at once, and
        the summary planes only of groups holding a flagged read.  A flagged
        read's hits are its rows' summary slots in row order, an overflow
        row's taken from the exact per-window replay (:func:`fp_slots`),
        folded in order (``fold_host_many``).  A read with more rows than a
        group sends the whole call to :meth:`_long_many_summary`.  Marks
        ``seen`` in place; returns (seen, finals list)."""
        planes, lens, row_item = self.chunk_rows(items)
        if len(row_item) == 0:
            return seen, [0] * len(items)
        mh = min(LONG_HITS, self.max_hits)
        read_rows = np.bincount(row_item, minlength=len(items))
        if read_rows.max() > self.batch_size:
            return self._long_many_summary(seen, items, planes, lens, row_item, mh)
        groups = []  # (first row, row count)
        g0 = r0 = 0
        for nr in read_rows[read_rows > 0].tolist():
            if r0 - g0 + nr > self.batch_size:
                groups.append((g0, r0 - g0))
                g0 = r0
            r0 += nr
        groups.append((g0, r0 - g0))

        runs = []  # (first row, row count, first read, read count, batch, finals, summary)
        for g0, n in groups:
            rows = slice(g0, g0 + n)
            item0 = int(row_item[g0])
            k = int(row_item[g0 + n - 1]) - item0 + 1
            batch = self._row_batch(planes[rows], lens[rows])
            seg = torch.from_numpy(row_item[rows] - item0)
            fin, summary = fp_long_finals(self._db, self._reads(batch), seg, seen, k, mh)
            runs.append((g0, n, item0, k, batch, fin, summary))
        fetched = torch.cat([r[5] for r in runs]).cpu().numpy()
        flag = (fetched & (1 << 30)) != 0
        finals = [0] * len(items)
        off = 0
        flagged_runs = []
        for run in runs:
            item0, k = run[2], run[3]
            finals[item0 : item0 + k] = (fetched[off : off + k] & ~np.int32(1 << 30)).tolist()
            if flag[off : off + k].any():
                flagged_runs.append((run, np.nonzero(flag[off : off + k])[0]))
            off += k
        if not flagged_runs:
            return seen, finals

        sums = torch.cat([run[6] for run, _ in flagged_runs]).cpu().numpy()
        targets, ids = [], []
        off = 0
        for (g0, n, item0, k, batch, _, _), fl in flagged_runs:
            s = sums[off : off + n]
            off += n
            replay = self._replay_overflow(seen, batch, np.nonzero(s[:, 2] & 2)[0])
            targets += self._read_targets(s[:, 3:], row_item[g0 : g0 + n] - item0, fl, replay)
            ids += (item0 + fl).tolist()
        for idx, f in zip(ids, fold_host_many(self.taxonomy, targets).tolist()):
            finals[idx] = f
        return seen, finals

    def _long_many_summary(self, seen, items, planes, lens, row_item, mh):
        """Summary-plane lane for a call holding a read with more chunk rows
        than a group: per-row summaries of every group of ``batch_size``
        rows, one fetch, the overflow replay, and every read folded on the
        host."""
        bs = self.batch_size
        runs = []
        for g in range(0, len(row_item), bs):
            batch = self._row_batch(planes[g : g + bs], lens[g : g + bs])
            runs.append((batch, fp_summary_seen(self._db, self._reads(batch), seen, mh)))
        s = torch.cat([summary for _, summary in runs]).cpu().numpy()
        ovr_rows = np.nonzero(s[:, 2] & 2)[0]
        replay = {}
        for gi in np.unique(ovr_rows // bs).tolist():
            rows = ovr_rows[ovr_rows // bs == gi]
            got = self._replay_overflow(seen, runs[gi][0], rows - gi * bs)
            replay.update({r + gi * bs: v for r, v in got.items()})
        targets = self._read_targets(s[:, 3:], row_item, np.arange(len(items)), replay)
        return seen, fold_host_many(self.taxonomy, targets).tolist()

    def _replay_overflow(self, seen, batch: Batch, rows) -> dict:
        """Exact per-window verified slots of a group (marked in ``seen``),
        for its candidate-overflow ``rows``: {row: slots [P], -1 = miss}."""
        if len(rows) == 0:
            return {}
        plane = fp_slots(self._db, self._reads(batch))
        _scatter_plane_seen(seen, plane)
        plane = plane.cpu().numpy()
        return {int(r): plane[int(r)] for r in rows}

    def _read_targets(self, slots, row_read, reads, replay: dict) -> list:
        """Window-ordered hit targets of each read in ``reads``: the verified
        slots of its rows in row order (``slots`` [R, mh], -1 holes), an
        overflow row's from its ``replay`` row instead.  ``row_read`` [R] is
        the nondecreasing read index of each row."""
        keep = np.isin(row_read, reads)
        keep[list(replay)] = False
        valid = (slots >= 0) & keep[:, None]
        flat_read = np.repeat(row_read, slots.shape[1])[valid.reshape(-1)]
        counts = np.bincount(flat_read, minlength=int(np.max(reads)) + 1)
        parts = np.split(self.slot_target[slots[valid]], np.cumsum(counts)[:-1])
        ovr_reads = {int(row_read[r]) for r in replay}
        out = []
        for j in np.asarray(reads).tolist():
            if j in ovr_reads:
                rows = np.nonzero(row_read == j)[0].tolist()
                s = np.concatenate([replay.get(r, slots[r]) for r in rows])
                out.append(self.slot_target[s[s >= 0]])
            else:
                out.append(parts[j])
        return out

    def ucount(self, seen) -> np.ndarray:
        """Per-target unique-k-mer counts (int64 [num_targ]).  Nodes at or
        past ``num_targ`` are not counted, as in the JAX engine."""
        if self._slot_node is None:
            self._slot_node = _slot_nodes(self._db["rec"], self._db["tinfo"])
        node = self._slot_node
        m = (seen[: node.shape[0]] > 0) & (node > 1) & (node < self.num_targ)
        u = torch.bincount(node[m].long(), minlength=self.num_targ)
        return u.cpu().numpy().astype(np.int64)
