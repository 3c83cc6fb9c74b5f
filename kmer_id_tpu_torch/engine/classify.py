"""The legacy engine (``--engine legacy``, and ``minalign > 0``), in PyTorch.

Port of ``kmer_id_tpu/engine/classify.py``.  Per batch of reads on one
device:

    read rows -> window planes (ops/gate.py extract mode: the kernel
      ``csrc/gate.cu`` on the card) -> cuckoo lookup (two 64-byte bucket
      rows per window) or the sorted-array bisection -> per-window targets
      -> ``seen`` marks -> per-read hit summary (ops/fold.py
      ``compact_hits``, its hit list by the kernel ``csrc/compact.cu``)
    -> host: :func:`resolve_finals`

Modes of :func:`classify_core`: ``compact`` (the summary), ``targets`` (the
per-window target plane: long reads and the overflow replay) and
``detail`` (per-window ``(probe index + 1) * strand sign`` and the key
words, for the verify replay of engine/verify.py; no ``seen`` marks).

``seen`` has one element per probe plus a sink at index ``n_probes`` that
misses write to; it is updated in place, and writing it again with the same
hits (the overflow replay) changes nothing.  ``ucount[t]`` is the number of
probes of target ``t > 1`` marked in it (``newkmer_10nx.cpp:596-603``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kmer_id_tpu_torch.core.codec import INVALID, KSIZE
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.probes import PackedDB
from kmer_id_tpu_torch.engine.host import Engine, PendingBatch, fold_host
from kmer_id_tpu_torch.io.batch import Batch, LongRead
from kmer_id_tpu_torch.ops.fold import compact_hits
from kmer_id_tpu_torch.ops.gate import ReadPlanes, extract
from kmer_id_tpu_torch.ops.lookup import cuckoo_lookup, lookup_keys
from kmer_id_tpu_torch.ops.probe import mark_seen
from kmer_id_tpu_torch.ops.words import u32_tensor
from kmer_id_tpu_torch.utils import timing


def classify_core(seen, db, tax, reads: ReadPlanes, bucket_bits: int, mode: str,
                  max_hits: int = 32, max_steps: int | None = None):
    """One batch through the legacy engine (see the module doc); returns
    (seen, result): the summary int32 [B, max_hits + 3], the target plane
    int32 [B, P], or (detail int32 [B, P], hi, lo) for ``detail``."""
    ex = extract(reads, fstrand=mode == "detail")
    if "cuckoo" in db:
        tgt0, idx, found = cuckoo_lookup(db, ex["hi"], ex["lo"])
        n = db["n_probes"]
    else:
        idx, found = lookup_keys(db, ex["hi"], ex["lo"], bucket_bits, max_steps)
        tgt0 = None
        n = db["hi"].shape[0]
    found = found & ex["valid"]
    if mode == "detail":
        sign = torch.where(ex["fstrand"], 1, -1)
        detail = torch.where(found, (idx + 1) * sign, 0).to(torch.int32)
        return seen, (detail, ex["hi"], ex["lo"])
    if tgt0 is not None:
        tgt = torch.where(found, tgt0, 0)
    else:
        safe = idx.clamp(max=max(n - 1, 0)).reshape(-1)
        tgt = torch.where(found, db["target"].index_select(0, safe).view(idx.shape), 0)
    mark_seen(seen, torch.where(found & (tgt > 1), idx, n))
    if mode == "compact":
        return seen, compact_hits(tax["anc"], tax["depth"], tgt, max_hits)
    return seen, tgt


def resolve_finals(tax, summary: np.ndarray, get_targets) -> np.ndarray:
    """Per-read finals from a hit summary (columns: deepest, nhits,
    consistent, hits...), exactly: no hits -> 0; consistent -> the deepest
    hit; inconsistent within the hit list -> its ordered msca fold, one
    vectorized step per hit column; inconsistent past the list (rare) ->
    the fold of the row of ``get_targets()``, the batch's full target plane
    (numpy)."""
    packed = np.asarray(summary)
    deepest = packed[:, 0]
    nhits = packed[:, 1]
    consistent = packed[:, 2] != 0
    hits = packed[:, 3:]
    h = hits.shape[1]
    finals = np.where(nhits == 0, 0, deepest).astype(np.int32)
    todo = np.nonzero(~consistent & (nhits > 0) & (nhits <= h))[0]
    if len(todo):
        sub = hits[todo]
        cur = np.zeros(len(todo), dtype=np.int32)
        for k in range(int(nhits[todo].max())):
            t = sub[:, k]
            merged = tax.msca(t, np.maximum(cur, 1))
            cur = np.where(t > 0, np.where(cur > 0, merged, t), cur)
        finals[todo] = cur
    overflow = np.nonzero(~consistent & (nhits > h))[0]
    if len(overflow):
        full = np.asarray(get_targets())
        for r in overflow:
            final = 0
            for t in full[r][full[r] > 0].tolist():
                final = int(tax.msca(t, final)) if final > 0 else t
            finals[r] = final
    return finals


def device_tables(db: PackedDB, use_cuckoo: bool, device) -> dict:
    """The engine's DB tables on ``device``, the arrays the JAX
    ``Classifier._db`` holds: with ``use_cuckoo`` the cuckoo table (int32
    bit patterns), ``n_probes`` and its salts (ints) and ``target``; else
    the sorted key words ``hi``/``lo``, ``target`` and, when the DB has a
    bucket index, ``bucket_off``."""
    target = torch.from_numpy(np.array(db.target, dtype=np.int32)).to(device)
    if use_cuckoo:
        ck = db.cuckoo()
        return {"cuckoo": u32_tensor(ck.table, device), "n_probes": len(db),
                "cuckoo_s1": int(ck.s1) & 0xFFFFFFFF, "cuckoo_s2": int(ck.s2) & 0xFFFFFFFF,
                "target": target}
    out = {"hi": u32_tensor(db.hi, device), "lo": u32_tensor(db.lo, device), "target": target}
    if db.bucket_bits > 0:
        out["bucket_off"] = torch.from_numpy(np.array(db.bucket_off, dtype=np.int32)).to(device)
    return out


def held_rows(summary, reads: ReadPlanes) -> list:
    """The device tensors a legacy engine's collect reads: the summary and
    the rows its overflow replay takes again."""
    return [summary] + [t for t in (reads.lengths, reads.packed, reads.exc, reads.codes)
                        if t is not None]


class Classifier(Engine):
    """The legacy engine on one torch device (engine/host.py's
    :class:`Engine`, with ``collect`` and ``detail_batch``).
    ``use_cuckoo=False`` looks keys up by bisection of the sorted array
    instead."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        batch_size: int = 1024,
        max_len: int = 512,
        use_cuckoo: bool = True,
        device="cuda",
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False"
            )
        self.n_probes = len(db)
        self.num_targ = db.num_targ
        self.bucket_bits = db.bucket_bits
        self.max_steps = (
            max(1, math.ceil(math.log2(db.max_bucket_len + 1)))
            if db.bucket_bits > 0 and db.max_bucket_len > 0
            else None
        )
        self.batch_size = batch_size
        self.max_len = max_len
        self.max_hits = 32
        self.taxonomy = taxonomy
        self.packed_db = db
        self.db_target_host = np.asarray(db.target)
        self._db = device_tables(db, use_cuckoo, self.device)
        self._tax = {
            "anc": torch.from_numpy(np.ascontiguousarray(taxonomy.anc)).to(self.device),
            "depth": torch.from_numpy(np.ascontiguousarray(taxonomy.depth)).to(self.device),
        }

    def new_seen(self) -> torch.Tensor:
        """Per-sample probe marks; element ``n_probes`` is the miss sink."""
        return torch.zeros(self.n_probes + 1, dtype=torch.int8, device=self.device)

    def _run(self, seen, reads: ReadPlanes, mode: str, max_steps: int | None = None):
        """:func:`classify_core` on this engine's tables."""
        return classify_core(seen, self._db, self._tax, reads, self.bucket_bits, mode,
                             self.max_hits, max_steps)

    def submit_batch(self, seen, batch: Batch):
        reads = ReadPlanes.from_batch(batch, self.device, self.max_len)
        seen, summary = self._run(seen, reads, "compact", self.max_steps)
        return seen, PendingBatch(summary, reads, held_rows(summary, reads), batch.n_rows)

    def collect(self, seen, pending: PendingBatch):
        """The pending batch's finals on the host; returns (seen, finals)."""

        def get_targets():
            # the overflow replay: the same rows in targets mode (marking
            # seen again with the same hits)
            return self._run(seen, pending.codes, "targets", self.max_steps)[1].cpu().numpy()

        finals = resolve_finals(self.taxonomy, timing.fetch(pending.packed), get_targets)
        return seen, finals[: pending.n_rows]

    def detail_batch(self, seen, batch: Batch):
        """Per-window hit detail for the verify replay: (seen, detail int32
        [B, P], canonical keys uint64 [B, P]), as numpy."""
        reads = ReadPlanes.from_batch(batch, self.device, self.max_len)
        seen, (detail, hi, lo) = self._run(seen, reads, "detail", self.max_steps)
        keys = ((hi.cpu().numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
                | lo.cpu().numpy().view(np.uint32))
        return seen, detail.cpu().numpy(), keys

    def _long_one(self, seen, item: LongRead):
        """One read longer than ``max_len``: chunk rows with a KSIZE-1 halo
        in groups of ``batch_size`` rows (a [batch_size, max_len] plane of
        invalid bases, lengths 0 past the group), each row's windows up to
        the next row's first, folded on the host.  Returns (seen, final)."""
        codes = np.asarray(item.codes, dtype=np.uint8)
        tl, l, bs = len(codes), self.max_len, self.batch_size
        step = l - KSIZE + 1
        w = tl - KSIZE + 1
        starts = np.arange(0, max(w, 0), step)
        parts = []
        for g in range(0, len(starts), bs):
            s = starts[g : g + bs]
            pos = s[:, None] + np.arange(l)[None, :]
            plane = np.full((bs, l), INVALID, dtype=np.uint8)
            plane[: len(s)] = np.where(pos < tl, codes[np.minimum(pos, tl - 1)], INVALID)
            lengths = np.zeros(bs, dtype=np.int32)
            lengths[: len(s)] = np.minimum(tl - s, l)
            reads = ReadPlanes(torch.from_numpy(lengths).to(self.device), l,
                               codes=torch.from_numpy(plane).to(self.device))
            seen, tgt = self._run(seen, reads, "targets")
            keep = np.arange(step)[None, :] < np.minimum(step, w - s)[:, None]
            parts.append(tgt[: len(s), :step].cpu().numpy()[keep])
        targets = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return seen, fold_host(self.taxonomy, targets)

    def ucount(self, seen) -> np.ndarray:
        """Per-target counts of the probes marked in ``seen`` (int64
        [num_targ]; targets 0 and 1 are not counted)."""
        marked = seen[: self.n_probes].cpu().numpy().astype(bool)
        t = self.db_target_host[marked]
        return np.bincount(t[t > 1], minlength=self.num_targ).astype(np.int64)
