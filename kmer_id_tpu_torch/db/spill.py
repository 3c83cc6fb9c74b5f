"""Disk-spilled probe builder: the bounded-memory path for corpus-scale DBs.

The in-RAM builder (db/build.py) holds the consolidated k-mer table at
~16 B per distinct key — past ~10^9 distinct keys (a full bact10-class
build) that exceeds one host's RAM.  The reference bounds memory by design
with a fixed 2^35 x 4 B table (``kmer_build_vf6.cpp:37,142``) at the price
of silent key collisions; this module bounds memory EXACTLY, by key-prefix
sharding the sorted table to disk (SURVEY.md §7 step 5):

* **Pass 1**: per-genome native extraction exactly as in-RAM; pending runs
  k-way merge in RAM under ``batch_bytes``; each consolidated batch is
  split by the top ``shard_bits`` of the key and 2-way merged into the
  matching on-disk shard (sorted keys/counts/targets column files).  Peak
  RAM = pending batch + one shard.
* **Pass 2**: outgroup keys poison shard slices in place (target -> 0; a
  dead cell in the reference likewise reads back as non-emittable).
* **Pass 3** is reordered into three exact phases, because the reference's
  genome-major destructive scan would page the whole table per genome:
  (A) per genome, spool its first-occurrence queries per shard;
  (B) per SHARD, stream genomes in order through the native
      lookup/consume/gate kernel (km_pass3_candidates) — the destructive
      ``getHash`` consume order within one shard is exactly genome order,
      and a key lives in exactly one shard, so the surviving candidate set
      equals the in-RAM pass's; candidates spool per genome;
  (C) per genome in order, merge its candidates back to position order and
      run the shared non-overlap/cap/entropy emission walk
      (db/build._walk_emit) — byte-identical emissions.

Equality with the in-RAM builder (and through it the compiled-reference
goldens) is asserted in tests/test_spill.py, including a forced multi-shard
fixture, and the port's outputs equal the JAX package's in
tests/test_torch_build.py.

Copy of ``kmer_id_tpu/db/spill.py``.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from kmer_id_tpu_torch.core.codec import KSIZE
from kmer_id_tpu_torch.utils.logging import log

_KEY_BITS = 60


class ShardStore:
    """Sorted (keys, counts, targets) column files per key-prefix shard.

    Pass-1 batches APPEND sorted run segments per shard (sequential writes,
    no rewrite); :meth:`consolidate` then k-way merges each shard's runs
    ONCE.  Rewriting every shard at every batch would cost
    O(batches x table) disk traffic (~300 GB at a 1 Gbase corpus); the
    append-then-merge plan writes/read each byte ~twice total."""

    def __init__(self, root: str, shard_bits: int):
        self.root = root
        self.bits = shard_bits
        self.n = 1 << shard_bits
        os.makedirs(root, exist_ok=True)
        self._runs: list[list[int]] = [[] for _ in range(self.n)]
        self._fhs = None
        self.consolidated = False

    def _paths(self, s: int):
        p = os.path.join(self.root, f"s{s:04d}")
        return p + ".k", p + ".c", p + ".t"

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        return (keys >> np.uint64(_KEY_BITS - self.bits)).astype(np.int64)

    def load(self, s: int):
        assert self.consolidated
        kp, cp, tp = self._paths(s)
        if not os.path.exists(kp):
            z = np.zeros(0, dtype=np.uint64)
            return z, z.astype(np.int32), z.astype(np.int32)
        return (
            np.fromfile(kp, dtype=np.uint64),
            np.fromfile(cp, dtype=np.int32),
            np.fromfile(tp, dtype=np.int32),
        )

    def store(self, s: int, keys, counts, targets) -> None:
        kp, cp, tp = self._paths(s)
        keys.tofile(kp + ".tmp")
        counts.tofile(cp + ".tmp")
        targets.tofile(tp + ".tmp")
        for p in (kp, cp, tp):
            os.replace(p + ".tmp", p)

    def store_targets(self, s: int, targets) -> None:
        tp = self._paths(s)[2]
        targets.tofile(tp + ".tmp")
        os.replace(tp + ".tmp", tp)

    def append_batch(self, keys, counts, targets) -> None:
        """Append one consolidated sorted batch as per-shard run segments."""
        if self._fhs is None:
            self._fhs = [
                tuple(
                    open(os.path.join(self.root, f"r{s:04d}{e}"), "ab")
                    for e in (".k", ".c", ".t")
                )
                for s in range(self.n)
            ]
        sh = self.shard_of(keys)
        bounds = np.searchsorted(sh, np.arange(self.n + 1))
        for s in range(self.n):
            lo, hi = bounds[s], bounds[s + 1]
            if lo == hi:
                continue
            fk, fc, ft = self._fhs[s]
            np.ascontiguousarray(keys[lo:hi]).tofile(fk)
            np.ascontiguousarray(counts[lo:hi]).tofile(fc)
            np.ascontiguousarray(targets[lo:hi]).tofile(ft)
            self._runs[s].append(int(hi - lo))

    def consolidate(self, tax, maxrep) -> int:
        """Merge every shard's appended runs into its final sorted files;
        returns the total distinct-key count."""
        from kmer_id_tpu_torch.db import native as kn

        if self._fhs is not None:
            for hs in self._fhs:
                for h in hs:
                    h.close()
            self._fhs = None
        total = 0
        for s in range(self.n):
            lens = self._runs[s]
            if not lens:
                continue
            p = os.path.join(self.root, f"r{s:04d}")
            ks = np.fromfile(p + ".k", dtype=np.uint64)
            cs = np.fromfile(p + ".c", dtype=np.int32)
            ts = np.fromfile(p + ".t", dtype=np.int32)
            for e in (".k", ".c", ".t"):
                os.remove(p + e)
            runs = []
            off = 0
            for n in lens:
                runs.append((ks[off:off + n], cs[off:off + n], ts[off:off + n]))
                off += n
            merged = kn.merge_runs(runs, tax.parent, tax.depth, maxrep)
            if merged is None:  # NumPy fallback (no native lib)
                from kmer_id_tpu_torch.db.build import TableBuilder

                order = np.argsort(ks, kind="stable")
                merged = TableBuilder._reduce(
                    ks[order], cs[order], ts[order], tax
                )
            self.store(s, *merged)
            total += len(merged[0])
        self.consolidated = True
        return total


class QuerySpool:
    """Per-(shard, genome) append-only query segments on disk."""

    def __init__(self, root: str, n_shards: int):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.files = {}
        self.index: list[list[tuple[int, int]]] = [[] for _ in range(n_shards)]

    def _fh(self, s: int):
        if s not in self.files:
            p = os.path.join(self.root, f"q{s:04d}")
            self.files[s] = (open(p + ".k", "ab"), open(p + ".p", "ab"),
                            open(p + ".f", "ab"))
        return self.files[s]

    def append(self, s: int, org_idx: int, uk, up, uf) -> None:
        fk, fp, ff = self._fh(s)
        uk.tofile(fk)
        up.tofile(fp)
        uf.tofile(ff)
        self.index[s].append((org_idx, len(uk)))

    def close(self) -> None:
        for fk, fp, ff in self.files.values():
            fk.close(); fp.close(); ff.close()

    def segments(self, s: int):
        """Yield (org_idx, uk, up, uf) in append (= genome) order."""
        if not self.index[s]:
            return
        p = os.path.join(self.root, f"q{s:04d}")
        ks = np.fromfile(p + ".k", dtype=np.uint64)
        ps = np.fromfile(p + ".p", dtype=np.int32)
        fs = np.fromfile(p + ".f", dtype=np.uint8)
        off = 0
        for org_idx, n in self.index[s]:
            yield org_idx, ks[off:off + n], ps[off:off + n], fs[off:off + n]
            off += n


class CandidateSpool:
    """Per-genome candidate records (ck, cp, cf, ctarg, ccount) on disk."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.files = {}

    def _fh(self, g: int):
        if g not in self.files:
            p = os.path.join(self.root, f"c{g:05d}")
            self.files[g] = tuple(
                open(p + ext, "ab") for ext in (".k", ".p", ".f", ".t", ".n")
            )
        return self.files[g]

    def append(self, g: int, ck, cp, cf, ct, cc) -> None:
        fk, fp, ff, ft, fn = self._fh(g)
        ck.tofile(fk)
        cp.astype(np.int32).tofile(fp)
        cf.astype(np.uint8).tofile(ff)
        ct.astype(np.int32).tofile(ft)
        cc.astype(np.int32).tofile(fn)

    def close(self) -> None:
        for hs in self.files.values():
            for h in hs:
                h.close()

    def load(self, g: int):
        p = os.path.join(self.root, f"c{g:05d}")
        if not os.path.exists(p + ".k"):
            z = np.zeros(0, dtype=np.uint64)
            i = np.zeros(0, dtype=np.int32)
            return z, i, np.zeros(0, bool), i.copy(), i.copy()
        return (
            np.fromfile(p + ".k", dtype=np.uint64),
            np.fromfile(p + ".p", dtype=np.int32),
            np.fromfile(p + ".f", dtype=np.uint8).astype(bool),
            np.fromfile(p + ".t", dtype=np.int32),
            np.fromfile(p + ".n", dtype=np.int32),
        )


def build_probes_spill(
    name: str,
    fadir: str,
    outdir: str = "",
    root: str = ".",
    cfg=None,
    resolver=None,
    spill_dir: str | None = None,
    shard_bits: int = 6,
    batch_bytes: int = 1 << 30,
):
    """Disk-spilled 3-pass build; same CLI contract and outputs as
    db/build.build_probes, bounded RAM (see module doc)."""
    from kmer_id_tpu_torch.config import BuildConfig
    from kmer_id_tpu_torch.db import native as kn
    from kmer_id_tpu_torch.db.build import (
        MAXREP,
        BuildResult,
        GenomeResolver,
        TableBuilder,
        _load_builder_data,
        _load_filter,
        _walk_emit,
    )
    from kmer_id_tpu_torch.db.probes import ProbeRecords, write_probes_text
    from kmer_id_tpu_torch.core.taxonomy import Taxonomy

    cfg = cfg or BuildConfig()
    wdir = os.path.join(root, name)
    spill_dir = spill_dir or os.path.join(wdir, ".spill")
    resolver = resolver or GenomeResolver(fadir, outdir)
    use_native = kn.native_available() and type(resolver) is GenomeResolver

    out_accs = _load_filter(os.path.join(wdir, f"{name}_filter.txt"))
    log(f"{len(out_accs)} outs loaded")
    accession, targno = _load_builder_data(os.path.join(wdir, f"{name}_data.txt"))
    num_orgs = len(accession)
    num_targ = max(targno, default=0) + 1
    log(f"{num_orgs} sequences loaded")
    ntargorgs = np.zeros(num_targ, dtype=np.int32)
    for t in targno:
        if t > 1:
            ntargorgs[t] += 1  # direct counts: pre-tree walk quirk
    edges = []
    tname = os.path.join(wdir, f"{name}_tree.txt")
    if os.path.exists(tname):
        with open(tname, "r", newline="") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    x, y = int(parts[0]), int(parts[1])
                    if x < num_targ and y < num_targ:
                        edges.append((x, y))
    tax = Taxonomy.from_edges(edges, num_nodes=num_targ)
    log("tree loaded")

    if os.path.exists(spill_dir):
        shutil.rmtree(spill_dir)
    store = ShardStore(os.path.join(spill_dir, "table"), shard_bits)

    def _unique_counts(acc: str, pass_no: int):
        if use_native:
            path, kind = resolver.find(acc, pass_no)
            res = kn.genome_unique_counts(path, kind)
            if res is not None:
                return res
        from kmer_id_tpu_torch.core.codec import canonical_kmers, encode_bases

        genome = resolver.load(acc, pass_no)
        keys, _, _ = canonical_kmers(encode_bases(genome))
        return np.unique(keys, return_counts=True)

    # ---- pass 1: ingest; batches spill-merge into the shard store
    tb = TableBuilder(tax, consolidate_bytes=batch_bytes, native=use_native)
    orig_consolidate = tb._consolidate

    def spill_consolidate():
        orig_consolidate()  # pending runs -> tb.base (RAM-bounded batch)
        if tb.base is not None:
            k, c, t = tb.base
            tb.base = None
            store.append_batch(k, c, t)

    tb._consolidate = spill_consolidate
    ingroup = [i for i in range(num_orgs) if targno[i] > 1]
    for i in ingroup:
        uk, counts = _unique_counts(accession[i], 1)
        tb.add_run(uk, counts, targno[i])
        log(f"1 {i} {num_orgs} {accession[i]}", level=2)
    tb._consolidate()
    nkeys = store.consolidate(tax, MAXREP)
    log(f"pass1 table: {nkeys} distinct kmers (spilled, {store.n} shards)")

    # ---- pass 2: outgroup poisoning, shard-sliced
    for i, acc in enumerate(out_accs):
        uk, _ = _unique_counts(acc, 2)
        sh = store.shard_of(uk)
        bounds = np.searchsorted(sh, np.arange(store.n + 1))
        for s in range(store.n):
            lo, hi = bounds[s], bounds[s + 1]
            if lo == hi:
                continue
            k, c, t = store.load(s)
            idx = np.searchsorted(k, uk[lo:hi])
            present = (idx < len(k)) & (
                k[np.minimum(idx, max(len(k) - 1, 0))] == uk[lo:hi]
            ) if len(k) else np.zeros(hi - lo, bool)
            if present.any():
                t[idx[present]] = 0  # poisoned: never emittable (target<=1)
                store.store_targets(s, t)
        log(f"2 {i} {len(out_accs)} {acc}", level=2)
    log("pass2 done")

    # ---- pass 3A: spool per-genome first-occurrence queries by shard
    qs = QuerySpool(os.path.join(spill_dir, "queries"), store.n)
    for i in ingroup:
        if use_native:
            path, kind = resolver.find(accession[i], 3)
            res3 = kn.genome_unique_first(path, kind)
        else:
            from kmer_id_tpu_torch.core.codec import canonical_kmers, encode_bases

            genome = resolver.load(accession[i], 3)
            keys, gpos, fwd = canonical_kmers(encode_bases(genome))
            uk2, first_idx = np.unique(keys, return_index=True)
            res3 = (uk2, gpos[first_idx].astype(np.int32), fwd[first_idx])
        k1, p1, f1 = res3
        sh = store.shard_of(k1)
        bounds = np.searchsorted(sh, np.arange(store.n + 1))
        for s in range(store.n):
            lo, hi = bounds[s], bounds[s + 1]
            if lo != hi:
                qs.append(s, i, k1[lo:hi],
                          np.ascontiguousarray(p1[lo:hi], dtype=np.int32),
                          np.ascontiguousarray(
                              np.asarray(f1[lo:hi]), dtype=np.uint8))
        log(f"3A {i} {num_orgs} {accession[i]}", level=2)
    qs.close()

    # ---- pass 3B: shard-major lookup/consume/gate; candidates per genome
    cs = CandidateSpool(os.path.join(spill_dir, "cands"))
    for s in range(store.n):
        tk, tc, tt = store.load(s)
        if len(tk) == 0:
            continue
        nto = ntargorgs[np.clip(tt, 0, num_targ - 1)]
        minct = np.where(
            nto == 1, 1,
            np.where(nto < 4, 2, np.where(nto < 10, nto - 2, nto // 5 + 1)),
        )
        emittable = (tt > 1) & (tc < MAXREP) & (tc >= minct)
        emittable = np.ascontiguousarray(emittable)
        consumed = np.zeros(len(tk), dtype=bool)
        for org_idx, uk, up, uf in qs.segments(s):
            got = (
                kn.pass3_candidates(tk, consumed, emittable, uk, up, uf)
                if use_native else None
            )
            if got is None:
                idx = np.searchsorted(tk, uk)
                safe = np.minimum(idx, len(tk) - 1)
                present = (idx < len(tk)) & (tk[safe] == uk)
                fresh = present & ~consumed[safe]
                consumed[idx[present]] = True
                cand = fresh & emittable[safe]
                got = (uk[cand], up[cand], uf[cand].astype(bool), idx[cand])
            ck, cp, cf, cti = got
            if len(ck):
                cs.append(org_idx, ck, cp, cf, tt[cti], tc[cti])
        log(f"3B shard {s}", level=2)
    cs.close()

    # ---- pass 3C: per genome, position-ordered emission walk (shared)
    chunks: list[tuple[np.ndarray, ...]] = []
    pcount = np.zeros(num_targ, dtype=np.int32)
    cap = cfg.max_probes_per_target
    for i in ingroup:
        ck, cp, cf, ct, cc = cs.load(i)
        if len(ck):
            o = kn.argsort_i32(cp) if use_native else None
            if o is None:
                o = np.argsort(cp, kind="stable")
            ck, cp, cf, ct, cc = ck[o], cp[o], cf[o], ct[o], cc[o]
        pcount = _walk_emit(ck, cp, cf, ct, cc, i, pcount, cap, cfg,
                            use_native, chunks)
        log(f"3C {i} {num_orgs} {accession[i]}", level=2)

    def cat(col, dtype):
        if not chunks:
            return np.zeros(0, dtype=dtype)
        return np.concatenate([c[col] for c in chunks]).astype(dtype)

    records = ProbeRecords(
        keys=cat(0, np.uint64), target=cat(1, np.int32), org=cat(2, np.int32),
        position=cat(3, np.int32), fstrand=cat(4, bool), count=cat(5, np.int32),
    )
    write_probes_text(records, os.path.join(wdir, f"{name}_probes.txt"))
    with open(os.path.join(wdir, f"{name}_count.txt"), "w") as f:
        for i in range(num_targ):
            f.write(f"{i},{pcount[i]}\n")
    log(f"probe count {len(records)}")
    shutil.rmtree(spill_dir, ignore_errors=True)
    return BuildResult(records, pcount, num_targ, nkeys)
