"""Sort-based probe-database builder.

Reimplements the reference builder's three passes (``kmer_build_vf6.cpp``,
SURVEY.md §3.4) without its 128 GiB keyless direct-indexed hash table
(``kmer_build_vf6.cpp:132-216``).  That table stores **no keys**, so distinct
k-mers silently merge on collision — approximate by design.  Here the k-mer
table is an exact sorted key array built by segmented reduction:

* pass 1 (ingest): per ingroup genome, canonical 30-mers → (key, occurrences)
  runs; runs consolidate by sorting and reducing — occurrence counts add
  (saturating at MAXREP=2048, whose overflow *poisons* a key, ``:184-191``)
  and targets merge via segmented LCA (the reference's per-add ``ca`` fold is
  associative/commutative, so the segment LCA is exact);
* pass 2 (outgroup subtraction): any canonical k-mer present in a filter-list
  genome is poisoned (``HashRemove``, ``:195-204``);
* pass 3 (emission): rescan each ingroup genome in order; every queried key is
  *consumed* on first touch (the destructive ``getHash``, ``:206-213``), and
  emits only if target>1, count >= minct(ntargorgs[target]), non-overlapping
  within the genome (end position > previous emission end + KSIZE), per-target
  cap, and the entropy filter (``:602-633``).

Behavioral quirks preserved: ``ntargorgs`` counts *directly-labeled* orgs
(the walk runs before tree edges load, ``:724-732``); tree edges referencing
nodes >= num_targ are dropped (bounds-checked ``add_edge``, ``:92-97``);
blank data.txt lines re-push the previous org (failed stream extraction,
``:705-717``).  Known divergence (improvement): no hash collisions, so counts
and merges are exact where the reference's may alias at ~2^-35 probability.

Copy of ``kmer_id_tpu/db/build.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from kmer_id_tpu_torch.config import BuildConfig
from kmer_id_tpu_torch.core.codec import KSIZE, canonical_kmers, encode_bases, key_to_string
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.entropy import check_entropy_keys
from kmer_id_tpu_torch.db.probes import ProbeRecords, write_probes_text
from kmer_id_tpu_torch.io.fastx import load_genome_contigs, load_genome_gz
from kmer_id_tpu_torch.utils.logging import log

MAXREP = 2048


# ------------------------------------------------------------ segmented LCA


def segmented_lca(tax: Taxonomy, starts: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """LCA of each segment of ``targets`` (segments begin at ``starts``).

    Exact set-LCA via the ancestor-at-depth table: the common depth d* is the
    largest d (<= every member's depth) at which all members' ancestors agree;
    agreement at d implies agreement at all shallower depths, so per-level
    segmented min==max checks suffice.
    """
    depth = tax.depth[targets]
    dmin = np.minimum.reduceat(depth, starts)
    nseg = len(starts)
    d_star = np.zeros(nseg, dtype=np.int32)
    for d in range(1, tax.anc.shape[1]):
        a = tax.anc[targets, d]
        agree = np.minimum.reduceat(a, starts) == np.maximum.reduceat(a, starts)
        ok = agree & (d <= dmin)
        d_star = np.where(ok, d, d_star)
        if not ok.any():
            break
    return tax.anc[targets[starts], d_star]


# ------------------------------------------------------------ k-mer table


@dataclass
class KmerTable:
    """Exact (key -> merged target, saturating count) table."""

    keys: np.ndarray  # uint64 sorted unique
    target: np.ndarray  # int32 (post-LCA merge; <=1 or poisoned = dead)
    count: np.ndarray  # int32, clipped at MAXREP (>= MAXREP -> poisoned)

    def __len__(self):
        return len(self.keys)


class TableBuilder:
    """Accumulates per-genome runs and consolidates by sort+reduce.

    The consolidated table is kept as a SORTED base that new 2 GB batches
    merge into: only the fresh batch pays a full comparison sort; the
    base+batch combine is a stable sort over two already-sorted runs
    (timsort detects them — O(n) merge), then one reduceat/LCA pass.  An
    earlier formulation counted the consolidated table itself against the
    pending budget, so past ~2 GB of distinct keys EVERY genome re-sorted
    the whole table — quadratic at multi-Mb-genome corpus scale (the
    200 x 5 Mb builder proof exposed it)."""

    def __init__(self, tax: Taxonomy, consolidate_bytes: int = 2 << 30,
                 native: bool | None = None):
        self.tax = tax
        self.base: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self.runs: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.pending = 0
        self.limit = consolidate_bytes
        if native is None:
            from kmer_id_tpu_torch.db import native as kn

            native = kn.native_available()
        self.native = native

    def add_genome(self, keys: np.ndarray, target: int) -> None:
        uk, counts = np.unique(keys, return_counts=True)
        self.add_run(uk, counts, target)

    def add_run(self, uk: np.ndarray, counts: np.ndarray, target: int) -> None:
        """Add one genome's pre-deduped (sorted unique keys, counts) run —
        the native extractor's output shape (db/native.genome_unique_counts)."""
        counts = np.minimum(counts, MAXREP).astype(np.int32)
        self.runs.append((uk, counts, np.full(len(uk), target, dtype=np.int32)))
        self.pending += uk.nbytes * 2
        if self.pending > self.limit:
            self._consolidate()

    @staticmethod
    def _reduce(keys, counts, targets, tax):
        starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
        uk = keys[starts]
        ucount = np.minimum(np.add.reduceat(counts, starts), MAXREP).astype(np.int32)
        utarg = segmented_lca(tax, starts, targets)
        return uk, ucount, utarg

    def _consolidate(self) -> None:
        if not self.runs:
            return
        if self.native:
            from kmer_id_tpu_torch.db import native as kn

            # two-stage like the NumPy path: k-way merge the fresh runs,
            # then one 2-way merge into the (much larger) base
            merged = kn.merge_runs(
                self.runs, self.tax.parent, self.tax.depth, MAXREP
            )
            if merged is not None and self.base is not None:
                merged = kn.merge_runs(
                    [self.base, merged], self.tax.parent, self.tax.depth,
                    MAXREP,
                )
            if merged is not None:
                self.base = merged
                self.runs = []
                self.pending = 0
                return
        keys = np.concatenate([r[0] for r in self.runs])
        counts = np.concatenate([r[1] for r in self.runs])
        targets = np.concatenate([r[2] for r in self.runs])
        self.runs = []
        self.pending = 0
        order = np.argsort(keys, kind="stable")
        batch = self._reduce(keys[order], counts[order], targets[order], self.tax)
        del keys, counts, targets, order
        if self.base is None:
            self.base = batch
            return
        # merge two sorted runs (saturating-count sum and LCA target merge
        # are both associative, so batchwise combining is exact)
        keys = np.concatenate([self.base[0], batch[0]])
        counts = np.concatenate([self.base[1], batch[1]])
        targets = np.concatenate([self.base[2], batch[2]])
        self.base = None
        del batch
        order = np.argsort(keys, kind="stable")  # timsort: O(n) on 2 runs
        self.base = self._reduce(
            keys[order], counts[order], targets[order], self.tax
        )

    def finish(self) -> KmerTable:
        self._consolidate()
        if self.base is None:
            z = np.zeros(0, dtype=np.uint64)
            return KmerTable(z, z.astype(np.int32), z.astype(np.int32))
        uk, ucount, utarg = self.base
        self.base = None
        return KmerTable(uk, utarg, ucount)


# ------------------------------------------------------------ genome access


class GenomeResolver:
    """Reference path-fallback conventions, per pass
    (``kmer_build_vf6.cpp:750-773, 781-792, 806-828``)."""

    def __init__(self, fdir: str, outdir: str):
        self.fdir = fdir
        self.outdir = outdir

    def _cands(self, acc: str, pass_no: int):
        f, o = self.fdir, self.outdir
        if pass_no == 1:
            return [
                (os.path.join(f, acc + ".fasta.gz"), "gz"),
                (os.path.join(o, acc + ".fasta.gz"), "gz"),
                (os.path.join(f, acc + "_contigs.fasta"), "contigs"),
            ]
        if pass_no == 2:
            return [
                (os.path.join(o, acc + ".fasta.gz"), "gz"),
                (os.path.join(f, acc + ".fasta.gz"), "gz"),
            ]
        return [
            (os.path.join(f, acc + ".fasta.gz"), "gz"),
            (os.path.join(o, acc + ".fna.gz"), "gz"),
            (os.path.join(f, acc + "_contigs.fasta"), "contigs"),
        ]

    def find(self, acc: str, pass_no: int) -> tuple[str, str]:
        """(path, kind) of the first existing candidate for this pass."""
        for path, kind in self._cands(acc, pass_no):
            if os.path.exists(path):
                return path, kind
        log(f"no file for {acc}")
        raise SystemExit(1)  # kmer_build_vf6.cpp:772

    def load(self, acc: str, pass_no: int) -> str:
        path, kind = self.find(acc, pass_no)
        if kind == "gz":
            return load_genome_gz(path)
        return load_genome_contigs(path)



def _walk_emit(ck, cp, cf, ctarg, ccount, org_idx, pcount, cap, cfg,
               use_native, chunks):
    """Greedy non-overlap emission over ONE genome's gate-passing candidates
    (position-ordered), shared by the in-RAM and disk-spill builders.

    Non-overlap minpos advances only on emission (kmer_build_vf6.cpp:620-627):
    each candidate's jump target (first candidate with position > cp + KSIZE)
    is precomputed so the chain walk costs O(#emissions) hops; equal-target
    runs skip in one hop once their target hits the per-target cap; the
    entropy filter is evaluated LAZILY on walk-visited candidates only (a
    failure alters the chain downstream, so re-walk until the visited set is
    fully vetted — converges in 1 + #failures rounds).  MUTATES nothing;
    returns the updated pcount and appends this genome's emission chunk.
    """
    from kmer_id_tpu_torch.db import native as kn

    nxt = np.searchsorted(cp, cp + KSIZE, side="right")
    n = len(ck)
    run_last = np.flatnonzero(
        np.concatenate([ctarg[1:] != ctarg[:-1], [True]])
    ) if n else np.zeros(0, np.int64)
    run_next = (
        np.repeat(run_last + 1, np.diff(np.concatenate([[0], run_last + 1])))
        if n else np.zeros(0, np.int64)
    )
    ent_known = np.full(n, -1, dtype=np.int8)  # -1 unknown, 0 fail, 1 ok
    ctarg32 = np.ascontiguousarray(ctarg, dtype=np.int32)
    nxt64 = np.ascontiguousarray(nxt, dtype=np.int64)
    run_next64 = np.ascontiguousarray(run_next, dtype=np.int64)
    while True:
        pcount_trial = pcount.copy()
        e = (
            kn.emit_walk(ctarg32, nxt64, run_next64, ent_known,
                         pcount_trial, cap)
            if use_native else None
        )
        if e is None:
            emit_js: list[int] = []
            j = 0
            while j < n:
                t = ctarg[j]
                if pcount_trial[t] >= cap:
                    j = int(run_next[j])  # whole same-target run is capped
                    continue
                if ent_known[j] != 0:
                    emit_js.append(j)
                    pcount_trial[t] += 1
                    j = int(nxt[j])
                    continue
                # skipped candidates don't advance minpos
                j += 1
            e = np.asarray(emit_js, dtype=np.int64)
        u = e[ent_known[e] < 0] if len(e) else e
        if len(u) == 0:
            pcount = pcount_trial
            break
        # lookahead: an entropy failure at candidate j makes the next walk
        # visit j+1, j+2, ... — pre-vet a few successors of every unknown so
        # cascaded failures converge in ~2 rounds instead of ~25
        u = np.unique(np.clip(u[:, None] + np.arange(5)[None, :], 0, n - 1))
        u = u[ent_known[u] < 0]
        ok = None
        if use_native:
            ok = kn.check_entropy_keys(
                ck[u], cfg.min_entropy, cfg.max_homopolymer
            )
        if ok is None:
            ok = check_entropy_keys(ck[u], cfg.min_entropy, cfg.max_homopolymer)
        ent_known[u] = ok.astype(np.int8)
        if ok.all():
            pcount = pcount_trial
            break
    if len(e):
        chunks.append(
            (
                ck[e],
                ctarg[e].astype(np.int32),
                np.full(len(e), org_idx, dtype=np.int32),
                cp[e].astype(np.int32),
                cf[e].astype(bool),
                ccount[e].astype(np.int32),
            )
        )
    return pcount


# ------------------------------------------------------------ main builder


@dataclass
class BuildResult:
    records: ProbeRecords
    pcount: np.ndarray  # int32 [num_targ]
    num_targ: int
    table_size: int


def _load_builder_data(path) -> tuple[list[str], list[int]]:
    """Builder data.txt loader with the failed-extraction re-push quirk."""
    accession: list[str] = []
    targno: list[int] = []
    last_t, last_a = 0, ""
    with open(path, "r", newline="") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                try:
                    last_t = int(parts[0])
                    last_a = parts[1]
                except ValueError:
                    pass
            accession.append(last_a)
            targno.append(last_t)
    return accession, targno


def _load_filter(path) -> list[str]:
    accs: list[str] = []
    if not os.path.exists(path):
        return accs
    with open(path, "r", newline="") as f:
        for line in f:
            parts = line.split()
            if parts:
                accs.append(parts[0])
    return accs


def build_probes(
    name: str,
    fadir: str,
    outdir: str = "",
    root: str = ".",
    cfg: BuildConfig | None = None,
    resolver: GenomeResolver | None = None,
    native: bool | None = None,
) -> BuildResult:
    """Run the 3-pass build for DB ``name`` (layout ``root/name/name_*``).

    Writes ``<name>_probes.txt`` and ``<name>_count.txt`` next to the inputs,
    mirroring the reference CLI contract (``-name``/``-fadir``).
    """
    cfg = cfg or BuildConfig()
    wdir = os.path.join(root, name)
    iname = os.path.join(wdir, f"{name}_data.txt")
    tname = os.path.join(wdir, f"{name}_tree.txt")
    fname = os.path.join(wdir, f"{name}_filter.txt")
    oname = os.path.join(wdir, f"{name}_probes.txt")
    cname = os.path.join(wdir, f"{name}_count.txt")
    resolver = resolver or GenomeResolver(fadir, outdir)

    out_accs = _load_filter(fname)
    log(f"{len(out_accs)} outs loaded")
    accession, targno = _load_builder_data(iname)
    num_orgs = len(accession)
    num_targ = max(targno, default=0) + 1
    log(f"{num_orgs} sequences loaded")

    ntargorgs = np.zeros(num_targ, dtype=np.int32)
    for t in targno:
        if t > 1:
            ntargorgs[t] += 1  # direct counts: pre-tree walk quirk

    edges = []
    if os.path.exists(tname):
        with open(tname, "r", newline="") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    x, y = int(parts[0]), int(parts[1])
                    if x < num_targ and y < num_targ:  # bounds-checked add_edge
                        edges.append((x, y))
    tax = Taxonomy.from_edges(edges, num_nodes=num_targ)
    log("tree loaded")

    # native builder kernels (db/native): decode + extract + sort/unique in
    # C++ when available and the resolver is the stock path-based one; the
    # NumPy formulations below remain the behavioral reference (equality
    # asserted in tests/test_builder_native.py)
    from kmer_id_tpu_torch.db import native as kn

    use_native = (
        (kn.native_available() if native is None else native)
        and type(resolver) is GenomeResolver
    )

    def _unique_counts(acc: str, pass_no: int):
        if use_native:
            path, kind = resolver.find(acc, pass_no)
            res = kn.genome_unique_counts(path, kind)
            if res is not None:
                return res
        genome = resolver.load(acc, pass_no)
        keys, _, _ = canonical_kmers(encode_bases(genome))
        uk, counts = np.unique(keys, return_counts=True)
        return uk, counts

    # one-worker prefetch: the native extraction releases the GIL (ctypes),
    # so the NEXT genome's decode+extract+sort overlaps the current genome's
    # consolidation / emission work on the second core
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=1) if use_native else None

    def _iter_prefetched(items, fetch):
        """Yield (item, fetch(item)) with one-item lookahead via ``ex``."""
        fut = None
        for idx, it in enumerate(items):
            cur = fetch(it) if fut is None else fut.result()
            fut = (
                ex.submit(fetch, items[idx + 1])
                if ex is not None and idx + 1 < len(items)
                else None
            )
            yield it, cur

    # ---- pass 1: ingest ingroups
    tb = TableBuilder(tax, native=use_native)
    ingroup = [i for i in range(num_orgs) if targno[i] > 1]
    for i, (uk, counts) in _iter_prefetched(
        ingroup, lambda i: _unique_counts(accession[i], 1)
    ):
        tb.add_run(uk, counts, targno[i])
        log(f"1 {i} {num_orgs} {accession[i]}", level=2)
    table = tb.finish()
    log(f"pass1 table: {len(table)} distinct kmers")

    # ---- pass 2: outgroup subtraction
    dead = (table.target <= 1) | (table.count >= MAXREP)
    for i, acc in enumerate(out_accs):
        uk, _ = _unique_counts(acc, 2)
        idx = np.searchsorted(table.keys, uk)
        present = (idx < len(table)) & (table.keys[np.minimum(idx, len(table) - 1)] == uk)
        dead[idx[present]] = True
        log(f"2 {i} {len(out_accs)} {acc}", level=2)
    log(f"pass2 done: {int(dead.sum())} dead cells")

    # ---- pass 3: gated emission
    consumed = np.zeros(len(table), dtype=bool)
    pcount = np.zeros(num_targ, dtype=np.int32)
    # minct per table entry from the merged target (kmer_build_vf6.cpp:611-618)
    nto = ntargorgs[np.clip(table.target, 0, num_targ - 1)]
    minct = np.where(
        nto == 1, 1, np.where(nto < 4, 2, np.where(nto < 10, nto - 2, nto // 5 + 1))
    )
    emittable = (~dead) & (table.target > 1) & (table.count >= minct)

    chunks: list[tuple[np.ndarray, ...]] = []
    cap = cfg.max_probes_per_target

    def _fetch3(i):
        if use_native:
            path, kind = resolver.find(accession[i], 3)
            return kn.genome_unique_first(path, kind)
        return None

    for i, res3 in _iter_prefetched(ingroup, _fetch3):
        got = None
        if res3 is not None:
            # native: KEY-sorted unique first-occurrence queries; ONE call
            # does galloping lookup + destructive consume + fresh/emittable
            # gates + genome-position reorder (mutates ``consumed``)
            k1, p1, f1 = res3
            if len(k1) == 0:
                continue
            got = kn.pass3_candidates(
                table.keys, consumed, emittable, k1, p1, f1
            )
        if got is not None:
            ck, cp, cf, cti = got
        else:
            if res3 is None:
                genome = resolver.load(accession[i], 3)
                keys, gpos, fwd = canonical_kmers(encode_bases(genome))
                if len(keys) == 0:
                    continue
                # first occurrence of each distinct key in this genome's order
                _, first_idx = np.unique(keys, return_index=True)
                first_idx.sort()
                k1, p1, f1 = keys[first_idx], gpos[first_idx], fwd[first_idx]
            # searchsorted with SORTED needles walks the table cache-coherently
            # (~12x faster than genome-order queries at 160M keys); sort the
            # queries, look up, and scatter the results back to genome order
            korder = np.argsort(k1, kind="stable")
            tidx = np.empty(len(k1), dtype=np.int64)
            tidx[korder] = np.searchsorted(table.keys, k1[korder])
            present = (tidx < len(table)) & (
                table.keys[np.minimum(tidx, len(table) - 1)] == k1
            )
            fresh = present & ~consumed[np.minimum(tidx, len(table) - 1)]
            # destructive getHash: every queried present key is consumed
            consumed[tidx[present]] = True
            cand = fresh & emittable[np.minimum(tidx, len(table) - 1)]
            ck, cp, cf, cti = k1[cand], p1[cand], f1[cand], tidx[cand]
            if not np.all(cp[1:] >= cp[:-1]):
                # key-sorted queries: restore genome-position order (the
                # walk's domain; first-occurrence positions are distinct)
                o = np.argsort(cp, kind="stable")
                ck, cp, cf, cti = ck[o], cp[o], cf[o], cti[o]
        ctarg = table.target[cti]
        pcount = _walk_emit(
            ck, cp, cf, ctarg, table.count[cti], i, pcount, cap, cfg,
            use_native, chunks,
        )
        log(f"3 {i} {num_orgs} {accession[i]}", level=2)

    if ex is not None:
        ex.shutdown(wait=True)

    def cat(col, dtype):
        if not chunks:
            return np.zeros(0, dtype=dtype)
        return np.concatenate([c[col] for c in chunks]).astype(dtype)

    records = ProbeRecords(
        keys=cat(0, np.uint64),
        target=cat(1, np.int32),
        org=cat(2, np.int32),
        position=cat(3, np.int32),
        fstrand=cat(4, bool),
        count=cat(5, np.int32),
    )
    write_probes_text(records, oname)
    with open(cname, "w") as f:
        for i in range(num_targ):
            f.write(f"{i},{pcount[i]}\n")
    log(f"probe count {len(records)}")
    return BuildResult(records, pcount, num_targ, len(table))
