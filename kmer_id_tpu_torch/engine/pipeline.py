"""The classifier drivers (nx, vf6, m3) on the PyTorch engine.

Port of ``load_db``, ``make_classifier``, ``SampleProcessor``,
``write_result``, ``run_nx``, ``load_jobs``, ``run_vf6`` and ``run_m3`` from
``kmer_id_tpu/engine/pipeline.py`` (which imports jax, so nothing of it is
imported here), with its overlap of host and device: a submitter and a
collector thread, on CUDA streams of their own on a card
(:class:`SampleProcessor`).  Under ``minalign > 0`` each batch is replayed
read by read against the live ``gcount`` (engine/verify.py) on the calling
thread.  On a grid of more than one rank (the sharded engines of
``parallel/``, one process per device) every rank runs the same sample loop over
the same stream in the same order, with no worker threads (the engine
takes the rank's rows of each batch), and rank 0 alone writes the files.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Iterable, Optional, TextIO

import numpy as np
import torch
import torch.distributed as dist

from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.metadata import StrainList, load_data_txt, load_tree_edges
from kmer_id_tpu_torch.db.probes import (
    PackedDB,
    load_packed,
    pack_probes,
    parse_probes_text,
    save_packed,
)
from kmer_id_tpu_torch.io.batch import Batch, LongRead, ReadBatcher
from kmer_id_tpu_torch.utils.logging import log
from kmer_id_tpu_torch.utils.timing import StageTimers
from kmer_id_tpu_torch.engine.classify import Classifier
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
from kmer_id_tpu_torch.ops.gate import ReadPlanes


@dataclass
class LoadedDB:
    packed: PackedDB
    taxonomy: Taxonomy
    strains: StrainList
    num_targ: int
    kmers_loaded: int  # probe rows parsed, -1 if unknown (m3's "<2 kmers" gate)


def load_db(
    data_path: str,
    tree_path: str,
    probes_path: str,
    num_targ: int | None = None,
    cache_dir: str | None = None,
    require_tree: bool = False,
) -> LoadedDB:
    """Load data/tree/probes into a packed DB + taxonomy.  With
    ``cache_dir``, the packed artifact is read from there when present
    (its manifest first) and written there after a text parse.  A missing
    tree file exits with status 1 under ``require_tree``
    (``kmer_read_m3.cpp:1060``) and means a flat taxonomy otherwise."""
    strains = load_data_txt(data_path)
    nt = num_targ if num_targ is not None else strains.num_targ
    if os.path.exists(tree_path):
        edges = load_tree_edges(tree_path)
    elif require_tree:
        raise SystemExit(1)
    else:
        edges = []
    taxonomy = Taxonomy.from_edges(edges, num_nodes=nt)

    packed = None
    n_rows = -1
    mpath = os.path.join(cache_dir, "manifest.json") if cache_dir else None
    if mpath and os.path.exists(mpath):
        try:
            packed = load_packed(cache_dir)
            with open(mpath) as f:
                n_rows = json.load(f).get("source_rows", -1)
        except (OSError, ValueError, KeyError):
            packed = None  # unreadable cache: re-parse the text
    if packed is None:
        records = parse_probes_text(probes_path)
        n_rows = len(records)
        packed = pack_probes(records, num_targ=nt)
        if cache_dir:
            save_packed(packed, cache_dir)
            with open(mpath) as f:
                manifest = json.load(f)
            manifest["source_rows"] = n_rows
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
    return LoadedDB(packed, taxonomy, strains, nt, n_rows)


def make_classifier(db: LoadedDB, cfg: ClassifyConfig, cache_dir: str | None = None,
                    device="cuda"):
    """The engine on ``device``, chosen as the JAX package chooses it: the
    legacy engine (engine/classify.py) for ``engine == "legacy"`` and for
    ``minalign > 0`` (the verify replay reads its per-window detail), else
    the fingerprint engine with its tables read from (or written to)
    ``cache_dir``, and the legacy engine where that one refuses the DB."""
    if cfg.minalign > 0 or cfg.engine != "fp":
        return Classifier(db.packed, db.taxonomy, cfg.batch_size, cfg.max_len, device=device)
    fp = load_or_build_fpdb(db, cache_dir)
    try:
        return FpClassifier(db.packed, db.taxonomy, cfg.batch_size, cfg.max_len,
                            fpdb=fp, device=device)
    except ValueError:
        return Classifier(db.packed, db.taxonomy, cfg.batch_size, cfg.max_len, device=device)


def load_or_build_fpdb(db: LoadedDB, cache_dir: str | None = None):
    """The fingerprint tables of ``db``: read from ``cache_dir`` when a
    cache of this DB is there, else built (and written there)."""
    from kmer_id_tpu_torch.db.fpdb import build_fpdb, load_fpdb, save_fpdb

    fp = load_fpdb(cache_dir) if cache_dir else None
    if fp is not None and fp.slot_idx.max(initial=-1) >= len(db.packed):
        fp = None  # stale cache from a different DB
    if fp is None:
        fp = build_fpdb(db.packed, db.taxonomy)
        if cache_dir:
            save_fpdb(fp, cache_dir)
    return fp


def world_size() -> int:
    """Ranks in this process's torch.distributed group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the rank that writes the files (rank 0; always without a
    process group): every rank runs the same sample loop, since the
    engines' collectives need it, but only this one writes result and
    read files and the resume manifest."""
    return world_size() == 1 or dist.get_rank() == 0


@dataclass
class SampleResult:
    gcount: np.ndarray  # int64 [num_targ]
    ucount: np.ndarray  # int64 [num_targ]
    reads: int  # processed read count
    wall_s: float = 0.0
    stage_s: dict = field(default_factory=dict)


class SampleProcessor:
    """One sample = one counter-reset unit (``newkmer_10nx.cpp:1015-1045``).

    Two feed paths give identical results: :meth:`feed` (Python records
    through io/batch.ReadBatcher) and :meth:`feed_file` (the native decoder
    fills the planes, io/native_feed.py, when it is available).  Reads
    longer than ``max_len`` go through the engine's long-read lane and are
    accounted at their place in read order.  ``target_reads_out`` receives
    every read whose final is ``cfg.save_target`` (vf6 ``-target``).

    The JAX driver's overlap of host and device, on two worker threads:

    * the **submitter** (one worker, FIFO, at most 6 steps queued) runs
      :meth:`_consume` / :meth:`_consume_native`: the engine's
      ``submit_batch``, which marks ``seen``, while the calling thread
      decodes ahead;
    * the **collector** (one worker, at most ``pipeline_depth`` jobs in
      flight) collects, replays candidate overflows, runs the long-read
      lane and accounts, in read order, marking only ``seen_ovr``.  The
      finals of ``collect_group`` batches come back in one transfer through
      the engine's ``collect_many`` (4 when it has one, else 1); a long read
      or a native batch with long rows flushes the group first.

    On a card each worker launches on a stream of its own, and a batch's
    submit is handed to the collector with an event its stream waits on.
    :meth:`finish` waits for both, synchronises both streams and counts
    ucount from ``max(seen, seen_ovr)``; an exception on either worker is
    raised there (or by the next :meth:`feed`) once both workers are shut
    down.

    On a grid of more than one rank (a sharded engine of ``parallel/``)
    there are no workers either, and no groups: every rank submits every
    batch, of which the engine ships only the rank's rows (its packed words
    and exception list cut and re-based, ``parallel/mesh.py:slice_batch``),
    its collect returns the whole batch's finals on every rank, and every
    rank calls the collectives in the same order.  Long reads run on
    the grid too.

    Under ``cfg.minalign > 0`` (a legacy engine) there are no workers:
    everything runs on the calling thread, in read order.  The Python feed
    is forced, since the replay needs each read's untrimmed length and trim
    start, which only the Python batcher's metadata carries.  Each
    short-read batch's per-window detail is replayed read by read on the
    host, aligning hits against ``cfg.fadir``'s genomes while a target's
    live ``gcount`` is below ``minalign``, and ucount comes from the replay.
    """

    def __init__(
        self,
        clf,
        cfg: ClassifyConfig,
        reads_out: Optional[TextIO] = None,
        target_reads_out: Optional[TextIO] = None,
        use_native: bool | None = None,
    ):
        from kmer_id_tpu_torch.io.native_feed import NativePlaneFeeder, native_available

        self.clf = clf
        self.cfg = cfg
        self.reads_out = reads_out
        self.target_reads_out = target_reads_out
        self.gcount = np.zeros(clf.num_targ, dtype=np.int64)
        self.reads = 0
        self.seen = clf.new_seen()
        # the collector's own unique-k-mer set (overflow replays, long
        # reads): each worker marks one, and a set union is exact as a
        # max-merge at finish
        self.seen_ovr = clf.new_seen()
        self.batcher = ReadBatcher(clf.batch_size, clf.max_len, u_is_t=cfg.u_is_t)
        if cfg.minalign > 0:
            use_native = False
        self.native = native_available() if use_native is None else use_native
        self._feeder = (
            NativePlaneFeeder(clf.batch_size, clf.max_len, cfg.u_is_t)
            if self.native
            else None
        )
        overlap = cfg.minalign == 0 and world_size() == 1
        self.pipeline_depth = 4 if overlap else 0  # collector jobs in flight
        self.collect_group = 4 if hasattr(clf, "collect_many") and overlap else 1
        self._group: list = []  # [(pending, batch, event)] awaiting a group job
        self._inflight: deque = deque()  # the collector's futures, FIFO
        self._sub_q: deque = deque()  # the submitter's futures, FIFO
        self._submitter = self._collector = None
        if overlap:
            self._submitter = ThreadPoolExecutor(1, thread_name_prefix="kmer-submit")
            self._collector = ThreadPoolExecutor(1, thread_name_prefix="kmer-collect")
        self._sub_stream = self._col_stream = None
        device = torch.device(clf.device)
        if overlap and device.type == "cuda":
            # seen, seen_ovr and the engine's tables were made on the
            # calling thread's stream: both worker streams start after it
            made = torch.cuda.current_stream(device)
            self._sub_stream = torch.cuda.Stream(device)
            self._col_stream = torch.cuda.Stream(device)
            for stream, marks in ((self._sub_stream, self.seen), (self._col_stream, self.seen_ovr)):
                stream.wait_stream(made)
                marks.record_stream(stream)
        self.timers = StageTimers()
        self._t_start = time.monotonic()
        self._verify = None
        if cfg.minalign > 0:
            from kmer_id_tpu_torch.engine.verify import AlignVerifier, GenomeCache

            genomes = GenomeCache(cfg.fadir, cfg.accessions or [], u_is_t=cfg.u_is_t)
            self._verify = {
                "verifier": AlignVerifier(genomes, clf.packed_db, cfg.minalign),
                "ucount": np.zeros(clf.num_targ, dtype=np.int64),
                "kmer_seen": set(),
            }

    def feed(self, records: Iterable) -> None:
        for acc, seq, qual in records:
            for item in self.batcher.add(acc, seq, qual):
                self._enqueue(self._consume, item)

    def feed_file(self, path, fmt: str | None = None) -> None:
        """Stream one read file (extension-dispatched, vf6:1133-1152; pass
        ``fmt`` to force a parser, as the nx driver does for FASTQ)."""
        if self._feeder is not None:
            with self.timers.stage("decode+classify"):
                for nb in self._feeder.feed_path(str(path), fmt=fmt):
                    self._enqueue(self._consume_native, nb)
            return
        from kmer_id_tpu_torch.io import fastx
        from kmer_id_tpu_torch.io.native import detect_format

        fmt = fmt or detect_format(str(path))
        iters = {
            "fastq_gz": fastx.iter_fastq_gz,
            "fastq": fastx.iter_fastq_plain,
            "fasta_gz": fastx.iter_fasta_gz,
            "fasta": fastx.iter_fasta_plain,
        }
        if fmt in iters:
            self.feed(iters[fmt](str(path)))

    def finish(self) -> SampleResult:
        try:
            if self._feeder is not None:
                for nb in self._feeder.flush():
                    self._enqueue(self._consume_native, nb)
            for item in self.batcher.flush():
                self._enqueue(self._consume, item)
            self._drain_submits()
            if self._submitter is not None:
                self._submitter.shutdown(wait=True)
            self._barrier()
        finally:
            self._shutdown()
        if self._verify is not None:
            ucount = self._verify["ucount"]
        else:
            with self.timers.stage("finalize"):
                for stream in (self._sub_stream, self._col_stream):
                    if stream is not None:
                        stream.synchronize()
                ucount = self.clf.ucount(torch.maximum(self.seen, self.seen_ovr))
        wall = time.monotonic() - self._t_start
        classified = int(self.reads - (self.gcount[0] if len(self.gcount) else 0))
        log(
            f"sample done: {self.reads} reads in {wall:.2f}s "
            f"({self.reads / max(wall, 1e-9):,.0f} r/s, "
            f"{100.0 * classified / max(self.reads, 1):.1f}% classified) "
            f"stages={self.timers.summary()}",
            level=2,
        )
        return SampleResult(
            gcount=self.gcount, ucount=ucount, reads=self.reads,
            wall_s=wall, stage_s=self.timers.summary(),
        )

    # ------------------------------------------------------------ workers
    @staticmethod
    def _on_stream(stream, fn, *a):
        """``fn(*a)`` with ``stream`` (on its device) as the thread's
        current stream; a worker thread starts on device 0's default
        stream."""
        if stream is None:
            return fn(*a)
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            return fn(*a)

    def _enqueue(self, fn, *a) -> None:
        """Run a consume step on the submitter thread (FIFO, at most 6
        queued), or inline without workers."""
        if self._submitter is None:
            fn(*a)
            return
        self._sub_q.append(self._submitter.submit(self._on_stream, self._sub_stream, fn, *a))
        while len(self._sub_q) > 6:
            self._result(self._sub_q.popleft())

    def _result(self, fut) -> None:
        """A submitter future's result, read on the calling thread; on an
        exception both workers are shut down before it is raised."""
        try:
            fut.result()
        except BaseException:
            self._shutdown()
            raise

    def _drain_submits(self) -> None:
        while self._sub_q:
            self._result(self._sub_q.popleft())

    def _shutdown(self) -> None:
        """Stop both workers: queued steps are cancelled, running ones end
        (the submitter first: its step may wait on the collector)."""
        for ex in (self._submitter, self._collector):
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)

    def _collect(self, fn, *a) -> None:
        """Queue a collector job (inline without workers), then hold the
        jobs in flight to ``pipeline_depth``."""
        if self._collector is None:
            fn(*a)
            return
        self._inflight.append(self._collector.submit(self._on_stream, self._col_stream, fn, *a))
        while len(self._inflight) > self.pipeline_depth:
            self._inflight.popleft().result()

    def _submitted(self):
        """An event after the submitter stream's work so far (None off the
        card): the collector's stream waits on it before it reads."""
        if self._sub_stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._sub_stream)
        return ev

    def _receive(self, pending, ev) -> None:
        """On the collector: its stream waits for ``pending``'s submit, and
        the device tensors ``pending`` holds are marked as used on that
        stream, so the caching allocator does not hand their memory to the
        submitter before the collector's work on them has run."""
        if ev is None:
            return
        self._col_stream.wait_event(ev)
        held = [pending.packed]
        if isinstance(pending.codes, ReadPlanes):  # the legacy engine's rows
            rows = pending.codes
            held += [t for t in (rows.lengths, rows.packed, rows.exc, rows.codes) if t is not None]
        for t in held:
            t.record_stream(self._col_stream)

    # ------------------------------------------------------------ internals
    def _consume(self, item) -> None:
        """Python-batcher path: a short-read batch joins the group, a long
        read flushes the group and goes to the collector."""
        if self._verify is not None and isinstance(item, Batch):
            self._replay_verify(item)
        elif isinstance(item, LongRead):
            self._flush_group()  # account order = read order
            self._collect(self._long_job, item)
        else:
            self.seen, pending = self.clf.submit_batch(self.seen, item)
            self._group.append((pending, item, self._submitted()))
            if len(self._group) >= self.collect_group:
                self._flush_group()

    def _consume_native(self, nb) -> None:
        """A native batch: its short rows through the engine; with long rows
        (placeholders of length 0 in the device batch) the group is flushed
        and the batch collected alone with its long rows (:meth:`_drain_job`)."""
        batch = nb.batch
        self.seen, pending = self.clf.submit_batch(self.seen, batch)
        ev = self._submitted()
        if not nb.long_rows:
            self._group.append((pending, batch, ev))
            if len(self._group) >= self.collect_group:
                self._flush_group()
        else:
            self._flush_group()  # account order = read order
            self._collect(self._drain_job, pending, ev, nb)

    def _flush_group(self) -> None:
        if self._group:
            grp, self._group = self._group, []
            self._collect(self._group_job, grp)

    def _barrier(self) -> None:
        """Wait for every queued collector job (order/exception barrier)."""
        self._flush_group()
        while self._inflight:
            self._inflight.popleft().result()

    def _group_job(self, grp) -> None:
        for pending, _, ev in grp:
            self._receive(pending, ev)
        if len(grp) == 1 or not hasattr(self.clf, "collect_many"):
            for pending, batch, _ in grp:
                self.seen_ovr, finals = self.clf.collect(self.seen_ovr, pending)
                self._account_batch(finals[: batch.n_rows], batch.metas)
            return
        self.seen_ovr, finals_list = self.clf.collect_many(self.seen_ovr, [p for p, _, _ in grp])
        for (_, batch, _), finals in zip(grp, finals_list):
            self._account_batch(finals, batch.metas)

    def _long_job(self, item: LongRead) -> None:
        self.seen_ovr, final = self.clf.process_long(self.seen_ovr, item)
        self._account(int(final), item.meta)

    def _drain_job(self, pending, ev, nb) -> None:
        """A native batch with long rows: its short rows' finals, its long
        rows through the long-read lane together, every row accounted in
        read order."""
        self._receive(pending, ev)
        self.seen_ovr, finals = self.clf.collect(self.seen_ovr, pending)
        batch = nb.batch
        metas = batch.metas
        long_items = [LongRead(meta=None, codes=metas.seq_codes(i, self.cfg.u_is_t))
                      for i in nb.long_rows]
        if hasattr(self.clf, "process_long_many"):
            self.seen_ovr, long_finals = self.clf.process_long_many(self.seen_ovr, long_items)
        else:  # the legacy engine: one read at a time
            long_finals = []
            for item in long_items:
                self.seen_ovr, f = self.clf.process_long(self.seen_ovr, item)
                long_finals.append(f)
        final = finals[: batch.n_rows].tolist()
        for i, f in zip(nb.long_rows, long_finals):
            final[i] = f
        for i, f in enumerate(final):
            self._account(int(f), None, metas, i)

    def _replay_verify(self, batch: Batch) -> None:
        """The exact ``minalign > 0`` replay of a batch (engine/verify.py),
        read by read in read order."""
        from kmer_id_tpu_torch.engine.verify import replay_read

        v = self._verify
        self.seen, detail, keys = self.clf.detail_batch(self.seen, batch)
        for i in range(batch.n_rows):
            meta = batch.metas[i]
            full_len = meta.full_len if meta.full_len >= 0 else len(meta.trimmed_seq)
            final = replay_read(
                self.clf.taxonomy, self.clf.packed_db, detail[i], meta.trimmed_seq,
                full_len, v["verifier"], self.gcount, v["ucount"], v["kmer_seen"], keys[i],
                trim_start=meta.trim_start,
            )
            self._account(final, meta)

    def _account_batch(self, finals: np.ndarray, metas) -> None:
        """Vectorized per-batch accounting, equal to :meth:`_account` row by
        row: the first-SAVENUM capture decision for row i depends on
        gcount[final] counting earlier rows only, reconstructed from
        per-target ranks within the batch."""
        cfg = self.cfg
        finals = np.asarray(finals, dtype=np.int64)
        n = len(finals)
        valid = (finals >= 0) & (finals < len(self.gcount))
        f = finals[valid]
        want_main = self.reads_out is not None and (cfg.variant == "nx" or cfg.save_target == 0)
        want_target = self.target_reads_out is not None and cfg.save_target > 1
        gt1 = np.nonzero(valid & (finals > 1))[0]
        if (want_main or want_target) and len(gt1):
            ff = finals[gt1]
            order = np.argsort(ff, kind="stable")
            sf = ff[order]
            first = np.concatenate([[0], np.nonzero(sf[1:] != sf[:-1])[0] + 1])
            starts = np.zeros(len(sf), dtype=np.int64)
            starts[first] = np.arange(len(sf))[first]
            np.maximum.accumulate(starts, out=starts)
            rank = np.arange(len(sf)) - starts  # occurrences before, in batch
            rank_unsorted = np.empty(len(sf), dtype=np.int64)
            rank_unsorted[order] = rank
            before = self.gcount[ff] + rank_unsorted
            main = set(gt1[before < cfg.savenum].tolist()) if want_main else set()
            target = set(gt1[ff == cfg.save_target].tolist()) if want_target else set()
            for i in sorted(main | target):  # ascending rows
                meta = metas[i]
                line = f">{finals[i]}:{meta.acc}\n{meta.trimmed_seq}\n"
                if i in main:
                    self.reads_out.write(line)
                if i in target:
                    self.target_reads_out.write(line)
        np.add.at(self.gcount, f, 1)
        self.reads += n

    def _account(self, final: int, meta, metas=None, i: int = -1) -> None:
        """Saved-read capture + gcount for one read, in read order
        (``newkmer_10nx.cpp:608-613``); ``meta`` is read from ``metas[i]``
        only when the read is written."""
        cfg = self.cfg
        if 1 < final < len(self.gcount):
            save_main = (
                self.reads_out is not None
                and self.gcount[final] < cfg.savenum
                and (cfg.variant == "nx" or cfg.save_target == 0)
            )
            save_target = self.target_reads_out is not None and final == cfg.save_target
            if save_main or save_target:
                meta = meta if meta is not None else metas[i]
                line = f">{final}:{meta.acc}\n{meta.trimmed_seq}\n"
                if save_main:
                    self.reads_out.write(line)
                if save_target:
                    self.target_reads_out.write(line)
        if 0 <= final < len(self.gcount):
            self.gcount[final] += 1
        self.reads += 1


def write_result(path: str, result: SampleResult) -> None:
    """``<sample>_result.txt``: one ``t,gcount,ucount`` line per target
    (``newkmer_10nx.cpp:1040-1043``)."""
    with open(path, "w") as f:
        for i in range(len(result.gcount)):
            f.write(f"{i},{result.gcount[i]},{result.ucount[i]}\n")


def run_nx(
    fastq_dir: str,
    db: LoadedDB,
    cfg: ClassifyConfig | None = None,
    e1: str = "_R1_tr.fastq.gz",
    e2: str = "_R2_tr.fastq.gz",
    fasta_mode: bool = False,
    resume: bool = False,
    clf=None,
    metrics_path: str | None = None,
    device="cuda",
) -> list[str]:
    """Classify every paired sample in a directory (nx driver,
    ``newkmer_10nx.cpp:915-1054``).  Returns the processed sample prefixes.
    Completed samples are listed in ``.kmer_id_tpu_done.json`` there, which
    ``resume`` reads to skip them."""
    cfg = cfg or ClassifyConfig.preset("nx")
    clf = clf or make_classifier(db, cfg, device=device)
    main = is_main_process()
    prefixes = []
    for name in os.listdir(fastq_dir):
        pos = name.find(e1)
        if pos != -1:
            prefixes.append(name[:pos])
    if world_size() > 1:
        prefixes.sort()  # every rank walks the samples in the same order
    manifest_path = os.path.join(fastq_dir, ".kmer_id_tpu_done.json")
    done: set[str] = set()
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            done = set(json.load(f))
    processed = []
    for prefix in prefixes:
        if prefix in done:
            log(f"sample {prefix}: already done, skipping (resume)")
            continue
        rpath = os.path.join(fastq_dir, prefix + "_reads.txt")
        with open(rpath if main else os.devnull, "w") as reads_out:
            sp = SampleProcessor(clf, cfg, reads_out=reads_out if main else None)
            if fasta_mode:
                sp.feed_file(os.path.join(fastq_dir, prefix + e1), fmt="fasta")
            else:
                sp.feed_file(os.path.join(fastq_dir, prefix + e1), fmt="fastq_gz")
                r2 = os.path.join(fastq_dir, prefix + e2)
                if os.path.exists(r2):
                    sp.feed_file(r2, fmt="fastq_gz")
            result = sp.finish()
        if main:
            write_result(os.path.join(fastq_dir, prefix + "_result.txt"), result)
        log(f"sample {prefix}: {result.reads} reads")
        if metrics_path and main:
            from kmer_id_tpu_torch.utils.timing import write_metrics_json

            write_metrics_json(
                metrics_path,
                sample=prefix, reads=result.reads, wall_s=round(result.wall_s, 3),
                reads_per_s=round(result.reads / max(result.wall_s, 1e-9), 1),
                classified=int(result.reads - result.gcount[0]),
                stages=result.stage_s, device=str(clf.device),
            )
        done.add(prefix)
        if main:
            with open(manifest_path, "w") as f:
                json.dump(sorted(done), f)
        processed.append(prefix)
    return processed


def load_jobs(jfile: str) -> tuple[list[str], list[list[str]]]:
    """Parse a vf6 job file (``kmer_read_vf6.cpp:1021-1057``), including the
    zero-file-job quirk: a job with 0 files keeps its name in the list but the
    next job's files land in its slot."""
    jnames: list[str] = []
    fnames: list[list[str]] = []
    num_jobs = 0
    with open(jfile, "r", newline="") as f:
        lines = iter(f)
        for line in lines:
            line = line.rstrip("\r\n")
            if len(line) <= 1:
                continue
            parts = line.split()
            jname, j = parts[0], int(parts[1])
            jnames.append(jname)
            fnames.append([])
            for _ in range(j):
                fl = next(lines).rstrip("\r\n")
                fnames[num_jobs].append(fl.split()[0])
            if j > 0:
                num_jobs += 1
    return jnames[:num_jobs], fnames[:num_jobs]


def run_vf6(
    name: str,
    jname: str,
    db: LoadedDB,
    cfg: ClassifyConfig | None = None,
    root: str = ".",
    clf=None,
    device="cuda",
) -> list[str]:
    """Job-based classification (vf6 driver, ``kmer_read_vf6.cpp:966-1172``):
    per job of ``<root>/<jname>/<jname>.txt``, ``<job>_result.txt``,
    ``<job>_reads.txt`` and, with ``save_target > 0``,
    ``<job>_target_reads.txt``.  Returns the job names."""
    cfg = cfg or ClassifyConfig.preset("vf6")
    clf = clf or make_classifier(db, cfg, device=device)
    jdir = os.path.join(root, jname)
    jnames, fnames = load_jobs(os.path.join(jdir, jname + ".txt"))
    log(f"{len(jnames)} jobs")
    main = is_main_process()
    for jstr, files in zip(jnames, fnames):
        with ExitStack() as stack:
            r_out = (stack.enter_context(open(os.path.join(jdir, jstr + "_reads.txt"), "w"))
                     if main else None)
            t_out = (
                stack.enter_context(open(os.path.join(jdir, jstr + "_target_reads.txt"), "w"))
                if cfg.save_target > 0 and main
                else None
            )
            sp = SampleProcessor(clf, cfg, reads_out=r_out, target_reads_out=t_out)
            for fl in files:
                sp.feed_file(fl)
            result = sp.finish()
        if main:
            write_result(os.path.join(jdir, jstr + "_result.txt"), result)
        log(f"job {jstr}: {result.reads} reads")
    return jnames


def run_m3(
    wdir: str,
    f1: str,
    f2: str = "none",
    cfg: ClassifyConfig | None = None,
    device="cuda",
) -> SampleResult:
    """Single-sample mitochondrial classification (m3 driver,
    ``kmer_read_m3.cpp:973-1132``): the DB is read from the
    ``<wdir>mitochondria_*`` files without a cache, ``f2`` is skipped when it
    is ``none``, and ``wdir/result.txt`` is written (no read-capture files).
    Exits with status 1 without a tree file or with fewer than 2 probe rows."""
    cfg = cfg or ClassifyConfig.preset("m3")
    wdir = wdir if wdir.endswith("/") or wdir == "" else wdir + "/"
    db = load_db(
        wdir + "mitochondria_data.txt",
        wdir + "mitochondria_tree.txt",
        wdir + "mitochondria_probes.txt.gz",
        require_tree=True,
    )
    if 0 <= db.kmers_loaded < 2:
        raise SystemExit(1)  # kmer_read_m3.cpp:1067
    clf = make_classifier(db, cfg, device=device)
    sp = SampleProcessor(clf, cfg)
    sp.feed_file(f1)
    if len(f2) > 1 and f2 != "none":
        sp.feed_file(f2)
    result = sp.finish()
    write_result(os.path.join(wdir, "result.txt"), result)
    return result
