"""One run of one cell: set-up, the measured window, the traced parts, the
check.

Set-up (``setup_s``, from the process's start): the probe DB from the seed
(gen/db.py), the port's ``pack_probes``, ``make_classifier`` (its
``build_fpdb`` and device tables; no cache is written), the pool of input
files written under the run's temporary directory meanwhile, and one
warm-up request at the cell's own shapes (the first run in a checkout also
builds the kernels there, under ``build/``).

The window is a closed loop of whole requests: the next starts when the
last has ended, and the window closes when the first request that ends
after ``seconds`` does.  A request is what one pass of the drivers' sample
loop does (``engine/pipeline.py``: ``run_nx``, ``run_vf6``, ``run_m3``):
``SampleProcessor``, ``feed_file`` of each file, ``finish``,
``write_result``.

A traced run (``--trace 1``) times the window's host spans (trace.py), then
profiles whole requests after it, then drains the native feeder alone over
one request; none of it is in the untraced runs' numbers."""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.gen.db import make_db
from benchmark.gen.samples import make_pool, write_pool

PROFILE_SECONDS = 3.0  # least host wall of the profiled requests of a traced run


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Served:
    pool: int  # the input's index in the pool
    out: str  # prefix of its output files
    seconds: float
    reads: int
    bases: int


@dataclass
class Trace:
    batches: int = 0  # short-read batches submitted in the window
    host_s: dict = field(default_factory=dict)  # span name: host seconds in the window
    decode_s: float = 0.0  # the native feeder drained alone over one request
    decode_batches: int = 0
    profile: object = None  # trace.Profile of the requests after the window


@dataclass
class Record:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    served: list  # the window's requests
    trace: Trace | None = None


class Program:
    """The port, set up for one cell: its classifier and its driver's
    request."""

    def __init__(self, cell, db, device: str):
        from kmer_id_tpu_torch.config import ClassifyConfig
        from kmer_id_tpu_torch.core.taxonomy import Taxonomy
        from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
        from kmer_id_tpu_torch.engine.pipeline import LoadedDB, make_classifier

        n = len(db.keys)
        t = time.perf_counter()
        rec = ProbeRecords(keys=db.keys, target=db.targets, org=np.zeros(n, np.int32),
                           position=np.zeros(n, np.int32), fstrand=np.ones(n, bool),
                           count=np.ones(n, np.int32))
        packed = pack_probes(rec, num_targ=db.num_targ)
        self.pack_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = LoadedDB(packed, Taxonomy(db.parent), None, db.num_targ, n)
        self.driver = cell.driver
        self.cfg = ClassifyConfig.preset(cell.driver, num_targ=db.num_targ, **cell.preset)
        self.clf = make_classifier(loaded, self.cfg, device=device)
        self.classifier_s = time.perf_counter() - t
        self.saves = cell.driver in ("nx", "vf6")  # m3 writes no read file
        self.span = lambda name: contextlib.nullcontext()  # a traced run's profiler spans

    def request(self, req, out: str) -> None:
        """One loop pass of the driver over ``req``'s files, writing
        ``<out>_result.txt`` (and ``<out>_reads.txt``)."""
        from kmer_id_tpu_torch.engine.pipeline import SampleProcessor, write_result

        reads_out = open(out + "_reads.txt", "w") if self.saves else None
        try:
            with self.span("sample_start"):
                sp = SampleProcessor(self.clf, self.cfg, reads_out=reads_out)
            for f in req.files:
                sp.feed_file(f.path, fmt="fastq_gz" if self.driver == "nx" else None)
            with self.span("finish"):
                result = sp.finish()
        finally:
            if reads_out is not None:
                reads_out.close()
        with self.span("write_result"):
            write_result(out + "_result.txt", result)

    def decode_alone(self, req) -> tuple[float, int]:
        """(seconds, batches) of the native feeder drained over ``req``."""
        from kmer_id_tpu_torch.io.native_feed import NativePlaneFeeder

        feeder = NativePlaneFeeder(self.cfg.batch_size, self.cfg.max_len, self.cfg.u_is_t)
        t = time.perf_counter()
        n = 0
        for f in req.files:
            n += sum(1 for _ in feeder.feed_path(f.path, fmt="fastq_gz" if self.driver == "nx"
                                                 else None))
        n += sum(1 for _ in feeder.flush())
        return time.perf_counter() - t, n


def sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def work_dir(cell: str) -> str:
    """The run's files: a fixed directory under the temporary directory
    (``TMPDIR``), emptied before and after the run."""
    return os.path.join(tempfile.gettempdir(), "kmerid-bench", cell)


def run(cell, seed: int, seconds: float, traced: bool, device: str, t_start: float):
    """Runs the cell once; returns (Record, the program's peak device bytes,
    the reference's check: (numbers, failed, attempted))."""
    import torch

    from benchmark import check, trace

    work = work_dir(cell.name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        parts = {}
        t = time.perf_counter()
        db = make_db(seed, int(cell.config["probes"]), int(cell.config["num_targ"]), device)
        if device != "cpu":  # the peak is the program's, not the generator's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        parts["db_generate_s"] = time.perf_counter() - t
        pool, written = [], {}

        def write():
            t0 = time.perf_counter()
            try:
                pool.extend(make_pool(seed, cell.traffic, db))
                write_pool(pool, os.path.join(work, "in"), cell.driver)
            except BaseException as e:  # handed to the main thread
                written["error"] = e
            written["s"] = time.perf_counter() - t0

        writer = threading.Thread(target=write, name="kbench-pool")
        writer.start()
        try:
            prog = Program(cell, db, device)
        finally:
            writer.join()
        if "error" in written:
            raise written["error"]
        parts.update(pack_s=prog.pack_s, classifier_s=prog.classifier_s, pool_s=written["s"])
        out = os.path.join(work, "out")
        os.makedirs(out)
        t = time.perf_counter()
        prog.request(pool[0], os.path.join(out, "warmup"))
        sync(device)
        parts["warmup_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start
        say(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

        spans = trace.HostSpans() if traced else None
        served = []

        def serve(k: int, into: list):
            req = pool[k % len(pool)]
            prefix = os.path.join(out, f"r{k}")
            t0 = time.perf_counter()
            with prog.span("request"):
                prog.request(req, prefix)
            into.append(Served(req.index, prefix, time.perf_counter() - t0, req.reads,
                               req.bases))

        if traced:
            with spans.installed():
                window_s = _window(serve, served, seconds)
        else:
            window_s = _window(serve, served, seconds)
        rec = Record(setup_s, window_s, served)
        walls = sorted(s.seconds for s in served)
        third = max(1, len(served) // 3)
        say(f"window {window_s:.3f} s, {len(served)} requests: wall min {walls[0]:.4f} median "
            f"{walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s; first third "
            f"{sum(s.seconds for s in served[:third]) / third:.4f}, last third "
            f"{sum(s.seconds for s in served[-third:]) / third:.4f} s a request")
        say("request walls, ms, in order: " + " ".join(f"{1e3 * s.seconds:.0f}" for s in served))
        profiled = []
        if traced:
            rec.trace = _traced(prog, pool, serve, served, spans, profiled, device)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        n_req = len(served) + len(profiled)
        cfg, saves = prog.cfg, prog.saves
        del prog
        if device != "cpu":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        everything = served + profiled
        refs = check.reference_outputs(pool, {s.pool for s in everything}, db, cfg.u_is_t,
                                       cfg.savenum, saves, device=device)
        numbers, failed = check.compare(everything, refs, saves)
        say(f"reference and check of {n_req} requests over {len(refs)} inputs: "
            f"{time.perf_counter() - t:.3f} s")
        return rec, peak, (numbers, failed, n_req)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _window(serve, served: list, seconds: float) -> float:
    t0 = time.perf_counter()
    k = 0
    while True:
        serve(k, served)
        k += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return elapsed


def _traced(prog, pool, serve, served, spans, profiled, device) -> "Trace":
    """The traced run's parts after the window (see the module doc)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    secs, calls = spans.snapshot()
    tr = Trace(batches=calls.get("submit", 0), host_s=secs)
    prog.span = lambda name: torch.profiler.record_function(trace.SPAN + name)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    kernels = trace.KernelCalls()
    k = len(served)
    sync(device)
    try:  # the workers' spans too, not only the calling thread's
        from torch._C._profiler import _ExperimentalConfig

        extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    with spans.installed(), kernels.installed(), profile(activities=acts, **extra) as prof:
        b0 = spans.snapshot()[1].get("submit", 0)
        t0 = time.perf_counter()
        while True:
            serve(k, profiled)
            k += 1
            if time.perf_counter() - t0 >= PROFILE_SECONDS:
                break
        sync(device)
        wall = time.perf_counter() - t0
        batches = spans.snapshot()[1].get("submit", 0) - b0
    tr.profile = trace.read_profile(prof.events(), wall, batches)
    tr.profile.calls = kernels.totals()
    tr.decode_s, tr.decode_batches = prog.decode_alone(pool[0])
    return tr
