"""The port's tracing: spans and counters of the sample loop, and the
operator exporters (``--metrics`` JSONL, ``--profile`` Chrome trace).

A sample is traced when, as its ``SampleProcessor`` is built, the switch is
on (:func:`set_tracing`; the CLI's ``--metrics`` and ``--profile`` turn it
on) or a ``torch.profiler`` is recording (:func:`profiler_recording`).  Its
:class:`SampleTrace` (which carries the sample's id) keeps, in memory,
one record per span (name, the batch's id, the thread, start and end from
``perf_counter_ns`` and, for the decoder's spans (:data:`CPU_SPANS`), the
thread's CPU time over it from ``thread_time_ns``: wall minus CPU is the
time the thread was off the CPU, waiting for the GIL, the OS or a lock)
and plain integer counters.  At the
sample's end they are summarised per span name (count, wall ns, CPU ns) with
the counters, and the summary joins :func:`recent`, the last
:data:`RECENT` traced samples of the process.

Code that does not hold the sample (the engine's syncs and fetches, the
kernel build) records through the thread's current trace (:func:`current`),
which each of the sample's worker jobs sets (:func:`using`); where none is
set, its spans and counts do nothing.  Off, a span site costs one check:
:func:`span` of ``None`` is a shared no-op context.

While a profiler records, each span is also a ``kmerid::<name>`` range of
the profiler (:func:`_range`), with the sample and batch ids, so the spans
sit on the profiler's clock beside the kernels and copies, and each device
idle gap can be put down to the spans open across it.

The reference's timers are commented out (``newkmer_10nx.cpp:17-18``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

RECENT = 256  # summaries kept by recent()
PREFIX = "kmerid::"  # the spans' names in a profile
# the spans that read the thread's CPU clock: on the card's host each read
# is a system call of 5 us alone and 15-20 us beside busy threads, with a 10
# ms resolution, so only the decoder's spans, which the off-CPU metric
# reads, take it
CPU_SPANS = frozenset({"decode.fill", "decode.pack"})

_switch = False
_recent: deque = deque(maxlen=RECENT)


class _Local(threading.local):
    """Per thread: the current trace, the innermost open span's name and
    batch id, and the thread's name once a span has read it (class defaults,
    so that an untraced thread's lookups never miss)."""

    trace = None
    span = None
    batch = -1
    name = None


_local = _Local()
_ids = itertools.count(1)  # sample ids, process-wide
_NULL = contextlib.nullcontext()
_profiler = None  # torch.autograd.profiler, once imported
_thread_ns, _wall_ns = time.thread_time_ns, time.perf_counter_ns


def set_tracing(on: bool) -> bool:
    """The switch: trace every sample whose ``SampleProcessor`` is built
    while it is on.  Returns the previous setting."""
    global _switch
    prev, _switch = _switch, bool(on)
    return prev


@contextlib.contextmanager
def tracing(on=True):
    """Inside the block the switch is on where ``on`` holds (else as it
    was); after it, as it was."""
    prev = set_tracing(True) if on else None
    try:
        yield
    finally:
        if on:
            set_tracing(prev)


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` records, in any thread of the process
    (``torch._C._autograd._profiler_enabled()`` is per thread, and reads
    False on a worker while the main thread profiles)."""
    global _profiler
    if _profiler is None:
        try:
            from torch.autograd import profiler
        except ImportError:
            return False
        if not hasattr(profiler, "_is_profiler_enabled"):
            return False
        _profiler = profiler
    return bool(_profiler._is_profiler_enabled)


def new_trace() -> "SampleTrace | None":
    """A trace for a sample starting now, or None where tracing is off."""
    if _switch or profiler_recording():
        return SampleTrace()
    return None


def recent() -> list:
    """The summaries of the process's last :data:`RECENT` traced samples,
    oldest first (see :meth:`SampleTrace.summarise`)."""
    return list(_recent)


def span(trace, name: str, batch: int = -1):
    """A span of ``name`` on the calling thread in ``trace`` (a no-op context
    where ``trace`` is None); ``batch`` -1 takes the batch id of the
    thread's innermost open span."""
    return _NULL if trace is None else _Span(trace, name, batch)


def count(trace, counter: str, n: int = 1) -> None:
    """Adds ``n`` to ``trace``'s counter (nothing where ``trace`` is None)."""
    if trace is not None:
        trace.add(counter, n)


def current():
    """The thread's current trace (None outside a traced sample's work)."""
    return _local.trace


def using(trace):
    """Makes ``trace`` the thread's current trace inside the block (a no-op
    context where ``trace`` is None)."""
    return _NULL if trace is None else _Using(trace)


def sync():
    """The span of a host read of a device value in the thread's current
    trace, named by the span it opens in: ``sync`` in the submitter's
    ``submit``, else ``<enclosing span>.sync`` (``collect.lane.sync``: the
    long lane's, on the collector)."""
    local = _local
    tr = local.trace
    if tr is None:
        return _NULL
    outer = local.span
    return _Span(tr, "sync" if outer in (None, "submit") else outer + ".sync", -1)


def fetch(t):
    """A batch's finals ``t`` on the host as a numpy array (from a card, a
    device-to-host copy that waits for the kernels writing them): in the
    thread's current trace a ``collect.fetch`` span and one of
    ``fetches``."""
    tr = _local.trace
    if tr is None:
        return t.cpu().numpy()
    tr.add("fetches")
    with _Span(tr, "collect.fetch", -1):
        return t.cpu().numpy()


class SampleTrace:
    """One sample's spans and counters (see the module doc)."""

    def __init__(self):
        profiler_recording()  # binds the profiler's module for the spans' check
        self.sample = next(_ids)
        self.spans: list = []  # (name, batch, thread, start_ns, end_ns, cpu_ns or None)
        self.counters: dict = {}
        self.summary: dict = {}  # filled by summarise(), in place
        self._lock = threading.Lock()  # counters are added from both workers

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + n

    def summarise(self) -> dict:
        """``{"sample": id, "spans": {name: {"count", "wall_ns"[, "cpu_ns"]}},
        "counters": {name: n}}`` (``cpu_ns`` for the :data:`CPU_SPANS`),
        written into :attr:`summary` in place, so that what holds the
        summary sees a later call's."""
        spans: dict = {}
        for name, _, _, t0, t1, cpu in list(self.spans):
            s = spans.get(name)
            if s is None:
                s = spans[name] = {"count": 0, "wall_ns": 0}
                if cpu is not None:
                    s["cpu_ns"] = 0
            s["count"] += 1
            s["wall_ns"] += t1 - t0
            if cpu is not None:
                s["cpu_ns"] += cpu
        with self._lock:
            counters = dict(self.counters)
        self.summary.update(sample=self.sample, spans=spans, counters=counters)
        return self.summary

    def finish(self) -> dict:
        """:meth:`summarise`, and the summary joins :func:`recent`."""
        _recent.append(self.summarise())
        return self.summary


class _Span:
    __slots__ = ("trace", "name", "batch", "prev", "outer", "rf", "t0", "c0")

    def __init__(self, trace, name: str, batch: int):
        self.trace, self.name, self.batch = trace, name, batch

    def __enter__(self):
        local = _local
        self.outer, local.span = local.span, self.name
        self.prev = prev = local.batch
        if self.batch < 0:
            self.batch = prev
        local.batch = self.batch
        self.rf = None
        if _profiler is not None and _profiler._is_profiler_enabled:
            self.rf = _range(PREFIX + self.name, self.trace.sample, self.batch)
            self.rf.__enter__()
        self.c0 = _thread_ns() if self.name in CPU_SPANS else None
        self.t0 = _wall_ns()
        return self

    def __exit__(self, *exc):
        t1 = _wall_ns()
        cpu = None if self.c0 is None else _thread_ns() - self.c0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        local = _local
        local.span, local.batch = self.outer, self.prev
        thread = local.name
        if thread is None:
            thread = local.name = threading.current_thread().name
        self.trace.spans.append((self.name, self.batch, thread, self.t0, t1, cpu))
        return False


class _Using:
    __slots__ = ("trace", "prev")

    def __init__(self, trace):
        self.trace = trace

    def __enter__(self):
        self.prev = _local.trace
        _local.trace = self.trace
        return self.trace

    def __exit__(self, *exc):
        _local.trace = self.prev
        return False


def _range(name: str, sample: int, batch: int):
    """A span's profiler range: a function-scope record, a ``cpu_op`` on the
    host's timeline, so that the device's side of a profile keeps only the
    kernels and copies (a ``record_function`` annotation is mirrored onto
    the device's timeline over the kernels it launched).  The ids are its
    keyword values, which a profiler keeps where it records shapes on the
    thread (not under ``profile_all_threads``)."""
    import torch

    return torch._C._profiler._RecordFunctionFast(name, (), {"sample": sample, "batch": batch})


def write_metrics_json(path: str, **payload) -> None:
    """Append one JSON metrics record (per-sample observability; the
    structured twin of the reference's cout progress lines)."""
    import json
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"ts": time.time(), **payload}) + "\n")


class profile_trace:
    """Optional ``torch.profiler`` trace around a pipeline section: host
    ops, the samples' ``kmerid::`` spans on every thread (the switch is on
    inside it), and the CUDA device's kernels and copies where a device is
    present.

    Usage: ``with profile_trace(trace_dir): ...`` — no-op when the dir is
    falsy.  On exit the trace is written into the dir as Chrome trace JSON,
    ``trace_<pid>_<ms since the epoch>.json``; view it in Perfetto or
    ``chrome://tracing``.
    """

    def __init__(self, trace_dir: str | None):
        self.dir = trace_dir
        self.path = None
        self._prof = None
        self._switch = tracing(bool(trace_dir))

    def __enter__(self):
        self._switch.__enter__()
        if self.dir:
            import torch
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            # every thread: the workers' spans too
            self._prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
                profile_all_threads=True))
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import os

            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self.path = os.path.join(self.dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
            self._prof.export_chrome_trace(self.path)
        self._switch.__exit__(*exc)
        return False
