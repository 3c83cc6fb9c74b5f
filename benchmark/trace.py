"""What a traced run records, from the benchmark's own files around the
program's calls (spans inside the program are not there yet):

* :class:`HostSpans`: host seconds and calls of the driver's submit step
  (``SampleProcessor._consume_native``), its collector jobs
  (``_group_job``, ``_drain_job``) and the long-read lane
  (``FpClassifier.process_long_many``), each also a ``record_function``
  span so that a profile shows what the host threads did;
* :class:`KernelCalls`: each call of the gate and probe kernels' wrappers
  (``ops/gate.py``, ``ops/probe.py``) with the tensors its least bytes are
  worked out from once the profile has closed (roofline.py);
* :func:`read_profile`: the device side of a ``torch.profiler`` run over
  whole requests: kernel time and count, the busy union, the longest idle
  gaps with the host spans open across them, the top device operations."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from benchmark import roofline

SPAN = "kbench::"


class HostSpans:
    """Host seconds and calls per span name, summed over threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seconds: dict = {}
        self.calls: dict = {}

    def wrap(self, name: str, fn):
        import torch

        def run(*a, **kw):
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(SPAN + name):
                    return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t
                with self.lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt
                    self.calls[name] = self.calls.get(name, 0) + 1
        return run

    def snapshot(self) -> tuple:
        with self.lock:
            return dict(self.seconds), dict(self.calls)

    @contextmanager
    def installed(self):
        from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
        from kmer_id_tpu_torch.engine.pipeline import SampleProcessor

        points = [(SampleProcessor, "_consume_native", "submit"),
                  (SampleProcessor, "_group_job", "collect"),
                  (SampleProcessor, "_drain_job", "collect"),
                  (SampleProcessor, "feed_file", "feed_file"),
                  (FpClassifier, "process_long_many", "lane")]
        saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in points]
        try:
            for cls, attr, name in points:
                setattr(cls, attr, self.wrap(name, cls.__dict__[attr]))
            yield self
        finally:
            for cls, attr, fn in saved:
                setattr(cls, attr, fn)


class KernelCalls:
    """The gate and probe wrappers' calls while installed: (kind, tensors)
    kept until :meth:`totals`, which works out their bytes and operations
    (after the profile, so that no counting runs inside it)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.calls: list = []

    def _keep(self, item):
        with self.lock:
            self.calls.append(item)

    @contextmanager
    def installed(self):
        from kmer_id_tpu_torch.ops import gate, probe

        orig = {("gate", "window_gate_cuda"): gate.window_gate_cuda,
                ("gate", "extract_cuda"): gate.extract_cuda,
                ("probe", "probe_verify_cuda"): probe.probe_verify_cuda,
                ("probe", "probe_verify_dense_cuda"): probe.probe_verify_dense_cuda}

        def window_gate(db, reads, k=gate.BLOOM_K):
            out = orig["gate", "window_gate_cuda"](db, reads, k)
            self._keep(("gate", reads, k))
            return out

        def extract(reads, fstrand=False):
            out = orig["gate", "extract_cuda"](reads, fstrand)
            self._keep(("extract", reads, fstrand))
            return out

        def verify(db, wpos, whi, wlo, max_hits, seen=None):
            out = orig["probe", "probe_verify_cuda"](db, wpos, whi, wlo, max_hits, seen)
            if wpos.shape[0]:
                self._keep(("probe", wpos, out, max_hits))
            return out

        def dense(db, hi, lo, valid, max_hits, seen=None):
            out = orig["probe", "probe_verify_dense_cuda"](db, hi, lo, valid, max_hits, seen)
            if valid.shape[0]:
                self._keep(("dense", valid, out, max_hits))
            return out

        # each original counts its launches through its module's name for it
        for fn, key in zip((window_gate, extract, verify, dense), orig):
            fn.launches = orig[key].launches
        mods = {"gate": gate, "probe": probe}
        try:
            gate.window_gate_cuda, gate.extract_cuda = window_gate, extract
            probe.probe_verify_cuda, probe.probe_verify_dense_cuda = verify, dense
            yield self
        finally:
            for (mod, name), fn in orig.items():
                setattr(mods[mod], name, fn)

    def totals(self) -> dict:
        """{"gate": [calls, bytes, ops], "probe": [...]}."""
        out = {"gate": [0, 0.0, 0.0], "probe": [0, 0.0, 0.0]}
        for kind, *args in self.calls:
            if kind == "gate":
                nb, no = roofline.gate_call(*args)
            elif kind == "extract":
                nb, no = roofline.extract_call(*args)
            elif kind == "probe":
                nb, no = roofline.probe_call(*args)
            else:
                nb, no = roofline.probe_dense_call(*args)
            acc = out["gate" if kind in ("gate", "extract") else "probe"]
            acc[0] += 1
            acc[1] += nb
            acc[2] += no
        self.calls = []
        return out


GATE_KERNELS = ("window_gate_kernel", "window_extract_kernel")
PROBE_KERNELS = ("probe_kernel<",)  # probe.cu's pass; its slots mode is probe_slots_kernel


def _copy(name: str) -> bool:
    return "Memcpy" in name or "Memset" in name


def _union(intervals) -> tuple[float, list]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


@dataclass
class Profile:
    window_s: float  # host wall of the profiled requests
    batches: int  # short-read batches submitted in them
    busy_s: float = 0.0  # union of device activity
    kernel_s: float = 0.0  # kernels, copies and fills left out
    kernels: int = 0
    gate_s: float = 0.0
    gate_kernels: int = 0
    probe_s: float = 0.0
    probe_kernels: int = 0
    device_ops: list = field(default_factory=list)  # [[name, seconds]] top 10
    idle_gaps: list = field(default_factory=list)  # [[host spans open, seconds]] top 10
    calls: dict = field(default_factory=dict)  # KernelCalls.totals()


def read_profile(events, window_s: float, batches: int) -> Profile:
    """The device side of a profile (times in the profiler's us)."""
    from torch.autograd import DeviceType

    prof = Profile(window_s, batches)
    # the spans also show on the device as annotations over their kernels
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN)]
    spans = [e for e in events if e.device_type != DeviceType.CUDA and e.name.startswith(SPAN)]
    if not dev:
        return prof
    by_name: dict = {}
    for e in dev:
        dt = (e.time_range.end - e.time_range.start) / 1e6
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
        if _copy(e.name):
            continue
        prof.kernel_s += dt
        prof.kernels += 1
        if any(k in e.name for k in GATE_KERNELS):
            prof.gate_s += dt
            prof.gate_kernels += 1
        elif any(k in e.name for k in PROBE_KERNELS):
            prof.probe_s += dt
            prof.probe_kernels += 1
    busy, merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    prof.busy_s = busy / 1e6
    reqs = [e for e in spans if e.name == SPAN + "request"]
    lo = min((e.time_range.start for e in reqs), default=merged[0][0])
    hi = max((e.time_range.end for e in reqs), default=merged[-1][1])
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        open_ = sorted({e.name[len(SPAN):] for e in spans if e.name != SPAN + "request"
                        and e.time_range.start <= mid <= e.time_range.end})
        prof.idle_gaps.append(["+".join(open_) or "none", (b - a) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    prof.device_ops = [[name[:120], s] for name, s in top]
    return prof

