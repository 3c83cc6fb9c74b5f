"""Per-stage wall-clock timers for pipeline observability.

The reference's timers are commented out (``newkmer_10nx.cpp:17-18``); here
every pipeline stage (decode, pack, device step, report) can be accounted,
and a ``torch.profiler`` trace can wrap a pipeline section (the CLI's
``--profile DIR``).  Port of ``kmer_id_tpu/utils/timing.py``, whose trace is
``jax.profiler``'s.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextmanager
    def __call__(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total += time.perf_counter() - t0
            self.count += 1


class StageTimers:
    def __init__(self):
        self.timers: dict[str, Timer] = defaultdict(Timer)

    def stage(self, name: str):
        return self.timers[name]()

    def summary(self) -> dict[str, float]:
        return {k: round(t.total, 4) for k, t in self.timers.items()}


def write_metrics_json(path: str, **payload) -> None:
    """Append one JSON metrics record (per-sample observability; the
    structured twin of the reference's cout progress lines)."""
    import json
    import os
    import time as _t

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"ts": _t.time(), **payload}) + "\n")


class profile_trace:
    """Optional ``torch.profiler`` trace around a pipeline section: host
    ops, and the CUDA device's kernels and copies where a device is present.

    Usage: ``with profile_trace(trace_dir): ...`` — no-op when the dir is
    falsy.  On exit the trace is written into the dir as Chrome trace JSON,
    ``trace_<pid>_<ms since the epoch>.json``; view it in Perfetto or
    ``chrome://tracing``.
    """

    def __init__(self, trace_dir: str | None):
        self.dir = trace_dir
        self.path = None
        self._prof = None

    def __enter__(self):
        if self.dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import os

            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self.path = os.path.join(self.dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
            self._prof.export_chrome_trace(self.path)
        return False
