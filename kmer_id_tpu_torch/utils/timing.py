"""Per-stage wall-clock timers for pipeline observability.

The reference's timers are commented out (``newkmer_10nx.cpp:17-18``); here
every pipeline stage (decode, pack, device step, report) can be accounted.
Copy of ``kmer_id_tpu/utils/timing.py`` without its profiler trace (the
port's CLI has no ``--profile``).
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

