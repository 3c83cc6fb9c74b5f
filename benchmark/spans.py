"""The program's own spans and counters (``kmer_id_tpu_torch/utils/timing.py``)
as the metrics of them read them: the summaries of the samples the program
traced.  The program traces a sample whose ``SampleProcessor`` is built while
a profiler records, so in a traced run these are the requests profiled after
the window (cell.py), and none of the window's.  Each metric divides by the
program's own count of short-read batches (``batches``), or by the traced
samples, and reads None where there is none: also in a checkout whose
program keeps no summaries."""

from __future__ import annotations


def summaries() -> list:
    """``timing.recent()`` of the program, or [] where it has none."""
    try:
        from kmer_id_tpu_torch.utils import timing
    except ImportError:
        return []
    recent = getattr(timing, "recent", None)
    return list(recent()) if callable(recent) else []


def _ns(summary: dict, name: str, offcpu: bool) -> int:
    s = summary.get("spans", {}).get(name)
    if s is None:
        return 0
    if offcpu:  # a span that does not read the thread's CPU clock counts nothing
        return s["wall_ns"] - s["cpu_ns"] if "cpu_ns" in s else 0
    return s["wall_ns"]


def _batches(got: list) -> int:
    return sum(s.get("counters", {}).get("batches", 0) for s in got)


def ms_per_batch(got: list, *names: str, offcpu: bool = False):
    """Wall ms (or, ``offcpu``, wall less the thread's CPU time) of the
    spans ``names`` per short-read batch, over the summaries ``got``."""
    batches = _batches(got)
    if not batches:
        return None
    return sum(_ns(s, n, offcpu) for s in got for n in names) / 1e6 / batches


def count_per_batch(got: list, counter: str):
    """The program's counter ``counter`` per short-read batch of ``got``."""
    batches = _batches(got)
    if not batches:
        return None
    return sum(s.get("counters", {}).get(counter, 0) for s in got) / batches


def ms_per_sample(got: list, *names: str):
    """Wall ms of the spans ``names`` per sample of ``got``."""
    if not got:
        return None
    return sum(_ns(s, n, False) for s in got for n in names) / 1e6 / len(got)
