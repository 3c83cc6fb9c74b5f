"""Host ms per batch of the collector's jobs (SampleProcessor._group_job and
_drain_job: D2H, overflow replay, long-read lane, accounting), over the
traced window."""


def read(rec):
    t = rec.trace
    if t is None or not t.batches or "collect" not in t.host_s:
        return None
    return 1e3 * t.host_s["collect"] / t.batches
