"""Host ms per short-read batch that the calling thread spent off the CPU
inside ``decode.fill`` and ``decode.pack`` (wall less the thread's CPU time:
waiting for the GIL, the OS or a lock), over the samples the program traced
(benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "decode.fill", "decode.pack", offcpu=True)
