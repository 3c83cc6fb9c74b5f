"""Host ms per traced sample of its fixed work on the calling thread (the
program's ``sample.start``, ``sample.finish`` and ``sample.write`` spans: the
set-up with its two ``seen`` planes; the drain, barrier, stream syncs and
ucount; the result file), over the samples the program traced
(benchmark/spans.py)."""

from benchmark.spans import ms_per_sample, summaries


def read(rec):
    return ms_per_sample(summaries(), "sample.start", "sample.finish", "sample.write")
