"""Host ms per short-read batch of the collector's fetches of finals (the
program's ``collect.fetch`` spans: the device-to-host copy and the wait for
the batch's kernels), over the samples the program traced
(benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "collect.fetch")
