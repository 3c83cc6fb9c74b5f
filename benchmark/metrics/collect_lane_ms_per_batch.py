"""Host ms per short-read batch of the long-read lane on the collector (the
program's ``collect.lane`` spans: ``process_long_many`` of a batch's long
rows), over the samples the program traced (benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "collect.lane")
