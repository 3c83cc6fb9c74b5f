"""Host ms per short-read batch that the submitter waited on the collector's
jobs in flight (``pipeline_depth``; the program's ``submit.wait`` spans), over
the samples the program traced (benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "submit.wait")
