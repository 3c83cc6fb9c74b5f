"""Host ms per short-read batch that the calling thread waited on the
submitter's queue of 6 (the program's ``feed.wait`` spans), over the samples
the program traced (benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "feed.wait")
