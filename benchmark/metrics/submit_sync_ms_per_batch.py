"""Host ms per short-read batch of the engine's host reads of device values
in its batch branches (the program's ``sync`` spans: the gate's passing count,
the consistency test, the fold's trip count), over the samples the program
traced (benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "sync")
