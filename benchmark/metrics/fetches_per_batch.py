"""Device-to-host fetches of finals per short-read batch (the program's
``fetches`` counter: one per collect group), over the samples the program
traced (benchmark/spans.py)."""

from benchmark.spans import count_per_batch, summaries


def read(rec):
    return count_per_batch(summaries(), "fetches")
