"""Host ms per short-read batch of the native feeder's numpy part (the
program's ``decode.pack`` spans: the blob copies, ``pack_codes``, the new
plane; calling thread), over the samples the program traced
(benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "decode.pack")
