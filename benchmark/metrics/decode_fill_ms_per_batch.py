"""Host ms per short-read batch of the native decoder's fills (the program's
``decode.fill`` spans: inflate, parse, trim, with the GIL released; calling
thread), over the samples the program traced (benchmark/spans.py)."""

from benchmark.spans import ms_per_batch, summaries


def read(rec):
    return ms_per_batch(summaries(), "decode.fill")
