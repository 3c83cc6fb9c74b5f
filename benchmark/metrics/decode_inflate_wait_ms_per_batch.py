"""Host ms per short-read batch that the native fill waited for its file's
read-ahead (the program's ``inflate.wait_us`` counter: the calling thread
blocked until the worker that inflates the file had a block ready), over the
samples the program traced (benchmark/spans.py).  Near 0 where the parse
sets the decoder's pace, near the fill's whole time where inflating does.
None where no traced sample counts it: a checkout whose reader has no
worker."""

from benchmark.spans import count_per_batch, summaries


def read(rec):
    got = [s for s in summaries() if "inflate.wait_us" in s.get("counters", {})]
    us = count_per_batch(got, "inflate.wait_us")
    return None if us is None else us / 1000
