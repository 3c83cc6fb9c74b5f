"""Share, in %, of the short-read batches that the native decoder emitted
while another file of the same request was still decoding (the program's
``feed.overlap`` counter over its ``batches``), over the samples the program
traced (benchmark/spans.py).  Near 100 where a request's files decode at
once, 0 where it has one file.  None where no traced sample counts it: a
checkout that decodes a request's files one at a time."""

from benchmark.spans import count_per_batch, summaries


def read(rec):
    got = [s for s in summaries() if "feed.overlap" in s.get("counters", {})]
    share = count_per_batch(got, "feed.overlap")
    return None if share is None else 100 * share
