"""Host ms per batch of the submitter's step (SampleProcessor._consume_native:
H2D enqueue, engine launches), over the traced window."""


def read(rec):
    t = rec.trace
    if t is None or not t.batches or "submit" not in t.host_s:
        return None
    return 1e3 * t.host_s["submit"] / t.batches
