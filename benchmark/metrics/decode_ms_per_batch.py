"""Host ms per batch of the native feeder (gz inflate, parse, trim, 2-bit
packing) drained alone over one request, after the window."""


def read(rec):
    t = rec.trace
    if t is None or not t.decode_batches:
        return None
    return 1e3 * t.decode_s / t.decode_batches
