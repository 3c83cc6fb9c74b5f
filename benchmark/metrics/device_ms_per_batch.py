"""Device ms per short-read batch: the profiler's kernel time (copies and
fills left out) over the profiled requests' batches."""


def read(rec):
    p = rec.trace.profile if rec.trace else None
    if p is None or not p.batches or not p.kernels:
        return None
    return 1e3 * p.kernel_s / p.batches
