"""Device kernels per short-read batch, counted in the profile."""


def read(rec):
    p = rec.trace.profile if rec.trace else None
    if p is None or not p.batches or not p.kernels:
        return None
    return p.kernels / p.batches
