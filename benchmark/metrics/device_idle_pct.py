"""100 - the device's busy share (the union of its activity in the profile)
of the profiled requests' wall, in %."""


def read(rec):
    p = rec.trace.profile if rec.trace else None
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
