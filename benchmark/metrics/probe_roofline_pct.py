"""Share of its roofline that csrc/probe.cu's probe pass reaches: the least
time of its calls (roofline.py; a floor) over the profiler's time of its
kernels, in %."""

from benchmark.roofline import least_seconds


def read(rec):
    p = rec.trace.profile if rec.trace else None
    if p is None or not p.probe_kernels:
        return None
    n, nbytes, nops = p.calls.get("probe", (0, 0, 0))
    if n != p.probe_kernels:  # every call is one kernel: else the two do not match
        return None
    return 100.0 * least_seconds(nbytes, nops) / p.probe_s
