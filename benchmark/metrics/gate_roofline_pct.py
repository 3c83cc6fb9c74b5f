"""Share of its roofline that csrc/gate.cu reaches: the least time of its
calls (roofline.py, from each call's own arguments) over the profiler's time
of its kernels, in %."""

from benchmark.roofline import least_seconds


def read(rec):
    p = rec.trace.profile if rec.trace else None
    if p is None or not p.gate_kernels:
        return None
    n, nbytes, nops = p.calls.get("gate", (0, 0, 0))
    if n != p.gate_kernels:  # every call is one kernel: else the two do not match
        return None
    return 100.0 * least_seconds(nbytes, nops) / p.gate_s
