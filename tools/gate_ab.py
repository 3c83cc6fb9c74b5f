#!/usr/bin/env python3
"""gate.cu in two checkouts, on one card, in turns, and the L2 settings it was tried with.

    python3 tools/gate_ab.py BEFORE_DIR AFTER_DIR [--pairs N] [--knobs] [--reps N]

Each arm is a fresh process that imports one checkout's
``kmer_id_tpu_torch`` (and builds its kernels), and makes the same rows,
filter and tables on the card from one seed with this checkout's
``chip_smoke.py`` (``gate_bloom``, ``gate_rows``, ``gate_forms``, in the
packed form the engine ships) and ``tools/probe_ab.py`` (``tables``,
``narrow_windows``): a filter of 2^22 blocks (67 MB, the 33M-probe DB's)
and 2^23-bucket fingerprint tables (134 MB).  It times each call three
ways, on a stream of its own:

* ``replay``: CUDA-graph replay of 20 calls (``chip_smoke.device_ms``), so
  the filter's rows stay in L2 between calls as far as they fit;
* ``flushed``: one call after a write over a 256 MB buffer, CUDA events
  around the call alone (a spin kernel keeps the card busy while the host
  queues it);
* ``sequence``: one call after a ``probe.cu`` pass (``probe_verify_cuda``
  at the rows' count, 12 windows a read, over the 134 MB tables: the
  engine's step between two gates), events around the call alone.

Measurements: gate mode at nx [8192x160] (reads of 100-150 bp), lane
[2048x512] (full rows) and m3 [2048x512] (100-300 bp), k = 12; k = 24 at
nx on a filter of 2^21 blocks (a grid rank's); at nx on a filter of 2^12
blocks (64 KB: every row on chip, the kernel without DRAM rows); extract
mode at nx, lane and m3, and with fstrand at nx and lane.  The same rows
also go in the code-plane form (``codes``: a grid rank's rows from
``make_global_batch``, chunk rows with many invalid bases) through gate
mode at nx, lane, m3 and k = 24, and extract mode at nx, lane and m3.  Each
gate shape also prints its bound (16 bytes a valid window's Bloom row) and
its sector floor (32) by ``chip_smoke.bound``.

Runs the arms in the order before, after, after, before, ``--pairs``
times over; prints one JSON line per arm, then one per measurement with
each side's median, with the card's name and power limit.

``--knobs``: then the AFTER checkout alone under three L2 settings, in the
order none, fetch32, persist, persist, fetch32, none: ``fetch32`` sets
``cudaLimitMaxL2FetchGranularity`` to 32 bytes, ``persist`` sets aside the
card's largest persisting L2 and puts an access-policy window (hits
persisting) over the filter on the timing stream (the graph replay's
capture stream is PyTorch's own, so ``replay`` may run without the
window; ``flushed`` and ``sequence`` run on the timing stream).  These
arms also time
``probe.cu`` (``probe_verify_cuda`` at nx [8192x12]/32, the three ways),
and the AFTER checkout's C entry at each warps-per-row choice (bit-equal
to the wrapper first).  Prints one line per measurement
with each setting's median.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

from engine_ab import card_line, load_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
NB1_LOG2 = 23
FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 2_000_000  # ~1 ms of the spin kernel
# (name, rows, width, read lengths [lo, hi), filter blocks, k)
GATES = (("nx", 8192, 160, (100, 151), 1 << 22, 12),
         ("lane", 2048, 512, (512, 513), 1 << 22, 12),
         ("m3", 2048, 512, (100, 301), 1 << 22, 12),
         ("nx k=24", 8192, 160, (100, 151), 1 << 21, 24),
         ("nx on-chip filter", 8192, 160, (100, 151), 1 << 12, 12))
EXTRACTS = (("nx", False), ("lane", False), ("m3", False), ("nx", True), ("lane", True))
CODES = ("nx", "lane", "m3", "nx k=24")  # gate shapes also run in the code-plane form
SWEEP = {"nx": (1, 2), "lane": (1, 2, 4, 8), "m3": (1, 2, 4, 8)}  # warps per row
KNOBS = ("none", "fetch32", "persist", "persist", "fetch32", "none")


class _Window(ctypes.Structure):
    """cudaAccessPolicyWindow inside the 64-byte cudaStreamAttrValue."""
    _fields_ = [("base_ptr", ctypes.c_void_p), ("num_bytes", ctypes.c_size_t),
                ("hit_ratio", ctypes.c_float), ("hit_prop", ctypes.c_int),
                ("miss_prop", ctypes.c_int), ("pad", ctypes.c_char * 36)]


def _cudart():
    for name in ("libcudart.so.12", "libcudart.so", "/usr/local/cuda/lib64/libcudart.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError("gate_ab: no libcudart to set the L2 limits with")


def set_knob(knob: str, stream, bloom) -> dict:
    """Applies an L2 setting (module doc); returns what the runtime read
    back, and the error codes of the calls."""
    rt = _cudart()
    v = ctypes.c_size_t()
    info = {"fetch_granularity_default": (rt.cudaDeviceGetLimit(ctypes.byref(v), 5), v.value)}
    if knob == "fetch32":
        info["set"] = rt.cudaDeviceSetLimit(5, ctypes.c_size_t(32))
        info["fetch_granularity"] = (rt.cudaDeviceGetLimit(ctypes.byref(v), 5), v.value)
    elif knob == "persist":
        a = ctypes.c_int()
        maxp = (rt.cudaDeviceGetAttribute(ctypes.byref(a), 108, 0), a.value)
        maxw = (rt.cudaDeviceGetAttribute(ctypes.byref(a), 109, 0), a.value)
        info.update(max_persisting_l2=maxp, max_window=maxw)
        info["set_limit"] = rt.cudaDeviceSetLimit(6, ctypes.c_size_t(maxp[1]))
        nbytes = min(bloom.numel() * 4, maxw[1])
        w = _Window(ctypes.c_void_p(bloom.data_ptr()), nbytes,
                    min(1.0, maxp[1] / max(nbytes, 1)), 2, 1)
        info["window"] = {"bytes": nbytes, "hit_ratio": w.hit_ratio}
        info["set_window"] = rt.cudaStreamSetAttribute(
            ctypes.c_void_p(stream.cuda_stream), 1, ctypes.byref(w))
        info["persisting_l2"] = (rt.cudaDeviceGetLimit(ctypes.byref(v), 6), v.value)
    return info


class Timer:
    """The three timings of the module doc on one stream."""

    def __init__(self, torch, smoke, stream, reps):
        self.torch, self.smoke, self.stream, self.reps = torch, smoke, stream, reps
        self.flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def replay(self, fn):
        with self.torch.cuda.stream(self.stream):
            return self.smoke.device_ms(fn)

    def _after(self, pre, fn):
        torch = self.torch
        times = []
        with torch.cuda.stream(self.stream):
            fn()
            for i in range(self.reps):
                pre(i)
                torch.cuda._sleep(SPIN_CYCLES)
                a = torch.cuda.Event(enable_timing=True)
                z = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                z.record()
                z.synchronize()
                times.append(a.elapsed_time(z))
        return float(np.median(times))

    def flushed(self, fn):
        return self._after(lambda i: self.flush_buf.fill_(i), fn)

    def sequence(self, fn, probe):
        return self._after(lambda i: probe(), fn)

    def all(self, fn, probe):
        return {"replay": self.replay(fn), "flushed": self.flushed(fn),
                "sequence": self.sequence(fn, probe)}


def arm(checkout: str, knob: str, reps: int) -> dict:
    sys.path.insert(0, checkout)
    import torch

    import kmer_id_tpu_torch.ops.gate as gate
    import kmer_id_tpu_torch.ops.probe as probe
    from kmer_id_tpu_torch.kernels.build import build_many, launch, load_gate, ptr
    from kmer_id_tpu_torch.ops.words import u32_tensor
    from probe_ab import narrow_windows, tables

    smoke = load_smoke(ROOT)
    build_many(["gate", "probe"])
    dev = torch.device("cuda")
    stream = torch.cuda.Stream()
    rng = np.random.default_rng(SEED)
    db, _, keys_hi, keys_lo = tables(NB1_LOG2, dev)
    seen = torch.zeros(db["rec"].shape[0] + 1, dtype=torch.int8, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    probes = {}
    for b, mh in ((8192, 32), (2048, 32)):
        w = narrow_windows(g, keys_hi, keys_lo, b, 12, dev)
        probes[b] = (lambda w=w, mh=mh: probe.probe_verify_cuda(db, *w, mh, seen))
    timer = Timer(torch, smoke, stream, reps)
    out, info, reads_of, codes_of = {}, {}, {}, {}
    blooms = {}  # filter blocks: (numpy filter, salts, the filter on the card)
    for name, b, l, lens, nblk, k in GATES:
        if nblk not in blooms:
            bloom_np, s4, s5 = smoke.gate_bloom(rng, nblk)
            blooms[nblk] = (bloom_np, s4, s5, u32_tensor(bloom_np, dev))
        bloom_np, s4, s5, bloom = blooms[nblk]
        codes, lengths = smoke.gate_rows(rng, b, l, lens, bloom_np, s4, s5)  # plants bits
        bloom.copy_(u32_tensor(bloom_np, dev))
        forms = smoke.gate_forms(rng, codes, lengths, dev)
        reads = forms["packed"]
        tdb = {"bloom": bloom, "fp_s4": s4, "fp_s5": s5}
        if name in ("nx", "lane", "m3"):
            reads_of[name] = (reads, tdb)
            codes_of[name] = forms["codes"]
        if name == "nx" and knob not in ("ab", "none"):
            info["knob"] = set_knob(knob, stream, bloom)
        for form in ("packed", "codes"):
            want = gate.window_gate_plain(tdb, forms[form], k)
            got = gate.window_gate_cuda(tdb, forms[form], k)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{checkout}: gate {name} ({form}) != plain")
        valid = int(gate.extract_plain(reads)["valid"].sum())
        in_bytes = lengths.nbytes + reads.packed.numel() * 4 + reads.exc.numel() * 4
        ops = smoke.GATE_OPS_PER_WINDOW * b * (l - 29)
        out_bytes = b * (3 * k + 1) * 4
        info[f"gate {name}"] = {"valid_windows": valid,
                                "bound_ms": smoke.bound(in_bytes + 16 * valid + out_bytes, ops)[0],
                                "sector_floor_ms": smoke.bound(in_bytes + 32 * valid + out_bytes,
                                                               ops)[0]}
        fn = (lambda r=reads, d=tdb, k=k: gate.window_gate_cuda(d, r, k))
        for how, ms in timer.all(fn, probes[b]).items():
            out[f"gate {name} [{b}x{l}] {how}"] = ms
        if name in CODES:
            fn = (lambda r=forms["codes"], d=tdb, k=k: gate.window_gate_cuda(d, r, k))
            for how, ms in timer.all(fn, probes[b]).items():
                out[f"gate {name} codes [{b}x{l}] {how}"] = ms
    for name, fs in EXTRACTS:
        reads, _ = reads_of[name]
        fn = (lambda r=reads, fs=fs: gate.extract_cuda(r, fstrand=fs))
        for how, ms in timer.all(fn, probes[reads.rows]).items():
            out[f"extract{' fstrand' if fs else ''} {name} [{reads.rows}x{reads.width}] {how}"] = ms
    for name, reads in codes_of.items():
        want = gate.extract_plain(reads)
        got = gate.extract_cuda(reads)
        torch.cuda.synchronize()
        if not all(torch.equal(got[n], want[n]) for n in want):
            raise AssertionError(f"{checkout}: extract {name} (codes) != plain")
        fn = (lambda r=reads: gate.extract_cuda(r))
        for how, ms in timer.all(fn, probes[reads.rows]).items():
            out[f"extract {name} codes [{reads.rows}x{reads.width}] {how}"] = ms
    if knob == "ab":
        return {"ms": out, "info": info}
    # probe.cu under the setting, the gate's C entry at each grouping
    w = narrow_windows(g, keys_hi, keys_lo, 8192, 12, dev)
    for how, ms in timer.all(lambda: probe.probe_verify_cuda(db, *w, 32, seen),
                             probes[8192]).items():
        out[f"probe_verify nx [8192x12]/32 {how}"] = ms
    if not hasattr(gate, "gate_group"):
        return {"ms": out, "info": info}
    lib = load_gate()
    for name, configs in SWEEP.items():
        reads, tdb = reads_of[name]
        b = reads.rows
        lead = gate._kernel_args(reads, "sweep")[:-1]
        want = gate.window_gate_cuda(tdb, reads)
        for group in configs:
            outs = [torch.empty((b, 12), dtype=torch.int32, device=dev) for _ in range(3)]
            outs.append(torch.empty((b,), dtype=torch.int32, device=dev))

            def call(group=group, outs=outs, lead=lead, tdb=tdb):
                launch(lib.kmer_window_gate, "window_gate", dev, *lead, group,
                       ptr(tdb["bloom"]), tdb["bloom"].shape[0], tdb["fp_s4"], tdb["fp_s5"], 12,
                       *map(ptr, outs))

            call()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(outs, want)):
                raise AssertionError(f"gate {name} at {group} warps a row != wrapper")
            key = f"sweep gate {name} G={group}"
            out[f"{key} replay"] = timer.replay(call)
            out[f"{key} flushed"] = timer.flushed(call)
    return {"ms": out, "info": info}


def run_arm(checkout: str, knob: str, reps: int) -> dict:
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--arm", checkout,
                          "--knob", knob, "--reps", str(reps)], capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"arm {checkout} ({knob}) exited {res.returncode}")
    return json.loads(next(line[4:] for line in res.stdout.splitlines()
                           if line.startswith("ARM ")))


def medians(runs: dict, card: str, label: str) -> None:
    names = []
    for rs in runs.values():
        for r in rs:
            names += [n for n in r["ms"] if n not in names]
    for name in names:
        med = {side: (float(np.median([r["ms"][name] for r in rs if name in r["ms"]]))
                      if any(name in r["ms"] for r in rs) else None)
               for side, rs in runs.items()}
        print(json.dumps({"measure": name, "card": card, label: med}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", nargs="?")
    ap.add_argument("after", nargs="?")
    ap.add_argument("--pairs", type=int, default=3, help="rounds of before, after, after, before")
    ap.add_argument("--knobs", action="store_true", help="then the L2 settings on AFTER")
    ap.add_argument("--reps", type=int, default=40, help="calls per flushed/sequence median")
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    ap.add_argument("--knob", default="ab", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.arm:
        res = arm(os.path.abspath(args.arm), args.knob, args.reps)
        print("ARM " + json.dumps(res), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("gate_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    runs = {"before": [], "after": []}
    for side in ("before", "after", "after", "before") * args.pairs:
        d = os.path.abspath(getattr(args, side))
        res = run_arm(d, "ab", args.reps)
        runs[side].append(res)
        print(json.dumps({"arm": side, "checkout": d, "card": card, **res}), flush=True)
    medians(runs, card, "ms")
    if args.knobs:
        knobs = {k: [] for k in KNOBS}
        after = os.path.abspath(args.after)
        for knob in KNOBS:
            res = run_arm(after, knob, args.reps)
            knobs[knob].append(res)
            print(json.dumps({"arm": "after", "knob": knob, "card": card, **res}), flush=True)
        medians(knobs, card, "ms_by_setting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
