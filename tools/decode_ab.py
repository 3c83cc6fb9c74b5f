#!/usr/bin/env python3
"""The port's native feeder in two checkouts, on one host, in turns.

    python3 tools/decode_ab.py BEFORE_DIR AFTER_DIR [--cells bact10.deep mito.reads]
                               [--rounds N] [--drains N] [--seed N] [--probes N]
                               [--toy]

For each cell of ``BENCHMARK.json``, makes one request of the cell's traffic
once, with AFTER_DIR's ``benchmark/gen`` on a DB of ``--probes`` random
probes (the reads' plants come from it; decoding does not depend on them),
and writes its files under ``build/decode_ab/``.  Then, ``--rounds`` times,
runs each checkout in a fresh process in the order before, after, after,
before.  Each process imports that checkout's ``NativePlaneFeeder``, drains
it over the request once to warm up, then ``--drains`` times with a trace
(no profiler), and reports per batch the median wall of a drain, of its
``decode.fill`` and ``decode.pack`` spans, and the fill's wait for the
reader's read-ahead (the ``inflate.wait_us`` counter; null in a checkout
whose reader has none).  Prints one JSON line per cell:
each arm's medians over its processes, and the after-minus-before
differences of the two processes of each turn (median and quartiles, ms a
batch), the fill's being what packing inside the fill costs there.
``--toy`` uses ``benchmark/tests/toy.py``'s request sizes (a rehearsal).
Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "decode_ab")

ARM = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
from kmer_id_tpu_torch.io.native_feed import NativePlaneFeeder
from kmer_id_tpu_torch.utils import timing
b, l, u, fmt, drains = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4] == "1", sys.argv[5], int(sys.argv[6])
paths = sys.argv[7:]
out = {"wall": [], "decode.fill": [], "decode.pack": [], "inflate.wait": []}
for k in range(drains + 1):
    tr = timing.SampleTrace()
    feeder = NativePlaneFeeder(b, l, u, trace=tr)
    t = time.perf_counter()
    for p in paths:
        for _ in feeder.feed_path(p, fmt=fmt or None):
            pass
    for _ in feeder.flush():
        pass
    wall = time.perf_counter() - t
    if k == 0:
        continue  # warm-up: the library's first load, the files' first read
    n = feeder.emitted
    spans = tr.summarise()["spans"]
    out["wall"].append(wall * 1e3 / n)
    for name in ("decode.fill", "decode.pack"):
        out[name].append(spans[name]["wall_ns"] / 1e6 / n)
    wait_us = tr.counters.get("inflate.wait_us")
    out["inflate.wait"].append(None if wait_us is None else wait_us / 1e3 / n)
print(json.dumps({k: None if None in v else statistics.median(v) for k, v in out.items()}
                 | {"batches": n}))
"""


def make_request(name: str, seed: int, probes: int, toy: bool) -> tuple:
    """(preset, fmt, paths) of one request of ``name``'s traffic."""
    from benchmark import spec
    from benchmark.gen.db import make_db
    from benchmark.gen.samples import make_pool, write_pool

    if toy:
        from benchmark.tests import toy as toy_mod

        cell = toy_mod.cell(name)
    else:
        cell = spec.load_cell(name)
    traffic = dict(cell.traffic, pool=1)
    db = make_db(seed, probes, int(cell.config["num_targ"]), "cpu")
    pool = make_pool(seed, traffic, db)
    d = os.path.join(WORK, name)
    write_pool(pool, d, cell.driver)
    fmt = "fastq_gz" if cell.driver == "nx" else ""
    return cell.preset, fmt, [f.path for f in pool[0].files]


def arm(checkout: str, preset: dict, fmt: str, paths: list, drains: int) -> dict:
    cmd = [sys.executable, "-c", ARM, os.path.abspath(checkout), str(preset["batch_size"]),
           str(preset["max_len"]), "1" if preset["u_is_t"] else "0", fmt, str(drains), *paths]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=checkout, timeout=1800)
    if p.returncode != 0:
        raise RuntimeError(f"{checkout}: {p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def median(values):
    """The median, or None where any value is None (an arm without it)."""
    v = list(values)
    return None if None in v else statistics.median(v)


def quartiles(v: list) -> list:
    return statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--cells", nargs="+", default=["bact10.deep", "mito.reads"])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--drains", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--probes", type=int, default=1_000_000)
    ap.add_argument("--toy", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.after))
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        for i, name in enumerate(args.cells):
            preset, fmt, paths = make_request(name, args.seed + i, args.probes, args.toy)
            runs = {"before": [], "after": []}
            diffs: dict = {"wall": [], "decode.fill": [], "decode.pack": [], "inflate.wait": []}
            for _ in range(args.rounds):
                turn = {}
                for which in ("before", "after", "after", "before"):
                    got = arm(getattr(args, which), preset, fmt, paths, args.drains)
                    runs[which].append(got)
                    turn.setdefault(which, []).append(got)
                for k in diffs:
                    for b, a in zip(turn["before"], turn["after"]):
                        if a[k] is not None and b[k] is not None:
                            diffs[k].append(a[k] - b[k])
            res = {"cell": name, "batches": runs["after"][0]["batches"],
                   "ms_per_batch": {which: {k: median(r[k] for r in rs) for k in diffs}
                                    for which, rs in runs.items()},
                   "after_minus_before": {k: {"median": statistics.median(v),
                                              "quartiles": quartiles(v)}
                                          for k, v in diffs.items() if v}}
            print(json.dumps(res), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
