#!/usr/bin/env python3
"""The control of a cell: the reference put in the program's place with one
guarantee broken, judged by the cell's own check (check.py), which has to
find it not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The guarantee broken is the per-sample unique-probe count: the control
counts a probe once per read instead of once per sample (``ucount`` from a
seen set cleared at every read), the step a change dropping the sample's
seen planes would take.  Each seed makes the cell's DB and input pool at
its own size and writes the control's outputs for every input once; a run's
check compares as many requests per input or more, so its numbers are at
least these.  Needs no program; the DB and the reference run on a card where there
is one (the DB the cell's runs on that card draw from the seed).  Prints one JSON line per seed."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cell, seed: int, work: str) -> dict:
    """The check's numbers for the control's outputs of every input of the
    cell's pool at ``seed``."""
    from benchmark import check
    from benchmark.gen.db import make_db
    from benchmark.gen.samples import make_pool

    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    db = make_db(seed, int(cell.config["probes"]), int(cell.config["num_targ"]), device)
    pool = make_pool(seed, cell.traffic, db)
    preset = cell.preset
    saves = cell.driver in ("nx", "vf6")
    u_is_t = preset.get("u_is_t", cell.driver != "nx")
    args = (pool, range(len(pool)), db, u_is_t, preset.get("savenum", 12), saves)
    refs = check.reference_outputs(*args, device=device)
    ctrl = check.reference_outputs(*args, dedup="read", device=device)
    served = []
    for i, outputs in ctrl.items():
        prefix = os.path.join(work, f"c{i}")
        check.write_outputs(prefix, outputs, saves)
        served.append(SimpleNamespace(pool=i, out=prefix))
    numbers, failed = check.compare(served, refs, saves)
    return {"numbers": numbers, "failed": failed, "attempted": len(served)}


def main(argv=None, overrides=None) -> int:
    import argparse

    from benchmark import spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    work = os.path.join(tempfile.gettempdir(), "kmerid-bench", "control-" + cell.name)
    for seed in args.seeds:
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        t = time.perf_counter()
        try:
            got = control_numbers(cell, seed, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        got.update(workload=cell.name, seed=seed, seconds=time.perf_counter() - t,
                   correct=got["failed"] == 0)
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
