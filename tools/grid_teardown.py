#!/usr/bin/env python3
"""How often a grid of gloo ranks on the CPU loses a rank at exit, with and without ``shutdown``.

    python3 tools/grid_teardown.py [--grids 200] [--at-once 4] [--mode both|bare|shutdown]
                                   [--extra 1]

Starts ``--grids`` grids of 2 x 2 ranks, ``--at-once`` grids at a time,
each rank a fresh process of the port (``parallel/distributed.py``:
``initialize``, ``make_mesh``), which runs 20 rounds of a
sum over db and one over data, and ``--extra`` more sums over db in data
shard 1 only (the legacy engine's replay; 0: every rank's last
collective the same), then either exits with its process
group up (``bare``) or leaves it first (``shutdown``: a barrier, then
``destroy_process_group``).  Prints, per mode, how many grids had a rank
that did not exit 0 (or did not end within RANK_TIMEOUT_S), and the last
line of each such rank's errors.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
ROUNDS = 20
RANK_TIMEOUT_S = 120  # a rank runs ~5 s; past this it counts as failed and is killed


def rank(coord: str, r: int, leave: bool, extra: int) -> int:
    import torch

    from kmer_id_tpu_torch.parallel import make_mesh
    from kmer_id_tpu_torch.parallel.distributed import initialize, shutdown

    torch.set_num_threads(1)
    initialize(coord, RANKS, r, "cpu")
    grid = make_mesh(data=2, db=2, device="cpu")
    x = torch.ones(1000)
    for _ in range(ROUNDS):
        x = grid.psum_db(x)
        x = grid.psum_data(x)
    if r // 2 == 1:
        for _ in range(extra):
            grid.psum_db(x)
    if leave:
        shutdown()
    return 0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def grid(leave: bool, extra: int) -> list:
    """(exit code, last error line) of each rank of one grid."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank",
         json.dumps({"coord": coord, "rank": r, "leave": leave, "extra": extra})],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    out = []
    for p in procs:
        try:
            err = p.communicate(timeout=RANK_TIMEOUT_S)[1]
            out.append((p.returncode, (err.strip().splitlines() or [""])[-1]))
        except subprocess.TimeoutExpired:
            out.append(("timeout", f"still running after {RANK_TIMEOUT_S} s"))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", type=int, default=200)
    ap.add_argument("--at-once", type=int, default=4)
    ap.add_argument("--mode", choices=("both", "bare", "shutdown"), default="both")
    ap.add_argument("--extra", type=int, default=1, help="sums over db in data shard 1 only")
    ap.add_argument("--rank", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        spec = json.loads(args.rank)
        return rank(spec["coord"], spec["rank"], spec["leave"], spec["extra"])
    sys.path.insert(0, ROOT)
    for mode, leave in (("bare", False), ("shutdown", True)):
        if args.mode not in ("both", mode):
            continue
        with ThreadPoolExecutor(args.at_once) as ex:
            runs = list(ex.map(lambda _: grid(leave, args.extra), range(args.grids)))
        bad = [[r for r in run if r[0] != 0] for run in runs]
        bad = [b for b in bad if b]
        print(json.dumps({"mode": mode, "grids": args.grids, "at_once": args.at_once,
                          "extra": args.extra,
                          "grids_with_a_failed_rank": len(bad), "failures": bad[:10]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
