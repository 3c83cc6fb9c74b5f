#!/usr/bin/env python3
"""The port's rank-compaction kernel (csrc/compact.cu) in two checkouts, on one card, in turns.

    python3 tools/compact_ab.py BEFORE_DIR AFTER_DIR [--pairs N]

Runs each checkout's own ``chip_smoke.kernel_phase`` in a fresh process
(which imports that checkout's ``kmer_id_tpu_torch``, builds its
``compact.cu`` and holds it bit for bit against its plain version at every
KERNEL_SHAPES row and density), in the order before, after, after, before,
``--pairs`` times over.  Each arm's device ms (CUDA-graph replay) at density
0.03 is what that checkout's kernel phase measures: the kernel as its
callers call it, with whatever payload copies its wrapper makes.  Prints
one JSON line per arm, then one per shape with the median of each side,
with the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from engine_ab import card_line, load_smoke


def arm(checkout: str) -> dict:
    sys.path.insert(0, checkout)
    times = load_smoke(checkout).kernel_phase("cuda")["times"]
    return {name: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2]} for name, t in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", nargs="?")
    ap.add_argument("after", nargs="?")
    ap.add_argument("--pairs", type=int, default=1, help="rounds of before, after, after, before")
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.arm:
        print("ARM " + json.dumps(arm(os.path.abspath(args.arm))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("compact_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    runs = {"before": [], "after": []}
    for side in ("before", "after", "after", "before") * args.pairs:
        d = os.path.abspath(getattr(args, side))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--arm", d],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"arm {side} ({d}) exited {out.returncode}")
        res = json.loads(next(line[4:] for line in out.stdout.splitlines()
                              if line.startswith("ARM ")))
        runs[side].append(res)
        print(json.dumps({"arm": side, "checkout": d, "card": card, "shapes": res}), flush=True)
    for name in runs["after"][0]:
        med = {side: float(np.median([r[name]["ms"] for r in rs if name in r]))
               for side, rs in runs.items()}
        print(json.dumps({"shape": name, "card": card, "before_ms": med["before"],
                          "after_ms": med["after"],
                          "bound_ms": runs["after"][0][name]["bound_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
