#!/usr/bin/env python3
"""classify-nx through the port's CLI on grids of cards, against one card.

    python3 tools/grid_cards.py [--probes N] [--reads N] [--ranks N] [--device cuda|cpu]

Makes chip_smoke.py's classify-nx DB (random canonical probes on 5,982
targets, from its seed) and one paired sample of ``--reads`` reads into
``build/grid_cards/``, runs ``python -m kmer_id_tpu_torch.cli classify-nx``
(batch 8192, max_len 160) on one device, then with ``--mesh-data D
--mesh-db K`` for every grid of D x K = ``--ranks`` ranks (the command
starts one rank per card, NCCL between them), and with ``--engine legacy``
on the 1 x N grid.  Every run's ``_result.txt`` and ``_reads.txt`` must
equal the one-device run's.  Prints one JSON line per run (grid, engine,
reads/s of the sample from the run's metrics, the command's wall with its
set-up) and the card's name and power limit; exits 1 on a failed run or a
mismatch.  ``--ranks`` defaults to the card count and must be at least 2;
``--device cpu`` runs the same on CPU ranks over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "grid_cards")
RUN_TIMEOUT_S = 1200


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probes", type=int, default=2_000_000)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = args.ranks or cards
    if n < 2 or (args.device == "cuda" and cards < n):
        print(f"grid_cards: {n} ranks on {args.device} with {cards} cards: needs at least 2 "
              f"ranks and a card for each", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.card_line() if args.device == "cuda" else "cpu"
    rng = np.random.default_rng(cs.SEED)
    shutil.rmtree(WORK, ignore_errors=True)
    db_dir, cache, fq = (os.path.join(WORK, d) for d in ("db", "cache", "fastq"))
    os.makedirs(fq)
    t0 = time.perf_counter()
    keys, _, _ = cs.make_db(rng, args.probes, cs.NUM_TARG, db_dir, cache)
    sel = rng.choice(len(keys), size=min(100_000, len(keys)), replace=False)
    plant = np.concatenate([cs._key_chars(keys[sel]), cs._key_chars(cs._revcomp(keys[sel]))])
    for mate, tag in (("R1", "a"), ("R2", "b")):
        cs.write_reads(rng, os.path.join(fq, f"s_{mate}_tr.fastq.gz"), args.reads // 2, plant,
                       tag)
    print(f"grid_cards: {len(keys)} probes, {args.reads} reads made in "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)

    grids = [(d, n // d) for d in range(1, n + 1) if n % d == 0]
    runs = ([("one", [], "fp")]
            + [(f"{d}x{k}", ["--mesh-data", str(d), "--mesh-db", str(k)], "fp") for d, k in grids]
            + [(f"1x{n}", ["--mesh-db", str(n)], "legacy")])
    want, failed = None, 0
    for label, mesh, engine in runs:
        d = cs.sample_dir(WORK, f"{label}_{engine}", fq, ("s",))
        metrics = os.path.join(WORK, f"{label}_{engine}.jsonl")
        argv = ["classify-nx", d, "--db-dir", db_dir, "--cache-dir", cache, "--num-targ",
                str(cs.NUM_TARG), "--batch-size", str(cs.BATCH), "--max-len", str(cs.MAX_LEN),
                "--device", args.device, "--engine", engine, "--metrics", metrics] + mesh
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, "-m", "kmer_id_tpu_torch.cli", *argv], cwd=ROOT,
                            timeout=RUN_TIMEOUT_S).returncode
        wall = time.perf_counter() - t0
        got = cs.sample_outputs(d)
        if want is None:
            want = got
        equal = rc == 0 and len(got) == 2 and got == want
        failed += not equal
        m = {}
        if rc == 0:
            with open(metrics) as f:
                m = json.loads(f.readline())
        print(json.dumps({"grid": label, "engine": engine, "rc": rc, "files_equal": equal,
                          "reads": m.get("reads"), "reads_per_s": m.get("reads_per_s"),
                          "command_s": wall, "card": card}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
