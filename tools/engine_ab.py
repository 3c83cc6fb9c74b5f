#!/usr/bin/env python3
"""The PyTorch port's classify-nx engine in two checkouts, on one card, in turns.

    python3 tools/engine_ab.py BEFORE_DIR AFTER_DIR [--probes N] [--reads N] [--pairs N]

Makes chip_smoke.py's classify-nx DB (random canonical probes on 5,982
targets, from its seed), one paired sample and a FASTA job of 2-50 kb
contigs (a planted probe about every 5 kb) once, with the functions of
AFTER_DIR's chip_smoke.py, into ``build/engine_ab/`` of this checkout.  Then
runs each checkout in a fresh process, in the order before, after, after,
before, ``--pairs`` times over (one by default).  Each process imports that checkout's ``kmer_id_tpu_torch`` and
calls that checkout's own ``chip_smoke.profile_phase`` (8 batches of
8192 x 160 under torch.profiler), and counts the device launches per batch
from the profiler window that phase opens.  It then runs that checkout's
``classify-nx`` CLI on the sample, then the long-read lane: that
checkout's ``process_long_many`` on the decoded contigs (groups of 2048 x
512, after a warm-up call), and last the batch shipping alone: that
checkout's ``ReadPlanes.from_batch`` of one decoded nx batch, 200 calls to
one synchronize.  Prints one JSON line per arm: engine wall ms/batch,
device busy ms/batch, device launches per batch, end-to-end reads/s, the
lane's Mbase/s and ms per shipped batch, with the card's name and power
limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "engine_ab")


def load_smoke(checkout: str):
    """``chip_smoke.py`` of a checkout, as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{abs(hash(checkout))}", os.path.join(checkout, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_world(after: str, n_probes: int, n_reads: int, lane_mbase: int) -> None:
    cs = load_smoke(after)
    sys.path.insert(0, after)
    rng = np.random.default_rng(cs.SEED)
    shutil.rmtree(WORK, ignore_errors=True)
    fq = os.path.join(WORK, "fastq")
    os.makedirs(fq)
    t0 = time.perf_counter()
    keys, _, _ = cs.make_db(rng, n_probes, cs.NUM_TARG, os.path.join(WORK, "db"),
                            os.path.join(WORK, "cache"))
    sel = rng.choice(len(keys), size=min(100_000, len(keys)), replace=False)
    plant = np.concatenate([cs._key_chars(keys[sel]), cs._key_chars(cs._revcomp(keys[sel]))])
    for mate, tag in (("R1", "a"), ("R2", "b")):
        cs.write_reads(rng, os.path.join(fq, f"s_{mate}_tr.fastq.gz"), n_reads, plant, tag)
    seqs, total = [], 0
    while total < lane_mbase * 1_000_000:
        n = int(rng.integers(2000, 50_001))
        seqs.append(cs.contig(rng, n, plant, n // 5000))
        total += n
    cs.write_fasta(os.path.join(WORK, "lane.fasta"), seqs, "t")
    print(f"world: {len(keys)} probes, sample of {2 * n_reads} reads, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def arm(checkout: str) -> dict:
    """This process's measurement of one checkout (see module doc)."""
    sys.path.insert(0, checkout)
    import torch
    import torch.profiler

    from kmer_id_tpu_torch import cli

    windows = []

    class Recorded(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            windows.append(self)
            return out

    torch.profiler.profile = Recorded
    cs = load_smoke(checkout)
    db_dir, cache = os.path.join(WORK, "db"), os.path.join(WORK, "cache")
    fq = os.path.join(WORK, "fastq")
    n_batches = 8
    prof = cs.profile_phase("cuda", db_dir, cache, os.path.join(fq, "s_R1_tr.fastq.gz"),
                            cs.BATCH, cs.MAX_LEN, n_batches=n_batches)
    dev = [e for e in windows[-1].key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    metrics = os.path.join(WORK, f"metrics_{os.getpid()}.jsonl")
    rc = cli.main(["classify-nx", fq, "--db-dir", db_dir, "--cache-dir", cache,
                   "--num-targ", str(cs.NUM_TARG), "--batch-size", str(cs.BATCH),
                   "--max-len", str(cs.MAX_LEN), "--device", "cuda", "--metrics", metrics])
    if rc != 0:
        raise SystemExit(f"classify-nx exited {rc} in {checkout}")
    with open(metrics) as f:
        m = json.loads(f.readline())
    return {"checkout": checkout, "wall_ms_per_batch": prof["wall_ms_per_batch"],
            "busy_ms_per_batch": prof["busy_ms_per_batch"],
            "launches_per_batch": sum(e.count for e in dev) / n_batches,
            "reads": m["reads"], "reads_per_s": m["reads_per_s"],
            "lane_mbase_per_s": lane(cs, db_dir, cache),
            "ship_ms_per_batch": ship(cs, os.path.join(fq, "s_R1_tr.fastq.gz"))}


def ship(cs, fastq: str, calls: int = 200) -> float:
    """ms per ``ReadPlanes.from_batch`` of one nx batch to the card, this
    checkout's (host work and the copies, to one synchronize)."""
    import itertools

    import torch

    from kmer_id_tpu_torch.io.batch import ReadBatcher
    from kmer_id_tpu_torch.io.fastx import iter_fastq_gz
    from kmer_id_tpu_torch.ops.gate import ReadPlanes

    rb = ReadBatcher(cs.BATCH, cs.MAX_LEN, u_is_t=False)
    recs = itertools.islice(iter_fastq_gz(fastq), cs.BATCH)
    batch = ([it for rec in recs for it in rb.add(*rec)] + list(rb.flush()))[0]
    dev = torch.device("cuda")
    for _ in range(20):
        ReadPlanes.from_batch(batch, dev, cs.MAX_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        ReadPlanes.from_batch(batch, dev, cs.MAX_LEN)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def lane(cs, db_dir: str, cache: str) -> float:
    """Mbase/s of this checkout's process_long_many on the decoded contigs
    of ``lane.fasta`` (the second of two calls)."""
    import torch

    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.core.codec import CODE_LUT_U
    from kmer_id_tpu_torch.engine.pipeline import load_db, make_classifier
    from kmer_id_tpu_torch.io.batch import LongRead
    from kmer_id_tpu_torch.io.fastx import iter_fasta_plain

    db = load_db(os.path.join(db_dir, "bData10.txt"), os.path.join(db_dir, "btree_10.txt"),
                 os.path.join(db_dir, "probes10.txt.gz"), num_targ=cs.NUM_TARG, cache_dir=cache)
    cfg = ClassifyConfig.preset("vf6", batch_size=cs.JOB_BATCH, max_len=cs.JOB_MAX_LEN)
    clf = make_classifier(db, cfg, cache_dir=cache, device="cuda")
    items = [LongRead(meta=None, codes=CODE_LUT_U[np.frombuffer(seq.encode(), np.uint8)])
             for _, seq, _ in iter_fasta_plain(os.path.join(WORK, "lane.fasta"))]
    bases = sum(len(it.codes) for it in items)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.process_long_many(clf.new_seen(), items)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return bases / 1e6 / secs


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", nargs="?")
    ap.add_argument("after", nargs="?")
    ap.add_argument("--probes", type=int, default=33_000_000)
    ap.add_argument("--reads", type=int, default=250_000, help="reads per mate file")
    ap.add_argument("--pairs", type=int, default=1, help="rounds of before, after, after, before")
    ap.add_argument("--lane-mbase", type=int, default=20, help="Mbase of contigs for the lane")
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.arm:
        print("ARM " + json.dumps(arm(os.path.abspath(args.arm))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device", file=sys.stderr)
        return 1
    before, after = (os.path.abspath(d) for d in (args.before, args.after))
    card = card_line()
    make_world(after, args.probes, args.reads, args.lane_mbase)
    for name, d in (("before", before), ("after", after), ("after", after),
                    ("before", before)) * args.pairs:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--arm", d],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.split("ARM ", 1)[1].splitlines()[0])
        print(json.dumps({"arm": name, "card": card, **res}), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
