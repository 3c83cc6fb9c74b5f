#!/usr/bin/env python3
"""probe.cu in two checkouts, on one card, in turns: the gate's windows and the every-window call.

    python3 tools/probe_ab.py BEFORE_DIR AFTER_DIR [--pairs N] [--nb1-log2 23]

Each arm is a fresh process that imports one checkout's
``kmer_id_tpu_torch`` (and builds its kernels), makes the same tables and
windows on the card from one seed (an L1 table of 2^nb1-log2 buckets, 2^23
by default as at 33M probes, and an L2 of 2^18, every fingerprint half
filled, every rec row's tin a node, 2M keys planted with their rec rows),
and times by CUDA-graph replay
(the checkout's ``chip_smoke.device_ms``):

* the gate's <= 32 windows as the engine passes them: ``probe_verify_cuda`` at nx
  [8192x12]/32 and the lane's [2048x12]/8 (rows of 0-12 windows, half of
  them DB keys), ``probe_hits_cuda`` at [8192x24]/8 on db rank 0 of 2;
* the every-window call from extract output (every window valid but 2%, 3%
  of them DB keys) to the per-read result, at nx [8192x131]/32, the lane's
  [2048x483]/8 and m3/jobs [2048x483]/32, and to the narrow hit plane on db
  rank 0 of 2 at [8192x131]/8: through ``probe_verify_dense_cuda`` /
  ``probe_hits_dense_cuda`` where the checkout has them, and in every
  checkout through the chain they replace (``fp_candidates``, the
  interleave, ``compact.cu``, the plain verify and summary; in shard mode
  ``probe_hits_plain`` with ``compact.cu``), both held equal;
* where the checkout has the every-window kernel, its C entry
  (``kmer_probe``) at 1 and 2 tiles per step at those shapes.

Runs the arms in the order before, after, after, before, ``--pairs`` times
over; prints one JSON line per arm, then one per measurement with each
side's median, with the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from engine_ab import card_line, load_smoke

SEED = 20261017
NB2_LOG2 = 18
PLANTED = 2_000_000
N_NODES = 6000
NARROW = (("nx", 8192, 12, 32), ("lane", 2048, 12, 8))
EVERY = (("nx", 8192, 131, 32), ("lane", 2048, 483, 8), ("m3", 2048, 483, 32))


def tables(nb1_log2: int, device):
    """(db, shard db of rank 0 of 2, planted key words): random full
    fingerprint tables with PLANTED keys' fingerprints and rec rows written
    in (each at the first half of its L1 bucket)."""
    import torch

    from kmer_id_tpu_torch.ops.lookup import fp_hashes

    g = torch.Generator(device=device).manual_seed(SEED)
    nb1, nb2 = 1 << nb1_log2, 1 << NB2_LOG2

    def rand(*shape):
        return torch.randint(-(2**31), 2**31 - 1, shape, generator=g, device=device,
                             dtype=torch.int32)

    db = {"fptab": rand(nb1, 4) | 0x00010001, "fptab2": rand(nb2, 4) | 0x00010001,
          "rec": rand((nb1 + nb2) * 8, 3), "tinfo": torch.randint(
              0, N_NODES, (N_NODES, 2), generator=g, device=device, dtype=torch.int32)}
    db["tinfo"][:, 1] = torch.arange(N_NODES, device=device, dtype=torch.int32)
    # every rec row's tin names a node, as a built DB's does
    db["rec"][:, 2] = torch.randint(0, N_NODES, (db["rec"].shape[0],), generator=g,
                                    device=device, dtype=torch.int32) | 1 << 24
    for i, s in enumerate((0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1)):
        db[f"fp_s{i + 1}"] = s
    hi = rand(PLANTED) & 0x0FFFFFFF
    lo = rand(PLANTED)
    b1, _, fp = fp_hashes(hi, lo, nb1, db["fp_s1"], db["fp_s2"], db["fp_s3"])
    b1 = b1.long()
    db["fptab"][b1, 0] = (db["fptab"][b1, 0] & -65536) | fp.to(torch.int32)
    tin = torch.randint(0, N_NODES, (PLANTED,), generator=g, device=device, dtype=torch.int32)
    db["rec"][b1 * 8] = torch.stack([hi, lo, tin | (tin & 3) << 24], dim=1)
    half = nb1 // 2
    shard = {**db, "fptab": db["fptab"][:half].contiguous(), "nb1": nb1,
             "rec": torch.cat([db["rec"][: half * 8], db["rec"][nb1 * 8:]])}
    return db, shard, hi, lo


def every_window(g, keys_hi, keys_lo, b, p, device):
    """Extract-mode planes: every window valid but 2%, 3% DB keys."""
    import torch

    hi = torch.randint(0, 2**28, (b, p), generator=g, device=device, dtype=torch.int32)
    lo = torch.randint(-(2**31), 2**31 - 1, (b, p), generator=g, device=device,
                       dtype=torch.int32)
    hit = torch.rand((b, p), generator=g, device=device) < 0.03
    pick = torch.randint(0, len(keys_hi), (b, p), generator=g, device=device)
    hi = torch.where(hit, keys_hi[pick], hi)
    lo = torch.where(hit, keys_lo[pick], lo)
    return hi, lo, torch.rand((b, p), generator=g, device=device) >= 0.02


def narrow_windows(g, keys_hi, keys_lo, b, k, device):
    """The gate's output: 0-k windows per read, half of them DB keys."""
    import torch

    from kmer_id_tpu_torch.ops.compact import SENT

    hi, lo, valid = every_window(g, keys_hi, keys_lo, b, k, device)
    hit = torch.rand((b, k), generator=g, device=device) < 0.5
    pick = torch.randint(0, len(keys_hi), (b, k), generator=g, device=device)
    hi, lo = torch.where(hit, keys_hi[pick], hi), torch.where(hit, keys_lo[pick], lo)
    n = torch.randint(0, k + 1, (b, 1), generator=g, device=device)
    pos = torch.arange(k, device=device, dtype=torch.int32)[None] * 10
    live = torch.arange(k, device=device)[None] < n
    return torch.where(live, pos, SENT), torch.where(live, hi, 0), torch.where(live, lo, 0)


def arm(checkout: str, nb1_log2: int) -> dict:
    sys.path.insert(0, checkout)
    import torch

    import kmer_id_tpu_torch.ops.probe as probe
    from kmer_id_tpu_torch.kernels.build import load_probe
    from kmer_id_tpu_torch.ops.compact import SENT, compact_ranks_cuda, interleave_planes
    from kmer_id_tpu_torch.ops.lookup import fp_candidates

    device_ms = load_smoke(checkout).device_ms
    dev = torch.device("cuda")
    db, sdb, keys_hi, keys_lo = tables(nb1_log2, dev)
    n_slots = db["rec"].shape[0]
    seen = torch.zeros(n_slots + 1, dtype=torch.int8, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {}
    for name, b, k, mh in NARROW:
        w = narrow_windows(g, keys_hi, keys_lo, b, k, dev)
        out[f"probe_verify {name} [{b}x{k}]/{mh}"] = device_ms(
            lambda: probe.probe_verify_cuda(db, *w, mh, seen))
    w = narrow_windows(g, keys_hi, keys_lo, 8192, 24, dev)
    out["probe_hits db0/2 [8192x24]/8"] = device_ms(
        lambda: probe.probe_hits_cuda(sdb, *w, 8, 0, sdb["fptab"].shape[0], True, seen))

    def chain(hi, lo, valid, mh):
        ci, vi = interleave_planes(fp_candidates(db, hi, lo, valid))
        pos = torch.arange(hi.shape[1], device=dev, dtype=torch.int32)[None]
        res = probe.cv_tier(db, hi, lo, ci, vi, pos, mh, mh, seen, compact_ranks_cuda)
        return probe.verify_summary(res, vi.sum(dim=1, dtype=torch.int32), mh)

    dense = hasattr(probe, "probe_verify_dense_cuda")
    for name, b, p, mh in EVERY:
        hi, lo, valid = every_window(g, keys_hi, keys_lo, b, p, dev)
        key = f"every-window {name} [{b}x{p}]/{mh}"
        out[f"{key} chain"] = device_ms(lambda: chain(hi, lo, valid, mh))
        if not dense:
            continue
        got = probe.probe_verify_dense_cuda(db, hi, lo, valid, mh)
        want = chain(hi, lo, valid, mh)
        ver = want["ver"]
        for f in want:
            g_, w_ = got[f], want[f]
            if f in ("tin", "tout", "depth"):
                g_, w_ = torch.where(ver, g_, 0), torch.where(ver, w_, 0)
            if not torch.equal(g_, w_):
                raise AssertionError(f"{key}: kernel != chain at {f}")
        out[f"{key} kernel"] = device_ms(
            lambda: probe.probe_verify_dense_cuda(db, hi, lo, valid, mh, seen))
        lib = load_probe()
        outs = probe._verify_outputs(b, mh, dev)
        nb1 = db["fptab"].shape[0]
        targs = probe._table_args(db, nb1, db["fptab2"].shape[0], 0, nb1, True)
        for unroll in (1, 2):
            def call(unroll=unroll):
                err = lib.kmer_probe(
                    probe.ptr(hi), probe.ptr(lo), probe.ptr(valid), None, b, p, *targs,
                    probe.ptr(db["tinfo"]), db["tinfo"].shape[0], probe.ptr(seen), mh, unroll, 0,
                    *(probe.ptr(outs[n]) for n in probe.PROBE_OUTPUTS), None, None, None, None,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"kmer_probe: cudaError {err}")
            out[f"{key} kernel unroll {unroll}"] = device_ms(call)

    hi, lo, valid = every_window(g, keys_hi, keys_lo, 8192, 131, dev)
    nbloc = sdb["fptab"].shape[0]
    iota = torch.arange(131, device=dev, dtype=torch.int32)[None]
    wpos = torch.where(valid, iota, SENT)
    key = "every-window shard db0/2 [8192x131]/8"
    out[f"{key} chain"] = device_ms(lambda: probe.probe_hits_plain(
        sdb, wpos, hi, lo, 8, 0, nbloc, True, seen, compact=compact_ranks_cuda))
    if dense:
        got = probe.probe_hits_dense_cuda(sdb, hi, lo, valid, 8, 0, nbloc, True)
        want = probe.probe_hits_plain(sdb, wpos, hi, lo, 8, 0, nbloc, True,
                                      compact=compact_ranks_cuda)
        for f in want:
            if not torch.equal(got[f], want[f]):
                raise AssertionError(f"{key}: kernel != chain at {f}")
        out[f"{key} kernel"] = device_ms(
            lambda: probe.probe_hits_dense_cuda(sdb, hi, lo, valid, 8, 0, nbloc, True, seen))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", nargs="?")
    ap.add_argument("after", nargs="?")
    ap.add_argument("--pairs", type=int, default=1, help="rounds of before, after, after, before")
    ap.add_argument("--nb1-log2", type=int, default=23, help="L1 table of 2^N buckets")
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.arm:
        print("ARM " + json.dumps(arm(os.path.abspath(args.arm), args.nb1_log2)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    runs = {"before": [], "after": []}
    for side in ("before", "after", "after", "before") * args.pairs:
        d = os.path.abspath(getattr(args, side))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--arm", d,
                              "--nb1-log2", str(args.nb1_log2)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"arm {side} ({d}) exited {out.returncode}")
        res = json.loads(next(line[4:] for line in out.stdout.splitlines()
                              if line.startswith("ARM ")))
        runs[side].append(res)
        print(json.dumps({"arm": side, "checkout": d, "card": card, "ms": res}), flush=True)
    for name in runs["after"][0]:
        med = {side: (float(np.median([r[name] for r in rs])) if name in rs[0] else None)
               for side, rs in runs.items()}
        print(json.dumps({"measure": name, "card": card, "before_ms": med["before"],
                          "after_ms": med["after"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
