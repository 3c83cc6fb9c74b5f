#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kmer_id_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the three kernels from csrc/ (one nvcc per source, started
together) and holds each against its plain PyTorch version: the window gate
(gate.cu, both modes, extract mode with and without its fstrand plane, both
input forms) at the row shapes of classify-nx, of the long-read lane and of
m3, and the rank compaction (compact.cu) at the shapes of classify-nx, of
the long-read lane, of m3's and jobs' short batches and of the legacy
engine's hit lists, bit for bit; probe + verify (probe.cu) at the window shapes and
budgets of classify-nx, of the long-read lane and of m3's and jobs' short
batches, on crafted copies of the nx DB's tables, bit for bit except where
nothing downstream reads (ops/probe.py).  Holds
the engine on the card against the engine on the CPU, for short batches and
for the long-read lane, on a toy world made with the port's own host
modules; then drives every classify path through the port's CLI:

* ``classify-nx`` against a 33M-probe fingerprint DB: a small sample checked
  against the reference simulator (tests/refsim.py), a 500,000-read sample
  timed (the probe + verify check runs on this DB's tables, after it);
* ``classify-jobs`` (vf6) against the same DB: 20,000 FASTQ.gz reads plus
  ~300 FASTA contigs and a 1.2-Mbase record, without and with ``-target``,
  checked against the simulator; then a ~50-Mbase contig job timed through
  ``run_vf6`` and through ``process_long_many`` alone;
* ``mitokmer`` (m3) against a 2M-probe text DB on 17,226 targets, with
  ``f2`` ``none`` and a FASTQ, checked against the simulator;
* the same three paths with ``--engine legacy`` (the cuckoo-table engine:
  gate.cu's extract mode, the cuckoo lookup, compact.cu's hit list),
  checked against the files the fingerprint engine wrote (themselves
  checked against the simulator), the nx big sample timed and profiled;
* the ``minalign > 0`` verify replay on a 400-kb genome world of 3,000
  reads: cuda against cpu at ``minalign`` 0 and 200, the legacy engine
  against the fingerprint engine at 0;
* the driver's overlap of host and device (engine/pipeline.py: submitter
  and collector threads on streams of their own): the nx small sample
  again through SampleProcessor with a delaying engine proxy at batches of
  1,024 (equal to the CLI run's files, which equal RefSim), and the
  500,000-read sample with its stages timed apart (decode alone; host
  submit and collect + account; device H2D, kernels and D2H) and the
  device's busy share over the whole sample's wall;
* ``build-db`` (host code) on a 3-Mbase genome set in RAM and with
  ``--spill`` (byte-equal files), its DB then classifying a sample through
  classify-jobs on the card, equal to RefSim.

Every phase that fails ends the run with a non-zero exit code, and so does
a path that did not go through its kernels: window_gate and probe_verify on
each fingerprint path (in the overlap runs window_gate exactly once per
batch, counted from the submitter thread); on each legacy run window_extract once per device run
(short-read batch, chunk group, replay) and compact_ranks once per
short-read batch.  Without a
CUDA device it exits 1 before doing anything.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
lines before it hold the card's ``name, power.limit`` and one JSON object
describing each kernel of the paths.  Scratch data goes to
``build/chip_smoke/`` and is removed at the end.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20261016
N_PROBES = 33_000_000  # the JAX package's benchmark DB size (bench.py)
NUM_TARG = 5982
READ_LEN = 150
BIG_READS = 250_000  # per mate file
SMALL_READS = 5_000
BATCH, MAX_LEN = 8192, 160
P = MAX_LEN - 30 + 1  # windows per row
JOB_BATCH, JOB_MAX_LEN = 2048, 512  # the vf6/m3 CLI defaults
LONG_P = JOB_MAX_LEN - 30 + 1  # windows per chunk row of the long-read lane
# (name, rows, columns, max_hits, position plane, extra payload planes).
# Position planes: "window" (column // 3, one row broadcast), "column" (the
# column, one row broadcast), "random" (per row).  The fingerprint engine
# launches compact.cu at the dense shapes only: the Bloom-gate call now runs
# inside gate.cu, the verify tiers inside probe.cu; their shapes stay held
# here.  The legacy engine launches it once per short-read batch, for the
# hit list of compact_hits (no extras).
KERNEL_SHAPES = (
    ("bloom_gate", BATCH, P, 12, "window", 2),
    ("fast_tier", BATCH, 36, 8, "random", 2),
    ("slow_tier", BATCH, 36, 32, "random", 2),
    ("dense_path", BATCH, 3 * P, 32, "window", 2),
    ("long_bloom_gate", JOB_BATCH, LONG_P, 12, "window", 2),
    ("long_verify_tier", JOB_BATCH, 36, 8, "random", 2),
    ("long_dense_path", JOB_BATCH, 3 * LONG_P, 8, "window", 2),
    ("job_dense_path", JOB_BATCH, 3 * LONG_P, 32, "window", 2),  # m3's and jobs' short batches
    ("legacy_nx", BATCH, P, 32, "column", 0),  # legacy engine: classify-nx batches
    ("legacy_job", JOB_BATCH, LONG_P, 32, "column", 0),  # jobs' and m3's short batches
)
MITO_TARG, MITO_PROBES = 17_226, 2_000_000  # targets of mitochondria_tree.txt
DENSITIES = (0.0, 0.003, 0.03, 1.0)
REPORT_DENSITY = 0.03


def say(msg: str) -> None:
    print(msg, flush=True)


KERNELS = ("window_gate", "window_extract", "probe_verify", "probe_hits", "compact_ranks")


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from kmer_id_tpu_torch.ops.compact import compact_ranks_cuda
    from kmer_id_tpu_torch.ops.gate import extract_cuda, window_gate_cuda
    from kmer_id_tpu_torch.ops.probe import probe_hits_cuda, probe_verify_cuda

    return dict(zip(KERNELS, (window_gate_cuda, extract_cuda, probe_verify_cuda,
                              probe_hits_cuda, compact_ranks_cuda)))


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches.reset()


def read_counts() -> dict:
    return {name: fn.launches.value for name, fn in _wrappers().items()}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel phase


def kernel_inputs(rng, b, c, density, pos_kind, device):
    """A [b, c] candidate plane laid out as three interleaved planes (so
    several planes of one window can be valid: cross-plane ties), int32
    candidates over the whole range, two extra planes with the high bit set
    in about half the words, the tie pattern of tests/test_compact.py in
    row 0, and the position plane of ``pos_kind`` (KERNEL_SHAPES)."""
    import torch

    cand = rng.integers(-(2**31), 2**31, size=(b, c), dtype=np.int64).astype(np.int32)
    valid = rng.random((b, c)) < density
    if c >= 12:
        valid[0, :12] = False
        valid[0, [3, 5, 10]] = True  # window 1 planes 0 and 2, window 3 plane 1
    ex = [rng.integers(0, 2**32, size=(b, c), dtype=np.uint64).astype(np.uint32)
          .view(np.int32) for _ in range(2)]
    if pos_kind == "window":
        pos = (np.arange(c, dtype=np.int32) // 3)[None, :]
    elif pos_kind == "column":
        pos = np.arange(c, dtype=np.int32)[None, :]
    else:
        pos = np.repeat(rng.integers(0, P, size=(b, c // 3), dtype=np.int32), 3, axis=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(cand), t(valid), t(pos), (t(ex[0]), t(ex[1]))


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def call_ms(fn, reps: int = 30) -> float:
    """Median milliseconds per call as the engine makes it (the wrapper's
    host work included): CUDA events around each of ``reps`` calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times))


def device_ms(fn, per_graph: int = 20, reps: int = 10) -> float:
    """Median device milliseconds per call: ``per_graph`` calls captured in
    one CUDA graph, replayed ``reps`` times, so no host work is timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z) / per_graph)
    return float(np.median(times))


def kernel_phase(device="cuda") -> dict:
    """Kernel vs plain version, bit for bit, at every main-path shape and
    density; returns the numbers for the kernels line."""
    import torch

    from kmer_id_tpu_torch.ops.compact import compact_ranks_cuda, compact_ranks_plain

    rng = np.random.default_rng(SEED)
    max_err = 0
    report = {}
    for name, b, c, mh, pos_kind, n_ex in KERNEL_SHAPES:
        for d in DENSITIES:
            cand, valid, pos, ex = kernel_inputs(rng, b, c, d, pos_kind, device)
            ex = ex[:n_ex]
            got = compact_ranks_cuda(cand, valid, pos, mh, extras=ex)
            want = compact_ranks_plain(cand, valid, pos, mh, extras=ex)
            torch.cuda.synchronize()
            for g, w, what in zip(got[:3] + got[3], want[:3] + want[3],
                                  ("pos", "cand", "ncand", "extra0", "extra1")[: 3 + n_ex]):
                err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
                max_err = max(max_err, err)
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"kernel != plain at {name} density {d}: {what} (max err {err})"
                    )

            def kern():
                return compact_ranks_cuda(cand, valid, pos, mh, extras=ex)

            def plain():
                return compact_ranks_plain(cand, valid, pos, mh, extras=ex)

            k_dev, p_dev = device_ms(kern), device_ms(plain)
            k_call, p_call = call_ms(kern), call_ms(plain)
            # the validity plane read once, the payloads (pos, cand, the
            # extras) only at the placed columns, the outputs written once
            placed = int(want[2].clamp(max=mh).sum())
            b_ms, b_by = bound(b * c + 4 * (2 + n_ex) * placed + b * mh * 4 * (2 + n_ex) + b * 4,
                               b * c)
            say(f"kernel {name} [{b}x{c}] mh={mh} density={d}: bit-equal; device "
                f"kernel {k_dev} ms, plain {p_dev} ms, bound {b_ms} ms ({b_by}); per call "
                f"kernel {k_call} ms, plain {p_call} ms")
            if d == REPORT_DENSITY:
                report[name] = (k_dev, p_dev, b_ms, b_by)
    return {"max_abs_err": max_err, "times": report}


# ------------------------------------------------------------ gate phase

# H100 SXM peaks from NVIDIA's data sheet: device memory, and 32-bit
# operations outside the tensor cores (its fp32 rate)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
GATE_OPS_PER_WINDOW = 80  # key, validity, two hashes, four bit tests, rank
BLOOM_BLOCKS = 1 << 22  # 67 MB of 16-byte blocks: the 33M-probe DB's filter
# (shape name, rows, row width, read lengths [lo, hi]); m3's rows are the
# mitokmer CLI's 2048 x 512 holding 100-300 bp reads
GATE_SHAPES = (
    ("nx", BATCH, MAX_LEN, (100, 151)),
    ("lane", JOB_BATCH, JOB_MAX_LEN, (JOB_MAX_LEN, JOB_MAX_LEN + 1)),
    ("m3", JOB_BATCH, JOB_MAX_LEN, (100, 301)),
)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") on one H100 for work
    that moves ``nbytes`` and does ``nops`` 32-bit operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gate_bloom(rng, blocks=BLOOM_BLOCKS):
    """A random block-Bloom table of ``blocks`` rows with a quarter of its
    bits set (a random window passes with probability 1/256, about the
    8-keys-per-block filter's rate), and two salts."""
    words = (rng.integers(0, 2**32, size=(blocks, 4), dtype=np.uint64)
             & rng.integers(0, 2**32, size=(blocks, 4), dtype=np.uint64))
    return words.astype(np.uint32), int(rng.integers(1, 2**32)), int(rng.integers(1, 2**32))


def gate_rows(rng, b, l, lens, bloom, s4, s5):
    """Read rows for the gate: random bases with N runs, invalid bases at
    both row ends, lengths below KSIZE and equal to the width, a planted
    probe in every third row, two probe-dense rows (every window's Bloom
    bits set: npass > 12) and two rows holding a palindromic 30-mer (its
    own reverse complement: the forward key equals the canonical one, and
    fstrand is False).  Sets the probes' bits in ``bloom``.  Returns
    (codes uint8 [b, l], lengths int32 [b])."""
    from kmer_id_tpu_torch.core.codec import KSIZE, canonical_kmers
    from kmer_id_tpu_torch.db.fpdb import bloom_hashes

    codes = rng.integers(0, 4, size=(b, l), dtype=np.uint8)
    lengths = rng.integers(lens[0], lens[1], size=b).astype(np.int32)
    lengths[:6] = (0, 5, KSIZE - 1, KSIZE, KSIZE + 1, l)
    lengths[6:10] = l
    # N runs and invalid read ends, few enough (<= ~650 bases) for the
    # packed form's exception list (EXC_CAP)
    for r in rng.choice(np.arange(12, b), size=min(b // 40, 12), replace=False):
        p = int(rng.integers(0, l))
        codes[r, p : p + int(rng.integers(1, 40))] = 4
    ends = rng.choice(np.arange(12, b), size=min(b // 100, 80), replace=False)
    codes[ends, np.maximum(lengths[ends] - 1, 0)] = 4  # last base of the read
    codes[ends, 0] = 4
    codes[8, l - 1] = 4  # rows as wide as the plane, invalid at the plane's end
    codes[9, [0, l - 1]] = 4
    keys = [canonical_kmers(codes[r])[0] for r in (6, 7)]  # probe-dense rows
    for r in range(12, b, 3):
        p = int(rng.integers(0, max(int(lengths[r]) - KSIZE, 1)))
        k = canonical_kmers(codes[r, p : p + KSIZE])[0]
        keys.append(k)
    keys = np.concatenate(keys)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    blk, bits = bloom_hashes(hi, lo, len(bloom), s4, s5)
    flat = bloom.reshape(-1)
    for bit in bits:
        np.bitwise_or.at(flat, blk * 4 + (bit >> 5), np.uint32(1) << (bit & 31).astype(np.uint32))
    for r in (10, 11):
        half = rng.integers(0, 4, size=KSIZE // 2, dtype=np.uint8)
        p = int(rng.integers(0, lengths[r] - KSIZE + 1))
        codes[r, p : p + KSIZE] = np.concatenate([half, 3 - half[::-1]])
    return codes, lengths


def gate_forms(rng, codes, lengths, device):
    """The rows as ReadPlanes in both input forms: packed words with the
    exception list in shuffled order, plus two entries the feeder never
    writes (a base past its row's length, and one past the plane, which
    lands on the last base); and the code plane, with invalid bases of
    values 4, 5 and 255."""
    import torch

    from kmer_id_tpu_torch.io.batch import pack_codes
    from kmer_id_tpu_torch.ops.gate import ReadPlanes

    b, l = codes.shape
    packed, exc = pack_codes(codes, lengths)
    if packed is None:
        raise AssertionError("gate rows hold more invalid bases than the exception list")
    pads = np.nonzero(exc < 0)[0]
    short = int(np.nonzero(lengths < l - 1)[0][0])
    exc[pads[:2]] = (short * l + l - 1, b * l + 7)
    rng.shuffle(exc)
    plane = codes.copy()
    bad = plane >= 4
    plane[bad] = rng.choice(np.array([4, 5, 255], np.uint8), size=int(bad.sum()))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lens = t(lengths)
    return {
        "packed": ReadPlanes(lens, l, packed=t(packed.view(np.int32)), exc=t(exc)),
        "codes": ReadPlanes(lens, l, codes=t(plane)),
    }


def gate_phase(device="cuda") -> dict:
    """csrc/gate.cu against its plain version, bit for bit, in both modes
    (extract mode with and without the fstrand plane) and both input forms
    at the nx, long-lane and m3 shapes; device times of the kernel and the
    plain version beside the bound.  Returns the numbers for the kernels
    line (nx shape, packed form)."""
    import torch

    from kmer_id_tpu_torch.ops.gate import (
        BLOOM_K,
        SHARD_BLOOM_K,
        extract_cuda,
        extract_plain,
        window_gate_cuda,
        window_gate_plain,
    )
    from kmer_id_tpu_torch.ops.words import u32_tensor

    rng = np.random.default_rng(SEED + 3)
    bloom_np, s4, s5 = gate_bloom(rng)
    max_err, report = 0, {}
    for name, b, l, lens in GATE_SHAPES:
        codes, lengths = gate_rows(rng, b, l, lens, bloom_np, s4, s5)
        db = {"bloom": u32_tensor(bloom_np, device), "fp_s4": s4, "fp_s5": s5}
        for form, reads in gate_forms(rng, codes, lengths, device).items():
            got_g = window_gate_cuda(db, reads)
            want_g = window_gate_plain(db, reads)
            got_x = extract_cuda(reads, fstrand=True)
            want_x = extract_plain(reads, fstrand=True)
            got_x3 = extract_cuda(reads)
            torch.cuda.synchronize()
            pairs = list(zip(("wpos", "whi", "wlo", "npass"), got_g, want_g))
            pairs += [(k, got_x[k], want_x[k]) for k in ("hi", "lo", "valid", "fstrand")]
            pairs += [(k + " (no fstrand)", got_x3[k], want_x[k]) for k in ("hi", "lo", "valid")]
            if "fstrand" in got_x3:
                raise AssertionError("extract_cuda wrote fstrand unasked")
            for what, g, w in pairs:
                err = int((g.long() - w.long()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(g, w):
                    raise AssertionError(f"gate.cu != plain at {name} {form}: {what} "
                                         f"(max err {err})")
            npass = want_g[3]
            valid = int(want_x["valid"].sum())
            if int(npass.max()) <= BLOOM_K or int((npass > 0).sum()) < b // 4:
                raise AssertionError(f"gate rows at {name}: no probe-dense or too few passing rows")
            fs = want_x["fstrand"] & want_x["valid"]
            if not (bool(fs.any()) and bool((want_x["valid"] & ~want_x["fstrand"]).any())):
                raise AssertionError(f"gate rows at {name}: fstrand all one way")
            out_bytes = b * (3 * BLOOM_K + 1) * 4
            in_bytes = lengths.nbytes + (
                reads.packed.numel() * 4 + reads.exc.numel() * 4 if form == "packed"
                else reads.codes.numel())
            p = l - 29
            g_bound = bound(in_bytes + 16 * valid + out_bytes, GATE_OPS_PER_WINDOW * b * p)
            x_bound = bound(in_bytes + b * p * 9, GATE_OPS_PER_WINDOW // 2 * b * p)
            xf_bound = bound(in_bytes + b * p * 10, GATE_OPS_PER_WINDOW // 2 * b * p)
            times = {
                "gate": (device_ms(lambda: window_gate_cuda(db, reads)),
                         device_ms(lambda: window_gate_plain(db, reads)), *g_bound),
                "extract": (device_ms(lambda: extract_cuda(reads)),
                            device_ms(lambda: extract_plain(reads)), *x_bound),
                "extract_fstrand": (device_ms(lambda: extract_cuda(reads, fstrand=True)),
                                    device_ms(lambda: extract_plain(reads, fstrand=True)),
                                    *xf_bound),
            }
            for mode, (k_ms, p_ms, b_ms, b_by) in times.items():
                say(f"gate.cu {mode} {name} [{b}x{l}] {form}: bit-equal ({valid} valid windows, "
                    f"npass max {int(npass.max())}, {int((npass > 0).sum())} rows passing); "
                    f"device kernel {k_ms} ms, plain {p_ms} ms, bound {b_ms} ms ({b_by})")
                report[(mode, name, form)] = (k_ms, p_ms, b_ms, b_by)

    # a rank of the sharded engine's grid: gate mode to SHARD_BLOOM_K windows
    # on one shard's filter (db = 2: half the nx DB's blocks), nx rows
    name, b, l, lens = GATE_SHAPES[0]
    k = SHARD_BLOOM_K
    sbloom, s4, s5 = gate_bloom(rng, BLOOM_BLOCKS // 2)
    codes, lengths = gate_rows(rng, b, l, lens, sbloom, s4, s5)
    db = {"bloom": u32_tensor(sbloom, device), "fp_s4": s4, "fp_s5": s5}
    for form, reads in gate_forms(rng, codes, lengths, device).items():
        got_g = window_gate_cuda(db, reads, k)
        want_g = window_gate_plain(db, reads, k)
        torch.cuda.synchronize()
        for what, g, w in zip(("wpos", "whi", "wlo", "npass"), got_g, want_g):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(g, w):
                raise AssertionError(f"gate.cu != plain at k={k} {name} {form}: {what} "
                                     f"(max err {err})")
        npass = want_g[3]
        if int(npass.max()) <= k or not bool(((npass > 0) & (npass <= k)).any()):
            raise AssertionError(f"gate rows at k={k}: no row past the budget or under it")
        valid = int(extract_plain(reads)["valid"].sum())
        in_bytes = lengths.nbytes + (
            reads.packed.numel() * 4 + reads.exc.numel() * 4 if form == "packed"
            else reads.codes.numel())
        b_ms, b_by = bound(in_bytes + 16 * valid + b * (3 * k + 1) * 4,
                           GATE_OPS_PER_WINDOW * b * (l - 29))
        k_ms = device_ms(lambda: window_gate_cuda(db, reads, k))
        p_ms = device_ms(lambda: window_gate_plain(db, reads, k))
        say(f"gate.cu gate k={k} {name} [{b}x{l}] {form}, shard filter of {len(sbloom)} "
            f"blocks: bit-equal (npass max {int(npass.max())}); device kernel {k_ms} ms, plain "
            f"{p_ms} ms, bound {b_ms} ms ({b_by})")
        report[("gate24", name, form)] = (k_ms, p_ms, b_ms, b_by)
    return {"max_abs_err": max_err, "times": report}


# ----------------------------------------------------------- probe phase

# (shape name, rows, max_hits): classify-nx's batches; the chunk groups of
# the long-read lane (vf6 and m3 alike) at its per-chunk budget LONG_HITS;
# the short batches of mitokmer and classify-jobs at the classifier's
# default budget
PROBE_SHAPES = (("nx", BATCH, 32), ("lane", JOB_BATCH, 8), ("m3", JOB_BATCH, 32))
PROBE_WORLDS = ("mixed", "empty", "saturated")
SHARD_RANKS = ((2, 0), (2, 1), (4, 3))  # (db axis, db rank) of the shard mode's checks
PROBE_OPS_PER_WINDOW = 120  # three hashes, 24 fingerprint compares, ranks, verify
PROBE_FIELDS = ("cand", "ver", "tin", "tout", "depth", "t", "nh", "deepest", "dtgt",
                "consistent", "overflow")
VER_MASKED = ("tin", "tout", "depth")  # compared where ver only
HIT_OUTPUTS = ("posk", "cand", "tgt", "tin", "td", "ver", "ncand")  # shard mode's


def probe_kinds(rng, b, world):
    """Row kinds of a probe world: 0 no passing window; 1 typical (1-4
    windows, about half of them DB keys, some planted in one plane, some
    with c1 == c2); 2 BLOOM_K DB keys; 3 BLOOM_K random keys (false passes);
    4 BLOOM_K keys each planted in its L1 bucket and both L2 buckets (36
    candidates: past 32, the overflow bit).  Worlds: "empty" (all 0),
    "typical" (0 and 1), "saturated" (2, and 4 in a row of four),
    "overflow" (all 4), "mixed" (every kind)."""
    if world == "empty":
        return np.zeros(b, np.int64)
    if world == "overflow":
        return np.full(b, 4)
    if world == "saturated":
        return rng.choice([2, 4], size=b, p=[0.75, 0.25])
    if world == "typical":
        return rng.choice(2, size=b, p=[0.4, 0.6])
    return rng.choice(5, size=b, p=[0.3, 0.45, 0.1, 0.1, 0.05])


def _key_words(key):
    return (key >> np.uint64(32)).astype(np.uint32), (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def probe_windows(rng, fpdb, keys, b, k, p, kinds):
    """Window-gate outputs for rows of ``kinds`` (:func:`probe_kinds`) against
    an FpDB and its sorted uint64 ``keys``: (wpos int32, whi, wlo uint32
    [b, k], numpy; ``SENT`` and 0 past a row's last window, positions
    ascending below ``p``) and the plants those rows need, for
    :func:`craft_tables`: {"hi", "lo", "planes" (bitmask: 1 L1, 2 L2 choice
    1, 4 L2 choice 2), "dup" (a second copy in the L1 bucket), "verify"
    (plane made to verify, -1 for none)}."""
    from kmer_id_tpu_torch.db.fpdb import fp_hashes
    from kmer_id_tpu_torch.ops.compact import SENT

    nb2 = len(fpdb.fptab2)

    def l2(hi, lo):
        return fp_hashes(hi, lo, nb2, fpdb.s4, fpdb.s5, fpdb.s3)[:2]

    n_win = np.where(kinds == 0, 0, np.where(kinds == 1, rng.integers(1, 5, size=b), k))
    rows, cols = np.nonzero(np.arange(k)[None, :] < n_win[:, None])
    kind, n = kinds[rows], len(rows)
    from_db = (kind == 2) | ((kind == 1) & (rng.random(n) < 0.5))
    key = np.where(from_db, keys[rng.integers(0, len(keys), size=n)],
                   rng.integers(0, 1 << 60, size=n, dtype=np.uint64))
    hi, lo = _key_words(key)
    while True:  # overflow windows need two distinct L2 buckets
        c1, c2 = l2(hi, lo)
        redo = np.nonzero((kind == 4) & (c1 == c2))[0]
        if not len(redo):
            break
        hi[redo], lo[redo] = _key_words(rng.integers(0, 1 << 60, size=len(redo), dtype=np.uint64))
    # typical random windows: a tenth take keys whose two L2 buckets agree
    # (the third plane is then never a candidate), planted in that bucket
    pool_hi, pool_lo = _key_words(rng.integers(0, 1 << 60, size=min(32 * nb2, 1 << 22),
                                               dtype=np.uint64))
    same = np.nonzero(np.equal(*l2(pool_hi, pool_lo)))[0]
    rand1 = np.nonzero((kind == 1) & ~from_db)[0]
    twin = rand1[rng.random(len(rand1)) < 0.1][: len(same)]
    hi[twin], lo[twin] = pool_hi[same[: len(twin)]], pool_lo[same[: len(twin)]]

    planes = np.zeros(n, np.int64)
    verify = np.full(n, -1, np.int64)
    one = rand1[~np.isin(rand1, twin) & (rng.random(len(rand1)) < 0.5)]
    planes[one] = 1 << rng.integers(0, 3, size=len(one))
    verify[one] = np.where(rng.random(len(one)) < 0.5, np.log2(planes[one]).astype(np.int64), -1)
    planes[twin] = 2
    verify[twin] = np.where(rng.random(len(twin)) < 0.5, 1, -1)
    over = np.nonzero(kind == 4)[0]
    planes[over] = 7
    verify[over] = np.where(rng.random(len(over)) < 0.7, rng.integers(0, 3, size=len(over)), -1)
    dup = np.zeros(n, bool)
    dup[over] = rng.random(len(over)) < 0.3

    pos = np.sort(np.argsort(rng.random((b, p)), axis=1)[:, :k], axis=1).astype(np.int32)
    wpos = np.full((b, k), SENT, np.int32)
    whi, wlo = np.zeros((b, k), np.uint32), np.zeros((b, k), np.uint32)
    wpos[rows, cols] = pos[rows, cols]
    whi[rows, cols], wlo[rows, cols] = hi, lo
    sel = planes > 0
    plants = {"hi": hi[sel], "lo": lo[sel], "planes": planes[sel], "dup": dup[sel],
              "verify": verify[sel]}
    return wpos, whi, wlo, plants


def craft_tables(rng, fpdb, n_nodes, plants):
    """Copies of ``fpdb``'s fptab, fptab2 and rec with ``plants`` written in
    (:func:`probe_windows`): each key's fingerprint in a free half of every
    bucket its bitmask names (another half of its L1 bucket too for a
    duplicate; halves taken by an earlier plant are not reused, so every
    plant holds), then, for a verify plane, the rec row of that bucket's
    first matching slot set to the key with a random tin below ``n_nodes``
    and a depth of 0-3 (ties for the deepest hit)."""
    from kmer_id_tpu_torch.db.fpdb import fp_hashes

    tabs = [fpdb.fptab.copy(), fpdb.fptab2.copy()]
    rec = fpdb.rec.copy()
    nb1, nb2 = len(tabs[0]), len(tabs[1])
    hi, lo = plants["hi"], plants["lo"]
    b1, _, fp = fp_hashes(hi, lo, nb1, fpdb.s1, fpdb.s2, fpdb.s3)
    c1, c2, _ = fp_hashes(hi, lo, nb2, fpdb.s4, fpdb.s5, fpdb.s3)
    where = ((0, b1), (1, c1), (1, c2))  # (table, bucket) of each plane
    used = set()
    start = rng.integers(0, 8, size=len(hi)).tolist()

    def put(t, bucket, f, h0):
        for j in range(8):
            h = (h0 + j) & 7
            if (t, bucket, h) not in used:
                used.add((t, bucket, h))
                word, sh = h & 3, 16 * (h >> 2)
                tabs[t][bucket, word] = ((int(tabs[t][bucket, word]) & ~(0xFFFF << sh))
                                         | (f << sh))
                return

    bucket_lists = [w[1].tolist() for w in where]
    for i, (mask, d, f) in enumerate(zip(plants["planes"].tolist(), plants["dup"].tolist(),
                                         fp.tolist())):
        for q in range(3):
            if mask >> q & 1:
                put(where[q][0], bucket_lists[q][i], f, start[i])
        if d:
            put(0, bucket_lists[0][i], f, start[i] + 3)
    ver = np.nonzero(plants["verify"] >= 0)[0]
    for i in ver.tolist():
        t, buckets = where[plants["verify"][i]]
        row = tabs[t][buckets[i]]
        h = int(np.argmax(np.concatenate([row & 0xFFFF, row >> 16]) == fp[i]))
        slot = t * nb1 * 8 + int(buckets[i]) * 8 + h
        rec[slot] = (hi[i], lo[i], int(rng.integers(0, n_nodes)) | int(rng.integers(0, 4)) << 24)
    return {"fptab": tabs[0], "fptab2": tabs[1], "rec": rec}


def probe_tables(fpdb, crafted, tinfo, device) -> dict:
    """The engine's probe tables on ``device`` from crafted copies."""
    import torch

    from kmer_id_tpu_torch.ops.words import u32_tensor

    db = {k: u32_tensor(v, device) for k, v in crafted.items()}
    db["tinfo"] = torch.from_numpy(tinfo).to(device)
    for i, s in enumerate((fpdb.s1, fpdb.s2, fpdb.s3, fpdb.s4, fpdb.s5)):
        db[f"fp_s{i + 1}"] = int(s)
    return db


def shard_cut(crafted, dbp: int, k: int) -> dict:
    """Db rank ``k`` of ``dbp``'s part of crafted tables, as
    parallel/fpsharded.py ``shard_tables`` lays it out: its L1 block of
    fptab, the whole fptab2, and its local rec (its L1 rows, then every L2
    row)."""
    nb1 = len(crafted["fptab"])
    nbloc = nb1 // dbp
    rec = crafted["rec"]
    return {"fptab": crafted["fptab"][k * nbloc : (k + 1) * nbloc],
            "fptab2": crafted["fptab2"],
            "rec": np.concatenate([rec[k * nbloc * 8 : (k + 1) * nbloc * 8], rec[nb1 * 8 :]])}


def shard_probe_tables(fpdb, crafted, tinfo, dbp: int, k: int, device) -> dict:
    """Db rank ``k`` of ``dbp``'s probe tables on ``device`` (:func:`shard_cut`
    of crafted copies, with ``nb1``, the global L1 bucket count)."""
    db = probe_tables(fpdb, shard_cut(crafted, dbp, k), tinfo, device)
    db["nb1"] = len(crafted["fptab"])
    return db


def probe_mismatch(got: dict, want: dict, n_slots: int, seen=None) -> tuple[list, int]:
    """(names of the outputs that differ, max abs error) between two probe +
    verify results: every output bit for bit, tin/tout/depth only where
    ``ver``, and ``seen`` (a pair of tensors) over the slot ids."""
    import torch

    ver = want["ver"]
    bad, err = [], 0
    pairs = [(k, got[k], want[k]) for k in PROBE_FIELDS]
    if seen is not None:
        pairs.append(("seen", seen[0][:n_slots], seen[1][:n_slots]))
    for k, g, w in pairs:
        if k in VER_MASKED:
            g, w = torch.where(ver, g, 0), torch.where(ver, w, 0)
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
        if g.shape != w.shape or not torch.equal(g, w):
            bad.append(k)
    return bad, err


def hits_mismatch(got: dict, want: dict, n_slots: int, seen=None) -> tuple[list, int]:
    """(names of the outputs that differ, max abs error) between two shard
    mode results (ops/probe.py ``probe_hits_*``): every output bit for bit,
    and ``seen`` (a pair of tensors) over the slot ids."""
    import torch

    bad, err = [], 0
    pairs = [(k, got[k], want[k]) for k in HIT_OUTPUTS]
    if seen is not None:
        pairs.append(("seen", seen[0][:n_slots], seen[1][:n_slots]))
    for k, g, w in pairs:
        if g.numel() and g.shape == w.shape:
            err = max(err, int((g.long() - w.long()).abs().max()))
        if g.shape != w.shape or not torch.equal(g.long(), w.long()):
            bad.append(k)
    return bad, err


def probe_plain_full_tier(db, wpos, whi, wlo, max_hits: int, seen) -> dict:
    """probe_verify_plain with its fast-tier host branch taken out: the
    full tier at ``max_hits`` always (the same outputs under the probe
    comparison's masking), so that a CUDA graph captures it and its time is
    a device time like the kernel's."""
    import torch

    from kmer_id_tpu_torch.ops.compact import SENT, compact_ranks_plain, interleave_planes
    from kmer_id_tpu_torch.ops.lookup import fp_candidates
    from kmer_id_tpu_torch.ops.probe import N_PLANES, cv_tier, verify_summary

    valid = wpos < SENT
    ci, vi = interleave_planes(fp_candidates(db, whi, wlo, valid))

    def rep(x):
        return x.repeat_interleave(N_PLANES, dim=1)

    res = cv_tier(db, rep(whi), rep(wlo), ci, vi, rep(torch.where(valid, wpos, 0)),
                  max_hits, max_hits, seen, compact_ranks_plain)
    return verify_summary(res, vi.sum(dim=1, dtype=torch.int32), max_hits)


def probe_phase(db, device="cuda") -> dict:
    """csrc/probe.cu against probe_verify_plain, on the nx phase's DB
    (33,000,000 probes built by build_fpdb) with crafted copies of its
    fingerprint tables and rec: at nx [8192x12] with max_hits 32, the
    long-read lane's [2048x12] with max_hits 8 and the m3 and jobs short
    batches' [2048x12] with max_hits 32, in the worlds mixed, empty and
    saturated (:func:`probe_kinds`).  Device times (CUDA graphs) of the
    kernel and of :func:`probe_plain_full_tier` beside the bound, and per
    call times (host work included) of the kernel and probe_verify_plain.
    Then the shard mode (probe_hits_cuda against probe_hits_plain, bit for
    bit, ``seen`` included) at nx [8192x24] with sh 8, for ranks 0 and 1 of
    db = 2 and rank 3 of db = 4 (SHARD_RANKS), in the same worlds, on the
    ranks' parts of the crafted tables, device times beside the bound.
    Returns the numbers for the kernels line."""
    import torch

    from kmer_id_tpu_torch.core.taxonomy import Taxonomy
    from kmer_id_tpu_torch.db.fpdb import build_tinfo, load_fpdb
    from kmer_id_tpu_torch.ops.compact import SENT, interleave_planes
    from kmer_id_tpu_torch.ops.gate import BLOOM_K, SHARD_BLOOM_K
    from kmer_id_tpu_torch.ops.lookup import fp_candidates, fp_hashes
    from kmer_id_tpu_torch.ops.probe import (
        probe_hits_cuda,
        probe_hits_plain,
        probe_verify_cuda,
        probe_verify_plain,
    )
    from kmer_id_tpu_torch.parallel.fpsharded import SHARD_HITS

    keys, _, parent, _, cache, _ = db
    rng = np.random.default_rng(SEED + 4)
    fp = load_fpdb(cache)
    tinfo = build_tinfo(Taxonomy(np.asarray(parent, np.int32)))
    t0 = time.perf_counter()
    worlds, shard_worlds, plants = {}, {}, []
    for shape, b, mh in PROBE_SHAPES:
        for world in PROBE_WORLDS:
            wpos, whi, wlo, pl = probe_windows(rng, fp, keys, b, BLOOM_K, P,
                                               probe_kinds(rng, b, world))
            worlds[(shape, world)] = (mh, wpos, whi, wlo)
            plants.append(pl)
    for world in PROBE_WORLDS:  # the shard mode's windows: the gate's 24 per read
        wpos, whi, wlo, pl = probe_windows(rng, fp, keys, BATCH, SHARD_BLOOM_K, P,
                                           probe_kinds(rng, BATCH, world))
        shard_worlds[world] = (wpos, whi, wlo)
        plants.append(pl)
    crafted = craft_tables(rng, fp, len(tinfo),
                           {k: np.concatenate([pl[k] for pl in plants]) for k in plants[0]})
    tdb = probe_tables(fp, crafted, tinfo, device)
    say(f"probe: {len(worlds)} window sets and tables crafted in {time.perf_counter() - t0:.1f} s")
    max_err, report = 0, {}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    for (shape, world), (mh, wpos, whi, wlo) in worlds.items():
        wp, wh, wl = t(wpos), t(whi.view(np.int32)), t(wlo.view(np.int32))
        seen_k, seen_p = (torch.zeros(fp.n_slots + 1, dtype=torch.int8, device=device)
                          for _ in range(2))
        got = probe_verify_cuda(tdb, wp, wh, wl, mh, seen_k)
        want = probe_verify_plain(tdb, wp, wh, wl, mh, seen_p)
        full = probe_plain_full_tier(tdb, wp, wh, wl, mh, seen_p)
        torch.cuda.synchronize()
        bad, err = probe_mismatch(got, want, fp.n_slots, (seen_k, seen_p))
        max_err = max(max_err, err)
        if bad:
            raise AssertionError(f"probe.cu != plain at {shape} {world}: {bad} (max err {err})")
        bad, _ = probe_mismatch(full, want, fp.n_slots)
        if bad:
            raise AssertionError(f"plain full tier != plain at {shape} {world}: {bad}")
        valid = wp < SENT
        ncand = interleave_planes(fp_candidates(tdb, wh, wl, valid))[1].sum(dim=1)
        n_valid, n_ver = int(valid.sum()), int(want["nh"].sum())
        placed = int(ncand.clamp(max=mh).sum())
        if world == "saturated" and not (int(ncand.max()) == 3 * BLOOM_K
                                         and bool(want["overflow"].any()) and n_ver > 0):
            raise AssertionError(f"probe world {shape} saturated: no row of 36 candidates")
        if world == "mixed" and not (bool(want["overflow"].any()) and n_ver > 0
                                     and not bool(want["consistent"].all())):
            raise AssertionError(f"probe world {shape} mixed: no overflow, hit or inconsistency")
        b = wp.shape[0]
        nbytes = (b * BLOOM_K * 12 + 48 * n_valid + 12 * placed + 9 * n_ver
                  + b * mh * 21 + b * 14)
        b_ms, b_by = bound(nbytes, PROBE_OPS_PER_WINDOW * n_valid)
        k_dev = device_ms(lambda: probe_verify_cuda(tdb, wp, wh, wl, mh, seen_k))
        p_dev = device_ms(lambda: probe_plain_full_tier(tdb, wp, wh, wl, mh, seen_p))
        k_call = call_ms(lambda: probe_verify_cuda(tdb, wp, wh, wl, mh, seen_k))
        p_call = call_ms(lambda: probe_verify_plain(tdb, wp, wh, wl, mh, seen_p))
        say(f"probe.cu {shape} {world} [{b}x{BLOOM_K}] mh={mh}: equal ({n_valid} windows, "
            f"{int(ncand.sum())} candidates, {placed} placed, {n_ver} verified, "
            f"{int(want['overflow'].sum())} overflow rows); device kernel {k_dev} ms, plain "
            f"full tier {p_dev} ms, bound {b_ms} ms ({b_by}); per call kernel {k_call} ms, "
            f"plain {p_call} ms")
        report[(shape, world)] = (k_dev, p_dev, b_ms, b_by, k_call, p_call)

    # shard mode (kmer_probe_hits): ranks 0 and 1 of db = 2 (rank 1 holds no
    # L2) and rank 3 of db = 4, on their parts of the same crafted tables
    del tdb
    sh = SHARD_HITS  # the engine's min(8, max_hits) at the default max_hits
    hits_err, hits_report = 0, {}
    for dbp, k in SHARD_RANKS:
        sdb = shard_probe_tables(fp, crafted, tinfo, dbp, k, device)
        nbloc = len(crafted["fptab"]) // dbp
        b0, own2 = k * nbloc, k == 0
        n_slots = (nbloc + len(crafted["fptab2"])) * 8
        for world, (wpos, whi, wlo) in shard_worlds.items():
            wp, wh, wl = t(wpos), t(whi.view(np.int32)), t(wlo.view(np.int32))
            seen_k, seen_p = (torch.zeros(n_slots + 1, dtype=torch.int8, device=device)
                              for _ in range(2))
            got = probe_hits_cuda(sdb, wp, wh, wl, sh, b0, nbloc, own2, seen_k)
            want = probe_hits_plain(sdb, wp, wh, wl, sh, b0, nbloc, own2, seen_p)
            torch.cuda.synchronize()
            bad, err = hits_mismatch(got, want, n_slots, (seen_k, seen_p))
            hits_err = max(hits_err, err)
            if bad:
                raise AssertionError(f"probe.cu shard mode != plain at db {k}/{dbp} {world}: "
                                     f"{bad} (max err {err})")
            valid = wp < SENT
            n_valid, n_ver = int(valid.sum()), int(want["ver"].sum())
            b1 = fp_hashes(wh, wl, sdb["nb1"], sdb["fp_s1"], sdb["fp_s2"], sdb["fp_s3"])[0]
            in_range = int((valid & (b1 >= b0) & (b1 < b0 + nbloc)).sum())
            ncand = want["ncand"]
            placed = int(ncand.clamp(max=sh).sum())
            if world != "empty" and not (n_ver > 0 and int(ncand.max()) > sh):
                raise AssertionError(f"shard world db {k}/{dbp} {world}: no hit or no row past "
                                     f"the budget")
            # windows read once; an L1 row per window in the rank's range, two
            # L2 rows per window on the rank owning L2; a rec row per placed
            # candidate, a tinfo row and a seen byte per verified hit; the
            # plane and the counts written once
            nbytes = (wp.numel() * 12 + 16 * in_range + (32 * n_valid if own2 else 0)
                      + 12 * placed + 9 * n_ver + wp.shape[0] * (sh * 21 + 4))
            b_ms, b_by = bound(nbytes, PROBE_OPS_PER_WINDOW * n_valid)
            k_dev = device_ms(lambda: probe_hits_cuda(sdb, wp, wh, wl, sh, b0, nbloc, own2, seen_k))
            p_dev = device_ms(lambda: probe_hits_plain(sdb, wp, wh, wl, sh, b0, nbloc, own2,
                                                       seen_p))
            say(f"probe.cu shard mode db {k}/{dbp} {world} [{BATCH}x{SHARD_BLOOM_K}] sh={sh}: "
                f"bit-equal ({n_valid} windows, {in_range} in range, {int(ncand.sum())} "
                f"candidates, {placed} placed, {n_ver} verified, {int((ncand > sh).sum())} rows "
                f"past the budget); device kernel {k_dev} ms, plain {p_dev} ms, bound {b_ms} ms "
                f"({b_by})")
            hits_report[(f"db{k}/{dbp}", world)] = (k_dev, p_dev, b_ms, b_by)
        del sdb
    return {"max_abs_err": max_err, "times": report, "hits_max_abs_err": hits_err,
            "hits_times": hits_report}


# ---------------------------------------------------------- engine phase


def toy_world(num_probes=4096, num_targ=64, batch=256, max_len=256, dense_rows=(),
              long_len=0):
    """A deterministic synthetic DB and read batch, made from the port's own
    host modules: the probes are every canonical 30-mer of one random
    genome, so a read copied from it has a probe at every window
    (``dense_rows`` get such reads: the dense path and the overflow
    replay); a third of the rows carry two planted probes, often of
    incomparable targets (the fold).  ``long_len`` > 0 also returns that
    many bases of the genome for the long-read lane.  Returns (packed DB,
    taxonomy, codes uint8 [batch, max_len], lengths int32 [batch], genome
    slice or None)."""
    from kmer_id_tpu_torch.core.codec import KSIZE, canonical_kmers
    from kmer_id_tpu_torch.core.taxonomy import Taxonomy
    from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes

    rng = np.random.default_rng(42)
    src = rng.integers(0, 4, size=num_probes + KSIZE, dtype=np.uint8)
    keys = np.unique(canonical_kmers(src)[0])
    n = len(keys)
    rec = ProbeRecords(keys=keys, target=rng.integers(2, num_targ, size=n).astype(np.int32),
                       org=np.zeros(n, np.int32), position=np.zeros(n, np.int32),
                       fstrand=np.ones(n, bool), count=np.ones(n, np.int32))
    packed = pack_probes(rec, num_targ=num_targ)
    parent = np.ones(num_targ, dtype=np.int32)
    for i in range(3, num_targ):
        parent[i] = int(rng.integers(1, i))
    codes = rng.integers(0, 4, size=(batch, max_len)).astype(np.uint8)
    starts = rng.integers(0, len(src) - KSIZE, size=batch)
    for r in range(0, batch, 3):
        pos = int(rng.integers(0, max_len - 2 * KSIZE))
        s, s2 = int(starts[r]), int(starts[(r + 7) % batch])
        codes[r, pos : pos + KSIZE] = src[s : s + KSIZE]
        codes[r, pos + KSIZE : pos + 2 * KSIZE] = src[s2 : s2 + KSIZE]
    for r in dense_rows:
        codes[r] = src[:max_len]
    lengths = rng.integers(31, max_len + 1, size=batch).astype(np.int32)
    lengths[list(dense_rows)] = max_len
    genome = src[:long_len].copy() if long_len else None
    return packed, Taxonomy(parent), codes, lengths, genome


def toy_batches(codes, lengths, dense_rows, num_probes):
    """The toy world's batch (dense path, overflow replay) and a copy with
    the dense rows replaced and two rows of 10 probe windows (Bloom path,
    slow tier)."""
    from kmer_id_tpu_torch.core.codec import KSIZE
    from kmer_id_tpu_torch.io.batch import Batch, pack_codes

    src = np.random.default_rng(42).integers(0, 4, size=num_probes + KSIZE, dtype=np.uint8)
    b, l = codes.shape
    mid, lmid = codes.copy(), lengths.copy()
    mid[list(dense_rows)] = np.random.default_rng(1).integers(
        0, 4, size=(len(dense_rows), l), dtype=np.uint8)
    for r, s in ((7, 100), (40, 3000)):
        mid[r, 20:59] = src[s : s + 39]
        lmid[r] = l
    out = []
    for c, ln in ((codes, lengths), (mid, lmid)):
        pk, exc = pack_codes(c, ln)
        out.append(Batch(codes=c, lengths=ln, metas=[None] * b, n_rows=b,
                         packed=pk, exc=exc))
    return out


def engine_phase(device="cuda", num_probes=100_000, batch=1024, max_len=256) -> None:
    """FpClassifier on ``device`` vs on the CPU: finals, seen and ucount
    bit-equal on the toy world."""
    from kmer_id_tpu_torch.db.fpdb import build_fpdb
    from kmer_id_tpu_torch.engine.fpclassify import FpClassifier

    dense_rows = (5, batch - 3)
    packed, tax, codes, lengths, _ = toy_world(
        num_probes=num_probes, num_targ=256, batch=batch, max_len=max_len,
        dense_rows=dense_rows,
    )
    fpdb = build_fpdb(packed, tax)
    batches = toy_batches(codes, lengths, dense_rows, num_probes)
    res = {}
    for dev in (device, "cpu"):
        clf = FpClassifier(packed, tax, batch_size=batch, max_len=max_len,
                           fpdb=fpdb, device=dev)
        seen = clf.new_seen()
        finals = []
        for bt in batches:
            seen, f = clf.process_batch(seen, bt)
            finals.append(f)
        res[dev] = (finals, seen.cpu().numpy(), clf.ucount(seen))
    for i, (a, c) in enumerate(zip(res[device][0], res["cpu"][0])):
        if not np.array_equal(a, c):
            raise AssertionError(f"toy world batch {i}: finals differ between {device} and cpu")
    if not np.array_equal(res[device][1], res["cpu"][1]):
        raise AssertionError("toy world: seen differs")
    if not np.array_equal(res[device][2], res["cpu"][2]):
        raise AssertionError("toy world: ucount differs")
    if res["cpu"][2].sum() == 0 or min(res["cpu"][0][0][r] for r in dense_rows) <= 0:
        raise AssertionError("toy world: no hits, or a dense read unresolved")
    say(f"engine {device} vs cpu on the toy world ({num_probes} probes, "
        f"{len(batches)} batches of {batch}x{max_len}): finals, seen, ucount bit-equal; "
        f"ucount sum {int(res['cpu'][2].sum())}")


def long_reads(genome, seed=3):
    """Long reads (uint8 codes) reaching every branch of the long-read lane:
    consistent, chimeric, a genome copy (a probe at every window: candidate
    overflow and the dense path), a 1,500-N run (the u8 plane), a read
    shorter than KSIZE, one without probes, and 40 reads of 3-10 kb with
    0-4 planted probes."""
    r = np.random.default_rng(seed)
    rnd = lambda n: r.integers(0, 4, size=n, dtype=np.uint8)  # noqa: E731

    def planted(n, k):
        a = rnd(n)
        for p, g in zip(r.integers(0, n - 30, size=k), r.integers(0, len(genome) - 30, size=k)):
            a[p : p + 30] = genome[g : g + 30]
        return a

    one = rnd(3000)
    one[1000:1030] = genome[5000:5030]
    nrun = np.concatenate([planted(2000, 2), np.full(1500, 4, np.uint8), planted(2000, 2)])
    reads = [one, planted(8000, 5), genome[:30_000].copy(), nrun, rnd(20), rnd(5000)]
    return reads + [planted(int(r.integers(3000, 10_000)), int(r.integers(0, 5)))
                    for _ in range(40)]


def long_engine_phase(device="cuda", num_probes=100_000, max_len=JOB_MAX_LEN) -> None:
    """FpClassifier.process_long_many on ``device`` vs on the CPU: finals,
    seen and ucount bit-equal, at a group size of 256 rows (several groups,
    per-read finals on device) and of 32 rows (the genome copy's 62 rows
    exceed a group: the summary lane)."""
    from kmer_id_tpu_torch.db.fpdb import build_fpdb
    from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
    from kmer_id_tpu_torch.io.batch import LongRead

    packed, tax, _, _, genome = toy_world(num_probes=num_probes, num_targ=256, batch=8,
                                           max_len=max_len, long_len=num_probes)
    fpdb = build_fpdb(packed, tax)
    items = [LongRead(meta=None, codes=c) for c in long_reads(genome)]
    for batch_size in (256, 32):
        res = {}
        for dev in (device, "cpu"):
            clf = FpClassifier(packed, tax, batch_size=batch_size, max_len=max_len,
                               fpdb=fpdb, device=dev)
            seen, finals = clf.process_long_many(clf.new_seen(), items)
            res[dev] = (finals, seen[: fpdb.n_slots].cpu().numpy(), clf.ucount(seen))
        if res[device][0] != res["cpu"][0]:
            raise AssertionError(f"long lane, groups of {batch_size}: finals differ")
        for i, what in ((1, "seen"), (2, "ucount")):
            if not np.array_equal(res[device][i], res["cpu"][i]):
                raise AssertionError(f"long lane, groups of {batch_size}: {what} differs")
        fin = res["cpu"][0]
        if fin[2] <= 0 or fin[4] != 0 or res["cpu"][2].sum() == 0:
            raise AssertionError("long lane: genome copy unresolved or no hits")
        say(f"long lane {device} vs cpu, groups of {batch_size} rows ({len(items)} reads, "
            f"max_len {max_len}): finals, seen, ucount bit-equal; "
            f"{sum(f > 1 for f in fin)} reads classified")


# ------------------------------------------------------------- nx phase


def _revcomp(keys):
    k = keys.copy()
    out = np.zeros_like(k)
    for _ in range(30):
        out = (out << np.uint64(2)) | ((np.uint64(3) - (k & np.uint64(3))) & np.uint64(3))
        k >>= np.uint64(2)
    return out


def _key_chars(keys):
    shifts = np.array([2 * (29 - j) for j in range(30)], dtype=np.uint64)
    codes = ((keys[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes]


def make_db(rng, n_probes, num_targ, db_dir, cache_dir):
    """Random canonical 30-mer probes on random targets of a random tree,
    written straight into the packed and fingerprint caches (no probe
    text).  Returns (sorted keys, targets, parent list)."""
    from kmer_id_tpu_torch.core.taxonomy import Taxonomy
    from kmer_id_tpu_torch.db.fpdb import build_fpdb, save_fpdb
    from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes, save_packed

    parent = np.ones(num_targ, dtype=np.int32)
    for i in range(3, num_targ):
        parent[i] = int(rng.integers(1, i))
    raw = rng.integers(0, 1 << 60, size=int(n_probes * 1.05), dtype=np.uint64)
    keys = np.unique(np.minimum(raw, _revcomp(raw)))
    keys = np.sort(rng.choice(keys, size=n_probes, replace=False))
    n = len(keys)
    rec = ProbeRecords(
        keys=keys, target=rng.integers(2, num_targ, size=n).astype(np.int32),
        org=np.zeros(n, np.int32), position=np.zeros(n, np.int32),
        fstrand=np.ones(n, bool), count=np.ones(n, np.int32),
    )
    packed = pack_probes(rec, num_targ=num_targ)
    save_packed(packed, cache_dir)
    tax = Taxonomy(parent)
    save_fpdb(build_fpdb(packed, tax), cache_dir)
    os.makedirs(db_dir, exist_ok=True)
    with open(os.path.join(db_dir, "bData10.txt"), "w") as f:
        f.writelines(f"{t}\tACC{t:06d}\n" for t in range(2, num_targ))
    with open(os.path.join(db_dir, "btree_10.txt"), "w") as f:
        f.writelines(f"{parent[t]}\t{t}\n" for t in range(2, num_targ))
    return packed.keys, packed.target, parent.tolist()


def sample_outputs(d) -> dict:
    """{name: text} of the _result.txt and _reads.txt files in ``d``."""
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(("_result.txt", "_reads.txt")):
            with open(os.path.join(d, name)) as f:
                out[name] = f.read()
    return out


def write_reads(rng, path, n, plant_chars, tag):
    """n FASTQ.gz reads of READ_LEN bases with 0-3 planted probes (either
    strand), an N in 1% of reads and a low-quality tail in 10%."""
    reads = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=(n, READ_LEN), dtype=np.uint8)]
    nplant = rng.integers(0, 4, size=n)
    for j in range(3):
        rows = np.nonzero(nplant > j)[0]
        pidx = rng.integers(0, len(plant_chars), size=len(rows))
        pos = rng.integers(0, READ_LEN - 30, size=len(rows))
        reads[rows[:, None], pos[:, None] + np.arange(30)[None, :]] = plant_chars[pidx]
    nrows = np.nonzero(rng.random(n) < 0.01)[0]
    reads[nrows, rng.integers(0, READ_LEN, size=len(nrows))] = ord("N")
    qual = np.full((n, READ_LEN), ord("J"), dtype=np.uint8)
    qual[rng.random(n) < 0.1, READ_LEN - 25 :] = ord("#")
    rec_len = 10 + READ_LEN + 1 + 2 + READ_LEN + 1
    block = np.zeros((n, rec_len), dtype=np.uint8)
    block[:, 0] = ord("@")
    block[:, 1] = ord(tag)
    d = np.arange(n, dtype=np.int64)
    for col, div in zip(range(2, 9), (10**6, 10**5, 10**4, 10**3, 100, 10, 1)):
        block[:, col] = ord("0") + (d // div) % 10
    block[:, 9] = ord("\n")
    block[:, 10 : 10 + READ_LEN] = reads
    block[:, 10 + READ_LEN] = ord("\n")
    block[:, 11 + READ_LEN] = ord("+")
    block[:, 12 + READ_LEN] = ord("\n")
    block[:, 13 + READ_LEN : 13 + 2 * READ_LEN] = qual
    block[:, -1] = ord("\n")
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(block.tobytes())


def probe_dict(keys, targets, records, u_is_t: bool) -> dict:
    """{key: target} of the DB's probes (sorted ``keys``) among the canonical
    30-mers of the records' sequences: the reference simulator's probe
    lookup restricted to the keys it can meet, in place of a 33M-entry dict
    or a binary search per window.  The sequences are joined with an
    invalid base between them, so no window spans two records."""
    from kmer_id_tpu_torch.core.codec import CODE_LUT, CODE_LUT_U, canonical_kmers

    lut = CODE_LUT_U if u_is_t else CODE_LUT
    text = b"\n".join(seq.encode("latin-1") for _, seq, _ in records)
    q = np.unique(canonical_kmers(lut[np.frombuffer(text, dtype=np.uint8)])[0])
    i = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    hit = keys[i] == q
    return dict(zip(q[hit].tolist(), np.asarray(targets)[i[hit]].tolist()))


def repo_refsim():
    """tests/refsim.RefSim of this checkout.  tests/ has no __init__.py, so
    an installed package named ``tests`` would shadow it: bind the name to
    this directory first."""
    import types

    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(ROOT, "tests")]
    sys.modules["tests"] = pkg
    from tests.refsim import RefSim

    return RefSim


def nx_phase(device="cuda", n_probes=N_PROBES, big=BIG_READS, small=SMALL_READS,
             batch=BATCH, max_len=MAX_LEN, work=WORK) -> dict:
    """classify-nx through the port's CLI; returns the run's numbers and the
    DB (keys, targets, parent, DB dir, cache, planted probe letters), whose
    files stay in ``work`` for the jobs phase."""
    import torch

    sys.path.insert(0, ROOT)
    from kmer_id_tpu_torch.io.fastx import iter_fastq_gz
    from kmer_id_tpu_torch import cli
    RefSim = repo_refsim()

    rng = np.random.default_rng(SEED)
    shutil.rmtree(work, ignore_errors=True)
    db_dir, cache, fq = (os.path.join(work, d) for d in ("db", "cache", "fastq"))
    os.makedirs(fq)
    t0 = time.perf_counter()
    keys, targets, parent = make_db(rng, n_probes, NUM_TARG, db_dir, cache)
    sel = rng.choice(len(keys), size=min(100_000, len(keys)), replace=False)
    plant = np.concatenate([_key_chars(keys[sel]), _key_chars(_revcomp(keys[sel]))])
    for name, n in (("big", big), ("small", small)):
        for mate, tag in (("R1", "a"), ("R2", "b")):
            write_reads(rng, os.path.join(fq, f"{name}_{mate}_tr.fastq.gz"), n, plant, tag)
    say(f"nx: {len(keys)} probes, {NUM_TARG} targets, samples big {2 * big} and "
        f"small {2 * small} reads generated in {time.perf_counter() - t0:.1f} s")

    metrics = os.path.join(work, "metrics.jsonl")
    argv = ["classify-nx", fq, "--db-dir", db_dir, "--cache-dir", cache,
            "--num-targ", str(NUM_TARG), "--batch-size", str(batch),
            "--max-len", str(max_len), "--device", device, "--metrics", metrics]
    reset_counts()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    run_s = time.perf_counter() - t0
    launches = read_counts()
    if rc != 0:
        raise AssertionError(f"classify-nx exited {rc}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    with open(metrics) as f:
        m = {r["sample"]: r for r in map(json.loads, f)}

    # small sample: the reference simulator decides every count and saved read
    t0 = time.perf_counter()
    records = [rec for mate in ("R1", "R2")
               for rec in iter_fastq_gz(os.path.join(fq, f"small_{mate}_tr.fastq.gz"))]
    sim = RefSim(probe_dict(keys, targets, records, False), parent, num_targ=NUM_TARG,
                 u_is_t=False, savenum=12, variant="nx")
    sim.feed(records)
    outputs = sample_outputs(fq)
    if outputs["small_result.txt"].splitlines() != sim.result_lines():
        raise AssertionError("small sample: _result.txt != RefSim")
    if outputs["small_reads.txt"] != "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved):
        raise AssertionError("small sample: _reads.txt != RefSim")
    say(f"nx small sample: {sim.reads} reads, _result.txt and _reads.txt equal "
        f"RefSim (checked in {time.perf_counter() - t0:.1f} s)")

    with open(os.path.join(fq, "big_result.txt")) as f:
        gsum = sum(int(line.split(",")[1]) for line in f)
    reads = m["big"]["reads"]
    if reads != 2 * big or gsum != reads:
        raise AssertionError(f"big sample: reads {reads}, sum(gcount) {gsum}, "
                             f"expected {2 * big}")
    from kmer_id_tpu_torch.core.taxonomy import Taxonomy
    from kmer_id_tpu_torch.db.fpdb import build_tinfo, load_fpdb

    fp = load_fpdb(cache)
    tax = Taxonomy(np.asarray(parent, np.int32))
    tables = (fp.fptab, fp.fptab2, fp.rec, fp.bloom, build_tinfo(tax), tax.chain_tables()[0])
    table_bytes = sum(a.nbytes for a in tables if a is not None)
    prof = {}
    if device != "cpu":
        prof = profile_phase(device, db_dir, cache, os.path.join(fq, "big_R1_tr.fastq.gz"),
                             batch, max_len)
    return {
        "outputs": outputs, "batch": batch, "max_len": max_len,
        "reads": reads, "wall_s": m["big"]["wall_s"],
        "reads_per_s": m["big"]["reads_per_s"], "classified": m["big"]["classified"],
        "small_wall_s": m["small"]["wall_s"], "cli_s": run_s,
        "launches": launches, "table_bytes": table_bytes, "seen_bytes": fp.n_slots + 1,
        "peak_bytes": peak, "n_probes": len(keys), "profile": prof,
        "db": (keys, targets, parent, db_dir, cache, plant),
    }


ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def contig(rng, n, pool, k):
    """n random bases (ASCII) with ``k`` rows of ``pool`` (30-base probe
    letters) planted at random places."""
    seq = ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)]
    if k and n > 30:
        for p, i in zip(rng.integers(0, n - 30, size=k), rng.integers(0, len(pool), size=k)):
            seq[p : p + 30] = pool[i]
    return seq


def write_fasta(path, seqs, tag):
    with open(path, "wb") as f:
        for i, seq in enumerate(seqs):
            f.write(b">%s%d contig\n" % (tag.encode(), i))
            f.write(seq.tobytes())
            f.write(b"\n")


def mixed_contigs(rng, keys, targets, n=300, big=1_200_000):
    """~300 contigs of 0.5-20 kb and one ``big``-base record, with probes
    planted about every 2 kb: a third from one target (consistent), the
    rest from random targets (chimeric across incomparable targets); every
    25th with a 1,100-1,500-N run, every 10th with U for T, every 50th with
    25 probes back to back (chunks past the lane's 8-hit budget).  Returns
    (contigs, the consistent contigs' target)."""
    pool_idx = rng.choice(len(keys), size=20_000, replace=False)
    pool = np.concatenate([_key_chars(keys[pool_idx]), _key_chars(_revcomp(keys[pool_idx]))])
    t_one = int(targets[pool_idx[0]])
    same = pool_idx[targets[pool_idx] == t_one]
    if len(same) < 2:  # widen to every key of that target
        same = np.nonzero(targets == t_one)[0][:64]
    one_pool = np.concatenate([_key_chars(keys[same]), _key_chars(_revcomp(keys[same]))])
    out = []
    for i in range(n):
        length = int(rng.integers(500, 20_001))
        seq = contig(rng, length, one_pool if i % 3 == 0 else pool, length // 2000 + 1)
        if i % 50 == 11:
            p = int(rng.integers(0, max(length - 750, 1)))
            dense = pool[rng.integers(0, len(pool), size=25)].reshape(-1)
            seq[p : p + len(dense)] = dense[: len(seq) - p]
        if i % 25 == 5:
            seq = np.concatenate([seq[: length // 2], np.full(int(rng.integers(1100, 1501)),
                                                              ord("N"), np.uint8),
                                  seq[length // 2 :]])
        if i % 10 == 7:
            seq[seq == ord("T")] = ord("U")
        out.append(seq)
    out.append(contig(rng, big, pool, big // 4000))
    return out, t_one


def jobs_phase(device, db, work=WORK, batch=JOB_BATCH, max_len=JOB_MAX_LEN,
               n_reads=20_000, n_contigs=300, big=1_200_000, timed_mbase=50) -> dict:
    """classify-jobs through the port's CLI against the nx phase's DB (its
    cache, plus ``<name>_data.txt``/``_tree.txt``): job ``mixed`` (FASTQ.gz
    reads + FASTA contigs) and job ``target`` (the same files, ``-target``)
    against the reference simulator; then a ~``timed_mbase``-Mbase job of
    2-50 kb contigs timed through run_vf6 (driver level) and through
    process_long_many on the decoded contigs (engine level)."""
    import torch

    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.io.fastx import iter_fasta_plain, iter_fastq_gz
    from kmer_id_tpu_torch import cli
    RefSim = repo_refsim()
    keys, targets, parent, db_dir, cache, plant = db
    rng = np.random.default_rng(SEED + 1)
    root = os.path.join(work, "jobs")
    dbd = os.path.join(root, "bact")
    os.makedirs(dbd)
    shutil.copy(os.path.join(db_dir, "bData10.txt"), os.path.join(dbd, "bact_data.txt"))
    shutil.copy(os.path.join(db_dir, "btree_10.txt"), os.path.join(dbd, "bact_tree.txt"))
    t0 = time.perf_counter()
    fq = os.path.join(root, "reads.fastq.gz")
    write_reads(rng, fq, n_reads, plant, "j")
    contigs, t_one = mixed_contigs(rng, keys, targets, n_contigs, big)
    fa = os.path.join(root, "contigs.fasta")
    write_fasta(fa, contigs, "c")
    say(f"jobs: {n_reads} reads, {len(contigs)} contigs of "
        f"{sum(len(c) for c in contigs)} bases generated in {time.perf_counter() - t0:.1f} s")

    engine = ["--batch-size", str(batch), "--max-len", str(max_len), "--cache-dir", cache,
              "--device", device]
    launches = dict.fromkeys(KERNELS, 0)
    for jname, job, target in (("jobs_mixed", "mixed", 0), ("jobs_target", "target", t_one)):
        os.makedirs(os.path.join(root, jname))
        with open(os.path.join(root, jname, jname + ".txt"), "w") as f:
            f.write(f"{job} 2\n{fq}\n{fa}\n")
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["classify-jobs", "-name", "bact", "-jname", jname, "--root", root,
                       "-target", str(target)] + engine)
        if rc != 0:
            raise AssertionError(f"classify-jobs exited {rc}")
        launches = {k: n + read_counts()[k] for k, n in launches.items()}
        say(f"jobs: classify-jobs job {job} ran in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    records = list(iter_fastq_gz(fq)) + list(iter_fasta_plain(fa))
    probes = probe_dict(keys, targets, records, True)
    checked = {}
    for jname, job, target in (("jobs_mixed", "mixed", 0), ("jobs_target", "target", t_one)):
        sim = RefSim(probes, parent, num_targ=NUM_TARG, u_is_t=True, savenum=12,
                     save_target=target, variant="vf6")
        sim.feed(records)
        out = {}
        for k in ("result", "reads", "target_reads")[: 3 if target else 2]:
            with open(os.path.join(root, jname, f"{job}_{k}.txt")) as f:
                out[k] = f.read()
        if out["result"].splitlines() != sim.result_lines():
            raise AssertionError(f"job {job}: _result.txt != RefSim")
        if out["reads"] != "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved):
            raise AssertionError(f"job {job}: _reads.txt != RefSim")
        if target:
            want = "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved_target)
            if out["target_reads"] != want or not sim.saved_target:
                raise AssertionError(f"job {job}: _target_reads.txt != RefSim")
        elif os.path.exists(os.path.join(root, jname, f"{job}_target_reads.txt")):
            raise AssertionError("a job without -target wrote _target_reads.txt")
        checked[job] = out
    say(f"jobs mixed/target: {sim.reads} reads ({sum(sim.gcount[2:])} classified, "
        f"{len(sim.saved_target)} of target {t_one}): _result.txt, _reads.txt and "
        f"_target_reads.txt equal RefSim (checked in {time.perf_counter() - t0:.1f} s)")
    timed = timed_long_job(device, rng, root, keys, plant, cache, batch, max_len, timed_mbase)
    return {"launches": launches, "checked": checked, "files": (fq, fa), "t_one": t_one,
            "root": root, "flags": engine, **timed}


def timed_long_job(device, rng, root, keys, plant, cache, batch, max_len, mbase) -> dict:
    """A ~``mbase``-Mbase job of 2-50 kb contigs (a planted probe about every
    5 kb) through run_vf6 with the classifier built beforehand (driver
    level: decode, placeholder batches, chunking, lane, accounting), then
    process_long_many on the same contigs decoded beforehand (engine
    level), unprofiled and under torch.profiler.  The two runs' counts must
    agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.core.codec import CODE_LUT_U
    from kmer_id_tpu_torch.io.batch import LongRead
    from kmer_id_tpu_torch.io.native_feed import NativePlaneFeeder
    from kmer_id_tpu_torch.engine.pipeline import load_db, make_classifier, run_vf6

    seqs, total = [], 0
    while total < mbase * 1_000_000:
        n = int(rng.integers(2000, 50_001))
        seqs.append(contig(rng, n, plant, n // 5000))
        total += n
    fa = os.path.join(root, "timed.fasta")
    write_fasta(fa, seqs, "t")
    jname = "jobs_timed"
    os.makedirs(os.path.join(root, jname))
    with open(os.path.join(root, jname, jname + ".txt"), "w") as f:
        f.write(f"timed 1\n{fa}\n")
    dbd = os.path.join(root, "bact")
    db = load_db(os.path.join(dbd, "bact_data.txt"), os.path.join(dbd, "bact_tree.txt"),
                 os.path.join(dbd, "bact_probes.txt.gz"), cache_dir=cache)
    cfg = ClassifyConfig.preset("vf6", batch_size=batch, max_len=max_len)
    clf = make_classifier(db, cfg, cache_dir=cache, device=device)
    sync(device)
    t0 = time.perf_counter()
    run_vf6("bact", jname, db, cfg, root=root, clf=clf)
    sync(device)
    driver_s = time.perf_counter() - t0
    with open(os.path.join(root, jname, "timed_result.txt")) as f:
        gcount = np.array([int(line.split(",")[1]) for line in f])
    # the driver's decode alone: native batches and each long row's codes
    feeder = NativePlaneFeeder(batch, max_len, True)
    t0 = time.perf_counter()
    nbs = list(feeder.feed_path(fa)) + list(feeder.flush())
    for nb in nbs:
        for i in nb.long_rows:
            nb.batch.metas.seq_codes(i, True)
    decode_s = time.perf_counter() - t0

    items = [LongRead(meta=None, codes=CODE_LUT_U[s]) for s in seqs]
    t0 = time.perf_counter()
    rows = len(clf.chunk_rows(items)[2])
    chunk_s = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    _, finals = clf.process_long_many(clf.new_seen(), items)
    sync(device)
    engine_s = time.perf_counter() - t0
    if not np.array_equal(np.bincount(finals, minlength=len(gcount)), gcount):
        raise AssertionError("timed job: engine-level finals disagree with run_vf6's counts")
    dev, busy_ms = [], float("nan")  # device time: on the card only
    if device != "cpu":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            clf.process_long_many(clf.new_seen(), items)
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    mb = total / 1e6
    say(f"long lane timed job: {len(seqs)} contigs, {total} bases, {rows} chunk rows of "
        f"{max_len}, groups of {batch}: driver (run_vf6) {driver_s} s = {mb / driver_s} Mbase/s, "
        f"of which native decode {decode_s} s ({len(nbs)} native batches); "
        f"engine (process_long_many, decoded) {engine_s} s = {mb / engine_s} Mbase/s, of "
        f"which host chunking {chunk_s * 1e3} ms; device busy {busy_ms} ms under the "
        f"profiler ({100 * busy_ms / (engine_s * 1e3)}% of the unprofiled engine time)")
    for e in dev[:8]:
        say(f"  device {e.self_device_time_total / 1e3:.3f} ms  {e.count} calls  {e.key[:90]}")
    return {"mbase": mb, "driver_mbase_s": mb / driver_s, "engine_mbase_s": mb / engine_s,
            "chunk_ms": chunk_s * 1e3, "decode_s": decode_s, "device_busy_ms": busy_ms}


def m3_phase(device, work=WORK, n_probes=MITO_PROBES, num_targ=MITO_TARG,
             n_reads=20_000) -> dict:
    """mitokmer through the port's CLI on a synthetic mito-scale text DB
    (``num_targ`` targets, ``n_probes`` probes, a 7-column refkey): reads of
    100-300 bp plus 1% of 600-2,000 bp with ``f2`` ``none``, then again with
    a FASTQ ``f2``; result.txt against the reference simulator each time."""
    from kmer_id_tpu_torch.db.probes import ProbeRecords, write_probes_text
    from kmer_id_tpu_torch.io.fastx import iter_fasta_plain, iter_fastq_plain
    from kmer_id_tpu_torch import cli

    RefSim = repo_refsim()
    rng = np.random.default_rng(SEED + 2)
    w = os.path.join(work, "mito")
    os.makedirs(w)
    t0 = time.perf_counter()
    parent = np.ones(num_targ, dtype=np.int32)
    for i in range(3, num_targ):
        parent[i] = int(rng.integers(1, i))
    raw = rng.integers(0, 1 << 60, size=int(n_probes * 1.02), dtype=np.uint64)
    keys = np.unique(np.minimum(raw, _revcomp(raw)))[:n_probes]
    targets = rng.integers(2, num_targ, size=len(keys)).astype(np.int32)
    n = len(keys)
    txt = os.path.join(w, "mitochondria_probes.txt")
    write_probes_text(ProbeRecords(keys=keys, target=targets, org=np.zeros(n, np.int32),
                                   position=np.zeros(n, np.int32), fstrand=np.ones(n, bool),
                                   count=np.ones(n, np.int32)), txt)
    with open(txt, "rb") as f, gzip.open(txt + ".gz", "wb", compresslevel=1) as g:
        shutil.copyfileobj(f, g)
    os.remove(txt)
    with open(os.path.join(w, "mitochondria_data.txt"), "w") as f:
        f.writelines(f"{t}\tMT{t:06d}\n" for t in range(2, num_targ))
    with open(os.path.join(w, "mitochondria_tree.txt"), "w") as f:
        f.writelines(f"{parent[t]}\t{t}\n" for t in range(2, num_targ))
    with open(os.path.join(w, "mitochondria_refkey.txt"), "w") as f:
        f.write("target\tname\tcount\thit\ttested\tgsize\tnstrains\n")
        f.writelines(f"{t}\tEukaryota_Chordata_Mammalia_Primates_Hominidae_Sp{t}\t{t % 90 + 10}"
                     f"\t{t % 40 + 10}\t{t % 70 + 50}\t16569\t1\n" for t in range(num_targ))
    sel = rng.choice(n, size=50_000, replace=False)
    pool = np.concatenate([_key_chars(keys[sel]), _key_chars(_revcomp(keys[sel]))])
    lens = np.concatenate([rng.integers(100, 301, size=n_reads),
                           rng.integers(600, 2001, size=n_reads // 100)])
    rng.shuffle(lens)
    reads = [contig(rng, int(m), pool, int(rng.integers(0, 4))) for m in lens]
    for i in range(0, len(reads), 37):
        reads[i][reads[i] == ord("T")] = ord("U")
    fa = os.path.join(w, "reads.fasta")
    write_fasta(fa, reads, "m")
    fq2 = os.path.join(w, "reads2.fastq")
    with open(fq2, "wb") as f:
        for i in range(n_reads // 4):
            seq = contig(rng, 150, pool, int(rng.integers(0, 3)))
            qual = np.full(150, ord("I"), np.uint8)
            if i % 9 == 0:
                qual[-30:] = ord("#")
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, seq.tobytes(), qual.tobytes()))
    say(f"m3: {n} probes on {num_targ} targets, {len(reads)} FASTA reads "
        f"({int((lens > 512).sum())} longer than 512) and {n_reads // 4} FASTQ reads "
        f"generated in {time.perf_counter() - t0:.1f} s")

    fa_records = list(iter_fasta_plain(fa))
    fq_records = list(iter_fastq_plain(fq2))
    probes = probe_dict(keys, targets, fa_records + fq_records, True)
    sim = RefSim(probes, parent.tolist(), num_targ=num_targ, u_is_t=True, variant="m3")
    launches = dict.fromkeys(KERNELS, 0)
    checked = None
    for f2, recs in (("none", fa_records), (fq2, fq_records)):
        out = os.path.join(work, "mito_out")
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["mitokmer", "-w", w, "-d", out, "-i", fa, f2, "--device", device])
        if rc != 0:
            raise AssertionError(f"mitokmer exited {rc}")
        launches = {k: n + read_counts()[k] for k, n in launches.items()}
        run_s = time.perf_counter() - t0
        sim.feed(recs)  # f2 given: the same sample, fed on after f1
        got = m3_outputs(w, out)
        if got[0].splitlines() != sim.result_lines():
            raise AssertionError(f"mitokmer f2={os.path.basename(f2)}: result.txt != RefSim")
        csv = got[1].splitlines()
        if csv[0] != "taxid,reads,abundance" or len(csv) < 4:
            raise AssertionError("mitokmer_result.csv malformed")
        checked = checked or got  # the f2 = none run's
        say(f"m3 mitokmer f2={os.path.basename(f2)}: {sim.reads} reads "
            f"({sum(sim.gcount[2:])} classified) in {run_s:.1f} s (text DB parse and "
            f"table build included); result.txt equals RefSim; mitokmer_result.csv "
            f"{len(csv)} lines")
    return {"launches": launches, "checked": checked, "wdir": w, "f1": fa}


def m3_outputs(wdir, out) -> tuple:
    """(result.txt, mitokmer_result.csv) texts of a mitokmer run."""
    with open(os.path.join(wdir, "result.txt")) as f, \
            open(os.path.join(out, "mitokmer_result.csv")) as g:
        return f.read(), g.read()


def profile_phase(device, db_dir, cache, fastq_path, batch, max_len, n_batches=8,
                  engine="fp"):
    """The engine (``engine``: fp or legacy) over ``n_batches`` batches of a
    sample at the main path's shape: wall time without the profiler, then
    device time by kernel and by op with torch.profiler, and the device's
    busy share of that wall time.  Decoding is done before either timed
    window."""
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.io.batch import ReadBatcher
    from kmer_id_tpu_torch.io.fastx import iter_fastq_gz
    from kmer_id_tpu_torch.engine.pipeline import load_db, make_classifier

    db = load_db(os.path.join(db_dir, "bData10.txt"), os.path.join(db_dir, "btree_10.txt"),
                 os.path.join(db_dir, "probes10.txt.gz"), num_targ=NUM_TARG, cache_dir=cache)
    cfg = ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=batch, max_len=max_len,
                                engine=engine)
    clf = make_classifier(db, cfg, cache_dir=cache, device=device)
    rb = ReadBatcher(batch, max_len, u_is_t=False)
    recs = itertools.islice(iter_fastq_gz(fastq_path), (n_batches + 1) * batch)
    items = [it for rec in recs for it in rb.add(*rec)] + list(rb.flush())
    items = items[: n_batches + 1]
    seen = clf.new_seen()
    seen, _ = clf.process_batch(seen, items[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bt in items[1:]:
        seen, _ = clf.process_batch(seen, bt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for bt in items[1:]:
            seen, _ = clf.process_batch(seen, bt)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    nb = len(items) - 1
    per_batch = sum(e.count for e in dev) / nb
    say(f"profile {engine}: {nb} batches of {batch}x{max_len}: wall {wall * 1e3 / nb} ms/batch "
        f"unprofiled; device busy {busy_ms / nb} ms/batch "
        f"({100 * busy_ms / (wall * 1e3)}% of the wall time), {per_batch} device "
        f"launches/batch")
    for e in dev[:12]:
        say(f"  device {e.self_device_time_total / 1e3 / nb:.4f} ms/batch  "
            f"{e.count / nb:.1f} calls/batch  {e.key[:90]}")
    ops = sorted((e for e in ka if e.device_type == DeviceType.CPU and e.key.startswith("aten::")),
                 key=lambda e: e.device_time_total, reverse=True)
    for e in ops[:10]:
        say(f"  op {e.device_time_total / 1e3 / nb:.4f} ms/batch device, "
            f"{e.cpu_time_total / 1e3 / nb:.4f} ms/batch host  {e.count / nb:.1f} calls/batch  "
            f"{e.key}")
    return {"wall_ms_per_batch": wall * 1e3 / nb, "busy_ms_per_batch": busy_ms / nb,
            "launches_per_batch": per_batch}


# ---------------------------------------------------------- legacy phase


LEGACY_MODES = ("compact", "targets", "detail")


class legacy_runs:
    """While open, counts the legacy engine's device runs by mode
    (``Classifier._run``: one per short-read batch in ``compact`` mode, per
    chunk group or overflow replay in ``targets``, per verify batch in
    ``detail``), so a run's kernel launches can be held against them.  The
    pipeline's submitter and collector threads both run the engine, so
    the count takes a lock."""

    def __enter__(self):
        import threading

        from kmer_id_tpu_torch.engine.classify import Classifier

        self.counts = dict.fromkeys(LEGACY_MODES, 0)
        self._run = run = Classifier._run
        counts, lock = self.counts, threading.Lock()

        def counted(clf, seen, reads, mode, max_steps=None):
            with lock:
                counts[mode] += 1
            return run(clf, seen, reads, mode, max_steps)

        Classifier._run = counted
        return self.counts

    def __exit__(self, *exc):
        from kmer_id_tpu_torch.engine.classify import Classifier

        Classifier._run = self._run
        return False


def check_legacy_launches(path: str, launches: dict, runs: dict) -> None:
    """A legacy run must launch window_extract once per device run (every
    short-read batch, chunk group and replay) and compact_ranks once per
    short-read batch, and neither fingerprint kernel."""
    if runs["compact"] <= 0:
        raise AssertionError(f"{path}: the legacy engine ran no short-read batch")
    if launches["window_extract"] != sum(runs.values()):
        raise AssertionError(f"{path}: window_extract launched {launches['window_extract']} "
                             f"times for {runs} legacy runs")
    if launches["compact_ranks"] != runs["compact"]:
        raise AssertionError(f"{path}: compact_ranks launched {launches['compact_ranks']} times "
                             f"for {runs['compact']} short-read batches")
    if launches["window_gate"] or launches["probe_verify"]:
        raise AssertionError(f"{path}: a fingerprint kernel ran under --engine legacy")


def legacy_cli(path: str, argv: list, device) -> tuple[dict, dict, float]:
    """One legacy CLI run on ``device`` with the counts reset before it and
    read after, its launches checked on a card: (kernel launches, legacy
    runs by mode, seconds)."""
    from kmer_id_tpu_torch import cli

    reset_counts()
    t0 = time.perf_counter()
    with legacy_runs() as runs:
        rc = cli.main(argv + ["--engine", "legacy"])
    run_s = time.perf_counter() - t0
    launches = read_counts()
    if rc != 0:
        raise AssertionError(f"{path} --engine legacy exited {rc}")
    if device != "cpu":
        check_legacy_launches(path, launches, runs)
    return launches, dict(runs), run_s


def legacy_phase(device, nx, jobs, m3, work=WORK) -> dict:
    """The legacy engine (``--engine legacy``) on every classify path, at
    the fingerprint phases' DBs and inputs:

    * classify-nx on the nx phase's samples (its 33M-probe cache holds the
      cuckoo table): every output file equal to the fingerprint engine's,
      whose small sample equals RefSim; the big sample's reads/s; a
      profile window of the engine;
    * classify-jobs, jobs ``mixed`` and ``target`` (the long-read path one
      read at a time, the 1.2-Mbase record included): equal to the jobs
      phase's files, which equal RefSim;
    * mitokmer with ``f2`` none on the m3 DB: equal to the m3 phase's.

    Each run's launches are held to its device runs (check_legacy_launches).
    """
    keys, targets, parent, db_dir, cache, _ = nx["db"]
    out = {}
    fq = os.path.join(work, "fastq")
    lfq = os.path.join(work, "fastq_legacy")
    os.makedirs(lfq)
    for name in os.listdir(fq):
        if name.endswith("_tr.fastq.gz"):
            os.symlink(os.path.join(fq, name), os.path.join(lfq, name))
    metrics = os.path.join(work, "metrics_legacy.jsonl")
    launches, runs, run_s = legacy_cli("nx", [
        "classify-nx", lfq, "--db-dir", db_dir, "--cache-dir", cache, "--num-targ",
        str(NUM_TARG), "--batch-size", str(nx["batch"]), "--max-len", str(nx["max_len"]),
        "--device", device, "--metrics", metrics], device)
    got = sample_outputs(lfq)
    if got != nx["outputs"]:
        bad = sorted(k for k in nx["outputs"] if got.get(k) != nx["outputs"][k])
        raise AssertionError(f"nx --engine legacy: {bad} differ from the fingerprint engine's")
    with open(metrics) as f:
        m = {r["sample"]: r for r in map(json.loads, f)}
    say(f"legacy nx: small and big samples' files equal the fingerprint engine's (small: "
        f"RefSim); big sample {m['big']['reads']} reads in {m['big']['wall_s']} s = "
        f"{m['big']['reads_per_s']} reads/s; CLI {run_s:.1f} s; launches {launches}; "
        f"legacy runs {runs}")
    out["nx"] = {"launches": launches, "runs": runs, "reads": m["big"]["reads"],
                 "wall_s": m["big"]["wall_s"], "reads_per_s": m["big"]["reads_per_s"]}
    if device != "cpu":
        out["nx"]["profile"] = profile_phase(
            device, db_dir, cache, os.path.join(fq, "big_R1_tr.fastq.gz"), nx["batch"],
            nx["max_len"], engine="legacy")

    root = jobs["root"]
    jfq, jfa = jobs["files"]
    total = dict.fromkeys(KERNELS, 0)
    truns = dict.fromkeys(LEGACY_MODES, 0)
    for jname, job, target in (("legacy_mixed", "mixed", 0),
                               ("legacy_target", "target", jobs["t_one"])):
        os.makedirs(os.path.join(root, jname))
        with open(os.path.join(root, jname, jname + ".txt"), "w") as f:
            f.write(f"{job} 2\n{jfq}\n{jfa}\n")
        launches, runs, run_s = legacy_cli(f"jobs {job}", [
            "classify-jobs", "-name", "bact", "-jname", jname, "--root", root,
            "-target", str(target)] + jobs["flags"], device)
        if runs["targets"] <= 0:
            raise AssertionError(f"jobs {job} --engine legacy: no chunk group ran")
        for k, want in jobs["checked"][job].items():
            with open(os.path.join(root, jname, f"{job}_{k}.txt")) as f:
                if f.read() != want:
                    raise AssertionError(f"jobs {job} --engine legacy: _{k}.txt != RefSim")
        total = {k: n + launches[k] for k, n in total.items()}
        truns = {k: n + runs[k] for k, n in truns.items()}
        say(f"legacy jobs {job}: files equal RefSim; {run_s:.1f} s; launches {launches}; "
            f"legacy runs {runs}")
    out["jobs"] = {"launches": total, "runs": truns}

    mout = os.path.join(work, "mito_out_legacy")
    launches, runs, run_s = legacy_cli("m3", ["mitokmer", "-w", m3["wdir"], "-d", mout, "-i",
                                              m3["f1"], "none", "--device", device], device)
    if m3_outputs(m3["wdir"], mout) != m3["checked"]:
        raise AssertionError("mitokmer --engine legacy: result.txt or the CSV != RefSim's run")
    say(f"legacy m3 mitokmer f2=none: result.txt and mitokmer_result.csv equal the fingerprint "
        f"engine's (RefSim); {run_s:.1f} s (text DB parse and cuckoo build included); "
        f"launches {launches}; legacy runs {runs}")
    out["m3"] = {"launches": launches, "runs": runs}
    return out


VERIFY_EDGES = [(1, 2), (2, 3), (2, 4), (1, 5), (5, 6)]
VERIFY_TARGETS = (3, 4, 6, 5)  # of the four genomes


def verify_world(work, n_genomes=4, glen=100_000, seed=SEED + 5):
    """A genome world crafted as tests/test_verify.py's: ``n_genomes``
    genomes of ``glen`` bases on disk (fadir/acc<i>.fasta.gz), probes every
    37 bases of each with their true positions and strands; reads: 2,000
    genuine (150 bp, a third reverse-complemented), 300 with a 5-base and
    200 with a 20-base low-quality head (within and beyond the band), 300
    chimeric (a probe in foreign sequence) and 200 random, shuffled.
    Returns (fadir, accessions, ProbeRecords, records)."""
    from kmer_id_tpu_torch.core.codec import KSIZE, canonical_kmers, encode_bases
    from kmer_id_tpu_torch.db.probes import ProbeRecords

    rng = np.random.default_rng(seed)
    fadir = os.path.join(work, "fadir")
    os.makedirs(fadir)
    seqs, accs = [], [f"acc{i}" for i in range(n_genomes)]
    cols = [[] for _ in range(5)]
    for i, acc in enumerate(accs):
        g = ACGT[rng.integers(0, 4, size=glen, dtype=np.uint8)].tobytes().decode()
        seqs.append(g)
        with gzip.open(os.path.join(fadir, acc + ".fasta.gz"), "wt", compresslevel=1) as f:
            f.write(">contig1\n" + "\n".join(g[s : s + 80] for s in range(0, glen, 80)) + "\n")
        last = np.arange(KSIZE, glen, 37)
        key, _, fwd = canonical_kmers(encode_bases(g))
        cols[0].append(key[last - KSIZE + 1])
        cols[1].append(np.full(len(last), VERIFY_TARGETS[i], np.int32))
        cols[2].append(np.full(len(last), i, np.int32))
        cols[3].append((1 + last).astype(np.int32))
        cols[4].append(fwd[last - KSIZE + 1])
    keys, target, org, position, fstrand = (np.concatenate(c) for c in cols)
    rec = ProbeRecords(keys=keys, target=target, org=org, position=position,
                       fstrand=fstrand.astype(bool), count=np.ones(len(keys), np.int32))

    def dna(n):
        return ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)].tobytes().decode()

    comp = str.maketrans("ACGT", "TGCA")
    records = []
    for i in range(2000):
        g = seqs[int(rng.integers(n_genomes))]
        s = int(rng.integers(0, glen - 150))
        seq = g[s : s + 150]
        records.append((f"@g{i}", seq.translate(comp)[::-1] if i % 3 == 2 else seq, "J" * 150))
    for tag, head, n in (("t", 5, 300), ("T", 20, 200)):
        for i in range(n):
            g = seqs[int(rng.integers(n_genomes))]
            s = int(rng.integers(0, glen - 150))
            records.append((f"@{tag}{i}", dna(head) + g[s : s + 150], "#" * head + "J" * 150))
    for i in range(300):
        g = seqs[int(rng.integers(n_genomes))]
        last = int(rng.choice(np.arange(KSIZE, glen, 37)))
        records.append((f"@c{i}", dna(60) + g[last - KSIZE + 1 : last + 1] + dna(60), "J" * 150))
    records += [(f"@r{i}", dna(150), "J" * 150) for i in range(200)]
    order = rng.permutation(len(records))
    return fadir, accs, rec, [records[i] for i in order]


def verify_phase(device="cuda", work=WORK, minalign=200) -> dict:
    """The ``minalign > 0`` verify replay on the card against the CPU: the
    verify world (verify_world) through SampleProcessor at ``minalign`` 0
    and ``minalign`` > 0; gcount, ucount and the saved reads must be equal
    between cuda and cpu, and at ``minalign`` 0 between the legacy and the
    fingerprint engines; the gate must reject reads.  Returns the counts."""
    import io

    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.core.taxonomy import Taxonomy
    from kmer_id_tpu_torch.db.probes import pack_probes
    from kmer_id_tpu_torch.engine.pipeline import LoadedDB, SampleProcessor, make_classifier

    t0 = time.perf_counter()
    fadir, accs, rec, records = verify_world(work)
    num_targ = 8
    packed = pack_probes(rec, num_targ=num_targ)
    db = LoadedDB(packed, Taxonomy.from_edges(VERIFY_EDGES, num_nodes=num_targ), None,
                  num_targ, len(packed))
    say(f"verify: {len(accs)} genomes, {len(packed)} probes, {len(records)} reads made in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {}
    for m, engine, dev in ((0, "fp", device), (0, "legacy", device), (0, "legacy", "cpu"),
                           (minalign, "legacy", device), (minalign, "legacy", "cpu")):
        cfg = ClassifyConfig.preset("vf6", num_targ=num_targ, batch_size=JOB_BATCH, max_len=192,
                                    minalign=m, fadir=fadir, accessions=accs, engine=engine)
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with legacy_runs() as runs:
            sp = SampleProcessor(make_classifier(db, cfg, device=dev), cfg, reads_out=buf)
            sp.feed(records)
            r = sp.finish()
        launches = read_counts()
        res[(m, engine, dev)] = (r.gcount.tolist(), r.ucount.tolist(), r.reads, buf.getvalue())
        if engine == "legacy" and dev != "cpu":  # its launches
            want = {"window_extract": sum(runs.values()),
                    "compact_ranks": runs["compact"] if m == 0 else 0}
            if {k: launches[k] for k in want} != want or not runs["detail" if m else "compact"]:
                raise AssertionError(f"verify minalign {m}: launches {launches} for runs {runs}")
        say(f"verify minalign {m} {engine} {dev}: {r.reads} reads, gcount {r.gcount.tolist()}, "
            f"ucount sum {int(r.ucount.sum())}, {buf.getvalue().count('>')} saved reads in "
            f"{time.perf_counter() - t0:.1f} s; legacy runs {dict(runs)}")
    for m in (0, minalign):
        if res[(m, "legacy", device)] != res[(m, "legacy", "cpu")]:
            raise AssertionError(f"verify minalign {m}: {device} != cpu")
    if res[(0, "fp", device)] != res[(0, "legacy", device)]:
        raise AssertionError("verify minalign 0: the legacy engine != the fingerprint engine")
    base, gated = res[(0, "legacy", device)], res[(minalign, "legacy", device)]
    if not gated[0][0] > base[0][0] or not sum(gated[0][2:]) > 0:
        raise AssertionError("verify: the gate rejected nothing, or everything")
    say(f"verify: cuda == cpu at minalign 0 and {minalign}, legacy == fp at 0; the gate "
        f"left {gated[0][0]} reads unclassified (ungated {base[0][0]})")
    return {"ungated": base[0], "gated": gated[0]}


# ------------------------------------------------ overlap and build-db phases


class SlowEngine:
    """Engine proxy that delays each submit, collect, grouped collect and
    long-read call by a per-call amount (ms, from ``delays``), widening the
    pipeline's submit/collect race windows, and reports ``batch_size`` (so a
    sample runs in more, smaller batches).  Counts its submits."""

    def __init__(self, clf, delays, batch_size):
        self._clf = clf
        self._delays = delays
        self.batch_size = batch_size
        self._n = {"submit": 0, "collect": 0}  # each side runs on one thread

    def __getattr__(self, name):
        return getattr(self._clf, name)

    @property
    def submits(self) -> int:
        return self._n["submit"]

    def _sleep(self, side):
        n = self._n[side]
        self._n[side] = n + 1
        time.sleep(self._delays[(n + (side == "submit")) % len(self._delays)] / 1000.0)

    def submit_batch(self, seen, batch):
        self._sleep("submit")
        return self._clf.submit_batch(seen, batch)

    def collect(self, seen, pending):
        self._sleep("collect")
        return self._clf.collect(seen, pending)

    def collect_many(self, seen, pendings):
        self._sleep("collect")
        return self._clf.collect_many(seen, pendings)

    def process_long_many(self, seen, items):
        self._sleep("collect")
        return self._clf.process_long_many(seen, items)


def clf_cfg(nx):
    """The nx phase's ClassifyConfig."""
    from kmer_id_tpu_torch.config import ClassifyConfig

    return ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=nx["batch"],
                                 max_len=nx["max_len"])


def nx_classifier(device, nx):
    """The fingerprint engine on the nx phase's DB cache, at its shape."""
    from kmer_id_tpu_torch.engine.pipeline import load_db, make_classifier

    _, _, _, db_dir, cache, _ = nx["db"]
    db = load_db(os.path.join(db_dir, "bData10.txt"), os.path.join(db_dir, "btree_10.txt"),
                 os.path.join(db_dir, "probes10.txt.gz"), num_targ=NUM_TARG, cache_dir=cache)
    return make_classifier(db, clf_cfg(nx), cache_dir=cache, device=device)


def overlap_phase(device, nx, clf, work=WORK, reps=3, batch=1024) -> dict:
    """The nx small sample again through SampleProcessor on the native feed
    (both mates, as run_nx feeds them), its engine wrapped in SlowEngine at
    batches of ``batch`` rows and pipeline depths 4-6: every repetition's
    gcount, ucount and saved reads must equal the CLI run's files (which
    equal RefSim), and window_gate must have launched exactly once per
    batch, from the submitter thread."""
    import dataclasses
    import io

    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor

    fq = os.path.join(work, "fastq")
    want = nx["outputs"]
    out = []
    for rep in range(reps):
        proxy = SlowEngine(clf, (rep % 5, 11, 0, (rep * 3) % 17), batch)
        cfg = dataclasses.replace(clf_cfg(nx), batch_size=batch)
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        sp = SampleProcessor(proxy, cfg, reads_out=buf)
        if not sp.native or sp.collect_group != 4:
            raise AssertionError("overlap: the native feed and grouped collects must run")
        sp.pipeline_depth = 4 + rep % 3
        for mate in ("R1", "R2"):
            sp.feed_file(os.path.join(fq, f"small_{mate}_tr.fastq.gz"), fmt="fastq_gz")
        res = sp.finish()
        run_s = time.perf_counter() - t0
        launches = read_counts()
        lines = [f"{i},{res.gcount[i]},{res.ucount[i]}" for i in range(len(res.gcount))]
        if lines != want["small_result.txt"].splitlines():
            raise AssertionError(f"overlap rep {rep}: gcount/ucount != the CLI's (RefSim)")
        if buf.getvalue() != want["small_reads.txt"]:
            raise AssertionError(f"overlap rep {rep}: saved reads != the CLI's (RefSim)")
        if device != "cpu" and (launches["window_gate"] != proxy.submits
                                or launches["probe_verify"] <= 0):
            raise AssertionError(f"overlap rep {rep}: launches {launches} for "
                                 f"{proxy.submits} batches")
        out.append({"batches": proxy.submits, "depth": sp.pipeline_depth, "s": run_s,
                    "launches": launches})
        say(f"overlap rep {rep}: {res.reads} reads in {proxy.submits} batches of {batch} "
            f"(delayed engine, depth {sp.pipeline_depth}) in {run_s:.2f} s: files equal the "
            f"CLI run's (RefSim); launches {launches}")
    return {"reps": out, "launches": out[-1]["launches"]}


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals, in ms (us in)."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def stage_phase(device, nx, clf, work=WORK) -> dict:
    """The 500,000-read sample through SampleProcessor as run_nx drives it
    (both mates on the native feed; the classifier built beforehand), its
    stages timed apart:

    * decode alone: the native feeder drained over both mates (gz decode,
      parse, trim, 2-bit packing);
    * the sample's wall, unprofiled, and its reads/s;
    * under torch.profiler (device activity of every thread), with the
      submit steps and the collector jobs timed on the host: host ms of
      submit (H2D enqueue, engine launches, host branches; submitter
      thread) and of collect + account (collector thread), device ms of
      the H2D copies, the kernels and the D2H copies, and the device's busy
      share: the union of its intervals over the whole sample's wall;
    * ucount: the finalize stage (max-merge of seen and seen_ovr, counts).

    Each run's window_gate launches must equal its batches."""
    import io
    import threading

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor
    from kmer_id_tpu_torch.io.native_feed import NativePlaneFeeder

    fq = os.path.join(work, "fastq")
    mates = [os.path.join(fq, f"big_{m}_tr.fastq.gz") for m in ("R1", "R2")]
    cfg = clf_cfg(nx)
    feeder = NativePlaneFeeder(nx["batch"], nx["max_len"], False)
    t0 = time.perf_counter()
    nbs = sum(1 for m in mates for _ in feeder.feed_path(m, fmt="fastq_gz"))
    nbs += sum(1 for _ in feeder.flush())
    decode_s = time.perf_counter() - t0

    host = {}  # name: [seconds, calls] of the timed steps
    lock = threading.Lock()

    def timed(name, fn):
        def run(self, *a):
            t = time.perf_counter()
            try:
                return fn(self, *a)
            finally:
                with lock:
                    acc = host.setdefault(name, [0.0, 0])
                    acc[0] += time.perf_counter() - t
                    acc[1] += 1
        return run

    def sample():
        reset_counts()
        sync(device)
        t = time.perf_counter()
        sp = SampleProcessor(clf, cfg, reads_out=io.StringIO())
        for m in mates:
            sp.feed_file(m, fmt="fastq_gz")
        res = sp.finish()
        sync(device)
        wall = time.perf_counter() - t
        launches = read_counts()
        if res.reads != nx["reads"]:
            raise AssertionError(f"stages: {res.reads} reads, expected {nx['reads']}")
        if device != "cpu" and launches["window_gate"] != nbs:
            raise AssertionError(f"stages: window_gate launched {launches['window_gate']} "
                                 f"times for {nbs} batches")
        return res, wall, launches

    res, wall, launches = sample()
    names = {"_consume_native": "submit", "_group_job": "collect+account",
             "_drain_job": "collect+account"}
    saved = {n: getattr(SampleProcessor, n) for n in names}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    try:
        for n, label in names.items():
            setattr(SampleProcessor, n, timed(label, saved[n]))
        with profile(activities=acts) as prof:
            pres, pwall, plaunches = sample()
    finally:
        for n, fn in saved.items():
            setattr(SampleProcessor, n, fn)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if device != "cpu" and not dev:
        raise AssertionError("stages: the profiler saw no device activity")

    def dev_ms(pred):
        return sum(e.time_range.end - e.time_range.start for e in dev if pred(e.name)) / 1e3

    h2d = dev_ms(lambda n: "HtoD" in n)
    d2h = dev_ms(lambda n: "DtoH" in n)
    kern = dev_ms(lambda n: "Memcpy" not in n and "Memset" not in n)
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in dev)
    ms = {k: v[0] * 1e3 / nbs for k, v in host.items()}
    out = {"batches": nbs, "reads": res.reads, "decode_ms_per_batch": decode_s * 1e3 / nbs,
           "wall_s": wall, "reads_per_s": res.reads / wall, "profiled_wall_s": pwall,
           "submit_ms_per_batch": ms.get("submit"),
           "collect_account_ms_per_batch": ms.get("collect+account"),
           "h2d_ms_per_batch": h2d / nbs, "kernel_ms_per_batch": kern / nbs,
           "d2h_ms_per_batch": d2h / nbs, "device_busy_ms": busy,
           "busy_share_profiled": busy / (pwall * 1e3),
           "busy_share_unprofiled": busy / (wall * 1e3),
           "ucount_ms": res.stage_s.get("finalize", float("nan")) * 1e3,
           "launches": launches, "launches_per_batch": plaunches["window_gate"] / nbs,
           "device_launches_per_batch": sum(1 for e in dev if "Memcpy" not in e.name
                                            and "Memset" not in e.name) / nbs}
    say(f"stages ({nbs} batches of {nx['batch']}x{nx['max_len']}, {res.reads} reads): decode "
        f"alone {out['decode_ms_per_batch']} ms/batch ({decode_s} s); sample wall {wall} s "
        f"unprofiled = {out['reads_per_s']} reads/s; under the profiler {pwall} s: submit "
        f"(host, submitter thread) {out['submit_ms_per_batch']} ms/batch, collect + account "
        f"(host, collector thread) {out['collect_account_ms_per_batch']} ms/batch; device: "
        f"H2D {out['h2d_ms_per_batch']} ms/batch, kernels {out['kernel_ms_per_batch']} ms/batch "
        f"in {out['device_launches_per_batch']} launches/batch, D2H {out['d2h_ms_per_batch']} "
        f"ms/batch; device busy (union) {busy} ms = {100 * out['busy_share_profiled']}% of "
        f"the profiled wall, {100 * out['busy_share_unprofiled']}% of the unprofiled wall; "
        f"ucount {out['ucount_ms']} ms (unprofiled run)")
    return out


BUILD_GENERA, BUILD_SPECIES = 4, 6  # targets: genera 2-5, species 6-29
BUILD_LEN = 120_000


def build_world(rng, root, name="syn"):
    """A genome set for build-db: one genome per species of 4 genera x 6
    (two genomes for species 6, so its probes need 2 occurrences), each
    with a 4-kb block shared inside its genus (those probes merge to the
    genus), species 7 sharing a 3-kb block with an outgroup genome of the
    filter list (poisoned), N runs, lowercase and U bases; gz FASTA of
    80-column lines under ``root/fa``.  Returns (fadir, {accession: seq})."""
    fadir = os.path.join(root, "fa")
    wdir = os.path.join(root, name)
    os.makedirs(fadir)
    os.makedirs(wdir)
    genus_block = [ACGT[rng.integers(0, 4, size=4000, dtype=np.uint8)]
                   for _ in range(BUILD_GENERA)]
    outg = ACGT[rng.integers(0, 4, size=3000, dtype=np.uint8)]
    genomes, data, tree = {}, [], []
    species = range(2 + BUILD_GENERA, 2 + BUILD_GENERA + BUILD_GENERA * BUILD_SPECIES)
    for t in species:
        genus = 2 + (t - 2 - BUILD_GENERA) % BUILD_GENERA
        tree.append(f"{genus}\t{t}")
        for copy in range(2 if t == species[0] else 1):
            seq = ACGT[rng.integers(0, 4, size=BUILD_LEN, dtype=np.uint8)]
            p = int(rng.integers(0, BUILD_LEN - 8000))
            seq[p : p + 4000] = genus_block[genus - 2]
            if t == species[1]:
                seq[p + 4000 : p + 7000] = outg
            if t % 5 == 0:
                seq[1000:1200] = ord("N")
                seq[5000:6000] += ord("a") - ord("A")  # lowercase
            if t % 7 == 0:
                head = seq[:20_000]
                head[head == ord("T")] = ord("U")
            acc = f"S{t}_{copy}"
            genomes[acc] = seq
            data.append(f"{t}\t{acc}")
    tree = [f"1\t{g}" for g in range(2, 2 + BUILD_GENERA)] + tree
    genomes["OUT"] = np.concatenate([ACGT[rng.integers(0, 4, size=2000, dtype=np.uint8)], outg])
    for acc, seq in genomes.items():
        with gzip.open(os.path.join(fadir, acc + ".fasta.gz"), "wb", compresslevel=1) as f:
            f.write(b">%s\n" % acc.encode())
            f.write(b"\n".join(seq[i : i + 80].tobytes() for i in range(0, len(seq), 80)) + b"\n")
    for suffix, lines in (("data", data), ("tree", tree), ("filter", ["OUT"])):
        with open(os.path.join(wdir, f"{name}_{suffix}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return fadir, genomes


def build_phase(device, work=WORK, name="syn", n_reads=6000) -> dict:
    """build-db through the port's CLI on build_world's genome set, in RAM
    and with ``--spill`` (16 shards, 1-MB batches: several shard merges),
    whose ``_probes.txt`` and ``_count.txt`` must be byte-equal; then the DB
    (its probes gzipped) classifies a FASTQ.gz sample of reads drawn from
    the genomes (and random ones) through classify-jobs on ``device``,
    whose files must equal RefSim on the built probes."""
    from kmer_id_tpu_torch import cli
    from kmer_id_tpu_torch.core.taxonomy import Taxonomy
    from kmer_id_tpu_torch.db.metadata import load_data_txt, load_tree_edges
    from kmer_id_tpu_torch.db.probes import parse_probes_text
    from kmer_id_tpu_torch.io.fastx import iter_fastq_gz

    RefSim = repo_refsim()
    rng = np.random.default_rng(SEED + 7)
    root = os.path.join(work, "build")
    t0 = time.perf_counter()
    fadir, genomes = build_world(rng, root, name)
    gen_s = time.perf_counter() - t0
    wdir = os.path.join(root, name)
    argv = ["build-db", "-name", name, "-fadir", fadir, "--root", root]
    files = [os.path.join(wdir, f"{name}_{k}.txt") for k in ("probes", "count")]
    got = {}
    for mode, extra in (("in RAM", []),
                        ("spill", ["--spill", "--spill-shard-bits", "4", "--spill-batch-mb", "1"])):
        t0 = time.perf_counter()
        if cli.main(argv + extra) != 0:
            raise AssertionError(f"build-db {mode} exited non-zero")
        secs = time.perf_counter() - t0
        got[mode] = (tuple(open(p, "rb").read() for p in files), secs)
    if got["in RAM"][0] != got["spill"][0]:
        raise AssertionError("build-db: --spill's _probes.txt/_count.txt != the in-RAM build's")
    rec = parse_probes_text(files[0])
    n_probes = len(rec)
    if n_probes < 1000 or len(np.unique(rec.target)) < BUILD_GENERA:
        raise AssertionError(f"build-db: {n_probes} probes on {np.unique(rec.target)}")
    say(f"build-db: {len(genomes)} genomes, {sum(len(g) for g in genomes.values())} bases "
        f"(made in {gen_s:.1f} s): {n_probes} probes on {len(np.unique(rec.target))} targets; "
        f"in RAM {got['in RAM'][1]} s, --spill {got['spill'][1]} s, byte-equal outputs")

    with open(files[0], "rb") as f, gzip.open(os.path.join(wdir, f"{name}_probes.txt.gz"), "wb",
                                              compresslevel=1) as g:
        shutil.copyfileobj(f, g)
    pool = [g for acc, g in genomes.items() if acc != "OUT"]
    reads = np.empty((n_reads, READ_LEN), np.uint8)
    for i in range(n_reads):
        if i % 4 == 3:
            reads[i] = ACGT[rng.integers(0, 4, size=READ_LEN, dtype=np.uint8)]
        else:
            g = pool[int(rng.integers(len(pool)))]
            p = int(rng.integers(0, len(g) - READ_LEN))
            reads[i] = g[p : p + READ_LEN]
    fq = os.path.join(root, "reads.fastq.gz")
    with gzip.open(fq, "wb", compresslevel=1) as f:
        for i in range(n_reads):
            qual = b"J" * (READ_LEN - 25) + (b"#" * 25 if i % 10 == 0 else b"J" * 25)
            f.write(b"@b%d\n%s\n+\n%s\n" % (i, reads[i].tobytes(), qual))
    jname = "synjobs"
    os.makedirs(os.path.join(root, jname))
    with open(os.path.join(root, jname, jname + ".txt"), "w") as f:
        f.write(f"sample 1\n{fq}\n")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["classify-jobs", "-name", name, "-jname", jname, "--root", root,
                   "--batch-size", str(JOB_BATCH), "--max-len", str(JOB_MAX_LEN),
                   "--device", device])
    run_s = time.perf_counter() - t0
    launches = read_counts()
    if rc != 0:
        raise AssertionError(f"classify-jobs on the built DB exited {rc}")
    num_targ = load_data_txt(os.path.join(wdir, f"{name}_data.txt")).num_targ
    parent = Taxonomy.from_edges(load_tree_edges(os.path.join(wdir, f"{name}_tree.txt")),
                                 num_nodes=num_targ).parent.tolist()
    records = list(iter_fastq_gz(fq))
    order = np.argsort(rec.keys, kind="stable")
    sim = RefSim(probe_dict(rec.keys[order], rec.target[order], records, True), parent,
                 num_targ=num_targ, u_is_t=True, savenum=12, variant="vf6")
    sim.feed(records)
    with open(os.path.join(root, jname, "sample_result.txt")) as f:
        if f.read().splitlines() != sim.result_lines():
            raise AssertionError("built DB: _result.txt != RefSim")
    with open(os.path.join(root, jname, "sample_reads.txt")) as f:
        if f.read() != "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved):
            raise AssertionError("built DB: _reads.txt != RefSim")
    if sum(sim.gcount[2:]) < n_reads // 2:
        raise AssertionError(f"built DB: only {sum(sim.gcount[2:])} reads classified")
    say(f"build-db DB: classify-jobs on {device}, {sim.reads} reads ({sum(sim.gcount[2:])} "
        f"classified) in {run_s:.1f} s: _result.txt and _reads.txt equal RefSim; launches "
        f"{launches}")
    return {"launches": launches, "probes": n_probes, "in_ram_s": got["in RAM"][1],
            "spill_s": got["spill"][1]}


# ------------------------------------------------------------- grid phase

GRID_TIMEOUT_S = 420  # a rank process's whole life; its peers are killed then
GRID_GRACE_S = 30  # after a rank fails, how long its peers get to end
FP_GRID_KERNELS = ("window_gate", "probe_hits")
LEGACY_GRID_KERNELS = ("window_extract", "compact_ranks")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def grid_db(db_dir, cache):
    """The nx phase's DB as the CLI loads it (packed and fingerprint
    caches): (LoadedDB, FpDB)."""
    from kmer_id_tpu_torch.engine.pipeline import load_db, load_or_build_fpdb

    db = load_db(os.path.join(db_dir, "bData10.txt"), os.path.join(db_dir, "btree_10.txt"),
                 os.path.join(db_dir, "probes10.txt.gz"), num_targ=NUM_TARG, cache_dir=cache)
    return db, load_or_build_fpdb(db, cache)


def sample_dir(work, name, fq, samples) -> str:
    """A fresh directory of links to the nx phase's FASTQ.gz files of
    ``samples``."""
    d = os.path.join(work, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for s in samples:
        for mate in ("R1", "R2"):
            f = f"{s}_{mate}_tr.fastq.gz"
            os.symlink(os.path.join(fq, f), os.path.join(d, f))
    return d


def toy_grid_world():
    """The 2 x 2 grid's world (the JAX package's multi-chip dry run): the
    toy DB of 100,000 probes, its two batches of 1024 x 256 (two
    probe-dense rows: the Bloom budget, the candidate budget and the
    replay), a 2,000-base long read.  Returns (packed, taxonomy, FpDB,
    batches, long reads)."""
    from kmer_id_tpu_torch.db.fpdb import build_fpdb
    from kmer_id_tpu_torch.io.batch import LongRead

    dense_rows = (5, 1024 - 3)
    packed, tax, codes, lengths, genome = toy_world(
        num_probes=100_000, num_targ=256, batch=1024, max_len=256, dense_rows=dense_rows,
        long_len=2000)
    return (packed, tax, build_fpdb(packed, tax), toy_batches(codes, lengths, dense_rows, 100_000),
            [LongRead(meta=None, codes=genome)])


def toy_grid_run(clf, batches, longs) -> dict:
    """Finals of the toy batches, long finals and ucount through ``clf``."""
    seen = clf.new_seen()
    finals = []
    for bt in batches:
        seen, f = clf.process_batch(seen, bt)
        finals.append(np.asarray(f).tolist())
    seen, lf = clf.process_long_many(seen, longs)
    return {"finals": finals, "long": [int(x) for x in lf],
            "ucount": np.asarray(clf.ucount(seen)).tolist()}


def grid_profile(device, run, nbs: int) -> dict:
    """``run()`` (a sample through SampleProcessor) under torch.profiler,
    with the host time of its submit steps and collector jobs and of
    the grid's collectives (Grid._psum, Grid._gather) taken apart: host ms
    per batch of each (the collectives' time is also inside submit and
    collect), and this process's device busy time (the union of its device
    intervals) and its share of the profiled wall."""
    import threading

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor
    from kmer_id_tpu_torch.parallel.mesh import Grid

    host, lock = {}, threading.Lock()

    def timed(name, fn):
        def step(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    host[name] = host.get(name, 0.0) + time.perf_counter() - t
        return step

    points = ((SampleProcessor, "_consume_native", "submit"),
              (SampleProcessor, "_group_job", "collect"),
              (SampleProcessor, "_drain_job", "collect"),
              (Grid, "_psum", "collectives"), (Grid, "_gather", "collectives"))
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in points]
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        for cls, name, label in points:
            setattr(cls, name, timed(label, getattr(cls, name)))
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            run()
            sync(device)
        wall = time.perf_counter() - t0
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if cuda and not dev:
        raise AssertionError("grid profile: the profiler saw no device activity")
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in dev)
    return {"profiled_wall_s": wall, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3),
            **{f"{k}_ms_per_batch": v * 1e3 / nbs for k, v in sorted(host.items())}}


def grid_rank(spec: dict) -> int:
    """One rank of a grid that shares this card with its peers over gloo
    (``python3 chip_smoke.py --grid-rank SPEC``): the task of ``spec`` on
    the sharded engine, its kernel launches counted from 0 just before it,
    the result written to ``spec["out"]``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.engine.pipeline import run_nx
    from kmer_id_tpu_torch.parallel import ShardedFpClassifier, make_mesh
    from kmer_id_tpu_torch.parallel.distributed import health_check, initialize

    dev = torch.device(spec["device"])
    initialize(spec["coord"], spec["n"], spec["rank"], dev, backend="gloo")
    h = health_check(dev)
    if not h["ok"]:
        raise AssertionError(f"rank {spec['rank']}: health check failed: {h}")
    grid = make_mesh(data=spec["dp"], db=spec["dbp"], device=dev)
    out = {"rank": spec["rank"], "health": h}
    t0 = time.perf_counter()
    if spec["task"] == "nx":
        db, fp = grid_db(spec["db_dir"], spec["cache"])
        b, l = spec["batch"], spec["max_len"]
        clf = ShardedFpClassifier(db.packed, db.taxonomy, grid, b, l, fpdb=fp)
        out["setup_s"] = time.perf_counter() - t0
        cfg = ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=b, max_len=l)
        grid.barrier()
        reset_counts()
        run_nx(spec["fq"], db, cfg, clf=clf, metrics_path=spec["metrics"], device=dev)
        out["launches"] = read_counts()
        grid.barrier()
        out["profile"] = grid_profile(dev, lambda: run_nx(spec["fq_profiled"], db, cfg, clf=clf),
                                      spec["profiled_batches"])
    else:  # the toy world at engine level
        packed, tax, fpdb, batches, longs = toy_grid_world()
        clf = ShardedFpClassifier(packed, tax, grid, 1024, 256, fpdb=fpdb)
        out["setup_s"] = time.perf_counter() - t0
        reset_counts()
        out.update(toy_grid_run(clf, batches, longs))
        out["launches"] = read_counts()
    sync(dev)
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kmer_id_tpu"))
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def spawn_grid(spec: dict, n: int, work) -> list:
    """Starts ``n`` ranks of ``spec`` (:func:`grid_rank`), each on this card
    over gloo, and returns their results in rank order.  Raises when a rank
    fails or outlives GRID_TIMEOUT_S; once one has failed, the rest get
    GRID_GRACE_S to end, and every rank still running is killed."""
    coord = f"127.0.0.1:{free_port()}"
    procs, logs, outs = [], [], []
    for r in range(n):
        outs.append(os.path.join(work, f"{spec['task']}_rank{r}.json"))
        logs.append(open(os.path.join(work, f"{spec['task']}_rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--grid-rank",
             json.dumps({**spec, "coord": coord, "n": n, "rank": r, "out": outs[r]})],
            cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT))
    t0, failed_at = time.monotonic(), None
    try:
        while any(p.poll() is None for p in procs):
            if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                failed_at = time.monotonic()
            now = time.monotonic()
            if now - t0 > GRID_TIMEOUT_S or (failed_at and now - failed_at > GRID_GRACE_S):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r].name) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"grid {spec['task']} rank {r} of {n} exited {p.returncode}:\n"
                                 f"{tail}")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    for r in res:
        if r["modules"]:
            raise AssertionError(f"grid rank {r['rank']} imported {r['modules']}")
    return res


def sum_counts(ranks) -> dict:
    return {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}


def grid_phase(device, nx, work=WORK) -> dict:
    """The sharded engines (parallel/) on grids of ranks, with the nx
    phase's DB and samples: a 1 x 1 grid over NCCL in this process (both
    engines; the small sample's files equal the single-device CLI's, which
    equal RefSim; the big sample timed with the fingerprint engine); a 1 x 2
    grid of two ranks sharing this card over gloo (files equal, big sample
    timed); a 2 x 2 grid of four ranks on this card at engine level on the
    toy world, equal to the single-device FpClassifier on the card.  Each
    timed big sample runs again under the profiler (:func:`grid_profile`,
    on every rank).  Every fingerprint grid launched window_gate and
    probe_hits on every rank, the legacy grid window_extract and
    compact_ranks."""
    import torch
    import torch.distributed as dist

    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
    from kmer_id_tpu_torch.engine.pipeline import run_nx
    from kmer_id_tpu_torch.parallel import ShardedClassifier, ShardedFpClassifier, make_mesh

    device = f"cuda:{torch.cuda.current_device()}" if device == "cuda" else device
    cuda = torch.device(device).type == "cuda"
    fq = os.path.join(work, "fastq")
    db_dir, cache = nx["db"][3:5]
    batch, max_len = nx["batch"], nx["max_len"]
    nbs = 2 * -(-nx["reads"] // 2 // batch)  # the big sample's batches: two mates of reads / 2
    want = {k: v for k, v in nx["outputs"].items() if k.startswith("small_")}
    cfg = ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=batch, max_len=max_len)
    out = {"launches": {}}

    def check_files(d, label):
        got = {k: v for k, v in sample_outputs(d).items() if k.startswith("small_")}
        if got != want:
            raise AssertionError(f"grid {label}: small sample files != the single-device CLI's")

    def metrics(path):
        with open(path) as f:
            return {r["sample"]: r for r in map(json.loads, f)}["big"]

    # 1 x 1 over NCCL, in this process (gloo in a rehearsal on the CPU)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(1, dtype=torch.int32, device=device)
        dist.all_reduce(x)
        grid = make_mesh(data=1, db=1, device=device)
        if grid.backend != ("nccl" if cuda else "gloo") or int(x) != 1:
            raise AssertionError(f"1 x 1 grid: backend {grid.backend}, all_reduce {int(x)}")
        t0 = time.perf_counter()
        db, fp = grid_db(db_dir, cache)
        clf = ShardedFpClassifier(db.packed, db.taxonomy, grid, batch, max_len, fpdb=fp)
        setup = time.perf_counter() - t0
        d = sample_dir(work, "grid_1x1", fq, ("small", "big"))
        m = os.path.join(work, "grid_1x1.jsonl")
        reset_counts()
        run_nx(d, db, cfg, clf=clf, metrics_path=m, device=device)
        out["launches"]["grid_nx_1x1"] = read_counts()
        check_files(d, "1 x 1 fingerprint")
        out["1x1"] = {**metrics(m), "setup_s": setup}
        big = sample_dir(work, "grid_1x1_profiled", fq, ("big",))
        out["1x1"]["profile"] = grid_profile(device, lambda: run_nx(big, db, cfg, clf=clf),
                                             nbs)
        del clf
        d = sample_dir(work, "grid_1x1_legacy", fq, ("small",))
        clf = ShardedClassifier(db.packed, db.taxonomy, grid, batch, max_len)
        reset_counts()
        run_nx(d, db, cfg, clf=clf, device=device)
        out["launches"]["grid_nx_legacy_1x1"] = read_counts()
        check_files(d, "1 x 1 legacy")
        del clf, db, fp
    finally:
        dist.destroy_process_group()
    say(f"grid 1 x 1 (NCCL, in process): both engines' small sample files equal the "
        f"single-device CLI's (= RefSim); fingerprint big sample {out['1x1']['reads']} reads in "
        f"{out['1x1']['wall_s']} s = {out['1x1']['reads_per_s']} reads/s (set-up "
        f"{setup:.1f} s); again under the profiler: {out['1x1']['profile']}")

    # 1 x 2: two ranks sharing this card over gloo
    d = sample_dir(work, "grid_1x2", fq, ("small", "big"))
    m = os.path.join(work, "grid_1x2.jsonl")
    big = sample_dir(work, "grid_1x2_profiled", fq, ("big",))
    ranks = spawn_grid({"task": "nx", "dp": 1, "dbp": 2, "device": device, "fq": d,
                        "metrics": m, "db_dir": db_dir, "cache": cache, "batch": batch,
                        "max_len": max_len, "fq_profiled": big, "profiled_batches": nbs},
                       2, work)
    check_files(d, "1 x 2")
    per_rank = {"grid_nx_1x2": ranks}
    out["launches"]["grid_nx_1x2"] = sum_counts(ranks)
    out["1x2"] = {**metrics(m), "setup_s": max(r["setup_s"] for r in ranks),
                  "profile": [r["profile"] for r in ranks]}
    say(f"grid 1 x 2 (two ranks sharing one card, gloo): small sample files equal the "
        f"single-device CLI's; big sample {out['1x2']['reads']} reads in {out['1x2']['wall_s']} "
        f"s = {out['1x2']['reads_per_s']} reads/s (set-up {out['1x2']['setup_s']:.1f} s per rank, "
        f"together); again under the profiler, by rank: {out['1x2']['profile']}")

    # 2 x 2: four ranks sharing this card over gloo, at engine level
    packed, tax, fpdb, batches, longs = toy_grid_world()
    single = toy_grid_run(FpClassifier(packed, tax, batch_size=1024, max_len=256, fpdb=fpdb,
                                       device=device), batches, longs)
    ranks = spawn_grid({"task": "toy", "dp": 2, "dbp": 2, "device": device}, 4, work)
    per_rank["grid_toy_2x2"] = ranks
    for r in ranks:
        got = {k: r[k] for k in ("finals", "long", "ucount")}
        if got != single:
            bad = [k for k in single if got[k] != single[k]]
            raise AssertionError(f"grid 2 x 2 rank {r['rank']}: {bad} != the single-device "
                                 f"engine's")
    if sum(single["ucount"]) <= 0 or min(single["finals"][0][i] for i in (5, 1021)) <= 0:
        raise AssertionError("grid 2 x 2: no hits, or a dense read unresolved")
    out["launches"]["grid_toy_2x2"] = sum_counts(ranks)
    say(f"grid 2 x 2 (four ranks sharing one card, gloo), toy world: finals of 2 batches, the "
        f"long read's final and ucount equal the single-device engine's on every rank")

    for path, counts in out["launches"].items():
        kernels = LEGACY_GRID_KERNELS if "legacy" in path else FP_GRID_KERNELS
        for k in kernels:
            if counts[k] <= 0:
                raise AssertionError(f"the {path} path launched {k} no time")
        for r in per_rank.get(path, []):
            if any(r["launches"][k] <= 0 for k in kernels):
                raise AssertionError(f"{path}: rank {r['rank']} launched {r['launches']}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from kmer_id_tpu_torch.kernels.build import build_many, load_compact, load_gate, load_probe

    t0 = time.perf_counter()
    built = build_many(["compact", "gate", "probe"])  # one nvcc per source, together
    load_compact()
    load_gate()
    load_probe()
    for name, (_, info) in built.items():
        say(f"build: {name}.cu built in {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
    say(f"phase build: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    gr = gate_phase()
    say(f"phase gate: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kr = kernel_phase()
    say(f"phase kernel: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_phase()
    long_engine_phase()
    say(f"phase engine: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nx = nx_phase()
    say(f"phase nx: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pr = probe_phase(nx["db"])
    say(f"phase probe: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gd = grid_phase("cuda", nx)
    say(f"phase grid: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    clf = nx_classifier("cuda", nx)
    ov = overlap_phase("cuda", nx, clf)
    say(f"phase overlap: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    st = stage_phase("cuda", nx, clf)
    del clf
    say(f"phase stages: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jobs = jobs_phase("cuda", nx["db"])
    say(f"phase jobs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m3 = m3_phase("cuda")
    say(f"phase m3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lg = legacy_phase("cuda", nx, jobs, m3)
    say(f"phase legacy: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vr = verify_phase("cuda")
    say(f"phase verify: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bd = build_phase("cuda")
    say(f"phase build-db: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    fp_paths = {"nx": nx["launches"], "jobs": jobs["launches"], "m3": m3["launches"],
                "nx_overlap": ov["launches"], "nx_stages": st["launches"],
                "build_db_jobs": bd["launches"]}
    paths = {**fp_paths, **{f"{p}_legacy": r["launches"] for p, r in lg.items()},
             **gd["launches"]}
    by_kernel = {k: {path: n[k] for path, n in paths.items()} for k in KERNELS}
    for k in ("window_gate", "probe_verify"):
        for path in fp_paths:
            if by_kernel[k][path] <= 0:
                raise AssertionError(f"the {path} path launched {k} no time")
    # the fingerprint engine's dense path and overflow replay: jobs'
    # probe-dense contigs; the legacy paths were held by check_legacy_launches
    for k in ("window_extract", "compact_ranks"):
        if sum(by_kernel[k][path] for path in fp_paths) <= 0:
            raise AssertionError(f"no fingerprint path launched {k}")
    for name in ("jax", "kmer_id_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")
    say(f"nx big sample: {nx['reads']} reads ({nx['classified']} classified) in "
        f"{nx['wall_s']:.3f} s = {nx['reads_per_s']:.1f} reads/s on {card} "
        f"(batch {BATCH}, max_len {MAX_LEN}, {nx['n_probes']} probes)")
    say(f"nx device tables {nx['table_bytes']} bytes + seen {nx['seen_bytes']} bytes, "
        f"peak allocated {nx['peak_bytes']} bytes on {card}")
    say(f"long lane on {card} (batch {JOB_BATCH}, max_len {JOB_MAX_LEN}, "
        f"{nx['n_probes']} probes, {jobs['mbase']} Mbase of 2-50 kb contigs): driver "
        f"{jobs['driver_mbase_s']} Mbase/s, engine {jobs['engine_mbase_s']} Mbase/s")
    lp = lg["nx"]["profile"]
    say(f"legacy nx big sample: {lg['nx']['reads']} reads in {lg['nx']['wall_s']} s = "
        f"{lg['nx']['reads_per_s']} reads/s on {card} (batch {BATCH}, max_len {MAX_LEN}, "
        f"{nx['n_probes']} probes); engine {lp['wall_ms_per_batch']} ms/batch, device busy "
        f"{lp['busy_ms_per_batch']} ms/batch, {lp['launches_per_batch']} launches/batch")
    say(f"legacy runs by path: { {p: r['runs'] for p, r in lg.items()} }")
    say(f"verify world on {card}: ungated gcount {vr['ungated']}, gated {vr['gated']}")
    say(f"nx big sample through SampleProcessor on {card}: {st['reads']} reads in "
        f"{st['batches']} batches, {st['wall_s']} s = {st['reads_per_s']} reads/s; per batch: "
        f"decode alone {st['decode_ms_per_batch']} ms, submit {st['submit_ms_per_batch']} ms "
        f"(host), collect + account {st['collect_account_ms_per_batch']} ms (host), H2D "
        f"{st['h2d_ms_per_batch']} ms, kernels {st['kernel_ms_per_batch']} ms, D2H "
        f"{st['d2h_ms_per_batch']} ms (device); device busy {st['device_busy_ms']} ms over the "
        f"whole sample = {100 * st['busy_share_profiled']}% of the profiled wall "
        f"({st['profiled_wall_s']} s), {100 * st['busy_share_unprofiled']}% of the unprofiled; "
        f"ucount {st['ucount_ms']} ms")
    say(f"overlap reruns on {card}: {[(r['batches'], r['depth'], round(r['s'], 3)) for r in ov['reps']]} "
        f"(batches, depth, s), files equal RefSim's")
    say(f"build-db on the host ({card} for the classify): {bd['probes']} probes, in RAM "
        f"{bd['in_ram_s']} s, --spill {bd['spill_s']} s")
    for g, label in (("1x1", "1 x 1 grid over NCCL"),
                     ("1x2", "1 x 2 grid of two ranks sharing one card over gloo")):
        say(f"{label} on {card} (batch {BATCH}, max_len {MAX_LEN}, {nx['n_probes']} probes): "
            f"nx big sample {gd[g]['reads']} reads in {gd[g]['wall_s']} s = "
            f"{gd[g]['reads_per_s']} reads/s; engine set-up {gd[g]['setup_s']} s; under the "
            f"profiler (per rank: host ms per batch, device busy): {gd[g]['profile']}")
    say(f"kernel launches by path: {by_kernel}")

    def entry(name, source, replaces, times, max_err, shapes):
        k_ms, p_ms, b_ms, b_by = times[:4]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_kernel[name].values()),
                "launches_by_path": by_kernel[name], "max_abs_err": max_err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "shapes": shapes}

    def shape_times(t):
        """ms and plain_ms are device times (CUDA graphs); probe shapes add
        per-call times, host work included, as call_ms and plain_call_ms."""
        out = {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3]}
        if len(t) > 4:
            out.update(call_ms=t[4], plain_call_ms=t[5])
        return out

    gate_src = "kmer_id_tpu_torch/csrc/gate.cu"
    print(json.dumps({"kernels": [
        entry("window_gate", gate_src, "kmer_id_tpu/ops/compact.py:101",
              gr["times"][("gate", "nx", "packed")], gr["max_abs_err"],
              {f"{n} {f}" + (" k=24" if m == "gate24" else ""): shape_times(t)
               for (m, n, f), t in gr["times"].items() if m in ("gate", "gate24")}),
        entry("window_extract", gate_src, "kmer_id_tpu/ops/extract.py:34",
              gr["times"][("extract", "nx", "packed")], gr["max_abs_err"],
              {f"{m} {n} {f}": shape_times(t) for (m, n, f), t in gr["times"].items()
               if m.startswith("extract")}),
        entry("probe_verify", "kmer_id_tpu_torch/csrc/probe.cu",
              "kmer_id_tpu/ops/compact.py:101", pr["times"][("nx", "mixed")],
              pr["max_abs_err"],
              {f"{s} {w}": shape_times(t) for (s, w), t in pr["times"].items()}),
        entry("probe_hits", "kmer_id_tpu_torch/csrc/probe.cu",
              "kmer_id_tpu/parallel/fpsharded.py:324", pr["hits_times"][("db0/2", "mixed")],
              pr["hits_max_abs_err"],
              {f"{r} {w}": shape_times(t) for (r, w), t in pr["hits_times"].items()}),
        entry("compact_ranks", "kmer_id_tpu_torch/csrc/compact.cu",
              "kmer_id_tpu/ops/compact.py:101", kr["times"]["legacy_nx"], kr["max_abs_err"],
              {name: shape_times(t) for name, t in kr["times"].items()}),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-rank"]:
        sys.exit(grid_rank(json.loads(sys.argv[2])))
    sys.exit(main())
