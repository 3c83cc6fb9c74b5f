#!/usr/bin/env python3
"""The port's tracing (``kmer_id_tpu_torch/utils/timing.py``) on one card:
what it costs when on, what it reads inside the sample loop, and what a
``--profile`` trace shows.

    python3 tools/trace_check.py [--cells mito.reads bact10.deep] [--rounds 12]
                                 [--seed N] [--profile-probes N] [--profile-reads N]
                                 [--out DIR]

1. **Span cost**: one span site entered and left 200,000 times with tracing
   off (``timing.span(None, ...)``) and on (a ``SampleTrace``, no profiler),
   ns a site.
2. **On against off**, per cell of ``BENCHMARK.json``: the cell's DB, input
   pool and program set up as ``benchmark/cell.py`` sets them up, one
   warm-up request, then ``--rounds`` rounds of three whole requests, one
   per arm: the switch off, on, and on with no span reading the thread's
   CPU clock (``timing.CPU_SPANS`` empty).  A round serves one request in
   each arm, in an order turned each round, each timed to a synchronize.
   Then the same rounds of the native feeder alone over one request, with
   no trace, a trace, and a trace with no clock.  Prints each arm's median
   wall and the median and quartiles of its ratios to the same round's
   ``off``, and, from the ``on`` arm's summaries (no profiler), spans per
   batch, the counters of the decoder (``pack.plane``, ``inflate.*``,
   ``feed.overlap``) and the in-loop readings of the benchmark's metrics of
   the spans (benchmark/spans.py), with ``finish``'s wait for the feed
   threads (``feed.join``).
3. **``classify-nx --profile``**: a DB of ``--profile-probes`` random
   probes on 5,982 targets and one pair of ``--profile-reads`` reads a file
   of the deep mix, through the CLI with ``--profile`` and ``--metrics``.
   From the Chrome trace: the ``kmerid::`` spans on each thread, the
   device's busy share over the sample, and its longest idle gaps, each with
   the spans open across its middle; from the ``--metrics`` record, the
   decoder's counters and the ``feed.join`` span.

Writes ``result.json`` and the gzipped Chrome trace into ``--out``
(default ``build/trace_check/``); the last line of standard output is the
same JSON without the summaries.  Needs one CUDA card; ``--device cpu`` runs the
same steps on the CPU, which is a rehearsal only at toy sizes (the cells
loaded with ``benchmark/tests/toy.py``'s overrides).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def say(msg: str) -> None:
    print(f"[trace_check] {msg}", file=sys.stderr, flush=True)


def sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def span_cost(n: int = 200_000, per_trace: int = 1_500) -> dict:
    """ns per span site, off and on (a new trace every ``per_trace`` spans,
    about a deep sample's count; a span of ``timing.CPU_SPANS`` apart), and
    of each clock read."""
    from kmer_id_tpu_torch.utils import timing

    def each(fn) -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t) / n

    def off():
        with timing.span(None, "x", 1):
            pass

    tr = [timing.SampleTrace(), 0]

    def on(name="submit"):
        if tr[1] == per_trace:
            tr[:] = [timing.SampleTrace(), 0]
        tr[1] += 1
        with timing.span(tr[0], name, 1):
            pass

    def sync_off():
        with timing.sync():  # no current trace: the engine's sites off
            pass

    return {"off_ns": each(off), "on_ns": each(on),
            "on_cpu_clock_ns": each(lambda: on("decode.fill")), "sync_off_ns": each(sync_off),
            "thread_time_ns": each(time.thread_time_ns),
            "perf_counter_ns": each(time.perf_counter_ns)}


def quartiles(xs: list) -> list:
    return statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3


ARMS = ("off", "on", "on_noclock")


def _arm(arm: str):
    """Sets the switch (and, for ``on_noclock``, no span reads the thread's
    CPU clock) for one arm; returns the undo."""
    from kmer_id_tpu_torch.utils import timing

    prev, spans = timing.set_tracing(arm != "off"), timing.CPU_SPANS
    if arm == "on_noclock":
        timing.CPU_SPANS = frozenset()

    def undo():
        timing.set_tracing(prev)
        timing.CPU_SPANS = spans
    return undo


def _ratios(walls: dict) -> dict:
    """Each arm's walls against the same round's ``off``: median and
    quartiles of the ratios, and of the walls."""
    out = {}
    for arm, w in walls.items():
        d = {"median_s": statistics.median(w), "quartiles_s": quartiles(w), "all_s": w}
        if arm != "off":
            r = [a / b for a, b in zip(w, walls["off"])]
            d.update(over_off_median=statistics.median(r), over_off_quartiles=quartiles(r),
                     over_off_all=r)
        out[arm] = d
    return out


def on_off(name: str, seed: int, rounds: int, device: str) -> dict:
    """Whole requests of one cell in rounds of the three :data:`ARMS`, the
    same request in each arm of a round, the arms' order turned each round;
    then the feeder alone over one request in the same way."""
    from benchmark import spans, spec
    from benchmark.cell import Program, work_dir
    from benchmark.gen.db import make_db
    from benchmark.gen.samples import make_pool, write_pool
    from kmer_id_tpu_torch.io.native_feed import NativePlaneFeeder
    from kmer_id_tpu_torch.utils import timing

    if device == "cpu":  # a rehearsal at toy sizes
        from benchmark.tests import toy

        cell = toy.cell(name)
    else:
        cell = spec.load_cell(name)
    work = work_dir(name + ".trace_check")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t = time.perf_counter()
        db = make_db(seed, int(cell.config["probes"]), int(cell.config["num_targ"]), device)
        pool = make_pool(seed, cell.traffic, db)
        write_pool(pool, os.path.join(work, "in"), cell.driver)
        prog = Program(cell, db, device)
        out = os.path.join(work, "out")
        os.makedirs(out)
        prog.request(pool[0], os.path.join(out, "warmup"))
        sync(device)
        say(f"{name}: set up in {time.perf_counter() - t:.1f} s")
        walls = {arm: [] for arm in ARMS}
        got = []  # the "on" arm's summaries
        k = 0
        for r in range(rounds):
            req = pool[r % len(pool)]
            for arm in ARMS[r % 3:] + ARMS[: r % 3]:
                undo = _arm(arm)
                try:
                    t0 = time.perf_counter()
                    prog.request(req, os.path.join(out, f"r{k}"))
                    sync(device)
                    walls[arm].append(time.perf_counter() - t0)
                finally:
                    undo()
                if arm == "on":
                    got.append(timing.recent()[-1])
                k += 1
        cfg = prog.cfg
        fmt = "fastq_gz" if cell.driver == "nx" else None
        dec = {arm: [] for arm in ARMS}
        for r in range(rounds):
            for arm in ARMS[r % 3:] + ARMS[: r % 3]:
                undo = _arm(arm)
                try:
                    feeder = NativePlaneFeeder(cfg.batch_size, cfg.max_len, cfg.u_is_t,
                                               trace=timing.new_trace())
                    t0 = time.perf_counter()
                    for f in pool[0].files:
                        for _ in feeder.feed_path(f.path, fmt=fmt):
                            pass
                    for _ in feeder.flush():
                        pass
                    dec[arm].append(time.perf_counter() - t0)
                finally:
                    undo()
        batches = sum(s["counters"].get("batches", 0) for s in got)
        pack_plane = sum(s["counters"].get("pack.plane", 0) for s in got)
        inflate = {c: sum(s["counters"].get(f"inflate.{c}", 0) for s in got)
                   for c in ("blocks", "waits", "wait_us")}
        # batches emitted while another file of the request decoded
        overlap = sum(s["counters"].get("feed.overlap", 0) for s in got)
        n_spans = sum(v["count"] for s in got for v in s["spans"].values())
        res = {
            "rounds": rounds,
            "request": _ratios(walls),
            "decode_alone": _ratios(dec),
            "spans_per_batch": n_spans / batches if batches else None,
            "batches_per_request": batches / len(got) if got else None,
            "batches": batches,
            "pack_plane": pack_plane,  # of them, shipped as u8 planes (exceptions overflowed)
            # the fills' read-ahead blocks, the waits for them and the us waited
            "inflate": inflate,
            "feed_overlap": overlap,
            "in_loop": {
                "decode_fill_ms_per_batch": spans.ms_per_batch(got, "decode.fill"),
                "decode_pack_ms_per_batch": spans.ms_per_batch(got, "decode.pack"),
                "decode_offcpu_ms_per_batch": spans.ms_per_batch(
                    got, "decode.fill", "decode.pack", offcpu=True),
                "decode_inflate_wait_ms_per_batch":
                    inflate["wait_us"] / 1e3 / batches if batches else None,
                "decode_overlap_pct": 100 * overlap / batches if batches else None,
                "feed_wait_ms_per_batch": spans.ms_per_batch(got, "feed.wait"),
                "submit_ms_per_batch": spans.ms_per_batch(got, "submit"),
                "submit_wait_ms_per_batch": spans.ms_per_batch(got, "submit.wait"),
                "submit_sync_ms_per_batch": spans.ms_per_batch(got, "sync"),
                "collect_ms_per_batch": spans.ms_per_batch(got, "collect"),
                "collect_fetch_ms_per_batch": spans.ms_per_batch(got, "collect.fetch"),
                "collect_replay_ms_per_batch": spans.ms_per_batch(got, "collect.replay"),
                "collect_lane_ms_per_batch": spans.ms_per_batch(got, "collect.lane"),
                "collect_lane_sync_ms_per_batch": spans.ms_per_batch(got, "collect.lane.sync"),
                "collect_account_ms_per_batch": spans.ms_per_batch(got, "collect.account"),
                "fetches_per_batch": spans.count_per_batch(got, "fetches"),
                "sample_overhead_ms": spans.ms_per_sample(got, "sample.start",
                                                          "sample.finish", "sample.write"),
                "feed_join_ms_per_sample": spans.ms_per_sample(got, "feed.join"),
            },
            "summaries": got,
        }
        rq, da = res["request"], res["decode_alone"]
        say(f"{name}: request off {rq['off']['median_s']:.4f} s; on/off "
            f"{rq['on']['over_off_median']:.4f} {rq['on']['over_off_quartiles']}, "
            f"no clock/off {rq['on_noclock']['over_off_median']:.4f} "
            f"{rq['on_noclock']['over_off_quartiles']}; decode alone off "
            f"{da['off']['median_s']:.4f} s, on/off {da['on']['over_off_median']:.4f} "
            f"{da['on']['over_off_quartiles']}, no clock/off "
            f"{da['on_noclock']['over_off_median']:.4f}; {res['spans_per_batch']} spans a batch; "
            f"batches {batches}, pack.plane {pack_plane}, inflate.blocks "
            f"{inflate['blocks']}, inflate.waits {inflate['waits']}, inflate.wait_us "
            f"{inflate['wait_us']}, feed.overlap {overlap}, feed.join "
            f"{res['in_loop']['feed_join_ms_per_sample']} ms a request")
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def profile_cli(seed: int, n_probes: int, n_reads: int, device: str, out: str) -> dict:
    """classify-nx --profile on one sample; the Chrome trace read back."""
    import numpy as np

    from benchmark import spec
    from benchmark.gen.db import make_db
    from benchmark.gen.samples import make_pool, write_pool
    from kmer_id_tpu_torch.db.probes import ProbeRecords, write_probes_text

    cell = spec.load_cell("bact10.deep")
    work = tempfile.mkdtemp(prefix="kmerid-trace-check-")
    try:
        db = make_db(seed, n_probes, int(cell.config["num_targ"]), device)
        dbd = os.path.join(work, "db")
        os.makedirs(dbd)
        n = len(db.keys)
        with open(os.path.join(dbd, "bData10.txt"), "w") as f:
            f.write("".join(f"{t}\tACC{t}\n" for t in range(2, db.num_targ)))
        with open(os.path.join(dbd, "btree_10.txt"), "w") as f:
            f.write("".join(f"{db.parent[t]}\t{t}\n" for t in range(2, db.num_targ)))
        text = os.path.join(dbd, "probes10.txt")
        write_probes_text(ProbeRecords(keys=db.keys, target=db.targets,
                                       org=np.zeros(n, np.int32), position=np.zeros(n, np.int32),
                                       fstrand=np.ones(n, bool), count=np.ones(n, np.int32)),
                          text)
        with open(text, "rb") as f, gzip.open(text + ".gz", "wb", compresslevel=1) as g:
            shutil.copyfileobj(f, g)
        os.remove(text)
        traffic = dict(cell.traffic, reads_per_file=n_reads, pool=1)
        fq = os.path.join(work, "fastq")
        write_pool(make_pool(seed, traffic, db), fq, "nx")
        prof = os.path.join(work, "prof")
        metrics = os.path.join(work, "m.jsonl")
        preset = cell.preset
        cmd = [sys.executable, "-m", "kmer_id_tpu_torch.cli", "classify-nx", fq, "--db-dir", dbd,
               "--num-targ", str(db.num_targ), "--batch-size", str(preset["batch_size"]),
               "--max-len", str(preset["max_len"]), "--profile", prof, "--metrics", metrics,
               "--device", device]
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=1800)
        if p.returncode != 0:
            raise RuntimeError(f"classify-nx failed ({p.returncode}):\n{p.stderr[-4000:]}")
        say(f"classify-nx --profile: {time.perf_counter() - t:.1f} s")
        (path,) = [os.path.join(prof, x) for x in os.listdir(prof)]
        os.makedirs(out, exist_ok=True)
        kept = os.path.join(out, "classify_nx_trace.json.gz")
        with open(path, "rb") as f, gzip.open(kept, "wb") as g:
            shutil.copyfileobj(f, g)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        with open(metrics) as f:
            record = json.loads(f.readline())
        counters = record.get("stages", {}).get("counters", {})
        decoder = {k: counters.get(k) for k in ("batches", "feed.overlap", "inflate.blocks",
                                                "inflate.waits", "inflate.wait_us")}
        join = record.get("stages", {}).get("spans", {}).get("feed.join")
        decoder["feed.join_ms"] = join["wall_ns"] / 1e6 if join else None
        say(f"classify-nx --metrics: {decoder}")
        return dict(read_trace(events), metrics_record=record, decoder=decoder,
                    trace_file=kept)
    finally:
        shutil.rmtree(work, ignore_errors=True)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(events: list) -> dict:
    """The ``kmerid::`` spans per thread, the device's busy share over the
    sample (``sample.start`` to ``sample.finish``) and its longest idle
    gaps with the spans open across each."""
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[(e.get("pid"), e.get("tid"))] = e.get("args", {}).get("name", "")
    spans = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("kmerid::")
             and e.get("cat") != "gpu_user_annotation"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    per_thread: dict = {}
    for e in spans:
        key = f"{e.get('pid')}/{e.get('tid')} {names.get((e.get('pid'), e.get('tid')), '')}"
        d = per_thread.setdefault(key.strip(), {})
        d[e["name"][8:]] = d.get(e["name"][8:], 0) + 1
    starts = [e["ts"] for e in spans if e["name"] == "kmerid::sample.start"]
    ends = [e["ts"] + e["dur"] for e in spans if e["name"] == "kmerid::sample.finish"]
    out = {"threads": per_thread, "device_events": len(dev)}
    if not starts or not ends or not dev:
        return out
    lo, hi = min(starts), max(ends)
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if b < lo or a > hi:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    longest = []
    for a, b in gaps[:5]:
        mid = (a + b) / 2
        open_ = sorted({f"{e['name'][8:]}@{e.get('tid')}" for e in spans
                        if e["ts"] <= mid <= e["ts"] + e["dur"]})
        longest.append({"ms": (b - a) / 1e3, "open": open_})
    out.update(sample_ms=(hi - lo) / 1e3, device_busy_ms=busy / 1e3,
               device_idle_pct=100.0 * (1 - busy / (hi - lo)), idle_gaps=longest)
    return out


def card() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return p.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*", default=["mito.reads", "bact10.deep"])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=2147490101)
    ap.add_argument("--profile-probes", type=int, default=1_000_000)
    ap.add_argument("--profile-reads", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "trace_check"))
    args = ap.parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    res = {"card": card() if args.device != "cpu" else "cpu",
           "torch": torch.__version__, "python": sys.version.split()[0],
           "span_cost": span_cost()}
    say(f"span cost: {res['span_cost']}")
    for i, name in enumerate(args.cells):
        res[name] = on_off(name, args.seed + i, args.rounds, args.device)
    if args.profile_reads:
        res["classify_nx_profile"] = profile_cli(args.seed, args.profile_probes,
                                                 args.profile_reads, args.device, args.out)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(res, f, indent=1)
    short = {k: v for k, v in res.items()}
    for name in args.cells:
        short[name] = {k: v for k, v in res[name].items() if k != "summaries"}
        for part in ("request", "decode_alone"):
            short[name][part] = {arm: {k: v for k, v in d.items() if not k.endswith("all_s")
                                       and k != "over_off_all"}
                                 for arm, d in res[name][part].items()}
    if "classify_nx_profile" in short:
        short["classify_nx_profile"] = {k: v for k, v in res["classify_nx_profile"].items()
                                        if k != "metrics_record"}
    print(json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
