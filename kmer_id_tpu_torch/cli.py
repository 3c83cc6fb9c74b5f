"""Command line of the PyTorch port.

    python -m kmer_id_tpu_torch.cli classify-nx FASTQ_DIR --db-dir DIR [...]
    python -m kmer_id_tpu_torch.cli classify-jobs -name DB -jname JOBS [-target T] [...]
    python -m kmer_id_tpu_torch.cli classify-m3 -wdir DIR -f1 READS [-f2 READS|none] [...]
    python -m kmer_id_tpu_torch.cli mitokmer -w DIR -d OUT -i READS1 READS2|none [...]
    python -m kmer_id_tpu_torch.cli readc --jobs-name JOBS --folder DB [...]
    python -m kmer_id_tpu_torch.cli build-db -name DB -fadir DIR [-outdir DIR] [--root R] [--spill]
    python -m kmer_id_tpu_torch.cli pack-db PROBES OUT_DIR --num-targ N
    python -m kmer_id_tpu_torch.cli report-b10 RESULT_DIR REFKEY OUT_CSV [--no-default-excludes]
    python -m kmer_id_tpu_torch.cli report-c3 RESULT_DIR REFKEY OUT_CSV

Each subcommand takes the flags of its namesake in ``kmer_id_tpu.cli`` and
writes the same files.  The classify subcommands take ``--batch-size
--max-len --cache-dir --engine {fp,legacy} --profile DIR`` (a
``torch.profiler`` trace of classify-nx, classify-jobs and classify-m3,
written as Chrome trace JSON into DIR, with the samples' ``kmerid::`` spans
of utils/timing.py on every thread) and ``--device``, which defaults to
``cuda`` and fails when no CUDA device is present.  ``build-db`` runs on
the host (numpy and the g++-built db/native library; ``--spill
--spill-shard-bits --spill-batch-mb`` for the disk-spilled build).

The grid (parallel/): ``classify-nx``, ``classify-jobs`` and ``readc`` with
``--mesh-data D --mesh-db K``, D x K > 1, run the sharded engine of
``--engine`` (``ShardedFpClassifier`` or ``ShardedClassifier``) on a grid
of D x K ranks, one process per device:

* without ``--num-processes`` (JAX's one-process mesh) the command starts
  D x K local ranks of itself, rank r on ``cuda:r`` (or on the CPU under
  ``--device cpu``, over gloo), refuses when the card count is short, and
  exits non-zero when a rank fails (the others are stopped after a grace
  period);
* with ``--coordinator HOST:PORT --num-processes N --process-id I`` this
  process is rank I of N (D x K must be N): ``--device cuda`` means
  ``cuda:(I % card count)``, ``cuda:k`` is taken as given; it joins the
  process group (NCCL on a card, gloo on the CPU) and runs the startup
  health check first.

One rank is one device: the one intended difference from JAX, where one
process may hold several.  ``classify-m3`` and ``mitokmer`` accept the mesh
flags and do not use them, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.utils.logging import log, set_verbosity
from kmer_id_tpu_torch.utils.timing import profile_trace, tracing

GRID_CMDS = ("classify-nx", "classify-jobs", "readc")  # the subcommands that run a grid
RANK_GRACE_S = 60.0  # after a rank fails, how long the others get to end


def _add_engine_args(p):
    p.add_argument("--mesh-data", type=int, default=1, help="data-parallel axis size")
    p.add_argument("--mesh-db", type=int, default=1, help="DB shard axis size")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--cache-dir", default=None, help="packed-DB artifact cache dir")
    p.add_argument("--engine", choices=("fp", "legacy"), default="fp",
                   help="fp = fingerprint engine; legacy = cuckoo-table engine")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of rank 0's store (multi-process runs)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run, with the samples' "
                   "kmerid:: spans, to DIR")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N, cpu)")


def _preset(variant: str, args, **overrides) -> ClassifyConfig:
    return ClassifyConfig.preset(variant, batch_size=args.batch_size, max_len=args.max_len,
                                 engine=args.engine, **overrides)


def _rank0_first(fn):
    """``fn()`` on rank 0, then on the other ranks (a cache it may write is
    written once, before anyone reads it); just ``fn()`` without a grid.
    Rank 0 tells the others whether it succeeded: when it raised, they exit
    too instead of waiting for it."""
    import torch.distributed as dist

    from kmer_id_tpu_torch.engine.pipeline import world_size

    if world_size() == 1:
        return fn()
    out, err = None, None
    if dist.get_rank() == 0:
        try:
            out = fn()
        except Exception as e:  # re-raised below, once the others know
            err = e
    ok = [err is None]
    dist.broadcast_object_list(ok, src=0)
    if err is not None:
        raise err
    if not ok[0]:
        raise SystemExit("rank 0 failed to load the DB")
    return out if dist.get_rank() == 0 else fn()


def _make_classifier(db, cfg, args):
    """The JAX CLI's choice (``kmer_id_tpu/cli.py:45-62``): on a grid of
    more than one rank the sharded engine of ``--engine``, else the
    single-device engine of ``make_classifier``."""
    from kmer_id_tpu_torch.engine.pipeline import load_or_build_fpdb, make_classifier

    if args.mesh_data * args.mesh_db > 1:
        from kmer_id_tpu_torch.parallel import ShardedClassifier, ShardedFpClassifier, make_mesh

        grid = make_mesh(data=args.mesh_data, db=args.mesh_db, device=args.device)
        if args.engine == "fp":
            fp = _rank0_first(lambda: load_or_build_fpdb(db, args.cache_dir))
            return ShardedFpClassifier(db.packed, db.taxonomy, grid, cfg.batch_size,
                                       cfg.max_len, fpdb=fp)
        return ShardedClassifier(db.packed, db.taxonomy, grid, cfg.batch_size, cfg.max_len)
    return make_classifier(db, cfg, cache_dir=args.cache_dir, device=args.device)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_ranks(argv: list, args) -> int:
    """JAX's one-process mesh on D x K local devices: this command again as
    each rank of a D x K grid (rank r on ``cuda:r``, or on the CPU), over a
    store on a free local port.  Returns 0 when every rank exits 0, else
    the first failing rank's exit code; once a rank has failed, the rest
    get ``RANK_GRACE_S`` seconds to end and are then killed."""
    import torch

    n = args.mesh_data * args.mesh_db
    dev = torch.device(args.device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"mesh {args.mesh_data}x{args.mesh_db} needs {n} devices, "
                             f"have {have}")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmer_id_tpu_torch.cli", *argv, "--coordinator", coord,
         "--num-processes", str(n), "--process-id", str(r),
         "--device", f"cuda:{r}" if dev.type == "cuda" else "cpu"], env=env)
        for r in range(n)]
    failed_at = None
    try:
        while any(p.poll() is None for p in procs):
            if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > RANK_GRACE_S:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    log(f"grid {args.mesh_data}x{args.mesh_db}: rank exit codes {rcs}")
    return next((rc for rc in rcs if rc != 0), 0)


def _join_grid(args) -> None:
    """This process as rank ``--process-id`` of ``--num-processes``: its
    device, the process group and the startup health check (JAX's
    ``SystemExit`` on a failure, ``kmer_id_tpu/cli.py:147-164``)."""
    import torch
    import torch.distributed as dist

    from kmer_id_tpu_torch.parallel.distributed import health_check, initialize

    n = args.num_processes
    if args.cmd in GRID_CMDS and n > 1 and args.mesh_data * args.mesh_db != n:
        raise ValueError(f"--num-processes {n} needs --mesh-data x --mesh-db == {n}, "
                         f"not {args.mesh_data}x{args.mesh_db}")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device '{dev}' requested but torch.cuda.is_available() is "
                               "False")
        if dev.index is None:
            dev = torch.device("cuda", args.process_id % torch.cuda.device_count())
    args.device = str(dev)
    initialize(args.coordinator, n, args.process_id, dev)
    if n > 1 and dist.get_world_size() != n:
        raise SystemExit(f"the process group came up with {dist.get_world_size()} ranks, "
                         f"expected {n}")
    h = health_check(dev)
    log(f"health: {h}")
    if not h["ok"]:
        raise SystemExit(f"device health check failed: {h}")


def _run_jobs(name: str, jobs_name: str, args):
    """vf6 over ``<root>/<jobs_name>`` against the DB ``<root>/<name>/<name>_*``."""
    from kmer_id_tpu_torch.engine.pipeline import load_db, run_vf6

    wdir = os.path.join(args.root, name)
    db = _rank0_first(lambda: load_db(
        os.path.join(wdir, f"{name}_data.txt"),
        os.path.join(wdir, f"{name}_tree.txt"),
        os.path.join(wdir, f"{name}_probes.txt.gz"),
        cache_dir=args.cache_dir,
    ))
    cfg = _preset("vf6", args, save_target=args.target)
    clf = _make_classifier(db, cfg, args)
    with profile_trace(args.profile if args.cmd == "classify-jobs" else None):
        run_vf6(name, jobs_name, db, cfg, root=args.root, clf=clf)
    return wdir


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="kmer_id_tpu_torch")
    ap.add_argument("-v", "--verbose", action="count", default=1)
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-db", help="3-pass probe DB construction")
    b.add_argument("-name", required=True)
    b.add_argument("-fadir", default="")
    b.add_argument("-outdir", default="")
    b.add_argument("--root", default=".")
    b.add_argument("--spill", action="store_true",
                   help="disk-spilled bounded-memory build (corpus-scale DBs)")
    b.add_argument("--spill-shard-bits", type=int, default=6)
    b.add_argument("--spill-batch-mb", type=int, default=1024)

    nx = sub.add_parser("classify-nx", help="batch-classify paired samples in a dir")
    nx.add_argument("fastq_dir")
    nx.add_argument("--db-dir", default="./bact10")
    nx.add_argument("--data", default=None, help="override *data.txt path")
    nx.add_argument("--tree", default=None)
    nx.add_argument("--probes", default=None)
    nx.add_argument("--e1", default="_R1_tr.fastq.gz")
    nx.add_argument("--e2", default="_R2_tr.fastq.gz")
    nx.add_argument("--num-targ", type=int, default=5982)
    nx.add_argument("--fasta", action="store_true", help="FASTA mode (FASTQ=0)")
    nx.add_argument("--resume", action="store_true")
    nx.add_argument("--metrics", default=None, metavar="JSONL",
                    help="write per-sample metrics, with each sample's spans and "
                    "counters under 'stages', to this JSONL file")
    _add_engine_args(nx)

    vj = sub.add_parser("classify-jobs", help="vf6 job-based classification")
    vj.add_argument("-name", required=True)
    vj.add_argument("-jname", required=True)
    vj.add_argument("-fadir", default="")
    vj.add_argument("-target", type=int, default=0)
    vj.add_argument("--root", default=".")
    _add_engine_args(vj)

    rb = sub.add_parser("report-b10", help="readbatch_10-compatible rollup")
    rb.add_argument("result_dir")
    rb.add_argument("refkey")
    rb.add_argument("out_csv")
    rb.add_argument("--no-default-excludes", action="store_true")

    rc3 = sub.add_parser("report-c3", help="readbatch_c3-compatible rollup")
    rc3.add_argument("result_dir")
    rc3.add_argument("refkey")
    rc3.add_argument("out_csv")

    m3 = sub.add_parser("classify-m3", help="single-sample mitochondrial run")
    m3.add_argument("-wdir", required=True)
    m3.add_argument("-f1", required=True)
    m3.add_argument("-f2", default="none")
    _add_engine_args(m3)

    mk = sub.add_parser("mitokmer", help="Galaxy orchestrator (kmer_read_m3.py)")
    mk.add_argument("-w", dest="wdir", required=True)
    mk.add_argument("-d", dest="outdir", required=True)
    mk.add_argument("-i", dest="inputs", nargs=2, required=True)
    mk.add_argument("--strip-cr", action="store_true",
                    help="normalize CRLF refkeys (reference crashes on them)")
    _add_engine_args(mk)

    rd = sub.add_parser("readc", help="chloroplast orchestrator (kmer_readc.py)")
    rd.add_argument("--jobs-name", required=True)
    rd.add_argument("--folder", required=True)
    rd.add_argument("--fadir", default="")
    rd.add_argument("--target", type=int, default=0)
    rd.add_argument("--root", default=".")
    _add_engine_args(rd)

    pk = sub.add_parser("pack-db", help="probes text -> packed mmap artifact")
    pk.add_argument("probes")
    pk.add_argument("out_dir")
    pk.add_argument("--num-targ", type=int, required=True)

    args = ap.parse_args(argv)
    set_verbosity(args.verbose)

    if args.cmd in GRID_CMDS and args.mesh_data * args.mesh_db > 1 and not args.num_processes:
        return _spawn_ranks(argv, args)
    if getattr(args, "num_processes", None):
        from kmer_id_tpu_torch.parallel.distributed import shutdown

        _join_grid(args)
        ok = False
        try:
            rc = _run(args)
            ok = True
        finally:
            shutdown(barrier=ok)
        return rc
    return _run(args)


def _run(args) -> int:
    if args.cmd == "build-db":
        if args.spill:
            from kmer_id_tpu_torch.db.spill import build_probes_spill

            res = build_probes_spill(args.name, args.fadir, args.outdir, root=args.root,
                                     shard_bits=args.spill_shard_bits,
                                     batch_bytes=args.spill_batch_mb << 20)
        else:
            from kmer_id_tpu_torch.db.build import build_probes

            res = build_probes(args.name, args.fadir, args.outdir, root=args.root)
        log(f"built {len(res.records)} probes over {res.num_targ} targets")
        return 0

    if args.cmd == "pack-db":
        from kmer_id_tpu_torch.db.probes import pack_probes, parse_probes_text, save_packed

        packed = pack_probes(parse_probes_text(args.probes), num_targ=args.num_targ)
        save_packed(packed, args.out_dir)
        log(f"packed {len(packed)} unique keys -> {args.out_dir}")
        return 0

    if args.cmd == "report-b10":
        from kmer_id_tpu_torch.report.rollup import readbatch_10

        readbatch_10(args.result_dir, args.refkey, args.out_csv,
                     exclude=set() if args.no_default_excludes else None)
        return 0

    if args.cmd == "report-c3":
        from kmer_id_tpu_torch.report.rollup import readbatch_c3

        readbatch_c3(args.result_dir, args.refkey, args.out_csv)
        return 0

    if args.cmd == "classify-nx":
        from kmer_id_tpu_torch.engine.pipeline import load_db, run_nx

        cfg = _preset("nx", args, num_targ=args.num_targ)
        dbd = args.db_dir
        db = _rank0_first(lambda: load_db(
            args.data or os.path.join(dbd, "bData10.txt"),
            args.tree or os.path.join(dbd, "btree_10.txt"),
            args.probes or os.path.join(dbd, "probes10.txt.gz"),
            num_targ=args.num_targ,
            cache_dir=args.cache_dir,
        ))
        clf = _make_classifier(db, cfg, args)
        with profile_trace(args.profile), tracing(args.metrics):
            run_nx(args.fastq_dir, db, cfg, e1=args.e1, e2=args.e2,
                   fasta_mode=args.fasta, resume=args.resume, clf=clf,
                   metrics_path=args.metrics)
        return 0

    if args.cmd == "classify-jobs":
        _run_jobs(args.name, args.jname, args)
        return 0

    if args.cmd in ("classify-m3", "mitokmer"):
        from kmer_id_tpu_torch.engine.pipeline import run_m3

        cfg = _preset("m3", args)
        if args.cmd == "classify-m3":
            with profile_trace(args.profile):
                run_m3(args.wdir, args.f1, args.f2, cfg=cfg, device=args.device)
            return 0
        from kmer_id_tpu_torch.report.rollup import m3_report

        wdir = args.wdir + "/"
        run_m3(wdir, args.inputs[0], args.inputs[1], cfg=cfg, device=args.device)
        os.makedirs(args.outdir, exist_ok=True)
        m3_report(
            os.path.join(wdir, "result.txt"),
            os.path.join(wdir, "mitochondria_refkey.txt"),
            os.path.join(args.outdir, "mitokmer_result.csv"),
            strip_cr=args.strip_cr,
        )
        return 0

    if args.cmd == "readc":
        from kmer_id_tpu_torch.engine.pipeline import is_main_process
        from kmer_id_tpu_torch.report.rollup import readc_report

        wdir = _run_jobs(args.folder, args.jobs_name, args)
        if not is_main_process():  # rank 0 writes the report
            return 0
        jdir = os.path.join(args.root, args.jobs_name)
        readc_report(
            jdir, args.jobs_name,
            os.path.join(wdir, f"{args.folder}_key.txt"),
            os.path.join(wdir, f"{args.folder}_count.txt"),
            os.path.join(jdir, f"{args.jobs_name}.csv"),
        )
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
