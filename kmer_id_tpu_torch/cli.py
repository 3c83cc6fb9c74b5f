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
written as Chrome trace JSON into DIR) and ``--device``, which defaults to
``cuda`` and fails when no CUDA device is present.  ``build-db`` runs on
the host (numpy and the g++-built db/native library; ``--spill
--spill-shard-bits --spill-batch-mb`` for the disk-spilled build).  Not
ported, and refused with ``NotImplementedError``: a mesh of more than one
device (``--mesh-data``/``--mesh-db`` > 1) and the multi-host flags
(``--coordinator --num-processes --process-id``).
"""

from __future__ import annotations

import argparse
import os
import sys

from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.utils.logging import log, set_verbosity
from kmer_id_tpu_torch.utils.timing import profile_trace

NOT_PORTED = "not yet ported to kmer_id_tpu_torch (ROADMAP.md §1)"


def _add_engine_args(p):
    p.add_argument("--mesh-data", type=int, default=1, help="data-parallel axis size (1 only)")
    p.add_argument("--mesh-db", type=int, default=1, help="DB shard axis size (1 only)")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--cache-dir", default=None, help="packed-DB artifact cache dir")
    p.add_argument("--engine", choices=("fp", "legacy"), default="fp",
                   help="fp = fingerprint engine; legacy = cuckoo-table engine")
    p.add_argument("--coordinator", default=None, help="multi-host runs: not ported")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N, cpu)")


def _preset(variant: str, args, **overrides) -> ClassifyConfig:
    return ClassifyConfig.preset(variant, batch_size=args.batch_size, max_len=args.max_len,
                                 engine=args.engine, **overrides)


def _run_jobs(name: str, jobs_name: str, args):
    """vf6 over ``<root>/<jobs_name>`` against the DB ``<root>/<name>/<name>_*``."""
    from kmer_id_tpu_torch.engine.pipeline import load_db, make_classifier, run_vf6

    wdir = os.path.join(args.root, name)
    db = load_db(
        os.path.join(wdir, f"{name}_data.txt"),
        os.path.join(wdir, f"{name}_tree.txt"),
        os.path.join(wdir, f"{name}_probes.txt.gz"),
        cache_dir=args.cache_dir,
    )
    cfg = _preset("vf6", args, save_target=args.target)
    clf = make_classifier(db, cfg, cache_dir=args.cache_dir, device=args.device)
    with profile_trace(args.profile if args.cmd == "classify-jobs" else None):
        run_vf6(name, jobs_name, db, cfg, root=args.root, clf=clf)
    return wdir


def main(argv=None):
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
                    help="write per-sample metrics to this JSONL file")
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

    if getattr(args, "mesh_data", 1) * getattr(args, "mesh_db", 1) > 1:
        raise NotImplementedError(f"a mesh of more than one device: {NOT_PORTED}")
    if any(getattr(args, k, None) is not None
           for k in ("coordinator", "num_processes", "process_id")):
        raise NotImplementedError(f"multi-host runs: {NOT_PORTED}")

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
        from kmer_id_tpu_torch.engine.pipeline import load_db, make_classifier, run_nx

        cfg = _preset("nx", args, num_targ=args.num_targ)
        dbd = args.db_dir
        db = load_db(
            args.data or os.path.join(dbd, "bData10.txt"),
            args.tree or os.path.join(dbd, "btree_10.txt"),
            args.probes or os.path.join(dbd, "probes10.txt.gz"),
            num_targ=args.num_targ,
            cache_dir=args.cache_dir,
        )
        clf = make_classifier(db, cfg, cache_dir=args.cache_dir, device=args.device)
        with profile_trace(args.profile):
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
        from kmer_id_tpu_torch.report.rollup import readc_report

        wdir = _run_jobs(args.folder, args.jobs_name, args)
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
