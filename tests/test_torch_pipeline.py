"""classify-nx through the PyTorch port's CLI (on the CPU) against the JAX
package's CLI on copies of one directory of paired FASTQ.gz samples:
``_result.txt`` and ``_reads.txt`` must be byte-identical, and equal to the
reference simulator (tests/refsim.py), with the fingerprint engine and with
``--engine legacy``.  Also: the port never imports jax, both feed paths
agree, the resume manifest, the per-read and per-batch accounting agree,
``--profile`` writes a trace, and the mesh and multi-process flags, once
refused, run (tests/test_torch_multiproc.py holds the grid in full).
"""

import gzip
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch

from kmer_id_tpu.core import codec
from kmer_id_tpu.db.probes import ProbeRecords, write_probes_text
from kmer_id_tpu.io.fastx import iter_fastq_gz
from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.io.batch import RowMeta
from tests.refsim import RefSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_TARG = 12
ARGS = ["--num-targ", str(NUM_TARG), "--batch-size", "32", "--max-len", "128"]


def _dna(r, n):
    return "".join("ACGT"[i] for i in r.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A probe DB on a random tree and two paired samples whose reads carry
    0-3 planted probes (either strand), Ns, low-quality tails, and a few
    probe-dense reads (dense path and candidate-overflow replay)."""
    r = np.random.default_rng(2026)
    parent = [1] * NUM_TARG
    for i in range(3, NUM_TARG):
        parent[i] = int(r.integers(1, i))
    # probes: every window of a random genome, so a read copied from the
    # genome carries a probe at every window
    genome = r.integers(0, 4, size=700).astype(np.uint8)
    gstr = "".join("ACGT"[i] for i in genome)
    kmap = {int(k): int(r.integers(2, NUM_TARG))
            for k in np.unique(codec.canonical_kmers(genome)[0])}
    keys = np.array(sorted(kmap), dtype=np.uint64)
    n = len(keys)
    root = tmp_path_factory.mktemp("nx")
    dbdir = root / "db"
    dbdir.mkdir()
    (dbdir / "bData10.txt").write_text(
        "".join(f"{t}\tACC{t}\n" for t in range(2, NUM_TARG)))
    (dbdir / "btree_10.txt").write_text(
        "".join(f"{parent[t]}\t{t}\n" for t in range(2, NUM_TARG)))
    write_probes_text(
        ProbeRecords(keys=keys, target=np.array([kmap[int(k)] for k in keys], np.int32),
                     org=np.zeros(n, np.int32), position=np.zeros(n, np.int32),
                     fstrand=np.ones(n, bool), count=np.ones(n, np.int32)),
        str(dbdir / "probes10.txt"),
    )
    with open(dbdir / "probes10.txt", "rb") as f, gzip.open(dbdir / "probes10.txt.gz", "wb") as g:
        g.write(f.read())
    klist = list(kmap)

    def probe(k):
        s = codec.key_to_string(k)
        return codec.key_to_string(codec.revcomp_key(k)) if r.random() < 0.5 else s

    fq = root / "fastq"
    fq.mkdir()
    for sample, nreads in (("sA", 150), ("sB", 90)):
        for mate in ("R1", "R2"):
            lines = []
            for i in range(nreads):
                seq = list(_dna(r, 100))
                for _ in range(int(r.integers(0, 4))):
                    p = int(r.integers(0, 70))
                    seq[p : p + 30] = probe(klist[int(r.integers(n))])
                if i % 37 == 5:  # probe-dense: > BLOOM_K windows, > 32 candidates
                    s0 = int(r.integers(0, len(gstr) - 100))
                    seq = list(gstr[s0 : s0 + 100])
                if r.random() < 0.03:
                    seq[int(r.integers(0, len(seq)))] = "N"
                qual = ["J"] * len(seq)
                if r.random() < 0.15:
                    qual[-20:] = ["#"] * 20
                lines.append(f"@{sample}.{mate}.{i}\n{''.join(seq)}\n+\n{''.join(qual)}\n")
            with gzip.open(fq / f"{sample}_{mate}_tr.fastq.gz", "wt") as f:
                f.write("".join(lines))
    return dict(root=root, dbdir=dbdir, fq=fq, kmap=kmap, parent=parent)


def _copy(world, name):
    d = world["root"] / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(world["fq"], d)
    return d


def _outputs(d, sample):
    return ((d / f"{sample}_result.txt").read_bytes(), (d / f"{sample}_reads.txt").read_bytes())


@pytest.fixture(scope="module")
def jax_run(world):
    from kmer_id_tpu import cli as jax_cli

    d = _copy(world, "jax")
    assert jax_cli.main(["classify-nx", str(d), "--db-dir", str(world["dbdir"])] + ARGS) == 0
    return d


def test_port_cli_matches_jax_cli_and_refsim(world, jax_run, tmp_path, monkeypatch):
    from kmer_id_tpu_torch import cli
    from kmer_id_tpu_torch.engine import fpclassify as F

    replays = []
    fp_slots = F.fp_slots
    monkeypatch.setattr(F, "fp_slots", lambda *a: replays.append(1) or fp_slots(*a))
    d = _copy(world, "torch")
    argv = ["classify-nx", str(d), "--db-dir", str(world["dbdir"]), "--device", "cpu",
            "--cache-dir", str(tmp_path / "cache")] + ARGS
    assert cli.main(argv) == 0
    assert replays  # the probe-dense reads took the overflow replay
    for sample in ("sA", "sB"):
        got = _outputs(d, sample)
        assert got == _outputs(jax_run, sample), sample
        sim = RefSim(world["kmap"], world["parent"], num_targ=NUM_TARG, u_is_t=False,
                     savenum=12, variant="nx")
        for mate in ("R1", "R2"):
            sim.feed(iter_fastq_gz(str(world["fq"] / f"{sample}_{mate}_tr.fastq.gz")))
        assert got[0].decode().splitlines() == sim.result_lines(), sample
        assert got[1].decode() == "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved)
        assert sum(sim.ucount) > 0 and len(sim.saved) > 0
    # a second run reads the packed and fingerprint caches written by the first
    assert (tmp_path / "cache" / "manifest.json").exists()
    assert (tmp_path / "cache" / "fp_manifest.json").exists()
    d2 = _copy(world, "torch_cached")
    assert cli.main(["classify-nx", str(d2)] + argv[2:]) == 0
    assert _outputs(d2, "sA") == _outputs(jax_run, "sA")


def test_python_feed_matches_native_feed(world, jax_run):
    from kmer_id_tpu_torch.engine.pipeline import (
        SampleProcessor,
        load_db,
        make_classifier,
    )

    db = load_db(str(world["dbdir"] / "bData10.txt"), str(world["dbdir"] / "btree_10.txt"),
                 str(world["dbdir"] / "probes10.txt.gz"), num_targ=NUM_TARG)
    cfg = ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=32, max_len=128)
    clf = make_classifier(db, cfg, device="cpu")
    outs = {}
    for native in (False, True):
        if native and not SampleProcessor(clf, cfg).native:
            pytest.skip("native decoder unavailable")
        buf = io.StringIO()
        sp = SampleProcessor(clf, cfg, reads_out=buf, use_native=native)
        for mate in ("R1", "R2"):
            sp.feed_file(str(world["fq"] / f"sA_{mate}_tr.fastq.gz"), fmt="fastq_gz")
        res = sp.finish()
        outs[native] = (res.gcount.tolist(), res.ucount.tolist(), res.reads, buf.getvalue())
    assert outs[False] == outs[True]
    assert outs[True][3].encode() == _outputs(jax_run, "sA")[1]


def test_resume_skips_done_samples(world):
    from kmer_id_tpu_torch.engine.pipeline import load_db, run_nx

    d = _copy(world, "resume")
    db = load_db(str(world["dbdir"] / "bData10.txt"), str(world["dbdir"] / "btree_10.txt"),
                 str(world["dbdir"] / "probes10.txt.gz"), num_targ=NUM_TARG)
    cfg = ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=32, max_len=128)
    assert sorted(run_nx(str(d), db, cfg, device="cpu")) == ["sA", "sB"]
    (d / "sA_result.txt").write_text("kept\n")
    assert run_nx(str(d), db, cfg, resume=True, device="cpu") == []
    assert (d / "sA_result.txt").read_text() == "kept\n"


def test_account_batch_equals_per_read_account():
    """The vectorized accounting equals the per-read one, saved reads and
    their order included."""
    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor

    class _Clf:
        num_targ, batch_size, max_len, device = 9, 8, 64, "cpu"

        def new_seen(self):
            return None

    r = np.random.default_rng(5)
    cfg = ClassifyConfig.preset("nx", num_targ=9, savenum=3)
    a, b = io.StringIO(), io.StringIO()
    pa = SampleProcessor(_Clf(), cfg, reads_out=a, use_native=False)
    pb = SampleProcessor(_Clf(), cfg, reads_out=b, use_native=False)
    for k in range(6):
        finals = r.integers(0, 9, size=40)
        metas = [RowMeta(acc=f"r{k}.{i}", trimmed_seq="ACGT" * (i % 3 + 1)) for i in range(40)]
        pa._account_batch(finals, metas)
        for f, m in zip(finals, metas):
            pb._account(int(f), m)
    assert a.getvalue() == b.getvalue() and a.getvalue()
    assert pa.gcount.tolist() == pb.gcount.tolist() and pa.reads == pb.reads == 240


@pytest.fixture(scope="module")
def jax_legacy_runs(world):
    """The JAX package's classify-nx with ``--engine legacy`` through its
    CLI (which on one device does not read the flag and runs the
    fingerprint engine) and through ``run_nx`` with a legacy config (its
    legacy engine)."""
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu.config import ClassifyConfig as JaxClassifyConfig
    from kmer_id_tpu.engine import pipeline as JP

    d = _copy(world, "jax_legacy")
    assert jax_cli.main(["classify-nx", str(d), "--db-dir", str(world["dbdir"]),
                         "--engine", "legacy"] + ARGS) == 0
    a = _copy(world, "jax_legacy_api")
    db = JP.load_db(str(world["dbdir"] / "bData10.txt"), str(world["dbdir"] / "btree_10.txt"),
                    str(world["dbdir"] / "probes10.txt.gz"), num_targ=NUM_TARG)
    cfg = JaxClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=32, max_len=128,
                                   engine="legacy")
    clf = JP.make_classifier(db, cfg)
    assert type(clf).__name__ == "Classifier"
    assert sorted(JP.run_nx(str(a), db, cfg, clf=clf)) == ["sA", "sB"]
    return d, a


def test_legacy_engine_cli_matches_jax_cli_and_refsim(world, jax_run, jax_legacy_runs):
    """``--engine legacy``: the same files as the JAX CLI run with that
    flag, as the JAX legacy engine's, and as the fingerprint engine's
    (which equal RefSim)."""
    from kmer_id_tpu_torch import cli

    d = _copy(world, "torch_legacy")
    assert cli.main(["classify-nx", str(d), "--db-dir", str(world["dbdir"]), "--device", "cpu",
                     "--engine", "legacy"] + ARGS) == 0
    for sample in ("sA", "sB"):
        got = _outputs(d, sample)
        for want in jax_legacy_runs + (jax_run,):
            assert got == _outputs(want, sample), (sample, want)


def test_profile_writes_a_trace(world, tmp_path):
    from kmer_id_tpu_torch import cli

    d = _copy(world, "profiled")
    trace = tmp_path / "trace"
    assert cli.main(["classify-nx", str(d), "--db-dir", str(world["dbdir"]), "--device", "cpu",
                     "--profile", str(trace)] + ARGS) == 0
    (path,) = list(trace.iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_unported_paths_refuse(world, jax_run, tmp_path):
    """The paths the port once refused now run.  classify-nx on a grid of
    ranks that the command starts (``--mesh-data 2``, ``--mesh-db 4``)
    writes the JAX CLI's files; a coordinator or a process id without
    ``--num-processes`` changes nothing, as in the JAX CLI, and
    ``--num-processes`` needs a grid of its size.  classify-jobs on a 2 x 2
    grid writes what it writes on one device, and classify-m3 accepts the
    mesh flags and does not use them."""
    from kmer_id_tpu_torch import cli

    def nx(d):
        return ["classify-nx", str(d), "--db-dir", str(world["dbdir"]), "--device", "cpu"] + ARGS

    for i, flags in enumerate((["--mesh-data", "2"], ["--mesh-db", "4"],
                               ["--coordinator", "localhost:1234"], ["--process-id", "0"])):
        d = _copy(world, f"once_refused{i}")
        assert cli.main(nx(d) + flags) == 0, flags
        for sample in ("sA", "sB"):
            assert _outputs(d, sample) == _outputs(jax_run, sample), (flags, sample)
    with pytest.raises(ValueError, match="--num-processes 2 needs"):
        cli.main(nx(tmp_path) + ["--num-processes", "2"])
    # the vf6 subcommand on a 2 x 2 grid; m3 with the mesh flags
    dbd, mito = tmp_path / "db", tmp_path / "mito"  # the DB under its vf6 and m3 names
    for d, prefix in ((dbd, "db_"), (mito, "mitochondria_")):
        d.mkdir()
        for src, dst in (("bData10.txt", "data.txt"), ("btree_10.txt", "tree.txt"),
                         ("probes10.txt.gz", "probes.txt.gz")):
            shutil.copy(world["dbdir"] / src, d / (prefix + dst))
    reads = world["fq"] / "sA_R1_tr.fastq.gz"
    files = {}
    for mesh in (["--mesh-data", "2", "--mesh-db", "2"], []):
        jobs = tmp_path / f"jobs{len(mesh)}"
        jobs.mkdir()
        (jobs / f"{jobs.name}.txt").write_text(f"j1 1\n{reads}\n")
        assert cli.main(["classify-jobs", "-name", "db", "-jname", jobs.name, "--root",
                         str(tmp_path), "--device", "cpu"] + ARGS[2:] + mesh) == 0
        assert cli.main(["classify-m3", "-wdir", str(mito), "-f1", str(reads), "--device",
                         "cpu"] + mesh) == 0
        files[len(mesh)] = [(jobs / n).read_bytes() for n in ("j1_result.txt", "j1_reads.txt")]
        files[len(mesh)].append((mito / "result.txt").read_bytes())
    assert files[4] == files[0] and files[0][0]


def test_cuda_device_refused_without_cuda(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kmer_id_tpu_torch import cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["classify-nx", str(tmp_path), "--db-dir", str(world["dbdir"]),
                  "--device", "cuda"] + ARGS)


def test_port_imports_no_jax():
    """Importing every module of the port adds no jax module."""
    code = (
        "import pkgutil, sys, importlib, kmer_id_tpu_torch\n"
        "before = {m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')}\n"
        "names = [m.name for m in pkgutil.walk_packages(kmer_id_tpu_torch.__path__, "
        "'kmer_id_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "after = {m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')}\n"
        "assert len(names) >= 10, names\n"
        "print(len(names), sorted(after - before))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, added = out.stdout.split(" ", 1)
    assert added.strip() == "[]", added
