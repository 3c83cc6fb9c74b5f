"""The vf6 and m3 drivers of the PyTorch port (on the CPU) against the JAX
package's, byte for byte: ``load_jobs``, ``run_vf6`` and ``run_m3``, the
``classify-jobs``, ``classify-m3``, ``mitokmer`` and ``readc`` subcommands
of both CLIs, on jobs that mix FASTQ.gz short reads with FASTA contigs longer
than ``--max-len`` (the long-read lane), with and without ``-target``, and
with ``f2`` given or ``none``, with the fingerprint engine and with
``--engine legacy``; and the ``pack-db``, ``report-b10`` and ``report-c3``
subcommands.  Also: the m3 driver's two exit gates, the repaired ``load_db``
(``require_tree``, ``kmers_loaded``), the Python and native feeds with long
reads, and the rounding of ``run_nx``'s metrics.
"""

import gzip
import io
import json
import os
import shutil

import numpy as np
import pytest

from kmer_id_tpu.core import codec
from kmer_id_tpu.db.probes import ProbeRecords, write_probes_text
from kmer_id_tpu.io.fastx import iter_fasta_plain, iter_fastq_gz, iter_fastq_plain
from kmer_id_tpu.config import ClassifyConfig as JaxClassifyConfig
from kmer_id_tpu_torch.config import ClassifyConfig
from tests.refsim import RefSim

NUM_TARG = 12
TARGET = 5
ENGINE = ["--batch-size", "32", "--max-len", "128"]


def _dna(r, n):
    return "".join("ACGT"[i] for i in r.integers(0, 4, size=n))


def _write_db(d, prefix, keys, targets, parent):
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{prefix}data.txt").write_text(
        "".join(f"{t}\tACC{t}\n" for t in range(2, NUM_TARG)))
    (d / f"{prefix}tree.txt").write_text(
        "".join(f"{parent[t]}\t{t}\n" for t in range(2, NUM_TARG)))
    n = len(keys)
    write_probes_text(
        ProbeRecords(keys=keys, target=targets, org=np.zeros(n, np.int32),
                     position=np.zeros(n, np.int32), fstrand=np.ones(n, bool),
                     count=np.ones(n, np.int32)),
        str(d / f"{prefix}probes.txt"),
    )
    with open(d / f"{prefix}probes.txt", "rb") as f:
        with gzip.open(d / f"{prefix}probes.txt.gz", "wb") as g:
            g.write(f.read())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A DB (every window of a random 900-base genome, random targets on a
    random tree) in the vf6 layout ``db/db_*`` and the m3 layout
    ``mito/mitochondria_*``; a FASTQ.gz of short reads (planted probes, Ns,
    Us, low-quality tails) and a FASTA of contigs up to 1,800 bases
    (planted probes, chimeras, genome copies, a 1,100-N run, U bases)."""
    r = np.random.default_rng(2027)
    parent = [1] * NUM_TARG
    for i in range(3, NUM_TARG):
        parent[i] = int(r.integers(1, i))
    genome = r.integers(0, 4, size=900).astype(np.uint8)
    gstr = "".join("ACGT"[i] for i in genome)
    keys = np.unique(codec.canonical_kmers(genome)[0])
    targets = r.integers(2, NUM_TARG, size=len(keys)).astype(np.int32)
    kmap = dict(zip(keys.tolist(), targets.tolist()))
    root = tmp_path_factory.mktemp("drivers")
    _write_db(root / "db", "db_", keys, targets, parent)
    (root / "db" / "db_key.txt").write_text(
        "".join(f"{t}\tname{t}\n" for t in range(NUM_TARG)))
    (root / "db" / "db_count.txt").write_text(
        "".join(f"{t},{int(r.integers(20, 200))}\n" for t in range(NUM_TARG)))
    _write_db(root / "mito", "mitochondria_", keys, targets, parent)
    (root / "mito" / "mitochondria_refkey.txt").write_text(
        "target\tname\tcount\thit\ttested\tgsize\tnstrains\n" + "".join(
            f"{t}\tk_p_c_o_f_g_s{t}\t{t + 5}\t{20 + t}\t{100 + 3 * t}\t{1000 + t}\t1\n"
            for t in range(NUM_TARG)))

    def probe():
        s = int(r.integers(0, len(gstr) - 30))
        k = gstr[s : s + 30]
        if r.random() < 0.5:
            k = codec.key_to_string(codec.revcomp_key(codec.string_to_key(k)))
        return k

    reads = root / "reads"
    reads.mkdir()
    lines = []
    for i in range(150):
        seq = list(_dna(r, 100))
        for _ in range(int(r.integers(0, 3))):
            p = int(r.integers(0, 70))
            seq[p : p + 30] = probe()
        if r.random() < 0.05:
            seq[int(r.integers(0, 100))] = "N"
        if r.random() < 0.05:
            seq = [c.replace("T", "U") for c in seq]
        qual = ["J"] * 100
        if r.random() < 0.15:
            qual[-20:] = ["#"] * 20
        lines.append(f"@q{i}\n{''.join(seq)}\n+\n{''.join(qual)}\n")
    with gzip.open(reads / "short.fastq.gz", "wt") as f:
        f.write("".join(lines))
    with open(reads / "short.fastq", "w") as f:
        f.write("".join(lines[:60]))
    recs = []
    for i in range(24):
        n = int(r.integers(40, 1800))
        seq = list(_dna(r, n))
        for _ in range(int(r.integers(0, 5))):
            p = int(r.integers(0, max(n - 30, 1)))
            seq[p : p + 30] = probe()
        if i % 7 == 3:  # a genome copy: a probe at every window
            s = int(r.integers(0, 400))
            seq = list(gstr[s : s + 500])
        if i == 5:
            seq[100:100] = ["N"] * 1100
        if i % 5 == 1:
            seq = [c.replace("T", "U") for c in seq]
        recs.append(f">c{i} contig {i}\n{''.join(seq)}\n")
    (reads / "contigs.fasta").write_text("".join(recs))
    return dict(root=root, kmap=kmap, parent=parent, reads=reads)


def _jobs(world, name, zero_file_job=True):
    """A job file under ``<root>/<name>``: job ``a`` (FASTQ.gz + FASTA), a
    zero-file job ``z`` (whose name stays, the next job's files taking its
    slot) unless ``zero_file_job`` is False, and job ``b`` (FASTA)."""
    d = world["root"] / name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir()
    rd = world["reads"]
    (d / f"{name}.txt").write_text(
        f"a 2\n{rd / 'short.fastq.gz'}\n{rd / 'contigs.fasta'} extra\n\n"
        + ("z 0\n" if zero_file_job else "") + f"b 1\n{rd / 'contigs.fasta'}\n")
    return d


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.name.endswith((".txt", ".csv"))}


def _sim(world, variant, save_target=0, paths=()):
    sim = RefSim(world["kmap"], world["parent"], num_targ=NUM_TARG, u_is_t=True,
                 save_target=save_target, variant=variant)
    parsers = {".gz": iter_fastq_gz, ".fastq": iter_fastq_plain, ".fasta": iter_fasta_plain}
    for p in paths:
        sim.feed(parsers[os.path.splitext(str(p))[1]](str(p)))
    return sim


def test_load_jobs_matches_jax(world):
    from kmer_id_tpu.engine.pipeline import load_jobs as jax_load_jobs
    from kmer_id_tpu_torch.engine.pipeline import load_jobs

    d = _jobs(world, "jl")
    got = load_jobs(str(d / "jl.txt"))
    assert got == jax_load_jobs(str(d / "jl.txt"))
    rd = world["reads"]
    assert got == (["a", "z"], [[str(rd / "short.fastq.gz"), str(rd / "contigs.fasta")],
                                [str(rd / "contigs.fasta")]])


@pytest.mark.parametrize("target", [0, TARGET])
def test_classify_jobs_cli_matches_jax_and_refsim(world, target, tmp_path):
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    root = world["root"]
    tflag = ["-target", str(target)]
    dj, dt = _jobs(world, f"jj{target}"), _jobs(world, f"tj{target}")
    assert jax_cli.main(["classify-jobs", "-name", "db", "-jname", dj.name, "--root",
                         str(root)] + tflag + ENGINE) == 0
    assert cli.main(["classify-jobs", "-name", "db", "-jname", dt.name, "--root", str(root),
                     "--device", "cpu", "--cache-dir", str(tmp_path / "c")]
                    + tflag + ENGINE) == 0
    got = _files(dt)
    want = _files(dj)
    assert {k: v for k, v in got.items() if not k.endswith(f"{dt.name}.txt")} == {
        k: v for k, v in want.items() if not k.endswith(f"{dj.name}.txt")}
    assert ("a_target_reads.txt" in got) == (target > 0)
    rd = world["reads"]
    sim = _sim(world, "vf6", target, [rd / "short.fastq.gz", rd / "contigs.fasta"])
    assert got["a_result.txt"].decode().splitlines() == sim.result_lines()
    assert got["a_reads.txt"].decode() == "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved)
    if target:
        assert got["a_target_reads.txt"].decode() == "".join(
            f">{t}:{a}\n{s}\n" for t, a, s in sim.saved_target)
        assert sim.saved_target and not sim.saved
    assert sum(sim.ucount) > 0 and sim.gcount[0] < sim.reads


@pytest.mark.parametrize("f2", ["none", "short.fastq"])
def test_mitokmer_and_classify_m3_match_jax(world, f2, tmp_path):
    """mitokmer (classify + report) and classify-m3 through both CLIs on
    copies of the m3 work dir: result.txt and mitokmer_result.csv equal."""
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    rd = world["reads"]
    f2p = "none" if f2 == "none" else str(rd / f2)
    inputs = [str(rd / "contigs.fasta"), f2p]
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []), ("torch", cli.main,
                                                          ["--device", "cpu"])):
        w = tmp_path / f"w_{name}"
        shutil.copytree(world["root"] / "mito", w)
        assert main(["mitokmer", "-w", str(w), "-d", str(tmp_path / f"out_{name}"),
                     "-i"] + inputs + ENGINE + extra) == 0
        csv = (tmp_path / f"out_{name}" / "mitokmer_result.csv").read_bytes()
        res = (w / "result.txt").read_bytes()
        (w / "result.txt").unlink()
        assert main(["classify-m3", "-wdir", str(w), "-f1", inputs[0], "-f2", f2p]
                    + ENGINE + extra) == 0
        assert (w / "result.txt").read_bytes() == res
        assert sorted(os.listdir(w)) == sorted(os.listdir(world["root"] / "mito")
                                               + ["result.txt"])
        outs[name] = (res, csv)
    assert outs["torch"] == outs["jax"]
    sim = _sim(world, "m3", 0, [rd / "contigs.fasta"] + ([rd / f2] if f2 != "none" else []))
    assert outs["torch"][0].decode().splitlines() == sim.result_lines()
    assert outs["torch"][1].startswith(b"taxid,reads,abundance\n")


def test_readc_cli_matches_jax(world):
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    root = world["root"]
    dj, dt = _jobs(world, "rj", False), _jobs(world, "rt", False)
    args = ["--folder", "db", "--root", str(root)] + ENGINE
    assert jax_cli.main(["readc", "--jobs-name", "rj"] + args) == 0
    assert cli.main(["readc", "--jobs-name", "rt", "--device", "cpu"] + args) == 0
    got, want = _files(dt), _files(dj)
    assert got.pop("rt.csv") == want.pop("rj.csv")
    assert got.pop("rt.txt") == want.pop("rj.txt")  # the job files, written alike
    assert got == want and len(got) == 4  # a, b: _result.txt and _reads.txt


def test_run_vf6_and_run_m3_match_jax(world, tmp_path):
    """The driver functions themselves, on a DB loaded once by each side."""
    from kmer_id_tpu.engine import pipeline as JP
    from kmer_id_tpu_torch.engine import pipeline as TP

    db_files = [str(world["root"] / "db" / f"db_{n}") for n in
                ("data.txt", "tree.txt", "probes.txt.gz")]
    kw = dict(save_target=TARGET, batch_size=32, max_len=128)
    cfg, jcfg = ClassifyConfig.preset("vf6", **kw), JaxClassifyConfig.preset("vf6", **kw)
    dj, dt = _jobs(world, "fj"), _jobs(world, "ft")
    assert JP.run_vf6("db", "fj", JP.load_db(*db_files), jcfg, root=str(world["root"])) == [
        "a", "z"]
    assert TP.run_vf6("db", "ft", TP.load_db(*db_files), cfg, root=str(world["root"]),
                      device="cpu") == ["a", "z"]
    got, want = _files(dt), _files(dj)
    got.pop("ft.txt"), want.pop("fj.txt")
    assert got == want and len(got) == 6
    rd = world["reads"]
    res = {}
    for name, mod in (("jax", JP), ("torch", TP)):
        w = tmp_path / name
        shutil.copytree(world["root"] / "mito", w)
        conf = JaxClassifyConfig if name == "jax" else ClassifyConfig
        cfg = conf.preset("m3", batch_size=32, max_len=128)
        kw = {"device": "cpu"} if name == "torch" else {}
        r = mod.run_m3(str(w), str(rd / "contigs.fasta"), str(rd / "short.fastq.gz"),
                       cfg=cfg, **kw)
        res[name] = ((w / "result.txt").read_bytes(), r.reads, r.gcount.tolist(),
                     r.ucount.tolist())
    assert res["torch"] == res["jax"]


def test_m3_exit_gates(world, tmp_path):
    """No tree file, or fewer than 2 probe rows: exit status 1
    (kmer_read_m3.cpp:1060,1067), as the JAX driver does."""
    from kmer_id_tpu.engine import pipeline as JP
    from kmer_id_tpu_torch.engine import pipeline as TP

    reads = str(world["reads"] / "contigs.fasta")
    w = tmp_path / "notree"
    shutil.copytree(world["root"] / "mito", w)
    (w / "mitochondria_tree.txt").unlink()
    for mod in (JP, TP):
        with pytest.raises(SystemExit) as e:
            mod.run_m3(str(w), reads, "none")
        assert e.value.code == 1
    w = tmp_path / "onerow"
    shutil.copytree(world["root"] / "mito", w)
    with gzip.open(w / "mitochondria_probes.txt.gz", "rt") as f:
        first = f.readline()
    with gzip.open(w / "mitochondria_probes.txt.gz", "wt") as f:
        f.write(first)
    for mod in (JP, TP):
        with pytest.raises(SystemExit) as e:
            mod.run_m3(str(w), reads, "none")
        assert e.value.code == 1


def test_load_db_require_tree_and_kmers_loaded(world, tmp_path):
    from kmer_id_tpu.engine.pipeline import load_db as jax_load_db
    from kmer_id_tpu_torch.engine.pipeline import load_db

    d = world["root"] / "db"
    files = [str(d / f"db_{n}") for n in ("data.txt", "tree.txt", "probes.txt.gz")]
    n_rows = len(world["kmap"])
    text = load_db(*files)
    assert text.kmers_loaded == jax_load_db(*files).kmers_loaded == n_rows
    cache = str(tmp_path / "cache")
    assert load_db(*files, cache_dir=cache).kmers_loaded == n_rows  # parse, then save
    cached = load_db(files[0], files[1], str(tmp_path / "absent.gz"), cache_dir=cache)
    assert cached.kmers_loaded == n_rows  # from the manifest's source_rows
    assert len(cached.packed) == len(text.packed)
    with pytest.raises(SystemExit) as e:
        load_db(files[0], str(tmp_path / "no_tree.txt"), files[2], require_tree=True)
    assert e.value.code == 1
    flat = load_db(files[0], str(tmp_path / "no_tree.txt"), files[2])
    assert flat.kmers_loaded == n_rows


def test_python_feed_matches_native_feed_with_long_reads(world):
    from kmer_id_tpu_torch.engine.pipeline import (
        SampleProcessor,
        load_db,
        make_classifier,
    )

    d = world["root"] / "db"
    db = load_db(*[str(d / f"db_{n}") for n in ("data.txt", "tree.txt", "probes.txt.gz")])
    cfg = ClassifyConfig.preset("vf6", save_target=TARGET, batch_size=32, max_len=128,
                                savenum=3)
    clf = make_classifier(db, cfg, device="cpu")
    outs = {}
    for native in (False, True):
        if native and not SampleProcessor(clf, cfg).native:
            pytest.skip("native decoder unavailable")
        main, targ = io.StringIO(), io.StringIO()
        sp = SampleProcessor(clf, cfg, reads_out=main, target_reads_out=targ,
                             use_native=native)
        for f in ("short.fastq.gz", "contigs.fasta", "short.fastq"):
            sp.feed_file(str(world["reads"] / f))
        res = sp.finish()
        outs[native] = (res.gcount.tolist(), res.ucount.tolist(), res.reads,
                        main.getvalue(), targ.getvalue())
    assert outs[False] == outs[True]
    assert outs[True][4] and not outs[True][3]  # vf6 -target: no main capture


def test_run_nx_metrics_rounding(world, tmp_path):
    """run_nx's metrics JSONL rounds wall_s to 3 decimals and reads_per_s to
    1, as the JAX driver writes them."""
    from kmer_id_tpu_torch.engine.pipeline import load_db, run_nx

    fq = tmp_path / "fq"
    fq.mkdir()
    shutil.copy(world["reads"] / "short.fastq.gz", fq / "s_R1_tr.fastq.gz")
    d = world["root"] / "db"
    db = load_db(*[str(d / f"db_{n}") for n in ("data.txt", "tree.txt", "probes.txt.gz")],
                 num_targ=NUM_TARG)
    cfg = ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=32, max_len=128)
    metrics = tmp_path / "m.jsonl"
    assert run_nx(str(fq), db, cfg, metrics_path=str(metrics), device="cpu") == ["s"]
    m = json.loads(metrics.read_text().splitlines()[0])
    assert m["wall_s"] == round(m["wall_s"], 3) and m["wall_s"] > 0
    assert m["reads_per_s"] == round(m["reads_per_s"], 1)
    assert 0 < m["reads"] <= 150
    assert set(m) >= {"sample", "reads", "wall_s", "reads_per_s", "classified", "stages"}


@pytest.mark.parametrize("cmd", ["classify-jobs", "classify-m3", "mitokmer", "readc"])
def test_cuda_device_refused_without_cuda(world, cmd, tmp_path):
    """``--device cuda`` (the default) raises where there is no card, on
    every new subcommand: nothing falls back to the CPU."""
    import torch

    from kmer_id_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, rd = str(world["root"]), world["reads"]
    _jobs(world, "cj", False)
    mito = str(world["root"] / "mito")
    argv = {
        "classify-jobs": ["-name", "db", "-jname", "cj", "--root", root],
        "classify-m3": ["-wdir", mito, "-f1", str(rd / "contigs.fasta")],
        "mitokmer": ["-w", mito, "-d", str(tmp_path), "-i", str(rd / "contigs.fasta"), "none"],
        "readc": ["--jobs-name", "cj", "--folder", "db", "--root", root],
    }[cmd]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([cmd] + argv + ENGINE)


LEGACY_CASES = ["classify-jobs", "classify-jobs-target", "classify-m3", "mitokmer", "readc"]


@pytest.mark.parametrize("case", LEGACY_CASES)
def test_legacy_engine_subcommands_match_jax(world, case, tmp_path):
    """``--engine legacy`` on the five classify subcommands: the files of
    the JAX CLI run with that flag (which on one device does not read it and
    runs the fingerprint engine) and of the port's fingerprint engine, byte
    for byte; for classify-jobs and classify-m3 also those of the JAX
    drivers run with a legacy config (the JAX legacy engine)."""
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    root, rd = world["root"], world["reads"]
    runs = {}
    for name, main, extra in (("jax", jax_cli.main, ["--engine", "legacy"]),
                              ("torch", cli.main, ["--engine", "legacy", "--device", "cpu"]),
                              ("fp", cli.main, ["--device", "cpu"])):
        tag = f"{name}_{case}"
        if case.startswith("classify-jobs") or case == "readc":
            d = _jobs(world, tag, zero_file_job=case != "readc")
            if case == "readc":
                argv = ["readc", "--jobs-name", tag, "--folder", "db", "--root", str(root)]
            else:
                argv = ["classify-jobs", "-name", "db", "-jname", tag, "--root", str(root),
                        "-target", str(TARGET if case.endswith("target") else 0)]
            assert main(argv + ENGINE + extra) == 0
            files = _files(d)
            runs[name] = {k.replace(tag, "JOB"): v for k, v in files.items()}
        else:
            w = tmp_path / tag
            shutil.copytree(root / "mito", w)
            inputs = [str(rd / "contigs.fasta"), str(rd / "short.fastq")]
            if case == "mitokmer":
                argv = ["mitokmer", "-w", str(w), "-d", str(tmp_path / f"out_{tag}"), "-i"] + inputs
            else:
                argv = ["classify-m3", "-wdir", str(w), "-f1", inputs[0], "-f2", inputs[1]]
            assert main(argv + ENGINE + extra) == 0
            runs[name] = {"result.txt": (w / "result.txt").read_bytes()}
            if case == "mitokmer":
                runs[name]["csv"] = (tmp_path / f"out_{tag}" / "mitokmer_result.csv").read_bytes()
    assert runs["torch"] == runs["jax"]
    assert runs["torch"] == runs["fp"]
    if case == "classify-jobs-target":
        assert runs["torch"]["a_target_reads.txt"]
    if case in ("classify-jobs", "classify-jobs-target", "classify-m3"):
        assert runs["torch"] == _jax_legacy_api(world, case, tmp_path)


def _jax_legacy_api(world, case, tmp_path):
    """The files of the JAX package's drivers with ``engine="legacy"``."""
    from kmer_id_tpu.engine import pipeline as JP

    rd = world["reads"]
    if case == "classify-m3":
        w = tmp_path / "jax_api"
        shutil.copytree(world["root"] / "mito", w)
        cfg = JaxClassifyConfig.preset("m3", batch_size=32, max_len=128, engine="legacy")
        JP.run_m3(str(w), str(rd / "contigs.fasta"), str(rd / "short.fastq"), cfg=cfg)
        return {"result.txt": (w / "result.txt").read_bytes()}
    tag = f"api_{case}"
    d = _jobs(world, tag)
    cfg = JaxClassifyConfig.preset("vf6", save_target=TARGET if case.endswith("target") else 0,
                                   batch_size=32, max_len=128, engine="legacy")
    db = JP.load_db(*[str(world["root"] / "db" / f"db_{n}")
                      for n in ("data.txt", "tree.txt", "probes.txt.gz")])
    clf = JP.make_classifier(db, cfg)
    assert type(clf).__name__ == "Classifier"
    JP.run_vf6("db", tag, db, cfg, root=str(world["root"]), clf=clf)
    return {k.replace(tag, "JOB"): v for k, v in _files(d).items()}


def test_pack_db_matches_jax(world, tmp_path):
    """``pack-db``: the packed artifact (sorted keys, values, bucket index,
    cuckoo table, manifest) byte for byte."""
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    probes = str(world["root"] / "db" / "db_probes.txt.gz")
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        assert main(["pack-db", probes, str(tmp_path / name), "--num-targ", str(NUM_TARG)]) == 0
    got, want = _files_all(tmp_path / "torch"), _files_all(tmp_path / "jax")
    assert got == want and "cuckoo.npy" in got and "manifest.json" in got


def _files_all(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture(scope="module")
def result_dir(tmp_path_factory):
    """Three samples' ``_result.txt`` files (random counts, a few below the
    rollups' thresholds), a 4-column bact10 refkey and a 7-column refkey."""
    r = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("results")
    for sample in ("s2", "s1", "s3"):
        g = r.integers(0, 400, size=NUM_TARG)
        g[r.random(NUM_TARG) < 0.2] = 1
        u = np.maximum(r.integers(0, 50, size=NUM_TARG), 1)
        (d / f"{sample}_result.txt").write_text(
            "".join(f"{t},{g[t]},{u[t]}\n" for t in range(NUM_TARG)))
    (d / "notes.txt").write_text("not a result file\n")
    key10 = d.parent / "refkey10.txt"
    key10.write_text("target\tname\tcount\tuse\n" + "".join(
        f"{t}\tname{t}\t{int(r.integers(5, 90))}\t{int(t % 4 != 3)}\n" for t in range(NUM_TARG)))
    key7 = d.parent / "refkey7.txt"
    key7.write_text("target\tname\tcount\thit\ttested\tgsize\tnstrains\n" + "".join(
        f"{t}\tk_p_c_o_f_g_s{t}\t{t + 5}\t{20 + t}\t{100 + 3 * t}\t{1000 + t}\t1\n"
        for t in range(NUM_TARG)))
    return d, key10, key7


@pytest.mark.parametrize("cmd,flags", [("report-b10", []),
                                       ("report-b10", ["--no-default-excludes"]),
                                       ("report-c3", [])])
def test_report_subcommands_match_jax(result_dir, cmd, flags, tmp_path):
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    d, key10, key7 = result_dir
    key = key10 if cmd == "report-b10" else key7
    out = {}
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        path = tmp_path / f"{name}.csv"
        assert main([cmd, str(d), str(key), str(path)] + flags) == 0
        out[name] = path.read_bytes()
    assert out["torch"] == out["jax"]
    lines = out["torch"].decode().splitlines()
    assert lines[0] == "name,s1,,s2,,s3,," and len(lines) > 4
