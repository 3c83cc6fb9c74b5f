"""The port's grid through its CLI and its multi-process runtime, on gloo
ranks on the CPU (kmer_id_tpu_torch/cli.py, parallel/distributed.py).

* ``classify-nx --mesh-data 2`` / ``--mesh-db 2`` (the command starts its
  ranks), with each engine, byte-identical to the JAX CLI's one-process
  mesh (on the 8 virtual CPU devices of tests/conftest.py) and to the
  single-device port; the same run as ``--coordinator --num-processes 2
  --process-id i`` (two processes started here: the analogue of the JAX
  package's two-process classify-nx test).
* ``classify-jobs`` and ``readc`` with ``--mesh-db 2`` on jobs whose contigs
  are longer than ``--max-len`` (the long-read lane on the grid), against
  the JAX CLI's mesh and the single-device port.
* The refusals: a grid larger than the devices there are, ``--num-processes``
  that is not the grid's size; a rank that fails makes the command fail.
* Ports of tests/test_distributed.py and tests/test_multihost.py:
  ``initialize``, ``health_check`` and ``SampleQueue``, one process and two;
  and the sharded engine's multi-process API (``make_global_batch``,
  ``collect_local``, ``ucount``) on a 2 x 2 grid of four processes, with a
  replaying row in each data shard, equal to the single-device engine.
* ``slice_batch``: a rank's rows in the packed form (the exception list cut
  and re-based) give the windows of the code plane's rows.
* ``shutdown``: 2 x 2 gloo grids whose ranks leave their group exit 0.

Every comparison is exact.  Every subprocess has a timeout.
"""

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.db.probes import ProbeRecords, write_probes_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_TARG = 12
ENGINE = ["--batch-size", "32", "--max-len", "128"]
TIMEOUT_S = 240


def _dna(r, n):
    return "".join("ACGT"[i] for i in r.integers(0, 4, size=n))


def _write_db(d, names, keys, targets, parent):
    data, tree, probes = names
    d.mkdir(parents=True, exist_ok=True)
    (d / data).write_text("".join(f"{t}\tACC{t}\n" for t in range(2, NUM_TARG)))
    (d / tree).write_text("".join(f"{parent[t]}\t{t}\n" for t in range(2, NUM_TARG)))
    n = len(keys)
    txt = d / "probes.tmp"
    write_probes_text(ProbeRecords(keys=keys, target=targets, org=np.zeros(n, np.int32),
                                   position=np.zeros(n, np.int32), fstrand=np.ones(n, bool),
                                   count=np.ones(n, np.int32)), str(txt))
    with open(txt, "rb") as f, gzip.open(d / probes, "wb") as g:
        g.write(f.read())
    txt.unlink()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A DB of every window of a random 900-base genome (random targets on a
    random tree) in the nx layout ``nxdb/`` and the vf6 layout ``db/db_*``;
    two paired samples of 100-bp reads (planted probes on either strand,
    genome copies: the overflow replay, Ns, low-quality tails); a job of
    FASTQ.gz reads and FASTA contigs of up to 1,500 bases."""
    r = np.random.default_rng(77)
    parent = [1] * NUM_TARG
    for i in range(3, NUM_TARG):
        parent[i] = int(r.integers(1, i))
    genome = r.integers(0, 4, size=900).astype(np.uint8)
    gstr = "".join("ACGT"[i] for i in genome)
    keys = np.unique(codec.canonical_kmers(genome)[0])
    targets = r.integers(2, NUM_TARG, size=len(keys)).astype(np.int32)
    root = tmp_path_factory.mktemp("multiproc")
    _write_db(root / "nxdb", ("bData10.txt", "btree_10.txt", "probes10.txt.gz"), keys, targets,
              parent)
    _write_db(root / "db", ("db_data.txt", "db_tree.txt", "db_probes.txt.gz"), keys, targets,
              parent)
    (root / "db" / "db_key.txt").write_text("".join(f"{t}\tname{t}\n" for t in range(NUM_TARG)))
    (root / "db" / "db_count.txt").write_text(
        "".join(f"{t},{int(r.integers(20, 200))}\n" for t in range(NUM_TARG)))

    def read(n):
        seq = list(_dna(r, n))
        for _ in range(int(r.integers(0, 3))):
            p, g = int(r.integers(0, n - 30)), int(r.integers(0, len(gstr) - 30))
            k = gstr[g : g + 30]
            if r.random() < 0.5:
                k = k[::-1].translate(str.maketrans("ACGT", "TGCA"))
            seq[p : p + 30] = k
        if r.random() < 0.04:  # a genome copy: a probe at every window
            s = int(r.integers(0, len(gstr) - n))
            seq = list(gstr[s : s + n])
        if r.random() < 0.03:
            seq[int(r.integers(0, n))] = "N"
        return "".join(seq)

    def fastq(path, n, tag):
        lines = []
        for i in range(n):
            qual = "J" * 100 if r.random() > 0.15 else "J" * 80 + "#" * 20
            lines.append(f"@{tag}{i}\n{read(100)}\n+\n{qual}\n")
        with gzip.open(path, "wt") as f:
            f.write("".join(lines))

    fq = root / "fq"
    fq.mkdir()
    for sample, n in (("s1", 150), ("s0", 40)):
        for mate in ("R1", "R2"):
            fastq(fq / f"{sample}_{mate}_tr.fastq.gz", n, f"{sample}{mate}.")
    reads = root / "reads"
    reads.mkdir()
    fastq(reads / "short.fastq.gz", 90, "q")
    (reads / "contigs.fasta").write_text("".join(
        f">c{i}\n{read(n)}\n" for i, n in enumerate((60, 300, 1500, 90, 700, 130, 1100))))
    return dict(root=root, fq=fq, nxdb=root / "nxdb", reads=reads)


def _copy(world, name):
    d = world["root"] / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(world["fq"], d)
    return d


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.name.endswith(("_result.txt", "_reads.txt", ".csv"))}


def _nx(world, d):
    return ["classify-nx", str(d), "--db-dir", str(world["nxdb"]), "--num-targ",
            str(NUM_TARG)] + ENGINE


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def single(world):
    """{engine: the single-device port's classify-nx files}."""
    from kmer_id_tpu_torch import cli

    out = {}
    for engine in ("fp", "legacy"):
        d = _copy(world, f"single_{engine}")
        assert cli.main(_nx(world, d) + ["--device", "cpu", "--engine", engine]) == 0
        out[engine] = _files(d)
        assert len(out[engine]) == 4
    return out


MESHES = [("fp", ["--mesh-data", "2"]), ("fp", ["--mesh-db", "2"]), ("legacy", ["--mesh-db", "2"])]


@pytest.mark.parametrize("engine,mesh", MESHES, ids=[f"{e}{''.join(m)}" for e, m in MESHES])
def test_classify_nx_grid_matches_jax_mesh_and_single_device(world, single, engine, mesh):
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    tag = f"{engine}{mesh[0][-2:]}"
    jd, d = _copy(world, f"jax_{tag}"), _copy(world, f"grid_{tag}")
    eng = ["--engine", engine]
    assert jax_cli.main(_nx(world, jd) + mesh + eng) == 0
    assert cli.main(_nx(world, d) + mesh + eng + ["--device", "cpu"]) == 0
    got = _files(d)
    assert got == _files(jd)
    assert got == single[engine]


def test_classify_nx_as_two_processes(world, single):
    """``--coordinator --num-processes 2 --process-id i``: rank 0 writes the
    files the single-device port writes."""
    d = _copy(world, "two_processes")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmer_id_tpu_torch.cli"] + _nx(world, d)
        + ["--mesh-data", "2", "--device", "cpu", "--coordinator", coord,
           "--num-processes", "2", "--process-id", str(i)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "health:" in outs[0][1]
    assert _files(d) == single["fp"]


def _jobs(world, name):
    d = world["root"] / name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir()
    rd = world["reads"]
    (d / f"{name}.txt").write_text(
        f"a 2\n{rd / 'short.fastq.gz'}\n{rd / 'contigs.fasta'}\nb 1\n{rd / 'contigs.fasta'}\n")
    return d


@pytest.mark.parametrize("cmd", ["classify-jobs", "readc"])
def test_jobs_and_readc_grid_match_jax_mesh_and_single_device(world, cmd):
    from kmer_id_tpu import cli as jax_cli
    from kmer_id_tpu_torch import cli

    root = str(world["root"])

    def argv(jname):
        if cmd == "readc":
            return ["readc", "--jobs-name", jname, "--folder", "db", "--root", root] + ENGINE
        return ["classify-jobs", "-name", "db", "-jname", jname, "-target", "3", "--root",
                root] + ENGINE

    tag = cmd.split("-")[-1]
    runs = {}
    for who in ("jax", "grid", "single"):
        d = _jobs(world, f"{tag}_{who}")
        if who == "jax":
            assert jax_cli.main(argv(d.name) + ["--mesh-db", "2"]) == 0
        else:
            mesh = ["--mesh-db", "2"] if who == "grid" else []
            assert cli.main(argv(d.name) + mesh + ["--device", "cpu"]) == 0
        runs[who] = {k.replace(d.name, "J"): v for k, v in _files(d).items()}
    assert runs["grid"] == runs["jax"] == runs["single"]
    assert "a_result.txt" in runs["grid"] and ("J.csv" in runs["grid"]) == (cmd == "readc")


def test_grid_refusals_and_a_failing_rank(world, tmp_path):
    import torch

    from kmer_id_tpu_torch import cli

    d = _copy(world, "refused")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = max(have + 1, 2)
    with pytest.raises(ValueError, match=f"needs {need} devices, have {have}"):
        cli.main(_nx(world, d) + ["--mesh-db", str(need), "--device", "cuda"])
    with pytest.raises(ValueError, match="--num-processes 2 needs --mesh-data x --mesh-db == 2"):
        cli.main(_nx(world, d) + ["--mesh-data", "3", "--num-processes", "2", "--process-id",
                                  "0", "--coordinator", "127.0.0.1:1", "--device", "cpu"])
    # a DB that is not there: rank 0 fails to load it, rank 1 is told, both exit 1
    argv = ["classify-nx", str(d), "--db-dir", str(tmp_path / "no_db"), "--mesh-data", "2",
            "--device", "cpu"] + ENGINE
    assert cli.main(argv) == 1
    assert not (d / "s1_result.txt").exists()


# ------------------------------------------------- the distributed runtime


def test_grid_ranks_leave_their_group():
    """The cause of the grid tests' rare failure under the parallel suite:
    a gloo rank that exits with its process group up can abort in the
    teardown (SIGABRT, "terminate called without an active exception",
    after the interpreter's last frame), about one 2 x 2 grid in eleven
    when the data shards' last collectives differ, as they do where one
    shard replays (``tools/grid_teardown.py``, which measures it).  Every
    grid worker now ends with ``shutdown`` (a barrier, then
    ``destroy_process_group``): 8 grids of the tool, each with a sum over
    db in one data shard only, leave their group and exit 0.  The abort is
    a race, so without ``shutdown`` this test still passes about two runs
    in five; the tool's 200 grids tell the two apart."""
    from kmer_id_tpu_torch.parallel.distributed import shutdown

    shutdown()  # no group: nothing to leave
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "grid_teardown.py"), "--grids", "8",
         "--at-once", "4", "--mode", "shutdown"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["mode"] == "shutdown" and res["grids"] == 8
    assert res["grids_with_a_failed_rank"] == 0, res["failures"]


def test_health_check_and_initialize_on_one_process():
    import torch.distributed as dist

    from kmer_id_tpu_torch.parallel.distributed import health_check, initialize

    initialize(None, 1, 0, "cpu")  # one process: no process group
    assert not dist.is_initialized()
    h = health_check("cpu")
    assert h["ok"] and h["devices"] == {"cpu": True} and h["process"] == 0
    assert h["barrier_s"] is None  # single process: no cross-process barrier


def test_distributed_entry_points_default_to_the_card(monkeypatch):
    """Like every entry point of the port, ``initialize`` and
    ``health_check`` take the card unless told otherwise: the probe runs on
    ``cuda`` (and fails where there is none), and a process group is NCCL's
    on the current card."""
    import torch
    import torch.distributed as dist

    from kmer_id_tpu_torch.parallel.distributed import health_check, initialize

    h = health_check()
    assert h["devices"] == {"cuda": torch.cuda.is_available()}
    assert h["ok"] == torch.cuda.is_available()
    seen = {}
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: seen.setdefault("device", dev))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.setdefault("backend", backend))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    initialize("127.0.0.1:1", 2, 0)
    assert seen == {"device": torch.device("cuda"), "backend": "nccl"}


def test_sample_queue_claims_and_restart(tmp_path):
    from kmer_id_tpu_torch.parallel.distributed import SampleQueue

    mpath = str(tmp_path / "queue.json")
    q = SampleQueue(mpath, ["s1", "s2", "s3"])
    a, b = q.claim("w1"), q.claim("w2")
    assert {a, b} == {"s1", "s2"}
    q.complete(a)
    q2 = SampleQueue(mpath, ["s1", "s2", "s3"])  # restart: the manifest keeps its state
    c = q2.claim("w3")
    assert c == "s3"
    q2.complete(c)
    assert q2.claim("w3") is None  # s2 still claimed, nothing pending
    assert q2.reclaim_stale(timeout_s=0.0) == [b]
    assert q2.claim("w3") == b


def test_sample_queue_concurrent(tmp_path):
    from kmer_id_tpu_torch.parallel.distributed import SampleQueue

    samples = [f"s{i}" for i in range(40)]
    q = SampleQueue(str(tmp_path / "q.json"), samples)
    got, lock = [], threading.Lock()

    def worker(w):
        while (s := q.claim(w)) is not None:
            with lock:
                got.append(s)
            q.complete(s)

    ts = [threading.Thread(target=worker, args=(f"w{i}",)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(got) == sorted(samples)


_PROC = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
pid = spec["rank"]
from kmer_id_tpu_torch.parallel.distributed import SampleQueue, health_check, initialize, shutdown
from kmer_id_tpu_torch.parallel import make_mesh
initialize(spec["coord"], spec["n"], pid, "cpu")
h = health_check("cpu")
assert h["ok"] and h["process"] == pid and h["barrier_s"] is not None, h
out = {"pid": pid}
if spec["task"] == "queue":
    g = make_mesh(data=2, db=1)
    x = g.psum_data(torch.arange(4, dtype=torch.int32) * (pid + 1))
    assert x.tolist() == [0, 3, 6, 9], x
    assert g.all_gather_data(torch.full((2,), pid)).tolist() == [[0, 0], [1, 1]]
    q = SampleQueue(os.path.join(spec["dir"], "manifest.json"), [f"s{i}" for i in range(8)])
    mine = []
    while (s := q.claim(f"proc{pid}")) is not None:
        mine.append(s)
        q.complete(s)
    out["claimed"] = mine
else:  # the sharded engine's multi-process API on a 2 x 2 grid
    from kmer_id_tpu_torch.core import codec
    from kmer_id_tpu_torch.core.taxonomy import Taxonomy
    from kmer_id_tpu_torch.db.fpdb import build_fpdb
    from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
    from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
    from kmer_id_tpu_torch.io.batch import Batch
    from kmer_id_tpu_torch.parallel import ShardedFpClassifier
    r = np.random.default_rng(5)
    genome = r.integers(0, 4, size=3000).astype(np.uint8)
    keys = np.unique(codec.canonical_kmers(genome)[0])
    n = len(keys)
    packed = pack_probes(ProbeRecords(
        keys=keys, target=r.integers(2, 8, size=n).astype(np.int32), org=np.zeros(n, np.int32),
        position=np.zeros(n, np.int32), fstrand=np.ones(n, bool), count=np.ones(n, np.int32)),
        num_targ=8)
    tax = Taxonomy(np.array([1, 1, 1, 2, 2, 4, 1, 6], np.int32))
    fp = build_fpdb(packed, tax)
    B, L, MH = 64, 512, 8
    codes = r.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = r.integers(40, 200, size=B).astype(np.int32)
    for row in range(0, B, 3):  # two planted probes
        for p in (5, 60):
            s = int(r.integers(0, 2970))
            codes[row, p : p + 30] = genome[s : s + 30]
    for row in (B // 2 - 1, B - 1):  # a genome copy in each data shard: the replay
        codes[row] = genome[row : row + L]
        lengths[row] = 400
    single = FpClassifier(packed, tax, batch_size=B, max_len=L, max_hits=MH, fpdb=fp,
                          device="cpu")
    s1, f1 = single.process_batch(single.new_seen(), Batch(codes, lengths, [None] * B, B))
    grid = make_mesh(data=2, db=2, device="cpu")
    clf = ShardedFpClassifier(packed, tax, grid, batch_size=B, max_len=L, max_hits=MH, fpdb=fp)
    rows = clf.local_data_rows()
    gc, gl = clf.make_global_batch(codes[rows], lengths[rows])
    seen, pending = clf.submit_batch(clf.new_seen(), Batch(gc, gl, [None] * B, B))
    seen, got_rows, f2 = clf.collect_local(seen, pending)
    assert got_rows.tolist() == rows.tolist()
    assert f2.tolist() == np.asarray(f1)[rows].tolist(), (f2.tolist(), np.asarray(f1)[rows])
    u1, u2 = single.ucount(s1), clf.ucount(seen)
    assert u1.tolist() == u2.tolist(), (u1, u2)
    out.update(rows=len(rows), ucount_sum=int(u2.sum()))
shutdown()
print(json.dumps(out))
"""


def _run_procs(task, n, tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROC, json.dumps(dict(task=task, n=n, rank=i, coord=coord,
                                                     dir=str(tmp_path)))],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so[-2000:] + se[-3000:]
    return [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]


def test_two_processes_form_a_group_and_split_the_queue(tmp_path):
    outs = _run_procs("queue", 2, tmp_path)
    claimed = sorted(outs[0]["claimed"] + outs[1]["claimed"])
    assert claimed == [f"s{i}" for i in range(8)]  # each sample once


def test_grid_engine_multi_process_api_matches_single_device(tmp_path):
    """The fingerprint grid engine on 2 x 2 processes: each rank's rows in
    through ``make_global_batch``, its finals out through ``collect_local``
    (a genome copy in each data shard: the replicated replay), ``ucount``
    equal to the single-device engine's."""
    outs = _run_procs("engine", 4, tmp_path)
    assert [o["rows"] for o in outs] == [32] * 4
    assert len({o["ucount_sum"] for o in outs}) == 1 and outs[0]["ucount_sum"] > 0


def test_slice_batch_forms_agree():
    """A rank's rows of a packed batch (the exception list filtered to them
    and re-based) give the windows of the same rows of the code plane."""
    import torch

    from kmer_id_tpu_torch.io.batch import Batch, pack_codes
    from kmer_id_tpu_torch.ops.gate import ReadPlanes, extract_plain
    from kmer_id_tpu_torch.parallel.mesh import slice_batch

    r = np.random.default_rng(9)
    b, l = 16, 96
    codes = r.integers(0, 4, size=(b, l)).astype(np.uint8)
    lengths = r.integers(20, l + 1, size=b).astype(np.int32)
    codes[r.random((b, l)) < 0.02] = 4  # Ns in every part of the batch
    packed, exc = pack_codes(codes, lengths)
    assert packed is not None and (exc >= 0).sum() > 4
    batch = Batch(codes=codes, lengths=lengths, metas=None, n_rows=b, packed=packed, exc=exc)
    for r0, r1 in ((0, 8), (8, 16), (4, 12), (0, 16)):
        part = slice_batch(batch, r0, r1, l)
        assert len(part.exc) == len(exc) and part.n_rows == b
        a = extract_plain(ReadPlanes.from_batch(part, torch.device("cpu"), l))
        plane = Batch(codes=codes[r0:r1], lengths=lengths[r0:r1], metas=None, n_rows=r1 - r0)
        want = extract_plain(ReadPlanes.from_batch(plane, torch.device("cpu"), l))
        assert all(torch.equal(a[k], want[k]) for k in want), (r0, r1)
