"""The port's sharded engines (kmer_id_tpu_torch/parallel/) on gloo ranks,
against the JAX package's sharded engines and the port's single-device ones
(the fingerprint engine here, the legacy one in
tests/test_torch_sharding_legacy.py, which uses this file's world, worker
and checks).

Each grid is a set of rank processes started here (``python -c`` of
``_WORKER``, which imports only the port and refuses jax and the JAX
package), joined over a local TCP store with the gloo backend on the CPU.
Every rank runs the same tasks on a world made here from a seed and
written to disk: ``SampleProcessor`` over a read stream (gcount, ucount,
reads), and the engine API (``process_batch`` of one batch in both input
forms, ``process_long_many``, ``collect_local``, each rank's ``seen`` block
and ``ucount``).  The JAX side runs the same calls on the 8 virtual CPU
devices tests/conftest.py provides, with ``make_mesh(data=dp, db=dbp)``;
its flat ``seen`` holds block ``d * dbp + k`` for rank ``(d, k)``.  Grids:
fingerprint (1, 2), (2, 1), (2, 2) and (1, 4); legacy (1, 2), (2, 1),
(1, 3) and (2, 2); the overflow replay and the no-Bloom shard branch
(``bloom_blocks_for`` patched to None in both packages) on (2, 2).  The
stream's first batch has a read that overflows both engines in one data
shard only: the replay's collectives are then called by that shard's db
group alone.  Also:
``shard_tables_from_jax`` and the per-shard filters against the JAX
engine's arrays and ``_shard_blooms``.  Every comparison is exact.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.fpdb import build_fpdb
from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT = [1, 1, 1, 2, 2, 4, 1, 6]
NUM_TARG = 8
B, L = 16, 96  # the stream's batches
OB, OL, OMH = 8, 512, 8  # the overflow stream's batches and hit budget
TIMEOUT_S = 180

_WORKER = r"""
import importlib.abc, json, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kmer_id_tpu"):
            raise ImportError("import of " + name + " refused")
        return None

sys.meta_path.insert(0, _Refuse())
spec = json.loads(sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.fpdb import build_fpdb
from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
from kmer_id_tpu_torch.engine.pipeline import SampleProcessor
from kmer_id_tpu_torch.io.batch import Batch, LongRead, pack_codes
from kmer_id_tpu_torch.parallel import ShardedClassifier, ShardedFpClassifier, make_mesh
from kmer_id_tpu_torch.parallel import fpsharded
from kmer_id_tpu_torch.parallel.distributed import health_check, initialize, shutdown

w = json.load(open(spec["world"]))
keys = np.array(w["keys"], np.uint64)
n = len(keys)
packed = pack_probes(ProbeRecords(
    keys=keys, target=np.array(w["targets"], np.int32), org=np.zeros(n, np.int32),
    position=np.zeros(n, np.int32), fstrand=np.ones(n, bool), count=np.ones(n, np.int32)),
    num_targ=w["num_targ"])
tax = Taxonomy(np.array(w["parent"], np.int32))
fp = build_fpdb(packed, tax)
initialize(spec["coord"], spec["n"], spec["rank"], "cpu")
assert health_check("cpu")["ok"]
grid = make_mesh(data=spec["dp"], db=spec["dbp"], device="cpu")
out = {}


def records(name):
    return [(a, s, q) for a, s, q in w[name]]


def batch(rows, width, plane):
    codes = np.full((len(rows), width), 4, np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, s in enumerate(rows):
        c = codec.encode_bases(s)[:width]
        codes[i, : len(c)], lengths[i] = c, len(c)
    pk, exc = (None, None) if plane else pack_codes(codes, lengths)
    return Batch(codes=codes, lengths=lengths, metas=[None] * len(rows), n_rows=len(rows),
                 packed=pk, exc=exc)


def engine(kind, bs, ml, mh=32):
    if kind == "fp":
        return ShardedFpClassifier(packed, tax, grid, bs, ml, max_hits=mh, fpdb=fp)
    return ShardedClassifier(packed, tax, grid, bs, ml)


def sample(clf, name):
    cfg = ClassifyConfig.preset("nx", num_targ=w["num_targ"], batch_size=clf.batch_size,
                                max_len=clf.max_len)
    sp = SampleProcessor(clf, cfg, use_native=False)
    sp.feed(records(name))
    r = sp.finish()
    return {"gcount": r.gcount.tolist(), "ucount": r.ucount.tolist(), "reads": r.reads}


for task in spec["tasks"]:
    kind = task.split("_")[0]
    if task.endswith("_nobloom"):
        fpsharded.bloom_blocks_for = lambda n_keys: None
    if task.endswith("_sample") or task.endswith("_nobloom"):
        clf = engine(kind, w["B"], w["L"])
        out[task] = sample(clf, "reads")
        if kind == "fp":
            out[task]["bloom"] = "bloom" in clf._db
    elif task == "fp_overflow":
        out[task] = sample(engine("fp", w["OB"], w["OL"], w["OMH"]), "dense")
    else:  # the engine API
        clf = engine(kind, w["B"], w["L"])
        rows = [s for _, s, _ in w["reads"][: w["B"]]]
        seen = clf.new_seen()
        seen, f = clf.process_batch(seen, batch(rows, w["L"], plane=False))
        res = {"finals": np.asarray(f).tolist()}
        s2, f2 = clf.process_batch(clf.new_seen(), batch(rows, w["L"], plane=True))
        assert np.array_equal(f, f2) and torch.equal(seen, s2), "packed != code plane"
        items = [LongRead(meta=None, codes=codec.encode_bases(s)) for s in w["long"]]
        if kind == "fp":
            seen, lf = clf.process_long_many(seen, items)
            _, pending = clf.submit_batch(clf.new_seen(), batch(rows, w["L"], plane=False))
            _, lrows, lfin = clf.collect_local(clf.new_seen(), pending)
            res["local"] = [lrows.tolist(), np.asarray(lfin).tolist()]
        else:
            lf = []
            for it in items:
                seen, x = clf.process_long(seen, it)
                lf.append(int(x))
        n_loc = clf.loc_slots if kind == "fp" else clf.shard_len
        res.update(long=[int(x) for x in lf], seen=seen[:n_loc].tolist(),
                   ucount=clf.ucount(seen).tolist())
        out[task] = res
json.dump(out, open(spec["out"] % spec["rank"], "w"))
shutdown()  # a rank that exits with its group up can abort in the teardown
"""


def _dna(r, n):
    return "".join("ACGT"[i] for i in r.integers(0, 4, size=n))


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A DB of 240 random probes and every window of a 200-base genome on
    the 8-node tree of tests/test_sharding.py, a read stream (200 reads of
    80 bp with planted probes on either strand, some FASTQ, a few Ns, a
    genome copy in one data shard of the first batch: both engines' replay
    on those ranks only, and 3 long reads), 6 probe-dense reads for the
    overflow replay and 5 long reads of 4 planted probes."""
    r = np.random.default_rng(31)
    kset = set()
    while len(kset) < 240:
        key = codec.canonical_kmers(codec.encode_bases(_dna(r, 30)))[0]
        kset.update(int(k) for k in key)
    genome = _dna(r, 200)  # every window a probe: a copy of it overflows both engines
    kset.update(int(k) for k in codec.canonical_kmers(codec.encode_bases(genome))[0])
    keys = np.array(sorted(kset), dtype=np.uint64)
    targets = np.array([2 + i % 6 for i in range(len(keys))], np.int32)
    probes = [codec.key_to_string(int(k)) for k in keys]
    reads = []
    for i in range(200):
        seq = _dna(r, 80)
        if r.random() < 0.75:
            p, at = probes[int(r.integers(len(probes)))], int(r.integers(0, 51))
            seq = seq[:at] + (_rc(p) if r.random() < 0.5 else p) + seq[at + 30 :]
        if r.random() < 0.03:
            at = int(r.integers(0, 80))
            seq = seq[:at] + "N" + seq[at + 1 :]
        qual = "".join(chr(c) for c in r.integers(35, 74, size=80)) if r.random() < 0.7 else None
        reads.append((f"r{i}", seq, qual))
    reads[13] = ("g13", genome[40:120], None)  # batch 0, row 13: data shard 1 of 2 only
    for i in range(3):
        reads.append((f"L{i}", "".join(_dna(r, 150) + probes[i * 7] for _ in range(5)), None))
    dense = [(f"h{i}", "".join(probes[int(r.integers(len(probes)))] for _ in range(12)), None)
             for i in range(6)]
    long = ["".join(_dna(r, 120) + probes[(i * 11 + j * 3) % len(probes)] for j in range(4))
            for i in range(5)]
    w = dict(keys=keys.tolist(), targets=targets.tolist(), parent=PARENT, num_targ=NUM_TARG,
             reads=reads, dense=dense, long=long, B=B, L=L, OB=OB, OL=OL, OMH=OMH)
    path = tmp_path_factory.mktemp("grid") / "world.json"
    path.write_text(json.dumps(w))
    return w, path


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_grid(path, dp, dbp, tasks, tmp_path) -> list:
    """Every rank's results (rank order) of ``tasks`` on a dp x dbp grid of
    gloo ranks."""
    n = dp * dbp
    out = str(tmp_path / f"g{dp}x{dbp}_%d.json")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps(dict(
            coord=coord, n=n, rank=r, dp=dp, dbp=dbp, world=str(path), out=out, tasks=tasks))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, e) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} of {dp}x{dbp} failed:\n{e[-3000:]}"
    return [json.loads(open(out % r).read()) for r in range(n)]


# ------------------------------------------------------------- the JAX side


def _jax_db(w):
    from kmer_id_tpu.core.taxonomy import Taxonomy as JTaxonomy
    from kmer_id_tpu.db.probes import ProbeRecords as JRecords
    from kmer_id_tpu.db.probes import pack_probes as jpack

    keys = np.array(w["keys"], np.uint64)
    n = len(keys)
    rec = JRecords(keys=keys, target=np.array(w["targets"], np.int32),
                   org=np.zeros(n, np.int32), position=np.zeros(n, np.int32),
                   fstrand=np.ones(n, bool), count=np.ones(n, np.int32))
    return jpack(rec, num_targ=NUM_TARG), JTaxonomy(np.array(PARENT, np.int32))


def _jax_sample(clf, w, name):
    from kmer_id_tpu.config import ClassifyConfig as JConfig
    from kmer_id_tpu.engine.pipeline import SampleProcessor as JSampleProcessor

    cfg = JConfig.preset("nx", num_targ=NUM_TARG, batch_size=clf.batch_size,
                         max_len=clf.max_len)
    sp = JSampleProcessor(clf, cfg, use_native=False)
    sp.feed([tuple(x) for x in w[name]])
    r = sp.finish()
    return {"gcount": r.gcount.tolist(), "ucount": r.ucount.tolist(), "reads": r.reads}


def _codes(rows, width):
    codes = np.full((len(rows), width), 4, np.uint8)
    lengths = np.zeros(len(rows), np.int32)
    for i, s in enumerate(rows):
        c = codec.encode_bases(s)[:width]
        codes[i, : len(c)], lengths[i] = c, len(c)
    return codes, lengths


def jax_grid(w, dp, dbp, kind, task):
    """The JAX package's answer to one worker task on a dp x dbp mesh."""
    from kmer_id_tpu.core import codec as jcodec
    from kmer_id_tpu.io.batch import Batch as JBatch
    from kmer_id_tpu.io.batch import LongRead as JLongRead
    from kmer_id_tpu.parallel import ShardedClassifier as JSharded
    from kmer_id_tpu.parallel import make_mesh as jmesh
    from kmer_id_tpu.parallel.fpsharded import ShardedFpClassifier as JShardedFp

    packed, tax = _jax_db(w)
    mesh = jmesh(data=dp, db=dbp)
    if task == "fp_overflow":
        return _jax_sample(JShardedFp(packed, tax, mesh, OB, OL, max_hits=OMH), w, "dense")
    clf = (JShardedFp if kind == "fp" else JSharded)(packed, tax, mesh, B, L)
    if task.endswith("_sample") or task.endswith("_nobloom"):
        return _jax_sample(clf, w, "reads")
    codes, lengths = _codes([s for _, s, _ in w["reads"][:B]], L)
    seen, f = clf.process_batch(clf.new_seen(), JBatch(codes, lengths, [None] * B, B))
    items = [JLongRead(meta=None, codes=jcodec.encode_bases(s)) for s in w["long"]]
    if kind == "fp":
        seen, lf = clf.process_long_many(seen, items)
        blocks = np.asarray(seen).reshape(dp * dbp, -1)
    else:
        lf = []
        for it in items:
            seen, x = clf.process_long(seen, it)
            lf.append(x)
        blocks = np.asarray(seen)[:, :, : clf.shard_len].reshape(dp * dbp, -1)
    return {"finals": np.asarray(f).tolist(), "long": [int(x) for x in lf],
            "blocks": blocks.tolist(), "ucount": clf.ucount(seen).tolist()}


def port_single(w, kind, task):
    """The single-device port's answer (gcount, ucount, reads) to a stream
    task, on the CPU."""
    from kmer_id_tpu_torch.config import ClassifyConfig
    from kmer_id_tpu_torch.engine.classify import Classifier
    from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor

    keys = np.array(w["keys"], np.uint64)
    n = len(keys)
    packed = pack_probes(ProbeRecords(
        keys=keys, target=np.array(w["targets"], np.int32), org=np.zeros(n, np.int32),
        position=np.zeros(n, np.int32), fstrand=np.ones(n, bool), count=np.ones(n, np.int32)),
        num_targ=NUM_TARG)
    tax = Taxonomy(np.array(PARENT, np.int32))
    bs, ml, mh, name = (OB, OL, OMH, "dense") if task == "fp_overflow" else (B, L, 32, "reads")
    clf = (FpClassifier(packed, tax, bs, ml, max_hits=mh, device="cpu") if kind == "fp"
           else Classifier(packed, tax, bs, ml, device="cpu"))
    sp = SampleProcessor(clf, ClassifyConfig.preset("nx", num_targ=NUM_TARG, batch_size=bs,
                                                    max_len=ml), use_native=False)
    sp.feed([tuple(x) for x in w[name]])
    r = sp.finish()
    return {"gcount": r.gcount.tolist(), "ucount": r.ucount.tolist(), "reads": r.reads}


GRIDS = {  # (dp, dbp): the worker's tasks there (legacy grids: test_torch_sharding_legacy.py)
    (1, 2): ["fp_sample", "fp_engine"],
    (2, 1): ["fp_sample", "fp_engine"],
    (2, 2): ["fp_sample", "fp_engine", "fp_overflow", "fp_nobloom"],
    (1, 4): ["fp_sample", "fp_engine"],
}


def grid_fixture(table):
    """A module fixture: {(dp, dbp): every rank's results} of ``table``'s
    grids, each grid run once, when a test first asks for it."""

    @pytest.fixture(scope="module")
    def grids(world, tmp_path_factory):
        cache = {}

        def get(dp, dbp):
            if (dp, dbp) not in cache:
                cache[(dp, dbp)] = run_grid(world[1], dp, dbp, table[(dp, dbp)],
                                            tmp_path_factory.mktemp(f"g{dp}{dbp}"))
            return cache[(dp, dbp)]

        return get

    return grids


def cases(table):
    return [(g, t) for g, tasks in table.items() for t in tasks]


def case_ids(table):
    return [f"{g[0]}x{g[1]}-{t}" for g, t in cases(table)]


def check_case(world, ranks, grid, task, monkeypatch):
    """Every rank's answer to ``task`` on ``grid`` against the JAX package's
    and (for a stream) the single-device port's."""
    w, _ = world
    dp, dbp = grid
    kind = task.split("_")[0]
    got = ranks[0][task]
    for r in ranks[1:]:  # every rank holds the same answer
        if task.endswith("_engine"):
            assert {k: v for k, v in r[task].items() if k not in ("seen", "local")} == \
                   {k: v for k, v in got.items() if k not in ("seen", "local")}
        else:
            assert r[task] == got
    if task.endswith("_nobloom"):
        import kmer_id_tpu.db.fpdb as jfpdb

        monkeypatch.setattr(jfpdb, "bloom_blocks_for", lambda n_keys: None)
        assert got.pop("bloom") is False
    elif "bloom" in got:
        assert got.pop("bloom") is True
    want = jax_grid(w, dp, dbp, kind, task)
    if task.endswith("_engine"):
        assert got["finals"] == want["finals"]
        assert got["long"] == want["long"]
        assert got["ucount"] == want["ucount"] and sum(got["ucount"]) > 0
        for r, res in enumerate(ranks):  # each rank's seen block is JAX's block (d, k)
            assert res[task]["seen"] == want["blocks"][r], f"rank {r} seen block"
        if kind == "fp":
            rows = [res[task]["local"][0] for res in ranks]
            fin = [res[task]["local"][1] for res in ranks]
            for r, (rw, fn) in enumerate(zip(rows, fin)):
                assert rw == list(range((r // dbp) * B // dp, (r // dbp + 1) * B // dp))
                assert fn == [want["finals"][i] for i in rw]
    else:
        assert got == want
        assert got == port_single(w, kind, task)
        assert sum(got["ucount"]) > 0 and got["gcount"][0] < got["reads"]


grids = grid_fixture(GRIDS)


@pytest.mark.parametrize("grid,task", cases(GRIDS), ids=case_ids(GRIDS))
def test_grid_matches_jax_and_single_device(world, grids, monkeypatch, grid, task):
    check_case(world, grids(*grid), grid, task, monkeypatch)


def test_shard_tables_and_filters_match_jax(world):
    """Each rank's tables and Bloom filter are the JAX engine's blocks
    (``shard_tables_from_jax`` of its arrays, and ``_shard_blooms``)."""
    from kmer_id_tpu.parallel import make_mesh as jmesh
    from kmer_id_tpu.parallel.fpsharded import ShardedFpClassifier as JShardedFp
    from kmer_id_tpu.parallel.fpsharded import _shard_blooms

    from kmer_id_tpu_torch.parallel.fpsharded import (
        shard_bloom,
        shard_tables,
        shard_tables_from_jax,
    )

    w, _ = world
    packed, jtax = _jax_db(w)
    keys = np.array(w["keys"], np.uint64)
    n = len(keys)
    ppacked = pack_probes(ProbeRecords(
        keys=keys, target=np.array(w["targets"], np.int32), org=np.zeros(n, np.int32),
        position=np.zeros(n, np.int32), fstrand=np.ones(n, bool), count=np.ones(n, np.int32)),
        num_targ=NUM_TARG)
    tax = Taxonomy(np.array(PARENT, np.int32))
    f = build_fpdb(ppacked, tax)
    for dp, dbp in ((1, 1), (1, 2), (2, 4), (1, 8)):
        jclf = JShardedFp(packed, jtax, jmesh(data=dp, db=dbp), B, L)
        blooms = _shard_blooms(jclf.fpdb, dbp, jclf.nbloc)
        arrays = {k: np.asarray(getattr(jclf, k)) for k in
                  ("_fptab", "_fptab2", "_rec", "_tinfo", "_chain3")}
        arrays["_bloom"] = None if jclf._bloom is None else np.asarray(jclf._bloom)
        arrays["_salts"] = [int(s) for s in jclf._salts]
        for k in range(dbp):
            mine = shard_tables(f, tax, dbp, k, "cpu")
            theirs = shard_tables_from_jax(arrays, dbp, k, "cpu")
            assert sorted(mine) == sorted(theirs)
            for name, v in mine.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, theirs[name]), (dbp, k, name)
                else:
                    assert v == theirs[name], (dbp, k, name)
            assert np.array_equal(shard_bloom(f, dbp, k), blooms[k]), (dbp, k)
        assert "bloom" in mine


def test_grid_refusals():
    """make_mesh and the engines refuse as JAX does."""
    from kmer_id_tpu_torch.parallel import ShardedFpClassifier, make_mesh
    from kmer_id_tpu_torch.parallel.mesh import Grid

    with pytest.raises(ValueError, match="db axis"):
        make_mesh(data=1, db=0)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(data=2, db=1)
    g = make_mesh()
    assert (g.dp, g.dbp, g.rank, g.world, g.backend) == (1, 1, 0, 1, None)
    assert torch.equal(g.psum_db(torch.arange(3)), torch.arange(3))
    assert g.all_gather_data(torch.arange(3)).shape == (1, 3)
    keys = np.arange(1, 200, dtype=np.uint64) * np.uint64(7919)
    n = len(keys)
    packed = pack_probes(ProbeRecords(
        keys=keys, target=np.full(n, 2, np.int32), org=np.zeros(n, np.int32),
        position=np.zeros(n, np.int32), fstrand=np.ones(n, bool), count=np.ones(n, np.int32)),
        num_targ=NUM_TARG)
    tax = Taxonomy(np.array(PARENT, np.int32))
    odd = Grid(rank=0, world=3, dp=3, dbp=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by data=3"):
        ShardedFpClassifier(packed, tax, odd, batch_size=16)
    wide = Grid(rank=0, world=1 << 12, dp=1, dbp=1 << 12, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by db"):
        ShardedFpClassifier(packed, tax, wide, batch_size=16)
