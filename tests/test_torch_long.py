"""The PyTorch engine's long-read lane (kmer_id_tpu_torch.engine.fpclassify)
on the CPU against the JAX engine on CPU JAX, on shared fingerprint tables.

``fp_long_finals`` and ``process_long_many`` must give the JAX engine's
finals and unique-k-mer ``seen`` set exactly (all integers), on consistent,
chimeric, chunk-overflow (genome verbatim: a probe at every window),
more-than-1,024-N, shorter-than-KSIZE, multi-group and
more-chunks-than-a-group reads.  The port's SampleProcessor with long reads
must equal the reference simulator on both feed paths.  Each engine gets its
own package's host objects (DB, taxonomy, reads), made from the same seed.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _toy_world
from chip_smoke import toy_world
from kmer_id_tpu.core import codec as jax_codec
from kmer_id_tpu.db.fpdb import build_fpdb as jax_build_fpdb
from kmer_id_tpu.engine import fpclassify as JF
from kmer_id_tpu.engine.fpclassify import FpClassifier as JaxFpClassifier
from kmer_id_tpu.io.batch import LongRead as JaxLongRead
from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.fpdb import build_fpdb
from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
from kmer_id_tpu_torch.engine import fpclassify as F
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
from kmer_id_tpu_torch.io.batch import LongRead
from kmer_id_tpu_torch.ops.gate import ReadPlanes
from tests.refsim import RefSim
from tests.test_classify_e2e import make_db, rand_dna

N_PROBES = 20_000
L = 96  # max_len: 67 windows per chunk row


@pytest.fixture(scope="module")
def world():
    """(port DB, port taxonomy, port fpdb, genome, (JAX DB, JAX taxonomy,
    JAX fpdb)): the same toy world from each package."""
    kw = dict(num_probes=N_PROBES, num_targ=64, batch=8, max_len=L)
    packed, tax, *_ = toy_world(**kw)
    jpk, jtax, *_ = _toy_world(**kw)
    src = np.random.default_rng(42).integers(0, 4, size=N_PROBES + codec.KSIZE,
                                             dtype=np.uint8)
    return packed, tax, build_fpdb(packed, tax), src, (jpk, jtax, jax_build_fpdb(jpk, jtax))


def _jax_engine(world, **kw):
    jpk, jtax, jfpdb = world[4]
    return JaxFpClassifier(jpk, jtax, max_len=L, fpdb=jfpdb, **kw)


def _plane_reads(planes, lens):
    """Chunk rows as the engine's code-plane batch."""
    return ReadPlanes(torch.from_numpy(lens), planes.shape[1],
                      codes=torch.from_numpy(planes))


def _reads(src, seed=7):
    """name -> LongRead codes covering each branch of the lane."""
    r = np.random.default_rng(seed)
    rnd = lambda n: r.integers(0, 4, size=n, dtype=np.uint8)  # noqa: E731

    def probe(i):
        return src[i : i + codec.KSIZE]

    rep = rnd(400)
    for p in (10, 150, 300):  # the same probe three times
        rep[p : p + 30] = probe(500)
    chim = rnd(700)
    for p, s in ((20, 100), (200, 7000), (450, 15000), (640, 3000)):  # chimeric
        chim[p : p + 30] = probe(s)
    nrun = np.concatenate([rnd(200), np.full(1100, codec.INVALID, np.uint8), rnd(300)])
    nrun[60:90] = probe(1234)
    nrun[1350:1380] = probe(9000)
    return {
        "consistent": np.concatenate([probe(42), rnd(150)]),  # one hit
        "repeat": rep,
        "chimeric": chim,
        "genome": src[2000:2700].copy(),  # every window a probe: chunk overflow
        "n_run": nrun,  # > EXC_CAP invalid bases: the u8 plane
        "short": rnd(20),  # shorter than KSIZE: no chunk rows
        "plain": rnd(300),  # no probes
    }


def _items(codes_list, cls=LongRead):
    return [cls(meta=None, codes=c) for c in codes_list]


def _run(world, codes_list, batch_size, max_hits=32):
    """(JAX finals, seen, ucount), (port finals, seen, ucount), port engine."""
    packed, tax, fpdb, *_ = world
    j = _jax_engine(world, batch_size=batch_size, max_hits=max_hits)
    t = FpClassifier(packed, tax, batch_size=batch_size, max_len=L, max_hits=max_hits,
                     fpdb=fpdb, device="cpu")
    jseen, jfin = j.process_long_many(j.new_seen(), _items(codes_list, JaxLongRead))
    tseen, tfin = t.process_long_many(t.new_seen(), _items(codes_list))
    n = t.fpdb.n_slots
    return ([int(x) for x in jfin], np.asarray(jseen), j.ucount(jseen),
            tfin, tseen[:n].numpy(), t.ucount(tseen), t)


@pytest.mark.parametrize("batch_size", [64, 32, 16])
def test_process_long_many_matches_jax(world, batch_size):
    """All reads (60 chunk rows) in one call: one group (64 rows), several
    groups (32), and more chunks in the N-run read (24) than a group (16:
    the summary lane)."""
    reads = _reads(world[3])
    jfin, jseen, juc, tfin, tseen, tuc, _ = _run(world, list(reads.values()), batch_size)
    assert tfin == jfin
    np.testing.assert_array_equal(tseen, jseen)
    np.testing.assert_array_equal(tuc, juc)
    names = list(reads)
    assert tfin[names.index("short")] == 0 and tfin[names.index("plain")] == 0
    assert tfin[names.index("genome")] > 0 and jseen.sum() > 600


@pytest.mark.parametrize("name", ["consistent", "repeat", "chimeric", "genome", "n_run",
                                  "short"])
def test_process_long_single_read_matches_jax(world, name):
    codes = _reads(world[3])[name]
    jfin, jseen, _, tfin, tseen, _, t = _run(world, [codes], 32)
    assert tfin == jfin
    np.testing.assert_array_equal(tseen, jseen)
    assert t.process_long(t.new_seen(), LongRead(meta=None, codes=codes))[1] == jfin[0]


def test_long_lane_branches_are_exercised(world, monkeypatch):
    """The fixture reads reach the device-flagged, overflow-replay, u8-plane
    and summary-lane branches."""
    packed, tax, fpdb, src, _ = world
    reads = _reads(src)
    t = FpClassifier(packed, tax, batch_size=32, max_len=L, fpdb=fpdb, device="cpu")
    calls = {"replay": 0, "summary": 0, "plane": 0}
    replay, summary, row_batch = t._replay_overflow, t._long_many_summary, t._row_batch

    def counted_replay(seen, batch, rows):
        calls["replay"] += len(rows) > 0
        return replay(seen, batch, rows)

    def counted_summary(*a):
        calls["summary"] += 1
        return summary(*a)

    def counted_row_batch(plane, lengths):
        b = row_batch(plane, lengths)
        calls["plane"] += b.packed is None
        return b

    monkeypatch.setattr(t, "_replay_overflow", counted_replay)
    monkeypatch.setattr(t, "_long_many_summary", counted_summary)
    monkeypatch.setattr(t, "_row_batch", counted_row_batch)
    t.process_long_many(t.new_seen(), _items(reads.values()))
    assert calls == {"replay": 1, "summary": 0, "plane": 1}
    t.batch_size = 8  # the genome read has 11 chunk rows
    t.process_long_many(t.new_seen(), _items([reads["genome"]]))
    assert calls["summary"] == 1
    # the chimeric read is flagged on device (inconsistent), the consistent
    # one is not
    planes, lens, item = t.chunk_rows(_items([reads["chimeric"], reads["consistent"]]))
    rows = t._reads(t._row_batch(planes, lens))
    fin, _ = F.fp_long_finals(t._db, rows, torch.from_numpy(item), t.new_seen(), 2,
                              F.LONG_HITS)
    assert int(fin[0]) & (1 << 30) and 1 < int(fin[1]) < (1 << 30)


def test_chunk_rows_halo(world):
    """Chunk rows step by max_len - KSIZE + 1, so every window of the read
    lies in exactly one row."""
    packed, tax, fpdb, src, _ = world
    t = FpClassifier(packed, tax, batch_size=16, max_len=L, fpdb=fpdb, device="cpu")
    codes = src[:500]
    planes, lens, item = t.chunk_rows(_items([codes, codes[:10]]))
    step = L - codec.KSIZE + 1
    assert (item == 0).all() and len(lens) == -(-(500 - codec.KSIZE + 1) // step)
    wins = sum(max(int(n) - codec.KSIZE + 1, 0) for n in lens)
    assert wins == 500 - codec.KSIZE + 1
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(planes[i, :n], codes[i * step : i * step + n])


def test_fp_long_finals_matches_jax(world):
    """fp_long_finals on one extract: rows of reads 0, 1 and 3 (read 2 has no
    rows: an empty segment) plus pad rows of length 0 on the sentinel
    segment 4."""
    packed, tax, fpdb, src, _ = world
    reads = _reads(src)
    t = FpClassifier(packed, tax, batch_size=64, max_len=L, fpdb=fpdb, device="cpu")
    j = _jax_engine(world, batch_size=64)
    planes, lens, item = t.chunk_rows(
        _items([reads["consistent"], reads["chimeric"], reads["plain"]]))
    item = np.where(item == 2, 3, item)
    pad = 3
    planes = np.concatenate([planes, np.full((pad, L), 4, np.uint8)])
    lens = np.concatenate([lens, np.zeros(pad, np.int32)])
    seg = np.concatenate([item, np.full(pad, 4)]).astype(np.int32)
    n_segs = 5
    jfin, jsum, jseen = JF._fp_long_codes(
        j._db, jnp.asarray(planes), jnp.asarray(lens), jnp.asarray(seg), j.new_seen(),
        n_segs=n_segs, max_hits=F.LONG_HITS)
    tseen = t.new_seen()
    tfin, tsum = F.fp_long_finals(t._db, _plane_reads(planes, lens), torch.from_numpy(seg), tseen, n_segs,
                                  F.LONG_HITS)
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
    np.testing.assert_array_equal(tseen[: t.fpdb.n_slots].numpy(), np.asarray(jseen))
    assert int(tfin[2]) == 0 and int(tfin[4]) == 0  # empty and pad segments
    assert int(tfin[1]) & (1 << 30) and tsum[:, 1].sum() > 0


def test_fp_summary_matches_jax(world):
    packed, tax, fpdb, src, _ = world
    reads = _reads(src)
    t = FpClassifier(packed, tax, batch_size=64, max_len=L, fpdb=fpdb, device="cpu")
    j = _jax_engine(world, batch_size=64)
    planes, lens, _ = t.chunk_rows(_items(reads.values()))
    for mh in (F.LONG_HITS, 32):
        rows = _plane_reads(planes, lens)
        jsum, jseen = JF._fp_sum_seen_codes(j._db, jnp.asarray(planes), jnp.asarray(lens),
                                            j.new_seen(), max_hits=mh)
        tseen = t.new_seen()
        np.testing.assert_array_equal(F.fp_summary_seen(t._db, rows, tseen, mh).numpy(),
                                      np.asarray(jsum))
        np.testing.assert_array_equal(tseen[: t.fpdb.n_slots].numpy(), np.asarray(jseen))


@pytest.fixture(scope="module")
def small_world():
    jrec, kmap = make_db()
    rec = ProbeRecords(**dataclasses.asdict(jrec))  # the port's own records
    parent = [1, 1, 1, 2, 2, 4, 1, 6]
    tax = Taxonomy(np.array(parent, dtype=np.int32))
    return kmap, parent, tax, pack_probes(rec, num_targ=8)


def _long_records(kmap, seed):
    r = np.random.default_rng(seed)
    records = []
    for i in range(6):
        parts = []
        for _ in range(8):
            parts.append(rand_dna(int(r.integers(50, 300))))
            parts.append(jax_codec.key_to_string(list(kmap)[int(r.integers(len(kmap)))]))
            if r.random() < 0.3:
                parts.append("N")
        records.append((f"c{i}", "".join(parts), None))
        records.append((f"s{i}", rand_dna(int(r.integers(40, 100))), None))
    return records


@pytest.mark.parametrize("native", [False, True])
def test_sample_processor_long_reads_match_refsim(small_world, tmp_path, native):
    """The port's SampleProcessor on long and short FASTA reads equals the
    reference simulator (tests/test_fp_engine.py's long-read case), on the
    Python batcher and on the native feeder."""
    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor

    kmap, parent, tax, packed = small_world
    records = _long_records(kmap, 11)
    sim = RefSim(kmap, parent, num_targ=8, u_is_t=False, variant="nx")
    sim.feed(records)
    cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=8, max_len=128)
    clf = FpClassifier(packed, tax, batch_size=8, max_len=128, device="cpu")
    buf = io.StringIO()
    sp = SampleProcessor(clf, cfg, reads_out=buf, use_native=native)
    if native and not sp.native:
        pytest.skip("native decoder unavailable")
    if native:
        path = tmp_path / "reads.fasta"
        path.write_text("".join(f">{a}\n{s}\n" for a, s, _ in records))
        sp.feed_file(str(path))
    else:
        sp.feed(records)
    res = sp.finish()
    assert res.reads == sim.reads
    assert res.gcount.tolist() == sim.gcount
    assert res.ucount.tolist() == sim.ucount
    assert buf.getvalue() == "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved)
    assert sum(sim.gcount[2:]) > 0
