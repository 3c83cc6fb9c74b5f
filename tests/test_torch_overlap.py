"""The port's overlap of host and device (engine/pipeline.py) against the
JAX package's, on the CPU.

* A port of ``tests/test_pipeline_stress.py``: 20 repetitions with an
  engine proxy that delays collects, grouped collects, the long-read lane
  and submits by a per-call amount, at pipeline depths 4-7, with long reads
  and candidate-overflow reads interleaved; every repetition's gcount,
  ucount and saved reads must be byte-identical to the JAX
  ``SampleProcessor`` on the same records, on both feeds.
* ``FpClassifier.collect_many`` equal to per-batch ``collect`` and to the
  JAX ``collect_many``, with a candidate-overflow row in the group.
* A worker that raises makes ``finish()`` raise, with no worker thread left.
* Every engine takes engine/host.py's ``Engine``: the sample loop's five
  calls, ``process_batch`` and ``process_long`` written once.
* Under ``minalign > 0`` no worker thread exists and the engine runs on the
  calling thread.
* The kernels' launch counts and ``chip_smoke.legacy_runs`` stay exact when
  several threads count at once.
"""

import dataclasses
import io
import sys
import threading
import time

import numpy as np
import pytest

from kmer_id_tpu.config import ClassifyConfig as JaxClassifyConfig
from kmer_id_tpu.core import codec as jcodec
from kmer_id_tpu.core.taxonomy import Taxonomy as JaxTaxonomy
from kmer_id_tpu.db.probes import pack_probes as jax_pack_probes
from kmer_id_tpu.engine.fpclassify import FpClassifier as JaxFpClassifier
from kmer_id_tpu.engine.pipeline import SampleProcessor as JaxSampleProcessor
from kmer_id_tpu.io.batch import ReadBatcher as JaxReadBatcher
from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
from kmer_id_tpu_torch.engine.classify import Classifier
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
from kmer_id_tpu_torch.engine.host import Engine
from kmer_id_tpu_torch.engine.pipeline import SampleProcessor
from kmer_id_tpu_torch.io.batch import ReadBatcher
from kmer_id_tpu_torch.parallel.fpsharded import ShardedFpClassifier
from kmer_id_tpu_torch.parallel.sharded import ShardedClassifier
from tests.test_classify_e2e import make_db, make_reads, rand_dna

PARENT = [1, 1, 1, 2, 2, 4, 1, 6]
BATCH, MAX_LEN, MAX_HITS = 16, 96, 8
WORKERS = ("kmer-submit", "kmer-collect")


class SlowEngine:
    """Engine proxy that delays each collect, grouped collect, long-read
    call and submit by a deterministic per-call amount, widening the
    submit/collect race windows."""

    def __init__(self, clf, delays_ms):
        self._clf = clf
        self._delays = delays_ms
        self._n = {"collect": 0, "submit": 0}

    def __getattr__(self, name):
        return getattr(self._clf, name)

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


def _records(kmap):
    """~200 normal reads + interleaved long reads + overflow-dense reads
    (the JAX stress test's records)."""
    recs = make_reads(kmap, n=200, read_len=80)
    keys = list(kmap)
    out = []
    for i, r in enumerate(recs):
        out.append(r)
        if i % 23 == 11:  # long read (> max_len): chunked lane
            parts = []
            for j in range(4):
                parts.append(rand_dna(140))
                parts.append(jcodec.key_to_string(keys[(i + j * 5) % len(keys)]))
            out.append((f"L{i}", "".join(parts), None))
        if i % 31 == 7:  # hit-dense read: candidate overflow -> host replay
            seq = "".join(jcodec.key_to_string(keys[(i * 3 + j) % len(keys)]) for j in range(12))
            out.append((f"D{i}", seq, None))
    return out


def _feed(sp, records, fasta):
    """The Python feed in chunks of 17 records, or the FASTA file through
    the native feed."""
    if fasta is None:
        for s in range(0, len(records), 17):
            sp.feed(records[s : s + 17])
    else:
        sp.feed_file(str(fasta))
    res = sp.finish()
    return res.gcount.tolist(), res.ucount.tolist(), res.reads, sp.reads_out.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' engines on one probe DB, the stress records, the same
    records as a FASTA file, and the JAX SampleProcessor's outputs on each
    feed."""
    jrec, kmap = make_db(num_targ=8, probes_per_target=40)
    records = _records(kmap)
    # a read-long stretch whose every window is a probe: the dense path and
    # a candidate overflow in a short-read batch
    dense = rand_dna(MAX_LEN)
    extra = np.setdiff1d(jcodec.canonical_kmers(jcodec.encode_bases(dense))[0], jrec.keys)
    jrec = dataclasses.replace(jrec, **{
        k: np.concatenate([getattr(jrec, k), v]) for k, v in (
            ("keys", extra), ("target", np.full(len(extra), 5, np.int32)),
            ("org", np.zeros(len(extra), np.int32)), ("position", np.zeros(len(extra), np.int32)),
            ("fstrand", np.ones(len(extra), bool)), ("count", np.ones(len(extra), np.int32)))})
    records.insert(40, ("@dense", dense, None))
    fasta = tmp_path_factory.mktemp("overlap") / "reads.fasta"
    fasta.write_text("".join(f">{acc.lstrip('@>')}\n{seq}\n" for acc, seq, _ in records))
    jclf = JaxFpClassifier(jax_pack_probes(jrec, num_targ=8),
                           JaxTaxonomy(np.array(PARENT, np.int32)),
                           batch_size=BATCH, max_len=MAX_LEN, max_hits=MAX_HITS)
    packed = pack_probes(ProbeRecords(**dataclasses.asdict(jrec)), num_targ=8)
    clf = FpClassifier(packed, Taxonomy(np.array(PARENT, np.int32)), batch_size=BATCH,
                       max_len=MAX_LEN, max_hits=MAX_HITS, device="cpu")
    jcfg = JaxClassifyConfig.preset("nx", num_targ=8, batch_size=BATCH, max_len=MAX_LEN)
    want = {}
    for feed, path in (("python", None), ("native", fasta)):
        sp = JaxSampleProcessor(jclf, jcfg, reads_out=io.StringIO(), use_native=path is not None)
        want[feed] = _feed(sp, records, path)
    assert want["python"][2] == len(records) and want["python"][3]  # capture exercised
    return dict(records=records, fasta=fasta, jclf=jclf, clf=clf, packed=packed, want=want,
                dense=dense)


def _cfg(**kw):
    return ClassifyConfig.preset("nx", num_targ=8, batch_size=BATCH, max_len=MAX_LEN, **kw)


@pytest.mark.parametrize("feed", ["python", "native"])
def test_collector_pipeline_deterministic_under_stress(world, feed):
    fasta = world["fasta"] if feed == "native" else None
    want = world["want"][feed]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for rep in range(20):
            clf = SlowEngine(world["clf"], delays_ms=(rep % 5, 11, 0, (rep * 3) % 17))
            sp = SampleProcessor(clf, _cfg(), reads_out=io.StringIO(),
                                 use_native=fasta is not None)
            assert sp.native == (fasta is not None) and sp.collect_group == 4
            sp.pipeline_depth = 4 + rep % 4
            got = _feed(sp, world["records"], fasta)
            assert got[:3] == want[:3], rep
            assert got[3] == want[3], rep
    finally:
        sys.setswitchinterval(interval)


def test_collect_many_equals_collect_and_jax(world):
    """The batches of 64 reads, one a candidate-overflow read, collected at
    once: the same finals and the same ``seen`` marks as batch by batch,
    and as the JAX engine's ``collect_many``."""
    clf, jclf = world["clf"], world["jclf"]
    short = [r for r in world["records"] if r[0].lstrip("@").startswith("r")]
    recs = short[:20] + [("@dense", world["dense"], None)] + short[20 : 4 * BATCH - 1]
    rb, jrb = ReadBatcher(BATCH, MAX_LEN, u_is_t=False), JaxReadBatcher(BATCH, MAX_LEN)
    batches = [b for r in recs for b in rb.add(*r)] + list(rb.flush())
    jbatches = [b for r in recs for b in jrb.add(*r)] + list(jrb.flush())
    assert len(batches) == len(jbatches) >= 4

    def submitted(eng, bs):
        seen, pendings = eng.new_seen(), []
        for b in bs:
            seen, p = eng.submit_batch(seen, b)
            pendings.append(p)
        return pendings

    pendings = submitted(clf, batches)
    assert any((np.asarray(p.packed) & (1 << 30)).any() for p in pendings)  # an overflow row
    seen_many, many = clf.collect_many(clf.new_seen(), pendings)
    seen_one, one = clf.new_seen(), []
    for p in pendings:
        seen_one, f = clf.collect(seen_one, p)
        one.append(f)
    jseen, jmany = jclf.collect_many(jclf.new_seen(), submitted(jclf, jbatches))
    n = len(np.asarray(jseen))
    assert [f.tolist() for f in many] == [f.tolist() for f in one]
    assert [f.tolist() for f in many] == [np.asarray(f).tolist() for f in jmany]
    assert seen_many[:n].tolist() == seen_one[:n].tolist() == np.asarray(jseen).tolist()
    assert int(seen_many[:n].sum()) > 0  # the overflow replay marked slots


@pytest.mark.parametrize("cls", [Classifier, FpClassifier, ShardedClassifier,
                                 ShardedFpClassifier])
def test_engines_take_one_interface(cls):
    """Each engine answers the sample loop's five calls, and
    ``process_batch`` and ``process_long`` are written once, in ``Engine``."""
    assert issubclass(cls, Engine)
    for name in ("new_seen", "submit_batch", "collect_many", "process_long_many", "ucount",
                 "collect"):
        assert callable(getattr(cls, name, None)), name
    for name in ("process_batch", "process_long"):
        assert [k for k in cls.__mro__ if name in k.__dict__] == [Engine], name


def test_pendings_name_the_tensors_their_collect_reads(world):
    """``_receive`` marks a pending batch's ``held`` tensors as used on the
    collector's stream: every engine's pending batch has them, the
    fingerprint grid's ``ShardPending`` among them."""
    import torch

    from kmer_id_tpu_torch.ops.gate import ReadPlanes
    from kmer_id_tpu_torch.parallel.fpsharded import ShardPending

    rb = ReadBatcher(BATCH, MAX_LEN, u_is_t=False)
    short = [r for r in world["records"] if r[0].lstrip("@").startswith("r")][:BATCH]
    (batch,) = [b for r in short for b in rb.add(*r)] + list(rb.flush())
    _, pending = world["clf"].submit_batch(world["clf"].new_seen(), batch)
    assert pending.held and all(isinstance(t, torch.Tensor) for t in pending.held)
    reads = ReadPlanes.from_batch(batch, "cpu", MAX_LEN)
    finals, ovr = torch.zeros(BATCH, dtype=torch.int32), torch.zeros((), dtype=torch.int32)
    held = ShardPending(finals, reads, BATCH, ovr).held
    assert held[0] is finals and held[-1] is ovr
    assert {id(t) for t in held} >= {id(t) for t in (reads.lengths, reads.packed)
                                     if t is not None}


class Failing:
    """Engine proxy that raises from the third batch through its ``where``
    side: ``collect`` (the batches of its ``collect_many`` calls) or
    ``submit_batch``."""

    def __init__(self, clf, where):
        self._clf = clf
        self._where = where
        self._n = 0

    def __getattr__(self, name):
        return getattr(self._clf, name)

    def _pass(self, side, batches):
        if side == self._where:
            self._n += batches
            if self._n >= 3:
                raise RuntimeError(f"{side} failed on batch 3")

    def submit_batch(self, seen, batch):
        self._pass("submit_batch", 1)
        return self._clf.submit_batch(seen, batch)

    def collect_many(self, seen, pendings):
        self._pass("collect", len(pendings))
        return self._clf.collect_many(seen, pendings)


def _workers():
    return {t for t in threading.enumerate() if t.name.startswith(WORKERS) and t.is_alive()}


@pytest.mark.parametrize("where", ["collect", "submit_batch"])
def test_worker_exception_fails_finish(world, where):
    """Five batches, collected in groups of 4: the collect (or submit) of
    the third raises; finish() raises it within the timeout, and both
    workers have stopped."""
    before = _workers()
    recs = [r for r in world["records"] if not r[0].startswith("L")][: 5 * BATCH]
    out = {}

    def run():
        sp = SampleProcessor(Failing(world["clf"], where), _cfg(), reads_out=io.StringIO(),
                             use_native=False)
        out["collect_group"] = sp.collect_group
        sp.feed(recs)
        out["fed"] = True
        try:
            sp.finish()
        except RuntimeError as e:
            out["raised"] = str(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert out == {"collect_group": 4, "fed": True, "raised": f"{where} failed on batch 3"}
    assert _workers() - before == set()


def test_minalign_runs_on_the_calling_thread(world, tmp_path):
    """With ``minalign > 0`` the processor has no workers: the legacy
    engine's detail batches and long reads run on the calling thread."""
    clf = Classifier(world["packed"], Taxonomy(np.array(PARENT, np.int32)), batch_size=BATCH,
                     max_len=MAX_LEN, device="cpu")
    threads = []

    class Recording:
        def __getattr__(self, name):
            return getattr(clf, name)

        def detail_batch(self, seen, batch):
            threads.append(threading.current_thread())
            return clf.detail_batch(seen, batch)

        def process_long_many(self, seen, items):
            threads.append(threading.current_thread())
            return clf.process_long_many(seen, items)

    before = _workers()
    cfg = ClassifyConfig.preset("vf6", num_targ=8, batch_size=BATCH, max_len=MAX_LEN,
                                minalign=60, fadir=str(tmp_path), accessions=["absent"],
                                engine="legacy")
    sp = SampleProcessor(Recording(), cfg, reads_out=io.StringIO())
    assert sp._submitter is None and sp._collector is None and not sp.native
    sp.feed(world["records"])
    res = sp.finish()
    assert res.reads == len(world["records"])
    assert len(threads) > 10 and set(threads) == {threading.current_thread()}
    assert _workers() - before == set()


def _hammer(fn, n_threads=8, per_thread=3000):
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [fn() for _ in range(per_thread)])
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    return n_threads * per_thread


def test_launch_counts_exact_across_threads():
    """Every wrapper's launch count, bumped from 8 threads at once, loses
    no launch."""
    from kmer_id_tpu_torch.ops.compact import compact_ranks_cuda
    from kmer_id_tpu_torch.ops.gate import extract_cuda, window_gate_cuda
    from kmer_id_tpu_torch.ops.probe import probe_verify_cuda

    for fn in (compact_ranks_cuda, extract_cuda, window_gate_cuda, probe_verify_cuda):
        fn.launches.reset()
        assert fn.launches.value == 0
        n = _hammer(fn.launches.add)
        assert fn.launches.value == n
        fn.launches.reset()


def test_legacy_runs_count_exact_across_threads(monkeypatch):
    """chip_smoke's count of the legacy engine's device runs by mode stays
    exact when the submitter and collector threads run the engine."""
    import chip_smoke

    monkeypatch.setattr(Classifier, "_run", lambda clf, seen, reads, mode, max_steps=None: None)
    with chip_smoke.legacy_runs() as runs:
        n = _hammer(lambda: Classifier._run(None, None, None, "targets"))
    assert runs == {"compact": 0, "targets": n, "detail": 0}
