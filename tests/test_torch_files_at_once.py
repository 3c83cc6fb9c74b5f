"""A request's read files decoded at once (engine/pipeline.py, files at once)
against the same sample fed one file at a time, on the CPU.

* ``_result.txt`` and ``_reads.txt`` byte-identical between the files
  decoded at once (a ``kmer-feed`` thread and a feeder per file, repeated
  with a delaying engine proxy), the port's Python feed one file at a time,
  and the JAX package's ``SampleProcessor``: a target whose first
  ``savenum`` reads straddle R1 and R2, long rows in R2, an R2 much shorter
  than R1, a three-file vf6 job (two files at once, the third after the
  first), FASTA input, and a target's reads spread one a batch over an R2
  shorter than R1.
* vf6 ``-target``, ``minalign > 0`` and a two-rank grid still feed one file
  at a time, with ``feed.overlap`` 0 (and the same files as the JAX
  package's).
* ``feed.overlap`` counts batches for two files and none for one, as
  ``decode_overlap_pct`` reads it.
* A missing file raises at its ``feed_file``; an error on a feed thread
  fails ``finish`` (or the next ``feed_file``) with every worker and feed
  thread stopped.
"""

import dataclasses
import gzip
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
from kmer_id_tpu.engine.classify import Classifier as JaxClassifier
from kmer_id_tpu.engine.fpclassify import FpClassifier as JaxFpClassifier
from kmer_id_tpu.engine.pipeline import SampleProcessor as JaxSampleProcessor
from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
from kmer_id_tpu_torch.engine import pipeline
from kmer_id_tpu_torch.engine.classify import Classifier
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
from kmer_id_tpu_torch.engine.pipeline import SampleProcessor
from kmer_id_tpu_torch.utils import timing
from tests.test_classify_e2e import make_db

PARENT = [1, 1, 1, 2, 2, 4, 1, 6]
BATCH, MAX_LEN, MAX_HITS, SAVENUM = 16, 96, 8, 5
THREADS = ("kmer-submit", "kmer-collect", "kmer-feed")


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _read(rng, by_target, t: int, n: int = 80) -> str:
    """``n`` random bases around one probe of target ``t`` (either strand),
    or none where ``t`` is 0; reads past ``MAX_LEN`` get a probe every ~100
    bases."""
    if t == 0:
        return _dna(rng, n)
    parts, left = [], n
    while left >= 30:
        keys = by_target[t]
        k = int(keys[rng.integers(len(keys))])
        if rng.random() < 0.5:
            k = jcodec.revcomp_key(k)
        gap = int(rng.integers(0, min(left - 30, 70) + 1))
        parts += [_dna(rng, gap), jcodec.key_to_string(k)]
        left -= gap + 30
        if n <= MAX_LEN:
            break
    return "".join(parts) + _dna(rng, left)


def _records(rng, by_target, n: int, name: str, targets, long_every: int = 0) -> list:
    out = []
    for i in range(n):
        t = int(targets[i]) if not callable(targets) else targets(i)
        long_ = long_every and i % long_every == long_every - 1
        out.append((f"{name}.{i}", _read(rng, by_target, t, int(rng.integers(220, 400))
                                         if long_ else 80)))
    return out


def _write(path, records, fasta: bool) -> str:
    if fasta:
        path.write_text("".join(f">{a}\n{s}\n" for a, s in records))
    else:
        with gzip.open(path, "wt") as f:
            f.write("".join(f"@{a}\n{s}\n+\n{'I' * len(s)}\n" for a, s in records))
    return str(path)


def _cases(rng, by_target):
    """{case: (variant, [(file name, records)])}."""
    other = lambda i: int(rng.choice([0, 2, 4, 5, 6, 7]))  # noqa: E731
    straddle_r1 = _records(rng, by_target, 60, "a1", other)
    for i in (7, 41):  # two reads of target 3 in R1, the rest of its first SAVENUM in R2
        straddle_r1[i] = (straddle_r1[i][0], _read(rng, by_target, 3))
    half3 = lambda i: 3 if i % 2 else other(i)  # noqa: E731
    sparse_r1 = _records(rng, by_target, 400, "f1", other)
    sparse_r1[5] = (sparse_r1[5][0], _read(rng, by_target, 3))
    sparse3 = lambda i: 3 if i % BATCH == 7 else other(i)  # noqa: E731
    anyt = lambda i: int(rng.choice([0, 2, 3, 4, 5, 6, 7]))  # noqa: E731
    return {
        "straddle": ("nx", [("a_R1.fastq.gz", straddle_r1),
                            ("a_R2.fastq.gz", _records(rng, by_target, 60, "a2", half3))]),
        "long_r2": ("nx", [("b_R1.fastq.gz", _records(rng, by_target, 60, "b1", anyt)),
                           ("b_R2.fastq.gz", _records(rng, by_target, 40, "b2", anyt, 4))]),
        "short_r2": ("nx", [("c_R1.fastq.gz", _records(rng, by_target, 300, "c1", anyt)),
                            ("c_R2.fastq.gz", _records(rng, by_target, 5, "c2", half3))]),
        "three_files": ("vf6", [(f"d{j}.fastq.gz", _records(rng, by_target, n, f"d{j}", anyt))
                                for j, n in enumerate((50, 30, 70))]),
        "fasta": ("nx", [("e_R1.fasta", _records(rng, by_target, 80, "e1", anyt)),
                         ("e_R2.fasta", _records(rng, by_target, 60, "e2", half3, 9))]),
        # one read of target 3 in each of R2's batches, held while the
        # longer R1 is still accounted
        "sparse_r2": ("nx", [("f_R1.fastq.gz", sparse_r1),
                             ("f_R2.fastq.gz", _records(rng, by_target, 200, "f2", sparse3))]),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' engines on one probe DB, and each case's files."""
    jrec, kmap = make_db(num_targ=8, probes_per_target=40)
    by_target: dict = {}
    for k, t in kmap.items():
        by_target.setdefault(t, []).append(k)
    rng = np.random.default_rng(2048)
    d = tmp_path_factory.mktemp("files_at_once")
    cases = {}
    for case, (variant, files) in _cases(rng, by_target).items():
        paths = [_write(d / name, recs, name.endswith(".fasta")) for name, recs in files]
        cases[case] = (variant, paths, files)
    packed = pack_probes(ProbeRecords(**dataclasses.asdict(jrec)), num_targ=8)
    clf = FpClassifier(packed, Taxonomy(np.array(PARENT, np.int32)), batch_size=BATCH,
                       max_len=MAX_LEN, max_hits=MAX_HITS, device="cpu")
    jpacked = jax_pack_probes(jrec, num_targ=8)
    jclf = JaxFpClassifier(jpacked, JaxTaxonomy(np.array(PARENT, np.int32)),
                           batch_size=BATCH, max_len=MAX_LEN, max_hits=MAX_HITS)
    return dict(cases=cases, clf=clf, jclf=jclf, packed=packed, jpacked=jpacked, dir=d)


class SlowEngine:
    """Engine proxy that delays each submit and grouped collect by a
    per-call amount, so that the files' batches interleave differently."""

    def __init__(self, clf, delays_ms):
        self._clf, self._delays, self._n = clf, delays_ms, 0

    def __getattr__(self, name):
        return getattr(self._clf, name)

    def _sleep(self):
        self._n += 1
        time.sleep(self._delays[self._n % len(self._delays)] / 1000.0)

    def submit_batch(self, seen, batch):
        self._sleep()
        return self._clf.submit_batch(seen, batch)

    def collect_many(self, seen, pendings):
        self._sleep()
        return self._clf.collect_many(seen, pendings)


def _cfg(variant, **kw):
    return ClassifyConfig.preset(variant, num_targ=8, batch_size=BATCH, max_len=MAX_LEN,
                                 savenum=SAVENUM, **kw)


def _run(sp, paths, target=False) -> tuple:
    """Each file through ``sp``, then its files' bytes: (result, reads[,
    target reads])."""
    for p in paths:
        sp.feed_file(p)
    res = sp.finish()
    out = ("".join(f"{i},{res.gcount[i]},{res.ucount[i]}\n" for i in range(len(res.gcount))),
           sp.reads_out.getvalue())
    return out + ((sp.target_reads_out.getvalue(),) if target else ())


def _jax(world, variant, paths, target=False, jclf=None, **kw):
    jcfg = JaxClassifyConfig.preset(variant, num_targ=8, batch_size=BATCH, max_len=MAX_LEN,
                                    savenum=SAVENUM, **kw)
    t_out = io.StringIO() if target else None
    sp = JaxSampleProcessor(jclf or world["jclf"], jcfg, reads_out=io.StringIO(),
                            target_reads_out=t_out, use_native=False)
    return _run(sp, paths, target)


def _threads():
    return {t for t in threading.enumerate() if t.name.startswith(THREADS) and t.is_alive()}


@pytest.mark.parametrize("case", ["straddle", "long_r2", "short_r2", "three_files", "fasta",
                                  "sparse_r2"])
def test_files_at_once_equal_one_at_a_time_and_jax(world, case):
    variant, paths, files = world["cases"][case]
    want = _jax(world, variant, paths)
    one = SampleProcessor(world["clf"], _cfg(variant), reads_out=io.StringIO(), use_native=False)
    assert not one._at_once
    assert _run(one, paths) == want
    assert want[1]  # reads were saved
    if case in ("straddle", "sparse_r2"):  # target 3's first SAVENUM: R1's, then R2's
        saved = [line for line in want[1].splitlines() if line.startswith(">3:")]
        r1 = 2 if case == "straddle" else 1
        assert [s.split(":")[1][2] for s in saved] == ["1"] * r1 + ["2"] * (SAVENUM - r1)
    if case == "long_r2":
        assert any(len(s) > MAX_LEN for _, s in files[1][1])
    before = _threads()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for rep in range(4):
            clf = SlowEngine(world["clf"], (rep % 3, 4, 0, (rep * 5) % 7)) if rep else world["clf"]
            sp = SampleProcessor(clf, _cfg(variant), reads_out=io.StringIO(), use_native=True)
            assert sp._at_once and sp._feeder is None
            assert _run(sp, paths) == want, rep
            assert sp._files == len(paths) and not sp._later and sp._head == len(paths)
    finally:
        sys.setswitchinterval(interval)
    assert _threads() - before == set()


@pytest.fixture
def traced():
    prev = timing.set_tracing(True)
    yield
    timing.set_tracing(prev)


@pytest.mark.parametrize("how", ["target", "minalign", "grid"])
def test_one_file_at_a_time_where_files_cannot_overlap(world, how, traced, monkeypatch,
                                                       tmp_path):
    """vf6 ``-target`` (every read of its target, in read order), ``minalign
    > 0`` (the calling thread, the Python feed) and a grid of two ranks
    (every rank submits in the same order) start no feed thread, count no
    overlap, and give the JAX package's files."""
    _, paths, _ = world["cases"]["straddle"]
    clf, kw, jkw, target = world["clf"], {}, {}, how == "target"
    if how == "target":
        kw = jkw = {"save_target": 3}
    elif how == "minalign":
        clf = Classifier(world["packed"], Taxonomy(np.array(PARENT, np.int32)),
                         batch_size=BATCH, max_len=MAX_LEN, device="cpu")
        kw = dict(minalign=60, fadir=str(tmp_path), accessions=["absent"], engine="legacy")
        jkw = dict(kw)
    else:
        monkeypatch.setattr(pipeline, "world_size", lambda: 2)
    before = _threads()
    sp = SampleProcessor(clf, _cfg("vf6" if target else "nx", **kw), reads_out=io.StringIO(),
                         target_reads_out=io.StringIO() if target else None)
    assert not sp._at_once
    got = _run(sp, paths, target)
    assert sp._files == 0 and not sp._feeds and _threads() - before == set()
    assert sp.trace.counters["feed.overlap"] == 0
    if how == "minalign":
        jclf = JaxClassifier(world["jpacked"], JaxTaxonomy(np.array(PARENT, np.int32)),
                             batch_size=BATCH, max_len=MAX_LEN)
        want = _jax(world, "nx", paths, jclf=jclf, **jkw)
    else:
        want = _jax(world, "vf6" if target else "nx", paths, target, **jkw)
    assert got == want
    if target:
        assert got[2].count(">3:") == 32  # R1's two and R2's thirty


@pytest.mark.parametrize("n_files", [1, 2])
def test_overlap_counter(world, n_files, traced):
    """Two files of a request decode at once: batches emitted while the
    other file decodes are counted (the submitter slowed, so neither file
    ends early); one file: none.  ``decode_overlap_pct`` reads the share."""
    from benchmark import spec

    _, paths, _ = world["cases"]["short_r2"]
    timing._recent.clear()
    r1 = world["cases"]["straddle"][1][0]
    sp = SampleProcessor(SlowEngine(world["clf"], (3,)), _cfg("nx"), reads_out=io.StringIO())
    _run(sp, [paths[0], r1][:n_files])
    c = sp.trace.counters
    assert c["batches"] == 19 + 4 * (n_files == 2)  # 300 and 60 reads in batches of 16
    assert (c["feed.overlap"] > 0) == (n_files == 2) and c["feed.overlap"] <= c["batches"]
    assert spec.reader("decode_overlap_pct")(None) == pytest.approx(
        100 * c["feed.overlap"] / c["batches"], rel=1e-12)
    assert "feed.join" in sp.trace.summary["spans"]
    timing._recent.clear()


def test_missing_file_raises_at_its_feed_file(world):
    _, paths, _ = world["cases"]["straddle"]
    before = _threads()
    sp = SampleProcessor(world["clf"], _cfg("nx"), reads_out=io.StringIO())
    sp.feed_file(paths[0])
    with pytest.raises(FileNotFoundError):
        sp.feed_file(str(world["dir"] / "absent_R2.fastq.gz"))
    res = sp.finish()  # R1 still classified in full
    assert res.reads == 60
    assert _threads() - before == set()


@pytest.mark.parametrize("where", ["finish", "next_feed_file"])
def test_feed_thread_error_stops_everything(world, where, monkeypatch):
    """The second file's feeder raises at its second batch: ``finish`` (or,
    once it and the oldest file have ended, the next ``feed_file``) raises
    it, and no worker or feed thread is left."""
    variant, paths, _ = world["cases"]["three_files"]
    made = []

    class Failing(pipeline.NativePlaneFeeder):
        def _pack(self):
            if made.index(self) == 1 and self.emitted == 1:
                raise RuntimeError("decoder failed")
            return super()._pack()

    def make(*a, **kw):
        made.append(Failing(*a, **kw))
        return made[-1]

    monkeypatch.setattr(pipeline, "NativePlaneFeeder", make)
    before = _threads()
    out = {}

    def run():
        sp = SampleProcessor(world["clf"], _cfg(variant), reads_out=io.StringIO())
        try:
            sp.feed_file(paths[1])
            sp.feed_file(paths[0])  # the failing file
            out["fed"] = True
            if where == "next_feed_file":
                sp._feeds[1].join()  # the failing file's thread has ended...
                sp._feeds.popleft().join()  # ...and the oldest's
                sp.feed_file(paths[2])
                out["third"] = True
            sp.finish()
        except RuntimeError as e:
            out["raised"] = str(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert out == {"fed": True, "raised": "decoder failed"}
    assert _threads() - before == set()


def test_metrics_record_has_the_overlap(world, tmp_path):
    """``classify-nx --metrics`` (``run_nx`` traced): the sample's record
    carries ``feed.overlap`` beside the ``inflate.*`` counters and the
    ``feed.join`` span, and the files equal the JAX package's."""
    import json
    import shutil

    from kmer_id_tpu_torch.engine.pipeline import LoadedDB, run_nx

    _, paths, _ = world["cases"]["straddle"]
    fq = tmp_path / "fq"
    fq.mkdir()
    for p, mate in zip(paths, ("R1", "R2")):
        shutil.copy(p, fq / f"s_{mate}_tr.fastq.gz")
    db = LoadedDB(world["packed"], Taxonomy(np.array(PARENT, np.int32)), None, 8, -1)
    metrics = tmp_path / "m.jsonl"
    with timing.tracing(True):
        assert run_nx(str(fq), db, _cfg("nx"), clf=world["clf"], metrics_path=str(metrics),
                      device="cpu") == ["s"]
    stages = json.loads(metrics.read_text().splitlines()[0])["stages"]
    assert {"feed.overlap", "inflate.blocks", "inflate.waits",
            "inflate.wait_us"} <= set(stages["counters"])
    assert stages["counters"]["feed.overlap"] <= stages["counters"]["batches"]
    assert {"feed.join", "sample.finish"} <= set(stages["spans"])
    want = _jax(world, "nx", paths)
    assert ((fq / "s_result.txt").read_text(), (fq / "s_reads.txt").read_text()) == want
