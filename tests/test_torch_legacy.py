"""The legacy engine of the PyTorch port (kmer_id_tpu_torch.engine.classify
and the lookup and fold ops under it) on the CPU against the JAX package's
on CPU JAX, bit for bit.

* ``_mix32``, ``cuckoo_lookup``, ``searchsorted2`` and ``lookup_keys``
  (bucket index on and off, too few bisection steps included) on DB keys,
  misses and keys with bit 31 of ``lo`` set;
* ``lca``, ``msca``, ``compact_hits`` (rows without hits, inconsistent rows
  and rows past the 32-hit list) and ``fold_targets``;
* ``device_tables`` against the JAX ``Classifier._db``, and
  ``classify_core`` in its three modes, with ``seen``, on both input forms
  and both lookups, over reads with N bases and palindromic 30-mers;
* ``Classifier``'s finals, ``detail_batch``, ``process_long`` and ucount on
  the world of tests/test_classify_e2e.py, against the JAX ``Classifier``
  and the reference simulator;
* ``make_classifier``'s routing, the ``ValueError`` fallback included.

Each package gets its own host objects (DB, taxonomy, reads), made from the
same seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_classify_e2e as E2E
from __graft_entry__ import _toy_world
from chip_smoke import toy_world
from kmer_id_tpu.config import ClassifyConfig as JaxClassifyConfig
from kmer_id_tpu.core.taxonomy import Taxonomy as JaxTaxonomy
from kmer_id_tpu.db.probes import pack_probes as jax_pack_probes
from kmer_id_tpu.engine import classify as JC
from kmer_id_tpu.engine.pipeline import SampleProcessor as JaxSampleProcessor
from kmer_id_tpu.io.batch import LongRead as JaxLongRead
from kmer_id_tpu.io.batch import ReadBatcher as JaxReadBatcher
from kmer_id_tpu.ops import fold as JFold
from kmer_id_tpu.ops import lookup as JL
from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
from kmer_id_tpu_torch.engine import classify as C
from kmer_id_tpu_torch.engine import pipeline as P
from kmer_id_tpu_torch.engine.classify import Classifier, classify_core, device_tables
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
from kmer_id_tpu_torch.io.batch import Batch, LongRead, ReadBatcher, pack_codes
from kmer_id_tpu_torch.ops import fold as F
from kmer_id_tpu_torch.ops import lookup as L
from kmer_id_tpu_torch.ops.gate import ReadPlanes
from tests.refsim import RefSim

N_PROBES = 6000
B, W = 48, 96  # batch rows, row width: 67 windows


def _u32(t):
    return t.numpy().view(np.uint32)


def _t32(a):
    """uint32 numpy -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def world():
    """The toy world of each package (keys: every canonical 30-mer of one
    random genome), its read plane with N bases, palindromic windows and
    genome copies (rows past 32 hits), and both packages' legacy engines."""
    kw = dict(num_probes=N_PROBES, num_targ=40, batch=B, max_len=W, dense_rows=(4, 20))
    packed, tax, codes, lengths, _ = toy_world(**kw)
    jpk, jtax, jcodes, jlengths, *_ = _toy_world(**kw)
    assert np.array_equal(codes, np.asarray(jcodes))
    r = np.random.default_rng(11)
    codes = codes.copy()
    half = r.integers(0, 4, size=15).astype(np.uint8)
    pal = np.concatenate([half, 3 - half[::-1]])  # its own reverse complement
    for row in (1, 7, 30):
        codes[row, 10:40] = pal
        lengths[row] = W
    for row in r.choice(B, size=8, replace=False):
        codes[row, r.integers(0, W, size=2)] = 4
    lengths[[0, 5]] = (0, codec.KSIZE - 1)
    return dict(packed=packed, tax=tax, jpk=jpk, jtax=jtax, codes=codes,
                lengths=lengths.astype(np.int32))


def _keys(packed, r, n=3000):
    """Query words: DB keys (about half with bit 31 of lo set) and random
    60-bit misses."""
    k = np.concatenate([r.choice(packed.keys, size=n), r.integers(0, 1 << 60, size=n,
                                                                   dtype=np.uint64)])
    assert (k & np.uint64(1 << 31)).any()
    return (k >> np.uint64(32)).astype(np.uint32), (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def test_mix32_matches_jax():
    r = np.random.default_rng(1)
    a = r.integers(0, 2**32, size=5000, dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2**32, size=5000, dtype=np.uint64).astype(np.uint32)
    b[:100] |= np.uint32(1 << 31)
    for s1, s2 in ((0x9E3779B1, 0x85EBCA6B), (0xFFFFFFFF, 1), (7919, 0x80000001)):
        want = np.asarray(JL._mix32_jnp(jnp.asarray(a), jnp.asarray(b), jnp.uint32(s1),
                                        jnp.uint32(s2)))
        got = L._mix32(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)),
                       s1, s2)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_device_tables_match_jax_classifier_db(world):
    for use_cuckoo in (True, False):
        got = device_tables(world["packed"], use_cuckoo, "cpu")
        want = JC.Classifier(world["jpk"], world["jtax"], use_cuckoo=use_cuckoo)._db
        assert set(got) == set(want), use_cuckoo
        for k, w in want.items():
            g = got[k]
            if isinstance(g, int):
                assert g == int(w), k
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(g.numpy().dtype))


def test_cuckoo_lookup_matches_jax(world):
    hi, lo = _keys(world["packed"], np.random.default_rng(2))
    jdb = JC.Classifier(world["jpk"], world["jtax"])._db
    want = JL.cuckoo_lookup(jdb, jnp.asarray(hi), jnp.asarray(lo))
    got = L.cuckoo_lookup(device_tables(world["packed"], True, "cpu"), _t32(hi), _t32(lo))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    found = got[2].numpy()
    assert 0 < found.sum() < len(found)
    assert (got[1].numpy()[~found] == len(world["packed"])).all()  # the miss sentinel


@pytest.mark.parametrize("bucket_bits,max_steps", [(0, None), (0, 3), (6, None), (6, 2), (6, 4)])
def test_lookup_keys_matches_jax(world, bucket_bits, max_steps):
    """The sorted-array lookup, with and without a bucket index and with
    bisection step counts short of convergence (the JAX result is then not
    the lower bound, and the port must give the same)."""
    rec = world["packed"]
    records = ProbeRecords(keys=rec.keys, target=rec.target, org=np.zeros(len(rec), np.int32),
                           position=np.zeros(len(rec), np.int32),
                           fstrand=np.ones(len(rec), bool), count=np.ones(len(rec), np.int32))
    packed = pack_probes(records, num_targ=40, bucket_bits=bucket_bits)
    jpk = jax_pack_probes(records, num_targ=40, bucket_bits=bucket_bits)
    hi, lo = _keys(packed, np.random.default_rng(3))
    jdb = JC.Classifier(jpk, world["jtax"], use_cuckoo=False)._db
    want = JL.lookup_keys(jdb, jnp.asarray(hi), jnp.asarray(lo), bucket_bits=bucket_bits,
                          max_steps=max_steps)
    tdb = device_tables(packed, False, "cpu")
    got = L.lookup_keys(tdb, _t32(hi), _t32(lo), bucket_bits, max_steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if max_steps is None:
        assert got[1].numpy()[:3000].all() and not got[1].numpy()[3000:].any()
    ss = L.searchsorted2(tdb["hi"], tdb["lo"], _t32(hi), _t32(lo), steps=max_steps)
    want_ss = JL.searchsorted2(jdb["hi"], jdb["lo"], jnp.asarray(hi), jnp.asarray(lo),
                               steps=max_steps)
    np.testing.assert_array_equal(ss.numpy(), np.asarray(want_ss))


def _tree(seed, n=120):
    r = np.random.default_rng(seed)
    parent = np.ones(n, np.int32)
    for i in range(3, n):
        parent[i] = int(r.integers(1, i))
    return r, Taxonomy(parent), JaxTaxonomy(parent)


@pytest.mark.parametrize("seed", [0, 1])
def test_lca_and_msca_match_jax(seed):
    r, tax, jtax = _tree(seed)
    x = r.integers(0, 120, size=4000).astype(np.int32)
    y = r.integers(0, 120, size=4000).astype(np.int32)
    y[:200] = x[:200]
    anc, depth = torch.from_numpy(tax.anc), torch.from_numpy(tax.depth)
    ja, jd = jnp.asarray(jtax.anc), jnp.asarray(jtax.depth)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(F.lca(anc, depth, tx, ty).numpy(),
                                  np.asarray(JFold.lca_jnp(ja, jd, jnp.asarray(x), jnp.asarray(y))))
    got = F.msca(anc, depth, tx, ty).numpy()
    np.testing.assert_array_equal(got, np.asarray(JFold.msca_jnp(ja, jd, jnp.asarray(x),
                                                                 jnp.asarray(y))))
    live = (x > 0) & (y > 0)
    np.testing.assert_array_equal(got[live], tax.msca(x[live], y[live]))


def _target_plane(r, b=64, p=90):
    """Targets with holes; rows 0-1 without hits, rows 2-5 with more hits
    than the 32-hit list, rows 6-9 with one hit."""
    t = r.integers(2, 120, size=(b, p)).astype(np.int32)
    t[r.random((b, p)) < 0.85] = 0
    t[:2] = 0
    t[2:6, :34] = r.integers(2, 120, size=(4, 34))
    t[6:10] = 0
    t[6:10, r.integers(0, p, size=4)] = 7
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_hits_matches_jax(seed):
    r, tax, jtax = _tree(seed)
    t = _target_plane(r)
    want = np.asarray(JFold.compact_hits(jnp.asarray(jtax.anc), jnp.asarray(jtax.depth),
                                         jnp.asarray(t), 32))
    got = F.compact_hits(torch.from_numpy(tax.anc), torch.from_numpy(tax.depth),
                         torch.from_numpy(t), 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    g = got.numpy()
    # no hit: deepest 0, no hits, consistent, an empty list
    assert (g[:2, :2] == 0).all() and (g[:2, 2] == 1).all() and (g[:2, 3:] == 0).all()
    assert (g[2:6, 1] > 32).all() and (g[6:10, 2] == 1).all()
    assert (g[:, 2] == 0).any()  # inconsistent rows


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_targets_matches_jax(seed):
    r, tax, jtax = _tree(seed)
    t = _target_plane(r, b=24, p=40)
    init = np.where(r.random(24) < 0.5, r.integers(2, 120, size=24), 0).astype(np.int32)
    args = (jnp.asarray(jtax.anc), jnp.asarray(jtax.depth), jnp.asarray(t))
    targs = (torch.from_numpy(tax.anc), torch.from_numpy(tax.depth), torch.from_numpy(t))
    for i in (None, init):
        want = JFold.fold_targets(*args, None if i is None else jnp.asarray(i))
        got = F.fold_targets(*targs, None if i is None else torch.from_numpy(i))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _reads(codes, lengths, form):
    if form == "codes":
        return ReadPlanes(torch.from_numpy(lengths), codes.shape[1],
                          codes=torch.from_numpy(codes))
    packed, exc = pack_codes(codes, lengths)
    return ReadPlanes(torch.from_numpy(lengths), codes.shape[1],
                      packed=_t32(packed), exc=torch.from_numpy(exc))


@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("use_cuckoo", [True, False])
@pytest.mark.parametrize("mode", ["compact", "targets", "detail"])
def test_classify_core_matches_jax(world, mode, use_cuckoo, form):
    codes, lengths = world["codes"], world["lengths"]
    jclf = JC.Classifier(world["jpk"], world["jtax"], use_cuckoo=use_cuckoo)
    clf = Classifier(world["packed"], world["tax"], use_cuckoo=use_cuckoo, device="cpu")
    assert (clf.bucket_bits, clf.max_steps) == (jclf.bucket_bits, jclf.max_steps)
    jseen, jout = JC.classify_core(jclf.new_seen(), jclf._db, jclf._tax, jnp.asarray(codes),
                                   jnp.asarray(lengths), jclf.bucket_bits, mode, 32,
                                   jclf.max_steps)
    seen, out = classify_core(clf.new_seen(), clf._db, clf._tax, _reads(codes, lengths, form),
                              clf.bucket_bits, mode, 32, clf.max_steps)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    if mode == "detail":
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
        for g, w in zip(out[1:], jout[1:]):
            np.testing.assert_array_equal(_u32(g), np.asarray(w))
        d = out[0].numpy()
        assert (d > 0).any() and (d < 0).any() and not seen.numpy().any()
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert seen.numpy()[:-1].sum() > 0
    if mode == "compact":
        s = out.numpy()
        assert (s[:, 1] > 32).any() and (s[:, 2] == 0).any()  # overflow, inconsistent


def test_resolve_finals_matches_jax(world):
    """Host resolution of the summary, overflow rows through the full plane."""
    codes, lengths = world["codes"], world["lengths"]
    clf = Classifier(world["packed"], world["tax"], device="cpu")
    reads = _reads(codes, lengths, "packed")
    _, summary = clf._run(clf.new_seen(), reads, "compact")
    _, full = clf._run(clf.new_seen(), reads, "targets")
    got = C.resolve_finals(world["tax"], summary.numpy(), lambda: full.numpy())
    want = JC.resolve_finals(world["jtax"], summary.numpy(), lambda: full.numpy())
    np.testing.assert_array_equal(got, want)
    assert (got > 1).sum() > 4


# ------------------------------------------- the tests/test_classify_e2e.py world


@pytest.fixture
def e2e(monkeypatch):
    """tests/test_classify_e2e.py's DB and reads, from its seed (its module
    generator is replaced for this test only), with each package's DB and
    taxonomy, and long contigs with planted probes and N runs."""
    monkeypatch.setattr(E2E, "rng", np.random.default_rng(7))
    rec, kmap = E2E.make_db()
    parent = [1, 1, 1, 2, 2, 4, 1, 6]
    records = E2E.make_reads(kmap, n=300, read_len=90)
    contigs = []
    keys = list(kmap)
    for i in range(5):
        parts = []
        for _ in range(10):
            parts.append(E2E.rand_dna(int(E2E.rng.integers(50, 300))))
            parts.append(E2E.codec.key_to_string(keys[int(E2E.rng.integers(len(keys)))]))
            if i == 2:
                parts.append("N" * 40)
        contigs.append((f"c{i}", "".join(parts), None))
    rec_t = ProbeRecords(**{f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)})
    return dict(kmap=kmap, parent=parent, records=records, contigs=contigs,
                packed=pack_probes(rec_t, num_targ=8), tax=Taxonomy(np.array(parent, np.int32)),
                jpk=jax_pack_probes(rec, num_targ=8),
                jtax=JaxTaxonomy(np.array(parent, np.int32)))


@pytest.mark.parametrize("batch_size,max_len", [(16, 96), (64, 64)])
def test_classifier_matches_jax_and_refsim(e2e, batch_size, max_len):
    """Finals batch by batch (detail included) and the long reads' finals,
    seen and ucount, against the JAX Classifier; the sample's counts
    against RefSim through each package's SampleProcessor."""
    clf = Classifier(e2e["packed"], e2e["tax"], batch_size=batch_size, max_len=max_len,
                     device="cpu")
    jclf = JC.Classifier(e2e["jpk"], e2e["jtax"], batch_size=batch_size, max_len=max_len)
    rb, jrb = ReadBatcher(batch_size, max_len), JaxReadBatcher(batch_size, max_len)
    items = [it for rec in e2e["records"] + e2e["contigs"] for it in rb.add(*rec)]
    items += list(rb.flush())
    jitems = [it for rec in e2e["records"] + e2e["contigs"] for it in jrb.add(*rec)]
    jitems += list(jrb.flush())
    assert len(items) == len(jitems) and any(isinstance(i, LongRead) for i in items)
    seen, jseen = clf.new_seen(), jclf.new_seen()
    for it, jit in zip(items, jitems):
        if isinstance(it, LongRead):
            seen, f = clf.process_long(seen, it)
            jseen, jf = jclf.process_long(jseen, JaxLongRead(meta=jit.meta, codes=jit.codes))
            assert f == jf
            continue
        seen, finals = clf.process_batch(seen, it)
        jseen, jfinals = jclf.process_batch(jseen, jit)
        np.testing.assert_array_equal(finals, np.asarray(jfinals))
        seen, d, k = clf.detail_batch(seen, it)
        jseen, jd, jk = jclf.detail_batch(jseen, jit)  # seen unchanged: no marks
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    np.testing.assert_array_equal(clf.ucount(seen), jclf.ucount(jseen))

    cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=batch_size, max_len=max_len)
    sp = P.SampleProcessor(clf, cfg, use_native=False)
    sp.feed(e2e["records"] + e2e["contigs"])
    res = sp.finish()
    sim = RefSim(e2e["kmap"], e2e["parent"], num_targ=8, u_is_t=False)
    sim.feed(e2e["records"] + e2e["contigs"])
    assert res.reads == sim.reads
    assert res.gcount.tolist() == sim.gcount and res.ucount.tolist() == sim.ucount
    jsp = JaxSampleProcessor(jclf, JaxClassifyConfig.preset("nx", num_targ=8,
                                                            batch_size=batch_size,
                                                            max_len=max_len))
    jsp.feed(e2e["records"] + e2e["contigs"])
    jres = jsp.finish()
    assert res.ucount.tolist() == jres.ucount.tolist() and sum(sim.ucount) > 0


def test_process_long_groups_and_batch_sizes(world):
    """A read of more chunk rows than a group (several groups) and one of
    exactly KSIZE + 1 bases past max_len, against the JAX engine."""
    src = np.random.default_rng(42).integers(0, 4, size=N_PROBES + codec.KSIZE, dtype=np.uint8)
    clf = Classifier(world["packed"], world["tax"], batch_size=8, max_len=W, device="cpu")
    jclf = JC.Classifier(world["jpk"], world["jtax"], batch_size=8, max_len=W)
    for codes in (src[:1500].copy(), src[100:100 + W + codec.KSIZE + 1].copy(),
                  np.concatenate([src[:300], np.full(200, 4, np.uint8), src[3000:3400]])):
        seen, f = clf.process_long(clf.new_seen(), LongRead(meta=None, codes=codes))
        jseen, jf = jclf.process_long(jclf.new_seen(), JaxLongRead(meta=None, codes=codes))
        assert f == jf and f > 0
        np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))


def test_collect_many_and_long_many_equal_one_at_a_time(world):
    """The legacy engine's ``collect_many`` over three pending batches and
    its ``process_long_many`` over three long reads: the finals and ``seen``
    marks of ``collect`` batch by batch and of the one-read lane read by
    read."""
    codes, lengths = world["codes"], world["lengths"]
    clf = Classifier(world["packed"], world["tax"], batch_size=B, max_len=W, device="cpu")
    batches = [Batch(codes=np.roll(codes, s, axis=0), lengths=np.roll(lengths, s), metas=None,
                     n_rows=B - 5 * s) for s in range(3)]
    pendings = []
    seen = clf.new_seen()
    for b in batches:
        seen, p = clf.submit_batch(seen, b)
        pendings.append(p)
    seen_many, many = clf.collect_many(seen.clone(), pendings)
    seen_one, one = seen.clone(), []
    for p in pendings:
        seen_one, f = clf.collect(seen_one, p)
        one.append(f)
    assert [f.tolist() for f in many] == [f.tolist() for f in one]
    assert [len(f) for f in many] == [B, B - 5, B - 10]
    assert torch.equal(seen_many, seen_one)

    src = np.random.default_rng(42).integers(0, 4, size=N_PROBES + codec.KSIZE, dtype=np.uint8)
    items = [LongRead(meta=None, codes=c) for c in (src[:700].copy(), src[2000:2200].copy(),
                                                    src[10:10 + codec.KSIZE - 1].copy())]
    seen_many, many = clf.process_long_many(clf.new_seen(), items)
    seen_one, one = clf.new_seen(), []
    for it in items:
        seen_one, f = clf._long_one(seen_one, it)
        one.append(f)
    assert many == one and many[0] > 0 and many[2] == 0
    assert torch.equal(seen_many, seen_one) and int(seen_many[:-1].sum()) > 0


# ------------------------------------------------------------ routing


def test_make_classifier_routes_as_jax(world, monkeypatch):
    db = P.LoadedDB(world["packed"], world["tax"], None, 40, len(world["packed"]))
    base = dict(num_targ=40, batch_size=16, max_len=W)
    assert isinstance(P.make_classifier(db, ClassifyConfig.preset("nx", **base), device="cpu"),
                      FpClassifier)
    for over in (dict(engine="legacy"), dict(minalign=3)):
        clf = P.make_classifier(db, ClassifyConfig.preset("nx", **base, **over), device="cpu")
        assert isinstance(clf, Classifier), over

    def refuse(*a, **k):
        raise ValueError("refused")

    monkeypatch.setattr(P, "FpClassifier", refuse)
    clf = P.make_classifier(db, ClassifyConfig.preset("nx", **base), device="cpu")
    assert isinstance(clf, Classifier)
    empty = ProbeRecords(keys=np.zeros(0, np.uint64), target=np.zeros(0, np.int32),
                         org=np.zeros(0, np.int32), position=np.zeros(0, np.int32),
                         fstrand=np.zeros(0, bool), count=np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="empty"):
        P.make_classifier(P.LoadedDB(pack_probes(empty, 40), world["tax"], None, 40, 0),
                          ClassifyConfig.preset("nx", **base, engine="legacy"), device="cpu")


def test_cuda_device_refused_without_cuda(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Classifier(world["packed"], world["tax"])


def test_batch_with_only_packed_words(world):
    """A batch that ships packed words without a code plane takes its width
    from max_len, as the fingerprint engine's batches do."""
    codes, lengths = world["codes"], world["lengths"]
    packed, exc = pack_codes(codes, lengths)
    clf = Classifier(world["packed"], world["tax"], batch_size=B, max_len=W, device="cpu")
    full = Batch(codes=codes, lengths=lengths, metas=[None] * B, n_rows=B, packed=packed, exc=exc)
    bare = dataclasses.replace(full, codes=None)
    _, a = clf.process_batch(clf.new_seen(), full)
    _, b = clf.process_batch(clf.new_seen(), bare)
    np.testing.assert_array_equal(a, b)
