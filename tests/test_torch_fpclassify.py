"""The PyTorch engine (kmer_id_tpu_torch.engine.fpclassify) on the CPU against
the JAX FpClassifier on CPU JAX, on shared fingerprint tables.

Finals, the unique-k-mer ``seen`` set and ``ucount`` must be equal exactly
(all integers).  The batches cover the Bloom path in both verify tiers, the
dense path (a read over BLOOM_K passing windows), the candidate-overflow
replay (reads over max_hits candidates), the msca fold, both batch forms
(packed words and the plain code plane) and a DB without a Bloom filter.
Each engine gets its own package's host objects (DB, taxonomy, batches),
made from the same seed.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from __graft_entry__ import _toy_world
from chip_smoke import toy_world
from kmer_id_tpu.db.fpdb import build_fpdb as jax_build_fpdb
from kmer_id_tpu.engine.fpclassify import FpClassifier as JaxFpClassifier
from kmer_id_tpu.io.batch import Batch as JaxBatch
from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.db.fpdb import build_fpdb
from kmer_id_tpu_torch.engine import fpclassify as F
from kmer_id_tpu_torch.engine.fpclassify import (
    FpClassifier,
    device_tables,
    tables_from_jax,
)
from kmer_id_tpu_torch.io.batch import Batch, pack_codes
from kmer_id_tpu_torch.ops.gate import window_gate

B, L = 96, 160


@pytest.fixture(scope="module")
def world():
    """(port DB, port taxonomy, codes, lengths, port fpdb, (JAX DB, JAX
    taxonomy, JAX fpdb)): the same toy world from each package."""
    kw = dict(num_probes=20_000, num_targ=64, batch=B, max_len=L, dense_rows=(5, 90))
    jpk, jtax, jcodes, jlengths, _ = _toy_world(**kw)
    packed, tax, codes, lengths, _ = toy_world(**kw)
    assert np.array_equal(codes, jcodes) and np.array_equal(lengths, jlengths)
    return (packed, tax, codes, lengths, build_fpdb(packed, tax),
            (jpk, jtax, jax_build_fpdb(jpk, jtax)))


def _src_genome():
    """The genome _toy_world draws its probes from (same seed and draw)."""
    rng = np.random.default_rng(42)
    return rng.integers(0, 4, size=20_000 + codec.KSIZE, dtype=np.uint8)


def _batches(world):
    """name -> (codes, lengths) planes exercising each engine path."""
    _, _, codes, lengths, *_ = world
    src = _src_genome()
    out = {"dense": (codes, lengths)}  # dense rows: > BLOOM_K and > 32 candidates
    plain = codes.copy()
    plain[[5, 90]] = np.random.default_rng(1).integers(0, 4, size=(2, L), dtype=np.uint8)
    out["fast"] = (plain, lengths)
    mid = plain.copy()
    lmid = lengths.copy()
    for r, s in ((7, 100), (40, 3000)):  # 10 consecutive probe windows each
        mid[r, 20:59] = src[s : s + 39]
        lmid[r] = L
    out["slow_tier"] = (mid, lmid)
    return out


def _batch(codes, lengths, packed_form: bool) -> Batch:
    packed, exc = pack_codes(codes, lengths) if packed_form else (None, None)
    return Batch(codes=codes, lengths=lengths, metas=[None] * len(codes),
                 n_rows=len(codes), packed=packed, exc=exc)


def _run_both(world, name, packed_form, max_hits=32, bloom=True):
    pk, tax, *_, fpdb, (jpk, jtax, jfpdb) = world
    if not bloom:
        fpdb, jfpdb = (dataclasses.replace(f, bloom=None) for f in (fpdb, jfpdb))
    codes, lengths = _batches(world)[name]
    batch = _batch(codes, lengths, packed_form)
    jbatch = JaxBatch(**dataclasses.asdict(batch))
    jclf = JaxFpClassifier(jpk, jtax, batch_size=B, max_len=L, max_hits=max_hits, fpdb=jfpdb)
    tclf = FpClassifier(pk, tax, batch_size=B, max_len=L, max_hits=max_hits,
                        fpdb=fpdb, device="cpu")
    jseen, jfin = jclf.process_batch(jclf.new_seen(), jbatch)
    tseen, tfin = tclf.process_batch(tclf.new_seen(), batch)
    return (np.asarray(jfin), np.asarray(jseen), jclf.ucount(jseen),
            tfin, tseen, tclf)


@pytest.mark.parametrize("packed_form", [True, False])
@pytest.mark.parametrize("name", ["fast", "slow_tier", "dense"])
def test_engine_matches_jax(world, name, packed_form):
    jfin, jseen, juc, tfin, tseen, tclf = _run_both(world, name, packed_form)
    n = tclf.fpdb.n_slots
    np.testing.assert_array_equal(tfin, jfin)
    np.testing.assert_array_equal(tseen[:n].numpy(), jseen)
    np.testing.assert_array_equal(tclf.ucount(tseen), juc)
    assert juc.sum() > 0


def test_paths_are_exercised(world):
    """Each fixture batch takes the branch it is named for."""
    pk, tax, *_ = world
    clf = FpClassifier(pk, tax, batch_size=B, max_len=L, fpdb=world[4], device="cpu")
    stats = {}
    for name, (codes, lengths) in _batches(world).items():
        reads = clf._reads(_batch(codes, lengths, True))
        npass = window_gate(clf._db, reads)[3]
        cv = F._compact_verify(clf._db, reads, 32)
        stats[name] = (int(npass.max()), bool(cv["overflow"].any()),
                       bool((~cv["consistent"]).any()))
    assert stats["fast"][0] <= F.BLOOM_K and not stats["fast"][1]
    assert F.BLOOM_K >= stats["slow_tier"][0] >= 10
    assert stats["dense"][0] > F.BLOOM_K and stats["dense"][1]
    assert stats["fast"][2]  # incomparable planted probes: the fold runs


@pytest.mark.parametrize("name", ["slow_tier", "dense"])
def test_engine_without_bloom_matches_jax(world, name):
    jfin, jseen, juc, tfin, tseen, tclf = _run_both(world, name, True, bloom=False)
    assert "bloom" not in tclf._db
    np.testing.assert_array_equal(tfin, jfin)
    np.testing.assert_array_equal(tseen[: tclf.fpdb.n_slots].numpy(), jseen)
    np.testing.assert_array_equal(tclf.ucount(tseen), juc)


def test_engine_fast_budget_only_matches_jax(world):
    """max_hits == FAST_HITS: one tier, overflow past 8 candidates."""
    jfin, jseen, juc, tfin, tseen, tclf = _run_both(world, "slow_tier", True, max_hits=8)
    np.testing.assert_array_equal(tfin, jfin)
    np.testing.assert_array_equal(tseen[: tclf.fpdb.n_slots].numpy(), jseen)
    np.testing.assert_array_equal(tclf.ucount(tseen), juc)


def test_tables_from_jax_equal_device_tables(world):
    pk, tax, *_, fpdb, (jpk, jtax, jfpdb) = world
    jclf = JaxFpClassifier(jpk, jtax, batch_size=B, max_len=L, fpdb=jfpdb)
    jdb = {k: np.asarray(v) for k, v in jax.device_get(jclf._db).items()}
    got = tables_from_jax(jdb, device="cpu")
    want = device_tables(fpdb, tax, "cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    # the port's word tables hold the JAX engine's bytes
    assert want["rec"].numpy().tobytes() == jdb["rec"].tobytes()


def test_cuda_device_without_cuda_raises(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pk, tax, _, _, fpdb, _ = world
    with pytest.raises(RuntimeError, match="cuda"):
        FpClassifier(pk, tax, batch_size=B, max_len=L, fpdb=fpdb, device="cuda")
