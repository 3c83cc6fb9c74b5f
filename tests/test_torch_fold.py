"""kmer_id_tpu_torch.ops.fold.fold_targets_chain and engine.host against the
JAX package (kmer_id_tpu/ops/fold.py, kmer_id_tpu/engine/classify.py), on
rows of mostly incomparable hits.  Exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kmer_id_tpu.core.taxonomy import Taxonomy as JaxTaxonomy
from kmer_id_tpu.engine.classify import fold_host as jax_fold_host
from kmer_id_tpu.engine.classify import fold_host_many as jax_fold_host_many
from kmer_id_tpu.ops.fold import fold_targets_chain as jax_fold
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.engine.host import fold_host, fold_host_many
from kmer_id_tpu_torch.ops.fold import fold_targets_chain
from tests.oracles import fold_ref


def _world(seed, n_nodes=200, b=64, p=32):
    r = np.random.default_rng(seed)
    parent = np.ones(n_nodes, np.int32)
    for i in range(3, n_nodes):
        parent[i] = int(r.integers(1, i))
    tax = Taxonomy(parent)
    t = r.integers(2, n_nodes, size=(b, p)).astype(np.int32)
    t[r.random((b, p)) < 0.4] = 0  # holes
    t[: b // 4, p // 2 :] = 0  # short rows: the trip count ends early
    t[b - 2] = 0  # a row with no hit
    return parent, tax, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_targets_chain_matches_jax(seed):
    parent, tax, t = _world(seed)
    chain3 = tax.chain_tables()[0]
    ttin = tax.tin[t].astype(np.int32)
    tout = tax.tout[t].astype(np.int32)
    want = np.asarray(jax_fold(jnp.asarray(chain3), jnp.asarray(t),
                               jnp.asarray(ttin), jnp.asarray(tout)))
    got = fold_targets_chain(torch.from_numpy(chain3), torch.from_numpy(t),
                             torch.from_numpy(ttin), torch.from_numpy(tout))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for row in range(4):  # and the scalar reference fold
        assert int(got[row]) == fold_ref(parent.tolist(), t[row][t[row] > 0].tolist())


def test_fold_of_empty_plane_is_zero():
    tax = _world(0)[1]
    chain3 = torch.from_numpy(tax.chain_tables()[0])
    z = torch.zeros((3, 5), dtype=torch.int32)
    assert fold_targets_chain(chain3, z, z, z).tolist() == [0, 0, 0]


def test_host_folds_match_jax():
    parent, tax, t = _world(4)
    jtax = JaxTaxonomy(parent)
    seqs = [row[row > 0] for row in t]
    np.testing.assert_array_equal(fold_host_many(tax, seqs), jax_fold_host_many(jtax, seqs))
    assert [fold_host(tax, row) for row in t] == [jax_fold_host(jtax, row) for row in t]
