"""kmer_id_tpu_torch.ops.compact: the plain rank compaction against the JAX
package's Pallas kernel (interpret mode) and its sort formulation.  The
CUDA kernel's own test is tests/test_torch_compact_cuda.py.

Budgets 8, 12 and 32 are the engine's (fast tier, Bloom gate, slow tier and
dense path); densities run from empty to full; positions are broadcast from
one row as on the main path; two extra payload planes carry words with the
high bit set.  All values are integers: equality is exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kmer_id_tpu.ops.compact import compact_ranks as jax_compact_ranks
from kmer_id_tpu.ops.compact import compact_ranks_pallas, compact_sort
from kmer_id_tpu.ops.compact import interleave_planes as jax_interleave
from kmer_id_tpu_torch.ops.compact import (
    SENT,
    compact_ranks,
    compact_ranks_cuda,
    compact_ranks_plain,
    interleave_planes,
)


def _fixture(seed, b, p, density, k=3):
    r = np.random.default_rng(seed)
    cand = [r.integers(0, 2**31 - 1, size=(b, p), dtype=np.int32) for _ in range(k)]
    valid = [r.random((b, p)) < density for _ in range(k)]
    ex = [r.integers(0, 2**32, size=(b, p * k), dtype=np.uint64).astype(np.uint32)
          for _ in range(2)]
    return cand, valid, ex


def _torch_args(cand, valid, ex):
    ci, vi = interleave_planes([(torch.from_numpy(c), torch.from_numpy(v))
                                for c, v in zip(cand, valid)])
    k = len(cand)
    pos = (torch.arange(ci.shape[1], dtype=torch.int32) // k)[None]
    return ci, vi, pos, tuple(torch.from_numpy(e.view(np.int32)) for e in ex)


def _jax_args(cand, valid, ex):
    ci, vi = jax_interleave([(jnp.asarray(c), jnp.asarray(v)) for c, v in zip(cand, valid)])
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, ci.shape[1]), 1) // len(cand)
    return ci, vi, pos, tuple(jnp.asarray(e) for e in ex)


def _assert_equal(got, want):
    names = ("pos", "cand", "ncand", "extra0", "extra1")
    for g, w, name in zip(got[:3] + got[3], want[:3] + want[3], names):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
@pytest.mark.parametrize("max_hits", [8, 12, 32])
def test_plain_matches_pallas_and_sort(density, max_hits):
    cand, valid, ex = _fixture(42, 48, 37, density)
    tci, tvi, tpos, tex = _torch_args(cand, valid, ex)
    jci, jvi, jpos, jex = _jax_args(cand, valid, ex)
    got = compact_ranks_plain(tci, tvi, tpos, max_hits, extras=tex)
    for g in got[:3] + got[3]:
        assert g.dtype == torch.int32 and g.is_contiguous()
    _assert_equal(got, compact_ranks_pallas(jci, jvi, jpos, max_hits, interpret=True,
                                            extras=jex))
    _assert_equal(got, compact_sort(jci, jvi, jpos, max_hits, extras=jex))


def test_interleave_matches_jax():
    cand, valid, ex = _fixture(3, 4, 11, 0.5)
    tci, tvi, *_ = _torch_args(cand, valid, ex)
    jci, jvi, *_ = _jax_args(cand, valid, ex)
    np.testing.assert_array_equal(tci.numpy(), np.asarray(jci))
    np.testing.assert_array_equal(tvi.numpy(), np.asarray(jvi))


def test_window_order_with_cross_plane_ties():
    """A window with candidates in several planes keeps plane order."""
    b, p, k = 1, 5, 3
    cand = np.zeros((b, p, k), np.int32)
    valid = np.zeros((b, p, k), bool)
    cand[0, 1, 0], cand[0, 1, 2], cand[0, 3, 1] = 10, 12, 31
    valid[0, 1, 0] = valid[0, 1, 2] = valid[0, 3, 1] = True
    planes = [(torch.from_numpy(cand[:, :, i].copy()), torch.from_numpy(valid[:, :, i].copy()))
              for i in range(k)]
    ci, vi = interleave_planes(planes)
    pos = (torch.arange(p * k, dtype=torch.int32) // k)[None]
    pos32, cand32, ncand, _ = compact_ranks(ci, vi, pos, 4)
    assert cand32[0, :3].tolist() == [10, 12, 31]
    assert pos32[0].tolist() == [1, 1, 3, SENT]
    assert int(ncand[0]) == 3


def test_budget_wider_than_plane():
    """max_hits past the column count pads (the Bloom gate on short rows),
    as the JAX engine's jnp formulation does."""
    cand, valid, ex = _fixture(5, 6, 3, 1.0, k=1)
    tci, tvi, tpos, tex = _torch_args(cand, valid, ex)
    jci, jvi, jpos, jex = _jax_args(cand, valid, ex)
    got = compact_ranks_plain(tci, tvi, tpos, 12, extras=tex)
    _assert_equal(got, jax_compact_ranks(jci, jvi, jpos, 12, extras=jex))
    assert got[0][:, 3:].eq(SENT).all()


def test_cpu_tensors_take_the_plain_version():
    cand, valid, ex = _fixture(8, 16, 20, 0.1)
    args = _torch_args(cand, valid, ex)
    before = compact_ranks_cuda.launches.value
    got = compact_ranks(*args[:3], 8, extras=args[3])
    want = compact_ranks_plain(*args[:3], 8, extras=args[3])
    assert compact_ranks_cuda.launches.value == before
    for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
        assert torch.equal(g, w)


def test_cuda_wrapper_refuses_cpu_tensors():
    cand, valid, ex = _fixture(9, 4, 10, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        compact_ranks_cuda(*_torch_args(cand, valid, ex)[:3], 8)
