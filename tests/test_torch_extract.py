"""kmer_id_tpu_torch.ops.extract against the JAX twins: unpack_codes
(kmer_id_tpu/engine/fpclassify.py) and extract_kmers (kmer_id_tpu/ops/
extract.py), on planes with invalid bases and ragged lengths.  Exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kmer_id_tpu.core.codec import INVALID
from kmer_id_tpu.engine.fpclassify import unpack_codes as jax_unpack
from kmer_id_tpu.ops.extract import extract_kmers as jax_extract
from kmer_id_tpu_torch.io.batch import pack_codes
from kmer_id_tpu_torch.ops.extract import extract_kmers, unpack_codes


def _plane(seed, b, l, n_bad):
    r = np.random.default_rng(seed)
    codes = r.integers(0, 4, size=(b, l)).astype(np.uint8)
    lengths = r.integers(0, l + 1, size=b).astype(np.int32)
    lengths[:2] = l  # full rows
    rows, cols = r.integers(0, b, size=n_bad), r.integers(0, l, size=n_bad)
    codes[rows, cols] = r.choice(np.array([INVALID, 5, 255], np.uint8), size=n_bad)
    return codes, lengths


@pytest.mark.parametrize("b,l,n_bad", [(17, 103, 40), (64, 160, 0), (8, 32, 12)])
def test_unpack_codes_matches_jax(b, l, n_bad):
    codes, lengths = _plane(b * l, b, l, n_bad)
    packed, exc = pack_codes(codes, lengths)
    want = np.asarray(jax_unpack(jnp.asarray(packed), jnp.asarray(exc), l))
    got = unpack_codes(torch.from_numpy(packed.view(np.int32)), torch.from_numpy(exc), l)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # in-length positions reproduce the plane, invalid bases as code 4
    inlen = np.arange(l)[None, :] < lengths[:, None]
    np.testing.assert_array_equal(got.numpy()[inlen], np.minimum(codes, 4)[inlen])


@pytest.mark.parametrize("b,l,n_bad", [(17, 103, 40), (64, 160, 0), (5, 30, 3)])
def test_extract_kmers_matches_jax(b, l, n_bad):
    codes, lengths = _plane(7 + b, b, l, n_bad)
    want = jax_extract(jnp.asarray(codes), jnp.asarray(lengths))
    got = extract_kmers(torch.from_numpy(codes), torch.from_numpy(lengths))
    for k in ("hi", "lo"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32), np.asarray(want[k]))
    for k in ("valid", "fstrand"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["valid"].any() or n_bad or b * l < 60


def test_pack_roundtrip_extracts_like_the_plane():
    """unpack(pack(codes)) -> extract equals extract on the plane itself."""
    codes, lengths = _plane(3, 32, 150, 25)
    packed, exc = pack_codes(codes, lengths)
    a = extract_kmers(
        unpack_codes(torch.from_numpy(packed.view(np.int32)), torch.from_numpy(exc), 150),
        torch.from_numpy(lengths),
    )
    b = extract_kmers(torch.from_numpy(codes), torch.from_numpy(lengths))
    v = a["valid"]
    assert torch.equal(v, b["valid"]) and v.any()
    for k in ("hi", "lo", "fstrand"):
        assert torch.equal(a[k][v], b[k][v]), k


def test_extract_rejects_short_plane():
    with pytest.raises(ValueError):
        extract_kmers(torch.zeros((2, 29), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32))
