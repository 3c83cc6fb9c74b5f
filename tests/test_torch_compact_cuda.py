"""The rank-compaction CUDA kernel (kmer_id_tpu_torch/csrc/compact.cu)
against its plain PyTorch version, on the card.

The kernel runs only on a CUDA device, so every test here is marked
``cuda`` and skips elsewhere.  This file imports no jax, so it also runs on
a machine that has only PyTorch (skip tests/conftest.py, which imports
jax): ``pytest --noconftest -m cuda tests/test_torch_compact_cuda.py``.
Shapes are classify-nx's (batch 8192, max_len 160: Bloom gate, both verify
tiers, dense path), the long-read lane's (2048 chunk rows of max_len 512:
Bloom gate, verify tier, dense path, all at the lane's budgets), the legacy
engine's hit lists (every window of an nx batch or of a jobs/m3 short batch
to 32) and a budget wider than a warp; values are integers, equality exact.
Then every chip_smoke KERNEL_SHAPES row in each payload form a caller
passes (a [1, C] broadcast row; [1 or B, C / 3] planes read at column // 3)
at every density, and the valid plane as a view 0-15 bytes past 16-byte
alignment that ends at its allocation's last byte, at row counts of 1, 7
and 8193 (not a multiple of any group's rows per block) and widths from 36
to 2100 (two passes of a 4-warp CTA).
"""

import numpy as np
import pytest
import torch

from chip_smoke import DENSITIES, KERNEL_SHAPES, kernel_inputs, misaligned_rows
from kmer_id_tpu_torch.ops.compact import (
    compact_ranks,
    compact_ranks_cuda,
    compact_ranks_plain,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _assert_same(got, want, what):
    for g, w, name in zip(got[:3] + got[3], want[:3] + want[3],
                          ("pos", "cand", "ncand", "extra0", "extra1")):
        assert torch.equal(g, w), f"{name} at {what}"



@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.003, 0.03, 1.0])
@pytest.mark.parametrize("b,c,max_hits", [(8192, 131, 12), (8192, 36, 8),
                                          (8192, 36, 32), (8192, 393, 32),
                                          (2048, 483, 12), (2048, 36, 8), (2048, 1449, 8),
                                          (8192, 131, 32), (2048, 483, 32), (5, 70, 40)])
def test_kernel_matches_plain_on_card(b, c, max_hits, density):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    r = np.random.default_rng(b + c + max_hits)
    dev = torch.device("cuda")
    cand = torch.from_numpy(r.integers(-(2**31), 2**31, size=(b, c)).astype(np.int32)).to(dev)
    valid = torch.from_numpy(r.random((b, c)) < density).to(dev)
    pos = (torch.arange(c, dtype=torch.int32, device=dev) // 3)[None]
    ex = tuple(torch.from_numpy(r.integers(0, 2**32, size=(b, c), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev) for _ in range(2))
    for n_extra in (0, 1, 2):
        before = compact_ranks_cuda.launches.value
        got = compact_ranks(cand, valid, pos, max_hits, extras=ex[:n_extra])
        assert compact_ranks_cuda.launches.value == before + 1
        want = compact_ranks_plain(cand, valid, pos, max_hits, extras=ex[:n_extra])
        torch.cuda.synchronize()
        for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
            assert torch.equal(g, w)


FORMS = [(shape, form) for shape in KERNEL_SHAPES for form in ("column", "window", "random")
         if form == "column" or shape[2] % 3 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,form", FORMS, ids=[f"{s[0]}-{f}" for s, f in FORMS])
def test_payload_forms_on_card(shape, form):
    dev = _card()
    name, b, c, mh, _, _ = shape
    r = np.random.default_rng(c + mh)
    for density in DENSITIES:
        cand, valid, pos, ex, div = kernel_inputs(r, b, c, density, form, dev)
        for n_extra in (0, 1, 2):
            before = compact_ranks_cuda.launches.value
            got = compact_ranks(cand, valid, pos, mh, extras=ex[:n_extra], r=div)
            assert compact_ranks_cuda.launches.value == before + 1
            want = compact_ranks_plain(cand, valid, pos, mh, extras=ex[:n_extra], r=div)
            torch.cuda.synchronize()
            _assert_same(got, want, f"{name} {form} density {density} extras {n_extra}")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 8193])
@pytest.mark.parametrize("c", [36, 131, 393, 1449, 2100])
def test_misaligned_valid_on_card(c, rows):
    dev = _card()
    r = np.random.default_rng(c * rows)
    form = "random" if c % 3 == 0 else "column"
    cand, valid, pos, ex, div = kernel_inputs(r, rows, c, 0.05, form, dev)
    valid[:, :: max(1, c // 5)] = True  # every row reaches several chunks
    for off in range(16):
        vv = misaligned_rows(valid, rows, off)
        assert vv.data_ptr() % 16 == off
        got = compact_ranks_cuda(cand, vv, pos, 32, extras=ex, r=div)
        want = compact_ranks_plain(cand, valid, pos, 32, extras=ex, r=div)
        torch.cuda.synchronize()
        _assert_same(got, want, f"[{rows}x{c}] offset {off}")
