"""kmer_id_tpu_torch.ops.compact: the plain rank compaction against the JAX
package's Pallas kernel (interpret mode) and its sort formulation, with the
payload planes in every form the port's callers pass (a [1, C] broadcast
row, [B or 1, C / 3] planes repeated along the row); a numpy model of the
CUDA kernel's own arithmetic (csrc/compact.cu: aligned 16-byte chunks of
the valid plane from any base offset, the row-edge masks, the group/CTA
scan, payloads read only for ranks under the budget, at column / divisor
by a multiply-high) against the plain version; and the wrapper's
refusals.  The CUDA kernel's own test is
tests/test_torch_compact_cuda.py.

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
    kernel_group,
    payload_layout,
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


# ------------------------------------------------ payload forms vs Pallas

WIDTHS = (131, 393, 483, 1449)  # legacy nx; dense nx; legacy jobs/m3; dense lane
# jitted so that the densities and forms of one (width, budget) share a trace
_pallas = jax.jit(compact_ranks_pallas, static_argnames=("max_hits", "interpret"))


def _payload_forms(r, b, c):
    """{form: (pos, extras, divisor)} as numpy int32 at width ``c``: the
    column row broadcast with full-width extras (the legacy hit list, the
    Bloom gate), and where ``c`` holds whole windows, the window row and
    per-row positions beside key words of width c / 3, repeated 3 times."""
    def words(w):
        return tuple(r.integers(0, 2**32, size=(b, w), dtype=np.uint64).astype(np.uint32)
                     .view(np.int32) for _ in range(2))

    forms = {"broadcast": (np.arange(c, dtype=np.int32)[None], words(c), 1)}
    if c % 3 == 0:
        w = c // 3
        forms["window_row"] = (np.arange(w, dtype=np.int32)[None], words(w), 3)
        forms["per_row"] = (r.integers(0, 2**31 - 1, size=(b, w), dtype=np.int32), words(w), 3)
    return forms


def _materialised(x, b, c, div):
    return np.ascontiguousarray(np.broadcast_to(np.repeat(x, div, axis=1), (b, c)))


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
@pytest.mark.parametrize("max_hits", [8, 12, 32])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_payload_forms_match_pallas(c, max_hits, density):
    b = 3
    r = np.random.default_rng(c * 100 + max_hits)
    cand = r.integers(-(2**31), 2**31 - 1, size=(b, c), dtype=np.int32)
    valid = r.random((b, c)) < density
    for form, (pos, ex, div) in _payload_forms(r, b, c).items():
        got = compact_ranks_plain(torch.from_numpy(cand), torch.from_numpy(valid),
                                  torch.from_numpy(pos), max_hits,
                                  extras=tuple(map(torch.from_numpy, ex)), r=div)
        want = _pallas(
            jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(_materialised(pos, b, c, div)),
            max_hits=max_hits, interpret=True,
            extras=tuple(jnp.asarray(_materialised(e, b, c, div)) for e in ex))
        try:
            _assert_equal(got, want)
        except AssertionError as e:
            raise AssertionError(f"payload form {form}") from e


# ------------------------------------------ numpy model of compact.cu

JUNK = 0xA5  # bytes around the plane: nonzero, so a byte read outside a row would count


def _chunk_mask(chunk):
    """compact.cu ``nonzero_bytes``: __vcmpne4 of each little-endian word
    against 0 (0xFF per nonzero byte), each byte's top bit gathered."""
    m = 0
    for k, word in enumerate(chunk.view("<u4").tolist()):
        v = sum(0xFF << (8 * i) for i in range(4) if (word >> (8 * i)) & 0xFF)
        m |= (((v >> 7) & 1) | ((v >> 14) & 2) | ((v >> 21) & 4) | ((v >> 28) & 8)) << (4 * k)
    return m


def _group_scan(cnt, group):
    """compact.cu's scan: __shfl_up_sync steps within a width of
    min(group, 32) lanes (a lane below the step keeps its value), then for a
    CTA group each warp's total through shared memory.  Returns (exclusive
    rank per lane, group total)."""
    width = min(group, 32)
    x = list(cnt)
    d = 1
    while d < width:
        x = [x[l] + (x[l - d] if l % width >= d else 0) for l in range(group)]
        d <<= 1
    if group <= 32:
        return [x[l] - cnt[l] for l in range(group)], x[group - 1]
    warp_total = [x[w * 32 + 31] for w in range(group // 32)]
    before = [sum(warp_total[: l // 32]) for l in range(group)]
    return [before[l] + x[l] - cnt[l] for l in range(group)], sum(warp_total)


def _model_compact(buf, off, b, c, cand, payloads, mh):
    """compact.cu on a valid plane laid at byte ``off`` of ``buf`` (offset 0
    is 16-byte aligned), with ``payloads`` [(flat int32, row stride,
    divisor)] for pos then the extras.  Returns the kernel's outputs and
    checks its reads: 16-byte loads only wholly inside the plane, bytes read
    one by one only inside the row, payloads only at ranks under ``mh``."""
    plane0, plane1 = off, off + b * c
    group, nch = kernel_group(c), (c + 14) // 16 + 1

    def load(a, n):
        assert plane0 <= a and a + n <= plane1, "a load leaves the valid plane"
        return buf[a : a + n]

    assert group in (8, 16, 32, 64, 96, 128) and (group >= nch or group == 128)
    outs = [np.full((b, mh), SENT, np.int32)] + [np.zeros((b, mh), np.int32)
                                                  for _ in payloads]
    n = np.zeros(b, np.int32)
    for row in range(b):
        rs = plane0 + row * c
        re = rs + c
        first = rs & ~15
        base = placed = 0
        for s0 in range(0, nch, group):
            masks = []
            for gl in range(group):
                c0 = first + 16 * (s0 + gl)
                m = 0
                if c0 < re:
                    if plane0 <= c0 and c0 + 16 <= plane1:
                        m = _chunk_mask(load(c0, 16))
                    else:
                        for i in range(16):
                            if rs <= c0 + i < re and load(c0 + i, 1)[0]:
                                m |= 1 << i
                    lo, hi = max(rs - c0, 0), min(re - c0, 16)
                    m &= ((1 << hi) - 1) & ~((1 << lo) - 1)
                masks.append((c0, m))
            excl, total = _group_scan([bin(m).count("1") for _, m in masks], group)
            for gl, (c0, m) in enumerate(masks):
                rank = base + excl[gl]
                while m and rank < mh:
                    i = (m & -m).bit_length() - 1
                    m &= m - 1
                    col = c0 + i - rs
                    assert 0 <= col < c
                    outs[1][row, rank] = cand[row, col]
                    for k, (flat, stride, div) in enumerate(payloads):
                        # col / div as compact.cu's multiply-high by 2^32 / div + 1
                        q = col if div == 1 else (col * ((1 << 32) // div + 1)) >> 32
                        outs[0 if k == 0 else k + 1][row, rank] = flat[row * stride + q]
                    rank += 1
                    placed += 1
            base += total
        assert placed == min(base, mh)
        n[row] = base
    pos_out, cand_out, *ex_out = outs
    return pos_out, cand_out, n, tuple(ex_out)


@pytest.mark.parametrize("max_hits", [8, 32])
@pytest.mark.parametrize("c", [7, 36, 131, 393, 483, 1449, 2100])
def test_kernel_model_matches_plain(c, max_hits):
    """Every base offset 0-15 of the valid plane, rows from empty to full
    (row densities 0, 0.02, 0.3, 1 and 0.5), the payload forms of the
    callers at this width; 2100 columns take two passes of a 4-warp CTA."""
    b = 5
    r = np.random.default_rng(c + max_hits)
    cand = r.integers(-(2**31), 2**31 - 1, size=(b, c), dtype=np.int32)
    dens = np.array([0.0, 0.02, 0.3, 1.0, 0.5])[:, None]
    for off in range(16):
        valid = r.random((b, c)) < dens
        buf = np.full(off + b * c + 32, JUNK, np.uint8)
        buf[off : off + b * c] = valid.reshape(-1)
        tvalid = torch.from_numpy(buf[off : off + b * c].view(bool).reshape(b, c))
        for form, (pos, ex, div) in _payload_forms(r, b, c).items():
            planes = [torch.from_numpy(x) for x in (pos, *ex)]
            payloads = [(p.reshape(-1).numpy(), *payload_layout("model", "p", p, b, c, div))
                        for p in planes]
            got = _model_compact(buf, off, b, c, cand, payloads, max_hits)
            want = compact_ranks_plain(torch.from_numpy(cand), tvalid, planes[0], max_hits,
                                       extras=tuple(planes[1:]), r=div)
            for g, w, name in zip(got[:3] + got[3], want[:3] + want[3],
                                  ("pos", "cand", "ncand", "extra0", "extra1")):
                np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{name} {form} off {off}")


def test_kernel_group_fits_the_width():
    """8 lanes to 113 columns, 16 to 241 (legacy nx's 131), a warp to 497, a
    CTA beyond: 3 warps at the dense lane's 1449 (about 6,000 warps at 2048
    rows), 4 from 1522 (one pass to 2017 columns)."""
    widths = (36, 113, 114, 131, 241, 242, 393, 483, 497, 498, 1449, 1521, 1522, 2017, 2018)
    assert [kernel_group(c) for c in widths] == [
        8, 8, 16, 16, 16, 32, 32, 32, 32, 64, 96, 96, 128, 128, 128]


def test_cuda_wrapper_refuses_bad_divisor_and_strides():
    """Refused before the device is looked at, so the CPU sees the reason;
    the plain version refuses the same forms."""
    b, c = 4, 12
    cand = torch.zeros((b, c), dtype=torch.int32)
    valid = torch.zeros((b, c), dtype=torch.bool)
    col = torch.arange(c, dtype=torch.int32)[None]
    win = torch.arange(c // 3, dtype=torch.int32)[None]
    wide = torch.zeros((b, 2 * c), dtype=torch.int32)
    bad = [
        (dict(pos=win, r=0), "divisor"),
        (dict(pos=win, r=-3), "divisor"),
        (dict(pos=win, r=2), "neither"),  # width 4 is not 12 / 2
        (dict(pos=col[:, :5], r=5), "neither"),  # 5 does not divide 12
        (dict(pos=wide[:, ::2]), "strides"),  # every other column
        (dict(pos=col, extras=(torch.zeros((c, b), dtype=torch.int32).t(),)), "strides"),
        (dict(pos=torch.zeros((2, c), dtype=torch.int32)), "shape"),  # rows neither 1 nor B
        (dict(pos=col[0]), "shape"),  # not 2-D
    ]
    for kw, msg in bad:
        pos, extras, r = kw["pos"], kw.get("extras", ()), kw.get("r", 1)
        for fn in (compact_ranks_cuda, compact_ranks_plain):
            with pytest.raises(ValueError, match=msg):
                fn(cand, valid, pos, 8, extras=extras, r=r)
    with pytest.raises(ValueError, match="CUDA"):  # every form right: the device is next
        compact_ranks_cuda(cand, valid, win, 8, extras=(wide[:, : c // 3],), r=3)
