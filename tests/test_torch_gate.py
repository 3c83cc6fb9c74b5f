"""The window gate (kmer_id_tpu_torch/ops/gate.py) on the CPU.

* ``window_gate_plain`` and ``extract_plain`` (its ``fstrand`` plane too)
  against the JAX chain they replace: ``unpack_codes``, ``extract_kmers``,
  ``bloom_pass`` and ``compact_ranks_pallas`` in interpret mode, bit for
  bit.
* A numpy model of the CUDA kernel's own arithmetic (csrc/gate.cu: each
  window read from the packed words by shift, the reverse complement as
  ``~W & (2^60 - 1)``, the forward key by reversing W's 2-bit groups,
  fstrand as forward < reverse complement, the bad-base bitmask, the uint32
  hash, ranks from a ballot per 32 windows)
  against the plain versions, so the kernel's formulas are checked here.
* The kernel itself against the plain versions, on the card only (marked
  ``cuda``; skips elsewhere).

Inputs are made with numpy from a seed: both input forms (packed words with
a shuffled exception list, and the code plane with invalid bytes 4, 5 and
255), N runs, invalid bases at both ends of a read, reads shorter than
KSIZE or as wide as the plane, probe-dense reads (more than 12 windows
passing the Bloom filter) and palindromic 30-mers (fstrand False where the
forward key is the canonical one).

The JAX package is imported only inside the test that uses it, so the card
test also runs where only PyTorch is installed (skip tests/conftest.py,
which imports jax): ``pytest --noconftest -m cuda tests/test_torch_gate.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import gate_forms, gate_rows
from kmer_id_tpu_torch.ops.compact import SENT
from kmer_id_tpu_torch.ops.gate import (
    BLOOM_K,
    ReadPlanes,
    _code_plane,
    extract,
    extract_cuda,
    extract_plain,
    window_gate,
    window_gate_cuda,
    window_gate_plain,
)
from kmer_id_tpu_torch.ops.words import u32_tensor

# (rows, row width, read lengths [lo, hi)): short reads in a narrow plane,
# chunk-like rows as wide as the plane, m3-like reads in a wide plane
SHAPES = [(200, 96, (60, 97)), (80, 160, (160, 161)), (64, 200, (40, 130))]
NBLK = 4096


def _world(seed, b, l, lens):
    """(numpy bloom, s4, s5, codes, lengths, {form: ReadPlanes on the CPU})."""
    r = np.random.default_rng(seed)
    bloom = (r.integers(0, 2**32, size=(NBLK, 4), dtype=np.uint64)
             & r.integers(0, 2**32, size=(NBLK, 4), dtype=np.uint64)).astype(np.uint32)
    s4, s5 = (int(x) for x in r.integers(1, 2**32, size=2))
    codes, lengths = gate_rows(r, b, l, lens, bloom, s4, s5)
    return bloom, s4, s5, codes, lengths, gate_forms(r, codes, lengths, "cpu")


def _tdb(bloom, s4, s5):
    return {"bloom": u32_tensor(bloom, "cpu"), "fp_s4": s4, "fp_s5": s5}


def _jax_chain(bloom, s4, s5, reads: ReadPlanes):
    """(wpos, whi, wlo, npass) and (hi, lo, valid) of the JAX package's
    chain, as numpy (key words as uint32)."""
    import jax.numpy as jnp

    from kmer_id_tpu.engine.fpclassify import unpack_codes as jax_unpack
    from kmer_id_tpu.ops.compact import compact_ranks_pallas
    from kmer_id_tpu.ops.extract import extract_kmers as jax_extract
    from kmer_id_tpu.ops.lookup import bloom_pass as jax_bloom_pass

    lengths = jnp.asarray(reads.lengths.numpy())
    if reads.packed is not None:
        codes = jax_unpack(jnp.asarray(reads.packed.numpy().view(np.uint32)),
                           jnp.asarray(reads.exc.numpy()), reads.width)
    else:
        codes = jnp.asarray(reads.codes.numpy())
    ex = jax_extract(codes, lengths)
    jdb = {"bloom": jnp.asarray(bloom), "fp_s4": jnp.uint32(s4), "fp_s5": jnp.uint32(s5)}
    bloomed = jax_bloom_pass(jdb, ex["hi"], ex["lo"], ex["valid"])
    b, p = bloomed.shape
    iota = jnp.arange(p, dtype=jnp.int32)[None]
    wpos, _, npass, (whi, wlo) = compact_ranks_pallas(
        jnp.broadcast_to(iota, (b, p)), bloomed, iota, BLOOM_K, interpret=True,
        extras=(ex["hi"], ex["lo"]))
    gate = tuple(np.asarray(x) for x in (wpos, whi, wlo, npass))
    return gate, tuple(np.asarray(ex[k]) for k in ("hi", "lo", "valid", "fstrand"))


def _as_numpy(gate, planes):
    g = tuple(x.numpy() for x in gate)
    return ((g[0], g[1].view(np.uint32), g[2].view(np.uint32), g[3]),
            (planes["hi"].numpy().view(np.uint32), planes["lo"].numpy().view(np.uint32),
             planes["valid"].numpy(), planes["fstrand"].numpy()))


@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("b,l,lens", SHAPES)
def test_plain_gate_matches_jax_chain(b, l, lens, form):
    bloom, s4, s5, _, _, forms = _world(b + l, b, l, lens)
    reads = forms[form]
    got = _as_numpy(window_gate_plain(_tdb(bloom, s4, s5), reads),
                    extract_plain(reads, fstrand=True))
    want = _jax_chain(bloom, s4, s5, reads)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    fstrand, pal = want[1][3], _palindromes(reads)
    assert fstrand.any() and pal.any() and not fstrand[pal].any()
    npass = want[0][3]
    assert npass.max() > BLOOM_K and 0 < (npass > 0).sum() < b  # dense rows and passes
    assert (want[0][0][npass == 0] == SENT).all()


# ------------------------------------------------ numpy model of gate.cu

M32 = np.uint64(0xFFFFFFFF)
M60 = np.uint64((1 << 60) - 1)
ODD = np.uint64(0x5555555555555555)
_BREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8)


def _funnel_r(lo, hi, sh):
    """__funnelshift_r: low 32 bits of (hi:lo) >> sh, sh in [0, 31]."""
    return (((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64))
            >> sh.astype(np.uint64)) & M32


def _brev64(x):
    x = np.ascontiguousarray(x, dtype=np.uint64).byteswap()
    return _BREV8[x.view(np.uint8)].view(np.uint64).reshape(x.shape)


def _mix(a, b, s1, s2):
    with np.errstate(over="ignore"):
        x = a ^ (b * np.uint32(s1))
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x2C1B3C6D)
        x ^= x >> np.uint32(12)
        x *= np.uint32(s2)
    return x ^ (x >> np.uint32(16))


def _stage(reads: ReadPlanes):
    """The kernel's shared-memory rows: 2-bit words (exception bases
    cleared) and the bad-base bitmask, uint32 [B, nw] and [B, nbw]."""
    b, l = reads.rows, reads.width
    n = reads.lengths.numpy().astype(np.int64)
    nbw = (l + 31) // 32 + 1
    i = np.arange(nbw * 32)
    badbits = i[None, :] >= n[:, None]
    if reads.packed is not None:
        packed = reads.packed.numpy().view(np.uint32)
        nw = max(2 * nbw, packed.shape[1] + 2)
        words = np.zeros((b, nw), np.uint32)
        words[:, : packed.shape[1]] = packed
        for e in reads.exc.numpy().tolist():
            if e < 0:
                continue
            f = min(e, b * l - 1)
            r, pos = divmod(f, l)
            badbits[r, pos] = True
            words[r, pos >> 4] &= ~np.uint32(3 << (2 * (pos & 15)))
    else:
        codes = np.zeros((b, nbw * 32), np.uint32)
        codes[:, :l] = reads.codes.numpy()
        badbits |= codes >= 4
        c = (codes & 3).reshape(b, -1, 16) << (2 * np.arange(16, dtype=np.uint32))
        words = np.bitwise_or.reduce(c, axis=2).astype(np.uint32)
    bad = np.packbits(badbits.reshape(b, nbw, 32)[..., ::-1], axis=2)
    bad = bad.view(">u4")[..., 0].astype(np.uint32)
    return words, bad


def _palindromes(reads: ReadPlanes):
    """[B, P] bool: the valid windows that are their own reverse
    complement."""
    c = _code_plane(reads).numpy().astype(np.int64) & 3
    p = reads.width - 29
    win = np.stack([c[:, j : j + p] for j in range(30)], axis=2)
    return (win == 3 - win[:, :, ::-1]).all(axis=2) & extract_plain(reads)["valid"].numpy()


def _model_windows(reads: ReadPlanes):
    """(hi, lo, valid, fstrand) [B, P] as gate.cu's window_key computes
    them."""
    words, bad = _stage(reads)
    p = reads.width - 29
    s = np.arange(p)
    k, sh = s >> 4, (2 * (s & 15)).astype(np.uint32)
    a = _funnel_r(words[:, k], words[:, k + 1], sh)
    c = _funnel_r(words[:, k + 1], words[:, k + 2], sh)
    win = (c << np.uint64(32)) | a
    rc = ~win & M60
    fw = _brev64(win) >> np.uint64(4)
    fw = ((fw >> np.uint64(1)) & ODD) | ((fw & ODD) << np.uint64(1))
    key = np.minimum(fw, rc)
    m = s >> 5
    ok = (_funnel_r(bad[:, m], bad[:, m + 1], (s & 31).astype(np.uint32))
          & np.uint64(0x3FFFFFFF)) == 0
    return (key >> np.uint64(32)).astype(np.uint32), (key & M32).astype(np.uint32), ok, fw < rc


def _model_gate(bloom, s4, s5, reads: ReadPlanes, k=BLOOM_K):
    """(wpos, whi, wlo, npass) as gate.cu's gate mode computes them."""
    hi, lo, ok, _ = _model_windows(reads)
    b, p = hi.shape
    blk = _mix(hi ^ np.uint32(0x243F6A88), lo, s4, s5) & np.uint32(len(bloom) - 1)
    m = _mix(lo ^ np.uint32(0xB7E15162), hi, s5, s4)
    row = bloom[blk]  # [B, P, 4]
    passed = ok.copy()
    for j in range(4):
        bit = (m >> np.uint32(7 * j)) & np.uint32(127)
        word = np.take_along_axis(row, (bit >> 5)[..., None].astype(np.int64), -1)[..., 0]
        passed &= ((word >> (bit & np.uint32(31))) & 1) == 1
    wpos = np.full((b, k), SENT, np.int32)
    whi, wlo = np.zeros((b, k), np.uint32), np.zeros((b, k), np.uint32)
    base = np.zeros(b, np.int64)
    lanes = np.arange(32, dtype=np.uint32)
    below = (np.uint32(1) << lanes) - np.uint32(1)
    for c0 in range(0, p, 32):  # one ballot per 32-window chunk
        chunk = np.zeros((b, 32), bool)
        chunk[:, : min(32, p - c0)] = passed[:, c0 : c0 + 32]
        ballot = np.bitwise_or.reduce(chunk.astype(np.uint32) << lanes, axis=1)
        rank = base[:, None] + np.bitwise_count(ballot[:, None] & below)  # [B, 32]
        rows, lane = np.nonzero(chunk & (rank < k))
        r = rank[rows, lane]
        wpos[rows, r] = c0 + lane
        whi[rows, r] = hi[rows, c0 + lane]
        wlo[rows, r] = lo[rows, c0 + lane]
        base += np.bitwise_count(ballot)
    return wpos, whi, wlo, base.astype(np.int32)


@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("b,l,lens", SHAPES)
def test_kernel_model_matches_plain(b, l, lens, form):
    bloom, s4, s5, _, _, forms = _world(7 * b + l, b, l, lens)
    reads = forms[form]
    got_gate = _model_gate(bloom, s4, s5, reads)
    got_planes = _model_windows(reads)
    want_gate, want_planes = _as_numpy(window_gate_plain(_tdb(bloom, s4, s5), reads),
                                       extract_plain(reads, fstrand=True))
    for g, w in zip(got_gate + got_planes, want_gate + want_planes):
        np.testing.assert_array_equal(g, w)
    assert want_gate[3].max() > BLOOM_K


def test_model_reads_bits_past_length_as_packed():
    """Invalid windows' key words come from the packed bits as they are,
    past the read's length too (the plain version unpacks them)."""
    r = np.random.default_rng(3)
    b, l = 8, 64
    packed = r.integers(0, 2**32, size=(b, l // 16), dtype=np.uint64).astype(np.uint32)
    lengths = np.array([0, 10, 29, 30, 40, 63, 64, 64], np.int32)
    exc = np.array([-1, 3 * l + 50, 7 * l + 2, b * l + 9, -1], np.int32)
    reads = ReadPlanes(torch.from_numpy(lengths), l, packed=torch.from_numpy(packed.view(np.int32)),
                       exc=torch.from_numpy(exc))
    got = _model_windows(reads)
    want = extract_plain(reads, fstrand=True)
    for g, k in zip(got, ("hi", "lo", "valid", "fstrand")):
        w = want[k].numpy()
        np.testing.assert_array_equal(g, w.view(np.uint32) if k in ("hi", "lo") else w)
    assert not got[2][7, :3].any() and got[2][6].all()  # exception at 7*l+2; row 6 clean


def test_dispatch_on_cpu_uses_the_plain_version():
    bloom, s4, s5, _, _, forms = _world(5, 40, 96, (60, 97))
    db = _tdb(bloom, s4, s5)
    before = (window_gate_cuda.launches.value, extract_cuda.launches.value)
    for reads in forms.values():
        for g, w in zip(window_gate(db, reads), window_gate_plain(db, reads)):
            assert torch.equal(g, w)
        got, want = extract(reads), extract_plain(reads)
        assert all(torch.equal(got[k], want[k]) for k in want) and "fstrand" not in got
        got, want = extract(reads, fstrand=True), extract_plain(reads, fstrand=True)
        assert set(got) == {"hi", "lo", "valid", "fstrand"}
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert (window_gate_cuda.launches.value, extract_cuda.launches.value) == before
    with pytest.raises(ValueError, match="CUDA"):
        window_gate_cuda(db, forms["packed"])
    with pytest.raises(ValueError, match="CUDA"):
        extract_cuda(forms["codes"])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("b,l,lens", [(8192, 160, (100, 151)), (2048, 512, (512, 513)),
                                      (2048, 512, (100, 301)), (37, 96, (20, 97))])
def test_kernel_matches_plain_on_card(b, l, lens, form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    r = np.random.default_rng(b + l)
    bloom = (r.integers(0, 2**32, size=(1 << 16, 4), dtype=np.uint64)
             & r.integers(0, 2**32, size=(1 << 16, 4), dtype=np.uint64)).astype(np.uint32)
    s4, s5 = (int(x) for x in r.integers(1, 2**32, size=2))
    codes, lengths = gate_rows(r, b, l, lens, bloom, s4, s5)
    reads = gate_forms(r, codes, lengths, "cuda")[form]
    db = {"bloom": u32_tensor(bloom, "cuda"), "fp_s4": s4, "fp_s5": s5}
    before = window_gate_cuda.launches.value
    got = window_gate(db, reads)
    assert window_gate_cuda.launches.value == before + 1
    want = window_gate_plain(db, reads)
    gx, wx = extract(reads, fstrand=True), extract_plain(reads, fstrand=True)
    g3 = extract_cuda(reads)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in ("hi", "lo", "valid", "fstrand"):
        assert torch.equal(gx[k], wx[k]), k
    assert set(g3) == {"hi", "lo", "valid"} and torch.equal(g3["hi"], wx["hi"])
