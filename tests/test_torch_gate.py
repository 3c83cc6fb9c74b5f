"""The window gate (kmer_id_tpu_torch/ops/gate.py) on the CPU.

* ``window_gate_plain`` and ``extract_plain`` (its ``fstrand`` plane too)
  against the JAX chain they replace: ``unpack_codes``, ``extract_kmers``,
  ``bloom_pass`` and ``compact_ranks_pallas`` in interpret mode, bit for
  bit.
* A numpy model of the CUDA kernel's own arithmetic and structure
  (csrc/gate.cu: each window read from the packed words by shift, the
  reverse complement as ``~W & (2^60 - 1)``, the forward key by reversing
  W's 2-bit groups, fstrand as forward < reverse complement, the bad-base
  bitmask, the uint32 hash; in gate mode a row's warps walking the read's
  own windows in steps of chunks of 32, the count carried across steps and
  warps, the Bloom loads of windows valid before the exception merge, the
  keys from the bits as packed) against the plain versions and the JAX
  chain, at the edges of the row counts, widths and groupings the kernel
  takes (rows of length 0, 29, 30, 31 and the width; npass exactly k and
  k + 1; k = 12 and 24), so the kernel's formulas are checked here.
* The kernel itself against the plain versions, on the card only (marked
  ``cuda``; skips elsewhere), at the engine's shapes, the edges, and every
  grouping through the C entries.

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

from chip_smoke import gate_edge_rows, gate_forms, gate_rows
from kmer_id_tpu_torch.ops.compact import SENT
from kmer_id_tpu_torch.ops.gate import (
    BLOOM_K,
    SHARD_BLOOM_K,
    ReadPlanes,
    _code_plane,
    extract,
    extract_cuda,
    extract_plain,
    gate_group,
    window_gate,
    window_gate_cuda,
    window_gate_plain,
)
from kmer_id_tpu_torch.ops.words import u32_tensor

# (rows, row width, read lengths [lo, hi)): short reads in a narrow plane,
# chunk-like rows as wide as the plane, m3-like reads in a wide plane
SHAPES = [(200, 96, (60, 97)), (80, 160, (160, 161)), (64, 200, (40, 130))]
NBLK = 4096
KCHUNKS = 4  # csrc/gate.cu's kChunks: chunks of 32 windows per warp per step


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


def _jax_chain(bloom, s4, s5, reads: ReadPlanes, k=BLOOM_K):
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
        jnp.broadcast_to(iota, (b, p)), bloomed, iota, k, interpret=True,
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


def _stage(reads: ReadPlanes, exceptions=True, clear=True):
    """The kernel's shared-memory rows: 2-bit words and the bad-base
    bitmask, uint32 [B, nw] and [B, nbw].  ``exceptions``: the exception
    list merged into the mask; ``clear``: its bases' code bits cleared too
    (extract mode; gate mode keeps the bits as packed)."""
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
        for e in reads.exc.numpy().tolist() if exceptions else ():
            if e < 0:
                continue
            f = min(e, b * l - 1)
            r, pos = divmod(f, l)
            badbits[r, pos] = True
            if clear:
                words[r, pos >> 4] &= ~np.uint32(3 << (2 * (pos & 15)))
    else:  # 16 bases a thread: a code word and a 16-bit half of the mask
        codes = np.zeros((b, nbw * 32), np.uint32)
        codes[:, :l] = reads.codes.numpy()
        badbits |= codes >= 4
        c = (codes & 3).reshape(b, -1, 16) << (2 * np.arange(16, dtype=np.uint32))
        words = np.bitwise_or.reduce(c, axis=2).astype(np.uint32)
        halves = np.packbits(badbits.reshape(b, 2 * nbw, 16)[..., ::-1], axis=2)
        halves = halves.view(">u2")[..., 0].astype("<u2")
        return words, np.ascontiguousarray(halves).view("<u4").astype(np.uint32)
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


def _keys(words, p):
    """(hi, lo, fstrand) [B, P] of gate.cu's window_key on staged words."""
    s = np.arange(p)
    k, sh = s >> 4, (2 * (s & 15)).astype(np.uint32)
    a = _funnel_r(words[:, k], words[:, k + 1], sh)
    c = _funnel_r(words[:, k + 1], words[:, k + 2], sh)
    win = (c << np.uint64(32)) | a
    rc = ~win & M60
    fw = _brev64(win) >> np.uint64(4)
    fw = ((fw >> np.uint64(1)) & ODD) | ((fw & ODD) << np.uint64(1))
    key = np.minimum(fw, rc)
    return (key >> np.uint64(32)).astype(np.uint32), (key & M32).astype(np.uint32), fw < rc


def _window_ok(bad, p):
    """[B, P] bool: gate.cu's window_ok, no bad base among a window's 30."""
    s = np.arange(p)
    m = s >> 5
    return (_funnel_r(bad[:, m], bad[:, m + 1], (s & 31).astype(np.uint32))
            & np.uint64(0x3FFFFFFF)) == 0


def _model_windows(reads: ReadPlanes):
    """(hi, lo, valid, fstrand) [B, P] as gate.cu's extract mode computes
    them (exceptions merged and cleared before any key)."""
    words, bad = _stage(reads)
    p = reads.width - 29
    hi, lo, fwd = _keys(words, p)
    return hi, lo, _window_ok(bad, p), fwd


def _model_gate(bloom, s4, s5, reads: ReadPlanes, k=BLOOM_K, group=None):
    """(wpos, whi, wlo, npass) as gate.cu's gate mode computes them, and the
    count of Bloom rows it loads.  ``group`` warps per row (default the
    wrapper's ``gate_group``) walk each read's own windows in steps of
    ``group * KCHUNKS`` chunks of 32, warp g taking the step's chunks
    ``(st * KCHUNKS + u) * group + g``; a window gets its Bloom load if the
    mask before the exception merge passes it (its key from the words as
    packed), and passes if the mask after the merge and the Bloom bits do;
    ranks are the running count, the counts of the step's earlier chunks
    (each warp's, through shared memory) and a ballot per chunk."""
    b, l = reads.rows, reads.width
    group = gate_group(b, l) if group is None else group
    p = l - 29
    words, bad_pre = _stage(reads, exceptions=False)
    _, bad = _stage(reads, clear=False)
    hi, lo, _ = _keys(words, p)
    nwin = np.maximum(np.clip(reads.lengths.numpy(), 0, l) - 29, 0)
    cand = (np.arange(p)[None] < nwin[:, None]) & _window_ok(bad_pre, p)
    blk = _mix(hi ^ np.uint32(0x243F6A88), lo, s4, s5) & np.uint32(len(bloom) - 1)
    m = _mix(lo ^ np.uint32(0xB7E15162), hi, s5, s4)
    row = bloom[blk]  # [B, P, 4]
    passed = cand & _window_ok(bad, p)
    for j in range(4):
        bit = (m >> np.uint32(7 * j)) & np.uint32(127)
        word = np.take_along_axis(row, (bit >> 5)[..., None].astype(np.int64), -1)[..., 0]
        passed &= ((word >> (bit & np.uint32(31))) & 1) == 1
    wpos = np.full((b, k), SENT, np.int32)
    whi, wlo = np.zeros((b, k), np.uint32), np.zeros((b, k), np.uint32)
    lanes = np.arange(32, dtype=np.uint32)
    below = (np.uint32(1) << lanes) - np.uint32(1)
    chunks = KCHUNKS
    per_step = group * chunks * 32
    steps = -(-nwin // per_step)
    base = np.zeros(b, np.int64)
    for st in range(int(steps.max(initial=0))):
        live = st < steps
        ballots = np.zeros((b, chunks, group), np.uint32)  # [row, u, warp g]
        for u in range(chunks):
            for g in range(group):
                s0 = ((st * chunks + u) * group + g) * 32
                bits = np.zeros((b, 32), bool)
                bits[:, : max(0, min(32, p - s0))] = passed[:, s0 : s0 + 32]
                ballots[:, u, g] = np.bitwise_or.reduce(
                    (bits & live[:, None]).astype(np.uint32) << lanes, axis=1)
        counts = np.bitwise_count(ballots).astype(np.int64).reshape(b, -1)  # chunk order
        rank0 = (base[:, None] + np.cumsum(counts, axis=1) - counts).reshape(b, chunks, group)
        for u in range(chunks):
            for g in range(group):
                ballot = ballots[:, u, g]
                on = ((ballot[:, None] >> lanes) & 1) == 1
                rank = rank0[:, u, g, None] + np.bitwise_count(ballot[:, None] & below)
                rows, lane = np.nonzero(on & (rank < k))
                r = rank[rows, lane]
                s = ((st * chunks + u) * group + g) * 32 + lane
                wpos[rows, r] = s
                whi[rows, r] = hi[rows, s]
                wlo[rows, r] = lo[rows, s]
        base += counts.sum(axis=1)
    return (wpos, whi, wlo, base.astype(np.int32)), int(cand.sum())


@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("b,l,lens", SHAPES)
def test_kernel_model_matches_plain(b, l, lens, form):
    bloom, s4, s5, _, _, forms = _world(7 * b + l, b, l, lens)
    reads = forms[form]
    got_gate, _ = _model_gate(bloom, s4, s5, reads)
    got_planes = _model_windows(reads)
    want_gate, want_planes = _as_numpy(window_gate_plain(_tdb(bloom, s4, s5), reads),
                                       extract_plain(reads, fstrand=True))
    for g, w in zip(got_gate + got_planes, want_gate + want_planes):
        np.testing.assert_array_equal(g, w)
    assert want_gate[3].max() > BLOOM_K


# The redesign's edges, each row count and width with the warps per row
# gate_group gives it: (rows, width, k).
EDGE_SHAPES = [
    (1, 30, BLOOM_K),  # one window, G 1
    (7, 31, SHARD_BLOOM_K),  # G 1
    (7, 61, BLOOM_K),  # one chunk exactly
    (7, 62, SHARD_BLOOM_K),  # one past a chunk
    (2047, 160, BLOOM_K),  # G 2
    (2049, 512, SHARD_BLOOM_K),  # G 2
    (1, 512, BLOOM_K),  # G 4, one row
    (8193, 160, SHARD_BLOOM_K),  # G 1
    (8193, 158, BLOOM_K),  # G 1: one window past a step of 128
]


def _edge_world(seed, b, l, k):
    """(numpy bloom, s4, s5, {form: ReadPlanes on the CPU}) of
    chip_smoke.gate_edge_rows."""
    r = np.random.default_rng(seed)
    bloom = (r.integers(0, 2**32, size=(NBLK, 4), dtype=np.uint64)
             & r.integers(0, 2**32, size=(NBLK, 4), dtype=np.uint64)).astype(np.uint32)
    s4, s5 = (int(x) for x in r.integers(1, 2**32, size=2))
    codes, lengths = gate_edge_rows(r, b, l, k, bloom, s4, s5)
    return bloom, s4, s5, gate_forms(r, codes, lengths, "cpu")


def _check_model(bloom, s4, s5, reads, k, group=None, jax=True):
    """The model of both modes against the plain versions and (``jax``) the
    JAX chain; returns the plain gate's npass."""
    (gate, loads) = _model_gate(bloom, s4, s5, reads, k, group)
    planes = _model_windows(reads)
    want = _as_numpy(window_gate_plain(_tdb(bloom, s4, s5), reads, k),
                     extract_plain(reads, fstrand=True))
    names = ("wpos", "whi", "wlo", "npass", "hi", "lo", "valid", "fstrand")
    for name, g, w in zip(names, gate + planes, want[0] + want[1]):
        np.testing.assert_array_equal(g, w, err_msg=f"model != plain: {name}")
    if jax:
        chain = _jax_chain(bloom, s4, s5, reads, k)
        for name, w, j in zip(names, want[0] + want[1], chain[0] + chain[1]):
            np.testing.assert_array_equal(w, j, err_msg=f"plain != JAX: {name}")
    # the walk stops at each read's end: no load past it, one per valid window
    # and a few more (windows invalid only by an exception, merged later)
    n = np.clip(reads.lengths.numpy(), 0, reads.width)
    assert int(want[1][2].sum()) <= loads <= int(np.maximum(n - 29, 0).sum())
    return want[0][3]


@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("b,l,k", EDGE_SHAPES, ids=[f"{b}x{l}-k{k}" for b, l, k in EDGE_SHAPES])
def test_model_matches_plain_and_jax_at_edges(b, l, k, form):
    bloom, s4, s5, forms = _edge_world(b + 3 * l + k, b, l, k)
    npass = _check_model(bloom, s4, s5, forms[form], k)
    if l >= 30 + k and b >= 7:
        assert (npass == k).any() and (npass == k + 1).any()


@pytest.mark.parametrize("width", ["past_step", "nx"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_model_any_group_matches_plain(group, width):
    """Every grouping the kernel takes, at a width one window past a step
    of ``group * KCHUNKS`` chunks (and at the nx width), against the plain
    versions (held to the JAX chain by the tests above)."""
    l = group * KCHUNKS * 32 + 30 if width == "past_step" else 160
    bloom, s4, s5, forms = _edge_world(group * 10 + KCHUNKS + l, 37, l, BLOOM_K)
    for reads in forms.values():
        _check_model(bloom, s4, s5, reads, BLOOM_K, group, jax=False)


@pytest.mark.parametrize("b,l,g", [(8192, 160, 1), (8193, 160, 1), (2048, 512, 2),
                                   (2049, 512, 2), (2047, 512, 4), (2047, 160, 2), (37, 96, 1),
                                   (7, 542, 8), (1, 30, 1), (4096, 512, 1), (100, 10_000, 8)])
def test_gate_group_fills_the_card(b, l, g):
    assert gate_group(b, l) == g


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


CARD_SHAPES = [(8192, 160, (100, 151)), (2048, 512, (512, 513)), (2048, 512, (100, 301)),
               (37, 96, (20, 97))]
CARD_SHAPES = ([(b, l, lens, BLOOM_K) for b, l, lens in CARD_SHAPES]
               + [(b, l, None, k) for b, l, k in EDGE_SHAPES + [(7, 542, SHARD_BLOOM_K)]])


def _card_world(b, l, lens, k, form):
    """(db, reads) on the card: chip_smoke's gate rows (``lens`` a range of
    read lengths) or its edge rows (``lens`` None), on a 2^16-block filter."""
    r = np.random.default_rng(b + l + k)
    bloom = (r.integers(0, 2**32, size=(1 << 16, 4), dtype=np.uint64)
             & r.integers(0, 2**32, size=(1 << 16, 4), dtype=np.uint64)).astype(np.uint32)
    s4, s5 = (int(x) for x in r.integers(1, 2**32, size=2))
    if lens is None:
        codes, lengths = gate_edge_rows(r, b, l, k, bloom, s4, s5)
    else:
        codes, lengths = gate_rows(r, b, l, lens, bloom, s4, s5)
    reads = gate_forms(r, codes, lengths, "cuda")[form]
    return {"bloom": u32_tensor(bloom, "cuda"), "fp_s4": s4, "fp_s5": s5}, reads


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("b,l,lens,k", CARD_SHAPES)
def test_kernel_matches_plain_on_card(b, l, lens, k, form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    db, reads = _card_world(b, l, lens, k, form)
    before = window_gate_cuda.launches.value
    got = window_gate(db, reads, k)
    assert window_gate_cuda.launches.value == before + 1
    want = window_gate_plain(db, reads, k)
    gx, wx = extract(reads, fstrand=True), extract_plain(reads, fstrand=True)
    g3 = extract_cuda(reads)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for name in ("hi", "lo", "valid", "fstrand"):
        assert torch.equal(gx[name], wx[name]), name
    assert set(g3) == {"hi", "lo", "valid"} and torch.equal(g3["hi"], wx["hi"])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "codes"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_kernel_any_group_on_card(group, form):
    """The C entries at every grouping, past the wrapper's choice, against
    the plain versions at the width one window past a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    from kmer_id_tpu_torch.kernels.build import launch, load_gate, ptr
    from kmer_id_tpu_torch.ops.gate import _kernel_args

    l = group * KCHUNKS * 32 + 30
    db, reads = _card_world(37, l, None, BLOOM_K, form)
    lead = _kernel_args(reads, "test")[:-1] + (group,)
    lib = load_gate()
    out = [torch.empty((37, BLOOM_K), dtype=torch.int32, device="cuda") for _ in range(3)]
    out.append(torch.empty((37,), dtype=torch.int32, device="cuda"))
    nblk = db["bloom"].shape[0]
    launch(lib.kmer_window_gate, "window_gate", reads.device, *lead, ptr(db["bloom"]),
           nblk, db["fp_s4"], db["fp_s5"], BLOOM_K, *map(ptr, out))
    planes = {n: torch.empty((37, l - 29), dtype=torch.int32, device="cuda") for n in ("hi", "lo")}
    planes.update({n: torch.empty((37, l - 29), dtype=torch.bool, device="cuda")
                   for n in ("valid", "fstrand")})
    launch(lib.kmer_window_extract, "window_extract", reads.device, *lead,
           *(ptr(planes[n]) for n in ("hi", "lo", "valid", "fstrand")))
    want, wx = window_gate_plain(db, reads), extract_plain(reads, fstrand=True)
    torch.cuda.synchronize()
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    for name in planes:
        assert torch.equal(planes[name], wx[name]), name
