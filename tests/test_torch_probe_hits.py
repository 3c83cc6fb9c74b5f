"""Shard mode of probe + verify (ops/probe.py ``probe_hits_*``, the second
entry of csrc/probe.cu) on the CPU.

* ``probe_hits_plain`` against the JAX composition it replaces: the
  candidate planes, compaction and verify of ``local_hits`` in
  kmer_id_tpu/parallel/fpsharded.py:304-346 after the gate, built here on
  JAX's ``fp_hashes_jnp``, ``_fp_bucket_match``, ``take_rows``,
  ``interleave_planes`` and ``compact_ranks_pallas`` in interpret mode (the
  Pallas call at fpsharded.py:324), with the rank's ``seen`` block marked as
  its ``step_finals`` marks it.  Ranks 0 and 1 of dbp 2 (rank 1 holds no
  L2) and rank 3 of dbp 4.
* A numpy model of the kernel's own arithmetic (uint32 hashes, the L1 range
  test on the unsigned difference, no L1 row for an out-of-range window, a
  ballot per plane and popcounts below the lane for the ranks, the tail of
  unplaced ranks) against the plain version.
* The kernel itself against the plain version, on the card only (marked
  ``cuda``; skips elsewhere).

Every output is compared bit for bit: the narrow hit plane ``posk``,
``cand``, ``tgt``, ``tin``, ``td``, ``ver``, the candidate count ``ncand``,
and ``seen`` over the rank's slot ids.  Windows and tables are
chip_smoke.probe_windows/craft_tables' at 24 windows per read (the shard
budget), cut to the rank's part by chip_smoke.shard_cut.

The JAX package is imported only inside the test that uses it:
``pytest --noconftest -m cuda tests/test_torch_probe_hits.py`` runs the card
test where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    HIT_OUTPUTS,
    P,
    craft_tables,
    hits_mismatch,
    probe_kinds,
    probe_windows,
    shard_cut,
    shard_probe_tables,
    toy_world,
)
from kmer_id_tpu_torch.db.fpdb import build_fpdb, build_tinfo
from kmer_id_tpu_torch.ops.compact import SENT
from kmer_id_tpu_torch.ops.gate import SHARD_BLOOM_K
from kmer_id_tpu_torch.ops.probe import probe_hits, probe_hits_cuda, probe_hits_plain

B = 96
SH = 8  # the sharded engine's budget, min(8, max_hits)
RANKS = [(2, 0), (2, 1), (4, 3)]  # (dbp, db rank)
WORLDS = ["mixed", "saturated", "empty"]


@pytest.fixture(scope="module")
def base():
    """(sorted DB keys, FpDB, tinfo) of a 3,000-probe toy DB."""
    packed, tax, *_ = toy_world(num_probes=3000, num_targ=64, batch=8, max_len=64)
    return packed.keys, build_fpdb(packed, tax), build_tinfo(tax)


def _world(base, seed, world, b=B):
    """(crafted numpy tables, wpos, whi, wlo numpy) at the shard budget."""
    keys, fpdb, tinfo = base
    rng = np.random.default_rng(seed)
    wpos, whi, wlo, plants = probe_windows(rng, fpdb, keys, b, SHARD_BLOOM_K, P,
                                           probe_kinds(rng, b, world))
    return craft_tables(rng, fpdb, len(tinfo), plants), wpos, whi, wlo


def _windows(wpos, whi, wlo, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (wpos, whi.view(np.int32), wlo.view(np.int32)))


def _rank(fpdb, dbp, k):
    """(b0, nbloc, own2, local slot count) of db rank ``k``."""
    nb1 = len(fpdb.fptab)
    nbloc = nb1 // dbp
    return k * nbloc, nbloc, k == 0, (nbloc + len(fpdb.fptab2)) * 8


def _jax_local_hits(fpdb, local, tinfo, dbp, k, wpos, whi, wlo, sh):
    """fpsharded.py's ``local_hits`` after the gate, and its ``seen`` marks,
    on rank ``k``'s tables: (outputs as int64 tensors, seen int8 tensor)."""
    import functools

    import jax.numpy as jnp

    from kmer_id_tpu.ops.compact import compact_ranks_pallas, interleave_planes
    from kmer_id_tpu.ops.lookup import _fp_bucket_match, fp_hashes_jnp, take_rows

    s1, s2, s3, s4, s5 = (jnp.uint32(s) for s in (fpdb.s1, fpdb.s2, fpdb.s3, fpdb.s4, fpdb.s5))
    fptab, fptab2, rec = (jnp.asarray(local[n]) for n in ("fptab", "fptab2", "rec"))
    nb1, nb2 = len(fpdb.fptab), len(local["fptab2"])
    nbloc = nb1 // dbp
    wpos, hi, lo = jnp.asarray(wpos), jnp.asarray(whi), jnp.asarray(wlo)
    valid = wpos < SENT
    wp = jnp.where(valid, wpos, 0)
    b0 = jnp.int32(k * nbloc)
    b1, _, fp = fp_hashes_jnp(hi, lo, nb1, s1, s2, s3)
    inr = (b1 >= b0) & (b1 < b0 + nbloc)
    bl = jnp.clip(b1 - b0, 0, nbloc - 1)
    m1, i1 = _fp_bucket_match(take_rows(fptab, bl), fp)
    own2 = k == 0
    c1, c2, _ = fp_hashes_jnp(hi, lo, nb2, s4, s5, s3)
    m2, i2 = _fp_bucket_match(take_rows(fptab2, c1), fp)
    m3, i3 = _fp_bucket_match(take_rows(fptab2, c2), fp)
    planes = [
        (bl * 8 + i1, m1 & valid & inr),
        (nbloc * 8 + c1 * 8 + i2, m2 & valid & own2),
        (nbloc * 8 + c2 * 8 + i3, m3 & valid & own2 & (c2 != c1)),
    ]
    cand_ilv, valid_ilv = interleave_planes(planes)
    compact = functools.partial(compact_ranks_pallas, interpret=True)
    posk, cand, ncand, (qhi, qlo) = compact(
        cand_ilv, valid_ilv, jnp.repeat(wp, 3, axis=1), sh,
        extras=(jnp.repeat(hi, 3, axis=1), jnp.repeat(lo, 3, axis=1)))
    rrows = take_rows(rec, cand)
    ver = (posk < SENT) & (rrows[..., 0] == qhi) & (rrows[..., 1] == qlo)
    tinw = rrows[..., 2]
    tin_r = (tinw & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
    info = take_rows(jnp.asarray(tinfo), tin_r)
    tdw = (info[..., 1].astype(jnp.uint32) & jnp.uint32(0xFFFFFF)) | (tinw & jnp.uint32(0xFF000000))
    out = {"posk": jnp.where(ver, posk, SENT), "cand": cand, "tgt": jnp.where(ver, info[..., 0], 0),
           "tin": jnp.where(ver, tin_r, 0), "td": jnp.where(ver, tdw.view(jnp.int32), 0),
           "ver": ver, "ncand": ncand}
    n_slots = (nbloc + nb2) * 8
    seen = jnp.zeros(n_slots, jnp.int8).at[jnp.where(ver, cand, 0).reshape(-1)].max(
        jnp.where(ver, jnp.int8(1), jnp.int8(0)).reshape(-1))
    return ({f: torch.from_numpy(np.asarray(v).astype(np.int64)) for f, v in out.items()},
            torch.from_numpy(np.array(seen)))


@pytest.mark.parametrize("dbp,k", RANKS)
@pytest.mark.parametrize("world", WORLDS)
def test_plain_matches_jax(base, world, dbp, k):
    _, fpdb, tinfo = base
    crafted, wpos, whi, wlo = _world(base, 17 * dbp + k, world)
    b0, nbloc, own2, n_slots = _rank(fpdb, dbp, k)
    db = shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cpu")
    seen = torch.zeros(n_slots + 1, dtype=torch.int8)
    got = probe_hits_plain(db, *_windows(wpos, whi, wlo), SH, b0, nbloc, own2, seen)
    want, jseen = _jax_local_hits(fpdb, shard_cut(crafted, dbp, k), tinfo, dbp, k,
                                  wpos, whi, wlo, SH)
    bad, _ = hits_mismatch(got, want, n_slots, (seen, jseen))
    assert not bad, bad
    if world == "empty":
        assert int(got["ncand"].sum()) == 0
    else:
        assert int(got["ver"].sum()) > 0 and int(seen[:n_slots].sum()) > 0
        assert bool((got["ncand"] > SH).any())  # rows past the budget: the replay flag


def test_rank_sees_only_its_part(base):
    """Rank 1 of dbp 2 holds no L2 candidates and only L1 buckets of its
    range; rank 0 holds L2; the two ranks' candidates together are the
    unsharded table's."""
    from kmer_id_tpu_torch.ops.lookup import fp_candidates, fp_candidates_shard

    _, fpdb, tinfo = base
    crafted, wpos, whi, wlo = _world(base, 3, "mixed")
    wp, wh, wl = _windows(wpos, whi, wlo)
    valid = wp < SENT
    full = fp_candidates(shard_probe_tables(fpdb, crafted, tinfo, 1, 0, "cpu"), wh, wl, valid)
    counts = []
    for k in range(2):
        b0, nbloc, own2, _ = _rank(fpdb, 2, k)
        planes = fp_candidates_shard(shard_probe_tables(fpdb, crafted, tinfo, 2, k, "cpu"),
                                     wh, wl, valid, b0, nbloc, own2)
        if k == 1:
            assert not bool(planes[1][1].any() | planes[2][1].any())
        counts.append([int(v.sum()) for _, v in planes])
        # local slot ids map back to the global ones
        l1 = planes[0][0][planes[0][1]].long() + b0 * 8
        assert torch.equal(l1, full[0][0][planes[0][1]].long())
    for q in range(3):
        assert counts[0][q] + counts[1][q] == int(full[q][1].sum())
    assert counts[0][0] > 0 and counts[1][0] > 0


# ------------------------------------------ numpy model of the shard mode

_LANES = np.arange(32, dtype=np.uint32)


def _mix(a, b, s1, s2):
    with np.errstate(over="ignore"):
        x = a ^ (b * np.uint32(s1))
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x2C1B3C6D)
        x ^= x >> np.uint32(12)
        x *= np.uint32(s2)
    return x ^ (x >> np.uint32(16))


def _match(row, fp):
    s = np.full(fp.shape, -1)
    for i in range(7, -1, -1):  # bucket_match: the first match wins
        half = (row[..., i & 3] >> np.uint32(16 * (i >> 2))) & np.uint32(0xFFFF)
        s = np.where(half == fp, i, s)
    return s


def _model_hits(local, tinfo, salts, nb1, b0, nbloc, own2, wpos, whi, wlo, sh):
    """probe.cu's shard-mode outputs at the gate's <= 32 windows, ranked as
    its arithmetic ranks one 32-window tile (warp lanes as a [B, 32] axis),
    and its seen marks, as torch tensors."""
    fptab, fptab2, rec = local["fptab"], local["fptab2"], local["rec"]
    nb2 = len(fptab2)
    s1, s2, s3, s4, s5 = salts
    b, k = wpos.shape
    live = np.zeros((b, 32), bool)
    hi, lo = np.zeros((b, 32), np.uint32), np.zeros((b, 32), np.uint32)
    pos = np.full((b, 32), SENT, np.int64)
    live[:, :k], hi[:, :k], lo[:, :k], pos[:, :k] = wpos < SENT, whi, wlo, wpos
    with np.errstate(over="ignore"):
        bl = (_mix(hi, lo, s1, s2) & np.uint32(nb1 - 1)) - np.uint32(b0)
    inr = bl < np.uint32(nbloc)
    m = _mix(hi ^ np.uint32(0x6A09E667), lo, s3, s1)
    fp = (m ^ (m >> np.uint32(16))) & np.uint32(0xFFFF)
    fp[fp == 0] = 1
    c1 = _mix(hi, lo, s4, s5) & np.uint32(nb2 - 1)
    c2 = _mix(lo, hi, s5, s4) & np.uint32(nb2 - 1)
    l1, l2 = live & inr, live & own2
    zero = np.zeros((b, 32, 4), np.uint32)
    rows = (np.where(l1[..., None], fptab[np.where(l1, bl, 0)], zero),
            np.where(l2[..., None], fptab2[c1], zero), np.where(l2[..., None], fptab2[c2], zero))
    buckets = (bl.astype(np.int64), nbloc + c1.astype(np.int64), nbloc + c2.astype(np.int64))
    valid, slot = [], []
    for q in range(3):
        s = _match(rows[q], fp)
        valid.append((l1 if q == 0 else l2) & (s >= 0))
        slot.append(buckets[q] * 8 + np.maximum(s, 0))
    valid[2] &= c2 != c1

    below = (np.uint32(1) << _LANES) - np.uint32(1)
    ballots = [np.bitwise_or.reduce(v.astype(np.uint32) << _LANES, axis=1) for v in valid]
    r = sum(np.bitwise_count(bal[:, None] & below) for bal in ballots).astype(np.int64)
    ncand = sum(np.bitwise_count(bal) for bal in ballots).astype(np.int64)
    out = {f: np.zeros((b, sh), np.int64) for f in HIT_OUTPUTS if f != "ncand"}
    out["posk"][:] = SENT
    seen = np.zeros((nbloc + nb2) * 8, np.int8)
    n_nodes = len(tinfo)
    for q in range(3):
        rank = r.copy()
        r = r + valid[q]
        placed = valid[q] & (rank < sh)
        w = rec[np.where(placed, slot[q], 0)]
        ver = placed & (w[..., 0] == hi) & (w[..., 1] == lo)
        tin = (w[..., 2] & np.uint32(0xFFFFFF)).astype(np.int64)
        known = ver & (tin < n_nodes)
        info = tinfo[np.where(known, tin, 0)]
        node, tout = np.where(known, info[..., 0], 0), np.where(known, info[..., 1], 0)
        td = ((tout.astype(np.uint32) & np.uint32(0xFFFFFF)) | (w[..., 2] & np.uint32(0xFF000000)))
        rr, lanes = np.nonzero(placed)
        o = rank[rr, lanes]
        for f, v in (("posk", np.where(ver, pos, SENT)), ("cand", slot[q]),
                     ("tgt", np.where(ver, node, 0)), ("tin", np.where(ver, tin, 0)),
                     ("td", np.where(ver, td.view(np.int32), 0)), ("ver", ver)):
            out[f][rr, o] = v[rr, lanes]
        seen[slot[q][ver]] = 1
    out["ncand"] = ncand
    return ({f: torch.from_numpy(np.asarray(v).astype(np.int64)) for f, v in out.items()},
            torch.from_numpy(seen))


@pytest.mark.parametrize("sh", [8, 1, 32])
@pytest.mark.parametrize("dbp,k", RANKS)
@pytest.mark.parametrize("world", WORLDS)
def test_kernel_model_matches_plain(base, world, dbp, k, sh):
    _, fpdb, tinfo = base
    crafted, wpos, whi, wlo = _world(base, 5 * sh + 3 * dbp + k, world)
    b0, nbloc, own2, n_slots = _rank(fpdb, dbp, k)
    local = shard_cut(crafted, dbp, k)
    salts = (fpdb.s1, fpdb.s2, fpdb.s3, fpdb.s4, fpdb.s5)
    got, mseen = _model_hits(local, tinfo, salts, len(fpdb.fptab), b0, nbloc, own2,
                             wpos, whi, wlo, sh)
    seen = torch.zeros(n_slots + 1, dtype=torch.int8)
    want = probe_hits_plain(shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cpu"),
                            *_windows(wpos, whi, wlo), sh, b0, nbloc, own2, seen)
    bad, _ = hits_mismatch(got, want, n_slots, (mseen, seen))
    assert not bad, bad


def test_dispatch_on_cpu_uses_the_plain_version(base):
    _, fpdb, tinfo = base
    crafted, wpos, whi, wlo = _world(base, 2, "mixed", b=40)
    b0, nbloc, own2, n_slots = _rank(fpdb, 2, 0)
    db = shard_probe_tables(fpdb, crafted, tinfo, 2, 0, "cpu")
    windows = _windows(wpos, whi, wlo)
    before = probe_hits_cuda.launches.value
    seen_a, seen_b = (torch.zeros(n_slots + 1, dtype=torch.int8) for _ in range(2))
    got = probe_hits(db, *windows, SH, b0, nbloc, own2, seen_a)
    want = probe_hits_plain(db, *windows, SH, b0, nbloc, own2, seen_b)
    assert all(torch.equal(got[f], want[f]) for f in HIT_OUTPUTS)
    assert torch.equal(seen_a, seen_b)
    assert probe_hits_cuda.launches.value == before
    with pytest.raises(ValueError, match="CUDA"):
        probe_hits_cuda(db, *windows, SH, b0, nbloc, own2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sh", [(8192, 8), (37, 8), (64, 1), (256, 32)])
@pytest.mark.parametrize("dbp,k", RANKS)
@pytest.mark.parametrize("world", WORLDS)
def test_kernel_matches_plain_on_card(base, world, dbp, k, b, sh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    _, fpdb, tinfo = base
    crafted, wpos, whi, wlo = _world(base, b + sh + dbp + k, world, b=b)
    b0, nbloc, own2, n_slots = _rank(fpdb, dbp, k)
    db = shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cuda")
    windows = _windows(wpos, whi, wlo, "cuda")
    seen_k, seen_p = (torch.zeros(n_slots + 1, dtype=torch.int8, device="cuda")
                      for _ in range(2))
    before = probe_hits_cuda.launches.value
    got = probe_hits(db, *windows, sh, b0, nbloc, own2, seen_k)
    assert probe_hits_cuda.launches.value == before + 1
    want = probe_hits_plain(db, *windows, sh, b0, nbloc, own2, seen_p)
    torch.cuda.synchronize()
    bad, _ = hits_mismatch(got, want, n_slots, (seen_k, seen_p))
    assert not bad, bad


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_card(base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the limits are the kernel's")
    _, fpdb, tinfo = base
    crafted, wpos, whi, wlo = _world(base, 1, "mixed", b=16)
    b0, nbloc, own2, _ = _rank(fpdb, 2, 1)
    db = shard_probe_tables(fpdb, crafted, tinfo, 2, 1, "cuda")
    windows = _windows(wpos, whi, wlo, "cuda")
    for sh in (0, 33):
        with pytest.raises(ValueError, match="sh"):
            probe_hits_cuda(db, *windows, sh, b0, nbloc, own2)
    with pytest.raises(ValueError, match="outside"):
        probe_hits_cuda(db, *windows, SH, b0 + 1, nbloc, own2)
    with pytest.raises(ValueError, match="shape"):
        probe_hits_cuda(db, *windows, SH, b0, nbloc // 2, own2)
