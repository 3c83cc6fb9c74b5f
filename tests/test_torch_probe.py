"""Probe + verify (kmer_id_tpu_torch/ops/probe.py) on the CPU.

* ``probe_verify_plain`` against the JAX composition it replaces:
  ``fp_candidates``, ``interleave_planes``, ``_cv_tier`` (its fast tier
  compacting by ``compact_ranks_pallas`` in interpret mode, its full tier by
  ``compact_sort``, as the JAX engine picks them) and ``_compact_verify``'s
  tail, at ``max_hits`` 8 and 32, with and without ``seen``.
* A numpy model of the CUDA kernel's own arithmetic (csrc/probe.cu: uint32
  hashes, the first match in the order low halves then high halves, a
  ballot per plane and popcounts below the lane for the ranks, the
  (depth + 1, 63 - rank) max and the all-lanes consistency test) against the
  plain version.
* The kernel itself against the plain version, and FpClassifier's check of
  a budget the kernel cannot rank, on the card only (marked ``cuda``; skips
  elsewhere).

Comparison: every output bit for bit, ``seen`` over the slot ids (the plain
version also writes its sink element), except ``tin``, ``tout`` and
``depth``, compared only where ``ver`` holds: at unverified and unplaced
slots the plain version keeps what the compaction padding and ``rec`` give,
the kernel 0 and the candidate's own rec fields, and nothing downstream
reads them there (the fold ignores ``t == 0``; ``consistent``, the summary
plane and ``fp_long_finals`` mask by ``ver``).  ``deepest`` and ``dtgt`` are
compared everywhere, though the engine reads them only where ``nh > 0``.

Tables are a small DB's (chip_smoke.toy_world probes through ``build_fpdb``)
with fingerprints planted by chip_smoke.craft_tables: windows whose
fingerprint sits in their L1 bucket and both L2 buckets (12 windows, 36
candidates: past 32, the overflow bit), keys whose two L2 buckets agree,
duplicate fingerprints in one bucket, rows with no passing window, and rec
rows planted to verify at tied depths.

The JAX package is imported only inside the test that uses it, so the card
test also runs where only PyTorch is installed (skip tests/conftest.py,
which imports jax): ``pytest --noconftest -m cuda tests/test_torch_probe.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    PROBE_FIELDS,
    craft_tables,
    probe_kinds,
    probe_mismatch,
    probe_tables,
    probe_windows,
    toy_world,
)
from kmer_id_tpu_torch.db.fpdb import build_fpdb, build_tinfo, fp_hashes
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier
from kmer_id_tpu_torch.ops.compact import SENT
from kmer_id_tpu_torch.ops.gate import BLOOM_K
from kmer_id_tpu_torch.ops.probe import (
    FAST_HITS,
    probe_verify,
    probe_verify_cuda,
    probe_verify_plain,
)

B, P = 96, 131
WORLDS = ["mixed", "typical", "empty", "overflow"]


@pytest.fixture(scope="module")
def base():
    """(sorted DB keys, FpDB, tinfo) of a 3,000-probe toy DB."""
    packed, tax, *_ = toy_world(num_probes=3000, num_targ=64, batch=8, max_len=64)
    return packed.keys, build_fpdb(packed, tax), build_tinfo(tax)


def _world(base, seed, world, b=B, device="cpu"):
    """(tables on ``device``, crafted numpy tables, wpos, whi, wlo numpy)."""
    keys, fpdb, tinfo = base
    rng = np.random.default_rng(seed)
    wpos, whi, wlo, plants = probe_windows(rng, fpdb, keys, b, BLOOM_K, P,
                                           probe_kinds(rng, b, world))
    crafted = craft_tables(rng, fpdb, len(tinfo), plants)
    return probe_tables(fpdb, crafted, tinfo, device), crafted, wpos, whi, wlo


def _windows(wpos, whi, wlo, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (wpos, whi.view(np.int32), wlo.view(np.int32)))


def _seen(n_slots, device="cpu"):
    return torch.zeros(n_slots + 1, dtype=torch.int8, device=device)


def _jax_probe_verify(fpdb, crafted, tinfo, wpos, whi, wlo, max_hits, with_seen):
    """The JAX composition (module doc): the per-read dict as torch tensors,
    and ``seen`` (int8 [n_slots]) or None."""
    import functools

    import jax.numpy as jnp

    from kmer_id_tpu.engine.fpclassify import FAST_HITS as JAX_FAST_HITS
    from kmer_id_tpu.engine.fpclassify import _cv_tier
    from kmer_id_tpu.ops.compact import compact_ranks_pallas, compact_sort, interleave_planes
    from kmer_id_tpu.ops.lookup import fp_candidates

    jdb = {k: jnp.asarray(v) for k, v in crafted.items()}
    jdb["tinfo"] = jnp.asarray(tinfo)
    for i, s in enumerate((fpdb.s1, fpdb.s2, fpdb.s3, fpdb.s4, fpdb.s5)):
        jdb[f"fp_s{i + 1}"] = jnp.uint32(s)
    wpos, whi, wlo = jnp.asarray(wpos), jnp.asarray(whi), jnp.asarray(wlo)
    wvalid = wpos < SENT
    ci, vi = interleave_planes(fp_candidates(jdb, whi, wlo, wvalid))
    pos = jnp.repeat(jnp.where(wvalid, wpos, 0), 3, axis=1)
    ncand = vi.sum(axis=1).astype(jnp.int32)
    args = (jdb, jnp.repeat(whi, 3, axis=1), jnp.repeat(wlo, 3, axis=1), ci, vi, pos)
    seen = jnp.zeros(fpdb.n_slots, jnp.int8) if with_seen else None
    if max_hits > JAX_FAST_HITS and int(ncand.max()) > JAX_FAST_HITS:
        res = _cv_tier(*args, max_hits, max_hits, compact_sort, seen)
    else:
        pallas = functools.partial(compact_ranks_pallas, interpret=True)
        res = _cv_tier(*args, min(JAX_FAST_HITS, max_hits), max_hits, pallas, seen)
    if with_seen:
        res, seen = res
    cand, ver, tin, tout, depth, t = res
    j = jnp.argmax(jnp.where(ver, depth, -1), axis=1)[:, None]
    dtin = jnp.take_along_axis(tin, j, axis=1)
    out = {
        "cand": cand, "ver": ver, "nh": ver.sum(axis=1), "tin": tin, "tout": tout,
        "depth": depth, "t": t,
        "deepest": jnp.take_along_axis(cand, j, axis=1)[:, 0],
        "dtgt": jnp.take_along_axis(t, j, axis=1)[:, 0],
        "consistent": jnp.all(~ver | ((tin <= dtin) & (dtin <= tout)), axis=1),
        "overflow": ncand > max_hits,
    }
    as_torch = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in out.items()}
    for k in ("ver", "consistent", "overflow"):
        as_torch[k] = as_torch[k].bool()
    return as_torch, None if seen is None else torch.from_numpy(np.array(seen))


def _widened(cv: dict) -> dict:
    return {k: v if v.dtype == torch.bool else v.long() for k, v in cv.items()}


@pytest.mark.parametrize("with_seen", [True, False])
@pytest.mark.parametrize("max_hits", [8, 32])
@pytest.mark.parametrize("world", ["mixed", "typical"])
def test_plain_matches_jax(base, world, max_hits, with_seen):
    _, fpdb, tinfo = base
    tdb, crafted, wpos, whi, wlo = _world(base, 11 + max_hits, world)
    seen = _seen(fpdb.n_slots) if with_seen else None
    got = probe_verify_plain(tdb, *_windows(wpos, whi, wlo), max_hits, seen)
    want, jseen = _jax_probe_verify(fpdb, crafted, tinfo, wpos, whi, wlo, max_hits, with_seen)
    pair = None if seen is None else (seen.long(), jseen.long())
    bad, _ = probe_mismatch(_widened(got), want, fpdb.n_slots, pair)
    assert not bad, bad
    assert int(got["nh"].sum()) > 0
    if with_seen:
        assert int(seen[: fpdb.n_slots].sum()) > 0


@pytest.mark.parametrize("world", ["empty", "overflow"])
def test_plain_matches_jax_at_the_extremes(base, world):
    _, fpdb, tinfo = base
    tdb, crafted, wpos, whi, wlo = _world(base, 5, world, b=40)
    seen = _seen(fpdb.n_slots)
    got = probe_verify_plain(tdb, *_windows(wpos, whi, wlo), 32, seen)
    want, jseen = _jax_probe_verify(fpdb, crafted, tinfo, wpos, whi, wlo, 32, True)
    bad, _ = probe_mismatch(_widened(got), want, fpdb.n_slots, (seen.long(), jseen.long()))
    assert not bad, bad
    assert bool(got["overflow"].all()) == (world == "overflow")


def test_worlds_cover_the_hard_cases(base):
    """The mixed world holds every case the kernel must get right."""
    keys, fpdb, tinfo = base
    tdb, crafted, wpos, whi, wlo = _world(base, 7, "mixed")
    live = wpos < SENT
    hi, lo = whi[live], wlo[live]
    b1, _, fp = fp_hashes(hi, lo, len(crafted["fptab"]), fpdb.s1, fpdb.s2, fpdb.s3)
    c1, c2, _ = fp_hashes(hi, lo, len(crafted["fptab2"]), fpdb.s4, fpdb.s5, fpdb.s3)

    def matches(tab, bucket):
        row = tab[bucket]
        return (np.concatenate([row & 0xFFFF, row >> 16], axis=-1) == fp[:, None]).sum(axis=-1)

    m1, m2, m3 = matches(crafted["fptab"], b1), matches(crafted["fptab2"], c1), matches(
        crafted["fptab2"], c2)
    cv = probe_verify_plain(tdb, *_windows(wpos, whi, wlo), 32)
    assert (~live.any(axis=1)).any()  # rows with no passing window
    assert ((m1 > 0) & (m2 > 0) & (m3 > 0) & (c1 != c2)).sum() >= BLOOM_K  # 3 planes
    assert ((c1 == c2) & (m2 > 0)).any()  # the third plane excluded
    assert (m1 > 1).any()  # duplicate fingerprints in one bucket: the first one wins
    assert bool(cv["overflow"].any()) and not bool(cv["overflow"].all())
    assert int(cv["nh"].max()) > FAST_HITS  # the full tier, verified hits past 8
    assert not bool(cv["consistent"].all()) and bool(cv["consistent"].any())
    depth = torch.where(cv["ver"], cv["depth"], -1)
    top = depth.max(dim=1, keepdim=True).values
    assert bool(((depth == top) & cv["ver"]).sum(dim=1).gt(1).any())  # tied deepest hits


# ----------------------------------------------- numpy model of probe.cu

_LANES = np.arange(32, dtype=np.uint32)


def _mix(a, b, s1, s2):
    with np.errstate(over="ignore"):
        x = a ^ (b * np.uint32(s1))
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x2C1B3C6D)
        x ^= x >> np.uint32(12)
        x *= np.uint32(s2)
    return x ^ (x >> np.uint32(16))


def _model_probe(tabs, tinfo, salts, wpos, whi, wlo, mh):
    """probe.cu's outputs at the gate's <= 32 windows, ranked as its
    arithmetic ranks one 32-window tile (warp lanes as a [B, 32] axis), as
    torch tensors."""
    fptab, fptab2, rec = tabs["fptab"], tabs["fptab2"], tabs["rec"]
    nb1, nb2 = len(fptab), len(fptab2)
    s1, s2, s3, s4, s5 = salts
    b, k = wpos.shape
    live = np.zeros((b, 32), bool)
    hi, lo = np.zeros((b, 32), np.uint32), np.zeros((b, 32), np.uint32)
    live[:, :k], hi[:, :k], lo[:, :k] = wpos < SENT, whi, wlo
    b1 = _mix(hi, lo, s1, s2) & np.uint32(nb1 - 1)
    m = _mix(hi ^ np.uint32(0x6A09E667), lo, s3, s1)
    fp = (m ^ (m >> np.uint32(16))) & np.uint32(0xFFFF)
    fp[fp == 0] = 1
    c1 = _mix(hi, lo, s4, s5) & np.uint32(nb2 - 1)
    c2 = _mix(lo, hi, s5, s4) & np.uint32(nb2 - 1)
    valid, slot = [], []
    for tab, bucket, base in ((fptab, b1, 0), (fptab2, c1, nb1), (fptab2, c2, nb1)):
        row = tab[bucket]
        s = np.full((b, 32), -1)
        for i in range(7, -1, -1):  # bucket_match: the first match wins
            half = (row[..., i & 3] >> np.uint32(16 * (i >> 2))) & np.uint32(0xFFFF)
            s = np.where(half == fp, i, s)
        valid.append(live & (s >= 0))
        slot.append((base + bucket.astype(np.int64)) * 8 + np.maximum(s, 0))
    valid[2] &= c2 != c1

    below = (np.uint32(1) << _LANES) - np.uint32(1)
    ballots = [np.bitwise_or.reduce(v.astype(np.uint32) << _LANES, axis=1) for v in valid]
    r = sum(np.bitwise_count(bal[:, None] & below) for bal in ballots).astype(np.int64)
    ncand = sum(np.bitwise_count(bal) for bal in ballots).astype(np.int64)
    out = {f: np.zeros((b, mh), np.int64) for f in ("cand", "tin", "tout", "depth", "t")}
    out["ver"] = np.zeros((b, mh), bool)
    best = np.zeros((b, 32), np.int64)
    best_cand, best_tin, best_t = (np.zeros((b, 32), np.int64) for _ in range(3))
    nh = np.zeros(b, np.int64)
    hits = []  # (ver, tin, tout) per plane, for the consistency test
    n_nodes = len(tinfo)
    for q in range(3):
        rank = r.copy()
        r = r + valid[q]
        placed = valid[q] & (rank < mh)
        w = rec[np.where(placed, slot[q], 0)]
        ver = placed & (w[..., 0] == hi) & (w[..., 1] == lo)
        tin = (w[..., 2] & np.uint32(0xFFFFFF)).astype(np.int64)
        dep = (w[..., 2] >> np.uint32(24)).astype(np.int64)
        known = ver & (tin < n_nodes)
        info = tinfo[np.where(known, tin, 0)]
        node, tout = np.where(known, info[..., 0], 0), np.where(known, info[..., 1], 0)
        rows, lanes = np.nonzero(placed)
        o = rank[rows, lanes]
        for f, v in (("cand", slot[q]), ("ver", ver), ("tin", tin), ("depth", dep),
                     ("tout", tout), ("t", node)):
            out[f][rows, o] = v[rows, lanes]
        key = np.where(placed, (np.where(ver, dep + 1, 0) << 6) | (63 - rank), 0)
        up = key > best
        best = np.where(up, key, best)
        best_cand = np.where(up, slot[q], best_cand)
        best_tin = np.where(up, tin, best_tin)
        best_t = np.where(up, node, best_t)
        nh += ver.sum(axis=1)
        hits.append((ver, tin, tout))
    top = best.max(axis=1)
    src = np.argmax(best == top[:, None], axis=1)  # __ffs of the ballot
    pick = lambda a: np.where(top > 0, a[np.arange(b), src], 0)  # noqa: E731
    dtin = pick(best_tin)[:, None]
    ok = np.ones((b, 32), bool)
    for ver, tin, tout in hits:
        ok &= ~ver | ((tin <= dtin) & (dtin <= tout))
    out.update(nh=nh, deepest=pick(best_cand), dtgt=pick(best_t), consistent=ok.all(axis=1),
               overflow=ncand > mh)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("max_hits", [8, 32])
@pytest.mark.parametrize("world", WORLDS)
def test_kernel_model_matches_plain(base, world, max_hits):
    _, fpdb, tinfo = base
    tdb, crafted, wpos, whi, wlo = _world(base, 3 * max_hits + len(world), world)
    salts = (fpdb.s1, fpdb.s2, fpdb.s3, fpdb.s4, fpdb.s5)
    got = _model_probe(crafted, tinfo, salts, wpos, whi, wlo, max_hits)
    want = _widened(probe_verify_plain(tdb, *_windows(wpos, whi, wlo), max_hits))
    bad, _ = probe_mismatch(got, want, fpdb.n_slots)
    assert not bad, bad
    assert sorted(got) == sorted(PROBE_FIELDS)


def test_dispatch_on_cpu_uses_the_plain_version(base):
    _, fpdb, _ = base
    tdb, _, wpos, whi, wlo = _world(base, 2, "mixed", b=40)
    windows = _windows(wpos, whi, wlo)
    before = probe_verify_cuda.launches.value
    seen_a, seen_b = _seen(fpdb.n_slots), _seen(fpdb.n_slots)
    got = probe_verify(tdb, *windows, 32, seen_a)
    want = probe_verify_plain(tdb, *windows, 32, seen_b)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(seen_a, seen_b)
    assert probe_verify_cuda.launches.value == before
    with pytest.raises(ValueError, match="CUDA"):
        probe_verify_cuda(tdb, *windows, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,max_hits", [(8192, 32), (2048, 8), (2048, 32), (37, 32), (64, 1)])
@pytest.mark.parametrize("world", WORLDS)
def test_kernel_matches_plain_on_card(base, world, b, max_hits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    _, fpdb, _ = base
    tdb, _, wpos, whi, wlo = _world(base, b + max_hits, world, b=b, device="cuda")
    windows = _windows(wpos, whi, wlo, "cuda")
    seen_k, seen_p = _seen(fpdb.n_slots, "cuda"), _seen(fpdb.n_slots, "cuda")
    before = probe_verify_cuda.launches.value
    got = probe_verify(tdb, *windows, max_hits, seen_k)
    assert probe_verify_cuda.launches.value == before + 1
    want = probe_verify_plain(tdb, *windows, max_hits, seen_p)
    torch.cuda.synchronize()
    bad, _ = probe_mismatch(got, want, fpdb.n_slots, (seen_k, seen_p))
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("max_hits", [0, 33])
def test_classifier_refuses_a_budget_the_kernel_cannot_rank_on_card(max_hits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the budget limit is the kernel's")
    packed, tax, *_ = toy_world(num_probes=3000, num_targ=64, batch=8, max_len=64)
    with pytest.raises(ValueError, match=f"max_hits {max_hits} outside"):
        FpClassifier(packed, tax, max_hits=max_hits, device="cuda")
