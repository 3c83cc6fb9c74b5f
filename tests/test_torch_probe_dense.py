"""The every-window pass of probe + verify (ops/probe.py
``probe_verify_dense_*`` and ``probe_hits_dense_*``: csrc/probe.cu's probe
pass from extract's planes) on the CPU.

* The engine's callers against the JAX package: the port's
  ``_compact_verify`` against JAX's ``_compact_verify`` (its Bloom gate's
  ``compact_auto`` as ``compact_ranks_pallas`` in interpret mode) on a batch
  that flips to the dense path (reads past ``BLOOM_K`` passing windows) and
  on a DB without a Bloom filter (the ``_tiered`` branch, its fast tier on a
  batch of sparse reads and its full tier on the dense batch), at 131 and
  483 windows per read (max_len 160 and 512), ``max_hits`` 8, 12 and 32,
  with and without ``seen``; and the shard mode's every-window form against
  JAX's ``local_hits`` without a filter (tests/test_torch_probe_hits.py's
  composition of its probes, the interpret-mode Pallas compaction at
  fpsharded.py:324 and the verify, given every window at its column) at
  dbp 1, 2 and 4.
* The slots mode (``probe_slots_*``: every window's verified slot and rec
  tin, the exact replay) against JAX's ``fp_slots``, and on a grid rank's
  tables against the unsharded slots mapped to local ids.
* A numpy model of the kernel's own arithmetic (csrc/probe.cu's
  every-window pass: 32-window tiles, the running base carried across them,
  the placed candidates staged by rank, the verify entry's stop after the
  tile where the count passes the budget, the shard entry's count of every
  candidate, the final lane-per-column reductions) against the plain
  versions, on rows of 0, 1, ``mh``, ``mh + 1`` and every window's
  candidates, at P not a multiple of 32, with DB keys repeated across tiles;
  and of its slots mode (the last plane that verifies).
* The kernel against the plain versions at the engine's shapes, and its
  refusals, on the card only (marked ``cuda``; skips elsewhere).

Comparison: as tests/test_torch_probe.py (every output bit for bit, ``tin``,
``tout`` and ``depth`` only where ``ver``; the shard outputs all bit for bit;
``seen`` over the slot ids).

The JAX package is imported only inside the tests that use it:
``pytest --noconftest -m cuda tests/test_torch_probe_dense.py`` runs the card
tests where only PyTorch is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (
    craft_tables,
    dense_kinds,
    dense_windows,
    hits_mismatch,
    probe_mismatch,
    probe_tables,
    shard_cut,
    shard_probe_tables,
    toy_world,
)
from kmer_id_tpu_torch.db.fpdb import build_fpdb, build_tinfo
from kmer_id_tpu_torch.engine.fpclassify import FpClassifier, _compact_verify, device_tables
from kmer_id_tpu_torch.ops.compact import SENT
from kmer_id_tpu_torch.ops.gate import BLOOM_K, ReadPlanes
from kmer_id_tpu_torch.ops.probe import (
    FAST_HITS,
    probe_hits_dense,
    probe_hits_dense_cuda,
    probe_hits_dense_plain,
    probe_slots,
    probe_slots_cuda,
    probe_slots_plain,
    probe_verify_dense,
    probe_verify_dense_cuda,
    probe_verify_dense_plain,
)
from test_torch_probe_hits import _jax_local_hits, _match, _mix

B = 96
WORLDS = ["mixed", "saturated", "background"]


@pytest.fixture(scope="module")
def base():
    """(sorted DB keys, FpDB, tinfo) of a 3,000-probe toy DB."""
    packed, tax, *_ = toy_world(num_probes=3000, num_targ=64, batch=8, max_len=64)
    return packed.keys, build_fpdb(packed, tax), build_tinfo(tax)


def _world(base, seed, world, p, mh, b=B):
    """(crafted numpy tables, hi, lo, valid numpy) of an every-window world."""
    keys, fpdb, tinfo = base
    rng = np.random.default_rng(seed)
    hi, lo, valid, plants = dense_windows(rng, keys, b, p, dense_kinds(rng, b, world), mh)
    return craft_tables(rng, fpdb, len(tinfo), plants), hi, lo, valid


def _planes(hi, lo, valid, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (hi.view(np.int32), lo.view(np.int32), valid))


def _seen(n_slots, device="cpu"):
    return torch.zeros(n_slots + 1, dtype=torch.int8, device=device)


def _widened(cv: dict) -> dict:
    return {k: v if v.dtype == torch.bool else v.long() for k, v in cv.items()}


def _rank(fpdb, dbp, k):
    """(b0, nbloc, own2, local slot count) of db rank ``k``."""
    nbloc = len(fpdb.fptab) // dbp
    return k * nbloc, nbloc, k == 0, (nbloc + len(fpdb.fptab2)) * 8


# ----------------------------------------------- numpy model of the pass

_LANES = np.arange(32)


def _model_dense(tabs, tinfo, salts, hi, lo, valid, mh, shard=None):
    """The every-window pass's outputs as its arithmetic computes them (warp
    lanes as a [B, 32] axis, one 32-window tile at a time), and its seen
    marks.  ``shard`` None models the verify entry; (nb1, b0, nbloc, own2)
    the shard entry on that rank's tables."""
    fptab, fptab2, rec = tabs["fptab"], tabs["fptab2"], tabs["rec"]
    nb2 = len(fptab2)
    nb1, b0, nbloc, own2 = shard if shard is not None else (len(fptab), 0, len(fptab), True)
    s1, s2, s3, s4, s5 = salts
    b, p = hi.shape
    n_nodes = len(tinfo)
    fields = ("cand", "ver", "tin", "f3", "f4", "node")  # the kernel's staged fields
    st = {f: np.zeros((b, 32), np.int64) for f in fields}
    seen = np.zeros((nbloc + nb2) * 8, np.int8)
    base = np.zeros(b, np.int64)
    going = np.ones(b, bool)  # the verify entry stops a read past the budget
    for w0 in range(0, p, 32):
        cols = w0 + _LANES
        inside = cols < p
        cc = np.minimum(cols, p - 1)
        live = valid[:, cc] & inside & going[:, None]
        h = np.where(inside, hi[:, cc], 0).astype(np.uint32)
        l = np.where(inside, lo[:, cc], 0).astype(np.uint32)
        bl = (_mix(h, l, s1, s2) & np.uint32(nb1 - 1)) - np.uint32(b0)
        m = _mix(h ^ np.uint32(0x6A09E667), l, s3, s1)
        fp = (m ^ (m >> np.uint32(16))) & np.uint32(0xFFFF)
        fp[fp == 0] = 1
        c1 = _mix(h, l, s4, s5) & np.uint32(nb2 - 1)
        c2 = _mix(l, h, s5, s4) & np.uint32(nb2 - 1)
        l1 = live & (bl < np.uint32(nbloc))
        l2 = live & own2
        valid_q, slot_q = [], []
        for tab, bucket, on, off in ((fptab, bl, l1, 0), (fptab2, c1, l2, nbloc),
                                     (fptab2, c2, l2, nbloc)):
            row = np.where(on[..., None], tab[np.where(on, bucket, 0)], 0)
            s = _match(row, fp)
            valid_q.append(on & (s >= 0))
            slot_q.append((off + bucket.astype(np.int64)) * 8 + np.maximum(s, 0))
        valid_q[2] &= c2 != c1
        cnt = sum(v.astype(np.int64) for v in valid_q)
        r = base[:, None] + np.cumsum(cnt, axis=1) - cnt  # popcounts of the lower lanes
        for q in range(3):
            rank = r.copy()
            r = r + valid_q[q]
            placed = valid_q[q] & (rank < mh)
            w = rec[np.where(placed, slot_q[q], 0)]
            ver = placed & (w[..., 0] == h) & (w[..., 1] == l)
            tin = (w[..., 2] & np.uint32(0xFFFFFF)).astype(np.int64)
            known = ver & (tin < n_nodes)
            info = tinfo[np.where(known, tin, 0)]
            node, tout = np.where(known, info[..., 0], 0), np.where(known, info[..., 1], 0)
            if shard is None:
                f2, f3, f4 = tin, (w[..., 2] >> np.uint32(24)).astype(np.int64), tout
            else:
                f2 = np.where(ver, tin, 0)
                f3 = np.where(ver, cols[None, :], SENT)
                td = (tout.astype(np.int64) & 0xFFFFFF) | (w[..., 2].astype(np.int64) & 0xFF000000)
                f4 = np.where(ver, td.astype(np.uint32).view(np.int32), 0)
            rows, lanes = np.nonzero(placed)
            o = rank[rows, lanes]
            for f, v in zip(fields, (slot_q[q], ver, f2, f3, f4, node)):
                st[f][rows, o] = np.broadcast_to(v, placed.shape)[rows, lanes]
            seen[slot_q[q][ver]] = 1
        base += np.where(going, cnt.sum(axis=1), 0)
        if shard is None:
            going &= base <= mh
    have = _LANES[None, :] < np.minimum(base, mh)[:, None]
    v = {f: np.where(have, st[f], 0) for f in fields}
    out = {"cand": v["cand"][:, :mh], "ver": v["ver"][:, :mh].astype(bool)}
    if shard is not None:
        out.update(posk=np.where(have, st["f3"], SENT)[:, :mh], tin=v["tin"][:, :mh],
                   td=v["f4"][:, :mh], tgt=v["node"][:, :mh], ncand=base)
        return {k: torch.from_numpy(np.asarray(x)) for k, x in out.items()}, seen
    ver = v["ver"].astype(bool)
    key = np.where(have, (np.where(ver, v["f3"] + 1, 0) << 6) | (63 - _LANES), 0)
    top = key.max(axis=1)
    src = np.argmax(key == top[:, None], axis=1)  # __ffs of the ballot
    pick = lambda a: np.where(top > 0, a[np.arange(b), src], 0)  # noqa: E731
    dtin = pick(v["tin"])[:, None]
    out.update(tin=v["tin"][:, :mh], depth=v["f3"][:, :mh], tout=v["f4"][:, :mh],
               t=v["node"][:, :mh], nh=ver.sum(axis=1), deepest=pick(v["cand"]),
               dtgt=pick(v["node"]),
               consistent=(~ver | ((v["tin"] <= dtin) & (dtin <= v["f4"]))).all(axis=1),
               overflow=base > mh)
    return {k: torch.from_numpy(np.asarray(x)) for k, x in out.items()}, seen


def _salts(fpdb):
    return (fpdb.s1, fpdb.s2, fpdb.s3, fpdb.s4, fpdb.s5)


@pytest.mark.parametrize("mh", [8, 12, 32])
@pytest.mark.parametrize("p", [20, 64, 131, 483])
@pytest.mark.parametrize("world", ["mixed", "saturated"])
def test_kernel_model_matches_plain(base, world, p, mh):
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, 7 * p + mh, world, p, mh)
    db = probe_tables(fpdb, crafted, tinfo, "cpu")
    seen = _seen(fpdb.n_slots)
    want = probe_verify_dense_plain(db, *_planes(hi, lo, valid), mh, seen)
    got, mseen = _model_dense(crafted, tinfo, _salts(fpdb), hi, lo, valid, mh)
    bad, _ = probe_mismatch(got, _widened(want), fpdb.n_slots,
                            (torch.from_numpy(mseen).long(), seen.long()))
    assert not bad, bad
    # the rows the pass must get right are in the world
    ncand = _ncand(db, hi, lo, valid)
    for n in (0, 1, mh, mh + 1):
        assert (ncand == n).any(), n
    assert bool(want["overflow"].any()) and int(want["nh"].sum()) > 0
    if world == "saturated":  # rows with every window valid and a candidate per window
        assert (valid.all(axis=1) & (ncand >= p)).any()
    else:  # a slot placed twice: a DB key repeated in two tiles
        cand = torch.where(want["ver"], want["cand"], -1).sort(dim=1).values
        assert bool(((cand[:, 1:] == cand[:, :-1]) & (cand[:, 1:] >= 0)).any())


def _ncand(db, hi, lo, valid):
    from kmer_id_tpu_torch.ops.compact import interleave_planes
    from kmer_id_tpu_torch.ops.lookup import fp_candidates

    return interleave_planes(fp_candidates(db, *_planes(hi, lo, valid)))[1].sum(dim=1).numpy()


@pytest.mark.parametrize("p", [20, 131, 483])
@pytest.mark.parametrize("dbp,k", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_shard_model_matches_plain(base, dbp, k, p):
    _, fpdb, tinfo = base
    sh = 8
    crafted, hi, lo, valid = _world(base, 31 * dbp + k + p, "saturated", p, sh)
    b0, nbloc, own2, n_slots = _rank(fpdb, dbp, k)
    seen = _seen(n_slots)
    want = probe_hits_dense_plain(shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cpu"),
                                  *_planes(hi, lo, valid), sh, b0, nbloc, own2, seen)
    got, mseen = _model_dense(shard_cut(crafted, dbp, k), tinfo, _salts(fpdb), hi, lo, valid,
                              sh, (len(fpdb.fptab), b0, nbloc, own2))
    bad, _ = hits_mismatch(got, want, n_slots, (torch.from_numpy(mseen), seen))
    assert not bad, bad
    assert int(want["ver"].sum()) > 0
    if own2 or p >= 131:  # enough of the rank's candidates for rows past the budget
        assert bool((want["ncand"] > sh).any())


def _model_slots(tabs, salts, hi, lo, valid, shard=None):
    """The slots mode's outputs as its arithmetic computes them (one thread
    per window): (slot, tin) int64 [B, P]."""
    fptab, fptab2, rec = tabs["fptab"], tabs["fptab2"], tabs["rec"]
    nb2 = len(fptab2)
    nb1, b0, nbloc, own2 = shard if shard is not None else (len(fptab), 0, len(fptab), True)
    s1, s2, s3, s4, s5 = salts
    h, l = hi.astype(np.uint32), lo.astype(np.uint32)
    bl = (_mix(h, l, s1, s2) & np.uint32(nb1 - 1)) - np.uint32(b0)
    m = _mix(h ^ np.uint32(0x6A09E667), l, s3, s1)
    fp = (m ^ (m >> np.uint32(16))) & np.uint32(0xFFFF)
    fp[fp == 0] = 1
    c1 = _mix(h, l, s4, s5) & np.uint32(nb2 - 1)
    c2 = _mix(l, h, s5, s4) & np.uint32(nb2 - 1)
    l1, l2 = valid & (bl < np.uint32(nbloc)), valid & own2
    slot, tin = np.full(hi.shape, -1, np.int64), np.zeros(hi.shape, np.int64)
    for q, (tab, bucket, on, off) in enumerate(((fptab, bl, l1, 0), (fptab2, c1, l2, nbloc),
                                                (fptab2, c2, l2, nbloc))):
        row = np.where(on[..., None], tab[np.where(on, bucket, 0)], 0)
        s = _match(row, fp)
        cand = on & (s >= 0) & ((c2 != c1) if q == 2 else True)
        sl = (off + bucket.astype(np.int64)) * 8 + np.maximum(s, 0)
        w = rec[np.where(cand, sl, 0)]
        ok = cand & (w[..., 0] == h) & (w[..., 1] == l)
        slot = np.where(ok, sl, slot)
        tin = np.where(ok, w[..., 2] & np.uint32(0xFFFFFF), tin)
    return slot, tin


@pytest.mark.parametrize("dbp,k", [(1, 0), (2, 0), (2, 1), (4, 3)])
@pytest.mark.parametrize("p", [20, 131])
def test_slots_model_matches_plain(base, p, dbp, k):
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, 3 * p + dbp + k, "mixed", p, 8)
    planes = _planes(hi, lo, valid)
    if dbp == 1:
        want = probe_slots_plain(probe_tables(fpdb, crafted, tinfo, "cpu"), *planes)
        got = _model_slots(crafted, _salts(fpdb), hi, lo, valid)
    else:
        b0, nbloc, own2, _ = _rank(fpdb, dbp, k)
        want = probe_slots_plain(shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cpu"),
                                 *planes, (b0, nbloc, own2))
        got = _model_slots(shard_cut(crafted, dbp, k), _salts(fpdb), hi, lo, valid,
                           (len(fpdb.fptab), b0, nbloc, own2))
    assert np.array_equal(got[0], want[0].numpy()) and np.array_equal(got[1], want[1].numpy())
    assert int((want[0] >= 0).sum()) > 0


@pytest.mark.parametrize("dbp,k", [(2, 0), (2, 1), (4, 3)])
def test_shard_slots_are_the_ranks_part(base, dbp, k):
    """A rank's slots are the unsharded slots it owns, in local ids: L1
    slots of its bucket range, L2 slots on db rank 0."""
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, 11 * dbp + k, "mixed", 131, 8)
    planes = _planes(hi, lo, valid)
    full, ftin = probe_slots_plain(probe_tables(fpdb, crafted, tinfo, "cpu"), *planes)
    b0, nbloc, own2, _ = _rank(fpdb, dbp, k)
    loc, ltin = probe_slots_plain(shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cpu"),
                                  *planes, (b0, nbloc, own2))
    nb1 = len(fpdb.fptab)
    l1 = (full >= b0 * 8) & (full < (b0 + nbloc) * 8)
    l2 = (full >= nb1 * 8) & own2
    want = torch.where(l1, full - b0 * 8, torch.where(l2, full - (nb1 - nbloc) * 8, -1))
    assert torch.equal(loc, want) and torch.equal(ltin, torch.where(l1 | l2, ftin, 0))


def test_slots_plain_matches_jax(reads_world):
    """probe_slots_plain is JAX's ``fp_slots`` on the dense batch."""
    import jax.numpy as jnp

    from kmer_id_tpu.engine.fpclassify import fp_slots as jax_fp_slots
    from kmer_id_tpu.ops.extract import extract_kmers

    from kmer_id_tpu_torch.ops.gate import extract

    for max_len, (packed, tax, fpdb, batches) in reads_world.items():
        codes, lengths = batches["dense"]
        db = device_tables(fpdb, tax, "cpu")
        jdb = {k: jnp.asarray(getattr(fpdb, k)) for k in ("fptab", "fptab2", "rec")}
        for i, s in enumerate(_salts(fpdb)):
            jdb[f"fp_s{i + 1}"] = jnp.uint32(s)
        want = np.asarray(jax_fp_slots(jdb, extract_kmers(jnp.asarray(codes),
                                                          jnp.asarray(lengths))))
        ex = extract(ReadPlanes(torch.from_numpy(lengths), max_len,
                                codes=torch.from_numpy(codes)))
        got = probe_slots_plain(db, ex["hi"], ex["lo"], ex["valid"])[0]
        assert np.array_equal(got.numpy(), want) and (want >= 0).sum() > max_len


# ----------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def reads_world():
    """Per max_len: (packed DB, taxonomy, FpDB, {batch name: (codes,
    lengths)}): "dense" holds two reads copied from the DB's genome (a
    probe at every window), "sparse" the same rows with those two random."""
    out = {}
    for max_len in (160, 512):
        b = 48 if max_len == 512 else B
        packed, tax, codes, lengths, _ = toy_world(num_probes=20_000, num_targ=64, batch=b,
                                                   max_len=max_len, dense_rows=(5, b - 3))
        sparse = codes.copy()
        sparse[[5, b - 3]] = np.random.default_rng(1).integers(0, 4, size=(2, max_len),
                                                               dtype=np.uint8)
        out[max_len] = (packed, tax, build_fpdb(packed, tax),
                        {"dense": (codes, lengths), "sparse": (sparse, lengths)})
    return out


def _jax_compact_verify(fpdb, tax, codes, lengths, mh, with_seen, monkeypatch):
    """JAX's ``_compact_verify`` on the tables of ``fpdb`` (its Bloom gate's
    compaction by the Pallas kernel in interpret mode): the per-read dict as
    torch tensors, and ``seen`` or None."""
    import functools

    import jax.numpy as jnp

    import kmer_id_tpu.ops.compact as jcompact
    from kmer_id_tpu.engine.fpclassify import _compact_verify as jax_compact_verify
    from kmer_id_tpu.ops.extract import extract_kmers

    monkeypatch.setattr(jcompact, "compact_auto",
                        functools.partial(jcompact.compact_ranks_pallas, interpret=True))
    jdb = {k: jnp.asarray(getattr(fpdb, k)) for k in ("fptab", "fptab2", "rec")}
    jdb["tinfo"] = jnp.asarray(build_tinfo(tax))
    if fpdb.bloom is not None:
        jdb["bloom"] = jnp.asarray(fpdb.bloom)
    for i, s in enumerate(_salts(fpdb)):
        jdb[f"fp_s{i + 1}"] = jnp.uint32(s)
    ex = extract_kmers(jnp.asarray(codes), jnp.asarray(lengths))
    seen = jnp.zeros(fpdb.n_slots, jnp.int8) if with_seen else None
    res = jax_compact_verify(jdb, ex, mh, seen)
    out, seen = res if with_seen else (res, None)
    got = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in out.items()}
    for k in ("ver", "consistent", "overflow"):
        got[k] = got[k].bool()
    return got, None if seen is None else torch.from_numpy(np.array(seen))


CASES = [(max_len, mh, with_seen) for max_len in (160, 512) for mh, with_seen in
         ((8, True), (12, False), (32, True), (32, False))]


@pytest.mark.parametrize("max_len,mh,with_seen", CASES)
@pytest.mark.parametrize("path", ["dense", "nobloom_full", "nobloom_fast"])
def test_compact_verify_matches_jax(reads_world, monkeypatch, path, max_len, mh, with_seen):
    packed, tax, fpdb, batches = reads_world[max_len]
    if path != "dense":
        fpdb = dataclasses.replace(fpdb, bloom=None)
    codes, lengths = batches["sparse" if path == "nobloom_fast" else "dense"]
    db = device_tables(fpdb, tax, "cpu")
    assert ("bloom" in db) == (path == "dense")
    reads = ReadPlanes(torch.from_numpy(lengths), max_len, codes=torch.from_numpy(codes))
    seen = _seen(fpdb.n_slots) if with_seen else None
    got = _compact_verify(db, reads, mh, seen)
    want, jseen = _jax_compact_verify(fpdb, tax, codes, lengths, mh, with_seen, monkeypatch)
    pair = None if seen is None else (seen.long(), jseen.long())
    bad, _ = probe_mismatch(_widened(got), want, fpdb.n_slots, pair)
    assert not bad, bad
    assert int(got["nh"].sum()) > 0
    assert bool(got["overflow"].any()) == (path != "nobloom_fast" and mh < max_len - 29)
    if path == "nobloom_fast":  # the fast tier: no read past FAST_HITS candidates
        assert not bool(got["overflow"].any()) and int(got["nh"].max()) <= FAST_HITS


def test_dense_batch_takes_the_dense_path(reads_world):
    """The dense batch's reads pass more Bloom windows than BLOOM_K (JAX's
    ``dense_path``), the sparse batch's do not."""
    from kmer_id_tpu_torch.ops.gate import window_gate

    for max_len, (packed, tax, fpdb, batches) in reads_world.items():
        db = device_tables(fpdb, tax, "cpu")
        for name, (codes, lengths) in batches.items():
            reads = ReadPlanes(torch.from_numpy(lengths), max_len, codes=torch.from_numpy(codes))
            npass = window_gate(db, reads)[3]
            assert (int(npass.max()) > BLOOM_K) == (name == "dense"), (max_len, name)


@pytest.mark.parametrize("dbp,k", [(1, 0), (2, 0), (2, 1), (4, 0), (4, 3)])
def test_shard_plain_matches_jax(base, dbp, k):
    _, fpdb, tinfo = base
    sh, p = 8, 131
    crafted, hi, lo, valid = _world(base, 5 * dbp + k, "saturated", p, sh, b=64)
    b0, nbloc, own2, n_slots = _rank(fpdb, dbp, k)
    seen = _seen(n_slots)
    got = probe_hits_dense_plain(shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cpu"),
                                 *_planes(hi, lo, valid), sh, b0, nbloc, own2, seen)
    # local_hits without a filter takes every window, at its column
    wpos = np.where(valid, np.arange(p, dtype=np.int32)[None], SENT)
    want, jseen = _jax_local_hits(fpdb, shard_cut(crafted, dbp, k), tinfo, dbp, k, wpos, hi, lo,
                                  sh)
    bad, _ = hits_mismatch(got, want, n_slots, (seen, jseen))
    assert not bad, bad
    assert int(got["ver"].sum()) > 0 and bool((got["ncand"] > sh).any())


# ----------------------------------------------------------- dispatch


def test_dispatch_on_cpu_uses_the_plain_versions(base):
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, 2, "mixed", 131, 32, b=40)
    planes = _planes(hi, lo, valid)
    db = probe_tables(fpdb, crafted, tinfo, "cpu")
    before = probe_verify_dense_cuda.launches.value, probe_hits_dense_cuda.launches.value
    for tiered in (False, True):
        seen_a, seen_b = _seen(fpdb.n_slots), _seen(fpdb.n_slots)
        got = probe_verify_dense(db, *planes, 32, seen_a, tiered=tiered)
        want = probe_verify_dense_plain(db, *planes, 32, seen_b, tiered=tiered)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert torch.equal(seen_a, seen_b)
    b0, nbloc, own2, n_slots = _rank(fpdb, 2, 0)
    sdb = shard_probe_tables(fpdb, crafted, tinfo, 2, 0, "cpu")
    seen_a, seen_b = _seen(n_slots), _seen(n_slots)
    got = probe_hits_dense(sdb, *planes, 8, b0, nbloc, own2, seen_a)
    want = probe_hits_dense_plain(sdb, *planes, 8, b0, nbloc, own2, seen_b)
    assert all(torch.equal(got[k], want[k]) for k in want) and torch.equal(seen_a, seen_b)
    for t, shard in ((db, None), (sdb, (b0, nbloc, own2))):
        got, want = probe_slots(t, *planes, shard), probe_slots_plain(t, *planes, shard)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (probe_verify_dense_cuda.launches.value, probe_hits_dense_cuda.launches.value) == before
    assert probe_slots_cuda.launches.value == 0
    with pytest.raises(ValueError, match="CUDA"):
        probe_verify_dense_cuda(db, *planes, 32)
    with pytest.raises(ValueError, match="CUDA"):
        probe_hits_dense_cuda(sdb, *planes, 8, b0, nbloc, own2)
    with pytest.raises(ValueError, match="CUDA"):
        probe_slots_cuda(db, *planes)


# ------------------------------------------------------------- the card

CARD_SHAPES = [(8192, 131, 32), (2048, 483, 8), (2048, 483, 32), (37, 1, 32), (64, 33, 1),
               (100, 64, 12)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,mh", CARD_SHAPES)
@pytest.mark.parametrize("world", WORLDS)
def test_kernel_matches_plain_on_card(base, world, b, p, mh):
    _needs_card()
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, b + p + mh, world, p, mh, b=b)
    db = probe_tables(fpdb, crafted, tinfo, "cuda")
    planes = _planes(hi, lo, valid, "cuda")
    seen_k, seen_p = _seen(fpdb.n_slots, "cuda"), _seen(fpdb.n_slots, "cuda")
    before = probe_verify_dense_cuda.launches.value
    got = probe_verify_dense(db, *planes, mh, seen_k)
    assert probe_verify_dense_cuda.launches.value == before + 1
    want = probe_verify_dense_plain(db, *planes, mh, seen_p)
    torch.cuda.synchronize()
    bad, _ = probe_mismatch(got, want, fpdb.n_slots, (seen_k, seen_p))
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("b,p", [(8192, 131), (2048, 483), (37, 20)])
@pytest.mark.parametrize("dbp,k", [(2, 0), (2, 1), (4, 3)])
def test_shard_kernel_matches_plain_on_card(base, dbp, k, b, p):
    _needs_card()
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, b + p + dbp + k, "mixed", p, 8, b=b)
    b0, nbloc, own2, n_slots = _rank(fpdb, dbp, k)
    db = shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cuda")
    planes = _planes(hi, lo, valid, "cuda")
    seen_k, seen_p = _seen(n_slots, "cuda"), _seen(n_slots, "cuda")
    before = probe_hits_dense_cuda.launches.value
    got = probe_hits_dense(db, *planes, 8, b0, nbloc, own2, seen_k)
    assert probe_hits_dense_cuda.launches.value == before + 1
    want = probe_hits_dense_plain(db, *planes, 8, b0, nbloc, own2, seen_p)
    torch.cuda.synchronize()
    bad, _ = hits_mismatch(got, want, n_slots, (seen_k, seen_p))
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("b,p", [(8192, 131), (2048, 483), (37, 1)])
@pytest.mark.parametrize("dbp,k", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_slots_kernel_matches_plain_on_card(base, dbp, k, b, p):
    _needs_card()
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, b + p + 3 * dbp + k, "mixed", p, 8, b=b)
    if dbp == 1:
        db, shard = probe_tables(fpdb, crafted, tinfo, "cuda"), None
    else:
        b0, nbloc, own2, _ = _rank(fpdb, dbp, k)
        db, shard = shard_probe_tables(fpdb, crafted, tinfo, dbp, k, "cuda"), (b0, nbloc, own2)
    planes = _planes(hi, lo, valid, "cuda")
    before = probe_slots_cuda.launches.value
    got = probe_slots(db, *planes, shard)
    assert probe_slots_cuda.launches.value == before + 1
    want = probe_slots_plain(db, *planes, shard)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take_on_card(base):
    _needs_card()
    _, fpdb, tinfo = base
    crafted, hi, lo, valid = _world(base, 9, "mixed", 131, 32, b=16)
    db = probe_tables(fpdb, crafted, tinfo, "cuda")
    hi_t, lo_t, valid_t = _planes(hi, lo, valid, "cuda")
    b0, nbloc, own2, _ = _rank(fpdb, 2, 1)
    sdb = shard_probe_tables(fpdb, crafted, tinfo, 2, 1, "cuda")
    for mh in (0, 33):
        with pytest.raises(ValueError, match="outside"):
            probe_verify_dense_cuda(db, hi_t, lo_t, valid_t, mh)
        with pytest.raises(ValueError, match="outside"):
            probe_hits_dense_cuda(sdb, hi_t, lo_t, valid_t, mh, b0, nbloc, own2)
    with pytest.raises(TypeError, match="valid"):
        probe_verify_dense_cuda(db, hi_t, lo_t, valid_t.to(torch.int32), 32)
    with pytest.raises(ValueError, match="shape"):
        probe_verify_dense_cuda(db, hi_t, lo_t[:, :-1].contiguous(), valid_t, 32)
    with pytest.raises(ValueError, match="contiguous"):
        probe_verify_dense_cuda(db, hi_t.t().contiguous().t(), lo_t, valid_t, 32)
    with pytest.raises(ValueError, match="outside"):
        probe_hits_dense_cuda(sdb, hi_t, lo_t, valid_t, 8, b0 + 1, nbloc, own2)
    with pytest.raises(ValueError, match="P >= 1"):
        probe_verify_dense_cuda(db, hi_t[:, :0], lo_t[:, :0], valid_t[:, :0], 32)
    with pytest.raises(ValueError, match="outside"):
        probe_slots_cuda(sdb, hi_t, lo_t, valid_t, (b0 + 1, nbloc, own2))
    with pytest.raises(TypeError, match="lo"):
        probe_slots_cuda(db, hi_t, lo_t.to(torch.int64), valid_t)


@pytest.mark.cuda
@pytest.mark.parametrize("max_hits", [0, 33])
def test_classifier_without_bloom_refuses_a_budget_on_card(max_hits):
    _needs_card()
    packed, tax, *_ = toy_world(num_probes=3000, num_targ=64, batch=8, max_len=64)
    fpdb = dataclasses.replace(build_fpdb(packed, tax), bloom=None)
    with pytest.raises(ValueError, match=f"max_hits {max_hits} outside"):
        FpClassifier(packed, tax, max_hits=max_hits, fpdb=fpdb, device="cuda")
