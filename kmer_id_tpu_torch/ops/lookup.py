"""Probe-DB lookups: the fingerprint tables, the cuckoo table and the
sorted key array.

Ports of ``kmer_id_tpu/ops/lookup.py``:

* the fingerprint engine's ``_fp_mix``, ``fp_hashes_jnp``,
  ``bloom_hashes_jnp``, ``bloom_pass``, ``_fp_bucket_match`` and
  ``fp_candidates`` (table layout in ``kmer_id_tpu/db/fpdb.py``);
* the legacy engine's ``_mix32``/``cuckoo_lookup`` (two 64-byte bucket rows
  per key, layout in db/cuckoo.py) and ``_less2``/``searchsorted2``/
  ``lookup_keys`` (a fixed-step lower-bound bisection over the sorted keys,
  optionally within a first-level bucket range).

Key words and table rows are int32 bit patterns (ops/words.py); hashes and
unsigned comparisons are formed on int64 values in [0, 2^32).
"""

from __future__ import annotations

import math

import torch

from kmer_id_tpu_torch.db.fpdb import BLOOM_BITS
from kmer_id_tpu_torch.ops.words import mul32, widen


def _fp_mix(a, b, s1: int, s2: int):
    x = a ^ mul32(b, s1)
    x = x ^ (x >> 15)
    x = mul32(x, 0x2C1B3C6D)
    x = x ^ (x >> 12)
    x = mul32(x, s2)
    return x ^ (x >> 16)


def fp_hashes(q_hi, q_lo, nb: int, s1: int, s2: int, s3: int):
    """(bucket1, bucket2, fingerprint) as int64, bit-identical to
    ``kmer_id_tpu.db.fpdb.fp_hashes``."""
    hi, lo = widen(q_hi), widen(q_lo)
    b1 = _fp_mix(hi, lo, s1, s2) & (nb - 1)
    b2 = _fp_mix(lo, hi, s2, s1) & (nb - 1)
    m = _fp_mix(hi ^ 0x6A09E667, lo, s3, s1)
    fp = (m ^ (m >> 16)) & 0xFFFF
    return b1, b2, fp.masked_fill(fp == 0, 1)


def bloom_hashes(q_hi, q_lo, nblk: int, s4: int, s5: int):
    """(block, [bit1..bitK]) as int64, bit-identical to
    ``kmer_id_tpu.db.fpdb.bloom_hashes``."""
    hi, lo = widen(q_hi), widen(q_lo)
    blk = _fp_mix(hi ^ 0x243F6A88, lo, s4, s5) & (nblk - 1)
    m = _fp_mix(lo ^ 0xB7E15162, hi, s5, s4)
    return blk, [(m >> (7 * j)) & 127 for j in range(BLOOM_BITS)]


def bloom_pass(db, q_hi, q_lo, valid):
    """bool plane: True where the window may be a probe (every one of its
    BLOOM_BITS bits is set in its 128-bit block; no false negatives)."""
    bloom = db["bloom"]
    blk, bits = bloom_hashes(q_hi, q_lo, bloom.shape[0], db["fp_s4"], db["fp_s5"])
    row = widen(bloom.index_select(0, blk.reshape(-1)).view(*blk.shape, 4))
    ok = valid
    for bit in bits:
        word = row.gather(-1, (bit >> 5).unsqueeze(-1)).squeeze(-1)
        ok = ok & (((word >> (bit & 31)) & 1) == 1)
    return ok


def _fp_bucket_match(row, fp):
    """row int32 [..., 4] -> (any match, slot index half*4 + word).

    The build guarantees at most one stored fingerprint per bucket equals
    ``fp``; argmax then picks it (and 0 when there is none)."""
    r = widen(row)
    m = torch.cat([r & 0xFFFF, r >> 16], dim=-1) == fp.unsqueeze(-1)
    return m.any(dim=-1), m.to(torch.int32).argmax(dim=-1)


def fp_candidates(db, q_hi, q_lo, valid):
    """Per-window candidate slot ids from one L1 and two L2 bucket rows.

    Returns [(cand int32, valid bool)] * 3 in plane order: L1, L2 choice 1,
    L2 choice 2 (the last excludes c2 == c1).  A present key yields its true
    slot in exactly one plane; false candidates die in the verify stage.
    """
    fptab, fptab2 = db["fptab"], db["fptab2"]
    nb1, nb2 = fptab.shape[0], fptab2.shape[0]
    shape = q_hi.shape
    b1, _, fp = fp_hashes(q_hi, q_lo, nb1, db["fp_s1"], db["fp_s2"], db["fp_s3"])
    c1, c2, _ = fp_hashes(q_hi, q_lo, nb2, db["fp_s4"], db["fp_s5"], db["fp_s3"])

    def rows(tab, idx):
        return tab.index_select(0, idx.reshape(-1)).view(*shape, 4)

    m1, s1 = _fp_bucket_match(rows(fptab, b1), fp)
    m2, s2 = _fp_bucket_match(rows(fptab2, c1), fp)
    m3, s3 = _fp_bucket_match(rows(fptab2, c2), fp)
    off = nb1 * 8
    return [
        ((b1 * 8 + s1).to(torch.int32), m1 & valid),
        ((off + c1 * 8 + s2).to(torch.int32), m2 & valid),
        ((off + c2 * 8 + s3).to(torch.int32), m3 & valid & (c2 != c1)),
    ]


def fp_candidates_shard(db, q_hi, q_lo, valid, b0: int, nbloc: int, own2: bool):
    """:func:`fp_candidates` on one rank of the sharded engine's grid
    (``local_hits`` of ``kmer_id_tpu/parallel/fpsharded.py:304-319``).

    ``db["fptab"]`` holds the rank's L1 buckets ``[b0, b0 + nbloc)`` of the
    global table of ``db["nb1"]`` buckets, whose mask the L1 hash takes; an
    L1 candidate counts only for a bucket in that range.  The two L2 planes
    count only on the rank that owns L2 (``own2``: db rank 0).  Slot ids are
    local: L1 ``(b1 - b0) * 8 + i``, L2 ``nbloc * 8 + c * 8 + s``."""
    fptab, fptab2 = db["fptab"], db["fptab2"]
    nb2 = fptab2.shape[0]
    shape = q_hi.shape
    b1, _, fp = fp_hashes(q_hi, q_lo, db["nb1"], db["fp_s1"], db["fp_s2"], db["fp_s3"])
    c1, c2, _ = fp_hashes(q_hi, q_lo, nb2, db["fp_s4"], db["fp_s5"], db["fp_s3"])
    inr = (b1 >= b0) & (b1 < b0 + nbloc)
    bl = (b1 - b0).clamp(0, nbloc - 1)

    def rows(tab, idx):
        return tab.index_select(0, idx.reshape(-1)).view(*shape, 4)

    m1, s1 = _fp_bucket_match(rows(fptab, bl), fp)
    m2, s2 = _fp_bucket_match(rows(fptab2, c1), fp)
    m3, s3 = _fp_bucket_match(rows(fptab2, c2), fp)
    off = nbloc * 8
    own = valid & own2
    return [
        ((bl * 8 + s1).to(torch.int32), m1 & valid & inr),
        ((off + c1 * 8 + s2).to(torch.int32), m2 & own),
        ((off + c2 * 8 + s3).to(torch.int32), m3 & own & (c2 != c1)),
    ]


# ------------------------------------------------------------ legacy engine


_mix32 = _fp_mix  # the cuckoo table's bucket mix: the same formula


def cuckoo_lookup(db, q_hi, q_lo):
    """Two-row lookup over the cuckoo table (db/cuckoo.py layout).

    ``db["cuckoo"]`` int32 [nb, 16]: 4 slots of (key hi, key lo, target,
    probe index) per bucket, empty slots with hi = 0xFFFFFFFF (-1 here),
    which no key reaches (hi < 2^28); ``db["n_probes"]`` and the salts
    ``db["cuckoo_s1"]``/``["cuckoo_s2"]`` are ints.  Returns (target int32,
    index int32, found bool): on a miss target 0 and index ``n_probes``; on
    a hit the first matching of the 8 slots (the build stores a key once).
    """
    table = db["cuckoo"]
    nb = table.shape[0]
    s1, s2 = db["cuckoo_s1"], db["cuckoo_s2"]
    hi, lo = widen(q_hi), widen(q_lo)
    h1 = _mix32(hi, lo, s1, s2) & (nb - 1)
    h2 = _mix32(lo, hi, s1, s2) & (nb - 1)
    shape = q_hi.shape
    rows = torch.cat([table.index_select(0, h.reshape(-1)).view(*shape, 16)
                      for h in (h1, h2)], dim=-1).view(*shape, 8, 4)
    hit = (rows[..., 0] == q_hi.unsqueeze(-1)) & (rows[..., 1] == q_lo.unsqueeze(-1))
    found = hit.any(dim=-1)
    slot = hit.to(torch.int32).argmax(dim=-1)
    row = rows.gather(-2, slot[..., None, None].expand(*shape, 1, 4)).squeeze(-2)
    tgt = torch.where(found, row[..., 2], 0)
    idx = torch.where(found, row[..., 3], db["n_probes"])
    return tgt, idx, found


def _less2(ahi, alo, bhi, blo):
    """(a < b) for two-word keys given as unsigned values (int64)."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def searchsorted2(db_hi, db_lo, q_hi, q_lo, lo0=None, hi0=None, steps: int | None = None):
    """Lower-bound index of each two-word query in the sorted key words.

    ``db_hi``/``db_lo`` int32 [N] bit patterns sorted by the 60-bit key;
    queries any shape.  ``lo0``/``hi0`` restrict each query's range (the
    bucket index); ``steps`` bounds the bisection rounds (the default
    covers the whole array).  Lanes whose range has closed stay put, so the
    result is the JAX function's for any ``steps``.  Returns int32 in [0, N].
    """
    n = db_hi.shape[0]
    dev = q_hi.device
    lo = (torch.zeros(q_hi.shape, dtype=torch.int32, device=dev) if lo0 is None
          else lo0.to(torch.int32))
    hi = (torch.full(q_hi.shape, n, dtype=torch.int32, device=dev) if hi0 is None
          else hi0.to(torch.int32))
    if n == 0:
        return lo
    if steps is None:
        steps = max(1, math.ceil(math.log2(n + 1)))
    qh, ql = widen(q_hi), widen(q_lo)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        # mid == n only on a closed lane (lo == hi == n): read any row there
        m = mid.clamp(max=n - 1).reshape(-1)
        less = _less2(widen(db_hi.index_select(0, m)).view(mid.shape),
                      widen(db_lo.index_select(0, m)).view(mid.shape), qh, ql)
        lo, hi = (torch.where(active & less, mid + 1, lo),
                  torch.where(active & ~less, mid, hi))
    return lo


def lookup_keys(db, q_hi, q_lo, bucket_bits: int = 0, max_steps: int | None = None):
    """Look up query keys in the sorted key words; returns (index int32,
    found bool), index N on a miss.  With ``bucket_bits > 0``,
    ``db["bucket_off"]`` int32 [2^bucket_bits + 1] maps the key's top bits
    (``hi >> (28 - bucket_bits)``) to its range of the sorted array."""
    db_hi, db_lo = db["hi"], db["lo"]
    n = db_hi.shape[0]
    if n == 0:
        return (torch.zeros(q_hi.shape, dtype=torch.int32, device=q_hi.device),
                torch.zeros(q_hi.shape, dtype=torch.bool, device=q_hi.device))
    if bucket_bits > 0:
        b = (widen(q_hi) >> (28 - bucket_bits)).reshape(-1)
        off = db["bucket_off"]
        lo0 = off.index_select(0, b).view(q_hi.shape)
        hi0 = off.index_select(0, b + 1).view(q_hi.shape)
        idx = searchsorted2(db_hi, db_lo, q_hi, q_lo, lo0, hi0, steps=max_steps)
    else:
        idx = searchsorted2(db_hi, db_lo, q_hi, q_lo, steps=max_steps)
    safe = idx.clamp(max=n - 1).reshape(-1)
    hit = ((idx < n) & (db_hi.index_select(0, safe).view(idx.shape) == q_hi)
           & (db_lo.index_select(0, safe).view(idx.shape) == q_lo))
    return torch.where(hit, idx, n), hit
