"""Fingerprint-table lookup: Bloom gate and L1/L2 candidate slots.

Ports ``_fp_mix``, ``fp_hashes_jnp``, ``bloom_hashes_jnp``, ``bloom_pass``,
``_fp_bucket_match`` and ``fp_candidates`` of ``kmer_id_tpu/ops/lookup.py``
(the table layout is documented in ``kmer_id_tpu/db/fpdb.py``).  Key words
and table rows are int32 bit patterns (ops/words.py); hashes are formed on
int64 values in [0, 2^32).
"""

from __future__ import annotations

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
