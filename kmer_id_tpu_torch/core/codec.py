"""2-bit nucleotide codec and canonical k-mer keys (host side, NumPy).

Behavioral contract (established by the reference, cited for parity checks —
no code is copied from it):

* Base encoding A=0, C=1, G=2, T=3; any other character is *invalid* and
  resets the rolling k-mer window (``newkmer_10nx.cpp:475-525``).  The vf6/m3
  variants additionally accept U/u as T (``kmer_read_vf6.cpp:283-300``).
* A k-mer of size ``KSIZE=30`` is emitted at every position whose trailing
  30-character window contains only valid bases; the forward key packs bases
  most-significant-first (``keyF = (keyF<<2 | code) & mask``) and the
  reverse-complement key packs complements least-significant-first
  (``newkmer_10nx.cpp:72-83``).  The canonical key is ``min(keyF, keyR)`` as a
  60-bit integer (``newkmer_10nx.cpp:528``).
* Key⇄string conversion is most-significant-base-first
  (``kmer_build_vf6.cpp:63-72``).

Device-side representation: the engine carries keys as two ``uint32`` words
— ``hi`` = bits [32, 60) (28 bits) and ``lo`` = bits [0, 32) — with
lexicographic (hi, lo) comparisons.  Host code uses ``np.uint64`` freely;
:func:`split_key` converts.

Copy of ``kmer_id_tpu/core/codec.py``, trimmed to what the port reaches.
"""

from __future__ import annotations

import numpy as np

KSIZE = 30
KEY_BITS = 2 * KSIZE  # 60
KEY_MASK = np.uint64((1 << KEY_BITS) - 1)

INVALID = np.uint8(4)  # code for non-ACGT characters
_BASES = "ACGT"

def _make_lut(u_is_t: bool) -> np.ndarray:
    lut = np.full(256, INVALID, dtype=np.uint8)
    for i, ch in enumerate("ACGT"):
        lut[ord(ch)] = i
        lut[ord(ch.lower())] = i
    if u_is_t:
        lut[ord("U")] = 3
        lut[ord("u")] = 3
    return lut


# nx-style table: only ACGT/acgt valid (newkmer_10nx.cpp:475-525).
CODE_LUT = _make_lut(u_is_t=False)
# vf6/m3-style table: U/u also map to T (kmer_read_vf6.cpp:496-525).
CODE_LUT_U = _make_lut(u_is_t=True)


def encode_bases(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Encode a nucleotide sequence to uint8 codes 0..3 (4 = invalid)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return CODE_LUT[arr]


# Per-base weights for the forward key: base j of the k-mer (0 = leftmost)
# contributes code << (2*(KSIZE-1-j)).
_F_SHIFTS = np.array([2 * (KSIZE - 1 - j) for j in range(KSIZE)], dtype=np.uint64)
# Reverse-complement key: base j contributes (3-code) << (2*j).
_R_SHIFTS = np.array([2 * j for j in range(KSIZE)], dtype=np.uint64)


def _window_keys(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All sliding-window (keyF, keyR, valid) for a 1-D code array.

    Returns arrays of length ``len(codes) - KSIZE + 1`` (empty if shorter),
    indexed by the k-mer's *start* position.  ``valid[s]`` is True iff the
    window ``codes[s : s+KSIZE]`` contains no invalid code.
    """
    n = codes.shape[0]
    p = n - KSIZE + 1
    if p <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    c64 = codes.astype(np.uint64)
    keyF = np.zeros(p, dtype=np.uint64)
    keyR = np.zeros(p, dtype=np.uint64)
    ok = np.ones(p, dtype=bool)
    three = np.uint64(3)
    for j in range(KSIZE):
        w = c64[j : j + p]
        keyF |= (w & three) << _F_SHIFTS[j]
        keyR |= ((three - (w & three)) & three) << _R_SHIFTS[j]
        ok &= codes[j : j + p] < INVALID
    return keyF, keyR, ok


def forward_kmers(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(keyF, end_positions) for every valid window, forward strand only.

    Matches the DB-load re-encoding path (``newkmer_10nx.cpp:619-661``), which
    never canonicalizes: the probe text already stores the canonical form.
    """
    keyF, _, ok = _window_keys(codes)
    pos = np.nonzero(ok)[0]
    return keyF[pos], pos + KSIZE - 1


def canonical_kmers(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical keys for every valid sliding window of a 1-D code array.

    Returns ``(keys, end_positions, fstrand)`` where ``end_positions`` are
    0-based indices of each k-mer's last base (the builder's ``gpos`` at
    emission, ``kmer_build_vf6.cpp:625,636``) and ``fstrand`` is True when the
    forward key is the canonical one (strict ``keyF < keyR``,
    ``kmer_build_vf6.cpp:606-609``).
    """
    keyF, keyR, ok = _window_keys(codes)
    pos = np.nonzero(ok)[0]
    kF, kR = keyF[pos], keyR[pos]
    fwd = kF < kR
    keys = np.where(fwd, kF, kR)
    return keys, pos + KSIZE - 1, fwd


def key_to_string(key: int) -> str:
    """Decode a 60-bit key to its 30-char base string (MSB base first)."""
    k = int(key)
    return "".join(_BASES[(k >> (2 * (KSIZE - 1 - j))) & 3] for j in range(KSIZE))


def split_key(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split uint64 keys into (hi, lo) uint32 words; hi = bits [32, 60)."""
    keys = np.asarray(keys, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo
