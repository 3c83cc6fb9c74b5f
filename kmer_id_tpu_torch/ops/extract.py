"""Read planes: 2-bit unpacking and canonical 30-mer key words per window.

Ports ``kmer_id_tpu/engine/fpclassify.py:unpack_codes`` and
``kmer_id_tpu/ops/extract.py:extract_kmers``.  Key words are int32 bit
patterns (ops/words.py); hi = key bits [32, 60), lo = bits [0, 32).
"""

from __future__ import annotations

import torch

from kmer_id_tpu_torch.core.codec import KSIZE
from kmer_id_tpu_torch.ops.words import narrow, widen

# Forward key: base j of the window contributes code << 2*(KSIZE-1-j);
# reverse complement: (3 - code) << 2*j.  Split by word.
_F_HI = [(j, 2 * (KSIZE - 1 - j) - 32) for j in range(KSIZE) if 2 * (KSIZE - 1 - j) >= 32]
_F_LO = [(j, 2 * (KSIZE - 1 - j)) for j in range(KSIZE) if 2 * (KSIZE - 1 - j) < 32]
_R_HI = [(j, 2 * j - 32) for j in range(KSIZE) if 2 * j >= 32]
_R_LO = [(j, 2 * j) for j in range(KSIZE) if 2 * j < 32]


def unpack_codes(packed: torch.Tensor, exc: torch.Tensor, l: int) -> torch.Tensor:
    """2-bit words + exception list -> uint8 code plane [B, L].

    ``packed`` int32 [B, ceil(L/16)] (uint32 bit patterns), base i of a row
    at word i >> 4, bits (i & 15) * 2.  ``exc`` int32 [E]: flat row*L+pos of
    non-ACGT bases, -1 pad; those positions become the invalid code 4.  Pads
    write to a sink element past the plane, so every write stores the same
    value and the result does not depend on write order.
    """
    b, w = packed.shape
    shifts = torch.arange(16, device=packed.device, dtype=torch.int64) * 2
    codes = ((widen(packed)[:, :, None] >> shifts) & 3).to(torch.uint8)
    n = b * l
    flat = torch.empty(n + 1, dtype=torch.uint8, device=packed.device)
    flat[:n] = codes.reshape(b, w * 16)[:, :l].reshape(-1)
    exc = exc.to(torch.int64)
    idx = torch.where(exc >= 0, exc.clamp(max=n - 1), n)
    flat.index_fill_(0, idx, 4)
    return flat[:n].view(b, l)


def extract_kmers(codes: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Canonical (hi, lo) key words for every window of a read plane.

    Args:
      codes: uint8 [B, L]; 0..3 = A,C,G,T, >= 4 = invalid or padding.
      lengths: int32 [B]; valid prefix length of each row.

    Returns a dict of ``hi``, ``lo`` int32 [B, P] bit patterns (P = L-KSIZE+1),
    ``valid`` bool [B, P] (window in bounds and all bases valid) and
    ``fstrand`` bool [B, P] (forward key strictly below reverse complement).
    """
    b, l = codes.shape
    p = l - KSIZE + 1
    if p <= 0:
        raise ValueError(f"batch length {l} shorter than KSIZE={KSIZE}")
    c = codes.to(torch.int64) & 3
    rc = 3 - c
    inb = torch.arange(l, device=codes.device)[None, :] < lengths[:, None]
    bad = (codes >= 4) | ~inb

    def word(src, terms):
        acc = torch.zeros((b, p), dtype=torch.int64, device=codes.device)
        for j, sh in terms:
            acc |= src[:, j : j + p] << sh
        return acc

    fhi, flo = word(c, _F_HI), word(c, _F_LO)
    rhi, rlo = word(rc, _R_HI), word(rc, _R_LO)

    # window validity: no bad base among codes[:, s:s+KSIZE]
    cs = torch.cumsum(bad, dim=1, dtype=torch.int32)
    cs0 = torch.nn.functional.pad(cs, (1, 0))
    valid = (cs[:, KSIZE - 1 :] - cs0[:, :p]) == 0

    fwd = (fhi < rhi) | ((fhi == rhi) & (flo < rlo))
    hi = narrow(torch.where(fwd, fhi, rhi))
    lo = narrow(torch.where(fwd, flo, rlo))
    return {"hi": hi, "lo": lo, "valid": valid, "fstrand": fwd}
