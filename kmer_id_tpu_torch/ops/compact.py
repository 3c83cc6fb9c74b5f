"""Candidate compaction: the first ``max_hits`` valid columns of each row.

The verify stage needs the first ``max_hits`` candidates of each read in
window order (ascending column of the interleaved plane: window, then plane
— the reference's discovery order).  Port of ``kmer_id_tpu/ops/compact.py``:

* :func:`compact_ranks_plain` — plain PyTorch (cumulative sum, then a
  scatter into ``[B, max_hits + 1]`` whose last column takes the ranks past
  the budget).  Runs for CPU tensors; the kernel's reference on the card.
* :func:`compact_ranks_cuda` — the hand-written kernel in
  ``csrc/compact.cu`` (one warp per row, ballot/popc ranks).
* :func:`compact_ranks` — the engine's entry: a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version.

All return ``(pos32, cand32, ncand, extras32)``: int32 [B, max_hits] window
positions (``SENT`` past the last candidate), int32 [B, max_hits] payloads
(0 pad), int32 [B] total valid count (may exceed ``max_hits``) and a tuple
of compacted extra payload planes (int32 [B, max_hits], 0 pad).
"""

from __future__ import annotations

import torch

from kmer_id_tpu_torch.kernels.build import LaunchCount, check_tensor, launch, load_compact, ptr

SENT = 2**31 - 1
MAX_EXTRAS = 2


def interleave_planes(planes):
    """[(cand, valid)] * K -> (cand_ilv, valid_ilv) [B, K*P].

    Column K*p + k holds plane k's candidate for window p, so ascending
    column is ascending (window, plane)."""
    cand = torch.stack([c for c, _ in planes], dim=2)
    valid = torch.stack([v for _, v in planes], dim=2)
    b, p, k = cand.shape
    return cand.reshape(b, p * k), valid.reshape(b, p * k)


def compact_ranks_plain(cand, valid, pos, max_hits: int, extras=()):
    """Rank compaction in plain PyTorch (see module doc).

    ``cand`` int32 [B, C], ``valid`` bool [B, C], ``pos`` int32 broadcastable
    to [B, C], ``extras`` int32 planes broadcastable to [B, C]."""
    b, c = cand.shape
    rank = torch.cumsum(valid, dim=1, dtype=torch.int32)
    ncand = rank[:, -1].contiguous()
    slot = torch.where(valid & (rank <= max_hits), rank - 1, max_hits).long()

    def place(src, fill):
        out = torch.full((b, max_hits + 1), fill, dtype=src.dtype, device=src.device)
        out.scatter_(1, slot, src.expand(b, c))
        return out[:, :max_hits].contiguous()

    return (
        place(pos, SENT),
        place(cand, 0),
        ncand,
        tuple(place(e, 0) for e in extras),
    )


def compact_ranks_cuda(cand, valid, pos, max_hits: int, extras=()):
    """Rank compaction by the CUDA kernel ``csrc/compact.cu``.

    ``pos`` and ``extras`` may be broadcasts (e.g. a [1, C] position row);
    the wrapper materialises them.  Everything else must already be a
    contiguous CUDA tensor of the stated dtype and shape, or this raises.
    ``compact_ranks_cuda.launches`` counts kernel launches."""
    if cand.dim() != 2:
        raise ValueError("compact_ranks_cuda: cand must be [B, C]")
    if len(extras) > MAX_EXTRAS:
        raise ValueError(f"compact_ranks_cuda: at most {MAX_EXTRAS} extra planes")
    if max_hits < 1:
        raise ValueError("compact_ranks_cuda: max_hits must be >= 1")
    device = cand.device
    if device.type != "cuda":
        raise ValueError(f"compact_ranks_cuda: tensors on {device}, not on a CUDA device")
    b, c = cand.shape
    pos = pos.expand(b, c).contiguous()
    extras = [e.expand(b, c).contiguous() for e in extras]
    check_tensor("compact_ranks_cuda", "cand", cand, torch.int32, (b, c), device)
    check_tensor("compact_ranks_cuda", "valid", valid, torch.bool, (b, c), device)
    check_tensor("compact_ranks_cuda", "pos", pos, torch.int32, (b, c), device)
    for i, e in enumerate(extras):
        check_tensor("compact_ranks_cuda", f"extras[{i}]", e, torch.int32, (b, c), device)

    pos_out = torch.empty((b, max_hits), dtype=torch.int32, device=device)
    cand_out = torch.empty((b, max_hits), dtype=torch.int32, device=device)
    n_out = torch.empty((b,), dtype=torch.int32, device=device)
    extra_outs = [torch.empty((b, max_hits), dtype=torch.int32, device=device)
                  for _ in extras]
    e_in = [ptr(e) for e in extras] + [None] * (MAX_EXTRAS - len(extras))
    e_out = [ptr(e) for e in extra_outs] + [None] * (MAX_EXTRAS - len(extras))
    launch(load_compact().kmer_compact_ranks, "compact_ranks", device,
           ptr(cand), ptr(valid), ptr(pos), e_in[0], e_in[1], len(extras),
           ptr(pos_out), ptr(cand_out), ptr(n_out), e_out[0], e_out[1], b, c, max_hits)
    compact_ranks_cuda.launches.add()
    return pos_out, cand_out, n_out, tuple(extra_outs)


compact_ranks_cuda.launches = LaunchCount()


def compact_ranks(cand, valid, pos, max_hits: int, extras=()):
    """Engine entry: CUDA tensors go to the kernel, CPU tensors to the plain
    version.  There is no fallback between the two."""
    if cand.is_cuda:
        return compact_ranks_cuda(cand, valid, pos, max_hits, extras)
    return compact_ranks_plain(cand, valid, pos, max_hits, extras)
