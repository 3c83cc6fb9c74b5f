"""Candidate compaction: the first ``max_hits`` valid columns of each row.

The verify stage needs the first ``max_hits`` candidates of each read in
window order (ascending column of the interleaved plane: window, then plane
— the reference's discovery order).  Port of ``kmer_id_tpu/ops/compact.py``:

* :func:`compact_ranks_plain` — plain PyTorch (cumulative sum, then a
  scatter into ``[B, max_hits + 1]`` whose last column takes the ranks past
  the budget).  Runs for CPU tensors; the kernel's reference on the card.
* :func:`compact_ranks_cuda` — the hand-written kernel in
  ``csrc/compact.cu`` (16-byte loads of the valid plane, one scan over a
  group of lanes per row; :func:`kernel_group` picks the group).
* :func:`compact_ranks` — the engine's entry: a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version.

The payload planes (``pos`` and the extras) take three forms
(:func:`payload_layout`): [B, C]; [1, C], one row broadcast; and
[B or 1, C / r], each column repeated ``r`` times along the row (``r`` an
argument: the engine passes ``N_PLANES`` = 3 for per-window planes beside
the interleaved candidates).  The plain version materialises them; the
kernel reads them in place.

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


def payload_layout(fn: str, name: str, plane, b: int, c: int, r: int) -> tuple[int, int]:
    """(row stride, column divisor) by which ``csrc/compact.cu`` reads a
    payload plane of a [b, c] compaction in place: value at (row, col) =
    ``plane[row * stride + col // divisor]``.  The plane is [b or 1, c], or
    [b or 1, c / r] repeated ``r`` times along the row (as
    ``repeat_interleave(r, dim=1)`` would), with adjacent columns; a
    single row is a broadcast (stride 0).  Raises on any other form, and on
    ``r`` < 1.  ``fn`` names the caller in the message."""
    if not isinstance(r, int) or r < 1:
        raise ValueError(f"{fn}: column divisor r={r!r} must be an int >= 1")
    if plane.dim() != 2 or plane.shape[0] not in (1, b):
        raise ValueError(f"{fn}: {name} shape {tuple(plane.shape)}, expected [{b} or 1, width]")
    w = plane.shape[1]
    if w == c:
        div = 1
    elif w * r == c:
        div = r
    else:
        raise ValueError(f"{fn}: {name} width {w} is neither {c} nor {c} / r (r={r})")
    if w > 1 and plane.stride(1) != 1:
        raise ValueError(f"{fn}: {name} strides {plane.stride()} unsupported: columns must be "
                         "adjacent")
    return (plane.stride(0) if plane.shape[0] > 1 else 0), div


def _full(plane, b: int, c: int, r: int):
    """A payload plane as the [b, c] plane it stands for (a view where it
    can be)."""
    _, div = payload_layout("compact_ranks_plain", "payload", plane, b, c, r)
    if div > 1:
        plane = plane.repeat_interleave(div, dim=1)
    return plane.expand(b, c)


def compact_ranks_plain(cand, valid, pos, max_hits: int, extras=(), r: int = 1):
    """Rank compaction in plain PyTorch (see module doc).

    ``cand`` int32 [B, C], ``valid`` bool [B, C]; ``pos`` and ``extras``
    int32 payload planes in any form :func:`payload_layout` takes, which
    this version materialises."""
    b, c = cand.shape
    rank = torch.cumsum(valid, dim=1, dtype=torch.int32)
    ncand = rank[:, -1].contiguous()
    slot = torch.where(valid & (rank <= max_hits), rank - 1, max_hits).long()

    def place(src, fill):
        out = torch.full((b, max_hits + 1), fill, dtype=src.dtype, device=src.device)
        out.scatter_(1, slot, src)
        return out[:, :max_hits].contiguous()

    return (
        place(_full(pos, b, c, r), SENT),
        place(cand, 0),
        ncand,
        tuple(place(_full(e, b, c, r), 0) for e in extras),
    )


def kernel_group(c: int) -> int:
    """Lanes per row of ``csrc/compact.cu`` at row width ``c`` (its note): a
    row touches at most ``(c + 14) // 16 + 1`` aligned 16-byte chunks, one
    per lane; 8, 16 or 32 lanes (the least power of two covering them) up
    to 32 chunks (``c`` <= 497), else a CTA of up to 4 warps (one pass to
    ``c`` = 2017; wider rows take passes)."""
    nch = (c + 14) // 16 + 1
    if nch <= 32:
        return max(8, 1 << (nch - 1).bit_length())
    return 32 * min(4, -(-nch // 32))


def compact_ranks_cuda(cand, valid, pos, max_hits: int, extras=(), r: int = 1):
    """Rank compaction by the CUDA kernel ``csrc/compact.cu``.

    ``cand`` and ``valid`` must be contiguous [B, C] CUDA tensors (``valid``
    may start at any byte); ``pos`` and ``extras`` are int32 payload planes
    in any form :func:`payload_layout` takes, passed to the kernel by
    pointer, row stride and column divisor, never copied.  Raises on
    anything else, and if the build or the launch fails.
    ``compact_ranks_cuda.launches`` counts kernel launches."""
    fn = "compact_ranks_cuda"
    if cand.dim() != 2:
        raise ValueError(f"{fn}: cand must be [B, C]")
    if len(extras) > MAX_EXTRAS:
        raise ValueError(f"{fn}: at most {MAX_EXTRAS} extra planes")
    if max_hits < 1:
        raise ValueError(f"{fn}: max_hits must be >= 1")
    b, c = cand.shape
    planes = [("pos", pos)] + [(f"extras[{i}]", e) for i, e in enumerate(extras)]
    layouts = [payload_layout(fn, name, t, b, c, r) for name, t in planes]
    device = cand.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors on {device}, not on a CUDA device")
    check_tensor(fn, "cand", cand, torch.int32, (b, c), device)
    check_tensor(fn, "valid", valid, torch.bool, (b, c), device)
    for name, t in planes:
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"{fn}: {name} is {t.dtype} on {t.device}, expected int32 on "
                             f"{device}")

    pos_out = torch.empty((b, max_hits), dtype=torch.int32, device=device)
    cand_out = torch.empty((b, max_hits), dtype=torch.int32, device=device)
    n_out = torch.empty((b,), dtype=torch.int32, device=device)
    extra_outs = [torch.empty((b, max_hits), dtype=torch.int32, device=device)
                  for _ in extras]
    args = []
    for i in range(1 + MAX_EXTRAS):
        if i < len(planes):
            args += [ptr(planes[i][1]), *layouts[i]]
        else:
            args += [None, 0, 1]
    e_out = [ptr(e) for e in extra_outs] + [None] * (MAX_EXTRAS - len(extras))
    launch(load_compact().kmer_compact_ranks, "compact_ranks", device,
           ptr(cand), ptr(valid), *args, len(extras),
           ptr(pos_out), ptr(cand_out), ptr(n_out), e_out[0], e_out[1], b, c, max_hits,
           kernel_group(c))
    compact_ranks_cuda.launches.add()
    return pos_out, cand_out, n_out, tuple(extra_outs)


compact_ranks_cuda.launches = LaunchCount()


def compact_ranks(cand, valid, pos, max_hits: int, extras=(), r: int = 1):
    """Engine entry: CUDA tensors go to the kernel, CPU tensors to the plain
    version.  There is no fallback between the two."""
    if cand.is_cuda:
        return compact_ranks_cuda(cand, valid, pos, max_hits, extras, r)
    return compact_ranks_plain(cand, valid, pos, max_hits, extras, r)
