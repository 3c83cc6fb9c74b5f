"""The yardstick of the kernels: the card's peaks and the least bytes and
operations of each call of ``csrc/gate.cu`` and ``csrc/probe.cu``, from the
call's own arguments and outputs.

Bytes: each input byte read once and each output byte written once, and of
the tables what this call's data needs: a 16-byte Bloom block per valid
window (gate mode), the key words and three 16-byte bucket rows per
probed window, and a rec row (12 B), a tinfo row (8 B) and a seen byte per
verified hit (probe).  A rec row of a candidate that fails its check is
not counted and the every-window pass is counted by its valid plane and
verified hits only, so the probe's share is a floor.  Peaks: NVIDIA's H100
SXM data sheet (the roofline share is stated against it, with the card's
power limit beside it)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12  # 32-bit operations outside the tensor cores
GATE_OPS_PER_WINDOW = 80  # key, validity, two hashes, four bit tests, rank
PROBE_OPS_PER_WINDOW = 120  # three hashes, 24 fingerprint compares, ranks, verify
KSIZE = 30
SENT = 2**31 - 1  # the gate's position past a read's last passing window


def least_seconds(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S)


def valid_windows(reads) -> int:
    """Windows of a ReadPlanes batch with 30 valid bases inside the row's
    length: from the code plane (codes > 3 invalid), or from the exception
    list of the packed form (flat row * width + position, -1 pad)."""
    import torch

    rows, width = reads.rows, reads.width
    col = torch.arange(width, device=reads.lengths.device)
    bad = col[None, :] >= reads.lengths[:, None].long()
    if reads.packed is None:
        bad |= reads.codes > 3
    elif reads.exc.numel():
        e = reads.exc[reads.exc >= 0].long()
        bad.view(-1)[e] = True
    run = torch.zeros((rows, width + 1), dtype=torch.int32, device=bad.device)
    run[:, 1:] = torch.cumsum(bad.int(), dim=1)
    return int(((run[:, KSIZE:] - run[:, :-KSIZE]) == 0).sum())


def reads_bytes(reads) -> int:
    """Input bytes of a ReadPlanes batch in the form it was shipped."""
    n = reads.lengths.numel() * 4
    if reads.packed is not None:
        return n + reads.packed.numel() * 4 + reads.exc.numel() * 4
    return n + reads.codes.numel()


def gate_call(reads, k: int) -> tuple[float, float]:
    """(bytes, operations) of one gate-mode call."""
    v = valid_windows(reads)
    return reads_bytes(reads) + 16 * v + reads.rows * (3 * k + 1) * 4, GATE_OPS_PER_WINDOW * v


def extract_call(reads, fstrand: bool) -> tuple[float, float]:
    """(bytes, operations) of one extract-mode call: its planes written."""
    v = valid_windows(reads)
    p = reads.width - KSIZE + 1
    return reads_bytes(reads) + reads.rows * p * (10 if fstrand else 9), GATE_OPS_PER_WINDOW // 2 * v


def probe_call(wpos, out: dict, max_hits: int) -> tuple[float, float]:
    """(bytes, operations) of one probe + verify call from the gate's
    windows."""
    b, k = wpos.shape
    n_valid = int((wpos != SENT).sum())
    n_ver = int(out["nh"].sum())
    nbytes = b * k * 4 + 56 * n_valid + 21 * n_ver + b * max_hits * 21 + b * 14
    return nbytes, PROBE_OPS_PER_WINDOW * n_valid


def probe_dense_call(valid, out: dict, max_hits: int) -> tuple[float, float]:
    """(bytes, operations) of one every-window call: a floor (see the
    module doc)."""
    b = valid.shape[0]
    n_ver = int(out["nh"].sum())
    return valid.numel() + 21 * n_ver + b * max_hits * 21 + b * 14, 0.0
