"""The window gate: from a batch's read rows to its Bloom-passing windows.

One stage of the engine per short-read batch (and per chunk group of the
long-read lane), in two modes:

* **gate** — canonical key words of every window, its validity, the
  block-Bloom test and the rank compaction of the passing windows to
  ``BLOOM_K`` per read with the key words as payloads.  Returns ``(wpos,
  whi, wlo, npass)``: int32 [B, K] window positions (``SENT`` past the last
  pass), int32 [B, K] key words (0 pad) and int32 [B], the full pass count,
  which may exceed K (the engine's dense branch reads it).  K is
  ``BLOOM_K`` for the single-device engine and ``SHARD_BLOOM_K`` on a rank
  of the sharded engine's grid (parallel/fpsharded.py).
* **extract** — the full ``{"hi", "lo", "valid"}`` planes [B, P] for the
  callers that probe every window (the dense path, the overflow replay, a
  DB without a Bloom filter, the legacy engine), with ``fstrand`` [B, P]
  (forward key strictly below the reverse complement) on request.

Each has a plain PyTorch version (:func:`window_gate_plain`,
:func:`extract_plain`: the composition of ops/extract.py's unpack and
extract, ops/lookup.py's ``bloom_pass`` and ops/compact.py's plain
compaction), the wrapper of the CUDA kernel ``csrc/gate.cu``
(:func:`window_gate_cuda`, :func:`extract_cuda`) and the engine's entry
(:func:`window_gate`, :func:`extract`): a CUDA tensor goes to the kernel, a
CPU tensor to the plain version, with no fallback between the two.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kmer_id_tpu_torch.core.codec import KSIZE
from kmer_id_tpu_torch.kernels.build import LaunchCount, check_tensor, launch, load_gate, ptr
from kmer_id_tpu_torch.ops.compact import compact_ranks_plain
from kmer_id_tpu_torch.ops.extract import extract_kmers, unpack_codes
from kmer_id_tpu_torch.ops.lookup import bloom_pass

BLOOM_K = 12  # per-read budget of Bloom-passing windows
SHARD_BLOOM_K = 24  # the same on a rank of the sharded engine's grid


@dataclass
class ReadPlanes:
    """A batch of read rows on one device, in one of two forms: 2-bit
    ``packed`` words (int32 bit patterns [B, ceil(width/16)], base i of a row
    at word i >> 4, bits 2(i & 15)) with the ``exc`` list (int32 [E], flat
    row*width+pos of non-ACGT bases, -1 pad), or the uint8 ``codes`` plane
    [B, width].  ``lengths`` int32 [B] is each row's valid prefix."""

    lengths: torch.Tensor
    width: int
    packed: torch.Tensor | None = None
    exc: torch.Tensor | None = None
    codes: torch.Tensor | None = None

    @classmethod
    def from_batch(cls, batch, device, max_len: int) -> "ReadPlanes":
        """An io/batch.Batch's rows on ``device``: its packed words (uint32
        as int32 bit patterns) and exception list when it has them (the
        rows' width is the code plane's, or ``max_len`` for a batch that
        ships none), else its code plane.  Each array is a private copy;
        to a card it goes from pinned host memory without blocking the
        host (:func:`_ship`)."""
        device = torch.device(device)
        lengths = _ship(np.array(batch.lengths, np.int32, order="C"), device)
        if batch.packed is not None:
            width = batch.codes.shape[1] if batch.codes is not None else max_len
            packed = _ship(np.array(batch.packed, np.uint32, order="C").view(np.int32), device)
            return cls(lengths, width, packed=packed,
                       exc=_ship(np.array(batch.exc, np.int32, order="C"), device))
        codes = _ship(np.array(batch.codes, np.uint8, order="C"), device)
        return cls(lengths, codes.shape[1], codes=codes)

    @property
    def rows(self) -> int:
        return self.lengths.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lengths.device


def _ship(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A C-order host array on ``device`` (on the CPU, a tensor sharing its
    memory).  To a card it is copied into pinned memory and sent with
    ``non_blocking=True`` on the current stream: the caching host allocator
    keeps the pinned block until that copy has run."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _code_plane(reads: ReadPlanes) -> torch.Tensor:
    if reads.packed is not None:
        return unpack_codes(reads.packed, reads.exc, reads.width)
    return reads.codes


def extract_plain(reads: ReadPlanes, fstrand: bool = False) -> dict:
    """Extract mode in plain PyTorch: unpack, then extract_kmers."""
    ex = extract_kmers(_code_plane(reads), reads.lengths)
    keep = ("hi", "lo", "valid", "fstrand") if fstrand else ("hi", "lo", "valid")
    return {k: ex[k] for k in keep}


def window_gate_plain(db, reads: ReadPlanes, k: int = BLOOM_K):
    """Gate mode in plain PyTorch: extract, ``bloom_pass`` against
    ``db["bloom"]`` (salts ``fp_s4``/``fp_s5``), then the rank compaction of
    the passing windows to ``k`` per read with (hi, lo) as payloads."""
    ex = extract_plain(reads)
    bloomed = bloom_pass(db, ex["hi"], ex["lo"], ex["valid"])
    b, p = bloomed.shape
    iota = torch.arange(p, device=bloomed.device, dtype=torch.int32)[None]
    wpos, _, npass, (whi, wlo) = compact_ranks_plain(
        iota.expand(b, p).contiguous(), bloomed, iota, k, extras=(ex["hi"], ex["lo"]))
    return wpos, whi, wlo, npass


def _kernel_args(reads: ReadPlanes, name: str):
    """Checks a batch for csrc/gate.cu; returns its form's leading
    arguments (packed, n_words, exc, n_exc, codes, lengths, rows, width)."""
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, not on a CUDA device")
    b, l = reads.rows, reads.width
    if l < KSIZE:
        raise ValueError(f"{name}: batch length {l} shorter than KSIZE={KSIZE}")

    def check(what, t, dtype, shape):
        check_tensor(name, what, t, dtype, shape, dev)

    check("lengths", reads.lengths, torch.int32, (b,))
    if reads.packed is not None:
        w = reads.packed.shape[1] if reads.packed.dim() == 2 else -1
        if w * 16 < l:
            raise ValueError(f"{name}: {w} packed words per row hold fewer than {l} bases")
        check("packed", reads.packed, torch.int32, (b, w))
        check("exc", reads.exc, torch.int32, (reads.exc.shape[0],))
        lead = (ptr(reads.packed), w, ptr(reads.exc), reads.exc.shape[0], None)
    else:
        check("codes", reads.codes, torch.uint8, (b, l))
        lead = (None, 0, None, 0, ptr(reads.codes))
    return lead + (ptr(reads.lengths), b, l)


def window_gate_cuda(db, reads: ReadPlanes, k: int = BLOOM_K):
    """Gate mode by the CUDA kernel ``csrc/gate.cu`` (see module doc), to
    ``k`` windows per read.  Raises on a batch or table the kernel does not
    take, and if the build or the launch fails.  ``window_gate_cuda.launches``
    counts launches."""
    lead = _kernel_args(reads, "window_gate_cuda")
    dev = reads.device
    bloom = db["bloom"]
    nblk = bloom.shape[0]
    check_tensor("window_gate_cuda", "bloom", bloom, torch.int32, (nblk, 4), dev)
    if nblk & (nblk - 1) or bloom.data_ptr() % 16:
        raise ValueError("window_gate_cuda: bloom needs a power-of-two row count "
                         "and 16-byte alignment")
    if k < 1:
        raise ValueError(f"window_gate_cuda: k {k} < 1")
    b = reads.rows
    wpos, whi, wlo = (torch.empty((b, k), dtype=torch.int32, device=dev)
                      for _ in range(3))
    npass = torch.empty((b,), dtype=torch.int32, device=dev)
    lib = load_gate()
    launch(lib.kmer_window_gate, "window_gate", dev, *lead, ptr(bloom), nblk,
            db["fp_s4"] & 0xFFFFFFFF, db["fp_s5"] & 0xFFFFFFFF, k,
            ptr(wpos), ptr(whi), ptr(wlo), ptr(npass))
    window_gate_cuda.launches.add()
    return wpos, whi, wlo, npass


window_gate_cuda.launches = LaunchCount()


def extract_cuda(reads: ReadPlanes, fstrand: bool = False) -> dict:
    """Extract mode by the CUDA kernel ``csrc/gate.cu`` (the ``fstrand``
    plane only when asked for).  Raises as :func:`window_gate_cuda` does;
    ``extract_cuda.launches`` counts launches."""
    lead = _kernel_args(reads, "extract_cuda")
    dev = reads.device
    shape = (reads.rows, reads.width - KSIZE + 1)
    out = {k: torch.empty(shape, dtype=torch.int32, device=dev) for k in ("hi", "lo")}
    out["valid"] = torch.empty(shape, dtype=torch.bool, device=dev)
    if fstrand:
        out["fstrand"] = torch.empty(shape, dtype=torch.bool, device=dev)
    lib = load_gate()
    launch(lib.kmer_window_extract, "window_extract", dev, *lead,
           ptr(out["hi"]), ptr(out["lo"]), ptr(out["valid"]),
           ptr(out["fstrand"]) if fstrand else None)
    extract_cuda.launches.add()
    return out


extract_cuda.launches = LaunchCount()


def window_gate(db, reads: ReadPlanes, k: int = BLOOM_K):
    """Engine entry of gate mode: the kernel for a batch on a CUDA device,
    the plain version for a batch on the CPU."""
    if reads.device.type == "cuda":
        return window_gate_cuda(db, reads, k)
    return window_gate_plain(db, reads, k)


def extract(reads: ReadPlanes, fstrand: bool = False) -> dict:
    """Engine entry of extract mode (see :func:`window_gate`)."""
    if reads.device.type == "cuda":
        return extract_cuda(reads, fstrand)
    return extract_plain(reads, fstrand)
