"""Native IO loader: compiles fastx_native.cpp on demand, ctypes ABI.

The extension is a plain C-ABI shared object built with g++ at first use
into ``build/kmer_id_tpu_torch/`` at the repository root (keyed by a source
hash; the directory is not committed) and driven through ctypes with
zero-copy NumPy buffers.  Falls back cleanly (``get_lib() is None``) when no
compiler is available — io/batch.py's pure-Python path remains the
behavioral reference.

Started as a copy of ``kmer_id_tpu/io/native/`` (this module and
``fastx_native.cpp``).  Where it differs: the fill
(``fx_next_batch_packed``) also writes the batch's packed 2-bit words and
exception list, the form ``io/batch.py:pack_codes`` gives, in the pass that
encodes each row; and each open file is read ahead, inflated where it is
gzip, on a native worker thread into a ring of blocks that the fill takes in
order (the fill reports the blocks it took and its waits for them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastx_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_DIR))),
                          "build", "kmer_id_tpu_torch")

FORMAT_CODES = {
    "fastq_gz": 0,
    "fastq": 1,
    "fasta_gz": 2,
    "fasta": 3,
}

_lib = None
_lib_tried = False


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libfastx_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"  # concurrent builders each rename a whole file
    r = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", _SRC, "-o", tmp,
         "-lz"],
        capture_output=True,
        text=True,
    )
    if r.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.fx_open.restype = ctypes.c_void_p
    lib.fx_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.fx_close.argtypes = [ctypes.c_void_p]
    lib.fx_next_batch_packed.restype = ctypes.c_int
    lib.fx_next_batch_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def detect_format(path: str) -> str | None:
    """Extension dispatch identical to iter_reads_auto / vf6:1133-1152."""
    p = str(path)
    if p.endswith(".fastq.gz"):
        return "fastq_gz"
    if p.endswith(".fasta.gz"):
        return "fasta_gz"
    if p.endswith(".fasta"):
        return "fasta"
    if p.endswith(".fastq"):
        return "fastq"
    return None


class NativeFileReader:
    """Streams one read file into caller-managed [B, L] planes."""

    def __init__(self, path: str, fmt: str, u_is_t: bool):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastx library unavailable")
        self.lib = lib
        self.u_is_t = 1 if u_is_t else 0
        self._ring = np.zeros(3, dtype=np.int64)  # the fill's read-ahead counts
        self.handle = lib.fx_open(
            str(path).encode(), FORMAT_CODES[fmt], self.u_is_t
        )
        if not self.handle:
            self.handle = None
            raise FileNotFoundError(path)

    def fill(self, row0: int, codes: np.ndarray, lengths: np.ndarray,
             packed: np.ndarray, exc: np.ndarray, n_exc: np.ndarray,
             acc_buf: np.ndarray, acc_off: np.ndarray,
             seq_buf: np.ndarray, seq_off: np.ndarray) -> tuple[int, bool, tuple]:
        """Fill rows [row0, B) of ``codes`` and of their packed words
        (uint32 [B, ceil(L/16)]), appending the rows' in-length non-ACGT
        positions to ``exc`` (int32 [cap]) after the ``n_exc[0]`` there
        (``n_exc[0]`` keeps counting past the cap); returns (rows_filled,
        eof, (blocks, waits, wait_ns)): the read-ahead blocks this fill
        took, how many of them it waited for, and the nanoseconds it
        waited."""
        b, l = codes.shape
        if (packed.shape != (b, (l + 15) // 16) or packed.dtype != np.uint32
                or not packed.flags.c_contiguous or exc.dtype != np.int32
                or n_exc.dtype != np.int32):
            raise ValueError("packed words or exception list do not fit the code plane")
        eof = ctypes.c_int32(0)
        ring = self._ring
        n = self.lib.fx_next_batch_packed(
            self.handle, row0, b, l, self.u_is_t,
            codes.ctypes.data_as(ctypes.c_void_p),
            lengths.ctypes.data_as(ctypes.c_void_p),
            packed.ctypes.data_as(ctypes.c_void_p),
            exc.ctypes.data_as(ctypes.c_void_p), len(exc),
            n_exc.ctypes.data_as(ctypes.c_void_p),
            acc_buf.ctypes.data_as(ctypes.c_void_p), acc_buf.nbytes,
            acc_off.ctypes.data_as(ctypes.c_void_p),
            seq_buf.ctypes.data_as(ctypes.c_void_p), seq_buf.nbytes,
            seq_off.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(eof), ring.ctypes.data_as(ctypes.c_void_p),
        )
        if n < 0:
            raise RuntimeError("native reader text buffer overflow")
        return n, bool(eof.value), (int(ring[0]), int(ring[1]), int(ring[2]))

    def close(self):
        if self.handle:
            self.lib.fx_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()
