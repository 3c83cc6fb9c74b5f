"""Build, load and call the port's CUDA kernels.

Each source under ``kmer_id_tpu_torch/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
ctypes.  The library is built at first use into ``build/kmer_id_tpu_torch/``
at the repository root, keyed by a hash of its source and flags, so a fresh
checkout builds it once and reuses it afterwards.  :func:`check_tensor`,
:func:`ptr` and :func:`launch` are what every kernel wrapper in ``ops/``
uses to check its arguments and call a library's C entry, and
:class:`LaunchCount` is each wrapper's count of its launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from kmer_id_tpu_torch.utils import timing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kmer_id_tpu_torch")
_BUILD_LOCK = threading.Lock()  # one build at a time per process
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str) -> tuple[str, str]:
    """(source, keyed library path) of ``csrc/<name>.cu``."""
    src = os.path.join(_SRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_many(names) -> dict:
    """Compile every ``csrc/<name>.cu`` whose keyed library is missing, one
    nvcc process per source, all started together.

    Returns {name: (library path, info)} where info holds the build seconds
    (0 when the library was already built) and the compiler's
    ``-Xptxas -v`` report.  Safe to call from several threads: the
    pipeline's submitter and collector may both reach a kernel first.
    In the thread's trace the call is a ``kernel.build`` span.
    """
    with timing.span(timing.current(), "kernel.build"), _BUILD_LOCK:
        return _build_many(names)


def _build_many(names) -> dict:
    out, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        src, so = _paths(name)
        if os.path.exists(so):
            report = ""
            if os.path.exists(so + ".log"):
                with open(so + ".log") as f:
                    report = f.read()
            out[name] = (so, {"seconds": 0.0, "ptxas": report})
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        running[name] = (src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (src, so, tmp, proc) in running.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{report}")
        with open(so + ".log", "w") as f:
            f.write(report)
        os.replace(tmp, so)
        out[name] = (so, {"seconds": time.perf_counter() - t0, "ptxas": report})
    return out


def build(name: str) -> tuple[str, dict]:
    """:func:`build_many` of one source."""
    return build_many([name])[name]


@functools.cache
def load_compact():
    """The rank-compaction library, built on first use."""
    so, _ = build("compact")
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    i = ctypes.c_int
    q = ctypes.c_longlong
    lib.kmer_compact_ranks.argtypes = [p, p] + [p, q, i] * 3 + [i, p, p, p, p, p, i, i, i, i, p]
    lib.kmer_compact_ranks.restype = ctypes.c_int
    return lib


@functools.cache
def load_gate():
    """The window-gate library (``csrc/gate.cu``), built on first use."""
    so, _ = build("gate")
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    i = ctypes.c_int
    u = ctypes.c_uint32
    lib.kmer_window_gate.argtypes = [p, i, p, i, p, p, i, i, i, p, u, u, u, i, p, p, p, p, p]
    lib.kmer_window_gate.restype = ctypes.c_int
    lib.kmer_window_extract.argtypes = [p, i, p, i, p, p, i, i, i, p, p, p, p, p]
    lib.kmer_window_extract.restype = ctypes.c_int
    return lib


@functools.cache
def load_probe():
    """The probe + verify library (``csrc/probe.cu``), built on first use."""
    so, _ = build("probe")
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    i = ctypes.c_int
    u = ctypes.c_uint32
    lib.kmer_probe.argtypes = ([p, p, p, p, i, i, p, u, u, u, p, u, i, p] + [u] * 5
                               + [p, i, p, i, i, i] + [p] * 15 + [p])
    lib.kmer_probe.restype = ctypes.c_int
    lib.kmer_probe_slots.argtypes = [p, p, p, i, i, p, u, u, u, p, u, i, p] + [u] * 5 + [p, p, p]
    lib.kmer_probe_slots.restype = ctypes.c_int
    return lib


def check_tensor(fn: str, name, t, dtype, shape, device):
    """Raises unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the kernel wrappers' argument check; ``fn`` names the
    wrapper in the message)."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


def ptr(t):
    """A tensor's data pointer as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def launch(fn, name: str, device, *args):
    """Calls a kernel library's C entry ``fn`` with ``args`` and the current
    stream of ``device``; raises on the cudaError value it returns."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


class LaunchCount:
    """A kernel wrapper's count of its launches: :meth:`add` where the
    wrapper launches its kernel, :attr:`value` to read, :meth:`reset` to
    zero.  A lock keeps ``add`` exact when the pipeline's submitter and
    collector threads launch the same kernel."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n
