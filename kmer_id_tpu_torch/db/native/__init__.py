"""Native builder-kernel loader: compiles kmer_native.cpp on demand (ctypes).

Same pattern as io/native: a plain C-ABI shared object built with g++ at
first use into ``build/kmer_id_tpu_torch/`` at the repository root (keyed by
a source hash; the directory is not committed), driven with zero-copy NumPy
buffers.  ``get_lib() is None`` when no compiler is available — db/build.py's
NumPy formulations remain the behavioral reference and fallback, and tests
assert both paths produce identical arrays.

Copy of ``kmer_id_tpu/db/native/`` (this module, without the uint64 sorts
that no caller uses, and ``kmer_native.cpp``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kmer_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_DIR))),
                          "build", "kmer_id_tpu_torch")

_lib = None
_lib_tried = False


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libkmer_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"  # concurrent builders each rename a whole file
    r = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp, "-lz"],
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
    p = ctypes.c_void_p
    i32 = ctypes.c_int32
    i64 = ctypes.c_int64
    lib.km_load_genome.restype = p
    lib.km_load_genome.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.km_genome_len.restype = i64
    lib.km_genome_len.argtypes = [p]
    lib.km_free_genome.argtypes = [p]
    lib.km_extract_unique.restype = i64
    lib.km_extract_unique.argtypes = [p, ctypes.c_int, p, p, p]
    lib.km_argsort_i32.argtypes = [p, i64, p]
    lib.km_keys_to_str.argtypes = [p, i64, p]
    lib.km_entropy.argtypes = [p, i64, p, ctypes.c_double, ctypes.c_double,
                               i32, p]
    lib.km_emit_walk.restype = i64
    lib.km_emit_walk.argtypes = [p, p, p, p, p, i32, i64, p]
    lib.km_merge_runs.restype = i64
    lib.km_merge_runs.argtypes = [i32, p, p, p, p, p, p, i32, p, p, p]
    lib.km_pass3_candidates.restype = i64
    lib.km_pass3_candidates.argtypes = [p, i64, p, p, p, p, p, i64,
                                        p, p, p, p]
    lib.km_write_probes.restype = i32
    lib.km_write_probes.argtypes = [ctypes.c_char_p, p, p, p, p, p, p, i64]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


GENOME_KIND = {"gz": 0, "contigs": 1}


def genome_unique_counts(path: str, kind: str, u_is_t: bool = False
                         ) -> tuple[np.ndarray, np.ndarray] | None:
    """(sorted unique canonical keys, occurrence counts) of one genome —
    native twin of load-genome + codec.canonical_kmers + np.unique."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.km_load_genome(path.encode(), GENOME_KIND[kind], 1 if u_is_t else 0)
    if not h:
        raise SystemExit(1)  # kmer_build_vf6.cpp:772 (missing genome)
    try:
        cap = max(int(lib.km_genome_len(h)), 1)
        uk = np.empty(cap, dtype=np.uint64)
        counts = np.empty(cap, dtype=np.int32)
        n = lib.km_extract_unique(h, 0, _ptr(uk), _ptr(counts), None)
        return uk[:n], counts[:n]
    finally:
        lib.km_free_genome(h)


def genome_unique_first(path: str, kind: str, u_is_t: bool = False
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """(sorted unique keys, first-occurrence end positions, first-occurrence
    forward-strand flags) — native twin of the pass-3 first-occurrence dedup
    (np.unique(keys, return_index) over canonical_kmers output)."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.km_load_genome(path.encode(), GENOME_KIND[kind], 1 if u_is_t else 0)
    if not h:
        raise SystemExit(1)
    try:
        cap = max(int(lib.km_genome_len(h)), 1)
        uk = np.empty(cap, dtype=np.uint64)
        pos = np.empty(cap, dtype=np.int32)
        fwd = np.empty(cap, dtype=np.uint8)
        n = lib.km_extract_unique(h, 1, _ptr(uk), _ptr(pos), _ptr(fwd))
        return uk[:n], pos[:n], fwd[:n].astype(bool)
    finally:
        lib.km_free_genome(h)


def argsort_i32(a: np.ndarray) -> np.ndarray | None:
    """Stable ascending argsort of a non-negative int32 array (radix)."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.int32)
    out = np.empty(len(a), dtype=np.int64)
    lib.km_argsort_i32(_ptr(a), len(a), _ptr(out))
    return out


def keys_to_strings(keys: np.ndarray) -> np.ndarray | None:
    """[n] uint64 -> [n] bytes-30 array of k-mer strings."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(len(keys), dtype="S30")
    lib.km_keys_to_str(_ptr(keys), len(keys), _ptr(out))
    return out


def _entropy_fterm() -> np.ndarray:
    """f[group][c] = -((c/T) * log10(c/T)) computed WITH np.log10 so the
    native filter's accepts are bit-identical to db/entropy's (both then
    sum in NumPy's pairwise axis-1 order)."""
    f = np.zeros((3, 32), dtype=np.float64)
    for g, total in enumerate((19.0, 14.0, 10.0)):  # mod2/mod3/mod5 + 4
        c = np.arange(1, 32, dtype=np.float64)
        p = c / total
        f[g, 1:] = -(p * np.log10(p))
    return f


_FTERM = None


def check_entropy_keys(keys: np.ndarray, min_entropy: float = 0.80,
                       max_run: int = 11) -> np.ndarray | None:
    """Native twin of db/entropy.check_entropy_keys (boolean accept mask)."""
    global _FTERM
    lib = get_lib()
    if lib is None:
        return None
    if _FTERM is None:
        _FTERM = np.ascontiguousarray(_entropy_fterm())
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    ok = np.empty(len(keys), dtype=np.uint8)
    lib.km_entropy(_ptr(keys), len(keys), _ptr(_FTERM),
                   float(np.log10(4.0)), float(min_entropy), int(max_run),
                   _ptr(ok))
    return ok.astype(bool)


def merge_runs(runs, parent: np.ndarray, depth: np.ndarray, maxrep: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """K-way merge of sorted (keys, counts, targets) runs with saturating
    count sum + tree-LCA target fold — native twin of TableBuilder's
    sort + reduceat + segmented_lca consolidation."""
    lib = get_lib()
    if lib is None or not runs:
        return None
    runs = [
        (
            np.ascontiguousarray(k, dtype=np.uint64),
            np.ascontiguousarray(c, dtype=np.int32),
            np.ascontiguousarray(t, dtype=np.int32),
        )
        for k, c, t in runs
    ]
    nr = len(runs)
    kp = (ctypes.c_void_p * nr)(*[r[0].ctypes.data for r in runs])
    cp = (ctypes.c_void_p * nr)(*[r[1].ctypes.data for r in runs])
    tp = (ctypes.c_void_p * nr)(*[r[2].ctypes.data for r in runs])
    lens = np.array([len(r[0]) for r in runs], dtype=np.int64)
    parent = np.ascontiguousarray(parent, dtype=np.int32)
    depth = np.ascontiguousarray(depth, dtype=np.int32)
    total = int(lens.sum())
    ok = np.empty(total, dtype=np.uint64)
    oc = np.empty(total, dtype=np.int32)
    ot = np.empty(total, dtype=np.int32)
    n = lib.km_merge_runs(nr, kp, cp, tp, _ptr(lens), _ptr(parent),
                          _ptr(depth), int(maxrep), _ptr(ok), _ptr(oc),
                          _ptr(ot))
    return ok[:n], oc[:n], ot[:n]


def pass3_candidates(table_keys: np.ndarray, consumed: np.ndarray,
                     emittable: np.ndarray, uk: np.ndarray, up: np.ndarray,
                     uf: np.ndarray):
    """Galloping sorted lookup + destructive consume + fresh/emittable gates
    + genome-position reorder (db/build pass 3 twin).  MUTATES ``consumed``.
    Returns (ck, cp, cf, cti) pos-ordered, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    assert table_keys.dtype == np.uint64 and consumed.dtype == np.bool_
    assert emittable.dtype == np.bool_ and uk.dtype == np.uint64
    n = len(uk)
    ck = np.empty(n, dtype=np.uint64)
    cp = np.empty(n, dtype=np.int32)
    cf = np.empty(n, dtype=np.uint8)
    cti = np.empty(n, dtype=np.int64)
    up = np.ascontiguousarray(up, dtype=np.int32)
    uf8 = np.ascontiguousarray(uf, dtype=np.uint8)
    m = lib.km_pass3_candidates(
        _ptr(table_keys), len(table_keys), _ptr(consumed), _ptr(emittable),
        _ptr(uk), _ptr(up), _ptr(uf8), n, _ptr(ck), _ptr(cp), _ptr(cf),
        _ptr(cti),
    )
    return ck[:m], cp[:m], cf[:m].astype(bool), cti[:m]


def write_probes(path: str, keys, target, org, position, fstrand, count
                 ) -> bool:
    """Native probe-text writer (plain text only); False -> caller falls
    back to the Python writer."""
    lib = get_lib()
    if lib is None or str(path).endswith(".gz"):
        return False
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    target = np.ascontiguousarray(target, dtype=np.int32)
    org = np.ascontiguousarray(org, dtype=np.int32)
    position = np.ascontiguousarray(position, dtype=np.int32)
    fstrand = np.ascontiguousarray(fstrand, dtype=np.uint8)
    count = np.ascontiguousarray(count, dtype=np.int32)
    r = lib.km_write_probes(str(path).encode(), _ptr(keys), _ptr(target),
                            _ptr(org), _ptr(position), _ptr(fstrand),
                            _ptr(count), len(keys))
    return r == 0


def emit_walk(ctarg: np.ndarray, nxt: np.ndarray, run_next: np.ndarray,
              ent_known: np.ndarray, pcount_trial: np.ndarray, cap: int
              ) -> np.ndarray | None:
    """Native pass-3 chain walk; MUTATES pcount_trial; returns emit_js."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(ctarg)
    ctarg = np.ascontiguousarray(ctarg, dtype=np.int32)
    nxt = np.ascontiguousarray(nxt, dtype=np.int64)
    run_next = np.ascontiguousarray(run_next, dtype=np.int64)
    ent_known = np.ascontiguousarray(ent_known, dtype=np.int8)
    assert pcount_trial.dtype == np.int32 and pcount_trial.flags.c_contiguous
    out = np.empty(n, dtype=np.int64)
    m = lib.km_emit_walk(_ptr(ctarg), _ptr(nxt), _ptr(run_next),
                         _ptr(ent_known), _ptr(pcount_trial), int(cap), n,
                         _ptr(out))
    return out[:m].copy()
