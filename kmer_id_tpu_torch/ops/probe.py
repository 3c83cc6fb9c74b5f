"""Probe + verify: from a read's Bloom-passing windows to its verified hits.

Stages 5-6 of the engine per short-read batch (and per chunk group of the
long-read lane), on the Bloom path.  From the window gate's ``(wpos, whi,
wlo)`` [B, K] (``SENT`` past a read's last passing window) it computes each
window's L1 and two L2 fingerprint candidates, ranks them in (window, plane)
order, keeps the first ``max_hits``, verifies each against the full key in
``rec``, resolves (node, tout) from ``tinfo``, marks the verified slots in
``seen`` and reduces each read to its hit summary.  The result is the dict
every caller of the engine's ``_compact_verify`` reads:

* [B, max_hits]: ``cand`` (slot id), ``ver`` (bool), ``tin``, ``tout``,
  ``depth``, ``t`` (the verified hit's target node, 0 elsewhere);
* [B]: ``nh`` (verified hits), ``deepest`` / ``dtgt`` (slot and target of
  the first deepest verified hit; column 0's when none verified),
  ``consistent`` (every verified hit an ancestor-or-self of the deepest),
  ``overflow`` (more candidates than ``max_hits``).

Three versions, as in ops/gate.py: :func:`probe_verify_plain` (plain
PyTorch: ops/lookup.py's ``fp_candidates``, the interleave, the two-tier
compact-and-verify and the summary), :func:`probe_verify_cuda` (the CUDA
kernel ``csrc/probe.cu``) and :func:`probe_verify`, the engine's entry: a
CUDA tensor goes to the kernel, a CPU tensor to the plain version, with no
fallback between the two.

The two versions agree on every output except at slots the downstream never
reads: ``tin``/``tout``/``depth`` where ``ver`` is false (the plain version
leaves what the compaction padding and ``rec`` give there; the kernel writes
``tout`` only for verified hits and 0 at unplaced slots).  The fold ignores
``t == 0``, and ``consistent``, the summary plane and ``fp_long_finals``
mask by ``ver``.

The compact-and-verify helpers (:func:`cv_tier`, :func:`two_tier`,
:func:`verify_summary`, :func:`mark_seen`) also serve the engine's dense and
no-Bloom branches, which probe every window and keep ``csrc/compact.cu``.

**Shard mode** (:func:`probe_hits_plain`, :func:`probe_hits_cuda`, the
kernel's second entry, and :func:`probe_hits`): the same pass on one rank
of the sharded engine's grid (parallel/fpsharded.py), ``local_hits`` of
``kmer_id_tpu/parallel/fpsharded.py:304-346`` after the gate.  The rank's
candidates (ops/lookup.py ``fp_candidates_shard``: L1 only in its bucket
range, L2 only on db rank 0, local slot ids) are ranked to ``sh``, verified
against its local ``rec`` and marked in its ``seen``; the result is the
narrow hit plane the grid gathers, [B, sh]: ``posk`` (window position of a
verified hit, ``SENT`` elsewhere), ``cand``, ``tgt``, ``tin`` and ``td``
(``(tout & 0xFFFFFF) | depth << 24`` as int32 bits) of verified hits (0
elsewhere), ``ver``; and ``ncand`` [B], the rank's full candidate count.
The two versions agree on every output.
"""

from __future__ import annotations

import torch

from kmer_id_tpu_torch.kernels.build import LaunchCount, check_tensor, launch, load_probe, ptr
from kmer_id_tpu_torch.ops.compact import (
    SENT,
    compact_ranks,
    compact_ranks_plain,
    interleave_planes,
)
from kmer_id_tpu_torch.ops.lookup import fp_candidates, fp_candidates_shard

FAST_HITS = 8  # fast verify tier's candidate budget
KERNEL_MAX_HITS = 32  # one warp per read: at most one output column per lane
N_PLANES = 3  # L1, L2 choice 1, L2 choice 2


def mark_seen(seen, idx):
    """seen[idx] = 1 for every index (unverified lanes point at the sink)."""
    seen.index_fill_(0, idx.reshape(-1).long(), 1)


def _pad_cols(x, n: int):
    return torch.cat([x, x.new_zeros((x.shape[0], n))], dim=1) if n else x


def cv_tier(db, qhi, qlo, cand_ilv, valid_ilv, pos, mh: int, out_mh: int, seen,
            compact=compact_ranks):
    """Compact to ``mh`` candidates, verify against ``rec``, resolve (node,
    tout) from ``tinfo``, mark verified slots in ``seen``.  Returns (cand,
    ver, tin, tout, depth, t) [B, out_mh] (pads are unverified).  The query
    key words ``qhi``/``qlo`` and the positions ``pos`` ride as compaction
    payloads in any form ops/compact.py takes with ``r = N_PLANES``: per
    window ([B or 1, C / N_PLANES]) or per interleaved column; ``compact``
    is an ops/compact.py formulation."""
    b = cand_ilv.shape[0]
    mh = min(mh, cand_ilv.shape[1])
    pos32, cand32, _, (qhi, qlo) = compact(
        cand_ilv, valid_ilv, pos, mh, extras=(qhi, qlo), r=N_PLANES
    )
    has = pos32 < SENT
    rows = db["rec"].index_select(0, cand32.reshape(-1)).view(b, mh, 3)
    ver = has & (rows[..., 0] == qhi) & (rows[..., 1] == qlo)
    tin = rows[..., 2] & 0xFFFFFF
    depth = (rows[..., 2] >> 24) & 0xFF
    info = db["tinfo"].index_select(0, tin.reshape(-1)).view(b, mh, 2)
    t = torch.where(ver, info[..., 0], 0)
    tout = info[..., 1]
    if seen is not None:
        mark_seen(seen, torch.where(ver, cand32, seen.shape[0] - 1))
    return tuple(_pad_cols(x, out_mh - mh) for x in (cand32, ver, tin, tout, depth, t))


def two_tier(db, qhi, qlo, cand_ilv, valid_ilv, pos, max_hits: int, seen,
             compact=compact_ranks):
    """:func:`cv_tier` at ``FAST_HITS`` when no read has more candidates
    (one host sync), else at ``max_hits``; the payloads as :func:`cv_tier`
    takes them.  Returns (tier outputs, ncand int32 [B])."""
    args = (db, qhi, qlo, cand_ilv, valid_ilv, pos)
    ncand = valid_ilv.sum(dim=1, dtype=torch.int32)
    mh = max_hits
    if max_hits > FAST_HITS and int(ncand.max()) <= FAST_HITS:
        mh = FAST_HITS
    return cv_tier(*args, mh, max_hits, seen, compact), ncand


def verify_summary(res, ncand, max_hits: int) -> dict:
    """The per-read dict (module doc) from a tier's outputs: the first
    deepest verified hit (argmax's first index over ``where(ver, depth,
    -1)``), the consistency test against it, and the overflow flag."""
    cand, ver, tin, tout, depth, t = res
    j = torch.where(ver, depth, -1).argmax(dim=1, keepdim=True)
    dtin = tin.gather(1, j)
    return {
        "cand": cand, "ver": ver, "nh": ver.sum(dim=1, dtype=torch.int32),
        "deepest": cand.gather(1, j)[:, 0],
        "consistent": (~ver | ((tin <= dtin) & (dtin <= tout))).all(dim=1),
        "overflow": ncand > max_hits, "dtgt": t.gather(1, j)[:, 0],
        "tin": tin, "tout": tout, "t": t, "depth": depth,
    }


def probe_verify_plain(db, wpos, whi, wlo, max_hits: int, seen=None) -> dict:
    """Probe + verify in plain PyTorch (module doc): every compaction by
    ``compact_ranks_plain``, so no kernel runs on any device."""
    wvalid = wpos < SENT
    wp = torch.where(wvalid, wpos, 0)
    ci, vi = interleave_planes(fp_candidates(db, whi, wlo, wvalid))
    res, ncand = two_tier(db, whi, wlo, ci, vi, wp, max_hits, seen, compact_ranks_plain)
    return verify_summary(res, ncand, max_hits)


def _pow2_rows(fn: str, name: str, t) -> int:
    n = t.shape[0]
    if n == 0 or n & (n - 1) or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} needs a power-of-two row count and 16-byte alignment")
    return n


def probe_verify_cuda(db, wpos, whi, wlo, max_hits: int, seen=None) -> dict:
    """Probe + verify by the CUDA kernel ``csrc/probe.cu`` (module doc).
    Raises on a table, a window plane or a budget the kernel does not take
    (``max_hits`` in [1, 32], at most 32 windows per read), and if the
    build or the launch fails.  ``probe_verify_cuda.launches`` counts
    launches."""
    name = "probe_verify_cuda"
    dev = wpos.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, not on a CUDA device")
    if not 1 <= max_hits <= KERNEL_MAX_HITS:
        raise ValueError(f"{name}: max_hits {max_hits} outside [1, {KERNEL_MAX_HITS}]")
    if wpos.dim() != 2 or not 1 <= wpos.shape[1] <= 32:
        raise ValueError(f"{name}: wpos must be [B, K] with 1 <= K <= 32")
    b, k = wpos.shape
    for what, t in (("wpos", wpos), ("whi", whi), ("wlo", wlo)):
        check_tensor(name, what, t, torch.int32, (b, k), dev)
    fptab, fptab2, rec, tinfo = db["fptab"], db["fptab2"], db["rec"], db["tinfo"]
    nb1, nb2 = _pow2_rows(name, "fptab", fptab), _pow2_rows(name, "fptab2", fptab2)
    check_tensor(name, "fptab", fptab, torch.int32, (nb1, 4), dev)
    check_tensor(name, "fptab2", fptab2, torch.int32, (nb2, 4), dev)
    n_slots = (nb1 + nb2) * 8
    if n_slots > SENT:
        raise ValueError(f"{name}: {n_slots} slots do not fit int32 slot ids")
    check_tensor(name, "rec", rec, torch.int32, (n_slots, 3), dev)
    check_tensor(name, "tinfo", tinfo, torch.int32, (tinfo.shape[0], 2), dev)
    if seen is not None:
        check_tensor(name, "seen", seen, torch.int8, (seen.shape[0],), dev)
        if seen.shape[0] < n_slots:
            raise ValueError(f"{name}: seen holds {seen.shape[0]} of {n_slots} slots")

    def plane(dtype):
        return torch.empty((b, max_hits), dtype=dtype, device=dev)

    def col(dtype):
        return torch.empty((b,), dtype=dtype, device=dev)

    out = {"cand": plane(torch.int32), "ver": plane(torch.bool), "tin": plane(torch.int32),
           "tout": plane(torch.int32), "depth": plane(torch.int32), "t": plane(torch.int32),
           "nh": col(torch.int32), "deepest": col(torch.int32), "dtgt": col(torch.int32),
           "consistent": col(torch.bool), "overflow": col(torch.bool)}
    if b == 0:
        return out
    salts = [db[f"fp_s{i}"] & 0xFFFFFFFF for i in range(1, 6)]
    lib = load_probe()
    launch(lib.kmer_probe_verify, "probe_verify", dev, ptr(wpos), ptr(whi), ptr(wlo), b, k,
            ptr(fptab), nb1, ptr(fptab2), nb2, ptr(rec), ptr(tinfo), tinfo.shape[0],
            *salts, None if seen is None else ptr(seen), max_hits,
            *(ptr(out[n]) for n in ("cand", "ver", "tin", "tout", "depth", "t", "nh",
                                    "deepest", "dtgt", "consistent", "overflow")))
    probe_verify_cuda.launches.add()
    return out


probe_verify_cuda.launches = LaunchCount()


def probe_verify(db, wpos, whi, wlo, max_hits: int, seen=None) -> dict:
    """Engine entry: the kernel for windows on a CUDA device, the plain
    version for windows on the CPU."""
    if wpos.device.type == "cuda":
        return probe_verify_cuda(db, wpos, whi, wlo, max_hits, seen)
    return probe_verify_plain(db, wpos, whi, wlo, max_hits, seen)


# ------------------------------------------------------------ shard mode

HIT_FIELDS = ("posk", "cand", "tgt", "tin", "td", "ver")


def probe_hits_plain(db, wpos, whi, wlo, sh: int, b0: int, nbloc: int, own2: bool, seen=None,
                     compact=compact_ranks_plain) -> dict:
    """Shard mode in plain PyTorch (module doc): ``fp_candidates_shard``,
    the interleave, the compaction to ``sh`` with the key words as payloads
    (``compact``: an ops/compact.py formulation; the plain one by default),
    the ``rec`` verify and the ``tinfo`` lookup.  ``db`` holds the rank's
    tables (``fptab`` [nbloc, 4], ``fptab2``, ``rec`` [(nbloc + nb2) * 8,
    3], ``tinfo``, the salts, and ``nb1``, the global L1 bucket count)."""
    wvalid = wpos < SENT
    wp = torch.where(wvalid, wpos, 0)
    ci, vi = interleave_planes(fp_candidates_shard(db, whi, wlo, wvalid, b0, nbloc, own2))
    pos32, cand32, ncand, (qhi, qlo) = compact(ci, vi, wp, sh, extras=(whi, wlo), r=N_PLANES)
    b = cand32.shape[0]
    rows = db["rec"].index_select(0, cand32.reshape(-1)).view(b, sh, 3)
    ver = (pos32 < SENT) & (rows[..., 0] == qhi) & (rows[..., 1] == qlo)
    tinw = rows[..., 2]
    tin = tinw & 0xFFFFFF
    tinfo = db["tinfo"]
    known = ver & (tin < tinfo.shape[0])
    info = tinfo.index_select(0, torch.where(known, tin, 0).reshape(-1)).view(b, sh, 2)
    info = torch.where(known[..., None], info, 0)
    td = (info[..., 1] & 0xFFFFFF) | (tinw & -(1 << 24))  # the depth byte as rec holds it
    if seen is not None:
        mark_seen(seen, torch.where(ver, cand32, seen.shape[0] - 1))
    return {"posk": torch.where(ver, pos32, SENT), "cand": cand32, "tgt": info[..., 0],
            "tin": torch.where(ver, tin, 0), "td": torch.where(ver, td, 0), "ver": ver,
            "ncand": ncand}


def probe_hits_cuda(db, wpos, whi, wlo, sh: int, b0: int, nbloc: int, own2: bool,
                    seen=None) -> dict:
    """Shard mode by the CUDA kernel ``csrc/probe.cu`` (module doc).  Raises
    on a table, a window plane or a budget the kernel does not take (``sh``
    in [1, 32], at most 32 windows per read, the rank's bucket range inside
    the global table), and if the build or the launch fails.
    ``probe_hits_cuda.launches`` counts launches."""
    name = "probe_hits_cuda"
    dev = wpos.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, not on a CUDA device")
    if not 1 <= sh <= KERNEL_MAX_HITS:
        raise ValueError(f"{name}: sh {sh} outside [1, {KERNEL_MAX_HITS}]")
    if wpos.dim() != 2 or not 1 <= wpos.shape[1] <= 32:
        raise ValueError(f"{name}: wpos must be [B, K] with 1 <= K <= 32")
    b, k = wpos.shape
    for what, t in (("wpos", wpos), ("whi", whi), ("wlo", wlo)):
        check_tensor(name, what, t, torch.int32, (b, k), dev)
    fptab, fptab2, rec, tinfo = db["fptab"], db["fptab2"], db["rec"], db["tinfo"]
    nb1 = int(db["nb1"])
    if nb1 < 1 or nb1 & (nb1 - 1) or not (nbloc >= 1 and 0 <= b0 and b0 + nbloc <= nb1):
        raise ValueError(f"{name}: buckets [{b0}, {b0 + nbloc}) outside a power-of-two "
                         f"table of {nb1}")
    if fptab.data_ptr() % 16:
        raise ValueError(f"{name}: fptab needs 16-byte alignment")
    nb2 = _pow2_rows(name, "fptab2", fptab2)
    check_tensor(name, "fptab", fptab, torch.int32, (nbloc, 4), dev)
    check_tensor(name, "fptab2", fptab2, torch.int32, (nb2, 4), dev)
    n_slots = (nbloc + nb2) * 8
    if n_slots > SENT:
        raise ValueError(f"{name}: {n_slots} slots do not fit int32 slot ids")
    check_tensor(name, "rec", rec, torch.int32, (n_slots, 3), dev)
    check_tensor(name, "tinfo", tinfo, torch.int32, (tinfo.shape[0], 2), dev)
    if seen is not None:
        check_tensor(name, "seen", seen, torch.int8, (seen.shape[0],), dev)
        if seen.shape[0] < n_slots:
            raise ValueError(f"{name}: seen holds {seen.shape[0]} of {n_slots} slots")
    out = {f: torch.empty((b, sh), dtype=torch.int32, device=dev) for f in HIT_FIELDS}
    out["ver"] = torch.empty((b, sh), dtype=torch.bool, device=dev)
    out["ncand"] = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    salts = [db[f"fp_s{i}"] & 0xFFFFFFFF for i in range(1, 6)]
    launch(load_probe().kmer_probe_hits, "probe_hits", dev, ptr(wpos), ptr(whi), ptr(wlo), b, k,
           ptr(fptab), nb1, b0, nbloc, ptr(fptab2), nb2, int(bool(own2)), ptr(rec), ptr(tinfo),
           tinfo.shape[0], *salts, None if seen is None else ptr(seen), sh,
           *(ptr(out[f]) for f in HIT_FIELDS + ("ncand",)))
    probe_hits_cuda.launches.add()
    return out


probe_hits_cuda.launches = LaunchCount()


def probe_hits(db, wpos, whi, wlo, sh: int, b0: int, nbloc: int, own2: bool, seen=None) -> dict:
    """Engine entry of shard mode: the kernel for windows on a CUDA device,
    the plain version for windows on the CPU."""
    if wpos.device.type == "cuda":
        return probe_hits_cuda(db, wpos, whi, wlo, sh, b0, nbloc, own2, seen)
    return probe_hits_plain(db, wpos, whi, wlo, sh, b0, nbloc, own2, seen)
