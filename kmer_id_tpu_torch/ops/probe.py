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

**Every-window pass** (:func:`probe_verify_dense_plain`,
:func:`probe_verify_dense_cuda`, :func:`probe_verify_dense`): the same
function for the engine's callers that probe every window of a read rather
than the gate's survivors, the dense path of a Bloom DB and a DB without a
filter.  It takes extract's planes (``hi``, ``lo`` int32 [B, P], ``valid``
bool [B, P], any P >= 1; the window position is the column) and returns the
same dict, under the same masking rule.  Its plain version is the chain the
kernel replaces (ops/lookup.py's ``fp_candidates``, the interleave,
:func:`cv_tier` at ``max_hits`` on the dense path, :func:`two_tier` with its
host sync on a DB without a filter, :func:`verify_summary`); the kernel
ranks straight to ``max_hits``.  No card path runs the plain chains or
``csrc/compact.cu`` here.

Every ``*_cuda`` wrapper of this module but the slots mode's launches one
kernel, ``csrc/probe.cu``'s probe pass (its C entry ``kmer_probe``), which
takes either window planes and any number of windows; each wrapper keeps
its own launch count.

**Shard mode** (:func:`probe_hits_plain`, :func:`probe_hits_cuda` and
:func:`probe_hits`): the same pass on one rank
of the sharded engine's grid (parallel/fpsharded.py), ``local_hits`` of
``kmer_id_tpu/parallel/fpsharded.py:304-346`` after the gate.  The rank's
candidates (ops/lookup.py ``fp_candidates_shard``: L1 only in its bucket
range, L2 only on db rank 0, local slot ids) are ranked to ``sh``, verified
against its local ``rec`` and marked in its ``seen``; the result is the
narrow hit plane the grid gathers, [B, sh]: ``posk`` (window position of a
verified hit, ``SENT`` elsewhere), ``cand``, ``tgt``, ``tin`` and ``td``
(``(tout & 0xFFFFFF) | depth << 24`` as int32 bits) of verified hits (0
elsewhere), ``ver``; and ``ncand`` [B], the rank's full candidate count.
The two versions agree on every output.  Its every-window form
(:func:`probe_hits_dense_plain`, :func:`probe_hits_dense_cuda`,
:func:`probe_hits_dense`) serves a rank whose DB takes no filter, from
extract's planes as above.

**Slots mode** (:func:`probe_slots_plain`, :func:`probe_slots_cuda`,
:func:`probe_slots`): every window's verified slot and its rec ``tin``, the
exact replay of reads past the candidate budget (the engine's ``fp_slots``)
and of a grid rank's long reads and replays (``_step_targets``), for the
unsharded tables or a grid rank's.  The two versions agree on every output.
"""

from __future__ import annotations

import torch

from kmer_id_tpu_torch.kernels.build import LaunchCount, check_tensor, launch, load_probe, ptr
from kmer_id_tpu_torch.ops.compact import SENT, compact_ranks_plain, interleave_planes
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
            compact=compact_ranks_plain):
    """Compact to ``mh`` candidates, verify against ``rec``, resolve (node,
    tout) from ``tinfo``, mark verified slots in ``seen``.  Returns (cand,
    ver, tin, tout, depth, t) [B, out_mh] (pads are unverified).  The query
    key words ``qhi``/``qlo`` and the positions ``pos`` ride as compaction
    payloads in any form ops/compact.py takes with ``r = N_PLANES``: per
    window ([B or 1, C / N_PLANES]) or per interleaved column; ``compact``
    is an ops/compact.py formulation (the plain one by default)."""
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


def two_tier(db, qhi, qlo, cand_ilv, valid_ilv, pos, max_hits: int, seen):
    """:func:`cv_tier` at ``FAST_HITS`` when no read has more candidates
    (one host sync), else at ``max_hits``; the payloads as :func:`cv_tier`
    takes them.  Returns (tier outputs, ncand int32 [B])."""
    args = (db, qhi, qlo, cand_ilv, valid_ilv, pos)
    ncand = valid_ilv.sum(dim=1, dtype=torch.int32)
    mh = max_hits
    if max_hits > FAST_HITS and int(ncand.max()) <= FAST_HITS:
        mh = FAST_HITS
    return cv_tier(*args, mh, max_hits, seen), ncand


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
    res, ncand = two_tier(db, whi, wlo, ci, vi, wp, max_hits, seen)
    return verify_summary(res, ncand, max_hits)


def _pow2_rows(fn: str, name: str, t) -> int:
    n = t.shape[0]
    if n == 0 or n & (n - 1) or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} needs a power-of-two row count and 16-byte alignment")
    return n


def _rec_tinfo_seen(name: str, db, n_slots: int, dev, seen) -> None:
    if n_slots > SENT:
        raise ValueError(f"{name}: {n_slots} slots do not fit int32 slot ids")
    check_tensor(name, "rec", db["rec"], torch.int32, (n_slots, 3), dev)
    check_tensor(name, "tinfo", db["tinfo"], torch.int32, (db["tinfo"].shape[0], 2), dev)
    if seen is not None:
        check_tensor(name, "seen", seen, torch.int8, (seen.shape[0],), dev)
        if seen.shape[0] < n_slots:
            raise ValueError(f"{name}: seen holds {seen.shape[0]} of {n_slots} slots")


def _verify_tables(name: str, db, dev, seen) -> tuple[int, int]:
    """Checks the tables and ``seen`` of the verify entries; returns (nb1,
    nb2)."""
    nb1 = _pow2_rows(name, "fptab", db["fptab"])
    nb2 = _pow2_rows(name, "fptab2", db["fptab2"])
    check_tensor(name, "fptab", db["fptab"], torch.int32, (nb1, 4), dev)
    check_tensor(name, "fptab2", db["fptab2"], torch.int32, (nb2, 4), dev)
    _rec_tinfo_seen(name, db, (nb1 + nb2) * 8, dev, seen)
    return nb1, nb2


def _table_args(db, nb1: int, nb2: int, b0: int, nbloc: int, own2: bool) -> tuple:
    """The kernel's table arguments: fptab, nb1, b0, nbloc, fptab2, nb2,
    own2, rec and the five salts (b0 = 0, nbloc = nb1, own2 for the whole
    tables)."""
    return (ptr(db["fptab"]), nb1, b0, nbloc, ptr(db["fptab2"]), nb2, int(bool(own2)),
            ptr(db["rec"]), *(db[f"fp_s{i}"] & 0xFFFFFFFF for i in range(1, 6)))


PROBE_OUTPUTS = ("cand", "ver", "tin", "tout", "depth", "t", "nh", "deepest", "dtgt",
                 "consistent", "overflow")
HIT_FIELDS = ("posk", "cand", "tgt", "tin", "td", "ver")
# the probe pass's outputs in the order of its C entry
_KERNEL_OUTPUTS = PROBE_OUTPUTS + ("posk", "tgt", "td", "ncand")


def dense_unroll(b: int, p: int) -> int:
    """Tiles of 32 windows per step of the probe pass for ``b`` reads of
    ``p`` windows (csrc/probe.cu): two when the reads span more than one
    tile and are too few to fill the card with warps (under 4096: ~30 warps
    per SM of an H100's 132), else one."""
    return 2 if p > 32 and b < 4096 else 1


def _plane_checks(name: str, hi, lo, valid=None, wpos=None, budget: int | None = None,
                  what: str = "") -> tuple:
    """Checks one entry's window planes (key words ``hi``, ``lo`` int32
    [B, P] and extract's ``valid`` bool or the gate's ``wpos`` int32 [B, P])
    and its budget when given; returns (device, B, P)."""
    dev = hi.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, not on a CUDA device")
    if budget is not None and not 1 <= budget <= KERNEL_MAX_HITS:
        raise ValueError(f"{name}: {what} {budget} outside [1, {KERNEL_MAX_HITS}]")
    if hi.dim() != 2 or hi.shape[1] < 1:
        raise ValueError(f"{name}: hi must be [B, P] with P >= 1")
    b, p = hi.shape
    check_tensor(name, "hi", hi, torch.int32, (b, p), dev)
    check_tensor(name, "lo", lo, torch.int32, (b, p), dev)
    if wpos is None:
        check_tensor(name, "valid", valid, torch.bool, (b, p), dev)
    else:
        check_tensor(name, "wpos", wpos, torch.int32, (b, p), dev)
    return dev, b, p


def _probe_launch(name: str, db, planes: tuple, tables: tuple, seen, mh: int,
                  out: dict) -> None:
    """One launch of probe.cu's probe pass (its ``kmer_probe``): ``planes``
    = (hi, lo, valid, wpos), one of valid and wpos None; ``tables`` from
    :func:`_table_args`; ``out`` the outputs of one mode (a hit plane, with
    ``ncand``, picks shard mode), the other mode's passed as null."""
    b, p = planes[0].shape
    launch(load_probe().kmer_probe, name, planes[0].device,
           *(None if x is None else ptr(x) for x in planes), b, p, *tables, ptr(db["tinfo"]),
           db["tinfo"].shape[0], None if seen is None else ptr(seen), mh, dense_unroll(b, p),
           int("ncand" in out), *(ptr(out[n]) if n in out else None for n in _KERNEL_OUTPUTS))


def _verify_outputs(b: int, max_hits: int, dev) -> dict:
    """The per-read dict's tensors (module doc), uninitialised."""
    out = {}
    for n in PROBE_OUTPUTS:
        shape = (b, max_hits) if n in ("cand", "ver", "tin", "tout", "depth", "t") else (b,)
        dtype = torch.bool if n in ("ver", "consistent", "overflow") else torch.int32
        out[n] = torch.empty(shape, dtype=dtype, device=dev)
    return out


def probe_verify_cuda(db, wpos, whi, wlo, max_hits: int, seen=None) -> dict:
    """Probe + verify by the CUDA kernel ``csrc/probe.cu`` (module doc), from
    the gate's planes.  Raises on a table, a window plane or a budget the
    kernel does not take (``max_hits`` in [1, 32]), and if the build or the
    launch fails.  ``probe_verify_cuda.launches`` counts launches."""
    name = "probe_verify_cuda"
    dev, b, _ = _plane_checks(name, whi, wlo, wpos=wpos, budget=max_hits, what="max_hits")
    nb1, nb2 = _verify_tables(name, db, dev, seen)
    out = _verify_outputs(b, max_hits, dev)
    if b == 0:
        return out
    _probe_launch(name, db, (whi, wlo, None, wpos), _table_args(db, nb1, nb2, 0, nb1, True),
                  seen, max_hits, out)
    probe_verify_cuda.launches.add()
    return out


probe_verify_cuda.launches = LaunchCount()


def probe_verify(db, wpos, whi, wlo, max_hits: int, seen=None) -> dict:
    """Engine entry: the kernel for windows on a CUDA device, the plain
    version for windows on the CPU."""
    if wpos.device.type == "cuda":
        return probe_verify_cuda(db, wpos, whi, wlo, max_hits, seen)
    return probe_verify_plain(db, wpos, whi, wlo, max_hits, seen)


# ----------------------------------------------------- every-window pass


def probe_verify_dense_plain(db, hi, lo, valid, max_hits: int, seen=None,
                             tiered: bool = False) -> dict:
    """Probe + verify of every window in plain PyTorch, from extract's
    planes (``hi``, ``lo`` int32 [B, P], ``valid`` bool [B, P]; the window
    position is the column): ops/lookup.py's ``fp_candidates``, the
    interleave, :func:`cv_tier` at ``max_hits`` (the JAX engine's dense
    path) or, with ``tiered``, :func:`two_tier` (a DB without a Bloom
    filter), and the summary.  Every compaction by ``compact_ranks_plain``."""
    ci, vi = interleave_planes(fp_candidates(db, hi, lo, valid))
    pos = torch.arange(hi.shape[1], device=hi.device, dtype=torch.int32)[None]
    args = (db, hi, lo, ci, vi, pos)
    if tiered:
        res, ncand = two_tier(*args, max_hits, seen)
    else:
        res = cv_tier(*args, max_hits, max_hits, seen)
        ncand = vi.sum(dim=1, dtype=torch.int32)
    return verify_summary(res, ncand, max_hits)


def probe_verify_dense_cuda(db, hi, lo, valid, max_hits: int, seen=None) -> dict:
    """Probe + verify of every window by ``csrc/probe.cu`` from extract's
    planes: the module doc's per-read dict, ranked straight to
    ``max_hits``.  Raises on a table, a plane or a budget the kernel does
    not take (``max_hits`` in [1, 32]), and if the build or the launch
    fails.  ``probe_verify_dense_cuda.launches`` counts launches."""
    name = "probe_verify_dense_cuda"
    dev, b, _ = _plane_checks(name, hi, lo, valid, budget=max_hits, what="max_hits")
    nb1, nb2 = _verify_tables(name, db, dev, seen)
    out = _verify_outputs(b, max_hits, dev)
    if b == 0:
        return out
    _probe_launch(name, db, (hi, lo, valid, None), _table_args(db, nb1, nb2, 0, nb1, True),
                  seen, max_hits, out)
    probe_verify_dense_cuda.launches.add()
    return out


probe_verify_dense_cuda.launches = LaunchCount()


def probe_verify_dense(db, hi, lo, valid, max_hits: int, seen=None,
                       tiered: bool = False) -> dict:
    """Engine entry of the every-window pass: the kernel for planes on a
    CUDA device (which ranks straight to ``max_hits``: ``tiered`` changes
    nothing the masking rule keeps), the plain version for planes on the
    CPU."""
    if hi.device.type == "cuda":
        return probe_verify_dense_cuda(db, hi, lo, valid, max_hits, seen)
    return probe_verify_dense_plain(db, hi, lo, valid, max_hits, seen, tiered)


# ------------------------------------------------------------ shard mode


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


def _shard_tables(name: str, db, b0: int, nbloc: int, dev, seen) -> tuple[int, int]:
    """Checks a grid rank's tables and ``seen`` for the shard entries;
    returns (nb1, nb2)."""
    nb1 = int(db["nb1"])
    if nb1 < 1 or nb1 & (nb1 - 1) or not (nbloc >= 1 and 0 <= b0 and b0 + nbloc <= nb1):
        raise ValueError(f"{name}: buckets [{b0}, {b0 + nbloc}) outside a power-of-two "
                         f"table of {nb1}")
    if db["fptab"].data_ptr() % 16:
        raise ValueError(f"{name}: fptab needs 16-byte alignment")
    nb2 = _pow2_rows(name, "fptab2", db["fptab2"])
    check_tensor(name, "fptab", db["fptab"], torch.int32, (nbloc, 4), dev)
    check_tensor(name, "fptab2", db["fptab2"], torch.int32, (nb2, 4), dev)
    _rec_tinfo_seen(name, db, (nbloc + nb2) * 8, dev, seen)
    return nb1, nb2


def _hits_outputs(b: int, sh: int, dev) -> dict:
    """The narrow hit plane and ``ncand`` (module doc), uninitialised."""
    out = {f: torch.empty((b, sh), dtype=torch.int32, device=dev) for f in HIT_FIELDS}
    out["ver"] = torch.empty((b, sh), dtype=torch.bool, device=dev)
    out["ncand"] = torch.empty((b,), dtype=torch.int32, device=dev)
    return out


def probe_hits_cuda(db, wpos, whi, wlo, sh: int, b0: int, nbloc: int, own2: bool,
                    seen=None) -> dict:
    """Shard mode by the CUDA kernel ``csrc/probe.cu`` (module doc), from
    the gate's planes.  Raises on a table, a window plane or a budget the
    kernel does not take (``sh`` in [1, 32], the rank's bucket range inside
    the global table), and if the build or the launch fails.
    ``probe_hits_cuda.launches`` counts launches."""
    name = "probe_hits_cuda"
    dev, b, _ = _plane_checks(name, whi, wlo, wpos=wpos, budget=sh, what="sh")
    nb1, nb2 = _shard_tables(name, db, b0, nbloc, dev, seen)
    out = _hits_outputs(b, sh, dev)
    if b == 0:
        return out
    _probe_launch(name, db, (whi, wlo, None, wpos), _table_args(db, nb1, nb2, b0, nbloc, own2),
                  seen, sh, out)
    probe_hits_cuda.launches.add()
    return out


probe_hits_cuda.launches = LaunchCount()


def probe_hits(db, wpos, whi, wlo, sh: int, b0: int, nbloc: int, own2: bool, seen=None) -> dict:
    """Engine entry of shard mode: the kernel for windows on a CUDA device,
    the plain version for windows on the CPU."""
    if wpos.device.type == "cuda":
        return probe_hits_cuda(db, wpos, whi, wlo, sh, b0, nbloc, own2, seen)
    return probe_hits_plain(db, wpos, whi, wlo, sh, b0, nbloc, own2, seen)


def probe_hits_dense_plain(db, hi, lo, valid, sh: int, b0: int, nbloc: int, own2: bool,
                           seen=None) -> dict:
    """Shard mode of every window in plain PyTorch, from extract's planes
    (the window position is the column): :func:`probe_hits_plain` of every
    window, ``SENT`` where not valid."""
    iota = torch.arange(hi.shape[1], dtype=torch.int32, device=hi.device)
    wpos = torch.where(valid, iota[None], SENT)
    return probe_hits_plain(db, wpos, hi, lo, sh, b0, nbloc, own2, seen)


def probe_hits_dense_cuda(db, hi, lo, valid, sh: int, b0: int, nbloc: int, own2: bool,
                          seen=None) -> dict:
    """Shard mode of every window by ``csrc/probe.cu`` from extract's
    planes.  Raises as :func:`probe_hits_cuda` does.
    ``probe_hits_dense_cuda.launches`` counts launches."""
    name = "probe_hits_dense_cuda"
    dev, b, _ = _plane_checks(name, hi, lo, valid, budget=sh, what="sh")
    nb1, nb2 = _shard_tables(name, db, b0, nbloc, dev, seen)
    out = _hits_outputs(b, sh, dev)
    if b == 0:
        return out
    _probe_launch(name, db, (hi, lo, valid, None), _table_args(db, nb1, nb2, b0, nbloc, own2),
                  seen, sh, out)
    probe_hits_dense_cuda.launches.add()
    return out


probe_hits_dense_cuda.launches = LaunchCount()


def probe_hits_dense(db, hi, lo, valid, sh: int, b0: int, nbloc: int, own2: bool,
                     seen=None) -> dict:
    """Engine entry of the shard mode of every window: the kernel for planes
    on a CUDA device, the plain version for planes on the CPU."""
    if hi.device.type == "cuda":
        return probe_hits_dense_cuda(db, hi, lo, valid, sh, b0, nbloc, own2, seen)
    return probe_hits_dense_plain(db, hi, lo, valid, sh, b0, nbloc, own2, seen)


# ------------------------------------------------------------ slots mode


def probe_slots_plain(db, hi, lo, valid, shard=None):
    """Every window's verified slot (int32 [B, P], -1 on a miss) and its rec
    tin (int32 [B, P], 0 on a miss), from extract's planes, in plain
    PyTorch: ops/lookup.py's ``fp_candidates`` (on a grid rank, ``shard`` =
    (b0, nbloc, own2): ``fp_candidates_shard`` and local slot ids) and the
    ``rec`` verify of each plane; the last plane that verifies wins (a DB
    holds each key once).  The exact replay of the engines' reads past the
    candidate budget and of the grid's long reads."""
    planes = (fp_candidates(db, hi, lo, valid) if shard is None
              else fp_candidates_shard(db, hi, lo, valid, *shard))
    rec = db["rec"]
    slot, tin = torch.full_like(hi, -1), torch.zeros_like(hi)
    for cand, cv in planes:
        r = rec.index_select(0, cand.reshape(-1)).view(*cand.shape, 3)
        ok = cv & (r[..., 0] == hi) & (r[..., 1] == lo)
        slot = torch.where(ok, cand, slot)
        tin = torch.where(ok, r[..., 2] & 0xFFFFFF, tin)
    return slot, tin


def probe_slots_cuda(db, hi, lo, valid, shard=None):
    """:func:`probe_slots_plain` by the slots mode of ``csrc/probe.cu`` (its
    ``kmer_probe_slots``).  Raises on a table or a plane the kernel does not
    take, and if the build or the launch fails.
    ``probe_slots_cuda.launches`` counts launches."""
    name = "probe_slots_cuda"
    dev, b, p = _plane_checks(name, hi, lo, valid)
    if shard is None:
        nb1, nb2 = _verify_tables(name, db, dev, None)
        b0, nbloc, own2 = 0, nb1, True
    else:
        b0, nbloc, own2 = shard
        nb1, nb2 = _shard_tables(name, db, b0, nbloc, dev, None)
    slot = torch.empty((b, p), dtype=torch.int32, device=dev)
    tin = torch.empty((b, p), dtype=torch.int32, device=dev)
    if b == 0:
        return slot, tin
    launch(load_probe().kmer_probe_slots, name, dev, ptr(hi), ptr(lo), ptr(valid), b, p,
           *_table_args(db, nb1, nb2, b0, nbloc, own2), ptr(slot), ptr(tin))
    probe_slots_cuda.launches.add()
    return slot, tin


probe_slots_cuda.launches = LaunchCount()


def probe_slots(db, hi, lo, valid, shard=None):
    """Engine entry of the slots mode: the kernel for planes on a CUDA
    device, the plain version for planes on the CPU."""
    if hi.device.type == "cuda":
        return probe_slots_cuda(db, hi, lo, valid, shard)
    return probe_slots_plain(db, hi, lo, valid, shard)
