"""Ordered per-read msca fold, and the legacy engine's hit summary.

The reference folds each read's hits with ``final = msca(target, final)``
in window order (``newkmer_10nx.cpp:588-595``); msca is not associative, so
a fold walks the hit columns left to right with a [B]-wide carry.  Ports of
``kmer_id_tpu/ops/fold.py``:

* ``fold_targets_chain`` — the fingerprint engine's fold: the carry is
  (node, tin, tout), and a lowest common ancestor comes from the carried
  node's ancestor chain;
* ``_anc_at``, ``_is_anc_or_self``, ``lca_jnp``, ``msca_jnp`` (as
  :func:`lca`, :func:`msca`), ``compact_hits`` and ``fold_targets`` — the
  legacy engine's taxonomy queries over the ancestor-at-depth table
  ``anc`` [n, D] and ``depth`` [n] (core/taxonomy.py), its per-read hit
  summary, and its fold.

``fold_targets_interval`` is not ported: nothing in either package calls it.
"""

from __future__ import annotations

import math

import torch

from kmer_id_tpu_torch.ops.compact import compact_ranks
from kmer_id_tpu_torch.utils import timing

SENT = 2**31 - 1


def fold_targets_chain(chain3, targets, ttin, tout):
    """Ordered msca fold of per-hit targets.

    Args:
      chain3: int32 [n, D, 3] from ``Taxonomy.chain_tables()`` — (node, tin,
        tout) of each ancestor by depth, (0, INT32_MAX, -1) past the node.
      targets: int32 [B, P] hit targets in window order, 0 = no hit.
      ttin / tout: int32 [B, P] the hits' Euler intervals (ignored where
        ``targets == 0``).

    Returns int32 [B] final target (0 = unclassified).

    The loop runs to one past the last column holding any hit (one host
    read of that count); later columns hold no hit and change nothing.
    """
    b, p = targets.shape
    n = chain3.shape[0]
    t = targets.clamp(0, n - 1).to(torch.int32)
    ttin = ttin.to(torch.int32)
    tout = tout.to(torch.int32)
    col = torch.arange(1, p + 1, device=t.device, dtype=torch.int32)
    with timing.sync():
        steps = int(((t > 0) * col).max()) if b else 0
    f = torch.zeros(b, dtype=torch.int32, device=t.device)
    ftin = torch.full((b,), SENT, dtype=torch.int32, device=t.device)
    ftout = torch.full((b,), -1, dtype=torch.int32, device=t.device)
    for i in range(steps):
        tcol, tin_c, tout_c = t[:, i], ttin[:, i], tout[:, i]
        has = tcol > 0
        fnone = f == 0
        descend = (ftin <= tin_c) & (tin_c <= ftout)
        stay = (tin_c <= ftin) & (ftin <= tout_c)
        chain_f = chain3.index_select(0, f)  # [B, D, 3]
        q = (chain_f[:, :, 1] <= tin_c[:, None]) & (tin_c[:, None] <= chain_f[:, :, 2])
        jstar = (q.sum(dim=1) - 1).clamp(min=0)
        lca = chain_f.gather(1, jstar[:, None, None].expand(b, 1, 3))[:, 0, :]
        nf = torch.where(descend, tcol, torch.where(stay, f, lca[:, 0]))
        nftin = torch.where(descend, tin_c, torch.where(stay, ftin, lca[:, 1]))
        nftout = torch.where(descend, tout_c, torch.where(stay, ftout, lca[:, 2]))
        adopt = has & fnone
        use = has & ~fnone
        f = torch.where(adopt, tcol, torch.where(use, nf, f))
        ftin = torch.where(adopt, tin_c, torch.where(use, nftin, ftin))
        ftout = torch.where(adopt, tout_c, torch.where(use, nftout, ftout))
    return f


def _anc_at(anc, node, d):
    """anc[node, d] with d clipped to the table's depth range."""
    return anc[node.long(), d.clamp(0, anc.shape[1] - 1).long()]


def _is_anc_or_self(anc, depth, y, x):
    """True where y is an ancestor of x or y == x."""
    dy = depth[y.long()]
    return (dy <= depth[x.long()]) & (_anc_at(anc, x, dy) == y)


def lca(anc, depth, x, y):
    """Lowest common ancestor-or-self (``ca`` of the reference DB build,
    ``kmer_build_vf6.cpp:99-118``): a bisection on the depth, run for a
    fixed step count as the JAX function runs it."""
    dmin = torch.minimum(depth[x.long()], depth[y.long()])
    lo = torch.zeros_like(dmin)  # depth 0 (the root) is always common
    hi = dmin
    for _ in range(max(1, math.ceil(math.log2(anc.shape[1] + 1)) + 1)):
        mid = (lo + hi + 1) >> 1
        same = _anc_at(anc, x, mid) == _anc_at(anc, y, mid)
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid - 1)
    return _anc_at(anc, x, lo)


def msca(anc, depth, x, y):
    """The classifier's fold op (``newkmer_10nx.cpp:118-144``): the
    descendant of a comparable pair, the LCA of an incomparable one.  Ids
    are clipped to the table (callers guard the 0 = no-hit sentinel)."""
    n = anc.shape[0]
    x, y = x.clamp(0, n - 1), y.clamp(0, n - 1)
    y_anc_x = _is_anc_or_self(anc, depth, y, x)
    x_anc_y = _is_anc_or_self(anc, depth, x, y)
    return torch.where(y_anc_x, x, torch.where(x_anc_y, y, lca(anc, depth, x, y)))


def compact_hits(anc, depth, targets, max_hits: int):
    """Per-read hit summary of a [B, P] per-window target plane (0 = miss),
    packed as int32 [B, max_hits + 3]: column 0 a deepest hit (the first of
    the deepest in window order; 0 for a row without hits), 1 the hit count
    (may exceed ``max_hits``), 2 consistency (every hit an ancestor-or-self
    of the deepest: the fold then returns the deepest), 3.. the first
    ``max_hits`` hits in window order, 0 pad.

    The hit list is the rank compaction of ops/compact.py (the kernel
    ``csrc/compact.cu`` for CUDA tensors): valid where ``t > 0``, payload
    ``t``, its 0 pad being the list's."""
    t = targets.to(torch.int32)
    b, p = t.shape
    hitm = t > 0
    col = torch.arange(p, dtype=torch.int32, device=t.device)[None]
    _, hits, nhits, _ = compact_ranks(t.contiguous(), hitm.contiguous(), col, max_hits)
    tc = t.clamp(0, depth.shape[0] - 1)
    d = torch.where(hitm, depth[tc.long()], -1)
    deepest = t.gather(1, d.argmax(dim=1, keepdim=True))  # [B, 1]
    n = anc.shape[0]
    ok = _is_anc_or_self(anc, depth, t.clamp(0, n - 1), deepest.clamp(0, n - 1))
    consistent = (ok | ~hitm).all(dim=1, keepdim=True)
    return torch.cat([deepest, nhits[:, None], consistent.to(torch.int32), hits], dim=1)


def fold_targets(anc, depth, targets, init=None):
    """Ordered fold of each row of per-window targets (int32 [B, P], 0 =
    miss), left to right: ``final = msca(t, final)`` where both are hits,
    ``t`` adopted where ``final`` is 0.  ``init`` int32 [B] resumes a fold
    (0 = none).  Returns int32 [B]."""
    t = targets.to(torch.int32)
    final = (torch.zeros(t.shape[0], dtype=torch.int32, device=t.device) if init is None
             else init.to(torch.int32))
    for i in range(t.shape[1]):
        col = t[:, i]
        merged = msca(anc, depth, col, final).to(torch.int32)
        final = torch.where(col > 0, torch.where(final > 0, merged, col), final)
    return final
