"""Taxonomy tree with vectorized ancestor queries.

The reference keeps a parent-pointer array (root = node 1, every node's parent
defaulting to root; ``newkmer_10nx.cpp:93-154``) and answers two different
ancestor queries with O(depth) set walks:

* **Classifier fold** ``msca(x, y)`` (``newkmer_10nx.cpp:118-144``): if one
  argument is an ancestor-or-self of the other, the *descendant* (more
  specific node) wins; otherwise the lowest common ancestor is returned.
* **Builder merge** ``ca(x, y)`` (``kmer_build_vf6.cpp:99-118``): plain
  lowest-common-ancestor-or-self — for comparable pairs the *ancestor* wins.

Neither is associative over arbitrary hit sets (msca is commutative but
order-dependent in folds mixing incomparable and comparable hits), so exact
parity requires ordered folds; see ``ops/fold.py``.

Instead of pointer walks, we precompute an
*ancestor-at-depth* table ``anc[t, d]`` (the ancestor of ``t`` at depth ``d``,
-1 beyond ``depth[t]``).  Then

* ``is ancestor-or-self(y, x)``  ⇔  ``depth[y] <= depth[x] and
  anc[x, depth[y]] == y`` — one gather;
* ``lca(x, y)`` = ``anc[x, d*]`` for the largest ``d* <= min(depths)`` with
  ``anc[x, d*] == anc[y, d*]`` — a log2(max_depth) binary search of gathers.

Both are branch-free and batch over whole read batches.

Copy of ``kmer_id_tpu/core/taxonomy.py``, trimmed to what the port reaches.
"""

from __future__ import annotations

import numpy as np

ROOT = 1


class Taxonomy:
    """Parent-pointer taxonomy with precomputed ancestor-at-depth tables.

    Node conventions (``newkmer_10nx.cpp:45``): 0 is "unclassified"/unused,
    1 is the root, real targets are >= 2.  Unlisted nodes default to parenting
    the root, matching the reference's constructor.
    """

    def __init__(self, parent: np.ndarray):
        parent = np.asarray(parent, dtype=np.int32).copy()
        n = parent.shape[0]
        if n <= ROOT:
            parent = np.pad(parent, (0, ROOT + 1 - n), constant_values=ROOT)
            n = parent.shape[0]
        # get_parent() semantics: node 0 and the root resolve to the root
        # (newkmer_10nx.cpp:146-152).
        parent[0] = ROOT
        parent[ROOT] = ROOT
        self.parent = parent
        self.num_nodes = n
        self.depth, self.anc = self._build_tables(parent)
        self.max_depth = int(self.depth.max())
        self.tin, self.tout = self._euler_intervals(parent, self.depth)

    # ------------------------------------------------------------- build
    @classmethod
    def from_edges(cls, edges, num_nodes: int | None = None) -> "Taxonomy":
        """Build from (parent, child) int pairs (`*tree.txt` rows)."""
        edges = list(edges)
        maxn = ROOT
        for x, y in edges:
            maxn = max(maxn, int(x), int(y))
        n = max(num_nodes or 0, maxn + 1)
        parent = np.full(n, ROOT, dtype=np.int32)
        for x, y in edges:
            parent[int(y)] = int(x)
        return cls(parent)

    @staticmethod
    def _build_tables(parent: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        n = parent.shape[0]
        depth = np.full(n, -1, dtype=np.int32)
        depth[ROOT] = 0
        # Resolve depths by repeated parent-pointer jumps; the taxonomy is a
        # tree of bounded height, so this converges in max_depth iterations.
        pending = np.nonzero(depth < 0)[0]
        cursor = parent[pending].copy()
        hops = np.ones(len(pending), dtype=np.int32)
        for _ in range(n + 1):
            if len(pending) == 0:
                break
            done = depth[cursor] >= 0
            if done.any():
                idx = pending[done]
                depth[idx] = depth[cursor[done]] + hops[done]
            pending = pending[~done]
            hops = hops[~done] + 1
            cursor = parent[cursor[~done]]
        if len(pending):
            raise ValueError("taxonomy parent pointers contain a cycle")
        # depth[0]: node 0 parents the root via get_parent -> depth 1.
        max_depth = int(depth.max())
        d = max_depth + 1
        anc = np.full((n, d), -1, dtype=np.int32)
        nodes = np.arange(n, dtype=np.int32)
        anc[nodes, depth] = nodes
        cur = parent.copy()
        cd = depth - 1
        for _ in range(max_depth):
            live = cd >= 0
            if not live.any():
                break
            anc[nodes[live], cd[live]] = cur[live]
            cur = parent[cur]
            cd = cd - 1
        return depth, anc

    @staticmethod
    def _euler_intervals(parent: np.ndarray, depth: np.ndarray):
        """DFS interval labels: ``tin[y] <= tin[x] <= tout[y]`` ⇔ y is an
        ancestor-or-self of x.

        These turn every ancestor test into pure elementwise compares, so the
        classify kernel can carry per-probe (tin, tout, depth) in its gathered
        payload and run the whole per-read consistency check without touching
        the ancestor table (zero taxonomy gathers on device; see db/fpdb.py).
        """
        n = parent.shape[0]
        # children grouped by parent via one sort (node 0 and the root are
        # their own get_parent()-roots; exclude them as children of ROOT to
        # avoid cycles — node 0 is handled as a standalone leaf under ROOT).
        nodes = np.arange(n, dtype=np.int64)
        par = parent.astype(np.int64).copy()
        par[ROOT] = -1  # root owns the traversal
        order = np.argsort(par, kind="stable")
        starts = np.searchsorted(par[order], nodes)
        ends = np.searchsorted(par[order], nodes, side="right")
        tin = np.zeros(n, dtype=np.int64)
        tout = np.zeros(n, dtype=np.int64)
        t = 0
        stack = [(ROOT, False)]
        while stack:
            node, done = stack.pop()
            if done:
                tout[node] = t - 1
                continue
            tin[node] = t
            t += 1
            stack.append((node, True))
            for c in order[starts[node]:ends[node]][::-1]:
                if c != node:
                    stack.append((int(c), False))
        return tin.astype(np.int32), tout.astype(np.int32)

    # ------------------------------------------------------------- queries
    def _clip(self, x: np.ndarray) -> np.ndarray:
        return np.clip(np.asarray(x, dtype=np.int32), 0, self.num_nodes - 1)

    def is_anc_or_self(self, y, x) -> np.ndarray:
        """True where y is an ancestor of x or y == x (vectorized)."""
        x = self._clip(x)
        y = self._clip(y)
        dy = self.depth[y]
        ok = dy <= self.depth[x]
        return ok & (self.anc[x, np.minimum(dy, self.anc.shape[1] - 1)] == y)

    def lca(self, x, y) -> np.ndarray:
        """Lowest common ancestor-or-self (builder ``ca`` semantics)."""
        x = self._clip(x)
        y = self._clip(y)
        dmin = np.minimum(self.depth[x], self.depth[y])
        lo = np.zeros_like(dmin)  # anc at depth 0 is the root: always common
        hi = dmin
        # binary search for the deepest common depth
        steps = max(1, int(np.ceil(np.log2(self.anc.shape[1] + 1))) + 1)
        for _ in range(steps):
            mid = (lo + hi + 1) >> 1
            same = self.anc[x, mid] == self.anc[y, mid]
            lo = np.where(same, mid, lo)
            hi = np.where(same, hi, mid - 1)
        return self.anc[x, lo]

    def msca(self, x, y) -> np.ndarray:
        """Classifier fold op (``newkmer_10nx.cpp:118-144``), vectorized.

        Comparable pairs resolve to the descendant; incomparable pairs to
        their LCA.
        """
        x = self._clip(x)
        y = self._clip(y)
        y_anc_x = self.is_anc_or_self(y, x)
        x_anc_y = self.is_anc_or_self(x, y)
        return np.where(y_anc_x, x, np.where(x_anc_y, y, self.lca(x, y)))

    def chain_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Ancestor-chain interval tables for the device msca fold
        (ops/fold.fold_targets_chain).

        ``chain3`` int32 [n, D, 3]: for each node t and depth d, the
        (node, tin, tout) of t's ancestor at depth d; entries beyond
        depth[t] hold (0, INT32_MAX, -1) so they never satisfy an interval
        containment test.  ``tax3`` int32 [n, 3]: each node's own
        (tin, tout, depth).  Real taxonomies are shallow (bact10 depth 4,
        mito depth 5), so these tables are a few hundred KB and gathers
        into them run in the fast small-table zone.
        """
        n, d = self.anc.shape
        chain3 = np.empty((n, d, 3), dtype=np.int32)
        valid = self.anc >= 0
        a = np.clip(self.anc, 0, n - 1)
        chain3[:, :, 0] = np.where(valid, a, 0)
        chain3[:, :, 1] = np.where(valid, self.tin[a], np.int32(2**31 - 1))
        chain3[:, :, 2] = np.where(valid, self.tout[a], -1)
        tax3 = np.stack([self.tin, self.tout, self.depth], axis=1).astype(np.int32)
        return chain3, tax3
