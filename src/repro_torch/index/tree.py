"""The adaptive split tree: structure, traversal, and snapshots.

Every indexed item is a D-dimensional real-valued feature vector (one of
:mod:`repro_torch.index.features`' adapters).  A node carries a per-dimension
bit count (its cardinality state); splitting promotes ONE dimension by
one bit and partitions members by their symbol at the new cardinality —
iSAX splitting, generalized to the multi-component feature word.  Leaves
hold item ids; every node keeps the tight bounding box of all members
ever routed through it, so the weighted box distance
(:meth:`SplitTree.bbox_lb`) prunes subtrees DS-tree-style from the very
first split.

The split dimension is a **deterministic function of the node's bit
state alone** (:func:`repro_torch.index.insert.split_dim_for`): refine the
least-refined dimension, season dimensions first.  Because it never
looks at the members, the tree after inserting rows 0..n-1 is the same
no matter how the inserts were chunked — incremental maintenance and
bulk construction are literally the same code path
(:mod:`repro_torch.index.insert`) and produce identical leaf membership.

Traversal (used by :class:`repro_torch.index.candidates.TreeCandidates`):

* ``seed_candidates`` — best-first leaf walk (heap on the box bound)
  until >= k member ids are collected; verifying them yields an upper
  bound U on the true k-th-NN distance.
* ``collect_bounds`` — prune subtrees whose box bound exceeds U;
  surviving leaf members are bounded individually with the adapter's
  exact feature distance.  O(survivors) output, never corpus-width.
  It is vectorized over a flattened node table (``_NodeTable``, built
  lazily in the walk's visit order and dropped on every change to the
  tree): one numpy pass evaluates every node's box bound, survival
  propagates from parent to child level by level, and ``member_lb``
  bounds the members of every surviving leaf in one blocked pass — the
  same (ids, bounds), in the same order, as a node-by-node walk.

Children are always iterated in symbol order, so two structurally equal
trees traverse identically regardless of construction history.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.index.features import FeatureAdapter, gauss_breaks

_MIN_CAPACITY = 256


@dataclass
class TreeNode:
    bits: np.ndarray                  # (D,) int8 cardinality bits per dim
    ids: Optional[np.ndarray] = None  # leaf payload (int64 item ids)
    children: Optional[dict] = None   # symbol -> TreeNode
    split_dim: int = -1
    lo: Optional[np.ndarray] = None   # (D,) running member bounding box
    hi: Optional[np.ndarray] = None

    @property
    def is_leaf(self) -> bool:
        return self.children is None


def _new_node(bits: np.ndarray) -> TreeNode:
    d = bits.shape[0]
    return TreeNode(bits=bits, ids=np.empty(0, np.int64),
                    lo=np.full(d, np.inf, np.float32),
                    hi=np.full(d, -np.inf, np.float32))


_BLOCK = 8192               # rows per row-wise numpy call of the walk
_THREADS = 8                # threads per row-wise pass, at most


def _rowwise(fn, n: int) -> np.ndarray:
    """``fn(lo, hi)`` — a row-wise numpy map over rows [lo, hi) — over
    rows [0, n) in blocks of ``_BLOCK`` rows (their temporaries stay in
    cache), the blocks spread over a few threads (numpy releases the GIL
    in its loops) and concatenated in order.  A row's value does not
    depend on its block, so this is one call over all rows, bitwise."""
    if n <= _BLOCK:
        return fn(0, n)
    starts = range(0, n, _BLOCK)
    workers = min(_THREADS, len(starts), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return np.concatenate(list(pool.map(
            lambda lo: fn(lo, min(lo + _BLOCK, n)), starts)))


@dataclass
class _NodeTable:
    """The tree flattened in ``collect_bounds``' visit order (depth
    first, children pushed in ascending symbol order and popped last
    first), so a node's parent precedes it and the surviving leaves in
    table order are the leaves the node-by-node walk reaches, in the
    order it reaches them."""

    lo: np.ndarray            # (n_nodes, D) float32 member boxes
    hi: np.ndarray
    parent: np.ndarray        # (n_nodes,) int64, -1 at the root
    levels: list              # node indices at depth 1, 2, ...
    is_leaf: np.ndarray       # (n_nodes,) bool
    start: np.ndarray         # (n_nodes,) leaf offset into ``ids``
    count: np.ndarray         # (n_nodes,) leaf size (0 when internal)
    ids: np.ndarray           # every leaf's member ids, in table order

    @classmethod
    def build(cls, root: TreeNode) -> "_NodeTable":
        nodes, parent, depth = [], [], []
        stack = [(root, -1, 0)]
        while stack:
            node, par, dep = stack.pop()
            nid = len(nodes)
            nodes.append(node)
            parent.append(par)
            depth.append(dep)
            if not node.is_leaf:
                for s in sorted(node.children):
                    stack.append((node.children[s], nid, dep + 1))
        depth = np.asarray(depth, np.int64)
        count = np.asarray([nd.ids.size if nd.is_leaf else 0
                            for nd in nodes], np.int64)
        leaf_ids = [nd.ids for nd in nodes if nd.is_leaf]
        return cls(
            lo=np.ascontiguousarray(np.stack([nd.lo for nd in nodes])),
            hi=np.ascontiguousarray(np.stack([nd.hi for nd in nodes])),
            parent=np.asarray(parent, np.int64),
            levels=[np.nonzero(depth == d)[0]
                    for d in range(1, int(depth.max()) + 1)],
            is_leaf=np.asarray([nd.is_leaf for nd in nodes]),
            start=np.concatenate([[0], np.cumsum(count)[:-1]]),
            count=count,
            ids=np.concatenate(leaf_ids).astype(np.int64))


class SplitTree:
    """Incremental adaptive split tree over one feature adapter.

    Parameters
    ----------
    adapter:   :class:`repro_torch.index.features.FeatureAdapter`.
    leaf_fill: leaf fill factor — a leaf holding more members splits
               (unless every dimension is refined to ``max_bits``).
    max_bits:  maximum cardinality bits per dimension.
    """

    def __init__(self, adapter: FeatureAdapter, *, leaf_fill: int = 64,
                 max_bits: int = 8):
        if leaf_fill < 1:
            raise ValueError(f"leaf_fill must be >= 1, got {leaf_fill}")
        self.adapter = adapter
        self.D = adapter.D
        self.leaf_fill = int(leaf_fill)
        self.max_bits = int(max_bits)
        self._feats = np.empty((0, self.D), np.float32)
        self._n = 0
        self.root = _new_node(np.zeros(self.D, np.int8))
        self.n_nodes = 1
        self._breaks: dict = {}       # (dim, bits) -> breakpoint array
        self._table: Optional[_NodeTable] = None   # collect's node table
        # structure mutex: a split rewires ``children`` dicts while a
        # traversal iterates them, so inserts and walks are serialized.
        # Walks are O(survivors) numpy work; verification — the
        # dominant cost — runs outside the lock, so concurrent
        # ingest-while-serving contends only on the cheap tree phases.
        self._lock = threading.RLock()

    # -- items -----------------------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    @property
    def feats(self) -> np.ndarray:
        """(n, D) feature matrix of all indexed items (live prefix)."""
        return self._feats[:self._n]

    def _grow(self, need: int):
        if need <= self._feats.shape[0]:
            return
        cap = max(need, 2 * self._feats.shape[0], _MIN_CAPACITY)
        arr = np.empty((cap, self.D), np.float32)
        arr[:self._n] = self._feats[:self._n]
        self._feats = arr

    def insert(self, feats) -> np.ndarray:
        """Index new items; returns their ids (contiguous, in insertion
        order — callers align them with dataset rows / window ids).
        Bulk construction IS this call: inserting everything at once and
        inserting in arbitrary chunks build the same tree."""
        from repro_torch.index.insert import route
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 1:
            feats = feats[None]
        if feats.shape[-1] != self.D:
            raise ValueError(f"features have {feats.shape[-1]} dims, "
                             f"adapter has D={self.D}")
        m = feats.shape[0]
        if m == 0:
            return np.empty(0, np.int64)
        with self._lock:
            self._grow(self._n + m)
            self._feats[self._n:self._n + m] = feats
            ids = np.arange(self._n, self._n + m, dtype=np.int64)
            self._n += m
            self._table = None
            route(self, self.root, ids)
        return ids

    def insert_grouped(self, feats, n_groups: int) -> np.ndarray:
        """Bulk insert partitioned by root-subtree address — the sharded
        build path (``insert.root_addresses`` is the partition key each
        host/device would own).  Groups are routed one root subtree at a
        time; because the tree after any insert sequence is a pure
        function of the feature multiset (:mod:`repro_torch.index.insert`),
        the structure equals the in-order bulk build, and sorting each
        leaf's ids afterwards (``_canonicalize_leaves``) restores the
        only order-dependent state — id order within a leaf — to what
        the in-order build produces (ascending).  Returns the ids in
        insertion order, same contract as ``insert``."""
        from repro_torch.index.insert import root_addresses, route
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 1:
            feats = feats[None]
        if feats.shape[-1] != self.D:
            raise ValueError(f"features have {feats.shape[-1]} dims, "
                             f"adapter has D={self.D}")
        m = feats.shape[0]
        if m == 0:
            return np.empty(0, np.int64)
        with self._lock:
            self._grow(self._n + m)
            self._feats[self._n:self._n + m] = feats
            ids = np.arange(self._n, self._n + m, dtype=np.int64)
            self._n += m
            self._table = None
            addr = root_addresses(self, feats, n_groups)
            for a in np.unique(addr):
                route(self, self.root, ids[addr == a])
            self._canonicalize_leaves()
        return ids

    def _canonicalize_leaves(self):
        """Sort every leaf's member ids ascending — the canonical order
        the in-order incremental build produces (ids are assigned
        monotonically and appended in arrival order)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.is_leaf:
                if node.ids.size:
                    node.ids = np.sort(node.ids)
            else:
                stack.extend(node.children.values())

    # -- symbols ---------------------------------------------------------
    def breaks(self, dim: int, bits: int) -> np.ndarray:
        key = (dim, bits)
        bp = self._breaks.get(key)
        if bp is None:
            bp = gauss_breaks(1 << bits, float(self.adapter.sds[dim]))
            self._breaks[key] = bp
        return bp

    def symbols(self, feats: np.ndarray, dim: int, bits: int) -> np.ndarray:
        """Symbol of each feature row on ``dim`` at cardinality 2**bits."""
        if bits == 0:
            return np.zeros(feats.shape[0], np.int64)
        return np.searchsorted(self.breaks(dim, bits), feats[:, dim],
                               side="right")

    # -- bounds ----------------------------------------------------------
    def bbox_lb(self, qf: np.ndarray, node: TreeNode) -> float:
        """Weighted distance from the query features to the node's tight
        member bounding box — a valid d_ED lower bound by the adapter's
        per-component argument (features module docstring).  +inf for a
        node no member was ever routed through."""
        gap = np.maximum(0.0, np.maximum(node.lo - qf, qf - node.hi))
        return float(np.sqrt(np.sum(self.adapter.weights * gap * gap)))

    def member_lb(self, qf: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Exact per-member feature-distance bound (adapter-defined)."""
        return self.adapter.member_lb(qf, self._feats[ids])

    # -- traversal -------------------------------------------------------
    #
    # As-of reads (``max_id``): item ids are assigned monotonically and
    # inserts only ever EXTEND the tree (new members, expanded boxes,
    # deeper splits) — nothing indexed before id ``max_id`` is ever
    # rewritten.  So a traversal as-of an epoch frontier is just the
    # filter ``id < max_id`` at the leaves: a node's (possibly later,
    # looser) bounding box is still a valid lower bound for the epoch
    # subset of its members, so pruning stays correct, and the final
    # top-k is bit-identical to a tree holding only the first ``max_id``
    # items (exactness of the downstream k-th-best verification holds
    # for ANY valid-bound candidate set).

    def seed_candidates(self, qf: np.ndarray, k: int,
                        max_id: Optional[int] = None) -> list:
        """Best-first leaf walk until >= k member ids are collected — the
        seed set whose verified distances upper-bound the true k-th NN.
        ``max_id`` restricts to items inserted before that id (as-of an
        epoch frontier); the walk keeps descending until k epoch-visible
        members are found or the tree is exhausted."""
        import heapq
        with self._lock:
            heap = [(0.0, 0, self.root)]
            counter = 1
            out: list = []
            while heap and len(out) < k:
                _, _, node = heapq.heappop(heap)
                if node.is_leaf:
                    ids = node.ids
                    if max_id is not None:
                        ids = ids[ids < max_id]
                    out.extend(ids.tolist())
                    continue
                for s in sorted(node.children):
                    child = node.children[s]
                    heapq.heappush(heap, (self.bbox_lb(qf, child), counter,
                                          child))
                    counter += 1
            return out

    def collect_bounds(self, qf: np.ndarray, thresh: float,
                       max_id: Optional[int] = None):
        """Compact (ids, member bounds) of every member that could still
        beat ``thresh`` (subtrees pruned by the box bound, members by the
        exact feature bound) — O(survivors), never corpus-width.
        ``max_id`` filters to the members visible as-of an epoch
        frontier (see the traversal note above).

        Vectorized over the node table: every node's ``bbox_lb`` in one
        pass (the same elementwise float ops and the same row sum over a
        contiguous last axis), a node survives when its bound and all
        its ancestors' are not above ``thresh``, and the members of the
        surviving leaves are bounded by ``member_lb`` (a row-wise map;
        both passes run in blocks, :func:`_rowwise`).  The result is the
        node-by-node walk's, order included."""
        w = self.adapter.weights

        def box_lb(lo, hi):
            gap = np.maximum(0.0, np.maximum(tab.lo[lo:hi] - qf,
                                             qf - tab.hi[lo:hi]))
            return np.sqrt(np.sum(w * gap * gap, axis=-1))

        with self._lock:
            if self._table is None:
                self._table = _NodeTable.build(self.root)
            tab = self._table
            alive = ~(_rowwise(box_lb, tab.lo.shape[0]) > thresh)
            for lvl in tab.levels:
                alive[lvl] &= alive[tab.parent[lvl]]
            leaves = np.nonzero(alive & tab.is_leaf)[0]
            cnt = tab.count[leaves]
            total = int(cnt.sum())
            ends = np.cumsum(cnt)
            pos = np.arange(total, dtype=np.int64) \
                + np.repeat(tab.start[leaves] - (ends - cnt), cnt)
            ids = tab.ids[pos]
            if max_id is not None:
                ids = ids[ids < max_id]
            if ids.size == 0:
                return np.empty(0, np.int64), np.empty(0)
            mlb = _rowwise(lambda lo, hi: self.member_lb(qf, ids[lo:hi]),
                           ids.size)
        keep = mlb <= thresh
        return ids[keep], mlb[keep]

    def leaf_membership(self) -> list:
        """Canonical structure fingerprint: preorder (symbol-ordered)
        list of (root-to-leaf symbol path, member ids).  Two trees built
        from the same items in any chunking compare equal."""
        out = []

        def walk(node, path):
            if node.is_leaf:
                out.append((path, node.ids.tolist()))
            else:
                for s in sorted(node.children):
                    walk(node.children[s], path + (int(s),))

        walk(self.root, ())
        return out

    # -- snapshot serialization ------------------------------------------
    def to_snapshot(self):
        """Flatten to (meta, arrays): feature matrix + preorder node
        table (bits, parent, split history, boxes) + concatenated leaf
        payloads.  ``from_snapshot`` rebuilds without re-splitting, and
        the rebuilt tree keeps accepting ``insert``."""
        nodes, parents, syms = [], [], []

        def walk(node, parent, sym):
            nid = len(nodes)
            nodes.append(node)
            parents.append(parent)
            syms.append(sym)
            if not node.is_leaf:
                for s in sorted(node.children):
                    walk(node.children[s], nid, s)

        walk(self.root, -1, -1)
        leaf_ids = [nd.ids if nd.is_leaf else np.empty(0, np.int64)
                    for nd in nodes]
        arrays = {
            "feats": np.ascontiguousarray(self.feats),
            "node_bits": np.stack([nd.bits for nd in nodes]),
            "node_parent": np.asarray(parents, np.int32),
            "node_sym": np.asarray(syms, np.int32),
            "node_split_dim": np.asarray([nd.split_dim for nd in nodes],
                                         np.int32),
            "node_lo": np.stack([nd.lo for nd in nodes]),
            "node_hi": np.stack([nd.hi for nd in nodes]),
            "leaf_counts": np.asarray([len(x) for x in leaf_ids], np.int64),
            "leaf_ids": (np.concatenate(leaf_ids) if leaf_ids else
                         np.empty(0, np.int64)).astype(np.int64),
        }
        meta = {"n": int(self._n), "D": int(self.D),
                "leaf_fill": int(self.leaf_fill),
                "max_bits": int(self.max_bits),
                "n_nodes": int(self.n_nodes)}
        return meta, arrays

    @classmethod
    def from_snapshot(cls, adapter: FeatureAdapter, meta: dict,
                      arrays: dict) -> "SplitTree":
        """Rebuild a tree from ``to_snapshot`` output (no re-split)."""
        self = cls(adapter, leaf_fill=int(meta["leaf_fill"]),
                   max_bits=int(meta["max_bits"]))
        n = int(meta["n"])
        feats = np.asarray(arrays["feats"], np.float32)
        if feats.shape != (n, self.D):
            raise ValueError(f"snapshot feats shape {feats.shape} != "
                             f"({n}, {self.D})")
        self._grow(n)
        self._feats[:n] = feats
        self._n = n
        n_nodes = int(meta["n_nodes"])
        counts = arrays["leaf_counts"]
        offsets = np.concatenate([[0], np.cumsum(counts)])
        nodes = []
        for i in range(n_nodes):
            is_leaf = int(arrays["node_split_dim"][i]) < 0
            node = TreeNode(
                bits=np.asarray(arrays["node_bits"][i], np.int8),
                ids=(arrays["leaf_ids"][offsets[i]:offsets[i + 1]]
                     .astype(np.int64) if is_leaf else None),
                children={} if not is_leaf else None,
                split_dim=int(arrays["node_split_dim"][i]),
                lo=np.asarray(arrays["node_lo"][i], np.float32),
                hi=np.asarray(arrays["node_hi"][i], np.float32))
            nodes.append(node)
            parent = int(arrays["node_parent"][i])
            if parent >= 0:
                nodes[parent].children[int(arrays["node_sym"][i])] = node
        with self._lock:
            self.root = nodes[0]
            self.n_nodes = n_nodes
            self._table = None
        return self
