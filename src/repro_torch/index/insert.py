"""Routing and splitting — the ONE construction code path.

Bulk build and incremental maintenance both come through
:func:`route`: new member ids are pushed down the tree, every touched
node's bounding box is widened, and any leaf that ends up over its fill
factor splits.  There is no separate "rebuild" algorithm to drift from
the insert path (the bug class where a post-append rebuild silently
re-splits differently from the original construction).

Chunking invariance (why incremental == bulk, leaf membership and all):

* the split dimension (:func:`split_dim_for`) is a function of the
  node's bit state only — never of its current members;
* a member's child at a split node is a function of its own feature
  value — never of its co-members;
* a node ends up split iff the TOTAL number of members ever routed
  through it exceeds ``leaf_fill`` — a monotone condition on the final
  member multiset, not on arrival order;
* boxes are running min/max — order-free.

So the final tree is a pure function of the inserted feature multiset
(in id order), regardless of how inserts were batched.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.index.tree import SplitTree, TreeNode, _new_node


def split_dim_for(tree: SplitTree, bits: np.ndarray) -> Optional[int]:
    """The dimension a node with ``bits`` splits on: the least-refined
    refinable dimension, ties broken season-first (adapter priority),
    then by dimension order.  Returns None when every dimension is at
    ``max_bits`` (the leaf stays overfull — alphabet exhausted)."""
    refinable = np.nonzero(np.asarray(bits) < tree.max_bits)[0]
    if refinable.size == 0:
        return None
    order = np.lexsort((refinable, tree.adapter.priority[refinable],
                        np.asarray(bits)[refinable]))
    return int(refinable[order[0]])


def root_addresses(tree: SplitTree, feats: np.ndarray,
                   n_groups: int) -> np.ndarray:
    """Deterministic root-subtree address of each feature row after
    ``ceil(log2(n_groups))`` top-level splits — the sharded bulk build's
    partition key (:meth:`SplitTree.insert_grouped`).

    Simulates the split cascade an empty tree would perform at the root:
    the split dimension at each depth is :func:`split_dim_for` of the
    accumulated bit state (a function of the bit state ALONE, never of
    the members), and the branch a row takes is the one new bit its
    symbol gains when that dimension's cardinality doubles.

    Why the branch extraction is exact: the Gaussian quantile breakpoints
    at cardinalities 2^b and 2^(b+1) nest BITWISE.  Break j of the
    2^b-grid is the quantile at j / 2^b, and (2j) / 2^(b+1) == j / 2^b
    exactly in IEEE arithmetic (division by a power of two only shifts
    the exponent), so ``ndtri_np`` — a deterministic elementwise map —
    produces the identical float64, ``gauss_breaks``' scaling by ``sd``
    is the same multiplication, and ``searchsorted(side="right")``
    against the finer grid therefore refines every coarse cell by
    exactly one new (odd-index) breakpoint.  Hence

        symbols(f, dim, b + 1) == 2 * symbols(f, dim, b) + branch,

    with branch in {0, 1} — the subtraction below recovers the branch
    bit exactly, never approximately.
    """
    feats = np.asarray(feats, np.float32)
    depth = max(int(np.ceil(np.log2(max(n_groups, 1)))), 0)
    bits = np.zeros(tree.D, np.int64)
    addr = np.zeros(feats.shape[0], np.int64)
    for _ in range(depth):
        dim = split_dim_for(tree, bits)
        if dim is None:               # alphabet exhausted at the root
            break
        b = int(bits[dim])
        branch = tree.symbols(feats, dim, b + 1) \
            - 2 * tree.symbols(feats, dim, b)
        addr = addr * 2 + branch
        bits[dim] += 1
    return addr


def route(tree: SplitTree, node: TreeNode, ids: np.ndarray):
    """Push member ids into ``node``'s subtree, splitting overfull
    leaves.  ``ids`` must already be present in ``tree.feats``."""
    if ids.size == 0:
        return
    f = tree._feats[ids]
    node.lo = np.minimum(node.lo, f.min(axis=0))
    node.hi = np.maximum(node.hi, f.max(axis=0))
    if node.is_leaf:
        node.ids = np.concatenate([node.ids, ids])
        if node.ids.size > tree.leaf_fill:
            _split_leaf(tree, node)
    else:
        _route_children(tree, node, ids)


def _split_leaf(tree: SplitTree, node: TreeNode):
    """Convert an overfull leaf into an internal node by promoting the
    deterministic split dimension one bit and re-routing its members
    (which recursively splits any still-overfull child)."""
    dim = split_dim_for(tree, node.bits)
    if dim is None:
        return                        # cannot refine further
    node.split_dim = dim
    node.children = {}
    ids, node.ids = node.ids, None
    _route_children(tree, node, ids)


def _route_children(tree: SplitTree, node: TreeNode, ids: np.ndarray):
    """Partition ``ids`` by their symbol on the node's split dimension at
    the promoted cardinality; create children lazily."""
    child_bits = int(node.bits[node.split_dim]) + 1
    syms = tree.symbols(tree._feats[ids], node.split_dim, child_bits)
    for s in np.unique(syms):
        child = node.children.get(int(s))
        if child is None:
            bits = node.bits.copy()
            bits[node.split_dim] += 1
            child = _new_node(bits)
            node.children[int(s)] = child
            tree.n_nodes += 1
        route(tree, child, ids[syms == s])
