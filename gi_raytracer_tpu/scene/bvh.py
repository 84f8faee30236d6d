"""Host-side flat BVH builder with preorder skip links.

Replaces the reference's recursive pointer octree (octree.cpp:316-384) with a
median-split BVH emitted directly as flat arrays for stackless lockstep
traversal: node i descends to i+1 on AABB hit and jumps to skip[i] on
miss / after a leaf; skip[last] == n_nodes terminates.

Build is O(N log N) NumPy (argsort-based median split over the longest
centroid axis).  A C++ builder with the same array contract can be slotted in
for very large scenes (see gi_raytracer_tpu/native).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BVHArrays:
    node_min: np.ndarray   # (N, 3) float
    node_max: np.ndarray   # (N, 3) float
    skip: np.ndarray       # (N,) int32
    first: np.ndarray      # (N,) int32
    count: np.ndarray      # (N,) int32 (0 => inner node)
    prim_idx: np.ndarray   # (P,) int32


def build_bvh(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int = 4,
              use_native: bool = True) -> BVHArrays:
    """Build from per-primitive AABBs (pmin/pmax: (P, 3)).

    Prefers the native binned-SAH builder (gi_raytracer_tpu/native) when the
    toolchain is available; falls back to the NumPy median-split builder.
    Both emit the identical preorder skip-link array contract.
    """
    if use_native and len(pmin) > 0:
        from ..native import build_bvh_native
        out = build_bvh_native(np.asarray(pmin), np.asarray(pmax), leaf_size)
        if out is not None:
            return out
    return _build_bvh_numpy(pmin, pmax, leaf_size)


def _build_bvh_numpy(pmin: np.ndarray, pmax: np.ndarray,
                     leaf_size: int = 4) -> BVHArrays:
    P = len(pmin)
    if P == 0:
        return BVHArrays(np.zeros((1, 3), np.float64),
                         np.zeros((1, 3), np.float64),
                         np.array([1], np.int32), np.array([0], np.int32),
                         np.array([0], np.int32), np.zeros(0, np.int32))

    centers = (pmin + pmax) * 0.5
    node_min, node_max, first, count = [], [], [], []
    children = []            # per-node: (left_child, right_child) or None
    order = []               # final primitive order

    def emit(idx: np.ndarray) -> int:
        """Create node for prims idx, return node id (preorder by recursion)."""
        nid = len(node_min)
        bmin = pmin[idx].min(0)
        bmax = pmax[idx].max(0)
        node_min.append(bmin); node_max.append(bmax)
        if len(idx) <= leaf_size:
            first.append(len(order)); count.append(len(idx))
            order.extend(idx.tolist())
            children.append(None)
            return nid
        first.append(0); count.append(0)
        children.append(None)  # patched below
        c = centers[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        srt = idx[np.argsort(c[:, axis], kind="stable")]
        half = len(srt) // 2
        left = emit(srt[:half])
        right = emit(srt[half:])
        children[nid] = (left, right)
        return nid

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * int(np.log2(P + 1) + 64)))
    try:
        emit(np.arange(P))
    finally:
        sys.setrecursionlimit(old_limit)

    n = len(node_min)
    skip = np.full(n, n, np.int32)

    # iterative threading to avoid recursion limits on deep trees
    stack = [(0, n)]
    while stack:
        nid, escape = stack.pop()
        skip[nid] = escape
        ch = children[nid]
        if ch is not None:
            left, right = ch
            stack.append((left, right))
            stack.append((right, escape))

    return BVHArrays(np.asarray(node_min), np.asarray(node_max),
                     skip.astype(np.int32),
                     np.asarray(first, np.int32), np.asarray(count, np.int32),
                     np.asarray(order, np.int32))
