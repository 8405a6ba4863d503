"""Host-side cluster-BVH build (SURVEY.md §2 row R4 — the reference builds a
BVH on the C++ host; here the build is host-side numpy, with a C++ builder in
tpurt/accel/native for large scenes).

The traversal wants neither per-thread stacks nor pointer chasing
(SURVEY.md §7 "hard parts": divergent traversal on a vector machine).  The
structure built here is therefore a TWO-LEVEL flattening of a median-split
BVH: the tree is descended only until leaves hold ≤ LEAF triangles; each
leaf becomes a CLUSTER stored as one contiguous padded block.  The
traversal culls whole clusters against a ray tile with a batched interval
slab test, then walks only the surviving blocks and intersects them
densely — masked vector work instead of divergent scalar traversal
(tpurt/kernels/traversal.py).

Padding uses DUPLICATES of the cluster's first triangle: duplicates are
harmless under closest-hit (ties resolve to the same triangle id) and under
any-hit (boolean or).
"""
from __future__ import annotations

import dataclasses

import numpy as np

LEAF = 128  # triangles per cluster block (= kernel lane width)


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Flattened cluster partition of a triangle set.

    tri_ids:  (C, LEAF) int32 — global triangle index per slot (duplicates
              pad short clusters; a cluster is never empty).
    aabb_lo:  (C, 3) f32, aabb_hi: (C, 3) f32 — cluster bounds.
    """

    tri_ids: np.ndarray
    aabb_lo: np.ndarray
    aabb_hi: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.tri_ids.shape[0]


def build_clusters(vertices, triangles, leaf: int = LEAF) -> ClusterSet:
    """Median-split partition of triangles into ≤leaf-sized spatial clusters.

    vertices (V, 3) f32, triangles (T, 3) i32 (numpy or anything
    np.asarray-able).  O(T log T) host build, geometry-only (no materials).
    """
    verts = np.asarray(vertices, np.float32)
    tris = np.asarray(triangles, np.int64)
    T = tris.shape[0]
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    cent = (lo + hi) * 0.5

    leaves: list[np.ndarray] = []

    # iterative median split (avoids python recursion limits at 1M tris)
    stack = [np.arange(T)]
    while stack:
        idx = stack.pop()
        if len(idx) <= leaf:
            leaves.append(idx)
            continue
        # split at a multiple of `leaf` so leaves come out full (a plain
        # halving of e.g. 81920 tris bottoms out at 80-tri leaves — 60% more
        # clusters to cull and stream for the same geometry); WHICH multiple
        # and WHICH axis come from a surface-area-heuristic sweep over all
        # three centroid-sorted axes (mirrors the C++ builder): SAH
        # minimizes child-box area × count, i.e. the expected cull-survivor
        # count the flat traversal pays per ray bundle
        n = len(idx)

        def _ha(blo, bhi):
            d = np.maximum(bhi - blo, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        ks = np.arange(leaf, n, leaf)
        best = None
        for axis in range(3):
            srt = idx[np.argsort(cent[idx, axis], kind="stable")]
            klo, khi = lo[srt], hi[srt]
            llo = np.minimum.accumulate(klo)
            lhi = np.maximum.accumulate(khi)
            rlo = np.minimum.accumulate(klo[::-1])[::-1]
            rhi = np.maximum.accumulate(khi[::-1])[::-1]
            cost = _ha(llo[ks - 1], lhi[ks - 1]) * ks + _ha(
                rlo[ks], rhi[ks]) * (n - ks)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (float(cost[j]), srt, int(ks[j]))
        _, srt, half = best
        stack.append(srt[:half])
        stack.append(srt[half:])

    C = len(leaves)
    tri_ids = np.empty((C, leaf), np.int32)
    aabb_lo = np.empty((C, 3), np.float32)
    aabb_hi = np.empty((C, 3), np.float32)
    for ci, idx in enumerate(leaves):
        pad = np.full(leaf - len(idx), idx[0], np.int64)
        tri_ids[ci] = np.concatenate([idx, pad])
        aabb_lo[ci] = lo[idx].min(0)
        aabb_hi[ci] = hi[idx].max(0)
    return ClusterSet(tri_ids=tri_ids, aabb_lo=aabb_lo, aabb_hi=aabb_hi)
