"""Clustered scene packing for the traversal kernel (tpurt/kernels/traversal.py).

Large scenes (config 4's ~82k tris, config 5's ~1M — BASELINE.json:10-11)
are partitioned on the host into ≤LEAF-triangle clusters
(tpurt/accel/clusters.py); this module packs, per cluster and inside jit:

* ``forms``  (C, FORMS, LEAF) — the 12 Baldwin–Weber coefficients of every
  triangle, component-major so a kernel step loads each coefficient of a
  run of triangles as one contiguous vector;
* ``gid``    (C, LEAF) int32 — global triangle id of each slot (short
  clusters repeat their first triangle: harmless under closest/any-hit);
* ``box``    (C, 8) — cluster bounds [lo xyz, 0, hi xyz, 0], padded by
  BOX_PAD so conservative tests stay conservative under f32 rounding;
* ``sph``    (S, 4) — sphere center + radius (tested brute force, outside
  the kernel; S = 0 rows' worth of work when the scene has no spheres).

Bounds are REFIT from the current vertices on every call (the cluster
topology `tri_ids` is frozen at build time), so optimisation steps that
move vertices keep a valid acceleration structure without a host rebuild.
Everything here feeds integer topology only, so it is stop-gradient.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from tpurt import constants as C
from tpurt.core import vec
from tpurt.core.types import pytree_dataclass

#: coefficient rows of ``forms``: N (3), -N·v0, r1 (3), c1, r2 (3), c2
FORMS = 12
#: absolute padding of cluster boxes.  Shadow rays start RAY_OFFSET_EPS off
#: the surface, and the light-origin cull (traversal.py) tests the
#: unshifted segment, so boxes grow by more than that offset.
BOX_PAD = 2.0 * C.RAY_OFFSET_EPS


@pytree_dataclass(meta_fields=("n_clusters", "n_spheres", "n_tris"))
class PackedClusters:
    forms: Any      # (C, FORMS, LEAF) f32
    gid: Any        # (C, LEAF) int32
    box: Any        # (C, 8) f32
    sph: Any        # (max(S, 1), 4) f32
    n_clusters: int
    n_spheres: int  # spheres the traversal tests (0: mesh-only scene)
    n_tris: int     # total triangles (gid >= n_tris ⇒ sphere)


def tri_forms(v0, e1, e2):
    """Baldwin–Weber coefficients of triangles (v0, e1, e2) → (FORMS, T).

    With N = e1×e2, det = N·N: t = -(N·o - N·v0)/(N·d) and the barycentrics
    u = r1·p + c1, v = r2·p + c2 at p = o + t·d.  Degenerate triangles get
    N = 0, so |N·d| < MT_DET_EPS masks them, and a nonzero numerator keeps
    0/0 out."""
    n = vec.cross(e1, e2)
    det = vec.dot(n, n)
    safe = jnp.where(det < 1e-18, 1.0, det)[..., None]
    r1 = vec.cross(e2, n) / safe
    r2 = vec.cross(n, e1) / safe
    nd = jnp.where(det < 1e-18, -1.0, vec.dot(n, v0))
    c1 = -vec.dot(r1, v0)
    c2 = -vec.dot(r2, v0)
    cols = [n[:, 0], n[:, 1], n[:, 2], -nd,
            r1[:, 0], r1[:, 1], r1[:, 2], c1,
            r2[:, 0], r2[:, 1], r2[:, 2], c2]
    return jnp.stack(cols, axis=0)


def pack_clusters(scene, tri_ids) -> PackedClusters:
    """Scene + frozen cluster topology (C, LEAF) int32 → PackedClusters."""
    scene = jax.lax.stop_gradient(scene)
    Ccount, leaf = tri_ids.shape
    flat = tri_ids.reshape(-1)
    tri = scene.triangles[flat]                   # (C*LEAF, 3)
    v0 = scene.vertices[tri[:, 0]]
    v1 = scene.vertices[tri[:, 1]]
    v2 = scene.vertices[tri[:, 2]]
    forms = tri_forms(v0, v1 - v0, v2 - v0)       # (FORMS, C*LEAF)
    forms = forms.reshape(FORMS, Ccount, leaf).transpose(1, 0, 2)

    lo = jnp.minimum(jnp.minimum(v0, v1), v2).reshape(Ccount, leaf, 3)
    hi = jnp.maximum(jnp.maximum(v0, v1), v2).reshape(Ccount, leaf, 3)
    lo = lo.min(axis=1) - BOX_PAD
    hi = hi.max(axis=1) + BOX_PAD
    zero = jnp.zeros((Ccount, 1), C.DTYPE)
    box = jnp.concatenate([lo, zero, hi, zero], axis=1)

    n_sph = 0 if scene.n_real_spheres == 0 else scene.n_spheres
    if n_sph:
        sph = jnp.concatenate(
            [scene.sph_center, scene.sph_radius[:, None]], axis=1)
    else:
        sph = jnp.zeros((1, 4), C.DTYPE)
    return PackedClusters(
        forms=forms,
        gid=tri_ids.astype(jnp.int32),
        box=box,
        sph=sph,
        n_clusters=Ccount,
        n_spheres=n_sph,
        n_tris=scene.n_tris,
    )
