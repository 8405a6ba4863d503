"""Geometry shared by the oracle and (as reference math) the fast paths:
camera ray generation, Möller–Trumbore ray-triangle, ray-sphere.

These are the JAX equivalents of SURVEY.md §2 rows R1–R3 (the
reference's OpenCL C device routines; reference unreadable this round —
provenance BASELINE.json:5).  Everything is written array-wise over an
arbitrary leading ray batch shape so the same code vectorizes
under jit and inside Pallas kernels.

Broadcasting convention: ray args have shape (..., 3); primitive args have a
leading primitive axis (P, 3) (or (P,)).  Pairwise routines return arrays of
shape (..., P).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tpurt import constants as C
from tpurt.core import vec


# ---------------------------------------------------------------------------
# R1: camera ray generation (pinhole; conventions in tpurt/constants.py)
# ---------------------------------------------------------------------------
def generate_rays(camera, height: int, width: int, row0=0, nrows=None):
    """Primary rays through every pixel center.

    Returns (origins, directions): ((nrows, W, 3), (nrows, W, 3)); directions
    unit.  Row 0 is the top of the image; pixel centers at (j+0.5, i+0.5).
    `row0`/`nrows` select a horizontal slab of the full image — the shard_map
    tile path passes each device its own slab (row0 may be traced; nrows is
    static).  NDC is always computed against the FULL image height so a
    sharded render is pixel-identical to a single-device one.
    """
    if nrows is None:
        nrows = height
    fwd, right, true_up = camera.basis()
    aspect = width / height
    half_h = jnp.tan(camera.fov_y * 0.5)
    half_w = half_h * aspect

    rows = row0 + jnp.arange(nrows, dtype=C.DTYPE)
    i = (rows + 0.5) / height                               # rows, top→bottom
    j = (jnp.arange(width, dtype=C.DTYPE) + 0.5) / width    # cols, left→right
    # NDC in [-1, 1]; +y is up, so row 0 (top) maps to +1.
    sx = (2.0 * j - 1.0) * half_w            # (W,)
    sy = (1.0 - 2.0 * i) * half_h            # (H,)

    d = (
        fwd[None, None, :]
        + sx[None, :, None] * right[None, None, :]
        + sy[:, None, None] * true_up[None, None, :]
    )
    d = vec.normalize(d)
    o = jnp.broadcast_to(camera.eye, d.shape)
    return o, d


def pixel_dirs_terms(camera, height: int, width: int):
    """Decomposed ray-gen terms for in-kernel reconstruction.

    Returns (eye(3,), fwd(3,), right_scaled(3,), up_scaled(3,)) such that the
    *unnormalized* direction of pixel (i, j) is
    ``fwd + ((2(j+.5)/W)-1)*right_scaled + (1-2(i+.5)/H)*up_scaled``.
    The Pallas ray-gen stage uses these so that camera math inside the kernel
    is 3 fused multiply-adds per component, identical to generate_rays().
    """
    fwd, right, true_up = camera.basis()
    aspect = width / height
    half_h = jnp.tan(camera.fov_y * 0.5)
    half_w = half_h * aspect
    return camera.eye, fwd, right * half_w, true_up * half_h


# ---------------------------------------------------------------------------
# R2: Möller–Trumbore ray-triangle intersection
# ---------------------------------------------------------------------------
def intersect_tris(o, d, v0, e1, e2, t_min=C.T_MIN, t_max=C.T_MAX):
    """Rays (..., 3) vs triangles (T, 3) given v0 and edges e1=v1-v0, e2=v2-v0.

    Returns (hit (..., T) bool, t (..., T), u (..., T), v (..., T)).
    Misses carry t = T_NONE.  Degenerate (near-parallel) pairs are masked by
    MT_DET_EPS on |det|, which also keeps 1/det finite for gradients.
    """
    o = o[..., None, :]
    d = d[..., None, :]
    pvec = vec.cross(d, e2)                      # (..., T, 3)
    det = vec.dot(e1, pvec)                      # (..., T)
    # Keep inv_det finite even when det ~ 0; such pairs are masked out below,
    # and the where() on det keeps NaNs out of the backward pass.
    safe_det = jnp.where(jnp.abs(det) < C.MT_DET_EPS, 1.0, det)
    inv_det = 1.0 / safe_det
    tvec = o - v0                                # (..., T, 3)
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) >= C.MT_DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    t = jnp.where(hit, t, C.T_NONE)
    return hit, t, u, v


# ---------------------------------------------------------------------------
# R3: ray-sphere intersection
# ---------------------------------------------------------------------------
def intersect_spheres(o, d, center, radius, t_min=C.T_MIN, t_max=C.T_MAX):
    """Rays (..., 3) vs spheres (S, 3)/(S,).  Directions must be unit length
    (so a == 1 and the quadratic simplifies — ray-gen guarantees this).

    Returns (hit (..., S) bool, t (..., S)) with the nearest positive root in
    range; misses carry t = T_NONE.
    """
    oc = o[..., None, :] - center                # (..., S, 3)
    b = vec.dot(oc, d[..., None, :])             # half-b, since a == 1
    c = vec.dot(oc, oc) - radius * radius
    disc = b * b - c
    has_root = disc > 0.0
    sq = jnp.sqrt(jnp.where(has_root, disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    # nearest root inside (t_min, t_max): prefer t0, fall back to t1
    t0_ok = has_root & (t0 > t_min) & (t0 < t_max)
    t1_ok = has_root & (t1 > t_min) & (t1 < t_max)
    t = jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, C.T_NONE))
    hit = t0_ok | t1_ok
    return hit, t


def sphere_normal(p, center):
    """Outward unit normal of a sphere at surface point p."""
    return vec.normalize(p - center)


# ---------------------------------------------------------------------------
# closest-hit / any-hit reductions over a whole scene (brute force)
# ---------------------------------------------------------------------------
def closest_hit(scene, o, d, t_min=C.T_MIN, t_max=C.T_MAX):
    """Brute-force closest hit of rays (..., 3) against ALL primitives.

    Returns a dict hit record (all (...,)-shaped):
      t         — distance (T_NONE on miss)
      hit       — bool
      is_tri    — bool, triangle vs sphere
      prim      — int32 primitive index (into tris or spheres)
      u, v      — triangle barycentrics (0 where sphere/miss)
    The record's integer fields identify hit topology; shading recomputes
    positions/normals from them so gradients flow through geometry at fixed
    topology (SURVEY.md §7 "hard parts").
    """
    v0 = scene.vertices[scene.triangles[:, 0]]
    e1 = scene.vertices[scene.triangles[:, 1]] - v0
    e2 = scene.vertices[scene.triangles[:, 2]] - v0
    _, t_tri, u, v = intersect_tris(o, d, v0, e1, e2, t_min, t_max)
    _, t_sph = intersect_spheres(o, d, scene.sph_center, scene.sph_radius, t_min, t_max)

    tri_idx = jnp.argmin(t_tri, axis=-1)
    tri_t = jnp.min(t_tri, axis=-1)
    tri_u = jnp.take_along_axis(u, tri_idx[..., None], axis=-1)[..., 0]
    tri_v = jnp.take_along_axis(v, tri_idx[..., None], axis=-1)[..., 0]

    sph_idx = jnp.argmin(t_sph, axis=-1)
    sph_t = jnp.min(t_sph, axis=-1)

    is_tri = tri_t <= sph_t
    t = jnp.minimum(tri_t, sph_t)
    return {
        "t": t,
        "hit": t < C.T_MAX,
        "is_tri": is_tri,
        "prim": jnp.where(is_tri, tri_idx, sph_idx).astype(C.INDEX_DTYPE),
        "u": jnp.where(is_tri, tri_u, 0.0),
        "v": jnp.where(is_tri, tri_v, 0.0),
    }


def any_hit(scene, o, d, t_max):
    """Brute-force occlusion test: True where ANY primitive lies in
    (T_MIN, t_max) along the ray.  t_max has the rays' batch shape.
    Used for shadow rays (SURVEY.md §2 row R7)."""
    v0 = scene.vertices[scene.triangles[:, 0]]
    e1 = scene.vertices[scene.triangles[:, 1]] - v0
    e2 = scene.vertices[scene.triangles[:, 2]] - v0
    hit_t, t_tri, _, _ = intersect_tris(o, d, v0, e1, e2)
    hit_s, t_sph = intersect_spheres(o, d, scene.sph_center, scene.sph_radius)
    occ_tri = jnp.any(hit_t & (t_tri < t_max[..., None]), axis=-1)
    occ_sph = jnp.any(hit_s & (t_sph < t_max[..., None]), axis=-1)
    return occ_tri | occ_sph
