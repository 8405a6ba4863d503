"""Differentiable scene packing for the phase-1 path (tpurt/kernels/phase1.py).

The reference packs scene structs into flat GPU buffers on the C++ host
(SURVEY.md §2 row R11, [ARCHETYPE]).  The equivalent here is a pure
jnp transform Scene → PackedScene that runs OUTSIDE the kernel but INSIDE
jit/autodiff, so scene-parameter gradients (vertices, normals, materials,
lights, camera — BASELINE.json:5) flow through the packing chain rule while
the tile program stays gather-free.

Data layout (rays ride in columns; primitives in rows):

* ``wtri`` (8, 6·T): per-triangle linear intersection forms, block-major.
  Triangle intersection is ``dot_general(wtri_block, X, contract dim0)``
  where ``X`` (8, R) stacks [ox,oy,oz,1, dx,dy,dz,0] per ray — a
  Baldwin–Weber-style precomputed-transform test: one matrix product
  instead of a cross-product chain per pair (Möller–Trumbore stays the oracle
  and the unit-level ground truth; both compute identical t,u,v up to fp
  rounding).  For triangle (v0, e1, e2) with N = e1×e2, det = N·N:
      t = (N·v0 - N·o) / (N·d)
      u = r1·p + c1,  r1 = (e2×N)/det,  c1 = -r1·v0,  p = o + t d
      v = r2·p + c2,  r2 = (N×e1)/det,  c2 = -r2·v0
  Six columns per triangle: [N·o - nd | N·d | r1·o+c1 | r1·d | r2·o+c2 | r2·d].
* ``wsph`` (8, 2·S): two columns per sphere: [-2c·o + (c·c - r²) | c·d]
  (unit d ⇒ a == 1; b = o·d - c·d, cterm = o·o - 2o·c + c·c - r²).
* ``attrs`` (P, ACOLS), P = T_pad + S_pad: per-primitive shading attributes,
  fetched by one-hot matmul (never a gather).
* ``globals`` (1, NGLOB): camera basis, ambient, per-light pos/color.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tpurt import constants as C
from tpurt.core import vec
from tpurt.core.types import pytree_dataclass

# attribute column layout (P, ACOLS)
A_GN = 0        # geometric normal (3)
A_N0 = 3        # vertex normals (3 × 3); == gn for flat shading
A_N1 = 6
A_N2 = 9
A_UV0 = 12      # per-corner uv (3 × 2)
A_UV1 = 14
A_UV2 = 16
A_KA = 18       # material ka/kd/ks (3 × 3)
A_KD = 21
A_KS = 24
A_SHIN = 27
A_REFL = 28
A_IS_SPH = 29
A_CENTER = 30   # sphere center (3)
A_RADIUS = 33
A_TEXID = 34    # float texture id; -1 = untextured
ACOLS = 64      # padded

NGLOB_BASE = 15  # eye(3) fwd(3) right_s(3) up_s(3) ambient(3)

LANES = 128     # primitive block width


@pytree_dataclass(
    meta_fields=(
        "n_tri_blocks", "n_sph_blocks", "n_lights", "smooth", "tlb", "slb"
    )
)
class PackedScene:
    """tlb/slb: primitive-block sublane width (multiple of 8, ≤ LANES).

    Small scenes use sub-128 blocks: the (block, R) t/u/v/hit math that
    dominates small scenes shrinks proportionally (a 6-prim scene does
    (8, R) elementwise work instead of (128, R): 16× less)."""

    wtri: Any       # (8, 6 * T_pad) f32, block-major [6, tlb] per block
    wsph: Any       # (8, 2 * S_pad) f32, block-major [2, slb] per block
    attrs: Any      # (T_pad + S_pad, ACOLS) f32
    globals: Any    # (1, NGLOB) f32
    n_tri_blocks: int
    n_sph_blocks: int
    n_lights: int
    smooth: bool
    tlb: int = LANES
    slb: int = LANES


def _pad_axis(x, n, axis=0, value=0.0):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return jnp.pad(x, pad, constant_values=value)


def tri_form_groups(v0, e1, e2):
    """Baldwin–Weber linear forms for triangles (v0, e1, e2) → (8, 6, T).

    Degenerate (pad) triangles have N == 0 ⇒ |N·d| < eps ⇒ masked in-kernel;
    their t numerator is kept nonzero so no 0/0 NaN can form."""
    N = vec.cross(e1, e2)
    det = vec.dot(N, N)
    safe_det = jnp.where(det < 1e-18, 1.0, det)[..., None]
    r1 = vec.cross(e2, N) / safe_det
    r2 = vec.cross(N, e1) / safe_det
    nd = vec.dot(N, v0)
    c1 = -vec.dot(r1, v0)
    c2 = -vec.dot(r2, v0)
    nd = jnp.where(det < 1e-18, -1.0, nd)

    zeros3 = jnp.zeros_like(v0)
    zeros1 = jnp.zeros_like(nd)

    def col(o_part3, o_part1, d_part3, d_part1=None):
        """One (8, T) column group: [o·a + b | d·a (+ b')] per primitive."""
        d_part1 = zeros1 if d_part1 is None else d_part1
        return jnp.stack(
            [
                o_part3[:, 0], o_part3[:, 1], o_part3[:, 2], o_part1,
                d_part3[:, 0], d_part3[:, 1], d_part3[:, 2], d_part1,
            ],
            axis=0,
        )  # (8, T)

    g_no = col(N, -nd, zeros3)          # N·o - nd
    g_nd = col(zeros3, zeros1, N)       # N·d
    g_uo = col(r1, c1, zeros3)          # r1·o + c1
    g_ud = col(zeros3, zeros1, r1)      # r1·d
    g_vo = col(r2, c2, zeros3)          # r2·o + c2
    g_vd = col(zeros3, zeros1, r2)      # r2·d
    return jnp.stack([g_no, g_nd, g_uo, g_ud, g_vo, g_vd], axis=1)  # (8,6,T)


def sphere_form_groups(cen, rad):
    """Sphere quadratic columns → (8, 2, S): [-2c·o + (c·c - r²) | c·d]."""
    cc_r2 = vec.dot(cen, cen) - rad * rad
    zs3 = jnp.zeros_like(cen)
    zs1 = jnp.zeros_like(rad)
    s_ct = jnp.stack(
        [
            -2.0 * cen[:, 0], -2.0 * cen[:, 1], -2.0 * cen[:, 2], cc_r2,
            zs3[:, 0], zs3[:, 1], zs3[:, 2], zs1,
        ],
        axis=0,
    )
    s_cd = jnp.stack(
        [zs3[:, 0], zs3[:, 1], zs3[:, 2], zs1, cen[:, 0], cen[:, 1], cen[:, 2], zs1],
        axis=0,
    )
    return jnp.stack([s_ct, s_cd], axis=1)  # (8, 2, S)


def block_major(groups, pad_to, lanes: int = LANES):
    """(8, G, P) column groups → (8, G*pad_to) block-major [G, lanes] layout."""
    G = groups.shape[1]
    groups = _pad_axis(groups, pad_to, axis=2)
    nb = pad_to // lanes
    return (
        groups.reshape(8, G, nb, lanes).transpose(0, 2, 1, 3).reshape(8, G * pad_to)
    )


def block_width(n: int) -> int:
    """Primitive-block sublane width for n primitives: the smallest multiple
    of 8 covering n, capped at LANES (multi-block scenes use full blocks)."""
    return min(LANES, max(8, -(-n // 8) * 8))


def globals_vec(scene):
    """(1, NGLOB) camera/ambient/light packing shared by every kernel."""
    cam = scene.camera
    fwd, right, true_up = cam.basis()
    half_h = jnp.tan(cam.fov_y * 0.5)
    return jnp.concatenate(
        [
            cam.eye, fwd,
            right * half_h,    # × aspect applied in-kernel (needs W/H statics)
            true_up * half_h,
            jnp.asarray(scene.ambient, C.DTYPE).reshape(3),
            scene.light_pos.reshape(-1),
            scene.light_color.reshape(-1),
        ]
    )[None, :]


def pack_scene(scene) -> PackedScene:
    """Pure-jnp, differentiable Scene → PackedScene."""
    T = scene.n_tris
    S = scene.n_spheres
    tlb = block_width(T)
    slb = block_width(S)
    T_pad = max(tlb, -(-T // tlb) * tlb)
    S_pad = max(slb, -(-S // slb) * slb)

    tri = scene.triangles
    v0 = scene.vertices[tri[:, 0]]
    e1 = scene.vertices[tri[:, 1]] - v0
    e2 = scene.vertices[tri[:, 2]] - v0
    wtri = block_major(tri_form_groups(v0, e1, e2), T_pad, tlb)
    nb_t = T_pad // tlb

    cen = scene.sph_center
    rad = scene.sph_radius
    wsph = block_major(sphere_form_groups(cen, rad), S_pad, slb)
    nb_s = S_pad // slb
    N = vec.cross(e1, e2)

    # ---- attribute table ---------------------------------------------------
    gn = vec.normalize(N)
    if scene.smooth:
        n0 = scene.vnormals[tri[:, 0]]
        n1 = scene.vnormals[tri[:, 1]]
        n2 = scene.vnormals[tri[:, 2]]
    else:
        n0 = n1 = n2 = gn
    uv0 = scene.uvs[tri[:, 0]]
    uv1 = scene.uvs[tri[:, 1]]
    uv2 = scene.uvs[tri[:, 2]]
    m = scene.materials
    tm = scene.tri_mat

    def mat_cols(ids):
        return (
            m.ka[ids], m.kd[ids], m.ks[ids],
            m.shininess[ids][:, None], m.reflectivity[ids][:, None],
            m.texture_id[ids].astype(C.DTYPE)[:, None],
        )

    ka_t, kd_t, ks_t, sh_t, rf_t, tx_t = mat_cols(tm)
    attrs_t = jnp.concatenate(
        [
            gn, n0, n1, n2, uv0, uv1, uv2, ka_t, kd_t, ks_t, sh_t, rf_t,
            jnp.zeros_like(sh_t),            # is_sphere = 0
            jnp.zeros((T, 3), C.DTYPE),      # center
            jnp.zeros((T, 1), C.DTYPE),      # radius
            tx_t,
        ],
        axis=1,
    )
    ka_s, kd_s, ks_s, sh_s, rf_s, tx_s = mat_cols(scene.sph_mat)
    zsn = jnp.zeros((S, 3), C.DTYPE)
    attrs_s = jnp.concatenate(
        [
            zsn, zsn, zsn, zsn,              # normals come from center/radius
            jnp.zeros((S, 6), C.DTYPE),      # uv
            ka_s, kd_s, ks_s, sh_s, rf_s,
            jnp.ones((S, 1), C.DTYPE),       # is_sphere = 1
            cen, rad[:, None], tx_s,
        ],
        axis=1,
    )
    attrs = jnp.concatenate(
        [_pad_axis(attrs_t, T_pad, axis=0), _pad_axis(attrs_s, S_pad, axis=0)],
        axis=0,
    )
    attrs = jnp.pad(attrs, ((0, 0), (0, ACOLS - attrs.shape[1])))

    glob = globals_vec(scene)

    return PackedScene(
        wtri=wtri,
        wsph=wsph,
        attrs=attrs,
        globals=glob,
        n_tri_blocks=nb_t,
        n_sph_blocks=nb_s,
        n_lights=scene.n_lights,
        smooth=scene.smooth,
        tlb=tlb,
        slb=slb,
    )
