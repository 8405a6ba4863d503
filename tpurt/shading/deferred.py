"""Deferred shading: differentiable image reconstruction from hit topology.

The scalable-scene architecture (SURVEY.md §7 step 4 + "hard parts"): the
traversal (tpurt/kernels/traversal.py) finds WHERE rays hit — integer
primitive ids per bounce and shadow-occlusion bitmasks — and this pure-jnp
pass recomputes every CONTINUOUS quantity (t, barycentrics, normals, Phong
terms) from those ids, differentiably, at XLA level.

Why the split:
* gradients: autodiff flows through gathers of (vertices, normals,
  materials, lights, camera) at *fixed* topology — exactly the
  piecewise-constant-visibility convention (BASELINE.json:5), with no
  custom_vjp needed and cost O(pixels × depth), independent of scene size;
* the non-differentiable, compute-heavy part (traversal, visibility) stays
  in the cluster-culled trace kernel;
* XLA fuses the whole replay into a handful of kernels over (N, ·) arrays.

The record format is backend-agnostic: `records_oracle` produces identical
records from the brute-force oracle, which is both the parity reference for
the traversal kernel and a CPU path for tests.
"""
from __future__ import annotations

import functools
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import ad_checkpoint, lax

from tpurt import constants as C
from tpurt.core import geom, vec
from tpurt.core.types import pytree_dataclass

#: backward of the material-table row gather as a one-hot matmul instead
#: of an N-row scatter-add into M rows (A/B constant, trace time; chosen on
#: the previous accelerator, not yet measured on the GPU).
MAT_SEGSUM = os.environ.get("TPURT_MAT_SEGSUM", "1") != "0"

#: backward of the texel quad-table gather as a FACTORED one-hot matmul:
#: dquad[r, c, k] = Σ_n Y[n,r]·X[n,c]·cot[n,k] with Y/X one-hots over the
#: (texture-row, texel-column) split instead of an N-update scatter-add
#: (see the MAT_SEGSUM note).
TEX_SEGSUM = os.environ.get("TPURT_TEX_SEGSUM", "1") != "0"
#: backward of the per-triangle shadepack gather as a SORTED segment-sum:
#: the hit topology is fixed (stop_gradient ints), so the forward graph
#: can afford an argsort of the 2M pids; the transpose then permutes the
#: cotangent rows (a gather) and segment-sums runs of equal pid with
#: indices_are_sorted=True, instead of scatter-adding N random rows into
#: the (T, 25) table.  A/B flag, off.
SORTED_SCATTER = os.environ.get("TPURT_SORTED_SCATTER", "0") != "0"

#: compacted chunked shading: sort pixels by (miss, pid) with a
#: stop-gradient argsort, shade in SHADE_CHUNKS chunks, and lax.cond-skip
#: chunks past the last hit.  On a mostly-miss frame of a big scene this
#: shrinks every per-pixel gather AND its backward scatter to the hit set.
#: Per-pixel math is identical and the permutation round-trips through
#: exact custom-vjp gathers, so images agree to compiler noise (fusion
#: differs at chunk shapes) and gradients differ from the unchunked path
#: only in scatter accumulation order (allclose).
#: "auto" gates compaction to scenes where the scatters it shrinks are the
#: dominant backward cost — the same 3·T > N regime as the direct vertex
#: transpose below; a scene with few triangles and many hits pays the
#: argsort and chunk machinery for nothing.  A RUNTIME lax.cond on the hit
#: fraction is a recorded negative (docs/design.md): the two branches'
#: (N, ·) residuals co-allocate.  "1"/"0" force on/off.
#: SHADE_REMAT: jax.checkpoint the COMPACTED-shading chunk body, so the
#: backward recomputes the chunk forward instead of loading scan
#: residuals, whose per-iteration buffers break fusion.  Applies only
#: inside _shade_compacted (the uncompacted path is not residual-bound).
#: Gradients differ only by refusion rounding (allclose; tested).
#: "names" (the default) additionally SAVES the wide shadepack/texel
#: gather rows (checkpoint_name 'shade_rows' + save_only_these_names) so
#: the backward recomputes the elementwise chains but not the gathers.
#: These gates were tuned on the previous accelerator and are not yet
#: re-measured on the GPU.
_SHADE_REMAT_ENV = os.environ.get("TPURT_SHADE_REMAT", "names")
SHADE_REMAT = _SHADE_REMAT_ENV != "0"


def _remat_policy():
    if _SHADE_REMAT_ENV in ("names", "outer"):
        return jax.checkpoint_policies.save_only_these_names("shade_rows")
    return None


SHADE_COMPACT = os.environ.get("TPURT_SHADE_COMPACT", "auto")
SHADE_CHUNKS = int(os.environ.get("TPURT_SHADE_CHUNKS", "32"))
SHADE_COMPACT_MIN = 1 << 17


def _shade_compact_on(n_tris: int, n_pix: int) -> bool:
    v = SHADE_COMPACT
    if isinstance(v, bool):      # tests monkeypatch booleans
        return v
    if v != "auto":
        return v != "0"
    return 3 * n_tris > n_pix

#: backward of the per-pixel pack-row gather as DIRECT scatters into the
#: merged per-vertex table: the shadepack is LINEAR in vtab, so the chain
#: cot_rows → (T, 25) pack scatter → 3 (V, 8) scatters at T updates can be
#: replaced by 3 (V, 8) scatters at N_pixels updates with analytically-
#: transposed column mixing — exact up to accumulation order.  With
#: compaction the pixel count is the HIT count, so the direct form moves
#: fewer rows whenever 3·n_hit < N + 3·T, i.e. for big scenes.  Auto rule
#: below; override with TPURT_PACK_DIRECT=0/1.
_PACK_DIRECT_ENV = os.environ.get("TPURT_PACK_DIRECT", "auto")


def _pack_direct(n_tris: int, n_pix: int) -> bool:
    if _PACK_DIRECT_ENV != "auto":
        return _PACK_DIRECT_ENV != "0"
    return 3 * n_tris > n_pix


@jax.custom_vjp
def _bij_gather(x, idx, idx_t, valid_t):
    """Gather y = x[idx] for a (padded) PERMUTATION whose transpose is the
    PRE-INVERTED gather instead of a scatter-add: dx[j] = cot[idx_t[j]]
    where valid_t[j], else 0.  Exact when idx restricted to valid_t's
    support is a bijection and the cotangent at padding positions is zero
    (compacted shading crops padding before the loss, so it is).  This
    keeps permutations at gather speed in both directions."""
    return x[idx]


def _bij_gather_fwd(x, idx, idx_t, valid_t):
    return x[idx], (idx.shape, idx_t, valid_t)


def _bij_gather_bwd(res, cot):
    idx_shape, idx_t, valid_t = res
    dx = cot[idx_t]
    mask = valid_t.reshape(valid_t.shape + (1,) * (dx.ndim - 1))
    f0 = lambda s: np.zeros(s, dtype=jax.dtypes.float0)  # noqa: E731
    return (jnp.where(mask, dx, 0.0), f0(idx_shape), f0(idx_t.shape),
            f0(valid_t.shape))


_bij_gather.defvjp(_bij_gather_fwd, _bij_gather_bwd)


@jax.custom_vjp
def _gather_rows_sorted(table, idx, order):
    """Row gather whose transpose scatter-adds in SORTED pid order.
    `order` must be argsort(idx) (precomputed in the forward graph from
    the stop_gradient'ed topology).  Forward is the plain gather
    (bit-identical); backward differs from the naive scatter only in
    accumulation order (allclose, not bit-equal)."""
    return table[idx]


def _gather_rows_sorted_fwd(table, idx, order):
    return table[idx], (idx, order, table.shape[0])


def _gather_rows_sorted_bwd(res, cot):
    idx, order, T = res
    cotf = cot.reshape(-1, cot.shape[-1])
    ids = idx.reshape(-1)[order]
    dtab = jax.ops.segment_sum(
        cotf[order], ids, num_segments=T, indices_are_sorted=True)
    f0 = lambda a: np.zeros(a.shape, dtype=jax.dtypes.float0)  # noqa: E731
    return dtab, f0(idx), f0(order)


_gather_rows_sorted.defvjp(_gather_rows_sorted_fwd, _gather_rows_sorted_bwd)


@jax.custom_vjp
def _gather_quad_factored(quad3, ridx, cidx):
    """Gather rows of a (R, C, K) table by (row, col) index pair; the
    transpose runs as K factored one-hot matmuls instead of an N-update
    scatter-add onto R·C rows.  Forward is the plain joint-index
    gather (bit-identical values); backward products are 0·x/1·x exact at
    f32 HIGHEST, so gradients differ from scatter-add only in accumulation
    order (allclose)."""
    R, Cc, K = quad3.shape
    return quad3.reshape(R * Cc, K)[ridx * Cc + cidx]


def _gather_quad_factored_fwd(quad3, ridx, cidx):
    return _gather_quad_factored(quad3, ridx, cidx), (
        ridx, cidx, quad3.shape)


def _gather_quad_factored_bwd(res, cot):
    ridx, cidx, (R, Cc, K) = res
    cotf = cot.reshape(-1, K)
    rf = ridx.reshape(-1)
    cf = cidx.reshape(-1)
    Y = (rf[:, None] == jnp.arange(R, dtype=rf.dtype)[None, :]).astype(
        cotf.dtype)                                   # (N, R)
    X = (cf[:, None] == jnp.arange(Cc, dtype=cf.dtype)[None, :]).astype(
        cotf.dtype)                                   # (N, C)
    planes = []
    for k in range(K):
        yk = Y * cotf[:, k : k + 1]
        planes.append(
            lax.dot_general(
                yk, X, (((0,), (0,)), ((), ())),
                precision=lax.Precision.HIGHEST,
            )
        )                                             # (R, C)
    dq = jnp.stack(planes, axis=-1)                   # (R, C, K)
    f0 = lambda a: np.zeros(a.shape, dtype=jax.dtypes.float0)  # noqa: E731
    return dq, f0(ridx), f0(cidx)


_gather_quad_factored.defvjp(
    _gather_quad_factored_fwd, _gather_quad_factored_bwd)


@jax.custom_vjp
def _gather_small(table, idx):
    """Row gather from a SMALL table (M rows ≪ N pixels) whose TRANSPOSE
    is a one-hot matmul: dL/dtable = onehot(idx)ᵀ @ cot instead of an
    N-update scatter-add onto M rows.
    Forward is the plain gather (unchanged cost/values); the backward sum
    is f32 HIGHEST (every product is 0·x or 1·x, exact — only the
    accumulation ORDER differs from scatter-add, so gradients are allclose,
    not bit-equal)."""
    return table[idx]


def _gather_small_fwd(table, idx):
    return table[idx], (idx, table.shape[0])


def _gather_small_bwd(res, cot):
    idx, M = res
    flat = idx.reshape(-1)
    cotf = cot.reshape(-1, cot.shape[-1])
    onehot = (
        flat[:, None] == jnp.arange(M, dtype=flat.dtype)[None, :]
    ).astype(cotf.dtype)
    dtab = lax.dot_general(
        onehot, cotf, (((0,), (0,)), ((), ())),
        precision=lax.Precision.HIGHEST,
    )
    return dtab, np.zeros(idx.shape, dtype=jax.dtypes.float0)


_gather_small.defvjp(_gather_small_fwd, _gather_small_bwd)


@pytree_dataclass
class HitRecords:
    """Per-depth hit topology for a flat bundle of N primary rays.

    prim:   (D, N) int32 — triangle index if is_tri else sphere index;
            -1 = miss.
    is_tri: (D, N) bool
    occ:    (D, N) int32 — bit l set ⇔ light l occluded at this bounce.
    D = max_depth + 1.
    """

    prim: Any
    is_tri: Any
    occ: Any


def records_oracle(scene, o, d, max_depth=C.DEFAULT_MAX_DEPTH, shadows=True):
    """Brute-force record producer (parity reference for traversal kernels).

    Record convention (shared with the traversal kernel): a lane is LIVE at
    depth d if every prior bounce hit a reflective surface; dead lanes get
    id -1 and occ 0 — their path throughput is zero, so the shader never
    reads them.  This makes record comparisons producer-agnostic lane by
    lane (the kernel emits exactly the same -1/-0 pattern).
    """
    prims, is_tris, occs = [], [], []
    alive = jnp.ones(o.shape[:-1], bool)
    for _ in range(max_depth + 1):
        rec = geom.closest_hit(scene, o, d)
        p, n, mat = _hit_geometry(scene, o, d, rec["t"], rec["prim"],
                                  rec["is_tri"], rec["u"], rec["v"])
        hit = rec["hit"] & alive
        p_off = p + n * C.RAY_OFFSET_EPS
        occ_bits = jnp.zeros(o.shape[:-1], C.INDEX_DTYPE)
        if shadows:
            for li in range(scene.n_lights):
                to_l = scene.light_pos[li] - p
                dist = vec.length(to_l)
                ldir = to_l / jnp.maximum(dist, 1e-20)[..., None]
                occluded = geom.any_hit(scene, p_off, ldir, dist - C.RAY_OFFSET_EPS)
                occ_bits = occ_bits | jnp.where(
                    hit & occluded, 1 << li, 0
                ).astype(C.INDEX_DTYPE)
        prims.append(jnp.where(hit, rec["prim"], -1).astype(C.INDEX_DTYPE))
        is_tris.append(rec["is_tri"] & hit)
        occs.append(occ_bits)
        o = p_off
        d = vec.reflect(d, n)
        refl = scene.materials.reflectivity[mat]
        alive = hit & (refl > 0.0)
    return HitRecords(
        prim=jnp.stack(prims), is_tri=jnp.stack(is_tris), occ=jnp.stack(occs)
    )


def _build_vtab(scene):
    """ONE merged per-vertex table [pos | normal? | uv?] gathered once per
    corner: 3 gathers instead of 9 (fields × corners), so the backward
    pass emits 3 (V, 8) scatter-adds instead of 9 (V, 2..3) ones — the
    fixed O(T)-update vertex scatters were half the bwd scatter rows at
    1M tris."""
    vcols = [scene.vertices]
    if scene.smooth:
        vcols.append(scene.vnormals)
    if scene.textured:
        vcols.append(scene.uvs)
    return jnp.concatenate(vcols, axis=-1) if len(vcols) > 1 else vcols[0]


def _pack_from_vtab(vtab, tri, tri_mat, smooth, textured):
    """(V, W) vertex table + topology → the (T, K) shadepack.  LINEAR in
    vtab (v0 = g0, e1 = g1 − g0, e2 = g2 − g0, normal/uv columns are
    slices) — the property _pack_gather's analytic transpose relies on.
    Column slices keep every downstream value the same subtraction/order
    as the inline path, so values and gradients are bit-identical."""
    g0 = vtab[tri[:, 0]]
    g1 = vtab[tri[:, 1]]
    g2 = vtab[tri[:, 2]]
    v0 = g0[:, 0:3]
    e1 = g1[:, 0:3] - v0
    e2 = g2[:, 0:3] - v0
    cols = [v0, e1, e2]
    k = 3
    if smooth:
        cols += [g0[:, k:k + 3], g1[:, k:k + 3], g2[:, k:k + 3]]
        k += 3
    if textured:
        cols += [g0[:, k:k + 2], g1[:, k:k + 2], g2[:, k:k + 2]]
    # material id as a float column (< 2^24, exact in f32): folds the 2M-row
    # tri_mat int gather into the same wide row; its cotangent is zero (used
    # only through an int cast), so the bwd scatter is unaffected
    cols += [lax.stop_gradient(tri_mat[:, None].astype(cols[0].dtype))]
    return jnp.concatenate(cols, axis=-1)


def _build_shadepack(scene):
    """Per-TRIANGLE gather table, O(T): ONE (T, K) concat of [v0|e1|e2]
    (cols 0:9), corner normals (9:18 when smooth) and corner uvs (next 6
    when textured).  Shading then does ONE wide row gather per pixel per
    depth instead of a triangle-index gather CHAINED into 3 dependent
    vertex/normal/uv gathers.  A single table
    also means the BACKWARD pass emits ONE (T, K) scatter-add per depth
    instead of one per use-site (the HLO showed 4 separate 2M-row scatters
    into (T, 9) before the merge)."""
    return _pack_from_vtab(_build_vtab(scene), scene.triangles,
                           scene.tri_mat, scene.smooth, scene.textured)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _pack_gather(smooth, textured, pack_sg, vtab, tri, pid):
    """Per-pixel shadepack-row gather whose TRANSPOSE scatters DIRECTLY
    into the merged per-vertex table: the pack is linear in vtab
    (_pack_from_vtab), so d_vtab is 3 (V, W) scatters at N_PIXEL updates
    with analytically-mixed columns, replacing the (T, K) pack scatter at
    N updates PLUS 3 (V, W) scatters at T updates the autodiff chain
    emits.  `pack_sg` must equal
    _pack_from_vtab(stop_gradient(vtab), tri, ...) — callers pass the
    prebuilt pack so the forward stays one wide gather; its cotangent here
    is zero (it feeds a stop_gradient).  Gradients are exact up to scatter
    accumulation order (allclose vs the chained form)."""
    return pack_sg[pid]


def _pack_gather_fwd(smooth, textured, pack_sg, vtab, tri, pid):
    return pack_sg[pid], (tri[pid], vtab.shape, pack_sg.shape, tri.shape,
                          pid.shape)


def _pack_gather_bwd(smooth, textured, res, cot):
    idx3, vtab_shape, pack_shape, tri_shape, pid_shape = res
    cotf = cot.reshape(-1, cot.shape[-1])
    i3 = idx3.reshape(-1, 3)
    c_v0 = cotf[:, 0:3]
    c_e1 = cotf[:, 3:6]
    c_e2 = cotf[:, 6:9]
    # v0 = g0, e1 = g1 - g0, e2 = g2 - g0 (transpose of the linear map)
    parts = [[c_v0 - c_e1 - c_e2], [c_e1], [c_e2]]
    k = 9
    if smooth:
        for c in range(3):
            parts[c].append(cotf[:, k + 3 * c : k + 3 * (c + 1)])
        k += 9
    if textured:
        for c in range(3):
            parts[c].append(cotf[:, k + 2 * c : k + 2 * (c + 1)])
    upds = [
        (jnp.concatenate(parts[c], axis=-1)
         if len(parts[c]) > 1 else parts[c][0])
        for c in range(3)
    ]
    # one scatter-add of all three corners (accumulation order is the
    # scatter's own; on the GPU it adds with atomics)
    dvtab = jnp.zeros(vtab_shape, cotf.dtype).at[i3.T.reshape(-1)].add(
        jnp.concatenate(upds, axis=0))
    f0 = lambda s: np.zeros(s, dtype=jax.dtypes.float0)  # noqa: E731
    return (jnp.zeros(pack_shape, cotf.dtype), dvtab, f0(tri_shape),
            f0(pid_shape))


_pack_gather.defvjp(_pack_gather_fwd, _pack_gather_bwd)


def _gather_shaderows(scene, pid, pack, vtab=None, gather_fn=None):
    """The one wide row gather per (pixel, depth): → (tri_rows, nrm_rows,
    uv_rows, mat) with statically-sliced columns (None where the scene has
    no such attribute); mat is the triangle's material id, int32.

    `vtab` (the differentiable merged vertex table) selects the
    _pack_gather direct-transpose backward; `gather_fn` overrides the
    gather entirely (scene-sharded rendering fetches rows around the
    device ring)."""
    if gather_fn is not None:
        g = gather_fn(pid)
    elif vtab is not None:
        g = _pack_gather(scene.smooth, scene.textured, pack, vtab,
                         scene.triangles, pid)
    elif SORTED_SCATTER:
        order = jnp.argsort(lax.stop_gradient(pid).reshape(-1))
        g = _gather_rows_sorted(pack, pid, order)
    else:
        g = pack[pid]
    # offerable to the "names" remat policy: the wide row gather is the
    # expensive-to-recompute part of the chunk body
    g = ad_checkpoint.checkpoint_name(g, "shade_rows")
    tri_rows = (g[..., 0:3], g[..., 3:6], g[..., 6:9])
    k = 9
    nrm_rows = None
    if scene.smooth:
        nrm_rows = (g[..., k:k + 3], g[..., k + 3:k + 6], g[..., k + 6:k + 9])
        k += 9
    uv_rows = None
    if scene.textured:
        uv_rows = (g[..., k:k + 2], g[..., k + 2:k + 4], g[..., k + 4:k + 6])
        k += 6
    mat = jnp.round(g[..., k]).astype(C.INDEX_DTYPE)
    return tri_rows, nrm_rows, uv_rows, mat


def _tri_rows(scene, pid, pack=None, rows=None):
    """v0/e1/e2 rows at pid — pre-gathered `rows` when the caller already
    did the wide gather, else one wide gather from `pack`, else the
    chained per-pixel gathers (used by callers that touch few rays, e.g.
    the wavefront reflection continuation, where building O(T) tables
    would cost more than they save)."""
    if rows is not None:
        return rows[0]
    if pack is not None:
        g = pack[pid]
        return g[..., 0:3], g[..., 3:6], g[..., 6:9]
    tri = scene.triangles[pid]
    v0 = scene.vertices[tri[..., 0]]
    e1 = scene.vertices[tri[..., 1]] - v0
    e2 = scene.vertices[tri[..., 2]] - v0
    return v0, e1, e2


def _recompute_tuv(scene, o, d, prim, is_tri, pack=None, rows=None):
    """Differentiable (t, u, v) at fixed topology.

    Triangles: Möller–Trumbore against the single gathered triangle
    (identical formulas/epsilons to the brute-force oracle).  Spheres:
    nearest-root-in-range quadratic.  Miss lanes get t = T_NONE.
    """
    pid = jnp.maximum(prim, 0)
    v0, e1, e2 = _tri_rows(scene, pid, pack, rows)
    pvec = vec.cross(d, e2)
    det = vec.dot(e1, pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < C.MT_DET_EPS, 1.0, det)
    tvec = o - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t_tri = vec.dot(e2, qvec) * inv_det

    if scene.n_real_spheres == 0:
        t_sph = jnp.zeros_like(t_tri)  # static: mesh-only scene
    else:
        cen = scene.sph_center[pid]
        rad = scene.sph_radius[pid]
        oc = o - cen
        b = vec.dot(oc, d)
        disc = b * b - (vec.dot(oc, oc) - rad * rad)
        has = disc > 0.0
        sq = jnp.sqrt(jnp.where(has, disc, 1.0))
        t0 = -b - sq
        t0_ok = has & (t0 > C.T_MIN) & (t0 < C.T_MAX)
        t_sph = jnp.where(t0_ok, t0, -b + sq)

    hit = prim >= 0
    t = jnp.where(is_tri, t_tri, t_sph)
    t = jnp.where(hit, t, C.T_NONE)
    u = jnp.where(is_tri & hit, u, 0.0)
    v = jnp.where(is_tri & hit, v, 0.0)
    return t, u, v


def _hit_geometry(scene, o, d, t, prim, is_tri, u, v, pack=None, rows=None):
    """Position, shading normal, material id (mirrors ref/oracle.py)."""
    pid = jnp.maximum(prim, 0)
    p = o + t[..., None] * d
    if scene.smooth:
        if rows is not None:
            n0, n1, n2 = rows[1]
        elif pack is not None:
            g = pack[pid]
            n0, n1, n2 = g[..., 9:12], g[..., 12:15], g[..., 15:18]
        else:
            tri = scene.triangles[pid]
            n0 = scene.vnormals[tri[..., 0]]
            n1 = scene.vnormals[tri[..., 1]]
            n2 = scene.vnormals[tri[..., 2]]
        w = (1.0 - u - v)[..., None]
        n_tri = vec.normalize(w * n0 + u[..., None] * n1 + v[..., None] * n2)
    else:
        _, e1, e2 = _tri_rows(scene, pid, pack, rows)
        n_tri = vec.normalize(vec.cross(e1, e2))
    n_tri = jnp.where(vec.dot(n_tri, d)[..., None] > 0.0, -n_tri, n_tri)
    mat_tri = rows[3] if rows is not None else scene.tri_mat[pid]
    if scene.n_real_spheres == 0:
        return p, n_tri, mat_tri
    n_sph = geom.sphere_normal(p, scene.sph_center[pid])
    n = jnp.where(is_tri[..., None], n_tri, n_sph)
    mat = jnp.where(is_tri, mat_tri, scene.sph_mat[pid])
    return p, n, mat


def _hit_uv_rows(uv_rows, u, v, is_tri):
    """Interpolated texture coordinates from pre-gathered corner-uv rows —
    same math as ref/oracle.py:_hit_uv, zero additional gathers."""
    uv0, uv1, uv2 = uv_rows
    w = (1.0 - u - v)[..., None]
    uv = w * uv0 + u[..., None] * uv1 + v[..., None] * uv2
    return jnp.where(is_tri[..., None], uv, 0.0)


def _sample_texture_flat(scene, tex_id, uv):
    """Bilinear texture lookup, element-for-element identical to
    ref/oracle.py:_sample_texture, via ONE wide row gather: a quad table
    (nt·th·tw, 12) bakes each texel's four bilinear corners
    [c(x,y) | c(x+1,y) | c(x,y+1) | c(x+1,y+1)] (wrap via jnp.roll, same
    semantics as the oracle's mod), so per pixel ONE (N, 12) gather
    replaces four (N, 3) texel gathers — and the backward pass pays one
    scatter-add plus four exact roll-transposes into the texture gradient
    instead of four 2M-row scatters.  The quad build is O(texels), tiny
    next to the pixel axis.  Products and adds are the oracle's exact
    expression on the same values — bit-identical images and gradients."""
    tid = jnp.maximum(tex_id, 0)
    nt, th, tw, _ = scene.textures.shape
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    tex = scene.textures
    quad = jnp.concatenate(
        [tex,
         jnp.roll(tex, -1, axis=2),                   # (x+1, y)
         jnp.roll(tex, -1, axis=1),                   # (x, y+1)
         jnp.roll(jnp.roll(tex, -1, axis=2), -1, axis=1)],  # (x+1, y+1)
        axis=-1,
    ).reshape(nt * th * tw, 12)
    xi = jnp.mod(x0.astype(jnp.int32), tw)
    yi = jnp.mod(y0.astype(jnp.int32), th)
    if TEX_SEGSUM:
        q = _gather_quad_factored(
            quad.reshape(nt * th, tw, 12), tid * th + yi, xi)
    else:
        q = quad[tid * (th * tw) + yi * tw + xi]      # (N, 12)
    q = ad_checkpoint.checkpoint_name(q, "shade_rows")
    col = (
        q[..., 0:3] * (1 - fx) * (1 - fy)
        + q[..., 3:6] * fx * (1 - fy)
        + q[..., 6:9] * (1 - fx) * fy
        + q[..., 9:12] * fx * fy
    )
    return jnp.where(tex_id[..., None] < 0, 1.0, col)


def shade_from_records(
    scene, o, d, recs: HitRecords, max_depth=C.DEFAULT_MAX_DEPTH,
    shadows=True, gather_fn=None,
):
    """Whitted shading replay from records → colors (N, 3), differentiable
    w.r.t. every float scene leaf.  Conventions identical to ref/oracle.py
    (tested: oracle records ⇒ bit-identical structure, allclose values).

    Big bundles are shaded COMPACTED (SHADE_COMPACT): pixels sorted by
    (miss, pid), chunks past the last hit cond-skipped — images agree to
    compiler noise (ulp-level FMA/fusion differences at chunk shapes),
    gradients allclose (scatter accumulation order).
    `gather_fn(pid) -> (N, K) rows` overrides the shadepack gather for
    scene-sharded rendering (collectives inside — compaction disabled:
    per-device chunk counts would diverge and deadlock the ring)."""
    N = o.shape[0]
    direct = gather_fn is None and _pack_direct(scene.n_tris, N)
    vtab = None
    pack = None
    if gather_fn is None:
        if direct:
            vtab = _build_vtab(scene)
            pack = _pack_from_vtab(lax.stop_gradient(vtab), scene.triangles,
                                   scene.tri_mat, scene.smooth,
                                   scene.textured)
        else:
            pack = _build_shadepack(scene)
    # material columns packed the same way: ONE (N, 12) row gather per
    # depth instead of six separate 2M-row gathers (ka/kd/ks/shininess/
    # reflectivity/texture_id — the id rides as an exact float, like
    # tri_mat in the shadepack)
    m = scene.materials
    matpack = jnp.concatenate(
        [m.ka, m.kd, m.ks, m.shininess[:, None], m.reflectivity[:, None],
         lax.stop_gradient(m.texture_id[:, None].astype(C.DTYPE))],
        axis=-1)

    compact = (gather_fn is None and N >= SHADE_COMPACT_MIN
               and _shade_compact_on(scene.n_tris, N))
    if not compact:
        # no remat on this uncompacted path: with most pixels hitting, the
        # recompute is not residual-bound — the trade is specific to the
        # chunked scan, whose per-iteration residual buffers break fusion
        return _shade_bundle(scene, o, d, (recs.prim, recs.is_tri, recs.occ),
                             max_depth, shadows, pack, vtab, matpack,
                             gather_fn)

    miss0 = recs.prim[0] < 0
    n_hit = jnp.sum((~miss0).astype(jnp.int32))
    fn = lambda: _shade_compacted(  # noqa: E731
        scene, o, d, recs, max_depth, shadows, pack, vtab, matpack, miss0,
        n_hit)
    if _SHADE_REMAT_ENV == "outer":
        # A/B: ALSO remat the compaction machinery (sort/permute/bij
        # gathers) around the chunk-level checkpoints
        return jax.checkpoint(
            fn,
            policy=jax.checkpoint_policies.save_only_these_names(
                "shade_rows"))()
    return fn()


def _shade_compacted(scene, o, d, recs, max_depth, shadows, pack, vtab,
                     matpack, miss0, n_hit):
    # ---- hit-compacted chunked shading -------------------------------------
    # Sort pixels by (miss, pid): a pixel that misses at depth 0 is dead at
    # every depth (alive never resurrects) and its color is exactly the
    # clipped background — zero gradient.  Hits sort by pid for gather/
    # scatter run-length locality.  The permutation round-trips through
    # _bij_gather (transpose = pre-inverted gather, never a scatter).
    N = o.shape[0]
    key = jnp.where(miss0, jnp.int32(2 ** 30), recs.prim[0])
    perm = jnp.argsort(lax.stop_gradient(key))
    inv = jnp.argsort(perm)
    NCHK = SHADE_CHUNKS
    B = -(-N // NCHK)
    N_pad = B * NCHK
    npad = N_pad - N
    perm_p = (jnp.concatenate([perm, jnp.zeros((npad,), perm.dtype)])
              if npad else perm)
    ones_home = jnp.ones((N,), bool)
    valid_sorted = jnp.arange(N_pad) < N
    o_p = _bij_gather(o, perm_p, inv, ones_home)
    d_p = _bij_gather(d, perm_p, inv, ones_home)

    def pint(x, fill):  # integer records: plain gathers (no gradients)
        xp = x[:, perm]
        if npad:
            xp = jnp.concatenate(
                [xp, jnp.full((x.shape[0], npad), fill, xp.dtype)], axis=1)
        return xp

    D = recs.prim.shape[0]
    prim_c = pint(recs.prim, -1).reshape(D, NCHK, B).transpose(1, 0, 2)
    istri_c = pint(recs.is_tri.astype(jnp.int32), 0).reshape(
        D, NCHK, B).transpose(1, 0, 2)
    occ_c = pint(recs.occ, 0).reshape(D, NCHK, B).transpose(1, 0, 2)
    o_c = o_p.reshape(NCHK, B, 3)
    d_c = d_p.reshape(NCHK, B, 3)

    def body(xs):
        ci, oc, dc, pc, tc, occc = xs

        def live(_):
            fn = lambda: _shade_bundle(  # noqa: E731
                scene, oc, dc, (pc, tc != 0, occc), max_depth, shadows,
                pack, vtab, matpack, None)
            if SHADE_REMAT:
                # rematerialize the chunk body in the backward instead of
                # storing scan residuals (design.md item 29); the "names"
                # policy keeps the wide gather rows saved
                return jax.checkpoint(fn, policy=_remat_policy())()
            return fn()

        # chunks whose first sorted position is past the last hit are
        # all-miss (or padding): their true color is the constant clipped
        # background, restored by the where(miss0) below — skip everything
        return lax.cond(ci * B < n_hit, live,
                        lambda _: jnp.zeros((B, 3), C.DTYPE), 0)

    colors_c = lax.map(
        body, (jnp.arange(NCHK), o_c, d_c, prim_c, istri_c, occ_c))
    colors = _bij_gather(colors_c.reshape(N_pad, 3), inv, perm_p,
                         valid_sorted)
    bg = jnp.clip(jnp.asarray(C.BACKGROUND, C.DTYPE), C.CLAMP_LO, C.CLAMP_HI)
    return jnp.where(miss0[:, None], bg, colors)


def _shade_bundle(scene, o, d, recs_tup, max_depth, shadows, pack, vtab,
                  matpack, gather_fn):
    """Whitted shading of one flat bundle (the per-chunk body; also the
    whole image on the uncompacted path)."""
    prim_all, istri_all, occ_all = recs_tup
    accum = jnp.zeros_like(o)
    thr = jnp.ones((*o.shape[:-1], 1), C.DTYPE)
    alive = jnp.ones(o.shape[:-1], bool)

    def layer(depth, accum, thr, alive, o, d):
        prim = prim_all[depth]
        is_tri = istri_all[depth]
        occ = occ_all[depth]
        hit = prim >= 0
        # ONE wide row gather per depth; every consumer below slices it
        # statically (fwd: one gather; bwd: one (T, K) scatter-add, or
        # direct (V, W) scatters via _pack_gather)
        rows = _gather_shaderows(scene, jnp.maximum(prim, 0), pack,
                                 vtab=vtab, gather_fn=gather_fn)
        t, u, v = _recompute_tuv(scene, o, d, prim, is_tri, rows=rows)
        p, n, mat = _hit_geometry(scene, o, d, t, prim, is_tri, u, v,
                                  rows=rows)

        gm = _gather_small(matpack, mat) if MAT_SEGSUM else matpack[mat]
        if scene.textured:
            tex_id = jnp.round(gm[..., 11]).astype(C.INDEX_DTYPE)
            tex = _sample_texture_flat(
                scene, tex_id, _hit_uv_rows(rows[2], u, v, is_tri))
        else:
            tex = 1.0  # static: skip the quad gather entirely
        ka = gm[..., 0:3]
        kd = gm[..., 3:6] * tex
        ks = gm[..., 6:9]
        shin = gm[..., 9]

        color = ka * jnp.asarray(scene.ambient, C.DTYPE)
        view = -d
        p_off = p + n * C.RAY_OFFSET_EPS
        for li in range(scene.n_lights):
            to_l = scene.light_pos[li] - p
            dist = vec.length(to_l)
            ldir = to_l / jnp.maximum(dist, 1e-20)[..., None]
            ndotl = jnp.maximum(vec.dot(n, ldir), 0.0)
            refl_l = vec.reflect(-ldir, n)
            rdotv = jnp.maximum(vec.dot(refl_l, view), 0.0)
            safe_rv = jnp.where(rdotv > 0.0, rdotv, 1.0)
            spec = jnp.where((ndotl > 0.0) & (rdotv > 0.0), safe_rv**shin, 0.0)
            if shadows:
                vis = 1.0 - ((occ >> li) & 1).astype(C.DTYPE)[..., None]
            else:
                vis = 1.0
            color = color + vis * scene.light_color[li] * (
                kd * ndotl[..., None] + ks * spec[..., None]
            )

        background = jnp.asarray(C.BACKGROUND, C.DTYPE)
        color = jnp.where(hit[..., None], color, background)
        accum = accum + jnp.where(alive[..., None], thr * color, 0.0)
        refl = jnp.where(hit, gm[..., 10], 0.0)
        thr = thr * refl[..., None]
        alive = alive & hit & (refl > 0.0)
        o = p_off
        d = vec.reflect(d, n)
        return accum, thr, alive, o, d

    def layer_skip(accum, thr, alive, o, d):
        return accum, thr, alive, o, d

    for depth in range(max_depth + 1):
        if depth == 0 or gather_fn is not None:
            # gather_fn may contain COLLECTIVES (the scene-sharded ring
            # rotates pack slices with ppermute): a data-dependent cond
            # around it deadlocks the mesh when devices disagree on
            # liveness (observed: 3-of-4 rendezvous hang) — every device
            # must execute every layer's collectives unconditionally
            accum, thr, alive, o, d = layer(depth, accum, thr, alive, o, d)
        else:
            # a layer with no live path contributes exactly zero (accum is
            # alive-masked) — skip its gathers/texture sampling entirely.
            # Every benchmark config ends all paths at depth 0 (no
            # reflective materials), so this saves a full shading layer's
            # gathers per empty depth.
            # lax.cond is reverse-mode differentiable; the skip branch is
            # the identity, so gradients flow correctly either way.
            accum, thr, alive, o, d = lax.cond(
                jnp.any(alive), lambda *s, _d=depth: layer(_d, *s),
                layer_skip, accum, thr, alive, o, d)

    return jnp.clip(accum, C.CLAMP_LO, C.CLAMP_HI)
