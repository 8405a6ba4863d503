"""The reference ("oracle") renderer: pure jax.numpy, brute force, CPU-runnable.

This is the framework's ground truth (SURVEY.md §0 "Parity note"): the OpenCL
reference was unreadable this round, so correctness is defined by THIS module
— a frozen, naively-differentiable Whitted renderer whose every convention
comes from tpurt/constants.py.  The fast paths must `allclose` to it
in both image and pixel-gradients (BASELINE.json:5).  If /root/reference ever
mounts non-empty, re-align constants.py (not this logic) to the OpenCL code.

Structure mirrors the reference's device kernel (SURVEY.md §3a Entry 2,
[ARCHETYPE]): ray-gen → closest-hit → Phong shade with shadow rays →
iterative Whitted reflection loop with multiplicative throughput.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpurt import constants as C
from tpurt.core import geom, vec


def _face_normals(scene):
    v0 = scene.vertices[scene.triangles[:, 0]]
    e1 = scene.vertices[scene.triangles[:, 1]] - v0
    e2 = scene.vertices[scene.triangles[:, 2]] - v0
    return vec.normalize(vec.cross(e1, e2))


def hit_geometry(scene, o, d, rec):
    """Position, shading normal, material id at a hit record.

    Gradients flow from the record's continuous fields (t, u, v) and from the
    scene arrays gathered at the record's *fixed* integer topology — the
    piecewise-constant-visibility convention (SURVEY.md §7).
    """
    p = o + rec["t"][..., None] * d
    prim = rec["prim"]

    tri = scene.triangles[prim]                       # (..., 3)
    if scene.smooth:
        n0 = scene.vnormals[tri[..., 0]]
        n1 = scene.vnormals[tri[..., 1]]
        n2 = scene.vnormals[tri[..., 2]]
        w = (1.0 - rec["u"] - rec["v"])[..., None]
        n_tri = vec.normalize(
            w * n0 + rec["u"][..., None] * n1 + rec["v"][..., None] * n2
        )
    else:
        n_tri = _face_normals(scene)[prim]
    # flip to face the incoming ray (two-sided shading)
    n_tri = jnp.where(vec.dot(n_tri, d)[..., None] > 0.0, -n_tri, n_tri)

    n_sph = geom.sphere_normal(p, scene.sph_center[prim])

    is_tri = rec["is_tri"][..., None]
    n = jnp.where(is_tri, n_tri, n_sph)
    mat = jnp.where(rec["is_tri"], scene.tri_mat[prim], scene.sph_mat[prim])
    return p, n, mat


def _sample_texture(scene, mat, uv):
    """Bilinear texture lookup with wrap addressing; untextured (texture_id
    < 0) returns 1 so `kd * tex` is a no-op.  SURVEY.md §2 row R9."""
    tex_id = scene.materials.texture_id[mat]          # (...,)
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

    def texel(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), tw)
        yi = jnp.mod(yi.astype(jnp.int32), th)
        return scene.textures[tid, yi, xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    col = (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )
    return jnp.where(tex_id[..., None] < 0, 1.0, col)


def _hit_uv(scene, rec):
    """Interpolated texture coordinates at a triangle hit (0 for spheres)."""
    tri = scene.triangles[rec["prim"]]
    uv0 = scene.uvs[tri[..., 0]]
    uv1 = scene.uvs[tri[..., 1]]
    uv2 = scene.uvs[tri[..., 2]]
    w = (1.0 - rec["u"] - rec["v"])[..., None]
    uv = w * uv0 + rec["u"][..., None] * uv1 + rec["v"][..., None] * uv2
    return jnp.where(rec["is_tri"][..., None], uv, 0.0)


def shade_hits(scene, o, d, rec, shadows=True):
    """Phong shading (constants.py conventions) of hit records.

    Returns (color (..., 3), reflect_dir (..., 3), hit_p (..., 3),
    reflectivity (...,)).  Misses get BACKGROUND and zero reflectivity.
    """
    p, n, mat = hit_geometry(scene, o, d, rec)
    m = scene.materials
    if scene.textured:
        tex = _sample_texture(scene, mat, _hit_uv(scene, rec))
    else:
        tex = 1.0  # static: untextured scenes skip the texel gathers
    ka = m.ka[mat]
    kd = m.kd[mat] * tex
    ks = m.ks[mat]
    shin = m.shininess[mat]

    color = ka * jnp.asarray(scene.ambient, C.DTYPE)
    view = -d                                          # unit, toward eye
    p_off = p + n * C.RAY_OFFSET_EPS                   # shadow-ray origin

    for li in range(scene.n_lights):
        lpos = scene.light_pos[li]
        lcol = scene.light_color[li]
        to_l = lpos - p
        dist = vec.length(to_l)
        ldir = to_l / jnp.maximum(dist, 1e-20)[..., None]
        ndotl = jnp.maximum(vec.dot(n, ldir), 0.0)
        refl_l = vec.reflect(-ldir, n)                 # mirror of L about N
        rdotv = jnp.maximum(vec.dot(refl_l, view), 0.0)
        # guard pow so d/d(shininess) at rdotv == 0 is 0·log(1) = 0, not
        # 0·log(0) = NaN; values are identical (pow only used when rdotv > 0)
        safe_rv = jnp.where(rdotv > 0.0, rdotv, 1.0)
        spec = jnp.where((ndotl > 0.0) & (rdotv > 0.0), safe_rv**shin, 0.0)
        if shadows:
            occluded = geom.any_hit(scene, p_off, ldir, dist - C.RAY_OFFSET_EPS)
            vis = jnp.where(occluded, 0.0, 1.0)[..., None]
        else:
            vis = 1.0
        color = color + vis * lcol * (kd * ndotl[..., None] + ks * spec[..., None])

    refl_dir = vec.reflect(d, n)
    background = jnp.asarray(C.BACKGROUND, C.DTYPE)
    hit = rec["hit"][..., None]
    color = jnp.where(hit, color, background)
    reflectivity = jnp.where(rec["hit"], m.reflectivity[mat], 0.0)
    return color, refl_dir, p_off, reflectivity


def trace_rays(scene, o, d, max_depth=C.DEFAULT_MAX_DEPTH, shadows=True):
    """Whitted-trace a flat bundle of rays (N, 3) → colors (N, 3).

    Iterative reflection loop, throughput-weighted, exactly the structure the
    reference's OpenCL kernel is forced into without recursion (SURVEY.md §2
    row R8).  A python loop (static depth) so XLA unrolls and autodiff is
    straightforward.
    """
    accum = jnp.zeros_like(o)
    throughput = jnp.ones((*o.shape[:-1], 1), C.DTYPE)
    alive = jnp.ones(o.shape[:-1], bool)

    for depth in range(max_depth + 1):
        rec = geom.closest_hit(scene, o, d)
        color, refl_dir, p_off, reflectivity = shade_hits(scene, o, d, rec, shadows)
        # classic Whitted: I = local + reflectivity * I_reflected, i.e. every
        # bounce's local color weighted by the product of reflectivities along
        # the path (constants.py convention).  Dead lanes contribute nothing
        # (they already added their background the step they died).
        accum = accum + jnp.where(alive[..., None], throughput * color, 0.0)
        throughput = throughput * reflectivity[..., None]
        alive = alive & rec["hit"] & (reflectivity > 0.0)
        o = p_off
        d = refl_dir

    return jnp.clip(accum, C.CLAMP_LO, C.CLAMP_HI)


def render_ref(scene, height=None, width=None, config=None, chunk=8192):
    """Render the full image with the oracle.

    `config`: optional RenderConfig (wins over height/width).  `chunk` bounds
    peak memory (pixels × primitives) by mapping over pixel chunks with
    lax.map; differentiable end to end.
    """
    if config is not None:
        height, width = config.height, config.width
        max_depth, shadows = config.max_depth, config.shadows
    else:
        max_depth, shadows = C.DEFAULT_MAX_DEPTH, True
    o, d = geom.generate_rays(scene.camera, height, width)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = o.shape[0]
    chunk = min(chunk, n)
    # pad the bundle to a chunk multiple so peak memory stays bounded at
    # pixels_per_chunk × primitives for ANY resolution (an odd-sized image
    # must never silently collapse to one giant chunk)
    n_pad = -(-n // chunk) * chunk
    if n_pad != n:
        o = jnp.concatenate([o, jnp.broadcast_to(o[-1:], (n_pad - n, 3))])
        d = jnp.concatenate([d, jnp.broadcast_to(d[-1:], (n_pad - n, 3))])
    o = o.reshape(n_pad // chunk, chunk, 3)
    d = d.reshape(n_pad // chunk, chunk, 3)
    colors = lax.map(
        lambda od: trace_rays(scene, od[0], od[1], max_depth, shadows), (o, d)
    )
    return colors.reshape(n_pad, 3)[:n].reshape(height, width, 3)
