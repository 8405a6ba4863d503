"""Scene representation: SoA pytrees of jnp arrays, GPU-struct-free.

The reference packs meshes/materials/lights into flat GPU-friendly structs on
the C++ host and uploads them via clCreateBuffer (SURVEY.md §1a/§2 row R11,
[ARCHETYPE] — reference unreadable this round).  The equivalent here is
a pytree of device arrays: jit donation/sharding replaces explicit buffer
management, and every field is a differentiable leaf (vertex positions,
normals, albedo/specular, light params — the gradient targets named in
BASELINE.json:5).

Padding convention: scenes always contain >=1 triangle and >=1 sphere; the
pad primitives are degenerate (zero-area triangle, far-away sphere) and can
never hit within [T_MIN, T_MAX], so brute-force reductions never see empty
axes and kernels never branch on emptiness.
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from tpurt import constants as C
from tpurt.core.types import pytree_dataclass
from tpurt.core import vec

#: Placement of degenerate pad primitives: far away, but small enough that
#: squared distances (sphere quadratic: |c|² - r²) stay finite in f32 —
#: 2e30 would overflow to inf and NaN the backward pass.  Pad triangles are
#: zero-area (can never hit); pad spheres subtend ~1e-10 rad.
_PAD_POS = 1.0e7


@pytree_dataclass
class Materials:
    """Phong material table, indexed by per-primitive material id.

    ka/kd/ks: (M, 3) ambient/diffuse/specular colour; shininess: (M,) Phong
    exponent; reflectivity: (M,) mirror weight in [0,1]; texture_id: (M,)
    int32 index into Scene.textures, -1 = untextured.
    """

    ka: Any
    kd: Any
    ks: Any
    shininess: Any
    reflectivity: Any
    texture_id: Any

    @staticmethod
    def table(rows):
        """Build from a list of dicts with defaults."""
        def col(key, default, width=3):
            out = []
            for r in rows:
                v = r.get(key, default)
                out.append([v] * width if np.isscalar(v) and width == 3 else v)
            return jnp.asarray(np.asarray(out, dtype=np.float32))

        return Materials(
            ka=col("ka", 0.0),
            kd=col("kd", 0.8),
            ks=col("ks", 0.0),
            shininess=jnp.asarray([r.get("shininess", 32.0) for r in rows], C.DTYPE),
            reflectivity=jnp.asarray(
                [r.get("reflectivity", 0.0) for r in rows], C.DTYPE
            ),
            texture_id=jnp.asarray(
                [r.get("texture_id", -1) for r in rows], C.INDEX_DTYPE
            ),
        )


@pytree_dataclass
class Camera:
    """Pinhole camera (conventions pinned in tpurt/constants.py)."""

    eye: Any
    look_at: Any
    up: Any
    fov_y: Any  # vertical field of view, radians (scalar array)

    @staticmethod
    def make(eye, look_at, up=(0.0, 1.0, 0.0), fov_y=np.pi / 3):
        return Camera(
            eye=jnp.asarray(eye, C.DTYPE),
            look_at=jnp.asarray(look_at, C.DTYPE),
            up=jnp.asarray(up, C.DTYPE),
            fov_y=jnp.asarray(fov_y, C.DTYPE),
        )

    def basis(self):
        fwd = vec.normalize(self.look_at - self.eye)
        right = vec.normalize(vec.cross(fwd, self.up))
        true_up = vec.cross(right, fwd)
        return fwd, right, true_up


@pytree_dataclass(meta_fields=("smooth", "textured", "n_real_spheres"))
class Scene:
    """Full scene: geometry + materials + lights + camera, all jnp SoA.

    Fields
    ------
    vertices:      (V, 3) f32 — gradient target (BASELINE.json:5)
    triangles:     (T, 3) i32 vertex indices
    tri_mat:       (T,)   i32 material ids
    vnormals:      (V, 3) f32 vertex normals (gradient target); used when
                   ``smooth`` (static flag), else face normals
    uvs:           (V, 2) f32 texture coordinates
    sph_center:    (S, 3) f32 — gradient target
    sph_radius:    (S,)   f32 — gradient target
    sph_mat:       (S,)   i32
    materials:     Materials — gradient targets
    textures:      (NT, TH, TW, 3) f32 — gradient target (config 5)
    light_pos:     (L, 3) f32 — gradient target
    light_color:   (L, 3) f32 (colour × intensity) — gradient target
    ambient:       (3,)  f32 scene ambient light
    camera:        Camera
    """

    vertices: Any
    triangles: Any
    tri_mat: Any
    vnormals: Any
    uvs: Any
    sph_center: Any
    sph_radius: Any
    sph_mat: Any
    materials: Materials
    textures: Any
    light_pos: Any
    light_color: Any
    ambient: Any
    camera: Camera
    smooth: bool = False
    #: static flag: any material references a texture (lets backends decide
    #: kernel applicability without inspecting traced data)
    textured: bool = False
    #: number of user (non-pad) spheres; -1 = unknown (treat all as real).
    #: Kernels skip the sphere path entirely when this is 0.
    n_real_spheres: int = -1

    # shapes are static under jit — safe to expose as python ints
    @property
    def n_tris(self):
        return self.triangles.shape[0]

    @property
    def n_spheres(self):
        return self.sph_center.shape[0]

    @property
    def n_lights(self):
        return self.light_pos.shape[0]


def build_scene(
    vertices=None,
    triangles=None,
    tri_mat=None,
    vnormals=None,
    uvs=None,
    spheres=None,  # list of (center(3), radius, mat_id)
    materials=None,  # list of material dicts (see Materials.table)
    textures=None,
    lights=None,  # list of (pos(3), color(3))
    ambient=C.AMBIENT_LIGHT,
    camera=None,
    smooth=False,
    pad_tris_to=1,
    pad_spheres_to=1,
):
    """Assemble a Scene from host data, inserting degenerate pad primitives.

    ``pad_tris_to``/``pad_spheres_to`` round the primitive counts up to a
    multiple (kernels pass 128 so intersection lanes are always full).
    """
    verts = np.zeros((0, 3), np.float32) if vertices is None else np.asarray(
        vertices, np.float32
    )
    tris = np.zeros((0, 3), np.int32) if triangles is None else np.asarray(
        triangles, np.int32
    )
    tmat = (
        np.zeros((tris.shape[0],), np.int32)
        if tri_mat is None
        else np.asarray(tri_mat, np.int32)
    )
    if vnormals is None:
        vnormals = _vertex_normals(verts, tris)
    vnormals = np.asarray(vnormals, np.float32)
    if uvs is None:
        uvs = np.zeros((verts.shape[0], 2), np.float32)
    uvs = np.asarray(uvs, np.float32)

    # --- pad triangles: degenerate (all verts coincident, far away) ---------
    def round_up(n, m):
        return max(1, -(-n // m) * m)

    n_t = round_up(tris.shape[0], pad_tris_to)
    n_pad_t = n_t - tris.shape[0]
    if n_pad_t or verts.shape[0] == 0:
        pad_vert = np.full((1, 3), _PAD_POS, np.float32)
        pad_idx = verts.shape[0]
        verts = np.concatenate([verts, pad_vert], 0)
        vnormals = np.concatenate([vnormals, np.array([[0, 1, 0]], np.float32)], 0)
        uvs = np.concatenate([uvs, np.zeros((1, 2), np.float32)], 0)
        tris = np.concatenate(
            [tris, np.full((max(n_pad_t, 1), 3), pad_idx, np.int32)], 0
        )
        tmat = np.concatenate([tmat, np.zeros((max(n_pad_t, 1),), np.int32)], 0)

    # --- spheres -------------------------------------------------------------
    spheres = spheres or []
    centers = np.asarray([s[0] for s in spheres], np.float32).reshape(-1, 3)
    radii = np.asarray([s[1] for s in spheres], np.float32).reshape(-1)
    smat = np.asarray([s[2] for s in spheres], np.int32).reshape(-1)
    n_s = round_up(centers.shape[0], pad_spheres_to)
    n_pad_s = n_s - centers.shape[0]
    if n_pad_s or centers.shape[0] == 0:
        k = max(n_pad_s, 1)
        centers = np.concatenate([centers, np.full((k, 3), _PAD_POS, np.float32)], 0)
        radii = np.concatenate([radii, np.full((k,), 1e-3, np.float32)], 0)
        smat = np.concatenate([smat, np.zeros((k,), np.int32)], 0)

    materials = materials or [{"kd": 0.8}]
    has_tex = (
        any(m.get("texture_id", -1) >= 0 for m in materials)
        if not isinstance(materials, Materials)
        else bool(np.any(np.asarray(materials.texture_id) >= 0))
    )
    lights = lights or [((0.0, 5.0, 0.0), (1.0, 1.0, 1.0))]
    lp = np.asarray([l[0] for l in lights], np.float32).reshape(-1, 3)
    lc = np.asarray([l[1] for l in lights], np.float32).reshape(-1, 3)
    if textures is None:
        textures = np.ones((1, 8, 8, 3), np.float32)
    camera = camera or Camera.make((0.0, 0.0, 5.0), (0.0, 0.0, 0.0))

    scene = Scene(
        vertices=jnp.asarray(verts),
        triangles=jnp.asarray(tris),
        tri_mat=jnp.asarray(tmat),
        vnormals=jnp.asarray(vnormals),
        uvs=jnp.asarray(uvs),
        sph_center=jnp.asarray(centers),
        sph_radius=jnp.asarray(radii),
        sph_mat=jnp.asarray(smat),
        materials=materials
        if isinstance(materials, Materials)
        else Materials.table(materials),
        textures=jnp.asarray(textures, C.DTYPE),
        light_pos=jnp.asarray(lp),
        light_color=jnp.asarray(lc),
        ambient=jnp.asarray(ambient, C.DTYPE),
        camera=camera,
        smooth=smooth,
        textured=has_tex,
        n_real_spheres=len(spheres),
    )
    # stash the host-side mesh on the instance (NOT a pytree field): accel
    # builders need concrete geometry, and fetching device arrays back
    # through a slow transport can dwarf the build itself.  Instances
    # produced by tree ops (jit, grad, replace) lose the stash and
    # prepare() falls back to a device fetch.
    object.__setattr__(scene, "host_mesh", (verts, tris))
    return scene


def _vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host-side numpy, build time only)."""
    vn = np.zeros_like(verts)
    if tris.shape[0] == 0 or verts.shape[0] == 0:
        return vn
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    lens = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(lens, 1e-20)).astype(np.float32)
