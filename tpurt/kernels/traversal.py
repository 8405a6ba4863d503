"""Cluster traversal: the hit-finder of large and textured scenes.

Rays arrive as arrays and are traced in tiles of RAYS consecutive rays
(8×8 pixel blocks for camera rays, Morton cells for re-binned secondary and
shadow rays).  Per tile:

1. CULL (plain jnp): the tile's alive rays are reduced to per-axis origin
   and direction intervals and tested against every cluster box with a
   conservative interval slab test (false positives cost work, never
   correctness; tests/test_accel.py pins the condition).  Survivors are
   compacted into a per-tile list, front to back in KB buckets of their
   conservative entry distance.  A tile with more than MAXS survivors keeps
   its count and is traced against EVERY cluster — exact, never truncated.
2. TRACE (one Pallas kernel through Triton, `_closest_kernel` /
   `_any_kernel`): one program per tile walks its survivor list, tests the
   tile's rays against each cluster box in registers, skips clusters no
   live ray can improve on, and intersects the rest BT triangles at a time
   (f32 FMA math on the CUDA cores — no matmul, so no TF32 reaches it).
   The any-hit mode stops once every ray of the tile is occluded.

Spheres are few and tested brute force in plain jnp; their best hit seeds
the kernel, and the (t, gid) lexicographic minimum (smaller t wins, then
the smaller global id — triangles before spheres) reproduces the oracle's
argmin-first tie rule.

The kernel emits integer topology (winning primitive id per bounce, shadow
occlusion bits) and the best t; the differentiable image is rebuilt from
them by tpurt/shading/deferred.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpurt import constants as C
from tpurt.accel.clusters import LEAF
from tpurt.core import geom
from tpurt.kernels.packc import FORMS, PackedClusters, pack_clusters

#: camera-ray tile: TILE_H × TILE_W pixels.  Square tiles keep each tile's
#: ray bundle a narrow frustum, which is what makes the interval cull
#: selective.
TILE_H = 8
TILE_W = 8
RAYS = TILE_H * TILE_W
#: survivor-list capacity per tile (overflowing tiles stream every cluster)
MAXS = 512
#: front-to-back entry-distance buckets of the survivor list
KB = 4
#: triangles per kernel step (LEAF // BT steps per cluster)
BT = 32
#: Triton launch shape of the trace kernel
NUM_WARPS = 4
NUM_STAGES = 2
#: cluster count above which shadows are traced over hit points re-binned
#: by Morton code instead of over the pixel tiles
SHADOW_REBIN_MIN_CLUSTERS = 2048
#: tile × cluster pairs per cull chunk (bounds the cull's device memory)
_CULL_PAIRS = 1 << 24
_BIG = 3.0e37
_IMAX = 2**31 - 1


def _interpret() -> bool:
    """Interpret the Triton kernel on the CPU (tests); compile it on the
    GPU.  Any other platform has no route and raises."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise NotImplementedError(
        f"the traversal kernel compiles for the GPU through Triton and runs "
        f"interpreted on the CPU; there is no route for platform "
        f"{platform!r}")


# ---------------------------------------------------------------------------
# ray-triangle math of the kernel
# ---------------------------------------------------------------------------
def _tri_t(o, d, f, t_hi):
    """t of rays (o, d) against triangles with Baldwin–Weber coefficients
    f (packc.tri_forms rows); T_NONE where there is no hit in
    (T_MIN, t_hi).  Operands broadcast: o/d/t_hi per ray, f per triangle.

    The same function runs inside the kernel and in plain XLA.  On the
    GPU, Triton's f32 `/` rounds exactly as XLA's division does (both are
    approximate, not IEEE: on an H100, 0 of 2^20 random quotients differ
    between them, 29% differ from IEEE), and chip_smoke.py holds the
    kernel's hit ids to this function's under XLA exactly.  A correctly
    rounded division in the kernel alone moved t by an ulp against XLA
    and let a ray slip between two triangles sharing an edge that XLA's
    arithmetic closes."""
    ox, oy, oz = o
    dx, dy, dz = d
    no = f[0] * ox + f[1] * oy + f[2] * oz + f[3]
    nd = f[0] * dx + f[1] * dy + f[2] * dz
    good = jnp.abs(nd) >= C.MT_DET_EPS
    t = -no / jnp.where(good, nd, 1.0)
    u = (f[4] * ox + f[5] * oy + f[6] * oz + f[7]) + t * (
        f[4] * dx + f[5] * dy + f[6] * dz)
    v = (f[8] * ox + f[9] * oy + f[10] * oz + f[11]) + t * (
        f[8] * dx + f[9] * dy + f[10] * dz)
    hit = (good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > C.T_MIN) & (t < t_hi))
    return jnp.where(hit, t, C.T_NONE)


def _safe_inv(x):
    return 1.0 / jnp.where(jnp.abs(x) < 1e-12,
                           jnp.where(x >= 0.0, 1e-12, -1e-12), x)


def _box_near_far(lo, hi, o, inv):
    """Per-ray slab test of one (padded) box: (near, far) distances."""
    near = jnp.full_like(o[0], -C.T_NONE)
    far = jnp.full_like(o[0], C.T_NONE)
    for k in range(3):
        t0 = (lo[k] - o[k]) * inv[k]
        t1 = (hi[k] - o[k]) * inv[k]
        near = jnp.maximum(near, jnp.minimum(t0, t1))
        far = jnp.minimum(far, jnp.maximum(t0, t1))
    return near, far


# ---------------------------------------------------------------------------
# cull + survivor compaction (plain jnp)
# ---------------------------------------------------------------------------
def _tile_bounds(o, d, tmax, alive):
    """Per-tile interval bounds of the alive rays → (olo, ohi, dlo, dhi
    (NT, 3), tmax (NT,), live (NT,))."""
    nt = o.shape[0] // RAYS
    a = alive.reshape(nt, RAYS, 1)
    ot = o.reshape(nt, RAYS, 3)
    dt = d.reshape(nt, RAYS, 3)
    olo = jnp.min(jnp.where(a, ot, _BIG), axis=1)
    ohi = jnp.max(jnp.where(a, ot, -_BIG), axis=1)
    dlo = jnp.min(jnp.where(a, dt, _BIG), axis=1)
    dhi = jnp.max(jnp.where(a, dt, -_BIG), axis=1)
    tm = jnp.max(jnp.where(alive, tmax, 0.0).reshape(nt, RAYS), axis=1)
    live = jnp.any(alive.reshape(nt, RAYS), axis=1)
    return olo, ohi, dlo, dhi, tm, live


def _cull_chunk(box, olo, ohi, dlo, dhi, tm, live):
    """Conservative interval slab test of tiles (CH,) × clusters (C,).

    For t ≥ 0 every ray of the tile lies per axis in [olo + t·dlo,
    ohi + t·dhi]; a cluster survives iff some t in [0, tmax] puts that
    interval into the box's slab on all three axes.  Returns (survive
    (CH, C) bool, conservative entry distance (CH, C))."""
    lo = box[None, :, 0:3]
    hi = box[None, :, 4:7]
    shape = (tm.shape[0], box.shape[0])
    t_lo = jnp.zeros(shape, jnp.float32)
    t_hi = jnp.broadcast_to(tm[:, None], shape)
    ok = jnp.broadcast_to(live[:, None], shape)
    for k in range(3):
        a = lo[..., k] - ohi[:, None, k]      # need t·dhi >= a
        b = hi[..., k] - olo[:, None, k]      # need t·dlo <= b
        dh = dhi[:, None, k]
        dl = dlo[:, None, k]
        t_lo = jnp.maximum(
            t_lo, jnp.where(dh > 0, a / jnp.where(dh > 0, dh, 1.0), -_BIG))
        t_hi = jnp.minimum(
            t_hi, jnp.where(dh < 0, a / jnp.where(dh < 0, dh, 1.0), _BIG))
        t_hi = jnp.minimum(
            t_hi, jnp.where(dl > 0, b / jnp.where(dl > 0, dl, 1.0), _BIG))
        t_lo = jnp.maximum(
            t_lo, jnp.where(dl < 0, b / jnp.where(dl < 0, dl, 1.0), -_BIG))
        ok = ok & ((dh != 0) | (a <= 0)) & ((dl != 0) | (b >= 0))
    return ok & (t_lo <= t_hi), t_lo


def _compact(surv, ent):
    """Survivor mask (CH, C) → (list (CH, MAXS) int32, count (CH,) int32),
    front to back by KB buckets of the entry distance, cluster order
    within a bucket.  Entries past MAXS are dropped from the list; the
    count keeps them (count > MAXS marks an overflowing tile)."""
    ch, nc = surv.shape
    e_lo = jnp.min(jnp.where(surv, ent, _BIG), axis=1, keepdims=True)
    e_hi = jnp.max(jnp.where(surv, ent, -_BIG), axis=1, keepdims=True)
    span = jnp.maximum(e_hi - e_lo, 1e-30)
    bucket = jnp.clip(jnp.floor(KB * (ent - e_lo) / span), 0, KB - 1)
    pos = jnp.full((ch, nc), MAXS, jnp.int32)
    off = jnp.zeros((ch,), jnp.int32)
    for b in range(KB):
        m = surv & (bucket == b)
        rank = jnp.cumsum(m.astype(jnp.int32), axis=1) - 1
        pos = jnp.where(m, off[:, None] + rank, pos)
        off = off + jnp.sum(m.astype(jnp.int32), axis=1)
    rows = lax.broadcasted_iota(jnp.int32, (ch, nc), 0)
    cidx = lax.broadcasted_iota(jnp.int32, (ch, nc), 1)
    slist = jnp.zeros((ch, MAXS), jnp.int32).at[rows, pos].set(
        cidx, mode="drop")
    return slist, off


def cull(packed: PackedClusters, o, d, tmax, alive):
    """Survivor lists of every RAYS-ray tile → (slist (NT, MAXS), count
    (NT,)).  Tiles are culled in chunks so the (tiles × clusters) work
    never holds more than _CULL_PAIRS pairs at once."""
    bounds = _tile_bounds(o, d, tmax, alive)
    nt = bounds[0].shape[0]
    ch = max(1, min(nt, _CULL_PAIRS // max(packed.n_clusters, 1)))
    n_chunks = -(-nt // ch)
    pad = n_chunks * ch - nt

    def chunked(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((n_chunks, ch) + x.shape[1:])

    def one(args):
        return _compact(*_cull_chunk(packed.box, *args))

    slist, cnt = lax.map(one, tuple(chunked(x) for x in bounds))
    return (slist.reshape(n_chunks * ch, MAXS)[:nt],
            cnt.reshape(n_chunks * ch)[:nt])


# ---------------------------------------------------------------------------
# the Triton kernel: one program per ray tile
# ---------------------------------------------------------------------------
def _cluster_id(slist_ref, j, ovf):
    """Survivor j of this tile (every cluster in order when it overflowed)."""
    listed = slist_ref[jnp.minimum(j, MAXS - 1)]
    return jnp.where(ovf, j, listed)


def _load_rays(o_refs, d_refs):
    o = tuple(r[...] for r in o_refs)
    d = tuple(r[...] for r in d_refs)
    return o, d, tuple(_safe_inv(x) for x in d)


def _box(box_ref, c):
    lo = tuple(box_ref[c, k] for k in range(3))
    hi = tuple(box_ref[c, 4 + k] for k in range(3))
    return lo, hi


def _step_t(forms_ref, c, s, o, d, t_hi):
    """(RAYS, BT) t values of triangles [s·BT, (s+1)·BT) of cluster c."""
    f = [forms_ref[c, k, pl.ds(s * BT, BT)][None, :] for k in range(FORMS)]
    return _tri_t(tuple(x[:, None] for x in o), tuple(x[:, None] for x in d),
                  f, t_hi[:, None])


def _closest_kernel(slist_ref, cnt_ref, forms_ref, gid_ref, box_ref,
                    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, thi_ref,
                    t0_ref, id0_ref, t_out, id_out, *, n_clusters):
    o, d, inv = _load_rays((ox_ref, oy_ref, oz_ref), (dx_ref, dy_ref, dz_ref))
    t_hi = thi_ref[...]
    cnt = cnt_ref[0]
    ovf = cnt > MAXS
    n = jnp.where(ovf, n_clusters, cnt)

    def body(j, carry):
        c = _cluster_id(slist_ref, j, ovf)
        lo, hi = _box(box_ref, c)
        near, far = _box_near_far(lo, hi, o, inv)
        tb = carry[0]
        act = (near <= far) & (far >= 0.0) & (near <= tb) & (near <= t_hi)

        def blocks(carry):
            tb, ib = carry
            for s in range(LEAF // BT):
                t = _step_t(forms_ref, c, s, o, d, t_hi)
                g = gid_ref[c, pl.ds(s * BT, BT)]
                bt = jnp.min(t, axis=1)
                bg = jnp.min(jnp.where(t == bt[:, None], g[None, :], _IMAX),
                             axis=1)
                better = (bt < tb) | ((bt == tb) & (bg < ib))
                better = better & (bt < C.T_NONE)
                tb = jnp.where(better, bt, tb)
                ib = jnp.where(better, bg, ib)
            return tb, ib

        live = jnp.max(act.astype(jnp.int32)) > 0
        return lax.cond(live, blocks, lambda c_: c_, carry)

    tb, ib = lax.fori_loop(0, n, body, (t0_ref[...], id0_ref[...]))
    t_out[...] = tb
    id_out[...] = ib


def _any_kernel(slist_ref, cnt_ref, forms_ref, box_ref,
                ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, thi_ref,
                occ0_ref, occ_out, *, n_clusters):
    o, d, inv = _load_rays((ox_ref, oy_ref, oz_ref), (dx_ref, dy_ref, dz_ref))
    t_hi = thi_ref[...]
    cnt = cnt_ref[0]
    ovf = cnt > MAXS
    n = jnp.where(ovf, n_clusters, cnt)

    def cond(carry):
        j, occ = carry
        return (j < n) & (jnp.min(occ) == 0)

    def body(carry):
        j, occ = carry
        c = _cluster_id(slist_ref, j, ovf)
        lo, hi = _box(box_ref, c)
        near, far = _box_near_far(lo, hi, o, inv)
        act = ((occ == 0) & (near <= far) & (far >= 0.0)
               & (near <= t_hi))

        def blocks(occ):
            for s in range(LEAF // BT):
                t = _step_t(forms_ref, c, s, o, d, t_hi)
                hit = jnp.max((t < C.T_NONE).astype(jnp.int32), axis=1)
                occ = jnp.maximum(occ, hit)
            return occ

        live = jnp.max(act.astype(jnp.int32)) > 0
        return j + 1, lax.cond(live, blocks, lambda x: x, occ)

    _, occ = lax.while_loop(cond, body, (jnp.int32(0), occ0_ref[...]))
    occ_out[...] = occ


def _kernel_call(kernel, name, packed, slist, cnt, tables, ray_args, outs):
    """pallas_call of one trace kernel over the tiles (Triton route):
    per-tile survivor list and count, whole cluster `tables`, per-tile
    ray arrays in and out."""
    nt = slist.shape[0]
    tile = pl.BlockSpec((RAYS,), lambda i: (i,))
    whole = lambda x: pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)  # noqa: E731
    return pl.pallas_call(
        functools.partial(kernel, n_clusters=packed.n_clusters),
        grid=(nt,),
        in_specs=[pl.BlockSpec((None, MAXS), lambda i: (i, 0)),
                  pl.BlockSpec((1,), lambda i: (i,)),
                  *[whole(x) for x in tables],
                  *[tile for _ in ray_args]],
        out_specs=[tile for _ in outs],
        out_shape=[jax.ShapeDtypeStruct((nt * RAYS,), dt) for dt in outs],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=_interpret(),
        name=name,
    )(slist, cnt, *tables, *ray_args)


# ---------------------------------------------------------------------------
# public trace entry points
# ---------------------------------------------------------------------------
def _spheres(packed, o, d, t_hi):
    """(t, gid) of the nearest sphere hit in (T_MIN, t_hi) — brute force
    (spheres are few); gid = n_tris + sphere index, -1 on a miss."""
    n = o.shape[0]
    if packed.n_spheres == 0:
        return (jnp.full((n,), C.T_NONE, jnp.float32),
                jnp.full((n,), -1, jnp.int32))
    _, ts = geom.intersect_spheres(o, d, packed.sph[:, :3], packed.sph[:, 3])
    ts = jnp.where(ts < t_hi[:, None], ts, C.T_NONE)
    s = jnp.argmin(ts, axis=-1).astype(jnp.int32)
    t = jnp.min(ts, axis=-1)
    return t, jnp.where(t < C.T_NONE, packed.n_tris + s, -1)


def _prep(packed, o, d, tmax):
    sg = lax.stop_gradient
    packed, o, d = sg(packed), sg(o), sg(d)
    n = o.shape[0]
    assert n % RAYS == 0, (n, RAYS)
    t_hi = (jnp.full((n,), C.T_MAX, jnp.float32) if tmax is None
            else sg(tmax).astype(jnp.float32))
    return packed, o, d, t_hi


def trace_closest(packed: PackedClusters, o, d, alive, tmax=None):
    """Closest hit of rays (N, 3) with N a multiple of RAYS, traced in
    tiles of RAYS consecutive rays → (ids (N,) global primitive id or -1,
    t (N,) with T_NONE on a miss, survivor count per tile (N/RAYS,)).

    `tmax` (N,) bounds the search (default T_MAX).  Inputs are
    stop-gradient'ed: topology is not differentiable."""
    packed, o, d, t_hi = _prep(packed, o, d, tmax)
    ts, ids = _spheres(packed, o, d, t_hi)
    t0 = jnp.where(alive, ts, -1.0)
    id0 = jnp.where(alive, ids, -1)
    slist, cnt = cull(packed, o, d, t_hi, alive)
    t, ids = _kernel_call(
        _closest_kernel, "tpurt_closest", packed, slist, cnt,
        (packed.forms, packed.gid, packed.box),
        (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_hi, t0,
         id0),
        (jnp.float32, jnp.int32))
    hit = alive & (ids >= 0)
    return (jnp.where(hit, ids, -1), jnp.where(hit, t, C.T_NONE), cnt)


def trace_any(packed: PackedClusters, o, d, tmax, alive, cull_rays=None):
    """Occlusion of segments (o, d, (T_MIN, tmax)) → (occluded (N,) bool,
    survivor count per tile).  `cull_rays` = (o_c, d_c, tmax_c) replaces
    the rays in the cull only; it must cover every traced segment (the
    shadow pass culls the light → surface segment, whose origin interval
    is a single point)."""
    packed, o, d, t_hi = _prep(packed, o, d, tmax)
    occ_s = jnp.zeros(o.shape[:1], bool)
    if packed.n_spheres:
        _, ts = geom.intersect_spheres(o, d, packed.sph[:, :3],
                                       packed.sph[:, 3])
        occ_s = jnp.any(ts < t_hi[:, None], axis=-1)
    occ0 = jnp.where(alive, occ_s, True).astype(jnp.int32)
    co, cd, ct = (o, d, t_hi) if cull_rays is None else tuple(
        lax.stop_gradient(x) for x in cull_rays)
    slist, cnt = cull(packed, co, cd, ct, alive)
    (occ,) = _kernel_call(
        _any_kernel, "tpurt_anyhit", packed, slist, cnt,
        (packed.forms, packed.box),
        (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_hi, occ0),
        (jnp.int32,))
    return (occ > 0) & alive, cnt


# ---------------------------------------------------------------------------
# the bounce driver: camera tiles, shadows, reflections
# ---------------------------------------------------------------------------
def _tiles_of(x, nty, ntx):
    """(nty·TILE_H, ntx·TILE_W, ...) image block → tile-major flat."""
    rest = x.shape[2:]
    x = x.reshape((nty, TILE_H, ntx, TILE_W) + rest)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape((nty * ntx * RAYS,) + rest)


def _untile(x, nrows, W):
    """(..., ntiles·RAYS) tile-major → (..., nrows·W) image-major."""
    nty = -(-nrows // TILE_H)
    ntx = -(-W // TILE_W)
    lead = x.shape[:-1]
    x = x.reshape(lead + (nty, ntx, TILE_H, TILE_W))
    x = jnp.moveaxis(x, -3, -2)
    x = x.reshape(lead + (nty * TILE_H, ntx * TILE_W))
    return x[..., :nrows, :W].reshape(lead + (nrows * W,))


def _camera_tiles(camera, height, W, row0, nrows):
    """Camera rays of rows [row0, row0+nrows) in tile-major order, padded
    to whole tiles → (o (N, 3), d (N, 3), in-image (N,)).  In-image rays
    are exactly geom.generate_rays'."""
    nty = -(-nrows // TILE_H)
    ntx = -(-W // TILE_W)
    o, d = geom.generate_rays(camera, height, W, row0, nty * TILE_H)
    pad = ((0, 0), (0, ntx * TILE_W - W), (0, 0))
    o = jnp.pad(o, pad, mode="edge")
    d = jnp.pad(d, pad, mode="edge")
    inside = ((jnp.arange(nty * TILE_H) < nrows)[:, None]
              & (jnp.arange(ntx * TILE_W) < W)[None, :])
    return (_tiles_of(o, nty, ntx), _tiles_of(d, nty, ntx),
            _tiles_of(inside, nty, ntx))


def _part1by2(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton(p, lo, hi, bits):
    ext = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((p - lo) / ext, 0.0, 1.0)
    cell = (q * float((1 << bits) - 1)).astype(jnp.int32)
    return (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
            | (_part1by2(cell[:, 2]) << 2))


def _bin_key_pts(p, lo, hi, alive):
    """Morton key of hit points: shadow tiles become compact 3D cells, so
    each tile's light-origin cull cone is as thin as the geometry allows.
    Dead lanes sort to the end."""
    return jnp.where(alive, _morton(p, lo, hi, 10), jnp.int32(2**30))


def _bin_key(p, d, lo, hi, alive):
    """Re-binning key of secondary rays: direction octant (high bits), then
    a 9-bit-per-axis Morton code of the origin — tiles whose origin box AND
    direction cone are both tight keep the interval cull selective.  Dead
    rays sort to the end."""
    octant = (((d[:, 0] < 0).astype(jnp.int32) << 2)
              | ((d[:, 1] < 0).astype(jnp.int32) << 1)
              | (d[:, 2] < 0).astype(jnp.int32))
    key = (octant << 27) | _morton(p, lo, hi, 9)
    return jnp.where(alive, key, jnp.int32(2**30))


def _permuted(key, *xs):
    """Sort lanes by key; returns (inverse permutation, permuted xs)."""
    perm = jnp.argsort(key)
    return jnp.argsort(perm), tuple(x[perm] for x in xs)


def _continue_rays(scene_sg, o, d, ids, T):
    """Reflection continuation from a bounce's records (stop-gradient
    values; the differentiable replay lives in tpurt/shading/deferred.py)."""
    from tpurt.core import vec
    from tpurt.shading.deferred import _hit_geometry, _recompute_tuv

    miss = ids < 0
    is_tri = (~miss) & (ids < T)
    prim = jnp.where(miss, -1, jnp.where(is_tri, ids, ids - T))
    t, u, v = _recompute_tuv(scene_sg, o, d, prim, is_tri)
    p, n, mat = _hit_geometry(scene_sg, o, d, t, prim, is_tri, u, v)
    o2 = p + n * C.RAY_OFFSET_EPS
    d2 = vec.reflect(d, n)
    refl = scene_sg.materials.reflectivity[mat]
    return o2, d2, (~miss) & (refl > 0.0), p


def _hit_points(scene_sg, o, d, ids):
    """(p, p_off) of one bounce's hits, recomputed with the shading
    replay's formulas.  Big mostly-miss frames recompute only the hit
    lanes: lanes are sorted by (miss, pid) and chunks past the last hit
    are skipped (same gate as compacted shading)."""
    from tpurt.shading.deferred import (SHADE_CHUNKS, SHADE_COMPACT_MIN,
                                        _build_shadepack, _gather_shaderows,
                                        _hit_geometry, _recompute_tuv,
                                        _shade_compact_on)

    T = scene_sg.n_tris
    # the shading replay's gather table (XLA CSEs the two recomputes)
    pack = _build_shadepack(scene_sg)

    def geom_of(idc, oc, dc):
        is_tri = (idc >= 0) & (idc < T)
        prim = jnp.where(idc < 0, -1, jnp.where(is_tri, idc, idc - T))
        rows = _gather_shaderows(scene_sg, jnp.maximum(prim, 0), pack)
        t, u, v = _recompute_tuv(scene_sg, oc, dc, prim, is_tri, rows=rows)
        p, nrm, _ = _hit_geometry(scene_sg, oc, dc, t, prim, is_tri, u, v,
                                  rows=rows)
        return p, p + nrm * C.RAY_OFFSET_EPS

    N = ids.shape[0]
    if N < SHADE_COMPACT_MIN or not _shade_compact_on(T, N):
        return geom_of(ids, o, d)
    miss0 = ids < 0
    prm = jnp.argsort(jnp.where(miss0, jnp.int32(2 ** 30), ids))
    ipr = jnp.argsort(prm)
    n_hit = jnp.sum((~miss0).astype(jnp.int32))
    B = -(-N // SHADE_CHUNKS)
    npad = B * SHADE_CHUNKS - N

    def srt(x, fill):
        xs = x[prm]
        if npad:
            xs = jnp.concatenate(
                [xs, jnp.full((npad,) + x.shape[1:], fill, xs.dtype)])
        return xs.reshape(SHADE_CHUNKS, B, *x.shape[1:])

    def body(xs):
        ci, idc, oc, dc = xs
        return lax.cond(
            ci * B < n_hit, lambda _: geom_of(idc, oc, dc),
            lambda _: (jnp.zeros((B, 3), jnp.float32),
                       jnp.zeros((B, 3), jnp.float32)), 0)

    p_s, poff_s = lax.map(
        body, (jnp.arange(SHADE_CHUNKS), srt(ids, -1), srt(o, 0.0),
               srt(d, 0.0)))
    # skipped chunks hold zeros: those lanes missed (alive False downstream)
    return p_s.reshape(-1, 3)[:N][ipr], poff_s.reshape(-1, 3)[:N][ipr]


def trace_records(scene, packed: PackedClusters, config, row0, nrows: int,
                  stats: dict | None = None):
    """Hit topology of rows [row0, row0+nrows) → (ids, occ), each
    (max_depth+1, nrows·W) int32 in image order: the global primitive id
    per bounce (-1: miss or dead path; >= n_tris: sphere) and the shadow
    bits (bit l ⇔ light l occluded).

    Camera rays are traced in 8×8 pixel tiles.  Shadows are traced per
    light over the same tiles or, above SHADOW_REBIN_MIN_CLUSTERS clusters
    with config.shadow_rebin, over hit points re-binned by Morton code;
    their cull uses the light → surface segment.  Reflection bounces
    (depth ≥ 1) re-bin live rays by octant + Morton when
    config.wavefront, and are skipped outright when no path is alive.
    `stats`, when given, receives the depth-0 survivor counts per tile."""
    sg = lax.stop_gradient
    scene_sg = sg(scene)
    W = config.width
    T = scene.n_tris
    o, d, inside = _camera_tiles(scene_sg.camera, config.height, W, row0,
                                 nrows)
    N = o.shape[0]
    lo = jnp.min(packed.box[:, 0:3], axis=0)
    hi = jnp.max(packed.box[:, 4:7], axis=0)
    rebin = (config.shadow_rebin
             and packed.n_clusters > SHADOW_REBIN_MIN_CLUSTERS)

    def shadow_bits(o_cur, d_cur, ids, tag):
        if not config.shadows:
            return jnp.zeros((N,), jnp.int32)
        p, p_off = _hit_points(scene_sg, o_cur, d_cur, ids)
        alive = ids >= 0
        inv = None
        if rebin:
            inv, (p, p_off, alive) = _permuted(
                _bin_key_pts(p, lo, hi, alive), p, p_off, alive)
        bits = jnp.zeros((N,), jnp.int32)
        for li in range(scene.n_lights):
            lpos = scene_sg.light_pos[li]
            to_l = lpos - p
            dist = jnp.sqrt(jnp.sum(to_l * to_l, axis=-1))
            ldir = to_l / jnp.maximum(dist, 1e-20)[:, None]
            occ, cnt = trace_any(
                packed, p_off, ldir, dist - C.RAY_OFFSET_EPS, alive,
                cull_rays=(jnp.broadcast_to(lpos, p.shape), -ldir, dist))
            if stats is not None and tag is not None:
                stats[f"{tag}.light{li}"] = cnt
            bits = bits | jnp.where(occ, 1 << li, 0)
        return bits if inv is None else bits[inv]

    with jax.named_scope("tpurt.traversal.b0"):
        ids, _, cnt = trace_closest(packed, o, d, inside)
    if stats is not None:
        stats["closest.b0"] = cnt
    with jax.named_scope("tpurt.shadows.b0"):
        occ = shadow_bits(o, d, ids, "shadow.b0")
    ids_l, occ_l = [ids], [occ]

    def alive_from_ids(ids):
        """Lanes that continue: a hit on a reflective material (two int
        gathers — the same rule as _continue_rays)."""
        hit = ids >= 0
        is_tri = hit & (ids < T)
        tid = jnp.clip(ids, 0, max(T - 1, 0))
        sid = jnp.clip(ids - T, 0, max(scene.n_spheres - 1, 0))
        mat = jnp.where(is_tri, scene_sg.tri_mat[tid], scene_sg.sph_mat[sid])
        return hit & (scene_sg.materials.reflectivity[mat] > 0.0)

    def bounce(o, d, ids, alive):
        o, d, _, _ = _continue_rays(scene_sg, o, d, ids, T)
        if config.wavefront:
            inv, (ob, db, ab) = _permuted(_bin_key(o, d, lo, hi, alive),
                                          o, d, alive)
            idsb = trace_closest(packed, ob, db, ab)[0][inv]
        else:
            idsb = trace_closest(packed, o, d, alive)[0]
        return idsb, shadow_bits(o, d, idsb, None), o, d

    def bounce_empty(o, d, ids, alive):
        # every later bounce is empty too (alive only shrinks)
        return (jnp.full((N,), -1, jnp.int32), jnp.zeros((N,), jnp.int32),
                o, d)

    for depth in range(1, config.max_depth + 1):
        alive = alive_from_ids(ids_l[-1])
        with jax.named_scope(f"tpurt.traversal.b{depth}"):
            ids, occ, o, d = lax.cond(jnp.any(alive), bounce, bounce_empty,
                                      o, d, ids_l[-1], alive)
        ids_l.append(ids)
        occ_l.append(occ)
    return (_untile(jnp.stack(ids_l), nrows, W),
            _untile(jnp.stack(occ_l), nrows, W))


def render_rows_clustered(scene, config, tri_ids, row0, nrows: int):
    """Cluster-traversal render of rows [row0, row0+nrows): the traversal
    finds topology, deferred shading rebuilds the image differentiably."""
    from tpurt.shading.deferred import HitRecords, shade_from_records

    with jax.named_scope("tpurt.pack_clusters"):
        packed = pack_clusters(scene, tri_ids)
    W = config.width
    ids, occ = trace_records(scene, packed, config, row0, nrows)
    T = scene.n_tris
    miss = ids < 0
    is_tri = (~miss) & (ids < T)
    prim = jnp.where(miss, -1, jnp.where(is_tri, ids, ids - T))
    recs = HitRecords(prim=prim, is_tri=is_tri, occ=occ)
    o, d = geom.generate_rays(scene.camera, config.height, W, row0, nrows)
    with jax.named_scope("tpurt.deferred_shading"):
        colors = shade_from_records(
            scene, o.reshape(-1, 3), d.reshape(-1, 3), recs,
            config.max_depth, config.shadows,
        )
    return colors.reshape(nrows, W, 3)


def traversal_stats(scene, config, tri_ids, row0=0, nrows=None) -> dict:
    """Depth-0 survivor counts per tile of every pass (closest, then one
    shadow pass per light) → {pass: (ntiles,) int32}.  A count above MAXS
    marks an overflowing tile (traced against every cluster)."""
    nrows = config.height if nrows is None else nrows
    stats = {}
    trace_records(scene, pack_clusters(scene, tri_ids),
                  config.replace(max_depth=0), row0, nrows, stats=stats)
    return stats
