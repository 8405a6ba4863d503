"""Scene sharding v2: cluster blocks AND shading tables sharded across the
mesh, rays exchanged around a ring (SURVEY.md §5 scaling axis (b) —
"ring-style ray exchange", the ray tracer's structural analogue of ring
attention; BASELINE.json:5 "scene primitives replicated or sharded
per-host").

Layout: a 1-D mesh of n devices.  The IMAGE is row-slab sharded (the same
data-parallel axis as tpurt/dist/shard.py) AND the triangle set is sharded:
triangles are RENUMBERED into cluster-major order (renumber_by_clusters) so
that a contiguous cluster range owns a contiguous global-id range, and
device i then holds

* 1/n of the cluster blocks — the packed ``forms/gid`` arrays the trace
  kernel reads,
* the matching 1/n slice of ``scene.triangles``/``tri_mat`` rows,
* the matching 1/n slice of the (T, K) deferred-shading pack built from it,
* and (v3) the ~1/n slice of the merged VERTEX table its triangles
  reference (exact per-shard gather lists — `widx`), with triangle
  corners localized to list positions

— only materials/lights/camera/spheres/textures stay replicated.

Each bounce runs n ring steps: compact the arrived rays (live-first, Morton
order — the wavefront re-bin applied to traveling rays, so dead tiles
cull to empty survivor lists), trace against local clusters, fold the
per-shard best into the carried (t, gid) record by the oracle's argmin-first
tie rule, then ``lax.ppermute`` the ray packet onward.  Shadow rays make the
same trip per light; occlusion is ``t_hit < dist``.  SHADING stays home:
per-depth shadepack rows are fetched by rotating the (Tmax, K) pack slices
around the ring (n gathers masked by pid range — `_ring_rows`), which is
differentiable, so vertex/normal/uv gradients flow through the traveling
slices and land back on the owning shard via the transposed permutes;
replicated leaves (vertices, materials, lights, textures) get their psum
from shard_map autodiff.

Cost model: forward communication is 6 f32 + records per ray per step plus
one rotation of the pack slice per shading depth over the device links —
bandwidth-bound, overlappable; v2 optimizes for correctness + memory
scaling and is validated bit-for-bit against replicated rendering of the renumbered scene on the CPU
mesh (tests/test_dist.py).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tpurt import constants as C
from tpurt.core import geom
from tpurt.core.types import RenderConfig
from tpurt.dist.shard import TILE_AXIS, _rows_per_device


def renumber_by_clusters(scene, tri_ids):
    """Host-side: permute triangles into cluster-major first-occurrence
    order so each contiguous cluster range owns one contiguous global
    tri-id range — the property that lets cluster shards also shard the
    shading tables by pid range.  Idempotent (renumbering a renumbered
    scene is the identity).  Images are invariant except on exact-t ties
    between DIFFERENT triangles (the lowest-gid rule resolves by the new
    numbering) — a measure-zero event; vertices keep their order, so all
    float gradients map 1:1.  (Vertex-table sharding does NOT renumber
    vertices: contiguous windows fail on connected meshes — a SAH split
    plane's vertices are shared across distant cluster ranges — so
    shard_scene_clusters builds per-shard exact gather LISTS instead.)"""
    flat = np.asarray(tri_ids).reshape(-1)
    T = int(np.asarray(scene.triangles).shape[0])
    _, first = np.unique(flat, return_index=True)
    order = flat[np.sort(first)]                  # old ids, cluster-major
    assert order.shape[0] == T, (order.shape, T)
    inv = np.empty(T, np.int64)
    inv[order] = np.arange(T)
    tris = np.asarray(scene.triangles)[order]
    tmat = np.asarray(scene.tri_mat)[order]
    scene2 = dataclasses.replace(
        scene, triangles=jnp.asarray(tris), tri_mat=jnp.asarray(tmat))
    host = getattr(scene, "host_mesh", None)
    if host is not None:
        object.__setattr__(scene2, "host_mesh", (host[0], tris))
    tri_ids2 = inv[np.asarray(tri_ids)].astype(np.int32)
    return scene2, jnp.asarray(tri_ids2)


def shard_scene_clusters(scene, tri_ids2, n: int):
    """Host-side shard assembly AFTER renumber_by_clusters: split the
    cluster list into n contiguous slices (padded with duplicates of the
    last cluster — harmless under closest/any-hit) and cut the matching
    triangle-row ranges, padded to a common Tmax.

    v3: triangle rows are VERTEX-LOCALIZED and each shard gets a `widx`
    row — the sorted unique global vertex ids its triangles reference —
    so the vertex table ships sharded (vtab[widx[i]] per device) and
    per-device vertex-derived bytes scale ~|unique corners| ≈ V/n plus
    boundary overlap.  Exact gather lists, not contiguous windows: on a
    connected mesh a SAH split plane's vertices are shared across distant
    cluster ranges, which stretches any [min, max) window to ~V.

    Returns (tri_ids_loc (n, Cs, 128) LOCAL-indexed, tri_sh (n, Tmax, 3)
    vertex-localized, tmat_sh (n, Tmax), t0s (n,), cnts (n,), widx
    (n, Vmax) global vertex ids, Tmax) — the per-device packed bytes are
    ~1/n of the replicated arrays (tests assert this)."""
    tri_ids2 = np.asarray(tri_ids2)
    tris = np.asarray(scene.triangles)
    tmat = np.asarray(scene.tri_mat)
    T = tris.shape[0]
    Ccount = tri_ids2.shape[0]
    Cs = -(-Ccount // n)
    if Cs * n != Ccount:
        # pad the cluster list with duplicates of the LAST cluster: they
        # stay inside the last shard's contiguous id range
        pad = np.broadcast_to(
            tri_ids2[-1:], (Cs * n - Ccount, tri_ids2.shape[1]))
        tri_ids2 = np.concatenate([tri_ids2, pad], axis=0)
    t0s = np.empty(n, np.int64)
    trace_hi = np.empty(n, np.int64)      # ids the shard's clusters touch
    for i in range(n):
        sl = tri_ids2[i * Cs : (i + 1) * Cs]
        t0s[i] = sl.min()
        trace_hi[i] = sl.max() + 1
    # contiguity invariants from the renumbering (duplicate-pad shards may
    # repeat the previous shard's range — t0s is non-decreasing, never gaps)
    assert t0s[0] == 0 and trace_hi.max() == T, (t0s, trace_hi, T)
    assert all(t0s[i + 1] <= trace_hi[i] for i in range(n - 1)), (
        t0s, trace_hi)
    # DISJOINT row-fetch ranges (a pid must be served by exactly ONE shard
    # in _ring_rows): [t0s[i], t0s[i+1]); duplicate-pad shards get cnt 0
    fetch_hi = np.concatenate([t0s[1:], [T]])
    cnts = np.maximum(fetch_hi - t0s, 0)
    # the TRACE needs every row its clusters reference, which can exceed
    # the fetch range on duplicate-pad shards — size slices to the max of
    # both and always fill them with the REAL rows at [t0, t0+Tmax)
    Tmax = int(np.maximum(trace_hi - t0s, cnts).max())
    tri_sh = np.zeros((n, Tmax, 3), tris.dtype)
    tmat_sh = np.zeros((n, Tmax), tmat.dtype)
    tloc = np.empty((n, Cs, tri_ids2.shape[1]), np.int32)
    for i in range(n):
        c = int(min(Tmax, T - t0s[i]))
        tri_sh[i, :c] = tris[t0s[i] : t0s[i] + c]
        tri_sh[i, c:] = tris[t0s[i] : t0s[i] + 1]  # pad rows: never packed
        tmat_sh[i, :c] = tmat[t0s[i] : t0s[i] + c]
        tmat_sh[i, c:] = tmat[t0s[i]]
        tloc[i] = tri_ids2[i * Cs : (i + 1) * Cs] - t0s[i]
    # per-shard vertex gather lists: sorted unique corner ids (pad rows
    # copy real rows, so they are covered); corners remapped to positions
    # in the list via searchsorted (exact on the sorted unique array)
    uniq = [np.unique(tri_sh[i].reshape(-1)) for i in range(n)]
    Vmax = max(int(u.shape[0]) for u in uniq)
    widx = np.empty((n, Vmax), np.int64)
    for i, u in enumerate(uniq):
        widx[i, : u.shape[0]] = u
        widx[i, u.shape[0] :] = u[-1]             # pad: never referenced
        tri_sh[i] = np.searchsorted(u, tri_sh[i])
    return (jnp.asarray(tloc), jnp.asarray(tri_sh), jnp.asarray(tmat_sh),
            jnp.asarray(t0s.astype(np.int32)),
            jnp.asarray(cnts.astype(np.int32)),
            jnp.asarray(widx.astype(np.int32)), Tmax)


def _merge(best_t, best_id, t_new, id_new):
    """Fold a shard's partial hits into the carried record by (t, gid):
    smaller t wins; on exact-t ties the smaller global primitive id wins
    (tpurt/constants.py tie convention, matching the oracle's argmin)."""
    tie = (t_new == best_t) & (t_new < C.T_NONE) & (id_new >= 0)
    tie = tie & ((id_new < best_id) | (best_id < 0))
    imp = (t_new < best_t) | tie
    return jnp.where(imp, t_new, best_t), jnp.where(imp, id_new, best_id)


def _root_entry(lo, hi, o, d):
    """Conservative per-ray entry distance into the RESIDENT shard's root
    box → (entry (N,), hit (N,)) — XLA-level slab test, O(rays)."""
    t_lo = jnp.full(o.shape[:1], -C.T_NONE)
    t_hi = jnp.full(o.shape[:1], C.T_NONE)
    for k in range(3):
        dk = d[:, k]
        par = jnp.abs(dk) < 1e-12
        safe = jnp.where(par, jnp.where(dk >= 0, 1e-12, -1e-12), dk)
        ta = (lo[k] - o[:, k]) / safe
        tb = (hi[k] - o[:, k]) / safe
        near, far = jnp.minimum(ta, tb), jnp.maximum(ta, tb)
        inside = (o[:, k] >= lo[k]) & (o[:, k] <= hi[k])
        near = jnp.where(par, jnp.where(inside, -C.T_NONE, C.T_NONE), near)
        far = jnp.where(par, jnp.where(inside, C.T_NONE, -C.T_NONE), far)
        t_lo = jnp.maximum(t_lo, near)
        t_hi = jnp.minimum(t_hi, far)
    return jnp.maximum(t_lo, 0.0), (t_lo <= t_hi) & (t_hi > 0.0)


def _ring_closest(packed, config, o, d, alive, axis, n, T_global, t0,
                  tmax=None):
    """n ring steps of closest-hit: returns (ids, t) GLOBAL bests for the
    rays that START on this device (they travel the full ring and land back
    home on the last permute).

    Cross-shard early termination (exact): on arrival at each shard, a ray
    skips the trace when (a) it misses the shard's root box, (b) its
    carried best t precedes the shard's conservative entry (non-strict
    keep at equality — an equal-t smaller-id tie could still win), or
    (c) `tmax` is given (shadow rings: the occlusion band end, which
    TRAVELS with the ray) and the carried best already proves occlusion.

    Traveling rays are COMPACTED before each trace (live-first, Morton-of-
    origin + direction-octant order — the wavefront re-bin applied to the
    ring) so dead tiles cull to empty survivor lists and the tiles the
    surviving rays do occupy stay coherent; results scatter back by the inverse
    permutation before the merge, which is order-independent (min-fold
    with an exact gid tie rule), so compaction is exact.

    COMM/COMPUTE OVERLAP: when the packet splits evenly, rays travel as
    TWO independent half-packets interleaved per step — half A's ppermute
    has no data dependence on half B's trace, so XLA's async collective
    scheduler hides each permute behind the other half's kernel (the
    ring-attention pipelining recipe).  Exact: the halves never interact
    until the final concat."""
    from tpurt.kernels.traversal import RAYS, _bin_key, trace_closest

    N = o.shape[0]
    Tmax = packed.n_tris                      # local (padded) triangle count
    lo = jnp.min(packed.box[:, 0:3], axis=0)
    hi = jnp.max(packed.box[:, 4:7], axis=0)
    no_tmax = tmax is None
    if no_tmax:
        tmax = jnp.full((N,), C.T_NONE, jnp.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def init_state(sl):
        Ns = sl.stop - sl.start
        return (
            o[sl], d[sl], alive[sl],
            jnp.full((Ns,), C.T_NONE, jnp.float32),
            jnp.full((Ns,), -1, jnp.int32),
            tmax[sl],
        )

    def trace_merge(state, step):
        o_c, d_c, al_c, bt, bid, tm = state
        ent, hitbox = _root_entry(lo, hi, o_c, d_c)
        keep = hitbox & (ent <= bt)
        if packed.n_spheres > 0:
            # resident spheres are REPLICATED, not part of any shard's
            # cluster box: fold them once by keeping every ray at step 0
            # (their hits then seed bt for the later shards' skip test)
            keep = keep | (step == 0)
        al_eff = al_c & keep
        if not no_tmax:
            al_eff = al_eff & ~(bt < tm)  # already provably occluded
        # live-first Morton compaction of the arrived rays (exact, see
        # docstring): dead tiles cull to empty survivor lists
        key = _bin_key(o_c, d_c, lo, hi, al_eff)
        prm = jnp.argsort(lax.stop_gradient(key))
        ipr = jnp.argsort(prm)
        # occlusion is traced by DEDICATED shadow rings (one per light):
        # closest hit within the travelling band end tm
        ids_s, t_s, _ = trace_closest(
            packed, o_c[prm], d_c[prm], al_eff[prm], tmax=tm[prm])
        ids_s = ids_s[ipr]
        t_s = t_s[ipr]
        # local → global ids: tris get + this device's shard offset (the
        # pack is resident — rays travel, clusters don't); spheres (local
        # gid >= Tmax) map past every global triangle
        ids_g = jnp.where(
            ids_s < 0, ids_s,
            jnp.where(ids_s < Tmax, ids_s + t0, ids_s - Tmax + T_global))
        bt, bid = _merge(bt, bid, t_s, ids_g)
        return (o_c, d_c, al_c, bt, bid, tm)

    halves = (
        [slice(0, N // 2), slice(N // 2, N)]
        if n > 1 and (N // 2) % RAYS == 0 and N % 2 == 0
        else [slice(0, N)]
    )
    # ring steps as ONE scan body instead of n unrolled copies: identical
    # ops in identical order (bit-equal to the unrolled loop), but the
    # traversal kernel is inlined once per half instead of n times — on
    # the interpret-mode CPU mesh (tests, dryrun_multichip) that cuts the
    # XLA graph ~n×, which is the difference between the driver's dryrun
    # compiling in seconds or timing out.  Both halves advance inside the
    # SAME body, so half A's ppermute still has no data dependence on half
    # B's trace and XLA's async collective scheduler keeps hiding each
    # permute behind the other half's kernel.
    def ring_step(states, step):
        return tuple(
            lax.ppermute(trace_merge(st, step), axis, perm) for st in states
        ), None

    states, _ = lax.scan(ring_step,
                         tuple(init_state(sl) for sl in halves),
                         jnp.arange(n))
    bids = jnp.concatenate([st[4] for st in states]) if len(states) > 1 \
        else states[0][4]
    bts = jnp.concatenate([st[3] for st in states]) if len(states) > 1 \
        else states[0][3]
    return bids, bts


def _ring_rows(pack_loc, pid, axis, n, t0s, cnts):
    """Fetch shadepack rows for GLOBAL pids by rotating the (Tmax, K) pack
    slices around the ring: n masked gathers, one ppermute per step.
    Differentiable — the transpose scatters each step's cotangent rows into
    the traveling slice and the reversed permutes carry them back to the
    owning shard.  Total traffic per device ≈ the full pack once, but peak
    residency is 2 slices (the >HBM point).  Miss lanes (pid clipped to 0)
    fetch shard 0's row 0, mirroring the replicated path's clipped gather.
    """
    me = lax.axis_index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    Tmax = pack_loc.shape[0]
    rows = jnp.zeros(pid.shape + (pack_loc.shape[1],), pack_loc.dtype)
    pk = pack_loc
    for s in range(n):
        src = (me - s) % n                    # shard resident after s steps
        t0 = t0s[src]
        cnt = cnts[src]
        loc = pid - t0
        m = (loc >= 0) & (loc < cnt)
        g = pk[jnp.clip(loc, 0, Tmax - 1)]
        rows = rows + jnp.where(m[..., None], g, 0.0)
        if s < n - 1:
            pk = lax.ppermute(pk, axis, perm)
    return rows


def _split_rows(smooth, textured, g):
    """Split a gathered (N, K) pack row into the _gather_shaderows tuple."""
    tri_rows = (g[..., 0:3], g[..., 3:6], g[..., 6:9])
    k = 9
    nrm_rows = None
    if smooth:
        nrm_rows = (g[..., k:k + 3], g[..., k + 3:k + 6], g[..., k + 6:k + 9])
        k += 9
    uv_rows = None
    if textured:
        uv_rows = (g[..., k:k + 2], g[..., k + 2:k + 4], g[..., k + 4:k + 6])
        k += 6
    mat = jnp.round(g[..., k]).astype(C.INDEX_DTYPE)
    return tri_rows, nrm_rows, uv_rows, mat


def _render_slab_ring(scene, config, tri_ids_loc, tri_loc, tmat_loc, t0,
                      t0s, cnts, vtab_loc, row0, nrows, axis, n, T_global):
    """Per-device body under shard_map: trace this device's row slab against
    the ring of cluster shards, then shade deferentially with ring-fetched
    pack rows.  `scene` arrives with DUMMY triangle AND vertex arrays (the
    real rows are the sharded tri_loc/tmat_loc/vtab_loc; tri_loc corners
    are local to vtab_loc's window)."""
    from tpurt.kernels.packc import pack_clusters
    from tpurt.kernels.traversal import RAYS
    from tpurt.shading.deferred import (HitRecords, _hit_geometry,
                                        _pack_from_vtab, _recompute_tuv,
                                        shade_from_records)
    from tpurt.core import vec

    sg = jax.lax.stop_gradient
    # rebuild per-field views of the windowed vertex table: everything
    # downstream (pack_clusters wtri forms, shading row gathers) then works
    # in local vertex indices with the exact same float values
    k = 3 + (3 if scene.smooth else 0)
    scene_loc = dataclasses.replace(
        scene, triangles=tri_loc, tri_mat=tmat_loc,
        vertices=vtab_loc[:, 0:3],
        vnormals=(vtab_loc[:, 3:6] if scene.smooth else scene.vnormals),
        uvs=(vtab_loc[:, k:k + 2] if scene.textured else scene.uvs),
    )
    packed = pack_clusters(scene_loc, tri_ids_loc)
    Tmax = tri_loc.shape[0]
    W = config.width
    n_pix = nrows * W
    # pad to an even tile count so the ring's two-half pipeline engages
    quantum = 2 * RAYS if n > 1 else RAYS
    N_pad = -(-n_pix // quantum) * quantum

    # the differentiable shading slice: (Tmax, K) built from this shard's
    # vertex window + its triangle rows
    pack_sh = _pack_from_vtab(vtab_loc, tri_loc, tmat_loc, scene.smooth,
                              scene.textured)
    pack_sg = sg(pack_sh)

    def ring_rows(pid):
        return _ring_rows(pack_sh, pid, axis, n, t0s, cnts)

    o, d = geom.generate_rays(scene.camera, config.height, W, row0, nrows)
    o = sg(o.reshape(-1, 3))
    d = sg(d.reshape(-1, 3))

    def padded(x):
        width = [(0, N_pad - n_pix)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, width)

    alive = padded(jnp.ones((n_pix,), bool))
    o_p, d_p = padded(o), padded(d)

    ids_list, occ_list = [], []
    for _depth in range(config.max_depth + 1):
        ids, _t = _ring_closest(packed, config, o_p, d_p, alive, axis, n,
                                T_global, t0)
        ids = jnp.where(alive, ids, -1)
        # continuation + shadow-origin geometry from ring-fetched rows
        # (stop-gradient: ray positions are kernel inputs, never a gradient
        # path; the differentiable replay is the shading below)
        miss = ids < 0
        is_tri = (~miss) & (ids < T_global)
        prim = jnp.where(miss, -1, jnp.where(is_tri, ids, ids - T_global))
        rows = _split_rows(
            scene.smooth, scene.textured,
            _ring_rows(pack_sg, sg(jnp.maximum(prim, 0)), axis, n, t0s,
                       cnts))
        t, u, v = _recompute_tuv(scene_loc, o_p, d_p, prim, is_tri,
                                 rows=rows)
        p, nrm, mat = _hit_geometry(scene_loc, o_p, d_p, t, prim, is_tri,
                                    u, v, rows=rows)
        p_off = p + nrm * C.RAY_OFFSET_EPS
        refl_dir = vec.reflect(d_p, nrm)
        refl = scene.materials.reflectivity[mat]
        alive_next = (~miss) & (refl > 0.0) & alive

        occ_bits = jnp.zeros((N_pad,), jnp.int32)
        if config.shadows:
            hit = ids >= 0
            for li in range(scene.n_lights):
                to_l = sg(scene.light_pos[li]) - p
                dist = jnp.sqrt(jnp.sum(to_l * to_l, axis=-1))
                ldir = to_l / jnp.maximum(dist, 1e-20)[..., None]
                _ids_s, t_s = _ring_closest(
                    packed, config, p_off, ldir, hit, axis, n, T_global, t0,
                    tmax=dist - C.RAY_OFFSET_EPS,
                )
                occ = hit & (t_s < dist - C.RAY_OFFSET_EPS)
                occ_bits = occ_bits | jnp.where(occ, 1 << li, 0)
        ids_list.append(ids[:n_pix])
        occ_list.append(occ_bits[:n_pix])
        o_p, d_p, alive = sg(p_off), sg(refl_dir), alive_next

    ids = jnp.stack(ids_list)
    occ = jnp.stack(occ_list)
    miss = ids < 0
    is_tri = (~miss) & (ids < T_global)
    prim = jnp.where(miss, -1, jnp.where(is_tri, ids, ids - T_global))
    recs = HitRecords(prim=prim, is_tri=is_tri, occ=occ)
    colors = shade_from_records(
        scene_loc, o, d, recs, config.max_depth, config.shadows,
        gather_fn=ring_rows,
    )
    return colors.reshape(nrows, W, 3)


class ShardParts(tuple):
    """(tloc, tri_sh, tmat_sh, t0s, cnts, widx, T_global) — host-built
    shard topology from prepare_scene_sharded (all integer arrays:
    freezing it across optimization steps is exactly the frozen-topology
    convention the clustered path already uses).  tri_sh corners are
    vertex-LOCAL to the shard's widx window."""


def prepare_scene_sharded(scene, tri_ids, n: int):
    """Host-side prepare for ring rendering: renumber the (concrete) scene
    into cluster-major triangle order and cut the n shard slices (cluster
    blocks, triangle rows, shading-table ranges, vertex gather lists).
    Returns (scene2, ShardParts); pass scene2
    (or any same-topology update of it — moved vertices, new materials)
    with the parts to render_scene_sharded_prepared, which is
    jit/grad-safe."""
    scene2, tri_ids2 = renumber_by_clusters(scene, tri_ids)
    tloc, tri_sh, tmat_sh, t0s, cnts, widx, _tmax = shard_scene_clusters(
        scene2, tri_ids2, n)
    T_global = int(np.asarray(scene2.triangles).shape[0])
    return scene2, ShardParts(
        (tloc, tri_sh, tmat_sh, t0s, cnts, widx, T_global))


def render_scene_sharded_prepared(scene2, config: RenderConfig,
                                  parts: ShardParts, mesh: Mesh,
                                  axis: str = TILE_AXIS):
    """Ring render of a prepared (renumbered) scene — differentiable and
    safe to call under jit/grad (no host work).

    v3: the merged vertex table enters SHARDED — each device receives
    vtab[widx[i]] (the rows its triangles reference) — so per-device
    triangle- AND vertex-derived bytes scale ~1/n; the gather's transpose
    scatters per-shard vertex cotangents back onto scene2's global
    arrays, summing rows shared across shard boundaries."""
    from tpurt.shading.deferred import _build_vtab

    tloc, tri_sh, tmat_sh, t0s, cnts, widx, T_global = parts
    # replicated scene ships WITHOUT triangle or vertex rows (dummies):
    # the real rows enter sharded
    slim = dataclasses.replace(
        scene2,
        triangles=jnp.zeros((1, 3), jnp.int32),
        tri_mat=jnp.zeros((1,), jnp.int32),
        vertices=jnp.zeros((1, 3), jnp.float32),
        vnormals=jnp.zeros((1, 3), jnp.float32),
        uvs=jnp.zeros((1, 2), jnp.float32),
    )
    vtab_sh = _build_vtab(scene2)[widx]           # (n, Vmax, W)
    return _render_scene_sharded_jit(
        slim, config, tloc, tri_sh, tmat_sh, t0s, cnts, vtab_sh, mesh,
        axis, T_global)


def render_scene_sharded(scene, config: RenderConfig, tri_ids, mesh: Mesh,
                         axis: str = TILE_AXIS):
    """Render with the image, the cluster set AND the shading tables
    sharded over `mesh` (>HBM scenes: per-device triangle-derived bytes
    scale as 1/n — see shard_scene_clusters).

    tri_ids: the full (C, 128) cluster topology from prepare()/
    build_clusters (host-concrete, like the scene — for use under
    jit/grad, call prepare_scene_sharded once outside and
    render_scene_sharded_prepared inside).  The scene is RENUMBERED into
    cluster-major triangle order internally (identical images up to
    exact-t ties between different triangles; identical gradients — see
    renumber_by_clusters).  Returns the full image.
    """
    scene2, parts = prepare_scene_sharded(scene, tri_ids, mesh.shape[axis])
    return render_scene_sharded_prepared(scene2, config, parts, mesh, axis)


@partial(jax.jit,
         static_argnames=("config", "mesh", "axis", "T_global"))
def _render_scene_sharded_jit(scene, config: RenderConfig, tloc, tri_sh,
                              tmat_sh, t0s, cnts, vtab_sh, mesh: Mesh,
                              axis: str, T_global: int):
    n = mesh.shape[axis]
    nrows = _rows_per_device(config.height, n)

    def body(s, tids_loc, tri_loc, tmat_loc, t0_loc, t0s_r, cnts_r,
             vtab_loc):
        row0 = lax.axis_index(axis) * nrows
        return _render_slab_ring(s, config, tids_loc[0], tri_loc[0],
                                 tmat_loc[0], t0_loc[0], t0s_r, cnts_r,
                                 vtab_loc[0], row0, nrows, axis, n,
                                 T_global)

    full = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(axis, None, None), P(axis, None, None),
                  P(axis, None), P(axis), P(), P(),
                  P(axis, None, None)),
        out_specs=P(axis, None, None),
        check_vma=False,
    )(scene, tloc, tri_sh, tmat_sh, t0s, t0s, cnts, vtab_sh)
    return full[: config.height]
