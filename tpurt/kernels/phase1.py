"""Phase-1 render path: small untextured scenes, every primitive tested by
every ray, in plain jnp left to XLA.

Phase-1 scenes are tiny in primitives (configs 1–3 have 1, 36 and 5; the
cap is _MAX_PRIMS per type), so the whole scene is one small operand and
the work is an elementwise chain over (primitives × pixels) that XLA fuses:

* Rays ride in columns: every per-ray quantity is a (k, R) row-stack over a
  tile of R flat pixels, and the tiles are mapped with `lax.map`.
* Intersection evaluates all six Baldwin–Weber linear forms of a primitive
  block against all rays as one `dot_general (8, 6·B) × (8, R)` at
  HIGHEST precision (pack.py holds the forms); the winner's attributes are
  fetched by a one-hot `dot_general`, also at HIGHEST, so they arrive
  exactly.
* The backward pass is autodiff of the same program; each tile is wrapped
  in `jax.checkpoint`, so the backward recomputes one tile at a time
  instead of holding (primitives × pixels) residuals.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from tpurt import constants as C
from tpurt.kernels import pack as PK
from tpurt.kernels.pack import pack_scene

#: pixels per mapped tile, at most: bounded so a tile's (sublanes × R)
#: intermediates stay near _TILE_ELEMS elements
RAYS = 1 << 16
_TILE_ELEMS = 1 << 22

_MAX_PRIMS = 4096  # phase-1 limit per primitive type


# ---------------------------------------------------------------------------
# the tile program: pure jnp on (k, R) row-stacks; vec3s are tuples of rows
# ---------------------------------------------------------------------------
def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]         # → (1, R)


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _neg3(a):
    return (-a[0], -a[1], -a[2])


def _where3(m, a, b):
    return tuple(jnp.where(m, x, y) for x, y in zip(a, b))


def _normalize3(a):
    s = lax.rsqrt(_dot3(a, a) + C.NORMALIZE_EPS)
    return _scale3(a, s)


def _reflect3(d, n):
    return _sub3(d, _scale3(n, 2.0 * _dot3(d, n)))


def _tile_color(glob, wtri, wsph, attrs, pix0, statics):
    """Render R flat pixels starting at pix0 (traced i32 scalar) →
    colors, a tuple of three (1, R) rows.

    glob (1, NGLOB) f32; wtri (8, 6·T_pad); wsph (8, 2·S_pad);
    attrs (T_pad + S_pad, ACOLS).
    statics: (H, W, max_depth, shadows, nb_t, nb_s, n_lights, R, TLB, SLB).
    """
    H, W, max_depth, shadows, nb_t, nb_s, n_lights, R, TLB, SLB = statics
    f32 = jnp.float32
    t_pad = nb_t * TLB

    def g(k):  # (1,1) global scalar — broadcasts against (1,R)
        return glob[:, k:k + 1]

    def g3(k):  # vec3 global as a tuple of (1,1) values
        return (g(k), g(k + 1), g(k + 2))

    # ---- ray-gen (constants.py camera conventions) ------------------------
    pix = pix0 + lax.broadcasted_iota(jnp.int32, (1, R), 1)
    row = (pix // W).astype(f32)
    colm = (pix % W).astype(f32)
    aspect = W / H
    sx = (2.0 * (colm + 0.5) / W - 1.0) * aspect   # right already × tan(fov/2)
    sy = 1.0 - 2.0 * (row + 0.5) / H
    eye, fwd = g3(0), g3(3)
    right_h, up_h = g3(6), g3(9)
    ambient = g3(12)
    d = _normalize3(_add3(fwd, _add3(_scale3(right_h, sx), _scale3(up_h, sy))))
    o = tuple(jnp.broadcast_to(e, (1, R)) for e in eye)

    iota_t = lax.broadcasted_iota(jnp.int32, (TLB, R), 0)
    iota_s = lax.broadcasted_iota(jnp.int32, (SLB, R), 0)
    rows8 = lax.broadcasted_iota(jnp.int32, (8, R), 0)

    def build_X(o3, d3):
        """(8, R) ray matrix [ox oy oz 1 dx dy dz 0] via iota masking (no
        small-vector concatenates)."""
        m = lambda k, v: jnp.where(rows8 == k, v, 0.0)        # noqa: E731
        return (
            m(0, o3[0]) + m(1, o3[1]) + m(2, o3[2]) + m(3, 1.0)
            + m(4, d3[0]) + m(5, d3[1]) + m(6, d3[2])
        )

    def tri_block(X, b, t_lo, t_hi):
        """(t (128,R), u, v) for triangle block b against rays X."""
        wb = wtri[:, b * 6 * TLB : (b + 1) * 6 * TLB]
        out = lax.dot_general(
            wb, X, (((0,), (0,)), ((), ())),
            preferred_element_type=f32,
            precision=lax.Precision.HIGHEST,
        ).reshape(6, TLB, R)
        no_, ndd, uo, ud, vo, vd = (out[i] for i in range(6))
        good = jnp.abs(ndd) >= C.MT_DET_EPS
        safe_nd = jnp.where(good, ndd, 1.0)
        t = -no_ / safe_nd
        u = uo + t * ud
        v = vo + t * vd
        hit = good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_lo) & (t < t_hi)
        return jnp.where(hit, t, C.T_NONE), u, v

    def sph_block(X, b, oo, od, t_lo, t_hi):
        """(t (128,R)) for sphere block b (nearest root in range)."""
        wb = wsph[:, b * 2 * SLB : (b + 1) * 2 * SLB]
        out = lax.dot_general(
            wb, X, (((0,), (0,)), ((), ())),
            preferred_element_type=f32,
            precision=lax.Precision.HIGHEST,
        ).reshape(2, SLB, R)
        ct, cd = out[0], out[1]
        b_half = od - cd                       # o·d - c·d
        cterm = oo + ct                        # |o-c|² - r²
        disc = b_half * b_half - cterm
        has = disc > 0.0
        sq = jnp.sqrt(jnp.where(has, disc, 1.0))  # guarded: grad-safe
        t0 = -b_half - sq
        t1 = -b_half + sq
        t0_ok = has & (t0 > t_lo) & (t0 < t_hi)
        t1_ok = has & (t1 > t_lo) & (t1 < t_hi)
        return jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, C.T_NONE))

    def fold_best(best, tm, u, v, attr_block, iota, blk):
        """Fold one block's (blk,R) candidates into the running per-ray best."""
        t_best, a_best, u_best, v_best = best
        bt = jnp.min(tm, axis=0, keepdims=True)                      # (1,R)
        bidx = jnp.min(
            jnp.where(tm == bt, iota, blk), axis=0, keepdims=True
        )
        onehot = (iota == bidx).astype(f32)                          # (blk,R)
        cand_a = lax.dot_general(
            attr_block, onehot, (((0,), (0,)), ((), ())),
            preferred_element_type=f32,
            precision=lax.Precision.HIGHEST,  # attrs must survive exactly
        )                                                            # (ACOLS,R)
        cand_u = jnp.sum(onehot * u, axis=0, keepdims=True)
        cand_v = jnp.sum(onehot * v, axis=0, keepdims=True)
        imp = bt < t_best
        return (
            jnp.where(imp, bt, t_best),
            jnp.where(imp, cand_a, a_best),
            jnp.where(imp, cand_u, u_best),
            jnp.where(imp, cand_v, v_best),
        )

    def closest(o3, d3):
        X = build_X(o3, d3)
        oo = _dot3(o3, o3)
        od = _dot3(o3, d3)
        best = (
            jnp.full((1, R), C.T_NONE, f32),
            jnp.zeros((PK.ACOLS, R), f32),
            jnp.zeros((1, R), f32),
            jnp.zeros((1, R), f32),
        )
        for b in range(nb_t):
            tm, u, v = tri_block(X, b, C.T_MIN, C.T_MAX)
            best = fold_best(
                best, tm, u, v, attrs[b * TLB : (b + 1) * TLB], iota_t, TLB
            )
        for b in range(nb_s):
            tm = sph_block(X, b, oo, od, C.T_MIN, C.T_MAX)
            zero = jnp.zeros_like(tm)
            best = fold_best(
                best, tm, zero, zero,
                attrs[t_pad + b * SLB : t_pad + (b + 1) * SLB], iota_s, SLB,
            )
        return best

    def occluded(o3, d3, tmax):
        """Any-hit in (T_MIN, tmax) — shadow rays (SURVEY §2 row R7)."""
        X = build_X(o3, d3)
        oo = _dot3(o3, o3)
        od = _dot3(o3, d3)
        occ = jnp.zeros((1, R), bool)
        for b in range(nb_t):
            tm, _, _ = tri_block(X, b, C.T_MIN, C.T_MAX)
            occ = occ | jnp.any(tm < tmax, axis=0, keepdims=True)
        for b in range(nb_s):
            tm = sph_block(X, b, oo, od, C.T_MIN, C.T_MAX)
            occ = occ | jnp.any(tm < tmax, axis=0, keepdims=True)
        return occ

    # ---- Whitted loop (constants.py conventions; mirrors ref/oracle.py) ---
    bg = tuple(jnp.full((1, R), C.BACKGROUND[c], f32) for c in range(3))
    accum = tuple(jnp.zeros((1, R), f32) for _ in range(3))
    thr = jnp.ones((1, R), f32)
    alive = jnp.ones((1, R), bool)

    def shade_at(t, a, u, v, args):
        """Post-closest shading of one depth; the cond-skipped section."""
        o, d, accum, thr, alive = args
        hit = t < C.T_MAX
        p = _add3(o, _scale3(d, t))

        def a1(k):
            return a[k : k + 1]

        def a3(k):
            return (a1(k), a1(k + 1), a1(k + 2))

        w_bar = 1.0 - u - v
        n_int = _normalize3(
            _add3(
                _scale3(a3(PK.A_N0), w_bar),
                _add3(_scale3(a3(PK.A_N1), u), _scale3(a3(PK.A_N2), v)),
            )
        )
        n_tri = _where3(_dot3(n_int, d) > 0.0, _neg3(n_int), n_int)  # two-sided
        n_sph = _normalize3(_sub3(p, a3(PK.A_CENTER)))               # not flipped
        is_sph = a1(PK.A_IS_SPH) > 0.5
        n = _where3(is_sph, n_sph, n_tri)

        ka = a3(PK.A_KA)
        kd = a3(PK.A_KD)
        ks = a3(PK.A_KS)
        shin = a1(PK.A_SHIN)
        refl = a1(PK.A_REFL)

        color = tuple(ka[c] * ambient[c] for c in range(3))
        view = _neg3(d)
        p_off = _add3(p, _scale3(n, C.RAY_OFFSET_EPS))
        for li in range(n_lights):
            lpos = g3(PK.NGLOB_BASE + 3 * li)
            lcol = g3(PK.NGLOB_BASE + 3 * n_lights + 3 * li)
            to_l = _sub3(lpos, p)
            dist = jnp.sqrt(_dot3(to_l, to_l))
            ldir = _scale3(to_l, 1.0 / jnp.maximum(dist, 1e-20))
            ndotl = jnp.maximum(_dot3(n, ldir), 0.0)
            refl_l = _reflect3(_neg3(ldir), n)
            rdotv = jnp.maximum(_dot3(refl_l, view), 0.0)
            safe_rv = jnp.where(rdotv > 0.0, rdotv, 1.0)
            spec = jnp.where((ndotl > 0.0) & (rdotv > 0.0), safe_rv**shin, 0.0)
            if shadows:
                occ = occluded(p_off, ldir, dist - C.RAY_OFFSET_EPS)
                vis = 1.0 - occ.astype(f32)
            else:
                vis = 1.0
            color = tuple(
                color[c] + vis * lcol[c] * (kd[c] * ndotl + ks[c] * spec)
                for c in range(3)
            )

        color = _where3(hit, color, bg)
        live = thr * alive.astype(f32)
        accum = tuple(accum[c] + live * color[c] for c in range(3))
        refl = jnp.where(hit, refl, 0.0)
        thr = thr * refl
        alive = alive & hit & (refl > 0.0)
        return (accum, thr, alive, p_off, _reflect3(d, n))

    def shade_skip(args):
        """EXACT equivalent of shade_at on a tile where NO lane hit: every
        lane's color is the background and throughput dies (refl is masked
        to zero on a miss), so sky tiles skip the Phong and occlusion
        passes entirely."""
        o, d, accum, thr, alive = args
        live = thr * alive.astype(f32)
        accum = tuple(accum[c] + live * bg[c] for c in range(3))
        return (accum, jnp.zeros_like(thr), jnp.zeros_like(alive), o, d)

    for _depth in range(max_depth + 1):
        if _depth == 0:
            # depth 0: every lane is alive; closest always runs, the
            # shading + shadow section is skipped on all-sky tiles
            t, a, u, v = closest(o, d)
            accum, thr, alive, o, d = lax.cond(
                jnp.any(t < C.T_MAX),
                functools.partial(shade_at, t, a, u, v), shade_skip,
                (o, d, accum, thr, alive))
        else:
            # deeper bounces: tiles with no live path skip closest AND
            # shading.  The idle branch is exact: live ≡ 0 ⇒ accum is
            # unchanged, thr/alive are already all-dead, o/d are unread.
            def full_body(args):
                t_, a_, u_, v_ = closest(args[0], args[1])
                return shade_at(t_, a_, u_, v_, args)

            def idle(args):
                o_, d_, accum_, thr_, alive_ = args
                return accum_, thr_, alive_, o_, d_

            accum, thr, alive, o, d = lax.cond(
                jnp.any(alive), full_body, idle, (o, d, accum, thr, alive))

    return tuple(jnp.clip(accum[c], C.CLAMP_LO, C.CLAMP_HI) for c in range(3))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def supports(scene, config) -> bool:
    """Phase-1 applicability: few primitives of each type, no textures.
    Uses only static scene properties (shapes + flags), so it is safe to
    call while tracing."""
    return (
        scene.n_tris <= _MAX_PRIMS
        and scene.n_spheres <= _MAX_PRIMS
        and not scene.textured
    )


def _tile_rays(n_pix: int, sublanes: int) -> int:
    """Tile width: a power of two ≥ 128, at most RAYS, covering n_pix when
    it is small, and keeping sublanes × R near _TILE_ELEMS."""
    r = 128
    while r < RAYS and r < n_pix and (2 * r) * max(sublanes, 1) <= _TILE_ELEMS:
        r *= 2
    return r


def render_rows_phase1(scene, config, row0, nrows: int):
    """Render rows [row0, row0+nrows) → (nrows, W, 3); row0 may be traced
    (the shard_map slab of each device)."""
    packed = pack_scene(scene)
    W = config.width
    n_pix = nrows * W
    sublanes = (packed.n_tri_blocks * packed.tlb
                + packed.n_sph_blocks * packed.slb)
    R = _tile_rays(n_pix, sublanes)
    ntiles = -(-n_pix // R)
    statics = (config.height, W, config.max_depth, config.shadows,
               packed.n_tri_blocks, packed.n_sph_blocks, packed.n_lights, R,
               packed.tlb, packed.slb)
    # pixel offsets stay int32: a float carry loses odd offsets past 2^24
    off = jnp.asarray(row0, jnp.int32) * W

    @jax.checkpoint
    def tile(pix0):
        cols = _tile_color(packed.globals, packed.wtri, packed.wsph,
                           packed.attrs, pix0, statics)
        return jnp.concatenate(cols, axis=0)               # (3, R)

    flat = lax.map(tile, off + R * jnp.arange(ntiles, dtype=jnp.int32))
    img = flat.transpose(1, 0, 2).reshape(3, ntiles * R)[:, :n_pix]
    return jnp.transpose(img.reshape(3, nrows, W), (1, 2, 0))


def render_phase1(scene, config):
    return render_rows_phase1(scene, config, 0, config.height)
