"""Smoke run of tpurt on one NVIDIA GPU: the main path at full size, every
kernel compiled for the card, parity with the frozen oracle.

    python chip_smoke.py            # one card: the phases below, in order
    python chip_smoke.py --four     # four cards: only the mesh comparisons

Phases (one card; the first failure ends the run with a nonzero exit):

1. compile  — the trace kernel on configs 4 and 5 and the config-5
              fwd+bwd step at their real widths; memory_analysis() of each.
2. parity   — on the card: the compiled trace kernel (closest and any-hit)
              on sampled tiles of the full config-4 and -5 frames against
              its plain-XLA brute-force twin (the same math) and the
              brute-force oracle; record equality of the shadow re-binning
              (config 5, full frame) and the wavefront bounces (config 3's
              cluster path) against their plain counterparts; compacted,
              chunked, rematerialised shading against the plain path on a
              72-row config-5 slab (image and gradients); the frozen oracle
              (tpurt/ref) on config 3 at 512² and config 4 at 1024² in
              full and config 5 on a row slab, gradients on row slabs; two
              central finite differences of the rendered loss against
              autodiff.
3. main     — prepare → render → render_and_grad (L2) on configs 3, 4 and
              5 at full size: ms per frame, nominal and traced Mrays/s,
              finite nonzero gradients; the config-5 vertex-table
              scatter-add of the backward timed alone.

--four runs config 5 at 1080p through make_train_step on a 4-card mesh
against the single-card render_and_grad, and the scene-sharded ring at n=4
against the replicated clustered render of the renumbered scene.

The last line of stdout is one JSON object with "ok" and the device JAX
reports.  Exits nonzero and prints no result when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

#: image tolerances against the oracle: mean |Δ| and the share of pixels
#: allowed past 1e-3 (the oracle intersects with Möller–Trumbore, the
#: kernel with Baldwin–Weber forms: a rounding step can move a hit across
#: a silhouette); gradients within 1% of the largest oracle entry.  Every
#: float32 product on these paths names its precision (HIGHEST) or is
#: elementwise, so no TF32 reaches them.
IMG_MEAN, IMG_BAD_PX, IMG_BAD_FRAC, GRAD_REL = 1e-4, 1e-3, 2e-3, 1e-2
#: the kernel against its plain-XLA twin (the same math; Triton's f32
#: division rounds as XLA's does): identical ids, no tie, t within TIE_REL
#: (t can differ in the last bit).  Against the oracle (Möller–Trumbore):
#: ids identical except on a tie — both hit, at t within TIE_REL relative
#: (two triangles sharing the edge the ray meets) — and every common hit's
#: t within TIE_REL
TIE_REL = 1e-5
#: compacted vs plain shading: same formulas, other chunking and
#: accumulation order — no pixel past 1e-4, gradients within 1e-3 of the
#: largest entry
EQ_PX, EQ_GRAD_REL = 1e-4, 1e-3
#: central finite differences: step and relative budget (f32 loss noise at
#: these sizes is about 1e-4 relative)
FD_H, FD_REL = 2e-3, 2e-2


def log(*a):
    print(*a, flush=True)


def timed(fn, arg, iters=3):
    """(compile+first seconds, seconds per call over `iters` calls)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(arg))
    first = time.perf_counter() - t0
    jax.block_until_ready(fn(arg))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(arg)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / iters


def memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k.replace('_size_in_bytes', '')}="
                    f"{getattr(m, k) / 2**20:.1f}MiB" for k in keys
                    if hasattr(m, k))


def compare_images(name, img, ref):
    import numpy as np

    d = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    mean_d = float(d.mean())
    frac = float((d.max(-1) > IMG_BAD_PX).mean())
    ok = np.isfinite(np.asarray(img)).all() and mean_d < IMG_MEAN \
        and frac < IMG_BAD_FRAC
    log(f"[parity] {name}: shape={tuple(img.shape)} mean|d|={mean_d:.3e} "
        f"frac(|d|>{IMG_BAD_PX})={frac:.2e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"parity failed: {name}")


def compare_grads(name, g, g_ref, leaves, rel=GRAD_REL):
    import numpy as np

    for leaf in leaves:
        a = np.asarray(getattr(g, leaf))
        r = np.asarray(getattr(g_ref, leaf))
        scale = float(np.abs(r).max())
        err = float(np.abs(a - r).max())
        ok = np.isfinite(a).all() and scale > 0 and err <= rel * scale
        log(f"[parity] {name} grad {leaf}: max|d|={err:.3e} "
            f"max|ref|={scale:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"gradient parity failed: {name} {leaf}")


def check_grads(name, g, leaves):
    import numpy as np

    for leaf in leaves:
        a = np.asarray(getattr(g, leaf))
        fin, nz = bool(np.isfinite(a).all()), float(np.abs(a).max())
        log(f"[main] {name} grad {leaf}: finite={fin} max|g|={nz:.3e}")
        if not fin or nz == 0.0:
            raise SystemExit(f"bad gradient: {name} {leaf}")


def oracle_rows(scene, cfg, row0, nrows, chunk):
    """The frozen oracle on rows [row0, row0+nrows), each pixel chunk under
    jax.checkpoint so its gradient holds one chunk's intermediates at a
    time (the oracle is O(pixels × primitives))."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from tpurt.core import geom
    from tpurt.ref import oracle

    o, d = geom.generate_rays(scene.camera, cfg.height, cfg.width, row0,
                              nrows)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    n = o.shape[0]
    assert n % chunk == 0, (n, chunk)
    body = jax.checkpoint(lambda od: oracle.trace_rays(
        scene, od[0], od[1], cfg.max_depth, cfg.shadows))
    cols = lax.map(body, (o.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3)))
    return cols.reshape(nrows, cfg.width, 3)


def fast_rows(scene, cfg, plan, row0, nrows):
    from tpurt.dist.shard import render_rows

    return render_rows(scene, cfg, row0, nrows, plan=plan)


def build(cfg_id, h, w):
    from tpurt.render import prepare
    from tpurt.scene import configs

    t0 = time.perf_counter()
    scene, cfg = configs.ALL_CONFIGS[cfg_id](h, w)
    plan = prepare(scene, cfg)
    log(f"[setup] config {cfg_id} {h}x{w}: tris={scene.n_tris} "
        f"spheres={scene.n_spheres} plan={plan.kind} "
        f"clusters={None if plan.tri_ids is None else plan.tri_ids.shape[0]}"
        f" ({time.perf_counter() - t0:.1f}s)")
    return scene, cfg, plan


def l2(target):
    import jax.numpy as jnp

    return lambda im: jnp.sum((im - target) ** 2)


def trace_inputs(scene, cfg, plan):
    """Packed clusters + camera rays of the full frame in tile order."""
    from tpurt.kernels import traversal as TV
    from tpurt.kernels.packc import pack_clusters

    packed = pack_clusters(scene, plan.tri_ids)
    o, d, inside = TV._camera_tiles(scene.camera, cfg.height, cfg.width, 0,
                                    cfg.height)
    return packed, o, d, inside


def phase_compile(scenes):
    import jax

    from tpurt.kernels import traversal as TV
    from tpurt.render import render_and_grad

    for cid in (4, 5):
        scene, cfg, plan = scenes[cid]
        t0 = time.perf_counter()
        fn = jax.jit(lambda s, _c=cfg, _p=plan: TV.trace_closest(
            *trace_inputs(s, _c, _p))[:2])
        comp = fn.lower(scene).compile()
        log(f"[compile] trace kernel config {cid}: "
            f"{time.perf_counter() - t0:.1f}s {memory(comp)}")
    scene, cfg, plan = scenes[5]
    t0 = time.perf_counter()
    step = jax.jit(lambda s: render_and_grad(s, l2(0.5), cfg, plan=plan))
    comp = step.lower(scene).compile()
    log(f"[compile] config 5 fwd+bwd step: {time.perf_counter() - t0:.1f}s "
        f"{memory(comp)}")
    return {5: comp}


def phase_parity(scenes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpurt import constants as C
    from tpurt.render import render

    # the compiled trace kernel against its twin and the oracle, at the
    # real scene width, on every 128th tile of the frame
    for cid in (4, 5):
        trace_vs_refs(cid, *scenes[cid])
    phase_equivalence(scenes)

    # full frames against the oracle: config 3 (phase-1) and config 4
    for cid in (3, 4):
        scene, cfg, plan = scenes[cid]
        img = jax.jit(lambda s: render(s, cfg, plan=plan))(scene)
        ref = jax.jit(lambda s: render(s, cfg.replace(backend="oracle",
                                                      accel="none")))(scene)
        compare_images(f"config {cid} full {cfg.height}x{cfg.width}", img,
                       ref)
    # row slabs: config 5's image, gradients of all three
    slabs = {3: (0.4, 16, 512, ("light_color", "sph_center", "sph_radius")),
             4: (0.5, 8, 256, ("vertices", "light_color")),
             5: (0.52, 4, 128, ("light_color", "textures", "vertices"))}
    for cid, (frac, nrows, chunk, leaves) in slabs.items():
        scene, cfg, plan = scenes[cid]
        row0 = int(frac * cfg.height)
        chunk = min(chunk, nrows * cfg.width)
        t0 = time.perf_counter()
        grad_f = jax.jit(jax.grad(
            lambda s: jnp.sum(fast_rows(s, cfg, plan, row0, nrows) ** 2),
            allow_int=True))
        grad_r = jax.jit(jax.grad(
            lambda s: jnp.sum(oracle_rows(s, cfg, row0, nrows, chunk) ** 2),
            allow_int=True))
        img = jax.jit(lambda s: fast_rows(s, cfg, plan, row0, nrows))(scene)
        ref = jax.jit(lambda s: oracle_rows(s, cfg, row0, nrows, chunk))(
            scene)
        hit = float(np.mean(np.abs(np.asarray(ref) - np.asarray(
            C.BACKGROUND)).max(-1) > 1e-6))
        compare_images(f"config {cid} rows {row0}+{nrows} (non-background "
                       f"{hit:.2f})", img, ref)
        compare_grads(f"config {cid} rows {row0}+{nrows}", grad_f(scene),
                      grad_r(scene), leaves)
        log(f"[parity] config {cid} slab done ({time.perf_counter() - t0:.1f}s)")
    finite_differences()


def brute_closest(packed, o, d, t_hi, alive):
    """The kernel's closest hit in plain XLA, brute force: the same
    Baldwin–Weber math (traversal._tri_t, with XLA's division) against
    every packed triangle, the same (t, gid) lexicographic minimum, seeded
    with the same sphere hit.  → (ids, t) as trace_closest returns them."""
    import jax.numpy as jnp

    from tpurt import constants as C
    from tpurt.kernels import traversal as TV
    from tpurt.kernels.packc import FORMS

    ts, sid = TV._spheres(packed, o, d, t_hi)
    f = packed.forms.transpose(1, 0, 2).reshape(FORMS, -1)
    gid = packed.gid.reshape(-1)
    t = TV._tri_t(tuple(o[:, k, None] for k in range(3)),
                  tuple(d[:, k, None] for k in range(3)),
                  [f[k][None, :] for k in range(FORMS)], t_hi[:, None])
    bt = jnp.min(t, axis=1)
    bg = jnp.min(jnp.where(t == bt[:, None], gid[None, :], TV._IMAX), axis=1)
    better = ((bt < ts) | ((bt == ts) & (bg < sid))) & (bt < C.T_NONE)
    ids = jnp.where(better, bg, sid)
    hit = alive & (ids >= 0)
    return (jnp.where(hit, ids, -1),
            jnp.where(hit, jnp.where(better, bt, ts), C.T_NONE))


def brute_any(packed, o, d, tmax, alive):
    """The kernel's any-hit in plain XLA, brute force over every packed
    triangle and sphere (same math as brute_closest)."""
    import jax.numpy as jnp

    from tpurt import constants as C
    from tpurt.core import geom
    from tpurt.kernels import traversal as TV
    from tpurt.kernels.packc import FORMS

    f = packed.forms.transpose(1, 0, 2).reshape(FORMS, -1)
    t = TV._tri_t(tuple(o[:, k, None] for k in range(3)),
                  tuple(d[:, k, None] for k in range(3)),
                  [f[k][None, :] for k in range(FORMS)], tmax[:, None])
    occ = jnp.any(t < C.T_NONE, axis=1)
    if packed.n_spheres:
        _, ts = geom.intersect_spheres(o, d, packed.sph[:, :3],
                                       packed.sph[:, 3])
        occ = occ | jnp.any(ts < tmax[:, None], axis=-1)
    return occ & alive


def id_mismatches(ids, t, ref_ids, ref_t):
    """(ids that differ other than on a tie, ties, common hits whose t is
    off by more than TIE_REL) — see TIE_REL."""
    import numpy as np

    both = (ids >= 0) & (ref_ids >= 0)
    close = both & (np.abs(t - ref_t) <= TIE_REL * np.abs(ref_t))
    differ = ids != ref_ids
    return (int((differ & ~close).sum()), int((differ & close).sum()),
            int((both & ~differ & ~close).sum()))


def trace_vs_refs(cid, scene, cfg, plan, every=128):
    """Full-frame closest + light-0 shadow traces with the compiled
    kernel; every `every`-th tile is traced again by its plain-XLA twin
    (brute_closest / brute_any) and by the oracle (geom.closest_hit /
    any_hit, Möller–Trumbore).  Closest ids must equal the twin's and the
    oracle's up to ties (TIE_REL; none allowed against the twin);
    occlusion of the same shadow segments must equal both exactly."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from tpurt import constants as C
    from tpurt.core import geom
    from tpurt.kernels import traversal as TV

    t_start = time.perf_counter()

    @jax.jit
    def run(s):
        packed, o, d, inside = trace_inputs(s, cfg, plan)
        ids, t, cnt = TV.trace_closest(packed, o, d, inside)
        p, p_off = TV._hit_points(s, o, d, ids)
        to_l = s.light_pos[0] - p
        dist = jnp.sqrt(jnp.sum(to_l * to_l, axis=-1))
        ldir = to_l / jnp.maximum(dist, 1e-20)[:, None]
        tmax = dist - C.RAY_OFFSET_EPS
        alive = ids >= 0
        occ, cnt_s = TV.trace_any(packed, p_off, ldir, tmax, alive)

        def sample(x):            # (sampled tiles, RAYS, ...)
            return x.reshape((-1, TV.RAYS) + x.shape[1:])[::every]

        def refs(args):
            oc, dc, ic, qc, lc, tc, ac = args
            t_inf = jnp.full(ic.shape, C.T_MAX, jnp.float32)
            tw_ids, tw_t = brute_closest(packed, oc, dc, t_inf, ic)
            rec = geom.closest_hit(s, oc, dc)
            hit = rec["hit"] & ic
            or_ids = jnp.where(hit, jnp.where(rec["is_tri"], rec["prim"],
                                              rec["prim"] + s.n_tris), -1)
            or_t = jnp.where(hit, rec["t"], C.T_NONE)
            return (tw_ids, tw_t, or_ids, or_t,
                    brute_any(packed, qc, lc, tc, ac),
                    geom.any_hit(s, qc, lc, tc) & ac)

        ref = lax.map(refs, tuple(sample(x) for x in (
            o, d, inside, p_off, ldir, tmax, alive)))
        mine = tuple(sample(x) for x in (ids, t, occ, alive))
        return mine, ref, cnt, cnt_s

    (ids, t, occ, alive), ref, cnt, cnt_s = jax.tree_util.tree_map(
        np.asarray, run(scene))
    tw_ids, tw_t, or_ids, or_t, tw_occ, or_occ = ref
    ok = True
    for name, r_ids, r_t, r_occ in (("twin", tw_ids, tw_t, tw_occ),
                                    ("oracle", or_ids, or_t, or_occ)):
        bad, ties, t_off = id_mismatches(ids, t, r_ids, r_t)
        t_bits = int((t != r_t).sum())
        occ_bad = int((occ != r_occ).sum())
        good = bad == 0 and t_off == 0 and occ_bad == 0
        if name == "twin":
            good = good and ties == 0
        ok = ok and good
        log(f"[parity] trace kernel vs {name} config {cid}: {ids.size} "
            f"sampled rays ({int((ids >= 0).sum())} hits), closest-id "
            f"mismatches={bad}, ties={ties}, t beyond {TIE_REL}={t_off}, "
            f"t not bit-identical={t_bits}; "
            f"any-hit mismatches={occ_bad} of {int(alive.sum())} segments "
            f"({int(occ.sum())} occluded) -> {'ok' if good else 'FAIL'}")
    log(f"[stats] config {cid} survivors/tile closest mean="
        f"{cnt.mean():.2f} max={cnt.max()} overflow tiles="
        f"{int((cnt > TV.MAXS).sum())} of {cnt.size}; shadow mean="
        f"{cnt_s.mean():.2f} max={cnt_s.max()} overflow tiles="
        f"{int((cnt_s > TV.MAXS).sum())} "
        f"({time.perf_counter() - t_start:.1f}s)")
    if not ok:
        raise SystemExit(f"trace kernel parity failed: config {cid}")


def records_equal(name, fn, scene):
    """fn(scene) → ((ids, occ), (ids, occ)); the records must be equal."""
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    (ia, oa), (ib, ob) = jax.jit(fn)(scene)
    mism = int(jnp.sum(ia != ib) + jnp.sum(oa != ob))
    log(f"[parity] {name}: record mismatches={mism} of {ia.size + oa.size} "
        f"(hits {int(jnp.sum(ia >= 0))}, shadowed lanes "
        f"{int(jnp.sum(oa != 0))}) -> {'ok' if mism == 0 else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f}s)")
    if mism:
        raise SystemExit(f"record parity failed: {name}")


def phase_equivalence(scenes):
    """Optimised paths against their plain counterparts, compiled for the
    card: shadow re-binning and wavefront bounces (integer records, equal
    exactly), compacted shading (image and gradients)."""
    import jax
    import jax.numpy as jnp

    from tpurt.kernels import traversal as TV
    from tpurt.kernels.packc import pack_clusters
    from tpurt.render import cap_depth, prepare
    from tpurt.shading import deferred as D

    def records(plan, cfg):
        return lambda s: TV.trace_records(s, pack_clusters(s, plan.tri_ids),
                                          cfg, 0, cfg.height)

    # shadows over Morton-re-binned hit points vs over the pixel tiles
    scene, cfg, plan = scenes[5]
    cfg = cap_depth(cfg, plan)
    assert plan.tri_ids.shape[0] > TV.SHADOW_REBIN_MIN_CLUSTERS
    on = records(plan, cfg.replace(shadow_rebin=True))
    off = records(plan, cfg.replace(shadow_rebin=False))
    records_equal("config 5 full frame shadow rebin on/off", lambda s: (
        on(s), off(s)), scene)

    # reflection bounces re-binned by octant + Morton vs in pixel tiles:
    # config 3's cluster path (reflective spheres, depth 2)
    scene, cfg, _ = scenes[3]
    plan = prepare(scene, cfg, accel="bvh")
    on = records(plan, cfg.replace(wavefront=True))
    off = records(plan, cfg.replace(wavefront=False))
    records_equal(f"config 3 {cfg.height}x{cfg.width} clusters wavefront "
                  f"on/off", lambda s: (on(s), off(s)), scene)

    # compacted, chunked, rematerialised shading vs the plain path on a
    # config-5 slab above the compaction threshold
    scene, cfg, plan = scenes[5]
    row0, nrows = 504, 72
    n_pix = nrows * cfg.width
    assert n_pix >= D.SHADE_COMPACT_MIN and D._shade_compact_on(
        scene.n_tris, n_pix)
    t0 = time.perf_counter()

    def run():
        f = lambda s: fast_rows(s, cfg, plan, row0, nrows)  # noqa: E731
        img = jax.jit(f)(scene)
        g = jax.jit(jax.grad(lambda s: jnp.sum(f(s) ** 2),
                             allow_int=True))(scene)
        return img, g

    img_c, g_c = run()
    saved = D.SHADE_COMPACT
    D.SHADE_COMPACT = False
    jax.clear_caches()          # the gate is read at trace time
    try:
        img_p, g_p = run()
    finally:
        D.SHADE_COMPACT = saved
        jax.clear_caches()
    d = jnp.abs(img_c - img_p).max(-1)
    n_bad = int(jnp.sum(d > EQ_PX))
    log(f"[parity] config 5 rows {row0}+{nrows} compacted vs plain shading: "
        f"max|d|={float(d.max()):.3e}, pixels past {EQ_PX}={n_bad} -> "
        f"{'ok' if n_bad == 0 else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f}s)")
    if n_bad:
        raise SystemExit("compacted shading differs from plain")
    compare_grads("config 5 compacted vs plain shading", g_c, g_p,
                  ("vertices", "textures", "light_color"), rel=EQ_GRAD_REL)


def finite_differences():
    """Autodiff against a central difference of the rendered loss, on the
    card: one scalar leaf per path class (the cluster path on a textured
    mesh, the phase-1 path).  No geometry leaf: a true finite difference
    moves silhouettes, which the fixed-topology gradient excludes."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tpurt.render import prepare, render
    from tpurt.scene import configs

    def light(s, v=None):
        if v is None:
            return s.light_color[0, 0]
        return dataclasses.replace(s, light_color=s.light_color.at[0, 0].set(v))

    def albedo(s, v=None):
        if v is None:
            return s.materials.kd[1, 0]
        return dataclasses.replace(s, materials=dataclasses.replace(
            s.materials, kd=s.materials.kd.at[1, 0].set(v)))

    cases = (
        ("config 5 48x64 light intensity", lambda: configs.config5_multimesh(
            48, 64, n_blobs=2, subdiv=4), "bvh", light),
        ("config 3 64x64 sphere albedo", lambda: configs.config3_spheres(
            64, 64), "auto", albedo))
    for name, build_fn, accel, leaf in cases:
        scene, cfg = build_fn()
        plan = prepare(scene, cfg, accel=accel)

        def loss(s):
            return jnp.sum(render(s, cfg, plan=plan) ** 2)

        g = float(leaf(jax.jit(jax.grad(loss, allow_int=True))(scene)))
        v0 = float(leaf(scene))
        loss_j = jax.jit(loss)
        fd = (float(loss_j(leaf(scene, v0 + FD_H)))
              - float(loss_j(leaf(scene, v0 - FD_H)))) / (2 * FD_H)
        rel = abs(fd - g) / max(abs(g), 1e-3)
        ok = rel < FD_REL
        log(f"[parity] finite difference {name} (plan={plan.kind}): "
            f"autodiff={g:.6e} central={fd:.6e} rel={rel:.2e} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"finite-difference check failed: {name}")


def phase_main(scenes, compiled):
    import jax
    import jax.numpy as jnp

    import bench
    from tpurt.accel import native
    from tpurt.render import render, render_and_grad

    log(f"[main] cluster builder: {native.backend()}")
    leaves = {3: ("light_color", "sph_center", "sph_radius"),
              4: ("vertices", "light_color"),
              5: ("vertices", "textures", "light_color")}
    results = {}
    for cid in (3, 4, 5):
        scene, cfg, plan = scenes[cid]
        fwd = jax.jit(lambda s: render(s, cfg, plan=plan))
        step = compiled.get(cid) or jax.jit(
            lambda s: render_and_grad(s, l2(0.5), cfg, plan=plan))
        c_f, t_f = timed(fwd, scene)
        c_b, t_b = timed(step, scene)
        (loss, img), g = step(scene)
        check_grads(f"config {cid}", g, leaves[cid])
        rays = bench.count_rays(cfg, scene)
        traced = bench.count_rays_traced(cfg, scene, plan)
        results[cid] = (t_f, t_b)
        log(f"[main] config {cid} {cfg.height}x{cfg.width} plan={plan.kind}: "
            f"fwd {t_f * 1e3:.3f} ms/frame (first call {c_f:.1f}s), "
            f"fwd+bwd {t_b * 1e3:.3f} ms/frame (first call {c_b:.1f}s); "
            f"Mrays/s fwd nominal={rays / t_f / 1e6:.2f} "
            f"traced={traced / t_f / 1e6:.2f}, fwd+bwd nominal="
            f"{rays / t_b / 1e6:.2f} traced={traced / t_b / 1e6:.2f}; "
            f"loss={float(loss):.6g} finite={bool(jnp.isfinite(loss))}")
    return results


def time_vertex_scatter(scene, cfg, plan):
    """The backward's vertex-table cotangent alone: deferred._pack_gather_bwd
    (one scatter-add of three corner rows per hit pixel into the merged
    (V, W) vertex table) at config 5's real shapes — the depth-0 hit
    pixels of the full frame in the (miss, pid) order compacted shading
    feeds it, with random cotangent rows."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpurt.kernels import traversal as TV
    from tpurt.kernels.packc import pack_clusters
    from tpurt.render import cap_depth
    from tpurt.shading import deferred as D

    cfg = cap_depth(cfg, plan)
    ids = np.asarray(jax.jit(lambda s: TV.trace_records(
        s, pack_clusters(s, plan.tri_ids), cfg, 0, cfg.height)[0][0])(scene))
    pid = np.sort(ids[(ids >= 0) & (ids < scene.n_tris)])
    idx3 = jnp.asarray(np.asarray(scene.triangles)[pid])
    vtab_shape = D._build_vtab(scene).shape
    pack_shape = D._build_shadepack(scene).shape
    cot = jax.random.normal(jax.random.PRNGKey(0), (pid.size, pack_shape[1]),
                            jnp.float32)
    assert D._pack_direct(scene.n_tris, cfg.height * cfg.width)
    res = lambda i3: (i3, vtab_shape, pack_shape,  # noqa: E731
                      tuple(scene.triangles.shape), (pid.size,))
    fn = jax.jit(lambda a: D._pack_gather_bwd(
        scene.smooth, scene.textured, res(a[0]), a[1])[1])
    first, per = timed(fn, (idx3, cot))
    log(f"[layer] config 5 vertex-table scatter-add alone: {pid.size} hit "
        f"pixels x 3 corners into {vtab_shape}: {per * 1e3:.3f} ms "
        f"(first call {first:.1f}s)")


#: full sizes: config 3 at 512², config 4 at 1024², config 5 at 1080p
SIZES = {3: (512, 512), 4: (1024, 1024), 5: (1080, 1920)}


def run_one():
    scenes = {cid: build(cid, *hw) for cid, hw in SIZES.items()}
    compiled = phase_compile(scenes)
    phase_parity(scenes)
    phase_main(scenes, compiled)
    time_vertex_scatter(*scenes[5])


def run_four():
    """Config 5 at 1080p over four cards: the row-slab train step and the
    scene-sharded ring, each against its single-card counterpart."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpurt.dist import (make_mesh, make_train_step,
                            prepare_scene_sharded,
                            render_scene_sharded_prepared, render_sharded,
                            renumber_by_clusters)
    from tpurt.kernels.traversal import render_rows_clustered
    from tpurt.render import render_and_grad

    scene, cfg, plan = build(5, *SIZES[5])
    mesh = make_mesh(4)
    log(f"[four] mesh {mesh.shape} over {[str(d) for d in mesh.devices]}")
    target = jnp.full((cfg.height, cfg.width, 3), 0.5, jnp.float32)
    # a large step so that (p − p') / lr recovers each gradient from the
    # update to well under 1% of its largest entry in f32
    lr = 1e3

    # (a) row-slab tile parallelism through make_train_step, against the
    # single-card render_and_grad of the same mean L2 loss
    step4 = make_train_step(cfg, mesh, plan=plan)
    lr_ = jnp.float32(lr)
    c4, t4 = timed(lambda s: step4(s, target, lr_), scene)
    s4, loss4 = step4(scene, target, lr_)
    rag1 = jax.jit(lambda s: render_and_grad(
        s, lambda im: jnp.mean((im - target) ** 2), cfg, plan=plan))
    c1, t1 = timed(rag1, scene)
    (loss1, img1), g1 = rag1(scene)
    img4 = jax.jit(lambda s: render_sharded(s, cfg, mesh, plan=plan))(scene)
    log(f"[four] image sharding: {img4.sharding}")
    compare_images("4-card row slabs vs 1 card", np.asarray(img4),
                   np.asarray(img1))
    rel_loss = abs(float(loss4) - float(loss1)) / abs(float(loss1))
    log(f"[four] loss 4-card train step={float(loss4):.8g} 1-card "
        f"render_and_grad={float(loss1):.8g} rel={rel_loss:.2e}; ms per "
        f"fwd+bwd 4-card step={t4 * 1e3:.3f} (incl. SGD update) 1-card="
        f"{t1 * 1e3:.3f} (first calls {c4:.1f}s, {c1:.1f}s)")
    if rel_loss > 1e-5:
        raise SystemExit("4-card loss differs from 1 card")

    def recovered(s2):
        return jax.tree_util.tree_map(
            lambda a, b: (np.asarray(a, np.float64) - np.asarray(b)) / lr
            if np.issubdtype(np.asarray(a).dtype, np.floating) else None,
            scene, s2)

    compare_grads("4-card train step vs 1-card render_and_grad",
                  recovered(s4), g1, ("vertices", "textures", "light_color"))
    for d in mesh.devices:
        st = d.memory_stats() or {}
        log(f"[four] {d}: peak_bytes_in_use="
            f"{st.get('peak_bytes_in_use', 0) / 2**30:.2f}GiB")

    # (b) the scene-sharded ring at n=4 vs replicated clustered render
    scene2, parts = prepare_scene_sharded(scene, plan.tri_ids, 4)
    _, tri_ids2 = renumber_by_clusters(scene, plan.tri_ids)
    ring = jax.jit(lambda s: render_scene_sharded_prepared(s, cfg, parts,
                                                           mesh))
    rep = jax.jit(lambda s: render_rows_clustered(s, cfg, tri_ids2, 0,
                                                  cfg.height))
    cr, tr = timed(ring, scene2)
    cp, tp = timed(rep, scene2)
    compare_images("ring n=4 vs replicated", np.asarray(ring(scene2)),
                   np.asarray(rep(scene2)))
    log(f"[four] ring n=4 {tr * 1e3:.3f} ms/frame vs replicated 1 card "
        f"{tp * 1e3:.3f} ms/frame (first calls {cr:.1f}s, {cp:.1f}s)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh comparisons")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU (platform "
              f"{devs[0].platform!r})", file=sys.stderr)
        sys.exit(1)
    from tpurt.utils.device import card, enable_compile_cache

    log(f"[card] {card()}")
    log(f"[card] jax {jax.__version__} devices={len(devs)} "
        f"kind={devs[0].device_kind!r} cache={enable_compile_cache()}")
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        sys.exit(1)
    t0 = time.perf_counter()
    if args.four:
        run_four()
    else:
        run_one()
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
