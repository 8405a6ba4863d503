"""Gradient checks (SURVEY.md §4 item 2): oracle autodiff vs central finite
differences on scalar scene parameters, on tiny images so FD is tractable.
These pin the gradient ground truth that the hand-derived Pallas backward
kernels must later match."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpurt.ref import render_ref
from tpurt.scene import configs


def _fd_check(loss_fn, x0, eps, rtol, atol=1e-4):
    g = jax.grad(loss_fn)(x0)
    fd = (loss_fn(x0 + eps) - loss_fn(x0 - eps)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g), np.asarray(fd), rtol=rtol, atol=atol)


def test_grad_light_intensity_config2():
    scene, cfg = configs.config2_cornell(16, 16)

    def loss(scale):
        s = dataclasses.replace(scene, light_color=scene.light_color * scale)
        return jnp.sum(render_ref(s, config=cfg))

    _fd_check(loss, jnp.float32(1.0), 1e-3, rtol=2e-2)
    # brighter light → brighter image (until clamp): gradient positive
    assert float(jax.grad(loss)(jnp.float32(1.0))) > 0


def test_grad_albedo_config2():
    scene, cfg = configs.config2_cornell(16, 16)

    def loss(scale):
        mats = dataclasses.replace(scene.materials, kd=scene.materials.kd * scale)
        s = dataclasses.replace(scene, materials=mats)
        img = render_ref(s, config=cfg)
        return jnp.sum(img**2)

    _fd_check(loss, jnp.float32(0.9), 1e-3, rtol=2e-2)


def test_grad_sphere_radius_config3():
    """Autodiff differentiates shading at *fixed* hit topology (SURVEY.md §7
    piecewise-constant-visibility convention); FD only agrees on pixels whose
    topology is constant under the perturbation, so mask to those and use
    depth 0 / no shadows (reflection & occlusion flips are also topology)."""
    from tpurt.core import geom

    scene, cfg = configs.config3_spheres(24, 24)
    cfg = cfg.replace(max_depth=0, shadows=False)
    eps = 1e-3
    o, d = geom.generate_rays(scene.camera, cfg.height, cfg.width)

    def topo(dr):
        s = dataclasses.replace(scene, sph_radius=scene.sph_radius + dr)
        rec = geom.closest_hit(s, o, d)
        return np.asarray(rec["hit"]), np.asarray(rec["is_tri"]), np.asarray(rec["prim"])

    hp, ip_, pp = topo(np.float32(2 * eps))
    hm, im, pm = topo(np.float32(-2 * eps))
    mask = jnp.asarray((hp == hm) & (ip_ == im) & (pp == pm), jnp.float32)[..., None]

    def loss(dr):
        s = dataclasses.replace(scene, sph_radius=scene.sph_radius + dr)
        return jnp.sum(render_ref(s, config=cfg) * mask)

    _fd_check(loss, jnp.float32(0.0), eps, rtol=5e-2, atol=1e-2)


def test_grad_sphere_center_finite():
    scene, cfg = configs.config3_spheres(16, 16)
    cfg = cfg.replace(max_depth=1)

    def loss(centers):
        s = dataclasses.replace(scene, sph_center=centers)
        return jnp.sum(render_ref(s, config=cfg))

    g = jax.grad(loss)(scene.sph_center)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0  # gradients actually flow


def test_grad_vertices_config4():
    scene, cfg = configs.config4_bunny(16, 16, subdiv=1)

    def loss(verts):
        s = dataclasses.replace(scene, vertices=verts)
        return jnp.sum(render_ref(s, config=cfg))

    g = jax.grad(loss)(scene.vertices)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def test_grad_no_nans_all_targets_config3():
    scene, cfg = configs.config3_spheres(12, 12)

    def loss(s):
        return jnp.sum(render_ref(s, config=cfg))

    grads = jax.grad(loss, allow_int=True)(scene)
    for leaf in jax.tree_util.tree_leaves(grads):
        if np.issubdtype(np.asarray(leaf).dtype, np.floating):
            assert np.isfinite(np.asarray(leaf)).all()


def test_sorted_scatter_grads_match_naive(monkeypatch):
    """TPURT_SORTED_SCATTER contract (ADVICE r2): the sorted segment-sum
    backward of the shadepack gather must be allclose to the naive
    scatter-add on a small textured clustered scene, and `order` must be
    argsort(pid) — violated preconditions would silently corrupt grads."""
    from tpurt.render import prepare, render_and_grad
    from tpurt.shading import deferred

    scene, cfg = configs.config5_multimesh(24, 32, n_blobs=2, subdiv=4)
    plan = prepare(scene, cfg)
    assert plan.kind == "clusters"

    def run():
        # render() is jitted and module flags are read at TRACE time —
        # without a cache clear the second variant would silently reuse
        # the first compilation and the comparison would be vacuous
        jax.clear_caches()
        (_, _), grads = render_and_grad(
            scene, lambda im: jnp.sum(im**2), cfg, plan=plan)
        return grads

    # the direct _pack_gather transpose bypasses the sorted-scatter flag;
    # force the chained path so the flag is actually exercised
    monkeypatch.setattr(deferred, "_PACK_DIRECT_ENV", "0")
    monkeypatch.setattr(deferred, "SORTED_SCATTER", False)
    g_naive = run()
    monkeypatch.setattr(deferred, "SORTED_SCATTER", True)
    g_sorted = run()
    for leaf in ("vertices", "textures", "light_color"):
        a = np.asarray(getattr(g_naive, leaf))
        b = np.asarray(getattr(g_sorted, leaf))
        assert np.isfinite(b).all(), leaf
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(a).max()),
            err_msg=leaf)


def test_shade_compact_matches_plain(monkeypatch):
    """Hit-compacted chunked shading + the _pack_gather direct transpose
    (r3): per-pixel math is identical, so images agree to compiler noise
    (XLA makes different FMA/fusion choices at chunk shapes — measured
    ulp-level, ≤3e-5) and gradients are allclose (scatter accumulation
    order), on (a) a mostly-miss textured mesh scene and (b) a reflective
    sphere scene whose multi-depth alive/throughput logic crosses chunk
    bodies."""
    from tpurt.render import prepare, render, render_and_grad
    from tpurt.shading import deferred

    cases = [
        configs.config5_multimesh(16, 48, n_blobs=1, subdiv=3),
        configs.config3_spheres(16, 48),
    ]
    for scene, cfg in cases:
        plan = prepare(scene, cfg, accel="bvh")
        assert plan.kind == "clusters"

        def run():
            jax.clear_caches()  # flags are read at trace time
            img = render(scene, cfg, plan=plan)
            (_, _), g = render_and_grad(
                scene, lambda im: jnp.sum(im**2), cfg, plan=plan)
            return np.asarray(img), g

        monkeypatch.setattr(deferred, "SHADE_COMPACT", False)
        img0, g0 = run()
        monkeypatch.setattr(deferred, "SHADE_COMPACT", True)
        monkeypatch.setattr(deferred, "SHADE_COMPACT_MIN", 1)
        monkeypatch.setattr(deferred, "SHADE_CHUNKS", 4)
        img1, g1 = run()
        np.testing.assert_allclose(
            img0, img1, atol=1e-4, err_msg="compact shading changed image")
        monkeypatch.setattr(deferred, "_PACK_DIRECT_ENV",
                            "0" if deferred._pack_direct(
                                scene.n_tris, img0.size // 3) else "1")
        img2, g2 = run()
        np.testing.assert_allclose(
            img0, img2, atol=1e-4, err_msg="pack transpose changed image")
        for ga, gb in ((g0, g1), (g1, g2)):
            for la, lb in zip(jax.tree_util.tree_leaves(ga),
                              jax.tree_util.tree_leaves(gb)):
                a, b = np.asarray(la), np.asarray(lb)
                if not np.issubdtype(a.dtype, np.floating):
                    continue
                assert np.isfinite(b).all()
                # scatter accumulation order differs between the paths —
                # f32 sums over ~1k terms drift a few e-5 relative
                np.testing.assert_allclose(
                    a, b, rtol=1e-4,
                    atol=1e-4 * max(1.0, np.abs(a).max()))


def test_segsum_flag_grads_match_naive(monkeypatch):
    """TPURT_TEX_SEGSUM / TPURT_MAT_SEGSUM contracts: the factored one-hot
    matmul transposes must be allclose to the scatter-add backward they
    replace on a small textured clustered scene (both flags are default-off
    A/B constants kept for other scene shapes — without this test a
    violated precondition would silently corrupt grads)."""
    from tpurt.render import prepare, render_and_grad
    from tpurt.shading import deferred

    scene, cfg = configs.config5_multimesh(24, 32, n_blobs=2, subdiv=4)
    plan = prepare(scene, cfg)

    def run():
        jax.clear_caches()  # flags are read at trace time
        (_, _), grads = render_and_grad(
            scene, lambda im: jnp.sum(im**2), cfg, plan=plan)
        return grads

    monkeypatch.setattr(deferred, "TEX_SEGSUM", False)
    monkeypatch.setattr(deferred, "MAT_SEGSUM", False)
    g0 = run()
    monkeypatch.setattr(deferred, "TEX_SEGSUM", True)
    g1 = run()
    monkeypatch.setattr(deferred, "TEX_SEGSUM", False)
    monkeypatch.setattr(deferred, "MAT_SEGSUM", True)
    g2 = run()
    for g in (g1, g2):
        for leaf in ("textures", "light_color", "vertices"):
            a = np.asarray(getattr(g0, leaf))
            b = np.asarray(getattr(g, leaf))
            assert np.isfinite(b).all(), leaf
            np.testing.assert_allclose(
                a, b, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(a).max()),
                err_msg=leaf)
        am = np.asarray(g0.materials.kd)
        bm = np.asarray(g.materials.kd)
        np.testing.assert_allclose(am, bm, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(am).max()))


def test_shade_remat_grads_allclose(monkeypatch):
    """TPURT_SHADE_REMAT (jax.checkpoint on the shading body — the
    residual-vs-recompute trade) must leave gradients allclose on BOTH the
    compacted and plain paths: remat is mathematically the identity, only
    refusion rounding may differ."""
    import numpy as np

    from tpurt.render import prepare, render_and_grad
    from tpurt.scene import configs
    from tpurt.shading import deferred as D

    scene, cfg = configs.config4_bunny(24, 24, subdiv=3)
    plan = prepare(scene, cfg, accel="bvh")

    def grads():
        (_, _), g = render_and_grad(
            scene, lambda im: jnp.sum(im ** 2), cfg, plan=plan)
        return np.asarray(g.vertices), np.asarray(g.materials.kd)

    for compact in (False, True):
        monkeypatch.setattr(D, "SHADE_COMPACT", compact)
        monkeypatch.setattr(D, "SHADE_COMPACT_MIN", 1)
        monkeypatch.setattr(D, "SHADE_REMAT", False)
        gv0, gk0 = grads()
        for policy in ("1", "names"):
            monkeypatch.setattr(D, "SHADE_REMAT", True)
            monkeypatch.setattr(D, "_SHADE_REMAT_ENV", policy)
            gv1, gk1 = grads()
            for a, b in ((gv0, gv1), (gk0, gk1)):
                assert np.isfinite(b).all()
                np.testing.assert_allclose(
                    a, b, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(a).max()))
