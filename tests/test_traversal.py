"""Cluster traversal + deferred shading parity (SURVEY.md §4 items 1-2, §7
step 4).  The Triton trace kernel runs in interpret mode on the CPU; the
brute-force oracle is its reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.accel import build_clusters, build_grid
from tpurt.kernels import traversal as TV
from tpurt.ref import render_ref
from tpurt.render import RenderPlan, prepare, render
from tpurt.scene import configs


def _plan_for(scene, kind="bvh"):
    verts = np.asarray(scene.vertices)
    tris = np.asarray(scene.triangles)
    cs = build_clusters(verts, tris) if kind == "bvh" else build_grid(verts, tris).clusters
    return jnp.asarray(cs.tri_ids)


def test_clustered_matches_oracle_mesh():
    scene, cfg = configs.config4_bunny(32, 32, subdiv=2)
    tri_ids = _plan_for(scene)
    img = np.asarray(TV.render_rows_clustered(scene, cfg, tri_ids, 0, 32))
    ref = np.asarray(render_ref(scene, config=cfg))
    np.testing.assert_allclose(img, ref, atol=2e-4)


def test_clustered_matches_oracle_spheres_reflections():
    scene, cfg = configs.config3_spheres(32, 32)  # depth-2, 2 lights
    tri_ids = _plan_for(scene)
    img = np.asarray(TV.render_rows_clustered(scene, cfg, tri_ids, 0, 32))
    ref = np.asarray(render_ref(scene, config=cfg))
    np.testing.assert_allclose(img, ref, atol=2e-4)


def test_grid_accel_matches_oracle():
    scene, cfg = configs.config4_bunny(24, 24, subdiv=2)
    tri_ids = _plan_for(scene, kind="grid")
    img = np.asarray(TV.render_rows_clustered(scene, cfg, tri_ids, 0, 24))
    ref = np.asarray(render_ref(scene, config=cfg))
    np.testing.assert_allclose(img, ref, atol=2e-4)


def test_clustered_textured_config5():
    scene, cfg = configs.config5_multimesh(24, 32, n_blobs=2, subdiv=2)
    tri_ids = _plan_for(scene)
    img = np.asarray(TV.render_rows_clustered(scene, cfg, tri_ids, 0, 24))
    ref = np.asarray(render_ref(scene, config=cfg))
    np.testing.assert_allclose(img, ref, atol=2e-4)


def test_shadow_rebin_matches_in_kernel_shadows(monkeypatch):
    """Shadows traced over Morton-re-binned hit points (shadow_rebin=True,
    gated to large cluster counts) produce bit-identical occlusion to
    shadows traced over the pixel tiles — same ray construction and
    (T_MIN, dist − eps) band, different tiling.  Covers the textured
    mesh+sphere scene (two lights); the size gate is lowered so the test
    scene takes the re-binned path."""
    monkeypatch.setattr(TV, "SHADOW_REBIN_MIN_CLUSTERS", 0)
    scene, cfg = configs.config5_multimesh(24, 32, n_blobs=2, subdiv=2)
    tri_ids = _plan_for(scene)
    img_rb = np.asarray(TV.render_rows_clustered(scene, cfg, tri_ids, 0, 24))
    img_nk = np.asarray(
        TV.render_rows_clustered(
            scene, cfg.replace(shadow_rebin=False), tri_ids, 0, 24
        )
    )
    np.testing.assert_array_equal(img_rb, img_nk)


def test_clustered_gradients_match_oracle():
    scene, cfg = configs.config4_bunny(16, 16, subdiv=1)
    tri_ids = _plan_for(scene)

    def loss_c(s):
        return jnp.sum(TV.render_rows_clustered(s, cfg, tri_ids, 0, 16) ** 2)

    def loss_r(s):
        return jnp.sum(render_ref(s, config=cfg) ** 2)

    gc = jax.grad(loss_c, allow_int=True)(scene)
    gr = jax.grad(loss_r, allow_int=True)(scene)
    for f in ("vertices", "vnormals", "light_pos", "light_color"):
        a, b = np.asarray(getattr(gr, f)), np.asarray(getattr(gc, f))
        assert np.isfinite(b).all(), f
        np.testing.assert_allclose(b, a, atol=2e-4 * (np.abs(a).max() + 1e-6), err_msg=f)


def test_render_auto_routes_big_scene_through_clusters():
    scene, cfg = configs.config4_bunny(16, 16, subdiv=4)  # 5122 tris > phase1 cap
    plan = prepare(scene, cfg)
    assert plan.kind == "clusters"
    img = np.asarray(render(scene, cfg, plan=plan))
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()


def test_train_step_clustered_plan():
    from tpurt.dist import make_mesh, make_train_step

    scene, cfg = configs.config4_bunny(16, 16, subdiv=2)
    plan = RenderPlan(tri_ids=_plan_for(scene), kind="clusters")
    mesh = make_mesh(8)
    step = make_train_step(cfg, mesh, plan=plan)
    target = jnp.zeros((16, 16, 3), jnp.float32)
    s2, loss = step(scene, target, jnp.float32(1e-3))
    assert np.isfinite(float(loss))
    # vertices actually moved (grads flowed through refit + traversal)
    assert not np.allclose(np.asarray(s2.vertices), np.asarray(scene.vertices))


def test_wavefront_matches_multibounce_records_and_image():
    """Re-binned reflection bounces (wavefront) produce the same records +
    image as tracing them in their pixel tiles (config3: reflective
    spheres → live secondary rays through argsort binning)."""
    from tpurt.kernels.packc import pack_clusters

    scene, cfg = configs.config3_spheres(32, 32)
    tri_ids = _plan_for(scene)
    packed = pack_clusters(scene, tri_ids)

    ids_m, occ_m = TV.trace_records(scene, packed,
                                    cfg.replace(wavefront=False), 0, 32)
    ids_w, occ_w = TV.trace_records(scene, packed,
                                    cfg.replace(wavefront=True), 0, 32)
    np.testing.assert_array_equal(np.asarray(ids_w), np.asarray(ids_m))
    np.testing.assert_array_equal(np.asarray(occ_w), np.asarray(occ_m))

    img_w = np.asarray(
        TV.render_rows_clustered(scene, cfg.replace(wavefront=True), tri_ids, 0, 32)
    )
    img_m = np.asarray(
        TV.render_rows_clustered(scene, cfg.replace(wavefront=False), tri_ids, 0, 32)
    )
    np.testing.assert_allclose(img_w, img_m, atol=1e-6)


def test_kernel_records_match_oracle_records():
    """Record-level parity: the traversal's (ids, occ) equal
    records_oracle lane by lane, including -1/0 on dead paths."""
    from tpurt.core import geom
    from tpurt.kernels.packc import pack_clusters
    from tpurt.shading.deferred import records_oracle

    scene, cfg = configs.config3_spheres(32, 32)
    tri_ids = _plan_for(scene)
    packed = pack_clusters(scene, tri_ids)
    ids_w, occ_w = TV.trace_records(scene, packed, cfg, 0, 32)

    o, d = geom.generate_rays(scene.camera, 32, 32)
    recs = records_oracle(
        scene, o.reshape(-1, 3), d.reshape(-1, 3), cfg.max_depth, cfg.shadows
    )
    T = scene.n_tris
    miss = ids_w < 0
    is_tri = (~miss) & (ids_w < T)
    prim = jnp.where(miss, -1, jnp.where(is_tri, ids_w, ids_w - T))
    np.testing.assert_array_equal(np.asarray(prim), np.asarray(recs.prim))
    np.testing.assert_array_equal(np.asarray(occ_w), np.asarray(recs.occ))


def test_chunked_hit_points_shadow_equality(monkeypatch):
    """The (miss, pid)-sorted chunk-cond hit-geometry recompute feeding the
    shadow pass must produce occlusion bit-identical to the
    unchunked recompute — same formulas, same lanes, only skipped all-miss
    chunks differ (and those lanes are dead)."""
    from tpurt.shading import deferred as D

    scene, cfg = configs.config5_multimesh(16, 48, n_blobs=1, subdiv=3)
    cfg = cfg.replace(max_depth=1, shadow_rebin=True)
    tri_ids = _plan_for(scene)
    monkeypatch.setattr(TV, "SHADOW_REBIN_MIN_CLUSTERS", 0)

    def run():
        jax.clear_caches()
        from tpurt.kernels.packc import pack_clusters

        packed = pack_clusters(scene, tri_ids)
        ids, occ = TV.trace_records(scene, packed, cfg, 0, cfg.height)
        return np.asarray(ids), np.asarray(occ)

    monkeypatch.setattr(D, "SHADE_COMPACT", False)
    ids0, occ0 = run()
    monkeypatch.setattr(D, "SHADE_COMPACT", True)
    monkeypatch.setattr(D, "SHADE_COMPACT_MIN", 1)
    monkeypatch.setattr(D, "SHADE_CHUNKS", 4)
    ids1, occ1 = run()
    assert (ids0 == ids1).all()
    assert (occ0 == occ1).all()


# ---- the trace kernel against the oracle -----------------------------------
def _rays_and_packed(scene, h, w):
    from tpurt.kernels.packc import pack_clusters

    packed = pack_clusters(scene, _plan_for(scene))
    o, d, inside = TV._camera_tiles(scene.camera, h, w, 0, h)
    return packed, o, d, inside


def _oracle_shadow_segments(scene, o, d, inside, li=0):
    """Shadow segments of the first-hit points toward light li, exactly the
    oracle's construction (p_off origin, (T_MIN, dist − eps) band), and the
    oracle's own any-hit answer for them."""
    from tpurt import constants as C
    from tpurt.core import geom, vec
    from tpurt.shading.deferred import _hit_geometry

    rec = geom.closest_hit(scene, o, d)
    p, n, _ = _hit_geometry(scene, o, d, rec["t"], rec["prim"],
                            rec["is_tri"], rec["u"], rec["v"])
    p_off = p + n * C.RAY_OFFSET_EPS
    to_l = scene.light_pos[li] - p
    dist = vec.length(to_l)
    ldir = to_l / jnp.maximum(dist, 1e-20)[:, None]
    tmax = dist - C.RAY_OFFSET_EPS
    alive = inside & rec["hit"]
    return p_off, ldir, tmax, alive, geom.any_hit(scene, p_off, ldir, tmax)


_SCENES = {
    "mesh": lambda: configs.config4_bunny(16, 16, subdiv=3),
    "spheres": lambda: configs.config3_spheres(16, 16),
    "textured": lambda: configs.config5_multimesh(16, 24, n_blobs=2,
                                                  subdiv=2),
}


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("name", list(_SCENES))
def test_kernel_matches_oracle(name, mode):
    """The Triton trace kernel (interpret mode) equals the brute-force
    oracle: closest-hit ids lane by lane (t within 1e-5 relative), and the
    any-hit occlusion of the oracle's own shadow segments."""
    from tpurt.core import geom

    scene, cfg = _SCENES[name]()
    packed, o, d, inside = _rays_and_packed(scene, cfg.height, cfg.width)
    if mode == "closest":
        ids, t, _ = TV.trace_closest(packed, o, d, inside)
        rec = geom.closest_hit(scene, o, d)
        T = scene.n_tris
        hit = rec["hit"] & inside
        ref = jnp.where(hit, jnp.where(rec["is_tri"], rec["prim"],
                                       rec["prim"] + T), -1)
        np.testing.assert_array_equal(np.asarray(ids), np.asarray(ref))
        np.testing.assert_allclose(
            np.asarray(jnp.where(hit, t, 0.0)),
            np.asarray(jnp.where(hit, rec["t"], 0.0)), rtol=1e-5)
        assert int(jnp.sum(ids >= 0)) > 0
    else:
        q, ldir, tmax, alive, ref = _oracle_shadow_segments(
            scene, o, d, inside)
        occ, _ = TV.trace_any(packed, q, ldir, tmax, alive)
        np.testing.assert_array_equal(np.asarray(occ),
                                      np.asarray(ref & alive))
        assert int(jnp.sum(occ)) > 0


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_survivor_overflow_traces_exactly(monkeypatch, mode):
    """A tile whose survivors overflow the list capacity is traced against
    every cluster — exact, never truncated: with MAXS forced to 1 the
    results still equal the brute-force oracle, and the counts report
    overflow."""
    from tpurt.core import geom

    scene, cfg = configs.config4_bunny(16, 16, subdiv=3)
    packed, o, d, inside = _rays_and_packed(scene, 16, 16)
    monkeypatch.setattr(TV, "MAXS", 1)
    if mode == "closest":
        ids, _, cnt = TV.trace_closest(packed, o, d, inside)
        rec = geom.closest_hit(scene, o, d)
        ref = jnp.where(rec["hit"] & inside, rec["prim"], -1)
        np.testing.assert_array_equal(np.asarray(ids), np.asarray(ref))
    else:
        q, ldir, tmax, alive, ref = _oracle_shadow_segments(
            scene, o, d, inside)
        occ, cnt = TV.trace_any(packed, q, ldir, tmax, alive)
        np.testing.assert_array_equal(np.asarray(occ),
                                      np.asarray(ref & alive))
    assert int(jnp.sum(cnt > 1)) > 0          # some tiles overflowed


def test_kernel_refuses_platform_without_route(monkeypatch):
    """Interpret mode is chosen only on the CPU; the GPU compiles the
    kernel; any other platform raises instead of interpreting or handing
    off to a reference."""
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert TV._interpret() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert TV._interpret() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="no route"):
        TV._interpret()


def test_cull_keeps_every_hit_cluster():
    """The tile cull is conservative: every cluster holding a triangle some
    ray of the tile hits is on that tile's survivor list (or the tile
    overflowed and streams all clusters); traversal_stats reports the same
    counts per pass."""
    from tpurt.core import geom

    scene, cfg = configs.config4_bunny(16, 16, subdiv=3)
    packed, o, d, inside = _rays_and_packed(scene, 16, 16)
    tmax = jnp.full(inside.shape, 1e30, jnp.float32)
    slist, cnt = TV.cull(packed, o, d, tmax, inside)
    slist, cnt = np.asarray(slist), np.asarray(cnt)
    stats = TV.traversal_stats(scene, cfg, _plan_for(scene))
    np.testing.assert_array_equal(np.asarray(stats["closest.b0"]), cnt)
    assert set(stats) == {"closest.b0"} | {
        f"shadow.b0.light{li}" for li in range(scene.n_lights)}
    rec = geom.closest_hit(scene, o, d)
    prim = np.asarray(jnp.where(rec["hit"] & inside, rec["prim"], -1))
    gid = np.asarray(packed.gid)
    for r in np.nonzero(prim >= 0)[0]:
        tile = r // TV.RAYS
        if cnt[tile] > TV.MAXS:
            continue
        owners = set(np.nonzero((gid == prim[r]).any(axis=1))[0])
        assert owners & set(slist[tile, : cnt[tile]]), (r, prim[r])


def _chip_smoke():
    import importlib
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("name", ["mesh", "textured"])
def test_kernel_matches_plain_twin(name, mode):
    """The kernel (interpret mode) equals its plain-XLA brute-force twin
    (chip_smoke.brute_closest / brute_any: the same Baldwin–Weber math and
    (t, gid) minimum over every packed triangle) — the reference the card
    run holds the compiled kernel to."""
    cs = _chip_smoke()
    scene, cfg = _SCENES[name]()
    packed, o, d, inside = _rays_and_packed(scene, cfg.height, cfg.width)
    t_inf = jnp.full(inside.shape, 1e30, jnp.float32)
    if mode == "closest":
        ids, t, _ = TV.trace_closest(packed, o, d, inside)
        r_ids, r_t = cs.brute_closest(packed, o, d, t_inf, inside)
        np.testing.assert_array_equal(np.asarray(ids), np.asarray(r_ids))
        # t to 1e-5 relative: on the CPU the interpreted kernel and XLA's
        # fused loop may round the plane products differently (ulp-level);
        # on the GPU chip_smoke.py finds them bit-identical
        np.testing.assert_allclose(np.asarray(t), np.asarray(r_t), rtol=1e-5)
        assert cs.id_mismatches(np.asarray(ids), np.asarray(t),
                                np.asarray(r_ids), np.asarray(r_t)) == (0, 0, 0)
    else:
        q, ldir, tmax, alive, _ = _oracle_shadow_segments(scene, o, d, inside)
        occ, _ = TV.trace_any(packed, q, ldir, tmax, alive)
        ref = cs.brute_any(packed, q, ldir, tmax, alive)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))
        assert int(jnp.sum(occ)) > 0


def test_id_mismatch_rule_counts_ties_apart():
    """Hit ids may differ only on a tie (both hit, t within TIE_REL); a
    hit/miss flip or a hit at another t is a mismatch."""
    cs = _chip_smoke()
    ids = np.array([1, 2, 3, -1, 5, 6])
    ref = np.array([1, 9, 4, 7, -1, 6])
    t = np.array([1.0, 2.0, 3.0, 1e30, 5.0, 6.0])
    r_t = np.array([1.0, 2.0 * (1 + 1e-6), 3.5, 4.0, 1e30, 6.1])
    # 2 vs 9 tie; 3 vs 4 and both flips mismatch; 6 has t off
    assert cs.id_mismatches(ids, t, ref, r_t) == (3, 1, 1)


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle_on_gpu(gpu_device):
    """On the card: the compiled Triton kernel against the brute-force
    oracle — identical ids except on ties (both hit, t within 1e-5
    relative: two triangles sharing the edge the ray meets; the oracle's
    Möller–Trumbore and the kernel's Baldwin–Weber forms may assign the
    edge differently), and t within 1e-5 relative on every common hit."""
    from tpurt.core import geom

    cs = _chip_smoke()
    scene, cfg = configs.config4_bunny(64, 64, subdiv=4)
    with jax.default_device(gpu_device):
        scene = jax.device_put(scene, gpu_device)
        packed, o, d, inside = _rays_and_packed(scene, 64, 64)
        ids, t, _ = TV.trace_closest(packed, o, d, inside)
        rec = geom.closest_hit(scene, o, d)
    hit = np.asarray(rec["hit"] & inside)
    ref = np.where(hit, np.asarray(rec["prim"]), -1)
    ref_t = np.where(hit, np.asarray(rec["t"]), 1e30)
    bad, _, t_off = cs.id_mismatches(np.asarray(ids), np.asarray(t), ref,
                                     ref_t)
    assert (bad, t_off) == (0, 0)
