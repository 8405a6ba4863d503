"""Distributed tile-parallel tests on the 8-virtual-CPU-device mesh
(SURVEY.md §4 item 4): sharded == single-device, grads psum correctly,
the full training step runs, and the driver entry points work."""
import jax
import jax.numpy as jnp
import numpy as np

from tpurt.dist import make_mesh, make_train_step, render_sharded
from tpurt.render import render, render_and_grad
from tpurt.scene import configs


def test_sharded_matches_single_device():
    scene, cfg = configs.config3_spheres(32, 32)
    cfg = cfg.replace(max_depth=1)
    img1 = np.asarray(render(scene, cfg))
    mesh = make_mesh(8)
    img8 = np.asarray(render_sharded(scene, cfg, mesh))
    np.testing.assert_allclose(img1, img8, atol=2e-6)


def test_sharded_various_mesh_sizes():
    scene, cfg = configs.config1_sphere(24, 24)
    ref = np.asarray(render(scene, cfg))
    for n in (1, 2, 4):
        mesh = make_mesh(n)
        out = np.asarray(render_sharded(scene, cfg, mesh))
        np.testing.assert_allclose(ref, out, atol=2e-6)


def test_sharded_grads_match_single_device():
    scene, cfg = configs.config2_cornell(16, 16)
    mesh = make_mesh(8)

    def loss_single(lc):
        import dataclasses

        s = dataclasses.replace(scene, light_color=lc)
        return jnp.sum(render(s, cfg))

    def loss_sharded(lc):
        import dataclasses

        s = dataclasses.replace(scene, light_color=lc)
        return jnp.sum(render_sharded(s, cfg, mesh))

    g1 = np.asarray(jax.grad(loss_single)(scene.light_color))
    g8 = np.asarray(jax.grad(loss_sharded)(scene.light_color))
    np.testing.assert_allclose(g1, g8, rtol=1e-5, atol=1e-5)


def test_train_step_reduces_loss():
    scene, cfg = configs.config1_sphere(16, 16)
    mesh = make_mesh(8)
    step = make_train_step(cfg, mesh)
    # target: the same scene with dimmer light — recoverable by sgd
    import dataclasses

    target_scene = dataclasses.replace(scene, light_color=scene.light_color * 0.5)
    target = render(target_scene, cfg)
    losses = []
    s = scene
    for _ in range(5):
        s, loss = step(s, target, jnp.float32(0.5))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_graft_entry_single():
    import __graft_entry__ as ge

    fn, example_args = ge.entry()
    out = jax.jit(fn)(*example_args)
    assert out.shape == (256, 256, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_scene_sharded_ring_matches_replicated():
    """Scene sharding v2 (SURVEY.md §5 axis b): cluster blocks AND shading
    tables sharded over the mesh + ring ray exchange must reproduce the
    replicated render of the (renumbered) scene.  Interpret-mode pallas
    inside shard_map is slow, so the case is tiny: mesh 2, one bounce,
    shadows on (exercises the shadow ring too)."""
    import numpy as np

    from tpurt.accel import build_clusters
    from tpurt.dist import (make_mesh, render_scene_sharded,
                            renumber_by_clusters)
    from tpurt.scene import configs

    scene, cfg = configs.config4_bunny(8, 8, subdiv=2)
    cfg = cfg.replace(max_depth=0)
    cs = build_clusters(np.asarray(scene.vertices), np.asarray(scene.triangles))
    # compare on the renumbered scene: the ring renumbers internally, and
    # the replicated reference must share the numbering (exact-t ties
    # between different tris resolve by gid)
    scene, tri_ids = renumber_by_clusters(scene, jnp.asarray(cs.tri_ids))

    from tpurt.kernels.traversal import render_rows_clustered

    ref = np.asarray(render_rows_clustered(scene, cfg, tri_ids, 0, 8))
    mesh = make_mesh(2)
    img = np.asarray(render_scene_sharded(scene, cfg, tri_ids, mesh))
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_scene_sharded_reflective_and_grads():
    """Ring exchange with live secondary rays (reflective spheres, duplicate
    pad clusters across 4 shards) + grads flow through the ring-fetched
    shading rows with psum'd scene cotangents (prepared API under grad)."""
    import numpy as np

    from tpurt.accel import build_clusters
    from tpurt.dist import (make_mesh, prepare_scene_sharded,
                            render_scene_sharded_prepared)
    from tpurt.scene import configs

    scene, cfg = configs.config3_spheres(8, 8)
    cfg = cfg.replace(max_depth=1, shadows=False)
    cs = build_clusters(np.asarray(scene.vertices), np.asarray(scene.triangles))
    mesh = make_mesh(4)
    scene2, parts = prepare_scene_sharded(scene, jnp.asarray(cs.tri_ids), 4)

    from tpurt.kernels.traversal import render_rows_clustered

    # per-device triangle-derived bytes shrink ~1/n (VERDICT r2 item 4c):
    # each shard's cluster slice is C/n and its triangle slice ≈ T/n
    tloc, tri_sh, _, _, cnts, widx, T_global = parts
    assert T_global == scene.n_tris
    assert tloc.shape[1] == -(-cs.tri_ids.shape[0] // 4)
    assert tri_sh.shape[1] <= -(-scene.n_tris // 4) + 128  # +1 cluster slack
    assert int(jnp.sum(cnts)) == scene.n_tris  # disjoint cover
    # v3: the vertex table ships sharded — corners are local to the window
    assert int(jnp.max(tri_sh)) < widx.shape[1]
    assert int(jnp.min(tri_sh)) >= 0

    # replicated reference on the SAME renumbered scene
    from tpurt.dist import renumber_by_clusters

    scene_r, tri_idsr = renumber_by_clusters(scene, jnp.asarray(cs.tri_ids))
    ref = np.asarray(render_rows_clustered(scene_r, cfg, tri_idsr, 0, 8))
    # topology is exactly equal (integer records); shading under shard_map
    # fuses differently -> ulp-level fp differences
    img = np.asarray(render_scene_sharded_prepared(scene2, cfg, parts, mesh))
    np.testing.assert_allclose(img, ref, atol=1e-5)

    def loss(s):
        return jnp.sum(
            render_scene_sharded_prepared(s, cfg, parts, mesh) ** 2)

    g = jax.grad(loss, allow_int=True)(scene2)
    for f in ("light_color", "sph_center", "vertices"):
        a = np.asarray(getattr(g, f))
        assert np.isfinite(a).all() and np.abs(a).sum() > 0, f
    # ring-fetched rows must carry vertex grads back to the owning shard:
    # compare against the replicated clustered path's gradients (same
    # renumbered scene, same topology -> allclose up to scatter order)
    from tpurt.render import RenderPlan, render_and_grad

    plan = RenderPlan(tri_ids=tri_idsr, kind="clusters")
    (_, _), g_ref = render_and_grad(
        scene_r, lambda im: jnp.sum(im**2), cfg, plan=plan)
    for f in ("light_color", "sph_center", "vertices"):
        a = np.asarray(getattr(g_ref, f))
        b = np.asarray(getattr(g, f))
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(a).max()),
            err_msg=f)


# ---------------------------------------------------------------------------
# failure detection / resumable rendering (SURVEY.md §5 failure-detection row)
# ---------------------------------------------------------------------------
def test_render_resumable_crash_and_resume(tmp_path):
    """Injected crash mid-render; a rerun with the same out_dir completes
    from the manifest and matches the direct render exactly."""
    import pytest

    from tpurt.dist import render_resumable

    scene, cfg = configs.config3_spheres(32, 32)
    direct = np.asarray(render(scene, cfg))
    out = str(tmp_path / "resume")
    with pytest.raises(RuntimeError, match="injected"):
        render_resumable(scene, cfg, out, chunk_rows=8, _fail_after=2)
    # exactly 2 of 4 chunks persisted
    import json as _json

    with open(out + "/manifest.json") as f:
        assert len(_json.load(f)["chunks"]) == 2
    img = render_resumable(scene, cfg, out, chunk_rows=8)
    # chunked slabs re-tile the phase-1 pixel tiles: reassociation-level diffs
    np.testing.assert_allclose(img, direct, atol=5e-6)


def test_render_resumable_sharded_chunks(tmp_path):
    """Chunks routed through render_sharded over the 8-device mesh match
    the single-device render (window sharding + padding rows crop)."""
    from tpurt.dist import render_resumable

    scene, cfg = configs.config3_spheres(36, 32)  # 36 rows: ragged chunks
    direct = np.asarray(render(scene, cfg))
    mesh = make_mesh(8)
    img = render_resumable(
        scene, cfg, str(tmp_path / "shard"), chunk_rows=16, mesh=mesh
    )
    np.testing.assert_allclose(img, direct, atol=2e-6)


def test_watchdog_and_retries():
    import time as _time

    import pytest

    from tpurt.dist import Watchdog, WatchdogTimeout, call_with_retries

    wd = Watchdog(0.2)
    assert wd.run(lambda: 7) == 7
    with pytest.raises(WatchdogTimeout):
        wd.run(_time.sleep, 5.0)

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient")
        return "ok"

    assert call_with_retries(flaky, retries=3, backoff_s=0.01) == "ok"
    assert len(calls) == 3
    # WatchdogTimeout is never retried (device wedged)
    with pytest.raises(WatchdogTimeout):
        call_with_retries(
            lambda: (_ for _ in ()).throw(WatchdogTimeout("x")), retries=3
        )


def test_heartbeat_mesh_roundtrip():
    from tpurt.dist import heartbeat

    rtt = heartbeat(make_mesh(8), timeout_s=120.0)
    assert rtt > 0.0


def test_scene_shard_vertex_windows_scale():
    """v3 memory scaling: each shard's vertex gather list (the slice of
    the vertex table it actually receives) is ~V/n + boundary overlap —
    not O(V).  Host-side check on a real connected mesh."""
    import numpy as np

    from tpurt.accel import build_clusters
    from tpurt.dist.scene_shard import (renumber_by_clusters,
                                        shard_scene_clusters)
    from tpurt.scene import configs

    scene, _cfg = configs.config4_bunny(16, 16, subdiv=4)
    cs = build_clusters(np.asarray(scene.vertices),
                        np.asarray(scene.triangles))
    scene2, tri_ids2 = renumber_by_clusters(scene, jnp.asarray(cs.tri_ids))
    n = 4
    _tloc, tri_sh, _tmat, _t0s, _cnts, widx, _tmax = shard_scene_clusters(
        scene2, tri_ids2, n)
    V = scene2.vertices.shape[0]
    Vmax = widx.shape[1]
    # tight windows: well under half the table per shard (ideal is ~V/4;
    # boundary overlap adds a fringe)
    assert Vmax < 0.5 * V, (Vmax, V)
    # every local corner resolves inside the window
    assert int(jnp.max(tri_sh)) < Vmax and int(jnp.min(tri_sh)) >= 0


def test_ring_train_step_reduces_loss():
    """The scene-sharded (>HBM) training step: L2 loss on the ring render
    with gradients through the sharded vertex table — loss must fall under
    SGD and stay finite (the train() analogue for scenes too big to
    replicate)."""
    import numpy as np

    from tpurt.accel import build_clusters
    from tpurt.dist import (make_mesh, make_ring_train_step,
                            prepare_scene_sharded)
    from tpurt.scene import configs

    scene, cfg = configs.config3_spheres(8, 8)
    cfg = cfg.replace(max_depth=0, shadows=False)
    cs = build_clusters(np.asarray(scene.vertices),
                        np.asarray(scene.triangles))
    mesh = make_mesh(4)
    scene2, parts = prepare_scene_sharded(scene, jnp.asarray(cs.tri_ids), 4)
    step = make_ring_train_step(cfg, mesh, parts)
    target = jnp.zeros((8, 8, 3), jnp.float32)
    losses = []
    s = scene2
    for _ in range(3):
        s, loss = step(s, target, jnp.float32(0.05))
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_sharded_grads_with_segsum_and_remat(monkeypatch):
    """The backward machinery (one scatter-add vertex accumulation +
    compacted-shading chunk remat) must compose with shard_map tile
    parallelism: on several cards this is the production fwdbwd graph, so
    the combination is pinned on the 8-device CPU mesh (forced flags — the
    test scenes are below the auto gates)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpurt.render import prepare
    from tpurt.scene import configs
    from tpurt.shading import deferred as D

    monkeypatch.setattr(D, "_PACK_DIRECT_ENV", "1")  # the vtab scatter
    monkeypatch.setattr(D, "SHADE_COMPACT", True)
    monkeypatch.setattr(D, "SHADE_COMPACT_MIN", 1)
    scene, cfg = configs.config4_bunny(32, 32, subdiv=3)
    plan = prepare(scene, cfg, accel="bvh")
    mesh = make_mesh(8)

    def loss(s):
        return jnp.sum(render_sharded(s, cfg, mesh, plan=plan) ** 2)

    g = jax.jit(jax.grad(loss, allow_int=True))(scene)
    gv = np.asarray(g.vertices)
    assert np.isfinite(gv).all() and np.abs(gv).max() > 0.0
