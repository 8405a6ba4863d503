"""Phase-1 path parity vs the frozen oracle (SURVEY.md §4 items 1–2).

Plain jnp (tpurt/kernels/phase1.py), the same program on CPU and GPU.
Image parity is elementwise; gradient parity covers every
BASELINE.json:5 target: vertices, normals (via smooth configs), material
albedo/specular, light parameters, plus camera.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.kernels import phase1 as P1
from tpurt.ref import render_ref
from tpurt.scene import configs

CASES = {
    "config1": lambda: configs.config1_sphere(24, 24),
    "config2": lambda: configs.config2_cornell(24, 24),
    "config3": lambda: configs.config3_spheres(24, 24),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_parity(name):
    scene, cfg = CASES[name]()
    ref = np.asarray(render_ref(scene, config=cfg))
    img = np.asarray(P1.render_phase1(scene, cfg))
    np.testing.assert_allclose(img, ref, atol=2e-4)


def test_forward_parity_bigger_image_odd_size():
    scene, cfg = configs.config3_spheres(40, 56)  # n_pix not a tile multiple
    ref = np.asarray(render_ref(scene, config=cfg))
    img = np.asarray(P1.render_phase1(scene, cfg))
    np.testing.assert_allclose(img, ref, atol=2e-4)


def test_forward_parity_smooth_mesh():
    scene, cfg = configs.config4_bunny(24, 24, subdiv=2)  # 320 tris, smooth
    ref = np.asarray(render_ref(scene, config=cfg))
    img = np.asarray(P1.render_phase1(scene, cfg))
    np.testing.assert_allclose(img, ref, atol=2e-4)


def _grads(render_fn, scene, cfg):
    def loss(s):
        return jnp.sum(render_fn(s, cfg) ** 2)

    return jax.grad(loss, allow_int=True)(scene)


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_gradient_parity(name):
    scene, cfg = CASES[name]()
    g_ref = _grads(lambda s, c: render_ref(s, config=c), scene, cfg)
    g_pal = _grads(lambda s, c: P1.render_phase1(s, c), scene, cfg)

    def check(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all(), what
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b, a, atol=2e-3 * scale, err_msg=what)

    check(g_ref.light_color, g_pal.light_color, "light_color")
    check(g_ref.light_pos, g_pal.light_pos, "light_pos")
    check(g_ref.sph_center, g_pal.sph_center, "sph_center")
    check(g_ref.sph_radius, g_pal.sph_radius, "sph_radius")
    check(g_ref.vertices, g_pal.vertices, "vertices")
    check(g_ref.camera.eye, g_pal.camera.eye, "camera.eye")
    for f in ("ka", "kd", "ks", "shininess", "reflectivity"):
        check(
            getattr(g_ref.materials, f), getattr(g_pal.materials, f), f"mat.{f}"
        )


def test_gradient_parity_vertex_normals_smooth():
    scene, cfg = configs.config4_bunny(16, 16, subdiv=1)
    g_ref = _grads(lambda s, c: render_ref(s, config=c), scene, cfg)
    g_pal = _grads(lambda s, c: P1.render_phase1(s, c), scene, cfg)
    for f in ("vertices", "vnormals"):
        a, b = np.asarray(getattr(g_ref, f)), np.asarray(getattr(g_pal, f))
        assert np.isfinite(b).all()
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b, a, atol=2e-3 * scale, err_msg=f)


def test_supports_gate():
    scene, cfg = configs.config1_sphere(16, 16)
    assert P1.supports(scene, cfg)
    scene5, cfg5 = configs.config5_multimesh(16, 16, n_blobs=1, subdiv=1)
    assert not P1.supports(scene5, cfg5)  # textured → phase-1 declines


def test_render_auto_dispatches_pallas():
    from tpurt.render import _resolve_backend

    scene, cfg = configs.config1_sphere(16, 16)
    assert _resolve_backend(cfg, scene) == "phase1"
    scene5, cfg5 = configs.config5_multimesh(16, 16, n_blobs=1, subdiv=1)
    assert _resolve_backend(cfg5, scene5) == "oracle"


def test_fused_l2_train_kernel_matches_generic():
    """The phase-1 train step (make_train_step: mean L2 loss, gradients by
    autodiff of the plain path, SGD update) must equal the generic
    render_and_grad objective on loss and every float leaf."""
    from tpurt.dist import make_train_step
    from tpurt.dist.train import sgd_update
    from tpurt.render import render_and_grad

    for build in (configs.config1_sphere, configs.config3_spheres):
        scene, cfg = build(24, 24)
        target = jax.random.uniform(jax.random.PRNGKey(1),
                                    (cfg.height, cfg.width, 3))
        lr = jnp.float32(0.1)
        s_f, loss_f = make_train_step(cfg)(scene, target, lr)

        (loss_g, _), g_g = render_and_grad(
            scene, lambda im: jnp.mean((im - target) ** 2), cfg)
        s_g = sgd_update(scene, g_g, lr)
        np.testing.assert_allclose(float(loss_f), float(loss_g), rtol=1e-5)
        for la, lb in zip(jax.tree_util.tree_leaves(s_f),
                          jax.tree_util.tree_leaves(s_g)):
            a, b = np.asarray(la), np.asarray(lb)
            if not np.issubdtype(a.dtype, np.floating):
                continue
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_phase1_tiles_match_oracle(monkeypatch, name):
    """Many narrow tiles and a row offset: the mapped, checkpointed tiles
    reassemble the oracle's slab exactly where tiles end mid-row, and the
    gradients summed over tiles match the oracle's."""
    from tpurt.ref import oracle
    from tpurt.core import geom

    monkeypatch.setattr(P1, "RAYS", 128)
    scene, cfg = CASES[name]()
    row0, nrows = 5, 13

    def slab_ref(s):
        o, d = geom.generate_rays(s.camera, cfg.height, cfg.width, row0,
                                  nrows)
        c = oracle.trace_rays(s, o.reshape(-1, 3), d.reshape(-1, 3),
                              cfg.max_depth, cfg.shadows)
        return c.reshape(nrows, cfg.width, 3)

    def slab_p1(s):
        return P1.render_rows_phase1(s, cfg, row0, nrows)

    np.testing.assert_allclose(np.asarray(slab_p1(scene)),
                               np.asarray(slab_ref(scene)), atol=2e-4)
    g_ref = jax.grad(lambda s: jnp.sum(slab_ref(s) ** 2),
                     allow_int=True)(scene)
    g_p1 = jax.grad(lambda s: jnp.sum(slab_p1(s) ** 2),
                    allow_int=True)(scene)
    for leaf in ("light_color", "vertices", "sph_center"):
        a = np.asarray(getattr(g_ref, leaf))
        b = np.asarray(getattr(g_p1, leaf))
        assert np.isfinite(b).all(), leaf
        np.testing.assert_allclose(
            b, a, atol=2e-3 * (np.abs(a).max() + 1e-6), err_msg=leaf)
