"""Public render API: `prepare`, `render`, `render_and_grad`.

The reference's host render loop (SURVEY.md §3a Entry 2: set kernel args →
clEnqueueNDRangeKernel → readback, [ARCHETYPE]) becomes one jit-compiled
XLA program; buffer management, fusion and scheduling belong to the
compiler.

Backends:
  "oracle" — the brute-force pure-jnp path (tpurt.ref), jitted.  Correct for
             any scene; cost O(pixels × primitives).
  "phase1" — small untextured scenes, every primitive against every ray
             (tpurt/kernels/phase1.py).
  "auto"   — phase1 when the scene qualifies, else oracle (prepare() routes
             big and textured scenes to cluster traversal).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpurt import constants as C
from tpurt.core import geom
from tpurt.core.types import RenderConfig
from tpurt.ref import oracle


from tpurt.core.types import pytree_dataclass
from typing import Any


@pytree_dataclass(meta_fields=("kind", "depth_cap"))
class RenderPlan:
    """Prepared acceleration state for a scene (host-built, jit-carriable).

    kind: "phase1"   — small-scene path, tri_ids unused
          "clusters" — cluster traversal + deferred shading; tri_ids is
                       the frozen (C, 128) cluster topology (AABBs refit
                       from live vertices inside jit)
          "oracle"   — brute force jnp
    depth_cap: static max depth any path can reach (None = config's).
          prepare() sets 0 when no material reflects: every path dies at
          the primary hit, so bounce passes and shading layers are not
          even compiled.
    """

    tri_ids: Any
    kind: str
    depth_cap: Any = None


def prepare(scene, config: RenderConfig | None = None, accel=None) -> RenderPlan:
    """Build the render plan for `scene` (host-side; scene must be concrete).

    Train loops call this once on the template scene and pass the plan to
    render()/make_train_step() so the jitted step never needs host work.
    `accel` overrides config.accel ("bvh" | "grid").
    """
    import jax.numpy as jnp
    import numpy as np

    config = config or RenderConfig()
    accel = accel or config.accel
    from tpurt.kernels import phase1

    if accel == "none":
        # no acceleration structure: brute-force oracle path
        return RenderPlan(tri_ids=None, kind="oracle")
    if phase1.supports(scene, config) and accel == "auto":
        return RenderPlan(tri_ids=None, kind="phase1")
    if isinstance(scene.vertices, jax.core.Tracer) and getattr(
        scene, "host_mesh", None
    ) is None:
        raise ValueError(
            "prepare() needs concrete scene geometry to build acceleration "
            "structures, but the scene is traced (inside jit/grad) and has "
            "no host-side mesh stash. Call prepare() once on the template "
            "scene outside jit and pass the plan to render()/make_train_step()."
        )
    # everything else — big scenes AND textured scenes of any size — goes
    # through cluster traversal + deferred shading (textures are sampled in
    # the deferred pass)
    from tpurt.accel.native import build_clusters_native, build_grid_native

    host = getattr(scene, "host_mesh", None)
    if host is not None:
        verts, tris = host
    else:
        verts = np.asarray(scene.vertices)
        tris = np.asarray(scene.triangles)
    # native C++ builders (tpurt/native) with a numpy fallback
    if accel == "grid":
        cs = build_grid_native(verts, tris)
    else:
        cs = build_clusters_native(verts, tris)
    # static depth cap: concrete material table + no reflective entries ⇒
    # no path survives depth 0 (conservative None when traced)
    depth_cap = None
    refl = scene.materials.reflectivity
    if not isinstance(refl, jax.core.Tracer) and not bool(
        jnp.any(refl > 0.0)
    ):
        depth_cap = 0
    return RenderPlan(tri_ids=jnp.asarray(cs.tri_ids), kind="clusters",
                      depth_cap=depth_cap)


def cap_depth(config: RenderConfig, plan) -> RenderConfig:
    """Apply the plan's static depth cap (see RenderPlan.depth_cap).

    Image-identical: capped depths are exactly the ones no path reaches
    (their throughput is zero in the oracle too)."""
    cap = getattr(plan, "depth_cap", None)
    if cap is not None and config.max_depth > cap:
        return config.replace(max_depth=cap)
    return config


def _resolve_backend(config: RenderConfig, scene=None) -> str:
    backend = config.backend
    if backend == "auto":
        from tpurt.kernels import phase1

        if scene is None or phase1.supports(scene, config):
            backend = "phase1"
        else:
            backend = "oracle"
    return backend


@partial(jax.jit, static_argnames=("config",))
def _render_oracle(scene, config: RenderConfig):
    # chunk size scales inversely with primitive count so the brute-force
    # (pixels × primitives) intermediates stay bounded (~40 MB) at any
    # scene size — the oracle must remain runnable as the parity tier
    prims = max(scene.n_tris + scene.n_spheres, 1)
    chunk = int(max(256, min(8192, (1 << 22) // prims)))
    return oracle.render_ref(scene, config=config, chunk=chunk)


def render(scene, config: RenderConfig | None = None, plan: RenderPlan | None = None,
           **overrides):
    """Render `scene` to an (H, W, 3) float32 image in [0, 1].

    `config` defaults to RenderConfig(); keyword overrides are applied on
    top (e.g. ``render(scene, width=1920, height=1080)``).  `plan` carries
    prepared acceleration state (see prepare()); without one, small scenes
    take the phase-1 path and big scenes build clusters on the host
    (requires a concrete, untraced scene).
    """
    config = (config or RenderConfig()).replace(**overrides) if overrides else (
        config or RenderConfig()
    )
    if plan is None:
        from tpurt.kernels import phase1

        if config.backend == "oracle":
            return _render_oracle(scene, config)
        if phase1.supports(scene, config) and config.accel == "auto":
            return _render_phase1_jit(scene, config)
        plan = prepare(scene, config)   # host build — scene must be concrete
    if plan.kind == "phase1":
        return _render_phase1_jit(scene, config)
    if plan.kind == "clusters":
        return _render_clustered_jit(scene, plan.tri_ids,
                                     cap_depth(config, plan))
    return _render_oracle(scene, config)


@partial(jax.jit, static_argnames=("config",))
def _render_phase1_jit(scene, config: RenderConfig):
    from tpurt.kernels import phase1

    return phase1.render_phase1(scene, config)


@partial(jax.jit, static_argnames=("config",))
def _render_clustered_jit(scene, tri_ids, config: RenderConfig):
    from tpurt.kernels import traversal

    return traversal.render_rows_clustered(scene, config, tri_ids, 0, config.height)


def render_and_grad(scene, loss_fn, config: RenderConfig | None = None,
                    plan: RenderPlan | None = None, **overrides):
    """Render and differentiate: returns ((loss, image), grads) where grads
    is a Scene-pytree cotangent (int/index leaves are None).

    `loss_fn(image) -> scalar`.  Gradients flow to every float leaf of the
    scene — vertices, normals, albedo/specular, light params
    (BASELINE.json:5) — at fixed hit topology.
    """
    config = (config or RenderConfig()).replace(**overrides) if overrides else (
        config or RenderConfig()
    )
    if plan is None:
        plan = prepare(scene, config)

    def wrapped(s):
        img = render(s, config, plan=plan)
        return loss_fn(img), img

    (loss, img), grads = jax.value_and_grad(wrapped, has_aux=True, allow_int=True)(
        scene
    )
    return (loss, img), grads
