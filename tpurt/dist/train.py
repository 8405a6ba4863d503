"""Inverse-rendering training step: the framework's "train()" analogue.

The reference has no training loop (forward renderer only, SURVEY.md §3a);
differentiability is a new-build requirement (BASELINE.json:5).  The
canonical optimization demo — and the program `__graft_entry__.
dryrun_multichip` compiles over the device mesh — is gradient descent of a
pixel L2 loss against a target image, with gradients flowing to every float
scene parameter and all-reduced across the tile mesh by the psum autodiff
inserts for the replicated scene.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tpurt.core.types import RenderConfig
from tpurt.dist.shard import TILE_AXIS, render_sharded


def sgd_update(scene, grads, lr):
    """SGD on every float leaf of the scene; int/index leaves pass through.
    (orbax/npz checkpointing of this pytree: tpurt.utils.checkpoint.)"""

    def upd(p, g):
        if g is None or not jnp.issubdtype(jnp.asarray(p).dtype, jnp.floating):
            return p
        g = jnp.asarray(g)
        if g.dtype == jax.dtypes.float0:  # int-leaf cotangent
            return p
        return p - lr * g

    return jax.tree_util.tree_map(upd, scene, grads)


def make_ring_train_step(config: RenderConfig, mesh, parts,
                         axis: str = TILE_AXIS):
    """Train step for scene-sharded (>HBM) scenes: L2 loss on the RING
    render (cluster blocks, shading tables and the vertex table all
    sharded over the mesh — dist/scene_shard.py v3), gradients to every
    float leaf of the renumbered scene.  `parts` comes from
    prepare_scene_sharded (host, once); pass the renumbered scene2 it
    returns (or any same-topology update of it) as the step's scene."""
    from tpurt.dist.scene_shard import render_scene_sharded_prepared

    def loss_fn(scene2, target):
        img = render_scene_sharded_prepared(scene2, config, parts, mesh,
                                            axis)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(scene2, target, lr):
        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(
            scene2, target)
        return sgd_update(scene2, grads, lr), loss

    return step


def make_train_step(config: RenderConfig, mesh=None, axis: str = TILE_AXIS,
                    plan=None):
    """Build a jitted train step `(scene, target, lr) -> (scene', loss)`.

    `mesh=None` renders single-device; with a mesh, rendering is
    tile-parallel via shard_map and scene-parameter gradients are globally
    correct (psum over the mesh).  `plan` (see tpurt.render.prepare) routes
    big scenes through cluster traversal; build it once from the template
    scene — cluster AABBs refit from live vertices inside the jitted step.
    """

    def loss_fn(scene, target):
        if mesh is None:
            from tpurt.render import render

            img = render(scene, config, plan=plan)
        else:
            img = render_sharded(scene, config, mesh, axis, plan=plan)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(scene, target, lr):
        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(scene, target)
        return sgd_update(scene, grads, lr), loss

    return step
