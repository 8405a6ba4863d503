"""Tile-parallel distributed rendering over a jax.sharding.Mesh.

The reference is single-device / single-process with zero inter-device
communication (SURVEY.md §2b [ARCHETYPE]); this module is the new build's
first-class scaling layer (BASELINE.json:5): the image is split into
horizontal row-slabs, one per device, via `shard_map`; the scene is
replicated (dist/scene_shard.py shards scenes larger than one device).
Gradients of replicated scene parameters are all-reduced by the `psum` XLA
inserts when differentiating through shard_map; XLA hands the collectives
to NCCL on the GPU.

Multi-host: every host runs the same program on the same global mesh
(jax.distributed.initialize() in the CLI); nothing here is host-count aware.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tpurt.core import geom
from tpurt.core.types import RenderConfig
from tpurt.ref import oracle

TILE_AXIS = "tiles"


def make_mesh(n_devices: int | None = None, axis: str = TILE_AXIS) -> Mesh:
    """1-D device mesh over the first `n_devices` (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def render_rows(scene, config: RenderConfig, row0, nrows: int, plan=None):
    """Render a horizontal slab [row0, row0+nrows) of the full image.

    The single-device building block shared by every parallel layout; row0
    may be a traced value (device-dependent), nrows is static.  Dispatches
    to the phase-1 path, cluster traversal, or the oracle.
    """
    from tpurt.render import _resolve_backend

    if plan is not None and plan.kind == "clusters":
        from tpurt.kernels import traversal
        from tpurt.render import cap_depth

        return traversal.render_rows_clustered(
            scene, cap_depth(config, plan), plan.tri_ids, row0, nrows)
    backend = _resolve_backend(config, scene)
    if backend == "phase1":
        from tpurt.kernels import phase1

        return phase1.render_rows_phase1(scene, config, row0, nrows)
    if config.backend != "oracle":
        from tpurt.kernels import phase1

        if not phase1.supports(scene, config):
            # a big/textured scene without a prepared plan would silently
            # brute-force O(pixels × primitives); that is never intended
            raise ValueError(
                f"scene with {scene.n_tris} tris (textured={scene.textured}) "
                "needs a prepared acceleration plan for sharded rendering: "
                "call tpurt.render.prepare(scene, config) outside jit and "
                "pass plan=, or set config.backend='oracle' explicitly."
            )
    o, d = geom.generate_rays(scene.camera, config.height, config.width, row0, nrows)
    colors = oracle.trace_rays(
        scene,
        o.reshape(-1, 3),
        d.reshape(-1, 3),
        max_depth=config.max_depth,
        shadows=config.shadows,
    )
    return colors.reshape(nrows, config.width, 3)


def _rows_per_device(height: int, n: int) -> int:
    """Rows per device, rounding up: heights that do not divide the mesh
    (1080p on 16 devices) render ceil(H/n) rows per device and the sharded
    image is cropped back to H — out-of-image rows are masked/ignored by
    every backend (BASELINE.json:2 targets arbitrary N-host scaling)."""
    return -(-height // n)


@partial(jax.jit, static_argnames=("config", "mesh", "axis", "nrows"))
def render_sharded(scene, config: RenderConfig, mesh: Mesh, axis: str = TILE_AXIS,
                   plan=None, row0: int = 0, nrows: int | None = None):
    """Render rows [row0, row0+nrows) (default: the full image)
    tile-parallel over `mesh`.

    Scene (and plan) replicated, image row-sharded across `axis`.  Pixel-
    identical to the single-device render (each slab computes NDC against
    the full image height) — the determinism property SURVEY.md §4 item 4
    tests.  The row window lets resumable/chunked rendering
    (dist/failsafe.py) shard each chunk over the same mesh; `row0` is
    TRACED (every backend takes it as a device scalar) so chunks at
    different offsets share one compilation.
    """
    n = mesh.shape[axis]
    total = config.height if nrows is None else nrows
    per = _rows_per_device(total, n)

    def tile_fn(s, p):
        r0 = row0 + lax.axis_index(axis) * per
        return render_rows(s, config, r0, per, plan=p)

    full = jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(axis, None, None),
        # pallas_call out_shapes carry no varying-mesh-axes annotation;
        # skip the vma check (correctness is covered by the sharded-vs-
        # single-device parity tests)
        check_vma=False,
    )(scene, plan)
    # crop padding rows when the window does not divide the mesh size
    return full[:total]
