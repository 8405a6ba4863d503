"""Core typed containers: pytree dataclass helper, Ray bundle, RenderConfig.

Replaces the reference's host-side structs (SURVEY.md §2 rows R11/R13,
[ARCHETYPE]) with JAX pytrees: static metadata rides in `meta_fields` so a
config change retraces, while arrays flow through jit/grad/shard_map.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax


def pytree_dataclass(cls=None, *, meta_fields: tuple = ()):
    """Dataclass registered as a JAX pytree; `meta_fields` are static."""

    def wrap(c):
        c = dataclasses.dataclass(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        )
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=tuple(meta_fields)
        )
        return c

    return wrap if cls is None else wrap(cls)


@pytree_dataclass
class Rays:
    """A bundle of rays, SoA: origins (..., 3), directions (..., 3).

    Directions are expected to be unit length (ray-gen normalizes); `t` values
    everywhere in the framework are metric distances under that convention.
    """

    o: Any
    d: Any


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) render options — a jit static argument.

    Mirrors the reference's hardcoded constants/argv (SURVEY.md §5
    "Config/flag system", [ARCHETYPE]): everything that changes the traced
    program lives here, everything that changes *values* lives in the Scene.
    """

    width: int = 256
    height: int = 256
    max_depth: int = 2        # Whitted bounces: 0 = primary rays only
    shadows: bool = True
    accel: str = "auto"       # "none" | "bvh" | "grid" | "auto"
    wavefront: bool = True    # re-bin live reflection rays between bounces
    #                           (clustered path; False = trace them in their
    #                           pixel tiles)
    shadow_rebin: bool = True  # large clustered scenes: trace shadows over
    #                            hit points re-binned by Morton code —
    #                            compact 3D cells give thin light-origin
    #                            cull cones (False = over the pixel tiles)
    backend: str = "auto"     # "oracle" | "phase1" | "auto"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
