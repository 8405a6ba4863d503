"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline (BASELINE.json:2): Mrays/s per card, forward + backward.  The ray
count is the number of rays the algorithm actually traces (see
count_rays_traced); the nominal count is pixels × (max_depth+1) closest-hit
rays × (1 + n_lights shadow rays).  Every line names the device it ran on
(platform, device kind, count) and the card's name and power limit.

`vs_baseline` is null: the reference publishes no numbers
(BASELINE.json:13 "published": {}).

Usage: python bench.py [--config N] [--res HxW] [--mode fwd|fwdbwd]
                       [--mesh N | --scene-shard N]
It measures whatever device JAX uses and names it in the line.  Parity on
the card is chip_smoke.py's.  Per-stage detail goes to stderr; stdout
carries only the JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def count_rays(cfg, scene) -> int:
    """Nominal Whitted ray budget: pixels × depths × (1 + shadow rays).

    A fixed convention, so Mrays/s ratios equal frame-time ratios.  The
    clustered path kills dead paths (zero-reflectivity hits) and skips
    empty bounces, so the rays it traces can be fewer —
    count_rays_traced() counts those; ms/frame is the ground-truth cost.
    """
    per_bounce = 1 + (scene.n_lights if cfg.shadows else 0)
    return cfg.height * cfg.width * (cfg.max_depth + 1) * per_bounce


def count_rays_traced(cfg, scene, plan) -> int:
    """Rays the compiled program actually traces.

    Phase-1/oracle paths compute every lane every depth (alive-masked), so
    traced == nominal there.  The clustered path deletes work three ways —
    static depth cap, per-bounce live-ray compaction, shadow rays only from
    actual hits — so for it we count: pixels (bounce-0 closest) + Σ_b live
    rays entering bounce b + n_lights × Σ_b hits at depth b.  Counts are
    reduced on the device.
    """
    if plan.kind != "clusters":
        return count_rays(cfg, scene)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpurt.kernels import traversal as TV
    from tpurt.kernels.packc import pack_clusters
    from tpurt.render import cap_depth

    cfgc = cap_depth(cfg, plan)

    @jax.jit
    def counts(s):
        packed = pack_clusters(s, plan.tri_ids)
        ids, _ = TV.trace_records(s, packed, cfgc, 0, cfgc.height)
        hit = ids >= 0
        hits = hit.sum(axis=-1)                      # hits per depth
        T = s.n_tris
        is_tri = hit & (ids < T)
        tid = jnp.clip(ids, 0, max(T - 1, 0))
        sid = jnp.clip(ids - T, 0, max(s.n_spheres - 1, 0))
        mat = jnp.where(is_tri, s.tri_mat[tid], s.sph_mat[sid])
        live = hit & (s.materials.reflectivity[mat] > 0.0)
        return hits, live.sum(axis=-1)               # continuations per depth

    hits, live = (np.asarray(x) for x in counts(scene))
    n_pix = cfg.height * cfg.width
    closest = n_pix + int(live[:-1].sum()) if len(live) > 1 else n_pix
    shadow = int(hits.sum()) * scene.n_lights if cfgc.shadows else 0
    return closest + shadow


def time_fn(fn, arg, iters: int) -> float:
    """Seconds per call: `iters` chained calls, then block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(arg)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--res", type=str, default="1080x1920")
    ap.add_argument("--mode", type=str, default="fwdbwd", choices=["fwd", "fwdbwd"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--depth", type=int, default=None,
                    help="override max_depth (pass-cost breakdown)")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--no-wavefront", action="store_true")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="render tile-parallel over an N-device mesh via "
                    "dist.render_sharded (the multi-card scaling command, "
                    "BASELINE.json:2; on one card use N=1)")
    ap.add_argument("--scene-shard", type=int, default=None, metavar="N",
                    help="render with clusters + shading tables + vertex "
                    "table sharded over an N-device mesh and ring ray "
                    "exchange (the larger-than-one-card command; N=1 "
                    "measures the ring's overhead against replicated)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpurt.render import prepare, render
    from tpurt.scene import configs
    from tpurt.utils.device import card, describe, enable_compile_cache

    dev = describe()
    enable_compile_cache()
    power = card()

    h, w = (int(x) for x in args.res.split("x"))
    build = configs.ALL_CONFIGS[args.config]
    scene, cfg = build(h, w)
    if args.depth is not None:
        cfg = cfg.replace(max_depth=args.depth)
    if args.no_shadows:
        cfg = cfg.replace(shadows=False)
    if args.no_wavefront:
        cfg = cfg.replace(wavefront=False)
    print(
        f"[bench] config={args.config} {h}x{w} mode={args.mode} "
        f"tris={scene.n_tris} spheres={scene.n_spheres} "
        f"device={dev} card={power}",
        file=sys.stderr,
    )

    plan = prepare(scene, cfg)
    print(f"[bench] plan={plan.kind}", file=sys.stderr)

    if args.scene_shard is not None:
        # ring path for scenes larger than one card
        from tpurt.dist import (make_mesh, prepare_scene_sharded,
                                render_scene_sharded_prepared)

        if args.scene_shard > dev["count"]:
            print(f"[bench] --scene-shard {args.scene_shard} > "
                  f"{dev['count']} device(s) available", file=sys.stderr)
            sys.exit(2)
        if plan.kind != "clusters":
            plan = prepare(scene, cfg, accel="bvh")
        scene, parts = prepare_scene_sharded(scene, plan.tri_ids,
                                             args.scene_shard)
        mesh = make_mesh(args.scene_shard)
        print(f"[bench] ring mesh={mesh.shape}", file=sys.stderr)
        fwd_fn = jax.jit(lambda s: render_scene_sharded_prepared(
            s, cfg, parts, mesh))
    elif args.mesh is not None:
        from tpurt.dist.shard import make_mesh, render_sharded

        if args.mesh > dev["count"]:
            print(f"[bench] --mesh {args.mesh} > {dev['count']} device(s) "
                  "available", file=sys.stderr)
            sys.exit(2)
        mesh = make_mesh(args.mesh)
        print(f"[bench] mesh={mesh.shape}", file=sys.stderr)
        fwd_fn = jax.jit(lambda s: render_sharded(s, cfg, mesh, plan=plan))
    else:
        fwd_fn = jax.jit(lambda s: render(s, cfg, plan=plan))

    if args.mode == "fwd":
        fn = fwd_fn
    else:
        def loss(s):
            return jnp.sum(fwd_fn(s) ** 2)

        fn = jax.jit(jax.grad(loss, allow_int=True))

    t0 = time.perf_counter()
    jax.block_until_ready(fn(scene))
    print(f"[bench] compile+first: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    for _ in range(args.warmup - 1):
        jax.block_until_ready(fn(scene))
    dt = time_fn(fn, scene, args.iters)
    rays = count_rays(cfg, scene)
    # ring mode renumbers the scene (plan.tri_ids indexes the original
    # order): report nominal rays as traced rather than recount
    traced = (rays if args.scene_shard is not None
              else count_rays_traced(cfg, scene, plan))
    print(f"[bench] {dt * 1e3:.3f} ms/frame over {args.iters} chained "
          f"iters; rays nominal={rays} traced={traced}", file=sys.stderr)

    # gradient-rays/s as a first-class metric (BASELINE.json:2 names it
    # separately): in fwdbwd mode also time the forward alone and charge
    # the backward with the difference
    grad_extra = {}
    if args.mode == "fwdbwd":
        jax.block_until_ready(fwd_fn(scene))
        dt_f = time_fn(fwd_fn, scene, args.iters)
        dt_b = max(dt - dt_f, 1e-9)
        grad_extra = {
            "ms_per_frame_fwd": dt_f * 1e3,
            "grad_mrays_traced": traced / dt_b / 1e6,
            "grad_mrays_nominal": rays / dt_b / 1e6,
        }
        print(f"[bench] fwd alone {dt_f * 1e3:.3f} ms → bwd-extra "
              f"{dt_b * 1e3:.3f} ms", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": f"Mrays/s/card {args.mode} config{args.config} "
                          f"{h}x{w}",
                "value": traced / dt / 1e6,
                "unit": "Mrays/s (traced rays)",
                "vs_baseline": None,
                "mrays_nominal": rays / dt / 1e6,
                "rays_nominal": rays,
                "rays_traced": traced,
                "ms_per_frame": dt * 1e3,
                "mesh": args.mesh,
                "scene_shard": args.scene_shard,
                "device": dev,
                "card": power,
                **grad_extra,
            }
        )
    )


if __name__ == "__main__":
    main()
