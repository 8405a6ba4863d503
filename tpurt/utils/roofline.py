"""Roofline model of the traversal trace kernel (SURVEY.md §5
"Tracing/profiling": bytes moved against memory bandwidth, flops against
the arithmetic peak).

The analytic cost of one frame's trace passes comes from the scene and
config shape plus the measured mean survivor count per tile
(tpurt.kernels.traversal.traversal_stats).  It counts upper-bound work —
every ray against every triangle of every survivor; the kernel's per-ray
box skip removes some — so the time that work takes at the peaks is not a
lower bound on the kernel's time, and its ratio to a measured time (the
"modelled share") can exceed 100% without any fault in the kernel.
Peaks live in one table keyed by jax's `device_kind`; a device that is not
in the table is an error, never a default.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    mem_bytes_per_s: float     # device memory bandwidth
    f32_flops_per_s: float     # f32 on the CUDA cores (no tensor cores)
    source: str


_H100_SXM = Peaks(
    mem_bytes_per_s=3.35e12,
    f32_flops_per_s=67e12,
    source="NVIDIA H100 SXM5 data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 "
           "(dense, at the 700 W power limit; a card set to a lower limit "
           "runs below these under load)",
)

#: published peaks by jax.Device.device_kind
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
    "NVIDIA H100 SXM5 80GB": _H100_SXM,
}


def peaks(device_kind: str) -> Peaks:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"tpurt.utils.roofline.PEAKS with its source") from None


#: flops of one ray × triangle test (traversal._tri_t; an FMA counts 2)
FLOPS_PER_PAIR = 44
#: flops of one ray × cluster-box test (traversal._box_near_far)
FLOPS_PER_BOX = 18


@dataclasses.dataclass
class TraversalCost:
    passes: int                # closest + occlusion passes per frame
    tiles: int
    survivors_per_pass: float  # mean clusters traced per tile per pass
    bytes: float = 0.0
    flops: float = 0.0

    def at_peak_s(self, device_kind: str) -> dict:
        """Seconds the counted bytes and flops take at the device's peaks."""
        pk = peaks(device_kind)
        mem_s = self.bytes / pk.mem_bytes_per_s
        f32_s = self.flops / pk.f32_flops_per_s
        return {"mem_s": mem_s, "f32_s": f32_s,
                "bound_s": max(mem_s, f32_s),
                "bound": "memory" if mem_s >= f32_s else "f32"}


def traversal_cost(height, width, max_depth, shadows, n_lights,
                   survivors_per_pass, rays_per_tile=64, leaf=128,
                   forms=12) -> TraversalCost:
    """Upper-bound work of one frame's trace passes: every survivor's
    cluster data is read once per tile and every ray meets every triangle
    of every survivor (the kernel's box skip only removes work)."""
    tiles = -(-height * width // rays_per_tile)
    passes = (max_depth + 1) * (1 + (n_lights if shadows else 0))
    visits = tiles * passes * survivors_per_pass
    cluster_bytes = (forms * leaf + leaf + 8) * 4       # forms + gid + box
    flops = visits * rays_per_tile * (leaf * FLOPS_PER_PAIR + FLOPS_PER_BOX)
    return TraversalCost(passes=passes, tiles=tiles,
                         survivors_per_pass=survivors_per_pass,
                         bytes=visits * cluster_bytes, flops=flops)


def report(measured_ms, device_kind, **kw) -> str:
    cost = traversal_cost(**kw)
    lb = cost.at_peak_s(device_kind)
    share = lb["bound_s"] * 1e3 / measured_ms if measured_ms > 0 else 0.0
    return (
        f"passes={cost.passes} tiles={cost.tiles} "
        f"bytes={cost.bytes / 1e9:.2f}GB flops={cost.flops / 1e9:.1f}G "
        f"at peak: mem={lb['mem_s'] * 1e3:.3f}ms "
        f"f32={lb['f32_s'] * 1e3:.3f}ms ({lb['bound']}-bound) | "
        f"measured={measured_ms:.3f}ms (modelled share {100 * share:.1f}%, "
        f"upper-bound work)"
    )
