"""Golden-image regression (SURVEY.md §4 item 3): committed PNGs of the five
benchmark configs, rendered by the frozen oracle.  A diff here means a
parity-critical convention drifted (tpurt/constants.py) or a scene config
changed — both must be deliberate, with goldens regenerated via
`python /tmp/gen_golden.py`-style script (see git history).

PNG quantization (8-bit) absorbs float jitter; tolerance is 2/255 per
channel plus a 0.1% pixel budget for boundary flips across BLAS/XLA
versions.
"""
import os

import numpy as np
import pytest

from tpurt.ref import render_ref
from tpurt.scene import configs
from tpurt.utils import load_png

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

SPECS = {
    "config1": (configs.config1_sphere, (64, 64), {}),
    "config2": (configs.config2_cornell, (64, 64), {}),
    "config3": (configs.config3_spheres, (64, 64), {}),
    "config4": (configs.config4_bunny, (64, 64), {"subdiv": 3}),
    "config5": (configs.config5_multimesh, (48, 64), {"n_blobs": 3, "subdiv": 2}),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_golden(name):
    build, res, kw = SPECS[name]
    scene, cfg = build(*res, **kw)
    img = np.asarray(render_ref(scene, config=cfg))
    gold = load_png(os.path.join(GOLDEN, f"{name}.png"))
    diff = np.abs(img - gold).max(-1)
    bad = diff > (2.5 / 255.0)
    assert bad.mean() < 1e-3, f"{name}: {bad.sum()} pixels differ (max {diff.max():.4f})"


# fast paths against the SAME goldens (path-vs-oracle parity is ~2e-4,
# far inside the 8-bit PNG tolerance): a fast-path image regression is
# caught here even if the oracle stays correct.
KERNEL_PATHS = {
    "config1": "auto",      # phase-1 path
    "config2": "auto",      # phase-1 path
    "config3": "auto",      # phase-1 path
    "config4": "bvh",       # cluster traversal + deferred shading
    "config5": "bvh",       # cluster traversal + textures
}


@pytest.mark.parametrize("name", list(SPECS))
def test_golden_kernel_paths(name):
    from tpurt.render import prepare, render

    build, res, kw = SPECS[name]
    scene, cfg = build(*res, **kw)
    plan = prepare(scene, cfg, accel=KERNEL_PATHS[name])
    assert plan.kind != "oracle"
    img = np.asarray(render(scene, cfg, plan=plan))
    gold = load_png(os.path.join(GOLDEN, f"{name}.png"))
    diff = np.abs(img - gold).max(-1)
    bad = diff > (2.5 / 255.0)
    assert bad.mean() < 1e-3, (
        f"{name}[{plan.kind}]: {bad.sum()} pixels differ (max {diff.max():.4f})"
    )
