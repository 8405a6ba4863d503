"""Roofline utility + animate CLI smoke tests."""
import pytest

from tpurt.utils.roofline import PEAKS, peaks, report, traversal_cost

H100 = "NVIDIA H100 80GB HBM3"


def test_traversal_cost_model():
    c = traversal_cost(1024, 1024, 1, True, 2, survivors_per_pass=20)
    assert c.passes == 6
    assert c.tiles == 1024 * 1024 // 64
    lb = c.at_peak_s(H100)
    assert 0 < lb["bound_s"] < 1.0
    assert lb["bound"] in ("memory", "f32")
    txt = report(500.0, H100, height=1024, width=1024, max_depth=1,
                 shadows=True, n_lights=2, survivors_per_pass=20)
    assert "modelled share" in txt


def test_roofline_unknown_device_raises():
    """Peaks come from one table keyed by device_kind, each with its
    source; an unknown device is an error, never an assumed rate."""
    assert all(p.source for p in PEAKS.values())
    assert peaks(H100).mem_bytes_per_s == 3.35e12
    for kind in ("Unknown Accelerator", "cpu", "NVIDIA A100-SXM4-40GB"):
        with pytest.raises(ValueError, match="no published peaks"):
            peaks(kind)
    with pytest.raises(ValueError):
        traversal_cost(64, 64, 0, False, 1, 2.0).at_peak_s("cpu")


def test_cli_animate(tmp_path):
    from tpurt.cli import main

    out = str(tmp_path / "f_{:03d}.png")
    main(["animate", "--config", "1", "--res", "16x16", "--frames", "3",
          "--out", out])
    import os

    assert os.path.exists(str(tmp_path / "f_002.png"))
