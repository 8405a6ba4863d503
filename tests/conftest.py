"""Test harness: force CPU with 8 virtual devices (SURVEY.md §4 item 4) so
multi-device shard_map paths are exercised deterministically on any host;
the Triton trace kernel runs in interpret mode there.  Tests that need the
GPU carry the `gpu` marker and decide inside the test (the `gpu_device`
fixture), never at import time; on a machine with a card they run with

    TPURT_TEST_GPU=1 python -m pytest tests -m gpu

which keeps the GPU visible (and the CPU beside it).  The platform is
pinned with jax.config.update after import, before the first backend
initialisation, together with XLA_FLAGS for the device count.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

ON_GPU = os.environ.get("TPURT_TEST_GPU") == "1"
jax.config.update("jax_platforms", "cuda,cpu" if ON_GPU else "cpu")
jax.config.update("jax_enable_x64", False)

if not ON_GPU:
    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) == 8


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when this process has none (the
    suite pins the CPU, so GPU tests run through chip_smoke.py)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: TPURT_TEST_GPU=1 python -m pytest tests -m gpu")
    return devs[0]
