"""Device facts for measurement scripts: the persistent compile cache, the
accelerator JAX sees, and the card's name and power limit."""
from __future__ import annotations

import os
import subprocess

#: the checkout's fixed cache path (listed in .gitignore)
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Use JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself,
    nothing else is set); otherwise keep the cache at <checkout>/.jax_cache.
    Returns the directory in use.  Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)
    return _DEFAULT_CACHE


def card() -> str | None:
    """`name, power.limit` of the first card as nvidia-smi reports them, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def describe() -> dict:
    """{"platform", "kind", "count"} of the devices JAX uses."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
