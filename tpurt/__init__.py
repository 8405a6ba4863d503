"""tpurt — a differentiable Whitted ray tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference `kotturtech/OpenCLRayTracer` (see SURVEY.md; the reference mount
was empty this round, so rows cite BASELINE.json / SURVEY.md instead of
file:line).  Public API:

    from tpurt import render, render_and_grad, RenderConfig, build_scene
"""
from tpurt.core.types import Rays, RenderConfig, pytree_dataclass
from tpurt.scene.scene import Scene, Camera, Materials, build_scene

__version__ = "0.1.0"

__all__ = [
    "Rays",
    "RenderConfig",
    "pytree_dataclass",
    "Scene",
    "Camera",
    "Materials",
    "build_scene",
    "render",
    "render_and_grad",
    "prepare",
]


def __getattr__(name):
    # render API imports lazily to keep `import tpurt` light and to avoid
    # circular imports from kernels.  Two traps here: `from tpurt import
    # render` re-enters this __getattr__ if written as a `from` import
    # (infinite recursion), and importing the tpurt.render SUBMODULE binds
    # it onto the package, shadowing this hook — so `from tpurt import
    # render` would return the module on the second lookup.  Import via
    # importlib, then rebind the public names to the functions.
    if name in ("render", "render_and_grad", "prepare"):
        import importlib

        mod = importlib.import_module("tpurt.render")
        for n in ("render", "render_and_grad", "prepare"):
            globals()[n] = getattr(mod, n)
        return globals()[name]
    raise AttributeError(name)
