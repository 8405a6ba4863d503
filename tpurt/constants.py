"""Parity-critical rendering constants — THE single source of truth.

Every convention that decides whether two renderers `allclose` lives here, so
the oracle (`tpurt.ref`), the fast paths (`tpurt.kernels`) and any
future backend can never drift from one another.  SURVEY.md §5 ("Config/flag
system") mandates this module; SURVEY.md §0 mandates re-aligning these values
to the OpenCL reference's constants if `/root/reference` ever becomes
readable (it was an empty mount this round — no file:line citations exist).

Conventions (binding for all backends):

* **Camera**: pinhole, right-handed.  ``forward = normalize(look_at - eye)``,
  ``right = normalize(forward × up)``, ``true_up = right × forward``.  Vertical
  field of view ``fov_y`` in radians; pixel (i, j) = (row, col) maps to NDC
  through the *pixel center* ((j + 0.5)/W, (i + 0.5)/H), row 0 = top of image.
* **Shading**: classic Phong — ``ambient·ka + Σ_l vis_l · I_l · (kd·max(N·L,0)
  + ks·max(R·V,0)^shininess)`` with ``R = reflect(-L, N)``; no distance
  attenuation; visibility is a binary any-hit shadow ray.
* **Whitted recursion**: iterative loop, contribution of bounce ``b`` weighted
  by the product of surface ``reflectivity`` along the path; rays stop after
  ``max_depth`` bounces (depth 0 = primary only).
* **Misses** return :data:`BACKGROUND`; the final image is clamped to [0, 1].
"""

# -- ray epsilons ------------------------------------------------------------
#: Minimum parametric distance for a primary/secondary ray hit to count.
T_MIN = 1e-4
#: Maximum parametric distance (effectively infinity).
T_MAX = 1e30
#: Sentinel "no hit" distance (compared against T_MAX to detect misses).
T_NONE = 1e30
#: Offset along the surface normal applied to shadow/secondary ray origins to
#: avoid self-intersection ("shadow acne").
RAY_OFFSET_EPS = 1e-3
#: Möller–Trumbore determinant cutoff below which a triangle is treated as
#: parallel to the ray (no hit, and no gradient through the degenerate term).
MT_DET_EPS = 1e-9
#: Guard added to squared-length terms before rsqrt in normalize().
NORMALIZE_EPS = 1e-20

# -- shading -----------------------------------------------------------------
#: RGB returned for rays that escape the scene.
BACKGROUND = (0.05, 0.07, 0.10)
#: Scene-wide ambient light colour multiplying material ambient (ka).
AMBIENT_LIGHT = (1.0, 1.0, 1.0)
#: Clamp bounds for the final image.
CLAMP_LO = 0.0
CLAMP_HI = 1.0

# -- defaults ----------------------------------------------------------------
#: Default Whitted bounce depth (2 = primary + two reflection bounces).
DEFAULT_MAX_DEPTH = 2
#: Compute dtype for all geometry/shading math (f32;
#: bf16 loses too much precision for intersection tests).
import jax.numpy as jnp

DTYPE = jnp.float32
INDEX_DTYPE = jnp.int32
