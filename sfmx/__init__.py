"""sfmx — Structure-from-Motion mapping & visual localization in JAX.

A ground-up re-design of the capability surface of hulop/SfMLocalization
(OpenMVG/OpenCV/Ceres CPU pipeline) as an arrays-and-meshes JAX/Pallas
framework:

- ``sfmx.core``     — SE(3)/SO(3), camera models, masking utilities (L0)
- ``sfmx.kernels``  — feature/matching ops, the GPU top-2 kernel + plain references (L1)
- ``sfmx.solvers``  — triangulation, PnP, RANSAC, epipolar, Umeyama, LM/Schur/PCG (L2)
- ``sfmx.recon``    — tracks, two-view init, incremental SfM engine (L3)
- ``sfmx.mapstore`` — columnar scene/map format, save/load, partitioning (C7)
- ``sfmx.dist``     — mesh construction, sharded BA collectives (L4)
- ``sfmx.localize`` — retrieval, 2D-3D matching, PnP localization, beacon fusion (L5)
- ``sfmx.serve``    — batched localization service (L6)
- ``sfmx.cli``      — build-map / localize / merge / serve / evaluate (L7)

Design stance (SURVEY.md §7.1): every variable-size phenomenon is static
capacity + validity mask; every algorithm is a jitted, vmapped, shardable
function over struct-of-arrays pytrees.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry is precision-critical: by default an f32 matmul on the H100 may
# run in TF32 (~3 decimal digits), which injects ~1e-3 relative noise into
# 3x3 pose algebra, projection, Schur assembly, and PCG — enough to stall BA
# far above its achievable floor (SURVEY §7.4).  Default the whole library
# to full-f32 matmuls; the few throughput-bound GEMMs (descriptor matching,
# retrieval) opt in to bf16 explicitly at their call sites.
_jax.config.update("jax_default_matmul_precision", "highest")

# Debug mode (SURVEY §5.2): SFMX_DEBUG=1 traps NaNs at the producing op and
# arms checkify wrappers; see sfmx.utils.debug.
from .utils import debug as _debug  # noqa: E402  (reads SFMX_DEBUG at import)
