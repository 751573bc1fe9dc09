"""pyrite-tpu: a spectral path-tracing framework in JAX.

A JAX/XLA/Pallas re-design of the capabilities of Ogeon/pyrite:
wavelength-based light transport over wavefronts of rays, sharded across
devices.
"""

import jax as _jax

# Ray tracing needs full f32 precision in its (tiny) matrix products — camera
# transforms, frame rotations, colorimetric integration. Reduced-precision
# matmul inputs (TF32 on the GPU) would quantize ray directions into visible
# banding, so every matmul is pinned to float32.
_jax.config.update("jax_default_matmul_precision", "float32")

__version__ = "0.1.0"
