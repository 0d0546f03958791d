"""vrdd_tpu — differentiable volume rendering of distribution data in JAX.

A JAX/XLA framework with the capabilities of the reference CUDA
application ``ykou/Volume-Rendering-Based-on-Distribution-Data`` (see SURVEY.md):
per-voxel *distributions* (block histograms, similarity/fractal-coded histograms,
integral-distribution flexible blocks, Gaussian moments) are decoded on the fly to a
scalar field (mean / variance / entropy), passed through a 1-D RGBA transfer function,
and composited front-to-back with early ray termination.

Layer map (a re-design around XLA's whole-array operations, not a port):

- ``core``      geometry, texture-semantics sampling, transfer functions, image packing
- ``ops``       distribution decode ops (histogram stats, fractal decode, Gaussian,
                sparse densify, integral histograms) — all vmappable + differentiable
- ``march``     the ray marcher (lax.scan reference) and the object-order plane
                sweeps (slice, shear-warp, streamed decode) with custom VJP
- ``models``    user-facing renderer / fitting model families
- ``parallel``  mesh construction, rays-on-hosts & bricks-on-chips sharding, halo
                exchange, distributed render/training steps
- ``io``        binary readers for the reference's 8 data formats, synthetic data
                generators, PPM/NPZ writers, checkpointing
- ``utils``     config dataclasses, logging, profiling/timing
"""

__version__ = "0.1.0"

from vrdd_tpu.utils.config import (  # noqa: F401
    MarchConfig,
    CameraConfig,
    TransferFunctionConfig,
    RenderConfig,
    QueryMethod,
)
