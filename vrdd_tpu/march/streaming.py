"""Streamed distribution decode fused into the plane sweep.

The north-star render path: per-voxel distribution parameters are "decoded to
scalar density on the fly ... fused with ray-casting" — the pattern the
reference implements only for query 7 (the in-march 8-corner histogram decode,
volumeRender_kernel.cu:354-480) and otherwise replaces with a full
precomputed query volume (d_basicDataProcessing, :722-872).

Here the decode streams: the plane schedule is cut into chunks of planes,
each chunk decodes ONLY the volume z-layers its planes touch, pre-blends
them, and runs a SEEDED sweep that resumes the front-to-back "over"
recursion from the previous chunk's accumulator — so the full decoded scalar
volume never materializes in device memory. On one device the chained seed
is the true prefix, so early termination is exact in a single pass (seeded
pixels past the opacity threshold freeze instantly — no two-pass scheme
needed, unlike the distributed sort-last sweep).

Differentiation: each chunk body (decode -> pre-blend -> seeded sweep) is
wrapped in ``jax.checkpoint``, so the backward pass rematerializes the
decoded layers chunk-by-chunk instead of storing them — without it, every
chunk sweep's custom VJP would save its plane stack and the residuals would
re-materialize the full decoded volume. The seeded sweeps' custom VJPs carry
the seed cotangent (``d seed_a = g_a - P_total / T_0``), so the chain rule
walks the chunk chain exactly, and the decode's own VJP routes plane
cotangents back to the distribution parameters per chunk.

The chunk sweeps are march/slice.py ``sweep_preblended_planes_xla``;
results match the decode-everything-then-render path to float tolerance
(tests).

Scope: this chunked chain is the route for arbitrary user decode functions
(Gaussian parameterizations, learned decoders) and for volumes whose
decoded form does not fit beside the distribution data, where remat'd
chunking is the only differentiable option. Histogram volumes whose decoded
form fits decode once (ops/histogram.py ``decode_with_rows``) and sweep.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from vrdd_tpu.march.slice import sweep_preblended_planes_xla
from vrdd_tpu.utils.config import MarchConfig


def _pixel_slope_grids(width: int, height: int, focal: float):
    u = ((np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0)
    v = ((np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0)
    return (u / (-focal)).astype(np.float32), (v / (-focal)).astype(np.float32)


def streaming_decode_render(
    dist,
    decode_layers: Callable,
    origin,
    tf_lut: jnp.ndarray,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    width: int,
    height: int,
    march: MarchConfig = MarchConfig(),
    n_planes: int = 0,
    chunk_planes: int = 64,
    focal: float = 2.0,
    tex_offset: float = 0.5,
    remat: bool = True,
) -> jnp.ndarray:
    """Render ``(H, W, 4)`` RGBA, decoding ``dist`` layer-by-layer in-stream.

    Args:
      dist: pytree of distribution parameters; every leaf has leading
        ``(Z, Y, X)`` axes (e.g. a ``(Z, Y, X, 16)`` histogram volume, or a
        ``(mu, sigma)`` tuple of ``(Z, Y, X)`` arrays).
      decode_layers: pure function mapping a z-layer slice of ``dist`` (same
        pytree, leaves ``(L, Y, X, ...)``) to scalar density layers
        ``(L, Y, X)``. Called once per chunk on only the layers that chunk's
        planes touch; differentiated by the chain rule per chunk.
      origin: camera position (unrotated view looking down -z, the
        slice_render_image frustum).
      chunk_planes: planes per streamed chunk (clipped to n_planes).
      remat: wrap each chunk in ``jax.checkpoint`` (see module docstring) —
        disable only for debugging.

    Everything else matches ``slice_render_image`` semantics. Gradients
    reach ``dist`` (through decode_layers), the TF LUT, and the render
    params, exactly as if the full volume had been decoded first.
    """
    leaves = jax.tree_util.tree_leaves(dist)
    nz, ny, nx = leaves[0].shape[:3]
    if n_planes <= 0:
        n_planes = 2 * nz
    chunk_planes = min(chunk_planes, n_planes)
    while n_planes % chunk_planes:
        chunk_planes -= 1
    n_chunks = n_planes // chunk_planes

    (xlo, ylo, zlo) = march.box_min
    (xhi, yhi, zhi) = march.box_max
    spacing = (zhi - zlo) / n_planes
    zs = (
        zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)
    ).astype(np.float32)[::-1]  # front-to-back for the -z camera

    # z-taps per plane: clamp-from-the-unclipped-floor (the pre-blend model,
    # march/slice.py)
    zf = (zs - zlo) / (zhi - zlo) * nz - tex_offset
    az = (zf - np.floor(zf)).astype(np.float32)
    iz1 = np.clip(np.floor(zf).astype(np.int64) + 1, 0, nz - 1)
    iz0 = np.clip(np.floor(zf).astype(np.int64), 0, nz - 1)

    mx, my = _pixel_slope_grids(width, height, focal)

    origin = jnp.asarray(origin, dtype=jnp.float32)
    lut = jnp.asarray(tf_lut, dtype=jnp.float32)
    density = jnp.asarray(density, jnp.float32)
    toff = jnp.asarray(transfer_offset, jnp.float32)
    tscl = jnp.asarray(transfer_scale, jnp.float32)

    acc = jnp.zeros((height, width, 4), dtype=jnp.float32)
    for c in range(n_chunks):
        sl = slice(c * chunk_planes, (c + 1) * chunk_planes)
        lo = int(min(iz0[sl].min(), iz1[sl].min()))
        hi = int(max(iz0[sl].max(), iz1[sl].max()))
        li0 = jnp.asarray(iz0[sl] - lo)
        li1 = jnp.asarray(iz1[sl] - lo)
        azj = jnp.asarray(az[sl])[:, None, None]
        zs_chunk = zs[sl]
        layers_in = jax.tree_util.tree_map(lambda a: a[lo:hi + 1], dist)

        def chunk_body(layers, acc, lut, density, toff, tscl, origin,
                       li0=li0, li1=li1, azj=azj, zs_chunk=zs_chunk):
            scal = decode_layers(layers)  # (L, NY, NX)
            planes = scal[li0] * (1.0 - azj) + scal[li1] * azj
            return sweep_preblended_planes_xla(
                planes, zs_chunk, origin, mx, my, lut, density, 1.0,
                toff, tscl, march, dz_sign=-1, plane_spacing=spacing,
                plane_chunk=min(8, chunk_planes), tex_offset=tex_offset,
                acc_init=acc,
            )

        body = jax.checkpoint(chunk_body) if remat else chunk_body
        acc = body(layers_in, acc, lut, density, toff, tscl, origin)
    return acc * jnp.asarray(brightness, dtype=jnp.float32)
