"""Explicit texture-unit semantics as differentiable gathers.

The CUDA texture fetches of the reference (volumeRender_kernel.cu:61-88)
become explicit gathers with the *exact* CUDA filtering/addressing model —
and because they are plain jnp ops, they are the differentiable path
(gradients scatter back into the volume / LUT).

CUDA linear-filter model (CUDA C Programming Guide, appendix on texture
fetching), clamp-to-edge addressing:

    x_f  = u * N - 0.5        (normalized coords;  x - 0.5 for unnormalized)
    i    = floor(x_f),  a = x_f - i
    out  = (1 - a) * T[clamp(i)] + a * T[clamp(i + 1)]

Point (nearest) sampling: ``T[clamp(floor(u * N))]``.

We do NOT replicate CUDA's 9-bit fixed-point filter weights; parity tests use
tolerances accordingly.

Volumes are arrays of shape ``(Z, Y, X)`` or ``(Z, Y, X, C)``; coordinates are
``(..., 3)`` in CUDA texture order ``(x, y, z)``.
"""

from __future__ import annotations

import jax.numpy as jnp


def _axis_sizes(vol: jnp.ndarray, channels: bool) -> jnp.ndarray:
    shape = vol.shape[:-1] if channels else vol.shape
    return jnp.asarray([shape[2], shape[1], shape[0]], dtype=jnp.float32)  # (x, y, z)


def sample_linear_1d(lut: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Linear-filtered 1-D LUT fetch at normalized coordinate ``u``.

    ``lut`` is ``(N, C)`` (or ``(N,)``); returns ``u.shape + (C,)``. This is the
    transferTex fetch (volumeRender_kernel.cu:683, setup 2337-2339).
    """
    squeeze = lut.ndim == 1
    if squeeze:
        lut = lut[:, None]
    n = lut.shape[0]
    xf = u * n - 0.5
    i0 = jnp.floor(xf)
    a = (xf - i0)[..., None]
    i0 = i0.astype(jnp.int32)
    lo = jnp.clip(i0, 0, n - 1)
    hi = jnp.clip(i0 + 1, 0, n - 1)
    out = (1.0 - a) * lut[lo] + a * lut[hi]
    return out[..., 0] if squeeze else out


def sample_nearest_3d(vol: jnp.ndarray, p01: jnp.ndarray) -> jnp.ndarray:
    """Point-sampled fetch at normalized coords ``p01 (..., 3)`` in (x,y,z) order."""
    channels = vol.ndim == 4
    sizes = _axis_sizes(vol, channels)
    idx = jnp.floor(p01 * sizes).astype(jnp.int32)
    shape = vol.shape[:-1] if channels else vol.shape
    nz, ny, nx = (int(d) for d in shape)  # static — safe under any trace
    ix = jnp.clip(idx[..., 0], 0, nx - 1)
    iy = jnp.clip(idx[..., 1], 0, ny - 1)
    iz = jnp.clip(idx[..., 2], 0, nz - 1)
    return vol[iz, iy, ix]


def _trilinear(vol: jnp.ndarray, xf: jnp.ndarray, channels: bool) -> jnp.ndarray:
    """Shared trilinear core; ``xf (..., 3)`` is the shifted filter coordinate."""
    if channels:
        nz, ny, nx = vol.shape[:3]
    else:
        nz, ny, nx = vol.shape
        vol = vol[..., None]
    i0 = jnp.floor(xf)
    a = xf - i0
    i0 = i0.astype(jnp.int32)
    x0 = jnp.clip(i0[..., 0], 0, nx - 1)
    x1 = jnp.clip(i0[..., 0] + 1, 0, nx - 1)
    y0 = jnp.clip(i0[..., 1], 0, ny - 1)
    y1 = jnp.clip(i0[..., 1] + 1, 0, ny - 1)
    z0 = jnp.clip(i0[..., 2], 0, nz - 1)
    z1 = jnp.clip(i0[..., 2] + 1, 0, nz - 1)
    ax = a[..., 0:1]
    ay = a[..., 1:2]
    az = a[..., 2:3]
    c000 = vol[z0, y0, x0]
    c100 = vol[z0, y0, x1]
    c010 = vol[z0, y1, x0]
    c110 = vol[z0, y1, x1]
    c001 = vol[z1, y0, x0]
    c101 = vol[z1, y0, x1]
    c011 = vol[z1, y1, x0]
    c111 = vol[z1, y1, x1]
    c00 = c000 * (1 - ax) + c100 * ax
    c10 = c010 * (1 - ax) + c110 * ax
    c01 = c001 * (1 - ax) + c101 * ax
    c11 = c011 * (1 - ax) + c111 * ax
    c0 = c00 * (1 - ay) + c10 * ay
    c1 = c01 * (1 - ay) + c11 * ay
    out = c0 * (1 - az) + c1 * az
    return out if channels else out[..., 0]


def sample_trilinear_3d(vol: jnp.ndarray, p01: jnp.ndarray) -> jnp.ndarray:
    """Linear-filtered fetch at normalized coords (originalQueryTex semantics,
    volumeRender_kernel.cu:1864-1876)."""
    channels = vol.ndim == 4
    sizes = _axis_sizes(vol, channels)
    return _trilinear(vol, p01 * sizes - 0.5, channels)


def sample_trilinear_3d_unnormalized(vol: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Linear-filtered fetch at *unnormalized* coords (flexBlockTex semantics,
    volumeRender_kernel.cu:1681-1691)."""
    channels = vol.ndim == 4
    return _trilinear(vol, coords - 0.5, channels)
