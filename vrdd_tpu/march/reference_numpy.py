"""Pure-numpy re-implementation of the reference render kernel.

This module is the CPU *specification* the JAX paths are tested against
("allclose to a CPU reference re-implementation of volumeRender_kernel.cu",
BASELINE.json). It deliberately mirrors d_render (volumeRender_kernel.cu:
272-717) step for step — including quirks:

- ``u = (x / W) * 2 - 1`` pixel-corner ray generation (:288-289)
- normalize-then-rotate direction, origin from the inv-view translation (:293-296)
- ``hit = tfar > tnear`` with NO ``tfar > 0`` requirement (:155)
- ``tnear`` clamped to 0 *before* the start position is computed (:305-311)
- composite first, THEN test opacity > 0.95, THEN advance and test ``t > tfar``
  (:690-706) — so every hit ray composites at least one sample
- ``sum *= brightness`` applied only to hit rays (early return skips it) (:713)
- CUDA linear-filter model ``x_f = u*N - 0.5`` with clamp-to-edge

Written independently from the JAX path (numpy loops, not shared helpers), so
the two implementations cross-check each other.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

SampleFn = Callable[[np.ndarray], np.ndarray]  # (N, 3) p01 -> (N,) scalar


def np_sample_linear_1d(lut: np.ndarray, u: np.ndarray) -> np.ndarray:
    n = lut.shape[0]
    xf = u * n - 0.5
    i0 = np.floor(xf)
    a = (xf - i0)[..., None]
    i0 = i0.astype(np.int64)
    lo = np.clip(i0, 0, n - 1)
    hi = np.clip(i0 + 1, 0, n - 1)
    return (1.0 - a) * lut[lo] + a * lut[hi]


def np_sample_trilinear(vol: np.ndarray, p01: np.ndarray) -> np.ndarray:
    """Normalized-coordinate trilinear fetch; vol (Z, Y, X[, C]), p01 (..., 3) xyz."""
    channels = vol.ndim == 4
    if not channels:
        vol = vol[..., None]
    nz, ny, nx = vol.shape[:3]
    sizes = np.array([nx, ny, nz], dtype=np.float32)
    xf = p01 * sizes - 0.5
    i0 = np.floor(xf)
    a = xf - i0
    i0 = i0.astype(np.int64)
    x0 = np.clip(i0[..., 0], 0, nx - 1)
    x1 = np.clip(i0[..., 0] + 1, 0, nx - 1)
    y0 = np.clip(i0[..., 1], 0, ny - 1)
    y1 = np.clip(i0[..., 1] + 1, 0, ny - 1)
    z0 = np.clip(i0[..., 2], 0, nz - 1)
    z1 = np.clip(i0[..., 2] + 1, 0, nz - 1)
    ax, ay, az = a[..., 0:1], a[..., 1:2], a[..., 2:3]
    c00 = vol[z0, y0, x0] * (1 - ax) + vol[z0, y0, x1] * ax
    c10 = vol[z0, y1, x0] * (1 - ax) + vol[z0, y1, x1] * ax
    c01 = vol[z1, y0, x0] * (1 - ax) + vol[z1, y0, x1] * ax
    c11 = vol[z1, y1, x0] * (1 - ax) + vol[z1, y1, x1] * ax
    c0 = c00 * (1 - ay) + c10 * ay
    c1 = c01 * (1 - ay) + c11 * ay
    out = c0 * (1 - az) + c1 * az
    return out if channels else out[..., 0]


def reference_render(
    sample_fn: SampleFn,
    inv_view: np.ndarray,
    width: int,
    height: int,
    tf_lut: np.ndarray,
    density: float = 0.05,
    brightness: float = 1.0,
    transfer_offset: float = 0.0,
    transfer_scale: float = 1.0,
    max_steps: int = 500,
    tstep: float = 0.01,
    opacity_threshold: float = 0.95,
    focal: float = 2.0,
    rows: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Render an (H, W, 4) float32 RGBA image, mirroring d_render exactly.

    ``rows=(r0, r1)`` renders only image rows ``r0:r1`` of the (H, W) image
    (an ``(r1 - r0, W, 4)`` band), so a full-width band of a large image can
    be checked without marching every ray on the host."""
    inv_view = np.asarray(inv_view, dtype=np.float32)
    r0, r1 = (0, height) if rows is None else rows
    x = np.arange(width, dtype=np.float32)
    y = np.arange(r0, r1, dtype=np.float32)
    u = (x / width) * 2.0 - 1.0
    v = (y / height) * 2.0 - 1.0
    uu, vv = np.meshgrid(u, v)
    d = np.stack([uu, vv, -focal * np.ones_like(uu)], axis=-1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rot = inv_view[:, :3]
    dirs = (d.reshape(-1, 3) @ rot.T).astype(np.float32)  # (N, 3)
    origin = inv_view[:, 3].astype(np.float32)

    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / dirs
        tbot = inv_d * (-1.0 - origin)
        ttop = inv_d * (1.0 - origin)
    tmin = np.minimum(ttop, tbot)
    tmax = np.maximum(ttop, tbot)
    tnear = tmin.max(axis=-1)
    tfar = tmax.min(axis=-1)
    hit = tfar > tnear

    tnear = np.where(tnear < 0.0, 0.0, tnear)
    n = dirs.shape[0]
    summ = np.zeros((n, 4), dtype=np.float32)
    t = tnear.copy()
    pos = origin[None, :] + dirs * tnear[:, None]
    step = dirs * tstep
    alive = hit.copy()

    for _ in range(max_steps):
        if not alive.any():
            break
        p01 = pos * 0.5 + 0.5
        sample = np.zeros(n, dtype=np.float32)
        sample[alive] = sample_fn(p01[alive])
        col = np_sample_linear_1d(
            tf_lut, (sample - transfer_offset) * transfer_scale
        ).astype(np.float32)
        col[:, 3] *= density
        col[:, 0] *= col[:, 3]
        col[:, 1] *= col[:, 3]
        col[:, 2] *= col[:, 3]
        new_sum = summ + col * (1.0 - summ[:, 3:4])
        summ = np.where(alive[:, None], new_sum, summ)
        alive = alive & ~(summ[:, 3] > opacity_threshold)
        t = np.where(alive, t + tstep, t)
        alive = alive & ~(t > tfar)
        pos = np.where(alive[:, None], pos + step, pos)

    summ = np.where(hit[:, None], summ * brightness, summ)
    return summ.reshape(r1 - r0, width, 4)
