"""Perspective shear-warp renderer: arbitrary rotated views on the sweep path.

The scan marcher (vrdd_tpu/march/scan.py) handles any view exactly with
per-sample gathers. This module renders ROTATED pinhole views with the same
object-order matmul sweep as vrdd_tpu/march/slice.py, via the perspective
shear-warp factorization (Lacroute & Levoy, SIGGRAPH '94; the reference has
no equivalent, its d_render re-marches per pixel for every view,
volumeRender_kernel.cu:272-717):

1. **Principal axis**: pick the volume axis a maximizing |view_dir_a| and
   permute volume axes so a -> z. A pure relabel + one jnp.transpose.
2. **Ray-slope (sheared-object) space**: every ray through the camera origin
   is identified by its slope ``m = (d_x / d_z, d_y / d_z)`` in (permuted)
   volume axes. On the volume plane ``z = zk`` the ray position is affine in
   m with a per-plane scale and translation, so resampling each plane onto a
   uniform m-grid is two small matmuls — the slice sweep runs UNCHANGED on a
   bounding m-grid (`sweep_slope_space`). Compositing in m-space is per-ray
   exact: each m-grid point IS one ray.
3. **Final 2-D warp**: pixels map to slopes by the projective map
   ``m(u, v) = (R(u,v,-f))_{xy} / (R(u,v,-f))_z`` — one bilinear resample of
   the composited (Hi, Wi, 4) m-space image. The only gather in the whole
   render, on a 2-D image, with host-precomputed static indices.

Requirements/limits (fall back to the scan marcher otherwise):
- d_z must keep one sign across the image (true for FOV < 90 deg with the
  principal-axis choice; `shearwarp_applicable` checks it),
- the warp resampling adds one bilinear filtering step: accuracy vs the scan
  marcher is ~1e-2 at oversample=2 (pinned in tests), not bit parity.

The view matrix is a HOST numpy array: geometry (principal axis, m-grid
bounds, warp indices) is computed host-side and embedded as literals, so
each view is its own compile. Differentiable w.r.t. volume and render params
(the warp is linear; the sweep has an analytic custom VJP).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from vrdd_tpu.march.slice import sweep_slope_space
from vrdd_tpu.utils.config import MarchConfig

# permutation per principal axis: world-axis indices (x=0, y=1, z=2) of the
# sweep's (x', y', z'); volume arrays are (Z, Y, X) = world axes (2, 1, 0).
_PERMS = {
    2: (0, 1, 2),  # z-principal: identity
    1: (0, 2, 1),  # y-principal: (x, z, y)
    0: (2, 1, 0),  # x-principal: (z, y, x)
}


def _pixel_grid(width: int, height: int, focal: float):
    u = ((np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0).astype(
        np.float32
    )
    v = ((np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0).astype(
        np.float32
    )
    uu, vv = np.meshgrid(u, v)  # (H, W)
    d = np.stack([uu, vv, -focal * np.ones_like(uu)], axis=-1)  # camera space
    return d


def shearwarp_geometry(
    inv_view: np.ndarray, width: int, height: int, focal: float = 2.0
):
    """Host-side geometry: principal axis, slopes per pixel, validity.

    Returns ``(axis, perm, slopes (H, W, 2), dz_sign, ok)`` where slopes are
    (mx, my) in PERMUTED volume axes.
    """
    inv_view = np.asarray(inv_view, dtype=np.float32)
    rot = inv_view[:, :3]
    d_cam = _pixel_grid(width, height, focal)  # (H, W, 3)
    d_world = d_cam @ rot.T  # (H, W, 3) in (x, y, z) world order
    view_dir = rot @ np.array([0.0, 0.0, -1.0], dtype=np.float32)
    axis = int(np.argmax(np.abs(view_dir)))  # world axis index
    px, py, pz = _PERMS[axis]
    dz = d_world[..., pz]
    ok = bool((dz > 1e-6).all() or (dz < -1e-6).all())
    dz_sign = 1 if float(dz.flat[0]) > 0 else -1
    mx = d_world[..., px] / dz
    my = d_world[..., py] / dz
    return axis, (px, py, pz), np.stack([mx, my], axis=-1), dz_sign, ok


def _principal_axis_geometry(
    inv_view: np.ndarray, width: int, height: int, focal: float = 2.0
):
    """O(1) host geometry: ``(axis, perm, dz_sign, ok)`` from the 3x3 alone.

    ``d_z(u, v)`` is AFFINE in the pixel coords, so its sign over the whole
    image is decided at the four corners of the actual pixel rectangle
    (u in [-1, 1 - 2/W], v in [-1, 1 - 2/H]) — exactly equivalent to
    :func:`shearwarp_geometry`'s all-pixels check without building (H, W)
    grids on the host: host work is 3x3 numpy."""
    inv_view = np.asarray(inv_view, dtype=np.float32)
    rot = inv_view[:, :3]
    view_dir = rot @ np.array([0.0, 0.0, -1.0], dtype=np.float32)
    axis = int(np.argmax(np.abs(view_dir)))
    px, py, pz = _PERMS[axis]
    u_ext = np.array([-1.0, 1.0 - 2.0 / width], dtype=np.float32)
    v_ext = np.array([-1.0, 1.0 - 2.0 / height], dtype=np.float32)
    dz = (
        u_ext[None, :] * rot[pz, 0]
        + v_ext[:, None] * rot[pz, 1]
        - focal * rot[pz, 2]
    )
    ok = bool((dz > 1e-6).all() or (dz < -1e-6).all())
    dz_sign = 1 if float(dz[0, 0]) > 0 else -1
    return axis, (px, py, pz), dz_sign, ok


def shearwarp_applicable(
    inv_view: np.ndarray, width: int = 64, height: int = 64, focal: float = 2.0
) -> bool:
    """True if d_z keeps one sign over the image for the best principal axis."""
    *_, ok = _principal_axis_geometry(inv_view, width, height, focal)
    return ok


def _bilinear_warp_2d_traced(
    img: jnp.ndarray, ix: jnp.ndarray, iy: jnp.ndarray
) -> jnp.ndarray:
    """Traced twin of :func:`_bilinear_warp_2d`: the index maps are DATA, so
    one compiled executable serves every view."""
    hi, wi = img.shape[0], img.shape[1]
    x0 = jnp.clip(jnp.floor(ix).astype(jnp.int32), 0, wi - 1)
    y0 = jnp.clip(jnp.floor(iy).astype(jnp.int32), 0, hi - 1)
    x1 = jnp.clip(x0 + 1, 0, wi - 1)
    y1 = jnp.clip(y0 + 1, 0, hi - 1)
    fx = (ix - jnp.floor(ix))[..., None]
    fy = (iy - jnp.floor(iy))[..., None]
    c00 = img[y0, x0]
    c01 = img[y0, x1]
    c10 = img[y1, x0]
    c11 = img[y1, x1]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def slope_corner_bounds(
    inv_view: np.ndarray, width: int, height: int, focal: float = 2.0
):
    """O(1) host geometry for the distributed rotated paths:
    ``(axis, (px, py, pz), dz_sign, ok, (mx_lo, mx_hi, my_lo, my_hi))``.

    The slopes ``mx(u, v) = d_px / d_pz`` are linear-fractional in the pixel
    coords (both components affine, ``d_pz`` of constant sign whenever
    ``ok``); restricted to an axis-parallel edge of the pixel rectangle the
    derivative's numerator is constant, so each edge is monotone and the
    extremes over the rectangle sit at its 4 CORNERS. These are exactly the
    m-grid bounds :func:`shearwarp_geometry` reads off the full (H, W)
    grid for Θ(H·W) host work (the per-pixel warp maps are built on device
    by :func:`_warp_from_rotation_traced` inside the fused frame jits)."""
    inv_view = np.asarray(inv_view, dtype=np.float32)
    axis, (px, py, pz), dz_sign, ok = _principal_axis_geometry(
        inv_view, width, height, focal
    )
    rot = inv_view[:, :3]
    u_ext = np.array([-1.0, 1.0 - 2.0 / width], dtype=np.float32)
    v_ext = np.array([-1.0, 1.0 - 2.0 / height], dtype=np.float32)
    uu, vv = np.meshgrid(u_ext, v_ext)
    d = np.stack([uu, vv, -focal * np.ones_like(uu)], axis=-1) @ rot.T
    mx = d[..., px] / d[..., pz]
    my = d[..., py] / d[..., pz]
    return axis, (px, py, pz), dz_sign, ok, (
        float(mx.min()), float(mx.max()), float(my.min()), float(my.max())
    )


def _warp_from_rotation_traced(
    img_m, rot, mgrid, width, height, focal, perm_world
):
    """Homography warp m-space → pixels with the per-pixel index maps built
    ON DEVICE from the 3×3 rotation — 13 traced floats per frame instead of
    two (H, W) host index maps (cf. volumeRender.cpp:225-232's
    copyInvViewMatrix-only upload). ``mgrid = [mx0, dmx, my0, dmy]`` are
    the m-grid's origin/spacing (traced); ``perm_world = (px, py, pz)``."""
    px, py, pz = perm_world
    u = ((jnp.arange(width, dtype=jnp.float32) / width) * 2.0 - 1.0)[None, :]
    v = ((jnp.arange(height, dtype=jnp.float32) / height) * 2.0 - 1.0)[:, None]

    def d_world(i):
        return u * rot[i, 0] + v * rot[i, 1] - focal * rot[i, 2]

    dzc = d_world(pz)
    mx_all = d_world(px) / dzc
    my_all = d_world(py) / dzc
    return _bilinear_warp_2d_traced(
        img_m, (mx_all - mgrid[0]) / mgrid[1], (my_all - mgrid[2]) / mgrid[3]
    )


def _bilinear_warp_2d(
    img: jnp.ndarray, ix: np.ndarray, iy: np.ndarray
) -> jnp.ndarray:
    """Sample (Hi, Wi, C) image at fractional index maps ix/iy (H, W)."""
    hi, wi = img.shape[0], img.shape[1]
    x0 = np.clip(np.floor(ix).astype(np.int32), 0, wi - 1)
    y0 = np.clip(np.floor(iy).astype(np.int32), 0, hi - 1)
    x1 = np.clip(x0 + 1, 0, wi - 1)
    y1 = np.clip(y0 + 1, 0, hi - 1)
    fx = jnp.asarray((ix - np.floor(ix)).astype(np.float32))[..., None]
    fy = jnp.asarray((iy - np.floor(iy)).astype(np.float32))[..., None]
    c00 = img[y0, x0]
    c01 = img[y0, x1]
    c10 = img[y1, x0]
    c11 = img[y1, x1]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def shearwarp_render_image(
    volume: jnp.ndarray,
    inv_view: np.ndarray,
    width: int,
    height: int,
    tf_lut: jnp.ndarray,
    density: jnp.ndarray = 0.05,
    brightness: jnp.ndarray = 1.0,
    transfer_offset: jnp.ndarray = 0.0,
    transfer_scale: jnp.ndarray = 1.0,
    march: MarchConfig = MarchConfig(),
    focal: float = 2.0,
    n_planes: int = 0,
    oversample: float = 2.0,
    length_correction: bool = True,
    compute_dtype=jnp.float32,
    plane_chunk: int = 8,
    use_custom_vjp: bool = True,
    tex_offset: float = 0.5,
    axis_scale=(1.0, 1.0, 1.0),
    pack_u8: bool = False,
) -> jnp.ndarray:
    """Render ``(H, W, 4)`` RGBA for an ARBITRARY view on the matmul sweep.

    ``inv_view`` is the reference's 3x4 camera-to-world matrix as a HOST numpy
    array (the view is static per compile).
    ``oversample`` scales the intermediate m-grid resolution relative to the
    output image (2.0 keeps the warp's filtering loss ~1e-2).

    ``axis_scale`` are per-WORLD-axis (sx, sy, sz) filter-grid scales (the
    padded-grid form of the flexible-block unnormalized fetch,
    volumeRender_kernel.cu:654-680); they are permuted together with the
    volume axes, so rotated flexible-block queries (8/9/0) ride this fast
    path too.
    """
    inv_view = np.asarray(inv_view, dtype=np.float32)
    axis, (px, py, pz), dz_sign, ok = _principal_axis_geometry(
        inv_view, width, height, focal
    )
    if not ok:
        raise ValueError(
            "shear-warp inapplicable: d_z changes sign across the image "
            "(FOV too wide / degenerate view); use the scan marcher"
        )

    # permute volume (Z, Y, X) axes so the principal world axis becomes z'.
    # volume array axis for world axis w is (2 - w).
    volume = jnp.asarray(volume)
    origin_w = inv_view[:, 3]
    box_min = np.asarray(march.box_min, dtype=np.float32)
    box_max = np.asarray(march.box_max, dtype=np.float32)
    march_p = MarchConfig(
        max_steps=march.max_steps,
        tstep=march.tstep,
        opacity_threshold=march.opacity_threshold,
        box_min=(float(box_min[px]), float(box_min[py]), float(box_min[pz])),
        box_max=(float(box_max[px]), float(box_max[py]), float(box_max[pz])),
    )
    ascale_p = (
        float(axis_scale[px]), float(axis_scale[py]), float(axis_scale[pz])
    )

    # bounding m-grid resolution
    wi = max(8, int(np.ceil(width * oversample)))
    hi = max(8, int(np.ceil(height * oversample)))

    # host per-pixel slopes + host m-grid (view-static compile)
    *_, slopes, _, _ = shearwarp_geometry(inv_view, width, height, focal)
    mx_all, my_all = slopes[..., 0], slopes[..., 1]
    mx_lo, mx_hi = float(mx_all.min()), float(mx_all.max())
    my_lo, my_hi = float(my_all.min()), float(my_all.max())
    mx_pad = max(1e-6, (mx_hi - mx_lo) / wi)
    my_pad = max(1e-6, (my_hi - my_lo) / hi)
    mx = np.linspace(mx_lo - mx_pad, mx_hi + mx_pad, wi, dtype=np.float32)
    my = np.linspace(my_lo - my_pad, my_hi + my_pad, hi, dtype=np.float32)

    # homography warp index maps m-space -> pixels (host fractional indices)
    ix = (mx_all - mx[0]) / (mx[-1] - mx[0]) * (wi - 1)
    iy = (my_all - my[0]) / (my[-1] - my[0]) * (hi - 1)

    vol_perm = jnp.transpose(volume, (2 - pz, 2 - py, 2 - px))
    origin_p = np.array(
        [origin_w[px], origin_w[py], origin_w[pz]], dtype=np.float32
    )
    img_m = sweep_slope_space(
        vol_perm, origin_p, mx, my, tf_lut,
        density, brightness, transfer_offset, transfer_scale, march_p,
        dz_sign=dz_sign, n_planes=n_planes,
        length_correction=length_correction, compute_dtype=compute_dtype,
        plane_chunk=plane_chunk, use_custom_vjp=use_custom_vjp,
        tex_offset=tex_offset, axis_scale=ascale_p,
    )

    # final warp (static fractional indices)
    img = _bilinear_warp_2d(img_m, ix, iy)
    if pack_u8:
        from vrdd_tpu.core.image import rgba_to_uint8

        out = rgba_to_uint8(img)
        return out[..., :3] if pack_u8 == 3 else out
    return img
