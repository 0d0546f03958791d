"""Object-order slice-sweep renderer — the matmul fast path.

Instead of per-sample 3-D gathers (the direct translation of d_render's
tex3D fetches), this module renders *object-order*: sweep the volume's Z
planes front-to-back, resample each plane onto the image with two small
matrix products, and composite it into the image. Whether this beats the
image-order marcher (vrdd_tpu/march/scan.py) on a GPU, which gathers
natively, is an open measurement.

The core factorization is **ray-slope space**: parameterize each pinhole ray
by its slope ``m = (d_x / d_z, d_y / d_z)`` in volume axes. On the plane
``z = zk`` the ray position is

    x(m, zk) = o_x + (zk - o_z) * m_x
    y(m, zk) = o_y + (zk - o_z) * m_y      (exact; normalization cancels)

i.e. every volume plane maps onto a uniform m-grid by a per-plane SCALE +
TRANSLATE — a separable resample:

    resampled = Wy(zk) @ plane @ Wx(zk)^T,     Wx: (Wi, X), Wy: (Hi, Y)

with bilinear CUDA-model weights (2 nonzeros/row, built densely on the fly).
The transfer-function lookup is an unrolled tent-basis FMA over the small
LUT; there are no gathers. Compositing in m-space is per-ray exact (each
m-grid point IS one ray through the camera), with per-ray slab path length
``dz * sqrt(1 + mx^2 + my^2)``.

Precision: the resample products run at the backend's DEFAULT matmul
precision, which on an H100 is TF32 for these f32 operands. The weights are
exact in TF32 only to ~1e-3, so each resampled value carries ~1e-3 relative
rounding; chip_smoke.py measures the 1024^2 image against a HIGHEST-precision
render and against the scan marcher and checks it stays inside the
reference's golden tolerance (5/255 per pixel). Callers that need float32
resampling wrap the call in ``jax.default_matmul_precision("highest")``.

For the reference's unrotated benchmark camera (volumeRender.cpp:1024-1043)
the m-grid equals the pixel grid (``m = (u, v) / -focal``) and
:func:`slice_render_image` renders directly. For ARBITRARY rotated views, the
same sweep runs on a bounding m-grid and one final 2-D homography warp maps
m-space to pixels — see ``vrdd_tpu.march.shearwarp`` (the perspective
shear-warp factorization, Lacroute & Levoy).

Discretization difference vs the ray-order marcher: samples lie on constant-z
planes instead of constant-t shells, with per-ray segment length
``dz_plane * |d| / |d_z|``. With ``length_correction=True`` (default), sample
opacity is scaled by ``segment / tstep`` so the sweep converges to the same
integral; parity tests compare against the scan marcher with tolerances, while
bit-exact reference parity remains the scan path's job.

Backward pass: compositing is an associative "over" chain, so the output
factors as ``out = sum_k m_k T_{k-1} c_k`` with transmittance
``T_{k-1} = prod_{j<k} (1 - m_j a_j)`` and freeze mask ``m_k`` (early
termination). The analytic custom VJP exploits this: cotangents are

    dL/dc_k[rgb] = m_k T_{k-1} g[rgb]
    dL/dc_k[a]   = m_k ( T_{k-1} g[a] - S_k / (1 - a_k) ),
    S_k = sum_{j>k} m_j (g . c_j) T_{j-1}   (suffix sums, two extra sweeps)

so backward memory is O(1) in plane count (no per-step residuals, no
full-volume cotangent carries) and cost ~3x forward. The per-plane local
transposes (TF lookup, separable resample) are delegated to jax.vjp of the
plane-decode function. Gradient parity vs plain autodiff is pinned in tests.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vrdd_tpu.utils.config import MarchConfig


def _axis_weights(
    coords: jnp.ndarray, n: int, lo: float, hi: float,
    tex_offset: float = 0.5, scale: float = 1.0, linear: bool = True,
) -> jnp.ndarray:
    """Dense CUDA-model bilinear weight matrix (P, n) for world coords (P,).

    Out-of-box coords (outside [lo, hi]) get all-zero rows (no contribution);
    in-box coords clamp to edge texels exactly like the texture unit.

    ``tex_offset`` selects the filtering convention: 0.5 is the CUDA texture
    model (texel centers at (i + 0.5) / n); 0.0 is the block-boundary grid of
    the reference's query 7 (volumeRender_kernel.cu:395-478), whose cell is
    ``[floor(p01 * n), ceil(p01 * n)]`` with index clamping.

    ``scale`` decouples the filter grid from the coverage box: the filter
    coordinate is ``p01 * scale * n - tex_offset`` while coverage stays
    ``p01 in [0, 1]``. The flexible-block fetch (queries 8/9/0) is the CUDA
    *unnormalized* fetch ``p01 * n_blocks - 0.5`` against an (n_blocks + 1)
    zero-padded grid (volumeRender_kernel.cu:654-680, 1637-1691) — i.e.
    ``scale = n_blocks / (n_blocks + 1)`` here.
    """
    p01 = (coords - lo) / (hi - lo)
    xf = p01 * (n * scale) - tex_offset
    i0 = jnp.floor(xf)
    a = xf - i0
    if not linear:
        # CUDA point sampling T[clamp(floor(p01 * n * scale))]: snapping the
        # lerp weight to the near tap selects exactly that texel (ties at
        # a == 0.5 go up, matching floor(xf + 0.5))
        a = jnp.floor(a + 0.5)
    i0i = i0.astype(jnp.int32)
    lo_idx = jnp.clip(i0i, 0, n - 1)
    hi_idx = jnp.clip(i0i + 1, 0, n - 1)
    in_box = (p01 >= 0.0) & (p01 <= 1.0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (coords.shape[0], n), 1)
    w = (
        jnp.where(cols == lo_idx[:, None], (1.0 - a)[:, None], 0.0)
        + jnp.where(cols == hi_idx[:, None], a[:, None], 0.0)
    )
    return jnp.where(in_box[:, None], w, 0.0)


def _tf_onehot_matmul(
    sample: jnp.ndarray, lut: jnp.ndarray, offset: jnp.ndarray, scale: jnp.ndarray
) -> jnp.ndarray:
    """TF lookup as an unrolled tent-basis FMA: scalars (...,) -> RGBA (..., 4).

    Linear LUT interpolation with clamp equals a sum of tent basis functions:
    with ``q = clip(u * n - 0.5, 0, n - 1)``,
    ``col = sum_l max(0, 1 - |q - l|) * lut[l]``. The unrolled form fuses into
    pure elementwise work — no (..., n) one-hot tensor ever materializes
    (which would dominate memory traffic at image scale).
    """
    n = lut.shape[0]
    q = jnp.clip((sample - offset) * scale * n - 0.5, 0.0, n - 1.0)
    col = None
    for li in range(n):
        w = jnp.maximum(0.0, 1.0 - jnp.abs(q - li))[..., None]
        term = w * lut[li]
        col = term if col is None else col + term
    return col


def sweep_slope_space(
    volume: jnp.ndarray,
    origin,
    mx: np.ndarray,
    my: np.ndarray,
    tf_lut: jnp.ndarray,
    density: jnp.ndarray = 0.05,
    brightness: jnp.ndarray = 1.0,
    transfer_offset: jnp.ndarray = 0.0,
    transfer_scale: jnp.ndarray = 1.0,
    march: MarchConfig = MarchConfig(),
    dz_sign: int = -1,
    n_planes: int = 0,
    length_correction: bool = True,
    compute_dtype=jnp.float32,
    plane_chunk: int = 8,
    use_custom_vjp: bool = True,
    tex_offset: float = 0.5,
    axis_scale=(1.0, 1.0, 1.0),
    filter_linear: bool = True,
) -> jnp.ndarray:
    """Plane sweep over a ray-slope grid: returns ``(Hi, Wi, 4)`` RGBA.

    ``volume`` is a scalar field ``(Z, Y, X)``; ``origin`` the camera position
    (in volume axes); ``mx (Wi,)`` / ``my (Hi,)`` HOST numpy slope grids
    (``m = d_xy / d_z`` per ray); ``dz_sign`` the common sign of d_z over the
    grid. Each (my[i], mx[j]) point is one ray; the output is the composited
    image in slope space. ``n_planes`` defaults to 2 * Z. ``use_custom_vjp``
    selects the analytic O(1)-memory backward (disable for higher-order
    differentiation).

    Static grid constants are built with numpy on the host so they embed as
    literals instead of device constants.
    """
    volume = jnp.asarray(volume)
    nz, ny, nx = volume.shape
    if n_planes <= 0:
        n_planes = 2 * nz
    origin = jnp.asarray(origin, dtype=jnp.float32)
    ox, oy, oz = origin[0], origin[1], origin[2]
    (xlo, ylo, zlo) = march.box_min
    (xhi, yhi, zhi) = march.box_max
    mx = np.asarray(mx, dtype=np.float32)
    my = np.asarray(my, dtype=np.float32)
    width, height = mx.shape[0], my.shape[0]

    # Plane schedule: front-to-back along the viewing direction. d_z < 0 means
    # the nearest plane has the largest z.
    spacing = (zhi - zlo) / n_planes
    zs = (zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)).astype(
        np.float32
    )
    if dz_sign < 0:
        zs = zs[::-1].copy()

    # Pre-blend all sampling planes with static two-tap gather lerps (two
    # CUDA-model bilinear weights per plane; index clamp, az from the
    # unclipped floor). Outside the sweep, so the volume cotangent is a pair
    # of static scatter-adds. Exact f32: an (n_planes, nz) matmul form would
    # run at the default (reduced) matmul precision and round the volume.
    sx, sy, sz = axis_scale  # filter-grid scales; see _axis_weights
    zf_all = (zs - zlo) / (zhi - zlo) * (nz * sz) - tex_offset
    iz0_all = np.floor(zf_all)
    az_all = (zf_all - iz0_all).astype(np.float32)
    # BOTH taps clamp from the unclipped floor (the CUDA texture model and
    # _axis_weights): for floor = -1 the pair is (0, 0) = the edge texel.
    # Clipping iz0 first and adding 1 after leaked the below-range tap onto
    # texel 1 — a half-texel band error at the low-z face, systematic (it
    # does not shrink with n_planes) and visible on +z-looking cameras where
    # the band is unoccluded (worst on coarse flexible-block grids).
    if not filter_linear:  # point sampling: snap the z lerp to the near tap
        az_all = np.floor(az_all + 0.5).astype(np.float32)
    iz1_all = np.clip(iz0_all.astype(np.int64) + 1, 0, nz - 1)
    iz0_all = np.clip(iz0_all.astype(np.int64), 0, nz - 1)
    if np.all(az_all < 1e-6):
        planes_all = volume[jnp.asarray(iz0_all)]  # pure (reversed) selection
    else:
        azj = jnp.asarray(az_all)[:, None, None]
        planes_all = (
            volume[jnp.asarray(iz0_all)] * (1.0 - azj)
            + volume[jnp.asarray(iz1_all)] * azj
        )

    return sweep_preblended_planes_xla(
        planes_all, zs, origin, mx, my, tf_lut, density, brightness,
        transfer_offset, transfer_scale, march, dz_sign=dz_sign,
        plane_spacing=spacing, length_correction=length_correction,
        compute_dtype=compute_dtype, plane_chunk=plane_chunk,
        use_custom_vjp=use_custom_vjp, tex_offset=tex_offset,
        axis_scale=(sx, sy), filter_linear=filter_linear,
    )


def sweep_preblended_planes_xla(
    planes_all,
    zs: np.ndarray,
    origin,
    mx: np.ndarray,
    my: np.ndarray,
    tf_lut: jnp.ndarray,
    density: jnp.ndarray = 0.05,
    brightness: jnp.ndarray = 1.0,
    transfer_offset: jnp.ndarray = 0.0,
    transfer_scale: jnp.ndarray = 1.0,
    march: MarchConfig = MarchConfig(),
    *,
    dz_sign: int = -1,
    plane_spacing=None,
    length_correction: bool = True,
    compute_dtype=jnp.float32,
    plane_chunk: int = 8,
    use_custom_vjp: bool = True,
    tex_offset: float = 0.5,
    axis_scale=(1.0, 1.0),
    filter_linear: bool = True,
    acc_init=None,
) -> jnp.ndarray:
    """Masked-scan sweep over an ALREADY pre-blended plane stack.

    ``planes_all (P, NY, NX)`` is a front-to-back plane stack, ``zs (P,)``
    its HOST-side plane depths, and
    ``acc_init`` an optional (H, W, 4) premultiplied-RGBA seed that resumes
    the "over" recursion mid-flight — seeded pixels past the opacity
    threshold freeze instantly. ``plane_spacing`` must be the FULL stack's
    inter-plane distance when ``planes_all`` is a partial stack (a streamed
    decode chunk, a z-slab).

    The custom VJP produces cotangents for the plane stack, TF LUT, render
    params AND the seed (``d seed_rgb = g_rgb``, ``d seed_a = g_a -
    P_total / T_0`` with ``T_0 = 1 - seed_a``), so chained chunk sweeps
    backpropagate exactly.
    """
    planes_all = jnp.asarray(planes_all)
    n_planes, ny, nx = planes_all.shape
    origin = jnp.asarray(origin, dtype=jnp.float32)
    (xlo, ylo, zlo) = march.box_min
    (xhi, yhi, zhi) = march.box_max
    mx = np.asarray(mx, dtype=np.float32)
    my = np.asarray(my, dtype=np.float32)
    width, height = mx.shape[0], my.shape[0]
    zs = np.asarray(zs, dtype=np.float32)
    sx, sy = axis_scale
    if plane_spacing is None:
        plane_spacing = (zhi - zlo) / n_planes

    # Per-ray world path length through one slab: dz * |d| / |d_z|.
    stretch = np.sqrt(1.0 + my[:, None] ** 2 + mx[None, :] ** 2)
    alpha_scale = (
        (plane_spacing * stretch / march.tstep).astype(np.float32)
        if length_correction
        else np.ones((height, width), dtype=np.float32)
    )

    dtype = compute_dtype
    thr = march.opacity_threshold

    chunk = plane_chunk
    while n_planes % chunk:
        chunk -= 1
    n_chunks = n_planes // chunk
    zs_c = jnp.asarray(zs.reshape(n_chunks, chunk))
    planes_c = planes_all.reshape(n_chunks, chunk, ny, nx)

    def chunk_rgba(z, planes, lut, density_, toff, tscl, orig):
        """Per-plane premultiplied RGBA for one chunk: (C, H, W, 4).

        Everything except compositing: separable resample (batched matmuls),
        TF lookup, opacity scaling and coverage masking.
        """
        # origin is an EXPLICIT argument (not a closure): a closed-over
        # origin tracer leaks out of the custom_vjp under jax.checkpoint
        # (the streamed-decode chunk bodies remat this whole sweep)
        ox, oy, oz = orig[0], orig[1], orig[2]
        x_at = ox + (z[:, None] - oz) * mx[None, :]  # (C, W)
        y_at = oy + (z[:, None] - oz) * my[None, :]  # (C, H)
        wx = _axis_weights(
            x_at.reshape(-1), nx, xlo, xhi, tex_offset, sx, filter_linear
        ).reshape(chunk, width, nx).astype(dtype)
        wy = _axis_weights(
            y_at.reshape(-1), ny, ylo, yhi, tex_offset, sy, filter_linear
        ).reshape(chunk, height, ny).astype(dtype)
        tmp = jax.lax.dot_general(
            wy, planes.astype(dtype), (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # (C, H, X)
        resampled = jax.lax.dot_general(
            tmp.astype(dtype), wx, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # (C, H, W)
        col = _tf_onehot_matmul(resampled, lut, toff, tscl)
        # t > 0 <=> (z - oz) has the sign of d_z — a per-plane scalar
        in_front = (jnp.sign(z - oz) * dz_sign) > 0  # (C,)
        covered = (
            (jnp.sum(jnp.abs(wy), axis=2) > 0.0)[:, :, None]
            & (jnp.sum(jnp.abs(wx), axis=2) > 0.0)[:, None, :]
            & in_front[:, None, None]
        )
        # clamp to 1: opacity is a probability, and the "over" recursion (and
        # the exact distributed-ET scheme) require monotone alpha. The
        # reference keeps a <= 1 by construction (TF alpha x density <= 1);
        # only the slab length correction can overshoot.
        a = jnp.where(
            covered,
            jnp.minimum(col[..., 3] * density_ * alpha_scale[None], 1.0),
            0.0,
        )
        rgb = col[..., :3] * a[..., None]
        return jnp.concatenate([rgb, a[..., None]], axis=-1)

    seed0 = (
        jnp.zeros((height, width, 4), dtype=jnp.float32)
        if acc_init is None
        else jnp.asarray(acc_init, dtype=jnp.float32)
    )

    def primal(planes_c, zs_cj, lut, density_, toff, tscl, acc0, orig):
        def body(acc, xs):
            z, planes = xs
            rgba_all = chunk_rgba(z, planes, lut, density_, toff, tscl, orig)
            for k in range(chunk):
                new_acc = acc + rgba_all[k] * (1.0 - acc[..., 3:4])
                acc = jnp.where(acc[..., 3:4] > thr, acc, new_acc)
            return acc, None

        acc, _ = jax.lax.scan(jax.checkpoint(body), acc0, (zs_cj, planes_c))
        return acc

    if not use_custom_vjp:
        acc = primal(planes_c, zs_c, tf_lut,
                     jnp.asarray(density, jnp.float32),
                     jnp.asarray(transfer_offset, jnp.float32),
                     jnp.asarray(transfer_scale, jnp.float32), seed0, origin)
        return acc * jnp.asarray(brightness, dtype=jnp.float32)

    # zs_c and origin are EXPLICIT custom_vjp arguments: any traced (or
    # trace-constant) value captured in a closure here escapes its trace
    # when the whole sweep is rematerialized (jax.checkpoint around the
    # streamed-decode chunk bodies)
    @jax.custom_vjp
    def sweep(planes_c, zs_cj, lut, density_, toff, tscl, acc0, orig):
        return primal(planes_c, zs_cj, lut, density_, toff, tscl, acc0, orig)

    def sweep_fwd(planes_c, zs_cj, lut, density_, toff, tscl, acc0, orig):
        acc = primal(planes_c, zs_cj, lut, density_, toff, tscl, acc0, orig)
        return acc, (planes_c, zs_cj, lut, density_, toff, tscl, acc0, orig)

    def sweep_bwd(res, g):
        planes_c, zs_cj, lut, density_, toff, tscl, acc0, orig = res

        # Sweep 1: total P = sum_k m_k (g . c_k) T_{k-1}.
        def pass1(carry, xs):
            T, Psum = carry
            z, planes = xs
            rgba_all = chunk_rgba(z, planes, lut, density_, toff, tscl,
                                  orig)
            for k in range(chunk):
                m = T >= 1.0 - thr
                P_k = jnp.where(
                    m, jnp.sum(g * rgba_all[k], axis=-1) * T, 0.0
                )
                Psum = Psum + P_k
                T = jnp.where(m, T * (1.0 - rgba_all[k][..., 3]), T)
            return (T, Psum), None

        # seeded start: the transmittance entering plane 0 is 1 - seed_a
        T0 = 1.0 - acc0[..., 3]
        zeros = jnp.zeros((height, width), dtype=jnp.float32)
        (_, Ptot), _ = jax.lax.scan(
            jax.checkpoint(pass1), (T0, zeros), (zs_cj, planes_c)
        )

        # Sweep 2: assemble per-plane cotangents, transpose locally via vjp.
        def pass2(carry, xs):
            T, Ppre, g_lut, g_dens, g_toff, g_tscl = carry
            z, planes = xs
            rgba_all, chunk_vjp = jax.vjp(
                lambda p, l, d, to, ts: chunk_rgba(z, p, l, d, to, ts, orig),
                planes, lut, density_, toff, tscl,
            )
            d_rgba = []
            for k in range(chunk):
                m = T >= 1.0 - thr
                c_k = rgba_all[k]
                P_k = jnp.where(m, jnp.sum(g * c_k, axis=-1) * T, 0.0)
                Ppre = Ppre + P_k
                S_k = Ptot - Ppre
                mT = jnp.where(m, T, 0.0)
                d_rgb = mT[..., None] * g[..., :3]
                one_minus_a = 1.0 - c_k[..., 3]
                chain = jnp.where(
                    jnp.abs(one_minus_a) > 1e-6, S_k / one_minus_a, 0.0
                )
                d_a = jnp.where(m, T * g[..., 3] - chain, 0.0)
                d_rgba.append(jnp.concatenate([d_rgb, d_a[..., None]], -1))
                T = jnp.where(m, T * one_minus_a, T)
            dp, dl, dd, dto, dts = chunk_vjp(jnp.stack(d_rgba, axis=0))
            return (
                (T, Ppre, g_lut + dl, g_dens + dd, g_toff + dto, g_tscl + dts),
                dp,
            )

        carry0 = (
            T0, zeros, jnp.zeros_like(lut), jnp.zeros_like(density_),
            jnp.zeros_like(toff), jnp.zeros_like(tscl),
        )
        (_, _, g_lut, g_dens, g_toff, g_tscl), g_planes = jax.lax.scan(
            jax.checkpoint(pass2), carry0, (zs_cj, planes_c)
        )
        # seed cotangent: out = seed + sum_k m_k c_k T_{k-1} with every
        # T_{k-1} proportional to T_0 = 1 - seed_a, so
        # d seed_rgb = g_rgb and d seed_a = g_a - P_total / T_0 (fully
        # saturated seeds contribute nothing: P_total = 0 there).
        dsa = g[..., 3] - jnp.where(T0 > 1e-6, Ptot / jnp.where(
            T0 > 1e-6, T0, 1.0), 0.0)
        d_acc0 = jnp.concatenate([g[..., :3], dsa[..., None]], axis=-1)
        # origin is geometry, not a fit parameter on this path: zero
        # cotangent (use use_custom_vjp=False to differentiate camera pose)
        return g_planes, jnp.zeros_like(zs_cj), g_lut, g_dens, g_toff, \
            g_tscl, d_acc0, jnp.zeros_like(orig)

    sweep.defvjp(sweep_fwd, sweep_bwd)

    brightness = jnp.asarray(brightness, dtype=jnp.float32)
    acc = sweep(
        planes_c, zs_c, tf_lut, jnp.asarray(density, jnp.float32),
        jnp.asarray(transfer_offset, jnp.float32),
        jnp.asarray(transfer_scale, jnp.float32), seed0, origin,
    )
    return acc * brightness


def slice_render_image(
    volume: jnp.ndarray,
    origin: jnp.ndarray,
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
    length_correction: bool = True,
    compute_dtype=jnp.float32,
    plane_chunk: int = 8,
    use_custom_vjp: bool = True,
    tex_offset: float = 0.5,
    axis_scale=(1.0, 1.0, 1.0),
    filter_linear: bool = True,
) -> jnp.ndarray:
    """Render ``(H, W, 4)`` RGBA by plane sweep (unrotated camera at ``origin``).

    The reference's NDC frustum looking down -z: ray slopes are
    ``m = (u, v) / -focal`` so the m-grid IS the pixel grid and no final warp
    is needed. For rotated views see ``vrdd_tpu.march.shearwarp``.
    """
    u = ((np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0).astype(
        np.float32
    )
    v = ((np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0).astype(
        np.float32
    )
    return sweep_slope_space(
        volume, origin, u / (-focal), v / (-focal), tf_lut,
        density, brightness, transfer_offset, transfer_scale, march,
        dz_sign=-1, n_planes=n_planes, length_correction=length_correction,
        compute_dtype=compute_dtype, plane_chunk=plane_chunk,
        use_custom_vjp=use_custom_vjp, tex_offset=tex_offset,
        axis_scale=axis_scale, filter_linear=filter_linear,
    )
