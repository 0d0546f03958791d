"""Distributed object-order sweep: z-slabs on bricks, image rows on rays.

The single-device slice sweep (vrdd_tpu/march/slice.py) is the per-chip fast
path; this module scales it over the ("bricks", "rays") mesh
(vrdd_tpu/parallel/mesh.py):

- the volume's Z axis is sharded into slabs on the ``bricks`` axis; each
  device PRE-BLENDS only the sweep planes falling inside its slab (one
  ghost layer each side via ``ppermute`` covers cross-slab bilinear
  taps) and sweeps them with the same separable-matmul resample + composite,
- image ROWS are sharded on the ``rays`` axis (each device resamples only
  its row strip: the Wy matmul shrinks proportionally),
- per-slab partial images combine front-to-back with the associative "over"
  operator — sort-last compositing, the compositing-tree analogue of
  context/sequence parallelism (SURVEY.md §5),
- early ray termination is EXACT at plane granularity via a two-pass
  scheme (cf. vrdd_tpu/parallel/bricks.py): pass 1 sweeps the slabs and
  locates, per pixel, the slab where accumulated alpha crosses the
  threshold plus the upstream prefix entering it; pass 2 re-sweeps only
  that slab, RESUMING the sequential recursion from the true prefix (a
  per-pixel local freeze threshold derived from the prefix alpha).

Unlike the host-static single-device path, per-device quantities (plane
z-values, row coordinates) arrive as SHARDED ARRAYS — shard_map traces one
program for all devices, so anything device-dependent must be data, not
Python constants. The plane pre-blend therefore builds its z tent weights in
jnp (same CUDA-model math as the host path).

Distribution volumes (bins-major ``(Z, B, Y, X)`` histograms) ride the same
sweep: each brick decodes its own histogram slab to the requested statistic
(ops/histogram.py ``decode_with_rows``) and sweeps the decoded slab.

The reference has no distribution at all (single process, single GPU;
SURVEY.md §2.3).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vrdd_tpu.march.slice import _axis_weights, _tf_onehot_matmul
from vrdd_tpu.ops.histogram import decode_with_rows
from vrdd_tpu.parallel.bricks import _halo_exchange
from vrdd_tpu.parallel.mesh import BRICK_AXIS, RAY_AXIS
from vrdd_tpu.utils.config import MarchConfig


def shard_scalar_volume(volume, mesh: Mesh):
    """Place a (Z, Y, X) scalar volume sharded over Z on the bricks axis."""
    return jax.device_put(
        volume, NamedSharding(mesh, P(BRICK_AXIS, None, None))
    )


def shard_hist_volume(hist_bm, mesh: Mesh):
    """Place a bins-major (Z, B, Y, X) DISTRIBUTION volume z-slab-sharded
    on the bricks axis (the layout :func:`distributed_hist_render`
    consumes — each brick decodes its own histogram slab)."""
    return jax.device_put(
        hist_bm, NamedSharding(mesh, P(BRICK_AXIS, None, None, None))
    )


def _local_sweep(
    planes: jnp.ndarray,  # (P, Y, X) front-to-back
    zs: jnp.ndarray,  # (P,)
    mx: np.ndarray,  # (W,) host
    my: jnp.ndarray,  # (Hl,) traced (row-sharded)
    origin: jnp.ndarray,
    tf_lut, density, toff, tscl,
    alpha_scale: jnp.ndarray,  # (Hl, W)
    box, threshold, plane_chunk: int, dz_sign: int = -1,
    tex_offset: float = 0.5, axis_scale=(1.0, 1.0),
):
    """Front-to-back composite of pre-blended planes on a row strip.

    ``threshold`` is a per-pixel (Hl, W) freeze level (>1 disables ET).
    """
    (xlo, ylo, zlo), (xhi, yhi, zhi) = box
    n_planes, ny, nx = planes.shape
    width, height = mx.shape[0], my.shape[0]
    ox, oy, oz = origin[0], origin[1], origin[2]

    chunk = plane_chunk
    while n_planes % chunk:
        chunk -= 1
    n_chunks = n_planes // chunk
    zs_c = zs.reshape(n_chunks, chunk)
    planes_c = planes.reshape(n_chunks, chunk, ny, nx)
    mx_j = jnp.asarray(mx)

    def body(acc, xs):
        z, pl = xs
        x_at = ox + (z[:, None] - oz) * mx_j[None, :]  # (C, W)
        y_at = oy + (z[:, None] - oz) * my[None, :]  # (C, Hl)
        wx = _axis_weights(
            x_at.reshape(-1), nx, xlo, xhi, tex_offset, axis_scale[0]
        ).reshape(chunk, width, nx)
        wy = _axis_weights(
            y_at.reshape(-1), ny, ylo, yhi, tex_offset, axis_scale[1]
        ).reshape(chunk, height, ny)
        tmp = jax.lax.dot_general(
            wy, pl, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        resampled = jax.lax.dot_general(
            tmp, wx, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        col = _tf_onehot_matmul(resampled, tf_lut, toff, tscl)
        in_front = (jnp.sign(z - oz) * dz_sign) > 0
        covered = (
            (jnp.sum(jnp.abs(wy), axis=2) > 0.0)[:, :, None]
            & (jnp.sum(jnp.abs(wx), axis=2) > 0.0)[:, None, :]
            & in_front[:, None, None]
        )
        # clamped like the single-device sweep: monotone alpha is also what
        # makes the two-pass distributed ET detection exact
        a = jnp.where(
            covered,
            jnp.minimum(col[..., 3] * density * alpha_scale[None], 1.0),
            0.0,
        )
        rgba = jnp.concatenate(
            [col[..., :3] * a[..., None], a[..., None]], axis=-1
        )
        for k in range(chunk):
            new_acc = acc + rgba[k] * (1.0 - acc[..., 3:4])
            acc = jnp.where(acc[..., 3:4] > threshold[..., None], acc, new_acc)
        return acc, None

    acc0 = jnp.zeros((height, width, 4), dtype=jnp.float32)
    acc, _ = jax.lax.scan(jax.checkpoint(body), acc0, (zs_c, planes_c))
    return acc


def _over(acc, part):
    return acc + part * (1.0 - acc[..., 3:4])


#: octant cache for the rotated paths' permuted+re-sharded volume: ONE slot
#: per entry point ('scalar' / 'hist'), each holding (source_array, perm,
#: mesh, spec, permuted). Rotating within a principal-axis octant then
#: really moves no volume data (the docstring contract) — without this,
#: every frame re-dispatches the transpose + device_put of the whole
#: volume. Per-entry-point slots keep the amortization when scalar and hist
#: renders alternate (one shared slot thrashes); one slot per entry point
#: bounds pinned device memory at one permuted copy each. Long-lived
#: processes that drop a volume should call :func:`clear_octant_cache` —
#: the slot holds strong references to both the source and the permuted
#: copy until then.
_OCTANT_CACHE: dict = {}


def clear_octant_cache(slot: str = None) -> None:
    """Release the octant cache's pinned device arrays (``slot`` = 'scalar'
    or 'hist'; default both). The cache holds strong references to the last
    rotated render's source volume AND its permuted copy (~2x the volume's
    bytes pinned in device memory) so same-octant frames skip the
    transpose; call this when a long-lived process (the viewer, a fitting
    loop) is done with a volume."""
    if slot is None:
        _OCTANT_CACHE.clear()
    else:
        _OCTANT_CACHE.pop(slot, None)


def _permuted_sharded(src, perm, mesh, spec, slot="scalar"):
    """Transpose ``src`` by ``perm`` and place it as ``spec`` on ``mesh``,
    memoized per (source identity, perm, mesh) in the entry point's cache
    slot. Tracers bypass the cache so the transpose stays inside the
    autodiff graph (its transpose is the gradient's inverse permutation)."""
    if isinstance(src, jax.core.Tracer):
        return jax.device_put(jnp.transpose(src, perm), NamedSharding(mesh, spec))
    ent = _OCTANT_CACHE.get(slot)
    if ent is not None:
        s, p, m, sp, out = ent
        if s is src and p == perm and m == mesh and sp == spec:
            return out
    out = jax.device_put(jnp.transpose(src, perm), NamedSharding(mesh, spec))
    _OCTANT_CACHE[slot] = (src, perm, mesh, spec, out)
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "mx_bytes", "my_bytes", "march", "mesh", "dz_sign", "n_planes",
        "length_correction", "plane_chunk", "tex_offset", "axis_scale",
        "volume_mode", "decode_mode",
    ),
)
def _sweep_slope_space_call(
    volume: jnp.ndarray,
    origin: jnp.ndarray,
    tf_lut: jnp.ndarray,
    density,
    brightness,
    transfer_offset,
    transfer_scale,
    *,
    mx_bytes: bytes,
    my_bytes: bytes,
    march: MarchConfig,
    mesh: Mesh,
    dz_sign: int,
    n_planes: int,
    length_correction: bool,
    plane_chunk: int,
    tex_offset: float = 0.5,
    axis_scale: tuple = (1.0, 1.0, 1.0),
    volume_mode: str = "slab",
    decode_mode: str = None,
    rows=None,
) -> jnp.ndarray:
    """Distributed sweep over an arbitrary uniform slope grid (core).

    The slope grids arrive as raw float32 bytes so they key the jit cache
    (host numpy, like the single-device sweeps). ``dz_sign`` is the common
    sign of d_z over the grid — it flips the front-to-back plane order and
    the sort-last compositing order. See :func:`distributed_sweep_render`
    for semantics and :func:`distributed_shearwarp_render` for the
    rotated-camera entry point.

    ``decode_mode`` (with ``rows``, see ops/histogram.py
    ``decode_weight_rows``): ``volume`` is a bins-major ``(Z, B, Y, X)``
    histogram volume sharded over bricks, and each brick decodes its own
    slab to the statistic before sweeping it.
    """
    mx = np.frombuffer(mx_bytes, dtype=np.float32)
    my_host = np.frombuffer(my_bytes, dtype=np.float32)
    width, height = mx.shape[0], my_host.shape[0]
    if decode_mode is not None:
        volume = jax.shard_map(
            lambda h, r: decode_with_rows(h, r, decode_mode),
            mesh=mesh,
            in_specs=(P(BRICK_AXIS, None, None, None), P(None, None)),
            out_specs=P(BRICK_AXIS, None, None),
        )(volume, rows)
    nz, ny, nx = volume.shape
    if n_planes <= 0:
        n_planes = 2 * nz
    nb = mesh.shape[BRICK_AXIS]
    nr = mesh.shape[RAY_AXIS]
    if volume_mode == "slab":
        # z-slab sharding needs the default filter grid: a scaled grid
        # (axis_scale[2] != 1, the flexible-block padded-grid fetch) maps a
        # plane's z-taps OUTSIDE its owning slab's +-1 ghost layer, so those
        # taps are unreachable by the halo exchange. Flexible stats grids
        # are tiny (tens of blocks per axis) — use volume_mode='replicated'
        # (plane-schedule sharding) for them instead.
        assert tex_offset == 0.5 and tuple(axis_scale) == (1.0, 1.0, 1.0), (
            "volume_mode='slab' supports only the default filter grid; use "
            "volume_mode='replicated' for tex_offset/axis_scale variants"
        )
        assert nz % nb == 0, f"Z={nz} must divide over {nb} bricks"
    else:
        assert volume_mode == "replicated", volume_mode
    assert n_planes % nb == 0, f"n_planes={n_planes} must divide over {nb}"
    assert height % nr == 0, f"H={height} must divide over {nr} ray shards"
    zl = nz // nb if volume_mode == "slab" else nz
    (xlo, ylo, zlo) = march.box_min
    (xhi, yhi, zhi) = march.box_max
    thr = march.opacity_threshold

    # ascending global plane schedule, sharded so device d's planes lie in
    # slab d (plane k of slab d is plane d*Pl + k globally)
    spacing = (zhi - zlo) / n_planes
    zs_global = (
        zlo + spacing * (np.arange(n_planes, dtype=np.float32) + 0.5)
    ).astype(np.float32)

    stretch = np.sqrt(1.0 + my_host[:, None] ** 2 + mx[None, :] ** 2)
    alpha_scale_host = (
        (spacing * stretch / march.tstep).astype(np.float32)
        if length_correction
        else np.ones((height, width), dtype=np.float32)
    )

    origin = jnp.asarray(origin, dtype=jnp.float32)
    box = (march.box_min, march.box_max)

    # host-static pre-blend taps: plane k of slab d sits at padded-frame
    # position lf = zf - d*zl + 1 with zf = (d*ppd + k + 0.5)*nz/n_planes
    # - 0.5; the d-terms cancel exactly (ppd*nz == n_planes*zl), so
    # lf = (k + 0.5)*nz/n_planes + 0.5 — the SAME static two-tap weights on
    # every device. The global clamp-to-edge (zf clipped to [0, nz-1]) only
    # bites at the outermost planes of the boundary devices, where
    # _halo_exchange replicates the edge layer — making the unclamped
    # two-tap lerp equal the clamped one identically. These static-index
    # gathers are the memory-bound minimum, flip folded in.
    lf = (
        (np.arange(n_planes // nb, dtype=np.float64) + 0.5)
        * nz / n_planes + 0.5
    )
    if dz_sign < 0:
        lf = lf[::-1]  # front-to-back for dz < 0: descending z
    iz0_host = np.floor(lf).astype(np.int32)
    az_host = (lf - np.floor(lf)).astype(np.float32)[:, None, None]
    # low-z boundary: any plane with lf < 1 on device 0 samples below the
    # volume; _halo_exchange replicates the edge layer into the ghost, so
    # the two-tap lerp equals the clamped edge texel identically — the same
    # clamp-from-the-unclipped-floor semantics as the single-device
    # pre-blend (march/slice.py) and the CUDA texture unit.
    # n_planes == nz lands planes exactly on layers: pure (reversed) layer
    # selection, no lerp, no halo taps
    pure_select = bool(np.all(az_host < 1e-6)) and bool(np.all(lf >= 1.0))

    hl = height // nr

    def per_device(
        vol_local, zs_local, my_local, alpha_local,
        origin, tf_lut, density, brightness, toff, tscl,
    ):
        d = jax.lax.axis_index(BRICK_AXIS)
        zs_ftb = (
            jnp.flip(zs_local, axis=0) if dz_sign < 0 else zs_local
        )  # front-to-back order

        if volume_mode == "replicated":
            # plane-schedule sharding: the volume is replicated (coarse
            # stats grids are KBs — the flexible-block representation's
            # whole point is compression), each brick pre-blends only ITS
            # contiguous plane subrange, straight from the full volume with
            # the exact single-device clamp-from-the-unclipped-floor taps
            # (march/slice.py sweep_slope_space semantics) — valid for ANY
            # tex_offset/axis_scale, no halo needed. Sort-last compositing
            # and the two-pass ET are unchanged: a contiguous plane range
            # IS a z interval.
            zf = (
                (zs_ftb - zlo) / (zhi - zlo) * (nz * axis_scale[2])
                - tex_offset
            )
            izf = jnp.floor(zf)
            az_t = (zf - izf)[:, None, None]
            iz0_t = jnp.clip(izf.astype(jnp.int32), 0, nz - 1)
            iz1_t = jnp.clip(izf.astype(jnp.int32) + 1, 0, nz - 1)
            planes = (
                vol_local[iz0_t] * (1.0 - az_t) + vol_local[iz1_t] * az_t
            )
        # pre-blend local planes with the host-static two-tap weights (see
        # the derivation above distributed_sweep_render's per_device call);
        # differentiable through XLA's gather transpose (scatter-add into
        # the haloed slab, then the ppermute adjoint returns ghost-layer
        # cotangents to their owners).
        elif pure_select:
            planes = vol_local[jnp.asarray(iz0_host - 1)]  # local frame
        else:
            padded = _halo_exchange(vol_local, nb)  # (zl + 2, Y, X)
            planes = (
                padded[jnp.asarray(iz0_host)] * (1.0 - az_host)
                + padded[jnp.asarray(iz0_host + 1)] * az_host
            )

        sweep = lambda threshold: _local_sweep(
            planes, zs_ftb, mx, my_local, origin, tf_lut, density,
            toff, tscl, alpha_local, box, threshold, plane_chunk, dz_sign,
            tex_offset, axis_scale[:2],
        )
        if nb == 1:
            # one brick: one thresholded sweep is the exact single-pass form
            partial = sweep(jnp.full((hl, width), thr, dtype=jnp.float32))
            return partial * brightness

        # pass 1: cutoff-free slab partials, folded front-to-back
        partial = sweep(jnp.full((hl, width), 2.0, dtype=jnp.float32))

        parts = jax.lax.all_gather(partial, BRICK_AXIS, axis=0)  # (nb, Hl, W, 4)
        # dz < 0: device nb-1 (largest z) is nearest the camera
        ordered = jnp.flip(parts, axis=0) if dz_sign < 0 else parts

        acc0 = jnp.zeros_like(partial)

        def fold(acc, part):
            return _over(acc, part), acc

        final_nc, prefixes = jax.lax.scan(fold, acc0, ordered)
        after_alpha = jnp.concatenate(
            [prefixes[1:, ..., 3], final_nc[None, ..., 3]], axis=0
        )
        crossed = after_alpha > thr  # (nb, Hl, W)
        saturating = jnp.any(crossed, axis=0)
        j_star = jnp.argmax(crossed, axis=0)
        prefix_at = jnp.take_along_axis(
            prefixes, j_star[None, ..., None], axis=0
        )[0]
        a_up = prefix_at[..., 3]

        # pass 2: re-sweep only the crossing slab
        my_pos = (nb - 1 - d) if dz_sign < 0 else d  # ordered device index
        flag = saturating & (j_star == my_pos)
        # resume the sequential recursion from the true prefix in its
        # local-threshold form
        tau = (thr - a_up) / jnp.maximum(1.0 - a_up, 1e-6)
        partial2 = sweep(jnp.where(flag, tau, 2.0))
        contrib2 = jax.lax.psum(
            jnp.where(flag[..., None], partial2, 0.0), BRICK_AXIS
        )
        exact = prefix_at + contrib2 * (1.0 - a_up[..., None])
        rgba = jnp.where(saturating[..., None], exact, final_nc)
        return rgba * brightness

    out = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(
            P(BRICK_AXIS, None, None) if volume_mode == "slab"
            else P(None, None, None),
            P(BRICK_AXIS),
            P(RAY_AXIS),
            P(RAY_AXIS, None),
            P(None), P(None, None), P(), P(), P(), P(),
        ),
        out_specs=P(RAY_AXIS, None, None),
        check_vma=False,
    )(
        volume,
        jnp.asarray(zs_global),
        jnp.asarray(my_host),
        jnp.asarray(alpha_scale_host),
        origin,
        tf_lut,
        jnp.asarray(density, jnp.float32),
        jnp.asarray(brightness, jnp.float32),
        jnp.asarray(transfer_offset, jnp.float32),
        jnp.asarray(transfer_scale, jnp.float32),
    )
    return out



def distributed_sweep_slope_space(
    volume: jnp.ndarray,
    origin,
    mx: np.ndarray,
    my: np.ndarray,
    tf_lut: jnp.ndarray,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    dz_sign: int = -1,
    n_planes: int = 0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    tex_offset: float = 0.5,
    axis_scale: tuple = (1.0, 1.0, 1.0),
    volume_mode: str = "auto",
) -> jnp.ndarray:
    """Distributed sweep over HOST numpy slope grids ``mx (W,)`` / ``my (H,)``.

    The distributed twin of ``march/slice.py sweep_slope_space`` — any
    uniform m-grid, either sweep direction; image rows (the my grid) are
    sharded on the rays axis, the volume's leading axis on bricks.

    ``volume_mode``: 'slab' shards the volume's leading axis over bricks
    (halo exchange; default-filter-grid only), 'replicated' keeps the
    volume whole on every brick and shards the PLANE SCHEDULE instead —
    the right layout for coarse flexible-block stats grids, and required
    for non-default ``tex_offset``/``axis_scale`` (the scaled filter grid
    maps plane taps outside their slab). 'auto' picks 'replicated' exactly
    when a non-default filter grid demands it."""
    if volume_mode == "auto":
        volume_mode = _auto_volume_mode(tex_offset, axis_scale)
    mx = np.ascontiguousarray(np.asarray(mx, dtype=np.float32))
    my = np.ascontiguousarray(np.asarray(my, dtype=np.float32))
    return _sweep_slope_space_call(
        volume,
        *_render_params(origin, tf_lut, density, brightness, transfer_offset,
                        transfer_scale),
        mx_bytes=mx.tobytes(),
        my_bytes=my.tobytes(),
        march=march,
        mesh=mesh,
        dz_sign=int(dz_sign),
        n_planes=int(n_planes),
        length_correction=length_correction,
        plane_chunk=plane_chunk,
        tex_offset=float(tex_offset),
        axis_scale=tuple(float(s) for s in axis_scale),
        volume_mode=volume_mode,
    )


def _auto_volume_mode(tex_offset, axis_scale) -> str:
    default_grid = (
        tex_offset == 0.5 and tuple(axis_scale) == (1.0, 1.0, 1.0)
    )
    return "slab" if default_grid else "replicated"


def _render_params(origin, tf_lut, density, brightness, transfer_offset,
                   transfer_scale):
    """The traced render parameters of the jitted cores, as float32."""
    return (
        jnp.asarray(origin, jnp.float32),
        jnp.asarray(tf_lut, jnp.float32),
        jnp.asarray(density, jnp.float32),
        jnp.asarray(brightness, jnp.float32),
        jnp.asarray(transfer_offset, jnp.float32),
        jnp.asarray(transfer_scale, jnp.float32),
    )


def _pixel_slopes(width: int, height: int, focal: float):
    """Slope grids of the unrotated -z camera: the m-grid IS the pixel grid."""
    u = ((np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0)
    v = ((np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0)
    return (u / (-focal)).astype(np.float32), (v / (-focal)).astype(np.float32)


def _decode_rows(weights):
    weights = jnp.asarray(weights, jnp.float32)
    return weights[None, :] if weights.ndim == 1 else weights


def distributed_sweep_render(
    volume: jnp.ndarray,
    origin: jnp.ndarray,
    tf_lut: jnp.ndarray,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    width: int,
    height: int,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    n_planes: int = 0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    tex_offset: float = 0.5,
    axis_scale: tuple = (1.0, 1.0, 1.0),
    volume_mode: str = "auto",
) -> jnp.ndarray:
    """Sweep-render with the volume sharded over bricks and rows over rays.

    ``volume`` is ``(Z, Y, X)`` (use :func:`shard_scalar_volume` to place it);
    unrotated benchmark camera at ``origin`` looking down -z. Returns
    ``(H, W, 4)`` float32 RGBA, rows sharded on the rays axis. Matches the
    single-device ``slice_render_image`` to float32 rounding (ET exact at
    plane granularity via the two-pass scheme). Rotated cameras: use
    :func:`distributed_shearwarp_render`.

    Differentiable: the static-tap pre-blend, halo ppermute, per-device
    sweeps (the slice sweep's masked scan), all_gather compositing and psum
    all transpose under XLA autodiff. Gradients match the single-device
    ``slice_render_image`` VJP (tests/test_dist_sweep.py).
    """
    mx, my = _pixel_slopes(width, height, focal)
    return distributed_sweep_slope_space(
        volume, origin, mx, my, tf_lut,
        density, brightness, transfer_offset, transfer_scale,
        march=march, mesh=mesh, dz_sign=-1, n_planes=n_planes,
        length_correction=length_correction, plane_chunk=plane_chunk,
        tex_offset=tex_offset, axis_scale=axis_scale,
        volume_mode=volume_mode,
    )


def distributed_hist_render(
    hist_bm: jnp.ndarray,
    weights: jnp.ndarray,
    origin: jnp.ndarray,
    tf_lut: jnp.ndarray,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    width: int,
    height: int,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    stat: str = "linear",
) -> jnp.ndarray:
    """DISTRIBUTION-NATIVE distributed render: the bins-major histogram
    volume ``(Z, B, Y, X)`` z-slab-sharded over bricks (use
    :func:`shard_hist_volume`), image rows over rays. Each brick decodes its
    own slab to the per-voxel statistic (``stat`` = 'linear' / 'var' /
    'entropy' with ``weights`` = the rows of ops/histogram.py
    ``decode_weight_rows``; a 1-D ``weights`` is one linear row) and sweeps
    the decoded slab with the sort-last bricks × rays sharding and its
    two-pass EXACT early termination.

    The reference decodes in the march only for query 7
    (volumeRender_kernel.cu:354-480) and never distributes; this is every
    statistic under sharding. Differentiable end-to-end: histogram
    cotangents come back per slab through the decode's transpose, the
    pass-2 prefix backprops into upstream bricks, LUT/param grads psum over
    the mesh.

    Schedule: pure selection (the planes are the Z layers), unrotated -z
    camera, Z % bricks == 0 and height % rays == 0. Rotated cameras:
    :func:`distributed_shearwarp_hist_render`.
    """
    mx, my = _pixel_slopes(int(width), int(height), focal)
    return _sweep_slope_space_call(
        hist_bm,
        *_render_params(origin, tf_lut, density, brightness, transfer_offset,
                        transfer_scale),
        mx_bytes=mx.tobytes(),
        my_bytes=my.tobytes(),
        march=march,
        mesh=mesh,
        dz_sign=-1,
        n_planes=int(hist_bm.shape[0]),
        length_correction=length_correction,
        plane_chunk=int(plane_chunk),
        volume_mode="slab",
        decode_mode=str(stat),
        rows=_decode_rows(weights),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mx_bytes", "my_bytes", "march", "mesh", "dz_sign", "n_planes",
        "length_correction", "plane_chunk", "tex_offset", "axis_scale",
        "volume_mode", "decode_mode", "width", "height", "focal",
        "perm_world",
    ),
)
def _rot_sweep_frame(
    vol_perm, origin, tf_lut, density, brightness, transfer_offset,
    transfer_scale, rot, mgrid, *,
    mx_bytes, my_bytes, march, mesh, dz_sign, n_planes, length_correction,
    plane_chunk, tex_offset, axis_scale, volume_mode, width, height, focal,
    perm_world, decode_mode=None, rows=None,
):
    """ONE jitted dispatch per rotated frame: the m-grid sweep (with the
    per-brick decode when ``decode_mode`` is set) and the homography warp
    to pixels."""
    from vrdd_tpu.march.shearwarp import _warp_from_rotation_traced

    img_m = _sweep_slope_space_call(
        vol_perm, origin, tf_lut, density, brightness, transfer_offset,
        transfer_scale, mx_bytes=mx_bytes, my_bytes=my_bytes, march=march,
        mesh=mesh, dz_sign=dz_sign, n_planes=n_planes,
        length_correction=length_correction, plane_chunk=plane_chunk,
        tex_offset=tex_offset, axis_scale=axis_scale,
        volume_mode=volume_mode, decode_mode=decode_mode, rows=rows,
    )
    return _warp_from_rotation_traced(
        img_m, rot, mgrid, width, height, focal, perm_world
    )


def _pad_grid(m: np.ndarray, mult: int) -> np.ndarray:
    """Extend a uniform slope grid to the next multiple of ``mult`` with the
    same spacing: the extra rays march like any others and the warp never
    samples them, so in-range samples see identical values."""
    m = np.asarray(m, dtype=np.float32)
    n = m.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return m
    dm = float(m[1] - m[0]) if n > 1 else 1.0
    ext = m[-1] + dm * np.arange(1, pad + 1, dtype=np.float32)
    return np.concatenate([m, ext.astype(np.float32)])


def _rotated_frame_args(inv_view, width, height, focal, oversample, march,
                        mesh):
    """Host geometry shared by the rotated entry points: ``(perm_world,
    dz_sign, origin_p, march_p, mx, my, mgrid)`` for the bounding m-grid of
    the view (march/shearwarp.py construction), rows extended to the ray
    shard multiple."""
    from vrdd_tpu.march.shearwarp import slope_corner_bounds

    inv_view = np.asarray(inv_view, dtype=np.float32)
    axis, (px, py, pz), dz_sign, ok, (mx_lo, mx_hi, my_lo, my_hi) = (
        slope_corner_bounds(inv_view, width, height, focal)
    )
    if not ok:
        raise ValueError(
            "shear-warp inapplicable: d_z changes sign across the image; "
            "use the scan-marcher bricks path (parallel/bricks.py)"
        )
    origin_w = inv_view[:, 3]
    origin_p = np.array(
        [origin_w[px], origin_w[py], origin_w[pz]], dtype=np.float32
    )
    bmin = np.asarray(march.box_min, dtype=np.float32)
    bmax = np.asarray(march.box_max, dtype=np.float32)
    march_p = MarchConfig(
        max_steps=march.max_steps, tstep=march.tstep,
        opacity_threshold=march.opacity_threshold,
        box_min=(float(bmin[px]), float(bmin[py]), float(bmin[pz])),
        box_max=(float(bmax[px]), float(bmax[py]), float(bmax[pz])),
    )
    wi = max(8, int(np.ceil(width * oversample)))
    hi = max(8, int(np.ceil(height * oversample)))
    mx_pad = max(1e-6, (mx_hi - mx_lo) / wi)
    my_pad = max(1e-6, (my_hi - my_lo) / hi)
    mx = np.linspace(mx_lo - mx_pad, mx_hi + mx_pad, wi, dtype=np.float32)
    my = np.linspace(my_lo - my_pad, my_hi + my_pad, hi, dtype=np.float32)
    my = _pad_grid(my, mesh.shape[RAY_AXIS])
    # the per-pixel warp maps build on device from the rotation and this
    # origin/spacing (spacing-based, so the row extension never shifts
    # in-range samples)
    mgrid = jnp.asarray(
        [mx[0], (mx[-1] - mx[0]) / (wi - 1), my[0], my[1] - my[0]],
        jnp.float32,
    )
    return (px, py, pz), dz_sign, origin_p, march_p, mx, my, mgrid


def distributed_shearwarp_hist_render(
    hist_bm: jnp.ndarray,
    weights: jnp.ndarray,
    inv_view: np.ndarray,
    width: int,
    height: int,
    tf_lut: jnp.ndarray,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    oversample: float = 2.0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    stat: str = "linear",
) -> jnp.ndarray:
    """ARBITRARY rotated views, DISTRIBUTION-NATIVE, under sharding:
    shear-warp (march/shearwarp.py) × per-brick histogram decode ×
    sort-last bricks+rays sharding.

    The bins-major ``(Z, B, Y, X)`` histogram volume's SPATIAL axes permute
    so the view's principal world axis becomes the sweep/shard axis, the
    permuted volume re-shards over bricks (amortized across every view in
    the same principal-axis octant by the 'hist' slot of the octant cache —
    rotating within an octant moves no histogram data), each brick decodes
    its slab's statistic and sweeps the bounding m-grid with rows sharded on
    rays, and the m-space image warps to pixels. Pure-selection schedule:
    the planes are the layers of the permuted volume.

    The reference serves rotated views of its distribution volumes by
    per-pixel marching precomputed query textures (volumeRender.cpp:225-246
    → volumeRender_kernel.cu:654-680). Differentiable like
    :func:`distributed_hist_render` (the axis permutation and warp
    transpose under XLA autodiff).
    """
    inv_view = np.asarray(inv_view, dtype=np.float32)
    perm, dz_sign, origin_p, march_p, mx, my, mgrid = _rotated_frame_args(
        inv_view, width, height, focal, oversample, march, mesh
    )
    px, py, pz = perm
    nb = mesh.shape[BRICK_AXIS]
    # spatial axis of the bins-major volume holding world axis a
    # (x → 3, y → 2, z → 0; axis 1 is always the bins axis)
    sp = lambda a: 0 if a == 2 else 3 - a
    hist_bm = jnp.asarray(hist_bm)
    if hist_bm.shape[sp(pz)] % nb:
        raise ValueError(
            f"principal axis extent {hist_bm.shape[sp(pz)]} must divide "
            f"over {nb} bricks"
        )
    hist_p = _permuted_sharded(
        hist_bm, (sp(pz), 1, sp(py), sp(px)), mesh,
        P(BRICK_AXIS, None, None, None), slot="hist",
    )
    return _rot_sweep_frame(
        hist_p,
        *_render_params(origin_p, tf_lut, density, brightness,
                        transfer_offset, transfer_scale),
        jnp.asarray(inv_view[:, :3]),
        mgrid,
        mx_bytes=np.ascontiguousarray(mx).tobytes(),
        my_bytes=np.ascontiguousarray(my).tobytes(),
        march=march_p,
        mesh=mesh,
        dz_sign=int(dz_sign),
        n_planes=int(hist_p.shape[0]),
        length_correction=length_correction,
        plane_chunk=int(plane_chunk),
        tex_offset=0.5,
        axis_scale=(1.0, 1.0, 1.0),
        volume_mode="slab",
        width=int(width),
        height=int(height),
        focal=float(focal),
        perm_world=perm,
        decode_mode=str(stat),
        rows=_decode_rows(weights),
    )


def distributed_shearwarp_render(
    volume: jnp.ndarray,
    inv_view: np.ndarray,
    width: int,
    height: int,
    tf_lut: jnp.ndarray,
    density=0.05,
    brightness=1.0,
    transfer_offset=0.0,
    transfer_scale=1.0,
    *,
    march: MarchConfig = MarchConfig(),
    mesh: Mesh,
    focal: float = 2.0,
    n_planes: int = 0,
    oversample: float = 2.0,
    length_correction: bool = True,
    plane_chunk: int = 8,
    tex_offset: float = 0.5,
    axis_scale: tuple = (1.0, 1.0, 1.0),
    volume_mode: str = "auto",
) -> jnp.ndarray:
    """ARBITRARY rotated views on the distributed sweep (shear-warp).

    Composes the shear-warp factorization (march/shearwarp.py) with the
    distributed slope-space sweep: pick the principal volume axis for the
    view, permute so it becomes the sweep axis and RE-SHARD the permuted
    volume over bricks (one all-to-all, amortized across every view in the
    same principal-axis octant — rotating within an octant re-renders
    through cached executables and moves no volume data), sweep the bounding
    m-grid with rows sharded on rays, then warp m-space to pixels (a 2-D
    bilinear gather on the row-sharded image; XLA inserts the gather
    collectives). Matches single-device ``shearwarp_render_image`` (the
    m-grid rows are only EXTENDED to the shard multiple — same spacing, so
    in-range warp samples see identical values).

    The reference renders arbitrary cameras by re-marching per pixel
    (volumeRender.cpp:225-246 -> volumeRender_kernel.cu:288-296); this is
    that capability under the BASELINE bricks+rays sharding contract.
    """
    inv_view = np.asarray(inv_view, dtype=np.float32)
    perm, dz_sign, origin_p, march_p, mx, my, mgrid = _rotated_frame_args(
        inv_view, width, height, focal, oversample, march, mesh
    )
    px, py, pz = perm
    nb = mesh.shape[BRICK_AXIS]
    # the per-world-axis filter-grid scales permute with the volume
    # (rotated flexible-block queries, march/shearwarp.py axis_scale)
    ascale_p = (
        float(axis_scale[px]), float(axis_scale[py]), float(axis_scale[pz])
    )
    if volume_mode == "auto":
        volume_mode = _auto_volume_mode(tex_offset, ascale_p)
    volume = jnp.asarray(volume)
    if volume_mode == "slab" and volume.shape[2 - pz] % nb:
        raise ValueError(
            f"principal axis extent {volume.shape[2 - pz]} must divide "
            f"over {nb} bricks"
        )
    vol_perm = _permuted_sharded(
        volume, (2 - pz, 2 - py, 2 - px), mesh,
        P(BRICK_AXIS, None, None) if volume_mode == "slab"
        else P(None, None, None),
    )
    return _rot_sweep_frame(
        vol_perm,
        *_render_params(origin_p, tf_lut, density, brightness,
                        transfer_offset, transfer_scale),
        jnp.asarray(inv_view[:, :3]),
        mgrid,
        mx_bytes=np.ascontiguousarray(mx).tobytes(),
        my_bytes=np.ascontiguousarray(my).tobytes(),
        march=march_p,
        mesh=mesh,
        dz_sign=int(dz_sign),
        n_planes=int(n_planes),
        length_correction=length_correction,
        plane_chunk=int(plane_chunk),
        tex_offset=float(tex_offset),
        axis_scale=ascale_p,
        volume_mode=volume_mode,
        width=int(width),
        height=int(height),
        focal=float(focal),
        perm_world=perm,
    )
