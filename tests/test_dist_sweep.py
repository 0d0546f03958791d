"""Distributed sweep (z-slabs x row shards) vs the single-device slice sweep."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.io.synthetic import gaussian_blob_volume
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.parallel.mesh import make_mesh
from vrdd_tpu.parallel.sweep import distributed_sweep_render, shard_scalar_volume

TF = jnp.asarray(default_transfer_function())
O = jnp.asarray([0.0, 0.0, 4.0])


def _ref(vol, W, H, **kw):
    return np.asarray(
        slice_render_image(vol, O, W, H, TF, use_custom_vjp=False, **kw)
    )


@pytest.mark.parametrize("bricks,rays", [(8, 1), (1, 8), (4, 2), (2, 4)])
def test_distributed_sweep_matches_single(bricks, rays):
    vol = jnp.asarray(gaussian_blob_volume((16, 16, 16), seed=5))
    mesh = make_mesh(bricks=bricks, rays=rays)
    sharded = shard_scalar_volume(vol, mesh)
    got = np.asarray(
        distributed_sweep_render(
            sharded, O, TF, width=32, height=32, mesh=mesh, n_planes=32,
        )
    )
    ref = _ref(vol, 32, 32, n_planes=32)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_distributed_sweep_early_termination_exact():
    # saturating density: the freeze plane must match the sequential sweep
    vol = jnp.asarray(gaussian_blob_volume((16, 16, 16), seed=2))
    mesh = make_mesh(bricks=4, rays=2)
    got = np.asarray(
        distributed_sweep_render(
            shard_scalar_volume(vol, mesh), O, TF, density=5.0,
            width=32, height=32, mesh=mesh, n_planes=32,
        )
    )
    ref = _ref(vol, 32, 32, n_planes=32, density=5.0)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    assert (ref[..., 3] > 0.95).any()  # ET actually triggered


def test_distributed_sweep_gradients():
    vol = jnp.asarray(gaussian_blob_volume((8, 8, 8), seed=1))
    mesh = make_mesh(bricks=4, rays=2)

    def loss(v, lut):
        img = distributed_sweep_render(
            v, O, lut, width=16, height=16, mesh=mesh, n_planes=16,
        )
        return jnp.sum(img ** 2)

    gv, gl = jax.grad(loss, argnums=(0, 1))(shard_scalar_volume(vol, mesh), TF)
    assert bool(jnp.all(jnp.isfinite(gv))) and bool(jnp.all(jnp.isfinite(gl)))
    # parity with the single-device custom-VJP path
    def loss1(v, lut):
        img = slice_render_image(v, O, 16, 16, lut, n_planes=16)
        return jnp.sum(img ** 2)

    gv1, gl1 = jax.grad(loss1, argnums=(0, 1))(vol, TF)
    np.testing.assert_allclose(
        np.asarray(gv), np.asarray(gv1), atol=3e-4, rtol=3e-4
    )


def _pure_select_stack(vol, march):
    """Front-to-back plane stack of the -z camera with n_planes == Z: the
    planes are the volume's layers, reversed (no z lerp)."""
    nz = vol.shape[0]
    spacing = (march.box_max[2] - march.box_min[2]) / nz
    zs = (march.box_min[2]
          + spacing * (np.arange(nz, dtype=np.float32) + 0.5))[::-1]
    return vol[::-1], np.ascontiguousarray(zs, dtype=np.float32), spacing


def _pixel_slopes(W, H):
    u = (np.arange(W, dtype=np.float32) / W) * 2.0 - 1.0
    v = (np.arange(H, dtype=np.float32) / H) * 2.0 - 1.0
    return u / -2.0, v / -2.0


def test_diff_sweep_seeded_grad_matches_full():
    """Gradients THROUGH the seed: a front half plus a seeded back half must
    reproduce one full differentiable sweep's gradients — the streamed and
    distributed building block (seed cotangent d seed_a = g_a - S/T_0 in
    march/slice.py sweep_preblended_planes_xla)."""
    from vrdd_tpu.march.slice import sweep_preblended_planes_xla
    from vrdd_tpu.utils.config import MarchConfig

    vol = jnp.asarray(gaussian_blob_volume((32, 16, 16), seed=5))
    W = H = 24
    march = MarchConfig()
    planes, zs, spacing = _pure_select_stack(vol, march)
    mx, my = _pixel_slopes(W, H)
    half = planes.shape[0] // 2
    kw = dict(march=march, plane_spacing=spacing)
    rng = np.random.default_rng(3)
    tgt = jnp.asarray(rng.random((H, W, 4), dtype=np.float32))
    # density high enough that some rays saturate within the FRONT half, so
    # the back half sees frozen seeds (m = 0 past the cutoff)
    density = jnp.float32(2.0)

    def sweep(p, z, lut, d, **extra):
        return sweep_preblended_planes_xla(p, z, O, mx, my, lut, d,
                                           **kw, **extra)

    def loss_full(p, lut, d):
        return jnp.sum(sweep(p, zs, lut, d) * tgt)

    def loss_split(p, lut, d):
        front = sweep(p[:half], zs[:half], lut, d)
        img = sweep(p[half:], zs[half:], lut, d, acc_init=front)
        return jnp.sum(img * tgt)

    lf, gf = jax.value_and_grad(loss_full, argnums=(0, 1, 2))(
        planes, TF, density
    )
    ls, gs = jax.value_and_grad(loss_split, argnums=(0, 1, 2))(
        planes, TF, density
    )
    front_a = np.asarray(sweep(planes[:half], zs[:half], TF, density))[..., 3]
    assert (front_a > march.opacity_threshold).any()  # freeze exercised
    assert np.allclose(float(lf), float(ls), rtol=1e-5)
    for name, a, b in zip(("planes", "lut", "density"), gf, gs):
        a, b = np.asarray(a), np.asarray(b)
        err = np.abs(a - b) / (np.abs(a).max() + 1e-6)
        assert np.quantile(err, 0.999) < 5e-3, f"{name}: {np.quantile(err, 0.999)}"


def test_sweep_seeded_resume_matches_full():
    """acc_init resumes the front-to-back recursion mid-flight: sweeping the
    back half of the plane stack seeded with the front half's accumulator
    must equal the full sweep (the streamed-decode chunk chain's building
    block); pixels seeded past the opacity threshold stay frozen."""
    from vrdd_tpu.march.slice import sweep_preblended_planes_xla
    from vrdd_tpu.utils.config import MarchConfig

    vol = jnp.asarray(gaussian_blob_volume((32, 16, 16), seed=5))
    W = H = 24
    march = MarchConfig()
    planes, zs, spacing = _pure_select_stack(vol, march)
    mx, my = _pixel_slopes(W, H)
    half = planes.shape[0] // 2
    # partial stacks keep the FULL stack's plane spacing
    kw = dict(march=march, plane_spacing=spacing)

    def sweep(p, z, acc=None):
        return sweep_preblended_planes_xla(p, z, O, mx, my, TF, 0.8,
                                           acc_init=acc, **kw)

    full = np.asarray(sweep(planes, zs))
    front = sweep(planes[:half], zs[:half])
    resumed = np.asarray(sweep(planes[half:], zs[half:], front))
    # frozen seed: alpha past the threshold contributes nothing
    frozen = jnp.concatenate(
        [jnp.zeros((H, W, 3), jnp.float32),
         jnp.full((H, W, 1), 2.0, jnp.float32)], axis=-1)
    untouched = np.asarray(sweep(planes[half:], zs[half:], frozen))
    diff = np.abs(resumed - full)
    assert np.quantile(diff, 0.999) < 1e-5, np.quantile(diff, 0.999)
    np.testing.assert_array_equal(untouched, np.asarray(frozen))


def test_distributed_shearwarp_matches_single():
    """Rotated camera on the distributed sweep: permute + re-shard the
    volume over bricks, sweep the m-grid, warp — must match the
    single-device shear-warp renderer (same m-grid; the distributed rows
    are only extended)."""
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.march.shearwarp import shearwarp_render_image
    from vrdd_tpu.parallel.sweep import distributed_shearwarp_render

    vol = jnp.asarray(gaussian_blob_volume((16, 16, 16), seed=5))
    mesh = make_mesh(bricks=2, rays=4)
    for rx, ry in ((20.0, 30.0), (80.0, 10.0)):  # z- and y-principal views
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        got = np.asarray(distributed_shearwarp_render(
            shard_scalar_volume(vol, mesh), iv, 32, 32, TF,
            mesh=mesh, n_planes=32,
        ))
        ref = np.asarray(shearwarp_render_image(
            vol, iv, 32, 32, TF, n_planes=32,
        ))
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_distributed_shearwarp_gradients():
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.march.shearwarp import shearwarp_render_image
    from vrdd_tpu.parallel.sweep import distributed_shearwarp_render

    vol = jnp.asarray(gaussian_blob_volume((8, 8, 8), seed=1))
    mesh = make_mesh(bricks=4, rays=2)
    iv = inv_view_from_rotation_translation(25.0, 15.0, (0.0, 0.0, -4.0))

    def loss(v, lut):
        img = distributed_shearwarp_render(
            v, iv, 16, 16, lut, mesh=mesh, n_planes=16,
        )
        return jnp.sum(img ** 2)

    def loss1(v, lut):
        img = shearwarp_render_image(
            v, iv, 16, 16, lut, n_planes=16,
        )
        return jnp.sum(img ** 2)

    gv, gl = jax.grad(loss, argnums=(0, 1))(shard_scalar_volume(vol, mesh), TF)
    gv1, gl1 = jax.grad(loss1, argnums=(0, 1))(vol, TF)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(gv1),
                               atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(np.asarray(gl), np.asarray(gl1),
                               atol=3e-4, rtol=3e-4)


def test_distributed_replicated_flex_axis_scale_matches_single():
    """Flexible-block queries under sharding: volume_mode='replicated'
    (plane-schedule sharding; the coarse padded stats grid replicates) must
    match the single-device sweep with the same padded-grid filter scales
    — including a grid whose extents do NOT divide over the bricks axis."""
    rng = np.random.default_rng(7)
    nzb, nyb, nxb = 6, 9, 11  # deliberately brick-indivisible
    padded = jnp.asarray(
        np.pad(rng.random((nzb, nyb, nxb), dtype=np.float32),
               ((0, 1), (0, 1), (0, 1)))
    )
    ascale = (nxb / (nxb + 1), nyb / (nyb + 1), nzb / (nzb + 1))
    mesh = make_mesh(bricks=4, rays=2)
    got = np.asarray(
        distributed_sweep_render(
            padded, O, TF, width=32, height=32, mesh=mesh, n_planes=32,
            axis_scale=ascale,
        )
    )
    ref = _ref(padded, 32, 32, n_planes=32, axis_scale=ascale)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_distributed_replicated_gradients():
    rng = np.random.default_rng(8)
    padded = jnp.asarray(
        np.pad(rng.random((4, 5, 6), dtype=np.float32),
               ((0, 1), (0, 1), (0, 1)))
    )
    ascale = (6 / 7, 5 / 6, 4 / 5)
    mesh = make_mesh(bricks=4, rays=2)

    def loss(v, lut, dist):
        if dist:
            img = distributed_sweep_render(
                v, O, lut, width=16, height=16, mesh=mesh, n_planes=16,
                axis_scale=ascale,
            )
        else:
            img = slice_render_image(
                v, O, 16, 16, lut, n_planes=16, axis_scale=ascale,
                use_custom_vjp=False,
            )
        return jnp.sum(img ** 2)

    gv_d, gl_d = jax.grad(loss, argnums=(0, 1))(padded, TF, True)
    gv_s, gl_s = jax.grad(loss, argnums=(0, 1))(padded, TF, False)
    np.testing.assert_allclose(np.asarray(gv_d), np.asarray(gv_s),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(gl_d), np.asarray(gl_s),
                               atol=1e-4, rtol=1e-4)
