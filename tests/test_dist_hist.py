"""Distribution-native DISTRIBUTED rendering: bins-major histogram slabs
sharded over bricks, each brick decoding its own slab to the per-voxel
statistic before the sort-last sharded sweep (parallel/sweep.py
distributed_hist_render), pinned on a virtual CPU mesh against the
single-device materialized path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.ops.histogram import decode_weight_rows, decode_with_rows
from vrdd_tpu.parallel.mesh import make_mesh
from vrdd_tpu.parallel.sweep import distributed_hist_render, shard_hist_volume

TF = jnp.asarray(default_transfer_function())
O = jnp.asarray([0.0, 0.0, 4.0])
W = H = 32


def _hist(nz=16, B=8, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.random((nz, B, nz, nz)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    w = (np.arange(B, dtype=np.float32) + 0.5) / B
    return jnp.asarray(h), jnp.asarray(w)


def _mesh2():
    return make_mesh(bricks=2, rays=1, devices=jax.devices()[:2])


def _ref_img(hist, w, **kw):
    decoded = jnp.einsum("zbyx,b->zyx", hist, w)
    return np.asarray(
        slice_render_image(decoded, O, W, H, TF, n_planes=hist.shape[0],
                           use_custom_vjp=False, **kw)
    )


def test_distributed_hist_matches_single():
    hist, w = _hist(seed=3)
    mesh = _mesh2()
    got = np.asarray(distributed_hist_render(
        shard_hist_volume(hist, mesh), w, O, TF, width=W, height=H,
        mesh=mesh,
    ))
    ref = _ref_img(hist, w)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_distributed_hist_early_termination_exact():
    # saturating density: first-crossing slab detection + seeded pass 2
    # must agree with the sequential sweep through the in-kernel decode
    hist, w = _hist(seed=7)
    mesh = _mesh2()
    got = np.asarray(distributed_hist_render(
        shard_hist_volume(hist, mesh), w, O, TF, density=5.0,
        width=W, height=H, mesh=mesh,
    ))
    ref = _ref_img(hist, w, density=5.0)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    assert (ref[..., 3] > 0.95).any()  # ET actually triggered


def test_distributed_hist_gradients():
    """Histogram + LUT cotangents through shard_map: per-slab decode
    transposes + the pass-2 prefix cotangent into upstream bricks."""
    hist, w = _hist(seed=11)
    mesh = _mesh2()

    def loss_d(h, lut):
        img = distributed_hist_render(
            h, w, O, lut, width=W, height=H, mesh=mesh, density=0.6,
        )
        return jnp.sum(img ** 2)

    def loss_s(h, lut):
        dec = jnp.einsum("zbyx,b->zyx", h, w)
        img = slice_render_image(dec, O, W, H, lut, n_planes=16,
                                 density=0.6, use_custom_vjp=False)
        return jnp.sum(img ** 2)

    gh, gl = jax.grad(loss_d, argnums=(0, 1))(
        shard_hist_volume(hist, mesh), TF
    )
    gh, gl = np.asarray(gh), np.asarray(gl)
    gh_s, gl_s = jax.grad(loss_s, argnums=(0, 1))(hist, TF)

    def mre(a, b):
        s = float(jnp.max(jnp.abs(b))) or 1.0
        return float(np.max(np.abs(a - np.asarray(b)))) / s

    assert mre(gh, gh_s) < 5e-4, "histogram cotangent across bricks"
    assert mre(gl, gl_s) < 5e-4, "LUT cotangent (psum over mesh)"


def test_distributed_hist_var_stat():
    """Nonlinear statistic under sharding: the variance combine decodes
    per brick, matching the materialized single-device render."""
    hist, _ = _hist(seed=13)
    rows, mode = decode_weight_rows("var", 8, family="unit")
    mesh = _mesh2()
    dec = decode_with_rows(hist, rows, mode)
    ref = np.asarray(
        slice_render_image(dec, O, W, H, TF, n_planes=16, density=0.6,
                           transfer_scale=8.0, use_custom_vjp=False)
    )
    got = np.asarray(distributed_hist_render(
        shard_hist_volume(hist, mesh), rows, O, TF, density=0.6,
        transfer_scale=8.0, width=W, height=H, mesh=mesh, stat=mode,
    ))
    assert np.abs(ref).max() > 1e-3, "vacuous comparison: image is black"
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def test_distributed_shearwarp_hist_matches_scalar_dist():
    """ROTATED distribution-native rendering under sharding: the bins-major
    volume's spatial axes permute with the principal axis, the slab shard
    follows, and each brick decodes its slab for the m-grid sweep. Anchored
    tightly against the rotated SCALAR distributed path on a materialized
    decode (identical m-grid construction and warp — only where the decode
    runs differs), and loosely against the single-device shear-warp (the
    distributed m-grid rows are extended to the shard multiple → warp-
    filter-level agreement; the random histogram volume decodes to
    broadband noise, the worst case for resampling)."""
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.march.shearwarp import (
        shearwarp_geometry,
        shearwarp_render_image,
    )
    from vrdd_tpu.parallel.sweep import (
        distributed_shearwarp_hist_render,
        distributed_shearwarp_render,
    )

    hist, w = _hist(seed=17)
    dec = jnp.einsum("zbyx,b->zyx", hist, w)
    mesh = _mesh2()
    signs = set()
    for rx, ry in ((20.0, 30.0), (80.0, 10.0), (160.0, 0.0)):
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        axis, _, _, dz_sign, ok = shearwarp_geometry(iv, 32, 32)
        assert ok
        signs.add(dz_sign)
        got = np.asarray(distributed_shearwarp_hist_render(
            hist, w, iv, 32, 32, TF, mesh=mesh, density=0.6,
        ))
        ref = np.asarray(distributed_shearwarp_render(
            dec, iv, 32, 32, TF, density=0.6, mesh=mesh,
            n_planes=hist.shape[0],
        ))
        np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4,
                                   err_msg=f"view rx={rx} ry={ry}")
        ref_x = np.asarray(shearwarp_render_image(
            dec, iv, 32, 32, TF, density=0.6, n_planes=hist.shape[0],
        ))
        diff = np.abs(got - ref_x)
        assert np.quantile(diff, 0.9) < 5e-2, (rx, ry, np.quantile(diff, 0.9))
    assert len(signs) == 2, "test views must cover both sweep directions"


def test_distributed_shearwarp_hist_gradients():
    """Histogram + LUT cotangents through the rotated sharded path: the
    axis permutation, re-shard, per-slab decode, prefix cotangent, and
    warp transpose must compose to the materialized gradient."""
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.parallel.sweep import (
        distributed_shearwarp_hist_render,
        distributed_shearwarp_render,
    )

    hist, w = _hist(nz=8, B=4, seed=19)
    mesh = _mesh2()
    iv = inv_view_from_rotation_translation(70.0, 15.0, (0.0, 0.0, -4.0))

    def loss_d(h, lut):
        img = distributed_shearwarp_hist_render(
            h, w, iv, 16, 16, lut, mesh=mesh, density=0.6,
        )
        return jnp.sum(img ** 2)

    def loss_s(h, lut):
        # materialized decode chained OUTSIDE the scalar distributed path
        # (same m-grid/warp as the hist path — only the decode moves)
        dec = jnp.einsum("zbyx,b->zyx", h, w)
        img = distributed_shearwarp_render(
            dec, iv, 16, 16, lut, density=0.6, mesh=mesh,
            n_planes=h.shape[0],
        )
        return jnp.sum(img ** 2)

    gh, gl = jax.grad(loss_d, argnums=(0, 1))(hist, TF)
    gh_s, gl_s = jax.grad(loss_s, argnums=(0, 1))(hist, TF)
    gh, gl = np.asarray(gh), np.asarray(gl)

    def mre(a, b):
        s = float(jnp.max(jnp.abs(b))) or 1.0
        return float(np.max(np.abs(a - np.asarray(b)))) / s

    assert mre(gh, gh_s) < 5e-4, "histogram cotangent (rotated, sharded)"
    assert mre(gl, gl_s) < 5e-4, "LUT cotangent (rotated, sharded)"


def test_octant_cache_slots_and_clear():
    """Per-entry-point octant cache slots: alternating scalar and hist
    permutes must not evict each other (the round-4 shared slot thrashed),
    and clear_octant_cache drops the pinned references."""
    from vrdd_tpu.parallel.sweep import (
        _OCTANT_CACHE, _permuted_sharded, clear_octant_cache,
    )

    clear_octant_cache()
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    from jax.sharding import PartitionSpec as P

    vol = jnp.asarray(np.arange(8.0, dtype=np.float32).reshape(2, 2, 2))
    hist = jnp.asarray(
        np.arange(16.0, dtype=np.float32).reshape(2, 2, 2, 2))
    a1 = _permuted_sharded(vol, (2, 1, 0), mesh, P(None, None, None),
                           slot="scalar")
    b1 = _permuted_sharded(hist, (0, 1, 3, 2), mesh,
                           P(None, None, None, None), slot="hist")
    a2 = _permuted_sharded(vol, (2, 1, 0), mesh, P(None, None, None),
                           slot="scalar")
    b2 = _permuted_sharded(hist, (0, 1, 3, 2), mesh,
                           P(None, None, None, None), slot="hist")
    assert a2 is a1, "scalar slot evicted by the hist permute"
    assert b2 is b1, "hist slot evicted by the scalar permute"
    clear_octant_cache("scalar")
    assert "scalar" not in _OCTANT_CACHE and "hist" in _OCTANT_CACHE
    clear_octant_cache()
    assert not _OCTANT_CACHE


@pytest.mark.parametrize("stat,tscl", [("mean", 1.0), ("var", 8.0),
                                       ("entropy", 1.0)])
def test_distributed_hist_stats_8_devices(stat, tscl):
    """Every statistic on the full 8-device virtual mesh (4 bricks x 2 ray
    shards, saturating density so the two-pass early termination runs)
    against the single-device decode-then-sweep."""
    hist, _ = _hist(seed=29)
    rows, mode = decode_weight_rows(stat, 8, family="unit")
    mesh = make_mesh(bricks=4, rays=2)
    dec = decode_with_rows(hist, rows, mode)
    ref = np.asarray(slice_render_image(
        dec, O, W, H, TF, n_planes=16, density=2.0, transfer_scale=tscl,
        use_custom_vjp=False,
    ))
    got = np.asarray(distributed_hist_render(
        shard_hist_volume(hist, mesh), rows, O, TF, density=2.0,
        transfer_scale=tscl, width=W, height=H, mesh=mesh, stat=mode,
    ))
    assert np.abs(ref).max() > 1e-3, "vacuous comparison: image is black"
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)
