"""End-to-end parity: JAX scan marcher vs the numpy d_render re-implementation.

This is the PR1 gate from SURVEY.md §7.3: 64^3 synthetic Gaussian-blob scalar
volume, 256^2 (here 64^2 for speed) image, grayscale-ramp TF, CPU-runnable,
allclose vs the numpy re-implementation of d_render.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrdd_tpu.core.geometry import (
    default_benchmark_inv_view,
    inv_view_from_rotation_translation,
)
from vrdd_tpu.core.transfer import default_transfer_function, grayscale_ramp
from vrdd_tpu.io.synthetic import gaussian_blob_volume, random_histogram_volume
from vrdd_tpu.march.reference_numpy import np_sample_trilinear, reference_render
from vrdd_tpu.march.scan import render_image
from vrdd_tpu.models.renderer import stats_sample_fn, scalar_sample_fn
from vrdd_tpu.ops.histogram import raw_block_stats
from vrdd_tpu.utils.config import MarchConfig


def _compare(vol_np, inv_view, tf, W=64, H=64, march=MarchConfig(), **params):
    ref = reference_render(
        lambda p: np_sample_trilinear(vol_np, p),
        inv_view,
        W,
        H,
        tf,
        max_steps=march.max_steps,
        tstep=march.tstep,
        opacity_threshold=march.opacity_threshold,
        **params,
    )
    got = render_image(
        scalar_sample_fn(jnp.asarray(vol_np)),
        jnp.asarray(inv_view),
        W,
        H,
        jnp.asarray(tf),
        jnp.float32(params.get("density", 0.05)),
        jnp.float32(params.get("brightness", 1.0)),
        jnp.float32(params.get("transfer_offset", 0.0)),
        jnp.float32(params.get("transfer_scale", 1.0)),
        march,
    )
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4, atol=2e-4)
    assert np.asarray(got)[..., 3].max() > 0.05, "render should not be empty"


def test_scalar_volume_benchmark_view_grayscale():
    vol = gaussian_blob_volume((32, 32, 32), seed=0)
    _compare(vol, default_benchmark_inv_view(), grayscale_ramp(16))


def test_scalar_volume_rotated_view_rainbow_tf():
    vol = gaussian_blob_volume((32, 32, 32), seed=1)
    inv_view = inv_view_from_rotation_translation(30.0, -45.0, (0.2, -0.1, -3.5))
    _compare(
        vol,
        inv_view,
        default_transfer_function(),
        density=0.08,
        brightness=1.2,
        transfer_offset=0.05,
        transfer_scale=1.3,
    )


def test_early_termination_parity():
    # high density forces opacity cutoff inside the volume
    vol = np.ones((8, 8, 8), dtype=np.float32) * 0.9
    _compare(
        vol,
        default_benchmark_inv_view(),
        grayscale_ramp(4),
        density=0.9,
    )


def test_histogram_stats_volume_parity():
    """Queries 1/2/3: stats volume trilinear fetch, vs numpy path."""
    hist = random_histogram_volume((10, 12, 12), seed=3)
    stats = np.asarray(raw_block_stats(jnp.asarray(hist)))
    tf = default_transfer_function()
    inv_view = default_benchmark_inv_view()
    for ch in range(3):
        ref = reference_render(
            lambda p: np_sample_trilinear(stats, p)[..., ch],
            inv_view,
            48,
            48,
            tf,
        )
        got = render_image(
            stats_sample_fn(jnp.asarray(stats), ch),
            jnp.asarray(inv_view),
            48,
            48,
            jnp.asarray(tf),
        )
        np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4, atol=2e-4)


def test_march_gradients_finite_difference():
    """Gradient of a pixel-loss w.r.t. volume matches finite differences."""
    vol = gaussian_blob_volume((8, 8, 8), seed=4)
    march = MarchConfig(max_steps=50, tstep=0.05)
    tf = jnp.asarray(grayscale_ramp(8))
    inv_view = jnp.asarray(default_benchmark_inv_view())

    def loss(v):
        img = render_image(
            scalar_sample_fn(v), inv_view, 8, 8, tf, 0.3, 1.0, 0.0, 1.0, march
        )
        return jnp.sum(img**2)

    v0 = jnp.asarray(vol)
    g = jax.grad(loss)(v0)
    rng = np.random.default_rng(0)
    idxs = [tuple(rng.integers(0, 8, size=3)) for _ in range(4)]
    eps = 1e-3
    for idx in idxs:
        dv = np.zeros_like(vol)
        dv[idx] = eps
        fd = (float(loss(v0 + dv)) - float(loss(v0 - dv))) / (2 * eps)
        np.testing.assert_allclose(float(g[idx]), fd, rtol=5e-2, atol=1e-4)


def test_brightness_not_applied_to_missed_rays():
    # camera inside looking away: some rays miss -> stay exactly zero
    vol = np.ones((4, 4, 4), dtype=np.float32)
    inv_view = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 10.0]], dtype=np.float32
    )
    got = np.asarray(
        render_image(
            scalar_sample_fn(jnp.asarray(vol)),
            jnp.asarray(inv_view),
            16,
            16,
            jnp.asarray(grayscale_ramp(4)),
            0.05,
            5.0,
        )
    )
    ref = reference_render(
        lambda p: np_sample_trilinear(vol, p),
        inv_view,
        16,
        16,
        grayscale_ramp(4),
        brightness=5.0,
    )
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_point_filter_on_object_order_paths():
    """The reference's 'f' key (setTextureFilterMode, volumeRender.cpp:
    311-314) on the slice sweep: one-hot (floor) weight rows behind
    filter_linear=False. The sweep's plane discretization differs from
    ray-order, so scan parity is bulk-level; the nearest render must track
    the scan marcher's NEAREST mode much closer than its linear mode."""

    from vrdd_tpu.core.geometry import default_benchmark_inv_view
    from vrdd_tpu.core.transfer import default_transfer_function
    from vrdd_tpu.io.synthetic import random_histogram_volume
    from vrdd_tpu.march.scan import render_image
    from vrdd_tpu.march.slice import slice_render_image
    from vrdd_tpu.models.renderer import stats_sample_fn
    from vrdd_tpu.ops.histogram import raw_block_stats
    from vrdd_tpu.utils.config import MarchConfig

    hist = jnp.asarray(random_histogram_volume((10, 50, 50), n_bins=32, seed=0))
    stats = raw_block_stats(hist)
    vol = stats[..., 0]
    iv = jnp.asarray(default_benchmark_inv_view())
    tf = jnp.asarray(default_transfer_function())
    march = MarchConfig(max_steps=500, tstep=0.01)
    W = H = 64
    o = iv[:, 3]
    scan_n = np.asarray(render_image(
        stats_sample_fn(stats, 0, linear=False), iv, W, H, tf,
        march=march, density=0.3,
    ))
    scan_l = np.asarray(render_image(
        stats_sample_fn(stats, 0, linear=True), iv, W, H, tf,
        march=march, density=0.3,
    ))
    got = np.asarray(slice_render_image(
        vol, o, W, H, tf, density=0.3, march=march, n_planes=64,
        filter_linear=False,
    ))
    d_n = np.abs(got - scan_n)
    d_l = np.abs(got - scan_l)
    assert np.quantile(d_n, 0.90) < 0.06, np.quantile(d_n, 0.90)
    assert d_n.mean() < 0.025, d_n.mean()
    # discriminates: point sampling is NOT just linear within tolerance
    assert d_n.mean() < 0.6 * d_l.mean(), (d_n.mean(), d_l.mean())


def test_box_clipping_non_default():
    """BASELINE config 2's box clipping with a NON-default asymmetric box:
    the general scan marcher and the slice sweep must agree on the clip
    region (coverage masks + coordinate mapping), and rays that miss the
    box must stay fully transparent."""

    from vrdd_tpu.core.geometry import default_benchmark_inv_view
    from vrdd_tpu.core.transfer import default_transfer_function
    from vrdd_tpu.io.synthetic import gaussian_blob_volume
    from vrdd_tpu.march.scan import render_image
    from vrdd_tpu.march.slice import slice_render_image
    from vrdd_tpu.models.renderer import scalar_sample_fn
    from vrdd_tpu.utils.config import MarchConfig

    vol = jnp.asarray(gaussian_blob_volume((24, 24, 24), seed=8))
    tf = jnp.asarray(default_transfer_function())
    iv = jnp.asarray(default_benchmark_inv_view())
    o = iv[:, 3]
    march = MarchConfig(
        max_steps=500, tstep=0.01,
        box_min=(-0.5, -1.0, -0.75), box_max=(1.0, 0.25, 1.0),
    )
    W = H = 64
    scan = np.asarray(render_image(
        scalar_sample_fn(vol), iv, W, H, tf, march=march, density=0.4,
    ))
    slc = np.asarray(slice_render_image(
        vol, o, W, H, tf, 0.4, march=march, n_planes=128,
    ))
    # sweep vs scan to sweep discretization tolerance
    d = np.abs(slc - scan)
    assert np.quantile(d, 0.98) < 0.06, np.quantile(d, 0.98)
    # clipping visible: the clipped render differs from the full-box one
    # and rays that miss the box are fully transparent on every path
    full = np.asarray(render_image(
        scalar_sample_fn(vol), iv, W, H, tf,
        march=MarchConfig(max_steps=500, tstep=0.01), density=0.4,
    ))
    assert np.abs(full - scan).max() > 0.05
    # the smaller box covers strictly fewer pixels on every path (the
    # volume remaps into the box, so per-pixel coverage is not a subset —
    # only the covered AREA shrinks)
    cov_full = float((full[..., 3] > 1e-6).sum())
    for img in (scan, slc):
        cov = float((img[..., 3] > 1e-6).sum())
        assert 0 < cov < 0.8 * cov_full, (cov, cov_full)


@pytest.mark.parametrize("W,H", [(100, 72), (40, 264), (136, 24), (33, 17)])
def test_slice_sweep_matches_numpy_reference_unaligned(W, H):
    """The slice sweep at image sizes that are not multiples of any tile
    (unaligned, tall, wide, odd) against the numpy specification of
    d_render: every size renders the same bulk image, to the sweep's
    plane-vs-shell discretization tolerance."""
    from vrdd_tpu.march.slice import slice_render_image

    vol = gaussian_blob_volume((24, 24, 24), seed=12)
    tf = default_transfer_function()
    iv = default_benchmark_inv_view()
    ref = reference_render(
        lambda p: np_sample_trilinear(vol, p), iv, W, H, tf, density=0.3,
    )
    got = np.asarray(slice_render_image(
        jnp.asarray(vol), jnp.asarray(iv[:, 3]), W, H, jnp.asarray(tf),
        0.3, n_planes=128,
    ))
    assert got.shape == (H, W, 4)
    d = np.abs(got - ref)
    assert np.quantile(d, 0.98) < 0.06, np.quantile(d, 0.98)
    assert d.mean() < 0.02, d.mean()
    assert ref[..., 3].max() > 0.1, "render should not be empty"


def test_reference_row_band_matches_full_image():
    """reference_render(rows=...) is exactly the band of the full image."""
    vol = gaussian_blob_volume((12, 12, 12), seed=13)
    tf = grayscale_ramp(8)
    iv = default_benchmark_inv_view()
    full = reference_render(lambda p: np_sample_trilinear(vol, p), iv, 24,
                            20, tf)
    band = reference_render(lambda p: np_sample_trilinear(vol, p), iv, 24,
                            20, tf, rows=(7, 13))
    np.testing.assert_array_equal(band, full[7:13])
