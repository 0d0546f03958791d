"""Shear-warp renderer vs the general scan marcher on rotated views.

The shear-warp path composites in ray-slope space (per-ray exact) and adds
one bilinear warp, so agreement with the scan marcher is tolerance-based
(resampling + plane-vs-shell discretization), not bit parity.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrdd_tpu.core.geometry import (
    default_benchmark_inv_view,
    inv_view_from_rotation_translation,
)
from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.io.synthetic import gaussian_blob_volume
from vrdd_tpu.march.scan import render_image
from vrdd_tpu.march.shearwarp import (
    shearwarp_applicable,
    shearwarp_geometry,
    shearwarp_render_image,
)
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.models.renderer import scalar_sample_fn
from vrdd_tpu.utils.config import MarchConfig


@pytest.fixture(scope="module")
def vol():
    return jnp.asarray(gaussian_blob_volume((32, 32, 32), seed=3))


TF = jnp.asarray(default_transfer_function())


MARCH = MarchConfig(max_steps=250, tstep=0.02)


def _scan(vol, iv, W=64, H=64, **kw):
    return render_image(
        scalar_sample_fn(vol), jnp.asarray(iv), W, H, TF, march=MARCH, **kw
    )


@pytest.mark.parametrize(
    "rx,ry", [(0.0, 0.0), (25.0, 0.0), (0.0, 40.0), (30.0, -50.0), (80.0, 10.0)]
)
def test_shearwarp_matches_scan(vol, rx, ry):
    iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
    assert shearwarp_applicable(iv)
    ref = np.asarray(_scan(vol, iv))
    got = np.asarray(
        shearwarp_render_image(vol, iv, 64, 64, TF, march=MARCH, n_planes=128)
    )
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - ref)
    # bulk agreement; edges/discretization allowed to differ on a few pixels
    assert np.quantile(diff, 0.98) < 0.06, (rx, ry, np.quantile(diff, 0.98))
    assert diff.mean() < 0.02, (rx, ry, diff.mean())


def test_unrotated_shearwarp_matches_slice(vol):
    iv = default_benchmark_inv_view()
    a = np.asarray(shearwarp_render_image(vol, iv, 64, 64, TF, n_planes=64))
    b = np.asarray(
        slice_render_image(vol, jnp.asarray(iv[:, 3]), 64, 64, TF, n_planes=64)
    )
    # same sweep, plus one bilinear warp of the m-grid
    assert np.quantile(np.abs(a - b), 0.98) < 0.03


def test_principal_axis_selection():
    # looking along -z -> z principal; 90deg about y -> x principal
    axis, *_ , ok = shearwarp_geometry(default_benchmark_inv_view(), 32, 32)
    assert axis == 2 and ok
    iv = inv_view_from_rotation_translation(0.0, 90.0, (0.0, 0.0, -4.0))
    axis, *_, ok = shearwarp_geometry(iv, 32, 32)
    assert axis == 0 and ok


def test_shearwarp_gradients_finite(vol):
    iv = inv_view_from_rotation_translation(20.0, 35.0, (0.0, 0.0, -4.0))

    def loss(v, lut, d):
        img = shearwarp_render_image(v, iv, 32, 32, lut, density=d,
                                     n_planes=32)
        return jnp.sum(img ** 2)

    gv, gl, gd = jax.grad(loss, argnums=(0, 1, 2))(
        vol, TF, jnp.float32(0.3)
    )
    for g in (gv, gl, gd):
        assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.abs(gv).max()) > 0.0


def test_rotated_flex_query_rides_shearwarp():
    """Rotated flexible-block queries (8/9/0) on the object-order fast path:
    the shear-warp axis permutation carries the per-axis filter-grid scales
    (axis_scale), matching the scan marcher's unnormalized padded-grid fetch
    (volumeRender_kernel.cu:654-680 at an arbitrary camera, :288-296).
    Views cover all principal axes and both d_z signs on an ANISOTROPIC
    block grid (6 x 4 x 8 blocks), so a mis-permuted or dropped axis_scale
    cannot pass (the identity-scale control errs ~0.8 p98 here)."""
    from vrdd_tpu.io.synthetic import gaussian_blob_volume
    from vrdd_tpu.models.flexible import FlexibleBlockVolume
    from vrdd_tpu.models.pipeline import RenderPipeline
    from vrdd_tpu.models.renderer import flex_sample_fn
    from vrdd_tpu.utils.config import CameraConfig, QueryMethod, RenderConfig

    raw = (gaussian_blob_volume((24, 16, 32), seed=6) * 255).astype(np.float32)
    fb = FlexibleBlockVolume.from_raw(raw, block_size=4, vmax=256.0)
    pipe = RenderPipeline(flexible=fb)
    config = RenderConfig(
        camera=CameraConfig(width=64, height=64), density=0.2,
        march=MARCH, query_method=QueryMethod.FLEX_ENTROPY,
    )
    views = [(20.0, -35.0), (0.0, 80.0), (80.0, 10.0), (0.0, 180.0)]
    for rx, ry in views:
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        # 'auto' routes rotated flex queries object-order (was: scan)
        assert pipe.resolve_renderer("auto", iv, config) == "shearwarp"
        got = np.asarray(pipe.render(iv, config, "shearwarp"))
        ref = np.asarray(pipe.render(iv, config, "scan"))
        assert np.isfinite(got).all()
        diff = np.abs(got - ref)
        assert np.quantile(diff, 0.98) < 0.08, (rx, ry, np.quantile(diff, 0.98))
        assert diff.mean() < 0.012, (rx, ry, diff.mean())
        assert ref[..., 3].max() > 0.1, (rx, ry)  # scene actually visible

    # negative control: WITHOUT the scales the same render is far off —
    # the tolerance above genuinely discriminates
    grid = fb.stats_grid
    padded = jnp.pad(jnp.asarray(grid), ((0, 1), (0, 1), (0, 1), (0, 0)))
    iv = inv_view_from_rotation_translation(20.0, -35.0, (0.0, 0.0, -4.0))
    bad = np.asarray(
        shearwarp_render_image(
            padded[..., 2], iv, 64, 64, TF, density=0.2, march=MARCH,
            n_planes=128,
        )
    )
    ref = np.asarray(
        render_image(
            flex_sample_fn(grid, 2), jnp.asarray(iv), 64, 64, TF,
            march=MARCH, density=0.2,
        )
    )
    assert np.quantile(np.abs(bad - ref), 0.98) > 0.3


def test_principal_axis_geometry_matches_full_grid():
    """The O(1) corner form must agree with the full-grid geometry for
    axis, dz_sign and applicability — the distributed rotated paths render
    with the corner decision (slope_corner_bounds), so drift between the two
    formulas would sweep in the wrong direction."""
    import numpy as np
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.march.shearwarp import (
        _principal_axis_geometry,
        shearwarp_geometry,
    )

    rng = np.random.default_rng(0)
    for _ in range(60):
        rx, ry = rng.uniform(-180, 180, size=2)
        t = rng.uniform(-1, 1, size=3)
        t[2] -= 3.0
        iv = inv_view_from_rotation_translation(rx, ry, tuple(t))
        a1, p1, s1, ok1 = _principal_axis_geometry(iv, 40, 24)
        a2, p2, _, s2, ok2 = shearwarp_geometry(iv, 40, 24)
        assert (a1, p1, ok1) == (a2, p2, ok2), (rx, ry)
        if ok1:
            assert s1 == s2, (rx, ry)
