"""Distribution decode of bins-major histogram volumes
(ops/histogram.py decode_weight_rows / decode_with_rows) and the slice
sweep over the decoded statistic.

The decode is pinned against a float64 numpy evaluation of the reference
formulas (volumeRender_kernel.cu:742-769 raw, :841-867 fractal,
:1083-1115 flexible) and, through the sweep, against the channel-last
``*_block_stats`` decode and plain autodiff."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.ops.histogram import (
    decode_weight_rows,
    decode_with_rows,
    raw_block_stats,
)
from vrdd_tpu.utils.config import (
    FLEX_MAX_HISTOGRAM,
    MAX_HISTOGRAM,
    MEAN_NORM,
    N_BINS,
    VARIANCE_NORM,
)

TF = jnp.asarray(default_transfer_function())
O = jnp.asarray([0.0, 0.0, 4.0])
W = H = 40


def _hist(nz=16, B=8, seed=0, ny=None, nx=None):
    rng = np.random.default_rng(seed)
    h = rng.random((nz, B, ny or nz, nx or nz)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    return jnp.asarray(h)


def _hist32(nz=16, seed=0):
    return _hist(nz=nz, B=N_BINS, seed=seed)


def _mre(a, b):
    s = float(jnp.max(jnp.abs(b))) or 1.0
    return float(jnp.max(jnp.abs(a - b))) / s


def _oracle(h, stat, family):
    """float64 numpy evaluation of the reference decode formulas on a
    bins-major (Z, B, Y, X) volume."""
    h = np.asarray(h, dtype=np.float64)
    B = h.shape[1]
    vmax, mnorm, vnorm = {
        "raw": (MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM),
        "fractal": (MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM),
        "flex": (FLEX_MAX_HISTOGRAM, 1.0, 1.0),
        "unit": (1.0, 1.0, 1.0),
    }[family]
    bw = vmax / B
    i = np.arange(B, dtype=np.float64)
    centers = (bw * i + bw / 2.0)[None, :, None, None]
    edges = ((i / B) * vmax)[None, :, None, None]
    mean = np.sum(h * centers, axis=1)
    if stat == "mean":
        return mean / mnorm
    if stat == "var":
        e = edges if family == "raw" else centers
        return np.sum(h * (e - mean[:, None]) ** 2, axis=1) / vnorm
    safe = np.where(h > 0.0, h, 1.0)
    return -np.sum(h * np.log2(safe), axis=1) / np.log2(B)


def _sweep(vol, **kw):
    return slice_render_image(vol, O, W, H, TF, n_planes=vol.shape[0], **kw)


# ---- the decode against the float64 oracle ----

@pytest.mark.parametrize("family", ["raw", "fractal", "flex", "unit"])
@pytest.mark.parametrize("stat", ["mean", "var", "entropy"])
def test_decode_matches_float64_oracle(stat, family):
    """f32 decode vs float64: a sum of B products per voxel in f32, so the
    relative error bound is ~B * 2^-24; 1e-5 of the statistic's range
    leaves a margin of ~10x at 32 bins (the variance combine subtracts, so
    its bound is taken against the largest term, not the difference)."""
    hist = _hist32(nz=8, seed=31)
    rows, mode = decode_weight_rows(stat, N_BINS, family=family)
    got = np.asarray(decode_with_rows(hist, rows, mode))
    ref = _oracle(hist, stat, family)
    assert got.dtype == np.float32 and got.shape == ref.shape
    tol = 1e-5 * np.abs(ref).max()
    if stat == "var":
        e_max = {"raw": MAX_HISTOGRAM, "fractal": MAX_HISTOGRAM,
                 "flex": FLEX_MAX_HISTOGRAM, "unit": 1.0}[family]
        scale = 1.0 / (VARIANCE_NORM if family in ("raw", "fractal")
                       else 1.0)
        tol = 1e-5 * e_max ** 2 * scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("stat", ["mean", "var", "entropy"])
def test_decode_bf16_storage_matches_oracle(stat):
    """bf16-stored histograms decode in f32: the only error beyond the f32
    decode is the storage rounding of each bin (2^-9 relative), so the
    decode of the bf16 volume must match the float64 oracle OF THE SAME
    ROUNDED BINS to f32 accuracy."""
    h16 = _hist32(nz=8, seed=37).astype(jnp.bfloat16)
    rows, mode = decode_weight_rows(stat, N_BINS, family="unit")
    got = np.asarray(decode_with_rows(h16, rows, mode))
    ref = _oracle(np.asarray(h16.astype(jnp.float32)), stat, "unit")
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# ---- decode + sweep (the render-hist / fit-hist path) ----

def test_forward_matches_materialized():
    """The bins-major decode through the sweep == the channel-last
    raw_block_stats decode through the same sweep."""
    hist = _hist32(seed=1)
    rows, mode = decode_weight_rows("mean", N_BINS, family="raw")
    got = np.asarray(_sweep(decode_with_rows(hist, rows, mode), density=0.3))
    ref = np.asarray(_sweep(
        raw_block_stats(jnp.moveaxis(hist, 1, -1), channels=(0,))[..., 0],
        density=0.3,
    ))
    assert np.abs(ref).max() > 1e-3, "vacuous comparison: image is black"
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_grads_match_materialized():
    """Histogram, decode-weight and LUT cotangents through the decode and
    the sweep's analytic VJP == plain autodiff through an einsum decode."""
    hist = _hist(seed=3)
    w = jnp.asarray((np.arange(8, dtype=np.float32) + 0.5) / 8)

    def loss_hist(h, w_, lut):
        img = slice_render_image(decode_with_rows(h, w_[None], "linear"),
                                 O, W, H, lut, n_planes=16, density=0.08)
        return jnp.sum(img ** 2)

    def loss_ref(h, w_, lut):
        dec = jnp.einsum("zbyx,b->zyx", h, w_)
        img = slice_render_image(dec, O, W, H, lut, n_planes=16,
                                 density=0.08, use_custom_vjp=False)
        return jnp.sum(img ** 2)

    v_h, (gh, gw, gl) = jax.value_and_grad(
        loss_hist, argnums=(0, 1, 2))(hist, w, TF)
    v_r, (gh_r, gw_r, gl_r) = jax.value_and_grad(
        loss_ref, argnums=(0, 1, 2))(hist, w, TF)
    assert abs(float(v_h - v_r)) / abs(float(v_r)) < 1e-5
    assert _mre(gh, gh_r) < 1e-4, "histogram cotangent"
    assert _mre(gw, gw_r) < 1e-4, "decode-weight cotangent"
    assert _mre(gl, gl_r) < 5e-4, "LUT cotangent"


def test_early_termination_matches():
    """Saturating density: the sweep's opacity cutoff through the decode
    freezes exactly like the materialized reference."""
    hist = _hist(seed=7)
    w = jnp.asarray((np.arange(8, dtype=np.float32) + 0.5) / 8)
    ref = np.asarray(_sweep(jnp.einsum("zbyx,b->zyx", hist, w), density=5.0,
                            use_custom_vjp=False))
    got = np.asarray(_sweep(decode_with_rows(hist, w[None], "linear"),
                            density=5.0))
    assert (ref[..., 3] > 0.95).any()  # ET actually triggered
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_bf16_histogram_storage():
    """bf16-stored distribution volume: half the bytes the decode reads;
    the image stays within bf16 storage rounding of the f32 render, and the
    histogram cotangent comes back in the storage dtype, pointing with the
    f32 gradient."""
    hist = _hist(seed=9)
    h16 = hist.astype(jnp.bfloat16)
    rows, mode = decode_weight_rows("mean", 8, family="unit")

    def render(h, lut):
        return _sweep(decode_with_rows(h, rows, mode), density=0.3)

    ref = np.asarray(render(hist, TF))
    got = np.asarray(render(h16, TF))
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=1e-2)

    def loss(h, lut):
        return jnp.sum(render(h, lut) ** 2)

    gh = jax.grad(loss)(h16, TF)
    g32 = jax.grad(loss)(hist, TF)
    assert gh.dtype == jnp.bfloat16
    num = float(jnp.sum(gh.astype(jnp.float32) * g32))
    den = float(jnp.linalg.norm(gh.astype(jnp.float32))
                * jnp.linalg.norm(g32))
    assert num / den > 0.999, "bf16 grads must point with the f32 grads"


def test_non_pow2_volume_dims():
    """Volume and bin extents are free: no tiling constraint anywhere."""
    hist = _hist(nz=12, B=5, seed=11, ny=20, nx=24)
    w = jnp.asarray((np.arange(5, dtype=np.float32) + 0.5) / 5)
    ref = np.asarray(_sweep(jnp.einsum("zbyx,b->zyx", hist, w)))
    got = np.asarray(_sweep(decode_with_rows(hist, w[None], "linear")))
    assert got.shape == (H, W, 4)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


# var decodes to ~2 after /VARIANCE_NORM — window the TF (transfer_scale)
# so the statistic lands mid-ramp instead of clipping to the black end knot
@pytest.mark.parametrize("stat,chan,tscl", [("mean", 0, 1.0),
                                            ("var", 1, 0.3),
                                            ("entropy", 2, 1.0)])
def test_nonlinear_stats_match_materialized(stat, chan, tscl):
    """decode_with_rows' var/entropy == raw_block_stats through the sweep:
    the reference's query 1/2/3 statistics (volumeRender_kernel.cu:
    742-769)."""
    hist = _hist32(seed=13)
    rows, mode = decode_weight_rows(stat, N_BINS, family="raw")
    decoded = raw_block_stats(
        jnp.moveaxis(hist, 1, -1), channels=(chan,)
    )[..., 0]
    ref = np.asarray(_sweep(decoded, density=0.3, transfer_scale=tscl))
    got = np.asarray(_sweep(decode_with_rows(hist, rows, mode), density=0.3,
                            transfer_scale=tscl))
    assert np.abs(ref).max() > 1e-3, "vacuous comparison: image is black"
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("stat,chan,tscl", [("var", 1, 0.3),
                                            ("entropy", 2, 1.0)])
def test_nonlinear_grads_match_materialized(stat, chan, tscl):
    """Histogram + LUT cotangents through the nonlinear decode and the
    sweep's VJP vs autodiff through the raw_block_stats pipeline."""
    hist = _hist32(seed=17)
    rows, mode = decode_weight_rows(stat, N_BINS, family="raw")

    def loss_hist(h, lut):
        img = slice_render_image(
            decode_with_rows(h, rows, mode), O, W, H, lut, n_planes=16,
            density=0.3, transfer_scale=tscl,
        )
        return jnp.sum(img ** 2)

    def loss_ref(h, lut):
        dec = raw_block_stats(jnp.moveaxis(h, 1, -1),
                              channels=(chan,))[..., 0]
        img = slice_render_image(
            dec, O, W, H, lut, n_planes=16, density=0.3,
            transfer_scale=tscl, use_custom_vjp=False,
        )
        return jnp.sum(img ** 2)

    v_h, (gh, gl) = jax.value_and_grad(loss_hist, argnums=(0, 1))(hist, TF)
    v_r, (gh_r, gl_r) = jax.value_and_grad(loss_ref, argnums=(0, 1))(hist, TF)
    assert abs(float(v_h - v_r)) / abs(float(v_r)) < 1e-5
    assert _mre(gh, gh_r) < 5e-4, "histogram cotangent"
    assert _mre(gl, gl_r) < 5e-4, "LUT cotangent"


def test_entropy_zero_bins_gradient():
    """Exact-zero bins: forward term is 0 and the cotangent is 0 (matching
    histogram_entropy's safe-log), never inf/nan."""
    nz = 16
    rng = np.random.default_rng(23)
    h = rng.random((nz, 8, nz, nz)).astype(np.float32)
    h[:, 3] = 0.0  # a bin that is exactly zero everywhere
    h /= h.sum(axis=1, keepdims=True)
    hist = jnp.asarray(h)
    rows, mode = decode_weight_rows("entropy", 8)

    def loss(hh):
        img = _sweep(decode_with_rows(hh, rows, mode), density=0.3)
        return jnp.sum(img ** 2)

    gh = np.asarray(jax.grad(loss)(hist))
    assert np.all(np.isfinite(gh))
    assert np.all(gh[:, 3] == 0.0), "zero bins must get zero cotangent"


@pytest.mark.gpu
def test_decode_on_gpu_matches_float64_oracle(gpu_device):
    """On the card the bins contractions must stay float32 (no TF32): the
    variance combine would otherwise miss the oracle by ~1e-3."""
    hist = jax.device_put(_hist32(nz=64, seed=41), gpu_device)
    for family in ("raw", "unit"):
        rows, mode = decode_weight_rows("var", N_BINS, family=family)
        got = np.asarray(decode_with_rows(hist, rows, mode))
        ref = _oracle(np.asarray(hist), "var", family)
        e_max = MAX_HISTOGRAM if family == "raw" else 1.0
        scale = 1.0 / VARIANCE_NORM if family == "raw" else 1.0
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * e_max ** 2 * scale)
