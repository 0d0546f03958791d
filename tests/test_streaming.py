"""Streamed (in-sweep) distribution decode vs decode-everything-then-render."""

import numpy as np
import jax
import jax.numpy as jnp

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.march.streaming import streaming_decode_render
from vrdd_tpu.ops.histogram import flex_block_stats

TF = jnp.asarray(default_transfer_function())
O = jnp.asarray([0.0, 0.0, 4.0])


def _hist_volume(n=16, bins=8, seed=0):
    key = jax.random.PRNGKey(seed)
    logits = jax.random.normal(key, (n, n, n, bins), dtype=jnp.float32)
    return jax.nn.softmax(2.0 * logits, axis=-1)


def _decode(h):
    return flex_block_stats(h, channels=(0,))[..., 0] / 255.0


def test_streaming_matches_materialized():
    hist = _hist_volume()
    vol = _decode(hist)
    ref = np.asarray(
        slice_render_image(vol, O, 32, 32, TF, n_planes=32, density=0.3)
    )
    for chunk_planes in (8, 16, 32):
        got = np.asarray(
            streaming_decode_render(
                hist, _decode, O, TF, density=0.3, width=32, height=32,
                n_planes=32, chunk_planes=chunk_planes,
            )
        )
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)


def test_streaming_early_termination_exact():
    """Saturating density: chained seeds must freeze exactly like the
    single-sweep early termination (the seed alpha IS the true prefix)."""
    hist = _hist_volume(seed=3)
    vol = _decode(hist)
    ref = np.asarray(
        slice_render_image(vol, O, 32, 32, TF, n_planes=32, density=5.0)
    )
    got = np.asarray(
        streaming_decode_render(
            hist, _decode, O, TF, density=5.0,
            width=32, height=32, n_planes=32, chunk_planes=8,
        )
    )
    assert (ref[..., 3] > 0.95).any()  # ET actually triggered
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)


def test_streaming_gradients_match():
    """Gradients reach the histograms and the LUT exactly as if the full
    volume had been decoded first (chunked seed-cotangent chain rule +
    rematerialized decode)."""
    hist = _hist_volume(n=8, bins=8, seed=1)

    def loss_stream(h, lut):
        img = streaming_decode_render(
            h, _decode, O, lut, density=0.5, width=16, height=16,
            n_planes=16, chunk_planes=4,
        )
        return jnp.sum(img ** 2)

    def loss_mat(h, lut):
        img = slice_render_image(
            _decode(h), O, 16, 16, lut, n_planes=16, density=0.5
        )
        return jnp.sum(img ** 2)

    gs_h, gs_l = jax.grad(loss_stream, argnums=(0, 1))(hist, TF)
    gm_h, gm_l = jax.grad(loss_mat, argnums=(0, 1))(hist, TF)
    assert bool(jnp.all(jnp.isfinite(gs_h)))
    np.testing.assert_allclose(
        np.asarray(gs_h), np.asarray(gm_h), atol=1e-5, rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(gs_l), np.asarray(gm_l), atol=1e-5, rtol=1e-4
    )


def test_streaming_remat_invariant():
    hist = _hist_volume(n=8, bins=8, seed=2)

    def run(remat):
        return streaming_decode_render(
            hist, _decode, O, TF, density=0.5, width=16, height=16,
            n_planes=16, chunk_planes=4, remat=remat,
        )

    np.testing.assert_array_equal(np.asarray(run(True)), np.asarray(run(False)))


def test_streaming_gaussian_pytree():
    """Pytree distribution params: per-voxel (mu, sigma) Gaussian decode."""
    from vrdd_tpu.ops.gaussian import gaussian_stats

    rng = np.random.default_rng(4)
    mu = jnp.asarray(rng.random((8, 8, 8), dtype=np.float32))
    sigma = jnp.asarray(
        0.05 + 0.2 * rng.random((8, 8, 8), dtype=np.float32)
    )

    def decode(t):
        return gaussian_stats(t[0], t[1])[..., 0]

    ref = np.asarray(
        slice_render_image(
            decode((mu, sigma)), O, 16, 16, TF, n_planes=16, density=0.5
        )
    )
    got = np.asarray(
        streaming_decode_render(
            (mu, sigma), decode, O, TF, density=0.5, width=16, height=16,
            n_planes=16, chunk_planes=4,
        )
    )
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)

    def loss(t, lut):
        img = streaming_decode_render(
            t, decode, O, lut, density=0.5, width=16, height=16,
            n_planes=16, chunk_planes=4,
        )
        return jnp.sum(img ** 2)

    (gmu, gsig), gl = jax.grad(loss, argnums=(0, 1))((mu, sigma), TF)

    def loss_mat(t, lut):
        img = slice_render_image(
            decode(t), O, 16, 16, lut, n_planes=16, density=0.5
        )
        return jnp.sum(img ** 2)

    (rmu, rsig), rl = jax.grad(loss_mat, argnums=(0, 1))((mu, sigma), TF)
    np.testing.assert_allclose(np.asarray(gmu), np.asarray(rmu), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(gsig), np.asarray(rsig), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(gl), np.asarray(rl), atol=1e-5, rtol=1e-4)
