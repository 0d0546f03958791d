"""Differentiable-fitting tests: the north-star training configurations.

BASELINE.json configs 3/4: per-voxel distribution parameters (Gaussian
mu/sigma, histograms) and the TF LUT are fitted by gradient descent through
the renderer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from vrdd_tpu.core.geometry import default_benchmark_inv_view
from vrdd_tpu.core.transfer import default_transfer_function, grayscale_ramp
from vrdd_tpu.io.synthetic import gaussian_blob_volume, random_histogram_volume
from vrdd_tpu.march.scan import render_image
from vrdd_tpu.models.renderer import scalar_sample_fn, stats_sample_fn
from vrdd_tpu.models.volumes import GaussianMomentVolume
from vrdd_tpu.ops.histogram import raw_block_stats
from vrdd_tpu.utils.config import MarchConfig

MARCH = MarchConfig(max_steps=60, tstep=0.05)
IV = jnp.asarray(default_benchmark_inv_view())
TF = jnp.asarray(default_transfer_function())


def _render_stats(stats, tf=TF, ch=0, n=16):
    return render_image(stats_sample_fn(stats, ch), IV, n, n, tf, march=MARCH)


def test_fit_gaussian_moments_through_render():
    """Recover perturbed per-voxel mu by matching target renders (config 3)."""
    rng = np.random.default_rng(0)
    mu_true = jnp.asarray(gaussian_blob_volume((8, 8, 8), seed=1))
    sigma = jnp.full((8, 8, 8), 0.1, dtype=jnp.float32)
    target = _render_stats(GaussianMomentVolume(mu_true, sigma).stats_volume())

    def loss_fn(mu):
        img = _render_stats(GaussianMomentVolume(mu, sigma).stats_volume())
        return jnp.mean((img - target) ** 2)

    mu = mu_true + 0.3 * jnp.asarray(
        rng.standard_normal((8, 8, 8)).astype(np.float32)
    )
    opt = optax.adam(3e-2)
    state = opt.init(mu)
    step = jax.jit(
        lambda mu, st: (lambda l, g: (optax.apply_updates(mu, opt.update(g, st, mu)[0]),
                                      opt.update(g, st, mu)[1], l))(
            *jax.value_and_grad(loss_fn)(mu))
    )
    l0 = float(loss_fn(mu))
    for _ in range(40):
        mu, state, loss = step(mu, state)
    assert float(loss) < l0 * 0.3, (l0, float(loss))


def test_fit_histograms_through_decode_and_render():
    """Gradients reach raw per-voxel histogram parameters (config 4)."""
    hist_true = jnp.asarray(random_histogram_volume((6, 6, 6), seed=2))
    target = _render_stats(raw_block_stats(hist_true))

    def loss_fn(logits):
        hist = jax.nn.softmax(logits, axis=-1)
        img = _render_stats(raw_block_stats(hist))
        return jnp.mean((img - target) ** 2)

    logits = jnp.zeros_like(hist_true)
    g = jax.grad(loss_fn)(logits)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.linalg.norm(g)) > 0.0
    opt = optax.adam(5e-2)
    state = opt.init(logits)

    @jax.jit
    def step(p, st):
        l, g = jax.value_and_grad(loss_fn)(p)
        up, st = opt.update(g, st, p)
        return optax.apply_updates(p, up), st, l

    l0 = float(loss_fn(logits))
    for _ in range(40):
        logits, state, loss = step(logits, state)
    assert float(loss) < l0 * 0.5, (l0, float(loss))


def test_remat_chunk_gradients_match():
    vol = jnp.asarray(gaussian_blob_volume((8, 8, 8), seed=3))
    march = MarchConfig(max_steps=40, tstep=0.06)
    tf = jnp.asarray(grayscale_ramp(8))

    def make_loss(remat_chunk):
        def loss(v):
            img = render_image(
                scalar_sample_fn(v), IV, 8, 8, tf, march=march,
                remat_chunk=remat_chunk,
            )
            return jnp.sum(img**2)
        return loss

    g0 = jax.grad(make_loss(0))(vol)
    g1 = jax.grad(make_loss(8))(vol)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), rtol=1e-5, atol=1e-7)


def test_render_determinism_bitwise():
    """Re-runs are bitwise identical (no atomics by construction)."""
    vol = jnp.asarray(gaussian_blob_volume((12, 12, 12), seed=4))
    f = jax.jit(
        lambda v: render_image(scalar_sample_fn(v), IV, 32, 32, TF, march=MARCH)
    )
    a = np.asarray(f(vol))
    b = np.asarray(f(vol))
    np.testing.assert_array_equal(a, b)
    # fresh compilation, same result
    g = jax.jit(
        lambda v: render_image(scalar_sample_fn(v), IV, 32, 32, TF, march=MARCH),
    )
    c = np.asarray(g(vol + 0.0))
    np.testing.assert_array_equal(a, c)


def test_sweep_fit_step_distributed():
    """Fast-path distributed training: TF fitting through the distributed
    object-order sweep (the north-star training step; the scan-bricks path
    stays as the rotated/flex fallback)."""
    from vrdd_tpu.parallel.mesh import make_mesh
    from vrdd_tpu.parallel.sweep import (
        distributed_sweep_render,
        shard_scalar_volume,
    )
    from vrdd_tpu.parallel.train import make_sweep_fit_step, shard_target_image

    mesh = make_mesh(2, 4)
    vol = shard_scalar_volume(
        jnp.asarray(gaussian_blob_volume((16, 16, 16), seed=1)), mesh
    )
    o = jnp.asarray([0.0, 0.0, 4.0])
    target = distributed_sweep_render(
        vol, o, TF, width=32, height=32, mesh=mesh, n_planes=32
    )
    target = shard_target_image(target, mesh)

    init_fn, step_fn = make_sweep_fit_step(mesh, 32, 32, n_planes=32)
    params, st = init_fn(grayscale_ramp(9))
    losses = []
    for _ in range(12):
        params, st, loss = step_fn(params, st, vol, o, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses
