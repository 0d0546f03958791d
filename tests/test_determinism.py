"""Bitwise determinism of renders and gradients (SURVEY.md §5).

The reference fixed shared-memory races by hand (ver1.9.6.txt:23-26, atomics);
this design is written race-free — pure functional ops and segment-sums
instead of atomics. These tests pin the stronger property on the CPU mesh:
re-running the same computation gives BITWISE-identical results, including
across fresh jit wrappers and on the multi-device mesh (deterministic
collectives). On a GPU, XLA lowers scatter-adds (gather transposes) to
atomics, so gradients there are bitwise-reproducible only with
``--xla_gpu_deterministic_ops=true``.
"""

import numpy as np
import jax
import jax.numpy as jnp

from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.io.synthetic import gaussian_blob_volume
from vrdd_tpu.march.scan import render_image
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.models.renderer import scalar_sample_fn
from vrdd_tpu.parallel.mesh import make_mesh
from vrdd_tpu.parallel.sweep import distributed_sweep_render, shard_scalar_volume

TF = jnp.asarray(default_transfer_function())


def test_scan_render_bitwise_deterministic():
    vol = jnp.asarray(gaussian_blob_volume((16, 16, 16), seed=0))
    iv = jnp.asarray(
        inv_view_from_rotation_translation(20.0, 30.0, (0.0, 0.0, -4.0))
    )
    runs = [
        np.asarray(
            jax.jit(
                lambda v: render_image(scalar_sample_fn(v), iv, 32, 32, TF)
            )(vol)
        )
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0], runs[1])


def test_sweep_grad_bitwise_deterministic():
    vol = jnp.asarray(gaussian_blob_volume((8, 16, 16), seed=1))
    o = jnp.asarray([0.0, 0.0, 4.0])

    def loss(v):
        return jnp.sum(slice_render_image(v, o, 32, 32, TF) ** 2)

    g1 = np.asarray(jax.jit(jax.grad(loss))(vol))
    g2 = np.asarray(jax.jit(jax.grad(loss))(vol))
    np.testing.assert_array_equal(g1, g2)


def test_distributed_sweep_bitwise_deterministic():
    vol = jnp.asarray(gaussian_blob_volume((16, 16, 16), seed=2))
    o = jnp.asarray([0.0, 0.0, 4.0])
    mesh = make_mesh(bricks=4, rays=2)
    sharded = shard_scalar_volume(vol, mesh)
    runs = [
        np.asarray(
            distributed_sweep_render(
                sharded, o, TF, width=32, height=32, mesh=mesh, n_planes=32
            )
        )
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0], runs[1])
