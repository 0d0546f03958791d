"""Distributed differentiable TF-LUT fitting.

The north-star training config (BASELINE.json config 4): fit the transfer
function LUT (and optionally the per-voxel distribution params) so rendered
images match targets. The forward is the bricks+rays distributed renderer;
gradients flow back through the shard_map (ppermute/all_gather transpose to
their adjoints automatically) and parameter gradients are summed across the
mesh by XLA — the "all-reduce overlapped with backward" is left to the XLA
latency-hiding scheduler (SURVEY.md hard part (e)).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vrdd_tpu.parallel.bricks import distributed_render_image
from vrdd_tpu.parallel.mesh import RAY_AXIS
from vrdd_tpu.utils.config import MarchConfig


def make_tf_fit_step(
    mesh: Mesh,
    width: int,
    height: int,
    channel: int = 0,
    march: MarchConfig = MarchConfig(),
    optimizer: optax.GradientTransformation = None,
    learn_volume: bool = False,
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for distributed TF fitting.

    ``step_fn(params, opt_state, stats, inv_view, target) -> (params,
    opt_state, loss)`` where ``params`` is ``{"tf_lut": (N, 4)}`` (plus
    ``"stats"`` if ``learn_volume``). ``target`` is an (H, W, 4) image sharded
    over rows on the rays axis.

    PERFORMANCE NOTE: this differentiates the general scan MARCHER
    (gather-bound; correct for any camera and query method, but orders of
    magnitude slower per step than the object-order path). For unrotated
    cameras over a scalar field use :func:`make_sweep_fit_step` (the sweep's
    analytic VJP) — this factory is the fallback for
    rotated views and the exotic query modes only.
    """
    optimizer = optax.adam(1e-2) if optimizer is None else optimizer

    def loss_fn(params, stats, inv_view, target):
        if learn_volume:
            stats = params["stats"]
        img = distributed_render_image(
            stats,
            inv_view,
            params["tf_lut"],
            jnp.float32(0.05),
            jnp.float32(1.0),
            jnp.float32(0.0),
            jnp.float32(1.0),
            width=width,
            height=height,
            channel=channel,
            march=march,
            mesh=mesh,
        )
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step_fn(params, opt_state, stats, inv_view, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, stats, inv_view, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init_fn(tf_lut, stats=None):
        params = {"tf_lut": jnp.asarray(tf_lut, dtype=jnp.float32)}
        if learn_volume:
            params["stats"] = stats
        return params, optimizer.init(params)

    return init_fn, step_fn


def shard_target_image(target, mesh: Mesh):
    """Place an (H, W, 4) target image row-sharded on the rays axis."""
    return jax.device_put(target, NamedSharding(mesh, P(RAY_AXIS, None, None)))


def make_sweep_fit_step(
    mesh: Mesh,
    width: int,
    height: int,
    march: MarchConfig = MarchConfig(),
    optimizer: optax.GradientTransformation = None,
    learn_volume: bool = False,
    n_planes: int = 0,
    plane_chunk: int = 8,
    density: float = 0.05,
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for distributed fitting on the FAST sweep path.

    Unlike :func:`make_tf_fit_step` (scan-marcher bricks; kept as the
    fallback for rotated cameras and flexible-block queries), the forward
    AND backward here run the distributed object-order sweep
    (parallel/sweep.py) per device under shard_map; TF-LUT gradients are
    summed across the mesh by the shard_map transpose (all-reduce overlap
    left to the XLA latency-hiding scheduler, SURVEY.md hard part (e)).

    ``step_fn(params, opt_state, volume, origin, target) -> (params,
    opt_state, loss)`` with ``params = {"tf_lut"}`` (+ ``"volume"`` when
    ``learn_volume``); ``volume`` placed via
    :func:`vrdd_tpu.parallel.sweep.shard_scalar_volume`, ``target`` via
    :func:`shard_target_image`.
    """
    from vrdd_tpu.parallel.sweep import distributed_sweep_render

    optimizer = optax.adam(1e-2) if optimizer is None else optimizer

    def loss_fn(params, volume, origin, target):
        if learn_volume:
            volume = params["volume"]
        img = distributed_sweep_render(
            volume,
            origin,
            params["tf_lut"],
            jnp.float32(density),
            width=width,
            height=height,
            march=march,
            mesh=mesh,
            n_planes=n_planes,
            plane_chunk=plane_chunk,
        )
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step_fn(params, opt_state, volume, origin, target):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, volume, origin, target
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init_fn(tf_lut, volume=None):
        params = {"tf_lut": jnp.asarray(tf_lut, dtype=jnp.float32)}
        if learn_volume:
            params["volume"] = volume
        return params, optimizer.init(params)

    return init_fn, step_fn
