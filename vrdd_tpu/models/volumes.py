"""Distribution-volume representations (model families).

Each family mirrors one of the reference's three per-voxel distribution
representations (SURVEY.md §0) plus the plain scalar volume and the
Gaussian-moment volume of the north-star configs. Every family exposes
``stats_volume()`` returning a ``(Z, Y, X, 3)`` float32 array of
(mean, variance, entropy) — the analogue of originalQueryTex / fractalQueryTex
/ flexBlockTex, computed as one fused, vmapped decode instead of the
reference's per-thread kernels (d_basicDataProcessing,
volumeRender_kernel.cu:722-872).

All classes are pytrees, so they can cross jit boundaries and be donated /
sharded like any other JAX value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from vrdd_tpu.ops.fractal import fractal_decode_batch
from vrdd_tpu.ops.gaussian import gaussian_stats
from vrdd_tpu.ops.histogram import fractal_block_stats, raw_block_stats


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScalarVolume:
    """One scalar per voxel — densities are sampled directly (PR1/128^3 configs)."""

    values: jnp.ndarray  # (Z, Y, X)

    def stats_volume(self) -> jnp.ndarray:
        v = self.values
        return jnp.stack([v, jnp.zeros_like(v), jnp.zeros_like(v)], axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RawHistogramVolume:
    """Per-voxel (per-block) raw histograms: ``(Z, Y, X, n_bins)``.

    The Isabel representation: 50x50x10 blocks x 32 bins
    (volumeRender.cpp:86-87).
    """

    histograms: jnp.ndarray  # (Z, Y, X, B)

    def stats_volume(self) -> jnp.ndarray:
        return raw_block_stats(self.histograms)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FractalHistogramVolume:
    """Similarity-coded histograms: codebook + sparse errors + template bank.

    ``codebook`` is ``(Z, Y, X, 4)`` int32 (templateId, shift, flipFlag,
    nErrors); ``error_bins``/``error_values`` are ``(Z, Y, X, E)`` padded
    sparse corrections; ``templates`` is ``(T, n_bins)``.
    (Loader formats: volumeRender.cpp:558-691.)
    """

    codebook: jnp.ndarray
    error_bins: jnp.ndarray
    error_values: jnp.ndarray
    templates: jnp.ndarray

    def decode(self) -> jnp.ndarray:
        """Decode every voxel's histogram: ``(Z, Y, X, n_bins)``."""
        zyx = self.codebook.shape[:3]
        cb = self.codebook.reshape(-1, 4)
        per_entry_templates = self.templates[cb[:, 0]]
        decoded = fractal_decode_batch(
            per_entry_templates,
            cb[:, 1],
            cb[:, 2],
            self.error_bins.reshape(len(cb), -1),
            self.error_values.reshape(len(cb), -1),
            cb[:, 3],
        )
        return decoded.reshape(*zyx, -1)

    def stats_volume(self) -> jnp.ndarray:
        return fractal_block_stats(self.decode())


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussianMomentVolume:
    """Per-voxel Gaussian (mu, sigma) — the north-star 256^3 config."""

    mu: jnp.ndarray  # (Z, Y, X)
    sigma: jnp.ndarray  # (Z, Y, X)

    def stats_volume(self) -> jnp.ndarray:
        return gaussian_stats(self.mu, self.sigma)


@jax.jit
def compute_stats_volume(volume) -> jnp.ndarray:
    """Any family's stats decode as ONE jitted call.

    An eager op chain dispatches and compiles every op separately; the
    families are registered pytrees, so one jit serves them all.
    """
    return volume.stats_volume()
