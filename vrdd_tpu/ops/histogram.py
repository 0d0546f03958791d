"""Histogram -> (mean, variance, entropy) decode ops.

These are the distribution-decode building blocks of the framework — the
equivalent of d_basicDataProcessing / d_computeBlock. The ``*_block_stats``
functions operate on a trailing bins axis, broadcast over any leading shape
(so the whole volume decodes as one fused elementwise pass), and are
differentiable; :func:`decode_with_rows` decodes a bins-MAJOR
``(Z, B, Y, X)`` volume to one statistic with the same formulas.

The reference's quirky normalizations are preserved bit-for-bit for parity
(SURVEY.md "hard parts (d)"):

- raw path (volumeRender_kernel.cu:742-769): mean uses bin *centers*
  ``binWidth * i + binWidth / 2``, variance uses bin *left edges*
  ``(i / nBins) * MaxHistogram`` against that mean; then ``mean /= 0.0217``,
  ``variance /= 0.000021``; entropy is Shannon/log2(nBins).
- fractal path (volumeRender_kernel.cu:841-867): mean AND variance both use
  bin centers; same normalizers.
- flexible path (volumeRender_kernel.cu:1083-1115): 64 bins over [0, 255],
  centers for both, NO mean/variance normalization, entropy/log2(64).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vrdd_tpu.utils.config import (
    FLEX_MAX_HISTOGRAM,
    FLEX_N_BINS,
    MAX_HISTOGRAM,
    MEAN_NORM,
    N_BINS,
    VARIANCE_NORM,
)


def _bin_centers(n_bins: int, vmax: float) -> jnp.ndarray:
    bin_width = vmax / n_bins
    i = jnp.arange(n_bins, dtype=jnp.float32)
    return bin_width * i + bin_width / 2.0


def _bin_left_edges(n_bins: int, vmax: float) -> jnp.ndarray:
    i = jnp.arange(n_bins, dtype=jnp.float32)
    return (i / n_bins) * vmax


def histogram_entropy(hist: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """Normalized Shannon entropy ``-sum p log2 p / log2(n)``; 0-bins contribute 0."""
    safe = jnp.where(hist > 0.0, hist, 1.0)
    ent = -jnp.sum(hist * jnp.log2(safe), axis=-1)
    return ent / jnp.log2(jnp.float32(n_bins))


def _select_stats(builders, channels):
    """Stack only the requested stat channels (0=mean, 1=var, 2=entropy).

    ``channels=None`` keeps the full (..., 3) layout. Explicit selection
    exists because XLA does NOT reliably dead-code-eliminate the unused
    channels through a ``stack(...)[..., c]`` pattern inside larger
    differentiated graphs — measured 18.5 ms vs ~4 ms for a mean-only
    decode+grad of a 256^3 x 16-bin volume — so callers on a hot path
    should ask for exactly what they read."""
    if channels is None:
        channels = (0, 1, 2)
    return jnp.stack([builders[c]() for c in channels], axis=-1)


def raw_block_stats(hist: jnp.ndarray, channels=None) -> jnp.ndarray:
    """Raw-histogram decode: ``(..., N_BINS) -> (..., len(channels))``
    (default all three: mean, var, entropy)."""
    centers = _bin_centers(N_BINS, MAX_HISTOGRAM)
    edges = _bin_left_edges(N_BINS, MAX_HISTOGRAM)
    mean = jnp.sum(hist * centers, axis=-1)
    return _select_stats([
        lambda: mean / MEAN_NORM,
        lambda: jnp.sum(
            hist * (edges - mean[..., None]) ** 2, axis=-1) / VARIANCE_NORM,
        lambda: histogram_entropy(hist, N_BINS),
    ], channels)


def fractal_block_stats(hist: jnp.ndarray, channels=None) -> jnp.ndarray:
    """Fractal-decoded-histogram stats: centers for mean AND variance."""
    centers = _bin_centers(N_BINS, MAX_HISTOGRAM)
    mean = jnp.sum(hist * centers, axis=-1)
    return _select_stats([
        lambda: mean / MEAN_NORM,
        lambda: jnp.sum(
            hist * (centers - mean[..., None]) ** 2, axis=-1) / VARIANCE_NORM,
        lambda: histogram_entropy(hist, N_BINS),
    ], channels)


def flex_block_stats(hist: jnp.ndarray, channels=None) -> jnp.ndarray:
    """Flexible-block stats over [0, 255], unnormalized mean/variance.

    Bin count is inferred from the trailing axis (64 in the reference,
    volumeRender_kernel.cu:1083-1115).
    """
    n_bins = hist.shape[-1]
    centers = _bin_centers(n_bins, FLEX_MAX_HISTOGRAM)
    mean = jnp.sum(hist * centers, axis=-1)
    return _select_stats([
        lambda: mean,
        lambda: jnp.sum(hist * (centers - mean[..., None]) ** 2, axis=-1),
        lambda: histogram_entropy(hist, n_bins),
    ], channels)


def decode_weight_rows(stat: str, n_bins: int, *, family: str = "raw"):
    """Decode-weight rows + combine mode for one histogram statistic.

    Returns ``(rows, mode)`` where ``rows`` is the ``(n_w, B)`` float32
    matrix :func:`decode_with_rows` contracts the bins axis against and
    ``mode`` selects the combine:

    - ``stat='mean'`` → ``mode='linear'``, 1 row: bin centers (scaled by
      the family's mean normalizer). dec = w·h.
    - ``stat='var'`` → ``mode='var'``, 4 rows ``[m, s·e, s·e², s·1]``:
      dec = C2 − 2·m·C1 + m²·C0 = s·Σ h (e − m)² — algebraically the
      reference's deviation-around-the-mean sum with NO Σh=1 assumption.
      The raw family deviates around bin *edges* while the mean uses
      *centers* (volumeRender_kernel.cu:742-755); fractal/flex use centers
      for both.
    - ``stat='entropy'`` → ``mode='entropy'``, 1 row whose [0, 0] is the
      1/log2(B) normalizer (Shannon entropy, :761-769).

    ``family``: 'raw' (MEAN_NORM / VARIANCE_NORM scaling, edge deviation),
    'fractal' (same normalizers, center deviation, :841-867), 'flex'
    ([0, 255] range, unnormalized, :1083-1115), or 'unit' (centers on
    [0, 1], no normalization — the framework's synthetic-volume default).
    """
    vmax, mnorm, vnorm = {
        "raw": (MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM),
        "fractal": (MAX_HISTOGRAM, MEAN_NORM, VARIANCE_NORM),
        "flex": (FLEX_MAX_HISTOGRAM, 1.0, 1.0),
        "unit": (1.0, 1.0, 1.0),
    }[family]
    bw = vmax / n_bins
    i = np.arange(n_bins, dtype=np.float64)
    centers = bw * i + bw / 2.0
    edges = (i / n_bins) * vmax
    if stat == "mean":
        return (centers / mnorm).astype(np.float32)[None, :], "linear"
    if stat == "var":
        e = edges if family == "raw" else centers
        s = 1.0 / vnorm
        rows = np.stack([
            centers, s * e, s * e * e, s * np.ones_like(e),
        ])
        return rows.astype(np.float32), "var"
    if stat == "entropy":
        rows = np.zeros((1, n_bins), dtype=np.float32)
        rows[0, 0] = 1.0 / np.log2(n_bins)
        return rows, "entropy"
    raise ValueError(f"unknown stat {stat!r}; use mean / var / entropy")


def decode_with_rows(hist_bm, rows, mode):
    """Bins-major ``(Z, B, Y, X)`` histogram volume → decoded ``(Z, Y, X)``
    float32 statistic, with the rows/mode of :func:`decode_weight_rows`.

    The contractions over the bins axis run at ``precision=HIGHEST``: on a
    GPU an f32 dot at default precision may run in TF32 (about three
    decimal digits), and the variance combine ``C2 − 2·m·C1 + m²·C0``
    subtracts nearly equal terms, so TF32 rounding would dominate it. The
    contractions read the histograms once and are bandwidth-bound, so the
    pin costs nothing. Storage may be bf16; the decode computes in f32."""
    hf = jnp.asarray(hist_bm).astype(jnp.float32)
    rows = jnp.asarray(rows, jnp.float32)

    def contract(w):
        return jnp.einsum("zbyx,b->zyx", hf, w,
                          precision=jax.lax.Precision.HIGHEST)

    if mode == "linear":
        return contract(rows[0])
    if mode == "var":
        m, c1, c2, c0 = (contract(rows[k]) for k in range(4))
        return c2 - 2.0 * m * c1 + m * m * c0
    safe = jnp.where(hf > 0.0, hf, 1.0)
    return rows[0, 0] * jnp.sum(-hf * jnp.log2(safe), axis=1)


def normalize_histogram(hist: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Clamp negatives to 0 and renormalize to sum 1 (guarding empty histograms).

    Mirrors the clamp-then-renormalize in d_computeBlock
    (volumeRender_kernel.cu:1047-1081). Returns ``(normalized, total)``.
    """
    hist = jnp.maximum(hist, 0.0)
    total = jnp.sum(hist, axis=-1, keepdims=True)
    normed = jnp.where(total > 0.0, hist / jnp.where(total > 0.0, total, 1.0), hist)
    return jnp.clip(normed, 0.0, 1.0), total[..., 0]
