"""Flexible-block-size (integral distribution) volume family.

The third distribution representation (SURVEY.md §0.3): for a user-chosen
block size, per-block histograms are assembled from power-of-two span
histograms via the integral-histogram identity. Two construction paths:

- :meth:`FlexibleBlockVolume.from_raw` — the raw volume is available: build a
  3-D prefix-sum integral histogram and query every block in O(1)
  (replacing the reference's 5-kernel pipeline d_divideBlock ->
  d_allocateSpace -> d_queryBlockNew -> d_querySpanNew -> d_computeBlock,
  volumeRender_kernel.cu:1735-1796, including its 194 s span-search
  bottleneck).

- :meth:`FlexibleBlockVolume.from_codebooks` — only the reference-format
  compressed span banks exist (fractal-coded spans >= 8 voxels + sparse
  "simple" spans < 8): decode both banks *once* (vectorized), build a dense
  high-corner lookup table, run the corner/Fenwick decomposition for ALL
  blocks in a few numpy kernels (ops/integral.py block_prefix_entries), and
  accumulate voxel-count-weighted span histograms with inclusion-exclusion
  signs — exactly the reference's algorithm with the search and the per-span
  redundant decode removed, and deterministic segment-sums instead of
  shared-memory atomics (volumeRender_kernel.cu:1320-1325, 1447). At the
  reference's own scale (Fuel 64^3, the full 262,144-span Fenwick universe,
  volumeRender_kernel.cu:99-100) this pipeline runs in seconds end-to-end
  where d_querySpanNew alone took 194,764 ms (ver1.9.6.txt:9).

Both paths end in clamp -> normalize -> (mean, variance, entropy) over the
[0, 255] 64-bin domain (d_computeBlock semantics,
volumeRender_kernel.cu:1041-1115).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vrdd_tpu.ops.fractal import fractal_decode_batch
from vrdd_tpu.ops.histogram import flex_block_stats, normalize_histogram
from vrdd_tpu.ops.integral import (
    block_prefix_entries,
    build_span_lookup,
    divide_blocks,
    integral_histogram,
    query_block_histogram,
)
from vrdd_tpu.ops.sparse import densify_sparse_histograms
from vrdd_tpu.utils.config import FLEX_N_BINS
from vrdd_tpu.utils.timing import StageTimer


# one jitted call per from_raw device stage (see from_raw docstring)
_integral_jit = jax.jit(
    integral_histogram, static_argnames=("n_bins", "vmin", "vmax")
)
_query_jit = jax.jit(query_block_histogram)


@jax.jit
def _stats_jit(counts):
    hist, _ = normalize_histogram(counts)
    return flex_block_stats(hist)


@dataclasses.dataclass
class FlexibleBlockVolume:
    """Per-block (mean, variance, entropy) grid for a flexible block size."""

    stats_grid: jnp.ndarray  # (nZb, nYb, nXb, 3)
    block_size: int
    volume_dim: Tuple[int, int, int]  # (x, y, z) extents
    timings: Optional[Dict[str, float]] = None

    @property
    def n_blocks(self) -> Tuple[int, int, int]:
        return self.stats_grid.shape[:3]

    def stat_ranges(self) -> np.ndarray:
        """(3, 2) per-channel (min, max) over blocks — what bindToTex computes
        and prints for TF calibration (volumeRender_kernel.cu:1592-1622)."""
        g = np.asarray(self.stats_grid).reshape(-1, 3)
        return np.stack([g.min(axis=0), g.max(axis=0)], axis=-1)

    def normalized(self) -> "FlexibleBlockVolume":
        """Copy with the mean/variance channels min-max mapped to [0, 1].

        The reference stores flexible-block mean/variance in RAW bin-domain
        units (mean in [0, 255], variance up to ~2e3 for the 64-bin domain),
        leaving their normalization as an open TODO ("think about how to
        normalize mean", volumeRender_kernel.cu:1092, commented-out min/max
        mapping at :1102-1104) — so queries 9/0 render black until the user
        manually winds transferScale down. This applies exactly the mapping
        the reference left commented out, using the min/max bindToTex already
        computes. The entropy channel is left UNTOUCHED: it is already
        normalized to [0, 1] at decode (volumeRender_kernel.cu:1106-1115),
        and remapping it would change query 8 away from the reference.
        Constant channels (max == min) map to 0.
        """
        g = self.stats_grid
        lo = jnp.min(g.reshape(-1, 3), axis=0)
        hi = jnp.max(g.reshape(-1, 3), axis=0)
        span = jnp.where(hi > lo, hi - lo, 1.0)
        entropy = jnp.asarray([0.0, 0.0, 1.0], dtype=g.dtype)
        mapped = (g - lo) / span
        return dataclasses.replace(
            self, stats_grid=mapped * (1.0 - entropy) + g * entropy
        )

    # ---------------------------------------------------------------- raw path
    @classmethod
    def from_raw(
        cls,
        raw: np.ndarray,
        block_size: int,
        n_bins: int = FLEX_N_BINS,
        vmin: float = 0.0,
        vmax: float = 255.0,
    ) -> "FlexibleBlockVolume":
        """O(1)-per-block construction from a raw scalar volume ``(Z, Y, X)``.

        Each device stage is one jitted call (an eager op chain dispatches
        and compiles every op separately); the per-stage timings
        mirror the reference's dataProcessing banners
        (volumeRender_kernel.cu:1739-1783).
        """
        timer = StageTimer()
        nz, ny, nx = raw.shape
        with timer.stage("divide_blocks"):
            spans = divide_blocks((nx, ny, nz), block_size)  # (nb, 6) 1-indexed
        with timer.stage("integral_histogram"):
            sat = jax.block_until_ready(
                _integral_jit(jnp.asarray(raw), n_bins, vmin, vmax)
            )
        with timer.stage("query_blocks"):
            low = np.stack([spans[:, 2], spans[:, 1], spans[:, 0]], -1) - 1  # zyx
            high = np.stack([spans[:, 5], spans[:, 4], spans[:, 3]], -1) - 1
            counts = jax.block_until_ready(
                _query_jit(sat, jnp.asarray(low), jnp.asarray(high))
            )
        with timer.stage("compute_block_stats"):
            stats = jax.block_until_ready(_stats_jit(counts))
        nbx = -(-nx // block_size)
        nby = -(-ny // block_size)
        nbz = -(-nz // block_size)
        grid = stats.reshape(nbz, nby, nbx, 3)
        return cls(grid, block_size, (nx, ny, nz), timer.as_dict())

    # ----------------------------------------------------------- codebook path
    @classmethod
    def from_codebooks(
        cls,
        *,
        volume_dim: Tuple[int, int, int],
        block_size: int,
        fractal_spans: np.ndarray,  # (F, 6) 1-indexed inclusive
        fractal_codebook: np.ndarray,  # (F, 4) templateId, shift, flip, nErrors
        fractal_error_bins: np.ndarray,  # (F, E)
        fractal_error_values: np.ndarray,  # (F, E)
        templates: np.ndarray,  # (T, n_bins)
        simple_spans: np.ndarray,  # (S, 6) 0-indexed inclusive (reference quirk)
        simple_bin_ids: np.ndarray,  # (S, E2)
        simple_freqs: np.ndarray,  # (S, E2)
        simple_counts: np.ndarray,  # (S,)
        n_bins: int = FLEX_N_BINS,
    ) -> "FlexibleBlockVolume":
        """Reference-format construction (span codebooks, no raw volume)."""
        timer = StageTimer()
        with timer.stage("decode_banks"):
            cb = np.asarray(fractal_codebook)
            fractal_hists = np.asarray(
                fractal_decode_batch(
                    jnp.asarray(templates)[cb[:, 0]],
                    jnp.asarray(cb[:, 1]),
                    jnp.asarray(cb[:, 2]),
                    jnp.asarray(fractal_error_bins),
                    jnp.asarray(fractal_error_values),
                    jnp.asarray(cb[:, 3]),
                )
            )
            simple_hists = np.asarray(
                densify_sparse_histograms(
                    jnp.asarray(simple_bin_ids),
                    jnp.asarray(simple_freqs),
                    jnp.asarray(simple_counts),
                    n_bins,
                )
            )
            bank = np.concatenate([fractal_hists, simple_hists], axis=0)

        with timer.stage("build_span_index"):
            # simple spans are stored 0-indexed (volumeRender_kernel.cu:
            # 1464-1471); rows are ordered (fractal, simple) to match `bank`,
            # and build_span_lookup's later-row-wins makes simple spans
            # override duplicate fractal highs (former dict semantics)
            all_spans = np.concatenate(
                [np.asarray(fractal_spans), np.asarray(simple_spans) + 1],
                axis=0,
            )
            lookup = build_span_lookup(all_spans, volume_dim)

        nx, ny, nz = volume_dim
        with timer.stage("divide_blocks"):
            spans = divide_blocks(volume_dim, block_size)

        with timer.stage("corner_decomposition"):
            eb, high, ec = block_prefix_entries(spans, volume_dim)
            es = lookup[high[:, 0], high[:, 1], high[:, 2]]
            if np.any(es < 0):
                bad = high[int(np.argmax(es < 0))]
                hi = tuple(int(v) for v in bad)
                lo = tuple(int(v - (v & -v) + 1) for v in bad)
                raise KeyError(f"span {lo + hi} missing from codebooks")

        with timer.stage("accumulate"):
            # deterministic segment-sum, chunked so the gathered
            # (chunk, n_bins) contributions stay bounded in device memory
            bank_j = jnp.asarray(bank)
            counts = jnp.zeros((len(spans), n_bins), dtype=jnp.float32)
            chunk = 1 << 19
            for s0 in range(0, len(eb), chunk):
                sl = slice(s0, s0 + chunk)
                contribs = (
                    bank_j[jnp.asarray(es[sl], dtype=jnp.int32)]
                    * jnp.asarray(ec[sl].astype(np.float32))[:, None]
                )
                counts = counts.at[
                    jnp.asarray(eb[sl], dtype=jnp.int32)
                ].add(contribs)

        with timer.stage("compute_block_stats"):
            hist, _ = normalize_histogram(counts)
            stats = flex_block_stats(hist)

        nbx = -(-nx // block_size)
        nby = -(-ny // block_size)
        nbz = -(-nz // block_size)
        grid = stats.reshape(nbz, nby, nbx, 3)
        return cls(grid, block_size, volume_dim, timer.as_dict())
