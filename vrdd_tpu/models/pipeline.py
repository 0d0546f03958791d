"""Full render pipeline: all three distribution representations + 10 query methods.

The analogue of the reference's startup sequence (initCuda ->
dataProcessing -> basicDataProcessing, volumeRender.cpp:1200-1221): given any
subset of {raw histograms, fractal codebooks, flexible-block data}, precompute
the corresponding stats volumes once, then render with any query method
0-9 (volumeRender.cpp:129 legend):

    1/2/3  raw mean / variance / entropy          (originalQueryTex)
    4/5/6  fractal mean / variance / entropy      (fractalQueryTex)
    7      on-the-fly interpolated mean           (in-march decode)
    8/9/0  flexible entropy / mean / variance     (flexBlockTex)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vrdd_tpu.core.geometry import default_benchmark_inv_view
from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.march.scan import render_image
from vrdd_tpu.march.shearwarp import (
    shearwarp_applicable,
    shearwarp_render_image,
)
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.models.flexible import FlexibleBlockVolume
from vrdd_tpu.models.renderer import (
    flex_sample_fn,
    interp_mean_sample_fn,
    interp_mean_volume,
    stats_sample_fn,
)
from vrdd_tpu.models.volumes import (
    FractalHistogramVolume,
    RawHistogramVolume,
    compute_stats_volume,
)
from vrdd_tpu.utils.config import QueryMethod, RenderConfig, query_channel
from vrdd_tpu.utils.timing import StageTimer


class RenderPipeline:
    """Holds precomputed query volumes and renders by query method."""

    def __init__(
        self,
        raw: Optional[RawHistogramVolume] = None,
        fractal: Optional[FractalHistogramVolume] = None,
        flexible: Optional[FlexibleBlockVolume] = None,
        tf_lut: Optional[np.ndarray] = None,
    ):
        timer = StageTimer()
        self.raw = raw
        self.fractal = fractal
        self.flexible = flexible
        self.raw_stats = (
            timer.time(
                "basic_data_processing/raw",
                lambda: jax.block_until_ready(compute_stats_volume(raw)),
            )
            if raw is not None
            else None
        )
        self.fractal_stats = (
            timer.time(
                "basic_data_processing/fractal",
                lambda: jax.block_until_ready(compute_stats_volume(fractal)),
            )
            if fractal is not None
            else None
        )
        self.timings: Dict[str, float] = timer.as_dict()
        if flexible is not None and flexible.timings:
            self.timings.update(
                {f"data_processing/{k}": v for k, v in flexible.timings.items()}
            )
        self.tf_lut = jnp.asarray(
            default_transfer_function() if tf_lut is None else tf_lut,
            dtype=jnp.float32,
        )
        self._interp_mean_vol = None  # query-7 field, built on first use
        self._flex_padded = None  # padded flex stats for object-order paths
        self._channel_cache: Dict[QueryMethod, jnp.ndarray] = {}

    def sample_source(self, method: QueryMethod, linear: bool = True):
        """(source array, array -> SampleFn builder) for a query method.

        ``linear=False`` selects point filtering for the stats-volume fetch
        (the reference's 'f' key, volumeRender.cpp:311-314); query 7 and the
        flexible-block fetch stay linear like the reference's textures.

        The source array is threaded through jit as an ARGUMENT, never a
        closure: a closed-over device array becomes an XLA constant, and
        constant folding of the render graph then dominates compile time.
        """
        method = QueryMethod(method)
        if method in (
            QueryMethod.RAW_MEAN,
            QueryMethod.RAW_VARIANCE,
            QueryMethod.RAW_ENTROPY,
        ):
            if self.raw_stats is None:
                raise ValueError("no raw histogram volume loaded")
            ch = query_channel(method)
            return self.raw_stats, lambda a: stats_sample_fn(a, ch, linear)
        if method in (
            QueryMethod.FRACTAL_MEAN,
            QueryMethod.FRACTAL_VARIANCE,
            QueryMethod.FRACTAL_ENTROPY,
        ):
            if self.fractal_stats is None:
                raise ValueError("no fractal codebook volume loaded")
            ch = query_channel(method)
            return self.fractal_stats, lambda a: stats_sample_fn(a, ch, linear)
        if method == QueryMethod.INTERP_MEAN:
            if self.raw is None:
                raise ValueError("query 7 needs the raw histogram volume")
            return self.raw.histograms, interp_mean_sample_fn
        # flexible-block queries
        if self.flexible is None:
            raise ValueError("no flexible-block volume loaded")
        ch = query_channel(method)
        return self.flexible.stats_grid, lambda a: flex_sample_fn(a, ch)

    def sample_fn(self, method: QueryMethod):
        src, build = self.sample_source(method)
        return build(src)

    def _stats_channel(self, method: QueryMethod):
        """(Z, Y, X) scalar field + source for the object-order fast paths.

        Memoized per method, so every frame of the viewer renders the same
        device array instead of slicing a fresh channel per call."""
        method = QueryMethod(method)
        cached = self._channel_cache.get(method)
        if cached is not None:
            return cached
        out = self._stats_channel_uncached(method)
        self._channel_cache[method] = out
        return out

    def _stats_channel_uncached(self, method: QueryMethod):
        if method in (
            QueryMethod.RAW_MEAN,
            QueryMethod.RAW_VARIANCE,
            QueryMethod.RAW_ENTROPY,
        ):
            if self.raw_stats is None:
                raise ValueError("no raw histogram volume loaded")
            return self.raw_stats[..., query_channel(method)]
        if method in (
            QueryMethod.FRACTAL_MEAN,
            QueryMethod.FRACTAL_VARIANCE,
            QueryMethod.FRACTAL_ENTROPY,
        ):
            if self.fractal_stats is None:
                raise ValueError("no fractal codebook volume loaded")
            return self.fractal_stats[..., query_channel(method)]
        if method == QueryMethod.INTERP_MEAN:
            if self.raw is None:
                raise ValueError("query 7 needs the raw histogram volume")
            if self._interp_mean_vol is None:
                self._interp_mean_vol = interp_mean_volume(
                    self.raw.histograms
                )
            return self._interp_mean_vol
        # flexible-block queries 8/9/0 on the object-order paths: the CUDA
        # unnormalized fetch (p01 * n_blocks - 0.5 against the zero-padded
        # scatter array, volumeRender_kernel.cu:654-680, 1637-1691) is the
        # same two-tap filter on an (n_blocks + 1) zero-padded grid with the
        # filter grid scaled off the coverage box — see _flex_axis_scale.
        if self.flexible is None:
            raise ValueError("no flexible-block volume loaded")
        if self._flex_padded is None:
            self._flex_padded = jnp.pad(
                jnp.asarray(self.flexible.stats_grid),
                ((0, 1), (0, 1), (0, 1), (0, 0)),
            )
        return self._flex_padded[..., query_channel(method)]

    def _flex_axis_scale(self, method) -> tuple:
        """(sx, sy, sz) filter-grid scales for the object-order sweeps:
        n_blocks / (n_blocks + 1) per axis for flex queries (the padded-grid
        form of the unnormalized fetch), identity otherwise."""
        if QueryMethod(method) not in (
            QueryMethod.FLEX_ENTROPY,
            QueryMethod.FLEX_MEAN,
            QueryMethod.FLEX_VARIANCE,
        ):
            return (1.0, 1.0, 1.0)
        nzb, nyb, nxb = self.flexible.stats_grid.shape[:3]
        return (nxb / (nxb + 1), nyb / (nyb + 1), nzb / (nzb + 1))

    @staticmethod
    def _tex_offset(method) -> float:
        """Filtering convention per query: 7 interpolates on the block-
        boundary grid (volumeRender_kernel.cu:395-478, no -0.5 texel offset);
        everything else uses the CUDA texture model."""
        return 0.0 if QueryMethod(method) == QueryMethod.INTERP_MEAN else 0.5

    def resolve_renderer(
        self, renderer: str, inv_view: np.ndarray, config: RenderConfig
    ) -> str:
        """'auto' -> the fastest applicable path for this view/method.

        Precomputed-stats queries (1-7) and flexible-block queries go
        object-order: the slice sweep for unrotated views, the shear-warp
        sweep for rotated views. Everything else (and degenerate views)
        renders on the general `lax.scan` ray marcher.
        """
        if renderer != "auto":
            return renderer
        unrotated = np.allclose(
            np.asarray(inv_view)[:, :3], np.eye(3), atol=1e-6
        )
        method = QueryMethod(config.query_method)
        stats_ok = method in (
            QueryMethod.RAW_MEAN, QueryMethod.RAW_VARIANCE,
            QueryMethod.RAW_ENTROPY, QueryMethod.FRACTAL_MEAN,
            QueryMethod.FRACTAL_VARIANCE, QueryMethod.FRACTAL_ENTROPY,
            QueryMethod.INTERP_MEAN,
        )
        flex_ok = (
            method in (QueryMethod.FLEX_ENTROPY, QueryMethod.FLEX_MEAN,
                       QueryMethod.FLEX_VARIANCE)
            and self.flexible is not None
        )
        if not (stats_ok or flex_ok):
            return "scan"
        if not config.filter_linear and not unrotated:
            # the reference's 'f' key at a rotated view: the shear-warp
            # path's final bilinear image warp would re-soften the crisp
            # point-sampled texels, so the scan marcher serves it; unrotated
            # point sampling rides the sweeps (one-hot weight rows)
            return "scan"
        if not unrotated:
            # rotated views object-order via the shear-warp factorization;
            # flex queries ride it too (the axis permutation carries the
            # filter-grid scales, march/shearwarp.py axis_scale)
            return "shearwarp" if shearwarp_applicable(inv_view) else "scan"
        return "slice"

    def render(
        self,
        inv_view: Optional[np.ndarray] = None,
        config: RenderConfig = RenderConfig(),
        renderer: str = "scan",
        as_uint8: bool = False,
        channels: int = 4,
    ) -> jnp.ndarray:
        """Jitted render; returns (H, W, 4) float RGBA.

        ``renderer``: 'scan' (general ray marcher, bit-faithful to d_render),
        'slice' (object-order matmul sweep), 'shearwarp' (the sweep for
        rotated views), or 'auto' (fastest applicable). The object-order
        paths take the precomputed-stats and flexible-block queries; their
        plane-sweep discretization matches the scan marcher to ~1e-2 (see
        vrdd_tpu/march/slice.py docstring).

        ``as_uint8=True`` fuses the RGBA8 pack into the SAME jitted call —
        the interactive viewer's frame path stays one device dispatch.
        ``channels=3`` additionally drops alpha INSIDE the jit (uint8 only):
        a (H, W, 3) readback is 25% fewer bytes.
        """
        if inv_view is None:
            inv_view = default_benchmark_inv_view()
        if channels not in (3, 4):
            raise ValueError(f"channels must be 3 or 4, got {channels}")
        if channels == 3 and not as_uint8:
            raise ValueError("channels=3 requires as_uint8=True (the RGB "
                             "drop is fused into the uint8 pack)")
        pack_u8 = (channels if channels != 4 else True) if as_uint8 else False
        renderer = self.resolve_renderer(renderer, inv_view, config)
        params = (
            self.tf_lut,
            jnp.float32(config.density),
            jnp.float32(config.brightness),
            jnp.float32(config.tf.offset),
            jnp.float32(config.tf.scale),
        )
        if renderer == "shearwarp":
            iv = np.ascontiguousarray(np.asarray(inv_view, dtype=np.float32))
            vol = self._stats_channel(config.query_method)
            # slope grids embed as literals, so the view is a compile key
            # (cached per view matrix)
            fn = self._compiled(
                config.query_method, config.camera.width,
                config.camera.height, config.march, renderer,
                iv_bytes=iv.tobytes(), pack_u8=pack_u8,
            )
            return fn(vol, *params)
        fn = self._compiled(
            config.query_method,
            config.camera.width,
            config.camera.height,
            config.march,
            renderer,
            linear=config.filter_linear,
            pack_u8=pack_u8,
        )
        if renderer == "slice":
            src = self._stats_channel(config.query_method)
        else:
            src, _ = self.sample_source(config.query_method)
        return fn(src, jnp.asarray(inv_view, dtype=jnp.float32), *params)

    @functools.lru_cache(maxsize=32)
    def _compiled(self, method, width, height, march, renderer="scan",
                  iv_bytes=None, linear=True, pack_u8=False):
        from vrdd_tpu.core.image import rgba_to_uint8

        # pack_u8: False = float RGBA, True/4 = uint8 RGBA, 3 = uint8 RGB
        # (alpha dropped inside the jit: 25% smaller device->host readback)
        if pack_u8 == 3:
            pack = lambda x: rgba_to_uint8(x)[..., :3]
        elif pack_u8:
            pack = rgba_to_uint8
        else:
            pack = lambda x: x
        # the sample source is a jit ARGUMENT (see sample_source docstring)
        if renderer == "shearwarp":
            inv_view = np.frombuffer(iv_bytes, dtype=np.float32).reshape(3, 4)
            toff = self._tex_offset(method)
            ascale = self._flex_axis_scale(method)

            @jax.jit
            def run_sw(volume, tf_lut, density, brightness, offset, scale):
                # distribution stats volumes are coarse (tens of blocks per
                # axis); floor the plane count so the sweep's axial sampling
                # stays comparable to the scan marcher's tstep
                return pack(shearwarp_render_image(
                    volume, inv_view, width, height, tf_lut, density,
                    brightness, offset, scale, march=march,
                    n_planes=max(64, 2 * volume.shape[0]),
                    tex_offset=toff, axis_scale=ascale,
                ))

            return run_sw
        if renderer == "slice":
            toff = self._tex_offset(method)
            ascale = self._flex_axis_scale(method)
            # point filtering ('f' key) applies to the stats-volume fetch of
            # queries 1-6 only — query 7 interpolates manually and the
            # flexible-block texture is always linear in the reference
            # (mirrors sample_source's linear handling)
            flin = linear or QueryMethod(method) in (
                QueryMethod.INTERP_MEAN, QueryMethod.FLEX_ENTROPY,
                QueryMethod.FLEX_MEAN, QueryMethod.FLEX_VARIANCE,
            )

            @jax.jit
            def run_obj(volume, inv_view, tf_lut, density, brightness,
                        offset, scale):
                origin = inv_view[:, 3]
                n_planes = max(64, 2 * volume.shape[0])
                return pack(slice_render_image(
                    volume, origin, width, height, tf_lut, density,
                    brightness, offset, scale, march=march, n_planes=n_planes,
                    tex_offset=toff, axis_scale=ascale, filter_linear=flin,
                ))

            return run_obj
        if renderer != "scan":
            raise ValueError(f"unknown renderer {renderer!r}")
        _, build = self.sample_source(method, linear)

        @jax.jit
        def run(src, inv_view, tf_lut, density, brightness, offset, scale):
            return pack(render_image(
                build(src), inv_view, width, height, tf_lut,
                density, brightness, offset, scale, march,
            ))

        return run
