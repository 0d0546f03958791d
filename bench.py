#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: Mrays/s forward+backward at the BASELINE.json config-5 semantics —
a 512^3 x 16-bin DISTRIBUTION volume (bf16 bins-major histograms, 4.3 GB),
1024^2 image, gradients w.r.t. the histograms and the transfer-function LUT,
through the decode (ops/histogram.py decode_with_rows) and the slice sweep's
analytic VJP. The scalar-volume fwd+bwd stays on record as
``scalar512_fwdbwd_mrays``.

``vs_baseline`` compares our *forward* 512^2 throughput (MTexels/s, the
reference's own benchmark metric, volumeRender.cpp:1066-1067) against the
reference's published 60 fps at 512^2 => 15.73 MTexels/s on a Quadro K5000.

Timings amortize iterations inside one jit (the reference's own 10-iteration
discipline, volumeRender.cpp:1049-1063); completion is forced by a scalar
readback. Every record names the device it ran on; a host without a GPU is
refused.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.io.synthetic import device_blob_volume, device_histogram_volume
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.ops.histogram import decode_weight_rows, decode_with_rows

REFERENCE_MTEXELS_PER_S = 60.0 * 512 * 512 / 1e6  # 15.73, presentation.pdf

#: Published peaks per ``device_kind`` (NVIDIA H100 data sheet, SXM5 part,
#: dense rates without sparsity, at the full 700 W power limit). Used only
#: for roofline shares, never for correctness. A kind missing here is an
#: error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM5)",
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The peaks table entry for ``device_kind``; unknown kinds raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add its "
            f"data-sheet rates to bench.PEAKS"
        ) from None


def roofline(flops: float, nbytes: float, seconds: float, peaks: dict,
             rate: str = "tf32_tflops") -> dict:
    """Roofline share of a measured time: the least time the card could
    take (the larger of ``flops`` at the ``rate`` peak and ``nbytes`` at the
    HBM peak) over ``seconds``, and which of the two bounds it."""
    t_flop = flops / (peaks[rate] * 1e12)
    t_mem = nbytes / (peaks["hbm_gbps"] * 1e9)
    return {
        "share": max(t_flop, t_mem) / seconds,
        "bound": "compute" if t_flop >= t_mem else "memory",
    }


def sweep_resample_flops(n_planes: int, ny: int, nx: int, H: int,
                         W: int) -> float:
    """Dense resample flops of one forward sweep (march/slice.py:
    (H, NY) @ (NY, NX) then (H, NX) @ (NX, W) per plane)."""
    return float(n_planes) * (2 * H * ny * nx + 2 * H * W * nx)


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: this benchmark measures the
    card and never falls back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX found {dev.platform} ({dev})"
        )
    return dev


def nvidia_smi() -> str:
    """Card name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    ).stdout.strip()


def time_amortized(fn, *args, iters: int = 1, repeats: int = 1):
    """(seconds per iteration, last result); ``fn`` runs ``iters``
    iterations in one jitted call and returns a scalar (the readback forces
    completion). The minimum over ``repeats`` timed calls after one
    warm-up call, which compiles."""
    float(fn(*args))
    best = float("inf")
    s = None
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        s = float(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best / iters, s


def emit(out: dict) -> None:
    """Print the CURRENT merged result as one JSON line, immediately: every
    section ends with a re-emission, so a run cut by a time limit still
    leaves its measurements so far on stdout (last line wins)."""
    print(json.dumps(out), flush=True)


def hist_fwdbwd_fn(rows, mode, W, iters, n_planes, tscl=1.0):
    """Jitted ``iters`` x fwd+bwd of the distribution render: decode ->
    slice sweep -> MSE, gradients to the histograms and the LUT. The
    density carries the loop index (a traced scalar) so no iteration is
    hoisted and the histogram input is never copied."""

    @jax.jit
    def run(h, lut, o):
        def loss(h, lut, i):
            vol = decode_with_rows(h, rows, mode)
            img = slice_render_image(
                vol, o, W, W, lut, density=0.05 * (1.0 + 1e-6 * i),
                transfer_scale=tscl, n_planes=n_planes,
            )
            return jnp.mean((img - 0.25) ** 2)

        def it(i, acc):
            l, (gh, gt) = jax.value_and_grad(loss, argnums=(0, 1))(h, lut, i)
            return acc + l + jnp.sum(gt) + gh[0, 0, 0, 0].astype(jnp.float32)

        return jax.lax.fori_loop(0, iters, it, 0.0)

    return run


def hist_fwd_fn(rows, mode, W, iters, n_planes, tscl=1.0):
    """Jitted ``iters`` x forward of the distribution render."""

    @jax.jit
    def run(h, lut, o):
        def it(i, acc):
            vol = decode_with_rows(h, rows, mode)
            img = slice_render_image(
                vol, o, W, W, lut, density=0.05 * (1.0 + 1e-6 * i),
                transfer_scale=tscl, n_planes=n_planes,
            )
            return acc + jnp.sum(img)

        return jax.lax.fori_loop(0, iters, it, 0.0)

    return run


def main() -> None:
    from vrdd_tpu.utils.profiling import enable_compilation_cache

    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=512, help="volume edge")
    p.add_argument("--image", type=int, default=1024, help="image edge")
    p.add_argument("--iters", type=int, default=10,
                   help="amortized inner iterations")
    p.add_argument(
        "--sections",
        default=os.environ.get(
            "VRDD_BENCH_SECTIONS", "headline,decode,dist,view,big,rot,scaling"
        ),
        help="comma list of sections to run, in order: headline (forward "
        "MTexels/s, distribution fwd+bwd — the metric — and the scalar "
        "fwd+bwd), decode (Gaussian + hist16 differentiable decode, and the "
        "chunk-streamed decode), dist (distributed sweep on a 1-device mesh "
        "vs unsharded), view (viewer fps at the reference's 512^2 Isabel "
        "config, median of 5 runs), big (1024^3 fwd + fwd+bwd, nonlinear "
        "and 32-bin distribution stats, distributed distribution fwd+bwd), "
        "rot (rotated distribution-native views), scaling (linear-scaling "
        "efficiency over all attached devices). A JSON line is "
        "(re-)emitted after every section; last line wins.",
    )
    args = p.parse_args()
    dev = require_gpu()
    peaks = device_peaks(dev.device_kind)
    enable_compilation_cache()
    sections = [s.strip() for s in args.sections.split(",") if s.strip()]

    n, W, K = args.size, args.image, args.iters
    t_start = time.perf_counter()

    def note(msg):
        print(f"[{time.perf_counter() - t_start:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    card = nvidia_smi()
    note(f"device: {dev} ({card}); sections: {','.join(sections)}")

    tf = jnp.asarray(default_transfer_function())
    origin = jnp.asarray([0.0, 0.0, 4.0], dtype=jnp.float32)

    out = {
        "metric": (
            f"Mrays/s fwd+bwd {n}^3x16-bin distribution vol {W}^2 img "
            "(decode + slice sweep)"
        ),
        "value": None,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "reference_mtexels_per_s": REFERENCE_MTEXELS_PER_S,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": card,
        "peaks_source": peaks["source"],
    }

    class sec:
        """Per-section wall-clock (compiles included) -> sec_<name>_s."""

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            out[f"sec_{self.name}_s"] = round(
                time.perf_counter() - self.t0, 1
            )
            emit(out)

    if "headline" in sections:
        with sec("headline"):
            out.update(bench_headline(n, W, K, tf, origin, peaks, note))

    if "decode" in sections:
        with sec("decode"):
            out.update(bench_decode(min(n, 256), min(W, 512), K, tf, origin,
                                    note))

    if "dist" in sections:
        with sec("dist"):
            out.update(bench_dist(n, W, K, tf, origin, note))

    if "view" in sections:
        with sec("view"):
            unrots, rots = viewer_fps_config(K, runs=5)
            fps_unrot = float(np.median(unrots))
            fps_rot = float(np.median(rots))
            note(f"viewer 512^2 Isabel config: median {fps_unrot:.1f} fps "
                 f"unrotated (band {min(unrots):.1f}-{max(unrots):.1f}), "
                 f"median {fps_rot:.1f} fps under rotation drag (band "
                 f"{min(rots):.1f}-{max(rots):.1f}); reference: 60 fps")
            out["viewer_fps_512"] = fps_unrot
            out["viewer_fps_rotated_512"] = fps_rot
            out["viewer_fps_512_band"] = [min(unrots), max(unrots)]
            out["viewer_fps_rotated_512_band"] = [min(rots), max(rots)]

    if "big" in sections:
        with sec("big"):
            out.update(bench_big(tf, note))

    if "rot" in sections:
        with sec("rot"):
            out.update(bench_rot(tf, note))

    if "scaling" in sections:
        with sec("scaling"):
            from vrdd_tpu.parallel.scaling import measure_scaling

            sc = measure_scaling(iters=K)
            note(f"scaling: {sc}")
            out.update(sc)
    emit(out)


def bench_headline(n, W, K, tf, origin, peaks, note):
    out = {}
    # --- forward, the reference's own benchmark geometry: 512^2 image over
    # an Isabel-shaped (50x50x10) decoded stats volume, 200 sampling planes
    # (~ the reference's effective step count under early termination) ---
    W0 = 512
    rng = np.random.default_rng(0)
    isabel = jnp.asarray(rng.random((10, 50, 50), dtype=np.float32))

    @jax.jit
    def fwd_isabel(v, tf, o):
        def it(i, acc):
            # the density carries the loop index: the reference's
            # runSingleTest re-renders the SAME volume
            # (volumeRender.cpp:1049-1063)
            img = slice_render_image(v, o, W0, W0, tf,
                                     density=0.05 * (1.0 + 1e-6 * i),
                                     n_planes=200)
            return acc + jnp.sum(img)

        return jax.lax.fori_loop(0, K, it, 0.0)

    dt_fwd, _ = time_amortized(fwd_isabel, isabel, tf, origin, iters=K)
    fwd_mtexels = W0 * W0 / dt_fwd / 1e6
    note(f"forward 512^2 Isabel-shaped (50x50x10): {dt_fwd * 1e3:.3f} ms "
         f"-> {fwd_mtexels:.2f} MTexels/s")
    out["vs_baseline"] = fwd_mtexels / REFERENCE_MTEXELS_PER_S
    out["forward_512_mtexels_per_s"] = fwd_mtexels

    # --- THE HEADLINE: fwd+bwd at the BASELINE.json config-5 shape ---
    hist = jax.block_until_ready(device_histogram_volume(n))
    rows, mode = decode_weight_rows("mean", 16, family="unit")
    rows = jnp.asarray(rows)
    dt, _ = time_amortized(hist_fwdbwd_fn(rows, mode, W, K, n), hist, tf,
                           origin, iters=K, repeats=2)
    mrays = W * W / dt / 1e6
    note(f"fwd+bwd DISTRIBUTION {n}^3x16 -> {W}^2: {dt * 1e3:.3f} ms -> "
         f"{mrays:.3f} Mrays/s")
    out["value"] = mrays
    out["hist512_fwdbwd_ms"] = dt * 1e3
    out["hist512_fwdbwd_iters"] = K

    dt_f, _ = time_amortized(hist_fwd_fn(rows, mode, W, K, n), hist, tf,
                             origin, iters=K)
    # forward bytes: the histograms once; flops: the dense resample (TF32)
    roof = roofline(
        sweep_resample_flops(n, n, n, W, W), hist.size * 2, dt_f, peaks
    )
    note(f"fwd DISTRIBUTION {n}^3x16 -> {W}^2: {dt_f * 1e3:.3f} ms; "
         f"roofline share {roof['share']:.3f} ({roof['bound']}-bound)")
    out["hist512_fwd_ms"] = dt_f * 1e3
    out["hist512_fwd_roofline_share"] = roof["share"]
    out["hist512_fwd_roofline_bound"] = roof["bound"]
    del hist

    # --- forward+backward on the SCALAR n^3 volume ---
    vol = jax.block_until_ready(device_blob_volume(n))

    @jax.jit
    def fwdbwd_scalar(v, tf, o):
        def loss(v, tf, i):
            img = slice_render_image(
                v, o, W, W, tf, density=0.05 * (1.0 + 1e-6 * i), n_planes=n,
            )
            return jnp.mean((img - 0.25) ** 2)

        def it(i, acc):
            l, (gv, gt) = jax.value_and_grad(loss, argnums=(0, 1))(v, tf, i)
            return acc + l + jnp.sum(gt) + gv[0, 0, 0]

        return jax.lax.fori_loop(0, K, it, 0.0)

    dt_fb, _ = time_amortized(fwdbwd_scalar, vol, tf, origin, iters=K,
                              repeats=2)
    note(f"fwd+bwd SCALAR {W}^2 over {n}^3: {dt_fb * 1e3:.3f} ms -> "
         f"{W * W / dt_fb / 1e6:.3f} Mrays/s")
    out["scalar512_fwdbwd_mrays"] = W * W / dt_fb / 1e6
    return out


def bench_decode(n, W, K, tf, origin, note):
    """BASELINE configs 3/4: distribution decode inside the timed fwd+bwd
    graph (the reference decodes during marching only for query 7,
    volumeRender_kernel.cu:722-872 precomputes the rest)."""
    from vrdd_tpu.march.streaming import streaming_decode_render
    from vrdd_tpu.ops.gaussian import gaussian_stats
    from vrdd_tpu.ops.histogram import flex_block_stats

    out = {}
    rng = np.random.default_rng(1)
    mu = device_blob_volume(n, seed=1)
    sigma = jnp.asarray(0.05 + 0.2 * rng.random((n, n, n), dtype=np.float32))

    @jax.jit
    def gauss_fb(mu, sigma, tf, o):
        def loss(mu, sigma, tf, i):
            vol = gaussian_stats(mu * (1.0 + 1e-6 * i), sigma)[..., 0]
            img = slice_render_image(vol, o, W, W, tf, n_planes=n)
            return jnp.mean((img - 0.25) ** 2)

        def it(i, acc):
            l, (gm, gs, gt) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
                mu, sigma, tf, i)
            return acc + l + jnp.sum(gt) + gm[0, 0, 0] + gs[0, 0, 0]

        return jax.lax.fori_loop(0, K, it, 0.0)

    dt, _ = time_amortized(gauss_fb, mu, sigma, tf, origin, iters=K)
    out["gaussian_decode_fwdbwd_mrays"] = W * W / dt / 1e6
    note(f"fwd+bwd Gaussian-decode {W}^2 over {n}^3: "
         f"{out['gaussian_decode_fwdbwd_mrays']:.3f} Mrays/s")

    logits = jax.random.normal(jax.random.PRNGKey(0), (n, n, n, 16),
                               dtype=jnp.float32)
    hist = jax.nn.softmax(2.0 * logits, axis=-1)

    def decode(h):
        # mean channel only: XLA does not DCE the var/entropy branches
        # through stack()[..., 0] (see ops/histogram.py _select_stats)
        return flex_block_stats(h, channels=(0,))[..., 0] / 255.0

    def hist_fb(streamed):
        @jax.jit
        def run(hist, tf, o):
            def loss(hist, tf, i):
                h = hist * (1.0 + 1e-6 * i)
                if streamed:
                    img = streaming_decode_render(
                        h, decode, o, tf, width=W, height=W, n_planes=n,
                        chunk_planes=64,
                    )
                else:
                    img = slice_render_image(decode(h), o, W, W, tf,
                                             n_planes=n)
                return jnp.mean((img - 0.25) ** 2)

            def it(i, acc):
                l, (gh, gt) = jax.value_and_grad(loss, argnums=(0, 1))(
                    hist, tf, i)
                return acc + l + jnp.sum(gt) + gh[0, 0, 0, 0]

            return jax.lax.fori_loop(0, K, it, 0.0)

        return run

    for key, streamed in (("hist16_decode_fwdbwd_mrays", False),
                          ("hist16_chunked_stream_fwdbwd_mrays", True)):
        dt, _ = time_amortized(hist_fb(streamed), hist, tf, origin, iters=K)
        out[key] = W * W / dt / 1e6
        note(f"{key} {W}^2 over {n}^3: {out[key]:.3f}")
    return out


def bench_dist(n, W, K, tf, origin, note):
    """Distributed sweep on a 1-device mesh vs the unsharded sweep: the
    per-card overhead of the distribution machinery (halo exchange,
    static-tap pre-blend, two-pass exact ET, sort-last compositing)."""
    from vrdd_tpu.parallel.mesh import make_mesh
    from vrdd_tpu.parallel.sweep import (
        distributed_sweep_render,
        shard_scalar_volume,
    )

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    vol = jax.block_until_ready(device_blob_volume(n))
    vs = shard_scalar_volume(vol, mesh)

    def fwd(dist):
        @jax.jit
        def run(v, tf, o):
            def it(i, acc):
                de = 0.05 * (1.0 + 1e-6 * i)
                if dist:
                    img = distributed_sweep_render(
                        v, o, tf, de, width=W, height=W, mesh=mesh,
                        n_planes=n,
                    )
                else:
                    img = slice_render_image(v, o, W, W, tf, density=de,
                                             n_planes=n)
                return acc + jnp.sum(img)

            return jax.lax.fori_loop(0, K, it, 0.0)

        return run

    @jax.jit
    def d_fwdbwd(v, tf, o):
        def loss(v, tf, i):
            img = distributed_sweep_render(
                v, o, tf, 0.05 * (1.0 + 1e-6 * i), width=W, height=W,
                mesh=mesh, n_planes=n,
            )
            return jnp.mean((img - 0.25) ** 2)

        def it(i, acc):
            l, (gv, gt) = jax.value_and_grad(loss, argnums=(0, 1))(v, tf, i)
            return acc + l + jnp.sum(gt) + gv[0, 0, 0]

        return jax.lax.fori_loop(0, K, it, 0.0)

    dt_un, _ = time_amortized(fwd(False), vol, tf, origin, iters=K)
    dt_d, _ = time_amortized(fwd(True), vs, tf, origin, iters=K)
    dt_db, _ = time_amortized(d_fwdbwd, vs, tf, origin, iters=K)
    out = {
        "unsharded_fwd_ms": dt_un * 1e3,
        "dist_fwd_ms": dt_d * 1e3,
        "dist_overhead_ratio": dt_d / dt_un,
        "dist_fwdbwd_ms": dt_db * 1e3,
        "dist_fwdbwd_mrays": W * W / dt_db / 1e6,
    }
    note(f"distributed (1-device mesh) fwd {dt_d * 1e3:.3f} ms vs unsharded "
         f"{dt_un * 1e3:.3f} ms; dist fwd+bwd {dt_db * 1e3:.3f} ms")
    return out


def bench_big(tf, note, n: int = 1024, W: int = 1024, K: int = 4):
    """Above the headline size: 1024^3 scalar forward and fwd+bwd, and the
    512^3 distribution volume's nonlinear statistics, 32-bin forward and
    distributed fwd+bwd."""
    out = {}
    origin = jnp.asarray([0.0, 0.0, 4.0], dtype=jnp.float32)
    vol = jax.block_until_ready(device_blob_volume(n))

    @jax.jit
    def fwd(v, lut, o):
        def it(i, acc):
            img = slice_render_image(v, o, W, W, lut,
                                     density=0.05 * (1.0 + 1e-6 * i),
                                     n_planes=n)
            return acc + jnp.sum(img)
        return jax.lax.fori_loop(0, K, it, 0.0)

    @jax.jit
    def fwdbwd(v, lut, o):
        def loss(v, lut, i):
            img = slice_render_image(v, o, W, W, lut,
                                     density=0.05 * (1.0 + 1e-6 * i),
                                     n_planes=n)
            return jnp.mean((img - 0.25) ** 2)

        def it(i, acc):
            l, (gv, gt) = jax.value_and_grad(loss, argnums=(0, 1))(v, lut, i)
            return acc + l + jnp.sum(gt) + gv[0, 0, 0]
        return jax.lax.fori_loop(0, K, it, 0.0)

    for key, fn in (("fwd_1024", fwd), ("fwdbwd_1024", fwdbwd)):
        dt, _ = time_amortized(fn, vol, tf, origin, iters=K)
        out[f"{key}_ms"] = dt * 1e3
        out[f"{key}_mrays"] = W * W / dt / 1e6
        note(f"{key} 1024^2 over 1024^3: {dt * 1e3:.3f} ms")
    del vol

    nh, B = 512, 16
    hist = jax.block_until_ready(device_histogram_volume(nh, B))
    for stat, tscl in (("var", 30.0), ("entropy", 1.0)):
        rows, mode = decode_weight_rows(stat, B, family="unit")
        rows = jnp.asarray(rows)
        dt, _ = time_amortized(hist_fwd_fn(rows, mode, W, K, nh, tscl), hist,
                               tf, origin, iters=K)
        out[f"hist512_{stat}_fwd_ms"] = dt * 1e3
        dt, _ = time_amortized(hist_fwdbwd_fn(rows, mode, W, K, nh, tscl),
                               hist, tf, origin, iters=K)
        out[f"hist512_{stat}_fwdbwd_mrays"] = W * W / dt / 1e6
        note(f"512^3x16 {stat}: fwd {out[f'hist512_{stat}_fwd_ms']:.3f} ms,"
             f" fwd+bwd {out[f'hist512_{stat}_fwdbwd_mrays']:.3f} Mrays/s")

    # distributed distribution-native fwd+bwd on a 1-device mesh
    from vrdd_tpu.parallel.mesh import make_mesh
    from vrdd_tpu.parallel.sweep import (
        distributed_hist_render, shard_hist_volume,
    )

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    hs = shard_hist_volume(hist, mesh)
    dw = jnp.asarray((np.arange(B) + 0.5) / B, jnp.float32)

    @jax.jit
    def dist_fwdbwd(h, lut, o):
        def loss(h, lut, i):
            img = distributed_hist_render(
                h, dw, o, lut, density=0.05 * (1.0 + 1e-6 * i),
                width=W, height=W, mesh=mesh,
            )
            return jnp.mean((img - 0.25) ** 2)

        def it(i, acc):
            l, (gh, gt) = jax.value_and_grad(loss, argnums=(0, 1))(h, lut, i)
            return acc + l + jnp.sum(gt) + gh[0, 0, 0, 0].astype(jnp.float32)
        return jax.lax.fori_loop(0, K, it, 0.0)

    dt, _ = time_amortized(dist_fwdbwd, hs, tf, origin, iters=K)
    out["hist512_dist_fwdbwd_ms"] = dt * 1e3
    note(f"512^3x16 distributed (1-device mesh) fwd+bwd: {dt * 1e3:.3f} ms")
    del hist, hs

    # the reference's OWN bin count (32, volumeRender.cpp N_BINS)
    hist32 = jax.block_until_ready(device_histogram_volume(nh, 32))
    rows, mode = decode_weight_rows("mean", 32, family="unit")
    dt, _ = time_amortized(
        hist_fwd_fn(jnp.asarray(rows), mode, W, K, nh), hist32, tf, origin,
        iters=K,
    )
    out["hist512_b32_fwd_ms"] = dt * 1e3
    note(f"512^3x32 fwd 1024^2: {dt * 1e3:.3f} ms")
    return out


def bench_rot(tf, note, n: int = 512, W: int = 1024, B: int = 16):
    """ROTATED distribution-native views on a 1-device mesh: the bins-major
    volume's spatial axes permute with the view's principal axis (cached per
    octant) and each frame decodes + sweeps + warps. The y-principal view's
    first frame pays the permute; the timed frames reuse it."""
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.parallel.mesh import make_mesh
    from vrdd_tpu.parallel.sweep import (
        clear_octant_cache, distributed_shearwarp_hist_render,
    )

    hist = jax.block_until_ready(device_histogram_volume(n, B))
    dw = jnp.asarray((np.arange(B) + 0.5) / B, jnp.float32)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    out = {}
    for tag, (rx, ry) in (("zrot", (20.0, 30.0)), ("yrot", (80.0, 10.0))):
        iv = np.asarray(
            inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0)),
            dtype=np.float32,
        )

        def frame(i, iv=iv):
            img = distributed_shearwarp_hist_render(
                hist, dw, iv, W, W, tf, density=0.05 * (1.0 + 1e-6 * i),
                mesh=mesh, oversample=1.0,
            )
            return float(jnp.sum(img))

        frame(0)  # compile + octant permute
        t0 = time.perf_counter()
        for i in range(1, 4):
            frame(i)
        out[f"hist512_{tag}_fwd_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        note(f"512^3x16 ROTATED ({tag}) fwd {W}^2: "
             f"{out[f'hist512_{tag}_fwd_ms']:.3f} ms")
    clear_octant_cache()
    return out


def viewer_fps_config(K, runs: int = 1):
    """Interactive-viewer frame rate through the viewer's EXACT frame path
    (ViewerServer.render_frame: pipeline auto-render + uint8 pack + bytes),
    at the reference's interactive config — 512^2 image over the
    Isabel-shaped decoded stats volume (presentation.pdf "Frame rate:
    60 fps" on a Quadro K5000). Two regimes: the fixed benchmark view
    (slice sweep) and a continuous rotation drag (shear-warp). Returns two
    lists of ``runs`` fps samples (one server, back-to-back passes)."""
    from vrdd_tpu.io.synthetic import random_histogram_volume
    from vrdd_tpu.models.pipeline import RenderPipeline
    from vrdd_tpu.models.volumes import RawHistogramVolume
    from vrdd_tpu.viewer import ViewerServer

    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    pipe = RenderPipeline(raw=RawHistogramVolume(jnp.asarray(hist)))
    srv = ViewerServer(pipe, width=512, height=512, port=0)
    unrots, rots = [], []
    try:
        n_frames = max(16, 8 * K)
        # the browser client's request: RGB payload + pipelined server;
        # 3 warm frames per regime compile and fill the 2-deep pipeline
        for r in range(runs):
            for i in range(3):
                srv.render_frame(
                    {"density": 0.04 + 1e-7 * i, "fmt": "rgb", "pipe": "1"})
            t0 = time.perf_counter()
            for i in range(n_frames):
                srv.render_frame(
                    {"density": 0.05 + 1e-7 * i, "fmt": "rgb", "pipe": "1"})
            unrots.append(n_frames / (time.perf_counter() - t0))
            for i in range(3):
                srv.render_frame(
                    {"rx": 9.0 + 0.05 * i, "ry": 5.0, "fmt": "rgb",
                     "pipe": "1"}
                )
            t0 = time.perf_counter()
            for i in range(n_frames):
                srv.render_frame(
                    {"rx": 10.0 + 0.05 * i, "ry": 5.0, "fmt": "rgb",
                     "pipe": "1"}
                )
            rots.append(n_frames / (time.perf_counter() - t0))
    finally:
        srv.httpd.server_close()
    return unrots, rots


if __name__ == "__main__":
    main()
