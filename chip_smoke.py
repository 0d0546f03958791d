#!/usr/bin/env python
"""On-card smoke run of the renderer's main paths, in one process.

    python chip_smoke.py              # phases a-d on one GPU
    python chip_smoke.py --four-gpus  # phase a, then phase e on four GPUs

a. Device: JAX must find a GPU (else exit non-zero, no result); prints the
   device and ``nvidia-smi`` name and power limit.
b. The reference's interactive deployment: RenderPipeline over 50x50x10
   blocks x 32-bin raw histograms (the Isabel layout, BASELINE.md) plus the
   fractal and flexible-block families, 512^2, ``renderer="auto"`` for every
   query against ``renderer="scan"``, scan against the numpy specification
   (march/reference_numpy.py) on a full-width band of rows, and a few
   ViewerServer.render_frame calls (fixed view, then rotated).
c. Distribution render at the north-star size: a 512^3 x 16-bin bf16
   bins-major histogram volume (generated on the device from a seed) ->
   decode_with_rows -> slice sweep -> 1024^2 for mean, var and entropy; the
   sweep at default matmul precision against HIGHEST and against scan; the
   decode against a float64 numpy evaluation on a full 512^2 plane slab;
   ``vrdd render-hist`` on a small file with dims that are not multiples of
   128.
d. Training at the north-star size: fwd+bwd with gradients to the 512^3 x 16
   bf16 histograms and the LUT (decode + the sweep's analytic VJP), its
   device-idle share from a profiler trace, the analytic VJP against plain
   autodiff on a small input, then ``vrdd fit-hist --size 256 --bins 32``
   for a few steps (loss finite and falling).
e. (``--four-gpus`` only) a (4, 1) ('bricks', 'rays') mesh: distributed
   sweep render and one sweep-fit training step at 512^3 f32 -> 1024^2,
   and the distributed distribution render at 512^3 x 16 bf16, each against
   the single-device path.

Every comparison uses the reference's golden tolerance (epsilon 5/255 per
pixel, at most 30% outlier pixels, volumeRender.cpp:57-58) unless it states
a tighter one. Each phase prints one ``phase <x> {json}`` line; a phase that
fails raises, so the script exits non-zero. The last line of stdout is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from vrdd_tpu import cli
from vrdd_tpu.core.geometry import default_benchmark_inv_view
from vrdd_tpu.core.image import rgba_to_uint8
from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.io import formats
from vrdd_tpu.io.synthetic import (
    device_blob_volume,
    device_histogram_volume,
    gaussian_blob_volume,
    random_histogram_volume,
    synthetic_flexible_dataset,
    synthetic_fractal_volume,
)
from vrdd_tpu.march.reference_numpy import (
    np_sample_trilinear,
    reference_render,
)
from vrdd_tpu.march.scan import render_image
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.models.flexible import FlexibleBlockVolume
from vrdd_tpu.models.pipeline import RenderPipeline
from vrdd_tpu.models.renderer import scalar_sample_fn
from vrdd_tpu.models.volumes import FractalHistogramVolume, RawHistogramVolume
from vrdd_tpu.ops.histogram import decode_weight_rows, decode_with_rows
from vrdd_tpu.utils.config import (
    CameraConfig,
    QueryMethod,
    RenderConfig,
    TransferFunctionConfig,
)
from vrdd_tpu.utils.profiling import (
    annotate,
    device_busy_share,
    device_trace,
    enable_compilation_cache,
)

REPO = os.path.dirname(os.path.abspath(__file__))
TF = default_transfer_function()
# TF windows that put each unit-family statistic of the device histogram
# volume mid-ramp (variance of a peaked histogram is small, entropy sits
# near the top of [0, 1])
STAT_TSCALE = {"mean": 1.0, "var": 30.0, "entropy": 1.0}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(phase: str, result: dict) -> None:
    print(f"phase {phase} {json.dumps(result)}", flush=True)


def golden(img, ref, what: str) -> dict:
    """The reference's golden compare of two float RGBA images (uint8 RGB,
    epsilon 5/255, outlier fraction <= 0.30); raises if it fails."""
    a = np.asarray(rgba_to_uint8(jnp.asarray(img)))[..., :3]
    b = np.asarray(rgba_to_uint8(jnp.asarray(ref)))[..., :3]
    ok, frac = formats.compare_ppm(a, b)
    out = {
        "outlier_frac": frac,
        "max_abs": float(np.abs(np.asarray(img, np.float32)
                                - np.asarray(ref, np.float32)).max()),
        "mean_rgb": float(b.mean()),
    }
    if not ok:
        raise AssertionError(f"{what}: golden compare failed {out}")
    return out


def memory(compiled=None) -> dict:
    """``compiled.memory_analysis()`` sizes and the device's peak bytes."""
    out = {}
    if compiled is not None:
        m = compiled.memory_analysis()
        for k in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "alias_size_in_bytes"):
            out[k] = getattr(m, k, None)
    stats = jax.devices()[0].memory_stats()
    out["peak_bytes_in_use"] = (stats or {}).get("peak_bytes_in_use")
    return out


def timed(fn, *args, repeats: int = 3):
    """(first-call seconds incl. compile, steady seconds per call, result);
    every call ends in block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = jax.block_until_ready(fn(*args))
    return first, (time.perf_counter() - t0) / repeats, out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------- phase a


def phase_device() -> jax.Device:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found {devs[0].platform} "
            f"({devs})"
        )
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    emit("a", {"platform": devs[0].platform, "kind": devs[0].device_kind,
               "count": len(devs), "nvidia_smi": smi})
    return devs[0]


# ---------------------------------------------------------------- phase b


def interactive_pipeline(blocks=(10, 50, 50), bins=32, flex_dims=(16, 16, 16),
                         flex_block=4, seed=0) -> RenderPipeline:
    """The reference's interactive deployment as ``vrdd view
    --flex-normalize`` builds it (cli._build_pipeline): raw and
    fractal-coded histograms on the Isabel block layout, plus flexible
    blocks over a ``flex_dims`` scalar field, min-max normalized onto the
    TF domain."""
    hist = random_histogram_volume(blocks, n_bins=bins, seed=seed)
    t, cb, eb, ev, _ = synthetic_fractal_volume(blocks, n_bins=bins,
                                                seed=seed + 1)
    ds = synthetic_flexible_dataset(dims=flex_dims, seed=seed + 2)
    flexible = FlexibleBlockVolume.from_raw(
        ds["raw"], block_size=flex_block, vmax=256.0
    ).normalized()
    return RenderPipeline(
        raw=RawHistogramVolume(jnp.asarray(hist)),
        fractal=FractalHistogramVolume(
            jnp.asarray(cb), jnp.asarray(eb), jnp.asarray(ev), jnp.asarray(t)
        ),
        flexible=flexible,
    )


def phase_interactive(blocks=(10, 50, 50), bins=32, width=512,
                      flex_dims=(16, 16, 16), flex_block=4, band=32) -> dict:
    from vrdd_tpu.viewer import ViewerServer

    t0 = time.perf_counter()
    pipe = interactive_pipeline(blocks, bins, flex_dims, flex_block)
    res = {"blocks_zyx": list(blocks), "bins": bins, "image": width,
           "setup_s": time.perf_counter() - t0, "queries": {}}
    for q in (1, 2, 3, 4, 5, 6, 7, 8, 9, 0):
        # the variance queries (2, 5) decode to ~1-3 after the reference's
        # /VARIANCE_NORM; window the TF as the ./, keys would, so the
        # comparison is not of two transparent images
        cfg = RenderConfig(camera=CameraConfig(width=width, height=width),
                           query_method=QueryMethod(q),
                           tf=TransferFunctionConfig(
                               scale=0.3 if q in (2, 5) else 1.0))
        first, steady, img = timed(lambda: pipe.render(None, cfg, "auto"))
        scan = pipe.render(None, cfg, "scan")
        entry = {"renderer": pipe.resolve_renderer(
                     "auto", default_benchmark_inv_view(), cfg),
                 "first_s": first, "steady_s": steady}
        entry.update(golden(img, scan, f"query {q} auto vs scan"))
        if entry["mean_rgb"] < 1.0:
            raise AssertionError(f"query {q}: scan image is black {entry}")
        res["queries"][str(q)] = entry
        log(f"[b] query {q}: {entry}")

    # scan vs the numpy specification on a full-width band of rows
    stats = np.asarray(pipe.raw_stats)
    r0 = width // 2 - band // 2
    cfg = RenderConfig(camera=CameraConfig(width=width, height=width))
    scan = np.asarray(pipe.render(None, cfg, "scan"))[r0:r0 + band]
    t0 = time.perf_counter()
    ref = reference_render(
        lambda p: np_sample_trilinear(stats, p)[..., 0],
        default_benchmark_inv_view(), width, width, TF,
        rows=(r0, r0 + band),
    )
    res["scan_vs_numpy_band"] = {"rows": [r0, r0 + band],
                                 "numpy_s": time.perf_counter() - t0}
    res["scan_vs_numpy_band"].update(golden(scan, ref, "scan vs numpy"))

    # the viewer's frame path: fixed view, then a rotation drag
    srv = ViewerServer(pipe, width=width, height=width, port=0)
    try:
        frames = []
        for q in ({"density": "0.05"}, {"density": "0.06"},
                  {"rx": "20", "ry": "30"}, {"rx": "25", "ry": "30"}):
            t0 = time.perf_counter()
            buf = srv.render_frame(q)
            frames.append(time.perf_counter() - t0)
            if len(buf) != width * width * 4:
                raise AssertionError(f"viewer frame of {len(buf)} bytes")
            if max(buf) == 0:
                raise AssertionError(f"viewer frame {q} is black")
    finally:
        srv.httpd.server_close()
    res["viewer_frame_s"] = frames
    return res


# ---------------------------------------------------------------- phase c


def _oracle_f64(h, stat):
    """float64 numpy evaluation of the unit-family decode formulas
    (volumeRender_kernel.cu:742-769) on a bins-major (Z, B, Y, X) slab."""
    h = np.asarray(h, np.float64)
    B = h.shape[1]
    c = ((np.arange(B) + 0.5) / B)[None, :, None, None]
    mean = np.sum(h * c, axis=1)
    if stat == "mean":
        return mean
    if stat == "var":
        return np.sum(h * (c - mean[:, None]) ** 2, axis=1)
    safe = np.where(h > 0.0, h, 1.0)
    return -np.sum(h * np.log2(safe), axis=1) / np.log2(B)


def phase_distribution(n=512, bins=16, width=1024, small_dims=(40, 72, 100),
                       workdir=None) -> dict:
    tf = jnp.asarray(TF)
    origin = jnp.asarray([0.0, 0.0, 4.0], jnp.float32)
    t0 = time.perf_counter()
    hist = jax.block_until_ready(device_histogram_volume(n, bins, seed=0))
    res = {"hist_shape": list(hist.shape), "hist_dtype": str(hist.dtype),
           "hist_gb": hist.size * hist.dtype.itemsize / 1e9,
           "image": width, "gen_s": time.perf_counter() - t0, "stats": {}}

    for stat in ("mean", "var", "entropy"):
        rows, mode = decode_weight_rows(stat, bins, family="unit")
        rows = jnp.asarray(rows)
        tscl = STAT_TSCALE[stat]

        def render(h, lut, rows=rows, mode=mode, tscl=tscl):
            return slice_render_image(decode_with_rows(h, rows, mode), origin,
                                      width, width, lut, transfer_scale=tscl,
                                      n_planes=n)

        fn = jax.jit(render)
        t0 = time.perf_counter()
        compiled = fn.lower(hist, tf).compile()
        compile_s = time.perf_counter() - t0
        _, steady, img = timed(compiled, hist, tf)
        img = np.asarray(img)
        if img.shape != (width, width, 4) or not np.isfinite(img).all():
            raise AssertionError(f"{stat}: bad image {img.shape}")
        entry = {"compile_s": compile_s, "fwd_s": steady,
                 "mrays_per_s": width * width / steady / 1e6,
                 "alpha_max": float(img[..., 3].max())}
        entry.update(memory(compiled))
        if entry["alpha_max"] < 0.05:
            raise AssertionError(f"{stat}: image is empty {entry}")

        # the decode vs float64 numpy on a full n^2 plane slab
        zc = n // 2
        dec = np.asarray(jax.jit(lambda h: decode_with_rows(
            h[zc:zc + 1], rows, mode))(hist))
        ref = _oracle_f64(np.asarray(hist[zc:zc + 1].astype(jnp.float32)),
                          stat)
        # f32 sums of B products: relative bound ~B * 2^-24 of the largest
        # term; 1e-5 leaves a margin of ~10x. The variance combine
        # subtracts terms up to e_max^2 = 1 (unit family), so its bound is
        # taken against that, not against the small difference; TF32
        # contractions would miss it by ~1e-3
        tol = 1e-5 * (1.0 if stat == "var" else float(np.abs(ref).max()))
        err = float(np.abs(dec - ref).max())
        entry["decode_vs_f64"] = {"slab": [zc, zc + 1], "max_abs": err,
                                  "tol": tol}
        if err > tol:
            raise AssertionError(f"{stat}: decode vs float64 {err} > {tol}")

        if stat == "mean":
            # resample precision: default (TF32 on the card) vs HIGHEST vs
            # scan over the same decoded volume
            with jax.default_matmul_precision("highest"):
                hi_fn = jax.jit(lambda h, lut: render(h, lut))
                hi = np.asarray(hi_fn(hist, tf))
            vol = decode_with_rows(hist, rows, mode)
            scan = np.asarray(jax.jit(lambda v, lut: render_image(
                scalar_sample_fn(v), jnp.asarray(default_benchmark_inv_view()),
                width, width, lut))(vol, tf))
            del vol
            entry["default_vs_highest"] = golden(img, hi, "default vs highest")
            entry["highest_vs_scan"] = golden(hi, scan, "highest vs scan")
            entry["default_vs_scan"] = golden(img, scan, "default vs scan")
        res["stats"][stat] = entry
        log(f"[c] {stat}: {entry}")
    del hist

    # render-hist from a small voxel-major float32 file, dims not multiples
    # of 128
    nz, ny, nx = small_dims
    rng = np.random.default_rng(1)
    flat = rng.random((nz * ny * nx, bins)).astype(np.float32)
    flat /= flat.sum(axis=1, keepdims=True)
    path = os.path.join(workdir, "small_hist.bin")
    flat.tofile(path)
    out = os.path.join(workdir, "small_hist.ppm")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        rc = cli.main([
            "render-hist", "--hist-file", path, "--dims", str(nz), str(ny),
            str(nx), "--bins", str(bins), "--width", "200", "--height", "136",
            "--density", "0.5", "-o", out,
        ])
    ppm = formats.read_ppm(out)
    res["render_hist_cli"] = {"dims": list(small_dims), "rc": rc,
                              "seconds": time.perf_counter() - t0,
                              "ppm_shape": list(ppm.shape),
                              "says": cli_out.getvalue().strip().splitlines()}
    if rc != 0 or ppm.shape != (136, 200, 3) or ppm.max() == 0:
        raise AssertionError(f"render-hist: {res['render_hist_cli']}")
    return res


# ---------------------------------------------------------------- phase d


def _vjp_parity(n=32, width=48) -> float:
    """The sweep's analytic VJP vs plain autodiff on a small volume: max
    relative error of the volume and LUT cotangents."""
    vol = jnp.asarray(gaussian_blob_volume((n, n, n), seed=4))
    tf = jnp.asarray(TF)
    o = jnp.asarray([0.0, 0.0, 4.0], jnp.float32)

    def loss(v, lut, custom):
        img = slice_render_image(v, o, width, width, lut, density=0.3,
                                 n_planes=n, use_custom_vjp=custom)
        return jnp.sum(img ** 2)

    with jax.default_matmul_precision("highest"):
        ga = jax.jit(jax.grad(lambda v, l: loss(v, l, True), (0, 1)))(vol, tf)
        gb = jax.jit(jax.grad(lambda v, l: loss(v, l, False), (0, 1)))(vol,
                                                                       tf)
    return max(float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
               for a, b in zip(ga, gb))


def phase_training(n=512, bins=16, width=1024, fit_size=256, fit_bins=32,
                   fit_image=256, fit_iters=6, workdir=None) -> dict:
    tf = jnp.asarray(TF)
    origin = jnp.asarray([0.0, 0.0, 4.0], jnp.float32)
    hist = jax.block_until_ready(device_histogram_volume(n, bins, seed=0))
    rows, mode = decode_weight_rows("mean", bins, family="unit")
    rows = jnp.asarray(rows)

    def loss(h, lut):
        img = slice_render_image(decode_with_rows(h, rows, mode), origin,
                                 width, width, lut, n_planes=n)
        return jnp.mean((img - 0.25) ** 2)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
    t0 = time.perf_counter()
    compiled = step.lower(hist, tf).compile()
    compile_s = time.perf_counter() - t0
    _, steady, (l, (gh, gl)) = timed(compiled, hist, tf, repeats=5)
    res = {"hist_shape": list(hist.shape), "image": width,
           "compile_s": compile_s, "fwdbwd_s": steady,
           "mrays_per_s": width * width / steady / 1e6, "loss": float(l)}
    res.update(memory(compiled))
    if (gh.shape, gh.dtype, gl.shape) != (hist.shape, hist.dtype, tf.shape):
        raise AssertionError(f"grad shapes {gh.shape} {gh.dtype} {gl.shape}")
    gmax = float(jnp.max(jnp.abs(gh.astype(jnp.float32))))
    if not (np.isfinite(float(l)) and np.isfinite(gmax) and gmax > 0.0
            and bool(jnp.all(jnp.isfinite(gl)))):
        raise AssertionError(f"non-finite or zero gradients: {res}")
    del gh, gl

    # device-idle share over a traced window of three steps
    trace_dir = os.path.join(workdir, "trace")
    with device_trace(trace_dir):
        with annotate("smoke_fwdbwd_window"):
            for _ in range(3):
                jax.block_until_ready(compiled(hist, tf))
    shares = device_busy_share(trace_dir, "smoke_fwdbwd_window")
    res["trace"] = {k: {kk: v[kk] for kk in ("busy_share", "idle_share",
                                             "window_ms")}
                    for k, v in shares.items()}
    res["trace_lines"] = sorted({ln for v in shares.values()
                                 for ln in v["lines"]})[:8]
    del hist, compiled

    res["vjp_vs_autodiff_max_rel"] = _vjp_parity()
    if res["vjp_vs_autodiff_max_rel"] > 1e-3:
        raise AssertionError(f"analytic VJP parity {res}")

    ck = os.path.join(workdir, "fit_hist.npz")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        rc = cli.main([
            "fit-hist", "--size", str(fit_size), "--bins", str(fit_bins),
            "--image", str(fit_image), "--iters", str(fit_iters),
            "--checkpoint", ck,
        ])
    lines = cli_out.getvalue().strip().splitlines()
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in lines if ln.startswith("step ")]
    res["fit_hist_cli"] = {"size": fit_size, "bins": fit_bins, "rc": rc,
                           "seconds": time.perf_counter() - t0,
                           "losses": losses}
    if rc != 0 or len(losses) < 2 or not np.all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"fit-hist: {res['fit_hist_cli']} {lines}")
    res.update({"peak_bytes_in_use": memory()["peak_bytes_in_use"]})
    return res


# ---------------------------------------------------------------- phase e


def phase_four(devices, n=512, width=1024, bins=16) -> dict:
    """Sharded (4, 1) mesh paths against single-device on devices[0]."""
    import optax

    from vrdd_tpu.parallel.mesh import make_mesh
    from vrdd_tpu.parallel.sweep import (
        distributed_hist_render,
        distributed_sweep_render,
        shard_hist_volume,
        shard_scalar_volume,
    )
    from vrdd_tpu.parallel.train import make_sweep_fit_step, shard_target_image

    mesh = make_mesh(len(devices), 1, devices=devices)
    tf = jnp.asarray(TF)
    origin = jnp.asarray([0.0, 0.0, 4.0], jnp.float32)
    res = {"mesh": dict(mesh.shape), "n": n, "image": width}

    vol = jax.device_put(device_blob_volume(n), devices[0])
    single = jax.jit(lambda v, lut: slice_render_image(
        v, origin, width, width, lut, n_planes=n))
    _, t_single, ref = timed(single, vol, tf)
    vs = shard_scalar_volume(vol, mesh)
    dist = jax.jit(lambda v, lut: distributed_sweep_render(
        v, origin, lut, width=width, height=width, mesh=mesh, n_planes=n))
    _, t_dist, got = timed(dist, vs, tf)
    res["sweep"] = {"single_s": t_single, "sharded_s": t_dist}
    res["sweep"].update(golden(got, ref, "sharded vs single sweep"))

    # one sweep-fit step (LUT learned, volume fixed) vs the same Adam step
    # on the single-device render
    target = jnp.full((width, width, 4), 0.25, jnp.float32)
    init_fn, step_fn = make_sweep_fit_step(mesh, width, width, n_planes=n)
    params, opt_state = init_fn(tf)
    params, opt_state, loss_d = step_fn(params, opt_state, vs, origin,
                                        shard_target_image(target, mesh))
    opt = optax.adam(1e-2)

    # the volume and target are arguments, never closed-over constants
    def loss_s(lut, v, tgt):
        img = slice_render_image(v, origin, width, width, lut,
                                 density=0.05, n_planes=n)
        return jnp.mean((img - tgt) ** 2)

    l_s, g_s = jax.jit(jax.value_and_grad(loss_s))(tf, vol, target)
    upd, _ = opt.update(g_s, opt.init(tf), tf)
    lut_s = optax.apply_updates(tf, upd)
    res["fit_step"] = {
        "loss_sharded": float(loss_d), "loss_single": float(l_s),
        "loss_rel": abs(float(loss_d) - float(l_s)) / abs(float(l_s)),
        "lut_max_abs": float(np.abs(np.asarray(params["tf_lut"])
                                    - np.asarray(lut_s)).max()),
    }
    # Adam's first step moves each entry by ~lr * sign(g): a sign flip of a
    # tiny gradient entry would show as ~2e-2
    if res["fit_step"]["loss_rel"] > 1e-3 or \
            res["fit_step"]["lut_max_abs"] > 1e-3:
        raise AssertionError(f"sharded fit step: {res['fit_step']}")
    del vol, vs, ref, got

    hist = jax.device_put(device_histogram_volume(n, bins, seed=0),
                          devices[0])
    rows, mode = decode_weight_rows("mean", bins, family="unit")
    rows = jnp.asarray(rows)
    single_h = jax.jit(lambda h, lut: slice_render_image(
        decode_with_rows(h, rows, mode), origin, width, width, lut,
        n_planes=n))
    _, t_single, ref = timed(single_h, hist, tf)
    hs = shard_hist_volume(hist, mesh)
    dist_h = jax.jit(lambda h, lut: distributed_hist_render(
        h, rows, origin, lut, width=width, height=width, mesh=mesh,
        stat=mode))
    _, t_dist, got = timed(dist_h, hs, tf)
    res["hist"] = {"single_s": t_single, "sharded_s": t_dist}
    res["hist"].update(golden(got, ref, "sharded vs single hist render"))
    return res


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-GPU sharded phase (e)")
    args = p.parse_args(argv)
    dev = phase_device()
    enable_compilation_cache()

    def run(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        res["phase_s"] = time.perf_counter() - t0
        emit(phase, res)

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_work_") as wd:
        if args.four_gpus:
            devs = jax.devices()
            if len(devs) < 4:
                raise SystemExit(f"--four-gpus needs 4 GPUs; found {devs}")
            run("e", phase_four, devs[:4])
        else:
            run("b", phase_interactive)
            run("c", phase_distribution, workdir=wd)
            run("d", phase_training, workdir=wd)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
