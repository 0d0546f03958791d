"""Command-line interface — the offline replacement for the GLUT app shell.

Subcommands:

- ``render``   render a dataset to PPM/NPY; ``--file ref.ppm`` switches to the
               benchmark+golden-test mode of the reference's ``-file`` flag
               (warmup + N timed iterations, MTexels/s print, PPM compare,
               pass/fail exit code — runSingleTest, volumeRender.cpp:1016-1084)
- ``encode``   offline data reduction: raw scalar volume -> block-histogram /
               flexible-block binary files in the reference formats
- ``fit-tf``   differentiable transfer-function fitting with checkpoint/resume
- ``view``     interactive browser viewer (the GLUT window replacement:
               mouse rotate/pan/zoom + the reference's keyboard map)
- ``bench``    the performance benchmark (same as bench.py)

Interactive keyboard controls (volumeRender.cpp:302-384) map to flags:
``+/-`` -> --density, ``]/[`` -> --brightness, ``;/'`` -> --tf-offset,
``./,`` -> --tf-scale, ``0-9`` -> --query.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_render_params(p: argparse.ArgumentParser) -> None:
    p.add_argument("--query", type=int, default=1, help="query method 0-9")
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--brightness", type=float, default=1.0)
    p.add_argument("--tf-offset", type=float, default=0.0)
    p.add_argument("--tf-scale", type=float, default=1.0)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--rot-x", type=float, default=0.0)
    p.add_argument("--rot-y", type=float, default=0.0)
    p.add_argument("--translate-z", type=float, default=-4.0)
    p.add_argument("--tf-checkpoint", help="load fitted TF LUT from checkpoint")
    p.add_argument(
        "--flex-normalize", action="store_true",
        help="min-max map flexible-block mean/variance onto [0,1] for the TF "
        "(the reference leaves them in raw bin-domain units)",
    )


def _build_pipeline(args):
    import jax.numpy as jnp

    from vrdd_tpu.io.synthetic import (
        random_histogram_volume,
        synthetic_flexible_dataset,
        synthetic_fractal_volume,
    )
    from vrdd_tpu.models.flexible import FlexibleBlockVolume
    from vrdd_tpu.models.pipeline import RenderPipeline
    from vrdd_tpu.models.volumes import FractalHistogramVolume, RawHistogramVolume

    tf_lut = None
    if getattr(args, "tf_checkpoint", None):
        from vrdd_tpu.io.checkpoint import load_checkpoint

        tf_lut = np.asarray(load_checkpoint(args.tf_checkpoint)["tf_lut"])

    if args.volume and args.volume != "synthetic":
        from vrdd_tpu.io import formats

        hist = formats.read_raw_histograms(
            args.volume, int(np.prod(args.blocks)), args.bins
        ).reshape(args.blocks[2], args.blocks[1], args.blocks[0], args.bins)
        return RenderPipeline(raw=RawHistogramVolume(jnp.asarray(hist)), tf_lut=tf_lut)

    hist = random_histogram_volume(
        (args.blocks[2], args.blocks[1], args.blocks[0]), n_bins=args.bins,
        seed=args.seed,
    )
    t, cb, eb, ev, _ = synthetic_fractal_volume(
        (args.blocks[2], args.blocks[1], args.blocks[0]), n_bins=args.bins,
        seed=args.seed + 1,
    )
    ds = synthetic_flexible_dataset(dims=(16, 16, 16), seed=args.seed + 2)
    flexible = FlexibleBlockVolume.from_raw(
        ds["raw"], block_size=args.flex_block, vmax=256.0
    )
    if getattr(args, "flex_normalize", False):
        # min-max map the raw-unit mean/variance channels onto the TF domain
        # (the normalization the reference left as a TODO; queries 9/0 are
        # otherwise black until transferScale is wound down manually)
        flexible = flexible.normalized()
    return RenderPipeline(
        raw=RawHistogramVolume(jnp.asarray(hist)),
        fractal=FractalHistogramVolume(
            jnp.asarray(cb), jnp.asarray(eb), jnp.asarray(ev), jnp.asarray(t)
        ),
        flexible=flexible,
        tf_lut=tf_lut,
    )


def cmd_render(args) -> int:
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.core.image import rgba_to_uint8
    from vrdd_tpu.io import formats
    from vrdd_tpu.utils.config import (
        CameraConfig,
        QueryMethod,
        RenderConfig,
        TransferFunctionConfig,
    )

    pipeline = _build_pipeline(args)
    config = RenderConfig(
        camera=CameraConfig(width=args.width, height=args.height),
        tf=TransferFunctionConfig(offset=args.tf_offset, scale=args.tf_scale),
        density=args.density,
        brightness=args.brightness,
        query_method=QueryMethod(args.query),
    )
    inv_view = inv_view_from_rotation_translation(
        args.rot_x, args.rot_y, (0.0, 0.0, args.translate_z)
    )

    if args.file:
        # benchmark + golden test (runSingleTest semantics)
        img = pipeline.render(inv_view, config, args.renderer)  # warmup + compile
        np.asarray(img)
        n_iter = args.iters
        t0 = time.perf_counter()
        for _ in range(n_iter):
            img = pipeline.render(inv_view, config, args.renderer)
        np.asarray(img)
        avg = (time.perf_counter() - t0) / n_iter
        print(
            f"vrdd_tpu render, Throughput = {args.width * args.height / avg / 1e6:.4f}"
            f" MTexels/s, Time = {avg:.5f} s, Size = {args.width * args.height} Texels"
        )
        out = np.asarray(rgba_to_uint8(img))
        formats.write_ppm(args.output or "volume.ppm", out)
        if args.file == "none":
            return 0
        ref = formats.read_ppm(args.file)
        ok, frac = formats.compare_ppm(out[..., :3], ref, args.epsilon, args.threshold)
        print(f"golden compare: outlier fraction {frac:.4f} -> "
              f"{'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1

    img = pipeline.render(inv_view, config, args.renderer)
    out_path = args.output or "volume.ppm"
    if out_path.endswith(".npy"):
        np.save(out_path, np.asarray(img))
    else:
        formats.write_ppm(out_path, np.asarray(rgba_to_uint8(img)))
    for k, v in pipeline.timings.items():
        print(f"{k}: {v * 1e3:.3f} ms", file=sys.stderr)
    print(f"wrote {out_path}")
    return 0


def cmd_encode(args) -> int:
    from vrdd_tpu.io import formats
    from vrdd_tpu.io.synthetic import (
        block_histograms_from_scalar,
        gaussian_blob_volume,
    )

    if args.input == "synthetic":
        vol = gaussian_blob_volume(tuple(args.dims[::-1]), seed=args.seed)
    else:
        vol = np.fromfile(args.input, dtype=np.float32).reshape(args.dims[::-1])
    hist = block_histograms_from_scalar(
        vol, tuple(args.block[::-1]), n_bins=args.bins, vmax=float(vol.max()) + 1e-6
    )
    formats.write_raw_histograms(args.output, hist.reshape(-1, args.bins))
    print(
        f"encoded {vol.shape} -> {hist.shape[:3][::-1]} blocks x {args.bins} bins "
        f"-> {args.output}"
    )
    return 0


def cmd_fit_tf(args) -> int:
    import jax
    import jax.numpy as jnp
    import optax

    from vrdd_tpu.core.geometry import default_benchmark_inv_view
    from vrdd_tpu.core.transfer import default_transfer_function, grayscale_ramp
    from vrdd_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from vrdd_tpu.march.scan import render_image
    from vrdd_tpu.models.renderer import stats_sample_fn
    from vrdd_tpu.utils.config import MarchConfig

    pipeline = _build_pipeline(args)
    stats = pipeline.raw_stats
    inv_view = jnp.asarray(default_benchmark_inv_view())
    march = MarchConfig(max_steps=args.steps, tstep=2.0 / args.steps)
    W = H = args.size

    renderer = getattr(args, "renderer", "auto")
    if renderer == "auto":
        renderer = "slice"
    print(f"fit-tf renderer: {renderer}")

    if renderer == "slice":
        from vrdd_tpu.march.slice import slice_render_image

        vol = stats[..., 0]  # mean channel, query method 1
        origin = inv_view[:, 3]
        n_planes = max(64, 2 * vol.shape[0])

        def fwd(v, lut):
            return slice_render_image(
                v, origin, W, H, lut, n_planes=n_planes
            )

        target = fwd(vol, jnp.asarray(default_transfer_function()))

        def loss_fn(lut, stats, target):
            return jnp.mean((fwd(stats[..., 0], lut) - target) ** 2)
    else:
        target = render_image(
            stats_sample_fn(stats, 0), inv_view, W, H,
            jnp.asarray(default_transfer_function()),
        )

        def loss_fn(lut, stats, target):
            img = render_image(stats_sample_fn(stats, 0), inv_view, W, H, lut,
                               march=march)
            return jnp.mean((img - target) ** 2)

    optimizer = optax.adam(args.lr)
    # stats/target are jit arguments, not closures — closed-over device
    # arrays become XLA constants, and constant folding of the render graph
    # then dominates compile time

    @jax.jit
    def step(lut, opt_state, stats, target):
        loss, g = jax.value_and_grad(loss_fn)(lut, stats, target)
        updates, opt_state = optimizer.update(g, opt_state, lut)
        return optax.apply_updates(lut, updates), opt_state, loss

    start = 0
    if args.resume:
        ck = load_checkpoint(args.resume)
        lut = jnp.asarray(ck["tf_lut"])
        opt_state = ck["opt_state"]
        start = int(ck["step"])
        print(f"resumed from {args.resume} at step {start}")
    else:
        lut = jnp.asarray(grayscale_ramp(9))
        opt_state = optimizer.init(lut)

    loss = float("nan")
    for i in range(start, start + args.iters):
        lut, opt_state, loss = step(lut, opt_state, stats, target)
        if (i + 1) % max(1, args.iters // 10) == 0:
            print(f"step {i + 1}: loss {float(loss):.6f}")
    save_checkpoint(
        args.checkpoint,
        {"tf_lut": np.asarray(lut), "opt_state": opt_state,
         "step": np.asarray(start + args.iters)},
    )
    print(f"saved {args.checkpoint} (final loss {float(loss):.6f})")
    return 0


def cmd_fit_voxels(args) -> int:
    """BASELINE config 3: per-voxel Gaussian (mu, sigma) recovered from
    multi-view renders through the differentiable renderer.

    The decode (``ops/gaussian.py`` gaussian_stats) and the sweep render
    are differentiated end-to-end: volume cotangents from the sweep's
    analytic VJP chain back through the moment-decode. Rotated views ride
    the shear-warp sweep, so every view uses the same sweep.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.core.transfer import grayscale_ramp
    from vrdd_tpu.io.checkpoint import save_checkpoint
    from vrdd_tpu.io.synthetic import gaussian_blob_volume
    from vrdd_tpu.march.shearwarp import shearwarp_render_image
    from vrdd_tpu.march.slice import slice_render_image
    from vrdd_tpu.ops.gaussian import gaussian_stats

    n, W = args.size, args.image
    H = W

    # ground truth: blob mu, spatially varying sigma
    mu_true = jnp.asarray(gaussian_blob_volume((n, n, n), seed=args.seed))
    sigma_true = 0.05 + 0.15 * jnp.asarray(
        gaussian_blob_volume((n, n, n), seed=args.seed + 1)
    )
    lut = jnp.asarray(grayscale_ramp(9))
    a = float(args.view_angle)
    views = [(0.0, 0.0), (a, 0.0), (0.0, a), (-a, 0.0), (0.0, -a)]
    views = views[: max(1, args.views)]
    # variance lives in [0, ~sigma_max^2]; scale it into the TF domain
    var_scale = 1.0 / float(jnp.max(sigma_true) ** 2)

    def render_channel(vol, rx, ry, tf_scale):
        if (rx, ry) == (0.0, 0.0):
            origin = jnp.asarray([0.0, 0.0, 4.0])
            return slice_render_image(
                vol, origin, W, H, lut, transfer_scale=tf_scale,
                n_planes=2 * n,
            )
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        return shearwarp_render_image(
            vol, iv, W, H, lut, transfer_scale=tf_scale, n_planes=2 * n,
        )

    def render_channel_streamed(mu, log_sigma, ch, tf_scale):
        # --streamed: decode per plane-chunk inside the sweep (the decoded
        # stats volume never materializes; march/streaming.py)
        from vrdd_tpu.march.streaming import streaming_decode_render

        return streaming_decode_render(
            (mu, log_sigma),
            lambda t: gaussian_stats(t[0], jnp.exp(t[1]))[..., ch],
            jnp.asarray([0.0, 0.0, 4.0]), lut, transfer_scale=tf_scale,
            width=W, height=H, n_planes=2 * n,
        )

    streamed = bool(getattr(args, "streamed", False))

    def render_views(mu, log_sigma):
        stats = gaussian_stats(mu, jnp.exp(log_sigma))
        out = []
        for rx, ry in views:
            if streamed and (rx, ry) == (0.0, 0.0):
                out.append((
                    render_channel_streamed(mu, log_sigma, 0, 1.0),
                    render_channel_streamed(mu, log_sigma, 1, var_scale),
                ))
            else:
                out.append((
                    render_channel(stats[..., 0], rx, ry, 1.0),
                    render_channel(stats[..., 1], rx, ry, var_scale),
                ))
        return out

    targets = jax.jit(render_views)(mu_true, jnp.log(sigma_true))
    targets = jax.tree_util.tree_map(jax.lax.stop_gradient, targets)

    def loss_fn(params, targets):
        rend = render_views(*params)
        loss = 0.0
        for (rm, rv), (tm, tv) in zip(rend, targets):
            loss = loss + jnp.mean((rm - tm) ** 2) + jnp.mean((rv - tv) ** 2)
        return loss / len(views)

    optimizer = optax.adam(args.lr)
    params = (
        jnp.zeros((n, n, n), jnp.float32),
        jnp.full((n, n, n), jnp.log(0.1), jnp.float32),
    )
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, targets):
        loss, g = jax.value_and_grad(loss_fn)(params, targets)
        updates, opt_state = optimizer.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    loss = float("nan")
    for i in range(args.iters):
        params, opt_state, loss = step(params, opt_state, targets)
        if (i + 1) % max(1, args.iters // 10) == 0:
            print(f"step {i + 1}: loss {float(loss):.6f}")
    mu, sigma = np.asarray(params[0]), np.asarray(jnp.exp(params[1]))
    err = float(np.sqrt(np.mean((mu - np.asarray(mu_true)) ** 2)))
    save_checkpoint(
        args.checkpoint,
        {"mu": mu, "sigma": sigma, "loss": np.float32(loss)},
    )
    print(
        f"saved {args.checkpoint} (final loss {float(loss):.6f}, "
        f"mu RMSE {err:.4f} over {len(views)} views)"
    )
    return 0


def cmd_fit_hist(args) -> int:
    """BASELINE config 4 end-to-end: recover a per-voxel HISTOGRAM volume
    from renders of a decoded statistic, differentiating through the
    decode (ops/histogram.py ``decode_with_rows``) and the slice sweep's
    analytic VJP. ``--stat`` selects the observed statistic: 'mean'
    (linear), 'var' or 'entropy' (nonlinear combines — the inverse problem
    runs through the decode jacobian chain). Histograms are
    softmax-parameterized so they stay on the simplex (the reference's
    sum == 1 invariant, volumeRender.cpp:583-597)."""
    import jax
    import jax.numpy as jnp
    import optax

    from vrdd_tpu.core.transfer import grayscale_ramp
    from vrdd_tpu.io.checkpoint import save_checkpoint
    from vrdd_tpu.io.synthetic import gaussian_blob_volume
    from vrdd_tpu.march.slice import slice_render_image
    from vrdd_tpu.ops.histogram import decode_weight_rows, decode_with_rows

    n, W, B = args.size, args.image, args.bins
    H = W
    lut = jnp.asarray(grayscale_ramp(9))
    origin = jnp.asarray([0.0, 0.0, 4.0])
    dw = jnp.asarray((np.arange(B) + 0.5) / B, jnp.float32)
    stat = getattr(args, "stat", "mean")
    rows, mode = decode_weight_rows(stat, B, family="unit")
    rows = jnp.asarray(rows)
    # window the TF so each statistic's range lands mid-ramp with live
    # gradients: unit-family variance of a near-unimodal histogram is
    # small, and entropy sits near 1.0 where an unwindowed ramp clips at
    # the top knot (clipped q has zero TF gradient — nothing would fit)
    toff, tscl = {"mean": (0.0, 1.0), "var": (0.0, 12.0),
                  "entropy": (0.55, 2.0)}[stat]

    # ground truth: smooth logits -> simplex histograms, bins-major
    base = jnp.asarray(gaussian_blob_volume((n, n, n), seed=args.seed))
    centers = dw[:, None, None, None]
    logits_true = -((centers - base[None]) ** 2) / 0.02
    hist_true = jax.nn.softmax(logits_true, axis=0)

    def render_mean(hist_bm):
        vol = decode_with_rows(hist_bm, rows, mode)
        return slice_render_image(vol, origin, W, H, lut,
                                  transfer_offset=toff,
                                  transfer_scale=tscl, n_planes=n)

    def to_hist(logits):  # (B, Z, Y, X) simplex over bins, z-major layout
        return jnp.transpose(jax.nn.softmax(logits, axis=0), (1, 0, 2, 3))

    target = jax.lax.stop_gradient(
        jax.jit(lambda l: render_mean(to_hist(l)))(logits_true)
    )

    def loss_fn(logits):
        img = render_mean(to_hist(logits))
        return jnp.mean((img - target) ** 2)

    optimizer = optax.adam(args.lr)
    # small random init, NOT zeros: the uniform histogram is an exact
    # saddle of the entropy statistic (its gradient is constant across
    # bins, which the softmax jacobian annihilates)
    params = 0.05 * jax.random.normal(
        jax.random.PRNGKey(args.seed + 1), (B, n, n, n), jnp.float32
    )
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    loss = float("nan")
    for i in range(args.iters):
        params, opt_state, loss = step(params, opt_state)
        if (i + 1) % max(1, args.iters // 10) == 0:
            print(f"step {i + 1}: loss {float(loss):.6f}")
    hist = np.asarray(to_hist(params))
    mean_err = float(np.sqrt(np.mean(
        (np.einsum("zbyx,b->zyx", hist, np.asarray(dw))
         - np.einsum("bzyx,b->zyx", np.asarray(hist_true), np.asarray(dw)))
        ** 2
    )))
    save_checkpoint(
        args.checkpoint, {"hist": hist, "loss": np.float32(loss)}
    )
    print(f"saved {args.checkpoint} (final loss {float(loss):.6f}, "
          f"decoded-mean RMSE {mean_err:.4f})")
    return 0


def cmd_render_hist(args) -> int:
    """Render STRAIGHT from a block-histogram file: native bins-major load
    (io/native.py — transposed to the device layout during the sequential
    read, bf16 by default) -> decode to the statistic
    (ops/histogram.py ``decode_with_rows``) -> slice sweep, or shear-warp
    sweep for rotated views. The whole path from the reference's on-disk
    format to pixels."""
    import jax.numpy as jnp

    from vrdd_tpu.core.image import rgba_to_uint8
    from vrdd_tpu.core.transfer import default_transfer_function
    from vrdd_tpu.io import formats, native
    from vrdd_tpu.march.slice import slice_render_image
    from vrdd_tpu.ops.histogram import decode_weight_rows, decode_with_rows

    nz, ny, nx = args.dims
    B = args.bins
    loader = (
        native.read_histograms_bins_major
        if native.available()
        else formats.read_histograms_bins_major
    )
    hist = loader(args.hist_file, (nz, ny, nx), B, dtype=args.dtype)
    print(f"loaded {args.hist_file}: {hist.shape} {hist.dtype} "
          f"({'native' if native.available() else 'python'} loader)")
    # decode statistic (reference queries 1/2/3); 'unit' family = centers
    # on [0, 1], the natural range for standalone histogram files
    rows, mode = decode_weight_rows(args.stat, B, family="unit")
    tf = jnp.asarray(default_transfer_function())
    origin = jnp.asarray([0.0, 0.0, args.translate_z * -1.0], jnp.float32)
    W, H = args.width, args.height
    vol = decode_with_rows(jnp.asarray(hist), rows, mode)
    if args.rot_x != 0.0 or args.rot_y != 0.0:
        from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
        from vrdd_tpu.march.shearwarp import shearwarp_render_image

        iv = inv_view_from_rotation_translation(
            args.rot_x, args.rot_y, (0.0, 0.0, args.translate_z)
        )
        img = shearwarp_render_image(
            vol, iv, W, H, tf, density=args.density,
            transfer_scale=args.tf_scale, n_planes=nz,
        )
        path = f"rotated shear-warp ({args.stat})"
    else:
        img = slice_render_image(
            vol, origin, W, H, tf, density=args.density,
            transfer_scale=args.tf_scale, n_planes=nz
        )
        path = f"slice sweep ({args.stat})"
    out = np.asarray(rgba_to_uint8(img))
    formats.write_ppm(args.output, out)
    print(f"wrote {args.output} ({path})")
    return 0


def cmd_view(args) -> int:
    """Interactive browser viewer — the GLUT main-loop replacement.

    Serves the page + raw-RGBA frames from a stateless HTTP server; the
    browser holds the camera/render state and maps the reference's keyboard
    and mouse interactions (volumeRender.cpp:302-432). See vrdd_tpu/viewer.py.
    """
    from vrdd_tpu.viewer import ViewerServer

    pipeline = _build_pipeline(args)
    server = ViewerServer(
        pipeline,
        width=args.width,
        height=args.height,
        renderer=args.renderer,
        query=args.query,
        host=args.host,
        port=args.port,
    )
    server.serve_forever()
    return 0


def main(argv=None) -> int:
    from vrdd_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(prog="vrdd", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a dataset to an image")
    pr.add_argument("--volume", default="synthetic",
                    help="'synthetic' or path to a raw block-histogram blob")
    pr.add_argument("--blocks", type=int, nargs=3, default=[50, 50, 10],
                    metavar=("X", "Y", "Z"))
    pr.add_argument("--bins", type=int, default=32)
    pr.add_argument("--flex-block", type=int, default=4)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--output", "-o", default=None)
    pr.add_argument("--file", default=None,
                    help="reference PPM for benchmark+golden mode ('none' to skip compare)")
    pr.add_argument("--iters", type=int, default=10)
    pr.add_argument("--epsilon", type=float, default=5.0)
    pr.add_argument("--threshold", type=float, default=0.30)
    pr.add_argument(
        "--renderer",
        choices=("scan", "slice", "shearwarp", "auto"),
        default="scan",
        help="scan = general ray marcher (reference-faithful); slice = "
        "object-order matmul sweep (unrotated); shearwarp = object-order "
        "sweep for rotated views; auto = fastest applicable (stats and "
        "flexible-block queries go object-order)",
    )
    _add_render_params(pr)
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser("encode", help="raw volume -> block histogram files")
    pe.add_argument("--input", default="synthetic")
    pe.add_argument("--dims", type=int, nargs=3, default=[64, 64, 64],
                    metavar=("X", "Y", "Z"))
    pe.add_argument("--block", type=int, nargs=3, default=[8, 8, 8])
    pe.add_argument("--bins", type=int, default=32)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--output", "-o", default="histograms.bin")
    pe.set_defaults(fn=cmd_encode)

    pf = sub.add_parser("fit-tf", help="fit the transfer function LUT")
    pf.add_argument("--volume", default="synthetic")
    pf.add_argument("--blocks", type=int, nargs=3, default=[16, 16, 8])
    pf.add_argument("--bins", type=int, default=32)
    pf.add_argument("--flex-block", type=int, default=4)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--size", type=int, default=64)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--iters", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.add_argument("--checkpoint", default="tf_fit.npz")
    pf.add_argument("--resume", default=None)
    pf.add_argument(
        "--renderer", default="auto", choices=["auto", "scan", "slice"],
        help="forward for the fit: scan (bit-faithful marcher) or slice "
        "(matmul sweep, analytic VJP; what auto picks)",
    )
    pf.add_argument("--tf-checkpoint", default=None, help=argparse.SUPPRESS)
    pf.set_defaults(fn=cmd_fit_tf)

    pv = sub.add_parser(
        "fit-voxels",
        help="fit per-voxel Gaussian (mu, sigma) from multi-view renders",
    )
    pv.add_argument("--size", type=int, default=32, help="volume dimension")
    pv.add_argument("--image", type=int, default=128)
    pv.add_argument("--views", type=int, default=3, help="1-5 views")
    pv.add_argument("--view-angle", type=float, default=25.0)
    pv.add_argument("--iters", type=int, default=100)
    pv.add_argument("--lr", type=float, default=3e-2)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--checkpoint", default="voxel_fit.npz")
    pv.add_argument(
        "--streamed", action="store_true",
        help="decode (mu, sigma) per plane-chunk inside the sweep for the "
        "unrotated views (peak-memory mode; march/streaming.py)",
    )
    pv.set_defaults(fn=cmd_fit_voxels)

    ph = sub.add_parser(
        "fit-hist",
        help="fit a per-voxel histogram volume through the decode",
    )
    ph.add_argument("--size", type=int, default=32, help="volume dimension")
    ph.add_argument("--image", type=int, default=128)
    ph.add_argument("--bins", type=int, default=16)
    ph.add_argument("--iters", type=int, default=50)
    ph.add_argument("--lr", type=float, default=0.05)
    ph.add_argument("--seed", type=int, default=0)
    ph.add_argument("--stat", default="mean",
                    choices=["mean", "var", "entropy"],
                    help="observed statistic to invert through")
    ph.add_argument("--checkpoint", default="fit_hist.npz")
    ph.set_defaults(fn=cmd_fit_hist)

    prh = sub.add_parser(
        "render-hist",
        help="render straight from a histogram file",
    )
    prh.add_argument("--hist-file", required=True)
    prh.add_argument("--dims", type=int, nargs=3, required=True,
                     metavar=("NZ", "NY", "NX"))
    prh.add_argument("--bins", type=int, default=16)
    prh.add_argument("--dtype", default="bfloat16",
                     choices=["bfloat16", "bf16", "float32"])
    prh.add_argument("--width", type=int, default=512)
    prh.add_argument("--height", type=int, default=512)
    prh.add_argument("--density", type=float, default=0.05)
    prh.add_argument("--translate-z", type=float, default=-4.0)
    prh.add_argument("--stat", default="mean",
                     choices=["mean", "var", "entropy"],
                     help="decoded statistic (reference queries 1/2/3)")
    prh.add_argument("--tf-scale", type=float, default=1.0, dest="tf_scale")
    prh.add_argument("--rot-x", type=float, default=0.0,
                     help="camera rotation about x (degrees; rotated views "
                     "ride the shear-warp sweep)")
    prh.add_argument("--rot-y", type=float, default=0.0)
    prh.add_argument("-o", "--output", default="hist_render.ppm")
    prh.set_defaults(fn=cmd_render_hist)

    pw = sub.add_parser(
        "view",
        help="interactive browser viewer (the GLUT window replacement)",
    )
    pw.add_argument("--volume", default="synthetic",
                    help="'synthetic' or path to a raw block-histogram blob")
    pw.add_argument("--blocks", type=int, nargs=3, default=[50, 50, 10],
                    metavar=("X", "Y", "Z"))
    pw.add_argument("--bins", type=int, default=32)
    pw.add_argument("--flex-block", type=int, default=4)
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--width", type=int, default=512)
    pw.add_argument("--height", type=int, default=512)
    pw.add_argument("--query", type=int, default=1)
    pw.add_argument("--renderer", default="auto",
                    choices=("scan", "slice", "auto"),
                    help="auto picks the fastest applicable path per view "
                    "(slice/shear-warp sweep for stats queries, scan "
                    "otherwise); scan keeps the view a traced argument "
                    "(never recompiles while dragging)")
    pw.add_argument("--host", default="127.0.0.1")
    pw.add_argument("--port", type=int, default=8412)
    pw.add_argument("--tf-checkpoint", help="load fitted TF LUT")
    pw.add_argument("--flex-normalize", action="store_true",
                    help="min-max map flexible-block stats onto the TF domain")
    pw.set_defaults(fn=cmd_view)

    pb = sub.add_parser("bench", help="performance benchmark")
    pb.add_argument("--size", type=int, default=512)
    pb.add_argument("--image", type=int, default=1024)
    pb.add_argument("--iters", type=int, default=4)
    def _bench(args):
        import bench

        sys.argv = ["bench.py", "--size", str(args.size), "--image",
                    str(args.image), "--iters", str(args.iters)]
        bench.main()
        return 0
    pb.set_defaults(fn=_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
