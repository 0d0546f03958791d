"""CLI workflows + checkpoint/resume tests (CPU)."""

import os

import numpy as np
import pytest

from vrdd_tpu import cli
from vrdd_tpu.io import formats
from vrdd_tpu.io.checkpoint import load_checkpoint, save_checkpoint


def test_checkpoint_roundtrip_pytree(tmp_path):
    import optax
    import jax.numpy as jnp

    opt = optax.adam(1e-2)
    lut = jnp.ones((9, 4))
    tree = {"tf_lut": lut, "opt_state": opt.init(lut), "step": np.asarray(7)}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, tree)
    back = load_checkpoint(p)
    assert int(back["step"]) == 7
    np.testing.assert_array_equal(back["tf_lut"], np.ones((9, 4)))
    # optimizer state structure survives
    import jax

    s1 = jax.tree_util.tree_structure(tree["opt_state"])
    s2 = jax.tree_util.tree_structure(back["opt_state"])
    assert s1 == s2


def test_cli_render_writes_ppm(tmp_path):
    out = str(tmp_path / "img.ppm")
    rc = cli.main([
        "render", "--blocks", "8", "8", "4", "--width", "24", "--height", "24",
        "-o", out,
    ])
    assert rc == 0 and os.path.exists(out)
    img = formats.read_ppm(out)
    assert img.shape == (24, 24, 3)


def test_cli_render_golden_self_compare(tmp_path):
    """Render once, then benchmark mode against the saved image must PASS."""
    ref = str(tmp_path / "ref.ppm")
    rc = cli.main([
        "render", "--blocks", "8", "8", "4", "--width", "16", "--height", "16",
        "-o", ref,
    ])
    assert rc == 0
    out = str(tmp_path / "bench.ppm")
    rc = cli.main([
        "render", "--blocks", "8", "8", "4", "--width", "16", "--height", "16",
        "-o", out, "--file", ref, "--iters", "2",
    ])
    assert rc == 0


def test_cli_encode_then_render(tmp_path):
    blob = str(tmp_path / "hist.bin")
    rc = cli.main([
        "encode", "--dims", "16", "16", "16", "--block", "4", "4", "4",
        "--bins", "32", "-o", blob,
    ])
    assert rc == 0
    out = str(tmp_path / "img.ppm")
    rc = cli.main([
        "render", "--volume", blob, "--blocks", "4", "4", "4", "--bins", "32",
        "--width", "16", "--height", "16", "-o", out,
    ])
    assert rc == 0 and os.path.exists(out)


def test_cli_fit_tf_and_resume(tmp_path):
    ck = str(tmp_path / "fit.npz")
    rc = cli.main([
        "fit-tf", "--blocks", "6", "6", "4", "--size", "12", "--steps", "20",
        "--iters", "10", "--checkpoint", ck,
    ])
    assert rc == 0 and os.path.exists(ck)
    first = load_checkpoint(ck)
    assert int(first["step"]) == 10
    rc = cli.main([
        "fit-tf", "--blocks", "6", "6", "4", "--size", "12", "--steps", "20",
        "--iters", "5", "--checkpoint", ck, "--resume", ck,
    ])
    assert rc == 0
    assert int(load_checkpoint(ck)["step"]) == 15


def test_cli_fit_tf_slice_renderer(tmp_path):
    """Object-order fit path (the fused-VJP path selects 'slice' on CPU)."""
    ck = str(tmp_path / "fit_slice.npz")
    rc = cli.main([
        "fit-tf", "--blocks", "6", "6", "4", "--size", "16",
        "--iters", "8", "--checkpoint", ck, "--renderer", "slice",
    ])
    assert rc == 0 and os.path.exists(ck)
    lut = load_checkpoint(ck)["tf_lut"]
    assert np.all(np.isfinite(lut)) and lut.shape == (9, 4)


def test_fit_voxels_cli(tmp_path):
    """BASELINE config 3 smoke: mu/sigma recovery through the renderer."""
    from vrdd_tpu.cli import main
    from vrdd_tpu.io.checkpoint import load_checkpoint

    ck = str(tmp_path / "vox.npz")
    rc = main([
        "fit-voxels", "--size", "8", "--image", "24", "--views", "2",
        "--iters", "8", "--checkpoint", ck,
    ])
    assert rc == 0
    out = load_checkpoint(ck)
    assert out["mu"].shape == (8, 8, 8)
    assert out["sigma"].shape == (8, 8, 8)
    assert float(out["loss"]) < 0.05  # decreased from the zero-init render


def test_fit_voxels_cli_streamed(tmp_path):
    """--streamed: unrotated views decode per plane-chunk inside the sweep
    (march/streaming.py); the fit still converges to the same checkpoint
    contract."""
    from vrdd_tpu.cli import main
    from vrdd_tpu.io.checkpoint import load_checkpoint

    ck = str(tmp_path / "vox_s.npz")
    rc = main([
        "fit-voxels", "--size", "8", "--image", "24", "--views", "2",
        "--iters", "8", "--checkpoint", ck, "--streamed",
    ])
    assert rc == 0
    out = load_checkpoint(ck)
    assert out["mu"].shape == (8, 8, 8)
    assert float(out["loss"]) < 0.05


def test_fit_hist_cli(tmp_path):
    """BASELINE config 4 smoke: histogram-volume recovery differentiated
    through the decode and the slice sweep."""
    from vrdd_tpu.cli import main
    from vrdd_tpu.io.checkpoint import load_checkpoint

    ck = str(tmp_path / "hist.npz")
    rc = main([
        "fit-hist", "--size", "8", "--image", "24", "--bins", "8",
        "--iters", "40", "--lr", "0.1", "--checkpoint", ck,
    ])
    assert rc == 0
    out = load_checkpoint(ck)
    assert out["hist"].shape == (8, 8, 8, 8)
    import numpy as np
    np.testing.assert_allclose(out["hist"].sum(axis=1), 1.0, atol=1e-5)
    assert float(out["loss"]) < 0.05


def test_fit_hist_cli_entropy_stat(tmp_path):
    """Inverting through a NONLINEAR observed statistic: the loss must
    decrease through the entropy decode's jacobian chain."""
    from vrdd_tpu.cli import main
    from vrdd_tpu.io.checkpoint import load_checkpoint

    ck = str(tmp_path / "hist_ent.npz")
    rc = main([
        "fit-hist", "--size", "8", "--image", "24", "--bins", "8",
        "--iters", "130", "--lr", "0.1", "--stat", "entropy",
        "--checkpoint", ck,
    ])
    assert rc == 0
    out = load_checkpoint(ck)
    import numpy as np
    np.testing.assert_allclose(out["hist"].sum(axis=1), 1.0, atol=1e-5)
    assert float(out["loss"]) < 0.05


def test_render_hist_cli(tmp_path):
    """File -> bins-major load -> decode -> render -> PPM end to end."""
    import numpy as np

    from vrdd_tpu.cli import main
    from vrdd_tpu.io.formats import read_ppm

    rng = np.random.default_rng(1)
    nz = ny = nx = 8
    B = 8
    flat = rng.random((nz * ny * nx, B)).astype(np.float32)
    flat /= flat.sum(axis=1, keepdims=True)
    hist_path = str(tmp_path / "hist.bin")
    flat.tofile(hist_path)
    out = str(tmp_path / "r.ppm")
    rc = main([
        "render-hist", "--hist-file", hist_path, "--dims", "8", "8", "8",
        "--bins", "8", "--width", "32", "--height", "32", "--density",
        "0.5", "-o", out,
    ])
    assert rc == 0
    img = read_ppm(out)
    assert img.shape == (32, 32, 3)
    assert img.max() > 0
    # nonlinear decoded statistics (reference queries 2/3) on the same file
    for stat, tscl in (("var", "8.0"), ("entropy", "1.0")):
        out_s = str(tmp_path / f"r_{stat}.ppm")
        rc = main([
            "render-hist", "--hist-file", hist_path, "--dims", "8", "8",
            "8", "--bins", "8", "--width", "32", "--height", "32",
            "--density", "0.5", "--stat", stat, "--tf-scale", tscl,
            "-o", out_s,
        ])
        assert rc == 0
        img = read_ppm(out_s)
        assert img.shape == (32, 32, 3)
        assert img.max() > 0, stat
    # rotated view (shear-warp path)
    out_r = str(tmp_path / "r_rot.ppm")
    rc = main([
        "render-hist", "--hist-file", hist_path, "--dims", "8", "8", "8",
        "--bins", "8", "--width", "32", "--height", "32", "--density",
        "0.5", "--rot-x", "25", "--rot-y", "40", "-o", out_r,
    ])
    assert rc == 0
    img = read_ppm(out_r)
    assert img.shape == (32, 32, 3)
    assert img.max() > 0
