"""chip_smoke.py: refuses a host without a GPU, and each phase's library
calls run end to end at a tiny size on the CPU (the card runs them at the
north-star sizes)."""

import json
import os
import subprocess
import sys

import jax

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu_only_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_phase_interactive_tiny():
    res = chip_smoke.phase_interactive(
        blocks=(4, 10, 10), bins=32, width=48, flex_dims=(16, 16, 16),
        flex_block=4, band=8,
    )
    assert sorted(res["queries"]) == [str(q) for q in range(10)]
    assert res["queries"]["1"]["renderer"] == "slice"
    assert res["scan_vs_numpy_band"]["outlier_frac"] <= 0.30
    assert len(res["viewer_frame_s"]) == 4
    json.dumps(res)


def test_phase_distribution_tiny(tmp_path):
    res = chip_smoke.phase_distribution(
        n=24, bins=8, width=40, small_dims=(5, 7, 9), workdir=str(tmp_path)
    )
    assert sorted(res["stats"]) == ["entropy", "mean", "var"]
    mean = res["stats"]["mean"]
    assert mean["default_vs_highest"]["outlier_frac"] <= 0.30
    assert mean["decode_vs_f64"]["max_abs"] <= mean["decode_vs_f64"]["tol"]
    assert res["render_hist_cli"]["rc"] == 0
    json.dumps(res)


def test_phase_training_tiny(tmp_path):
    res = chip_smoke.phase_training(
        n=24, bins=8, width=40, fit_size=8, fit_bins=8, fit_image=16,
        fit_iters=6, workdir=str(tmp_path),
    )
    losses = res["fit_hist_cli"]["losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert res["vjp_vs_autodiff_max_rel"] < 1e-3
    json.dumps(res)


def test_phase_four_on_virtual_mesh():
    res = chip_smoke.phase_four(jax.devices()[:4], n=16, width=32, bins=8)
    assert res["mesh"] == {"bricks": 4, "rays": 1}
    assert res["sweep"]["max_abs"] < 1e-4 and res["hist"]["max_abs"] < 1e-4
    assert res["fit_step"]["loss_rel"] < 1e-5
    json.dumps(res)
