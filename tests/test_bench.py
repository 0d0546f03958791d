"""bench.py's device rules: the peaks table keyed by device kind, the
roofline share, and the refusal to measure without a GPU."""

import jax
import pytest

import bench


def test_h100_peaks_found():
    p = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_gbps"] == 3350.0 and p["bf16_tflops"] == 989.0
    assert p["tf32_tflops"] == 495.0 and "data sheet" in p["source"]


def test_unknown_device_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("Unknown Accelerator 9000")
    with pytest.raises(ValueError):
        bench.device_peaks(jax.devices()[0].device_kind)


def test_roofline_names_its_bound():
    p = bench.device_peaks("NVIDIA H100 80GB HBM3")
    # 3.35 GB at 3.35 TB/s is 1 ms; 1 TFLOP at 495 TFLOP/s is ~2 ms
    mem = bench.roofline(1e9, 3.35e9, 2e-3, p)
    assert mem["bound"] == "memory" and mem["share"] == pytest.approx(0.5)
    cmp = bench.roofline(1e12, 3.35e9, 4.04e-3, p)
    assert cmp["bound"] == "compute"
    assert cmp["share"] == pytest.approx(1e12 / 495e12 / 4.04e-3)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.require_gpu()
