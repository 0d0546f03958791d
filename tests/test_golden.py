"""Golden-image regression against stored fixtures.

The reference's only automated test is its golden-image compare
(runSingleTest, volumeRender.cpp:1016-1084: render a fixed view, compare to a
stored PPM with per-pixel epsilon 5/255 and a 30% outlier budget). These
fixtures pin our render semantics the same way ACROSS code revisions: any
change to camera math, sampling, decoding, the TF, or compositing that shifts
the image beyond the reference's own tolerance fails here.

Fixtures are generated on CPU (conftest pins the backend) by this file's
``--regen`` hook:  python -m pytest tests/test_golden.py --regen-golden
"""

import pathlib

import numpy as np
import jax.numpy as jnp
import pytest

from vrdd_tpu.core.image import rgba_to_uint8
from vrdd_tpu.io import formats
from vrdd_tpu.io.synthetic import (
    random_histogram_volume,
    synthetic_flexible_dataset,
)
from vrdd_tpu.models.flexible import FlexibleBlockVolume
from vrdd_tpu.models.pipeline import RenderPipeline
from vrdd_tpu.models.volumes import RawHistogramVolume
from vrdd_tpu.utils.config import CameraConfig, QueryMethod, RenderConfig

GOLDEN = pathlib.Path(__file__).parent / "golden"
W = H = 128


def _pipeline() -> RenderPipeline:
    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    ds = synthetic_flexible_dataset(dims=(8, 8, 8), seed=9)
    return RenderPipeline(
        raw=RawHistogramVolume(jnp.asarray(hist)),
        flexible=FlexibleBlockVolume.from_raw(
            ds["raw"], block_size=3, vmax=256.0
        ),
    )


def _render(pipeline, query, renderer) -> np.ndarray:
    from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu.utils.config import TransferFunctionConfig

    # flex mean lives in the unnormalized [0, 255] domain
    # (volumeRender_kernel.cu:1091); scale the TF like the ./, keys would
    tf_scale = 1.0 / 255.0 if QueryMethod(query) == QueryMethod.FLEX_MEAN else 1.0
    config = RenderConfig(
        camera=CameraConfig(width=W, height=H),
        density=0.5,
        query_method=QueryMethod(query),
        tf=TransferFunctionConfig(scale=tf_scale),
    )
    # shear-warp is the rotated-view path: pin a rotated camera; the others
    # use the reference's fixed benchmark view (inv_view=None)
    inv_view = (
        inv_view_from_rotation_translation(15.0, 10.0, (0.0, 0.0, -4.0))
        if renderer == "shearwarp" else None
    )
    img = pipeline.render(inv_view, config, renderer)
    return np.asarray(rgba_to_uint8(jnp.asarray(img)))


CASES = [
    ("scan_q1", 1, "scan"),
    ("scan_q3", 3, "scan"),
    ("scan_q7", 7, "scan"),
    ("slice_q1", 1, "slice"),
    ("shearwarp_q1", 1, "shearwarp"),
    ("scan_q9", 9, "scan"),
    # flexible-block query on the unrotated object-order fast path
    ("slice_q9", 9, "slice"),
    # rotated flexible-block query on the object-order fast path
    ("shearwarp_q9", 9, "shearwarp"),
]


@pytest.fixture(scope="module")
def pipeline():
    return _pipeline()


@pytest.mark.parametrize("name,query,renderer", CASES)
def test_golden(pipeline, name, query, renderer, pytestconfig):
    path = GOLDEN / f"{name}_{W}.ppm"
    img = _render(pipeline, query, renderer)
    if pytestconfig.getoption("--regen-golden"):
        GOLDEN.mkdir(exist_ok=True)
        formats.write_ppm(str(path), img)
        pytest.skip(f"regenerated {path}")
    assert path.exists(), f"missing fixture {path}; run --regen-golden"
    ref = formats.read_ppm(str(path))  # (H, W, 3): PPM drops alpha
    ok, outliers = formats.compare_ppm(img[..., :3], ref)  # reference tolerances
    assert ok, f"{name}: {outliers:.1%} pixels beyond epsilon"


@pytest.mark.parametrize("query", [1, 9])
def test_slice_tracks_scan_at_golden_tolerance(pipeline, query):
    """The slice fixtures pin the sweep's own semantics; this pins the sweep
    against the reference-faithful scan marcher with the reference's golden
    tolerance at the default density (RenderConfig, 0.05). At the
    fixtures' density 0.5 rays saturate within a few planes and the sweep's
    plane-vs-shell sampling exceeds that tolerance (~44% outliers), so the
    fixtures cannot stand in for this check."""
    from vrdd_tpu.utils.config import TransferFunctionConfig

    tf_scale = 1.0 / 255.0 if query == 9 else 1.0
    config = RenderConfig(
        camera=CameraConfig(width=W, height=H),
        density=0.05,
        query_method=QueryMethod(query),
        tf=TransferFunctionConfig(scale=tf_scale),
    )
    imgs = [
        np.asarray(rgba_to_uint8(pipeline.render(None, config, r)))[..., :3]
        for r in ("slice", "scan")
    ]
    assert imgs[1].max() > 100, "vacuous comparison: scan image is dark"
    ok, outliers = formats.compare_ppm(*imgs)
    assert ok, f"q{query}: {outliers:.1%} pixels beyond epsilon"
