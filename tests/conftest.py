"""Test configuration: run on CPU with 8 virtual devices unless told otherwise.

Multi-chip sharding logic (mesh, halo exchange, psum) is tested on a virtual
8-device CPU mesh per SURVEY.md §4. An explicitly set ``JAX_PLATFORMS``
(for example ``cuda``) is honoured, so the same suite runs on a GPU host;
tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them where JAX finds no GPU:

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips where JAX finds none)"
    )


def pytest_report_header(config):
    return f"jax devices: {jax.devices()}"


def pytest_addoption(parser):
    parser.addoption(
        "--regen-golden",
        action="store_true",
        default=False,
        help="regenerate golden-image fixtures (tests/golden/*.ppm)",
    )


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
