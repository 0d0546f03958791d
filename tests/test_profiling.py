"""The compile-cache location rule and the trace-to-idle-share reduction
(vrdd_tpu/utils/profiling.py)."""

import os

import jax
import jax.numpy as jnp
import pytest

from vrdd_tpu.utils import profiling


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_dir_honours_env(monkeypatch, tmp_path, restore_cache_config):
    """JAX_COMPILATION_CACHE_DIR set: that directory is the cache, and the
    function sets no other directory in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert profiling.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    assert profiling.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_inside_checkout(monkeypatch,
                                            restore_cache_config):
    """Unset: one fixed directory inside the checkout (never ~/.cache)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = profiling.enable_compilation_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_merged_length_unions_overlaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 40)]
    assert profiling._merged_length(spans) == 12 + 10
    assert profiling._merged_length([]) == 0.0


def test_busy_share_reads_a_recorded_trace(tmp_path):
    """A real trace: the window annotation is found on the host plane; the
    CPU backend records no device Stream lines, so no device is reported,
    and a missing annotation is an error."""
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("test_window"):
            f(x).block_until_ready()
    assert profiling.device_busy_share(str(tmp_path), "test_window") == {}
    with pytest.raises(ValueError):
        profiling.device_busy_share(str(tmp_path), "no_such_window")
