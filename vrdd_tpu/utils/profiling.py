"""Profiling helpers (jax.profiler integration) and the compile cache.

Replaces the reference's cudaEvent/StopWatch instrumentation with proper
device traces viewable in TensorBoard/Perfetto, plus the wall-clock
StageTimer (vrdd_tpu.utils.timing) for coarse stage accounting.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import jax

#: fixed in-checkout cache location used when JAX_COMPILATION_CACHE_DIR is
#: unset (listed in .gitignore). The cache key includes the directory, so a
#: fixed path is what lets a second run hit the first run's entries.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed block into ``log_dir``.

    View with ``tensorboard --logdir <log_dir>`` or load the .json.gz into
    Perfetto. Annotate hot regions inside the block with
    :func:`jax.profiler.TraceAnnotation`.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace region: ``with annotate("decode"): ...``."""
    return jax.profiler.TraceAnnotation(name)


def _merged_length(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_busy_share(trace_dir: str, window: str) -> dict:
    """Busy and idle share of each device over a traced window.

    Reads the ``.xplane.pb`` that :func:`device_trace` wrote under
    ``trace_dir``. The window is the span of the host annotation named
    ``window`` (see :func:`annotate`). A device's busy time is the union of
    the intervals of the events on its ``Stream`` lines (kernels and copies
    as the GPU tracer records them), clipped to the window. Returns
    ``{device plane name: {"busy_share", "idle_share", "window_ms",
    "lines"}}``; planes with no stream events are left out.
    """
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    ))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    w0 = w1 = None
    for plane in data.planes:
        if not plane.name.startswith("/host:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name == window:
                    w0, w1 = ev.start_ns, ev.start_ns + ev.duration_ns
    if w0 is None:
        raise ValueError(f"no host annotation {window!r} in the trace")
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        names, spans = [], []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            names.append(line.name)
            for ev in line.events:
                s = max(ev.start_ns, w0)
                e = min(ev.start_ns + ev.duration_ns, w1)
                if e > s:
                    spans.append((s, e))
        if not names:
            continue
        busy = _merged_length(spans) / (w1 - w0)
        out[plane.name] = {
            "busy_share": busy,
            "idle_share": 1.0 - busy,
            "window_ms": (w1 - w0) / 1e6,
            "lines": names,
        }
    return out


def compilation_cache_dir() -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else :data:`DEFAULT_CACHE_DIR` inside the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent on-disk compilation cache; returns its path.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads the variable
    and this function sets no other directory. Otherwise the cache goes to
    the fixed :data:`DEFAULT_CACHE_DIR`. Called by the CLI, bench and
    chip_smoke entry points; library users can call it explicitly.
    """
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
