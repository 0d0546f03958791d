"""Per-stage wall timing + structured metric logging.

Replacement for the reference's cudaEvent per-kernel timers and
printf banners (volumeRender_kernel.cu:1739-1783, volumeRender.cpp:174-191).
Stages block on device results (``block_until_ready``) so timings are honest.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Any, Dict, Iterator, Optional

import jax

logger = logging.getLogger("vrdd_tpu")


def _block(x: Any) -> None:
    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


class StageTimer:
    """Collects named stage durations; drop-in for the flex-pipeline profiler."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result: Optional[Any] = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    def time(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and block on its output, recording wall time under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block(out)
        self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)
        return out

    def report(self) -> str:
        return "\n".join(f"{k}: {v * 1e3:.3f} ms" for k, v in self.stages.items())

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)


def log_metrics(metrics: Dict[str, Any], *, name: str = "metrics") -> None:
    """Structured one-line JSON metric logging (replaces raw printf)."""
    logger.info("%s %s", name, json.dumps(metrics, default=float))
