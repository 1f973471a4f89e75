"""Profiling and step-timing observability.

The reference had no tracing at all (SURVEY.md §5 — only wandb GPU-memory
numbers). Here: ``jax.profiler`` trace capture around training steps plus a
lightweight step timer whose summaries go to the logger/wandb, switchable
from the training config (``training_config.profile_dir``) and the trainer.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace into ``profile_dir`` (TensorBoard
    format); no-op when dir is None."""
    if not profile_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(profile_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("Profiler trace written to %s", profile_dir)


class StepTimer:
    """Rolling step-time / throughput statistics."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def stats(self, tokens_per_step: Optional[int] = None) -> Dict[str, float]:
        if not self.times:
            return {}
        times = sorted(self.times)
        mean = sum(times) / len(times)
        out = {
            "step_time_mean_s": mean,
            "step_time_p50_s": times[len(times) // 2],
            "step_time_p90_s": times[int(len(times) * 0.9)],
        }
        if tokens_per_step:
            out["tokens_per_sec"] = tokens_per_step / mean
        return out


# Dense bf16 tensor-core peaks (TFLOP/s) keyed by a substring of
# ``jax.devices()[0].device_kind``. Source: NVIDIA's H100 data sheet (SXM
# part, dense, at the 700 W power limit).
_PEAK_TFLOPS_BF16 = (
    ("h100", 989.0),
)


def device_peak_tflops(device_kind: Optional[str] = None) -> Optional[float]:
    """bf16 peak of the local accelerator, for MFU accounting.

    ``APERTIS_PEAK_TFLOPS`` overrides (any backend, incl. CPU test runs);
    returns None when the device kind is not in the table — callers then
    skip MFU rather than report one against a made-up peak.
    """
    import os

    env = os.environ.get("APERTIS_PEAK_TFLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            logger.warning("Unparseable APERTIS_PEAK_TFLOPS=%r", env)
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    kind = device_kind.lower()
    for needle, peak in _PEAK_TFLOPS_BF16:
        if needle in kind:
            return peak
    return None


def annotate(name: str):
    """Named profiler span (shows up in traces)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
