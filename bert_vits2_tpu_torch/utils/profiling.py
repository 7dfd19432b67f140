"""Device traces and per-step wall-clock statistics of the training loop
(counterpart of `bert_vits2_tpu/utils/profiling.py`): `trace` and
`annotate` on `torch.profiler` where the JAX file has `jax.profiler`, and a
copy of `StepTimer` (steps/s and the realtime factor).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed block, the host's ops and, on the
    card, its kernels:

        with profiling.trace("model_dir/logs/profile"):
            step_fn(...)

    It lands in `log_dir` as a Chrome trace (`*.pt.trace.json`), which
    TensorBoard's profiler plugin and ui.perfetto.dev read."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named region inside a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock stats for the hot loop; prints steps/s and, given
    audio seconds per step, the realtime factor (audio-s per wall-s)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def steps_per_sec(self) -> float:
        m = self.mean_step_time
        return 1.0 / m if m and np.isfinite(m) and m > 0 else 0.0

    def rtf(self, audio_seconds_per_step: float) -> float:
        """North-star metric: audio seconds generated per wall second."""
        return audio_seconds_per_step * self.steps_per_sec()
