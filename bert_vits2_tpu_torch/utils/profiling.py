"""Per-step wall-clock statistics of the training loop: steps/s and the
realtime factor. A copy of `StepTimer` from
`bert_vits2_tpu/utils/profiling.py`.
"""

from __future__ import annotations

import time

import numpy as np


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
