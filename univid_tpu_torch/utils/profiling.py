"""Per-phase wall-clock timing (counterpart of univid_tpu/utils/profiling.py
PhaseTimer). A phase ends with a CUDA synchronise when the work ran on a
card, so device time is charged to the phase that queued it."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


def device_sync() -> None:
    """Wait for queued CUDA work (a no-op on CPU-only runs)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        device_sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device_sync()
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def time_phase(self, name: str, fn, *args, **kwargs):
        """Run fn, synchronise, charge the time to `name`."""
        with self.phase(name):
            return fn(*args, **kwargs)

    def summary(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.totals.items()}
