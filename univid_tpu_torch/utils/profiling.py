"""Profiling hooks (counterpart of univid_tpu/utils/profiling.py).

  * PhaseTimer: wall-clock seconds per named phase. A phase ends with a
    CUDA synchronise when the work ran on a card, so device time is
    charged to the phase that queued it.
  * trace(): a torch.profiler trace (CPU and CUDA activities) exported as
    a Chrome trace under $UNIVID_PROFILE_DIR/<name> (or profile_dir);
    nothing at all when neither is set, so production runs pay nothing.
  * annotate(): torch.profiler.record_function, a named region that shows
    in such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

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


@contextlib.contextmanager
def trace(name: str = "univid", profile_dir: Optional[str] = None):
    """torch.profiler trace of the block when UNIVID_PROFILE_DIR (or
    profile_dir) is set, written as <dir>/<name>/trace.json; a no-op
    otherwise."""
    out = profile_dir or os.environ.get("UNIVID_PROFILE_DIR")
    if not out:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(out, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def annotate(name: str):
    """A named region of a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
