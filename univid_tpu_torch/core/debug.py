"""Debug flags of the port's CLIs (counterpart of univid_tpu/core/debug.py).

The same three env knobs, applied by every CLI through apply_debug_flags
at the top of `main`, mapped onto an eager PyTorch program:
  UNIVID_DEBUG_NANS=1   torch.autograd.set_detect_anomaly(True,
                        check_nan=True): a backward op that returns a NaN
                        raises, with the forward op's traceback
  UNIVID_DISABLE_JIT=1  nothing: the port runs eagerly, there is no jit to
                        bypass (not reported as applied)
  UNIVID_LOG_COMPILES=1 log each CUDA extension build of kernels/build.py
                        (its `univid_tpu_torch.kernels.build` logger at
                        INFO, to stderr)
With no variable set nothing changes.
"""

from __future__ import annotations

import logging
import os

BUILD_LOGGER = "univid_tpu_torch.kernels.build"


def apply_debug_flags(env=None) -> dict:
    """Apply the UNIVID_* debug env knobs; returns the flags applied (for
    logging / metadata)."""
    env = os.environ if env is None else env

    def on(var):
        return env.get(var, "0") not in ("0", "")

    applied = {}
    if on("UNIVID_DEBUG_NANS"):
        import torch
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        applied["detect_anomaly_check_nan"] = True
    if on("UNIVID_LOG_COMPILES"):
        logger = logging.getLogger(BUILD_LOGGER)
        logger.setLevel(logging.INFO)
        if not logger.handlers:
            logger.addHandler(logging.StreamHandler())
        applied["log_kernel_builds"] = True
    return applied
