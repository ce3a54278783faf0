"""TaylorSeer step caching (counterpart of univid_tpu/ops/taylorseer.py).

The schedule (`taylorseer_schedule`, a numpy copy of the JAX package's):
a step is full while step < first_enhance (5) or every fresh_threshold-th
step after; otherwise it is a Taylor step. Full steps run the model and
refresh a fixed-slot factor stack [max_order + 1, ...]: factor[0] = the
feature, factor[i + 1] = (new[i] - old[i]) / dd, dd the distance between
the last two full steps; higher orders start once step > first_enhance - 2
and grow by one a full step up to max_order (6). Taylor steps skip the
model and extrapolate sum_i factor[i] * x^i / i!, x = step - last full
step. The Wan denoise loop (pipelines/ti2v.py) caches the batch-2 CFG
velocity this way. The schedule is host bookkeeping, so the loop decides
on the host which steps run the DiT.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass(frozen=True)
class TaylorSeerConfig:
    fresh_threshold: int = 3
    first_enhance: int = 5
    max_order: int = 6


def taylorseer_schedule(num_steps: int, cfg: TaylorSeerConfig
                        ) -> Dict[str, np.ndarray]:
    """Per-step arrays: is_full (1.0 on full steps), dd (activated-step
    distance for the derivative update), x (step - last activated, the
    expansion distance), n_upd (derivative orders updated this full step),
    n_stored (factors valid when predicting at this step)."""
    is_full = np.zeros(num_steps, np.float32)
    dd = np.zeros(num_steps, np.float32)
    x = np.zeros(num_steps, np.float32)
    n_upd = np.zeros(num_steps, np.int32)
    n_stored = np.zeros(num_steps, np.int32)

    counter = 0
    activated = [0]
    stored = 0
    for step in range(num_steps):
        first = step < cfg.first_enhance
        full = first or counter == cfg.fresh_threshold - 1
        if full:
            is_full[step] = 1.0
            counter = 0
            activated.append(step)
            dd[step] = activated[-1] - activated[-2]
            if step == 0:
                stored = 0  # the cache is cleared at step 0
            upd = min(stored, cfg.max_order) if step > cfg.first_enhance - 2 \
                else 0
            n_upd[step] = upd
            stored = upd + 1
        else:
            counter += 1
            x[step] = step - activated[-1]
        n_stored[step] = stored
    return {"is_full": is_full, "dd": dd, "x": x, "n_upd": n_upd,
            "n_stored": n_stored}


def init_taylor_cache(feature_shape, max_order: int = 6,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The zeroed factor stack [max_order + 1, *feature_shape]."""
    return torch.zeros((max_order + 1,) + tuple(feature_shape), dtype=dtype,
                       device=device)


def taylor_update(factors: torch.Tensor, feature: torch.Tensor, dd: float,
                  n_upd: int) -> torch.Tensor:
    """The full-step refresh: a new stack whose first n_upd + 1 factors are
    the feature and its divided differences against the old stack, in the
    stack's dtype; the rest zero. dd <= 0 divides by 1."""
    safe_dd = float(dd) if dd > 0 else 1.0
    new = torch.zeros_like(factors)
    new[0] = feature.to(factors.dtype)
    for i in range(min(int(n_upd), factors.shape[0] - 1)):
        new[i + 1] = (new[i] - factors[i]) / safe_dd
    return new


def taylor_predict(factors: torch.Tensor, x: float,
                   n_stored: int) -> torch.Tensor:
    """The Taylor extrapolation sum_{i < n_stored} factor[i] * x^i / i!."""
    out = torch.zeros_like(factors[0])
    for i in range(min(int(n_stored), factors.shape[0])):
        out = out + factors[i] * (float(x) ** i) / math.factorial(i)
    return out
