"""Temperature Modality Alignment (TMA) — dynamic text weight scheduling.

Counterpart of univid_tpu/ops/tma.py: a per-sampling-step scalar weight,
precomputed on the host, multiplies the text prefix of the cross-attention
context before each DiT call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import TMAConfig


def tma_schedule_weights(cfg: TMAConfig, total_steps: int) -> np.ndarray:
    """Per-step text weights [total_steps] float32 (1.3 -> 1.0 cosine over
    the first 40% of steps by default)."""
    if not cfg.enabled:
        return np.ones(total_steps, dtype=np.float32)
    transition = int(total_steps * cfg.transition_ratio)
    out = np.full(total_steps, cfg.weight_min, dtype=np.float64)
    for step in range(min(transition, total_steps)):
        progress = step / max(transition, 1)
        if cfg.schedule == "linear":
            w = cfg.weight_max - (cfg.weight_max - cfg.weight_min) * progress
        elif cfg.schedule == "cosine":
            cos_f = (1.0 + math.cos(math.pi * progress)) / 2.0
            w = cfg.weight_min + (cfg.weight_max - cfg.weight_min) * cos_f
        elif cfg.schedule == "exponential":
            exp_f = math.exp(-5.0 * progress)
            w = cfg.weight_min + (cfg.weight_max - cfg.weight_min) * exp_f
        else:
            w = 1.0
        out[step] = w
    return out.astype(np.float32)


def apply_text_weight(context: torch.Tensor, weight,
                      text_prefix_len: int) -> torch.Tensor:
    """Scale the first `text_prefix_len` context tokens by `weight` (cast to
    the context's dtype first)."""
    if text_prefix_len <= 0:
        return context
    prefix = min(text_prefix_len, context.shape[-2])
    weight = torch.as_tensor(weight, dtype=context.dtype,
                             device=context.device)
    head = context[..., :prefix, :] * weight
    return torch.cat([head, context[..., prefix:, :]], dim=-2)
