"""Timestep embeddings (counterpart of univid_tpu/ops/embeddings.py)."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding in fp32: sinusoid = outer(pos,
    10000^{-i/half}), output = concat([cos, sin]) (cos first)."""
    assert dim % 2 == 0
    half = dim // 2
    pos = position.float()
    inv = torch.as_tensor(
        np.power(10000.0, -np.arange(half, dtype=np.float64) / half)
        .astype(np.float32), device=pos.device)
    sinusoid = pos[..., None] * inv
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)
