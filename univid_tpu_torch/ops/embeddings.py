"""Timestep and 2D position embeddings (counterpart of
univid_tpu/ops/embeddings.py)."""

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


def sincos_2d(dim: int, h: int, w: int) -> np.ndarray:
    """2D sin-cos position embedding, [h*w, dim] float32 on the host: half
    for the row, half for the column, each [sin | cos] over dim // 4
    frequencies, computed in float64."""
    assert dim % 4 == 0
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64)
                               / quarter))

    def emb_1d(pos):
        out = np.einsum("m,d->md", pos.astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    emb = np.concatenate([emb_1d(gy.reshape(-1)), emb_1d(gx.reshape(-1))],
                         axis=1)
    return emb.astype(np.float32)
