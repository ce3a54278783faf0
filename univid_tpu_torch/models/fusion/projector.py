"""ContextProjector: the trained adapter bridging BAGEL -> Wan.

Counterpart of univid_tpu/models/fusion/projector.py (reference
model_pipeline.py:1506-1622): Linear(3584 -> 8192) -> LayerNorm -> GELU ->
Dropout -> Linear(8192 -> 4096) -> LayerNorm, then 1-D linear
interpolation of the token axis to wan_text_length (512), and the
semantic-alignment training loss (cosine similarity of mean-pooled
features against T5 supervision + L2 + diversity). Parameters keep the JAX
tree's names (fc0, ln0, fc1, ln1 with w / b) in PyTorch's layouts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import nn as unn
from ...core.config import FusionConfig


class ContextProjector(nn.Module):
    """Parameters of the projector, trainable (requires_grad). With `gen`,
    drawn on `device` as univid_tpu init_context_projector draws them
    (xavier-uniform linears, zero biases, unit LayerNorm gains); without,
    left empty for convert.projector_from_jax."""

    def __init__(self, cfg: FusionConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        hidden = cfg.wan_text_dim * cfg.projector_hidden_mult
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.fc0 = unn.Linear(cfg.bagel_hidden_dim, hidden, **kw)
        self.ln0 = unn.Node(w=unn.param((hidden,), dtype, device, init="ones"),
                            b=unn.param((hidden,), dtype, device,
                                        init="zeros"))
        self.fc1 = unn.Linear(hidden, cfg.wan_text_dim, **kw)
        self.ln1 = unn.Node(
            w=unn.param((cfg.wan_text_dim,), dtype, device, init="ones"),
            b=unn.param((cfg.wan_text_dim,), dtype, device, init="zeros"))
        self.requires_grad_(True)


def init_context_projector(gen: torch.Generator, cfg: FusionConfig, *,
                           dtype=torch.float32, device="cuda"
                           ) -> ContextProjector:
    return ContextProjector(cfg, dtype=dtype, device=device, gen=gen)


def adapt_sequence_length(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """1-D linear interpolation along the token axis, as
    F.interpolate(mode='linear', align_corners=False). x: [..., L, D]."""
    src = x.shape[-2]
    if src == target_len:
        return x
    # sample positions: centers map (i + 0.5) * src/tgt - 0.5
    pos = (torch.arange(target_len, dtype=torch.float32, device=x.device)
           + 0.5) * (src / target_len) - 0.5
    pos = pos.clamp(0.0, src - 1.0)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=src - 1)
    frac = (pos - lo)[:, None].to(x.dtype)
    return x[..., lo, :] * (1.0 - frac) + x[..., hi, :] * frac


def context_projector_forward(params: ContextProjector, cfg: FusionConfig,
                              bagel_tokens: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """[B, L, 3584] BAGEL hidden states -> [B, 512, 4096] Wan context.
    Dropout runs only when a generator is given (the JAX package's
    dropout_rng)."""
    x = bagel_tokens.to(compute_dtype)
    x = unn.linear(params.fc0, x, compute_dtype=compute_dtype)
    x = unn.layer_norm(x, weight=params.ln0.w.to(compute_dtype),
                       bias=params.ln0.b.to(compute_dtype), eps=1e-5)
    x = F.gelu(x)
    if generator is not None and cfg.projector_dropout > 0:
        keep = 1.0 - cfg.projector_dropout
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        x = torch.where(mask, x / keep, 0.0)
    x = unn.linear(params.fc1, x, compute_dtype=compute_dtype)
    x = unn.layer_norm(x, weight=params.ln1.w.to(compute_dtype),
                       bias=params.ln1.b.to(compute_dtype), eps=1e-5)
    return adapt_sequence_length(x, cfg.wan_text_length)


def projector_training_loss(params: ContextProjector, cfg: FusionConfig,
                            bagel_tokens: torch.Tensor,
                            supervision: torch.Tensor, *, generator=None
                            ) -> Dict[str, torch.Tensor]:
    """Semantic-alignment loss (model_pipeline.py:1576-1622):
    bagel_tokens [B, L, 3584], supervision [B, Ls, 4096]."""
    projected = context_projector_forward(params, cfg, bagel_tokens,
                                          generator=generator)
    if supervision.shape[-2] != projected.shape[-2]:
        supervision = adapt_sequence_length(supervision,
                                            projected.shape[-2])
    if cfg.use_cosine_similarity_loss:
        p_mean = projected.mean(dim=-2)
        s_mean = supervision.mean(dim=-2)
        cos = (p_mean * s_mean).sum(-1) / (
            torch.linalg.vector_norm(p_mean, dim=-1)
            * torch.linalg.vector_norm(s_mean, dim=-1) + 1e-8)
        semantic = (1.0 - cos).mean()
    else:
        semantic = (projected - supervision).square().mean()
    semantic = semantic.clamp(0.0, 10.0)

    l2_reg = projected.square().sum() * 1e-6 / projected.shape[0]
    feature_std = projected.std(dim=-2, correction=0).mean()
    diversity = torch.exp(-feature_std * 10.0)

    total = semantic + l2_reg + diversity * 0.1
    return {"total_loss": total, "semantic_loss": semantic,
            "l2_reg": l2_reg, "diversity_loss": diversity,
            "feature_std": feature_std}
