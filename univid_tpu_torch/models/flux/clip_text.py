"""CLIP-L/14 text encoder, FLUX's pooled-prompt conditioner.

Counterpart of univid_tpu/models/flux/clip_text.py: learned token and
position embeddings, pre-norm blocks with causal self-attention and
quickGELU MLPs, a final LayerNorm; the pooled vector is the post-LN hidden
state at the EOT token, the highest id in CLIP's vocabulary, so
`argmax(ids)` finds it. The blocks are an nn.ModuleList (the JAX tree's
stacked leaves). Its head dim of 64 takes the reference attention route,
as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ...core import nn as unn
from ...kernels.attention import attention


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77


TINY_CLIP_TEXT = ClipTextConfig(vocab_size=512, hidden_size=32,
                                intermediate_size=64, num_layers=2,
                                num_heads=2, max_len=16)


class ClipText(nn.Module):
    """Every parameter of init_clip_text: token_embedding [V, d] ~
    N(0, 0.02^2), position_embedding [max_len, d] ~ N(0, 0.01^2),
    final_norm, and blocks.{i} (ln1, ln2, attn.{q,k,v,o}, mlp.fc0 / fc1:
    xavier-uniform linears, zero biases); empty when gen is None."""

    def __init__(self, cfg: ClipTextConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        kw = dict(dtype=dtype, device=device, gen=gen)

        def ln():
            return unn.Node(w=unn.param((d,), dtype, device, init="ones"),
                            b=unn.param((d,), dtype, device, init="zeros"))

        self.token_embedding = unn.param((cfg.vocab_size, d), dtype, device,
                                         gen, "normal", std=0.02)
        self.position_embedding = unn.param((cfg.max_len, d), dtype, device,
                                            gen, "normal", std=0.01)
        self.final_norm = ln()
        self.blocks = nn.ModuleList(
            unn.Node(ln1=ln(), ln2=ln(),
                     attn=unn.Node(**{nm: unn.Linear(d, d, **kw)
                                      for nm in ("q", "k", "v", "o")}),
                     mlp=unn.mlp((d, cfg.intermediate_size, d), **kw))
            for _ in range(cfg.num_layers))


def init_clip_text(gen: Optional[torch.Generator], cfg: ClipTextConfig, *,
                   dtype=torch.float32, device="cuda") -> ClipText:
    return ClipText(cfg, dtype=dtype, device=device, gen=gen)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _ln(x, p):
    return unn.layer_norm(x.float(), weight=p["w"].float(),
                          bias=p["b"].float())


@torch.no_grad()
def clip_text_encode(model: ClipText, ids: torch.Tensor,
                     compute_dtype=torch.float32):
    """ids [B, L] int -> (hidden [B, L, d], pooled [B, d]) in the compute
    dtype: causal attention; pooled = the post-LN hidden at argmax(ids)."""
    cfg = model.cfg
    b, l = ids.shape
    n = cfg.num_heads
    dh = cfg.hidden_size // n
    cd = compute_dtype
    x = (model.token_embedding[ids]
         + model.position_embedding[:l]).to(cd)
    for bp in model.blocks:
        y = _ln(x, bp.ln1).to(cd)
        q, k, v = (unn.linear(bp.attn[nm], y, compute_dtype=cd)
                   .reshape(b, l, n, dh) for nm in ("q", "k", "v"))
        a = attention(q, k, v, causal=True)
        x = x + unn.linear(bp.attn["o"], a.reshape(b, l, -1),
                           compute_dtype=cd)
        y = _ln(x, bp.ln2).to(cd)
        h = _quick_gelu(unn.linear(bp.mlp["fc0"], y, compute_dtype=cd))
        x = x + unn.linear(bp.mlp["fc1"], h, compute_dtype=cd)
    x = _ln(x, model.final_norm)
    pooled = x[torch.arange(b, device=x.device), ids.argmax(dim=-1)]
    return x.to(cd), pooled.to(cd)
