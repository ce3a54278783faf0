"""XLM-Roberta CLIP text tower (open-clip XLM-Roberta-Large text side).

Counterpart of univid_tpu/models/wan/animate/clip_text.py: token, type
and position embeddings with the Roberta position ids (pad_id +
cumsum(mask) * mask), a LayerNorm after the embeddings, POST-norm
attention blocks with pad keys masked (suffix padding, so through kv_len),
masked mean pooling and a 2-layer bias-free head, every GELU the exact
erf form. No pipeline reads this tower (WanAnimate uses the visual side
only); the port has it because the JAX package exports it. Head dim 64:
attention takes the dispatcher's reference route. The stacked `layers` of
the JAX tree become a ModuleList.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ....core import nn as unn
from ....kernels.attention import attention


@dataclass(frozen=True)
class ClipTextXlmRobertaConfig:
    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    out_dim: int = 1024     # CLIP embed dim (head output)
    eps: float = 1e-5


def _norm(d, kw):
    return unn.Node(w=unn.param((d,), kw["dtype"], kw["device"], init="ones"),
                    b=unn.param((d,), kw["dtype"], kw["device"],
                                init="zeros"))


class ClipTextXlmRoberta(nn.Module):
    """Parameters of init_clip_text: the three embedding tables (normal
    0.02), embed_norm, the layers and the bias-free head; empty without
    `gen`."""

    def __init__(self, cfg: ClipTextXlmRobertaConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        mid = (cfg.dim + cfg.out_dim) // 2
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.token_embed = unn.param((cfg.vocab_size, d), dtype, device, gen,
                                     "normal", std=0.02)
        self.type_embed = unn.param((cfg.type_size, d), dtype, device, gen,
                                    "normal", std=0.02)
        self.pos_embed = unn.param((cfg.max_seq_len, d), dtype, device, gen,
                                   "normal", std=0.02)
        self.embed_norm = _norm(d, kw)
        self.head = unn.Node(
            fc0=unn.Linear(d, mid, bias=False, init="normal", **kw),
            fc1=unn.Linear(mid, cfg.out_dim, bias=False, init="normal", **kw))
        self.layers = nn.ModuleList(unn.Node(
            attn=unn.Node(**{k: unn.Linear(d, d, init="normal", **kw)
                             for k in ("q", "k", "v", "o")}),
            norm1=_norm(d, kw),
            mlp=unn.mlp((d, d * 4, d), init="normal", **kw),
            norm2=_norm(d, kw)) for _ in range(cfg.num_layers))


def init_clip_text(gen: Optional[torch.Generator],
                   cfg: ClipTextXlmRobertaConfig, *, dtype=torch.float32,
                   device="cuda") -> ClipTextXlmRoberta:
    return ClipTextXlmRoberta(cfg, dtype=dtype, device=device, gen=gen)


def _post_norm(x, p, eps, dtype):
    return unn.layer_norm(x.float(), weight=p["w"].float(),
                          bias=p["b"].float(), eps=eps).to(dtype)


def clip_text_forward(model: ClipTextXlmRoberta,
                      cfg: ClipTextXlmRobertaConfig, ids: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """ids [B, L] (pad_id-suffix-padded) -> CLIP text embedding [B,
    out_dim] fp32 (tower -> masked mean pool -> bias-free GELU head;
    unnormalised)."""
    cd = compute_dtype
    b, s = ids.shape
    mask = ids != cfg.pad_id
    m32 = mask.to(torch.int32)
    pos = cfg.pad_id + torch.cumsum(m32, dim=1) * m32
    x = (model.token_embed[ids] + model.type_embed[torch.zeros_like(ids)]
         + model.pos_embed[pos])
    x = _post_norm(x, model.embed_norm, cfg.eps, cd)
    n, dh = cfg.num_heads, cfg.dim // cfg.num_heads
    kv_len = mask.sum(dim=1).to(torch.int32)   # suffix padding
    for layer in model.layers:
        a = layer.attn
        q = unn.linear(a["q"], x, compute_dtype=cd)
        k = unn.linear(a["k"], x, compute_dtype=cd)
        v = unn.linear(a["v"], x, compute_dtype=cd)
        o = attention(q.reshape(b, s, n, dh), k.reshape(b, s, n, dh),
                      v.reshape(b, s, n, dh), kv_len=kv_len)
        o = unn.linear(a["o"], o.reshape(b, s, cfg.dim), compute_dtype=cd)
        x = _post_norm(x + o, layer.norm1, cfg.eps, cd)
        y = unn.linear(layer.mlp["fc0"], x, compute_dtype=cd)
        y = unn.linear(layer.mlp["fc1"], F.gelu(y), compute_dtype=cd)
        x = _post_norm(x + y, layer.norm2, cfg.eps, cd)
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1)
    y = F.gelu(unn.linear(model.head["fc0"], pooled, compute_dtype=cd))
    return unn.linear(model.head["fc1"], y, compute_dtype=cd).float()


def convert_clip_text_xlm_roberta(sd, cfg: ClipTextXlmRobertaConfig,
                                  dtype=torch.float32,
                                  prefix: str = "textual.", *,
                                  device="cuda") -> ClipTextXlmRoberta:
    """Reference XLMRobertaWithHead state dict (clip.py's `textual`
    submodule key layout) -> ClipTextXlmRoberta in `dtype` on `device`."""
    from ....core.checkpoint import _assemble, _Entries

    e = _Entries(sd, device)
    e.put("token_embed", f"{prefix}token_embedding.weight", dtype)
    e.put("type_embed", f"{prefix}type_embedding.weight", dtype)
    e.put("pos_embed", f"{prefix}pos_embedding.weight", dtype)
    e.norm("embed_norm", f"{prefix}norm", dtype)
    for i in range(cfg.num_layers):
        src, dst = f"{prefix}blocks.{i}", f"layers.{i}"
        for k in ("q", "k", "v", "o"):
            e.lin(f"{dst}.attn.{k}", f"{src}.attn.{k}", dtype)
        e.norm(f"{dst}.norm1", f"{src}.norm1", dtype)
        e.lin(f"{dst}.mlp.fc0", f"{src}.ffn.0", dtype)
        e.lin(f"{dst}.mlp.fc1", f"{src}.ffn.2", dtype)
        e.norm(f"{dst}.norm2", f"{src}.norm2", dtype)
    e.lin("head.fc0", f"{prefix}head.0", dtype)
    e.lin("head.fc1", f"{prefix}head.2", dtype)
    return _assemble(ClipTextXlmRoberta(cfg, dtype=dtype, device="meta"), e)
