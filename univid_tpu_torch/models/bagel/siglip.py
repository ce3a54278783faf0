"""SigLIP NaViT vision tower (packed variable-resolution ViT).

Counterpart of univid_tpu/models/bagel/siglip.py:26-161: conv-as-linear
patch embedding, flattened 2-D position ids into a learned table, pre-LN
encoder layers with full per-image attention (segment ids play the role of
cu_seqlens), a final layer norm, no CLS token or pooling. The head dim of
the so400m tower is 72 (1152 / 16), so attention takes the dispatcher's
reference route with segment masks, as on the TPU. Parameters keep the JAX
tree's names; its stacked `layers` leaves become a ModuleList.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ...core import nn as unn
from ...kernels.attention import attention
from ...ops.resize import resize_weights


@dataclass(frozen=True)
class SiglipConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    patch_size: int = 14
    num_channels: int = 3
    image_size: int = 980
    layer_norm_eps: float = 1e-6
    use_rope: bool = False

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.patch_size ** 2

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size


class Siglip(nn.Module):
    """SigLIP parameters. With `gen`, drawn on `device` as univid_tpu
    init_siglip draws them (linears normal with std 0.02 and zero biases,
    layer norms ones / zeros, pos_embed normal 0.02); without, the random
    ones are left empty for convert.siglip_from_jax."""

    def __init__(self, cfg: SiglipConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        kw = dict(init="normal", dtype=dtype, device=device, gen=gen)

        def ln():
            return unn.Node(w=unn.param((d,), dtype, device, init="ones"),
                            b=unn.param((d,), dtype, device, init="zeros"))

        self.patch_embed = unn.Linear(cfg.patch_dim, d, **kw)
        self.post_ln = ln()
        if not cfg.use_rope:
            self.pos_embed = unn.param((cfg.num_patches_per_side ** 2, d),
                                       dtype, device, gen, "normal",
                                       std=0.02)
        self.layers = nn.ModuleList([
            unn.Node(ln1=ln(),
                     attn=unn.Node(**{p: unn.Linear(d, d, **kw)
                                      for p in ("q", "k", "v", "o")}),
                     ln2=ln(),
                     mlp=unn.mlp((d, cfg.intermediate_size, d), **kw))
            for _ in range(cfg.num_layers)])


def init_siglip(gen: torch.Generator, cfg: SiglipConfig, *,
                dtype=torch.float32, device="cuda") -> Siglip:
    return Siglip(cfg, dtype=dtype, device=device, gen=gen)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] weights of jax.image.resize's 'bilinear' method along one
    axis (`ops.resize.resize_weights`)."""
    return resize_weights(in_size, out_size, device, "bilinear")


def vit_aligned_resize(image: torch.Tensor, patch: int, max_side: int
                       ) -> torch.Tensor:
    """Stride-aligned bilinear resize for the ViT path: [H, W, C] to sides
    that are multiples of `patch`, the long side clamped to max_side. The
    resample is jax.image.resize's (separable, antialiased when it
    downsamples), written out, so both packages give the same pixels."""
    h, w = image.shape[:2]
    scale = min(1.0, max_side / max(h, w))
    th = int(np.clip(round(h * scale / patch), 1, max_side // patch)) * patch
    tw = int(np.clip(round(w * scale / patch), 1, max_side // patch)) * patch
    if (th, tw) == (h, w):
        return image
    x = image.float()
    if th != h:
        x = torch.einsum("hwc,hy->ywc", x, _resize_weights(h, th, x.device))
    if tw != w:
        x = torch.einsum("ywc,wx->yxc", x, _resize_weights(w, tw, x.device))
    return x.to(image.dtype)


def image_to_patches(image: torch.Tensor, patch: int) -> torch.Tensor:
    """[H, W, C] -> [h*w, patch*patch*C] raster order, inner order (ph, pw,
    c)."""
    h, w, c = image.shape
    x = image.reshape(h // patch, patch, w // patch, patch, c)
    return x.permute(0, 2, 1, 3, 4).reshape(-1, patch * patch * c)


def siglip_forward(params: Siglip, cfg: SiglipConfig, patches: torch.Tensor,
                   pos_ids: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """patches [N, patch_dim], pos_ids [N] -> features [N, hidden].
    segment_ids [N] packs several images (a query sees its own image's
    patches only); None means one image. Position ids past the table are
    clamped to its last row, as a JAX gather clamps them."""
    n = patches.shape[0]
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    cd = compute_dtype
    x = unn.linear(params.patch_embed, patches.to(cd), compute_dtype=cd)
    if not cfg.use_rope:
        table = params.pos_embed
        x = x + table[pos_ids.clamp(0, table.shape[0] - 1)].to(cd)
    segs = segment_ids[None] if segment_ids is not None else None

    def norm(h, p):
        return unn.layer_norm(h, weight=p.w.to(h.dtype), bias=p.b.to(h.dtype),
                              eps=cfg.layer_norm_eps)

    for layer in params.layers:
        a = layer.attn
        y = norm(x, layer.ln1)
        q, k, v = (unn.linear(a[p], y, compute_dtype=cd).reshape(1, n, nh, hd)
                   for p in ("q", "k", "v"))
        o = attention(q, k, v, q_segments=segs, kv_segments=segs)
        x = x + unn.linear(a.o, o.reshape(n, cfg.hidden_size),
                           compute_dtype=cd)
        y = norm(x, layer.ln2)
        y = unn.linear(layer.mlp.fc0, y, compute_dtype=cd)
        y = unn.gelu_tanh(y)
        x = x + unn.linear(layer.mlp.fc1, y, compute_dtype=cd)
    return norm(x, params.post_ln)
