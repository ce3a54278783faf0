"""CLIP ViT-H/14 visual tower (the open-clip XLM-Roberta-CLIP image side).

Counterpart of univid_tpu/models/wan/animate/clip_vit.py: WanAnimate reads
only the visual tower, which resizes the reference frame to 224x224
(jax.image.resize 'bicubic': Keys' cubic, a = -0.5, antialiased when it
downsamples; `ops.resize`), normalises it with the CLIP mean / std and
runs the pre-norm VisionTransformer through 31 of its 32 blocks (cls + 256
patch tokens, exact GELU), returning the 257 x 1280 hidden states with no
final norm or head. Head dim 80, so attention takes the dispatcher's
reference route, as on the TPU. Computed in fp32 by default (the JAX
package's compute_dtype) whatever the weights' dtype. The stacked `layers`
leaves of the JAX tree become a ModuleList.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ....core import nn as unn
from ....kernels.attention import attention
from ....ops.resize import resize

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32          # use_31_block runs num_layers - 1
    norm_eps: float = 1e-5
    activation: str = "gelu"


def _norm(d, kw):
    return unn.Node(w=unn.param((d,), kw["dtype"], kw["device"], init="ones"),
                    b=unn.param((d,), kw["dtype"], kw["device"],
                                init="zeros"))


class ClipVision(nn.Module):
    """Parameters of init_clip_vision: patch_embed (no bias), cls,
    pos_embed, pre_norm and the layers. With `gen`, drawn as the JAX init
    (normal(0.02) linears, gain 1/sqrt(d) for cls and pos_embed); empty
    without."""

    def __init__(self, cfg: ClipVisionConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        kw = dict(dtype=dtype, device=device, gen=gen)
        gain = d ** -0.5
        self.patch_embed = unn.Linear(cfg.patch_size ** 2 * 3, d, bias=False,
                                      init="normal", **kw)
        self.cls = unn.param((1, d), dtype, device, gen, "normal", std=gain)
        self.pos_embed = unn.param((n_patches + 1, d), dtype, device, gen,
                                   "normal", std=gain)
        self.pre_norm = _norm(d, kw)
        mid = int(d * cfg.mlp_ratio)
        self.layers = nn.ModuleList(unn.Node(
            ln1=_norm(d, kw),
            attn=unn.Node(**{k: unn.Linear(d, d, init="normal", **kw)
                             for k in ("q", "k", "v", "o")}),
            ln2=_norm(d, kw),
            mlp=unn.mlp((d, mid, d), init="normal", **kw))
            for _ in range(cfg.num_layers))


def init_clip_vision(gen: Optional[torch.Generator], cfg: ClipVisionConfig,
                     *, dtype=torch.float32, device="cuda") -> ClipVision:
    return ClipVision(cfg, dtype=dtype, device=device, gen=gen)


def clip_preprocess(frame: torch.Tensor, cfg: ClipVisionConfig
                    ) -> torch.Tensor:
    """[H, W, 3] in [-1, 1] -> [S, S, 3] CLIP-normalised (fp32)."""
    img = resize(frame.float(), (cfg.image_size, cfg.image_size, 3),
                 "bicubic")
    img = img * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, device=img.device)
    std = torch.tensor(CLIP_STD, device=img.device)
    return (img - mean) / std


def clip_visual_forward(model: ClipVision, cfg: ClipVisionConfig,
                        image: torch.Tensor, use_31_block: bool = True,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """image [S, S, 3] (CLIP-normalised) -> tokens [257, dim]."""
    cd = compute_dtype
    p = cfg.patch_size
    s = cfg.image_size // p
    x = image.reshape(s, p, s, p, 3).permute(0, 2, 1, 3, 4) \
        .reshape(s * s, p * p * 3)
    x = unn.linear(model.patch_embed, x.to(cd), compute_dtype=cd)
    x = torch.cat([model.cls.to(cd), x], dim=0)
    x = x + model.pos_embed.to(cd)
    x = unn.layer_norm(x, weight=model.pre_norm["w"].to(x.dtype),
                       bias=model.pre_norm["b"].to(x.dtype),
                       eps=cfg.norm_eps)
    l = x.shape[0]
    nh = cfg.num_heads
    hd = cfg.dim // nh
    n_run = cfg.num_layers - 1 if use_31_block else cfg.num_layers
    for layer in model.layers[:n_run]:
        y = unn.layer_norm(x, weight=layer.ln1["w"].to(x.dtype),
                           bias=layer.ln1["b"].to(x.dtype), eps=cfg.norm_eps)
        a = layer.attn
        q = unn.linear(a["q"], y, compute_dtype=cd)
        k = unn.linear(a["k"], y, compute_dtype=cd)
        v = unn.linear(a["v"], y, compute_dtype=cd)
        o = attention(q.reshape(1, l, nh, hd), k.reshape(1, l, nh, hd),
                      v.reshape(1, l, nh, hd)).reshape(l, cfg.dim)
        x = x + unn.linear(a["o"], o, compute_dtype=cd)
        y = unn.layer_norm(x, weight=layer.ln2["w"].to(x.dtype),
                           bias=layer.ln2["b"].to(x.dtype), eps=cfg.norm_eps)
        y = unn.linear(layer.mlp["fc0"], y, compute_dtype=cd)
        y = F.gelu(y) if cfg.activation == "gelu" \
            else y * torch.sigmoid(1.702 * y)
        x = x + unn.linear(layer.mlp["fc1"], y, compute_dtype=cd)
    return x
