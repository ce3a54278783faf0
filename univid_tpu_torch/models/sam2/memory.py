"""SAM2 memory subsystem: memory encoder + RoPE memory attention
(counterpart of univid_tpu/models/sam2/memory.py).

  * memory encoder: fuses the current frame's stride-16 image feature
    with its predicted mask (sigmoid-scaled 20x - 10, or binarized on
    clicked frames) into a compact 64-d memory map: the strided mask
    downsampler (4x conv / LN / exact GELU, total stride 16), two
    ConvNeXt-style CX blocks (7x7 depthwise conv), a 1x1 out projection.
  * memory attention: 4 pre-norm layers; self-attention over the current
    frame's tokens and cross-attention into the concatenated memory bank,
    both with 2D axial RoPE over the feature grid (theta 10000, x
    frequencies then y); k positions repeat the grid once a memory frame,
    the trailing object-pointer tokens are excluded from rotary
    (num_k_exclude_rope), and a key mask (-1e9) hides invalid slots of
    the fixed-capacity bank. pos_enc_at_input with the 0.1x residual.

Pinned from the published SAM2.1-L configuration: d_model 256, 1 head,
dim_feedforward 2048, ReLU, memory dim 64. The attention is a plain
product with an fp32 softmax, as in JAX: one head of d = 256 over up to
57,436 memory keys at 1024x1024.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import nn as unn
from .hiera import Init, conv2d, layer_norm, sine_pos_encoding
from .sam_heads import attn_params


@dataclass(frozen=True)
class MemoryConfig:
    d_model: int = 256
    mem_dim: int = 64
    num_layers: int = 4
    num_heads: int = 1
    dim_feedforward: int = 2048
    rope_theta: float = 10000.0
    feat_size: int = 64                  # memory grid side
    mask_downsample_layers: int = 4      # total stride 16
    fuser_layers: int = 2
    sigmoid_scale: float = 20.0
    sigmoid_bias: float = -10.0


def _ln(p, x):
    return layer_norm(p, x, 1e-5)


# ---------------------------------------------------------------- encoder

def init_memory_encoder(cfg: MemoryConfig, mk: Init) -> unn.Node:
    d = cfg.d_model
    downs, cin = [], 1
    for _ in range(cfg.mask_downsample_layers):
        cout = cin * 4                  # stride^2 channel growth
        downs.append(unn.Node(conv=mk.conv(3, 3, cin, cout),
                              ln=mk.ln(cout)))
        cin = cout
    # CXBlock: 7x7 depthwise conv, LN, pw 4x expand, GELU, pw project,
    # 1e-6 layer scale, residual
    fuser = [unn.Node(dwconv=mk.conv(7, 7, 1, d), norm=mk.ln(d),
                      pwconv1=mk.linear(d, 4 * d),
                      pwconv2=mk.linear(4 * d, d),
                      gamma=mk.full((d,), 1e-6))
             for _ in range(cfg.fuser_layers)]
    return unn.Node(mask_down=nn.ModuleList(downs),
                    mask_down_final=mk.conv(1, 1, cin, d),
                    pix_feat_proj=mk.conv(1, 1, d, d),
                    fuser=nn.ModuleList(fuser),
                    out_proj=mk.conv(1, 1, d, cfg.mem_dim))


def _cx_block(p, x):
    inp = x
    x = conv2d(x, p.dwconv, padding=3, groups=x.shape[-1])
    x = _ln(p.norm, x)
    x = unn.linear(p.pwconv1, x)
    x = F.gelu(x)
    x = unn.linear(p.pwconv2, x)
    return inp + p.gamma.to(x.dtype) * x


def memory_encoder_forward(p, cfg: MemoryConfig, pix_feat, mask_logits, *,
                           binarize: bool):
    """pix_feat [B, g, g, d] (stride-16 image feature), mask_logits
    [B, G, G, 1] at input-image resolution. Returns (mem [B, g, g, 64],
    mem_pos [g, g, 64])."""
    if binarize:
        m = (mask_logits > 0).to(pix_feat.dtype)
    else:
        m = torch.sigmoid(mask_logits).to(pix_feat.dtype)
    m = m * cfg.sigmoid_scale + cfg.sigmoid_bias
    for layer in p.mask_down:
        m = conv2d(m, layer.conv, stride=2, padding=1)
        m = F.gelu(_ln(layer.ln, m))
    m = conv2d(m, p.mask_down_final)
    x = conv2d(pix_feat, p.pix_feat_proj) + m
    for blk in p.fuser:
        x = _cx_block(blk, x)
    x = conv2d(x, p.out_proj)
    pos = sine_pos_encoding(x.shape[1], x.shape[2], cfg.mem_dim, x.device,
                            x.dtype)
    return x, pos


# ----------------------------------------------------------- rope attn

def axial_rope_freqs(cfg: MemoryConfig, head_dim: int, device):
    """(cos, sin), each [g*g, head_dim/2] fp32: the published
    compute_axial_cis rotations (first half x-axis, second half y-axis
    frequencies), from float64 angles as the JAX package's complex64
    table."""
    g = cfg.feat_size
    quarter = head_dim // 4
    freqs = 1.0 / (cfg.rope_theta **
                   (np.arange(0, head_dim, 4)[:quarter] / head_dim))
    idx = np.arange(g * g)
    ang = np.concatenate([np.outer(idx % g, freqs),
                          np.outer(idx // g, freqs)], axis=-1)
    rot = np.exp(1j * ang).astype(np.complex64)
    return (torch.from_numpy(rot.real.copy()).to(device),
            torch.from_numpy(rot.imag.copy()).to(device))


def apply_rope(x, freqs):
    """x [B, H, N, hd] with N a whole number of freqs' g*g rows (the grid
    repeats once a memory frame): pairs (x0, x1) rotated as the complex
    product (x0 + i x1)(cos + i sin), in fp32."""
    cos, sin = freqs
    b, h, n, hd = x.shape
    xc = x.float().reshape(b, h, n, hd // 2, 2)
    x0, x1 = xc[..., 0], xc[..., 1]
    reps = n // cos.shape[0]
    if reps != 1:
        cos, sin = cos.repeat(reps, 1), sin.repeat(reps, 1)
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(b, h, n, hd).to(x.dtype)


def rope_attn(p, cfg: MemoryConfig, freqs, q, k, v, *,
              num_k_exclude_rope: int = 0, key_mask=None,
              compute_dtype=None):
    """RoPEAttention: rotary on q and on all k except the trailing
    `num_k_exclude_rope` tokens (object pointers); `key_mask` [K] bool
    hides the invalid slots of the fixed-capacity bank (-1e9 scores)."""
    q = unn.linear(p.q, q, compute_dtype=compute_dtype)
    k = unn.linear(p.k, k, compute_dtype=compute_dtype)
    v = unn.linear(p.v, v, compute_dtype=compute_dtype)
    b, nq, c = q.shape
    nk = k.shape[1]
    heads = cfg.num_heads
    hd = c // heads
    qh = apply_rope(q.reshape(b, nq, heads, hd).transpose(1, 2), freqs)
    kh = k.reshape(b, nk, heads, hd).transpose(1, 2)
    vh = v.reshape(b, nk, heads, hd).transpose(1, 2)
    n_rot = nk - num_k_exclude_rope
    if num_k_exclude_rope > 0:
        kh = torch.cat([apply_rope(kh[:, :, :n_rot], freqs),
                        kh[:, :, n_rot:]], dim=2)
    else:
        kh = apply_rope(kh, freqs)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(hd)
    if key_mask is not None:
        logits = torch.where(key_mask[None, None, None, :], logits, -1e9)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(vh.dtype), vh)
    out = out.transpose(1, 2).reshape(b, nq, c)
    return unn.linear(p.o, out, compute_dtype=compute_dtype)


def init_memory_attention(cfg: MemoryConfig, mk: Init) -> unn.Node:
    d = cfg.d_model
    layers = [unn.Node(
        self_attn=attn_params(mk, d, d),
        cross_attn=attn_params(mk, d, d, kv_in=cfg.mem_dim),
        linear1=mk.linear(d, cfg.dim_feedforward),
        linear2=mk.linear(cfg.dim_feedforward, d),
        norm1=mk.ln(d), norm2=mk.ln(d), norm3=mk.ln(d))
        for _ in range(cfg.num_layers)]
    return unn.Node(layers=nn.ModuleList(layers), norm=mk.ln(d))


def memory_attention_forward(p, cfg: MemoryConfig, curr, curr_pos, memory,
                             memory_pos, *, num_obj_ptr_tokens: int = 0,
                             key_mask=None, compute_dtype=None):
    """curr [B, g*g, d] stride-16 tokens + sine positions; memory
    [B, M, mem_dim] concatenated maskmem tokens (+ trailing
    object-pointer tokens); returns conditioned [B, g*g, d]."""
    freqs = axial_rope_freqs(cfg, cfg.d_model // cfg.num_heads,
                             curr.device)
    x = curr + 0.1 * curr_pos            # pos_enc_at_input
    for layer in p.layers:
        y = _ln(layer.norm1, x)
        x = x + rope_attn(layer.self_attn, cfg, freqs, y, y, y,
                          compute_dtype=compute_dtype)
        y = _ln(layer.norm2, x)
        x = x + rope_attn(layer.cross_attn, cfg, freqs, y,
                          memory + memory_pos, memory,
                          num_k_exclude_rope=num_obj_ptr_tokens,
                          key_mask=key_mask, compute_dtype=compute_dtype)
        y = _ln(layer.norm3, x)
        y = unn.linear(layer.linear2, F.relu(
            unn.linear(layer.linear1, y, compute_dtype=compute_dtype)),
            compute_dtype=compute_dtype)
        x = x + y
    return _ln(p.norm, x)
