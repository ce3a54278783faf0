"""Face conditioning blocks of WanAnimate.

Counterpart of univid_tpu/models/wan/animate/face_blocks.py:
  * FaceEncoder: per-frame motion vectors [B, T, 512] through a causal
    Conv1d pyramid (k = 3, left replicate padding of k - 1; strides 1, 2,
    2, so T frames give ceil(T / 4) rows: 77 -> 20), affine-free
    LayerNorms + SiLU, a linear out_proj to the DiT width, the heads
    folded back as a token axis, plus one learned padding token ->
    [B, T_lat, heads + 1, dim].
  * FaceBlock: the video tokens of latent frame j attend that frame's
    motion tokens (frames are contiguous in the f-major raster, so one
    batched call of B * T_lat groups covers all frames); affine-free
    pre-LayerNorms, a packed kv projection, per-head RMS qk-norm with a
    [head_dim] gain, all in `compute_dtype` (fp32 by default, as JAX
    computes it). Its output is the residual the DiT adds after every
    fifth block.
Conv1d weights are [out, in, k] (the JAX tree's [k, in, out], permuted).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ....core import nn as unn
from ....kernels.attention import attention


def causal_conv1d(p, x, stride=1):
    """x [B, T, C] -> [B, T', C']: the first frame repeated k - 1 times on
    the left, then a valid conv1d."""
    k = p["w"].shape[-1]
    x = x.transpose(1, 2)
    x = F.pad(x, (k - 1, 0), mode="replicate")
    out = F.conv1d(x, p["w"], stride=stride)
    return out.transpose(1, 2) + p["b"]


def _ln_no_affine(x, eps=1e-6):
    return unn.layer_norm(x, eps=eps)


def init_face_encoder(gen: Optional[torch.Generator], in_dim: int,
                      hidden_dim: int, num_heads: int = 4,
                      width: int = 1024, *, dtype=torch.float32,
                      conv_dtype=torch.float32, device="cuda") -> unn.Node:
    """FaceEncoder parameters: conv1_local (in_dim -> width * heads),
    conv2 and conv3 (width -> width), each w N(0, 1/(k * in)) and b 0, in
    `conv_dtype` (fp32 in the checkpoint converter); out_proj (xavier) and
    the padding token (zeros) in `dtype`. Empty without `gen`."""

    def conv(cin, cout, k=3):
        w = unn.param((cout, cin, k), conv_dtype, device, gen, "normal",
                      std=1.0 / math.sqrt(k * cin))
        return unn.Node(w=w, b=unn.param((cout,), conv_dtype, device,
                                         init="zeros"))

    return unn.Node(
        conv1_local=conv(in_dim, width * num_heads),
        conv2=conv(width, width),
        conv3=conv(width, width),
        out_proj=unn.Linear(width, hidden_dim, dtype=dtype, device=device,
                            gen=gen),
        padding_tokens=unn.param((1, 1, 1, hidden_dim), dtype, device,
                                 init="zeros"))


def face_encoder_forward(params, x: torch.Tensor, num_heads: int = 4
                         ) -> torch.Tensor:
    """[B, T, in_dim] -> [B, T_lat, heads + 1, hidden]."""
    n = num_heads
    b, t, _ = x.shape
    h = causal_conv1d(params["conv1_local"], x)          # [B, T, width*n]
    width = h.shape[-1] // n
    h = h.reshape(b, t, n, width).transpose(1, 2).reshape(b * n, t, width)
    h = F.silu(_ln_no_affine(h))
    h = causal_conv1d(params["conv2"], h, stride=2)
    h = F.silu(_ln_no_affine(h))
    h = causal_conv1d(params["conv3"], h, stride=2)
    h = F.silu(_ln_no_affine(h))
    h = unn.linear(params["out_proj"], h)                # [(b n), t', d]
    tl = h.shape[1]
    h = h.reshape(b, n, tl, -1).transpose(1, 2)          # [B, t', n, d]
    pad = params["padding_tokens"].expand(b, tl, 1, h.shape[-1]).to(h.dtype)
    return torch.cat([h, pad], dim=2)


def init_face_block(gen: Optional[torch.Generator], hidden_size: int,
                    heads_num: int, *, dtype=torch.float32,
                    device="cuda") -> unn.Node:
    """FaceBlock parameters: linear1_kv (dim -> 2 dim), linear1_q, linear2
    (xavier, zero biases) and the per-head q / k norm gains (ones)."""
    hd = hidden_size // heads_num
    kw = dict(dtype=dtype, device=device, gen=gen)
    return unn.Node(
        linear1_kv=unn.Linear(hidden_size, hidden_size * 2, **kw),
        linear1_q=unn.Linear(hidden_size, hidden_size, **kw),
        linear2=unn.Linear(hidden_size, hidden_size, **kw),
        q_norm=unn.param((hd,), dtype, device, init="ones"),
        k_norm=unn.param((hd,), dtype, device, init="ones"))


def face_block_forward(params, x: torch.Tensor, motion_vec: torch.Tensor,
                       heads_num: int, motion_mask=None,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """x [B, T_lat * S, dim] (f-major token raster), motion_vec [B, T_lat,
    N, dim] -> residual [B, T_lat * S, dim] in compute_dtype; motion_mask
    [B, T_lat * S] (or any shape of that size) scales each token's
    residual."""
    cd = compute_dtype
    b, l_total, c = x.shape
    _, t_lat, n_tok, _ = motion_vec.shape
    s = l_total // t_lat
    hd = c // heads_num

    x_motion = _ln_no_affine(motion_vec.to(cd))
    x_feat = _ln_no_affine(x.to(cd))
    kv = unn.linear(params["linear1_kv"], x_motion, compute_dtype=cd)
    q = unn.linear(params["linear1_q"], x_feat, compute_dtype=cd)
    k, v = kv.chunk(2, dim=-1)
    q = unn.rms_norm(q.reshape(b, t_lat, s, heads_num, hd),
                     params["q_norm"].to(cd), eps=1e-6)
    k = unn.rms_norm(k.reshape(b, t_lat, n_tok, heads_num, hd),
                     params["k_norm"].to(cd), eps=1e-6)
    v = v.reshape(b, t_lat, n_tok, heads_num, hd)

    # one batched call: (B * T_lat) groups of S queries over N motion tokens
    o = attention(q.reshape(b * t_lat, s, heads_num, hd),
                  k.reshape(b * t_lat, n_tok, heads_num, hd),
                  v.reshape(b * t_lat, n_tok, heads_num, hd))
    out = unn.linear(params["linear2"], o.reshape(b, l_total, c),
                     compute_dtype=cd)
    if motion_mask is not None:
        out = out * motion_mask.reshape(b, -1)[..., None]
    return out
