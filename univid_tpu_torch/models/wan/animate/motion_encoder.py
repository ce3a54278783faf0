"""LIA motion encoder (the StyleGAN-style face-motion tower of WanAnimate).

Counterpart of univid_tpu/models/wan/animate/motion_encoder.py, with its
numerics: EqualConv2d / EqualLinear scale their weights by 1/sqrt(fan_in)
(times lr_mul) at run time; the fused leaky ReLU adds its bias, then
leaky_relu(0.2) * sqrt(2); the [1,3,3,1]^2 / 64 blur is a depthwise 4x4
convolution; ResBlocks (3x3 conv, then blur + stride-2 3x3 conv) merge
their blur + stride-2 1x1 skip with / sqrt(2); a 4x4 valid conv gives the
512-d appearance code, five EqualLinears the 20 motion alphas, and the
Direction module projects them through the Q of qr(weight + 1e-8).

The JAX package runs NHWC with [kh, kw, in, out] weights; here the images
are transposed once to NCHW and the convolutions run on cuDNN with
[out, in, kh, kw] weights, in fp32 (the CLI turns TF32 off). Parameters
keep the JAX tree's names; its `blocks` and `fc` lists become
ModuleLists.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ....core import nn as unn

BLUR_KERNEL = (1.0, 3.0, 3.0, 1.0)

# EncoderApp channel schedule, by feature-map side
CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64,
            512: 32, 1024: 16}


def _blur_kernel_2d() -> np.ndarray:
    k = np.asarray(BLUR_KERNEL, np.float32)
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def fused_leaky_relu(x, bias, negative_slope=0.2, scale=math.sqrt(2.0)):
    """leaky_relu(x + bias) * sqrt(2), bias over the channel axis (1)."""
    return F.leaky_relu(x + bias[:, None, None], negative_slope) * scale


def scaled_leaky_relu(x, negative_slope=0.2):
    return F.leaky_relu(x, negative_slope) * math.sqrt(2.0)


def equal_conv2d(p, x, stride=1, padding=0):
    """EqualConv2d: weight [out, in, kh, kw] scaled by 1/sqrt(in*kh*kw) at
    run time; x NCHW."""
    w = p["w"]
    scale = 1.0 / math.sqrt(w[0].numel())
    out = F.conv2d(x, w * scale, stride=stride, padding=padding)
    if "b" in p:
        out = out + p["b"][:, None, None]
    return out


def equal_linear(p, x, lr_mul=1.0):
    """EqualLinear without activation: x @ (w * scale)^T + b * lr_mul, scale
    1/sqrt(in) * lr_mul (w [out, in])."""
    w = p.w
    scale = (1.0 / math.sqrt(w.shape[1])) * lr_mul
    return F.linear(x, w * scale) + p.b * lr_mul


def blur(x, pad):
    """upfirdn2d(kernel=[1,3,3,1]^2/64, pad) as a depthwise conv; pad =
    (before, after), the same on both spatial axes."""
    c = x.shape[1]
    k = torch.as_tensor(_blur_kernel_2d(), dtype=x.dtype, device=x.device)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(x, k.expand(c, 1, 4, 4), groups=c)


def conv_layer(p, x, kernel_size, downsample=False, activate=True,
               bias=True):
    """ConvLayer: [blur ->] EqualConv2d [-> fused leaky ReLU]."""
    if downsample:
        pth = (len(BLUR_KERNEL) - 2) + (kernel_size - 1)
        x = blur(x, ((pth + 1) // 2, pth // 2))
        x = equal_conv2d(p, x, stride=2, padding=0)
    else:
        x = equal_conv2d(p, x, stride=1, padding=kernel_size // 2)
    if activate:
        x = fused_leaky_relu(x, p["act_b"]) if bias else scaled_leaky_relu(x)
    return x


def res_block(p, x):
    """ResBlock: conv1 (same) -> conv2 (down), plus the down skip, over
    sqrt(2)."""
    out = conv_layer(p["conv1"], x, 3)
    out = conv_layer(p["conv2"], out, 3, downsample=True)
    skip = conv_layer(p["skip"], x, 1, downsample=True, activate=False,
                      bias=False)
    return (out + skip) / math.sqrt(2.0)


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------


def _conv(kh, cin, cout, kw, bias=True, act_bias=True):
    """A conv's Node: w [cout, cin, kh, kh] N(0, 1) (zeros-initialised b
    and act_b when asked), as the JAX init draws them."""
    p = {"w": unn.param((cout, cin, kh, kh), kw["dtype"], kw["device"],
                        kw["gen"], "normal")}
    if bias:
        p["b"] = unn.param((cout,), kw["dtype"], kw["device"], init="zeros")
    if act_bias:
        p["act_b"] = unn.param((cout,), kw["dtype"], kw["device"],
                               init="zeros")
    return unn.Node(**p)


class MotionEncoder(nn.Module):
    """Parameters of init_motion_encoder: `first` (1x1 conv from RGB),
    `blocks` (log2(size) - 2 ResBlocks), `final` (4x4 conv to `dim`), `fc`
    (five EqualLinears, the last to motion_dim) and `direction` [dim,
    motion_dim]. With `gen`, drawn from N(0, 1) with zero biases, as the
    JAX init; without, left empty to be loaded."""

    def __init__(self, size: int = 512, dim: int = 512,
                 motion_dim: int = 20, channels: Optional[dict] = None, *,
                 dtype=torch.float32, device="cuda",
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        channels = channels or CHANNELS
        kw = dict(dtype=dtype, device=device, gen=gen)
        log_size = int(math.log2(size))
        self.first = _conv(1, 3, channels[size], kw)
        cin = channels[size]
        blocks = []
        for i in range(log_size, 2, -1):
            cout = channels[2 ** (i - 1)]
            blocks.append(unn.Node(
                conv1=_conv(3, cin, cin, kw), conv2=_conv(3, cin, cout, kw),
                skip=_conv(1, cin, cout, kw, bias=False, act_bias=False)))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.final = _conv(4, cin, dim, kw, bias=False, act_bias=False)
        self.fc = nn.ModuleList(
            unn.Linear(dim, dim if i < 4 else motion_dim, init="normal",
                       std=1.0, **kw) for i in range(5))
        self.direction = unn.param((dim, motion_dim), dtype, device, gen,
                                   "normal")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def enc_motion(model: MotionEncoder, img: torch.Tensor) -> torch.Tensor:
    """img [B, S, S, 3] (channels-last, as the JAX package takes it) ->
    motion alphas [B, motion_dim]."""
    h = conv_layer(model.first, img.permute(0, 3, 1, 2), 1)
    for bp in model.blocks:
        h = res_block(bp, h)
    h = equal_conv2d(model.final, h, stride=1, padding=0)   # [B, d, 1, 1]
    h = h.reshape(h.shape[0], -1)
    for fp in model.fc:
        h = equal_linear(fp, h)
    return h


def direction(model: MotionEncoder, alphas: torch.Tensor) -> torch.Tensor:
    """Project through the orthonormal Q of qr(weight + 1e-8): alphas @
    Q^T."""
    w = model.direction.float() + 1e-8
    q, _ = torch.linalg.qr(w)
    return alphas.float() @ q.T


def get_motion(model: MotionEncoder, img: torch.Tensor) -> torch.Tensor:
    """[B, S, S, 3] in [-1, 1] -> motion vectors [B, dim]."""
    return direction(model, enc_motion(model, img))


def init_motion_encoder(gen: Optional[torch.Generator], size: int = 512,
                        dim: int = 512, motion_dim: int = 20,
                        channels: Optional[dict] = None, *,
                        dtype=torch.float32, device="cuda") -> MotionEncoder:
    """MotionEncoder drawn from `gen` (empty without one)."""
    return MotionEncoder(size, dim, motion_dim, channels, dtype=dtype,
                         device=device, gen=gen)
