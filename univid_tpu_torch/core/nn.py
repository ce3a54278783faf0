"""Layers with the JAX package's numerics (counterpart of
univid_tpu/core/nn.py).

Parameters keep the JAX parameter tree's names (`w`, `b`, ...) so that
`convert.py` maps a JAX tree onto a module key by key; weights are stored
in PyTorch's layouts (linear [out, in], conv [Cout, Cin, kt, kh, kw]).
Products accumulate in fp32 and round once to the compute dtype; norms
take fp32 statistics. Modules are created on their device, either empty
(to be loaded) or drawn from a torch.Generator with the distributions of
the JAX init functions.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def param(shape, dtype, device, gen=None, init="empty", std=1.0,
           limit=None):
    """A Parameter drawn on `device`: 'normal' (std), 'uniform' (+-limit),
    'zeros', 'ones', or left empty when gen is None and init is random."""
    if init == "zeros":
        t = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        t = torch.ones(shape, dtype=dtype, device=device)
    elif gen is None or init == "empty":
        t = torch.empty(shape, dtype=dtype, device=device)
    elif init == "normal":
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device).mul_(std).to(dtype)
    elif init == "uniform":
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.uniform_(-limit, limit, generator=gen)
        t = t.to(dtype)
    else:
        raise ValueError(init)
    return nn.Parameter(t, requires_grad=False)


class Node(nn.Module):
    """A module holding named children and parameters, indexable like the
    JAX parameter dict it mirrors (`p["conv1"]`, `"shortcut" in p`)."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._modules or name in self._parameters


class Linear(nn.Module):
    """Dense layer; w [out, in] (the JAX tree's [in, out], transposed)."""

    def __init__(self, in_dim, out_dim, *, bias=True, init="xavier",
                 std=0.02, dtype=torch.float32, device="cuda", gen=None):
        super().__init__()
        if init == "xavier":
            limit = math.sqrt(6.0 / (in_dim + out_dim))
            self.w = param((out_dim, in_dim), dtype, device, gen, "uniform",
                            limit=limit)
        elif init == "normal":
            self.w = param((out_dim, in_dim), dtype, device, gen, "normal",
                            std=std)
        else:
            self.w = param((out_dim, in_dim), dtype, device, init=init)
        self.b = param((out_dim,), dtype, device, init="zeros") \
            if bias else None

    def forward(self, x, compute_dtype=None):
        return linear(self, x, compute_dtype=compute_dtype)


def mlp(dims, *, bias=True, init="xavier", std=0.02, dtype=torch.float32,
        device="cuda", gen=None) -> Node:
    """Stack of linears named fc0, fc1, ...: dims = (in, hidden..., out)."""
    return Node(**{f"fc{i}": Linear(dims[i], dims[i + 1], bias=bias,
                                    init=init, std=std, dtype=dtype,
                                    device=device, gen=gen)
                   for i in range(len(dims) - 1)})


def linear(p, x, *, compute_dtype=None):
    """y = x @ w^T + b with fp32 accumulation, one rounding to the output
    dtype (compute_dtype, else x's dtype). Without compute_dtype the
    operands are promoted as JAX promotes them (fp32 x with bf16 weights
    computes in fp32).

    Also takes the int8 layers of core/quant.py: `qw8` (dynamic W8A8, an
    int8 x int8 -> int32 product, `quant.w8a8_linear`) and `qw`
    (weight-only: the codes times the fp32 scale, cast once to the compute
    dtype, then the dense product)."""
    if getattr(p, "qw8", None) is not None:
        from .quant import w8a8_linear
        return w8a8_linear(p, x, compute_dtype=compute_dtype)
    if getattr(p, "qw", None) is not None:
        dt = compute_dtype or x.dtype
        w = (p.qw.float() * p.scale.float()[:, None]).to(dt)
        return _dense(x.to(dt), w, p.b, dt)
    w, b = p.w, getattr(p, "b", None)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
        out_dtype = compute_dtype
    else:
        out_dtype = x.dtype
        ct = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(ct), w.to(ct)
    return _dense(x, w, b, out_dtype)


def _dense(x, w, b, out_dtype):
    if x.is_cuda and x.dtype != torch.float32:
        # cuBLAS accumulates in fp32 and rounds once, bias included
        y = F.linear(x, w, None if b is None else b.to(x.dtype))
        return y.to(out_dtype)
    y = F.linear(x.float(), w.float(), None if b is None else b.float())
    return y.to(out_dtype)


def layer_norm(x, *, weight=None, bias=None, eps=1e-6):
    """fp32-statistics layer norm; the affine runs in x's dtype."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x, weight, *, eps=1e-5):
    """fp32-statistics RMS norm, cast back, times weight in x's dtype."""
    dtype = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(dtype) * weight


def l2_normalize_rms(x, gamma, *, bias=None, dim=-1):
    """F.normalize-style RMS norm of the video VAE: unit-normalise along
    `dim`, scale by sqrt(size) * gamma (+ bias)."""
    x32 = x.float()
    norm = x32.square().sum(dim=dim, keepdim=True).sqrt()
    scale = x.shape[dim] ** 0.5
    y = (x32 / norm.clamp_min(1e-12)) * scale
    y = y.to(x.dtype) * gamma
    if bias is not None:
        y = y + bias
    return y


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)
