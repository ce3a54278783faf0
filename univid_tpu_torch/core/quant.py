"""int8 quantization for serving (counterpart of univid_tpu/core/quant.py).

Per-output-channel symmetric int8 on linear weights: scale[o] =
max(max_i |w[o, i]| / 127, 1e-8), codes clip(round(w / scale), -127, 127),
in the port's [out, in] layout. Two forms, each a `QuantLinear` module that
`core.nn.linear` dispatches on:
  * weight-only `qw` (`quantize_linear`, `quantize_tree`): the weight is
    dequantized in fp32 and cast once to the compute dtype;
  * dynamic W8A8 `qw8` (`quantize_linear_w8a8`, `quantize_dit_w8a8`, the
    CLI's --int8): per-token symmetric int8 activations and an int8 x int8
    -> int32 product (`torch._int_mm`, a library GEMM as XLA's dot_general
    is in the JAX package), rescaled in fp32.
Quantizing replaces modules in place (the JAX functions return a new tree):
a full-size DiT then never holds its bf16 and int8 weights at once.
`W8A8_LAUNCHES` counts the int8 products.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import Linear, linear

W8A8_LAUNCHES = {"w8a8_linear": 0}

_DIT_W8A8_SUBPATHS = ("self_attn.q", "self_attn.k", "self_attn.v",
                      "self_attn.o", "cross_attn.q", "cross_attn.k",
                      "cross_attn.v", "cross_attn.o", "ffn.fc0", "ffn.fc1")


class QuantLinear(nn.Module):
    """A quantized dense layer: int8 codes `qw` (weight-only) or `qw8`
    (W8A8), [out, in]; fp32 per-output-channel `scale` [out]; bias `b` (the
    original's dtype) or None. Buffers, so a state dict carries them."""

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor,
                 bias=None, *, w8a8: bool):
        super().__init__()
        self.register_buffer("qw8" if w8a8 else "qw", codes)
        self.register_buffer("scale", scale)
        self.register_buffer("b", bias)

    @classmethod
    def empty(cls, out_dim, in_dim, *, bias: bool, w8a8: bool, bias_dtype,
              device):
        """Uninitialised buffers of the right shapes (for load_state_dict)."""
        return cls(torch.empty((out_dim, in_dim), dtype=torch.int8,
                               device=device),
                   torch.empty((out_dim,), dtype=torch.float32,
                               device=device),
                   torch.empty((out_dim,), dtype=bias_dtype, device=device)
                   if bias else None, w8a8=w8a8)

    def forward(self, x, compute_dtype=None):
        return linear(self, x, compute_dtype=compute_dtype)


def _codes(w: torch.Tensor):
    """(int8 codes, fp32 scale [out]) of w [out, in], per output channel."""
    w = w.float()
    scale = (w.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    qw = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return qw, scale[:, 0]


def _bias(p):
    b = getattr(p, "b", None)
    return None if b is None else b.detach().clone()


def quantize_linear(p: Linear) -> QuantLinear:
    """A Linear -> weight-only int8 (`qw`)."""
    qw, scale = _codes(p.w.detach())
    return QuantLinear(qw, scale, _bias(p), w8a8=False)


def quantize_linear_w8a8(p: Linear) -> QuantLinear:
    """A Linear -> dynamic W8A8 (`qw8`): the same weight codes and scales
    as `quantize_linear`, with per-token activation quantization in
    `w8a8_linear`."""
    qw, scale = _codes(p.w.detach())
    return QuantLinear(qw, scale, _bias(p), w8a8=True)


def int8_matmul(xq: torch.Tensor, qw8: torch.Tensor) -> torch.Tensor:
    """xq int8 [M, K] @ qw8 int8 [N, K]^T -> int32 [M, N], exact
    (`torch._int_mm`, whose cuBLAS path wants a row-major left operand and a
    column-major right one: qw8's transpose is). On the card it needs
    M > 16 and K, N multiples of 8: zero rows and columns pad a shape that
    breaks a rule (they add nothing) and are sliced off."""
    m, k = xq.shape
    n = qw8.shape[0]
    if xq.is_cuda:
        pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
        if pm or pk:
            xq = F.pad(xq, (0, pk, 0, pm))
        if pk or pn:
            qw8 = F.pad(qw8, (0, pk, 0, pn))
    y = torch._int_mm(xq, qw8.t())
    W8A8_LAUNCHES["w8a8_linear"] += 1
    return y[:m, :n]


def w8a8_linear(p, x, *, compute_dtype=None):
    """Dynamic W8A8: y = (q(x) @ qw8^T) * a_scale * w_scale + b. Activations
    per token: a_scale = max(max|x| / 127, 1e-8) in fp32, codes
    clip(round(x / a_scale), -127, 127); the int32 product rescaled in fp32,
    then one cast to the compute dtype (else x's)."""
    dt = compute_dtype or x.dtype
    xf = x.float()
    a_scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    xq = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    y = int8_matmul(xq.reshape(-1, x.shape[-1]), p.qw8)
    y = y.reshape(*x.shape[:-1], -1).float() * a_scale * p.scale.float()
    if p.b is not None:
        y = y + p.b.float()
    return y.to(dt)


def _replace(root: nn.Module, path: str, new: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, name, new)


def quantize_dit_w8a8(dit: nn.Module) -> nn.Module:
    """W8A8 serving mode of the Wan DiT, in place: each block's self- and
    cross-attention projections and FFN become `qw8` layers (~99% of the
    linear FLOPs at 33k tokens); patch, time and text embeddings, the AdaLN
    modulations and the output head stay as they are. Returns `dit`."""
    for path, mod in list(dit.named_modules()):
        if isinstance(mod, Linear) and path.endswith(_DIT_W8A8_SUBPATHS):
            _replace(dit, path, quantize_linear_w8a8(mod))
    return dit


def quantize_tree(model: nn.Module, *, skip: Iterable[str] = ("embed_tokens",),
                  min_size: int = 1 << 16) -> nn.Module:
    """Weight-only int8 on every Linear of `model` whose weight has at least
    `min_size` elements and whose path contains none of `skip`, in place.
    A Linear inside a ModuleList member counts its elements times the
    list's length: the JAX tree stacks those layers into one [depth, in,
    out] leaf, whose size JAX's min_size reads, so both packages pick the
    same layers (UMT5, whose JAX blocks are not stacked, is quantized by no
    caller). Returns `model`."""
    skip = tuple(skip)
    lists = {path: len(mod) for path, mod in model.named_modules()
             if isinstance(mod, nn.ModuleList)}
    for path, mod in list(model.named_modules()):
        if not isinstance(mod, Linear) or any(s in path for s in skip):
            continue
        owner = max((p for p in lists if path.startswith(p + ".")),
                    key=len, default=None)
        depth = lists[owner] if owner is not None else 1
        if mod.w.numel() * depth >= min_size:
            _replace(model, path, quantize_linear(mod))
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of a (possibly quantized) module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
