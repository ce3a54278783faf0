"""Hiera image encoder trunk + FPN neck of the SAM2 video segmenter
(counterpart of univid_tpu/models/sam2/hiera.py).

The Hiera hierarchical ViT (window attention, 2x2 max-pool query pooling
at the stage changes, stage-doubling widths) and the FPN neck that
projects the four stage maps to a shared 256-d space with sine position
encodings. Architecture constants are pinned from the published SAM2.1
Hiera-L configuration (sam2.1_hiera_l.yaml): embed 144, 2 heads, stages
(2, 6, 36, 4), q-pool 3, window spec (8, 4, 16, 8), global-attention
blocks (23, 33, 43), 7x7 / stride-4 patch embed, neck d_model 256 with
top-down fusion on the two lowest-resolution levels.

Tensors are channels-last [B, H, W, C] as in the JAX package; each
convolution views its input as NCHW (a permute, no copy) for cuDNN and
views the result back. Where the JAX package departs from the published
model the port follows it: the background position embedding is resized
to the token grid by jax.image.resize's bicubic (Keys' cubic, a = -0.5,
`ops/resize.py`; torch's F.interpolate uses a = -0.75), and the MLP's
GELU is the tanh approximation. Attention is a plain product with an fp32
softmax, as in JAX (d = 72 in every stage: no Pallas kernel there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import nn as unn
from ...ops.resize import resize


@dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    q_pool: int = 3                      # number of pooling stage transitions
    q_stride: int = 2
    dim_mul: float = 2.0
    head_mul: float = 2.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    window_pos_embed_bkg_size: int = 7   # background pos-embed grid
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    mlp_ratio: float = 4.0

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        ends, total = [], 0
        for s in self.stages:
            total += s
            ends.append(total - 1)
        return tuple(ends)

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(e + 1 for e in self.stage_ends[: self.q_pool])

    def block_layout(self):
        """Per-block (dim_in, dim_out, heads, window_size, pooled) table.

        Mirrors the published Hiera constructor: the window size "lags by
        a block" — the first block of a new stage still uses the previous
        stage's window size; global-attention blocks use no windowing.
        """
        layout = []
        dim, heads, stage = self.embed_dim, self.num_heads, 1
        for i in range(self.depth):
            dim_out = dim
            window = self.window_spec[stage - 1]
            if i in self.global_att_blocks:
                window = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * self.dim_mul)
                heads = int(heads * self.head_mul)
                stage += 1
            layout.append(dict(dim=dim, dim_out=dim_out, heads=heads,
                               window=window,
                               pooled=i in self.q_pool_blocks))
            dim = dim_out
        return layout

    @property
    def channel_list(self) -> Tuple[int, ...]:
        """Per-stage output channels, high-res first."""
        dims, d = [], self.embed_dim
        for i in range(len(self.stages)):
            if i > 0:
                d = int(d * self.dim_mul)
            dims.append(d)
        return tuple(dims)


@dataclass(frozen=True)
class NeckConfig:
    d_model: int = 256
    num_pos_feats: int = 256
    # top-down fusion levels, indexed from the HIGH-res end like the
    # published FpnNeck (levels 2 and 3 = strides 16 and 32)
    top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1                       # drop this many lowest-res levels


# ---------------------------------------------------------------------------
# parameters (named as the JAX trees of init_hiera / init_neck)
# ---------------------------------------------------------------------------


class Init:
    """Draws leaves as the JAX init functions draw them (their
    distributions, from a torch.Generator), or leaves them empty when gen
    is None, to be loaded."""

    def __init__(self, dtype=torch.float32, device="cuda", gen=None):
        self.dtype, self.device, self.gen = dtype, device, gen

    def param(self, shape, init="empty", **kw):
        return unn.param(shape, self.dtype, self.device, self.gen, init,
                         **kw)

    def normal(self, shape, std):
        return self.param(shape, "normal", std=std)

    def full(self, shape, value):
        t = self.param(shape, "zeros")
        t.data.fill_(value)
        return t

    def conv(self, kh, kw, cin, cout):
        """w [Cout, Cin, kh, kw], b [Cout]: U(+-1/sqrt(fan_in))
        over the JAX HWIO kernel's fan_in = kh * kw * cin."""
        lim = 1.0 / math.sqrt(kh * kw * cin)
        return unn.Node(w=self.param((cout, cin, kh, kw), "uniform",
                                     limit=lim),
                        b=self.param((cout,), "uniform", limit=lim))

    def deconv(self, k, cin, cout):
        """A transposed conv, w [Cin, Cout, k, k] (torch's layout of the
        published weights), b [Cout]: U(+-1/sqrt(cin * k * k))."""
        lim = 1.0 / math.sqrt(cin * k * k)
        return unn.Node(w=self.param((cin, cout, k, k), "uniform",
                                     limit=lim),
                        b=self.param((cout,), "uniform", limit=lim))

    def linear(self, din, dout):
        return unn.Linear(din, dout, dtype=self.dtype, device=self.device,
                          gen=self.gen)

    def ln(self, d):
        return unn.Node(w=self.param((d,), "ones"),
                        b=self.param((d,), "zeros"))

    def mlp(self, dims):
        """{"layers": [linear, ...]} over dims (in, hidden..., out)."""
        return unn.Node(layers=nn.ModuleList(
            [self.linear(a, b) for a, b in zip(dims[:-1], dims[1:])]))


def init_hiera(cfg: HieraConfig, mk: Init) -> unn.Node:
    blocks = []
    for spec in cfg.block_layout():
        d, do = spec["dim"], spec["dim_out"]
        hidden = int(do * cfg.mlp_ratio)
        blk = dict(norm1=mk.ln(d), qkv=mk.linear(d, 3 * do),
                   attn_proj=mk.linear(do, do), norm2=mk.ln(do),
                   mlp0=mk.linear(do, hidden), mlp1=mk.linear(hidden, do))
        if d != do:
            blk["proj"] = mk.linear(d, do)
        blocks.append(unn.Node(**blk))
    bkg, win, e = (cfg.window_pos_embed_bkg_size, cfg.window_spec[0],
                   cfg.embed_dim)
    return unn.Node(
        patch_embed=mk.conv(cfg.patch_kernel, cfg.patch_kernel, 3, e),
        # background pos embed (resized to the full grid) plus a
        # window-tiled local pos embed, both [h, w, C], added after the
        # patch embed
        pos_embed=mk.normal((bkg, bkg, e), 0.02),
        pos_embed_window=mk.normal((win, win, e), 0.02),
        blocks=nn.ModuleList(blocks))


def init_neck(cfg: NeckConfig, channel_list, mk: Init) -> unn.Node:
    # convs[0] maps the LOWEST-res stage like the published FpnNeck
    return unn.Node(convs=nn.ModuleList(
        [mk.conv(1, 1, c, cfg.d_model) for c in reversed(channel_list)]))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def conv2d(x, p, *, stride=1, padding=0, groups=1):
    """x [B, H, W, Cin], p.w [Cout, Cin / groups, kh, kw] -> [B, H', W',
    Cout] in x's dtype; the bias added after the rounded product, as the
    JAX package adds it."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p.w.to(x.dtype), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1) + p.b.to(x.dtype)


def layer_norm(p, x, eps):
    return unn.layer_norm(x, weight=p.w.to(x.dtype), bias=p.b.to(x.dtype),
                          eps=eps)


def attention(q, k, v, num_heads: int):
    """Plain attention over [B, N, C] heads: scores in fp32 (the JAX
    package divides by an np.float64 scale, which promotes), an fp32
    softmax, probabilities in v's dtype."""
    b, nq, c = q.shape
    hd = c // num_heads
    qh = q.reshape(b, nq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, -1, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, -1, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(b, nq, c)


def _window_partition(x, ws: int):
    """[B, H, W, C] -> windows [B*nH*nW, ws, ws, C], padding to multiples."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def _window_unpartition(x, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _max_pool2x2(x):
    """2x2/stride-2 max pool over [B, H, W, C] (floor mode)."""
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _block_forward(blk, spec, x, compute_dtype):
    """One MultiScaleBlock: pre-LN windowed attention with optional
    query pooling at stage transitions, then a tanh-GELU MLP."""
    d, do, heads = spec["dim"], spec["dim_out"], spec["heads"]
    ws = spec["window"]
    shortcut = x
    y = layer_norm(blk.norm1, x, 1e-6)
    if d != do:
        # dim-change shortcut: linear proj of the NORMED input, pooled
        shortcut = unn.linear(blk.proj, y, compute_dtype=compute_dtype)
        if spec["pooled"]:
            shortcut = _max_pool2x2(shortcut)

    pad_hw = hw = tuple(y.shape[1:3])
    if ws > 0:
        y, pad_hw = _window_partition(y, ws)
    b, h, w, _ = y.shape
    qkv = unn.linear(blk.qkv, y, compute_dtype=compute_dtype)
    qkv = qkv.reshape(b, h * w, 3, do)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if spec["pooled"]:
        q = _max_pool2x2(q.reshape(b, h, w, do))
        qh, qw = q.shape[1:3]
        q = q.reshape(b, qh * qw, do)
    out = attention(q, k, v, heads)
    if spec["pooled"]:
        out = out.reshape(b, qh, qw, do)
        # the token grid halved: unpartition with the pooled geometry
        ws_out = max(ws // 2, 1) if ws > 0 else 0
        hw = (hw[0] // 2, hw[1] // 2)
        pad_hw = (pad_hw[0] // 2, pad_hw[1] // 2)
    else:
        ws_out = ws
        out = out.reshape(b, h, w, do)
    out = unn.linear(blk.attn_proj, out, compute_dtype=compute_dtype)
    if ws > 0:
        out = _window_unpartition(out, ws_out, pad_hw, hw)
    x = shortcut + out

    y = layer_norm(blk.norm2, x, 1e-6)
    y = unn.linear(blk.mlp0, y, compute_dtype=compute_dtype)
    y = unn.gelu_tanh(y)
    y = unn.linear(blk.mlp1, y, compute_dtype=compute_dtype)
    return x + y


def hiera_forward(p, cfg: HieraConfig, x: torch.Tensor,
                  compute_dtype=torch.float32) -> List[torch.Tensor]:
    """[B, H, W, 3] normalized image -> per-stage features, high-res
    first: [(B, H/4, W/4, C0), ..., (B, H/32, W/32, C3)]."""
    x = conv2d(x.to(compute_dtype), p.patch_embed,
               stride=cfg.patch_stride, padding=cfg.patch_padding)
    h, w = x.shape[1:3]
    bg = resize(p.pos_embed.to(x.dtype), (h, w, cfg.embed_dim), "bicubic")
    win = p.pos_embed_window.to(x.dtype)
    x = x + bg + win.tile(h // win.shape[0], w // win.shape[1], 1)

    outputs = []
    for i, (blk, spec) in enumerate(zip(p.blocks, cfg.block_layout())):
        x = _block_forward(blk, spec, x, compute_dtype)
        if i in cfg.stage_ends:
            outputs.append(x)
    return outputs


def sine_pos_encoding(h: int, w: int, num_feats: int, device,
                      dtype=torch.float32) -> torch.Tensor:
    """[H, W, num_feats] normalized sine/cosine position encoding (the
    published PositionEmbeddingSine: y-half then x-half, interleaved
    sin/cos per frequency, scale 2*pi, temperature 10000), in fp32."""
    half = num_feats // 2
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(1, h + 1, **f32)[:, None]
    x = torch.arange(1, w + 1, **f32)[None, :]
    eps = 1e-6
    y = y / (h + eps) * (2 * math.pi)
    x = x / (w + eps) * (2 * math.pi)
    dim_t = torch.arange(half, **f32)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / half)
    yy = y.expand(h, w)[:, :, None] / dim_t
    xx = x.expand(h, w)[:, :, None] / dim_t
    pos_y = torch.stack([torch.sin(yy[:, :, 0::2]),
                         torch.cos(yy[:, :, 1::2])], dim=3).reshape(h, w,
                                                                    half)
    pos_x = torch.stack([torch.sin(xx[:, :, 0::2]),
                         torch.cos(xx[:, :, 1::2])], dim=3).reshape(h, w,
                                                                    half)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


def neck_forward(p, cfg: NeckConfig, features: List[torch.Tensor]):
    """FPN neck: 1x1 lateral convs to d_model + nearest 2x top-down fusion
    on `top_down_levels`; returns (features, positions), high-res first,
    with the `scalp` lowest-resolution levels dropped."""
    n = len(features) - 1
    out: List[Optional[torch.Tensor]] = [None] * len(features)
    pos: List[Optional[torch.Tensor]] = [None] * len(features)
    prev = None
    for i in range(n, -1, -1):
        lat = conv2d(features[i], p.convs[n - i])
        if i in cfg.top_down_levels and prev is not None:
            up = prev.float().repeat_interleave(2, dim=1) \
                .repeat_interleave(2, dim=2)
            prev = lat + up.to(lat.dtype)
        else:
            prev = lat
        out[i] = prev
        pos[i] = sine_pos_encoding(prev.shape[1], prev.shape[2],
                                   cfg.num_pos_feats, prev.device,
                                   prev.dtype)[None].expand(prev.shape)
    if cfg.scalp > 0:
        out, pos = out[: -cfg.scalp], pos[: -cfg.scalp]
    return out, pos
