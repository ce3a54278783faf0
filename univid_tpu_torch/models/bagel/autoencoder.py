"""FLUX-style 2D image VAE: BAGEL's generation latent space.

Counterpart of univid_tpu/models/bagel/autoencoder.py: GroupNorm-swish
res blocks, one single-head attention block at the bottleneck, 8x
downsampling, z = 16, scale 0.3611 / shift 0.1159. The public API is
channels-last [B, H, W, C] like the JAX package's; each convolution views
its input as NCHW (a permute, no copy) for cuDNN and views the result back.
The encode is deterministic and returns the scaled mean.

Everything runs in fp32 with TF32 off (`_exact_fp32`), as the Wan VAE
does: the reference computes in fp32, and TF32 would round each product's
operands to 10 mantissa bits. The bottleneck attention is a plain einsum in
the JAX package, outside any Pallas kernel; here it is torch.matmul and a
softmax in fp32 (its score matrix is 1.07 GB at a 1024x1024 image).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import nn as unn


@dataclass(frozen=True)
class ImageVAEConfig:
    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@contextlib.contextmanager
def _exact_fp32():
    """cuBLAS and cuDNN at fp32 (TF32 off) inside, the flags restored."""
    mm = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def conv2d(x, p, *, stride=1, padding="SAME"):
    """x [B, H, W, Cin], p.w [Cout, Cin, kh, kw] -> [B, H', W', Cout].
    padding 'SAME' (symmetric), or 'RB': FLUX's downsample pad (0, 1, 0, 1)
    before a stride-2 conv."""
    w, b = p.w, getattr(p, "b", None)
    kh, kw = w.shape[2:]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        pad = ((kh - 1) // 2, (kw - 1) // 2)
    elif padding == "RB":
        xc = F.pad(xc, (0, 1, 0, 1))
        pad = 0
    else:
        raise ValueError(padding)
    y = F.conv2d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def group_norm(x, p, groups=32, eps=1e-6):
    """GroupNorm over [B, H, W, C] with fp32 statistics."""
    b, h, w, c = x.shape
    groups = min(groups, c)
    x32 = x.float().reshape(b, h * w, groups, c // groups)
    var, mean = torch.var_mean(x32, dim=(1, 3), keepdim=True, correction=0)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (y * p.w.float() + p.b.float()).to(x.dtype)


def _swish(x):
    return F.silu(x)


def _res_block(p, x):
    h = conv2d(_swish(group_norm(x, p.norm1)), p.conv1)
    h = conv2d(_swish(group_norm(h, p.norm2)), p.conv2)
    if "shortcut" in p:
        x = conv2d(x, p.shortcut)
    return x + h


def _attn_block(p, x):
    """Single-head attention over the H*W positions, fp32 scores."""
    b, h, w, c = x.shape
    y = group_norm(x, p.norm)
    q, k, v = (conv2d(y, p[n]).reshape(b, h * w, c).float()
               for n in ("q", "k", "v"))
    s = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
    o = torch.matmul(torch.softmax(s, dim=-1), v).reshape(b, h, w, c)
    return x + conv2d(o.to(x.dtype), p.proj)


# ---------------------------------------------------------------------------
# parameters (named as the JAX tree of init_image_vae)
# ---------------------------------------------------------------------------


class ImageVAE(nn.Module):
    """Every parameter of init_image_vae: `encoder` (conv_in, down{i}
    with res{j} and `down`, mid_res1, mid_attn, mid_res2, norm_out,
    conv_out) and `decoder` (conv_in, the mid blocks, up{i} with res{j} and
    `up`, norm_out, conv_out). Drawn from `gen` as the JAX init draws them
    (convs normal / sqrt(fan_in) with zero bias, norms ones / zeros); left
    empty when gen is None, to be loaded."""

    def __init__(self, cfg: ImageVAEConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg

        def conv(k, cin, cout):
            init = "normal" if gen is not None else "empty"
            return unn.Node(
                w=unn.param((cout, cin, k, k), dtype, device, gen, init,
                            std=(k * k * cin) ** -0.5),
                b=unn.param((cout,), dtype, device, init="zeros"))

        def gn(c):
            return unn.Node(w=unn.param((c,), dtype, device, init="ones"),
                            b=unn.param((c,), dtype, device, init="zeros"))

        def res(cin, cout):
            d = dict(norm1=gn(cin), conv1=conv(3, cin, cout), norm2=gn(cout),
                     conv2=conv(3, cout, cout))
            if cin != cout:
                d["shortcut"] = conv(1, cin, cout)
            return unn.Node(**d)

        def attn(c):
            return unn.Node(norm=gn(c), q=conv(1, c, c), k=conv(1, c, c),
                            v=conv(1, c, c), proj=conv(1, c, c))

        ch, mults = cfg.ch, cfg.ch_mult
        n_levels = len(mults)
        enc = {"conv_in": conv(3, cfg.in_channels, ch)}
        block_in = ch
        for i in range(n_levels):
            level = {}
            block_in = ch * ((1,) + tuple(mults))[i]
            block_out = ch * mults[i]
            for j in range(cfg.num_res_blocks):
                level[f"res{j}"] = res(block_in, block_out)
                block_in = block_out
            if i != n_levels - 1:
                level["down"] = conv(3, block_in, block_in)
            enc[f"down{i}"] = unn.Node(**level)
        enc.update(mid_res1=res(block_in, block_in), mid_attn=attn(block_in),
                   mid_res2=res(block_in, block_in), norm_out=gn(block_in),
                   conv_out=conv(3, block_in, 2 * cfg.z_channels))

        block_in = ch * mults[-1]
        dec = {"conv_in": conv(3, cfg.z_channels, block_in),
               "mid_res1": res(block_in, block_in),
               "mid_attn": attn(block_in),
               "mid_res2": res(block_in, block_in)}
        for i in reversed(range(n_levels)):
            level = {}
            block_out = ch * mults[i]
            for j in range(cfg.num_res_blocks + 1):
                level[f"res{j}"] = res(block_in, block_out)
                block_in = block_out
            if i != 0:
                level["up"] = conv(3, block_in, block_in)
            dec[f"up{i}"] = unn.Node(**level)
        dec.update(norm_out=gn(block_in),
                   conv_out=conv(3, block_in, cfg.out_ch))
        self.encoder = unn.Node(**enc)
        self.decoder = unn.Node(**dec)


def init_image_vae(gen: torch.Generator, cfg: ImageVAEConfig, *,
                   dtype=torch.float32, device="cuda") -> ImageVAE:
    return ImageVAE(cfg, dtype=dtype, device=device, gen=gen)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def image_vae_encode(params: ImageVAE, cfg: ImageVAEConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> the scaled latent mean [B, H/8, W/8, z]."""
    enc = params.encoder
    with _exact_fp32():
        h = conv2d(x, enc.conv_in)
        for i in range(len(cfg.ch_mult)):
            level = enc[f"down{i}"]
            for j in range(cfg.num_res_blocks):
                h = _res_block(level[f"res{j}"], h)
            if "down" in level:
                h = conv2d(h, level.down, stride=2, padding="RB")
        h = _res_block(enc.mid_res1, h)
        h = _attn_block(enc.mid_attn, h)
        h = _res_block(enc.mid_res2, h)
        h = conv2d(_swish(group_norm(h, enc.norm_out)), enc.conv_out)
    mean = h[..., :cfg.z_channels]
    return cfg.scale_factor * (mean - cfg.shift_factor)


def image_vae_decode(params: ImageVAE, cfg: ImageVAEConfig,
                     z: torch.Tensor) -> torch.Tensor:
    """The scaled latent [B, h, w, z] -> the image [B, 8h, 8w, 3], nearest
    2x upsampling between levels."""
    z = z / cfg.scale_factor + cfg.shift_factor
    dec = params.decoder
    with _exact_fp32():
        h = conv2d(z, dec.conv_in)
        h = _res_block(dec.mid_res1, h)
        h = _attn_block(dec.mid_attn, h)
        h = _res_block(dec.mid_res2, h)
        for i in reversed(range(len(cfg.ch_mult))):
            level = dec[f"up{i}"]
            for j in range(cfg.num_res_blocks + 1):
                h = _res_block(level[f"res{j}"], h)
            if "up" in level:
                b, hh, ww, c = h.shape
                h = h[:, :, None, :, None, :].expand(b, hh, 2, ww, 2, c) \
                    .reshape(b, hh * 2, ww * 2, c)
                h = conv2d(h, level.up)
        return conv2d(_swish(group_norm(h, dec.norm_out)), dec.conv_out)
