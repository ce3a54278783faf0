"""Wan 3D causal video VAE: layers, encoder and decoder.

Counterpart of univid_tpu/models/wan/vae.py, written over channels-last
[B, T, H, W, C] tensors like the JAX package; each convolution views its
input as NCDHW (a permute, no copy) for cuDNN and views the result back.
The streaming cache is the JAX package's: every causal conv keeps the last
CACHE_T=2 input frames of the stream (zero-filled before it starts), so a
chunked decode equals the full-sequence decode exactly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core import nn as unn
from ...core.config import WanVAEConfig
from ...kernels.attention import attention

CACHE_T = 2


class Stream:
    """Threads per-conv temporal caches through the layer graph in
    construction order."""

    def __init__(self, cache: Optional[Tuple] = None):
        self.cache_in = cache
        self.idx = 0
        self.cache_out: List = []

    @property
    def first(self) -> bool:
        return self.cache_in is None

    def pull(self):
        v = self.cache_in[self.idx]
        self.idx += 1
        return v

    def push(self, v):
        # a copy: a slice would keep the whole chunk's input alive (at
        # 1280x704 that is GBs per causal conv of the decoder)
        self.cache_out.append(v.clone())

    def done(self) -> Tuple:
        if self.cache_in is not None:
            assert self.idx == len(self.cache_in), \
                f"cache mismatch: used {self.idx}/{len(self.cache_in)}"
        return tuple(self.cache_out)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def conv3d(x, w, b=None, *, stride=(1, 1, 1), padding="CAUSAL"):
    """x [B, T, H, W, Cin], w [Cout, Cin, kt, kh, kw] -> [B, T', H', W', Cout].

    padding: 'CAUSAL' = (kt-1 front, 0 back) temporal + symmetric spatial;
    'VALID'; or explicit [(t0, t1), (h0, h1), (w0, w1)]. Weights are cast to
    x's dtype (fp32 latents with bf16 weights compute in fp32)."""
    kt, kh, kw = w.shape[2:]
    if padding == "CAUSAL":
        pads = [(kt - 1, 0), ((kh - 1) // 2, (kh - 1) // 2),
                ((kw - 1) // 2, (kw - 1) // 2)]
    elif padding == "VALID":
        pads = [(0, 0)] * 3
    else:
        pads = padding
    xc = x.permute(0, 4, 1, 2, 3)
    (t0, t1), (h0, h1), (w0, w1) = pads
    sym = (h0 == h1 and w0 == w1)
    if t0 or t1 or not sym:
        xc = F.pad(xc, (w0, w1, h0, h1, t0, t1) if not sym
                   else (0, 0, 0, 0, t0, t1))
    y = F.conv3d(xc, w.to(x.dtype),
                 None if b is None else b.to(x.dtype), stride=stride,
                 padding=(0, h0, w0) if sym else 0)
    return y.permute(0, 2, 3, 4, 1)


def causal_conv_stream(p, x, stream: Optional[Stream]):
    """CausalConv3d with streaming cache = last 2 input frames of the
    stream, zero-filled before the stream starts."""
    w, b = p.w, p.b
    kt = w.shape[2]
    if stream is None or kt == 1:
        return conv3d(x, w, b)
    if stream.first:
        y = conv3d(x, w, b)
        tail = x[:, -CACHE_T:]
        if tail.shape[1] < CACHE_T:
            tail = F.pad(tail, (0, 0, 0, 0, 0, 0, CACHE_T - tail.shape[1], 0))
    else:
        cache = stream.pull()
        xin = torch.cat([cache.to(x.dtype), x], dim=1)
        y = conv3d(xin, w, b, padding=[(0, 0), (1, 1), (1, 1)])
        tail = xin[:, -CACHE_T:]
    stream.push(tail)
    return y


def conv2d_per_frame(x, w, b=None, *, stride=(1, 1), padding="SAME"):
    """2D conv applied framewise; w [Cout, Cin, 1, kh, kw]."""
    kh, kw = w.shape[3:]
    if padding == "SAME":
        pads = [(0, 0), ((kh - 1) // 2, (kh - 1) // 2),
                ((kw - 1) // 2, (kw - 1) // 2)]
    elif padding == "ZEROPAD_RB":
        # ZeroPad2d((0, 1, 0, 1)) + stride-2 3x3 conv
        pads = [(0, 0), (0, 1), (0, 1)]
    else:
        pads = padding
    return conv3d(x, w, b, stride=(1,) + tuple(stride), padding=pads)


def vae_rms_norm(x, gamma):
    """Channel-wise F.normalize RMS norm."""
    return unn.l2_normalize_rms(x, gamma.to(x.dtype), dim=-1)


def nearest_up2x(x):
    """Nearest 2x spatial upsample (pixel repeat)."""
    b, t, h, w, c = x.shape
    x = x[:, :, :, None, :, None, :].expand(b, t, h, 2, w, 2, c)
    return x.reshape(b, t, h * 2, w * 2, c)


# ---------------------------------------------------------------------------
# temporal resampling
# ---------------------------------------------------------------------------


def time_down_conv(p, x, stream: Optional[Stream]):
    """downsample3d time conv: frame 0 passes through, stride-2 windows;
    streaming cache = last frame."""
    w, b = p.w, p.b
    if stream is None:
        if x.shape[1] < w.shape[2]:
            # no full window (the single-frame i2v encode): the valid conv
            # has no output frame, frame 0 passes alone
            return x[:, :1]
        body = conv3d(x, w, b, stride=(2, 1, 1), padding="VALID")
        return torch.cat([x[:, :1], body], dim=1)
    if stream.first:
        stream.push(x[:, -1:])
        return x
    cache = stream.pull()
    xin = torch.cat([cache.to(x.dtype), x], dim=1)
    y = conv3d(xin, w, b, stride=(2, 1, 1), padding="VALID")
    stream.push(x[:, -1:])
    return y


def time_up_conv(p, x, stream: Optional[Stream]):
    """upsample3d time conv ("Rep" semantics): frame 0 bypasses, the
    2x-channel conv output interleaves into twice the frames."""
    w, b = p.w, p.b
    c = x.shape[-1]

    def interleave(y):
        bb, tt, hh, ww, _ = y.shape
        y = y.reshape(bb, tt, hh, ww, 2, c).permute(0, 1, 4, 2, 3, 5)
        return y.reshape(bb, tt * 2, hh, ww, c)

    if stream is None:
        if x.shape[1] == 1:
            return x
        y = conv3d(x[:, 1:], w, b)
        return torch.cat([x[:, :1], interleave(y)], dim=1)
    if stream.first:
        stream.push(torch.zeros((x.shape[0], CACHE_T) + tuple(x.shape[2:]),
                                dtype=x.dtype, device=x.device))
        return x
    cache = stream.pull()
    xin = torch.cat([cache.to(x.dtype), x], dim=1)
    y = conv3d(xin, w, b, padding=[(0, 0), (0, 0), (0, 0)])
    stream.push(xin[:, -CACHE_T:])
    return interleave(y)


# ---------------------------------------------------------------------------
# shortcut resamplers
# ---------------------------------------------------------------------------


def avg_down3d(x, out_c, ft, fs):
    """AvgDown3D: front-pad T to a multiple of ft, group channels as
    (C, ft, fs, fs) and average each group."""
    b, t, h, w, c = x.shape
    pad_t = (ft - t % ft) % ft
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, pad_t, 0))
        t += pad_t
    factor = ft * fs * fs
    x = x.reshape(b, t // ft, ft, h // fs, fs, w // fs, fs, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(b, t // ft, h // fs, w // fs, c * factor)
    group = c * factor // out_c
    return x.reshape(*x.shape[:-1], out_c, group).mean(dim=-1)


def dup_up3d(x, out_c, ft, fs, first_chunk: bool):
    """DupUp3D: channel repeat -> (C, ft, fs, fs) unpack; the first chunk
    drops its leading ft-1 frames."""
    b, t, h, w, c = x.shape
    repeats = out_c * ft * fs * fs // c
    x = torch.repeat_interleave(x, repeats, dim=-1)
    x = x.reshape(b, t, h, w, out_c, ft, fs, fs)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(b, t * ft, h * fs, w * fs, out_c)
    if first_chunk:
        x = x[:, ft - 1:]
    return x


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def residual_block(p, x, stream: Optional[Stream]):
    """RMSnorm-SiLU-conv x2 with shortcut."""
    h = causal_conv_stream(p["shortcut"], x, None) if "shortcut" in p else x
    y = unn.silu(vae_rms_norm(x, p["norm1"]))
    y = causal_conv_stream(p["conv1"], y, stream)
    y = unn.silu(vae_rms_norm(y, p["norm2"]))
    y = causal_conv_stream(p["conv2"], y, stream)
    return y + h


def attention_block(p, x):
    """Single-head per-frame spatial attention (one flash launch per
    chunk: the frames of the chunk form its batch)."""
    b, t, h, w, c = x.shape
    y = vae_rms_norm(x, p["norm"]).reshape(b * t, h * w, c)
    qkv = unn.linear(p["qkv"], y)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    o = attention(q[:, :, None, :].contiguous(), k[:, :, None, :].contiguous(),
                  v[:, :, None, :].contiguous())
    o = unn.linear(p["proj"], o[:, :, 0, :])
    return x + o.reshape(b, t, h, w, c)


def spatial_resample(p, x, mode):
    if mode == "up":
        return conv2d_per_frame(nearest_up2x(x), p.w, p.b)
    if mode == "down":
        return conv2d_per_frame(x, p.w, p.b, stride=(2, 2),
                                padding="ZEROPAD_RB")
    return x


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


def _enc_dims(cfg: WanVAEConfig):
    return [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]


def _dec_dims(cfg: WanVAEConfig):
    m = tuple(cfg.dim_mult)
    return [cfg.dec_dim * u for u in (m[-1],) + m[::-1]]


def encoder_forward(p, cfg: WanVAEConfig, x, stream: Optional[Stream]):
    """Encoder3d. x: [B, T, H, W, 3*p*p] patchified."""
    dims = _enc_dims(cfg)
    x = causal_conv_stream(p["conv1"], x, stream)
    for i in range(len(cfg.dim_mult)):
        sp = p[f"down{i}"]
        t_down = cfg.temporal_downsample[i] if i < len(
            cfg.temporal_downsample) else False
        down_flag = i != len(cfg.dim_mult) - 1
        x_copy = x
        for j in range(cfg.num_res_blocks):
            x = residual_block(sp[f"res{j}"], x, stream)
        if down_flag:
            x = spatial_resample(sp["resample"], x, "down")
            if t_down:
                x = time_down_conv(sp["time_conv"], x, stream)
        x = x + avg_down3d(x_copy, dims[i + 1], 2 if t_down else 1,
                           2 if down_flag else 1)
    x = residual_block(p["mid_res1"], x, stream)
    x = attention_block(p["mid_attn"], x)
    x = residual_block(p["mid_res2"], x, stream)
    x = unn.silu(vae_rms_norm(x, p["head_norm"]))
    return causal_conv_stream(p["head_conv"], x, stream)


def decoder_forward(p, cfg: WanVAEConfig, x, stream: Optional[Stream],
                    first_chunk: bool):
    """Decoder3d. x: [B, T, h, w, z]."""
    dims = _dec_dims(cfg)
    ups = cfg.temporal_upsample
    x = causal_conv_stream(p["conv1"], x, stream)
    x = residual_block(p["mid_res1"], x, stream)
    x = attention_block(p["mid_attn"], x)
    x = residual_block(p["mid_res2"], x, stream)
    for i in range(len(cfg.dim_mult)):
        sp = p[f"up{i}"]
        t_up = ups[i] if i < len(ups) else False
        up_flag = i != len(cfg.dim_mult) - 1
        x_in = x
        for j in range(cfg.num_res_blocks + 1):
            x = residual_block(sp[f"res{j}"], x, stream)
        if up_flag:
            if t_up:
                x = time_up_conv(sp["time_conv"], x, stream)
            x = spatial_resample(sp["resample"], x, "up")
            x = x + dup_up3d(x_in, dims[i + 1], 2 if t_up else 1, 2,
                             first_chunk)
    x = unn.silu(vae_rms_norm(x, p["head_norm"]))
    return causal_conv_stream(p["head_conv"], x, stream)
