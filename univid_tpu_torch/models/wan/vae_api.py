"""Wan video VAE: parameters and the public encode / decode.

Counterpart of univid_tpu/models/wan/vae_api.py: spatial patchify, per-
channel latent normalisation for the 48-channel Wan2.2 VAE, decode clamped
to [-1, 1], and streaming decode one latent frame at a time (the first
frame alone, then `decode_chunk` latent frames per chunk with the causal
caches carried across), which equals the full-sequence decode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ...core import nn as unn
from ...core.config import WanVAEConfig
from .vae import (Stream, _dec_dims, _enc_dims, causal_conv_stream,
                  decoder_forward, encoder_forward)

# Per-channel latent statistics of the pretrained Wan2.2 VAE (model data)
WAN22_LATENT_MEAN = np.array([
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
], dtype=np.float32)

WAN22_LATENT_STD = np.array([
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
], dtype=np.float32)


# ---------------------------------------------------------------------------
# parameters (names follow the JAX tree of init_wan_vae)
# ---------------------------------------------------------------------------


class _Factory:
    """Draws VAE parameters with the distributions of init_wan_vae: convs
    normal / sqrt(fan_in) with zero bias, norms ones, attention qkv
    xavier-uniform and proj zeros; empty when gen is None."""

    def __init__(self, dtype, device, gen):
        self.dtype, self.device, self.gen = dtype, device, gen

    def p(self, shape, init, std=1.0):
        return unn.param(shape, self.dtype, self.device, self.gen, init,
                         std=std)

    def conv(self, kt, kh, kw, cin, cout):
        fan_in = kt * kh * kw * cin
        return unn.Node(w=self.p((cout, cin, kt, kh, kw), "normal",
                                 fan_in ** -0.5),
                        b=self.p((cout,), "zeros"))

    def resample(self, c):
        # 2D 3x3 conv, stored as a kt=1 conv3d
        return unn.Node(w=self.p((c, c, 1, 3, 3), "normal",
                                 (9 * c) ** -0.5),
                        b=self.p((c,), "zeros"))

    def res(self, cin, cout):
        d = dict(norm1=self.p((cin,), "ones"),
                 conv1=self.conv(3, 3, 3, cin, cout),
                 norm2=self.p((cout,), "ones"),
                 conv2=self.conv(3, 3, 3, cout, cout))
        if cin != cout:
            d["shortcut"] = self.conv(1, 1, 1, cin, cout)
        return unn.Node(**d)

    def attn(self, c):
        kw = dict(dtype=self.dtype, device=self.device, gen=self.gen)
        return unn.Node(norm=self.p((c,), "ones"),
                        qkv=unn.Linear(c, 3 * c, **kw),
                        proj=unn.Linear(c, c, init="zeros", **kw))


class WanVAE(nn.Module):
    def __init__(self, cfg: WanVAEConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        fc = _Factory(dtype, device, gen)
        in_ch = 3 * cfg.spatial_patch ** 2
        enc_dims, dec_dims = _enc_dims(cfg), _dec_dims(cfg)
        z2 = cfg.z_dim * 2

        enc = {"conv1": fc.conv(3, 3, 3, in_ch, enc_dims[0])}
        for i in range(len(cfg.dim_mult)):
            cin, cout = enc_dims[i], enc_dims[i + 1]
            t_down = cfg.temporal_downsample[i] if i < len(
                cfg.temporal_downsample) else False
            sp = {f"res{j}": fc.res(cin if j == 0 else cout, cout)
                  for j in range(cfg.num_res_blocks)}
            if i != len(cfg.dim_mult) - 1:
                sp["resample"] = fc.resample(cout)
                if t_down:
                    sp["time_conv"] = fc.conv(3, 1, 1, cout, cout)
            enc[f"down{i}"] = unn.Node(**sp)
        c_mid = enc_dims[-1]
        enc.update(mid_res1=fc.res(c_mid, c_mid), mid_attn=fc.attn(c_mid),
                   mid_res2=fc.res(c_mid, c_mid),
                   head_norm=fc.p((c_mid,), "ones"),
                   head_conv=fc.conv(3, 3, 3, c_mid, z2))

        dec = {"conv1": fc.conv(3, 3, 3, cfg.z_dim, dec_dims[0]),
               "mid_res1": fc.res(dec_dims[0], dec_dims[0]),
               "mid_attn": fc.attn(dec_dims[0]),
               "mid_res2": fc.res(dec_dims[0], dec_dims[0])}
        ups = cfg.temporal_upsample
        for i in range(len(cfg.dim_mult)):
            cin, cout = dec_dims[i], dec_dims[i + 1]
            t_up = ups[i] if i < len(ups) else False
            sp = {f"res{j}": fc.res(cin if j == 0 else cout, cout)
                  for j in range(cfg.num_res_blocks + 1)}
            if i != len(cfg.dim_mult) - 1:
                if t_up:
                    sp["time_conv"] = fc.conv(3, 1, 1, cout, 2 * cout)
                sp["resample"] = fc.resample(cout)
            dec[f"up{i}"] = unn.Node(**sp)
        dec.update(head_norm=fc.p((dec_dims[-1],), "ones"),
                   head_conv=fc.conv(3, 3, 3, dec_dims[-1], in_ch))

        self.encoder = unn.Node(**enc)
        self.decoder = unn.Node(**dec)
        self.conv_mu = fc.conv(1, 1, 1, z2, z2)
        self.conv_z = fc.conv(1, 1, 1, cfg.z_dim, cfg.z_dim)


# ---------------------------------------------------------------------------
# patchify / normalisation
# ---------------------------------------------------------------------------


def spatial_patchify(x, p):
    """[B,T,H,W,C] -> [B,T,H/p,W/p,C*p*p], channel order (c, w_off, h_off)."""
    if p == 1:
        return x
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 2, 4, 6, 5, 3)
    return x.reshape(b, t, h // p, w // p, c * p * p)


def spatial_unpatchify(x, p):
    if p == 1:
        return x
    b, t, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, t, h, w, c, p, p)
    x = x.permute(0, 1, 2, 6, 3, 5, 4)
    return x.reshape(b, t, h * p, w * p, c)


def _normalize(mu, cfg):
    if cfg.z_dim == 48:
        mean = torch.as_tensor(WAN22_LATENT_MEAN, device=mu.device)
        std = torch.as_tensor(WAN22_LATENT_STD, device=mu.device)
        return (mu - mean) / std
    return mu


def _denormalize(z, cfg):
    if cfg.z_dim == 48:
        mean = torch.as_tensor(WAN22_LATENT_MEAN, device=z.device)
        std = torch.as_tensor(WAN22_LATENT_STD, device=z.device)
        return z * std + mean
    return z


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def vae_encode(vae: WanVAE, video: torch.Tensor, streaming: bool = True
               ) -> torch.Tensor:
    """video [B, T, H, W, 3] in [-1,1], T = 1 + 4k -> normalised latent
    [B, 1+k, H/s, W/s, z] (deterministic: the mean)."""
    cfg = vae.cfg
    x = spatial_patchify(video, cfg.spatial_patch)
    t = x.shape[1]
    if not streaming or t == 1:
        out = encoder_forward(vae.encoder, cfg, x, None)
    else:
        s = Stream(None)
        outs = [encoder_forward(vae.encoder, cfg, x[:, :1], s)]
        cache = s.done()
        nchunks = (t - 1) // cfg.encode_chunk
        for i in range(nchunks):
            a = 1 + i * cfg.encode_chunk
            s = Stream(cache)
            outs.append(encoder_forward(vae.encoder, cfg,
                                        x[:, a:a + cfg.encode_chunk], s))
            cache = s.done()
        out = torch.cat(outs, dim=1)
    moments = causal_conv_stream(vae.conv_mu, out, None)
    return _normalize(moments[..., :cfg.z_dim], cfg)


@torch.no_grad()
def vae_decode(vae: WanVAE, z: torch.Tensor, streaming: bool = True
               ) -> torch.Tensor:
    """normalised latent [B, T', h, w, z] -> video [B, T, H, W, 3] in
    [-1, 1] (clamped), T = 1 + 4 * (T' - 1)."""
    cfg = vae.cfg
    z = _denormalize(z, cfg)
    x = causal_conv_stream(vae.conv_z, z, None)
    t = x.shape[1]
    if not streaming:
        out = decoder_forward(vae.decoder, cfg, x, None, first_chunk=True)
    else:
        s = Stream(None)
        outs = [decoder_forward(vae.decoder, cfg, x[:, :1], s,
                                first_chunk=True)]
        cache = s.done()
        ck = max(int(cfg.decode_chunk), 1)
        if (t - 1) % ck:
            ck = 1
        for a in range(1, t, ck):
            s = Stream(cache)
            outs.append(decoder_forward(vae.decoder, cfg, x[:, a:a + ck], s,
                                        first_chunk=False))
            cache = s.done()
        out = torch.cat(outs, dim=1)
    out = spatial_unpatchify(out, cfg.spatial_patch)
    return out.clamp(-1.0, 1.0)
