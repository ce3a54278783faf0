"""FLUX.1-Kontext rectified-flow image-editing transformer.

Counterpart of univid_tpu/models/flux/kontext.py, with the same numerics:
the guidance-distilled MMDiT (19 double-stream blocks with separate image
and text streams joined for attention, 38 single-stream blocks over the
joined sequence, text first), 3-axis RoPE over (set, y, x) token ids built
in float64 numpy, AdaLN modulation from time + guidance + CLIP-pooled
conditioning in fp32, and Kontext's reference image as extra tokens behind
the target's with ids offset on the first RoPE axis.

The double and single blocks are nn.ModuleLists, one module a block (the
JAX tree's stacked [depth, ...] leaves), with weights in the port's
[out, in] layout. q and k take a per-head RMS norm (a [head_dim] gain, eps
1e-6) and the pair rotation in fp32 in plain torch before the attention
call, as JAX rotates them in XLA outside its kernel; the joint attention
(bf16 d=128, no mask, running max) is `kernels.attention.attention`: the
card's `flash_attention_sm90.cu`, the plain version on the CPU.

A model sharded by `parallel.sharding.shard_params` with
`flux_param_sharding_rules` runs in the same forward: each FSDP unit (the
root, each block) is gathered around its use (`gathered`), and on a mesh
with tp > 1 the forward runs the tp collectives itself. The fused
projections (qkv [3d, d], a single block's linear1 [3d + mlp, d], the
modulations [6d, d] / [3d, d]) are split by the rules into contiguous row
shards that hold no whole heads or chunks, so the port gathers their
fused output over tp and each rank takes its own heads (N / tp) of q, k
and v from the whole. proj and the FFN's fc0 / fc1 are split as JAX's
values require (column-parallel fc0, row-parallel proj and fc1 over the
rank's heads and hidden units). linear2 reads the whole [attn, gelu(mlp)]
(the attention output gathered over tp) and takes the rank's columns as a
row-parallel projection. The tp forward has no backward (no trainer of
either package differentiates FLUX): it refuses to run under grad.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core import nn as unn
from ...core.dtypes import DEFAULT_POLICY, DTypePolicy
from ...kernels.attention import attention
from ...ops.rope import apply_rope
from ...parallel.sharding import gathered
from ...parallel.tensor_parallel import (copy_to_tp, gather_from_tp,
                                         row_parallel_linear, tp_of)


@dataclass(frozen=True)
class FluxConfig:
    """flux1-kontext-dev geometry (BFL reference params: in_channels=64,
    hidden 3072, 24 heads, mlp_ratio 4, depth 19/38, axes_dim
    (16, 56, 56), theta 10_000, guidance-embedded)."""

    in_channels: int = 64
    out_channels: int = 64
    hidden_size: int = 3072
    num_heads: int = 24
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    axes_dim: Tuple[int, int, int] = (16, 56, 56)
    theta: float = 10000.0
    context_dim: int = 4096     # T5-XXL features
    vec_dim: int = 768          # CLIP-L pooled
    guidance_embed: bool = True
    time_freq_dim: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


# tiny geometry for tests / mock pipelines
TINY_FLUX = FluxConfig(in_channels=16, out_channels=16, hidden_size=128,
                       num_heads=2, depth_double=2, depth_single=2,
                       axes_dim=(16, 24, 24), context_dim=32, vec_dim=32,
                       time_freq_dim=32)


# ---------------------------------------------------------------------------
# latent <-> token packing (diffusers FluxKontextPipeline._pack_latents)
# ---------------------------------------------------------------------------


def pack_latents(z: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] channels-last latent -> [B, (h/2)*(w/2), 4C] tokens,
    each token ordered (c, py, px)."""
    b, h, w, c = z.shape
    z = z.reshape(b, h // 2, 2, w // 2, 2, c)
    z = z.permute(0, 1, 3, 5, 2, 4)            # [B, h/2, w/2, C, 2, 2]
    return z.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, grid_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """[B, gh*gw, 4C] -> [B, 2*gh, 2*gw, C] (inverse of pack_latents)."""
    b = tokens.shape[0]
    gh, gw = grid_hw
    c4 = tokens.shape[-1]
    z = tokens.reshape(b, gh, gw, c4 // 4, 2, 2)
    z = z.permute(0, 1, 4, 2, 5, 3)            # [B, gh, 2, gw, 2, C]
    return z.reshape(b, gh * 2, gw * 2, c4 // 4)


def image_token_ids(grid_hw: Tuple[int, int], set_id: int = 0
                    ) -> np.ndarray:
    """[gh*gw, 3] float64 (set, y, x) RoPE ids of one packed latent grid:
    the target grid on set 0, Kontext's reference grid on set 1."""
    gh, gw = grid_hw
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    ids = np.stack([np.full(ys.size, set_id), ys.ravel(), xs.ravel()],
                   axis=-1)
    return ids.astype(np.float64)


def build_rope_from_ids(ids: np.ndarray, axes_dim: Tuple[int, ...],
                        theta: float, device="cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [L, n_axes] -> (cos, sin) fp32, each [L, sum(axes_dim) // 2]: per
    axis a, angles pos * theta^(-2k / axes_dim[a]) in float64, the bands
    concatenated along the half-channel dim (adjacent-pair rotation,
    `ops.rope.apply_rope`)."""
    bands = []
    for a, d in enumerate(axes_dim):
        half = d // 2
        inv = theta ** (-np.arange(half, dtype=np.float64) * 2.0 / d)
        bands.append(np.outer(ids[:, a].astype(np.float64), inv))
    full = np.concatenate(bands, axis=-1)
    return (torch.as_tensor(np.cos(full).astype(np.float32), device=device),
            torch.as_tensor(np.sin(full).astype(np.float32), device=device))


def timestep_embedding(t: torch.Tensor, dim: int, *,
                       max_period: float = 10000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """[B] -> [B, dim] fp32: t scaled by time_factor, cos half first."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# parameters (named as the JAX tree of init_flux)
# ---------------------------------------------------------------------------


class Flux(nn.Module):
    """Every parameter of init_flux: img_in, txt_in, time_in / vector_in /
    guidance_in (in_layer, out_layer), final_layer (linear, adaLN),
    double_blocks.{i}.{img,txt} (mod, qkv, norm_q, norm_k, proj, mlp.fc0 /
    fc1) and single_blocks.{i} (mod, linear1, norm_q, norm_k, linear2).
    With `gen`, drawn as the JAX init draws them (xavier-uniform linears,
    zero biases, unit gains); else left empty, to be loaded."""

    def __init__(self, cfg: FluxConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, dh = cfg.hidden_size, cfg.head_dim
        kw = dict(dtype=dtype, device=device, gen=gen)

        def lin(i, o):
            return unn.Linear(i, o, **kw)

        def embedder(i):
            return unn.Node(in_layer=lin(i, d), out_layer=lin(d, d))

        def gain():
            return unn.param((dh,), dtype, device, init="ones")

        def stream():
            return unn.Node(mod=lin(d, 6 * d), qkv=lin(d, 3 * d),
                            norm_q=gain(), norm_k=gain(), proj=lin(d, d),
                            mlp=unn.mlp((d, cfg.mlp_dim, d), **kw))

        self.img_in = lin(cfg.in_channels, d)
        self.txt_in = lin(cfg.context_dim, d)
        self.time_in = embedder(cfg.time_freq_dim)
        self.vector_in = embedder(cfg.vec_dim)
        # random (not AdaLN-zero) head, as JAX's: a zeroed head would make
        # every mock output identically zero
        self.final_layer = unn.Node(linear=lin(d, cfg.out_channels),
                                    adaLN=lin(d, 2 * d))
        if cfg.guidance_embed:
            self.guidance_in = embedder(cfg.time_freq_dim)
        self.double_blocks = nn.ModuleList(
            unn.Node(img=stream(), txt=stream())
            for _ in range(cfg.depth_double))
        self.single_blocks = nn.ModuleList(
            unn.Node(mod=lin(d, 3 * d), linear1=lin(d, 3 * d + cfg.mlp_dim),
                     norm_q=gain(), norm_k=gain(),
                     linear2=lin(d + cfg.mlp_dim, d))
            for _ in range(cfg.depth_single))

    def forward(self, img_tokens, txt, t, **kw):
        return flux_forward(self, self.cfg, img_tokens, txt, t, **kw)


def init_flux(gen: Optional[torch.Generator], cfg: FluxConfig, *,
              dtype=torch.float32, device="cuda") -> Flux:
    return Flux(cfg, dtype=dtype, device=device, gen=gen)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _mlp_embed(p, x):
    h = unn.linear(p["in_layer"], x, compute_dtype=torch.float32)
    return unn.linear(p["out_layer"], unn.silu(h),
                      compute_dtype=torch.float32)


def _mod(p_lin, vec, n_chunks, tp):
    """AdaLN modulation: lin(silu(vec)) -> n_chunks x [B, 1, d] fp32 (the
    whole vector, gathered over tp)."""
    m = unn.linear(p_lin, copy_to_tp(unn.silu(vec), tp),
                   compute_dtype=torch.float32)
    return gather_from_tp(m, tp)[:, None, :].chunk(n_chunks, dim=-1)


def _modulated(x, shift, scale):
    return unn.layer_norm(x.float()) * (1 + scale) + shift


def _heads_qkv(qkv, p, cfg: FluxConfig, tp):
    """The fused q | k | v rows [B, L, 3d] -> this rank's heads of q, k and
    v [B, L, n, dh] (n = N / tp), q and k RMS-normed per head in fp32."""
    b, l, _ = qkv.shape
    n, dh = cfg.num_heads, cfg.head_dim
    q, k, v = (t.reshape(b, l, n, dh) for t in qkv.chunk(3, dim=-1))
    if tp is not None:
        heads = tp.slice(n)
        q, k, v = q[:, :, heads], k[:, :, heads], v[:, :, heads]
    q = unn.rms_norm(q.float(), p["norm_q"].float(), eps=1e-6)
    k = unn.rms_norm(k.float(), p["norm_k"].float(), eps=1e-6)
    return q, k, v


def _joint_attention(q, k, v, cos, sin, policy):
    """q / k / v [B, L, n, D] -> [B, L, n * D]: q and k rotated in fp32,
    then the flash kernel in the compute dtype."""
    cd = policy.compute_dtype
    q = apply_rope(q, cos, sin).to(cd)
    k = apply_rope(k, cos, sin).to(cd)
    out = attention(q, k, v.to(cd))
    b, l, n, dh = out.shape
    return out.reshape(b, l, n * dh)


def _gated(x, gate, y, policy):
    """x + gate * y, the residual in the policy's dtype."""
    return x + (gate * y.float()).to(policy.residual_dtype)


def _double_block(bp, cfg, img, txt_h, vec, cos, sin, policy, tp):
    cd = policy.compute_dtype
    l_txt = txt_h.shape[1]
    mods = {s: _mod(bp[s]["mod"], vec, 6, tp) for s in ("img", "txt")}

    def qkv_of(s, x):
        sh, sc = mods[s][0], mods[s][1]
        xm = _modulated(x, sh, sc).to(cd)
        y = unn.linear(bp[s]["qkv"], copy_to_tp(xm, tp), compute_dtype=cd)
        return _heads_qkv(gather_from_tp(y, tp), bp[s], cfg, tp)

    iq, ik, iv = qkv_of("img", img)
    tq, tk, tv = qkv_of("txt", txt_h)
    # joint attention, text first (the published ordering)
    attn = _joint_attention(torch.cat([tq, iq], dim=1),
                            torch.cat([tk, ik], dim=1),
                            torch.cat([tv, iv], dim=1), cos, sin, policy)
    del iq, ik, iv, tq, tk, tv

    def out_of(s, x, a):
        _, _, g1, sh2, sc2, g2 = mods[s]
        sp = bp[s]
        x = _gated(x, g1, row_parallel_linear(sp["proj"], a, tp, cd), policy)
        xm = _modulated(x, sh2, sc2).to(cd)
        h = unn.gelu_tanh(unn.linear(sp["mlp"]["fc0"], copy_to_tp(xm, tp),
                                     compute_dtype=cd))
        return _gated(x, g2, row_parallel_linear(sp["mlp"]["fc1"], h, tp,
                                                 cd), policy)

    return (out_of("img", img, attn[:, l_txt:]),
            out_of("txt", txt_h, attn[:, :l_txt]))


def _single_block(bp, cfg, x, vec, cos, sin, policy, tp):
    cd = policy.compute_dtype
    d = cfg.hidden_size
    sh, sc, g = _mod(bp["mod"], vec, 3, tp)
    xm = _modulated(x, sh, sc).to(cd)
    h = gather_from_tp(unn.linear(bp["linear1"], copy_to_tp(xm, tp),
                                  compute_dtype=cd), tp)
    q, k, v = _heads_qkv(h[..., :3 * d], bp, cfg, tp)
    attn = gather_from_tp(_joint_attention(q, k, v, cos, sin, policy), tp)
    del q, k, v
    y = torch.cat([attn, unn.gelu_tanh(h[..., 3 * d:])], dim=-1)
    del h, attn
    if tp is not None:
        y = y[..., tp.slice(y.shape[-1])]
    return _gated(x, g, row_parallel_linear(bp["linear2"], y, tp, cd),
                  policy)


def flux_forward(model: Flux, cfg: FluxConfig, img_tokens: torch.Tensor,
                 txt: torch.Tensor, t: torch.Tensor, *,
                 guidance: Optional[torch.Tensor] = None,
                 clip_pooled: Optional[torch.Tensor] = None,
                 rope_tables: Tuple[torch.Tensor, torch.Tensor],
                 policy: DTypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """One transformer evaluation: velocity tokens [B, L_img, out_channels]
    in the compute dtype (reference rows included; the pipeline drops
    them).

    img_tokens [B, L_img, in_channels]: the packed target latents with
    Kontext's reference tokens behind them; txt [B, L_txt, context_dim]
    (T5 features); t [B] the current sigma in [0, 1]; guidance [B] the
    distilled guidance scale (required when cfg.guidance_embed);
    clip_pooled [B, vec_dim] (zeros when None); rope_tables (cos, sin)
    [L_txt + L_img, head_dim // 2] from `build_rope_from_ids` over the
    text, target and reference ids."""
    tp = tp_of(model)
    if tp is not None and torch.is_grad_enabled():
        raise NotImplementedError(
            "the tensor-parallel FLUX forward has no backward: run it under "
            "torch.no_grad()")
    b = img_tokens.shape[0]
    l_txt = txt.shape[1]
    cd, rdt = policy.compute_dtype, policy.residual_dtype
    cos, sin = rope_tables

    with gathered(model):
        img = unn.linear(model.img_in, img_tokens.to(cd),
                         compute_dtype=cd).to(rdt)
        txt_h = unn.linear(model.txt_in, txt.to(cd), compute_dtype=cd).to(rdt)
        # conditioning vector (fp32 island)
        vec = _mlp_embed(model.time_in,
                         timestep_embedding(t, cfg.time_freq_dim))
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("cfg.guidance_embed requires guidance")
            vec = vec + _mlp_embed(model.guidance_in,
                                   timestep_embedding(guidance,
                                                      cfg.time_freq_dim))
        if clip_pooled is None:
            clip_pooled = torch.zeros((b, cfg.vec_dim), dtype=torch.float32,
                                      device=img_tokens.device)
        vec = vec + _mlp_embed(model.vector_in, clip_pooled.float())

    for bp in model.double_blocks:
        with gathered(bp):
            img, txt_h = _double_block(bp, cfg, img, txt_h, vec, cos, sin,
                                       policy, tp)
    x = torch.cat([txt_h, img], dim=1)
    del img, txt_h
    for bp in model.single_blocks:
        with gathered(bp):
            x = _single_block(bp, cfg, x, vec, cos, sin, policy, tp)
    x = x[:, l_txt:]

    with gathered(model):
        # final AdaLN head: chunk order (shift, scale)
        fl = model.final_layer
        m = unn.linear(fl["adaLN"], unn.silu(vec),
                       compute_dtype=torch.float32)
        sh, sc = m[:, None, :].chunk(2, dim=-1)
        x = _modulated(x, sh, sc)
        return unn.linear(fl["linear"], x.to(cd), compute_dtype=cd)
