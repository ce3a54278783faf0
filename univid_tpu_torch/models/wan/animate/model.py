"""WanAnimate DiT (character animation and replacement) on one GPU.

Counterpart of univid_tpu/models/wan/animate/model.py::wan_animate_forward,
with its numerics:
  * in_dim 36 = latent (16) + i2v conditioning y (4 mask + 16 latent); the
    pose latents' own patch embedding is added to the video tokens of
    every latent frame but the first (the reference frame's slot);
  * the face path: LIA motion vectors of every face crop -> FaceEncoder ->
    a zero pad frame prepended for the reference slot; a FaceBlock (fp32)
    adds its residual after blocks 0, 5, 10, ... (adapter
    min(idx // 5, adapter_layers - 1));
  * a per-sample fp32 time embedding and AdaLN-6 modulation (fp32
    islands), the residual stream in fp32 whatever the policy (as JAX's);
  * the context: the CLIP image tokens through img_emb (LayerNorm, fp32
    linears, exact GELU, LayerNorm) and the text through its tanh-GELU
    MLP; cross-attention runs the text call and the image call (k_img /
    v_img) with one normed q and sums them before `o`, each with its own
    score bound under `bounded_softmax`;
  * self-attention takes q and k before their qk RMS norm (over each
    token's N * D width) and rope: `attention(rope_tables=..., qk_norm=...)`
    norms and rotates them (kernel A of qk_prepass.cu on the card's bf16
    d=128 route, `rms_heads` and `rotate` elsewhere; JAX norms, rotates in
    fp32 and casts outside its kernel, the same function up to where the
    rounding to bf16 falls); the bound only under `bounded_softmax`,
    `softmax_bf16` threaded through;
  * the two-way modulated head.
Parameters keep the JAX tree's names; its stacked `blocks` and
`face_adapter` leaves become ModuleLists of one module a block, in the
port's [out, in] layout (`blocks.{l}.{self_attn,cross_attn}.{q,k,v,o}.w`,
so train/lora.merge_lora merges a LoRA unchanged). Leaf dtypes are the
checkpoint converter's: `dtype` for the DiT, fp32 for the time embedding,
time projection, head, modulations, the motion encoder and the face
encoder's convolutions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ....core import nn as unn
from ....core.dtypes import DEFAULT_POLICY, DTypePolicy
from ....kernels.attention import attention
from ....kernels.flash_attention import build_fused_rope_tables, rms_heads
from ....ops.embeddings import sinusoidal_embedding_1d
from ....ops.rope import build_rope_3d
from ..dit import (WanBlock, _norm_heads, _qk_bound, patchify_latent,
                   unpatchify_tokens)
from .face_blocks import (face_block_forward, face_encoder_forward,
                          init_face_block, init_face_encoder)
from .motion_encoder import get_motion, init_motion_encoder


@dataclass(frozen=True)
class WanAnimateConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 36
    dim: int = 5120
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 40
    num_layers: int = 40
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    motion_encoder_dim: int = 512
    use_img_emb: bool = True
    clip_tokens: int = 257
    clip_dim: int = 1280
    motion_size: int = 512
    motion_dim: int = 20
    vae_z_dim: int = 16          # pose latents / y channels
    face_width: int = 1024       # FaceEncoder conv width
    motion_channels: tuple = ()  # override CHANNELS for tiny configs

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def adapter_layers(self) -> int:
        return self.num_layers // 5


F32 = torch.float32


class WanAnimate(nn.Module):
    """Parameters of init_wan_animate. With `gen`, drawn on `device` from
    the distributions of the JAX init (xavier-uniform linears, normal(0.02)
    text / time embeddings, a zero head, normal / sqrt(d) modulations, the
    motion and face encoders' own draws); without, left empty to be loaded.
    `dtype` is the DiT's; the fp32 leaves stay fp32 (see the module
    docstring)."""

    def __init__(self, cfg: WanAnimateConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        pt, ph, pw = cfg.patch_size
        kw = dict(dtype=dtype, device=device, gen=gen)
        k32 = dict(kw, dtype=F32)
        self.patch_embed = unn.Linear(pt * ph * pw * cfg.in_dim, d, **kw)
        self.pose_patch_embed = unn.Linear(pt * ph * pw * cfg.vae_z_dim, d,
                                           **kw)
        self.text_embedding = unn.mlp((cfg.text_dim, d, d), init="normal",
                                      **kw)
        self.time_embedding = unn.mlp((cfg.freq_dim, d, d), init="normal",
                                      **k32)
        self.time_projection = unn.mlp((d, d * 6), **k32)
        self.head = unn.Node(
            head=unn.Linear(d, pt * ph * pw * cfg.out_dim, init="zeros",
                            **k32),
            modulation=unn.param((2, d), F32, device, gen, "normal",
                                 std=d ** -0.5))
        if cfg.use_img_emb:
            cd_ = cfg.clip_dim
            self.img_emb = unn.Node(
                ln0=unn.Node(w=unn.param((cd_,), dtype, device, init="ones"),
                             b=unn.param((cd_,), dtype, device,
                                         init="zeros")),
                fc0=unn.Linear(cd_, cd_, **kw), fc1=unn.Linear(cd_, d, **kw),
                ln1=unn.Node(w=unn.param((d,), dtype, device, init="ones"),
                             b=unn.param((d,), dtype, device, init="zeros")))
        blocks = []
        for _ in range(cfg.num_layers):
            blk = WanBlock(cfg, kw)
            blk.modulation = unn.param((6, d), F32, device, gen, "normal",
                                       std=d ** -0.5)
            if cfg.use_img_emb:
                ca = blk.cross_attn
                ca.k_img = unn.Linear(d, d, **kw)
                ca.v_img = unn.Linear(d, d, **kw)
                if cfg.qk_norm:
                    ca.norm_k_img = unn.param((d,), dtype, device,
                                              init="ones")
            blocks.append(blk)
        self.blocks = nn.ModuleList(blocks)
        self.motion_encoder = init_motion_encoder(
            gen, size=cfg.motion_size, dim=cfg.motion_encoder_dim,
            motion_dim=cfg.motion_dim,
            channels=dict(cfg.motion_channels) or None, device=device)
        self.face_encoder = init_face_encoder(
            gen, cfg.motion_encoder_dim, d, num_heads=4,
            width=cfg.face_width, dtype=dtype, device=device)
        self.face_adapter = nn.ModuleList(
            init_face_block(gen, d, cfg.num_heads, dtype=dtype,
                            device=device)
            for _ in range(cfg.adapter_layers))


def init_wan_animate(gen: Optional[torch.Generator], cfg: WanAnimateConfig,
                     *, dtype=torch.float32, device="cuda") -> WanAnimate:
    return WanAnimate(cfg, dtype=dtype, device=device, gen=gen)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _gains(p, names, cd):
    """(gain, gain, eps) for attention()'s qk_norm, in the compute dtype."""
    return p[names[0]].to(cd), p[names[1]].to(cd), 1e-6


def _self_attention(bp, cfg, y, rope_tabs, policy):
    b, l, _ = y.shape
    n, dh, cd = cfg.num_heads, cfg.head_dim, policy.compute_dtype
    sa = bp.self_attn
    q, k, v = (unn.linear(sa[name], y, compute_dtype=cd).reshape(b, l, n, dh)
               for name in ("q", "k", "v"))
    bound = None
    if policy.bounded_softmax and cfg.qk_norm:
        bound = _qk_bound(sa, dh)
    o = attention(q, k, v, rope_tables=rope_tabs,
                  qk_norm=_gains(sa, ("norm_q", "norm_k"), cd)
                  if cfg.qk_norm else None,
                  softmax_bf16=policy.softmax_bf16, score_bound=bound)
    return unn.linear(sa["o"], o.to(cd).reshape(b, l, cfg.dim),
                      compute_dtype=cd)


def _cross_attention(bp, cfg, y, ctx_text, ctx_img, policy):
    """Text and image calls with one q, summed before `o`. The q / k norms
    of the text call run together (kernel A's norm-only mode on the card's
    bf16 d=128 route), the image keys' alone."""
    b, l, _ = y.shape
    n, dh, cd = cfg.num_heads, cfg.head_dim, policy.compute_dtype
    ca = bp.cross_attn

    def kv(kname, vname, ctx):
        lc = ctx.shape[1]
        return (unn.linear(ca[kname], ctx, compute_dtype=cd)
                .reshape(b, lc, n, dh),
                unn.linear(ca[vname], ctx, compute_dtype=cd)
                .reshape(b, lc, n, dh))

    def bound(nk):
        if not (policy.bounded_softmax and cfg.qk_norm):
            return None
        return _qk_bound({"norm_q": ca["norm_q"], "norm_k": ca[nk]}, dh)

    q = unn.linear(ca["q"], y, compute_dtype=cd).reshape(b, l, n, dh)
    k, v = kv("k", "v", ctx_text)
    if cfg.qk_norm:
        q, k = _norm_heads(q, k, _gains(ca, ("norm_q", "norm_k"), cd))
    o = attention(q, k, v, score_bound=bound("norm_k"))
    if ctx_img is not None:
        ki, vi = kv("k_img", "v_img", ctx_img)
        if cfg.qk_norm:
            ki = rms_heads(ki, ca["norm_k_img"].to(cd), 1e-6)
        o = o + attention(q, ki, vi, score_bound=bound("norm_k_img"))
    return unn.linear(ca["o"], o.reshape(b, l, cfg.dim), compute_dtype=cd)


def _block(bp, cfg, x32, e0, ctx_text, ctx_img, rope_tabs, policy):
    cd = policy.compute_dtype
    mod = bp.modulation.float()[None] + e0                 # [B, 6, d]

    def m(i):
        return mod[:, i][:, None]                          # [B, 1, d]

    y = (unn.layer_norm(x32, eps=cfg.eps) * (1 + m(1)) + m(0)).to(cd)
    x32 = x32 + _self_attention(bp, cfg, y, rope_tabs, policy).float() \
        * m(2)

    if hasattr(bp, "norm3"):
        y = unn.layer_norm(x32, weight=bp.norm3["w"].float(),
                           bias=bp.norm3["b"].float(), eps=cfg.eps)
    else:
        y = x32
    x32 = x32 + _cross_attention(bp, cfg, y.to(cd), ctx_text, ctx_img,
                                 policy).float()

    y = (unn.layer_norm(x32, eps=cfg.eps) * (1 + m(4)) + m(3)).to(cd)
    y = unn.gelu_tanh(unn.linear(bp.ffn["fc0"], y, compute_dtype=cd))
    y = unn.linear(bp.ffn["fc1"], y, compute_dtype=cd)
    return x32 + y.float() * m(5)


def _context(model: WanAnimate, context, clip_fea, cd):
    """(text context [B, text_len, d], image context [B, 257, d] or None),
    both in the compute dtype."""
    ctx = unn.linear(model.text_embedding["fc0"], context.to(cd),
                     compute_dtype=cd)
    ctx = unn.linear(model.text_embedding["fc1"], unn.gelu_tanh(ctx),
                     compute_dtype=cd)
    if not model.cfg.use_img_emb:
        return ctx, None
    ie = model.img_emb
    ci = unn.layer_norm(clip_fea.float(), weight=ie.ln0["w"].float(),
                        bias=ie.ln0["b"].float())
    ci = F.gelu(unn.linear(ie.fc0, ci, compute_dtype=F32))
    ci = unn.linear(ie.fc1, ci, compute_dtype=F32)
    ci = unn.layer_norm(ci, weight=ie.ln1["w"].float(),
                        bias=ie.ln1["b"].float())
    return ctx, ci.to(cd)


def wan_animate_forward(model: WanAnimate, x, t, context, clip_fea,
                        pose_latents, face_pixel_values, *,
                        policy: DTypePolicy = DEFAULT_POLICY
                        ) -> torch.Tensor:
    """Velocity prediction [B, F_lat + 1, H, W, out_dim] (fp32).

    x [B, F_lat + 1, H, W, in_dim] (the reference frame first); t [B]; context
    [B, text_len, text_dim]; clip_fea [B, 257, clip_dim] (ignored without
    use_img_emb); pose_latents [B, F_lat, H, W, vae_z_dim];
    face_pixel_values [B, T_pix, S, S, 3] in [-1, 1]."""
    cfg = model.cfg
    b = x.shape[0]
    cd = policy.compute_dtype

    # patch embedding + pose on frames 1.. (frame 0 is the reference slot)
    tokens, grid = patchify_latent(x.to(cd), cfg.patch_size)
    h = unn.linear(model.patch_embed, tokens, compute_dtype=cd)
    pose_tok, _ = patchify_latent(pose_latents.to(cd), cfg.patch_size)
    pose_h = unn.linear(model.pose_patch_embed, pose_tok, compute_dtype=cd)
    per_frame = grid[1] * grid[2]
    h = torch.cat([h[:, :per_frame], h[:, per_frame:] + pose_h], dim=1)

    # motion vectors of every face crop; a zero frame for the reference slot
    bt, t_pix = face_pixel_values.shape[:2]
    motion = get_motion(model.motion_encoder, face_pixel_values.reshape(
        (bt * t_pix,) + tuple(face_pixel_values.shape[2:])))
    motion_vec = face_encoder_forward(model.face_encoder,
                                      motion.reshape(bt, t_pix, -1),
                                      num_heads=4)
    motion_vec = torch.cat([torch.zeros_like(motion_vec[:, :1]), motion_vec],
                           dim=1)

    # per-sample time embedding (fp32)
    e = sinusoidal_embedding_1d(cfg.freq_dim, t.float())
    e = unn.linear(model.time_embedding["fc0"], e, compute_dtype=F32)
    e = unn.linear(model.time_embedding["fc1"], unn.silu(e),
                   compute_dtype=F32)                       # [B, d]
    e0 = unn.linear(model.time_projection["fc0"], unn.silu(e),
                    compute_dtype=F32).reshape(b, 6, cfg.dim)

    ctx_text, ctx_img = _context(model, context, clip_fea, cd)
    cos, sin = build_rope_3d(cfg.head_dim, grid, device=x.device)
    rope_tabs = build_fused_rope_tables(cos, sin, cfg.head_dim)

    x32 = h.float()
    for i, bp in enumerate(model.blocks):
        x32 = _block(bp, cfg, x32, e0, ctx_text, ctx_img, rope_tabs, policy)
        if i % 5 == 0:
            adapter = model.face_adapter[min(i // 5, cfg.adapter_layers - 1)]
            x32 = x32 + face_block_forward(adapter, x32.to(cd), motion_vec,
                                           cfg.num_heads).float()

    # two-way modulated head
    hm = model.head["modulation"].float()[None] + e[:, None]   # [B, 2, d]
    y = unn.layer_norm(x32, eps=cfg.eps) * (1 + hm[:, 1][:, None]) \
        + hm[:, 0][:, None]
    out = unn.linear(model.head["head"], y, compute_dtype=F32)
    return unpatchify_tokens(out.float(), grid, cfg.patch_size, cfg.out_dim)
