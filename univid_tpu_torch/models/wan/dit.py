"""Wan diffusion transformer (DiT) on one GPU.

Counterpart of univid_tpu/models/wan/dit.py::wan_dit_forward, with the
same numerics: channels-last [B, F, H, W, C] latents; patch embedding as a
dense layer over flattened patches; per-token timesteps in the two-value
form ({t, 0} embedded once, selected per token by t_zero_mask); fp32
islands for the time embedding, AdaLN modulation, norms and the residual
stream; the bounded-softmax score bound 1.01 * d * max|g_q| * max|g_k| for
self- and cross-attention; and the fused-rope route into the flash kernel,
on which q and k reach `attention` before their qk-norm (`qk_norm`) so that
the card's q / k pre-pass takes the norm as its prologue.
The blocks are an nn.ModuleList. `wan_dit_forward` is differentiable
(serving runs it under the pipeline's no_grad): `remat_blocks` recomputes
blocks in the backward with torch.utils.checkpoint, and `weights`
substitutes named parameters (the LoRA-merged weights of
train/lora.merge_lora) without touching the module. A block frees its q, k
and v after their attention call and runs a long sequence's FFN over
token chunks (`FFN_CHUNK_ELEMS`), so a 1280x720x81 A14B call fits beside
both experts. Sequence parallelism is a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...core import nn as unn
from ...core.config import WanDiTConfig
from ...core.dtypes import DEFAULT_POLICY, DTypePolicy
from ...kernels.attention import attention
from ...kernels.flash_attention import build_fused_rope_tables
from ...ops.embeddings import sinusoidal_embedding_1d
from ...ops.rope import apply_rope

# the largest FFN hidden activation a block computes at once (elements):
# 2 GB in bf16; longer sequences run the FFN over token chunks
FFN_CHUNK_ELEMS = 1 << 30

# ---------------------------------------------------------------------------
# modules (parameter names follow the JAX tree of init_wan_dit)
# ---------------------------------------------------------------------------


def _attn(cfg: WanDiTConfig, kw) -> unn.Node:
    d = cfg.dim
    p = {name: unn.Linear(d, d, **kw) for name in ("q", "k", "v", "o")}
    if cfg.qk_norm:
        p["norm_q"] = unn.param((d,), kw["dtype"], kw["device"], init="ones")
        p["norm_k"] = unn.param((d,), kw["dtype"], kw["device"], init="ones")
    return unn.Node(**p)


class WanBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig, kw):
        super().__init__()
        d = cfg.dim
        self.self_attn = _attn(cfg, kw)
        self.cross_attn = _attn(cfg, kw)
        self.ffn = unn.mlp((d, cfg.ffn_dim, d), **kw)
        self.modulation = unn.param((6, d), kw["dtype"], kw["device"],
                                    kw["gen"], "normal", std=d ** -0.5)
        if cfg.cross_attn_norm:
            self.norm3 = unn.Node(
                w=unn.param((d,), kw["dtype"], kw["device"], init="ones"),
                b=unn.param((d,), kw["dtype"], kw["device"], init="zeros"))


class WanDiT(nn.Module):
    """Parameters of the Wan DiT. With `gen`, drawn on `device` from the
    distributions of univid_tpu init_wan_dit (xavier-uniform linears,
    normal(0.02) text/time embeddings, zero head, normal/sqrt(d)
    modulations); without, left empty for `convert.dit_from_jax`."""

    def __init__(self, cfg: WanDiTConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        pt, ph, pw = cfg.patch_size
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.patch_embed = unn.Linear(pt * ph * pw * cfg.in_dim, d, **kw)
        self.text_embedding = unn.mlp((cfg.text_dim, d, d), init="normal",
                                      **kw)
        self.time_embedding = unn.mlp((cfg.freq_dim, d, d), init="normal",
                                      **kw)
        self.time_projection = unn.mlp((d, d * 6), **kw)
        self.head = unn.Node(
            head=unn.Linear(d, pt * ph * pw * cfg.out_dim, init="zeros",
                            **kw),
            modulation=unn.param((2, d), dtype, device, gen, "normal",
                                 std=d ** -0.5))
        self.blocks = nn.ModuleList(WanBlock(cfg, kw)
                                    for _ in range(cfg.num_layers))

    def forward(self, x, t, context, rope_cos, rope_sin, **kw):
        return wan_dit_forward(self, x, t, context, rope_cos, rope_sin, **kw)


# ---------------------------------------------------------------------------
# patch <-> token
# ---------------------------------------------------------------------------


def patchify_latent(x, patch_size):
    """[B, F, H, W, C] -> [B, L, pt*ph*pw*C] tokens in (f, h, w) order."""
    b, f, h, w, c = x.shape
    pt, ph, pw = patch_size
    gf, gh, gw = f // pt, h // ph, w // pw
    x = x.reshape(b, gf, pt, gh, ph, gw, pw, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, gf * gh * gw, pt * ph * pw * c), (gf, gh, gw)


def unpatchify_tokens(tokens, grid, patch_size, out_dim):
    """[B, L, pt*ph*pw*C] -> [B, F, H, W, C]."""
    b = tokens.shape[0]
    gf, gh, gw = grid
    pt, ph, pw = patch_size
    x = tokens[:, :gf * gh * gw].reshape(b, gf, gh, gw, pt, ph, pw, out_dim)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, gf * pt, gh * ph, gw * pw, out_dim)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _attn_qkv(p, x, n_heads, policy, defer_norm=False):
    """q, k, v [B, L, N, dh]; q and k qk-normed unless defer_norm (the
    fused-rope path hands the gains to `attention`, `_qk_norm`)."""
    b, l, d = x.shape
    dh = d // n_heads
    cd = policy.compute_dtype
    q = unn.linear(p["q"], x, compute_dtype=cd)
    k = unn.linear(p["k"], x, compute_dtype=cd)
    if "norm_q" in p and not defer_norm:
        q = unn.rms_norm(q, p["norm_q"].to(cd), eps=1e-6)
        k = unn.rms_norm(k, p["norm_k"].to(cd), eps=1e-6)
    v = unn.linear(p["v"], x, compute_dtype=cd)
    return (q.reshape(b, l, n_heads, dh), k.reshape(b, l, n_heads, dh),
            v.reshape(b, l, n_heads, dh))


def _modulated(x32, shift, scale, eps):
    """AdaLN: LayerNorm(x) * (1 + scale) + shift, fp32 statistics."""
    y = unn.layer_norm(x32.float(), eps=eps)
    return y * (1.0 + scale) + shift


def _select_rows(e_pair, mask):
    """e_pair [B, 2, ...] -> per-token rows: row 0 embeds t, row 1 embeds 0;
    mask [B, L] True -> row 1. mask None (t2v): row 0 for every token,
    broadcast over L without materialising [B, L, ...]."""
    e_t = e_pair[:, 0][:, None]
    if mask is None:
        return e_t
    e_0 = e_pair[:, 1][:, None]
    m = mask[(...,) + (None,) * (e_pair.ndim - 2)]
    return torch.where(m, e_0, e_t)


def _embed_inputs(model: WanDiT, x, t, context, policy: DTypePolicy):
    """Patch / time / text embeddings. Returns (tokens [B, L, d], grid,
    e [B, 2, d], e0 [B, 2, 6, d], ctx [B, text_len, d])."""
    cfg = model.cfg
    b = x.shape[0]
    cd = policy.compute_dtype
    tokens, grid = patchify_latent(x.to(cd), cfg.patch_size)
    h = unn.linear(model.patch_embed, tokens, compute_dtype=cd)

    t_pair = torch.stack([t.float(), torch.zeros_like(t, dtype=torch.float32)],
                         dim=1)                                   # [B, 2]
    e = sinusoidal_embedding_1d(cfg.freq_dim, t_pair)
    e = unn.linear(model.time_embedding["fc0"], e, compute_dtype=torch.float32)
    e = unn.silu(e)
    e = unn.linear(model.time_embedding["fc1"], e, compute_dtype=torch.float32)
    e0 = unn.linear(model.time_projection["fc0"], unn.silu(e),
                    compute_dtype=torch.float32)
    e0 = e0.reshape(b, 2, 6, cfg.dim)

    ctx = context.to(cd)
    ctx = unn.linear(model.text_embedding["fc0"], ctx, compute_dtype=cd)
    ctx = unn.gelu_tanh(ctx)
    ctx = unn.linear(model.text_embedding["fc1"], ctx, compute_dtype=cd)
    return h, grid, e, e0, ctx


def _pad_rope(rope_cos, rope_sin, l):
    """Pad RoPE tables to l with the identity rotation (cos=1, sin=0)."""
    if rope_cos.shape[0] < l:
        pad = l - rope_cos.shape[0]
        rope_cos = F.pad(rope_cos, (0, 0, 0, pad), value=1.0)
        rope_sin = F.pad(rope_sin, (0, 0, 0, pad))
    return rope_cos, rope_sin


def _qk_norm(p, policy, fused):
    """attention()'s qk_norm on the fused-rope path: (gain_q, gain_k, eps)
    in the compute dtype, as `_attn_qkv` would apply them; else None."""
    if not fused or "norm_q" not in p:
        return None
    cd = policy.compute_dtype
    return p["norm_q"].to(cd), p["norm_k"].to(cd), 1e-6


def _qk_bound(p, dh):
    """1.01 * d * max|g_q| * max|g_k|: qk-norm bounds every row norm by
    max|gain| * sqrt(d) and rope preserves norms; 1% absorbs bf16 rounding
    of the normalised rows. Recomputed from the current gains on every call
    and detached: it only moves the softmax's reference point."""
    gq = p["norm_q"].detach().float().abs().max()
    gk = p["norm_k"].detach().float().abs().max()
    return 1.01 * dh * gq * gk


class _View:
    """A block's module tree with some parameters replaced: `p.w`,
    `p["q"]` and `"norm_q" in p` read the tensor of `weights` named by the
    state-dict key, else the module's own."""

    def __init__(self, mod, prefix: str, weights: Dict[str, torch.Tensor]):
        self._mod, self._prefix, self._weights = mod, prefix, weights

    def __getattr__(self, name):
        child = getattr(self._mod, name)
        key = self._prefix + name
        if isinstance(child, nn.Module):
            return _View(child, key + ".", self._weights)
        return self._weights.get(key, child)

    __getitem__ = __getattr__

    def __contains__(self, name):
        return name in self._mod


def _self_attn_qkv(bp, cfg, x32, sel, rope_cos, rope_sin, rope_tabs, policy):
    """AdaLN + q/k/v projections + qk-norm and rope, unless fused: then
    `attention` takes both (`_self_attn`)."""
    cd = policy.compute_dtype
    y = _modulated(x32, sel(0), sel(1), cfg.eps).to(cd)
    q, k, v = _attn_qkv(bp.self_attn, y, cfg.num_heads, policy,
                        defer_norm=rope_tabs is not None)
    if rope_tabs is None:
        q = apply_rope(q, rope_cos, rope_sin).to(cd)
        k = apply_rope(k, rope_cos, rope_sin).to(cd)
    return q, k, v


def _self_attn(bp, cfg, q, k, v, rope_tabs, self_kv_len, policy):
    bound = None
    if policy.bounded_softmax and "norm_q" in bp.self_attn:
        bound = _qk_bound(bp.self_attn, cfg.head_dim)
    # the output in the compute dtype: what the o-projection reads, and
    # what the 'attn' remat mode keeps
    return attention(q, k, v, kv_len=self_kv_len, rope_tables=rope_tabs,
                     softmax_bf16=policy.softmax_bf16,
                     qk_int8=policy.qk_int8, score_bound=bound,
                     qk_norm=_qk_norm(bp.self_attn, policy,
                                      rope_tabs is not None)
                     ).to(policy.compute_dtype)


def _block_rest(bp, cfg, x32, attn, sel, ctx, policy, fused=False):
    """o-projection + residual, cross-attention (q and k normed by
    `attention` when fused), FFN."""
    b, l, _ = x32.shape
    n = cfg.num_heads
    dh = cfg.head_dim
    cd = policy.compute_dtype
    rdt = policy.residual_dtype
    attn = attn.reshape(b, l, cfg.dim)
    attn = unn.linear(bp.self_attn["o"], attn, compute_dtype=cd)
    x32 = x32 + (attn.float() * sel(2)).to(rdt)

    # cross-attention (norm3 affine if cross_attn_norm)
    if hasattr(bp, "norm3"):
        y = unn.layer_norm(x32.float(), weight=bp.norm3["w"].float(),
                           bias=bp.norm3["b"].float(), eps=cfg.eps)
    else:
        y = x32
    y = y.to(cd)
    ca = bp.cross_attn
    ctx_len = ctx.shape[1]
    qk_norm = _qk_norm(ca, policy, fused)
    q = unn.linear(ca["q"], y, compute_dtype=cd)
    if "norm_q" in ca and qk_norm is None:
        q = unn.rms_norm(q, ca["norm_q"].to(cd), eps=1e-6)
    k = unn.linear(ca["k"], ctx, compute_dtype=cd)
    if "norm_k" in ca and qk_norm is None:
        k = unn.rms_norm(k, ca["norm_k"].to(cd), eps=1e-6)
    v = unn.linear(ca["v"], ctx, compute_dtype=cd)
    q = q.reshape(b, l, n, dh)
    k = k.reshape(b, ctx_len, n, dh)
    v = v.reshape(b, ctx_len, n, dh)
    cbound = None
    if policy.bounded_softmax and "norm_q" in ca and "norm_k" in ca:
        cbound = _qk_bound(ca, dh)
    attn = attention(q, k, v, softmax_bf16=policy.softmax_bf16,
                     score_bound=cbound, qk_norm=qk_norm
                     ).reshape(b, l, cfg.dim)
    del y, q, k, v   # the FFN's working set is the block's largest
    attn = unn.linear(ca["o"], attn, compute_dtype=cd)
    x32 = x32 + attn.to(rdt)

    # ffn: over token chunks when its hidden activation [B * L, ffn_dim]
    # passes FFN_CHUNK_ELEMS (the 720p A14B call: 2.1e9 elements, 4.2 GB
    # twice around the GELU); the FFN and the gated residual are row-wise,
    # so a row's products and roundings are the whole call's wherever the
    # GEMM keeps its kernel (chip_smoke.py checks the 720p shape bit for bit)
    y = _modulated(x32, sel(3), sel(4), cfg.eps).to(cd)
    gate = sel(5)
    step = max(1, FFN_CHUNK_ELEMS // (b * cfg.ffn_dim))
    if step >= l:
        return x32 + (_ffn(bp, y, cd).float() * gate).to(rdt)
    out = torch.empty_like(x32)
    for i in range(0, l, step):
        rows = slice(i, i + step)
        g = gate if gate.shape[1] == 1 else gate[:, rows]
        out[:, rows] = x32[:, rows] + (_ffn(bp, y[:, rows], cd).float()
                                       * g).to(rdt)
    return out


def _ffn(bp, y, cd):
    y = unn.linear(bp.ffn["fc0"], y, compute_dtype=cd)
    y = unn.gelu_tanh(y)
    return unn.linear(bp.ffn["fc1"], y, compute_dtype=cd)


def _block(bp, cfg, x32, e0, ctx, rope_cos, rope_sin, rope_tabs,
           t_zero_mask, self_kv_len, policy, remat):
    """One DiT block. remat: False keeps every activation for the backward;
    True recomputes the whole block there (its attention calls included);
    'attn' checkpoints the block in two segments around the self-attention
    call, so the backward recomputes everything but that call, whose
    autograd Function keeps the folded q, k, v, its output and lse (the JAX
    package's save_only_these_names('attn_out') policy). The segments draw
    no random numbers, so the RNG state is not stashed."""
    mod = bp.modulation.float()[None, None] + e0        # [B, 2, 6, d]

    def sel(i):
        return _select_rows(mod[:, :, i], t_zero_mask)

    def qkv(x):
        return _self_attn_qkv(bp, cfg, x, sel, rope_cos, rope_sin,
                              rope_tabs, policy)

    def rest(x, a):
        return _block_rest(bp, cfg, x, a, sel, ctx, policy,
                           fused=rope_tabs is not None)

    def full(x):
        # q, k and v live only through the self-attention call (at 720p
        # A14B they are 4.65 GB that the rest of the block does not read)
        return rest(x, _self_attn(bp, cfg, *qkv(x), rope_tabs, self_kv_len,
                                  policy))

    ck = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "attn":
        q, k, v = checkpoint(qkv, x32, **ck)
        a = _self_attn(bp, cfg, q, k, v, rope_tabs, self_kv_len, policy)
        return checkpoint(rest, x32, a, **ck)
    if remat:
        return checkpoint(full, x32, **ck)
    return full(x32)


def wan_dit_forward(model: WanDiT, x, t, context, rope_cos, rope_sin, *,
                    t_zero_mask: Optional[torch.Tensor] = None,
                    seq_pad_to: Optional[int] = None,
                    policy: DTypePolicy = DEFAULT_POLICY,
                    fused_rope: bool = False, remat_blocks=False,
                    weights: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Velocity prediction [B, F, H, W, C_out] (fp32).

    x [B, F, H, W, C_in] latent; t [B] timesteps (0..1000); context
    [B, text_len, text_dim]; rope_cos/sin [L, head_dim // 2]; t_zero_mask
    [B, L] True where a token takes t = 0; seq_pad_to pads the token axis
    (padded keys are masked through kv_len); fused_rope rotates q and k in
    the attention kernel instead of in the block (inference only).
    remat_blocks: False | True | 'attn' (see _block). weights: tensors that
    replace the parameters of the same state-dict names inside the blocks
    (merge_lora's output)."""
    if remat_blocks not in (False, True, "attn"):
        raise ValueError(f"remat_blocks must be False, True or 'attn', "
                         f"got {remat_blocks!r}")
    cfg = model.cfg
    b = x.shape[0]
    h, grid, e, e0, ctx = _embed_inputs(model, x, t, context, policy)
    l_real = h.shape[1]
    if seq_pad_to is not None and seq_pad_to > l_real:
        h = F.pad(h, (0, 0, 0, seq_pad_to - l_real))
    l = h.shape[1]
    rope_cos, rope_sin = _pad_rope(rope_cos, rope_sin, l)
    self_kv_len = (torch.full((b,), l_real, dtype=torch.int32,
                              device=h.device) if l_real < l else None)
    if t_zero_mask is not None and t_zero_mask.shape[1] < l:
        t_zero_mask = F.pad(t_zero_mask, (0, l - t_zero_mask.shape[1]))

    x32 = h.to(policy.residual_dtype)
    rope_tabs = (build_fused_rope_tables(rope_cos, rope_sin, cfg.head_dim)
                 if fused_rope else None)
    for i, bp in enumerate(model.blocks):
        if weights:
            bp = _View(bp, f"blocks.{i}.", weights)
        x32 = _block(bp, cfg, x32, e0, ctx, rope_cos, rope_sin, rope_tabs,
                     t_zero_mask, self_kv_len, policy, remat_blocks)

    hp = model.head
    head_mod = hp["modulation"].float()[None, None] + e[:, :, None, :]
    shift = _select_rows(head_mod[:, :, 0], t_zero_mask)
    scale = _select_rows(head_mod[:, :, 1], t_zero_mask)
    y = unn.layer_norm(x32.float(), eps=cfg.eps) * (1.0 + scale) + shift
    out = unn.linear(hp["head"], y, compute_dtype=torch.float32)
    return unpatchify_tokens(out.float(), grid, cfg.patch_size, cfg.out_dim)
