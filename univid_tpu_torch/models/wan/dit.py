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
both experts.

`wan_dit_forward_sp` is the sequence-parallel forward over the `sp` axis of
a DeviceMesh (JAX's shard_map version): each rank of the sp group holds its
slice of the tokens through the blocks, self-attention is Ulysses
(`parallel.ulysses`) or ring (`parallel.ring`), and the head's output is
all-gathered. A model sharded by `parallel.sharding.shard_params` runs in
both forwards: each unit (the root, each block) is gathered around its use
(`gathered`, inside each segment that `remat_blocks` recomputes), since
the forwards read the tensors directly and FSDP2's module hooks never
fire; under grad the gradients reach the shards. On a mesh with tp > 1
(`wan_dit_forward` only; sequence and tensor parallelism together wait)
each rank runs N / tp heads and ffn_dim / tp of the FFN: q / k / v and fc0
are column-parallel, o and fc1 row-parallel with their bias added once
after the sum over tp (`parallel.tensor_parallel`); Wan's qk norm takes
its sum of squares over the whole N * D of a token across the tp group,
and the score bound the whole gains; the modulation, norms and embeddings
stay whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...core import nn as unn
from ...core.config import WanDiTConfig
from ...core.mesh import AXIS_SP
from ...core.dtypes import DEFAULT_POLICY, DTypePolicy
from ...kernels.attention import attention
from ...kernels.flash_attention import (D128, build_fused_rope_tables,
                                        qk_norm_rope, rms_heads)
from ...ops.embeddings import sinusoidal_embedding_1d
from ...ops.rope import apply_rope
from ...parallel.ring import ring_attention
from ...parallel.sharding import SP_TP_LATER, gathered
from ...parallel.tensor_parallel import (copy_to_tp, rms_norm_tp,
                                         row_parallel_linear, tp_of)
from ...parallel.ulysses import ulysses_attention

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


def _attn_qkv(p, x, n_heads, policy, defer_norm=False, tp=None):
    """q, k, v [B, L, N, dh] (N / tp heads under tp); q and k qk-normed
    unless defer_norm (the fused-rope path hands the gains to `attention`,
    `_qk_norm`)."""
    b, l, d = x.shape
    dh = d // n_heads
    n = tp.heads(n_heads) if tp is not None else n_heads
    cd = policy.compute_dtype
    x = copy_to_tp(x, tp)
    q = unn.linear(p["q"], x, compute_dtype=cd)
    k = unn.linear(p["k"], x, compute_dtype=cd)
    if "norm_q" in p and not defer_norm:
        q = rms_norm_tp(q, p["norm_q"], 1e-6, tp)
        k = rms_norm_tp(k, p["norm_k"], 1e-6, tp)
    v = unn.linear(p["v"], x, compute_dtype=cd)
    return (q.reshape(b, l, n, dh), k.reshape(b, l, n, dh),
            v.reshape(b, l, n, dh))


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


@dataclass(frozen=True)
class _SeqParallel:
    """The sp group a block's self-attention runs over, and how."""
    group: object
    impl: str   # 'ulysses' | 'ring'


def _norm_heads(q, k, qk_norm):
    """Wan's qk RMS norm over each token's N * D width: kernel A's
    norm-only mode on the card's bf16 d=128 tensors, else `rms_heads`."""
    gq, gk, eps = qk_norm
    if q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] == D128:
        return qk_norm_rope(q, k, qk_norm=qk_norm)
    return rms_heads(q, gq, eps), rms_heads(k, gk, eps)


def _self_attn_qkv(bp, cfg, x32, sel, rope_cos, rope_sin, rope_tabs, policy,
                   sp=None, tp=None):
    """AdaLN + q/k/v projections + qk-norm and rope, unless fused: then
    `attention` takes both (`_self_attn`). Under sequence parallelism the
    norm runs here, on the rank's tokens with all their heads: Ulysses
    scatters the heads, and a norm over a rank's N / sp heads of a token
    is another function. Under tensor parallelism it runs here too, its
    sum of squares summed over tp (`rms_norm_tp`); fused, `attention` then
    takes the rotation alone."""
    cd = policy.compute_dtype
    y = _modulated(x32, sel(0), sel(1), cfg.eps).to(cd)
    q, k, v = _attn_qkv(bp.self_attn, y, cfg.num_heads, policy,
                        defer_norm=rope_tabs is not None and tp is None,
                        tp=tp)
    if rope_tabs is None:
        q = apply_rope(q, rope_cos, rope_sin).to(cd)
        k = apply_rope(k, rope_cos, rope_sin).to(cd)
    elif sp is not None and "norm_q" in bp.self_attn:
        q, k = _norm_heads(q, k, _qk_norm(bp.self_attn, policy, True))
    return q, k, v


def _self_attn(bp, cfg, q, k, v, rope_tabs, self_kv_len, policy, sp=None,
               tp=None):
    bound = None
    if policy.bounded_softmax and "norm_q" in bp.self_attn:
        bound = _qk_bound(bp.self_attn, cfg.head_dim)
    if sp is not None and sp.impl == "ring":
        # JAX's ring path: the running max, neither bound nor knobs
        o = ring_attention(q, k, v, sp.group, seq_len_global=self_kv_len)
    elif sp is not None:
        o = ulysses_attention(q, k, v, sp.group, kv_len=self_kv_len,
                              rope_tables=rope_tabs,
                              softmax_bf16=policy.softmax_bf16,
                              qk_int8=policy.qk_int8, score_bound=bound)
    else:
        o = attention(q, k, v, kv_len=self_kv_len, rope_tables=rope_tabs,
                      softmax_bf16=policy.softmax_bf16,
                      qk_int8=policy.qk_int8, score_bound=bound,
                      qk_norm=_qk_norm(bp.self_attn, policy,
                                       rope_tabs is not None and tp is None))
    # the output in the compute dtype: what the o-projection reads, and
    # what the 'attn' remat mode keeps
    return o.to(policy.compute_dtype)


def _block_rest(bp, cfg, x32, attn, sel, ctx, policy, fused=False, tp=None):
    """o-projection + residual, cross-attention (q and k normed by
    `attention` when fused at tp = 1), FFN."""
    b, l, _ = x32.shape
    n = tp.heads(cfg.num_heads) if tp is not None else cfg.num_heads
    dh = cfg.head_dim
    cd = policy.compute_dtype
    rdt = policy.residual_dtype
    attn = attn.reshape(b, l, n * dh)
    attn = row_parallel_linear(bp.self_attn["o"], attn, tp, cd)
    x32 = x32 + (attn.float() * sel(2)).to(rdt)

    # cross-attention (norm3 affine if cross_attn_norm)
    if hasattr(bp, "norm3"):
        y = unn.layer_norm(x32.float(), weight=bp.norm3["w"].float(),
                           bias=bp.norm3["b"].float(), eps=cfg.eps)
    else:
        y = x32
    y = copy_to_tp(y.to(cd), tp)
    ctx = copy_to_tp(ctx, tp)
    ca = bp.cross_attn
    ctx_len = ctx.shape[1]
    qk_norm = _qk_norm(ca, policy, fused and tp is None)
    q = unn.linear(ca["q"], y, compute_dtype=cd)
    if "norm_q" in ca and qk_norm is None:
        q = rms_norm_tp(q, ca["norm_q"], 1e-6, tp)
    k = unn.linear(ca["k"], ctx, compute_dtype=cd)
    if "norm_k" in ca and qk_norm is None:
        k = rms_norm_tp(k, ca["norm_k"], 1e-6, tp)
    v = unn.linear(ca["v"], ctx, compute_dtype=cd)
    q = q.reshape(b, l, n, dh)
    k = k.reshape(b, ctx_len, n, dh)
    v = v.reshape(b, ctx_len, n, dh)
    cbound = None
    if policy.bounded_softmax and "norm_q" in ca and "norm_k" in ca:
        cbound = _qk_bound(ca, dh)
    attn = attention(q, k, v, softmax_bf16=policy.softmax_bf16,
                     score_bound=cbound, qk_norm=qk_norm
                     ).reshape(b, l, n * dh)
    del y, q, k, v   # the FFN's working set is the block's largest
    attn = row_parallel_linear(ca["o"], attn, tp, cd)
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
        return x32 + (_ffn(bp, y, cd, tp).float() * gate).to(rdt)
    out = torch.empty_like(x32)
    for i in range(0, l, step):
        rows = slice(i, i + step)
        g = gate if gate.shape[1] == 1 else gate[:, rows]
        out[:, rows] = x32[:, rows] + (_ffn(bp, y[:, rows], cd, tp).float()
                                       * g).to(rdt)
    return out


def _ffn(bp, y, cd, tp=None):
    y = unn.linear(bp.ffn["fc0"], copy_to_tp(y, tp), compute_dtype=cd)
    y = unn.gelu_tanh(y)
    return row_parallel_linear(bp.ffn["fc1"], y, tp, cd)


def _block(bp, unit, cfg, x32, e0, ctx, rope_cos, rope_sin, rope_tabs,
           t_zero_mask, self_kv_len, policy, remat, sp=None, tp=None):
    """One DiT block. remat: False keeps every activation for the backward;
    True recomputes the whole block there (its attention calls included);
    'attn' checkpoints the block in two segments around the self-attention
    call, so the backward recomputes everything but that call, whose
    autograd Function keeps the folded q, k, v, its output and lse (the JAX
    package's save_only_these_names('attn_out') policy). The segments draw
    no random numbers, so the RNG state is not stashed. Each segment runs
    with `unit` (the block's module) gathered, so a recomputed segment of a
    sharded block gathers its parameters again; between the segments only
    the whole qk-norm gains are read."""
    mod = bp.modulation.float()[None, None] + e0        # [B, 2, 6, d]

    def sel(i):
        return _select_rows(mod[:, :, i], t_zero_mask)

    def seg(fn):
        def run(*a):
            with gathered(unit):
                return fn(*a)
        return run

    def qkv(x):
        return _self_attn_qkv(bp, cfg, x, sel, rope_cos, rope_sin,
                              rope_tabs, policy, sp, tp)

    def rest(x, a):
        return _block_rest(bp, cfg, x, a, sel, ctx, policy,
                           fused=rope_tabs is not None, tp=tp)

    def attn(q, k, v):
        return _self_attn(bp, cfg, q, k, v, rope_tabs, self_kv_len, policy,
                          sp, tp)

    def full(x):
        # q, k and v live only through the self-attention call (at 720p
        # A14B they are 4.65 GB that the rest of the block does not read)
        return rest(x, attn(*qkv(x)))

    ck = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "attn":
        a = attn(*checkpoint(seg(qkv), x32, **ck))
        return checkpoint(seg(rest), x32, a, **ck)
    if remat:
        return checkpoint(seg(full), x32, **ck)
    return seg(full)(x32)


def _check_forward(model, remat_blocks, weights=None):
    if remat_blocks not in (False, True, "attn"):
        raise ValueError(f"remat_blocks must be False, True or 'attn', "
                         f"got {remat_blocks!r}")
    if weights and tp_of(model) is not None:
        raise ValueError("weights (merged LoRA tensors) are whole: merge "
                         "them before the DiT is sharded over tp")


def _blocks_and_head(model: WanDiT, x32, e, e0, ctx, rope_cos, rope_sin,
                     rope_tabs, t_zero_mask, self_kv_len, policy,
                     remat_blocks, weights=None, sp=None):
    """The blocks and the modulated head over the (possibly rank-local)
    tokens x32 [B, L, d]: head output tokens [B, L, patch_out] (fp32).
    Each block's FSDP unit, and the root's for the head, is gathered
    around its use."""
    cfg = model.cfg
    tp = tp_of(model)
    for i, blk in enumerate(model.blocks):
        bp = _View(blk, f"blocks.{i}.", weights) if weights else blk
        x32 = _block(bp, blk, cfg, x32, e0, ctx, rope_cos, rope_sin,
                     rope_tabs, t_zero_mask, self_kv_len, policy,
                     remat_blocks, sp, tp)
    with gathered(model):
        hp = model.head
        head_mod = hp["modulation"].float()[None, None] + e[:, :, None, :]
        shift = _select_rows(head_mod[:, :, 0], t_zero_mask)
        scale = _select_rows(head_mod[:, :, 1], t_zero_mask)
        y = unn.layer_norm(x32.float(), eps=cfg.eps) * (1.0 + scale) + shift
        return unn.linear(hp["head"], y, compute_dtype=torch.float32)


def _tokens(model: WanDiT, x, t, context, rope_cos, rope_sin, t_zero_mask,
            seq_pad_to, policy, multiple=1):
    """The token set-up both forwards share: the embeddings (the root's
    FSDP unit gathered), the tokens padded to seq_pad_to and up to a
    multiple of `multiple`, the rope tables and t_zero_mask padded to
    match. Returns (h, grid, e, e0, ctx, rope_cos, rope_sin, t_zero_mask,
    self_kv_len), self_kv_len [B] the real token count (None when no token
    is padding)."""
    with gathered(model):
        h, grid, e, e0, ctx = _embed_inputs(model, x, t, context, policy)
    b, l_real = h.shape[:2]
    l = -(-max(seq_pad_to or 0, l_real) // multiple) * multiple
    if l > l_real:
        h = F.pad(h, (0, 0, 0, l - l_real))
    rope_cos, rope_sin = _pad_rope(rope_cos, rope_sin, l)
    self_kv_len = (torch.full((b,), l_real, dtype=torch.int32,
                              device=h.device) if l_real < l else None)
    if t_zero_mask is not None and t_zero_mask.shape[1] < l:
        t_zero_mask = F.pad(t_zero_mask, (0, l - t_zero_mask.shape[1]))
    return (h, grid, e, e0, ctx, rope_cos, rope_sin, t_zero_mask,
            self_kv_len)


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
    _check_forward(model, remat_blocks, weights)
    cfg = model.cfg
    (h, grid, e, e0, ctx, rope_cos, rope_sin, t_zero_mask,
     self_kv_len) = _tokens(model, x, t, context, rope_cos, rope_sin,
                            t_zero_mask, seq_pad_to, policy)
    rope_tabs = (build_fused_rope_tables(rope_cos, rope_sin, cfg.head_dim)
                 if fused_rope else None)
    out = _blocks_and_head(model, h.to(policy.residual_dtype), e, e0, ctx,
                           rope_cos, rope_sin, rope_tabs, t_zero_mask,
                           self_kv_len, policy, remat_blocks, weights)
    return unpatchify_tokens(out.float(), grid, cfg.patch_size, cfg.out_dim)


def wan_dit_forward_sp(model: WanDiT, x, t, context, rope_cos, rope_sin, *,
                       mesh, sp_impl: str = "ulysses",
                       t_zero_mask: Optional[torch.Tensor] = None,
                       seq_pad_to: Optional[int] = None,
                       policy: DTypePolicy = DEFAULT_POLICY,
                       fused_rope: bool = False, remat_blocks=False
                       ) -> torch.Tensor:
    """Sequence-parallel velocity prediction [B, F, H, W, C_out] (fp32),
    the same on every rank of the mesh's sp group, each of which passes
    the same inputs (as wan_dit_forward takes them).

    The embeddings run on every rank; the tokens are padded to a multiple
    of sp (and to seq_pad_to) and each rank keeps its slice, with its
    slice of t_zero_mask; e, e0 and the text context stay whole. Self-
    attention: sp_impl 'ulysses' (`parallel.ulysses`: heads scattered,
    the sequence gathered; fused_rope rotates in the kernel with the
    global tables after the exchange) or 'ring' (`parallel.ring`: the kv
    shards pass around the group; q and k rotated here by the rank's
    global slice of the tables; fused_rope is ignored, as in JAX), padded
    keys masked through the global kv_len either way. Cross-attention and
    the FFN stay local (FFN_CHUNK_ELEMS per rank); the head's output is
    all-gathered before unpatchify."""
    if sp_impl not in ("ulysses", "ring"):
        raise ValueError(f"sp_impl must be 'ulysses' or 'ring', got "
                         f"{sp_impl!r}")
    if tp_of(model) is not None:
        raise NotImplementedError(SP_TP_LATER)
    _check_forward(model, remat_blocks)
    cfg = model.cfg
    group = mesh[AXIS_SP].get_group()
    sp = dist.get_world_size(group)
    me = dist.get_rank(group)
    if cfg.num_heads % sp:
        raise ValueError(f"num_heads {cfg.num_heads} % sp {sp} != 0")
    (h, grid, e, e0, ctx, rope_cos, rope_sin, t_zero_mask,
     self_kv_len) = _tokens(model, x, t, context, rope_cos, rope_sin,
                            t_zero_mask, seq_pad_to, policy, multiple=sp)
    l_loc = h.shape[1] // sp
    rows = slice(me * l_loc, (me + 1) * l_loc)
    rope_tabs = (build_fused_rope_tables(rope_cos, rope_sin, cfg.head_dim)
                 if fused_rope and sp_impl == "ulysses" else None)
    out = _blocks_and_head(
        model, h[:, rows].to(policy.residual_dtype), e, e0, ctx,
        rope_cos[rows], rope_sin[rows], rope_tabs,
        None if t_zero_mask is None else t_zero_mask[:, rows],
        self_kv_len, policy, remat_blocks, sp=_SeqParallel(group, sp_impl))
    parts = [torch.empty_like(out) for _ in range(sp)]
    dist.all_gather(parts, out.contiguous(), group=group)
    full = torch.cat(parts, dim=1)
    return unpatchify_tokens(full, grid, cfg.patch_size, cfg.out_dim)
