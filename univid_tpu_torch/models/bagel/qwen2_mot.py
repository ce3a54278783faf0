"""BAGEL's LLM: Qwen2 with Mixture-of-Transformers experts.

Counterpart of univid_tpu/models/bagel/qwen2_mot.py: und / gen expert twins
of every projection, norm and MLP, per-head qk RMS-norm, grouped-query
attention, rotate-half RoPE, and a fixed-capacity KV cache with an append
cursor. What the JAX callers `vmap` is a leading batch dimension here:
`x [B, L, hidden]`, cache `k` / `v` [layers, B, capacity, n_kv, head_dim]
and `len` int32 [B] on the device (the sequential paths use B = 1), so each
batch row keeps its own cache length. `lax.scan` over the layers is a loop
over a ModuleList.

Differences from the JAX function, each deliberate:
  * The cache is updated in place (the JAX function returns a new cache):
    a context whose cache was appended to must not be appended to again.
    The cache also carries `len_host`, the host's copy of the lengths, so
    no call reads the device to know where the cursor is. Where a JAX
    caller throws the returned cache away (the flow loop's CFG branches),
    the port runs the pass with `commit=False`: its rows are written past
    the cursor and attended to, and the cursor stays where it was.
  * An append that would pass the capacity raises ValueError; JAX's
    dynamic_update_slice clamps the start and overwrites valid rows.
  * The decode-shaped einsums read the cache up to the longest row's new
    length (the keys past it are masked either way); the prefill kernel
    takes the whole buffer and skips the dead tiles itself.
  * A tree sharded by `parallel.sharding.shard_params` runs as it is: the
    forward gathers each layer's unit around the layer, and
    `lm_head_logits` the root's around the head. On a mesh with tp > 1 a
    rank runs num_heads / tp query heads over num_kv_heads / tp kv heads
    (the group kept), the und and gen twins alike: q / k / v, gate and up
    are column-parallel, o and down row-parallel
    (`parallel.tensor_parallel`); the per-head qk norm needs no
    collective, and the KV cache holds the rank's kv heads
    (`init_kv_cache(..., tp=)`). embed_tokens and lm_head have no tp axis
    in their rules and stay as they are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from ...core import nn as unn
from ...kernels.attention import attention
from ...parallel.sharding import gathered
from ...parallel.tensor_parallel import copy_to_tp, reduce_from_tp, tp_of


@dataclass(frozen=True)
class Qwen2MoTConfig:
    """BAGEL-7B-MoT shape (Qwen2-7B backbone)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    qk_norm: bool = True
    moe: bool = True  # MoT dual experts (layer_module Qwen2MoTDecoderLayer)
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# AR decode appends a handful of rows per step: up to this many query rows
# take the plain grouped-query einsums over the un-repeated cache
_GQA_DENSE_MAX_Q = 32


# ---------------------------------------------------------------------------
# parameters (named as the JAX tree; random ones drawn as init_qwen2_mot
# draws them: normal std 0.02, zero biases, unit norms)
# ---------------------------------------------------------------------------


def _attn(cfg: Qwen2MoTConfig, kw) -> unn.Node:
    d, hd = cfg.hidden_size, cfg.head_dim
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = dict(q=unn.Linear(d, qd, **kw), k=unn.Linear(d, kvd, **kw),
             v=unn.Linear(d, kvd, **kw), o=unn.Linear(qd, d, bias=False, **kw))
    if cfg.qk_norm:
        p["q_norm"] = unn.param((hd,), kw["dtype"], kw["device"], init="ones")
        p["k_norm"] = unn.param((hd,), kw["dtype"], kw["device"], init="ones")
    return unn.Node(**p)


def _mlp(cfg: Qwen2MoTConfig, kw) -> unn.Node:
    d, m = cfg.hidden_size, cfg.intermediate_size
    return unn.Node(gate=unn.Linear(d, m, bias=False, **kw),
                    up=unn.Linear(d, m, bias=False, **kw),
                    down=unn.Linear(m, d, bias=False, **kw))


def init_qwen2_mot(gen: Optional[torch.Generator], cfg: Qwen2MoTConfig, *,
                   dtype=torch.float32, device="cuda",
                   layers: bool = True) -> unn.Node:
    """The `llm` subtree: embed_tokens, layers (a ModuleList), norm,
    lm_head (and norm_gen with MoT). `layers=False` keeps embed_tokens only
    (what the fusion extractor reads). gen None leaves random leaves empty,
    to be loaded."""
    kw = dict(init="normal", dtype=dtype, device=device, gen=gen)
    d = cfg.hidden_size
    p = {"embed_tokens": unn.param((cfg.vocab_size, d), dtype, device, gen,
                                   "normal", std=0.02)}
    if not layers:
        return unn.Node(**p)

    def ones():
        return unn.param((d,), dtype, device, init="ones")

    def layer():
        lyr = dict(input_ln=ones(), attn=_attn(cfg, kw), post_ln=ones(),
                   mlp=_mlp(cfg, kw))
        if cfg.moe:
            lyr.update(input_ln_gen=ones(), attn_gen=_attn(cfg, kw),
                       post_ln_gen=ones(), mlp_gen=_mlp(cfg, kw))
        return unn.Node(**lyr)

    p["layers"] = nn.ModuleList([layer() for _ in range(cfg.num_layers)])
    p["norm"] = ones()
    p["lm_head"] = unn.Linear(d, cfg.vocab_size, bias=False, **kw)
    if cfg.moe:
        p["norm_gen"] = ones()
    return unn.Node(**p)


def init_kv_cache(cfg: Qwen2MoTConfig, capacity: int, *, batch: int = 1,
                  dtype=torch.bfloat16, device="cuda", tp: int = 1):
    """k / v [layers, batch, capacity, num_kv_heads / tp, head_dim]: tp is
    the size of the mesh's tp axis of a tensor-parallel LLM (the rank's kv
    heads)."""
    if cfg.num_kv_heads % tp:
        raise ValueError(f"{cfg.num_kv_heads} kv heads do not split over "
                         f"tp = {tp}")
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads // tp,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "len_host": [0] * batch}


# ---------------------------------------------------------------------------
# rope (HF rotate-half convention)
# ---------------------------------------------------------------------------


def rope_tables(pos_ids: torch.Tensor, head_dim: int, theta: float):
    """cos / sin [*pos_ids.shape, head_dim], fp32: angles over the first
    half, duplicated into the second (HF qwen2 layout)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=pos_ids.device) / half))
    ang = pos_ids.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., L, N, D] with tables [..., L, D]: x * cos + rotate_half(x) *
    sin in fp32, rounded to x's dtype."""
    d = x.shape[-1]
    x32 = x.float()
    rot = torch.cat([-x32[..., d // 2:], x32[..., :d // 2]], dim=-1)
    out = x32 * cos.unsqueeze(-2) + rot * sin.unsqueeze(-2)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _expert_linear(p_und, p_gen, x, und_rows, compute_dtype):
    """x [B, L, D] through the gen projection, then the (static) und rows
    overwritten with the und projection of those rows."""
    y = unn.linear(p_gen, x, compute_dtype=compute_dtype)
    if und_rows is not None and und_rows.numel() > 0:
        y[:, und_rows] = unn.linear(p_und, x[:, und_rows],
                                    compute_dtype=compute_dtype)
    return y


def _expert_norm(w_und, w_gen, x, und_rows, eps):
    y = unn.rms_norm(x, w_gen.to(x.dtype), eps=eps)
    if und_rows is not None and und_rows.numel() > 0:
        y[:, und_rows] = unn.rms_norm(x[:, und_rows], w_und.to(x.dtype),
                                      eps=eps)
    return y


def _qwen_mlp(p, x, compute_dtype, tp=None):
    """The gated MLP; under tp the rank's part of down's product (summed
    by the caller)."""
    x = copy_to_tp(x, tp)
    g = unn.linear(p.gate, x, compute_dtype=compute_dtype)
    u = unn.linear(p.up, x, compute_dtype=compute_dtype)
    return unn.linear(p.down, unn.silu(g) * u, compute_dtype=compute_dtype)


def _tp_sum(x, tp, compute_dtype):
    """Row-parallel partial products (no bias: o and down have none)
    summed over tp in fp32, rounded once to the compute dtype."""
    if tp is None:
        return x
    return reduce_from_tp(x.float(), tp).to(compute_dtype)


def _rows_valid(q_valid, b: int, l: int):
    """q_valid (None, an int, or one int per batch row) -> host list."""
    if q_valid is None:
        return [l] * b
    if isinstance(q_valid, int):
        return [q_valid] * b
    rows = [int(n) for n in q_valid]
    if len(rows) != b:
        raise ValueError(f"q_valid has {len(rows)} rows for a batch of {b}")
    return rows


def qwen2_mot_forward(params, cfg: Qwen2MoTConfig, x: torch.Tensor,
                      pos_ids: torch.Tensor, cache, *,
                      q_valid: Union[None, int, Sequence[int]] = None,
                      mode: str = "und",
                      und_rows: Optional[torch.Tensor] = None,
                      is_causal: bool = True,
                      compute_dtype=torch.bfloat16, final_norm: bool = True,
                      commit: bool = True):
    """x [B, L, hidden] input embeddings at rope positions pos_ids [B, L];
    appends their keys and values to `cache` at each row's cursor (in
    place) and returns (hidden [B, L, hidden], cache). q_valid: the rows
    that advance the cursor (the rest are padding, written past it and
    masked). mode 'gen' runs the gen experts except at und_rows [n].
    commit=False writes and attends to the fresh rows as a committed pass
    does, and leaves `len` and `len_host` as they were: the rows up to
    the cursor are unchanged, so the pass leaves the context as it was."""
    b, l, _ = x.shape
    hd = cfg.head_dim
    cap = cache["k"].shape[2]
    if max(cache["len_host"]) + l > cap:
        raise ValueError(
            f"appending {l} rows at cache length {max(cache['len_host'])} "
            f"passes the KV cache capacity {cap}")
    valid = _rows_valid(q_valid, b, l)
    kv_len = cache["len"]
    new_host = [n + a for n, a in zip(cache["len_host"], valid)]
    new_len = (kv_len + valid[0] if len(set(valid)) == 1 else
               kv_len + torch.tensor(valid, dtype=torch.int32,
                                     device=kv_len.device))

    tp = tp_of(params)
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if tp is not None:
        nh, nkv = tp.heads(nh), tp.heads(nkv)
    if cache["k"].shape[3] != nkv:
        raise ValueError(f"the KV cache holds {cache['k'].shape[3]} kv "
                         f"heads, the rank runs {nkv} (init_kv_cache's tp)")
    cos, sin = rope_tables(pos_ids.expand(b, l), hd, cfg.rope_theta)
    x = x.to(compute_dtype)
    gen_mode = mode != "und" and cfg.moe
    und = None
    if gen_mode:
        und = und_rows if und_rows is not None else torch.zeros(
            (0,), dtype=torch.long, device=x.device)
    groups = nh // nkv
    write_at = (kv_len.long()[:, None]
                + torch.arange(l, device=x.device)[None, :])   # [B, L]
    batch_idx = torch.arange(b, device=x.device)[:, None]

    def ln(layer, name, h):
        if not gen_mode:
            return unn.rms_norm(h, layer[name].to(h.dtype),
                                eps=cfg.rms_norm_eps)
        return _expert_norm(layer[name], layer[name + "_gen"], h, und,
                            cfg.rms_norm_eps)

    def proj(attn_u, attn_g, name, h):
        if not gen_mode:
            return unn.linear(attn_u[name], h, compute_dtype=compute_dtype)
        return _expert_linear(attn_u[name], attn_g[name], h, und,
                              compute_dtype)

    def one_layer(layer, i, h):
        attn_u = layer.attn
        attn_g = layer.attn_gen if gen_mode else attn_u
        y = copy_to_tp(ln(layer, "input_ln", h), tp)
        q = proj(attn_u, attn_g, "q", y).reshape(b, l, nh, hd)
        k = proj(attn_u, attn_g, "k", y).reshape(b, l, nkv, hd)
        v = proj(attn_u, attn_g, "v", y).reshape(b, l, nkv, hd)
        if cfg.qk_norm:
            if not gen_mode:
                q = unn.rms_norm(q, attn_u.q_norm.to(q.dtype),
                                 eps=cfg.rms_norm_eps)
                k = unn.rms_norm(k, attn_u.k_norm.to(k.dtype),
                                 eps=cfg.rms_norm_eps)
            else:
                q = _expert_norm(attn_u.q_norm, attn_g.q_norm, q, und,
                                 cfg.rms_norm_eps)
                k = _expert_norm(attn_u.k_norm, attn_g.k_norm, k, und,
                                 cfg.rms_norm_eps)
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)

        # append the fresh keys and values at each row's cursor
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[batch_idx, write_at] = k.to(k_cache.dtype)
        v_cache[batch_idx, write_at] = v.to(v_cache.dtype)
        if l <= _GQA_DENSE_MAX_Q and groups > 1:
            # keys past the longest row are masked: read up to there
            live = max(new_host)
            a = _gqa_dense_attention(q, k_cache[:, :live], v_cache[:, :live],
                                     kv_len, new_len, is_causal,
                                     compute_dtype)
        else:
            a = _cached_attention(q, k_cache, v_cache, kv_len, new_len,
                                  is_causal, compute_dtype)
        h = h + _tp_sum(proj(attn_u, attn_g, "o", a.reshape(b, l, nh * hd)),
                        tp, compute_dtype)

        y = ln(layer, "post_ln", h)
        if not gen_mode:
            m = _qwen_mlp(layer.mlp, y, compute_dtype, tp)
        else:
            m = _qwen_mlp(layer.mlp_gen, y, compute_dtype, tp)
            if und.numel() > 0:
                m[:, und] = _qwen_mlp(layer.mlp, y[:, und], compute_dtype, tp)
        return h + _tp_sum(m, tp, compute_dtype)

    h = x
    for i, layer in enumerate(params.layers):
        with gathered(layer):
            h = one_layer(layer, i, h)

    if commit:
        cache["len"] = new_len
        cache["len_host"] = new_host
    if final_norm:
        if gen_mode:
            h = _expert_norm(params.norm, params.norm_gen, h, und,
                             cfg.rms_norm_eps)
        else:
            h = unn.rms_norm(h, params.norm.to(h.dtype), eps=cfg.rms_norm_eps)
    return h, cache


def _gqa_dense_attention(q, k_cache, v_cache, kv_len, new_len, is_causal,
                         compute_dtype):
    """Decode-shaped attention with grouped kv heads, two plain einsums
    over the un-repeated cache: q [B, l, n, d] over caches [B, S, kvh, d],
    fp32 scores and softmax. Keys at or past new_len[b] are masked, and
    with is_causal those past kv_len[b] + row."""
    b, l, n, d = q.shape
    s_cap, kvh = k_cache.shape[1], k_cache.shape[2]
    g = n // kvh
    qg = q.reshape(b, l, kvh, g, d).to(compute_dtype).float()
    scores = torch.einsum("blkgd,bskd->blkgs", qg,
                          k_cache.to(compute_dtype).float()) \
        * (1.0 / math.sqrt(d))
    col = torch.arange(s_cap, device=q.device)
    mask = col[None, None, :] < new_len[:, None, None]          # [B, 1, S]
    if is_causal:
        row = kv_len[:, None] + torch.arange(l, device=q.device)[None, :]
        mask = mask & (col[None, None, :] <= row[:, :, None])   # [B, l, S]
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("blkgs,bskd->blkgd", p.to(compute_dtype).float(),
                       v_cache.to(compute_dtype).float())
    return out.reshape(b, l, n, d).to(compute_dtype)


def _cached_attention(q, k_cache, v_cache, kv_len, new_len, is_causal,
                      compute_dtype):
    """Fresh queries (rows kv_len[b] .. kv_len[b] + L - 1) over the cache,
    masked to new_len: causal at the dynamic per-row offset kv_len (the
    kernel's q_offsets mode), or non-causal (the ViT append). The kv heads
    stay grouped (the JAX prefill repeats them first)."""
    cd = compute_dtype
    if is_causal:
        return attention(q.to(cd), k_cache.to(cd), v_cache.to(cd),
                         causal=True, q_offsets=kv_len, kv_len=new_len)
    return attention(q.to(cd), k_cache.to(cd), v_cache.to(cd),
                     kv_len=new_len)


def lm_head_logits(params, cfg: Qwen2MoTConfig, hidden: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    with gathered(params):
        return unn.linear(params.lm_head, hidden.to(compute_dtype),
                          compute_dtype=compute_dtype).float()
