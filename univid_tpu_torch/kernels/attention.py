"""Attention dispatcher: the hand-written kernels, or the plain reference.

Counterpart of univid_tpu/kernels/attention.py::attention for the t2v
inference options, the training paths, BAGEL's causal KV-cache prefill and
BAGEL packed training (`pack_mask_codes`, `packed_mode`). Inputs are
[B, L, N, D] and may be unpadded: the kernel route pads Lq and Lk to the
kernels' tile multiple, masks padded keys through kv_len (and pads segment
ids with JAX's -1 for queries, -2 for keys, which match nothing) and
slices the output back. k and v may have fewer heads than q (grouped-query
attention, N a multiple of their head count): the kernel reads each kv head
for its group of query heads, the reference route repeats them. Routes:

  kernel     — kernels.flash_attention (CUDA kernels on the card, their
               plain versions on the CPU), for head dims that are multiples
               of 128. A call that needs a gradient (grad enabled and q, k
               or v requiring it) goes through `FlashAttention`, the
               counterpart of the JAX package's `_flash` custom VJP: the
               forward that saves the lse, then the backward kernels, with
               every mask (kv_len, causal, segments, packed codes) in bf16
               (the unmasked modes on the one-pass sm90 backward),
               and with kv_len in fp32 (the DiT at its default fp32
               policy; fp32 masked modes raise on the card).
  reference  — `mha_reference`, a masked softmax attention, for other head
               dims (as on the TPU), segment masks included (SigLIP's
               d=72); differentiable by plain autograd.

The Wan serving knobs, JAX's semantics: `softmax_bf16` (the bf16 softmax
chain) and `qk_int8` (int8 QK^T with per-row q and per-kv-block k scales,
the block width JAX's dispatcher picks, `jax_block_k`) take the kernel
route's bf16 kernels with kv_len and the bound; the reference route and a
call under grad ignore them, as the JAX package's XLA fallback and its
training forward (`_flash_fwd`) do. With causal, segment or packed masks,
and on the card with fp32 inputs, they raise (no caller, no kernel mode).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .flash_attention import (LOG2E, NEG_INF, TILE, _fold, causal_rows,
                              flash_attention_bwd_folded,
                              flash_attention_fwd_folded,
                              flash_attention_padded, packed_mask_allowed,
                              repeat_kv, rotate, tma_readable)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def jax_block_k(lk: int) -> int:
    """The kv block width the JAX dispatcher picks for Lk keys
    (univid_tpu/kernels/attention.py): 2048 from 4,096 keys when that adds
    no padding over 1024, else 1024; 512 below; at most round_up(Lk, 128).
    qk_int8 takes one k scale per block of this width."""
    if lk >= 4096:
        bk = 2048 if _round_up(lk, 2048) == _round_up(lk, 1024) else 1024
    else:
        bk = 512
    return min(bk, _round_up(lk, 128))


def pack_mask_codes(doc_id, fn_id, noise_id):
    """Pack BAGEL packed training's three mask id arrays into one int32 per
    token: doc in bits 16+, full/noise split id + 1 (0 = none) in bits
    8-15, noise split id + 1 in bits 0-7 (data_utils.py create_sparse_mask
    ids). numpy arrays in, numpy out; torch tensors in, torch out."""
    if isinstance(doc_id, torch.Tensor):
        doc, fn, nz = (torch.as_tensor(x, dtype=torch.int32)
                       for x in (doc_id, fn_id, noise_id))
    else:
        doc, fn, nz = (np.asarray(x, np.int32)
                       for x in (doc_id, fn_id, noise_id))
    return (doc << 16) | ((fn + 1) << 8) | (nz + 1)


def mha_reference(q, k, v, *, kv_len=None, q_segments=None,
                  kv_segments=None, softmax_scale=None, causal=False,
                  q_offset=0, q_offsets=None, packed_mode=False):
    """Masked attention with an fp32 softmax (the JAX package's XLA path):
    with `causal`, keys past the query's row arange(Lq) + q_offset (+
    q_offsets[b]) are masked; so are keys at or past kv_len[b], and keys
    whose segment id differs from the query's (q_segments [B, Lq],
    kv_segments [B, Lk]); with packed_mode the ids are pack_mask_codes
    codes and `packed_mask_allowed` decides (query rows arange(Lq) +
    q_offset). A row with no valid key is zero: with segments, where no key
    passes both masks; without, where kv_len == 0 (a causal row always sees
    key 0: offsets are >= 0). k and v with fewer heads are repeated. p is
    rounded to v's dtype for p @ v; the output has q's dtype."""
    d = q.shape[-1]
    lq, lk = q.shape[1], k.shape[1]
    k, v = repeat_kv(k, q.shape[2]), repeat_kv(v, q.shape[2])
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * softmax_scale
    if causal:
        rows = causal_rows(lq, q_offset, q_offsets, q.device)
        cols = torch.arange(lk, device=q.device)
        s = s.masked_fill((cols[None, None, :] > rows[:, :, None])[:, None],
                          NEG_INF)
    kv_valid = None
    if kv_len is not None:
        kv_len = kv_len.to(q.device)
        kv_valid = torch.arange(lk, device=q.device)[None, :] < kv_len[:, None]
        s = s.masked_fill(~kv_valid[:, None, None, :], NEG_INF)
    seg_mask = None
    if q_segments is not None:
        qs = q_segments.to(q.device)[:, :, None]
        ks = kv_segments.to(q.device)[:, None, :]
        if packed_mode:
            rows = torch.arange(lq, device=q.device)[None, :, None] + q_offset
            cols = torch.arange(lk, device=q.device)[None, None, :]
            seg_mask = packed_mask_allowed(qs, ks, rows, cols)[:, None]
        else:
            seg_mask = (qs == ks)[:, None]
        s = s.masked_fill(~seg_mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if seg_mask is not None:
        valid = seg_mask if kv_valid is None \
            else seg_mask & kv_valid[:, None, None, :]
        p = torch.where(valid.any(dim=-1, keepdim=True), p, 0.0)
    elif kv_len is not None:
        p = torch.where((kv_len > 0)[:, None, None, None], p, 0.0)
    o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over PADDED inputs (JAX `_flash`).

    Takes the raw q and folds it by softmax_scale * log2(e) inside, as JAX
    does; the forward saves (qs, k, v, o, lse) and the backward runs the
    backward kernels on them (their plain versions on the CPU), under the
    forward's masks. kv_len, the masks and score_bound get no gradient:
    the bound only moves the softmax's reference point, so d(out)/d(bound)
    = 0."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, score_bound, softmax_scale, causal,
                q_offset, q_offsets, q_segments, kv_segments, packed_mode):
        qs = _fold(q, softmax_scale)
        masks = dict(causal=causal, q_offset=q_offset, q_offsets=q_offsets,
                     q_segments=q_segments, kv_segments=kv_segments,
                     packed_mode=packed_mode)
        o, lse = flash_attention_fwd_folded(qs, k, v, kv_len=kv_len,
                                            score_bound=score_bound, **masks)
        ctx.save_for_backward(qs, k, v, o, lse, kv_len, q_offsets,
                              q_segments, kv_segments)
        ctx.softmax_scale = softmax_scale
        ctx.flags = (causal, q_offset, packed_mode)
        return o

    @staticmethod
    def backward(ctx, do):
        (qs, k, v, o, lse, kv_len, q_offsets, q_segments,
         kv_segments) = ctx.saved_tensors
        causal, q_offset, packed_mode = ctx.flags
        if do.stride(-1) != 1 or (do.dtype == torch.float32 and (
                do.data_ptr() % 16 or any(s % 4 for s in do.stride()[:-1]))):
            do = do.contiguous()   # the fp32 kernels read aligned rows
        elif do.is_cuda and do.dtype == torch.bfloat16 and not tma_readable(
                do):
            do = do.contiguous()   # the sm90 backward reads it through TMA
        dq, dk, dv = flash_attention_bwd_folded(
            qs, k, v, o, lse, do, kv_len=kv_len,
            softmax_scale=ctx.softmax_scale, causal=causal,
            q_offset=q_offset, q_offsets=q_offsets, q_segments=q_segments,
            kv_segments=kv_segments, packed_mode=packed_mode)
        return (dq, dk, dv) + (None,) * 9


def attention(q, k, v, *, kv_len=None, softmax_scale=None, rope_tables=None,
              score_bound=None, causal=False, q_offset=0, q_offsets=None,
              q_segments=None, kv_segments=None, packed_mode=False,
              softmax_bf16=False, qk_int8=False):
    """Multi-head attention over [B, L, N, D] tensors (k, v [B, Lk, N /
    group, D]).

    kv_len: int32 [B] valid keys per batch row. causal: query i of batch b
    sits at row i + q_offset (+ q_offsets[b], int32 [B]) and sees the keys
    at or before it (the kernel route reads q_offsets on the device).
    q_segments [B, Lq] and kv_segments [B, Lk] (int32): a query sees only
    keys of its own segment id; with packed_mode they are pack_mask_codes
    codes and BAGEL's packed-training predicate applies (no q offsets). The
    kernel route pads them with -1 (queries) and -2 (keys), as the JAX
    dispatcher does; padded query rows see no key and come out zero (the
    JAX kernel gives them other values; they are sliced off). rope_tables:
    build_fused_rope_tables output (fused rotation of q and k). score_bound:
    a PROVEN upper bound on the RAW q.k scores (d * max|g_q| * max|g_k| for
    qk-normed rows) -> bounded softmax in the kernel route; the reference
    route ignores it (exact softmax either way).

    Under grad (grad enabled and q, k or v requiring it) the kernel route
    runs `FlashAttention`: rope_tables are refused (training rotates q and
    k outside the kernel, as the JAX package does), the cross call takes
    the generic kernel rather than the one-shot route, the bound is
    detached; bf16 takes every mask, fp32 (d=128 kernels) kv_len only.
    Grouped kv heads under grad are refused: repeat them first, as the
    JAX callers do (autograd sums the repeat).

    softmax_bf16 / qk_int8: inference knobs of the kernel route (see the
    module docstring); under grad and on the reference route they are
    ignored, as in the JAX package. qk_int8's k scales span `jax_block_k`
    (Lk) keys."""
    b, lq, n, d = q.shape
    segs = q_segments is not None or kv_segments is not None
    if segs and (q_segments is None or kv_segments is None):
        raise ValueError("pass both q_segments and kv_segments")
    if packed_mode and not segs:
        raise ValueError("packed_mode takes the codes as q_segments and "
                         "kv_segments")
    # the packed mode's causal term reads the pack's own row indices
    assert not (packed_mode and (q_offset != 0 or q_offsets is not None)), \
        "packed_mode does not support q offsets"
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if n % k.shape[2] or k.shape[2] != v.shape[2]:
        raise ValueError(f"{n} query heads over {k.shape[2]} kv heads")
    lk = k.shape[1]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32).to(q.device)
    if q_offsets is not None:
        q_offsets = torch.as_tensor(q_offsets, dtype=torch.int32).to(
            q.device)
    if d % 128 != 0:
        if rope_tables is not None:
            # rotate with the UNSCALED (k) tables: mha_reference scales
            _, _, ck, sk = rope_tables
            q = rotate(q, ck[:lq], sk[:lq], q.dtype)
            k = rotate(k, ck[:lk], sk[:lk], k.dtype)
        return mha_reference(q, k, v, kv_len=kv_len, q_segments=q_segments,
                             kv_segments=kv_segments,
                             softmax_scale=softmax_scale, causal=causal,
                             q_offset=q_offset, q_offsets=q_offsets,
                             packed_mode=packed_mode)
    if train and k.shape[2] != n:
        raise NotImplementedError(
            "grouped kv heads under grad: the backward kernels take as many "
            "kv heads as query heads")
    if train and rope_tables is not None:
        raise NotImplementedError(
            "fused rope is inference-only: under grad, rotate q and k "
            "before the call (the DiT does so when fused_rope=False)")

    lq_pad = _round_up(lq, TILE)
    lk_pad = _round_up(lk, TILE)
    if lk_pad != lk and kv_len is None:
        kv_len = torch.full((b,), lk, dtype=torch.int32, device=q.device)
    if segs:   # the kernels read contiguous int32 [B, L] ids
        q_segments = torch.as_tensor(q_segments, dtype=torch.int32).to(
            q.device).contiguous()
        kv_segments = torch.as_tensor(kv_segments, dtype=torch.int32).to(
            q.device).contiguous()
    if lq_pad != lq:
        q = F.pad(q, (0, 0, 0, 0, 0, lq_pad - lq))
        if segs:
            q_segments = F.pad(q_segments, (0, lq_pad - lq), value=-1)
    if lk_pad != lk:
        k = F.pad(k, (0, 0, 0, 0, 0, lk_pad - lk))
        v = F.pad(v, (0, 0, 0, 0, 0, lk_pad - lk))
        if segs:
            kv_segments = F.pad(kv_segments, (0, lk_pad - lk), value=-2)
    masks = dict(causal=causal, q_offset=q_offset, q_offsets=q_offsets,
                 q_segments=q_segments, kv_segments=kv_segments,
                 packed_mode=packed_mode)

    sc = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    folded_bound = None
    if score_bound is not None:
        # kernel scores carry softmax_scale * log2(e): fold the raw bound
        folded_bound = torch.as_tensor(score_bound, dtype=torch.float32) \
            .to(q.device).detach() * (sc * LOG2E)
    if train:
        return FlashAttention.apply(q, k, v, kv_len, folded_bound, sc,
                                    causal, q_offset, q_offsets, q_segments,
                                    kv_segments, packed_mode)[:, :lq]
    o = flash_attention_padded(q, k, v, kv_len=kv_len,
                               softmax_scale=softmax_scale,
                               rope_tables=rope_tables,
                               score_bound=folded_bound,
                               softmax_bf16=softmax_bf16, qk_int8=qk_int8,
                               block_k=jax_block_k(lk), **masks)
    return o[:, :lq]
