"""UMT5 text encoder.

Counterpart of univid_tpu/models/wan/t5.py: pre-norm blocks, a relative-
position attention bias per layer (umt5), gated GELU-tanh feed-forward,
unscaled attention with an fp32 softmax, final RMS norm. The bucket table
for a fixed length is computed on the host in numpy. An encoder sharded by
`parallel.sharding.shard_params` runs as it is: the forward gathers the
root's unit around the token embedding and each block's around the block.
On a mesh with tp > 1 a rank runs its num_heads / tp heads with their
columns of the relative position bias, and dim_ffn / tp of the gated FFN:
q / k / v, gate and fc1 are column-parallel, o and fc2 row-parallel
(`parallel.tensor_parallel`). Its head dim of 64 takes the reference
attention route either way.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ...core import nn as unn
from ...core.config import T5Config
from ...parallel.sharding import gathered
from ...parallel.tensor_parallel import (copy_to_tp, row_parallel_linear,
                                         tp_of)


def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32,
                              max_dist: int = 128,
                              bidirectional: bool = True) -> np.ndarray:
    """[Lq, Lk] int32 bucket ids."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        out = (rel > 0).astype(np.int64) * nb
        rel = np.abs(rel)
    else:
        nb = num_buckets
        out = np.zeros_like(rel)
        rel = -np.minimum(rel, 0)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel, 1) / max_exact)
            / math.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    out = out + np.where(rel < max_exact, rel, large)
    return out.astype(np.int32)


class UMT5Encoder(nn.Module):
    """Parameters of the encoder (names follow init_t5_encoder's tree).
    With `gen`, drawn with its distributions: token embedding N(0, 1),
    q ~ N(0, (d*da)^-1/2), k, v ~ N(0, d^-1/2), o ~ N(0, (nh*da)^-1/2),
    position tables ~ N(0, (2*buckets*nh)^-1/2), gate / fc1 ~
    N(0, d^-1/2), fc2 ~ N(0, dff^-1/2), norms ones."""

    def __init__(self, cfg: T5Config, *, dtype=torch.float32, device="cuda",
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, da, dff, nh = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads

        def p(shape, init, std=1.0):
            return unn.param(shape, dtype, device, gen, init, std=std)

        def lin(i, o, std):
            return unn.Node(w=p((o, i), "normal", std))

        self.token_embedding = p((cfg.vocab_size, d), "normal", 1.0)
        self.norm = p((d,), "ones")
        blocks = []
        for i in range(cfg.num_layers):
            blk = dict(
                norm1=p((d,), "ones"),
                attn=unn.Node(q=lin(d, da, (d * da) ** -0.5),
                              k=lin(d, da, d ** -0.5),
                              v=lin(d, da, d ** -0.5),
                              o=lin(da, d, (nh * da) ** -0.5)),
                norm2=p((d,), "ones"),
                ffn=unn.Node(gate=lin(d, dff, d ** -0.5),
                             fc1=lin(d, dff, d ** -0.5),
                             fc2=lin(dff, d, dff ** -0.5)))
            if not cfg.shared_pos or i == 0:
                blk["pos_embedding"] = p((cfg.num_buckets, nh), "normal",
                                         (2 * cfg.num_buckets * nh) ** -0.5)
            blocks.append(unn.Node(**blk))
        self.blocks = nn.ModuleList(blocks)


def _t5_attention(p, x, pos_bias, mask, num_heads, compute_dtype, tp=None):
    """Unscaled attention with an additive position bias, fp32 softmax.
    Under tp: the rank's heads (pos_bias [N, Lq, Lk] sliced to them)."""
    b, l, _ = x.shape
    if tp is not None:
        num_heads = tp.heads(num_heads)
        pos_bias = pos_bias[tp.slice(pos_bias.shape[0])]
        x = copy_to_tp(x, tp)
    q = unn.linear(p["q"], x, compute_dtype=compute_dtype)
    k = unn.linear(p["k"], x, compute_dtype=compute_dtype)
    v = unn.linear(p["v"], x, compute_dtype=compute_dtype)
    dh = q.shape[-1] // num_heads
    q = q.reshape(b, l, num_heads, dh)
    k = k.reshape(b, l, num_heads, dh)
    v = v.reshape(b, l, num_heads, dh)
    s = torch.einsum("bind,bjnd->bnij", q.float(), k.float())
    s = s + pos_bias[None]
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p_attn = torch.softmax(s, dim=-1)
    o = torch.einsum("bnij,bjnd->bind", p_attn.to(compute_dtype).float(),
                     v.float())
    o = o.reshape(b, l, num_heads * dh).to(compute_dtype)
    return row_parallel_linear(p["o"], o, tp, compute_dtype)


@torch.no_grad()
def t5_encode(model: UMT5Encoder, ids: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """ids [B, L] int -> embeddings [B, L, dim] (padded rows not zeroed)."""
    cfg = model.cfg
    tp = tp_of(model)
    _, l = ids.shape
    buckets = torch.as_tensor(relative_position_buckets(
        l, l, cfg.num_buckets, cfg.rel_pos_max_dist),
        dtype=torch.long, device=ids.device)
    with gathered(model):
        x = model.token_embedding[ids].to(compute_dtype)
    shared_bias = None
    if cfg.shared_pos:
        shared_bias = model.blocks[0].pos_embedding.float()[buckets] \
            .permute(2, 0, 1)
    for bp in model.blocks:
        bias = shared_bias if shared_bias is not None else \
            bp.pos_embedding.float()[buckets].permute(2, 0, 1)
        with gathered(bp):
            y = unn.rms_norm(x, bp.norm1.to(compute_dtype), eps=1e-6)
            x = x + _t5_attention(bp.attn, y, bias, mask, cfg.num_heads,
                                  compute_dtype, tp)
            y = copy_to_tp(unn.rms_norm(x, bp.norm2.to(compute_dtype),
                                        eps=1e-6), tp)
            ff = bp.ffn
            gate = unn.gelu_tanh(unn.linear(ff["gate"], y,
                                            compute_dtype=compute_dtype))
            h = unn.linear(ff["fc1"], y, compute_dtype=compute_dtype) * gate
            x = x + row_parallel_linear(ff["fc2"], h, tp, compute_dtype)
    return unn.rms_norm(x, model.norm.to(compute_dtype), eps=1e-6)


def encode_padded(model: UMT5Encoder, ids: torch.Tensor,
                  seq_lens: torch.Tensor, compute_dtype=torch.bfloat16
                  ) -> torch.Tensor:
    """Run with an attention mask, then zero the padded rows (the Wan
    contract: the DiT sees zeros past each prompt)."""
    mask = torch.arange(ids.shape[1], device=ids.device)[None, :] \
        < seq_lens.to(ids.device)[:, None]
    x = t5_encode(model, ids, mask, compute_dtype)
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
