"""Ulysses sequence-parallel attention: two all-to-all exchanges.

Counterpart of univid_tpu/parallel/ulysses.py. Activations arrive sharded
over the sequence, [B, L/sp, N, D] on each rank of the sp group. The first
`all_to_all_single` scatters heads and gathers the sequence, [B, L, N/sp,
D]; each rank runs the port's `attention` over the whole sequence for its
N/sp heads (on the card the bf16 kernel of flash_attention_sm90.cu, after
kernel A's rope-only pre-pass when rope_tables are given); the second
exchange undoes the first. Both move the tensors on their device through
the group's backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.attention import attention


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, L/sp, N, D] sequence shard -> [B, L, N/sp, D] head shard: rank r
    sends head group j to rank j and receives every rank's tokens of its
    own head group r, in rank (= sequence) order."""
    sp = dist.get_world_size(group)
    b, l_loc, n, d = x.shape
    if n % sp:
        raise ValueError(f"{n} heads do not split over sp = {sp}")
    send = x.reshape(b, l_loc, sp, n // sp, d).permute(2, 0, 1, 3, 4)
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    # recv [src rank, B, L/sp, N/sp, D]: the source rank's tokens
    return recv.permute(1, 0, 2, 3, 4).reshape(b, sp * l_loc, n // sp, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of `seq_to_heads`: [B, L, N/sp, D] -> [B, L/sp, N, D]."""
    sp = dist.get_world_size(group)
    b, l, n_loc, d = x.shape
    send = x.reshape(b, sp, l // sp, n_loc, d).permute(1, 0, 2, 3, 4)
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    # recv [src rank = head group, B, L/sp, N/sp, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, l // sp, sp * n_loc, d)


def ulysses_attention(q, k, v, group, *, kv_len=None, rope_tables=None,
                      softmax_bf16: bool = False, qk_int8: bool = False,
                      score_bound=None) -> torch.Tensor:
    """Full-sequence attention over sequence-sharded q, k, v [B, L/sp, N,
    D] on the ranks of `group`; returns [B, L/sp, N, D], sharded the same.

    kv_len [B]: the real key count of the GLOBAL sequence. rope_tables
    (build_fused_rope_tables over the global padded sequence) rotate q and
    k after the exchange, when each rank holds the whole sequence in global
    order: q and k then arrive unrotated, and already qk-normed (Wan's norm
    spans all N heads of a token, which only the sequence shard holds)."""
    qg, kg, vg = (seq_to_heads(t, group) for t in (q, k, v))
    o = attention(qg, kg, vg, kv_len=kv_len, rope_tables=rope_tables,
                  softmax_bf16=softmax_bf16, qk_int8=qk_int8,
                  score_bound=score_bound)
    del qg, kg, vg
    return heads_to_seq(o, group)
