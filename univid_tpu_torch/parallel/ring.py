"""Ring attention over the sequence-parallel group.

Counterpart of univid_tpu/parallel/ring.py. q, k and v arrive sharded over
the sequence, [B, L/sp, N, D] on each rank, q and k already rotated by
their global positions. The key / value shards pass around the ring, one
rank a step, so every shard visits every rank; at each visit the rank runs
`flash_attention_padded(..., save_residuals=True)` of its queries over the
visiting shard, with that shard's kv_len = clip(seq_len_global - src *
L/sp, 0, L/sp) (on the card: the running-max lse output of
flash_attention_sm90.cu), and merges the partial into its running result
in fp32, in the exp2 domain of the kernel's lse:

  lse' = log2(2^lse_a + 2^lse_b)
  o'   = 2^(lse_a - lse') o_a + 2^(lse_b - lse') o_b

A shard with no valid key (kv_len 0) gives zero rows with lse +1e30, which
the merge maps to zero weight. The merge is a plain elementwise pass, of
the form of the causal kernel's split merge (`causal_split_plain`). The
shards move from rank to rank on the group's backend (`pass_on`);
overlapping the pass of the next shard with the kernel is later work.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.flash_attention import NEG_INF, flash_attention_padded

RING_TILE = 128   # the local length the kernels take without a pad


def _row_lse(lse: torch.Tensor) -> torch.Tensor:
    """The kernel's lse [B, N, L] -> [B, L, N, 1] fp32, its empty-row
    sentinel (+1e30) mapped to -1e30 so that the row weighs nothing."""
    row = lse.permute(0, 2, 1)[..., None]
    return torch.where(row > 1e29, NEG_INF, row)


def merge_partials(o, lse, o_i, lse_i):
    """Merge two normalised partials of the same rows (o [B, L, N, D] fp32,
    lse [B, L, N, 1] fp32 with -1e30 for empty rows): (o', lse')."""
    m = torch.maximum(lse, lse_i)
    live = m > NEG_INF / 2
    w_a = torch.where(live, torch.exp2(lse - m), 0.0)
    w_b = torch.where(live, torch.exp2(lse_i - m), 0.0)
    tot = w_a + w_b
    lse_new = torch.where(tot > 0, m + torch.log2(tot.clamp_min(1e-30)),
                          NEG_INF)
    inv = torch.where(tot > 0, 1.0 / tot.clamp_min(1e-30), 0.0)
    return (o * w_a + o_i.float() * w_b) * inv, lse_new


def pass_on(t: torch.Tensor, group) -> torch.Tensor:
    """Send t to the next rank of the group's ring and return the tensor
    of the previous rank: one all_to_all_single whose only nonzero split
    goes to the next rank (gloo, which the one-card check runs its ranks
    on, has no point-to-point for CUDA tensors; the exchange is one call on
    any backend)."""
    sp = dist.get_world_size(group)
    me = dist.get_rank(group)
    n = t.numel()
    send = [n if j == (me + 1) % sp else 0 for j in range(sp)]
    recv = [n if j == (me - 1) % sp else 0 for j in range(sp)]
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    dist.all_to_all_single(out.view(-1), t.contiguous().view(-1), recv,
                           send, group=group)
    return out


def ring_attention(q, k, v, group, *,
                   seq_len_global: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Full (non-causal) attention over sequence-sharded q, k, v [B, L/sp,
    N, D] on the ranks of `group`, scaled by 1/sqrt(D); returns [B, L/sp,
    N, D] in q's dtype.

    seq_len_global: int32 [B], the real total key count (the padded tail
    past it is masked); None: every key is real. A local length that is
    not a multiple of RING_TILE is padded here, and the pad masked."""
    sp = dist.get_world_size(group)
    me = dist.get_rank(group)
    b, l_loc, n, d = q.shape
    if seq_len_global is None:
        seq_len_global = torch.full((b,), sp * l_loc, dtype=torch.int32)
    seq_len_global = seq_len_global.to(q.device, torch.int32)
    pad = -l_loc % RING_TILE
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, q.shape[1], n, 1), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for step in range(sp):
        # the shard on this rank now started on rank (me - step) % sp
        src = (me - step) % sp
        valid = (seq_len_global - src * l_loc).clamp(0, l_loc)
        o_i, lse_i = flash_attention_padded(
            q, k, v, kv_len=valid.to(torch.int32), save_residuals=True)
        o, lse = merge_partials(o, lse, o_i, _row_lse(lse_i))
        del o_i, lse_i
        if step + 1 < sp:
            k, v = pass_on(k, group), pass_on(v, group)
    return o[:, :l_loc].to(q.dtype)
