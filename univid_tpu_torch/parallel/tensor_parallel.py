"""Tensor parallelism over the mesh's `tp` axis: the collectives of the
forwards.

The JAX package has no counterpart: GSPMD inserts these collectives where
the rules' `tp` axis shards a projection. Here a model that
`parallel.sharding.shard_params` placed on a mesh with tp > 1 carries its
`TensorParallel` (`tp_of`), and its forwards call the collectives
explicitly; `parallelize_module`'s hooks would never fire, since the
forwards read the parameters directly. A rank holds N / tp heads of each
attention and ffn / tp of each hidden layer:

  column-parallel  q, k, v, fc0 (gate, up): the rank's rows of the weight
                   and bias, its input through `copy_to_tp`;
  row-parallel     o, fc1 (fc2, down): the rank's columns, the partial
                   products summed by `reduce_from_tp`, then the bias
                   (whole on every rank) added once (`row_parallel_linear`);
  gathered         FLUX's fused qkv, linear1 and modulations: the rank's
                   rows of the weight, the outputs all-gathered over tp
                   (`gather_from_tp`), since a row shard of a fused
                   projection holds no whole heads.

Each collective is an autograd Function with Megatron-LM's pairing:
`copy_to_tp` is the identity forward and an all-reduce backward (the
rank's heads give a part of the input's gradient); `reduce_from_tp` an
all-reduce forward and the identity backward (what follows is the same on
every rank); `sum_over_tp` an all-reduce both ways, for a sum that the
rank's heads go on to use alone: Wan's qk norm spans all N * D of a token
(`rms_norm_tp`), so its sum of squares is the rank's part, summed over tp.
Under grad the norm is plain torch; under no_grad the normed q and k go on
to kernel A's rope-only mode in `attention`, as on the Ulysses path after
its exchange. A fused norm that takes the total from outside is later
speed work (ROADMAP.md queue 1 item 13b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import nn as unn


@dataclass(frozen=True)
class TensorParallel:
    """The tp process group a model's forwards run their collectives on,
    its size and this rank's index in it."""
    group: object
    size: int
    rank: int

    def heads(self, n: int) -> int:
        """The rank's share of n heads (or rows); refuses a remainder."""
        if n % self.size:
            raise ValueError(f"{n} heads do not split over tp = {self.size}")
        return n // self.size

    def slice(self, n: int) -> slice:
        """The rank's rows of a dimension of n rows."""
        m = self.heads(n)
        return slice(self.rank * m, (self.rank + 1) * m)


def tp_of(module) -> Optional[TensorParallel]:
    """The model's TensorParallel (set by `shard_params` on a mesh with tp >
    1), else None."""
    return getattr(module, "tensor_parallel", None)


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """The input of a column-parallel projection: x itself; its gradient
    summed over the tp group."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """The partial products of a row-parallel projection summed over the
    tp group; the gradient passes as it is."""
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def sum_over_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """A partial sum completed over the tp group, forward and backward."""
    return x if tp is None else _SumOverTP.apply(x, tp.group)


@torch.no_grad()
def gather_from_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """The tp group's shards of x concatenated along its last dimension, in
    rank order (one all_gather_into_tensor): the whole output of a
    projection whose row shards hold no whole heads (FLUX's fused qkv,
    linear1 and modulations). No backward: the FLUX forward that calls it
    refuses grad. x itself under tp None."""
    if tp is None:
        return x
    t = x.movedim(-1, 0).contiguous()
    out = t.new_empty((tp.size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=tp.group)
    return out.movedim(0, -1)


def row_parallel_linear(p, x: torch.Tensor, tp: Optional[TensorParallel],
                        compute_dtype) -> torch.Tensor:
    """y = x @ w^T + b where x [..., in / tp] and p.w [out, in / tp] are the
    rank's columns: the rank's product (fp32 on the CPU and in fp32, the
    compute dtype on the card, as `core.nn.linear` computes it), summed
    over tp in fp32, then the bias once, one rounding to the compute
    dtype. tp None: `core.nn.linear`."""
    if tp is None:
        return unn.linear(p, x, compute_dtype=compute_dtype)
    if getattr(p, "qw8", None) is not None or getattr(p, "qw", None) is not None:
        raise NotImplementedError(
            "a quantized row-parallel projection: quantize the model before "
            "it is sharded over tp, or serve it at tp = 1")
    cd = compute_dtype
    if x.is_cuda and cd != torch.float32:
        y = F.linear(x.to(cd), p.w.to(cd))
    else:
        y = F.linear(x.float(), p.w.float())
    y = reduce_from_tp(y.float(), tp)
    b = getattr(p, "b", None)
    if b is not None:
        y = y + b.float()
    return y.to(cd)


def rms_norm_tp(x: torch.Tensor, gain: torch.Tensor, eps: float,
                tp: Optional[TensorParallel]) -> torch.Tensor:
    """`core.nn.rms_norm` over the whole last dimension of a tensor whose
    last dimension the tp group holds in parts (x [..., W / tp], the rank's
    part): the fp32 sum of squares summed over tp, rsqrt of its mean, cast
    back, times the rank's slice of `gain` [W] (whole on every rank; its
    gradient summed over tp)."""
    if tp is None:
        return unn.rms_norm(x, gain.to(x.dtype), eps=eps)
    w_loc = x.shape[-1]
    dtype = x.dtype
    x32 = x.float()
    ss = sum_over_tp(x32.square().sum(dim=-1, keepdim=True), tp)
    y = x32 * torch.rsqrt(ss / (w_loc * tp.size) + eps)
    g = copy_to_tp(gain, tp)[tp.rank * w_loc:(tp.rank + 1) * w_loc]
    return y.to(dtype) * g.to(dtype)
