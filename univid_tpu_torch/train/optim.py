"""Optimizers with optax's semantics, over lists of tensors.

Counterpart of the optax chains of univid_tpu/train/fusion_trainer.py
(make_fusion_optimizer) and univid_tpu/train/trainer.py (make_optimizer):
`chain(clip_by_global_norm(c), adamw(lr, ...))`. A transform is a pair
init(params) -> state and update(grads, state, params) -> (updates,
state) over equally long lists of tensors; `apply_updates` adds the
updates to the parameters in place (the JAX package builds new arrays; the
port updates the trainables where they are, which saves a copy of them).

What follows optax and not torch.optim:
  * clip_by_global_norm scales by max_norm / norm only when norm >=
    max_norm, as (g / norm) * max_norm (torch's clip_grad_norm_ divides by
    norm + 1e-6 and always multiplies);
  * adamw: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, bias
    correction by 1 - b^count with the incremented count, update
    -lr(count) * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * param),
    the schedule evaluated at the count before the increment;
  * cosine_onecycle_schedule and cosine_decay_schedule reproduce optax's
    formulas (piecewise cosine interpolation between accumulated values).

Sharded parameters (`parallel.sharding.shard_params`: DTensors over fsdp
and tp) come with DTensor gradients. Every transform works on the rank's
local tensors, and clip_by_global_norm's norm is the whole model's: a
DTensor's squared norm is summed over every mesh axis that shards it, and
a tensor that is whole on every rank (the norm gains, the modulation, the
embeddings' biases) counts once (`global_sq_norm`). dp replicas hold
equal gradients and count once.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

Schedule = Callable[[int], float]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (the rank's shard, sharing its storage); a
    plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_sq_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 squared L2 norm of all of `grads` as whole tensors: the
    local sums of the DTensors that share a mesh and placement summed over
    each mesh axis that shards them (one all-reduce an axis), plus the
    plain tensors' sums, counted once."""
    plain = []
    sharded = {}
    for g in grads:
        s = local(g).float().square().sum()
        if not isinstance(g, DTensor):
            plain.append(s)
            continue
        axes = tuple(i for i, pl in enumerate(g.placements) if pl.is_shard())
        key = (g.device_mesh.mesh_dim_names, axes)
        if key not in sharded:
            sharded[key] = (g.device_mesh, [])
        sharded[key][1].append(s)
    total = sum(plain) if plain else None
    for (_, axes), (mesh, sums) in sharded.items():
        s = torch.stack(sums).sum()
        for i in axes:
            dist.all_reduce(s, group=mesh.get_group(i))
        total = s if total is None else total + s
    return total


def clip_by_global_norm(max_norm: float) -> Transform:
    def init(params):
        return {}

    def update(grads, state, params=None):
        norm = torch.sqrt(global_sq_norm(grads))
        # the choice stays on the device (no host sync)
        clipped = [torch.where(norm < max_norm, g,
                               (g / norm.to(g.dtype)) * max_norm)
                   for g in map(local, grads)]
        return clipped, state

    return Transform(init, update)


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Transform:
    lr = learning_rate if callable(learning_rate) \
        else (lambda count: learning_rate)

    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(local(p),
                                        memory_format=torch.preserve_format)
                       for p in params],
                "nu": [torch.zeros_like(local(p),
                                        memory_format=torch.preserve_format)
                       for p in params]}

    def update(grads, state, params):
        count = state["count"] + 1
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count
        step_lr = float(lr(state["count"]))
        mu, nu, updates = [], [], []
        for g, m, v, p in zip(grads, state["mu"], state["nu"], params):
            g, p = local(g), local(p)
            m = (1.0 - b1) * g + b1 * m
            v = (1.0 - b2) * g.square() + b2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            u = u + weight_decay * p.detach()
            updates.append(-step_lr * u)
            mu.append(m)
            nu.append(v)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(grads, state, params):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, new

    return Transform(init, update)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    for p, u in zip(params, updates):
        local(p).add_(u.to(p.dtype))


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule: cosine from peak/div_factor up to
    peak over int(pct_start * steps), then down to peak / (div_factor *
    final_div_factor) at `transition_steps`, constant after."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    init = peak_value / div_factor
    values = [init, init * div_factor,
              init * div_factor / (div_factor * final_div_factor)]

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0
                          ) -> Schedule:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * cos_decay^exp +
    alpha), cos_decay = (1 + cos(pi * min(count, steps) / steps)) / 2."""
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule needs decay_steps > 0")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule
