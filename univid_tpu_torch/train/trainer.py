"""Full DiT fine-tune (flow-matching MSE), on one GPU or over a mesh.

Counterpart of univid_tpu/train/trainer.py: `make_optimizer` (global-norm
clip + AdamW with optax's semantics, train/optim.py), `init_train_state`
and `make_dit_train_step`. The loss is the flow-matching velocity MSE
(target noise - x0 at sigma = t / num_train_timesteps), as in the JAX
package. The step updates the model's parameters in place.

With a mesh (dp x fsdp x tp; the JAX step's SPMD over the mesh in scope)
the model is sharded first (`parallel.sharding.shard_params`, then
`init_train_state`). The batch is split over the dp x fsdp ranks, HSDP
style, FSDP being data-parallel too (JAX puts it over dp alone); the ranks
of a tp group share theirs. Each rank's forward gathers a unit's fsdp
shards by an autograd Function whose backward reduce-scatters the
gradient into the shard; a unit stays gathered while autograd keeps its
tensors, and a segment that remat_blocks recomputes is gathered again in
the backward (`parallel.sharding.gathered`), so 'attn' and True keep the
weights sharded between the passes. After the backward the gradients of
parameters whole over fsdp are all-reduced over fsdp, every gradient over
dp, each divided by dp * fsdp (the mean of the ranks' mean losses, the
global mean); the update runs on each rank's shards, the clip on the
whole model's norm (train/optim.py). The loss returned is the global mean.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.config import WanDiTConfig
from ..core.dtypes import FP32_POLICY, DTypePolicy
from ..core.mesh import AXIS_DP, AXIS_FSDP, AXIS_SP
from ..models.wan.dit import wan_dit_forward
from ..ops.samplers import add_flow_noise
from ..parallel.sharding import axis_sizes
from . import optim

SP_TRAIN_LATER = ("a train step over an sp > 1 mesh is a later slice "
                  "(ROADMAP.md queue 1: Sequence-parallel training)")


def make_optimizer(learning_rate=1e-4, weight_decay=0.01, grad_clip=1.0,
                   schedule=None) -> optim.Transform:
    """Global-norm clip + AdamW (reference model_pipeline.py:3282-3306)."""
    lr = schedule if schedule is not None else learning_rate
    return optim.chain(optim.clip_by_global_norm(grad_clip),
                       optim.adamw(lr, weight_decay=weight_decay))


def init_train_state(model: torch.nn.Module, tx=None, learning_rate=1e-4):
    """{'params': model (every parameter set trainable), 'opt', 'step'}."""
    if tx is None:
        tx = make_optimizer(learning_rate)
    model.requires_grad_(True)
    state = {"params": model, "opt": tx.init(list(model.parameters())),
             "step": 0}
    return state, tx


def make_dit_train_step(cfg: WanDiTConfig, tx, mesh=None,
                        rope: Optional[Tuple] = None,
                        policy: DTypePolicy = FP32_POLICY,
                        num_train_timesteps: int = 1000,
                        remat_blocks=False,
                        seq_pad_to: Optional[int] = None):
    """train_step(state, batch) -> (state, loss); batch: latents
    [B, F, H, W, C], context [B, L, D], t [B] in [0, 1000), noise like the
    latents, the whole batch on every rank. rope = (cos, sin) tables of
    the token grid. remat_blocks (False | True | 'attn') recomputes DiT
    blocks in the backward. mesh: a DeviceMesh (sp = 1) the model was
    sharded over; B must divide by dp * fsdp (ValueError)."""
    rope_cos, rope_sin = rope
    ranks = _DataRanks(mesh) if mesh is not None else None

    def train_step(state, batch):
        model = state["params"]
        params = list(model.parameters())
        if ranks is not None:
            batch = ranks.share(batch)
        x0 = batch["latents"]
        noise = batch["noise"]
        t = batch["t"]
        sigma = t.float() / num_train_timesteps
        x_t = add_flow_noise(x0, noise, sigma[:, None, None, None, None])
        v_pred = wan_dit_forward(model, x_t, t, batch["context"], rope_cos,
                                 rope_sin, policy=policy,
                                 remat_blocks=remat_blocks,
                                 seq_pad_to=seq_pad_to)
        target = (noise - x0).float()
        loss = (v_pred - target).square().mean()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        loss = loss.detach()
        if ranks is not None:
            loss = ranks.mean_grads(params, grads, loss)
        updates, opt = tx.update(grads, state["opt"], params)
        optim.apply_updates(params, updates)
        return dict(state, opt=opt, step=state["step"] + 1), loss

    return train_step


def _fsdp_sharded(p) -> bool:
    return isinstance(p, DTensor) and AXIS_FSDP in p.device_mesh.mesh_dim_names


def _all_reduce_flat(tensors, group) -> None:
    """Sum each tensor over the group in place, in one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


class _DataRanks:
    """The data-parallel ranks of a train step's mesh: dp x fsdp, each
    with its share of the batch."""

    def __init__(self, mesh):
        sizes = axis_sizes(mesh)
        if sizes[AXIS_SP] > 1:
            raise NotImplementedError(SP_TRAIN_LATER)
        self.dp, self.fsdp = sizes[AXIS_DP], sizes[AXIS_FSDP]
        self.groups = {ax: mesh[ax].get_group() for ax in (AXIS_DP, AXIS_FSDP)
                       if sizes[ax] > 1}
        self.index = (mesh[AXIS_DP].get_local_rank() * self.fsdp
                      + mesh[AXIS_FSDP].get_local_rank())

    def share(self, batch):
        """The rank's rows of every batch tensor (batch-first)."""
        n = self.dp * self.fsdp
        b = batch["latents"].shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split over dp "
                             f"{self.dp} x fsdp {self.fsdp} = {n} ranks")
        m = b // n
        rows = slice(self.index * m, (self.index + 1) * m)
        return {k: v[rows] for k, v in batch.items()}

    def mean_grads(self, params, grads, loss):
        """Average the gradients (in place, the local tensors) and the loss
        over the dp x fsdp ranks; returns the global mean loss."""
        locs = [optim.local(g) for g in grads]
        whole = [g for p, g in zip(params, locs) if not _fsdp_sharded(p)]
        if AXIS_FSDP in self.groups:
            _all_reduce_flat(whole + [loss.view(1)], self.groups[AXIS_FSDP])
        if AXIS_DP in self.groups:
            _all_reduce_flat(locs + [loss.view(1)], self.groups[AXIS_DP])
        n = self.dp * self.fsdp
        for g in locs:
            g.div_(n)
        return loss / n
