"""Full DiT fine-tune on one GPU (flow-matching MSE).

Counterpart of univid_tpu/train/trainer.py: `make_optimizer` (global-norm
clip + AdamW with optax's semantics, train/optim.py), `init_train_state`
and `make_dit_train_step`. The loss is the flow-matching velocity MSE
(target noise - x0 at sigma = t / num_train_timesteps), as in the JAX
package. The step updates the model's parameters in place. The JAX step's
`mesh` (SPMD over fsdp / tp / dp / sp) waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.config import WanDiTConfig
from ..core.dtypes import FP32_POLICY, DTypePolicy
from ..models.wan.dit import wan_dit_forward
from ..ops.samplers import add_flow_noise
from . import optim


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
    latents. rope = (cos, sin) tables of the token grid. remat_blocks
    (False | True | 'attn') recomputes DiT blocks in the backward."""
    if mesh is not None:
        raise NotImplementedError(
            "the mesh (sharded training) is a later slice (ROADMAP.md "
            "queue 1: Multi-GPU training)")
    rope_cos, rope_sin = rope

    def train_step(state, batch):
        model = state["params"]
        params = list(model.parameters())
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
        updates, opt = tx.update(grads, state["opt"], params)
        optim.apply_updates(params, updates)
        return dict(state, opt=opt, step=state["step"] + 1), loss.detach()

    return train_step
