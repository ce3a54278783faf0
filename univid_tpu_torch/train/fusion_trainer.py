"""UniVid adapter/LoRA trainer on one GPU: trains what the reference trains.

Counterpart of univid_tpu/train/fusion_trainer.py (reference
train_cross_attention_fusion, model_pipeline.py:3232-3439, and the
semantic batch path, :2528-2548):

  * trainables = {ContextProjector} (+ LoRA a/b factors when train_lora);
    the frozen Wan DiT and VAE never receive gradients (:3262-3281);
  * AdamW(lr, weight_decay=1e-5, betas=(0.9, 0.999), eps=1e-8) after a
    global-norm clip, with OneCycle (10% warmup, cosine) or cosine
    annealing to lr * 0.1 (:3284-3306), with optax's semantics
    (train/optim.py);
  * semantic path: projector(bagel_tokens) against UMT5 supervision
    features (cosine + L2 + diversity);
  * diffusion path: VAE-encode video -> flow-matching noise at t -> DiT
    with LoRA-merged weights + projected context -> velocity MSE;
  * best-model tracking on every improvement, periodic checkpoints, full
    train-state save / resume, and the best adapter exported as
    `lora_best/` in the save_lora format.

A train state is {'trainable': {'projector': ContextProjector, 'lora':
{site: {'a', 'b'}}}, 'opt': optimizer state, 'step': int, 'best_loss':
0-dim fp32 tensor}. Steps update the trainables in place.

Train-state files (`save_train_state`): `train_state.npz` holds every
tensor as fp32 numpy under a name — `trainable/<leaf>` for the trainables
(`projector.fc0.w`, `lora.cross_attn/q.a`, ...; the projector in
PyTorch's [out, in] layout), `opt/<i>/<key>/<leaf>` for per-leaf
optimizer tensors of the i-th transform of the chain and `opt/<i>/<key>`
for its scalars; `train_state.json` holds step, best_loss and the format
name. `load_train_state` restores by name into a template state built
with the same configs, and refuses a file whose names differ.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.config import FusionConfig, WanModelSpec
from ..models.fusion.projector import (context_projector_forward,
                                       init_context_projector,
                                       projector_training_loss)
from ..models.wan.dit import wan_dit_forward
from ..models.wan.vae_api import vae_encode
from ..ops.rope import build_rope_3d
from ..ops.samplers import add_flow_noise
from . import optim
from .lora import (LoRAConfig, init_lora, merge_lora, save_lora,
                   trainable_sites, with_sites)

STATE_FORMAT = "univid_tpu_torch train state v1"


@dataclass(frozen=True)
class FusionTrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    use_one_cycle_lr: bool = True
    max_steps: int = 200
    save_interval: int = 50
    log_interval: int = 10
    train_lora: bool = True
    use_semantic_alignment: bool = True
    num_train_timesteps: int = 1000


# ---------------------------------------------------------------------------
# trees of trainables
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of a tree of dicts (sorted keys), modules (their
    named parameters) and tensors, in a fixed order."""
    if isinstance(tree, nn.Module):
        return [(prefix + name, p) for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += named_leaves(tree[key], f"{prefix}{key}.")
        return out
    return [(prefix[:-1], tree)]


def _leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]


def _grads(loss, leaves):
    """d loss / d leaves; zeros for leaves the loss does not reach (as
    jax.grad gives them, so weight decay still applies)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)]


def _apply(state, loss, tx, leaves):
    grads = _grads(loss, leaves)
    updates, opt = tx.update(grads, state["opt"], leaves)
    optim.apply_updates(leaves, updates)
    loss = loss.detach()
    return dict(state, opt=opt, step=state["step"] + 1,
                best_loss=torch.minimum(state["best_loss"], loss.float()))


# ---------------------------------------------------------------------------
# optimizer / state
# ---------------------------------------------------------------------------


def make_fusion_optimizer(cfg: FusionTrainConfig) -> optim.Transform:
    """Clip + AdamW + OneCycle / cosine schedule (model_pipeline.py:
    3284-3306)."""
    if cfg.use_one_cycle_lr:
        # optax's onecycle divides by floor(pct_start * steps): keep the
        # warmup at >= 1 step
        steps = max(cfg.max_steps, 10)
        sched = optim.cosine_onecycle_schedule(
            transition_steps=steps, peak_value=cfg.learning_rate,
            pct_start=0.1)
    else:
        sched = optim.cosine_decay_schedule(cfg.learning_rate, cfg.max_steps,
                                            alpha=0.1)  # eta_min = lr * 0.1
    return optim.chain(
        optim.clip_by_global_norm(cfg.grad_clip),
        optim.adamw(sched, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=cfg.weight_decay))


def new_train_state(trainable, tx: optim.Transform):
    """A fresh state around given trainables (step 0, best_loss inf)."""
    leaves = _leaves(trainable)
    return {"trainable": trainable, "opt": tx.init(leaves), "step": 0,
            "best_loss": torch.tensor(float("inf"), device=leaves[0].device)}


def init_fusion_train_state(gen: torch.Generator, fusion_cfg: FusionConfig,
                            train_cfg: FusionTrainConfig, dit_cfg=None,
                            lora_cfg: Optional[LoRAConfig] = None, *,
                            device="cuda"):
    """-> (state, tx, lora_template): the projector (and LoRA factors) drawn
    from `gen` on `device`."""
    trainable = {"projector": init_context_projector(gen, fusion_cfg,
                                                     device=device)}
    lora_template = None
    if train_cfg.train_lora:
        if dit_cfg is None:
            raise ValueError("train_lora needs dit_cfg")
        lora_template = init_lora(gen, dit_cfg, lora_cfg or LoRAConfig(),
                                  device=device)
        # only a and b are trainable; masks, rank and alpha stay in the
        # template handed to make_diffusion_train_step
        trainable["lora"] = trainable_sites(lora_template)
    tx = make_fusion_optimizer(train_cfg)
    return new_train_state(trainable, tx), tx, lora_template


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def make_semantic_train_step(fusion_cfg: FusionConfig, tx):
    """Projector semantic-alignment step: bagel_tokens [B, L, bagel_dim],
    supervision [B, Ls, wan_dim] (UMT5 features of the same caption,
    model_pipeline.py:2418-2548). Returns (state, loss, losses)."""

    def step(state, bagel_tokens, supervision):
        leaves = _leaves(state["trainable"])
        losses = projector_training_loss(state["trainable"]["projector"],
                                         fusion_cfg, bagel_tokens,
                                         supervision)
        loss = losses["total_loss"]
        new = _apply(state, loss, tx, leaves)
        return new, loss.detach(), {k: v.detach() for k, v in losses.items()}

    return step


def make_diffusion_train_step(spec: WanModelSpec, fusion_cfg: FusionConfig,
                              train_cfg: FusionTrainConfig, tx,
                              base_dit, vae, latent_grid,
                              lora_template=None, remat_blocks=False,
                              policy=None):
    """LoRA + projector diffusion step (model_pipeline.py:2765-3142 role):
    latents -> flow noise at t -> DiT with the LoRA-merged frozen base and
    the projected BAGEL context -> velocity MSE. Returns (step, encode):
    step(state, batch) -> (state, loss) with batch {'latents', 'noise',
    'bagel_tokens', 't'}; encode(video [B, T, H, W, 3]) -> latents, the
    VAE encode without grad.

    remat_blocks (False | True | 'attn') recomputes DiT blocks in the
    backward; 'attn' with the O(L)-memory flash backward is what fits the
    full-resolution step (32,768 tokens) on one card."""
    cfg = spec.dit
    f, h, w = latent_grid
    pt, ph, pw = cfg.patch_size
    base_dit.requires_grad_(False)   # the frozen base: LoRA carries updates
    device = next(base_dit.parameters()).device
    rope_cos, rope_sin = build_rope_3d(cfg.head_dim,
                                       (f // pt, h // ph, w // pw),
                                       device=device)
    # pad the token axis once to a multiple of 2048, as the JAX trainer
    # does (kv_len masks the padded keys)
    seq_len = (f // pt) * (h // ph) * (w // pw)
    seq_pad = -(-seq_len // 2048) * 2048 if seq_len > 2048 else None
    kw = {"policy": policy} if policy is not None else {}

    def loss_fn(trainable, batch):
        ctx = context_projector_forward(trainable["projector"], fusion_cfg,
                                        batch["bagel_tokens"])
        weights = None
        if "lora" in trainable:
            weights = merge_lora(base_dit, lora_template,
                                 sites=trainable["lora"])
        x0 = batch["latents"]
        noise = batch["noise"]
        t = batch["t"]
        sigma = t.float() / train_cfg.num_train_timesteps
        x_t = add_flow_noise(x0, noise, sigma[:, None, None, None, None])
        v_pred = wan_dit_forward(base_dit, x_t, t, ctx, rope_cos,
                                 rope_sin, seq_pad_to=seq_pad,
                                 remat_blocks=remat_blocks, weights=weights,
                                 **kw)
        target = (noise - x0).float()
        return (v_pred - target).square().mean()

    def encode(video):
        return vae_encode(vae, video)

    def step(state, batch):
        leaves = _leaves(state["trainable"])
        loss = loss_fn(state["trainable"], batch)
        new = _apply(state, loss, tx, leaves)
        return new, loss.detach()

    return step, encode


# ---------------------------------------------------------------------------
# full train-state checkpointing (save / resume); format in the docstring
# ---------------------------------------------------------------------------


def _state_arrays(state) -> Dict[str, np.ndarray]:
    named = named_leaves(state["trainable"])
    names = [n for n, _ in named]
    out = {f"trainable/{n}": t.detach().float().cpu().numpy()
           for n, t in named}
    for i, sub in enumerate(state["opt"]):
        for key, val in sub.items():
            if isinstance(val, list):
                for n, t in zip(names, val):
                    out[f"opt/{i}/{key}/{n}"] = t.detach().float().cpu() \
                        .numpy()
            else:
                out[f"opt/{i}/{key}"] = np.asarray(val)
    return out


def save_train_state(path: str, state) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "train_state.npz"), **_state_arrays(state))
    with open(os.path.join(path, "train_state.json"), "w") as f:
        json.dump({"format": STATE_FORMAT, "step": int(state["step"]),
                   "best_loss": float(state["best_loss"])}, f)


def load_train_state(path: str, template_state):
    """Restore by name into `template_state` (built by
    init_fusion_train_state with identical configs): its tensors are
    overwritten in place; the returned state holds them."""
    with open(os.path.join(path, "train_state.json")) as f:
        meta = json.load(f)
    if meta.get("format") != STATE_FORMAT:
        raise ValueError(f"{path}: not a {STATE_FORMAT} checkpoint")
    data = np.load(os.path.join(path, "train_state.npz"))
    want = _state_arrays(template_state)
    if set(data.files) != set(want):
        raise ValueError(f"{path}: checkpoint names differ from the "
                         f"template's ({len(data.files)} vs {len(want)})")
    named = named_leaves(template_state["trainable"])
    with torch.no_grad():
        for n, t in named:
            t.copy_(torch.as_tensor(data[f"trainable/{n}"]))
        opt = []
        for i, sub in enumerate(template_state["opt"]):
            new = {}
            for key, val in sub.items():
                if isinstance(val, list):
                    for (n, _), t in zip(named, val):
                        t.copy_(torch.as_tensor(data[f"opt/{i}/{key}/{n}"]))
                    new[key] = val
                else:
                    new[key] = type(val)(data[f"opt/{i}/{key}"])
            opt.append(new)
    best = template_state["best_loss"]
    return dict(template_state, opt=opt, step=int(meta["step"]),
                best_loss=torch.tensor(float(meta["best_loss"]),
                                       device=best.device))


# ---------------------------------------------------------------------------
# training loop (model_pipeline.py:3232-3439)
# ---------------------------------------------------------------------------


def train_cross_attention_fusion(
    dataset,
    extract_tokens: Callable[[str], torch.Tensor],   # caption -> [L, bagel]
    t5_supervision: Callable[[str], torch.Tensor],   # caption -> [Ls, wan]
    fusion_cfg: FusionConfig,
    train_cfg: FusionTrainConfig,
    output_dir: str,
    *,
    seed: int = 0,
    resume: bool = True,
    dit_cfg=None,
    lora_cfg: Optional[LoRAConfig] = None,
    diffusion: Optional[Dict] = None,
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Dict:
    """Training loop over dataset samples. Returns {'steps', 'best_loss',
    'losses'}.

    Objective: semantic alignment (projector) by default; pass
    `diffusion={'spec': WanModelSpec, 'dit': WanDiT, 'vae': WanVAE,
    'latent_grid': (f, h, w)}` (optionally 'remat_blocks', 'policy') for
    the velocity-MSE objective through the LoRA-merged DiT, the only one
    whose loss reaches the LoRA factors: train_lora without it is refused.
    Samples are {'caption': str} (+ 'video' [T, H, W, 3] in [-1, 1] on the
    diffusion path). Noise and t come from a torch.Generator seeded with
    seed + 1; the trainables from one seeded with seed."""
    log = log or (lambda s: None)
    if train_cfg.train_lora and diffusion is None:
        raise ValueError(
            "train_lora=True with the semantic objective trains nothing: "
            "the semantic loss never touches the DiT, so LoRA gradients "
            "are exactly zero. Pass `diffusion=...` (velocity-MSE through "
            "the LoRA-merged DiT) or set train_lora=False.")
    gen = torch.Generator(device=device).manual_seed(seed)
    state, tx, lora_template = init_fusion_train_state(
        gen, fusion_cfg, train_cfg, dit_cfg=dit_cfg, lora_cfg=lora_cfg,
        device=device)
    ckpt_dir = os.path.join(output_dir, "latest")
    if resume and os.path.exists(os.path.join(ckpt_dir, "train_state.npz")):
        state = load_train_state(ckpt_dir, state)
        log(f"resumed at step {state['step']}")

    if diffusion is not None:
        diff_step, encode = make_diffusion_train_step(
            diffusion["spec"], fusion_cfg, train_cfg, tx, diffusion["dit"],
            diffusion["vae"], diffusion["latent_grid"],
            lora_template=lora_template,
            remat_blocks=diffusion.get("remat_blocks", False),
            policy=diffusion.get("policy"))
    else:
        sem_step = make_semantic_train_step(fusion_cfg, tx)

    noise_gen = torch.Generator(device=device).manual_seed(seed + 1)
    losses = []
    best_saved = float("inf")
    while state["step"] < train_cfg.max_steps:
        for sample in dataset:
            if state["step"] >= train_cfg.max_steps:
                break
            caption = sample["caption"] if isinstance(sample, dict) \
                else str(sample)
            bagel_tokens = torch.as_tensor(extract_tokens(caption))[None] \
                .to(device)
            if diffusion is not None:
                video = torch.as_tensor(sample["video"])[None].to(device)
                latents = encode(video)
                batch = {
                    "latents": latents,
                    "bagel_tokens": bagel_tokens,
                    "noise": torch.randn(latents.shape, generator=noise_gen,
                                         device=device),
                    "t": torch.rand((1,), generator=noise_gen, device=device)
                    * float(train_cfg.num_train_timesteps),
                }
                state, loss = diff_step(state, batch)
                semantic = 0.0
            else:
                supervision = torch.as_tensor(
                    t5_supervision(caption))[None].to(device)
                state, loss, aux = sem_step(state, bagel_tokens, supervision)
                semantic = float(aux["semantic_loss"])
            loss = float(loss)
            losses.append(loss)
            step = state["step"]
            if step % train_cfg.log_interval == 0:
                log(f"step {step}: loss={loss:.6f} semantic={semantic:.6f}")
            # best-model tracking: persist every improvement, not only
            # improvements landing on a save_interval boundary
            if loss < best_saved:
                best_saved = loss
                save_train_state(os.path.join(output_dir, "best"), state)
            if step % train_cfg.save_interval == 0:
                save_train_state(ckpt_dir, state)
        if not losses:
            break  # empty dataset

    save_train_state(ckpt_dir, state)
    if train_cfg.train_lora and lora_template is not None:
        # export the BEST-loss adapter in the save_lora format (the
        # reference persists weights on every improvement,
        # model_pipeline.py:3389-3392)
        best_dir = os.path.join(output_dir, "best")
        export_state = state
        if os.path.exists(os.path.join(best_dir, "train_state.npz")):
            export_state = load_train_state(best_dir, copy.deepcopy(state))
        trained = with_sites(lora_template,
                             export_state["trainable"]["lora"])
        save_lora(os.path.join(output_dir, "lora_best"), trained,
                  lora_cfg or LoRAConfig())
        log(f"exported LoRA adapter to {output_dir}/lora_best")
    return {"steps": state["step"], "best_loss": float(state["best_loss"]),
            "losses": losses}
