"""Wan text/image-to-video pipeline on one GPU.

Counterpart of univid_tpu/pipelines/ti2v.py: the token axis padded once to
a multiple of 2048 (above 2048 tokens; padded keys are masked in the DiT),
UniPC or DPM++ coefficients and TMA text weights precomputed per step on
the host, classifier-free guidance as one batch-2 DiT call per step, then a
streaming VAE decode. i2v conditions on the first frame: its VAE latent z0
replaces the first latent frame before the loop and after every solver
step, and the first frame's tokens take t = 0. `denoise_fn(...)` returns
the inner `run(dit, noise, context, context_null, z0)` so that a caller can
feed its own noise. `taylorseer_threshold` > 0 turns on TaylorSeer step
caching of the batch-2 CFG velocity (ops/taylorseer.py): full steps run
the DiT and refresh the factor stack [7, 2, F, H, W, C] (fp32); Taylor
steps extrapolate the velocity and skip the DiT. Threshold 1 makes every
step full (the result equals the loop without it).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import (GenerationConfig, TMAConfig, WanModelSpec,
                           dit_seq_len, latent_shape)
from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..models.wan.dit import WanDiT, wan_dit_forward
from ..models.wan.vae_api import WanVAE, vae_decode, vae_encode
from ..ops.rope import build_rope_3d
from ..ops.samplers import (dpm_step, flow_sigmas, get_sampling_sigmas,
                            precompute_dpm_solver, precompute_unipc,
                            unipc_init_state, unipc_step)
from ..ops.taylorseer import (TaylorSeerConfig, init_taylor_cache,
                              taylor_predict, taylor_update,
                              taylorseer_schedule)
from ..ops.tma import apply_text_weight, tma_schedule_weights


def solver_for(gen: GenerationConfig):
    """(sigmas, SolverCoeffs, step_fn) for gen.sample_solver."""
    if gen.sample_solver == "unipc":
        sigmas, timesteps = flow_sigmas(
            gen.sampling_steps, shift=gen.shift,
            num_train_timesteps=gen.num_train_timesteps)
        return sigmas, precompute_unipc(sigmas, timesteps=timesteps), \
            unipc_step
    if gen.sample_solver in ("dpm++", "dpm", "dpm++3"):
        order = 3 if gen.sample_solver == "dpm++3" else 2
        sig = get_sampling_sigmas(gen.sampling_steps, gen.shift)
        sigmas = np.concatenate([sig, [0.0]])
        timesteps = np.floor(sig * gen.num_train_timesteps)
        return sigmas, precompute_dpm_solver(sigmas, solver_order=order,
                                             timesteps=timesteps), dpm_step
    raise NotImplementedError(gen.sample_solver)


def padded_seq_len(spec: WanModelSpec, size, frame_num: int) -> int:
    """DiT token count, padded once to a multiple of 2048 above 2048
    tokens (the 30 blocks then need no per-call padding)."""
    seq_len = dit_seq_len(spec, size[0], size[1], frame_num)
    if seq_len > 2048:
        seq_len = -(-seq_len // 2048) * 2048
    return seq_len


class WanTI2VPipeline:
    """Tensor-in / tensor-out t2v and i2v pipeline. Text encoding (UMT5 or
    the fusion projector) happens upstream; the pipeline takes context
    tensors [text_len, text_dim]."""

    def __init__(self, spec: WanModelSpec, dit: WanDiT, vae: WanVAE,
                 policy: DTypePolicy = DEFAULT_POLICY):
        self.spec = spec
        self.dit = dit
        self.vae = vae
        self.policy = policy

    @property
    def device(self):
        return self.dit.patch_embed.w.device

    def denoise_fn(self, latent_grid: Tuple[int, int, int], seq_len: int,
                   steps: int, shift: float, guide_scale: float,
                   solver: str, tma: Optional[TMAConfig], i2v: bool = False,
                   taylorseer_threshold: int = 0, timer=None):
        """The denoise loop for one shape: run(dit, noise, context,
        context_null, z0) -> final latent [1, F, H, W, C] (fp32). With i2v
        the first latent frame is clamped to z0's (before the loop and
        after every step) and its tokens take t = 0. taylorseer_threshold >
        0: TaylorSeer with that fresh_threshold (0: off). timer: a
        PhaseTimer that also times each step, as dit_step or, with
        TaylorSeer, taylor_step."""
        cfg = self.spec.dit
        gen = GenerationConfig(sampling_steps=steps, shift=shift,
                               guide_scale=guide_scale, sample_solver=solver)
        _, coeffs, step_fn = solver_for(gen)
        if tma is not None and tma.enabled:
            tma_w = tma_schedule_weights(tma, steps)
            tma_prefix = min(tma.text_prefix_len, cfg.text_len // 2)
        else:
            tma_w = np.ones(steps, np.float32)
            tma_prefix = 0
        f, h, w = latent_grid
        pt, ph, pw = cfg.patch_size
        grid = (f // pt, h // ph, w // pw)
        policy = self.policy
        sched = (taylorseer_schedule(steps, TaylorSeerConfig(
            fresh_threshold=taylorseer_threshold))
            if taylorseer_threshold > 0 else None)

        def step_phase(name):
            return timer.phase(name) if timer is not None \
                else contextlib.nullcontext()

        @torch.no_grad()
        def run(dit, noise, context, context_null, z0):
            # noise / z0: [1, F, H, W, C]; context*: [1, text_len, text_dim]
            dev = noise.device
            rope_cos, rope_sin = build_rope_3d(cfg.head_dim, grid, device=dev)
            ctx_pair = torch.cat([context, context_null], dim=0)
            t_zero = None
            latents = noise
            if i2v:
                per_frame = grid[1] * grid[2]
                t_zero = torch.zeros((2, grid[0] * per_frame), dtype=torch.bool,
                                     device=dev)
                t_zero[:, :per_frame] = True
                frame_mask = torch.zeros((1, f, h, w, 1), device=dev)
                frame_mask[:, :1] = 1.0   # 1 where clamped to z0
                latents = frame_mask * z0 + (1.0 - frame_mask) * noise
            state = unipc_init_state(latents, order=coeffs.order)
            factors = (init_taylor_cache((2,) + tuple(latents.shape[1:]),
                                         device=dev)
                       if sched is not None else None)
            for i in range(steps):
                full = sched is None or sched["is_full"][i] > 0
                with step_phase("dit_step" if full else "taylor_step"):
                    c = coeffs.step(i)
                    if full:
                        ctx = ctx_pair
                        if tma_prefix > 0:
                            ctx = apply_text_weight(ctx, float(tma_w[i]),
                                                    tma_prefix)
                        x2 = state["sample"].float().expand(
                            (2,) + tuple(state["sample"].shape[1:]))
                        t2 = torch.full((2,), c["timestep"],
                                        dtype=torch.float32, device=dev)
                        v = wan_dit_forward(
                            dit, x2, t2, ctx, rope_cos, rope_sin,
                            t_zero_mask=t_zero, seq_pad_to=seq_len,
                            policy=policy, fused_rope=True)
                        if sched is not None:
                            factors = taylor_update(factors, v,
                                                    sched["dd"][i],
                                                    sched["n_upd"][i])
                    else:
                        v = taylor_predict(factors, sched["x"][i],
                                           sched["n_stored"][i]).float()
                    v_guided = v[1:2] + guide_scale * (v[0:1] - v[1:2])
                    state = step_fn(state, c, v_guided)
                    if i2v:
                        state = dict(state, sample=frame_mask * z0
                                     + (1.0 - frame_mask) * state["sample"])
            return state["sample"]

        return run

    @torch.no_grad()
    def generate(self, context, context_null, *, size=(1280, 704),
                 frame_num: int = 121, shift: float = 5.0,
                 sample_solver: str = "unipc", sampling_steps: int = 50,
                 guide_scale: float = 5.0, seed: int = 0,
                 img: Optional[torch.Tensor] = None,
                 tma: Optional[TMAConfig] = None, decode: bool = True,
                 noise: Optional[torch.Tensor] = None, timer=None,
                 taylorseer_threshold: int = 0):
        """Video [T, H, W, 3] in [-1, 1] (or the latent with decode=False).
        img [H, W, 3] in [-1, 1], at `size`, makes it i2v. noise [1, F, H,
        W, C]: the initial latent; when None it is drawn on the pipeline's
        device from a torch.Generator seeded with `seed`.
        taylorseer_threshold: TaylorSeer's fresh_threshold (0: off)."""
        spec = self.spec
        c, f, h, w = latent_shape(spec, size[0], size[1], frame_num)
        seq_len = padded_seq_len(spec, size, frame_num)
        dev = self.device
        if noise is None:
            g = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn((1, f, h, w, c), generator=g, device=dev,
                                dtype=torch.float32)
        noise = noise.to(dev, torch.float32)
        i2v = img is not None
        if i2v:
            video = img[None, None].to(dev, torch.float32)
            if timer is not None:
                z0 = timer.time_phase("vae_encode", vae_encode, self.vae,
                                      video)
            else:
                z0 = vae_encode(self.vae, video)
            # z0: [1, 1, h, w, c] -> zero-padded over the latent frames
            z0 = torch.nn.functional.pad(z0, (0, 0, 0, 0, 0, 0, 0, f - 1))
        else:
            z0 = torch.zeros_like(noise)
        run = self.denoise_fn((f, h, w), seq_len, sampling_steps, shift,
                              guide_scale, sample_solver, tma, i2v=i2v,
                              taylorseer_threshold=taylorseer_threshold,
                              timer=timer)
        ctx, nctx = context[None].to(dev), context_null[None].to(dev)
        if timer is not None:
            x0 = timer.time_phase("denoise", run, self.dit, noise, ctx, nctx,
                                  z0)
        else:
            x0 = run(self.dit, noise, ctx, nctx, z0)
        if not decode:
            return x0
        if timer is not None:
            video = timer.time_phase("vae_decode", vae_decode, self.vae, x0)
        else:
            video = vae_decode(self.vae, x0)
        return video[0]
