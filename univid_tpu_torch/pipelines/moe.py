"""Wan2.2 A14B dual-expert (MoE) text/image-to-video pipeline on one GPU.

Counterpart of univid_tpu/pipelines/moe.py: two full DiTs of one shape,
the high-noise expert for steps whose timestep is at or above
moe_boundary * num_train_timesteps and the low-noise expert below it,
each with its own CFG guide scale. Both experts stay resident on the
device; a step picks one on the host. As in WanTI2VPipeline, CFG is one
batch-2 DiT call a step, TMA text weights scale the context, the DiT takes
the fused-rope route, and the token axis is padded once to a multiple of
2048. i2v conditions through channels, not a clamp: y = concat(the
first-frame mask, vae_encode([image, zeros x (frame_num - 1)])) is
concatenated to the sample before every DiT call, and no token takes t =
0. The loop is a host loop: JAX's chunked dispatch (`dispatch_steps`) is a
TPU device, not semantics. sp_size > 1 with a DeviceMesh runs both
experts' calls sequence-parallel over the mesh's sp axis, as in
WanTI2VPipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import (GenerationConfig, TMAConfig, WanModelSpec,
                           latent_shape)
from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..models.wan.dit import WanDiT
from ..models.wan.vae_api import WanVAE, vae_encode
from ..ops.samplers import unipc_init_state
from ..parallel.sharding import check_serving_mesh
from .ti2v import (cfg_velocity, decoded, dit_rope, guided, initial_noise,
                   padded_seq_len, phase, solver_for, timed, tma_context)


def first_frame_mask(lat_f: int, lat_h: int, lat_w: int,
                     device=None) -> torch.Tensor:
    """[1, lat_f, lat_h, lat_w, 4] fp32 i2v mask: the pixel-frame mask
    [1, 0, ..., 0] with the first frame repeated 4x, grouped 4 pixel frames
    to a latent frame's 4 channels, so latent frame 0 is all ones and the
    rest zero."""
    m = torch.zeros((1, lat_f, lat_h, lat_w, 4), dtype=torch.float32,
                    device=device)
    m[:, 0] = 1.0
    return m


def expert_schedule(spec: WanModelSpec, timesteps,
                    guide_scale: Tuple[float, float]):
    """(is_high [S] bool, guide scale [S] fp32) for the solver's timesteps:
    the high-noise expert where t >= moe_boundary * num_train_timesteps,
    with guide_scale[1] there and guide_scale[0] elsewhere."""
    is_high = np.asarray(timesteps) >= (spec.moe_boundary
                                        * spec.num_train_timesteps)
    return is_high, np.where(is_high, guide_scale[1],
                             guide_scale[0]).astype(np.float32)


class WanMoEPipeline:
    """A14B dual-expert generation (t2v, or i2v by the DiT's model_type).
    Takes context tensors [text_len, text_dim] from upstream (UMT5 or the
    fusion projector), like WanTI2VPipeline."""

    def __init__(self, spec: WanModelSpec, low: WanDiT, high: WanDiT,
                 vae: WanVAE, policy: DTypePolicy = DEFAULT_POLICY,
                 sp_size: int = 1, mesh=None):
        if spec.moe_boundary is None:
            raise ValueError(f"{spec.name} has no moe_boundary")
        check_serving_mesh(mesh, sp_size)
        self.spec = spec
        self.low = low
        self.high = high
        self.vae = vae
        self.policy = policy
        self.sp_size = sp_size
        self.mesh = mesh

    @property
    def device(self):
        return self.low.patch_embed.w.device

    def denoise_fn(self, latent_grid: Tuple[int, int, int], seq_len: int,
                   steps: int, shift: float,
                   guide_scale: Tuple[float, float], solver: str,
                   tma: Optional[TMAConfig], timer=None):
        """The denoise loop for one shape: run(low, high, noise, context,
        context_null, y) -> final latent [1, F, H, W, C] (fp32). The i2v
        conditioning y [1, F, H, W, 4 + C] (None for t2v) is concatenated
        to the sample before each DiT call. timer: a PhaseTimer that also
        times each step as dit_step."""
        cfg = self.spec.dit
        gen = GenerationConfig(sampling_steps=steps, shift=shift,
                               sample_solver=solver)
        _, coeffs, step_fn = solver_for(gen)
        is_high, gscale = expert_schedule(self.spec, coeffs.timesteps,
                                          guide_scale)
        context_at = tma_context(tma, steps, cfg.text_len)
        policy = self.policy
        mesh = self.mesh if self.sp_size > 1 else None

        @torch.no_grad()
        def run(low, high, noise, context, context_null, y):
            # noise [1, F, H, W, C]; context*: [1, text_len, text_dim]
            rope = dit_rope(cfg, latent_grid, noise.device)
            ctx_pair = torch.cat([context, context_null], dim=0)
            state = unipc_init_state(noise, order=coeffs.order)
            for i in range(steps):
                with phase(timer, "dit_step"):
                    c = coeffs.step(i)
                    v = cfg_velocity(high if is_high[i] else low,
                                     state["sample"], c["timestep"],
                                     context_at(ctx_pair, i), rope, seq_len,
                                     policy, cond=y, mesh=mesh)
                    state = step_fn(state, c, guided(v, float(gscale[i])))
            return state["sample"]

        return run

    @torch.no_grad()
    def generate(self, context, context_null, *, size=(1280, 720),
                 frame_num: int = 81, shift: Optional[float] = None,
                 sample_solver: str = "unipc", sampling_steps: int = 50,
                 guide_scale: Union[float, Tuple[float, float]] = 5.0,
                 seed: int = 0, img: Optional[torch.Tensor] = None,
                 tma: Optional[TMAConfig] = None, decode: bool = True,
                 noise: Optional[torch.Tensor] = None, timer=None,
                 taylorseer_threshold: int = 0):
        """Video [T, H, W, 3] in [-1, 1] (or the latent with decode=False).
        guide_scale: one value, or (low_noise, high_noise). img [H, W, 3]
        in [-1, 1], at `size`, conditions an i2v model (and only one).
        shift None takes the model's default. noise [1, F, H, W, C]: the
        initial latent; when None it is drawn on the pipeline's device from
        a torch.Generator seeded with `seed`."""
        if taylorseer_threshold > 0:
            raise NotImplementedError(
                "TaylorSeer step caching is wired for the TI2V pipeline; "
                "the dual-expert MoE denoise switches models mid-schedule "
                "and would need per-expert caches")
        spec = self.spec
        i2v = img is not None
        if i2v != (spec.dit.model_type == "i2v"):
            raise ValueError(f"{spec.name} ({spec.dit.model_type}) "
                             f"{'takes no' if i2v else 'needs an'} image")
        if shift is None:
            shift = spec.generation.shift
        if isinstance(guide_scale, (int, float)):
            guide_scale = (float(guide_scale), float(guide_scale))
        c, f, h, w = latent_shape(spec, size[0], size[1], frame_num)
        seq_len = padded_seq_len(spec, size, frame_num, self.sp_size)
        dev = self.device
        noise = initial_noise(noise, (1, f, h, w, c), seed, dev)
        y = None
        if i2v:
            # the image followed by black frames through the causal VAE
            frames = torch.cat(
                [img[None, None].to(dev, torch.float32),
                 torch.zeros((1, frame_num - 1) + tuple(img.shape),
                             dtype=torch.float32, device=dev)], dim=1)
            z = timed(timer, "vae_encode", vae_encode, self.vae, frames)
            del frames
            y = torch.cat([first_frame_mask(f, h, w, device=dev),
                           z.float()], dim=-1)
        run = self.denoise_fn((f, h, w), seq_len, sampling_steps, shift,
                              tuple(guide_scale), sample_solver, tma,
                              timer=timer)
        x0 = timed(timer, "denoise", run, self.low, self.high, noise,
                   context[None].to(dev), context_null[None].to(dev), y)
        return decoded(self.vae, x0, decode, timer)
