"""WanAnimate pipeline on one GPU: character animation and replacement.

Counterpart of univid_tpu/pipelines/animate.py:
  * clip by clip: `clip_len` (77) frames a clip, `refert_num` (1 or 5)
    overlap frames of temporal guidance taken from the previous clip's
    decoded tail; the inputs are padded ping-pong to a length the clips
    tile (`inputs_padding`, `get_valid_len`);
  * conditioning of a clip: pose latents = VAE(pose frames); y_ref = [i2v
    mask | VAE(reference image)]; y_reft = [i2v mask over the overlap |
    VAE(overlap frames + zeros)], or in replace mode the background video
    with the previous tail over its overlap and the inverted character
    mask, downsampled [::8, ::8]; y = [y_ref | y_reft] along time; CLIP
    ViT-H features of the reference image;
  * classifier-free guidance only for expression control: with guide_scale
    > 1 a second forward (batch 1, after the conditional one) whose face
    video is blanked to -1;
  * the decode drops the reference latent frame, later clips the overlap.
The solver is the t2v pipeline's (`solver_for`: UniPC or DPM++), run step
by step on the host. The JAX package splits a clip's schedule into device
dispatches of UNIVID_DISPATCH_STEPS steps (TPU program chunking); the eager
port has nothing to chunk and drops it. The noise of each clip is one draw
from a torch.Generator seeded with `seed` (the JAX package splits
PRNGKey(seed) once a clip: other numbers), or the given list, one tensor a
clip.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.config import GenerationConfig, WanVAEConfig
from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..models.wan.animate import (ClipVision, ClipVisionConfig, WanAnimate,
                                  WanAnimateConfig, clip_preprocess,
                                  clip_visual_forward, wan_animate_forward)
from ..models.wan.vae_api import WanVAE, vae_decode, vae_encode
from ..ops.samplers import unipc_init_state
from .ti2v import phase, solver_for, timed


def inputs_padding(frames: List, target_len: int) -> List:
    """Ping-pong padding of a frame list to target_len."""
    idx = 0
    flip = False
    out: List = []
    while len(out) < target_len:
        out.append(frames[idx])
        idx = idx - 1 if flip else idx + 1
        if idx == 0 or idx == len(frames) - 1:
            flip = not flip
    return out[:target_len]


def get_valid_len(real_len: int, clip_len: int = 81, overlap: int = 1
                  ) -> int:
    """real_len rounded up so that clips of clip_len with `overlap` frames
    tile it exactly."""
    real_clip = clip_len - overlap
    last = (real_len - overlap) % real_clip
    extra = 0 if last == 0 else real_clip - last
    return real_len + extra


def get_i2v_mask(lat_t: int, lat_h: int, lat_w: int, mask_len: int = 1,
                 mask_pixel_values: Optional[torch.Tensor] = None,
                 device="cpu") -> torch.Tensor:
    """The frame-grouped i2v mask, channels-last [1, lat_t, h, w, 4]: the
    pixel-frame mask (zeros, or mask_pixel_values [1, T_pix, h, w]) with its
    first mask_len frames set to 1, the first frame repeated 4 times, each
    4 consecutive frames one latent frame's 4 channels."""
    t_pix = (lat_t - 1) * 4 + 1
    if mask_pixel_values is None:
        msk = torch.zeros((1, t_pix, lat_h, lat_w), device=device)
    else:
        msk = mask_pixel_values.float().clone()
    if mask_len > 0:
        msk[:, :mask_len] = 1.0
    msk = torch.cat([msk[:, 0:1].repeat(1, 4, 1, 1), msk[:, 1:]], dim=1)
    msk = msk.reshape(1, msk.shape[1] // 4, 4, lat_h, lat_w)
    return msk.permute(0, 1, 3, 4, 2)


def _frames(seq: Sequence, a: int, b: int, device) -> torch.Tensor:
    """Frames a..b-1 of a padded frame list as one fp32 tensor."""
    return torch.as_tensor(np.stack([np.asarray(f) for f in seq[a:b]]),
                           dtype=torch.float32).to(device)


class WanAnimatePipeline:
    """Tensor-in / tensor-out animation pipeline; the text context comes
    from the upstream UMT5 encoder, as in the other pipelines. relight_lora (a
    save_lora dir or a LoRA tree): the replacement mode's relighting LoRA,
    merged into `model` in place (train/lora.merge_lora), as the CLI's
    --use_lora merges."""

    def __init__(self, animate_cfg: WanAnimateConfig, model: WanAnimate,
                 vae_cfg: WanVAEConfig, vae: WanVAE,
                 clip_cfg: Optional[ClipVisionConfig] = None,
                 clip: Optional[ClipVision] = None,
                 policy: DTypePolicy = DEFAULT_POLICY, relight_lora=None):
        self.cfg = animate_cfg
        if relight_lora is not None:
            from ..train.lora import load_lora, merge_lora
            if isinstance(relight_lora, str):
                relight_lora, _ = load_lora(relight_lora,
                                            device=model.patch_embed.w.device)
            merged = merge_lora(model, relight_lora)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name in merged:
                        p.copy_(merged[name])
        self.model = model
        self.vae_cfg = vae_cfg
        self.vae = vae
        self.clip_cfg = clip_cfg
        self.clip = clip
        self.policy = policy

    @property
    def device(self):
        return self.model.patch_embed.w.device

    def denoise_fn(self, steps: int, shift: float, guide_scale: float,
                   solver: str, timer=None):
        """run(noise, context, context_null, y, clip_fea, pose_latents,
        face, face_uncond) -> the clip's final latent [1, F_lat + 1, h, w,
        z] (fp32); each solver step timed as `dit_step` with a timer."""
        gen = GenerationConfig(sampling_steps=steps, shift=shift,
                               sample_solver=solver)
        _, coeffs, step_fn = solver_for(gen)
        use_cfg = guide_scale > 1.0
        policy = self.policy

        @torch.no_grad()
        def run(noise, context, context_null, y, clip_fea, pose_latents,
                face, face_uncond):
            def forward(x, t, ctx, face_in):
                x_in = torch.cat([x.float(), y.float()], dim=-1)
                return wan_animate_forward(self.model, x_in, t, ctx,
                                           clip_fea, pose_latents, face_in,
                                           policy=policy)

            state = unipc_init_state(noise, order=coeffs.order)
            for i in range(steps):
                with phase(timer, "dit_step"):
                    c = coeffs.step(i)
                    x = state["sample"]
                    t1 = torch.full((1,), c["timestep"], dtype=torch.float32,
                                    device=x.device)
                    v = forward(x, t1, context, face)
                    if use_cfg:
                        v_un = forward(x, t1, context_null, face_uncond)
                        v = v_un + guide_scale * (v - v_un)
                    state = step_fn(state, c, v)
            return state["sample"]

        return run

    def _clip_features(self, ref_image: torch.Tensor) -> torch.Tensor:
        if self.clip is None:
            raise ValueError("animate needs the CLIP visual tower "
                             "(use_img_emb)")
        img = clip_preprocess(ref_image, self.clip_cfg)
        return clip_visual_forward(self.clip, self.clip_cfg, img)[None]

    @torch.no_grad()
    def generate(self, context, context_null, *, cond_video, face_video,
                 ref_image, bg_video=None, mask_video=None,
                 clip_len: int = 77, refert_num: int = 1, shift: float = 5.0,
                 sample_solver: str = "dpm++", sampling_steps: int = 20,
                 guide_scale: float = 1.0, seed: int = 0,
                 noise: Optional[List[torch.Tensor]] = None, timer=None
                 ) -> torch.Tensor:
        """Video [T_real, H, W, 3] in [-1, 1] (fp32, on the pipeline's
        device). context / context_null [text_len, text_dim]; cond_video
        [T, H, W, 3] pose frames and face_video [T, S, S, 3] face crops in
        [-1, 1]; ref_image [H, W, 3]; replace mode: bg_video [T, H, W, 3]
        and mask_video [T, H, W] in {0, 1}. noise: one [1, F_lat + 1, h, w,
        z] tensor a clip (else drawn). timer: a PhaseTimer (clip_encode,
        vae_encode, dit_step, vae_decode)."""
        if refert_num not in (1, 5):
            raise ValueError("refert_num should be 1 or 5")
        dev = self.device
        replace = bg_video is not None
        real_len = len(cond_video)
        target_len = get_valid_len(real_len, clip_len, overlap=refert_num)
        cond = inputs_padding(list(cond_video), target_len)
        face = inputs_padding(list(face_video), target_len)
        if replace:
            bg = inputs_padding(list(bg_video), target_len)
            mask = inputs_padding(list(mask_video), target_len)

        ref = torch.as_tensor(np.asarray(ref_image),
                              dtype=torch.float32).to(dev)
        h_px, w_px = ref.shape[:2]
        sh = self.vae_cfg.vae_stride[1]
        lat_h, lat_w = h_px // sh, w_px // sh
        lat_t = clip_len // 4 + 1
        vae = self.vae

        def encode(video):
            return timed(timer, "vae_encode", vae_encode, vae, video)

        clip_fea = timed(timer, "clip_encode", self._clip_features, ref)
        ref_lat = encode(ref[None, None])
        y_ref = torch.cat([get_i2v_mask(1, lat_h, lat_w, 1, device=dev),
                           ref_lat], dim=-1)
        ctx = context[None].to(dev)
        nctx = context_null[None].to(dev)
        run = self.denoise_fn(sampling_steps, shift, guide_scale,
                              sample_solver, timer)
        g = torch.Generator(device=dev).manual_seed(seed)
        shape = (1, lat_t + 1, lat_h, lat_w, self.vae_cfg.z_dim)

        out_clips: List[torch.Tensor] = []
        prev_tail = None
        start, k = 0, 0
        while start + refert_num < len(cond):
            clip_cond = _frames(cond, start, start + clip_len, dev)
            clip_face = _frames(face, start, start + clip_len, dev)
            mask_reft_len = 0 if start == 0 else refert_num
            pose_latents = encode(clip_cond[None])
            if replace:
                inv = 1.0 - _frames(mask, start, start + clip_len, dev)
                mask_pv = inv[:, ::sh, ::sh][None]   # nearest downsample
                reft = _frames(bg, start, start + clip_len, dev)
                msk_reft = get_i2v_mask(lat_t, lat_h, lat_w, mask_reft_len,
                                        mask_pixel_values=mask_pv)
            else:
                reft = torch.zeros((clip_len, h_px, w_px, 3), device=dev)
                msk_reft = get_i2v_mask(lat_t, lat_h, lat_w, mask_reft_len,
                                        device=dev)
            if mask_reft_len > 0:
                reft[:mask_reft_len] = prev_tail
            y_reft = torch.cat([msk_reft, encode(reft[None])], dim=-1)
            y = torch.cat([y_ref, y_reft], dim=1)

            x_noise = (noise[k].to(dev, torch.float32) if noise is not None
                       else torch.randn(shape, generator=g, device=dev))
            face_in = clip_face[None]
            x0 = timed(timer, "denoise", run, x_noise, ctx, nctx, y,
                       clip_fea, pose_latents, face_in, face_in * 0.0 - 1.0)
            frames = timed(timer, "vae_decode", vae_decode, vae,
                           x0[:, 1:])[0]
            out_clips.append(frames if start == 0 else frames[refert_num:])
            prev_tail = frames[-refert_num:]
            start += clip_len - refert_num
            k += 1
        return torch.cat(out_clips, dim=0)[:real_len]
