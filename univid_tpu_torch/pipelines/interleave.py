"""Interleaved multimodal inference with BAGEL: understanding, image
generation and editing.

Counterpart of univid_tpu/pipelines/interleave.py (InterleaveInferencer):
text and image segments go into the KV cache in order (images through the
SigLIP tower and the ViT append, and for generation first through the FLUX
image VAE and the VAE-latent append; text through the causal prefill),
then BAGEL decodes text or generates an image by flow matching inside the
LLM with dual CFG. Prompts are padded to `TEXT_BUCKETS` and patch counts
to `VIT_BUCKETS` with `n_valid`, as in the JAX package, so both run the
same shapes. `caption_frames` runs its frames as one batch (the JAX package
vmaps them), each row with its own cache length.

The port's cache is updated in place: a context passed to an update must
not be updated again (every caller here threads the returned one). Where
the JAX inferencer keeps a context's old value while extending it (the
CFG contexts, the think-mode decode before an image), the port takes a
`fork_context` first. A 1024x1024 request needs more rows than the default
capacity of 4,096 (4,098 for the latent alone): pass a larger `capacity`;
an append past it raises, where JAX's overwrites.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..models.bagel.autoencoder import (ImageVAE, ImageVAEConfig,
                                        image_vae_decode, image_vae_encode)
from ..models.bagel.bagel import (Bagel, BagelConfig, flattened_position_ids,
                                  fork_context, generate_image_latent,
                                  generate_text, init_gen_context,
                                  unpatchify_latent, update_context_text,
                                  update_context_vae, update_context_vit)
from ..models.bagel.siglip import (Siglip, SiglipConfig, image_to_patches,
                                   siglip_forward, vit_aligned_resize)

VLM_THINK_SYSTEM_PROMPT = (
    "You should first think about the reasoning process in the mind and "
    "then provide the user with the answer. \n"
    "The reasoning process is enclosed within <think> </think> tags, i.e. "
    "<think> reasoning process here </think> answer here"
)

GEN_THINK_SYSTEM_PROMPT = (
    "You should first think about the planning process in the mind and "
    "then generate the image. \n"
    "The planning process is enclosed within <think> </think> tags, i.e. "
    "<think> planning process here </think> image here"
)

class InterleaveInferencer:
    """Single-sample interleaved inference on the device of `bagel`."""

    TEXT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
    VIT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)

    def __init__(self, bagel: Bagel, bagel_cfg: BagelConfig, tokenizer,
                 siglip: Optional[Siglip] = None,
                 siglip_cfg: Optional[SiglipConfig] = None,
                 vae: Optional[ImageVAE] = None,
                 vae_cfg: Optional[ImageVAEConfig] = None,
                 capacity: int = 4096, compute_dtype=torch.bfloat16):
        self.params = bagel
        self.cfg = bagel_cfg
        self.tokenizer = tokenizer
        self.siglip = siglip
        self.siglip_cfg = siglip_cfg
        self.vae = vae
        self.vae_cfg = vae_cfg
        self.capacity = capacity
        self.dtype = compute_dtype

    @property
    def device(self):
        return self.params.vit_pos_embed.device

    def init_gen_context(self, batch: int = 1,
                         capacity: Optional[int] = None):
        return init_gen_context(
            self.cfg, capacity or self.capacity, batch=batch,
            dtype=torch.bfloat16 if self.dtype == torch.bfloat16
            else torch.float32, device=self.device)

    def _wrap_ids(self, text: str) -> List[int]:
        return [self.cfg.bos_token_id] + self.tokenizer.encode(text) + \
            [self.cfg.eos_token_id]

    @torch.no_grad()
    def update_context_text(self, text: str, ctx):
        """Causal prefill of [bos] + text + [eos], padded to its bucket."""
        ids = self._wrap_ids(text)
        n = len(ids)
        bucket = next((b for b in self.TEXT_BUCKETS if b >= n),
                      ((n + 63) // 64) * 64)
        ids = torch.as_tensor([ids + [0] * (bucket - n)], device=self.device)
        return update_context_text(self.params, self.cfg, ctx, ids,
                                   compute_dtype=self.dtype, n_valid=n)

    def _image(self, image) -> torch.Tensor:
        return torch.as_tensor(np.asarray(image) if not isinstance(
            image, torch.Tensor) else image).to(self.device, torch.float32)

    def vit_resize(self, image: torch.Tensor) -> torch.Tensor:
        """Stride-aligned resize for the ViT path."""
        return vit_aligned_resize(image, self.siglip_cfg.patch_size,
                                  self.siglip_cfg.image_size)

    def _prep_image_bucketed(self, image, bucket: Optional[int] = None):
        """-> (patches [bucket, pd], pos [bucket], segs [bucket], n_valid):
        pad patches carry segment -1 and position 0."""
        scfg = self.siglip_cfg
        image = self.vit_resize(self._image(image))
        patches = image_to_patches(image, scfg.patch_size)
        h_p = image.shape[0] // scfg.patch_size
        w_p = image.shape[1] // scfg.patch_size
        n = h_p * w_p
        if bucket is None:
            bucket = next((b for b in self.VIT_BUCKETS if b >= n), n)
        pad = bucket - n
        pos = np.pad(flattened_position_ids(
            h_p, w_p, self.cfg.vit_max_num_patch_per_side), (0, pad))
        segs = np.concatenate([np.zeros(n, np.int64), np.full(pad, -1)])
        patches = torch.nn.functional.pad(patches, (0, 0, 0, pad))
        return (patches, torch.as_tensor(pos, device=self.device),
                torch.as_tensor(segs, device=self.device), n)

    def vit_features(self, patches, pos, segs) -> torch.Tensor:
        """The SigLIP tower on one bucketed image -> [bucket, vit_d]."""
        return siglip_forward(self.siglip, self.siglip_cfg, patches, pos,
                              segment_ids=segs, compute_dtype=self.dtype)

    def vit_append(self, ctx, feats, pos, n_valid):
        """The ViT append of a batch of bucketed images' features."""
        return update_context_vit(self.params, self.cfg, ctx, feats, pos,
                                  compute_dtype=self.dtype, n_valid=n_valid)

    def vae_resize(self, image: torch.Tensor) -> torch.Tensor:
        """Stride-aligned resize for the VAE path: sides to multiples of
        latent_downsample (16), the long side clamped to max_latent_size *
        latent_downsample (1024)."""
        stride = self.cfg.latent_downsample
        return vit_aligned_resize(image, stride,
                                  self.cfg.max_latent_size * stride)

    @torch.no_grad()
    def update_context_vae_image(self, image, ctx):
        """The VAE tower of an image context: the resized image's FLUX
        encoding appended as timestep-0 latent rows."""
        if self.vae is None:
            raise ValueError("the image VAE is not loaded")
        img = self.vae_resize(self._image(image))
        latent = image_vae_encode(self.vae, self.vae_cfg, img[None])
        return update_context_vae(self.params, self.cfg, ctx, latent,
                                  compute_dtype=self.dtype)

    @torch.no_grad()
    def update_context_image(self, image, ctx, bucketed: bool = True,
                             vae: bool = False):
        """image [H, W, 3] in [-1, 1]; resized to ViT patch multiples.
        vae=True puts the VAE-latent rows before the ViT rows (generation
        and editing contexts condition on both towers, understanding ones
        on the ViT tower only)."""
        if self.siglip is None:
            raise ValueError("the vision tower is not loaded")
        if vae:
            ctx = self.update_context_vae_image(image, ctx)
        if bucketed:
            patches, pos, segs, n = self._prep_image_bucketed(image)
            feats = self.vit_features(patches, pos, segs)
            return self.vit_append(ctx, feats[None], pos[None], n)
        scfg = self.siglip_cfg
        img = self.vit_resize(self._image(image))
        h_p = img.shape[0] // scfg.patch_size
        w_p = img.shape[1] // scfg.patch_size
        pos = torch.as_tensor(flattened_position_ids(
            h_p, w_p, self.cfg.vit_max_num_patch_per_side),
            device=self.device)
        feats = siglip_forward(self.siglip, scfg,
                               image_to_patches(img, scfg.patch_size), pos,
                               compute_dtype=self.dtype)
        return self.vit_append(ctx, feats[None], pos[None], None)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def caption_frames(self, frames: List[Any], prompt: str, *,
                       max_length: int = 512, do_sample: bool = False,
                       temperature: float = 0.3,
                       rng: Optional[torch.Generator] = None,
                       capacity: Optional[int] = None) -> List[str]:
        """Caption every frame with the same prompt as ONE batch: each row
        is image -> ViT append -> prompt prefill -> decode, in its own
        cache (the JAX package vmaps one program over the frames)."""
        if self.siglip is None:
            raise ValueError("the vision tower is not loaded")
        if not frames:
            return []
        p = self.siglip_cfg.patch_size
        images = [self._image(f) for f in frames]
        sizes = []
        for img in images:
            r = self.vit_resize(img)
            sizes.append((r.shape[0] // p) * (r.shape[1] // p))
        bucket = next((b for b in self.VIT_BUCKETS if b >= max(sizes)),
                      max(sizes))
        preps = [self._prep_image_bucketed(img, bucket=bucket)
                 for img in images]
        feats = torch.stack([self.vit_features(*pr[:3]) for pr in preps])
        pos = torch.stack([pr[1] for pr in preps])
        ns = [pr[3] for pr in preps]
        ids = self._wrap_ids(prompt)
        cap = capacity or min(self.capacity,
                              bucket + 2 + len(ids) + max_length + 8)
        b = len(frames)
        ctx = self.init_gen_context(batch=b, capacity=cap)
        ctx = self.vit_append(ctx, feats, pos, ns)
        ctx = update_context_text(
            self.params, self.cfg, ctx,
            torch.as_tensor([ids] * b, device=self.device),
            compute_dtype=self.dtype)
        tokens, lengths = generate_text(
            self.params, self.cfg, ctx, max_length=max_length,
            do_sample=do_sample, temperature=temperature,
            end_token_id=self.cfg.eos_token_id, rng=rng,
            compute_dtype=self.dtype)
        return [self._decode(row, ln) for row, ln in
                zip(tokens.cpu().numpy(), lengths.cpu().numpy())]

    def _decode(self, row, length) -> str:
        """The first `length` tokens without the bos / eos framing."""
        return self.tokenizer.decode(
            [int(t) for t in row[: int(length)]
             if t not in (self.cfg.bos_token_id, self.cfg.eos_token_id)])

    @torch.no_grad()
    def gen_text(self, ctx, max_length: int = 500, do_sample: bool = False,
                 temperature: float = 1.0,
                 rng: Optional[torch.Generator] = None) -> str:
        tokens, length = generate_text(
            self.params, self.cfg, ctx, max_length=max_length,
            do_sample=do_sample, temperature=temperature,
            end_token_id=self.cfg.eos_token_id, rng=rng,
            compute_dtype=self.dtype)
        return self._decode(tokens[0].cpu().numpy(), length[0])

    @torch.no_grad()
    def gen_image(self, image_shape, ctx, *, cfg_text_ctx=None,
                  cfg_img_ctx=None, cfg_text_scale=4.0, cfg_img_scale=1.5,
                  cfg_interval=(0.4, 1.0), cfg_renorm_min=0.0,
                  cfg_renorm_type="global", num_timesteps=50,
                  timestep_shift=3.0, rng: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The generated image [H, W, 3] in [0, 1]: the flow loop over the
        three contexts (each left as it was), unpatchify, the FLUX decode,
        then clip(x * 0.5 + 0.5, 0, 1)."""
        if self.vae is None:
            raise ValueError("the image VAE is not loaded")
        tokens, grid = generate_image_latent(
            self.params, self.cfg, ctx, image_shape,
            cfg_text_ctx=cfg_text_ctx, cfg_img_ctx=cfg_img_ctx,
            num_timesteps=num_timesteps, timestep_shift=timestep_shift,
            cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
            cfg_interval=cfg_interval, cfg_renorm_min=cfg_renorm_min,
            cfg_renorm_type=cfg_renorm_type, rng=rng, noise=noise,
            compute_dtype=self.dtype)
        latent = unpatchify_latent(tokens[0], grid,
                                   self.cfg.latent_patch_size,
                                   self.cfg.latent_channel)
        img = image_vae_decode(self.vae, self.vae_cfg, latent[None])[0]
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)

    # ------------------------------------------------------------------
    def interleave_inference(
        self, input_list: List[Union[str, Any]], *, think: bool = False,
        understanding_output: bool = False, max_think_token_n: int = 1000,
        do_sample: bool = False, text_temperature: float = 0.3,
        cfg_text_scale: float = 3.0, cfg_img_scale: float = 1.5,
        cfg_interval=(0.4, 1.0), timestep_shift: float = 3.0,
        num_timesteps: int = 50, cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global", image_shapes=(1024, 1024),
        rng: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> List[Union[str, torch.Tensor]]:
        """Text and images into one context in order, then the answer text,
        or (understanding_output=False) the think text if `think`, then the
        image. Generation keeps JAX's three contexts: ctx (everything),
        cfg_text_ctx (ctx before its last text segment; ctx itself after an
        image) and cfg_img_ctx (the text segments alone); an input image
        appends both towers when a VAE is loaded and sets image_shapes to
        its own."""
        gen = not understanding_output
        ctx = self.init_gen_context()
        # None stands for the empty context; after an image, cfg_text_ctx
        # is ctx itself, forked before ctx is extended
        cfg_text_ctx = cfg_img_ctx = None
        if think:
            sp = GEN_THINK_SYSTEM_PROMPT if gen else VLM_THINK_SYSTEM_PROMPT
            ctx = self.update_context_text(sp, ctx)
            if gen:
                cfg_img_ctx = self.update_context_text(
                    sp, self.init_gen_context())
        for term in input_list:
            if isinstance(term, str):
                if gen:
                    cfg_text_ctx = fork_context(ctx)
                    cfg_img_ctx = self.update_context_text(
                        term, cfg_img_ctx if cfg_img_ctx is not None
                        else self.init_gen_context())
                ctx = self.update_context_text(term, ctx)
            else:
                ctx = self.update_context_image(
                    term, ctx, vae=gen and self.vae is not None)
                image_shapes = tuple(term.shape[:2])
                cfg_text_ctx = ctx
        if not gen:
            return [self.gen_text(ctx, max_length=max_think_token_n,
                                  do_sample=do_sample,
                                  temperature=text_temperature, rng=rng)]
        out = []
        if think:
            # the decode appends to the cache it reads: decode on a fork
            txt = self.gen_text(fork_context(ctx),
                                max_length=max_think_token_n,
                                do_sample=do_sample,
                                temperature=text_temperature, rng=rng)
            if cfg_text_ctx is ctx:
                cfg_text_ctx = fork_context(ctx)
            ctx = self.update_context_text(txt, ctx)
            out.append(txt)
        out.append(self.gen_image(
            image_shapes, ctx,
            cfg_text_ctx=cfg_text_ctx if cfg_text_ctx is not None
            else self.init_gen_context(),
            cfg_img_ctx=cfg_img_ctx if cfg_img_ctx is not None
            else self.init_gen_context(),
            cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
            cfg_interval=cfg_interval, cfg_renorm_min=cfg_renorm_min,
            cfg_renorm_type=cfg_renorm_type, num_timesteps=num_timesteps,
            timestep_shift=timestep_shift, rng=rng, noise=noise))
        return out

    def video_understanding(self, video: List[Any], text: str,
                            fps: float = 1.0,
                            max_frames: Optional[int] = None,
                            max_pixels: int = 2000 * 2000,
                            think: bool = False,
                            max_think_token_n: int = 512,
                            do_sample: bool = False,
                            text_temperature: float = 0.3,
                            rng=None) -> Dict[str, Any]:
        """Multi-frame video QA: the frames (ViT path), then the question,
        then the decoded answer."""
        frames = video[:max_frames] if max_frames else video
        out = self.interleave_inference(
            list(frames) + [text], think=think, understanding_output=True,
            max_think_token_n=max_think_token_n, do_sample=do_sample,
            text_temperature=text_temperature, rng=rng)
        return {"text": out[0] if out else "", "image": None}

    def chat(self, images: List[Any], prompt: str, max_length: int = 500,
             do_sample: bool = False, temperature: float = 1.0,
             rng=None) -> str:
        """Image(s) + prompt -> the answer without its bos / eos framing."""
        ctx = self.init_gen_context()
        for image in images:
            ctx = self.update_context_image(image, ctx, vae=False)
        ctx = self.update_context_text(prompt, ctx)
        return self.gen_text(ctx, max_length=max_length, do_sample=do_sample,
                             temperature=temperature, rng=rng)

    def __call__(self, image=None, text: Optional[str] = None, **kwargs
                 ) -> Dict[str, Any]:
        result = {"image": None, "text": None}
        inputs: List[Any] = []
        if image is not None:
            inputs.append(image)
        if text is not None:
            inputs.append(text)
        if not inputs:
            return result
        for item in self.interleave_inference(inputs, **kwargs):
            result["text" if isinstance(item, str) else "image"] = item
        return result
