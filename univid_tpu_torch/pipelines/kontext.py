"""FLUX.1-Kontext image-editing pipeline on one GPU.

Counterpart of univid_tpu/pipelines/kontext.py, the surface the animate
preprocess drives (`--use_flux`): `edit(image, prompt)` at guidance 2.5
and 28 steps by default. Stages:

  prompt -> CLIP-L pooled + T5-XXL v1.1 features
  input image -> preferred-resolution resize -> FLUX AE encode
              -> packed reference tokens (RoPE set id 1)
  noise tokens (set id 0) -> distilled-guidance Euler flow steps over the
  resolution-shifted sigma schedule -> unpack -> AE decode.

The sigma loop is a plain host loop of one transformer pass a step (no CFG
batch: Kontext is guidance-distilled) over one set of rope tables cached
for each (grid, reference grid, text length) bucket. The schedule is fp64
numpy cast to fp32 before the loop, as JAX casts it: s_next - s_cur, t and
the guidance are fp32, the latent stays fp32, and only the target rows of
the velocity feed the update. The noise is the given `noise=` or a draw
from a torch.Generator seeded with `seed` (JAX draws from PRNGKey(seed)).
T5 runs through `models/wan/t5.py::encode_padded` (shared_pos), the AE
through `models/bagel/autoencoder.py` (channels-last, fp32).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.config import T5Config
from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..models.bagel.autoencoder import (ImageVAEConfig, image_vae_decode,
                                        image_vae_encode, init_image_vae)
from ..models.flux import (ClipTextConfig, FluxConfig, TINY_CLIP_TEXT,
                           TINY_FLUX, build_rope_from_ids, clip_text_encode,
                           flux_forward, image_token_ids, init_clip_text,
                           init_flux, pack_latents, unpack_latents)
from ..models.wan.t5 import UMT5Encoder, encode_padded
from .ti2v import initial_noise

# aspect buckets the published Kontext editor was trained on (the
# diffusers pipeline resizes the input to the closest-aspect bucket, ~1MP
# each)
PREFERRED_KONTEXT_RESOLUTIONS = [
    (672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328),
    (832, 1248), (880, 1184), (944, 1104), (1024, 1024), (1104, 944),
    (1184, 880), (1248, 832), (1328, 800), (1392, 752), (1456, 720),
    (1504, 688), (1568, 672),
]

# t5-v1_1-xxl geometry (FLUX's text_encoder_2; vs UMT5: 32k vocab, one
# relative-position table shared by every layer)
FLUX_T5_CONFIG = T5Config(vocab_size=32128, shared_pos=True, text_len=512)
TINY_FLUX_T5 = T5Config(vocab_size=512, dim=32, dim_attn=32, dim_ffn=64,
                        num_heads=2, num_layers=2, shared_pos=True,
                        text_len=16)
TINY_FLUX_VAE = ImageVAEConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1,
                               z_channels=4)


def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                    max_seq_len: int = 4096, base_shift: float = 0.5,
                    max_shift: float = 1.15) -> float:
    """Resolution-dependent timestep-schedule shift (mu)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    return image_seq_len * m + (base_shift - m * base_seq_len)


def kontext_sigmas(num_steps: int, image_seq_len: int) -> np.ndarray:
    """[num_steps + 1] fp64 sigma schedule: linspace(1, 1/N) put through
    the exponential time shift, terminal 0 appended."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps)
    mu = calculate_shift(image_seq_len)
    sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
    return np.concatenate([sigmas, [0.0]])


def preferred_resolution(h: int, w: int) -> Tuple[int, int]:
    """Closest-aspect (h, w) bucket from the published training set."""
    aspect = w / h
    _, bw, bh = min((abs(aspect - pw / ph), pw, ph)
                    for ph, pw in PREFERRED_KONTEXT_RESOLUTIONS)
    return bh, bw


def _resize_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC))


class KontextPipeline:
    """image (u8 HWC) + prompt -> edited image (u8 HWC), on the device of
    its modules."""

    def __init__(self, flux, flux_cfg: FluxConfig, vae, vae_cfg:
                 ImageVAEConfig, t5: UMT5Encoder, t5_cfg: T5Config,
                 t5_tokenizer, clip, clip_cfg: ClipTextConfig,
                 clip_tokenizer, policy: DTypePolicy = DEFAULT_POLICY):
        self.flux = flux
        self.flux_cfg = flux_cfg
        self.vae = vae
        self.vae_cfg = vae_cfg
        self.t5 = t5
        self.t5_cfg = t5_cfg
        self.t5_tokenizer = t5_tokenizer
        self.clip = clip
        self.clip_cfg = clip_cfg
        self.clip_tokenizer = clip_tokenizer
        self.policy = policy
        self._rope_cache = {}

    @property
    def device(self):
        # the AE's: fp32, never quantized or sharded
        return next(self.vae.parameters()).device

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def random_init(cls, seed: int = 0, tiny: bool = True,
                    policy: DTypePolicy = DEFAULT_POLICY, *,
                    dtype=torch.float32, device="cuda"
                    ) -> "KontextPipeline":
        """The same program on weights drawn from torch.Generators seeded
        from `seed`: the tiny geometry (hermetic tests), or the published
        one (FluxConfig(), T5-XXL v1.1, CLIP-L, the FLUX AE). `dtype` is
        the transformer's and both text towers' (JAX draws fp32;
        from_checkpoint places bf16); the AE stays fp32."""
        from ..utils.tokenizers import HashTokenizer

        flux_cfg = TINY_FLUX if tiny else FluxConfig()
        vae_cfg = TINY_FLUX_VAE if tiny else ImageVAEConfig()
        t5_cfg = TINY_FLUX_T5 if tiny else FLUX_T5_CONFIG
        clip_cfg = TINY_CLIP_TEXT if tiny else ClipTextConfig()
        if tiny:
            # tie the tiny geometries together: packed latent channels (4 *
            # z_channels) are flux in_channels; the text dims the
            # context / vec dims
            assert 4 * vae_cfg.z_channels == flux_cfg.in_channels
            assert t5_cfg.dim == flux_cfg.context_dim
            assert clip_cfg.hidden_size == flux_cfg.vec_dim

        def gen(i):
            return torch.Generator(device=device).manual_seed(seed + i)

        kw = dict(dtype=dtype, device=device)
        return cls(
            init_flux(gen(0), flux_cfg, **kw), flux_cfg,
            init_image_vae(gen(1), vae_cfg, device=device), vae_cfg,
            UMT5Encoder(t5_cfg, gen=gen(2), **kw), t5_cfg,
            _PaddedTok(HashTokenizer(vocab_size=t5_cfg.vocab_size),
                       t5_cfg.text_len),
            init_clip_text(gen(3), clip_cfg, **kw), clip_cfg,
            _PaddedTok(HashTokenizer(vocab_size=clip_cfg.vocab_size),
                       clip_cfg.max_len),
            policy=policy)

    @classmethod
    def from_checkpoint(cls, flux_dir: str, dtype=torch.bfloat16,
                        int8: bool = False,
                        policy: DTypePolicy = DEFAULT_POLICY, *,
                        device="cuda") -> "KontextPipeline":
        """The published layout:

            flux_dir/flux1-kontext-dev.safetensors   (BFL transformer)
            flux_dir/ae.safetensors                  (BFL image VAE)
            flux_dir/text_encoder/model.safetensors  (HF CLIP-L)
            flux_dir/text_encoder_2/*.safetensors    (HF T5-XXL v1.1)
            flux_dir/tokenizer, flux_dir/tokenizer_2 (HF tokenizers)

        int8=True quantizes the transformer's linears weight-only per
        output channel (`core.quant.quantize_tree`), in place."""
        from ..core.checkpoint import load_kontext_checkpoint
        from ..utils.tokenizers import load_tokenizer

        (flux, flux_cfg, vae, vae_cfg, t5, t5_cfg, clip,
         clip_cfg) = load_kontext_checkpoint(flux_dir, dtype=dtype,
                                             device=device)
        if int8:
            from ..core.quant import quantize_tree
            quantize_tree(flux)
        return cls(
            flux, flux_cfg, vae, vae_cfg, t5, t5_cfg,
            load_tokenizer(os.path.join(flux_dir, "tokenizer_2"),
                           seq_len=t5_cfg.text_len),
            clip, clip_cfg,
            load_tokenizer(os.path.join(flux_dir, "tokenizer"),
                           seq_len=clip_cfg.max_len),
            policy=policy)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def rope_tables(self, grid_hw: Tuple[int, int],
                    ref_grid_hw: Tuple[int, int], txt_len: int):
        """(cos, sin) over the text (ids 0), target (set 0) and reference
        (set 1) tokens of one bucket, built once and kept on the device."""
        key = (grid_hw, ref_grid_hw, txt_len)
        if key not in self._rope_cache:
            ids = np.concatenate([
                np.zeros((txt_len, 3)),
                image_token_ids(grid_hw, set_id=0),
                image_token_ids(ref_grid_hw, set_id=1),
            ])
            self._rope_cache[key] = build_rope_from_ids(
                ids, self.flux_cfg.axes_dim, self.flux_cfg.theta,
                device=self.device)
        return self._rope_cache[key]

    @torch.no_grad()
    def denoise(self, noise, ref_tokens, txt, pooled, sigmas: np.ndarray,
                guidance: float, grid_hw: Tuple[int, int],
                ref_grid_hw: Tuple[int, int]) -> torch.Tensor:
        """The Euler flow loop from noise [B, l_tgt, C] (fp32) with the
        reference tokens behind the target's: the final latent tokens
        (fp32). sigmas [S + 1] is cast to fp32 first, as JAX casts it."""
        cfg, policy = self.flux_cfg, self.policy
        cd = policy.compute_dtype
        dev = noise.device
        cos, sin = self.rope_tables(grid_hw, ref_grid_hw, txt.shape[1])
        b, l_tgt = noise.shape[:2]
        sig = torch.as_tensor(sigmas.astype(np.float32), device=dev)
        g = torch.full((b,), guidance, dtype=torch.float32, device=dev)
        ref = ref_tokens.to(cd)
        lat = noise.float()
        for i in range(len(sigmas) - 1):
            s_cur, s_next = sig[i], sig[i + 1]
            v = flux_forward(
                self.flux, cfg, torch.cat([lat.to(cd), ref], dim=1), txt,
                s_cur.expand(b), guidance=g, clip_pooled=pooled,
                rope_tables=(cos, sin), policy=policy)[:, :l_tgt]
            lat = lat + (s_next - s_cur) * v.float()
        return lat

    @torch.no_grad()
    def encode_prompt(self, prompt: str):
        """-> (T5 features [1, text_len, ctx_dim] in the compute dtype,
        CLIP pooled [1, vec] fp32)."""
        dev = self.device
        ids, lens = self.t5_tokenizer.batch_encode_padded([prompt])
        ids = np.clip(np.asarray(ids, np.int64)[:, :self.t5_cfg.text_len],
                      0, self.t5_cfg.vocab_size - 1)
        lens = np.minimum(np.asarray(lens, np.int32), self.t5_cfg.text_len)
        txt = encode_padded(self.t5, torch.as_tensor(ids, device=dev),
                            torch.as_tensor(lens, device=dev),
                            compute_dtype=self.policy.compute_dtype)
        cids, _ = self.clip_tokenizer.batch_encode_padded([prompt])
        cids = np.clip(np.asarray(cids, np.int64)[:, :self.clip_cfg.max_len],
                       0, self.clip_cfg.vocab_size - 1)
        _, pooled = clip_text_encode(self.clip,
                                     torch.as_tensor(cids, device=dev))
        return txt, pooled.float()

    # ------------------------------------------------------------------
    # the reference surface
    # ------------------------------------------------------------------

    @torch.no_grad()
    def edit(self, image: np.ndarray, prompt: str, *,
             height: Optional[int] = None, width: Optional[int] = None,
             num_inference_steps: int = 28, guidance_scale: float = 2.5,
             seed: int = 0, auto_resize: bool = True,
             noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """u8 [H, W, 3] + prompt -> edited u8 [height, width, 3].

        height / width default to the input size (multiples of 16); the
        conditioning image is resized to the closest-aspect preferred
        bucket first (inputs over 64 px). noise [1, l_tgt, 4 z] fp32 takes
        the place of the seeded draw."""
        dev = self.device
        ih, iw = image.shape[:2]
        height = max((height or ih) // 16 * 16, 16)
        width = max((width or iw) // 16 * 16, 16)
        # the conditioning image keeps its OWN latent grid, resized to the
        # closest-aspect training bucket (tiny inputs at their own size)
        cond = image
        if auto_resize and min(ih, iw) > 64:
            bh, bw = preferred_resolution(ih, iw)
            if (bh, bw) != (ih, iw):
                cond = _resize_u8(image, bh, bw)
        ch = max(cond.shape[0] // 16 * 16, 16)
        cw = max(cond.shape[1] // 16 * 16, 16)
        if cond.shape[:2] != (ch, cw):
            cond = _resize_u8(cond, ch, cw)

        ds = self.vae_cfg.downsample
        x = (cond.astype(np.float32) / 127.5 - 1.0)[None]
        z_ref = image_vae_encode(self.vae, self.vae_cfg,
                                 torch.as_tensor(x, device=dev))
        ref_tokens = pack_latents(z_ref)
        ref_grid = (ch // ds // 2, cw // ds // 2)

        gh, gw = height // ds // 2, width // ds // 2
        txt, pooled = self.encode_prompt(prompt)
        sigmas = kontext_sigmas(num_inference_steps, gh * gw)
        noise = initial_noise(noise, (1, gh * gw, 4 * self.vae_cfg.z_channels),
                              seed, dev)
        lat = self.denoise(noise, ref_tokens, txt, pooled, sigmas,
                           float(guidance_scale), (gh, gw), ref_grid)
        img = image_vae_decode(self.vae, self.vae_cfg,
                               unpack_latents(lat, (gh, gw)))
        img = img[0].float().cpu().numpy()
        return np.clip((img + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


class _PaddedTok:
    """Fixed-length adapter over HashTokenizer for the mock pipeline."""

    def __init__(self, tok, seq_len: int):
        self.tok = tok
        self.seq_len = seq_len

    def batch_encode_padded(self, texts):
        return self.tok.batch_encode_padded(texts, seq_len=self.seq_len)


def make_edit_fn(flux_dir: Optional[str] = None,
                 pipeline: Optional[KontextPipeline] = None, *,
                 num_inference_steps: int = 28,
                 guidance_scale: float = 2.5, int8: bool = True,
                 seed: int = 0, device="cuda") -> Callable:
    """The animate preprocess's `edit_fn(image u8, prompt) -> u8` contract
    (reference guidance 2.5 / 28 steps). A pipeline is loaded from
    flux_dir (int8: the transformer quantized weight-only) unless one is
    given, which is used as it is."""
    if pipeline is None:
        if flux_dir is None:
            raise ValueError("make_edit_fn needs flux_dir or pipeline")
        pipeline = KontextPipeline.from_checkpoint(flux_dir, int8=int8,
                                                   device=device)

    def edit_fn(image: np.ndarray, prompt: str) -> np.ndarray:
        return pipeline.edit(np.asarray(image), prompt,
                             num_inference_steps=num_inference_steps,
                             guidance_scale=guidance_scale, seed=seed)

    return edit_fn
