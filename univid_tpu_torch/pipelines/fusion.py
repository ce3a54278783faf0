"""Cross-attention fusion pipeline: UniVid's own generation path.

Counterpart of univid_tpu/pipelines/fusion.py:41-119: BAGEL semantic
tokens -> ContextProjector -> Wan context, TMA per-step text weights, then
the TI2V denoise loop. With fusion_alpha >= 1 the projected BAGEL context
replaces the UMT5 context for the prompt and (null_context 'bagel') for the
negative prompt too, which makes classifier-free guidance degenerate, as in
the reference; the batch-2 DiT call is kept all the same. With alpha < 1
each context is the per-token mix alpha * bagel + (1 - alpha) * t5.
null_context picks what the unconditional branch sees: 'bagel', 't5' (the
negative prompt's UMT5 context) or 'zeros'.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.config import FusionConfig, TMAConfig
from ..models.fusion.projector import (ContextProjector,
                                       context_projector_forward)
from .ti2v import WanTI2VPipeline


class FusionPipeline:
    """BAGEL extractor + projector + the Wan TI2V pipeline on one device."""

    def __init__(self, wan: WanTI2VPipeline, projector: ContextProjector,
                 fusion_cfg: FusionConfig,
                 bagel_extractor: Optional[Callable] = None):
        self.wan = wan
        self.projector = projector
        self.cfg = fusion_cfg
        self.bagel_extractor = bagel_extractor

    @torch.no_grad()
    def project_context(self, bagel_tokens: torch.Tensor) -> torch.Tensor:
        """[L, 3584] or [1, L, 3584] BAGEL tokens -> [512, 4096]."""
        if bagel_tokens.ndim == 2:
            bagel_tokens = bagel_tokens[None]
        return context_projector_forward(self.projector, self.cfg,
                                         bagel_tokens)[0]

    def _mix(self, bagel_ctx, t5_ctx):
        alpha = self.cfg.fusion_alpha
        if alpha >= 1.0 or t5_ctx is None:
            return bagel_ctx
        return alpha * bagel_ctx + (1.0 - alpha) * t5_ctx.to(bagel_ctx)

    def generate_video_with_bagel_context(
            self, text: Optional[str] = None, image=None, *,
            bagel_tokens: Optional[torch.Tensor] = None,
            t5_context: Optional[torch.Tensor] = None,
            t5_context_null: Optional[torch.Tensor] = None,
            null_context: str = "bagel", tma: Optional[TMAConfig] = None,
            timer=None, **gen_kwargs):
        """Video [T, H, W, 3] in [-1, 1] (or the latent with decode=False).
        Pass `bagel_tokens` (precomputed semantic tokens), or `text` and
        `image` [H, W, 3] with a bagel_extractor configured; the image also
        makes the video i2v."""
        def phase(name, fn, *args):
            if timer is None:
                return fn(*args)
            return timer.time_phase(name, fn, *args)

        if bagel_tokens is None:
            if self.bagel_extractor is None:
                raise ValueError(
                    "need bagel_tokens or a configured bagel_extractor")
            bagel_tokens = phase("bagel_extract", self.bagel_extractor, text,
                                 image)
        bagel_ctx = phase("project_context", self.project_context,
                          bagel_tokens)
        ctx = self._mix(bagel_ctx, t5_context)
        if null_context == "bagel":
            nctx = self._mix(bagel_ctx, t5_context_null)
        elif null_context == "t5":
            if t5_context_null is None:
                raise ValueError("null_context='t5' needs t5_context_null")
            nctx = t5_context_null.to(ctx)
        elif null_context == "zeros":
            nctx = torch.zeros_like(ctx)
        else:
            raise ValueError(null_context)
        if tma is None:
            tma = TMAConfig(text_prefix_len=self.cfg.bagel_sequence_length)
        return self.wan.generate(ctx, nctx, tma=tma, img=image, timer=timer,
                                 **gen_kwargs)
