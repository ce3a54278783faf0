"""BAGEL semantic token extraction for the fusion pipeline.

Counterpart of univid_tpu/models/fusion/extractor.py:28-133. The "semantic
tokens" fed to the ContextProjector are BAGEL *input-space* embeddings:
  * text: embed_tokens([bos] + ids + [eos]);
  * image: SigLIP features -> connector (fc0 -> gelu_tanh -> fc1) + the
    ViT position embedding;
image tokens first when present, then padded with zeros or truncated to
`target_len`. The JAX package's text and patch-count buckets are kept (the
prompt ids and the patches are padded to the same bucket sizes, pad patches
carrying segment -1), so both packages run the tower on the same shapes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core import nn as unn
from ..bagel.bagel import Bagel, BagelConfig, flattened_position_ids
from ..bagel.siglip import (Siglip, SiglipConfig, image_to_patches,
                            siglip_forward, vit_aligned_resize)


class BagelSemanticExtractor:
    VIT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
    TEXT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)

    def __init__(self, bagel: Bagel, bagel_cfg: BagelConfig, tokenizer,
                 siglip: Optional[Siglip] = None,
                 siglip_cfg: Optional[SiglipConfig] = None,
                 target_len: int = 256, compute_dtype=torch.bfloat16):
        self.params = bagel
        self.cfg = bagel_cfg
        self.tokenizer = tokenizer
        self.siglip = siglip
        self.siglip_cfg = siglip_cfg
        self.target_len = target_len
        self.dtype = compute_dtype

    @property
    def device(self):
        return self.params.vit_pos_embed.device

    def _text_ids_bucketed(self, text: str):
        ids = [self.cfg.bos_token_id] + self.tokenizer.encode(text) + \
            [self.cfg.eos_token_id]
        n = len(ids)
        bucket = next((b for b in self.TEXT_BUCKETS if b >= n),
                      ((n + 63) // 64) * 64)
        return np.asarray(ids + [0] * (bucket - n), np.int64), n

    def _image_tokens(self, image: torch.Tensor):
        """-> ([bucket, hidden] padded tower output, n_valid)."""
        scfg = self.siglip_cfg
        image = vit_aligned_resize(image.to(self.device, torch.float32),
                                   scfg.patch_size, scfg.image_size)
        patches = image_to_patches(image, scfg.patch_size)
        h_p = image.shape[0] // scfg.patch_size
        w_p = image.shape[1] // scfg.patch_size
        n = h_p * w_p
        bucket = next((b for b in self.VIT_BUCKETS if b >= n), n)
        pad = bucket - n
        pos = np.pad(flattened_position_ids(
            h_p, w_p, self.cfg.vit_max_num_patch_per_side), (0, pad))
        segs = np.concatenate([np.zeros(n, np.int64), np.full(pad, -1)])
        patches = torch.nn.functional.pad(patches, (0, 0, 0, pad))
        pos = torch.as_tensor(pos, device=self.device)
        segs = torch.as_tensor(segs, device=self.device)
        feats = siglip_forward(self.siglip, scfg, patches, pos,
                               segment_ids=segs, compute_dtype=self.dtype)
        conn = self.params.connector
        tok = unn.linear(conn.fc0, feats, compute_dtype=self.dtype)
        tok = unn.gelu_tanh(tok)
        tok = unn.linear(conn.fc1, tok, compute_dtype=self.dtype)
        table = self.params.vit_pos_embed
        tok = tok + table[pos.clamp(0, table.shape[0] - 1)].to(self.dtype)
        return tok, n

    def _assemble(self, text_ids, n_text: int, image_tok, n_img: int):
        """[image ; text] over target_len rows: row i < n_img is image token
        i, then text row i - n_img (index clipped into the bucket), zero
        past n_img + n_text."""
        emb = self.params.llm.embed_tokens
        length = self.target_len
        idx = torch.arange(length, device=self.device)
        t_row = (idx - n_img).clamp(0, text_ids.shape[0] - 1)
        ids = text_ids[t_row].clamp(0, emb.shape[0] - 1)
        text_part = emb[ids].to(self.dtype)
        if image_tok.shape[0] < length:
            image_tok = torch.nn.functional.pad(
                image_tok, (0, 0, 0, length - image_tok.shape[0]))
        out = torch.where((idx < n_img)[:, None], image_tok[:length],
                          text_part)
        return torch.where((idx < n_img + n_text)[:, None], out,
                           torch.zeros((), dtype=self.dtype,
                                       device=self.device))

    @torch.no_grad()
    def extract_semantic_tokens(self, text: str,
                                image: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
        """-> [target_len, hidden]; image [H, W, 3] in [-1, 1] or None."""
        text_ids, n_text = self._text_ids_bucketed(text)
        if image is not None:
            image_tok, n_img = self._image_tokens(image)
        else:
            image_tok = torch.zeros((0, self.params.llm.embed_tokens.shape[1]),
                                    dtype=self.dtype, device=self.device)
            n_img = 0
        return self._assemble(torch.as_tensor(text_ids, device=self.device),
                              n_text, image_tok, n_img)

    # callable interface used by FusionPipeline
    def __call__(self, text, image=None):
        return self.extract_semantic_tokens(text, image)
