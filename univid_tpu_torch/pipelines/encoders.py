"""Prompt -> context encoder for the Wan pipelines (counterpart of
univid_tpu/pipelines/encoders.py WanTextEncoder): tokenizer + UMT5 forward
producing padded-and-zeroed [B, text_len, dim] context tensors."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.config import T5Config, WanModelSpec
from ..models.wan.t5 import UMT5Encoder, encode_padded


class WanTextEncoder:
    """Tokenize + UMT5-encode prompts into Wan DiT context tensors."""

    def __init__(self, model: UMT5Encoder, t5_cfg: T5Config, tokenizer,
                 compute_dtype=torch.bfloat16):
        self.model = model
        self.cfg = t5_cfg
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype

    @property
    def device(self):
        return self.model.norm.device

    def __call__(self, texts: List[str]) -> torch.Tensor:
        """texts -> [B, text_len, dim] on the model's device; rows past each
        prompt are zero."""
        ids, lens = self.tokenizer.batch_encode_padded(
            texts, seq_len=self.cfg.text_len)
        ids = np.asarray(ids, np.int64)
        ids = np.clip(ids, 0, self.cfg.vocab_size - 1)
        lens = np.minimum(np.asarray(lens, np.int64), self.cfg.text_len)
        return encode_padded(self.model, torch.as_tensor(ids,
                                                         device=self.device),
                             torch.as_tensor(lens, device=self.device),
                             self.compute_dtype)

    @classmethod
    def random_init(cls, spec: WanModelSpec, *, device="cuda",
                    gen: Optional[torch.Generator] = None,
                    compute_dtype=torch.float32) -> "WanTextEncoder":
        """Hermetic encoder: random fp32 UMT5 weights drawn on `device` +
        the hash tokenizer; the same forward as a real checkpoint."""
        from ..utils.tokenizers import HashTokenizer

        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        model = UMT5Encoder(spec.t5, dtype=torch.float32, device=device,
                            gen=gen)
        return cls(model, spec.t5, HashTokenizer(vocab_size=spec.t5.vocab_size),
                   compute_dtype=compute_dtype)

