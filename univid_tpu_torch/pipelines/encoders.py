"""Prompt -> context encoder for the Wan pipelines (counterpart of
univid_tpu/pipelines/encoders.py WanTextEncoder): tokenizer + UMT5 forward
producing padded-and-zeroed [B, text_len, dim] context tensors, from
random weights (`random_init`) or a Wan checkpoint dir (`from_checkpoint`)."""

from __future__ import annotations

import os
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


    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, spec: WanModelSpec,
                        dtype=torch.bfloat16, *,
                        device="cuda") -> "WanTextEncoder":
        """The reference UMT5 .pth (models_t5_umt5-xxl-enc-bf16.pth,
        umt5.pth or t5.safetensors) in `dtype` on `device` + the HF
        tokenizer of the google/umt5-xxl subdir (or the dir itself),
        which needs `transformers` (utils.tokenizers.load_tokenizer raises
        RuntimeError without it)."""
        from ..core.checkpoint import convert_umt5, load_state_dict
        from ..utils.tokenizers import load_tokenizer

        t5_path = None
        for cand in ("models_t5_umt5-xxl-enc-bf16.pth", "umt5.pth",
                     "t5.safetensors"):
            p = os.path.join(checkpoint_dir, cand)
            if os.path.exists(p):
                t5_path = p
                break
        if t5_path is None:
            raise FileNotFoundError(
                f"no UMT5 checkpoint in {checkpoint_dir}")
        # the tokenizer first: a dir without one fails before the
        # weights reach the device
        tok_dir = os.path.join(checkpoint_dir, "google", "umt5-xxl")
        tokenizer = load_tokenizer(
            tok_dir if os.path.isdir(tok_dir) else checkpoint_dir,
            seq_len=spec.t5.text_len)
        model = convert_umt5(load_state_dict(t5_path), spec.t5, dtype,
                             device=device)
        return cls(model, spec.t5, tokenizer, compute_dtype=dtype)
