"""BAGEL's LLM (Qwen2 with Mixture-of-Transformers experts): its config.

Counterpart of univid_tpu/models/bagel/qwen2_mot.py. Only `Qwen2MoTConfig`
is here, which `BagelConfig` holds: the fusion extractor reads BAGEL's
input embeddings and never runs the LLM. The forward, the KV cache and the
causal attention it needs come with the BAGEL LM slice.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Qwen2MoTConfig:
    """BAGEL-7B-MoT shape (Qwen2-7B backbone)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    qk_norm: bool = True
    moe: bool = True  # MoT dual experts (layer_module Qwen2MoTDecoderLayer)
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads
