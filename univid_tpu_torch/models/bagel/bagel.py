"""BAGEL: the config and the parameters the fusion extractor reads.

Counterpart of univid_tpu/models/bagel/bagel.py:46-136: `BagelConfig`, the
frozen 2-D sin-cos table, the flattened ViT position ids, and `Bagel`, a
module with the three parameter groups that the semantic extractor uses:
`llm.embed_tokens`, the ViT `connector` (fc0 -> gelu_tanh -> fc1) and
`vit_pos_embed`. The LLM layers, the image-generation heads and the context
updaters come with the BAGEL LM slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ...core import nn as unn
from .qwen2_mot import Qwen2MoTConfig


@dataclass(frozen=True)
class BagelConfig:
    llm: Qwen2MoTConfig = field(default_factory=Qwen2MoTConfig)
    latent_patch_size: int = 2
    max_latent_size: int = 64
    latent_channel: int = 16
    vae_downsample: int = 8
    vit_hidden_size: int = 1152
    vit_patch_size: int = 14
    vit_max_num_patch_per_side: int = 70
    timestep_shift: float = 1.0
    # special token ids (data/data_utils.py:130-165 adds these)
    start_of_image: int = 151652
    end_of_image: int = 151653
    bos_token_id: int = 151644
    eos_token_id: int = 151645

    @property
    def latent_downsample(self) -> int:
        return self.vae_downsample * self.latent_patch_size

    @property
    def patch_latent_dim(self) -> int:
        return self.latent_patch_size ** 2 * self.latent_channel


def sincos_2d_table(dim: int, side: int) -> np.ndarray:
    """Frozen 2-D sin-cos table [side^2, dim]: [sin|cos] per half, the
    first half encoding the column (w) coordinate."""
    def emb_1d(pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64)
                                / (dim / 4))
        out = np.outer(pos.astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    idx = np.arange(side * side)
    h_idx, w_idx = idx // side, idx % side
    return np.concatenate([emb_1d(w_idx), emb_1d(h_idx)],
                          axis=1).astype(np.float32)


def flattened_position_ids(h_patches: int, w_patches: int,
                           max_per_side: int) -> np.ndarray:
    """Row-major patch ids on a max_per_side-wide grid (the extrapolate
    variant)."""
    hh = np.arange(h_patches)
    ww = np.arange(w_patches)
    return (hh[:, None] * max_per_side + ww[None, :]).reshape(-1)


class Bagel(nn.Module):
    """The BAGEL parameters the extractor reads, named as in the JAX tree.
    With `gen`, embed_tokens and the connector are drawn on `device` as
    univid_tpu init_bagel draws them (normal, std 0.02; zero biases);
    without, they are left empty for convert.bagel_extractor_from_jax.
    vit_pos_embed is the fixed sin-cos table either way."""

    def __init__(self, cfg: BagelConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.llm.hidden_size
        self.llm = unn.Node(embed_tokens=unn.param(
            (cfg.llm.vocab_size, d), dtype, device, gen, "normal", std=0.02))
        self.connector = unn.mlp((cfg.vit_hidden_size, d, d), init="normal",
                                 dtype=dtype, device=device, gen=gen)
        table = sincos_2d_table(d, cfg.vit_max_num_patch_per_side)
        self.vit_pos_embed = nn.Parameter(
            torch.as_tensor(table).to(device=device, dtype=dtype),
            requires_grad=False)


def init_bagel(gen: torch.Generator, cfg: BagelConfig, *,
               dtype=torch.float32, device="cuda") -> Bagel:
    return Bagel(cfg, dtype=dtype, device=device, gen=gen)
