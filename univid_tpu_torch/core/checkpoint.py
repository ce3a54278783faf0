"""Checkpoint ingestion (counterpart of univid_tpu/core/checkpoint.py).

Only the ContextProjector loader is here (`--training_state`); the Wan,
UMT5 and BAGEL loaders come with the checkpoint slice.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .config import FusionConfig

# reference ContextProjector: Sequential(Linear, LayerNorm, GELU, Dropout,
# Linear, LayerNorm) -> the port's module names
_SEQ_INDEX = {"fc0": 0, "ln0": 1, "fc1": 4, "ln1": 5}
_LEAF = {"w": "weight", "b": "bias"}


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A flat {name: tensor} from a torch file (read with weights_only),
    an .npz, or a directory holding the port trainer's train_state.npz."""
    from ..convert import _flatten

    if os.path.isdir(path):
        path = os.path.join(path, "train_state.npz")
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.as_tensor(np.array(data[k])) for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return _flatten(sd)


def load_projector_checkpoint(path: str, cfg: FusionConfig, *,
                              dtype=torch.float32, device="cuda"):
    """ContextProjector weights from a reference training_state.pt (the
    projector under `context_projector.`, `projector.` or
    `model_state_dict.`, its layers under `bagel_to_t5_projector.`,
    `projection.` or bare, at Sequential indices 0, 1, 4, 5), a bare
    projector state dict, or the port trainer's train_state.npz
    (`trainable/projector.` + the port's fc0 / ln0 / fc1 / ln1 names)."""
    from ..models.fusion.projector import ContextProjector

    sd = _read_state_dict(path)
    for container in ("context_projector", "projector", "model_state_dict",
                      "trainable/projector"):
        inner = {k[len(container) + 1:]: v for k, v in sd.items()
                 if k.startswith(container + ".")}
        if inner:
            sd = inner
            break
    if "fc0.w" in sd:   # the port's own names
        sd = {f"{_SEQ_INDEX[m]}.{_LEAF[leaf]}": v for m, leaf, v in
              (k.split(".") + [v] for k, v in sd.items())}
    root = next((c for c in ("bagel_to_t5_projector.", "projection.", "")
                 if f"{c}0.weight" in sd), "")
    model = ContextProjector(cfg, dtype=dtype, device=device)
    model.load_state_dict({
        f"{mod}.{leaf}": sd[f"{root}{idx}.{_LEAF[leaf]}"].to(dtype)
        for mod, idx in _SEQ_INDEX.items() for leaf in ("w", "b")})
    return model
