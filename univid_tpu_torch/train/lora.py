"""LoRA for the Wan DiT: stacked factors over the layers, no PEFT.

Counterpart of univid_tpu/train/lora.py (reference LoRAManager,
model_pipeline.py:325-835): the target strategies (:463-566) over the same
flat module ordering (blocks ascending, q/k/v/o per attention), as
per-site [num_layers] masks; the FFN "low priority" list that never
matches a WanModel name stays empty, and > 50 targets clamp to the first
50 of high + medium + low, as in the reference.

A LoRA tree is {'sites': {site: {'a': [L, in, r], 'b': [L, r, out],
'mask': [L]}}, 'rank': r, 'alpha': alpha}, the JAX tree's structure and
layouts, so `save_lora` / `load_lora` read and write the same npz + json
files as the JAX package. `merge_lora` returns the merged weights of the
masked layers only, keyed by the DiT's state-dict names, for
`wan_dit_forward(..., weights=...)`: the frozen base stays where it is,
uncopied, and gradients reach a and b only.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import WanDiTConfig

ATTN_SITES = ["q", "k", "v", "o"]


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    target_strategy: str = "wan_cross_attention"
    dropout: float = 0.0

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


# ---------------------------------------------------------------------------
# target selection (model_pipeline.py:463-566 semantics)
# ---------------------------------------------------------------------------


def select_targets(cfg: WanDiTConfig, strategy: str
                   ) -> List[Tuple[str, int]]:
    """-> list of ("cross_attn/q", layer) pairs."""
    n = cfg.num_layers
    high = [("cross_attn/" + s, i) for i in range(n) for s in ATTN_SITES]
    medium = [("self_attn/" + s, i) for i in range(n) for s in ATTN_SITES]
    low: List[Tuple[str, int]] = []  # the reference's FFN names never match

    if strategy == "wan_cross_attention":
        out = list(high)
        step = max(1, len(medium) // 4)
        out += medium[::step]
    elif strategy == "smart_wan_dit":
        out = list(high)
        out += [m for i, m in enumerate(medium) if i % 2 == 0]
        out += [m for i, m in enumerate(low) if i % 4 == 0][
            : max(4, len(high) // 2)]
    elif strategy == "cross_attention_only":
        out = list(high)
    elif strategy == "attention_only":
        blocks = [b for b in range(8, 21) if b < n]
        out = [("cross_attn/" + s, b) for b in blocks for s in ATTN_SITES]
    elif strategy == "minimal_cross_attention":
        blocks = [b for b in (10, 12, 14, 16, 18) if b < n]
        out = [("cross_attn/" + s, b) for b in blocks for s in ATTN_SITES]
    elif strategy == "attention_focused":
        out = list(high) + list(medium)
    else:
        out = list(high)
        out += [m for i, m in enumerate(medium) if i % 2 == 0]

    if len(out) > 50:
        out = (high + medium + low)[:50]
    return out


def site_masks(cfg: WanDiTConfig, strategy: str) -> Dict[str, np.ndarray]:
    """site -> [num_layers] float mask."""
    masks: Dict[str, np.ndarray] = {}
    for site, layer in select_targets(cfg, strategy):
        masks.setdefault(site, np.zeros(cfg.num_layers, np.float32))
        masks[site][layer] = 1.0
    return masks


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_lora(gen: torch.Generator, cfg: WanDiTConfig, lora_cfg: LoRAConfig,
              *, dtype=torch.float32, device="cuda"):
    """A gaussian / sqrt(in), B zeros (standard LoRA init), per site in
    sorted order, drawn from `gen`."""
    masks = site_masks(cfg, lora_cfg.target_strategy)
    d = cfg.dim
    r = lora_cfg.rank
    sites = {}
    for site, mask in sorted(masks.items()):
        a = torch.randn((cfg.num_layers, d, r), generator=gen,
                        dtype=torch.float32, device=device) / np.sqrt(d)
        sites[site] = {
            "a": a.to(dtype),
            "b": torch.zeros((cfg.num_layers, r, d), dtype=dtype,
                             device=device),
            "mask": torch.as_tensor(mask, device=device),
        }
    return {"sites": sites, "rank": r, "alpha": lora_cfg.alpha}


def trainable_sites(lora) -> Dict[str, dict]:
    """The differentiable subset of a LoRA tree, {site: {'a', 'b'}}: the
    same tensors, set to require grad (rank, alpha and masks are
    hyperparameters)."""
    return {site: {"a": p["a"].requires_grad_(True),
                   "b": p["b"].requires_grad_(True)}
            for site, p in lora["sites"].items()}


def with_sites(lora, sites: Dict[str, dict]):
    """Rebuild a full LoRA tree with updated a/b leaves."""
    merged = {site: dict(p, **sites[site])
              for site, p in lora["sites"].items()}
    return dict(lora, sites=merged)


def merge_lora(model, lora, *, sites: Optional[Dict[str, dict]] = None
               ) -> Dict[str, torch.Tensor]:
    """Merged weights {"blocks.{l}.{mod}.{proj}.w": w_l + scale * mask_l *
    (a_l b_l)^T} for every layer whose mask is non-zero (elsewhere the merge
    is the base weight itself). Sums in fp32, one rounding to the base
    dtype, as the JAX merge; differentiable in a and b (`sites` substitutes
    trained factors), with the base weights frozen (requires_grad off)."""
    scale = lora["alpha"] / lora["rank"]
    out = {}
    for site, p in lora["sites"].items():
        mod, proj = site.split("/")
        a = sites[site]["a"] if sites is not None else p["a"]
        b = sites[site]["b"] if sites is not None else p["b"]
        mask = p["mask"].detach()
        layers = torch.nonzero(mask.cpu()).flatten().tolist()
        if not layers:
            continue
        idx = torch.tensor(layers, device=a.device)
        # [n, out, in]: the port keeps linear weights as [out, in]
        delta = torch.einsum("lir,lro->loi", a[idx].float(), b[idx].float())
        delta = delta * (scale * mask[idx].float())[:, None, None]
        for j, layer in enumerate(layers):
            w = getattr(model.blocks[layer], mod)[proj].w
            w.requires_grad_(False)
            out[f"blocks.{layer}.{mod}.{proj}.w"] = (
                w.float() + delta[j]).to(w.dtype)
    return out


# ---------------------------------------------------------------------------
# save / load (model_pipeline.py:601-720 surface; the JAX package's files)
# ---------------------------------------------------------------------------


def save_lora(path: str, lora, lora_cfg: LoRAConfig,
              metadata: Optional[dict] = None):
    """lora_weights.npz ({site with '.' for '/'}.{a,b,mask}, fp32 or the
    leaves' dtype) + lora_config.json (+ metadata.json)."""
    os.makedirs(path, exist_ok=True)
    flat = {}
    for site, p in lora["sites"].items():
        key = site.replace("/", ".")
        for leaf in ("a", "b", "mask"):
            flat[f"{key}.{leaf}"] = p[leaf].detach().cpu().numpy()
    np.savez(os.path.join(path, "lora_weights.npz"), **flat)
    with open(os.path.join(path, "lora_config.json"), "w") as f:
        json.dump({"rank": lora_cfg.rank, "alpha": lora_cfg.alpha,
                   "target_strategy": lora_cfg.target_strategy}, f,
                  indent=2)
    if metadata:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2)


def load_lora(path: str, *, device="cuda"):
    """-> (LoRA tree on `device`, LoRAConfig)."""
    with open(os.path.join(path, "lora_config.json")) as f:
        cfg = json.load(f)
    data = np.load(os.path.join(path, "lora_weights.npz"))
    sites: Dict[str, dict] = {}
    for key in data.files:
        name, leaf = key.rsplit(".", 1)
        site = name.replace(".", "/")
        sites.setdefault(site, {})[leaf] = torch.as_tensor(
            np.array(data[key])).to(device)
    return ({"sites": sites, "rank": cfg["rank"], "alpha": cfg["alpha"]},
            LoRAConfig(rank=cfg["rank"], alpha=cfg["alpha"],
                       target_strategy=cfg["target_strategy"]))
