"""Turn JAX parameter trees (numpy leaves) into the port's modules.

The port's modules keep the JAX trees' parameter names, so a tree maps onto
a state dict key by key. Layout rules, by leaf name and rank:
  * `w` of rank 2, a linear [in, out]        -> [out, in];
  * `w` of rank 5, a conv3d THWIO            -> [Cout, Cin, kt, kh, kw];
  * `w` of rank 4, a 2D conv HWIO (resample) -> [Cout, Cin, 1, kh, kw];
  * every other leaf as it is.
The DiT's `blocks` and SigLIP's `layers` leaves are stacked
[num_layers, ...] in the JAX tree (one lax.scan); they are unstacked into
the ModuleList here. Of a BAGEL tree only what the fusion extractor reads
is taken (llm.embed_tokens, connector, vit_pos_embed). LoRA trees
keep the JAX layout as they are (stacked a [L, in, r], b [L, r, out]).
Leaves may be numpy arrays or anything `np.asarray` accepts (bf16 leaves
included); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core.config import FusionConfig, T5Config, WanDiTConfig, WanVAEConfig
from .models.bagel.bagel import Bagel, BagelConfig
from .models.bagel.siglip import Siglip, SiglipConfig
from .models.fusion.projector import ContextProjector
from .models.wan.dit import WanDiT
from .models.wan.t5 import UMT5Encoder
from .models.wan.vae_api import WanVAE


def _to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact through fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _layout(name: str, t: torch.Tensor) -> torch.Tensor:
    if name == "w" and t.ndim == 2:
        return t.t()
    if name == "w" and t.ndim == 5:
        return t.permute(4, 3, 0, 1, 2)
    if name == "w" and t.ndim == 4:
        return t.permute(3, 2, 0, 1)[:, :, None]
    return t


def _flatten(tree, prefix="") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def jax_tree_to_state_dict(tree, stacked: Optional[str] = None
                           ) -> Dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree into a state dict of the port's module;
    `stacked` names a subtree whose leaves carry a leading layer axis."""
    sd = {}
    for key, leaf in _flatten(tree).items():
        t = _to_torch(leaf)
        name = key.rsplit(".", 1)[-1]
        if stacked is not None and key.startswith(stacked + "."):
            rest = key[len(stacked) + 1:]
            for i in range(t.shape[0]):
                sd[f"{stacked}.{i}.{rest}"] = _layout(name, t[i]).contiguous()
        else:
            sd[key] = _layout(name, t).contiguous()
    return sd


def _load(module, sd, dtype):
    if dtype is not None:
        sd = {k: v.to(dtype) for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module


def dit_from_jax(params, cfg: WanDiTConfig, *, device="cuda",
                 dtype=None) -> WanDiT:
    """univid_tpu init_wan_dit / checkpoint tree -> WanDiT on `device`
    (leaf dtypes kept unless `dtype` is given)."""
    model = WanDiT(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="blocks"),
                 dtype)


def vae_from_jax(params, cfg: WanVAEConfig, *, device="cuda",
                 dtype=None) -> WanVAE:
    model = WanVAE(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params), dtype)


def t5_from_jax(params, cfg: T5Config, *, device="cuda",
                dtype=None) -> UMT5Encoder:
    model = UMT5Encoder(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params), dtype)


def projector_from_jax(params, cfg: FusionConfig, *, device="cuda",
                       dtype=None) -> ContextProjector:
    """univid_tpu init_context_projector tree -> ContextProjector
    (trainable) on `device`."""
    model = ContextProjector(cfg, dtype=dtype or torch.float32,
                             device=device)
    return _load(model, jax_tree_to_state_dict(params), dtype)


def lora_from_jax(lora, *, device="cuda"):
    """univid_tpu init_lora / load_lora tree -> the port's LoRA tree on
    `device` (same structure and layouts)."""
    sites = {site: {leaf: _to_torch(x).to(device) for leaf, x in p.items()}
             for site, p in lora["sites"].items()}
    return {"sites": sites, "rank": int(lora["rank"]),
            "alpha": float(lora["alpha"])}


def bagel_extractor_from_jax(params, cfg: BagelConfig, *, device="cuda",
                             dtype=None) -> Bagel:
    """univid_tpu init_bagel / checkpoint tree -> the port's Bagel (the
    parameters the semantic extractor reads) on `device`."""
    tree = {"llm": {"embed_tokens": params["llm"]["embed_tokens"]},
            "connector": params["connector"],
            "vit_pos_embed": params["vit_pos_embed"]}
    model = Bagel(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(tree), dtype)


def siglip_from_jax(params, cfg: SiglipConfig, *, device="cuda",
                    dtype=None) -> Siglip:
    """univid_tpu init_siglip tree -> Siglip on `device`."""
    model = Siglip(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="layers"),
                 dtype)
