"""Turn JAX parameter trees (numpy leaves) into the port's modules.

The port's modules keep the JAX trees' parameter names, so a tree maps onto
a state dict key by key. Layout rules, by leaf name and rank:
  * `w` of rank 2, a linear [in, out]        -> [out, in];
  * `qw8` / `qw` of rank 2, the int8 codes of a quantized linear
    (univid_tpu/core/quant.py) [in, out]    -> [out, in]; the module's
    Linear becomes a `core.quant.QuantLinear`, so both packages can run
    the same int8 codes;
  * `w` of rank 5, a conv3d THWIO            -> [Cout, Cin, kt, kh, kw];
  * `w` of rank 4, a 2D conv HWIO (resample) -> [Cout, Cin, 1, kh, kw]
    (the FLUX image VAE's, `image_vae_from_jax`: [Cout, Cin, kh, kw]);
  * every other leaf as it is.
The DiT's `blocks`, the `layers` of SigLIP, the SigLIP text tower and
both NaFlex towers, BAGEL's `llm.layers`, FLUX's `double_blocks` and
`single_blocks`, the CLIP text tower's `blocks`, WanAnimate's `blocks` and
`face_adapter` and the `layers` of its CLIP towers are stacked
[num_layers, ...] in the JAX tree (one lax.scan); they are unstacked into
the ModuleList here. WanAnimate's motion encoder keeps Python lists
(`blocks`, `fc`), which become ModuleLists too; its 2D convs are [Cout,
Cin, kh, kw] and the face encoder's conv1d [Cout, Cin, k]. UMT5's blocks are a dict of layers in both packages
(with `shared_pos`, layer 0 alone holds the position table). LoRA trees
keep the JAX layout as they are (stacked a [L, in, r], b [L, r, out]).
Leaves may be numpy arrays or anything `np.asarray` accepts (bf16 leaves
included); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from .core.config import FusionConfig, T5Config, WanDiTConfig, WanVAEConfig
from .core.quant import QuantLinear
from .models.bagel.autoencoder import ImageVAE, ImageVAEConfig
from .models.bagel.bagel import Bagel, BagelConfig
from .models.bagel.siglip import Siglip, SiglipConfig
from .models.flux.clip_text import ClipText, ClipTextConfig
from .models.flux.kontext import Flux, FluxConfig
from .reflection.scorer import (SiglipMapHead, SiglipText,
                                SiglipTextConfig)
from .models.fusion.projector import ContextProjector
from .models.wan.animate import (ClipTextXlmRoberta,
                                 ClipTextXlmRobertaConfig, ClipVision,
                                 ClipVisionConfig, WanAnimate,
                                 WanAnimateConfig)
from .models.wan.dit import WanDiT
from .models.wan.t5 import UMT5Encoder
from .models.wan.vae_api import WanVAE


def _to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact through fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _layout(name: str, t: torch.Tensor) -> torch.Tensor:
    if name in ("w", "qw8", "qw") and t.ndim == 2:
        return t.t()
    if name == "w" and t.ndim == 5:
        return t.permute(4, 3, 0, 1, 2)
    if name == "w" and t.ndim == 4:
        return t.permute(3, 2, 0, 1)[:, :, None]
    return t


def _flatten(tree, prefix="") -> Dict[str, object]:
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def jax_tree_to_state_dict(tree, stacked: Union[str, Tuple[str, ...],
                                                 None] = None
                           ) -> Dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree into a state dict of the port's module;
    `stacked` names the subtree (or subtrees) whose leaves carry a leading
    layer axis."""
    prefixes = (stacked,) if isinstance(stacked, str) else tuple(stacked or ())
    sd = {}
    for key, leaf in _flatten(tree).items():
        t = _to_torch(leaf)
        name = key.rsplit(".", 1)[-1]
        top = next((p for p in prefixes if key.startswith(p + ".")), None)
        if top is not None:
            rest = key[len(top) + 1:]
            for i in range(t.shape[0]):
                sd[f"{top}.{i}.{rest}"] = _layout(name, t[i]).contiguous()
        else:
            sd[key] = _layout(name, t).contiguous()
    return sd


def _quantized_layers(module, sd):
    """Swap each Linear whose state-dict entries are int8 codes (`qw8` or
    `qw`) for an empty QuantLinear of the same shape."""
    for key, t in sd.items():
        path, _, name = key.rpartition(".")
        if name in ("qw8", "qw"):
            bias = sd.get(f"{path}.b")
            new = QuantLinear.empty(
                t.shape[0], t.shape[1], bias=bias is not None,
                w8a8=name == "qw8",
                bias_dtype=bias.dtype if bias is not None else None,
                device=module.get_submodule(path).w.device)
            parent, _, attr = path.rpartition(".")
            setattr(module.get_submodule(parent), attr, new)


def _load(module, sd, dtype):
    """Load sd into module (Linear layers with int8 codes in sd become
    QuantLinear first); `dtype` casts the floating leaves, never the codes
    or their fp32 scales."""
    _quantized_layers(module, sd)
    if dtype is not None:
        quant = {k for k in sd if k.rpartition(".")[2] in ("qw8", "qw")}
        quant |= {k.rpartition(".")[0] + ".scale" for k in quant}
        sd = {k: v if k in quant else v.to(dtype) for k, v in sd.items()}
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


def bagel_from_jax(params, cfg: BagelConfig, *, device="cuda", dtype=None,
                   llm_layers: bool = True) -> Bagel:
    """univid_tpu init_bagel / checkpoint tree -> the port's Bagel on
    `device`: every parameter, the stacked llm.layers unstacked.
    `llm_layers=False` takes the LLM's embed_tokens only (the module the
    fusion extractor reads)."""
    tree = dict(params)
    if not llm_layers:
        tree["llm"] = {"embed_tokens": params["llm"]["embed_tokens"]}
    model = Bagel(cfg, dtype=dtype or torch.float32, device=device,
                  llm_layers=llm_layers)
    return _load(model, jax_tree_to_state_dict(tree, stacked="llm.layers"),
                 dtype)


def image_vae_from_jax(params, cfg: ImageVAEConfig, *, device="cuda",
                       dtype=None) -> ImageVAE:
    """univid_tpu init_image_vae / convert_flux_ae tree -> ImageVAE on
    `device`, its 2D convs [Cout, Cin, kh, kw]."""
    model = ImageVAE(cfg, dtype=dtype or torch.float32, device=device)
    sd = {k: t[:, :, 0] if t.ndim == 5 else t
          for k, t in jax_tree_to_state_dict(params).items()}
    return _load(model, sd, dtype)


def siglip_from_jax(params, cfg: SiglipConfig, *, device="cuda",
                    dtype=None) -> Siglip:
    """univid_tpu init_siglip tree -> Siglip on `device`."""
    model = Siglip(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="layers"),
                 dtype)


def siglip_text_from_jax(params, cfg: SiglipTextConfig, *, device="cuda",
                         dtype=None) -> SiglipText:
    """univid_tpu init_siglip_text tree -> SiglipText on `device`."""
    model = SiglipText(cfg, dtype=dtype or torch.float32, device=device,
                       proj_bias="b" in params["proj"])
    return _load(model, jax_tree_to_state_dict(params, stacked="layers"),
                 dtype)


def siglip_map_head_from_jax(params, *, device="cuda",
                             dtype=None) -> SiglipMapHead:
    """univid_tpu convert_siglip_map_head tree -> SiglipMapHead."""
    d = np.asarray(params["probe"]).shape[-1]
    mlp = np.asarray(params["mlp"]["fc0"]["w"]).shape[-1]
    model = SiglipMapHead(d, mlp, dtype=dtype or torch.float32,
                          device=device)
    return _load(model, jax_tree_to_state_dict(params), dtype)


def naflex_vision_from_jax(params, cfg, *, device="cuda", dtype=None):
    """univid_tpu init_naflex_vision / convert_naflex_checkpoint tree ->
    reflection.naflex.NaflexVision."""
    from .reflection.naflex import NaflexVision
    model = NaflexVision(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="layers"),
                 dtype)


def naflex_text_from_jax(params, cfg, *, device="cuda", dtype=None):
    """univid_tpu init_naflex_text / convert_naflex_checkpoint tree ->
    reflection.naflex.NaflexText."""
    from .reflection.naflex import NaflexText
    model = NaflexText(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="layers"),
                 dtype)


def flux_from_jax(params, cfg: FluxConfig, *, device="cuda",
                  dtype=None) -> Flux:
    """univid_tpu init_flux / convert_flux_transformer tree (quantized by
    quantize_tree or not) -> Flux on `device`, its stacked double and
    single blocks unstacked."""
    model = Flux(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(
        params, stacked=("double_blocks", "single_blocks")), dtype)


def clip_text_from_jax(params, cfg: ClipTextConfig, *, device="cuda",
                       dtype=None) -> ClipText:
    """univid_tpu init_clip_text / convert_clip_text tree -> ClipText on
    `device`."""
    model = ClipText(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="blocks"),
                 dtype)


def wan_animate_from_jax(params, cfg: WanAnimateConfig, *, device="cuda",
                         dtype=None) -> WanAnimate:
    """univid_tpu init_wan_animate / convert_wan_animate tree -> WanAnimate
    on `device`, its DiT leaves in `dtype` (default fp32) and its fp32
    leaves in fp32, as the checkpoint converter places them: the stacked
    blocks and face adapters unstacked, the motion encoder's convs [Cout,
    Cin, kh, kw], the face encoder's conv1d [Cout, Cin, k]. A converted
    checkpoint's tree lacks the motion encoder's conv biases (the
    reference's EqualConv2d has none before a fused leaky ReLU); they load
    as zeros, which the JAX forward's absent bias equals."""
    model = WanAnimate(cfg, dtype=dtype or torch.float32, device=device)
    sd = {}
    for k, t in jax_tree_to_state_dict(
            params, stacked=("blocks", "face_adapter")).items():
        if k.startswith("motion_encoder.") and t.ndim == 5:
            t = t[:, :, 0]
        elif k.startswith("face_encoder.conv") and k.endswith(".w"):
            t = t.permute(2, 1, 0)
        sd[k] = t.contiguous()
    for k, p in model.motion_encoder.named_parameters():
        if k.endswith(".b") and f"motion_encoder.{k}" not in sd:
            sd[f"motion_encoder.{k}"] = torch.zeros_like(p, device="cpu")
    return _load(model, sd, None)


def clip_vit_from_jax(params, cfg: ClipVisionConfig, *, device="cuda",
                      dtype=None) -> ClipVision:
    """univid_tpu init_clip_vision / convert_clip_vit tree -> ClipVision."""
    model = ClipVision(cfg, dtype=dtype or torch.float32, device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="layers"),
                 dtype)


def clip_text_xlmr_from_jax(params, cfg: ClipTextXlmRobertaConfig, *,
                            device="cuda", dtype=None) -> ClipTextXlmRoberta:
    """univid_tpu init_clip_text / convert_clip_text_xlm_roberta tree (the
    XLM-Roberta CLIP text tower) -> ClipTextXlmRoberta."""
    model = ClipTextXlmRoberta(cfg, dtype=dtype or torch.float32,
                               device=device)
    return _load(model, jax_tree_to_state_dict(params, stacked="layers"),
                 dtype)
