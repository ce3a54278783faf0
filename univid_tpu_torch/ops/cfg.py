"""Classifier-free guidance combine and renorm (counterpart of
univid_tpu/ops/cfg.py).

  * classifier_free_guidance: v = v_uncond + scale * (v_cond - v_uncond),
    the Wan denoise loop's combine;
  * cfg_renorm: scale the guided prediction so its norm does not pass the
    conditional one's, blended with renorm_min: renorm_min + (1 -
    renorm_min) * min(1, |v_cond| / |v_guided|), the norms over every axis
    but the first ('global') or over axis 1 ('channel', 'text_channel');
  * dual_cfg: text guidance, renorm, image guidance, renorm.

These are exported helpers: the pipelines combine their CFG branches
inline. BAGEL's flow loop (models/bagel/bagel.py generate_image_latent)
has a renorm of its own, clip(|v| / (|v_| + 1e-8), renorm_min, 1) over
the last axis for 'channel', applied once after both guidances; each
package keeps the two apart, and so does this one.
"""

from __future__ import annotations

import torch


def classifier_free_guidance(v_cond: torch.Tensor, v_uncond: torch.Tensor,
                             scale) -> torch.Tensor:
    return v_uncond + scale * (v_cond - v_uncond)


def cfg_renorm(v_guided: torch.Tensor, v_cond: torch.Tensor,
               renorm_min: float = 0.0, mode: str = "global"
               ) -> torch.Tensor:
    """v_guided times renorm_min + (1 - renorm_min) * min(1, |v_cond| /
    max(|v_guided|, 1e-12)), fp32 norms, in v_guided's dtype."""
    if mode == "global":
        dims = tuple(range(1, v_guided.ndim))
    elif mode in ("channel", "text_channel"):
        dims = (1,)
    else:
        raise ValueError(mode)
    g = v_guided.float()
    norm_g = torch.linalg.vector_norm(g, dim=dims, keepdim=True)
    norm_c = torch.linalg.vector_norm(v_cond.float(), dim=dims, keepdim=True)
    scale = torch.clamp(norm_c / norm_g.clamp_min(1e-12), max=1.0)
    scale = renorm_min + (1.0 - renorm_min) * scale
    return (g * scale).to(v_guided.dtype)


def dual_cfg(v_cond: torch.Tensor, v_cfg_text: torch.Tensor,
             v_cfg_img: torch.Tensor, cfg_text_scale, cfg_img_scale,
             renorm_mode: str = "global",
             renorm_min: float = 0.0) -> torch.Tensor:
    """Text guidance against v_cfg_text, renormed toward v_cond; then image
    guidance against v_cfg_img, renormed toward the text-guided one."""
    v_text = v_cfg_text + cfg_text_scale * (v_cond - v_cfg_text)
    v_text = cfg_renorm(v_text, v_cond, renorm_min, renorm_mode)
    v = v_cfg_img + cfg_img_scale * (v_text - v_cfg_img)
    return cfg_renorm(v, v_text, renorm_min, renorm_mode)
