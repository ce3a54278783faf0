"""SigLIP2 frame scorer: text and image towers, top-k frames by cosine.

Counterpart of univid_tpu/reflection/scorer.py: `SiglipTextConfig`, the
text tower (`siglip_text_forward`), the attention-pooling head
(`map_head_forward`) and `Siglip2Scorer` (`emb_imgs`, `emb_text`,
`rank_frames`) with its random-init default, a SigLIP2-base vision tower
(patch 16, 224 px, mean-pooled and projected) and text tower, or an HF
SigLIP / SigLIP2 checkpoint (`from_checkpoint`: the attention-pooling head,
the text head on the last token; the NaFlex tower is reflection/naflex.py).
The JAX scorer shards its batch over a mesh; here a batch of frames runs on
one device, image by image through the tower. Both towers have head dim
64, so attention takes the dispatcher's reference route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core import nn as unn
from ..kernels.attention import attention
from ..models.bagel.bagel import flattened_position_ids
from ..models.bagel.siglip import (SiglipConfig, image_to_patches,
                                   init_siglip, siglip_forward)


@dataclass(frozen=True)
class SiglipTextConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 64
    proj_dim: int = 1024
    # "mean": mean-pool + proj (random-init mode); "hf_last": the last
    # (padded) token + head linear (HF SiglipTextTransformer)
    pooling: str = "mean"


def _ln(d, dtype, device):
    return unn.Node(w=unn.param((d,), dtype, device, init="ones"),
                    b=unn.param((d,), dtype, device, init="zeros"))


class SiglipText(nn.Module):
    """The text tower's parameters, named as init_siglip_text's tree; drawn
    from `gen` (normal, std 0.02) or left empty to be loaded. `proj_bias`:
    the HF checkpoint's pooling head has a bias, the random init none."""

    def __init__(self, cfg: SiglipTextConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None,
                 proj_bias: bool = False):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(init="normal", dtype=dtype, device=device, gen=gen)
        self.token_embed = unn.param((cfg.vocab_size, d), dtype, device, gen,
                                     "normal", std=0.02)
        self.pos_embed = unn.param((cfg.max_len, d), dtype, device, gen,
                                   "normal", std=0.02)
        self.final_ln = _ln(d, dtype, device)
        self.proj = unn.Linear(d, cfg.proj_dim, bias=proj_bias, **kw)
        self.layers = nn.ModuleList([
            unn.Node(ln1=_ln(d, dtype, device),
                     attn=unn.Node(**{p: unn.Linear(d, d, **kw)
                                      for p in ("q", "k", "v", "o")}),
                     ln2=_ln(d, dtype, device),
                     mlp=unn.mlp((d, cfg.intermediate_size, d), **kw))
            for _ in range(cfg.num_layers)])


class SiglipMapHead(nn.Module):
    """HF SiglipMultiheadAttentionPoolingHead's parameters (probe, q/k/v/o,
    ln, mlp fc0/fc1), named as convert_siglip_map_head's tree."""

    def __init__(self, d: int, mlp_dim: int, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.probe = unn.param((1, 1, d), dtype, device)
        for p in ("q", "k", "v", "o"):
            setattr(self, p, unn.Linear(d, d, init="empty", dtype=dtype,
                                        device=device))
        self.ln = _ln(d, dtype, device)
        self.mlp = unn.mlp((d, mlp_dim, d), init="empty", dtype=dtype,
                           device=device)


def _norm(h, p):
    return unn.layer_norm(h, weight=p.w.to(h.dtype), bias=p.b.to(h.dtype))


def siglip_text_forward(params: SiglipText, cfg: SiglipTextConfig,
                        ids: torch.Tensor, compute_dtype=torch.float32
                        ) -> torch.Tensor:
    """ids [B, L] -> projected, L2-normalised text embedding [B, proj],
    fp32."""
    b, l = ids.shape
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    cd = compute_dtype
    x = (params.token_embed[ids] + params.pos_embed[None, :l]).to(cd)
    for layer in params.layers:
        y = _norm(x, layer.ln1)
        a = layer.attn
        q, k, v = (unn.linear(a[p], y, compute_dtype=cd).reshape(b, l, nh, hd)
                   for p in ("q", "k", "v"))
        o = attention(q, k, v)
        x = x + unn.linear(a.o, o.reshape(b, l, -1), compute_dtype=cd)
        y = _norm(x, layer.ln2)
        y = unn.gelu_tanh(unn.linear(layer.mlp.fc0, y, compute_dtype=cd))
        x = x + unn.linear(layer.mlp.fc1, y, compute_dtype=cd)
    x = _norm(x, params.final_ln)
    pooled = x[:, -1] if cfg.pooling == "hf_last" else x.mean(dim=1)
    t = unn.linear(params.proj, pooled, compute_dtype=cd).float()
    return t / torch.linalg.norm(t, dim=-1, keepdim=True)


def map_head_forward(params: SiglipMapHead, feats: torch.Tensor,
                     num_heads: int, compute_dtype=torch.float32
                     ) -> torch.Tensor:
    """The learned probe cross-attends the patch features, then layer norm
    and an MLP residual: feats [N, d] (one image) -> pooled [d]."""
    d = feats.shape[-1]
    hd = d // num_heads
    cd = compute_dtype
    n = feats.shape[0]
    f = feats.to(cd)[None]                                     # [1, N, d]
    probe = params.probe.to(cd).reshape(1, 1, d)
    q = unn.linear(params.q, probe, compute_dtype=cd).reshape(1, 1,
                                                              num_heads, hd)
    k = unn.linear(params.k, f, compute_dtype=cd).reshape(1, n, num_heads, hd)
    v = unn.linear(params.v, f, compute_dtype=cd).reshape(1, n, num_heads, hd)
    o = attention(q, k, v).reshape(1, 1, d)
    h = unn.linear(params.o, o, compute_dtype=cd)
    y = unn.layer_norm(h, weight=params.ln.w.to(cd), bias=params.ln.b.to(cd))
    y = unn.gelu_tanh(unn.linear(params.mlp.fc0, y, compute_dtype=cd))
    y = unn.linear(params.mlp.fc1, y, compute_dtype=cd)
    return (h + y)[0, 0]


class Siglip2Scorer:
    """Dual-tower frame scorer. Without towers it draws the random-init
    default from `seed` on `device`: a SigLIP2-base vision tower (768 wide,
    12 layers, patch 16, `image_size` px) whose mean-pooled features are
    projected by `img_proj` into the text tower's space. compute_dtype:
    bf16 on a card, fp32 on the CPU unless given; embeddings are
    L2-normalised in fp32 either way."""

    def __init__(self, vision_params=None,
                 vision_cfg: Optional[SiglipConfig] = None,
                 text_params: Optional[SiglipText] = None,
                 text_cfg: Optional[SiglipTextConfig] = None,
                 tokenizer=None, image_size: int = 224, seed: int = 0,
                 map_head: Optional[SiglipMapHead] = None, img_proj=None,
                 compute_dtype=None, device="cuda"):
        self.device = torch.device(device)
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" \
                else torch.float32
        self.compute_dtype = compute_dtype
        self.vision_cfg = vision_cfg or SiglipConfig(
            hidden_size=768, intermediate_size=3072, num_layers=12,
            num_heads=12, patch_size=16, image_size=image_size)
        self.text_cfg = text_cfg or SiglipTextConfig()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.vision_params = vision_params if vision_params is not None \
            else init_siglip(gen, self.vision_cfg, device=self.device)
        self.text_params = text_params if text_params is not None \
            else SiglipText(self.text_cfg, device=self.device, gen=gen)
        # a checkpoint's attention-pool head needs no projection; the
        # random-init default mean-pools and projects
        self.map_head = map_head
        if map_head is None and img_proj is None:
            img_proj = unn.Linear(self.vision_cfg.hidden_size,
                                  self.text_cfg.proj_dim, bias=False,
                                  init="normal", device=self.device, gen=gen)
        self.img_proj = None if map_head is not None else img_proj
        self.tokenizer = tokenizer
        self.image_size = image_size

    @classmethod
    def from_checkpoint(cls, path: str, tokenizer=None,
                        dtype=torch.float32, *, device="cuda",
                        compute_dtype=None) -> "Siglip2Scorer":
        """A pretrained HF SigLIP / SigLIP2 dual tower
        (core.checkpoint.load_siglip2_checkpoint); without `tokenizer`, the
        checkpoint's own (utils.tokenizers.load_tokenizer: RuntimeError
        when unavailable, raised before the weights reach the device)."""
        from ..core.checkpoint import (collect_checkpoint_shapes,
                                       load_siglip2_checkpoint)

        if tokenizer is None:
            from ..utils.tokenizers import load_tokenizer
            max_len = collect_checkpoint_shapes(path)[
                "text_model.embeddings.position_embedding.weight"][0]
            tokenizer = load_tokenizer(path, seq_len=max_len)
        parts = load_siglip2_checkpoint(path, dtype=dtype, device=device)
        return cls(vision_params=parts["vision"],
                   vision_cfg=parts["vision_cfg"],
                   text_params=parts["text"], text_cfg=parts["text_cfg"],
                   tokenizer=tokenizer, map_head=parts["map_head"],
                   image_size=parts["vision_cfg"].image_size,
                   compute_dtype=compute_dtype, device=device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _encode_image_batch(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, S, S, 3] (uint8 or float, on the device) -> normalised
        [B, proj]; uint8 is mapped to [-1, 1] on the device."""
        if not images.is_floating_point():
            images = images.float() / 127.5 - 1.0
        cfg = self.vision_cfg
        side = self.image_size // cfg.patch_size
        pos = torch.as_tensor(flattened_position_ids(
            side, side, cfg.num_patches_per_side), device=self.device)
        pooled = []
        for img in images:
            feats = siglip_forward(self.vision_params, cfg,
                                   image_to_patches(img, cfg.patch_size), pos,
                                   compute_dtype=self.compute_dtype)
            if self.map_head is not None:
                pooled.append(map_head_forward(
                    self.map_head, feats, cfg.num_heads,
                    compute_dtype=self.compute_dtype))
            else:
                pooled.append(feats.mean(dim=0))
        pooled = torch.stack(pooled)
        if self.img_proj is not None:
            pooled = unn.linear(self.img_proj, pooled,
                                compute_dtype=self.compute_dtype)
        pooled = pooled.float()
        return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)

    def emb_imgs(self, frames: List[np.ndarray], bs: int = 64) -> np.ndarray:
        """frames: [H, W, 3] uint8 / float arrays, resized on the host to the
        square scorer input -> [N, proj] fp32 numpy."""
        if not frames:
            return np.zeros((0, self.text_cfg.proj_dim), np.float32)
        imgs = np.stack([self._prep(f) for f in frames])
        outs = []
        for i in range(0, len(imgs), bs):
            batch = torch.as_tensor(imgs[i:i + bs]).to(self.device)
            outs.append(self._encode_image_batch(batch).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _prep(self, frame: np.ndarray) -> np.ndarray:
        """HF SiglipImageProcessor's resize: uint8 frames are PIL-BICUBIC
        stretched to [S, S, 3] and stay uint8 (the rescale and normalise
        are the (x / 127.5 - 1) on the device); float frames, already in
        model space, are nearest-resized."""
        f = np.asarray(frame)
        h, w = f.shape[:2]
        s = self.image_size
        if (h, w) == (s, s):
            return f
        if f.dtype == np.uint8 and f.ndim == 3 and f.shape[2] == 3:
            from PIL import Image
            return np.asarray(Image.fromarray(f).resize((s, s),
                                                        Image.BICUBIC))
        yi = (np.arange(s) * h // s).clip(0, h - 1)
        xi = (np.arange(s) * w // s).clip(0, w - 1)
        return f[yi][:, xi]

    @torch.no_grad()
    def emb_text(self, q: str) -> np.ndarray:
        """-> [1, proj] fp32 numpy."""
        if self.tokenizer is None:
            raise ValueError("the scorer needs a tokenizer")
        ids = self.tokenizer.encode(q)[: self.text_cfg.max_len]
        ids = ids + [0] * (self.text_cfg.max_len - len(ids))
        ids = torch.as_tensor([ids], device=self.device) \
            % self.text_cfg.vocab_size
        t = siglip_text_forward(self.text_params, self.text_cfg, ids,
                                compute_dtype=self.compute_dtype)
        return t.cpu().numpy()

    def rank_frames(self, frames: List[np.ndarray], query: str, topk: int,
                    bs: int = 64, v_emb: Optional[np.ndarray] = None
                    ) -> Tuple[List[int], List[float]]:
        """Top-k frames for a text query; `v_emb` reuses image embeddings
        computed before (the reflexion rounds re-rank one pool)."""
        if len(frames) == 0 and (v_emb is None or len(v_emb) == 0):
            return [], []
        t = self.emb_text(query)
        v = v_emb if v_emb is not None else self.emb_imgs(frames, bs=bs)
        sims = (v @ t.T).squeeze(-1)
        k = min(topk, sims.shape[0])
        idx = np.argsort(-sims)[:k]
        return idx.tolist(), [float(sims[i]) for i in idx]
