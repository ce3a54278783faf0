"""SAM prompt encoder + two-way transformer mask decoder (SAM2 variant),
counterpart of univid_tpu/models/sam2/sam_heads.py.

Random-Fourier point encoding, 4 point-type embeddings, a depth-2
two-way transformer (queries <-> image cross attention at half width), 4
mask tokens + IoU token + SAM2's object-score token, transposed-conv
upscaling fused with the two high-resolution FPN skip levels, per-token
hypernetwork MLPs, and the dynamic multimask-via-stability fallback
(delta 0.05, threshold 0.98). Points are padded to capacity with label
-1 ("not a point") entries, the published padding semantics.

The transposed convolutions follow the JAX package, which applies the
published [in, out, k, k] kernel through jax.lax.conv_transpose: that
is torch's conv_transpose2d with the kernel flipped over both spatial
axes. Attention is a plain product with an fp32 softmax (d = 32 and 16).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import nn as unn
from .hiera import Init, attention, conv2d, layer_norm

NO_OBJ_SCORE = -1024.0


@dataclass(frozen=True)
class SamHeadConfig:
    embed_dim: int = 256
    image_size: int = 1024
    embedding_grid: int = 64            # image_size // 16
    num_multimask: int = 3
    transformer_depth: int = 2
    transformer_heads: int = 8
    transformer_mlp_dim: int = 2048
    attn_downsample: int = 2            # cross-attn internal dim // 2
    upscale_ch: Tuple[int, int] = (64, 32)
    iou_head_depth: int = 3
    iou_head_hidden: int = 256
    pred_obj_scores: bool = True
    use_high_res_features: bool = True
    stability_delta: float = 0.05
    stability_thresh: float = 0.98

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask + 1


def mlp(p, x, *, sigmoid_output=False, compute_dtype=None):
    n = len(p.layers)
    for i, layer in enumerate(p.layers):
        x = unn.linear(layer, x, compute_dtype=compute_dtype)
        if i < n - 1:
            x = F.relu(x)
    return torch.sigmoid(x) if sigmoid_output else x


def deconv2x(x, p):
    """2x2/stride-2 transposed conv over [B, H, W, C]: the JAX package's
    lax.conv_transpose of the unflipped kernel."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           p.w.to(x.dtype).flip((2, 3)), stride=2)
    return y.permute(0, 2, 3, 1) + p.b.to(x.dtype)


def init_prompt_encoder(cfg: SamHeadConfig, mk: Init) -> unn.Node:
    d = cfg.embed_dim
    return unn.Node(
        # PositionEmbeddingRandom gaussian matrix [2, d/2]
        pe_gaussian=mk.normal((2, d // 2), 1.0),
        # 0: negative point, 1: positive point, 2/3: box corners
        point_embeddings=mk.normal((4, d), 1.0),
        not_a_point=mk.normal((d,), 1.0),
        no_mask=mk.normal((d,), 1.0))


def point_pe(pe_gaussian, coords01):
    """Random-Fourier positional encoding of [..., 2] coords in [0,1]."""
    c = 2.0 * coords01 - 1.0
    c = torch.matmul(c, pe_gaussian.to(c.dtype))
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(pe_gaussian, grid: int):
    """[grid, grid, d] positional encoding of pixel centers."""
    g = (torch.arange(grid, dtype=torch.float32,
                      device=pe_gaussian.device) + 0.5) / grid
    coords = torch.stack(torch.meshgrid(g, g, indexing="xy"), dim=-1)
    return point_pe(pe_gaussian, coords)


def encode_points(pe, cfg: SamHeadConfig, points, labels):
    """points [B, N, 2] in input-image pixels, labels [B, N] in
    {-1: pad, 0: negative, 1: positive} -> sparse embeddings [B, N, d]:
    +0.5 pixel-center shift, normalize by the input size, zero the PE of
    pad entries and add the not-a-point embedding, else add the
    per-label point embedding."""
    coords = (points + 0.5) / cfg.image_size
    emb = point_pe(pe.pe_gaussian, coords)
    lab = labels[..., None]
    emb = torch.where(lab == -1, 0.0, emb)
    pts = pe.point_embeddings.to(emb.dtype)
    return emb + torch.where(
        lab == -1, pe.not_a_point.to(emb.dtype),
        torch.where(lab == 0, pts[0], pts[1]))


def attn_params(mk: Init, d, internal, kv_in=None) -> unn.Node:
    kv_in = kv_in or d
    return unn.Node(q=mk.linear(d, internal), k=mk.linear(kv_in, internal),
                    v=mk.linear(kv_in, internal), o=mk.linear(internal, d))


def _attn(p, q, k, v, num_heads: int, compute_dtype=None):
    """Multi-head attention over [B, N, *] with an fp32 softmax."""
    q = unn.linear(p.q, q, compute_dtype=compute_dtype)
    k = unn.linear(p.k, k, compute_dtype=compute_dtype)
    v = unn.linear(p.v, v, compute_dtype=compute_dtype)
    return unn.linear(p.o, attention(q, k, v, num_heads),
                      compute_dtype=compute_dtype)


def _ln(p, x):
    return layer_norm(p, x, 1e-5)


def init_two_way_transformer(cfg: SamHeadConfig, mk: Init) -> unn.Node:
    d = cfg.embed_dim
    internal = d // cfg.attn_downsample
    layers = [unn.Node(
        self_attn=attn_params(mk, d, d), norm1=mk.ln(d),
        cross_t2i=attn_params(mk, d, internal), norm2=mk.ln(d),
        mlp0=mk.linear(d, cfg.transformer_mlp_dim),
        mlp1=mk.linear(cfg.transformer_mlp_dim, d), norm3=mk.ln(d),
        cross_i2t=attn_params(mk, d, internal), norm4=mk.ln(d))
        for _ in range(cfg.transformer_depth)]
    return unn.Node(layers=nn.ModuleList(layers),
                    final_attn=attn_params(mk, d, internal),
                    norm_final=mk.ln(d))


def two_way_transformer(p, cfg: SamHeadConfig, image_embed, image_pe,
                        tokens, compute_dtype=None):
    """queries=tokens [B, T, d] <-> keys=image [B, HW, d]; returns
    (queries, keys). Layer 0's self-attention skips the positional
    re-add (skip_first_layer_pe)."""
    heads = cfg.transformer_heads
    queries, keys = tokens, image_embed
    for i, layer in enumerate(p.layers):
        if i == 0:
            queries = _attn(layer.self_attn, queries, queries, queries,
                            heads, compute_dtype=compute_dtype)
        else:
            q = queries + tokens
            queries = queries + _attn(layer.self_attn, q, q, queries,
                                      heads, compute_dtype=compute_dtype)
        queries = _ln(layer.norm1, queries)
        q = queries + tokens
        k = keys + image_pe
        queries = queries + _attn(layer.cross_t2i, q, k, keys, heads,
                                  compute_dtype=compute_dtype)
        queries = _ln(layer.norm2, queries)
        m = unn.linear(layer.mlp0, queries, compute_dtype=compute_dtype)
        m = unn.linear(layer.mlp1, F.relu(m), compute_dtype=compute_dtype)
        queries = _ln(layer.norm3, queries + m)
        q = queries + tokens
        keys = keys + _attn(layer.cross_i2t, k, q, queries, heads,
                            compute_dtype=compute_dtype)
        keys = _ln(layer.norm4, keys)
    q = queries + tokens
    k = keys + image_pe
    queries = queries + _attn(p.final_attn, q, k, keys, heads,
                              compute_dtype=compute_dtype)
    return _ln(p.norm_final, queries), keys


def init_mask_decoder(cfg: SamHeadConfig, mk: Init) -> unn.Node:
    d = cfg.embed_dim
    c1, c2 = cfg.upscale_ch
    nm = cfg.num_mask_tokens
    p = dict(
        transformer=init_two_way_transformer(cfg, mk),
        iou_token=mk.normal((d,), 1.0),
        mask_tokens=mk.normal((nm, d), 1.0),
        upscale0=mk.deconv(2, d, c1),
        upscale_ln=mk.ln(c1),
        upscale1=mk.deconv(2, c1, c2),
        # hypernetwork MLPs are depth 3 (d -> d -> d -> c2)
        hyper_mlps=nn.ModuleList([mk.mlp((d, d, d, c2))
                                  for _ in range(nm)]),
        iou_head=mk.mlp((d,) + (cfg.iou_head_hidden,)
                        * (cfg.iou_head_depth - 1) + (nm,)))
    if cfg.pred_obj_scores:
        p["obj_score_token"] = mk.normal((d,), 1.0)
        p["pred_obj_score_head"] = mk.mlp((d, d, d, 1))
    if cfg.use_high_res_features:
        p["conv_s0"] = mk.conv(1, 1, d, c2)
        p["conv_s1"] = mk.conv(1, 1, d, c1)
    return unn.Node(**p)


def mask_decoder_forward(p, cfg: SamHeadConfig, image_embed, image_pe,
                         sparse_prompt, dense_prompt, high_res_feats=None,
                         compute_dtype=None):
    """image_embed [B, g, g, d]; sparse_prompt [B, N, d]; dense_prompt
    [B, g, g, d]. Returns (masks [B, nm, 4g, 4g], iou [B, nm],
    mask_tokens_out [B, nm, d], obj_score [B, 1])."""
    b, g = image_embed.shape[0], image_embed.shape[1]
    d = cfg.embed_dim
    toks = [p.obj_score_token, p.iou_token] if cfg.pred_obj_scores \
        else [p.iou_token]
    output_tokens = torch.cat([torch.stack(toks), p.mask_tokens],
                              dim=0).to(sparse_prompt.dtype)
    s = 1 if cfg.pred_obj_scores else 0
    tokens = torch.cat([output_tokens[None].expand(
        (b,) + output_tokens.shape), sparse_prompt], dim=1)

    src = (image_embed + dense_prompt).reshape(b, g * g, d)
    pe = image_pe.reshape(1, g * g, d).expand(b, g * g, d).to(src.dtype)
    hs, src = two_way_transformer(p.transformer, cfg, src, pe, tokens,
                                  compute_dtype=compute_dtype)
    iou_tok = hs[:, s]
    mask_toks = hs[:, s + 1: s + 1 + cfg.num_mask_tokens]

    x = src.reshape(b, g, g, d)
    if cfg.use_high_res_features and high_res_feats is not None:
        f_s0, f_s1 = high_res_feats   # strides 4 and 8, d channels
        s0 = conv2d(f_s0, p.conv_s0)
        s1 = conv2d(f_s1, p.conv_s1)
        x = deconv2x(x, p.upscale0) + s1
        x = F.gelu(_ln(p.upscale_ln, x))
        x = F.gelu(deconv2x(x, p.upscale1) + s0)
    else:
        x = deconv2x(x, p.upscale0)
        x = F.gelu(_ln(p.upscale_ln, x))
        x = F.gelu(deconv2x(x, p.upscale1))

    hyper = torch.stack(
        [mlp(m, mask_toks[:, i], compute_dtype=compute_dtype)
         for i, m in enumerate(p.hyper_mlps)], dim=1)   # [B, nm, c2]
    g4 = 4 * g
    masks = torch.einsum("bnc,bhwc->bnhw", hyper, x.to(hyper.dtype)) \
        .reshape(b, cfg.num_mask_tokens, g4, g4)
    iou = mlp(p.iou_head, iou_tok, sigmoid_output=True,
              compute_dtype=compute_dtype)
    if cfg.pred_obj_scores:
        obj = mlp(p.pred_obj_score_head, hs[:, 0],
                  compute_dtype=compute_dtype)
    else:
        obj = 10.0 * torch.ones((b, 1), dtype=iou.dtype, device=iou.device)
    return masks, iou, mask_toks, obj


def stability_score(mask_logits, delta: float):
    area_u = (mask_logits > -delta).sum(dim=(-1, -2)).float()
    area_i = (mask_logits > delta).sum(dim=(-1, -2)).float()
    return torch.where(area_u > 0, area_i / area_u.clamp_min(1.0), 1.0)


def _take(x, idx):
    """x[b, idx[b]] over the slot axis 1."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def select_masks(cfg: SamHeadConfig, masks, iou, mask_toks,
                 multimask: bool):
    """Published SAM2 selection: multimask -> argmax-IoU over slots 1..3;
    single-mask -> slot 0 unless its stability < 0.98, then fall back to
    the best multimask slot (dynamic_multimask_via_stability). Returns
    (mask, token, score, slot)."""
    best = torch.argmax(iou[:, 1:], dim=-1) + 1
    m_best, t_best, s_best = (_take(masks, best), _take(mask_toks, best),
                              _take(iou, best))
    if multimask:
        return m_best, t_best, s_best, best
    stab = stability_score(masks[:, 0], cfg.stability_delta)
    keep = stab >= cfg.stability_thresh
    m = torch.where(keep[:, None, None], masks[:, 0], m_best)
    t = torch.where(keep[:, None], mask_toks[:, 0], t_best)
    s = torch.where(keep, iou[:, 0], s_best)
    return m, t, s, torch.where(keep, 0, best)
