"""SigLIP2-NaFlex dual tower: the reference's default frame-ranking model
(counterpart of univid_tpu/reflection/naflex.py).

The reference ranks keyframes with `google/siglip2-base-patch16-naflex`
through its AutoProcessor: an image is resized aspect-preserving so that
its patch count fits a budget (256), patchified into its own (h_p, w_p)
grid, and the learned 16x16 position-embedding grid is resized
(antialiased bilinear) to that grid.

  * Host (numpy, copies of the JAX package's): the max-patches resize rule
    (HF `get_image_size_for_max_num_patches`'s binary search), PIL BILINEAR
    resize, patchify, pad to the budget, and the antialiased bilinear
    position-embedding resize (the triangle filter of torch's
    `_upsample_bilinear2d_aa`), once per grid shape.
  * Device: the patch linear, the position add, the pre-LN encoder with
    suffix-padded keys masked by kv_len, and the attention-pooling head
    over the real patches only. Head dim 64: attention takes the
    dispatcher's reference route, as in the JAX package.

`Siglip2NaflexScorer` has the scorer surface (`emb_imgs`, `emb_text`,
`rank_frames`, `from_checkpoint`); a batch of frames runs on one device.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core import nn as unn
from ..kernels.attention import attention
from ..parallel.data_parallel import dp_map

# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NaflexVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    patch_size: int = 16
    num_patches: int = 256       # learned pos grid = sqrt(num_patches)^2
    max_num_patches: int = 256   # processor budget / padded seq len
    num_channels: int = 3
    eps: float = 1e-6

    @property
    def num_patches_per_side(self) -> int:
        return int(math.isqrt(self.num_patches))


@dataclass(frozen=True)
class NaflexTextConfig:
    vocab_size: int = 256000     # Gemma tokenizer
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 64
    proj_dim: int = 768          # text head output == vision hidden
    eps: float = 1e-6


# ---------------------------------------------------------------------------
# host side: the processor (image_processing_siglip2.py)
# ---------------------------------------------------------------------------


def get_image_size_for_max_num_patches(image_height: int, image_width: int,
                                       patch_size: int, max_num_patches: int,
                                       eps: float = 1e-5
                                       ) -> Tuple[int, int]:
    """HF's binary search: the largest aspect-preserving scale whose
    ceil-to-patch dimensions fit the patch budget."""

    def scaled(scale: float, size: int) -> int:
        s = math.ceil(size * scale / patch_size) * patch_size
        return int(max(patch_size, s))

    lo, hi = eps / 10, 100.0
    while (hi - lo) >= eps:
        mid = (lo + hi) / 2
        th, tw = scaled(mid, image_height), scaled(mid, image_width)
        if (th / patch_size) * (tw / patch_size) <= max_num_patches:
            lo = mid
        else:
            hi = mid
    return scaled(lo, image_height), scaled(lo, image_width)


def _triangle_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] row-stochastic matrix of the antialiased bilinear
    resample along one axis (align_corners=False; torch
    `_upsample_bilinear2d_aa`, PIL's BILINEAR): a triangle filter of
    half-width max(1, n_in/n_out) centred at (i + 0.5) * n_in/n_out,
    clipped to bounds and normalised."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = scale * (i + 0.5)
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        js = np.arange(xmin, xmax)
        ws = np.maximum(0.0, 1.0 - np.abs(js + 0.5 - center) / support)
        s = ws.sum()
        if s > 0:
            w[i, xmin:xmax] = ws / s
        else:
            w[i, min(max(int(center), 0), n_in - 1)] = 1.0
    return w


def resize_positional_embeddings_np(pos_grid: np.ndarray, h: int, w: int,
                                    max_length: int) -> np.ndarray:
    """[S, S, d] learned grid -> [max_length, d]: antialiased bilinear
    resize to (h, w), flattened row-major; positions past h*w take the
    resized grid's row 0 (as HF Siglip2VisionEmbeddings pads)."""
    s_h, s_w, d = pos_grid.shape
    g = pos_grid.astype(np.float64)
    g = np.einsum("oi,iwd->owd", _triangle_resize_weights(s_h, h), g)
    g = np.einsum("oi,hid->hod", _triangle_resize_weights(s_w, w), g)
    flat = g.reshape(h * w, d)
    out = np.empty((max_length, d), np.float64)
    out[: h * w] = flat
    out[h * w:] = flat[0]
    return out.astype(np.float32)


def naflex_preprocess(frames: List[np.ndarray], patch_size: int = 16,
                      max_num_patches: int = 256
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HF Siglip2ImageProcessor's preprocessing on the host.

    frames: [H, W, 3] uint8 (or float in [-1, 1], mapped back to uint8 for
    the PIL resample). Returns (pixel patches uint8 [B, max_p, p*p*3],
    spatial shapes int32 [B, 2], kv_len int32 [B]); the rescale and
    normalise, x / 127.5 - 1, run on the device."""
    pv, shapes, lens = [], [], []
    from PIL import Image
    for f in frames:
        f = np.asarray(f)
        if f.dtype != np.uint8:
            f = np.clip((np.asarray(f, np.float32) + 1.0) * 127.5,
                        0, 255).astype(np.uint8)
        if f.ndim == 2:
            f = np.stack([f] * 3, axis=-1)
        h0, w0 = f.shape[:2]
        th, tw = get_image_size_for_max_num_patches(
            h0, w0, patch_size, max_num_patches)
        if (th, tw) != (h0, w0):
            f = np.asarray(Image.fromarray(f).resize((tw, th),
                                                     Image.BILINEAR))
        nh, nw = th // patch_size, tw // patch_size
        p = f.reshape(nh, patch_size, nw, patch_size, 3)
        p = p.transpose(0, 2, 1, 3, 4).reshape(nh * nw, -1)
        n = p.shape[0]
        if n < max_num_patches:
            p = np.pad(p, ((0, max_num_patches - n), (0, 0)))
        pv.append(p)
        shapes.append((nh, nw))
        lens.append(n)
    return (np.stack(pv), np.asarray(shapes, np.int32),
            np.asarray(lens, np.int32))


# ---------------------------------------------------------------------------
# parameters (names follow init_naflex_vision / init_naflex_text's trees)
# ---------------------------------------------------------------------------


def _ln(d, dtype, device):
    return unn.Node(w=unn.param((d,), dtype, device, init="ones"),
                    b=unn.param((d,), dtype, device, init="zeros"))


def _encoder_layers(d, inter, n_layers, dtype, device, gen):
    kw = dict(init="normal", dtype=dtype, device=device, gen=gen)
    return nn.ModuleList([
        unn.Node(ln1=_ln(d, dtype, device),
                 attn=unn.Node(**{p: unn.Linear(d, d, **kw)
                                  for p in ("q", "k", "v", "o")}),
                 ln2=_ln(d, dtype, device),
                 mlp=unn.mlp((d, inter, d), **kw))
        for _ in range(n_layers)])


class NaflexVision(nn.Module):
    """The vision tower: patch_embed, pos_embed [num_patches, d], layers,
    post_ln and the attention-pooling head (probe, q / k / v / o, ln,
    mlp). With `gen`, drawn as init_naflex_vision draws (linears normal
    0.02 with zero biases, pos_embed normal 0.02, the probe normal 1);
    without, left empty to be loaded."""

    def __init__(self, cfg: NaflexVisionConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(init="normal", dtype=dtype, device=device, gen=gen)
        self.patch_embed = unn.Linear(
            cfg.num_channels * cfg.patch_size ** 2, d, **kw)
        self.pos_embed = unn.param((cfg.num_patches, d), dtype, device, gen,
                                   "normal", std=0.02)
        self.layers = _encoder_layers(d, cfg.intermediate_size,
                                      cfg.num_layers, dtype, device, gen)
        self.post_ln = _ln(d, dtype, device)
        self.head = unn.Node(
            probe=unn.param((1, 1, d), dtype, device, gen, "normal"),
            **{p: unn.Linear(d, d, **kw) for p in ("q", "k", "v", "o")},
            ln=_ln(d, dtype, device),
            mlp=unn.mlp((d, cfg.intermediate_size, d), **kw))


class NaflexText(nn.Module):
    """The text tower: token_embed, pos_embed, layers, final_ln and the
    pooling head (a linear with bias, HF Siglip2TextTransformer.head)."""

    def __init__(self, cfg: NaflexTextConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_size
        self.token_embed = unn.param((cfg.vocab_size, d), dtype, device, gen,
                                     "normal", std=0.02)
        self.pos_embed = unn.param((cfg.max_len, d), dtype, device, gen,
                                   "normal", std=0.02)
        self.layers = _encoder_layers(d, cfg.intermediate_size,
                                      cfg.num_layers, dtype, device, gen)
        self.final_ln = _ln(d, dtype, device)
        self.head = unn.Linear(d, cfg.proj_dim, init="normal", dtype=dtype,
                               device=device, gen=gen)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _norm(x, p, eps):
    return unn.layer_norm(x, weight=p.w.to(x.dtype), bias=p.b.to(x.dtype),
                          eps=eps)


def _encoder(x, layers, n_heads: int, eps: float, compute_dtype,
             kv_len: Optional[torch.Tensor]):
    """Pre-LN encoder; kv_len [B] masks suffix-padded keys (queries run
    unmasked, the HF additive mask's semantics: padded query rows are
    dropped by the pooling)."""
    b, l, d = x.shape
    hd = d // n_heads
    cd = compute_dtype
    for layer in layers:
        y = _norm(x, layer.ln1, eps)
        a = layer.attn
        q, k, v = (unn.linear(a[p], y, compute_dtype=cd)
                   .reshape(b, l, n_heads, hd) for p in ("q", "k", "v"))
        o = attention(q, k, v, kv_len=kv_len)
        x = x + unn.linear(a.o, o.reshape(b, l, d), compute_dtype=cd)
        y = _norm(x, layer.ln2, eps)
        y = unn.gelu_tanh(unn.linear(layer.mlp.fc0, y, compute_dtype=cd))
        x = x + unn.linear(layer.mlp.fc1, y, compute_dtype=cd)
    return x


def _map_head(p, feats, n_heads: int, eps: float, compute_dtype,
              kv_len: Optional[torch.Tensor]):
    """HF Siglip2MultiheadAttentionPoolingHead with key masking: the
    learned probe cross-attends the real patches, then layer norm and an
    MLP residual. feats [B, N, d] -> [B, d]."""
    b, n, d = feats.shape
    hd = d // n_heads
    cd = compute_dtype
    f = feats.to(cd)
    probe = p.probe.to(cd).expand(b, 1, d)
    q = unn.linear(p.q, probe, compute_dtype=cd)
    k = unn.linear(p.k, f, compute_dtype=cd)
    v = unn.linear(p.v, f, compute_dtype=cd)
    o = attention(q.reshape(b, 1, n_heads, hd), k.reshape(b, n, n_heads, hd),
                  v.reshape(b, n, n_heads, hd), kv_len=kv_len)
    h = unn.linear(p.o, o.reshape(b, 1, d), compute_dtype=cd)
    y = unn.layer_norm(h, weight=p.ln.w.to(cd), bias=p.ln.b.to(cd), eps=eps)
    y = unn.gelu_tanh(unn.linear(p.mlp.fc0, y, compute_dtype=cd))
    y = unn.linear(p.mlp.fc1, y, compute_dtype=cd)
    return (h + y)[:, 0]


def naflex_vision_forward(params: NaflexVision, cfg: NaflexVisionConfig,
                          pixel_patches: torch.Tensor,  # [B, P, p*p*3]
                          pos_embeds: torch.Tensor,     # [B, P, d] resized
                          kv_len: torch.Tensor,         # [B] real patches
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Pooled image features [B, d] fp32 (HF get_image_features,
    unnormalised); uint8 patches are mapped to [-1, 1] on the device."""
    x = pixel_patches
    if not x.is_floating_point():
        x = x.float() / 127.5 - 1.0
    x = unn.linear(params.patch_embed, x.to(compute_dtype),
                   compute_dtype=compute_dtype)
    x = x + pos_embeds.to(x.dtype)
    x = _encoder(x, params.layers, cfg.num_heads, cfg.eps, compute_dtype,
                 kv_len)
    x = _norm(x, params.post_ln, cfg.eps)
    return _map_head(params.head, x, cfg.num_heads, cfg.eps, compute_dtype,
                     kv_len).float()


def naflex_text_forward(params: NaflexText, cfg: NaflexTextConfig,
                        ids: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """ids [B, L] (right-padded to max_len) -> text features [B, proj] fp32
    (HF get_text_features, unnormalised): the tokenizer mask as a key
    mask, the last position pooled (a pad token too, as HF pools index
    -1), then the head linear."""
    b, l = ids.shape
    x = (params.token_embed[ids] + params.pos_embed[None, :l]).to(
        compute_dtype)
    x = _encoder(x, params.layers, cfg.num_heads, cfg.eps, compute_dtype,
                 kv_len)
    x = _norm(x, params.final_ln, cfg.eps)
    return unn.linear(params.head, x[:, -1],
                      compute_dtype=compute_dtype).float()


# ---------------------------------------------------------------------------
# HF state dict converter (Siglip2Model layout)
# ---------------------------------------------------------------------------


def convert_naflex_checkpoint(sd, dtype=torch.float32,
                              vision_heads: Optional[int] = None,
                              text_heads: Optional[int] = None, *,
                              device="cuda"):
    """HF Siglip2Model state dict -> (NaflexVision, vision cfg, NaflexText,
    text cfg) on `device`, every leaf in `dtype` but the position grid
    (fp32: it is resized on the host). The NaFlex patch embedding is a
    linear over (h, w, c)-flattened patches, so its weight is taken as it
    is. Head counts come from config.json (from_checkpoint) or the
    arguments; shapes cannot show them."""
    from ..core.checkpoint import (_assemble, _encoder_entries, _Entries,
                                   _map_head_entries)

    v_hidden = sd["vision_model.embeddings.patch_embedding.bias"].shape[0]
    pd = sd["vision_model.embeddings.patch_embedding.weight"].shape[1]
    patch = int(math.isqrt(pd // 3))

    def n_layers(prefix):
        n = 0
        while f"{prefix}.encoder.layers.{n}.layer_norm1.weight" in sd:
            n += 1
        return n

    v_layers = n_layers("vision_model")
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    vision_cfg = NaflexVisionConfig(
        hidden_size=v_hidden,
        intermediate_size=sd[
            "vision_model.encoder.layers.0.mlp.fc1.bias"].shape[0],
        num_layers=v_layers, num_heads=vision_heads or (
            12 if v_hidden % 12 == 0 and v_hidden <= 768 else 16),
        patch_size=patch, num_patches=n_pos, max_num_patches=n_pos)
    e = _Entries(sd, device)
    e.lin("patch_embed", "vision_model.embeddings.patch_embedding", dtype)
    e.put("pos_embed", "vision_model.embeddings.position_embedding.weight",
          torch.float32)
    _encoder_entries(e, v_layers, dtype, "vision_model")
    e.norm("post_ln", "vision_model.post_layernorm", dtype)
    _map_head_entries(e, dtype, "vision_model.head", "head.")
    vision = _assemble(NaflexVision(vision_cfg, dtype=dtype, device="meta"),
                       e)

    t_layers = n_layers("text_model")
    t_hidden = sd["text_model.embeddings.token_embedding.weight"].shape[1]
    text_cfg = NaflexTextConfig(
        vocab_size=sd["text_model.embeddings.token_embedding.weight"
                      ].shape[0],
        hidden_size=t_hidden,
        intermediate_size=sd["text_model.encoder.layers.0.mlp.fc1.bias"
                             ].shape[0],
        num_layers=t_layers,
        num_heads=text_heads or (
            12 if t_hidden % 12 == 0 and t_hidden <= 768 else 16),
        max_len=sd["text_model.embeddings.position_embedding.weight"
                   ].shape[0],
        proj_dim=sd["text_model.head.bias"].shape[0])
    e = _Entries(sd, device)
    e.put("token_embed", "text_model.embeddings.token_embedding.weight",
          dtype)
    e.put("pos_embed", "text_model.embeddings.position_embedding.weight",
          dtype)
    _encoder_entries(e, t_layers, dtype, "text_model")
    e.norm("final_ln", "text_model.final_layer_norm", dtype)
    e.lin("head", "text_model.head", dtype)
    text = _assemble(NaflexText(text_cfg, dtype=dtype, device="meta"), e)
    return vision, vision_cfg, text, text_cfg


# ---------------------------------------------------------------------------
# scorer
# ---------------------------------------------------------------------------


class Siglip2NaflexScorer:
    """The scorer surface (emb_text / emb_imgs / rank_frames) over the
    NaFlex dual tower. Without towers it draws the random-init default
    from `seed` on `device`. compute_dtype: bf16 on a card, fp32 on the
    CPU unless given; embeddings are L2-normalised in fp32 either way.
    mesh: a DeviceMesh whose dp ranks share each batch of frames
    (`parallel.data_parallel.dp_map`, as Siglip2Scorer)."""

    def __init__(self, vision_params: Optional[NaflexVision] = None,
                 vision_cfg: Optional[NaflexVisionConfig] = None,
                 text_params: Optional[NaflexText] = None,
                 text_cfg: Optional[NaflexTextConfig] = None,
                 tokenizer=None, seed: int = 0, compute_dtype=None,
                 device="cuda", mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" \
                else torch.float32
        self.compute_dtype = compute_dtype
        self.vision_cfg = vision_cfg or NaflexVisionConfig()
        self.text_cfg = text_cfg or NaflexTextConfig(
            vocab_size=getattr(tokenizer, "vocab_size", 256000) or 256000)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.vision_params = vision_params if vision_params is not None \
            else NaflexVision(self.vision_cfg, device=self.device, gen=gen)
        self.text_params = text_params if text_params is not None \
            else NaflexText(self.text_cfg, device=self.device, gen=gen)
        self.tokenizer = tokenizer
        self._pos_cache = {}

    @classmethod
    def from_checkpoint(cls, path: str, tokenizer=None,
                        dtype=torch.float32, *, device="cuda",
                        compute_dtype=None, mesh=None
                        ) -> "Siglip2NaflexScorer":
        """A save_pretrained Siglip2Model dir (config.json + safetensors)
        or a state-dict file; without `tokenizer`, the checkpoint's own
        (utils.tokenizers.load_tokenizer: RuntimeError when unavailable,
        raised before the weights reach the device)."""
        from ..core.checkpoint import load_state_dict

        sd = load_state_dict(path)
        if tokenizer is None:
            from ..utils.tokenizers import load_tokenizer
            tokenizer = load_tokenizer(path, seq_len=sd[
                "text_model.embeddings.position_embedding.weight"].shape[0])
        vh = th = None
        cfg_dir = path if os.path.isdir(path) else os.path.dirname(path)
        cfg_json = os.path.join(cfg_dir, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                hf = json.load(f)
            vh = hf.get("vision_config", {}).get("num_attention_heads")
            th = hf.get("text_config", {}).get("num_attention_heads")
        vision, vcfg, text, tcfg = convert_naflex_checkpoint(
            sd, dtype, vision_heads=vh, text_heads=th, device=device)
        return cls(vision_params=vision, vision_cfg=vcfg, text_params=text,
                   text_cfg=tcfg, tokenizer=tokenizer,
                   compute_dtype=compute_dtype, device=device, mesh=mesh)

    # ------------------------------------------------------------------
    def _pos_for_shape(self, nh: int, nw: int) -> np.ndarray:
        key = (nh, nw)
        if key not in self._pos_cache:
            cfg = self.vision_cfg
            s = cfg.num_patches_per_side
            grid = self.vision_params.pos_embed.detach().float().cpu() \
                .numpy().reshape(s, s, cfg.hidden_size)
            self._pos_cache[key] = resize_positional_embeddings_np(
                grid, nh, nw, cfg.max_num_patches)
        return self._pos_cache[key]

    @torch.no_grad()
    def emb_imgs(self, frames: List[np.ndarray], bs: int = 64
                 ) -> np.ndarray:
        """frames: [H, W, 3] uint8 / float arrays -> [N, d] fp32 numpy,
        L2-normalised."""
        if not frames:
            return np.zeros((0, self.vision_cfg.hidden_size), np.float32)
        cfg = self.vision_cfg
        patches, shapes, lens = naflex_preprocess(
            frames, cfg.patch_size, cfg.max_num_patches)
        pos = np.stack([self._pos_for_shape(nh, nw) for nh, nw in shapes])

        def embed(px, pe, kl):
            return naflex_vision_forward(
                self.vision_params, cfg, *(torch.as_tensor(a).to(self.device)
                                           for a in (px, pe, kl)),
                compute_dtype=self.compute_dtype)

        outs = []
        for i in range(0, len(frames), bs):
            share = (patches[i:i + bs], pos[i:i + bs], lens[i:i + bs])
            v = (embed(*share) if self.mesh is None
                 else dp_map(self.mesh, embed, *share))
            outs.append(v.cpu().numpy())
        v = np.concatenate(outs, axis=0)
        return v / np.linalg.norm(v, axis=-1, keepdims=True).clip(1e-12)

    @torch.no_grad()
    def emb_text(self, q: str) -> np.ndarray:
        """-> [1, proj] fp32 numpy, L2-normalised. Ids at or past the vocab
        wrap by `% vocab_size`, as the JAX scorer's do."""
        if self.tokenizer is None:
            raise ValueError("the scorer needs a tokenizer")
        ids = self.tokenizer.encode(q)[: self.text_cfg.max_len]
        n_real = len(ids)
        ids = ids + [0] * (self.text_cfg.max_len - n_real)
        ids = torch.as_tensor([ids], device=self.device) \
            % self.text_cfg.vocab_size
        t = naflex_text_forward(
            self.text_params, self.text_cfg, ids,
            kv_len=torch.as_tensor([n_real], dtype=torch.int32,
                                   device=self.device),
            compute_dtype=self.compute_dtype).cpu().numpy()
        return t / np.linalg.norm(t, axis=-1, keepdims=True).clip(1e-12)

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
