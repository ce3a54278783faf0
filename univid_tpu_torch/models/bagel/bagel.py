"""BAGEL: the config, the parameters, the context updaters, text decode
and image generation.

Counterpart of univid_tpu/models/bagel/bagel.py: `BagelConfig`, the frozen
2-D sin-cos table, the flattened ViT position ids, `Bagel` (every
parameter of init_bagel), `init_gen_context`, the causal text prefill
`update_context_text`, the non-causal ViT append `update_context_vit`
(both bucketed by `n_valid`), the VAE-latent append `update_context_vae`,
greedy or sampled `generate_text`, and `generate_image_latent`: Euler flow
matching inside the LLM over a shifted timestep ladder, with dual CFG (the
full context, the one without the last text, the one without the image),
the renorm toward the conditional velocity's norm, and TaylorSeer step
caching per CFG branch. The fusion extractor reads the same module
(embed_tokens, connector, vit_pos_embed).

Every function takes a leading batch dimension B (the JAX callers vmap);
a context is {"cache": qwen2_mot KV cache, "rope": int32 [B] rope cursor}.
The cache is updated in place, so two differences from the JAX package
follow: each flow-loop pass runs with `commit=False` (JAX throws the
returned cache away), and a caller that needs a context both as it is and
extended takes a `fork_context` first (JAX keeps the old value). The flow
loop's starting noise comes from a torch.Generator; `noise=` takes a given
draw (JAX's, in the tests).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from ...core import nn as unn
from ...ops.taylorseer import (TaylorSeerConfig, init_taylor_cache,
                               taylor_predict, taylor_update,
                               taylorseer_schedule)
from .qwen2_mot import (Qwen2MoTConfig, _expert_norm, init_kv_cache,
                        init_qwen2_mot, lm_head_logits, qwen2_mot_forward)


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


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """DiT-style [cos|sin] embedding of t [N] -> [N, dim], fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify_latent(latent: torch.Tensor, patch: int) -> torch.Tensor:
    """[H_lat, W_lat, c] -> [h*w, p*p*c], inner order (p, q, c); the exact
    inverse of unpatchify_latent."""
    hl, wl, c = latent.shape
    x = latent.reshape(hl // patch, patch, wl // patch, patch, c)
    return x.permute(0, 2, 1, 3, 4).reshape(-1, patch * patch * c)


def unpatchify_latent(latent_tokens: torch.Tensor, grid, patch: int,
                      channels: int) -> torch.Tensor:
    """[h*w, p*p*c] -> [H_lat, W_lat, c]."""
    h, w = grid
    x = latent_tokens.reshape(h, w, patch, patch, channels)
    return x.permute(0, 2, 1, 3, 4).reshape(h * patch, w * patch, channels)


class Bagel(nn.Module):
    """Every parameter of univid_tpu init_bagel, named as in its tree:
    time_embedder (256 -> d -> d), vae2llm, llm2vae (zero-init),
    latent_pos_embed and vit_pos_embed (fixed sin-cos tables), connector
    (vit_hidden -> d -> d) and llm (qwen2_mot.init_qwen2_mot). With `gen`
    the random leaves are drawn on `device` as the JAX init draws them
    (normal, std 0.02; zero biases); without, they are left empty to be
    loaded (convert.bagel_from_jax). `llm_layers=False` keeps only the
    LLM's embed_tokens, what the fusion extractor reads."""

    def __init__(self, cfg: BagelConfig, *, dtype=torch.float32,
                 device="cuda", gen: Optional[torch.Generator] = None,
                 llm_layers: bool = True):
        super().__init__()
        self.cfg = cfg
        d = cfg.llm.hidden_size
        kw = dict(init="normal", dtype=dtype, device=device, gen=gen)

        def table(side):
            return nn.Parameter(torch.as_tensor(sincos_2d_table(d, side)).to(
                device=device, dtype=dtype), requires_grad=False)

        self.time_embedder = unn.mlp((256, d, d), **kw)
        self.vae2llm = unn.Linear(cfg.patch_latent_dim, d, **kw)
        self.llm2vae = unn.Linear(d, cfg.patch_latent_dim, init="zeros",
                                  dtype=dtype, device=device)
        self.latent_pos_embed = table(cfg.max_latent_size)
        self.connector = unn.mlp((cfg.vit_hidden_size, d, d), **kw)
        self.vit_pos_embed = table(cfg.vit_max_num_patch_per_side)
        self.llm = init_qwen2_mot(gen, cfg.llm, dtype=dtype, device=device,
                                  layers=llm_layers)


def init_bagel(gen: torch.Generator, cfg: BagelConfig, *,
               dtype=torch.float32, device="cuda",
               llm_layers: bool = True) -> Bagel:
    return Bagel(cfg, dtype=dtype, device=device, gen=gen,
                 llm_layers=llm_layers)


def init_gen_context(cfg: BagelConfig, capacity: int = 4096, *,
                     batch: int = 1, dtype=torch.bfloat16, device="cuda"):
    """An empty context: the KV cache and the rope cursor of each row."""
    return {"cache": init_kv_cache(cfg.llm, capacity, batch=batch,
                                   dtype=dtype, device=device),
            "rope": torch.zeros((batch,), dtype=torch.int32, device=device)}


def fork_context(ctx):
    """A copy of ctx that later updates of either leave the other as it
    was: new cache buffers of the same capacity holding the rows up to the
    longest row's length (zeros past it), and copies of `len`, `len_host`
    and the rope cursor."""
    cache = ctx["cache"]
    live = max(cache["len_host"])
    out = {"len": cache["len"].clone(), "len_host": list(cache["len_host"])}
    for kv in ("k", "v"):
        out[kv] = torch.zeros_like(cache[kv])
        out[kv][:, :, :live] = cache[kv][:, :, :live]
    return {"cache": out, "rope": ctx["rope"].clone()}


def _advance(rope: torch.Tensor, n: Union[int, Sequence[int]]):
    if isinstance(n, int):
        return rope + n
    return rope + torch.tensor(list(n), dtype=torch.int32, device=rope.device)


# ---------------------------------------------------------------------------
# context updaters
# ---------------------------------------------------------------------------


def update_context_text(params: Bagel, cfg: BagelConfig, ctx,
                        text_ids: torch.Tensor, compute_dtype=torch.bfloat16,
                        n_valid=None):
    """Causal prefill of [bos] + text + [eos] ids, text_ids [B, L] int. With
    n_valid (an int, or one per row) the ids are a padded bucket and only
    the first n_valid rows advance the cache and the rope cursor."""
    b, l = text_ids.shape
    x = params.llm.embed_tokens[text_ids].to(compute_dtype)
    pos = ctx["rope"][:, None] + torch.arange(l, device=x.device)[None]
    _, cache = qwen2_mot_forward(
        params.llm, cfg.llm, x, pos, ctx["cache"], mode="und",
        q_valid=n_valid, is_causal=True, compute_dtype=compute_dtype,
        final_norm=False)
    return {"cache": cache,
            "rope": _advance(ctx["rope"], l if n_valid is None else n_valid)}


def update_context_vit(params: Bagel, cfg: BagelConfig, ctx,
                       vit_embeds: torch.Tensor, vit_pos_ids: torch.Tensor,
                       compute_dtype=torch.bfloat16, n_valid=None):
    """Append [start_of_image] + connector(vit_embeds) + pos embed +
    [end_of_image] non-causally, every row at the context's rope position.
    vit_embeds [B, N, vit_d] from SigLIP, vit_pos_ids [B, N]. With n_valid
    (an int, or one per row) the embeds are a padded bucket: end_of_image
    goes to row n_valid + 1 and only n_valid + 2 rows advance the cache."""
    cd = compute_dtype
    b, n, _ = vit_embeds.shape
    emb = params.llm.embed_tokens
    conn = params.connector
    tok = unn.linear(conn.fc0, vit_embeds.to(cd), compute_dtype=cd)
    tok = unn.gelu_tanh(tok)
    tok = unn.linear(conn.fc1, tok, compute_dtype=cd)
    tok = tok + params.vit_pos_embed[vit_pos_ids].to(cd)

    start = emb[cfg.start_of_image].to(cd).expand(b, 1, -1)
    end = emb[cfg.end_of_image].to(cd).expand(b, 1, -1)
    seq = torch.cat([start, tok, end], dim=1)
    q_valid = None
    if n_valid is not None:
        rows = [int(n_valid)] * b if isinstance(n_valid, int) \
            else [int(r) for r in n_valid]
        seq[torch.arange(b, device=seq.device),
            torch.tensor(rows, device=seq.device) + 1] = end[:, 0]
        q_valid = [r + 2 for r in rows]
    pos = ctx["rope"][:, None].expand(b, n + 2)
    _, cache = qwen2_mot_forward(
        params.llm, cfg.llm, seq, pos, ctx["cache"], mode="und",
        q_valid=q_valid, is_causal=False, compute_dtype=cd,
        final_norm=False)
    return {"cache": cache, "rope": ctx["rope"] + 1}


def _latent_rows(params: Bagel, cfg: BagelConfig, tokens: torch.Tensor,
                 t: float, pos_rows: torch.Tensor, compute_dtype):
    """[start_of_image] + (vae2llm(tokens) + t_emb(t) + 2-D latent pos
    embed) + [end_of_image] -> [B, n + 2, hidden] in compute_dtype; the
    latent rows are computed in fp32. tokens [B, n, p*p*c]."""
    b = tokens.shape[0]
    dev = tokens.device
    f32 = torch.float32
    te = params.time_embedder
    t_emb = unn.linear(te.fc1, unn.silu(unn.linear(
        te.fc0, timestep_embedding(torch.tensor([t], dtype=f32, device=dev),
                                   256), compute_dtype=f32)),
        compute_dtype=f32)[0]
    x_tok = unn.linear(params.vae2llm, tokens.float(), compute_dtype=f32)
    x_tok = x_tok + t_emb + params.latent_pos_embed[pos_rows].float()
    emb = params.llm.embed_tokens
    cd = compute_dtype
    return torch.cat([emb[cfg.start_of_image].to(cd).expand(b, 1, -1),
                      x_tok.to(cd),
                      emb[cfg.end_of_image].to(cd).expand(b, 1, -1)], dim=1)


def _latent_grid(cfg: BagelConfig, hh: int, ww: int, device):
    """(position-table rows of an hh x ww latent grid, the und rows: the
    start and end tokens around its hh * ww rows)."""
    pos_rows = torch.as_tensor(flattened_position_ids(
        hh, ww, cfg.max_latent_size), device=device)
    und = torch.tensor([0, hh * ww + 1], dtype=torch.long, device=device)
    return pos_rows, und


def update_context_vae(params: Bagel, cfg: BagelConfig, ctx,
                       latent: torch.Tensor, timestep: float = 0.0,
                       compute_dtype=torch.bfloat16):
    """Append the VAE-latent view of a context image non-causally, every
    row at the context's rope position (which then advances by 1): the
    patchified latent through vae2llm plus the timestep embedding and the
    2-D latent position embedding (fp32) on the gen expert, the start and
    end tokens on the und expert. latent [B, H_lat, W_lat, latent_channel]
    (an image_vae_encode output). The second tower of an editing context,
    before the ViT rows."""
    p = cfg.latent_patch_size
    b, hl, wl, _ = latent.shape
    hh, ww = hl // p, wl // p
    tokens = torch.stack([patchify_latent(latent[i].float(), p)
                          for i in range(b)])
    pos_rows, und = _latent_grid(cfg, hh, ww, latent.device)
    seq = _latent_rows(params, cfg, tokens, timestep, pos_rows,
                       compute_dtype)
    pos = ctx["rope"][:, None].expand(b, seq.shape[1])
    _, cache = qwen2_mot_forward(
        params.llm, cfg.llm, seq, pos, ctx["cache"], mode="gen",
        und_rows=und, is_causal=False, compute_dtype=compute_dtype,
        final_norm=False)
    return {"cache": cache, "rope": ctx["rope"] + 1}


# ---------------------------------------------------------------------------
# text generation
# ---------------------------------------------------------------------------


def _gumbel_argmax(logits: torch.Tensor, gen: torch.Generator):
    """A categorical draw per row by the Gumbel-max trick (what
    jax.random.categorical does; the bits differ from JAX's)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(torch.finfo(torch.float32).tiny, 1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def generate_text(params: Bagel, cfg: BagelConfig, ctx, max_length: int,
                  do_sample: bool = False, temperature: float = 1.0,
                  end_token_id: Optional[int] = None,
                  rng: Optional[torch.Generator] = None,
                  compute_dtype=torch.bfloat16):
    """Greedy or temperature decode from [bos], max_length steps, every
    row of the batch together (a finished row keeps decoding and emits
    end_token_id). Returns (tokens [B, max_length] int32, lengths [B]
    int32), on the device: the loop never waits for the card. rng: a
    torch.Generator on the context's device (seed 0 when None); sampled
    tokens are deterministic per seed but are not JAX's."""
    end_id = end_token_id if end_token_id is not None else cfg.eos_token_id
    emb = params.llm.embed_tokens
    rope = ctx["rope"]
    cache = ctx["cache"]
    b = rope.shape[0]
    dev = rope.device
    if do_sample and rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    cur = torch.full((b,), cfg.bos_token_id, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = []
    for _ in range(max_length):
        x = emb[cur][:, None].to(compute_dtype)
        h, cache = qwen2_mot_forward(
            params.llm, cfg.llm, x, rope[:, None], cache, mode="und",
            is_causal=True, compute_dtype=compute_dtype, final_norm=True)
        logits = lm_head_logits(params.llm, cfg.llm, h,
                                compute_dtype=compute_dtype)[:, 0]
        if do_sample:
            nxt = _gumbel_argmax(logits / temperature, rng)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, end_id), nxt)
        finished = finished | (nxt == end_id)
        out.append(nxt)
        rope = rope + 1
        cur = nxt
    tokens = torch.stack(out, dim=1).to(torch.int32)
    hit = tokens == end_id
    length = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1,
                         torch.full((b,), max_length, device=dev))
    return tokens, length.to(torch.int32)


# ---------------------------------------------------------------------------
# image generation (Euler flow with dual CFG + renorm)
# ---------------------------------------------------------------------------


def _flow_hidden(params: Bagel, cfg: BagelConfig, x_t: torch.Tensor,
                 t: float, und_rows: torch.Tensor, pos_rows: torch.Tensor,
                 ctx, compute_dtype):
    """One gen-mode LM pass over ctx, not committed -> the last layer's
    hidden states before the final norm [B, n + 2, hidden]. Split from the
    norm + llm2vae tail so that TaylorSeer caches the feature the reference
    hooks."""
    seq = _latent_rows(params, cfg, x_t, t, pos_rows, compute_dtype)
    pos = ctx["rope"][:, None].expand(seq.shape[0], seq.shape[1])
    h, _ = qwen2_mot_forward(
        params.llm, cfg.llm, seq, pos, ctx["cache"], mode="gen",
        und_rows=und_rows, is_causal=False, compute_dtype=compute_dtype,
        final_norm=False, commit=False)
    return h


def _flow_post(params: Bagel, cfg: BagelConfig, h: torch.Tensor,
               und_rows: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The final (dual) norm and llm2vae in fp32 -> the velocity on the
    latent rows [B, n, p*p*c]."""
    llm = params.llm
    h = h.to(compute_dtype)
    if cfg.llm.moe:
        h = _expert_norm(llm.norm, llm.norm_gen, h, und_rows,
                         cfg.llm.rms_norm_eps)
    else:
        h = unn.rms_norm(h, llm.norm.to(h.dtype), eps=cfg.llm.rms_norm_eps)
    v = unn.linear(params.llm2vae, h.float(), compute_dtype=torch.float32)
    return v[:, 1:-1]


def _flow_velocity(params: Bagel, cfg: BagelConfig, x_t, t, und_rows,
                   pos_rows, ctx, compute_dtype) -> torch.Tensor:
    """One uncommitted LM pass -> the velocity on the latent rows."""
    h = _flow_hidden(params, cfg, x_t, t, und_rows, pos_rows, ctx,
                     compute_dtype)
    return _flow_post(params, cfg, h, und_rows, compute_dtype)


def _f32(x: float) -> float:
    """x rounded to fp32, as the JAX loop's traced scalars are."""
    return float(np.float32(x))


def generate_image_latent(
    params: Bagel, cfg: BagelConfig, ctx, image_shape, *,
    cfg_text_ctx=None, cfg_img_ctx=None, num_timesteps: int = 50,
    timestep_shift: float = 3.0, cfg_text_scale: float = 4.0,
    cfg_img_scale: float = 1.5, cfg_interval=(0.4, 1.0),
    cfg_renorm_min: float = 0.0, cfg_renorm_type: str = "global",
    rng: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None, compute_dtype=torch.bfloat16,
    enable_taylorseer: bool = False, taylorseer_cfg=None):
    """Denoise a latent of image_shape (H, W pixels) conditioned on ctx.
    Returns (the patched latent [B, h*w, p*p*c] fp32, (h, w)).

    Every step runs the branches on the same latent: v over ctx, and, when
    cfg_text_ctx is given and cfg_text_scale > 1, v_text over it and
    (cfg_img_ctx, cfg_img_scale > 1) v_img; v_ = v_text + s_t (v - v_text),
    then v_img + s_i (v_ - v_img), renormed by clip(|v| / (|v_| + 1e-8),
    cfg_renorm_min, 1) over all of a row's elements ('global') or over the
    last axis ('channel', 'text_channel'); then x -= v dt in fp32. Outside
    cfg_interval the scales are 1: every branch still runs. The contexts
    are left as they were (uncommitted passes). noise [B, h*w, p*p*c]: the
    starting latent; else drawn from rng (seed 0 when None) on ctx's
    device. With enable_taylorseer, the host's schedule decides which steps
    run the LM: a Taylor step extrapolates each branch's hidden states
    from its own cache."""
    dev = ctx["rope"].device
    b = ctx["rope"].shape[0]
    hh = image_shape[0] // cfg.latent_downsample
    ww = image_shape[1] // cfg.latent_downsample
    n_tok = hh * ww
    pos_rows, und = _latent_grid(cfg, hh, ww, dev)
    if noise is None:
        if rng is None:
            rng = torch.Generator(device=dev).manual_seed(0)
        noise = torch.randn((b, n_tok, cfg.patch_latent_dim), generator=rng,
                            device=dev)
    x = noise.to(device=dev, dtype=torch.float32).reshape(
        b, n_tok, cfg.patch_latent_dim)

    # the shifted timestep ladder and the cfg gate of each step
    ts = np.linspace(1.0, 0.0, num_timesteps)
    ts = timestep_shift * ts / (1 + (timestep_shift - 1) * ts)
    dts = ts[:-1] - ts[1:]
    gates = [float((t > cfg_interval[0]) and (t <= cfg_interval[1]))
             for t in ts[:-1]]

    branches = [ctx]
    text_cfg = cfg_text_ctx is not None and cfg_text_scale > 1.0
    img_cfg = text_cfg and cfg_img_ctx is not None and cfg_img_scale > 1.0
    if text_cfg:
        branches.append(cfg_text_ctx)
    if img_cfg:
        branches.append(cfg_img_ctx)

    if enable_taylorseer:
        ts_cfg = taylorseer_cfg or TaylorSeerConfig()
        sched = taylorseer_schedule(num_timesteps - 1, ts_cfg)
        feat = (b, n_tok + 2, cfg.llm.hidden_size)
        caches = [init_taylor_cache(feat, ts_cfg.max_order, device=dev)
                  for _ in branches]

    def velocities(x_t, t, step):
        out = []
        for i, c in enumerate(branches):
            if enable_taylorseer and not sched["is_full"][step]:
                h = taylor_predict(caches[i], float(sched["x"][step]),
                                   int(sched["n_stored"][step]))
            else:
                h = _flow_hidden(params, cfg, x_t, t, und, pos_rows, c,
                                 compute_dtype)
                if enable_taylorseer:
                    caches[i] = taylor_update(caches[i], h,
                                              float(sched["dd"][step]),
                                              int(sched["n_upd"][step]))
            out.append(_flow_post(params, cfg, h, und, compute_dtype))
        return out

    def norm(v):
        if cfg_renorm_type == "global":
            return torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True)
        # "channel" / "text_channel"
        return torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    for step in range(num_timesteps - 1):
        t, dt, g = _f32(ts[step]), _f32(dts[step]), gates[step]
        vs = velocities(x, t, step)
        v = vs[0]
        if text_cfg:
            text_scale = _f32(1.0 + g * _f32(cfg_text_scale - 1.0))
            v_ = vs[1] + text_scale * (v - vs[1])
            if img_cfg:
                img_scale = _f32(1.0 + g * _f32(cfg_img_scale - 1.0))
                v_ = vs[2] + img_scale * (v_ - vs[2])
            scale = (norm(v) / (norm(v_) + 1e-8)).clamp(cfg_renorm_min, 1.0)
            v = v_ * scale
        x = x - v * dt
    return x, (hh, ww)
