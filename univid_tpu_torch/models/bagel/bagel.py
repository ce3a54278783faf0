"""BAGEL: the config, the parameters, the context updaters, text decode.

Counterpart of univid_tpu/models/bagel/bagel.py for the understanding path:
`BagelConfig`, the frozen 2-D sin-cos table, the flattened ViT position
ids, `Bagel` (every parameter of init_bagel), `init_gen_context`, the
causal text prefill `update_context_text`, the non-causal ViT append
`update_context_vit` (both bucketed by `n_valid`), greedy or sampled
`generate_text`, and the small `timestep_embedding`, `patchify_latent` and
`unpatchify_latent`. The fusion extractor reads the same module
(embed_tokens, connector, vit_pos_embed). `update_context_vae` and
`generate_image_latent` wait for the image-generation slice.

Every function takes a leading batch dimension B (the JAX callers vmap);
a context is {"cache": qwen2_mot KV cache, "rope": int32 [B] rope cursor}.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from ...core import nn as unn
from .qwen2_mot import (Qwen2MoTConfig, init_kv_cache, init_qwen2_mot,
                        lm_head_logits, qwen2_mot_forward)


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
