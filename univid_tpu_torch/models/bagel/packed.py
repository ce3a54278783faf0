"""BAGEL packed-sequence training forward.

Counterpart of univid_tpu/models/bagel/packed.py (reference Bagel.forward,
models/BAGEL/modeling/bagel/bagel.py:101-229): several samples packed into
one flat token sequence; text tokens embedded by the LM, ViT images encoded
by NaViT SigLIP and the connector, VAE latents noised by per-split flow
timesteps and bridged by vae2llm; the LM runs once over the pack with the
mixed causal / full / noise mask (data/data_utils.py:13-41) as
pack_mask_codes codes on the flash kernels' packed mode, with MoT expert
routing (und = text and ViT rows, gen = the rest); the outputs are the
velocity MSE terms of the noised VAE rows and the next-token CE terms of
the labelled text rows. Gradients come from autograd over the caller's
loss: the attention's backward runs the packed dq and dk/dv kernels.

Differences from the JAX functions, each deliberate:
  * The flow noise comes from a torch.Generator (`rng`), so its numbers
    are not jax.random's; `noise=` takes a given draw (the tests feed
    JAX's).
  * The gen MLP runs on the gen rows only. JAX runs it on every row and
    then overwrites the und rows with the und MLP: the same values and
    gradients, without the und rows' activations of the gen expert. With
    freeze_und the und MLP runs under no_grad, the counterpart of its
    stop_gradient, which saves nothing for a backward that would not use
    it.
  * Rows are stop-gradiented out of place (`_detach_rows`): the port's
    expert helpers overwrite und rows in place, and a row detach must not
    write into a tensor that autograd saved.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core import nn as unn
from ...kernels.attention import attention
from ...kernels.flash_attention import build_tile_plan, repeat_kv
from .bagel import Bagel, BagelConfig, timestep_embedding
from .qwen2_mot import (Qwen2MoTConfig, _expert_linear, _expert_norm,
                        _qwen_mlp, apply_rope_half, rope_tables)
from .siglip import siglip_forward


def build_mask_ids(sample_lens: List[int], split_lens: List[int],
                   attn_modes: List[str]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(doc_id, fn_id, noise_id) per token, the create_sparse_mask id
    arrays (data_utils.py:27-40); doc ids start at 1. The full / noise
    split ids restart at 0 in every document (the predicate also asks for
    the same document), which keeps them inside pack_mask_codes' 8-bit
    fields. At most 254 full / noise splits a sample and 65,535 documents."""
    if len(sample_lens) > 0xFFFF:
        raise ValueError(f"{len(sample_lens)} documents exceed the 16-bit "
                         "doc field")
    doc_id = np.concatenate([np.full(l, i + 1, np.int32)
                             for i, l in enumerate(sample_lens)])
    fn = np.full(int(np.sum(split_lens)), -1, np.int32)
    nz = np.full(fn.shape[0], -1, np.int32)
    doc_bounds = np.cumsum(sample_lens)
    pos = 0
    doc_i = 0
    fn_next = nz_next = 1
    for l, mode in zip(split_lens, attn_modes):
        while pos >= doc_bounds[doc_i]:
            doc_i += 1
            fn_next = nz_next = 1
        if mode in ("full", "noise"):
            if fn_next > 0xFE:
                raise ValueError("more than 254 full/noise splits in one "
                                 "sample exceed the 8-bit mask field")
            fn[pos:pos + l] = fn_next - 1  # pack_mask_codes adds 1
            fn_next += 1
        if mode == "noise":
            nz[pos:pos + l] = nz_next - 1
            nz_next += 1
        pos += l
    return doc_id, fn, nz


def _detach_rows(h: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """h [B, L, ...] with the rows `rows` of dim 1 cut from the graph (the
    reference's .detach() on packed_und_token_indexes slices), out of
    place."""
    return h.index_copy(1, rows, h.index_select(1, rows).detach())


def qwen2_mot_packed_forward(params, cfg: Qwen2MoTConfig, seq: torch.Tensor,
                             pos_ids: torch.Tensor, mask_codes: torch.Tensor,
                             und_rows: torch.Tensor,
                             compute_dtype=torch.bfloat16,
                             freeze_und: bool = False) -> torch.Tensor:
    """Cache-free packed LM forward with the composite training mask.

    seq [L, hidden], pos_ids [L], mask_codes int32 [L] (pack_mask_codes),
    und_rows [n] long: the understanding rows (text and ViT), routed
    through the und experts; every other row takes the gen experts
    (qwen2_navit.py:406-497). Returns the final-normed hidden [L, hidden].

    freeze_und=True is the reference's config.freeze_und
    (qwen2_navit.py:434,441,446,737,747,980,1011): the und input rows, the
    und q / k (after their norms) and v rows, the und rows of the attention
    output, the und MLP and the final norm's und rows are cut from the
    graph, so the gen objective reaches no und weight, not even through gen
    queries reading und keys and values."""
    l = seq.shape[0]
    hd = cfg.head_dim
    nh = cfg.num_heads
    cos, sin = rope_tables(pos_ids, hd, cfg.rope_theta)
    x = seq.to(compute_dtype)[None]
    if freeze_und:
        x = _detach_rows(x, und_rows)   # qwen2_navit.py:980
    codes = mask_codes.to(torch.int32)[None]
    # once a pass: the padded codes and, on the card, both tile lists of
    # the packed mask, which every layer's attention call reads
    plan = build_tile_plan(codes, codes, packed_mode=True,
                           device=seq.device)
    gen = torch.ones(l, dtype=torch.bool, device=seq.device)
    gen[und_rows] = False
    gen_rows = gen.nonzero()[:, 0]

    def ln(layer, name, h):
        if not cfg.moe:
            return unn.rms_norm(h, layer[name].to(h.dtype),
                                eps=cfg.rms_norm_eps)
        return _expert_norm(layer[name], layer[name + "_gen"], h, und_rows,
                            cfg.rms_norm_eps)

    def proj(attn_u, attn_g, name, h):
        if not cfg.moe:
            return unn.linear(attn_u[name], h, compute_dtype=compute_dtype)
        return _expert_linear(attn_u[name], attn_g[name], h, und_rows,
                              compute_dtype)

    h = x
    for layer in params.layers:
        attn_u = layer.attn
        attn_g = layer.attn_gen if cfg.moe else attn_u
        y = ln(layer, "input_ln", h)
        q = proj(attn_u, attn_g, "q", y).reshape(1, l, nh, hd)
        k = proj(attn_u, attn_g, "k", y).reshape(1, l, cfg.num_kv_heads, hd)
        v = proj(attn_u, attn_g, "v", y).reshape(1, l, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            if not cfg.moe:
                q = unn.rms_norm(q, attn_u.q_norm.to(q.dtype),
                                 eps=cfg.rms_norm_eps)
                k = unn.rms_norm(k, attn_u.k_norm.to(k.dtype),
                                 eps=cfg.rms_norm_eps)
            else:
                q = _expert_norm(attn_u.q_norm, attn_g.q_norm, q, und_rows,
                                 cfg.rms_norm_eps)
                k = _expert_norm(attn_u.k_norm, attn_g.k_norm, k, und_rows,
                                 cfg.rms_norm_eps)
        if freeze_und:
            # qwen2_navit.py:434,441,446: cuts the und q / k / v rows,
            # including from gen queries that read und keys and values
            q = _detach_rows(q, und_rows)
            k = _detach_rows(k, und_rows)
            v = _detach_rows(v, und_rows)
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)
        # the kv heads repeated, as JAX repeats them (autograd sums them)
        o = attention(q, repeat_kv(k, nh), repeat_kv(v, nh),
                      packed_mode=True, tile_plan=plan)
        o = proj(attn_u, attn_g, "o", o.reshape(1, l, nh * hd))
        if freeze_und:
            o = _detach_rows(o, und_rows)   # qwen2_navit.py:737
        h = h + o

        y = ln(layer, "post_ln", h)
        if not cfg.moe:
            m = _qwen_mlp(layer.mlp, y, compute_dtype)
        else:
            m = torch.zeros_like(y)
            if gen_rows.numel() > 0:
                m = m.index_copy(1, gen_rows, _qwen_mlp(
                    layer.mlp_gen, y[:, gen_rows], compute_dtype))
            if und_rows.numel() > 0:
                with torch.set_grad_enabled(torch.is_grad_enabled()
                                            and not freeze_und):   # :747
                    m_und = _qwen_mlp(layer.mlp, y[:, und_rows],
                                      compute_dtype)
                m = m.index_copy(1, und_rows, m_und)
        h = h + m

    if cfg.moe:
        h = _expert_norm(params.norm, params.norm_gen, h, und_rows,
                         cfg.rms_norm_eps)
    else:
        h = unn.rms_norm(h, params.norm.to(h.dtype), eps=cfg.rms_norm_eps)
    if freeze_und:
        h = _detach_rows(h, und_rows)   # qwen2_navit.py:1011
    return h[0]


def bagel_packed_forward(params: Bagel, cfg: BagelConfig, batch: Dict, *,
                         rng: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         siglip_params=None, siglip_cfg=None,
                         compute_dtype=torch.bfloat16,
                         freeze_und: bool = False
                         ) -> Dict[str, Optional[torch.Tensor]]:
    """Packed multi-sample training forward (bagel.py:101-229) on the
    device of `params`.

    batch (numpy arrays or tensors, data/packed_dataset.py's to_batch):
      seq_len (int), mask_codes [L], packed_position_ids [L],
      packed_text_ids [Nt], packed_text_indexes [Nt];
      (ViT) packed_vit_patches [Nv, patch_dim], packed_vit_pos_ids [Nv],
            packed_vit_token_indexes [Nv], vit_seg_ids [Nv];
      (VAE) packed_latent_clean [Ng, patch_latent_dim],
            packed_latent_pos_ids [Ng], packed_vae_token_indexes [Ng],
            packed_timesteps [Ng] (raw; -inf marks a clean condition image);
      (CE)  ce_loss_indexes [Nc], packed_label_ids [Nc],
            ce_loss_weights [Nc].
    The flow noise is drawn from `rng` (a torch.Generator on that device)
    unless `noise` [Ng, patch_latent_dim] is given. Returns {'mse': [Ng,
    patch_latent_dim] squared errors, zero outside 'mse_mask' [Ng]; 'ce':
    [Nc] token losses; 'ce_weights'} (None where the batch has no such
    rows)."""
    dev = params.llm.embed_tokens.device
    f32 = torch.float32

    def arr(name, dtype=torch.long):
        return torch.as_tensor(batch[name]).to(dev, dtype)

    l = int(batch["seq_len"])
    d = cfg.llm.hidden_size
    emb = params.llm.embed_tokens

    text_idx = arr("packed_text_indexes")
    seq = torch.zeros((l, d), dtype=f32, device=dev).index_copy(
        0, text_idx, emb[arr("packed_text_ids")].float())
    und_rows = [text_idx]
    if "packed_vit_patches" in batch:
        vit_pos = arr("packed_vit_pos_ids")
        feats = siglip_forward(siglip_params, siglip_cfg,
                               arr("packed_vit_patches", f32), vit_pos,
                               segment_ids=arr("vit_seg_ids", torch.int32),
                               compute_dtype=compute_dtype)
        conn = params.connector
        tok = unn.linear(conn.fc0, feats, compute_dtype=compute_dtype)
        tok = unn.gelu_tanh(tok)
        tok = unn.linear(conn.fc1, tok, compute_dtype=compute_dtype)
        tok = tok + params.vit_pos_embed[vit_pos].to(compute_dtype)
        vit_idx = arr("packed_vit_token_indexes")
        seq = seq.index_copy(0, vit_idx, tok.float())
        und_rows.append(vit_idx)

    target = mse_mask = None
    if "packed_latent_clean" in batch:
        clean = arr("packed_latent_clean", f32)
        raw_t = arr("packed_timesteps", f32)
        t = torch.sigmoid(raw_t)
        t = cfg.timestep_shift * t / (1 + (cfg.timestep_shift - 1) * t)
        if noise is None:
            if rng is None:
                raise ValueError("pass rng (a torch.Generator) or noise")
            noise = torch.randn(clean.shape, generator=rng, dtype=f32,
                                device=dev)
        noise = torch.as_tensor(noise).to(dev, f32)
        x_t = (1 - t[:, None]) * clean + t[:, None] * noise
        te = params.time_embedder
        t_emb = unn.linear(te.fc1, unn.silu(unn.linear(
            te.fc0, timestep_embedding(t, 256), compute_dtype=f32)),
            compute_dtype=f32)
        tok = unn.linear(params.vae2llm, x_t, compute_dtype=f32)
        tok = tok + t_emb + params.latent_pos_embed[
            arr("packed_latent_pos_ids")].float()
        seq = seq.index_copy(0, arr("packed_vae_token_indexes"), tok)
        target = noise - clean   # v_t = x_1 - x_0 (bagel.py:223)
        mse_mask = (raw_t > float("-inf")) & torch.isfinite(raw_t)

    und = torch.cat(und_rows) if len(und_rows) > 1 else und_rows[0]
    h = qwen2_mot_packed_forward(
        params.llm, cfg.llm, seq, arr("packed_position_ids"),
        arr("mask_codes", torch.int32), und, compute_dtype=compute_dtype,
        freeze_und=freeze_und)

    out: Dict[str, Optional[torch.Tensor]] = {"mse": None, "ce": None}
    if target is not None:
        preds = unn.linear(params.llm2vae,
                           h[arr("packed_vae_token_indexes")].float(),
                           compute_dtype=f32)
        out["mse"] = (preds - target).square() * mse_mask[:, None]
        out["mse_mask"] = mse_mask
    if "ce_loss_indexes" in batch:
        logits = unn.linear(params.llm.lm_head,
                            h[arr("ce_loss_indexes")].float(),
                            compute_dtype=f32)
        logp = F.log_softmax(logits, dim=-1)
        out["ce"] = -logp.gather(-1, arr("packed_label_ids")[:, None])[:, 0]
        out["ce_weights"] = (arr("ce_loss_weights", f32)
                             if batch.get("ce_loss_weights") is not None
                             else None)
    return out
