"""The rank tasks of tests/test_torch_parallel_train.py: they run in the
spawned ranks of `torch_ranks.Ranks`, which import this module by name, so
it imports no JAX (the ranks start without it). Inputs arrive as numpy
trees and arrays; each task converts and shards them on its rank.
"""

import torch

from torch_ranks import _mesh
from univid_tpu_torch import convert
from univid_tpu_torch.core import nn as unn
from univid_tpu_torch.core.config import T5Config, WanDiTConfig
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.models.bagel import qwen2_mot as tq
from univid_tpu_torch.models.bagel.siglip import SiglipConfig
from univid_tpu_torch.models.wan import dit as tdit
from univid_tpu_torch.models.wan.t5 import encode_padded
from univid_tpu_torch.ops.rope import build_rope_3d
from univid_tpu_torch.parallel import sharding as tsh
from univid_tpu_torch.parallel import tensor_parallel as ttp
from univid_tpu_torch.reflection import naflex as tn
from univid_tpu_torch.reflection import scorer as tscorer
from univid_tpu_torch.train import optim as toptim
from univid_tpu_torch.train import trainer as ttrainer


# tests/test_parallel.py's train-step model: _tiny_cfg(dim=64, num_heads=4)
TRAIN_CFG = dict(model_type="t2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                 freq_dim=32, text_dim=48, num_heads=4, num_layers=2,
                 text_len=12)


TRAIN_GRID = (2, 4, 4)   # latents [4, 2, 8, 8, 8], patch (1, 2, 2)


def _full_state(model):
    """Every parameter whole (a collective for each DTensor, in the same
    order on every rank)."""
    return {n: tsh.full_tensor(p).detach().numpy()
            for n, p in model.named_parameters()}


def _task_train(rank, world, axes, params, batch, remat, clip_only=False,
                local_norm=False):
    """One sharded train step: (loss, the clip's norm, every parameter
    gathered whole). local_norm: the clip takes each rank's own sum of
    squares (no all-reduce)."""
    cfg = WanDiTConfig(**TRAIN_CFG)
    norms = []
    real = toptim.global_sq_norm

    def record(grads):
        s = (sum(toptim.local(g).float().square().sum() for g in grads)
             if local_norm else real(grads))
        norms.append(float(s) ** 0.5)
        return s

    toptim.global_sq_norm = record
    try:
        with torch.enable_grad():
            model = convert.dit_from_jax(params, cfg, device="cpu")
            mesh = _mesh(**axes)
            tsh.shard_params(model, mesh, tsh.dit_param_sharding_rules())
            tx = toptim.clip_by_global_norm(1.0) if clip_only else None
            state, tx = ttrainer.init_train_state(model, tx,
                                                  learning_rate=1e-3)
            step = ttrainer.make_dit_train_step(
                cfg, tx, mesh=mesh,
                rope=build_rope_3d(cfg.head_dim, TRAIN_GRID, device="cpu"),
                remat_blocks=remat)
            _, loss = step(state, {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
    finally:
        toptim.global_sq_norm = real
    return float(loss), norms[0], _full_state(model)


def _task_train_refusals(rank, world, params, batch):
    cfg = WanDiTConfig(**TRAIN_CFG)
    model = convert.dit_from_jax(params, cfg, device="cpu")
    mesh = _mesh(dp=2, fsdp=2, tp=world // 4)
    state, tx = ttrainer.init_train_state(model)
    step = ttrainer.make_dit_train_step(
        cfg, tx, mesh=mesh,
        rope=build_rope_3d(cfg.head_dim, TRAIN_GRID, device="cpu"))
    out = []
    for fn in (lambda: step(state, {k: torch.as_tensor(v[:3])
                                    for k, v in batch.items()}),
               lambda: ttrainer.make_dit_train_step(
                   cfg, tx, mesh=_mesh(sp=2, fsdp=world // 2),
                   rope=(None, None))):
        try:
            with torch.enable_grad():
                fn()
            out.append(None)
        except (ValueError, NotImplementedError) as e:
            out.append(str(e))
    return out


def _task_dit_tp(rank, world, cfg_kw, axes, params, x, t, ctx, grid, t_zero,
                 seq_pad_to, fused, local_norm=False):
    cfg = WanDiTConfig(**cfg_kw)
    model = convert.dit_from_jax(params, cfg, device="cpu")
    tsh.shard_params(model, _mesh(**axes), tsh.dit_param_sharding_rules())
    q = model.blocks[0].self_attn.q.w
    local = tuple(q.to_local().shape)
    cos, sin = build_rope_3d(cfg.head_dim, grid, device="cpu")
    real = ttp.sum_over_tp
    if local_norm:   # each rank's own sum of squares: no all-reduce
        ttp.sum_over_tp = lambda s, tp: s
    try:
        out = tdit.wan_dit_forward(
            model, torch.as_tensor(x), torch.as_tensor(t),
            torch.as_tensor(ctx), cos, sin,
            t_zero_mask=None if t_zero is None else torch.as_tensor(t_zero),
            seq_pad_to=seq_pad_to, policy=FP32_POLICY, fused_rope=fused)
    finally:
        ttp.sum_over_tp = real
    return local, out.numpy()


def _task_sp_tp_refusals(rank, world, cfg_kw, params):
    cfg = WanDiTConfig(**cfg_kw)
    model = convert.dit_from_jax(params, cfg, device="cpu")
    tsh.shard_params(model, _mesh(tp=world), tsh.dit_param_sharding_rules())
    out = []
    for fn in (lambda: tdit.wan_dit_forward_sp(
                   model, None, None, None, None, None, mesh=_mesh(tp=world)),
               lambda: tsh.check_serving_mesh(_mesh(sp=2, tp=world // 2), 2)):
        try:
            fn()
            out.append(None)
        except NotImplementedError as e:
            out.append(str(e))
    return out


def _task_t5_tp(rank, world, cfg_kw, params, ids, lens):
    cfg = T5Config(**cfg_kw)
    model = convert.t5_from_jax(params, cfg, device="cpu")
    tsh.shard_params(model, _mesh(fsdp=4, tp=2), tsh.t5_param_sharding_rules())
    w = model.blocks[0].attn.q.w   # [out = heads, in]: tp on 0, fsdp on 1
    assert tuple(w.to_local().shape) == (64 // 2, 64 // 4)
    return encode_padded(model, torch.as_tensor(ids), torch.as_tensor(lens),
                         compute_dtype=torch.float32).numpy()


def _task_qwen_tp(rank, world, cfg_kw, params, x, und_rows):
    cfg = tq.Qwen2MoTConfig(**cfg_kw)
    model = tq.init_qwen2_mot(None, cfg, device="cpu")
    model.load_state_dict(convert.jax_tree_to_state_dict(
        params, stacked="layers"))
    tsh.shard_params(model, _mesh(fsdp=2, tp=4),
                     tsh.bagel_llm_param_sharding_rules())
    assert tuple(model.layers[0].attn.q.w.to_local().shape) == (
        64 // 4, 64 // 2)
    l = x.shape[0]
    outs = []
    for mode, rows in (("und", None), ("gen", und_rows)):
        cache = tq.init_kv_cache(cfg, 64, dtype=torch.float32, device="cpu",
                                 tp=4)
        assert cache["k"].shape[3] == 1   # 4 kv heads over tp 4
        h, _ = tq.qwen2_mot_forward(
            model, cfg, torch.as_tensor(x)[None], torch.arange(l)[None],
            cache, mode=mode,
            und_rows=None if rows is None else torch.as_tensor(rows),
            compute_dtype=torch.float32)
        outs.append(h[0].numpy())
    logits = tq.lm_head_logits(model, cfg, h, compute_dtype=torch.float32)
    return outs + [logits[0].numpy()]


SIGLIP_VISION = dict(hidden_size=64, intermediate_size=128, num_layers=2,
                     num_heads=4, patch_size=16, image_size=32)


SIGLIP_TEXT = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_layers=1, num_heads=2, proj_dim=16)


NAFLEX_VISION = dict(hidden_size=32, intermediate_size=64, num_layers=2,
                     num_heads=4, patch_size=4, num_patches=16,
                     max_num_patches=16)


NAFLEX_TEXT = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=4, max_len=8, proj_dim=32)


def _task_scorer(rank, world, kind, trees, frames):
    mesh = _mesh(dp=world)
    if kind == "siglip":
        vcfg = SiglipConfig(**SIGLIP_VISION)
        tcfg = tscorer.SiglipTextConfig(**SIGLIP_TEXT)
        proj = unn.Linear(64, 16, bias=False, init="empty", device="cpu")
        proj.load_state_dict(convert.jax_tree_to_state_dict(trees[2]))
        s = tscorer.Siglip2Scorer(
            vision_params=convert.siglip_from_jax(trees[0], vcfg,
                                                  device="cpu"),
            vision_cfg=vcfg, text_cfg=tcfg,
            text_params=convert.siglip_text_from_jax(trees[1], tcfg,
                                                     device="cpu"),
            image_size=32, img_proj=proj, device="cpu", mesh=mesh)
    else:
        vcfg = tn.NaflexVisionConfig(**NAFLEX_VISION)
        tcfg = tn.NaflexTextConfig(**NAFLEX_TEXT)
        s = tn.Siglip2NaflexScorer(
            vision_params=convert.naflex_vision_from_jax(trees[0], vcfg,
                                                         device="cpu"),
            vision_cfg=vcfg, text_cfg=tcfg,
            text_params=convert.naflex_text_from_jax(trees[1], tcfg,
                                                     device="cpu"),
            device="cpu", mesh=mesh)
    # two batches: 8 frames (no pad at dp 2 and 4), then 3 (a pad at both)
    return s.emb_imgs(frames, bs=8)
