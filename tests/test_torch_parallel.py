"""Multi-GPU serving in the port (core/mesh.py, parallel/, the DiT's
sequence-parallel forward, the SP pipelines and FSDP) against univid_tpu's
own multi-device functions on its 8 virtual CPU devices
(tests/conftest.py), at tests/test_parallel.py's tolerances.

The port's ranks are spawned processes in gloo groups of 2 and 4
(`torch_ranks.Ranks`: a pool per group size, rendezvous through a file,
kept for the module). Each test sends one task to every rank and waits at
most DEADLINE s for all of them; past it, or when a rank fails, the ranks
are killed and the test fails, so a hung collective costs one test its
deadline and no more.
Inputs are numpy arrays made from seeds here and sent to the ranks; the
DiT, T5 and Qwen2-MoT weights are numpy trees converted on each rank.
fp32 policies on both sides hold the SP forwards and pipelines to JAX's
own SP-vs-single tolerances.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import univid_tpu.kernels.flash_attention as jfa
from test_torch_models import D128, np_params
from torch_ranks import _mesh, ranks  # noqa: F401
from univid_tpu.core.config import T5Config as JT5Config
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.core.mesh import ALL_AXES as J_AXES
from univid_tpu.models.bagel import qwen2_mot as jq
from univid_tpu.models.flux.kontext import FluxConfig, init_flux
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.dit import wan_dit_forward as j_dit
from univid_tpu.models.wan.dit import wan_dit_forward_sp as j_dit_sp
from univid_tpu.models.wan.t5 import encode_padded as j_encode_padded
from univid_tpu.models.wan.t5 import init_t5_encoder
from univid_tpu.models.wan.vae_api import init_wan_vae
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu.parallel import sharding as jsh
from univid_tpu.parallel.ring import ring_attention as j_ring
from univid_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from univid_tpu.pipelines.moe import WanMoEPipeline as JMoE
from univid_tpu.pipelines.ti2v import WanTI2VPipeline as JPipeline
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import T5Config, WAN_CONFIGS, WanDiTConfig
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.core.mesh import MeshSpec, make_mesh
from univid_tpu_torch.kernels.attention import attention
from univid_tpu_torch.kernels.flash_attention import rms_heads
from univid_tpu_torch.models.bagel import qwen2_mot as tq
from univid_tpu_torch.models.wan import dit as tdit
from univid_tpu_torch.models.wan.t5 import encode_padded
from univid_tpu_torch.ops.rope import build_rope_3d
from univid_tpu_torch.parallel import sharding as tsh
from univid_tpu_torch.parallel.ring import ring_attention
from univid_tpu_torch.parallel.ulysses import (heads_to_seq, seq_to_heads,
                                               ulysses_attention)
from univid_tpu_torch.pipelines.moe import WanMoEPipeline
from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rows(rank, world, l):
    n = l // world
    return slice(rank * n, (rank + 1) * n)


def _jmesh(sp=1, fsdp=1, tp=1):
    devs = np.asarray(jax.devices()[:sp * fsdp * tp]).reshape(1, fsdp, sp, tp)
    return Mesh(devs, J_AXES)


def _same_on_every_rank(outs):
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


# ---------------------------------------------------------------------------
# Ulysses attention
# ---------------------------------------------------------------------------


def _task_ulysses(rank, world, q, k, v, kv_len):
    rows = _rows(rank, world, q.shape[1])
    group = _mesh(sp=world)["sp"].get_group()
    out = ulysses_attention(
        *(torch.as_tensor(t[:, rows]) for t in (q, k, v)), group,
        kv_len=None if kv_len is None else torch.as_tensor(kv_len))
    return out.numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kv_masked", [False, True])
def test_ulysses_attention_matches_jax(world, kv_masked, ranks):
    b, l, n, d = 2, 64, 8, 32
    q, k, v = (_rand((b, l, n, d), s) for s in range(3))
    kv_len = np.array([l - 7, l - 13], np.int32) if kv_masked else None
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    f = jax.shard_map(
        lambda q, k, v: j_ulysses(q, k, v, "sp", kv_len=jkv),
        mesh=_jmesh(sp=world), in_specs=(P(None, "sp"),) * 3,
        out_specs=P(None, "sp"), axis_names={"sp"}, check_vma=False)
    want = np.asarray(jax.jit(f)(q, k, v))
    got = np.concatenate(ranks(world).run(_task_ulysses, q, k, v, kv_len),
                         axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _task_norm_through_exchange(rank, world, q, k, v, gq, gk):
    """(norm over all heads, then the exchange; the exchange, then a norm
    over the rank's N / sp heads)."""
    rows = _rows(rank, world, q.shape[1])
    group = _mesh(sp=world)["sp"].get_group()
    q, k, v = (torch.as_tensor(t[:, rows]) for t in (q, k, v))
    gq, gk = torch.as_tensor(gq), torch.as_tensor(gk)
    right = ulysses_attention(rms_heads(q, gq, 1e-6), rms_heads(k, gk, 1e-6),
                              v, group)
    qg, kg, vg = (seq_to_heads(t, group) for t in (q, k, v))
    n_loc, d = qg.shape[2], qg.shape[3]
    mine = slice(rank * n_loc * d, (rank + 1) * n_loc * d)
    deferred = heads_to_seq(attention(rms_heads(qg, gq[mine], 1e-6),
                                      rms_heads(kg, gk[mine], 1e-6), vg),
                            group)
    return right.numpy(), deferred.numpy()


def test_qk_norm_runs_before_the_ulysses_exchange(ranks):
    """Wan's qk norm spans all N heads of a token. Normed before the
    exchange (as wan_dit_forward_sp does) Ulysses equals single-device
    attention; deferred past it, each rank norms over its N / sp heads and
    the result is another function."""
    b, l, n, d = 1, 32, 4, 32
    q, k, v = (_rand((b, l, n, d), s) for s in range(3))
    q[..., :2, :] *= 4.0   # heads of unequal norm: the two norms differ
    gq = np.random.default_rng(5).uniform(0.5, 1.5, n * d).astype(np.float32)
    gk = np.random.default_rng(6).uniform(0.5, 1.5, n * d).astype(np.float32)
    outs = ranks(2).run(_task_norm_through_exchange, q, k, v, gq, gk)
    right = np.concatenate([o[0] for o in outs], axis=1)
    deferred = np.concatenate([o[1] for o in outs], axis=1)
    tq_, tk_ = (rms_heads(torch.as_tensor(t), torch.as_tensor(g), 1e-6)
                for t, g in ((q, gq), (k, gk)))
    want = attention(tq_, tk_, torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(right, want, rtol=1e-5, atol=1e-5)
    assert np.abs(deferred - want).max() > 1e-2


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _task_ring(rank, world, q, k, v, seq_real):
    rows = _rows(rank, world, q.shape[1])
    group = _mesh(sp=world)["sp"].get_group()
    out = ring_attention(
        *(torch.as_tensor(t[:, rows]) for t in (q, k, v)), group,
        seq_len_global=None if seq_real is None else torch.as_tensor(
            seq_real))
    return out.numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tail_masked", [False, True])
def test_ring_attention_matches_jax(world, tail_masked, ranks):
    """With the tail masked, batch row 0's real length ends inside the last
    shard and row 1's leaves the last shard all padding (kv_len 0 there:
    the kernel's zero rows with lse +1e30 weigh nothing in the merge)."""
    b, l, n, d = 2, 256, 4, 32
    q, k, v = (_rand((b, l, n, d), 10 + s) for s in range(3))
    seq_real = (np.array([l - 70, l - l // world], np.int32)
                if tail_masked else None)
    jseq = None if seq_real is None else jnp.asarray(seq_real)
    f = jax.shard_map(
        lambda q, k, v: j_ring(q, k, v, "sp", seq_len_global=jseq,
                               block_q=64, block_k=64, interpret=True),
        mesh=_jmesh(sp=world), in_specs=(P(None, "sp"),) * 3,
        out_specs=P(None, "sp"), check_vma=False)
    want = np.asarray(jax.jit(f)(q, k, v))
    got = np.concatenate(ranks(world).run(_task_ring, q, k, v, seq_real),
                         axis=1)
    valid = int(seq_real.min()) if tail_masked else l
    np.testing.assert_allclose(got[:, :valid], want[:, :valid], rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# the sequence-parallel DiT forward
# ---------------------------------------------------------------------------

SP_CFG = dict(model_type="t2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
              freq_dim=32, text_dim=48, num_heads=8, num_layers=2,
              text_len=12)
RING_CFG = dict(model_type="t2v", in_dim=4, out_dim=4, dim=64, ffn_dim=96,
                freq_dim=32, text_dim=48, num_heads=4, num_layers=2,
                text_len=8)


def _dit_case(cfg_kw, i2v, pad, seed=0):
    """(params, x, t, ctx, grid, t_zero, seq_pad_to) of a 4 x 8 x 8
    latent; the head random (init's zero head gives velocity 0)."""
    jc = JDiTConfig(**cfg_kw)
    params = np_params(init_wan_dit, jc, seed, stacked=True)
    b, f, h, w = 2, (2 if cfg_kw["dim"] == 256 else 4), 8, 8
    pt, ph, pw = jc.patch_size
    grid = (f // pt, h // ph, w // pw)
    per_frame = grid[1] * grid[2]
    l_real = grid[0] * per_frame
    x = _rand((b, f, h, w, jc.in_dim), seed + 1)
    t = np.array([500.0, 500.0], np.float32)
    ctx = _rand((b, jc.text_len, jc.text_dim), seed + 2, 0.5)
    t_zero = None
    if i2v:
        t_zero = np.zeros((b, l_real), bool)
        t_zero[:, :per_frame] = True
    return params, x, t, ctx, grid, t_zero, (l_real + 24 if pad else None)


def _task_dit_sp(rank, world, cfg_kw, params, x, t, ctx, grid, t_zero,
                 seq_pad_to, sp_impl, fused, fsdp=1):
    cfg = WanDiTConfig(**cfg_kw)
    model = convert.dit_from_jax(params, cfg, device="cpu")
    mesh = _mesh(fsdp=fsdp, sp=world // fsdp)
    if fsdp > 1:
        tsh.shard_params(model, mesh, tsh.dit_param_sharding_rules())
    cos, sin = build_rope_3d(cfg.head_dim, grid, device="cpu")
    kw = dict(t_zero_mask=None if t_zero is None else torch.as_tensor(t_zero),
              seq_pad_to=seq_pad_to, policy=FP32_POLICY, fused_rope=fused)
    args = (model, torch.as_tensor(x), torch.as_tensor(t),
            torch.as_tensor(ctx), cos, sin)
    if world // fsdp == 1:
        return tdit.wan_dit_forward(*args, **kw).numpy()
    return tdit.wan_dit_forward_sp(*args, mesh=mesh, sp_impl=sp_impl,
                                   **kw).numpy()


def _jax_dit_sp(cfg_kw, params, x, t, ctx, grid, t_zero, seq_pad_to, sp,
                sp_impl, fused):
    jc = JDiTConfig(**cfg_kw)
    cos, sin = jrope3d(jc.head_dim, grid)
    jt0 = None if t_zero is None else jnp.asarray(t_zero)

    @jax.jit
    def run(params, x, t, ctx):
        return j_dit_sp(params, jc, x, t, ctx, cos, sin, mesh=_jmesh(sp=sp),
                        sp_impl=sp_impl, t_zero_mask=jt0,
                        seq_pad_to=seq_pad_to, policy=J_FP32,
                        fused_rope=fused)

    return np.asarray(run(params, x, t, ctx))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("i2v,pad,fused",
                         [(False, False, False), (True, True, False),
                          (False, True, True), (True, False, True)])
def test_sp_dit_forward_ulysses_matches_jax(world, i2v, pad, fused, ranks):
    """Ulysses at head dim 8 (the reference route; fused rope rotates
    there with the global tables after the exchange): t2v / i2v (t = 0 on
    the first frame's tokens, sharded like the tokens), padded or not."""
    case = _dit_case(SP_CFG, i2v, pad)
    want = _jax_dit_sp(SP_CFG, *case, world, "ulysses", fused)
    got = _same_on_every_rank(ranks(world).run(
        _task_dit_sp, SP_CFG, *case, "ulysses", fused))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_sp_dit_forward_ulysses_kernel_route_matches_jax(ranks):
    """Ulysses at head dim 128 with the fused rope (the card's serving
    route: kernel A's norm before the exchange, its rope pre-pass after),
    padded tokens masked through the global kv_len, 1 head a rank."""
    case = _dit_case(D128, True, True)
    want = _jax_dit_sp(D128, *case, 2, "ulysses", True)
    got = _same_on_every_rank(ranks(2).run(_task_dit_sp, D128, *case,
                                           "ulysses", True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_sp_dit_forward_ring_matches_jax(world, ranks):
    case = _dit_case(RING_CFG, False, False)
    jfa.set_interpret_mode(True)
    try:
        want = _jax_dit_sp(RING_CFG, *case, world, "ring", False)
    finally:
        jfa.set_interpret_mode(False)
    got = _same_on_every_rank(ranks(world).run(_task_dit_sp, RING_CFG,
                                               *case, "ring", False))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# the SP pipelines
# ---------------------------------------------------------------------------

PIPE_KW = dict(size=(64, 64), frame_num=9, sampling_steps=3, seed=7,
               decode=False)


def _jax_noise(jspec, seed):
    c, f, h, w = 4, 3, 4, 4   # latent_shape(tiny, 64, 64, 9)
    assert jspec.vae.z_dim == c
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (1, f, h, w, c), jnp.float32))


def _task_pipeline(rank, world, name, trees, ctx, nctx, noise, img):
    spec = WAN_CONFIGS[name]
    mesh = _mesh(sp=world)
    dits = [convert.dit_from_jax(p, spec.dit, device="cpu")
            for p in trees[:-1]]
    vae = convert.vae_from_jax(trees[-1], spec.vae, device="cpu")
    if len(dits) == 1:
        pipe = WanTI2VPipeline(spec, dits[0], vae, policy=FP32_POLICY,
                               sp_size=world, mesh=mesh)
    else:
        pipe = WanMoEPipeline(spec, *dits, vae, policy=FP32_POLICY,
                              sp_size=world, mesh=mesh)
    kw = dict(PIPE_KW, noise=torch.as_tensor(noise))
    if img is not None:
        kw["img"] = torch.as_tensor(img)
    return pipe.generate(torch.as_tensor(ctx), torch.as_tensor(nctx),
                         **kw).numpy()


@pytest.mark.parametrize("name,world",
                         [("tiny", 2), ("tiny", 4), ("tiny-moe-t2v", 2),
                          ("tiny-moe-i2v", 2)])
def test_sp_pipeline_matches_jax(name, world, ranks):
    """WanTI2VPipeline / WanMoEPipeline(sp_size=world, mesh) against
    JAX's SP pipelines: 3 UniPC steps, batch-2 CFG, JAX's noise draw."""
    jspec = JCONFIGS[name]
    moe = name.startswith("tiny-moe")
    dits = [np_params(init_wan_dit, jspec.dit, s, stacked=True)
            for s in ((0, 1) if moe else (0,))]
    vae = np_params(init_wan_vae, jspec.vae, 2)
    text = (jspec.dit.text_len, jspec.dit.text_dim)
    ctx, nctx = _rand(text, 3, 0.5), _rand(text, 4, 0.5)
    img = (np.random.default_rng(5).uniform(-1, 1, (64, 64, 3))
           .astype(np.float32) if name.endswith("i2v") else None)
    jkw = dict(PIPE_KW)
    if img is not None:
        jkw["img"] = jnp.asarray(img)
    if moe:
        jpipe = JMoE(jspec, *dits, vae, policy=J_FP32, sp_size=world,
                     mesh=_jmesh(sp=world), dispatch_steps=0)
    else:
        jpipe = JPipeline(jspec, *dits, vae, policy=J_FP32, sp_size=world,
                          mesh=_jmesh(sp=world), dispatch_steps=0)
    want = np.asarray(jpipe.generate(jnp.asarray(ctx), jnp.asarray(nctx),
                                     **jkw))
    got = _same_on_every_rank(ranks(world).run(
        _task_pipeline, name, dits + [vae], ctx, nctx,
        _jax_noise(jspec, PIPE_KW["seed"]), img))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# FSDP: UMT5, Qwen2-MoT and the DiT sharded by the ported rules
# ---------------------------------------------------------------------------

T5_CFG = dict(vocab_size=128, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
              num_layers=2, text_len=16)
QWEN_CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=8, num_kv_heads=4)


def _task_t5_fsdp(rank, world, params, ids, lens):
    cfg = T5Config(**T5_CFG)
    model = convert.t5_from_jax(params, cfg, device="cpu")
    tsh.shard_params(model, _mesh(fsdp=world), tsh.t5_param_sharding_rules())
    w = model.blocks[0].attn.q.w   # [out, in] sharded on dim 1
    assert tuple(w.to_local().shape) == (64, 64 // world)
    return encode_padded(model, torch.as_tensor(ids), torch.as_tensor(lens),
                         compute_dtype=torch.float32).numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_t5_fsdp_encode_matches_jax(world, ranks):
    cfg = JT5Config(**T5_CFG)
    params = np_params(init_t5_encoder, cfg, 0)
    ids = np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int64)
    lens = np.array([9, 16], np.int32)
    want = np.asarray(j_encode_padded(params, cfg, jnp.asarray(ids),
                                      jnp.asarray(lens),
                                      compute_dtype=jnp.float32))
    got = _same_on_every_rank(ranks(world).run(_task_t5_fsdp, params, ids,
                                               lens))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _task_qwen_fsdp(rank, world, params, x):
    cfg = tq.Qwen2MoTConfig(**QWEN_CFG)
    model = tq.init_qwen2_mot(None, cfg, device="cpu")
    model.load_state_dict(convert.jax_tree_to_state_dict(
        params, stacked="layers"))
    tsh.shard_params(model, _mesh(fsdp=world),
                     tsh.bagel_llm_param_sharding_rules())
    assert tuple(model.layers[0].mlp.gate.w.to_local().shape) == (
        128, 64 // world)
    l = x.shape[0]
    cache = tq.init_kv_cache(cfg, 64, dtype=torch.float32, device="cpu")
    h, _ = tq.qwen2_mot_forward(model, cfg, torch.as_tensor(x)[None],
                                torch.arange(l)[None], cache, mode="und",
                                compute_dtype=torch.float32)
    logits = tq.lm_head_logits(model, cfg, h, compute_dtype=torch.float32)
    return h[0].numpy(), logits[0].numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_qwen2_mot_fsdp_forward_matches_jax(world, ranks):
    """The Qwen2-MoT prefill and the LM head on an FSDP-sharded tree (the
    memory path of BAGEL-7B), against JAX's unsharded forward."""
    cfg = jq.Qwen2MoTConfig(**QWEN_CFG)
    params = np_params(jq.init_qwen2_mot, cfg, 0, stacked=False)
    x = _rand((16, cfg.hidden_size), 1)
    cache = jq.init_kv_cache(cfg, 64, dtype=jnp.float32)
    h, _ = jq.qwen2_mot_forward(params, cfg, jnp.asarray(x), jnp.arange(16),
                                cache, mode="und",
                                compute_dtype=jnp.float32)
    want_h = np.asarray(h)
    want_logits = np.asarray(jq.lm_head_logits(params, cfg, h,
                                               compute_dtype=jnp.float32))
    outs = ranks(world).run(_task_qwen_fsdp, params, x)
    got_h = _same_on_every_rank([o[0] for o in outs])
    got_logits = _same_on_every_rank([o[1] for o in outs])
    np.testing.assert_allclose(got_h, want_h, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_logits, want_logits, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_dit_fsdp_forward_matches_jax(world, ranks):
    """The DiT FSDP-sharded over fsdp = 2: wan_dit_forward on 2 ranks, and
    wan_dit_forward_sp (Ulysses, fused rope) over the sp axis of a
    (fsdp 2, sp 2) mesh on 4, against JAX's single-device forward."""
    params, x, t, ctx, grid, t_zero, pad = _dit_case(SP_CFG, True, True)
    jc = JDiTConfig(**SP_CFG)
    cos, sin = jrope3d(jc.head_dim, grid)
    want = np.asarray(j_dit(params, jc, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx), cos, sin,
                            t_zero_mask=jnp.asarray(t_zero), seq_pad_to=pad,
                            policy=J_FP32))
    got = _same_on_every_rank(ranks(world).run(
        _task_dit_sp, SP_CFG, params, x, t, ctx, grid, t_zero, pad,
        "ulysses", True, 2))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _task_unsharded_read(rank, world, params, x, t, ctx, grid):
    """The shard of a dim-1 rule is [out, in / world] (a shape some reads
    would take); a forward whose gathers are skipped must raise, and one
    with them leaves every sharded parameter a shard again."""
    cfg = WanDiTConfig(**SP_CFG)
    model = convert.dit_from_jax(params, cfg, device="cpu")
    tsh.shard_params(model, _mesh(fsdp=world), tsh.dit_param_sharding_rules())
    q = model.blocks[0].self_attn.q.w
    local = tuple(q.to_local().shape)
    cos, sin = build_rope_3d(cfg.head_dim, grid, device="cpu")
    args = (model, torch.as_tensor(x), torch.as_tensor(t),
            torch.as_tensor(ctx), cos, sin)
    tdit.wan_dit_forward(*args, policy=FP32_POLICY)
    after = type(model.blocks[0].self_attn.q.w).__name__
    real = tdit.gathered
    tdit.gathered = contextlib.nullcontext
    try:
        tdit.wan_dit_forward(*args, policy=FP32_POLICY)
        raised = None
    except Exception as e:   # any refusal to compute on a shard
        raised = type(e).__name__
    finally:
        tdit.gathered = real
    return local, after, raised


def test_sharded_parameter_is_never_read_without_its_gather(ranks):
    params, x, t, ctx, grid, _, _ = _dit_case(SP_CFG, False, False)
    for local, after, raised in ranks(2).run(_task_unsharded_read, params,
                                             x, t, ctx, grid):
        assert local == (64, 32)
        assert after == "DTensor"
        assert raised is not None


def _task_mesh_refusals(rank, world):
    out = []
    for fn in (lambda: make_mesh(MeshSpec(sp=world // 2), device="cpu"),
               lambda: tsh.check_serving_mesh(_mesh(sp=2, tp=world // 2),
                                              2)):
        try:
            fn()
            out.append(None)
        except (ValueError, NotImplementedError) as e:
            out.append(str(e))
    return out


def test_mesh_size_and_tensor_parallel_refusals(ranks):
    """make_mesh raises JAX's ValueError for a spec of the wrong size; a
    serving mesh with sp and tp both > 1 raises the message of the queue 1
    item that takes them together (tp alone runs: test_torch_parallel_train
    .py)."""
    for size_err, tp_err in ranks(4).run(_task_mesh_refusals):
        assert size_err == ("mesh spec MeshSpec(dp=1, fsdp=1, sp=2, tp=1) "
                            "needs 2 devices, have 4")
        assert tp_err == tsh.SP_TP_LATER
        assert ("ROADMAP.md queue 1: Sequence and tensor parallelism "
                "together") in tp_err


def _task_sp_size_mismatch(rank, world, name):
    spec = WAN_CONFIGS[name]
    out = []
    for sp_size, mesh in ((1, _mesh(sp=world)), (world, _mesh(fsdp=world))):
        try:
            if spec.moe_boundary is None:
                WanTI2VPipeline(spec, None, None, sp_size=sp_size, mesh=mesh)
            else:
                WanMoEPipeline(spec, None, None, None, sp_size=sp_size,
                               mesh=mesh)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("name", ["tiny", "tiny-moe-t2v"])
def test_pipeline_sp_size_must_be_the_mesh_sp_axis(ranks, name):
    """A pipeline whose sp_size is not the size of its mesh's sp axis
    raises ValueError: an sp = 2 mesh at sp_size 1 (every rank would do the
    whole work) and an fsdp-only mesh at sp_size 2 (a group of one)."""
    for one_on_sp2, two_on_fsdp in ranks(2).run(_task_sp_size_mismatch,
                                                name):
        assert one_on_sp2 == "sp_size 1 is not the mesh's sp axis (2)"
        assert two_on_fsdp == "sp_size 2 is not the mesh's sp axis (1)"


# ---------------------------------------------------------------------------
# the rules, leaf for leaf against JAX's
# ---------------------------------------------------------------------------

_STACKED = ("blocks", "layers", "double_blocks", "single_blocks")


def _port_leaf(path, shape, spec, stacked):
    """A JAX leaf (path parts, shape, spec padded to its rank) -> the
    port's name of its first layer, shape and spec: the stacked layer axis
    dropped, a linear `w` [in, out] transposed to [out, in]."""
    parts = list(path)
    if stacked and parts[0] in _STACKED:
        parts.insert(1, "0")
        shape, spec = shape[1:], spec[1:]
    if parts[-1] == "w" and len(shape) == 2:
        shape, spec = shape[::-1], spec[::-1]
    return ".".join(parts), shape, spec


MODELS = {
    "dit": (lambda: np_params(init_wan_dit, JDiTConfig(**SP_CFG), 0,
                              stacked=True), True,
            jsh.dit_param_sharding_rules, tsh.dit_param_sharding_rules),
    "t5": (lambda: np_params(init_t5_encoder, JT5Config(**T5_CFG), 0),
           False, jsh.t5_param_sharding_rules, tsh.t5_param_sharding_rules),
    "bagel_llm": (lambda: np_params(jq.init_qwen2_mot,
                                    jq.Qwen2MoTConfig(**QWEN_CFG), 0),
                  True, jsh.bagel_llm_param_sharding_rules,
                  tsh.bagel_llm_param_sharding_rules),
    "flux": (lambda: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), jax.eval_shape(
            functools.partial(init_flux, cfg=FluxConfig(
                in_channels=16, out_channels=16, hidden_size=64,
                num_heads=4, depth_double=2, depth_single=2,
                axes_dim=(4, 6, 6), context_dim=32, vec_dim=24,
                time_freq_dim=32)), jax.random.PRNGKey(0))), True,
        jsh.flux_param_sharding_rules, tsh.flux_param_sharding_rules),
}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("axes", [dict(fsdp=2, tp=4), dict(fsdp=4, tp=2),
                                  dict(fsdp=8)])
def test_sharding_rules_match_jax_leaf_for_leaf(model, axes):
    """apply_sharding_rules for every leaf of the DiT, UMT5, Qwen2-MoT and
    FLUX trees against JAX's spec, the axes moved by the port's layout
    (one module a layer, linear weights [out, in]); axes that do not
    divide their dim are dropped alike."""
    make, stacked, jrules, trules = MODELS[model]
    params = make()
    spec = MeshSpec(**axes)
    jmesh = _jmesh(fsdp=spec.fsdp, tp=spec.tp)
    jspecs = jsh.apply_sharding_rules(params, jmesh, jrules())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    shardings = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda s: hasattr(s, "spec"))
    want, shapes = {}, {}
    for (path, leaf), sh in zip(leaves, shardings):
        parts = jsh.path_str(path).split("/")
        jspec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        name, shape, tspec = _port_leaf(parts, leaf.shape, jspec, stacked)
        want[name], shapes[name] = tspec, shape
    got = tsh.apply_sharding_rules(shapes, spec, trules())
    pad = {k: v + (None,) * (len(shapes[k]) - len(v)) for k, v in got.items()}
    assert pad == want
    assert any("fsdp" in s for s in want.values())
