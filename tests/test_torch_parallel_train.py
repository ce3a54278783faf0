"""Multi-GPU training and tensor parallelism in the port (the DiT train
step's dp / fsdp / tp mesh, the tensor-parallel Wan DiT, UMT5 and
Qwen2-MoT, the dp-sharded SigLIP scorers) against univid_tpu's own
functions on its 8 virtual CPU devices (tests/conftest.py), at
tests/test_parallel.py's tolerances.

The ranks are `torch_ranks`' pool (spawned gloo groups, DEADLINE s a
test), running the JAX-free tasks of `torch_parallel_train_tasks`; tasks
run under no_grad, so the training tasks enable grad themselves. Weights are numpy trees from seeds with a random
head (init's zero head blocks every gradient but its own), converted on
each rank and sharded there by the ported rules. The train step runs JAX's
configuration (tests/test_parallel.py:154-197: dim 64, 4 heads, B = 4,
AdamW lr 1e-3, grad_clip 1.0) on dp 2 x fsdp 2 x tp 2, fsdp 2 and tp 2,
with and without remat_blocks='attn', against JAX's unsharded step and
its step sharded by the rules at dp 2 x fsdp 2 x tp 2; every parameter is
gathered back whole (`sharding.full_tensor`). Adam's step does not see
the clip's scale (m / sqrt(v) is scale-free), so the clip's cross-rank
norm is held with the clip alone as the optimizer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_models import D128, np_params
from test_torch_parallel import (QWEN_CFG, SP_CFG, T5_CFG, _dit_case, _rand,
                                 _same_on_every_rank)
from torch_parallel_train_tasks import (NAFLEX_TEXT, NAFLEX_VISION,
                                        SIGLIP_TEXT, SIGLIP_VISION, TRAIN_CFG,
                                        TRAIN_GRID, _task_dit_tp,
                                        _task_qwen_tp, _task_scorer,
                                        _task_sp_tp_refusals, _task_t5_tp,
                                        _task_train, _task_train_refusals)
from torch_ranks import ranks  # noqa: F401
from univid_tpu.core.config import T5Config as JT5Config
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.core.mesh import MeshSpec as JMeshSpec
from univid_tpu.core.mesh import make_mesh as j_make_mesh
from univid_tpu.models.bagel import qwen2_mot as jq
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.dit import wan_dit_forward as j_dit
from univid_tpu.models.wan.t5 import encode_padded as j_encode_padded
from univid_tpu.models.wan.t5 import init_t5_encoder
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu.parallel import sharding as jsh
from univid_tpu.reflection import naflex as jn
from univid_tpu.reflection import scorer as jscorer
from univid_tpu.train import trainer as jtrainer
from univid_tpu_torch import convert
from univid_tpu_torch.core.mesh import MeshSpec
from univid_tpu_torch.parallel import sharding as tsh
from univid_tpu_torch.train import trainer as ttrainer

LOSS = dict(rtol=1e-5, atol=1e-6)
PARAM = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=2e-4, atol=2e-4)
SCORER = dict(rtol=1e-4, atol=1e-5)

MESHES = {"dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2),
          "fsdp2": dict(fsdp=2), "tp2": dict(tp=2)}


def _world(axes):
    return MeshSpec(**axes).size


def _jmesh(dp=1, fsdp=1, tp=1):
    spec = JMeshSpec(dp=dp, fsdp=fsdp, sp=1, tp=tp)
    return j_make_mesh(spec, devices=jax.devices()[:spec.size])


def _sd(tree):
    """A JAX DiT tree as the port's state dict (numpy, PyTorch layouts)."""
    return {k: v.float().numpy() for k, v in
            convert.jax_tree_to_state_dict(tree, "blocks").items()}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _train_case():
    """(params, batch) of tests/test_parallel.py's configuration, numpy."""
    jc = JDiTConfig(**TRAIN_CFG)
    params = np_params(init_wan_dit, jc, 0, stacked=True)
    b, (f, h, w) = 4, (TRAIN_GRID[0], 2 * TRAIN_GRID[1], 2 * TRAIN_GRID[2])
    batch = {"latents": _rand((b, f, h, w, jc.in_dim), 1),
             "context": _rand((b, jc.text_len, jc.text_dim), 2),
             "t": np.full((b,), 400.0, np.float32),
             "noise": _rand((b, f, h, w, jc.in_dim), 3)}
    return params, batch


@functools.lru_cache(maxsize=None)
def _jax_train(sharded, clip_only=False):
    """JAX's loss and parameters (state dict) after one step, unsharded or
    sharded by the rules at dp 2 x fsdp 2 x tp 2 with the batch over dp
    (as tests/test_parallel.py runs it); clip_only: the optimizer is
    clip_by_global_norm(1.0) alone (the update is the clipped gradient)."""
    params, batch = _train_case()
    jc = JDiTConfig(**TRAIN_CFG)
    rope = jrope3d(jc.head_dim, TRAIN_GRID)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = None
    if sharded:
        mesh = _jmesh(dp=2, fsdp=2, tp=2)
        params = jax.device_put(params, jsh.apply_sharding_rules(
            params, mesh, jsh.dit_param_sharding_rules()))
        jb = {k: jax.device_put(v, NamedSharding(mesh, P("dp")))
              for k, v in jb.items()}
    tx = optax.clip_by_global_norm(1.0) if clip_only else None
    state, tx = jtrainer.init_train_state(params, tx, learning_rate=1e-3)
    step = jtrainer.make_dit_train_step(jc, tx, mesh=mesh, rope=rope)
    if sharded:
        with mesh:
            state, loss = step(state, jb)
    else:
        state, loss = step(state, jb)
    return float(loss), _sd(jax.tree_util.tree_map(np.asarray,
                                                   state["params"]))


@pytest.mark.parametrize("remat", [False, "attn"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_train_step_matches_jax(mesh, remat, ranks):
    """One make_dit_train_step(mesh=...) step on the port's sharded model
    (its batch over dp x fsdp) against JAX's unsharded and sharded steps:
    the loss at rtol 1e-5 / atol 1e-6, every updated parameter at rtol
    1e-4 / atol 1e-5; the loss and parameters the same on every rank."""
    params, batch = _train_case()
    axes = MESHES[mesh]
    outs = ranks(_world(axes)).run(_task_train, axes, params, batch, remat)
    loss = _same_on_every_rank([np.float64(o[0]) for o in outs])
    for name in outs[0][2]:
        _same_on_every_rank([o[2][name] for o in outs])
    start = _sd(params)
    for sharded in (False, True):
        jloss, jparams = _jax_train(sharded)
        np.testing.assert_allclose(loss, jloss, **LOSS)
        assert set(jparams) == set(outs[0][2])
        for name, want in jparams.items():
            np.testing.assert_allclose(outs[0][2][name], want, err_msg=name,
                                       **PARAM)
    moved = [n for n, w in start.items()
             if not np.array_equal(outs[0][2][n], w)]
    assert len(moved) == len(start)


@pytest.mark.parametrize("mesh", ["dp2_fsdp2_tp2", "tp2"])
def test_clip_norm_needs_the_cross_rank_sum(mesh, ranks):
    """One step with clip_by_global_norm(1.0) as the optimizer: with the
    norm summed over the shards (global_sq_norm) the parameters match
    JAX's; with each rank's own sum of squares (its shards, without the
    all-reduce) the norm is another number and they do not."""
    params, batch = _train_case()
    _, jparams = _jax_train(False, True)
    axes = MESHES[mesh]
    right = ranks(_world(axes)).run(_task_train, axes, params, batch, False,
                                    True)
    local = ranks(_world(axes)).run(_task_train, axes, params, batch, False,
                                    True, True)
    assert right[0][1] > 1.0   # the clip is active
    assert abs(local[0][1] - right[0][1]) > 1e-2 * right[0][1]
    err = {}
    for name, want in jparams.items():
        np.testing.assert_allclose(right[0][2][name], want, err_msg=name,
                                   **PARAM)
        err[name] = np.abs(local[0][2][name] - want).max()
    assert max(err.values()) > 10 * PARAM["atol"]


def test_train_step_refuses_a_batch_that_does_not_split(ranks):
    """B = 3 over dp 2 x fsdp 2 raises a ValueError naming the sizes; an
    sp > 1 mesh raises the sequence-parallel training item's message."""
    params, batch = _train_case()
    for odd, sp in ranks(8).run(_task_train_refusals, params, batch):
        assert odd == "a batch of 3 does not split over dp 2 x fsdp 2 = 4 ranks"
        assert sp == ttrainer.SP_TRAIN_LATER
        assert "ROADMAP.md queue 1: Sequence-parallel training" in sp


# ---------------------------------------------------------------------------
# the tensor-parallel DiT forward
# ---------------------------------------------------------------------------

TP_DIT = {"tp2": (SP_CFG, dict(tp=2), False),
          "fsdp2_tp2": (SP_CFG, dict(fsdp=2, tp=2), False),
          "tp2_d128_fused": (D128, dict(tp=2), True)}


def _jax_dit_tp(cfg_kw, params, x, t, ctx, grid, t_zero, seq_pad_to, tp):
    """JAX's forward on the tree placed by dit_param_sharding_rules at tp."""
    jc = JDiTConfig(**cfg_kw)
    mesh = _jmesh(tp=tp)
    placed = jax.device_put(params, jsh.apply_sharding_rules(
        params, mesh, jsh.dit_param_sharding_rules()))
    cos, sin = jrope3d(jc.head_dim, grid)
    with mesh:
        return np.asarray(j_dit(
            placed, jc, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), cos,
            sin, t_zero_mask=None if t_zero is None else jnp.asarray(t_zero),
            seq_pad_to=seq_pad_to, policy=J_FP32))


@pytest.mark.parametrize("case", list(TP_DIT))
def test_tp_dit_forward_matches_jax(case, ranks):
    """wan_dit_forward on a DiT sharded over tp (and fsdp x tp): i2v with
    padded tokens, q / k / v / fc0 column- and o / fc1 row-parallel, the
    qk norm over the tp group; the d=128 case on the fused-rope route (the
    card's: the norm in the block, kernel A's rope-only mode in
    attention), one head a rank."""
    cfg_kw, axes, fused = TP_DIT[case]
    params, x, t, ctx, grid, t_zero, pad = _dit_case(cfg_kw, True, True)
    want = _jax_dit_tp(cfg_kw, params, x, t, ctx, grid, t_zero, pad,
                       axes["tp"])
    outs = ranks(_world(axes)).run(_task_dit_tp, cfg_kw, axes, params, x, t,
                                   ctx, grid, t_zero, pad, fused)
    dim = cfg_kw["dim"]
    for local, _ in outs:
        assert local == (dim // 2, dim // axes.get("fsdp", 1))
    got = _same_on_every_rank([o[1] for o in outs])
    np.testing.assert_allclose(got, want, **FWD)


def test_qk_norm_needs_the_cross_rank_sum(ranks):
    """Wan's qk norm spans all N * D of a token: at tp 2, each rank's sum
    of squares over its own N / 2 heads (without the all-reduce) gives
    another function than JAX's."""
    params, x, t, ctx, grid, t_zero, pad = _dit_case(SP_CFG, True, True)
    want = _jax_dit_tp(SP_CFG, params, x, t, ctx, grid, t_zero, pad, 2)
    outs = ranks(2).run(_task_dit_tp, SP_CFG, dict(tp=2), params, x, t, ctx,
                        grid, t_zero, pad, False, True)
    assert np.abs(outs[0][1] - want).max() > 1e-2


def test_sequence_and_tensor_parallelism_together_raise(ranks):
    """A tp-sharded DiT refuses the sequence-parallel forward, and a
    pipeline's mesh with sp and tp both > 1 is refused, citing the queue 1
    item by name."""
    params = _dit_case(SP_CFG, False, False)[0]
    for sp_fwd, mesh in ranks(4).run(_task_sp_tp_refusals, SP_CFG, params):
        assert sp_fwd == mesh == tsh.SP_TP_LATER
        assert ("ROADMAP.md queue 1: Sequence and tensor parallelism "
                "together") in mesh


# ---------------------------------------------------------------------------
# UMT5 at fsdp 4 x tp 2, Qwen2-MoT at fsdp 2 x tp 4
# ---------------------------------------------------------------------------


def test_t5_fsdp_tp_encode_matches_jax(ranks):
    """tests/test_parallel.py:268-297's configuration: UMT5 sharded at fsdp 4
    x tp 2, its heads and their position-bias columns split over tp."""
    cfg = JT5Config(**T5_CFG)
    params = np_params(init_t5_encoder, cfg, 0)
    ids = np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int64)
    lens = np.array([9, 16], np.int32)
    mesh = _jmesh(fsdp=4, tp=2)
    placed = jax.device_put(params, jsh.apply_sharding_rules(
        params, mesh, jsh.t5_param_sharding_rules()))
    with mesh:
        want = np.asarray(j_encode_padded(placed, cfg, jnp.asarray(ids),
                                          jnp.asarray(lens),
                                          compute_dtype=jnp.float32))
    got = _same_on_every_rank(ranks(8).run(_task_t5_tp, T5_CFG, params, ids, lens))
    np.testing.assert_allclose(got, want, **FWD)


def test_qwen2_mot_fsdp_tp_forward_matches_jax(ranks):
    """tests/test_parallel.py:233-266's configuration: the Qwen2-MoT prefill
    sharded at fsdp 2 x tp 4 (2 query heads over 1 kv head a rank), the
    und experts and the gen experts with und rows, and the LM head."""
    cfg = jq.Qwen2MoTConfig(**QWEN_CFG)
    params = np_params(jq.init_qwen2_mot, cfg, 0, stacked=False)
    x = _rand((16, cfg.hidden_size), 1)
    und_rows = np.array([0, 1, 2, 15], np.int64)
    mesh = _jmesh(fsdp=2, tp=4)
    placed = jax.device_put(params, jsh.apply_sharding_rules(
        params, mesh, jsh.bagel_llm_param_sharding_rules()))
    want = []
    with mesh:
        for mode, rows in (("und", None), ("gen", und_rows)):
            cache = jq.init_kv_cache(cfg, 64, dtype=jnp.float32)
            h, _ = jq.qwen2_mot_forward(
                placed, cfg, jnp.asarray(x), jnp.arange(16), cache, mode=mode,
                und_rows=None if rows is None else jnp.asarray(rows),
                compute_dtype=jnp.float32)
            want.append(np.asarray(h))
        want.append(np.asarray(jq.lm_head_logits(placed, cfg, h,
                                                 compute_dtype=jnp.float32)))
    outs = ranks(8).run(_task_qwen_tp, QWEN_CFG, params, x, und_rows)
    for i, w in enumerate(want):
        np.testing.assert_allclose(_same_on_every_rank([o[i] for o in outs]),
                                   w, **FWD)


# ---------------------------------------------------------------------------
# the dp-sharded scorers
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_scorer(kind):
    """(JAX scorer, its trees as numpy)."""
    if kind == "siglip":
        j = jscorer.Siglip2Scorer(
            vision_cfg=JSiglipConfig(**SIGLIP_VISION),
            text_cfg=jscorer.SiglipTextConfig(**SIGLIP_TEXT), image_size=32,
            seed=0)
        return j, (_np_tree(j.vision_params), _np_tree(j.text_params),
                   _np_tree(j.img_proj))
    j = jn.Siglip2NaflexScorer(vision_cfg=jn.NaflexVisionConfig(**NAFLEX_VISION),
                               text_cfg=jn.NaflexTextConfig(**NAFLEX_TEXT))
    return j, (_np_tree(j.vision_params), _np_tree(j.text_params))


def _frames(kind):
    """11 frames (a pad at dp 2 and at dp 4); NaFlex's of two shapes."""
    if kind == "siglip":
        return [np.random.default_rng(i).integers(0, 255, (40, 56, 3),
                                                  np.uint8)
                for i in range(11)]
    return [np.random.default_rng(i).integers(
        0, 255, (24, 36, 3) if i % 3 else (50, 13, 3), np.uint8)
        for i in range(11)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["siglip", "naflex"])
def test_dp_sharded_scorer_matches_jax(kind, world, ranks):
    """Siglip2Scorer / Siglip2NaflexScorer(mesh=) at dp 2 and 4 on 11
    frames: each batch padded to a multiple of dp by repeating its last
    frame, each rank embedding its share, the embeddings all-gathered and
    the pad dropped; every rank returns all of them, equal to JAX's serial
    scorer at tests/test_parallel.py's tolerance."""
    j, trees = _jax_scorer(kind)
    frames = _frames(kind)
    want = j.emb_imgs(frames, bs=8)
    got = _same_on_every_rank(ranks(world).run(_task_scorer, kind, trees,
                                               frames))
    assert got.shape == want.shape == (11, want.shape[1])
    np.testing.assert_allclose(got, want, **SCORER)
