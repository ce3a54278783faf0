"""The port's training slice against univid_tpu's: LoRA, projector,
optimizer, DiT gradients under the three remat modes, the diffusion and DiT
train steps, the semantic loop, and grad-free serving. Parameters come
from the JAX init functions (or np_params) and reach the port through
univid_tpu_torch.convert; inputs are numpy arrays from a seed.

Tolerances (fp32 throughout, JAX matmuls pinned to the highest precision
by conftest): forwards and losses 1e-5 relative (summation order);
gradients 2e-4 relative + 1e-6 absolute (summation orders through two
blocks and the attention backward); parameters after AdamW steps 1e-5
relative + 1e-6 absolute (Adam divides by sqrt(v), so a gradient's
relative error becomes the update's, at lr <= 3e-3); the three remat modes
of the port agree with each other to 1e-6 (the same operations, rerun).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import univid_tpu.kernels.flash_attention as jfa
from test_torch_models import D128, np_params
from univid_tpu.core.config import FusionConfig as JFusionConfig
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.models.fusion import projector as jproj
from univid_tpu.models.wan.dit import init_wan_dit, wan_dit_forward
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu.train import fusion_trainer as jft
from univid_tpu.train import lora as jlora
from univid_tpu.train import trainer as jtrainer
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import FusionConfig, WAN_CONFIGS
from univid_tpu_torch.core.config import WanDiTConfig
from univid_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from univid_tpu_torch.kernels import attention as tatt
from univid_tpu_torch.models.fusion import projector as tproj
from univid_tpu_torch.models.wan.dit import wan_dit_forward as t_dit
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d
from univid_tpu_torch.train import fusion_trainer as tft
from univid_tpu_torch.train import lora as tlora
from univid_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
GRAD = dict(rtol=2e-4, atol=1e-6)
PARAM = dict(rtol=1e-5, atol=1e-6)
FUSION_KW = dict(bagel_hidden_dim=16, wan_text_dim=24, wan_text_length=8,
                 bagel_sequence_length=6, projector_hidden_mult=2)
STRATEGIES = ["wan_cross_attention", "smart_wan_dit", "cross_attention_only",
              "attention_only", "minimal_cross_attention",
              "attention_focused", "balanced"]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _sd(tree, stacked=None):
    """A JAX tree as the port's state dict (numpy, PyTorch layouts)."""
    return {k: v.float().numpy()
            for k, v in convert.jax_tree_to_state_dict(tree, stacked).items()}


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_select_targets_matches_jax(strategy):
    """All seven strategies (the last one the default branch) on the
    t2v-1.3B config: the same targets in the same order, the clamp to 50,
    the same per-site masks."""
    jc, tc = JCONFIGS["t2v-1.3B"].dit, WAN_CONFIGS["t2v-1.3B"].dit
    assert tlora.select_targets(tc, strategy) == \
        jlora.select_targets(jc, strategy)
    tm, jm = tlora.site_masks(tc, strategy), jlora.site_masks(jc, strategy)
    assert sorted(tm) == sorted(jm)
    for site in jm:
        np.testing.assert_array_equal(tm[site], jm[site])


def _jax_lora(cfg, rank=4, strategy="wan_cross_attention", seed=3):
    """A JAX LoRA tree with non-zero b, so the merge moves the weights."""
    lora = jlora.init_lora(jax.random.PRNGKey(seed), cfg,
                           jlora.LoRAConfig(rank=rank,
                                            target_strategy=strategy))
    for i, p in enumerate(lora["sites"].values()):
        p["b"] = jnp.asarray(_rand(p["b"].shape, 40 + i, 0.1))
    return lora


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(dtype):
    """merge_lora: w + scale * mask * (a b)^T in fp32, one rounding to the
    base dtype; only masked layers are returned (elsewhere JAX's merge is
    the base weight itself); differentiable in a and b, base frozen."""
    jc, tc = JDiTConfig(**D128), WanDiTConfig(**D128)
    params = np_params(init_wan_dit, jc, 1, stacked=True)
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                        params)
    jl = _jax_lora(jc)
    want = _sd({"blocks": jlora.merge_lora(params, jl)["blocks"]}, "blocks")
    base = _sd({"blocks": params["blocks"]}, "blocks")
    dit = convert.dit_from_jax(params, tc, device="cpu")
    tl = convert.lora_from_jax(jl, device="cpu")
    sites = tlora.trainable_sites(tl)
    got = tlora.merge_lora(dit, tl, sites=sites)
    masks = jlora.site_masks(jc, "wan_cross_attention")
    n_merged = 0
    for site, mask in masks.items():
        mod, proj = site.split("/")
        for layer in range(jc.num_layers):
            key = f"blocks.{layer}.{mod}.{proj}.w"
            if mask[layer]:
                n_merged += 1
                np.testing.assert_allclose(
                    got[key].detach().float().numpy(), want[key],
                    rtol=1e-6 if dtype == "float32" else 2 ** -8, atol=1e-7)
            else:
                assert key not in got
                np.testing.assert_array_equal(want[key], base[key])
    assert len(got) == n_merged > 0
    loss = sum(w.float().sum() for w in got.values())
    loss.backward()
    assert all(p["b"].grad is not None for p in sites.values())
    assert all(not p.requires_grad for p in dit.parameters())


def test_lora_files_load_across_packages(tmp_path):
    """An adapter saved by either package loads in the other, leaf for
    leaf (the same npz + json files)."""
    jc = JCONFIGS["tiny"].dit
    jl = _jax_lora(jc, rank=2)
    jcfg = jlora.LoRAConfig(rank=2)
    jlora.save_lora(str(tmp_path / "j"), jl, jcfg)
    tl, tcfg = tlora.load_lora(str(tmp_path / "j"), device="cpu")
    assert (tcfg.rank, tcfg.alpha, tcfg.target_strategy) == \
        (jcfg.rank, jcfg.alpha, jcfg.target_strategy)
    for site, p in jl["sites"].items():
        for leaf in ("a", "b", "mask"):
            np.testing.assert_array_equal(tl["sites"][site][leaf].numpy(),
                                          np.asarray(p[leaf]))
    tlora.save_lora(str(tmp_path / "t"), tl, tcfg)
    back, bcfg = jlora.load_lora(str(tmp_path / "t"))
    assert bcfg == jcfg
    for site, p in jl["sites"].items():
        for leaf in ("a", "b", "mask"):
            np.testing.assert_array_equal(np.asarray(back["sites"][site][leaf]),
                                          np.asarray(p[leaf]))


# ---------------------------------------------------------------------------
# projector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,tgt", [(6, 8), (8, 6), (7, 512), (5, 5)])
def test_adapt_sequence_length_matches_jax_and_interpolate(src, tgt):
    x = _rand((2, src, 3), 5)
    got = tproj.adapt_sequence_length(torch.as_tensor(x), tgt)
    want = np.asarray(jproj.adapt_sequence_length(jnp.asarray(x), tgt))
    ref = F.interpolate(torch.as_tensor(x).transpose(1, 2), size=tgt,
                        mode="linear", align_corners=False).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_projector_forward_and_loss_match_jax():
    jcfg, tcfg = JFusionConfig(**FUSION_KW), FusionConfig(**FUSION_KW)
    params = jproj.init_context_projector(jax.random.PRNGKey(0), jcfg)
    # non-trivial LayerNorm affines
    params["ln0"]["w"] = jnp.asarray(_rand((48,), 1, 0.2) + 1.0)
    params["ln1"]["b"] = jnp.asarray(_rand((24,), 2, 0.1))
    tokens = _rand((2, 6, 16), 3)
    sup = _rand((2, 10, 24), 4)
    proj = convert.projector_from_jax(params, tcfg, device="cpu")
    got = tproj.context_projector_forward(proj, tcfg, torch.as_tensor(tokens))
    want = jproj.context_projector_forward(params, jcfg, jnp.asarray(tokens))
    assert got.shape == (2, 8, 24)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    gl = tproj.projector_training_loss(proj, tcfg, torch.as_tensor(tokens),
                                       torch.as_tensor(sup))
    jl = jproj.projector_training_loss(params, jcfg, jnp.asarray(tokens),
                                       jnp.asarray(sup))
    for key in jl:
        np.testing.assert_allclose(float(gl[key].detach()), float(jl[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("one_cycle", [True, False])
def test_optimizer_matches_optax(one_cycle):
    """make_fusion_optimizer (clip + AdamW + schedule) fed the same five
    gradients as the optax chain: the same parameters after every step.
    Gradients 0 and 3 are scaled past the clip norm, the others not."""
    cfg_kw = dict(learning_rate=3e-3, max_steps=10,
                  use_one_cycle_lr=one_cycle, weight_decay=1e-2)
    jtx = jft.make_fusion_optimizer(jft.FusionTrainConfig(**cfg_kw))
    ttx = tft.make_fusion_optimizer(tft.FusionTrainConfig(**cfg_kw))
    p0 = {"a": _rand((3, 4), 0), "b": _rand((5,), 1)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = [torch.as_tensor(p0[k]).clone() for k in sorted(p0)]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(5):
        scale = 10.0 if i in (0, 3) else 0.05
        g = {"a": _rand((3, 4), 10 + i, scale), "b": _rand((5,), 20 + i,
                                                           scale)}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = ttx.update([torch.as_tensor(g[k]) for k in sorted(g)],
                                  tstate, tp)
        tft.optim.apply_updates(tp, tupd)
        for k, t in zip(sorted(p0), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       err_msg=f"step {i} {k}", **PARAM)


def test_schedules_match_optax():
    from univid_tpu_torch.train import optim
    pairs = [
        (optim.cosine_onecycle_schedule(20, 1e-3, pct_start=0.1),
         optax.cosine_onecycle_schedule(20, 1e-3, pct_start=0.1)),
        (optim.cosine_decay_schedule(1e-3, 20, alpha=0.1),
         optax.cosine_decay_schedule(1e-3, 20, alpha=0.1)),
    ]
    for t, j in pairs:
        for count in range(25):
            # optax evaluates in fp32, the port in float64
            np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-5)


# ---------------------------------------------------------------------------
# DiT gradients under remat
# ---------------------------------------------------------------------------


def _dit_case(model):
    if model == "tiny":
        jc, tc = JCONFIGS["tiny"].dit, WAN_CONFIGS["tiny"].dit
        x = _rand((1, 3, 8, 8, jc.in_dim), 0)
        grid = (3, 4, 4)
    else:
        jc, tc = JDiTConfig(**D128), WanDiTConfig(**D128)
        x = _rand((1, 2, 8, 8, 16), 0)
        grid = (2, 4, 4)
    params = np_params(init_wan_dit, jc, 1, stacked=True)
    params["head"]["head"]["w"] = jnp.asarray(
        _rand(params["head"]["head"]["w"].shape, 9, 0.02))
    t = np.array([500.0], np.float32)
    ctx = _rand((1, jc.text_len, jc.text_dim), 2, 0.5)
    return jc, tc, params, x, t, ctx, grid


@pytest.mark.parametrize("model", ["tiny", "d128"])
def test_dit_grads_all_remat_modes_match_jax(model, monkeypatch):
    """d mean(v^2) / d params, FP32_POLICY (bounded softmax at d=128):
    remat_blocks False, True and 'attn' agree with each other and with
    jax.grad of JAX wan_dit_forward (tiny: the reference route; d128: the
    kernel route, JAX on its Pallas custom VJP in interpret mode, with
    seq_pad_to so kv_len masks padded keys). At d=128 the forward-with-lse
    calls are counted: 'attn' reruns the cross-attention forward only."""
    jc, tc, params, x, t, ctx, grid = _dit_case(model)
    jpol = dataclasses.replace(J_FP32, bounded_softmax=True)
    tpol = dataclasses.replace(FP32_POLICY, bounded_softmax=True)
    kw = dict(seq_pad_to=64) if model == "d128" else {}
    cos, sin = jrope3d(jc.head_dim, grid)

    def jloss(p):
        v = wan_dit_forward(p, jc, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx), cos, sin, policy=jpol, **kw)
        return jnp.mean(jnp.square(v))

    if model == "d128":
        jbackend("pallas")
        jfa.set_interpret_mode(True)
    try:
        jl, jg = jax.value_and_grad(jloss)(params)
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    want = _sd(jg, "blocks")

    calls = []
    real = tatt.flash_attention_fwd_folded
    monkeypatch.setattr(tatt, "flash_attention_fwd_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    dit = convert.dit_from_jax(params, tc, device="cpu").requires_grad_(True)
    tcos, tsin = trope3d(tc.head_dim, grid, device="cpu")
    grads = {}
    for remat in (False, True, "attn"):
        calls.clear()
        v = t_dit(dit, torch.as_tensor(x), torch.as_tensor(t),
                  torch.as_tensor(ctx), tcos, tsin, policy=tpol,
                  remat_blocks=remat, **kw)
        loss = v.square().mean()
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-5)
        names, ps = zip(*dit.named_parameters())
        grads[remat] = dict(zip(names, torch.autograd.grad(loss, ps)))
        if model == "d128":   # 2 layers: self + cross forwards, + recompute
            assert len(calls) == {False: 4, True: 8, "attn": 6}[remat]
    for name, w in want.items():
        for remat in (False, True, "attn"):
            np.testing.assert_allclose(grads[remat][name].numpy(), w,
                                       err_msg=f"remat={remat} {name}",
                                       **GRAD)
            np.testing.assert_allclose(grads[remat][name].numpy(),
                                       grads[False][name].numpy(),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("remat", [False, True, "attn"])
def test_attention_routes_per_remat_mode(remat, monkeypatch):
    """A frozen base DiT whose only trainable input is the context (as with
    LoRA on cross-attention and the projector): the attention calls per
    step that PERF.md states and chip_smoke.py asserts, for L = 2 layers.
    Layer 0's self-attention has no trainable upstream, so it takes the
    serving route and gets no backward; every other call takes the forward
    with lse and one backward; remat True reruns each block's forwards in
    the backward, 'attn' only the cross-attention."""
    tc = WanDiTConfig(**D128)
    calls = {"serve": 0, "lse": 0, "bwd": 0}
    for key, name in (("serve", "flash_attention_padded"),
                      ("lse", "flash_attention_fwd_folded"),
                      ("bwd", "flash_attention_bwd_folded")):
        real = getattr(tatt, name)
        monkeypatch.setattr(tatt, name, lambda *a, _k=key, _f=real, **kw:
                            calls.__setitem__(_k, calls[_k] + 1)
                            or _f(*a, **kw))
    from univid_tpu_torch.models.wan.dit import WanDiT
    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(tc, device="cpu", gen=gen)
    assert not any(p.requires_grad for p in dit.parameters())
    ctx = torch.as_tensor(_rand((1, tc.text_len, tc.text_dim), 2)) \
        .requires_grad_(True)
    cos, sin = trope3d(tc.head_dim, (2, 4, 4), device="cpu")
    v = t_dit(dit, torch.as_tensor(_rand((1, 2, 8, 8, 16), 0)),
              torch.tensor([500.0]), ctx, cos, sin, policy=FP32_POLICY,
              remat_blocks=remat)
    torch.autograd.grad(v.square().mean(), ctx)
    n = tc.num_layers
    fwd_runs = 2 if remat is True else 1
    assert calls == {"serve": fwd_runs,
                     "lse": fwd_runs * (n - 1) + (1 if remat is False
                                                  else 2) * n,
                     "bwd": 2 * n - 1}


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def _diffusion_setup():
    spec, tspec = JCONFIGS["tiny"], WAN_CONFIGS["tiny"]
    fkw = dict(FUSION_KW, wan_text_dim=spec.dit.text_dim,
               wan_text_length=spec.dit.text_len)
    jfusion, tfusion = JFusionConfig(**fkw), FusionConfig(**fkw)
    cfg_kw = dict(max_steps=8, learning_rate=3e-3, train_lora=True)
    jcfg, tcfg = jft.FusionTrainConfig(**cfg_kw), \
        tft.FusionTrainConfig(**cfg_kw)
    base = init_wan_dit(jax.random.PRNGKey(0), spec.dit)
    # the zero-init head blocks every gradient: redraw it, as a checkpoint
    # would have it
    base["head"]["head"]["w"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(50), base["head"]["head"]["w"].shape)
    lcfg = jlora.LoRAConfig(rank=2)
    jstate, jtx, jtmpl = jft.init_fusion_train_state(
        jax.random.PRNGKey(2), jfusion, jcfg, dit_cfg=spec.dit,
        lora_cfg=lcfg)
    f, h, w = 3, 8, 8
    batch = {"latents": _rand((1, f, h, w, 4), 3),
             "bagel_tokens": _rand((1, 6, 16), 4),
             "noise": _rand((1, f, h, w, 4), 5),
             "t": np.array([400.0], np.float32)}
    return (spec, tspec, jfusion, tfusion, jcfg, tcfg, base, jstate, jtx,
            jtmpl, (f, h, w), batch)


@pytest.mark.parametrize("policy", ["fp32", "default"])
def test_diffusion_step_matches_jax(policy):
    """Three steps of make_diffusion_train_step in both packages from the
    same converted state and batch: per-step losses and the trainables
    agree; the frozen base is bit-identical after the steps; LoRA b moved
    off zero. FP32_POLICY: losses to 1e-5, trainables to 1e-5 + 1e-6.
    The default bf16 policy rounds every GEMM to bf16 at the same points
    in both packages, but the two frameworks accumulate in other orders,
    so gradients agree only to ~1e-2 (measured 0.5-0.7% relative L2 on
    the first step): the losses are held to 1e-2 relative, the trainables
    only under fp32 (Adam's sign-like first steps turn a gradient element
    near zero into a full lr-sized update of either sign)."""
    (spec, tspec, jfusion, tfusion, jcfg, tcfg, base, jstate, jtx, jtmpl,
     grid, batch) = _diffusion_setup()
    fp32 = policy == "fp32"
    jstep, _ = jft.make_diffusion_train_step(
        spec, jfusion, jcfg, jtx, base, None, grid, lora_template=jtmpl,
        policy=J_FP32 if fp32 else J_DEFAULT)
    dit = convert.dit_from_jax(base, tspec.dit, device="cpu")
    snapshot = {k: v.clone() for k, v in dit.state_dict().items()}
    ttmpl = convert.lora_from_jax(jtmpl, device="cpu")
    trainable = {"projector": convert.projector_from_jax(
        jstate["trainable"]["projector"], tfusion, device="cpu"),
        "lora": tlora.trainable_sites(ttmpl)}
    ttx = tft.make_fusion_optimizer(tcfg)
    tstate = tft.new_train_state(trainable, ttx)
    tstep, _ = tft.make_diffusion_train_step(
        tspec, tfusion, tcfg, ttx, dit, None, grid, lora_template=ttmpl,
        policy=FP32_POLICY if fp32 else DEFAULT_POLICY)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jloss = jstep(jstate, jb)
        tstate, tloss = tstep(tstate, tb)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=1e-5 if fp32 else 1e-2,
                                   err_msg=f"step {i}")
    assert tstate["step"] == 3
    jp = jstate["trainable"]
    want = {f"projector.{n}": w for n, w in _sd(jp["projector"]).items()}
    want.update({f"lora.{site}.{leaf}": np.asarray(p[leaf])
                 for site, p in jp["lora"].items() for leaf in ("a", "b")})
    got = dict(tft.named_leaves(tstate["trainable"]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if fp32:
            np.testing.assert_allclose(got[name].detach().numpy(), w,
                                       err_msg=name, **PARAM)
    for k, v in dit.state_dict().items():
        assert torch.equal(v, snapshot[k]), k
    b = tstate["trainable"]["lora"]["cross_attn/q"]["b"]
    assert float(b.detach().abs().max()) > 0


def test_dit_train_step_matches_jax():
    """Two full fine-tune steps (make_dit_train_step, every DiT parameter
    trained, AdamW lr 1e-3 with weight decay): the losses agree, and so do
    the parameters: the change of each tensor to 1e-4 relative L2, each
    element to 1e-5 relative + 1e-5 absolute. Adam moves an element by
    about lr * g / |g| whatever |g|, so an element whose gradient is at the
    level of fp32 summation noise moves by a rounding-dependent part of lr:
    the absolute term is 1% of lr."""
    jc, tc, params, x, t, ctx, grid = _dit_case("tiny")
    cos, sin = jrope3d(jc.head_dim, grid)
    jstate, jtx = jtrainer.init_train_state(
        params, jtrainer.make_optimizer(1e-3))
    jstep = jtrainer.make_dit_train_step(jc, jtx, rope=(cos, sin))
    dit = convert.dit_from_jax(params, tc, device="cpu")
    start = _sd(params, "blocks")
    tstate, ttx = ttrainer.init_train_state(dit, ttrainer.make_optimizer(1e-3))
    tstep = ttrainer.make_dit_train_step(
        tc, ttx, rope=trope3d(tc.head_dim, grid, device="cpu"))
    noise = _rand(x.shape, 7)
    batch = {"latents": x, "noise": noise, "t": t, "context": ctx}
    for i in range(2):
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tstate, tloss = tstep(tstate, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = dict(dit.named_parameters())
    for name, w in _sd(jstate["params"], "blocks").items():
        g = got[name].detach().numpy()
        np.testing.assert_allclose(g, w, err_msg=name, rtol=1e-5, atol=1e-5)
        moved = w - start[name]
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(moved), name


# ---------------------------------------------------------------------------
# the loop (mirrors tests/test_fusion_trainer.py)
# ---------------------------------------------------------------------------


def _fake_encoders():
    def extract(caption):
        seed = sum(map(ord, caption))
        return torch.as_tensor(_rand((6, FUSION_KW["bagel_hidden_dim"]), seed))

    def supervise(caption):
        seed = sum(map(ord, caption + "t5"))
        return torch.as_tensor(_rand((8, FUSION_KW["wan_text_dim"]), seed))

    return extract, supervise


def test_semantic_loop_decreases_loss_and_resumes(tmp_path):
    """20 semantic steps lower the loss; a resume continues from the saved
    step to the raised cap, running only the new steps."""
    fusion = FusionConfig(**FUSION_KW)
    extract, supervise = _fake_encoders()
    data = [{"caption": f"a video of thing number {i}"} for i in range(4)]
    cfg = tft.FusionTrainConfig(max_steps=20, save_interval=10,
                                learning_rate=3e-3, train_lora=False)
    out = tft.train_cross_attention_fusion(
        data, extract, supervise, fusion, cfg, str(tmp_path), device="cpu")
    assert out["steps"] == 20
    assert np.mean(out["losses"][-4:]) < np.mean(out["losses"][:4])
    assert os.path.exists(tmp_path / "latest" / "train_state.npz")
    cfg2 = dataclasses.replace(cfg, max_steps=24)
    out2 = tft.train_cross_attention_fusion(
        data, extract, supervise, fusion, cfg2, str(tmp_path), device="cpu")
    assert out2["steps"] == 24 and len(out2["losses"]) == 4


def test_save_load_state_identical(tmp_path):
    fusion = FusionConfig(**FUSION_KW)
    cfg = tft.FusionTrainConfig(max_steps=5, train_lora=False)
    gen = torch.Generator().manual_seed(0)
    state, tx, _ = tft.init_fusion_train_state(gen, fusion, cfg,
                                               device="cpu")
    step = tft.make_semantic_train_step(fusion, tx)
    state, _, _ = step(state, torch.as_tensor(_rand((1, 6, 16), 1)),
                       torch.as_tensor(_rand((1, 8, 24), 2)))
    tft.save_train_state(str(tmp_path / "ck"), state)
    template, _, _ = tft.init_fusion_train_state(
        torch.Generator().manual_seed(7), fusion, cfg, device="cpu")
    restored = tft.load_train_state(str(tmp_path / "ck"), template)
    assert restored["step"] == state["step"] == 1
    assert float(restored["best_loss"]) == float(state["best_loss"])
    a = tft._state_arrays(state)
    b = tft._state_arrays(restored)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_diffusion_loop_writes_checkpoints_and_adapter(tmp_path):
    """train_cross_attention_fusion(diffusion=...) on the tiny DiT + VAE:
    train_lora without diffusion is refused; the run writes latest/, best/
    and a lora_best/ adapter that the JAX package loads and that moves the
    targeted weights."""
    tspec = WAN_CONFIGS["tiny"]
    fusion = FusionConfig(**dict(FUSION_KW, wan_text_dim=tspec.dit.text_dim,
                                 wan_text_length=tspec.dit.text_len))
    cfg = tft.FusionTrainConfig(max_steps=4, learning_rate=3e-3,
                                save_interval=2)
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.models.wan.vae_api import WanVAE
    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(tspec.dit, device="cpu", gen=gen)
    with torch.no_grad():
        dit.head.head.w.normal_(0.0, 0.02, generator=gen)
    vae = WanVAE(tspec.vae, device="cpu", gen=gen)
    extract, _ = _fake_encoders()
    data = [{"caption": f"sample {i}",
             "video": np.clip(_rand((5, 64, 64, 3), i, 0.5), -1, 1)}
            for i in range(2)]
    lcfg = tlora.LoRAConfig(rank=2, target_strategy="cross_attention_only")
    with pytest.raises(ValueError, match="trains nothing"):
        tft.train_cross_attention_fusion(
            data, extract, None, fusion, cfg, str(tmp_path / "bad"),
            dit_cfg=tspec.dit, lora_cfg=lcfg, device="cpu")
    out = tft.train_cross_attention_fusion(
        data, extract, None, fusion, cfg, str(tmp_path / "run"),
        dit_cfg=tspec.dit, lora_cfg=lcfg, device="cpu",
        diffusion={"spec": tspec, "dit": dit, "vae": vae,
                   "latent_grid": (2, 4, 4), "remat_blocks": "attn"})
    assert out["steps"] == 4 and all(np.isfinite(out["losses"]))
    for sub in ("latest", "best"):
        assert os.path.exists(tmp_path / "run" / sub / "train_state.npz")
    trained, jcfg = jlora.load_lora(str(tmp_path / "run" / "lora_best"))
    assert jcfg.rank == 2
    assert np.abs(np.asarray(trained["sites"]["cross_attn/q"]["b"])).max() > 0


# ---------------------------------------------------------------------------
# serving stays grad-free
# ---------------------------------------------------------------------------


def test_t2v_serving_is_grad_free(monkeypatch):
    """With every DiT parameter trainable, a t2v denoise run on the kernel
    route (d=128 heads) returns a latent without grad and never enters the
    training attention (no forward-with-lse, no backward)."""
    from univid_tpu_torch.core.config import WanModelSpec
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.models.wan.vae_api import WanVAE, vae_decode
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline

    base = WAN_CONFIGS["tiny"]
    dcfg = WanDiTConfig(model_type="t2v", in_dim=4, out_dim=4, dim=256,
                        ffn_dim=256, freq_dim=32, text_dim=64, num_heads=2,
                        num_layers=1, text_len=16)
    spec = WanModelSpec(name="t2v-d128", dit=dcfg, vae=base.vae,
                        generation=base.generation, t5=base.t5, text_len=16)
    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(dcfg, device="cpu", gen=gen).requires_grad_(True)
    vae = WanVAE(base.vae, device="cpu", gen=gen)
    entered = []
    monkeypatch.setattr(tatt.FlashAttention, "forward",
                        lambda *a, **k: entered.append(1))
    pipe = WanTI2VPipeline(spec, dit, vae, policy=DEFAULT_POLICY)
    fn = pipe.denoise_fn((3, 4, 4), 48, 2, 5.0, 5.0, "unipc", None)
    noise = torch.as_tensor(_rand((1, 3, 4, 4, 4), 1))
    ctx = torch.as_tensor(_rand((1, 16, 64), 2, 0.5))
    out = fn(dit, noise, ctx, ctx, torch.zeros_like(noise))
    video = vae_decode(vae, out)
    assert not out.requires_grad and out.grad_fn is None
    assert not video.requires_grad
    assert not entered and bool(torch.isfinite(out).all())
