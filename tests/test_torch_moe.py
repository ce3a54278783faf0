"""The port's A14B dual-expert pipeline (univid_tpu_torch/pipelines/moe.py)
against univid_tpu.pipelines.moe, and its CLI.

Both packages get the same two expert trees (numpy, converted for the port
by convert.dit_from_jax), the same VAE tree and contexts, and JAX's own
noise draw (`jax.random.normal(PRNGKey(seed))`, passed to the port through
`noise=`). fp32 policy on both sides: latents and videos within 1e-4, as
tests/test_torch_pipeline.py holds the single-DiT slice. The d=128 case
takes the kernel route (fused rope, bounded softmax) with JAX on its Pallas
kernels in interpret mode, as tests/test_attention.py runs them. Then the
counterparts of tests/test_moe.py on the port alone.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import univid_tpu.kernels.flash_attention as jfa
from test_torch_models import D128, np_params
from univid_tpu.core.config import TMAConfig as JTMA
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.vae_api import init_wan_vae
from univid_tpu.ops.samplers import flow_sigmas as j_flow_sigmas
from univid_tpu.pipelines.moe import WanMoEPipeline as JMoE
from univid_tpu.pipelines.moe import first_frame_mask as j_first_frame_mask
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import (TMAConfig, WAN_CONFIGS,
                                          WanDiTConfig, latent_shape)
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.core.mesh import MeshSpec, make_mesh
from univid_tpu_torch.ops.samplers import flow_sigmas
from univid_tpu_torch.pipelines.moe import (WanMoEPipeline,
                                            expert_schedule,
                                            first_frame_mask)
from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _specs(case):
    """(JAX spec, port spec, size, frames, steps) of a parity case."""
    if case == "d128":
        # 2 blocks, 2 heads of d=128 and the 16-channel stride-(4, 8, 8)
        # VAE grid: 128x128x13 -> latent 4 x 16 x 16 -> 256 tokens
        base_j, base_t = JCONFIGS["t2v-A14B"], WAN_CONFIGS["t2v-A14B"]
        return (dataclasses.replace(base_j, dit=JDiTConfig(**D128)),
                dataclasses.replace(base_t, dit=WanDiTConfig(**D128)),
                (128, 128), 13, 2)
    return JCONFIGS[case], WAN_CONFIGS[case], (64, 64), 9, 4


def _trees(jspec, seed=0):
    """Two expert trees (their heads random: init_wan_dit's zero head gives
    velocity 0) and, for the tiny configs, a VAE tree."""
    low = np_params(init_wan_dit, jspec.dit, seed, stacked=True)
    high = np_params(init_wan_dit, jspec.dit, seed + 1, stacked=True)
    vae = (np_params(init_wan_vae, jspec.vae, seed + 2)
           if jspec.vae.z_dim == 4 else None)
    return low, high, vae


def _port(tspec, low, high, vae, policy=FP32_POLICY):
    return WanMoEPipeline(
        tspec, convert.dit_from_jax(low, tspec.dit, device="cpu"),
        convert.dit_from_jax(high, tspec.dit, device="cpu"),
        None if vae is None else convert.vae_from_jax(vae, tspec.vae,
                                                      device="cpu"),
        policy=policy)


def _jax_noise(spec, size, frames, seed):
    c, f, h, w = latent_shape(spec, size[0], size[1], frames)
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (1, f, h, w, c), jnp.float32))


@pytest.mark.parametrize("case", ["tiny-moe-t2v", "tiny-moe-i2v", "d128"])
def test_moe_pipeline_matches_jax(case):
    """4 UniPC steps (2 high, 2 low at shift 5) with a (low, high) guide
    scale of (3, 6) and TMA: the latent (decode=False) and the decoded
    video within 1e-4; the d=128 case 2 steps (one an expert), latent only,
    JAX on its Pallas kernels in interpret mode."""
    jspec, tspec, size, frames, steps = _specs(case)
    low, high, vae = _trees(jspec)
    rng = np.random.default_rng(3)
    text = (jspec.dit.text_len, jspec.dit.text_dim)
    ctx = (rng.standard_normal(text) * 0.5).astype(np.float32)
    nctx = (rng.standard_normal(text) * 0.5).astype(np.float32)
    img = (rng.uniform(-1, 1, (size[1], size[0], 3)).astype(np.float32)
           if case.endswith("i2v") else None)
    tma = dict(enabled=True, weight_max=1.3, text_prefix_len=text[0])
    kw = dict(size=size, frame_num=frames, shift=5.0, sampling_steps=steps,
              guide_scale=(3.0, 6.0), seed=7)
    decodes = (False,) if vae is None else (False, True)
    jpol = J_FP32
    tpol = FP32_POLICY
    if case == "d128":
        jpol = dataclasses.replace(jpol, bounded_softmax=True)
        tpol = dataclasses.replace(tpol, bounded_softmax=True)
        jbackend("pallas")
        jfa.set_interpret_mode(True)
    try:
        jpipe = JMoE(jspec, low, high, vae, policy=jpol, dispatch_steps=0)
        want = [np.asarray(jpipe.generate(
            jnp.asarray(ctx), jnp.asarray(nctx), tma=JTMA(**tma),
            img=None if img is None else jnp.asarray(img), decode=d, **kw))
            for d in decodes]
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    tpipe = _port(tspec, low, high, vae, policy=tpol)
    noise = torch.as_tensor(_jax_noise(tspec, size, frames, kw["seed"]))
    for d, w in zip(decodes, want):
        got = tpipe.generate(
            torch.as_tensor(ctx), torch.as_tensor(nctx), tma=TMAConfig(**tma),
            img=None if img is None else torch.as_tensor(img), decode=d,
            noise=noise, **kw)
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, **TOL)


@pytest.mark.parametrize("model", ["t2v-A14B", "i2v-A14B", "tiny-moe-t2v"])
def test_boundary_schedule(model):
    """The expert and guide scale of each step equal JAX's rule on the
    port's own timesteps: with shift 5 and 4 steps (~[999, 937, 833, 625])
    the tiny and t2v boundary 0.875 takes steps 0-1 high, the i2v 0.900
    step 0-1 as well (937 >= 900); at 2 steps (999, 833) each boundary
    puts one step on each expert."""
    spec, jspec = WAN_CONFIGS[model], JCONFIGS[model]
    for steps, want in ((4, [True, True, False, False]), (2, [True, False])):
        _, ts = flow_sigmas(steps, shift=5.0)
        _, jts = j_flow_sigmas(steps, shift=5.0)
        np.testing.assert_array_equal(ts, jts)
        is_high, g = expert_schedule(spec, ts, (3.0, 4.5))
        assert list(is_high) == want
        assert list(is_high) == list(
            jts >= jspec.moe_boundary * jspec.num_train_timesteps)
        assert g.dtype == np.float32
        assert list(g) == [4.5 if h else 3.0 for h in want]


def _small(model="tiny-moe-t2v"):
    jspec, tspec, size, frames, _ = _specs(model)
    low, high, vae = _trees(jspec, seed=10)
    rng = np.random.default_rng(9)
    ctx = torch.as_tensor(rng.standard_normal((16, 64)), dtype=torch.float32)
    return tspec, low, high, vae, ctx


KW = dict(size=(64, 64), frame_num=5, sampling_steps=4, seed=5,
          decode=False)


def test_both_experts_used():
    spec, low, high, vae, ctx = _small()
    nctx = torch.zeros_like(ctx)
    base = _port(spec, low, high, vae).generate(ctx, nctx, **KW)
    moved = jax.tree_util.tree_map(lambda x: x + 0.05, high)
    out_h = _port(spec, low, moved, vae).generate(ctx, nctx, **KW)
    assert (out_h - base).abs().max() > 1e-6
    moved = jax.tree_util.tree_map(lambda x: x + 0.05, low)
    out_l = _port(spec, moved, high, vae).generate(ctx, nctx, **KW)
    assert (out_l - base).abs().max() > 1e-6


def test_per_expert_guide_scale():
    """(low, high): only the high scale changed still changes the output; a
    float g is (g, g)."""
    spec, low, high, vae, ctx = _small()
    nctx = torch.as_tensor(np.random.default_rng(8).standard_normal(
        tuple(ctx.shape)), dtype=torch.float32)
    pipe = _port(spec, low, high, vae)
    a = pipe.generate(ctx, nctx, guide_scale=(3.0, 4.0), **KW)
    b = pipe.generate(ctx, nctx, guide_scale=(3.0, 7.0), **KW)
    assert (a - b).abs().max() > 1e-6
    assert torch.equal(pipe.generate(ctx, nctx, guide_scale=4.0, **KW),
                       pipe.generate(ctx, nctx, guide_scale=(4.0, 4.0),
                                     **KW))


def test_single_expert_matches_ti2v_t2v():
    """With the boundary above every timestep only the low expert runs, and
    the MoE loop equals the port's WanTI2VPipeline t2v bit for bit."""
    spec, low, high, vae, ctx = _small()
    nctx = torch.zeros_like(ctx)
    moe = _port(dataclasses.replace(spec, moe_boundary=1.5), low, high, vae)
    out = moe.generate(ctx, nctx, guide_scale=5.0, shift=5.0, **KW)
    ref = WanTI2VPipeline(spec, moe.low, moe.vae, policy=FP32_POLICY) \
        .generate(ctx, nctx, guide_scale=5.0, shift=5.0, **KW)
    assert torch.equal(out, ref)


def test_first_frame_mask_matches_jax():
    m = first_frame_mask(3, 4, 4)
    assert m.shape == (1, 3, 4, 4, 4) and m.dtype == torch.float32
    assert (m[:, 0] == 1.0).all() and (m[:, 1:] == 0.0).all()
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(j_first_frame_mask(3, 4, 4)))


def test_i2v_conditioning():
    """The image reaches the DiT through y: another first frame gives
    another video. An i2v model without an image, and a t2v model with
    one, raise."""
    spec, low, high, vae, ctx = _small("tiny-moe-i2v")
    nctx = torch.zeros_like(ctx)
    pipe = _port(spec, low, high, vae)
    a = pipe.generate(ctx, nctx, img=torch.full((64, 64, 3), 0.5), **KW)
    b = pipe.generate(ctx, nctx, img=torch.full((64, 64, 3), -0.5), **KW)
    assert a.shape == b.shape == (1, 2, 4, 4, 4)
    assert (a - b).abs().max() > 1e-6
    with pytest.raises(ValueError, match="needs an image"):
        pipe.generate(ctx, nctx, **KW)
    tspec, tlow, thigh, tvae, _ = _small()
    with pytest.raises(ValueError, match="takes no image"):
        _port(tspec, tlow, thigh, tvae).generate(
            ctx, nctx, img=torch.zeros((64, 64, 3)), **KW)


def test_refusals():
    """TaylorSeer raises JAX's NotImplementedError message; sp_size > 1
    without a mesh raises JAX's ValueError; a mesh with sp and tp both > 1
    cites the ROADMAP's item that takes them together."""
    spec, low, high, vae, ctx = _small()
    with pytest.raises(NotImplementedError) as want:
        JMoE(JCONFIGS["tiny-moe-t2v"], low, high, vae).generate(
            jnp.asarray(ctx.numpy()), jnp.asarray(ctx.numpy()),
            taylorseer_threshold=2)
    with pytest.raises(NotImplementedError) as got:
        _port(spec, low, high, vae).generate(ctx, ctx, taylorseer_threshold=2)
    assert str(got.value) == str(want.value)
    dits = _port(spec, low, high, vae)
    with pytest.raises(ValueError) as want:
        JMoE(JCONFIGS["tiny-moe-t2v"], low, high, vae, sp_size=2)
    with pytest.raises(ValueError) as got:
        WanMoEPipeline(spec, dits.low, dits.high, dits.vae, sp_size=2)
    assert str(got.value) == str(want.value)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh(MeshSpec(sp=2, tp=2), device="cpu")
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1: Sequence and tensor "
                                 "parallelism together"):
            WanMoEPipeline(spec, dits.low, dits.high, dits.vae, sp_size=2,
                           mesh=mesh)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="no moe_boundary"):
        WanMoEPipeline(WAN_CONFIGS["tiny"], dits.low, dits.high, dits.vae)


@pytest.mark.parametrize("mask", [False, True])
def test_dit_ffn_over_token_chunks_equals_the_whole(mask, monkeypatch):
    """Above FFN_CHUNK_ELEMS the DiT runs its FFN and gated residual over
    token chunks (the 720p A14B call): at a cap of 100 tokens a chunk the
    d=128 DiT's velocity equals the one-chunk forward bit for bit, fp32
    and bf16, with a per-token t = 0 mask (gates per token) and without."""
    from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
    from univid_tpu_torch.models.wan import dit as dit_mod
    from univid_tpu_torch.ops.rope import build_rope_3d

    cfg = WanDiTConfig(**D128)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 16, 16, 16), generator=g)
    t = torch.tensor([900.0, 300.0])
    ctx = torch.randn((2, cfg.text_len, cfg.text_dim), generator=g)
    tz = (torch.rand((2, 256), generator=g) < 0.3) if mask else None
    cos, sin = build_rope_3d(cfg.head_dim, (4, 8, 8), device="cpu")
    for dtype, pol in ((torch.float32, FP32_POLICY),
                       (torch.bfloat16, DEFAULT_POLICY)):
        dit = dit_mod.WanDiT(cfg, dtype=dtype, device="cpu", gen=g)
        with torch.no_grad():
            dit.head.head.w.normal_(0.0, 0.05, generator=g)
        outs = []
        for cap in (dit_mod.FFN_CHUNK_ELEMS, 2 * cfg.ffn_dim * 100):
            monkeypatch.setattr(dit_mod, "FFN_CHUNK_ELEMS", cap)
            with torch.no_grad():
                outs.append(dit_mod.wan_dit_forward(
                    dit, x, t, ctx, cos, sin, t_zero_mask=tz,
                    seq_pad_to=320, fused_rope=True,
                    policy=dataclasses.replace(pol, bounded_softmax=True)))
        assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["tiny-moe-t2v", "tiny-moe-i2v"])
def test_cli_moe_route(model, tmp_path, monkeypatch):
    """--model tiny-moe-t2v --no_bagel (UMT5 context) and tiny-moe-i2v
    --image (the default fusion context) serve through WanMoEPipeline: an
    mp4 of the requested 9 frames each."""
    from PIL import Image

    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.data.video_io import read_video_frames

    args = ["--model", model, "--mock_weights", "--device", "cpu",
            "--video_size", "64x64", "--video_length", "9", "--steps", "2",
            "--output_dir", str(tmp_path / "out")]
    if model.endswith("t2v"):
        args += ["--mode", "t2v", "--no_bagel"]
    else:
        png = str(tmp_path / "frame.png")
        Image.fromarray(np.random.default_rng(0).integers(
            0, 256, (64, 64, 3), dtype=np.uint8)).save(png)
        args += ["--mode", "i2v", "--image", png]
    built = []
    real = inference.build_pipeline

    def spy(a, spec):
        built.append(real(a, spec))
        return built[-1]

    monkeypatch.setattr(inference, "build_pipeline", spy)
    res = inference.main(args)
    assert isinstance(built[0], WanMoEPipeline)
    assert built[0].low is not built[0].high
    want = "umt5" if model.endswith("t2v") else "bagel_fusion"
    assert [r["context_path"] for r in res] == [want]
    frames = read_video_frames(res[0]["video_path"])
    assert len(frames) == 9 and frames[0].shape == (64, 64, 3)


@pytest.mark.parametrize("model", ["tiny-moe-t2v", "tiny"])
def test_cli_frees_umt5_before_placing_a_dit(model, tmp_path, monkeypatch):
    """One order for every model: UMT5 is built, encodes the prompt and is
    freed before the first DiT is constructed (two experts for the MoE
    config, one DiT otherwise)."""
    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.models.wan import dit as dit_mod
    from univid_tpu_torch.pipelines.encoders import WanTextEncoder

    events = []
    real_init = dit_mod.WanDiT.__init__
    real_random = WanTextEncoder.random_init.__func__

    def dit_init(self, *a, **kw):
        events.append("dit")
        real_init(self, *a, **kw)

    def random_init(cls, *a, **kw):
        enc = real_random(cls, *a, **kw)
        events.append("umt5")
        weakref.finalize(enc, events.append, "umt5 freed")
        return enc

    monkeypatch.setattr(dit_mod.WanDiT, "__init__", dit_init)
    monkeypatch.setattr(WanTextEncoder, "random_init",
                        classmethod(random_init))
    inference.main(["--model", model, "--mode", "t2v", "--no_bagel",
                    "--mock_weights", "--device", "cpu", "--video_size",
                    "64x64", "--video_length", "5", "--steps", "1",
                    "--output_dir", str(tmp_path)])
    n = 2 if model.startswith("tiny-moe") else 1
    assert events == ["umt5", "umt5 freed"] + ["dit"] * n
