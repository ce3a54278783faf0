"""The port's BAGEL image generation against univid_tpu's: the VAE-latent
append, the uncommitted LM pass, the flow loop with dual CFG, renorm and
TaylorSeer, and the inferencer's text to image and editing.

The tiny BAGEL of test_torch_bagel.py (hidden 256, 2 query heads over 1 kv
head, head dim 128) with non-unit gen-expert norms and a random llm2vae
(JAX's is zero-init: the velocity would be exactly 0 and every comparison
trivial); vae_downsample 4 with a 3-level FLUX AE (ch 16), so a 48x64
image is 6 x 8 latent tokens and every gen pass has 50 rows: more than 32,
so the passes take the attention kernel route (its plain version on the
CPU) while JAX runs its XLA reference. Weights come from the JAX init
through convert; ids, images and JAX's starting noise (`noise=`) are numpy
arrays. fp32 throughout: latents and images to 1e-4. After every
generation the caller's contexts are as they were: len, len_host, rope
and the cache rows up to len.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univid_tpu.models.bagel import autoencoder as ja
from univid_tpu.models.bagel import bagel as jb
from univid_tpu.models.bagel import qwen2_mot as jq
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.models.bagel.siglip import init_siglip as j_init_siglip
from univid_tpu.ops.taylorseer import TaylorSeerConfig as JTaylorSeerConfig
from univid_tpu.pipelines.interleave import InterleaveInferencer as JInfer
from univid_tpu.utils.tokenizers import HashTokenizer as JHashTokenizer
from univid_tpu_torch import convert
from univid_tpu_torch.models.bagel import autoencoder as ta
from univid_tpu_torch.models.bagel import bagel as tb
from univid_tpu_torch.models.bagel import qwen2_mot as tq
from univid_tpu_torch.models.bagel.siglip import SiglipConfig
from univid_tpu_torch.ops.taylorseer import TaylorSeerConfig
from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
from univid_tpu_torch.utils.tokenizers import HashTokenizer

torch.set_num_threads(2)
F32 = dict(rtol=1e-4, atol=1e-4)
LLM = dict(vocab_size=512, hidden_size=256, intermediate_size=96,
           num_layers=2, num_heads=2, num_kv_heads=1)
BAGEL = dict(start_of_image=508, end_of_image=509, bos_token_id=510,
             eos_token_id=511, vit_hidden_size=32, vit_patch_size=14,
             vit_max_num_patch_per_side=8, vae_downsample=4)
SIGLIP = dict(hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=2, patch_size=14, image_size=56)
VAE = dict(ch=16, ch_mult=(1, 2, 2), num_res_blocks=1)
SHAPE = (48, 64)                  # 6 x 8 latent tokens, 50-row gen passes
N_TOK = 48
CAPACITY = 512
PROMPT = ("A red fox sitting in fresh snow at the edge of a pine forest at "
          "dawn, soft golden light on its fur, mist between the trees, "
          "photographed with a long lens and a shallow depth of field")
EDIT = "make the sky purple and add a small boat on the lake"


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX config, port Bagel, port config) sharing weights:
    non-unit gen-expert norms and a random llm2vae."""
    jcfg = jb.BagelConfig(llm=jq.Qwen2MoTConfig(**LLM), **BAGEL)
    jp = jb.init_bagel(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    layers = dict(jp["llm"]["layers"])
    for name in ("input_ln_gen", "post_ln_gen"):
        layers[name] = jnp.asarray(rng.uniform(0.5, 1.5, layers[name].shape),
                                   jnp.float32)
    gen_attn = dict(layers["attn_gen"])
    gen_attn["q_norm"] = jnp.asarray(
        rng.uniform(0.5, 1.5, gen_attn["q_norm"].shape), jnp.float32)
    layers["attn_gen"] = gen_attn
    llm = dict(jp["llm"], layers=layers, norm_gen=jnp.asarray(
        rng.uniform(0.5, 1.5, jp["llm"]["norm_gen"].shape), jnp.float32))
    jp = dict(jp, llm=llm, llm2vae=dict(jp["llm2vae"], w=0.1 * jnp.asarray(
        rng.standard_normal(jp["llm2vae"]["w"].shape), jnp.float32)))
    cfg = tb.BagelConfig(llm=tq.Qwen2MoTConfig(**LLM), **BAGEL)
    model = convert.bagel_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   cfg, device="cpu")
    return jp, jcfg, model, cfg


def _ids(seed, n=40):
    return np.random.default_rng(seed).integers(0, 500, n)


def _ctx_pair(models, seed, n=40):
    """(JAX, port) contexts after the same n-token causal prefill."""
    jp, jcfg, model, cfg = models
    ids = _ids(seed, n)
    jc = jb.init_gen_context(jcfg, 256, dtype=jnp.float32)
    jc = jb.update_context_text(jp, jcfg, jc, jnp.asarray(ids),
                                compute_dtype=jnp.float32)
    tc = tb.init_gen_context(cfg, 256, dtype=torch.float32, device="cpu")
    tc = tb.update_context_text(model, cfg, tc, torch.as_tensor(ids[None]),
                                compute_dtype=torch.float32)
    return jc, tc


def _snapshot(ctx):
    n = max(ctx["cache"]["len_host"])
    return (ctx["cache"]["len"].clone(), list(ctx["cache"]["len_host"]),
            ctx["rope"].clone(), ctx["cache"]["k"][:, :, :n].clone(),
            ctx["cache"]["v"][:, :, :n].clone())


def assert_unchanged(ctx, snap):
    for got, want in zip(_snapshot(ctx), snap):
        if isinstance(want, list):
            assert got == want
        else:
            assert torch.equal(got, want)


def _assert_cache_matches(tc, jc):
    n = int(jc["cache"]["len"])
    assert tc["cache"]["len_host"] == [n] and int(tc["cache"]["len"][0]) == n
    assert int(tc["rope"][0]) == int(jc["rope"])
    for kv in ("k", "v"):
        np.testing.assert_allclose(tc["cache"][kv][:, 0, :n].numpy(),
                                   np.asarray(jc["cache"][kv][:, :n]), **F32)


def _jax_noise(key=0, n_tok=N_TOK):
    """JAX's starting latent of generate_image_latent(rng=PRNGKey(key))."""
    return np.array(jax.random.normal(jax.random.PRNGKey(key), (n_tok, 64),
                                      jnp.float32))


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


def test_update_context_vae_matches_jax(models):
    """A 12 x 16 latent (6 x 8 tokens) appended after a text prefill: the
    cache rows (gen expert on the latent rows, und on start / end) and the
    rope cursor (+1) == JAX."""
    jp, jcfg, model, cfg = models
    jc, tc = _ctx_pair(models, 1)
    lat = np.random.default_rng(2).standard_normal((12, 16, 16)).astype(
        np.float32)
    jc = jb.update_context_vae(jp, jcfg, jc, jnp.asarray(lat),
                               compute_dtype=jnp.float32)
    tc = tb.update_context_vae(model, cfg, tc, torch.as_tensor(lat[None]),
                               compute_dtype=torch.float32)
    assert tc["cache"]["len_host"] == [40 + N_TOK + 2]
    _assert_cache_matches(tc, jc)


def test_uncommitted_pass_equals_committed_and_leaves_the_context(models):
    """commit=False: the hidden states equal a committed pass's (on a fork
    of the same context), and len, len_host, the rope cursor and the rows
    up to len are as they were; a second uncommitted pass gives the same
    states again."""
    _, _, model, cfg = models
    _, ctx = _ctx_pair(models, 3)
    fork = tb.fork_context(ctx)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, 50, 256)).astype(np.float32))
    pos = ctx["rope"][:, None].expand(1, 50)
    und = torch.tensor([0, 49])
    kw = dict(mode="gen", und_rows=und, is_causal=False,
              compute_dtype=torch.float32, final_norm=False)
    snap = _snapshot(ctx)
    h0, _ = tq.qwen2_mot_forward(model.llm, cfg.llm, x, pos, ctx["cache"],
                                 commit=False, **kw)
    assert_unchanged(ctx, snap)
    h1, _ = tq.qwen2_mot_forward(model.llm, cfg.llm, x, pos, ctx["cache"],
                                 commit=False, **kw)
    h2, cache = tq.qwen2_mot_forward(model.llm, cfg.llm, x, pos,
                                     fork["cache"], **kw)
    assert torch.equal(h0, h1) and torch.equal(h0, h2)
    assert cache["len_host"] == [90] and snap[1] == [40]


def test_fork_context_is_independent(models):
    """A fork holds the rows up to len and the cursors; appending to
    either leaves the other as it was."""
    jp, jcfg, model, cfg = models
    _, ctx = _ctx_pair(models, 5)
    fork = tb.fork_context(ctx)
    snap = _snapshot(ctx)
    assert_unchanged(fork, snap)
    ids = torch.as_tensor(_ids(6, 8)[None])
    fork = tb.update_context_text(model, cfg, fork, ids,
                                  compute_dtype=torch.float32)
    assert_unchanged(ctx, snap)
    assert fork["cache"]["len_host"] == [48] and int(fork["rope"][0]) == 48
    ctx = tb.update_context_text(model, cfg, ctx, ids,
                                 compute_dtype=torch.float32)
    assert torch.equal(ctx["cache"]["k"][:, :, :48],
                       fork["cache"]["k"][:, :, :48])


LOOP_CASES = {
    # 8 timesteps at shift 3: the gate (0.4, 1.0] is off for the last two
    "three_branches_global": dict(),
    "channel_renorm_min": dict(cfg_renorm_type="channel",
                               cfg_renorm_min=0.3),
    "text_channel": dict(cfg_renorm_type="text_channel"),
    "text_cfg_only": dict(cfg_img_ctx=None, cfg_text_scale=3.0),
    "no_cfg": dict(cfg_text_scale=1.0),
    "gate_mostly_off": dict(cfg_interval=(0.0, 0.5), cfg_renorm_min=0.9),
    # 9 timesteps: steps 0-4 full, 5 and 6 extrapolated, 7 full
    "taylorseer": dict(enable_taylorseer=True, num_timesteps=9),
    "taylorseer_order_2": dict(enable_taylorseer=True, num_timesteps=9,
                               taylorseer_cfg=(2, 3, 2)),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_generate_image_latent_matches_jax(models, case):
    """The flow loop from JAX's noise over a full context (text + VAE
    rows), the context before the VAE rows (cfg_text) and an empty one
    (cfg_img) == JAX's latent at 1e-4; the latent moved from the noise;
    every context as it was."""
    jp, jcfg, model, cfg = models
    kw = dict(LOOP_CASES[case])
    jc, tc = _ctx_pair(models, 7)
    keep = tb.fork_context(tc)
    lat = np.random.default_rng(8).standard_normal((12, 16, 16)).astype(
        np.float32)
    jfull = jb.update_context_vae(jp, jcfg, jc, jnp.asarray(lat),
                                  compute_dtype=jnp.float32)
    tfull = tb.update_context_vae(model, cfg, tc, torch.as_tensor(lat[None]),
                                  compute_dtype=torch.float32)
    jempty = jb.init_gen_context(jcfg, 256, dtype=jnp.float32)
    tempty = tb.init_gen_context(cfg, 256, dtype=torch.float32, device="cpu")
    jimg, timg = (None, None) if "cfg_img_ctx" in kw else (jempty, tempty)
    kw.pop("cfg_img_ctx", None)
    ts = kw.pop("taylorseer_cfg", None)
    kw.setdefault("num_timesteps", 8)
    noise = _jax_noise(3)
    xj, grid = jb.generate_image_latent(
        jp, jcfg, jfull, SHAPE, cfg_text_ctx=jc, cfg_img_ctx=jimg,
        rng=jax.random.PRNGKey(3), compute_dtype=jnp.float32,
        taylorseer_cfg=ts and JTaylorSeerConfig(*ts), **kw)
    snaps = [_snapshot(c) for c in (tfull, keep, tempty)]
    xt, tgrid = tb.generate_image_latent(
        model, cfg, tfull, SHAPE, cfg_text_ctx=keep, cfg_img_ctx=timg,
        noise=torch.as_tensor(noise[None].copy()), compute_dtype=torch.float32,
        taylorseer_cfg=ts and TaylorSeerConfig(*ts), **kw)
    assert tuple(tgrid) == tuple(grid) == (6, 8)
    assert xt.shape == (1, N_TOK, 64) and xt.dtype == torch.float32
    np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), **F32)
    assert np.linalg.norm(np.asarray(xj) - noise) > 0.1 * np.linalg.norm(
        noise)
    for c, s in zip((tfull, keep, tempty), snaps):
        assert_unchanged(c, s)


def test_the_gate_scales_and_never_skips(models):
    """Outside cfg_interval the CFG scales are 1, but every branch still
    runs (3 uncommitted LM passes a step: the kernel route's launches)."""
    _, _, model, cfg = models
    _, ctx = _ctx_pair(models, 9)
    calls = []
    real = tb.qwen2_mot_forward

    def spy(*a, **kw):
        calls.append(kw.get("commit", True))
        return real(*a, **kw)

    tb.qwen2_mot_forward = spy
    try:
        tb.generate_image_latent(
            model, cfg, ctx, SHAPE, cfg_text_ctx=tb.fork_context(ctx),
            cfg_img_ctx=tb.fork_context(ctx), num_timesteps=6,
            cfg_interval=(0.0, 0.0), noise=torch.zeros(1, N_TOK, 64),
            compute_dtype=torch.float32)
    finally:
        tb.qwen2_mot_forward = real
    assert calls == [False] * 15


def test_taylorseer_threshold_1_equals_the_uncached_loop(models):
    """fresh_threshold=1 makes every step a full step: the loop with
    TaylorSeer equals the loop without, bit for bit."""
    _, _, model, cfg = models
    _, ctx = _ctx_pair(models, 10)
    kw = dict(cfg_text_ctx=tb.init_gen_context(cfg, 256, dtype=torch.float32,
                                               device="cpu"),
              num_timesteps=7, noise=torch.as_tensor(_jax_noise(4)[None]),
              compute_dtype=torch.float32)
    a, _ = tb.generate_image_latent(model, cfg, ctx, SHAPE, **kw)
    b, _ = tb.generate_image_latent(
        model, cfg, ctx, SHAPE, enable_taylorseer=True,
        taylorseer_cfg=TaylorSeerConfig(fresh_threshold=1), **kw)
    assert torch.equal(a, b)


def test_noise_from_a_generator_is_deterministic(models):
    _, _, model, cfg = models
    _, ctx = _ctx_pair(models, 11)

    def run(seed):
        return tb.generate_image_latent(
            model, cfg, ctx, SHAPE, num_timesteps=3,
            rng=torch.Generator().manual_seed(seed),
            compute_dtype=torch.float32)[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_a_1024_request_needs_a_larger_capacity(models):
    """A 64 x 64 latent's 4,098 rows (1024x1024 at BAGEL-7B-MoT's latent
    downsampling of 16; 512x512 here) do not fit the default capacity of
    4,096: the port raises where JAX's append would overwrite."""
    _, _, model, cfg = models
    ctx = tb.init_gen_context(cfg, 4096, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="capacity 4096"):
        tb.generate_image_latent(model, cfg, ctx, (512, 512),
                                 num_timesteps=2,
                                 compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# the inferencer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inferencers(models):
    jp, jcfg, model, cfg = models
    jscfg = JSiglipConfig(**SIGLIP)
    sig = j_init_siglip(jax.random.PRNGKey(1), jscfg)
    jvcfg = ja.ImageVAEConfig(**VAE)
    vae = ja.init_image_vae(jax.random.PRNGKey(2), jvcfg)
    j = JInfer(jp, jcfg, JHashTokenizer(500), siglip_params=sig,
               siglip_cfg=jscfg, vae_params=vae, vae_cfg=jvcfg,
               capacity=CAPACITY, compute_dtype=jnp.float32)
    vcfg = ta.ImageVAEConfig(**VAE)
    t = Spy(model, cfg, HashTokenizer(500),
            siglip=convert.siglip_from_jax(
                jax.tree_util.tree_map(np.asarray, sig),
                SiglipConfig(**SIGLIP), device="cpu"),
            siglip_cfg=SiglipConfig(**SIGLIP),
            vae=convert.image_vae_from_jax(
                jax.tree_util.tree_map(np.asarray, vae), vcfg, device="cpu"),
            vae_cfg=vcfg, capacity=CAPACITY, compute_dtype=torch.float32)
    return j, t


class Spy(InterleaveInferencer):
    """Asserts that gen_image leaves its three contexts as they were, and
    that they are three different caches."""

    def gen_image(self, image_shape, ctx, **kw):
        ctxs = [ctx, kw["cfg_text_ctx"], kw["cfg_img_ctx"]]
        assert len({id(c["cache"]["k"]) for c in ctxs}) == 3
        snaps = [_snapshot(c) for c in ctxs]
        out = super().gen_image(image_shape, ctx, **kw)
        for c, s in zip(ctxs, snaps):
            assert_unchanged(c, s)
        self.contexts = [c["cache"]["len_host"][0] for c in ctxs]
        return out


def _input_image(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (*SHAPE, 3)).astype(
        np.float32)


def test_vae_resize_matches_jax(inferencers):
    """Sides to multiples of 8 here (latent_downsample), the long side
    clamped to 64 x 8 = 512: within 1e-6 of a float64 evaluation of the
    same resample weights, and within 3e-5 of jax.image.resize (its CPU
    einsum is off the float64 value by up to 2e-5, as
    test_vit_aligned_resize_full_size_is_exact pins for the ViT resize)."""
    from univid_tpu_torch.models.bagel.siglip import _resize_weights

    j, t = inferencers
    for shape, out in (((50, 70, 3), (48, 72)), ((700, 300, 3), (512, 216)),
                       ((48, 64, 3), (48, 64))):
        img = np.random.default_rng(1).uniform(-1, 1, shape).astype(
            np.float32)
        want = np.asarray(j.vae_resize(jnp.asarray(img)))
        got = t.vae_resize(torch.as_tensor(img)).numpy()
        assert got.shape == want.shape == (*out, 3)
        wh = _resize_weights(shape[0], out[0], "cpu").double().numpy()
        ww = _resize_weights(shape[1], out[1], "cpu").double().numpy()
        exact = np.einsum("ywc,wx->yxc", np.einsum(
            "hwc,hy->ywc", img.astype(np.float64), wh), ww)
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)


def test_update_context_image_with_vae_matches_jax(inferencers):
    """vae=True: the VAE-latent rows (50) before the ViT rows, cache and
    rope == JAX's (the FLUX encode, both appends)."""
    j, t = inferencers
    img = _input_image(12)
    jc = j.update_context_image(jnp.asarray(img), j.init_gen_context(),
                                vae=True)
    tc = t.update_context_image(img, t.init_gen_context(), vae=True)
    assert int(jc["rope"]) == 2
    assert tc["cache"]["len_host"] == [50 + 12 + 2]
    _assert_cache_matches(tc, jc)


def test_gen_image_matches_jax(inferencers):
    """gen_image over a prompt's context, the empty context as cfg_text
    and cfg_img: the image [48, 64, 3] in [0, 1] == JAX's at 1e-4."""
    j, t = inferencers
    jctx = j.update_context_text(PROMPT, j.init_gen_context())
    tctx = t.update_context_text(PROMPT, t.init_gen_context())
    want = np.asarray(j.gen_image(
        SHAPE, jctx, cfg_text_ctx=j.init_gen_context(),
        cfg_img_ctx=j.init_gen_context(), num_timesteps=6,
        rng=jax.random.PRNGKey(5)))
    got = t.gen_image(SHAPE, tctx, cfg_text_ctx=t.init_gen_context(),
                      cfg_img_ctx=t.init_gen_context(), num_timesteps=6,
                      noise=torch.as_tensor(_jax_noise(5)[None]))
    assert got.shape == (*SHAPE, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("think", [False, True], ids=["plain", "think"])
def test_text_to_image_matches_jax(inferencers, think):
    """interleave_inference([prompt]) with the three CFG branches (global
    renorm): the image == JAX's, and with think the decoded plan too; the
    contexts (full, the one before the prompt, the text-only one) are
    three caches, each unchanged by the loop."""
    j, t = inferencers
    kw = dict(think=think, max_think_token_n=4, num_timesteps=6,
              image_shapes=SHAPE, cfg_text_scale=4.0)
    want = j.interleave_inference([PROMPT], **kw)
    got = t.interleave_inference([PROMPT], noise=torch.as_tensor(
        _jax_noise()[None]), **kw)
    assert len(got) == len(want) == 1 + think
    if think:
        assert got[0] == want[0]
    assert got[-1].shape == (*SHAPE, 3)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]), **F32)


@pytest.mark.parametrize("think", [False, True], ids=["plain", "think"])
def test_editing_matches_jax(inferencers, think):
    """interleave_inference([image, instruction]): the image through both
    towers (VAE rows, then ViT rows), the instruction, then the loop over
    ctx, the image-only context (cfg_text) and the instruction alone
    (cfg_img) == JAX's image; image_shapes from the input image."""
    j, t = inferencers
    img = _input_image(13)
    kw = dict(think=think, max_think_token_n=4, num_timesteps=5,
              cfg_text_scale=3.0, cfg_img_scale=1.5,
              cfg_renorm_type="text_channel")
    want = j.interleave_inference([jnp.asarray(img), EDIT], **kw)
    got = t.interleave_inference([img, EDIT], noise=torch.as_tensor(
        _jax_noise()[None]), **kw)
    if think:
        assert got[0] == want[0]
    assert got[-1].shape == (*SHAPE, 3)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]), **F32)
    # the full context holds both towers and the instruction; cfg_text the
    # image without the instruction; cfg_img the instruction alone
    assert t.contexts[0] > t.contexts[1] > t.contexts[2] > 0
    if not think:
        assert t.contexts[1] == 50 + 12 + 2


def test_call_returns_the_image_and_the_plan(inferencers):
    """__call__(image, text, think=True) -> {"image": [H, W, 3],
    "text": the plan}."""
    _, t = inferencers
    out = t(image=_input_image(14), text=EDIT, think=True,
            max_think_token_n=3, num_timesteps=3)
    assert isinstance(out["text"], str)
    assert out["image"].shape == (*SHAPE, 3)
    assert bool(torch.isfinite(out["image"]).all())


def test_generation_needs_the_vae(models):
    """Without a VAE, gen_image and the VAE tower raise."""
    _, _, model, cfg = models
    t = InterleaveInferencer(model, cfg, HashTokenizer(500), capacity=256,
                             compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="image VAE"):
        t.gen_image(SHAPE, t.init_gen_context())
    with pytest.raises(ValueError, match="image VAE"):
        t.update_context_vae_image(_input_image(1), t.init_gen_context())
