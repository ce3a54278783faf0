"""The port's FLUX.1-Kontext editor against univid_tpu's: token packing,
RoPE ids and tables, the sigma schedule, the time embedding, the MMDiT
forward (the reference route at TINY_FLUX's d=64, the kernel route at
d=128 against JAX's Pallas kernel in interpret mode), CLIP-L and T5 v1.1
(shared_pos), the pipeline's edit from JAX's noise, the three converters
and manifests, the loader, the weight-only int8 transformer, and the
forward sharded at fsdp 4 x tp 2 over 8 gloo ranks.

Parameter trees have the JAX init's structure, filled from a numpy seed,
and reach the port through univid_tpu_torch.convert. Tolerances: equal
bits for the integer and float64 host work; fp32 forwards 1e-4 rel. (the
text towers 1e-5); the bf16 policy 2e-2 rel. L2 (PERF.md s2); the u8
images of an fp32 edit within one level; the sharded forward 2e-4
(tests/test_flux.py:322-352's tolerance).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu.core import checkpoint as JC
from univid_tpu.core import manifest as JM
from univid_tpu.core import quant as jquant
from univid_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.models.flux import clip_text as jclip
from univid_tpu.models.flux import kontext as jk
from univid_tpu.models.wan.t5 import encode_padded as j_encode_padded
from univid_tpu.models.wan.t5 import init_t5_encoder
from univid_tpu.pipelines import kontext as jp
from univid_tpu_torch import convert
from univid_tpu_torch.core import checkpoint as TC
from univid_tpu_torch.core import manifest as TM
from univid_tpu_torch.core import quant as tquant
from univid_tpu_torch.core.config import T5Config
from univid_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from univid_tpu_torch.models.flux import clip_text as tclip
from univid_tpu_torch.models.flux import kontext as tk
from univid_tpu_torch.models.wan.t5 import encode_padded as t_encode_padded
from univid_tpu_torch.pipelines import kontext as tp
from univid_tpu_torch.utils.tokenizers import HashTokenizer

from test_torch_checkpoint import assert_same_module, sd_from_manifest, \
    to_torch
from test_torch_models import _rand, _rel
from torch_flux_tasks import _task_flux_fsdp_tp
from torch_ranks import ranks  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACKED = ("double_blocks", "single_blocks")

# a d=128 geometry (the kernel route): hidden 256, 2 heads, 2 + 2 blocks
D128 = dict(in_channels=16, out_channels=16, hidden_size=256, num_heads=2,
            depth_double=2, depth_single=2, axes_dim=(16, 56, 56),
            context_dim=32, vec_dim=32, time_freq_dim=32)
TINY = {f.name: getattr(jk.TINY_FLUX, f.name)
        for f in dataclasses.fields(jk.TINY_FLUX)}


def flux_params(init_fn, cfg, seed, stacked=STACKED):
    """A tree of init_fn's structure (jax.eval_shape) from a numpy seed:
    matrices N(0, 1/fan_in) over their last-but-one axes, biases N(0,
    0.02^2), gains U(0.5, 1.5), embeddings N(0, 1); the leading layer axis
    of a `stacked` subtree is no fan-in."""
    shapes = jax.eval_shape(lambda k: init_fn(k, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        top = str(getattr(path[0], "key", path[0]))
        shape = s.shape[1:] if top in stacked else s.shape
        full = s.shape
        if name == "w" and len(shape) >= 2:
            x = rng.standard_normal(full) / np.sqrt(shape[-2])
        elif name == "b":
            x = rng.standard_normal(full) * 0.02
        elif len(shape) == 1:
            x = rng.uniform(0.5, 1.5, full)
        else:
            x = rng.standard_normal(full)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(cfg_kw, l_txt, grid, ref_grid, seed=0):
    """Packed target + reference tokens, T5 features, CLIP pooled and the
    RoPE ids of one call (numpy)."""
    l_img = grid[0] * grid[1] + ref_grid[0] * ref_grid[1]
    img = _rand((1, l_img, cfg_kw["in_channels"]), seed)
    txt = _rand((1, l_txt, cfg_kw["context_dim"]), seed + 1)
    pooled = _rand((1, cfg_kw["vec_dim"]), seed + 2)
    ids = np.concatenate([np.zeros((l_txt, 3)), jk.image_token_ids(grid, 0),
                          jk.image_token_ids(ref_grid, 1)])
    return img, txt, pooled, ids


# ---------------------------------------------------------------------------
# host work: equal bits
# ---------------------------------------------------------------------------


def test_pack_unpack_equal_jax():
    z = _rand((2, 8, 12, 5), 0)
    want = np.asarray(jk.pack_latents(jnp.asarray(z)))
    got = tk.pack_latents(torch.as_tensor(z))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tk.unpack_latents(got, (4, 6)).numpy(),
                                  np.asarray(jk.unpack_latents(
                                      jnp.asarray(want), (4, 6))))
    np.testing.assert_array_equal(tk.unpack_latents(got, (4, 6)).numpy(), z)


@pytest.mark.parametrize("grid,set_id,axes", [
    ((4, 6), 0, (16, 24, 24)), ((64, 64), 1, (16, 56, 56)),
    ((44, 60), 1, (16, 56, 56))], ids=["tiny", "1024", "1184x880-ref"])
def test_token_ids_and_rope_equal_jax(grid, set_id, axes):
    """image_token_ids and build_rope_from_ids (text ids zero ahead of the
    target and reference grids) bit for bit."""
    ids_j = jk.image_token_ids(grid, set_id)
    ids_t = tk.image_token_ids(grid, set_id)
    np.testing.assert_array_equal(ids_t, ids_j)
    assert ids_t.dtype == np.float64
    ids = np.concatenate([np.zeros((7, 3)), ids_t,
                          tk.image_token_ids(grid, 1 - set_id)])
    cj, sj = jk.build_rope_from_ids(ids, axes, 10000.0)
    ct, st = tk.build_rope_from_ids(ids, axes, 10000.0, device="cpu")
    assert ct.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("steps,seq", [(28, 4096), (4, 256), (2, 192),
                                       (28, 4070)])
def test_sigmas_and_shift_equal_jax(steps, seq):
    assert tp.calculate_shift(seq) == jp.calculate_shift(seq)
    np.testing.assert_array_equal(tp.kontext_sigmas(steps, seq),
                                  jp.kontext_sigmas(steps, seq))


def test_preferred_resolution_equal_jax():
    sizes = [(1024, 1024), (720, 1280), (1280, 720), (1184, 880),
             (48, 64), (333, 517), (2000, 900), (900, 2000)]
    for h, w in sizes:
        assert tp.preferred_resolution(h, w) == jp.preferred_resolution(h, w)
    img = (np.random.default_rng(0).random((90, 70, 3)) * 255).astype(
        np.uint8)
    np.testing.assert_array_equal(tp._resize_u8(img, 64, 48),
                                  jp._resize_u8(img, 64, 48))


@pytest.mark.parametrize("dim", [32, 256])
def test_timestep_embedding_matches_jax(dim):
    """Within 1e-6 plus one fp32 ulp of each frequency times the argument's
    scale t * 1000: XLA's fp32 exp is not correctly rounded and takes some
    frequencies one ulp off torch's, which the product carries into cos
    and sin (their slope is at most 1)."""
    t = np.array([0.0, 0.25, 0.7, 1.0, 2.5], np.float32)
    want = np.asarray(jk.timestep_embedding(jnp.asarray(t), dim))
    got = tk.timestep_embedding(torch.as_tensor(t), dim)
    assert got.dtype == torch.float32 and got.shape == (5, dim)
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    lim = 1e-6 + (t[:, None] * 1000.0) * np.tile(freqs, 2) * 2.0 ** -23
    assert np.all(np.abs(got.numpy() - want) <= lim)
    np.testing.assert_allclose(got[:, :half].numpy(),
                               np.cos(t[:, None] * 1000.0 * freqs), atol=1e-3)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["tiny", "d128"])
@pytest.mark.parametrize("policy", ["fp32", "default"])
def test_flux_forward_matches_jax(model, policy):
    """flux_forward at TINY_FLUX (head dim 64: the reference route) and at
    a d=128 config (the kernel route, 144 tokens padded to 256 with
    kv_len), JAX on its Pallas kernel in interpret mode for d=128."""
    cfg_kw = TINY if model == "tiny" else D128
    jcfg, tcfg = jk.FluxConfig(**cfg_kw), tk.FluxConfig(**cfg_kw)
    grid, ref = ((4, 4), (4, 4)) if model == "tiny" else ((8, 8), (8, 9))
    img, txt, pooled, ids = _inputs(cfg_kw, 8, grid, ref)
    params = flux_params(jk.init_flux, jcfg, 1)
    jpol, tpol = ((J_FP32, FP32_POLICY) if policy == "fp32"
                  else (J_DEFAULT, DEFAULT_POLICY))
    t, g = np.array([0.7], np.float32), np.array([2.5], np.float32)
    if model == "d128":
        jbackend("pallas")
        jfa.set_interpret_mode(True)
    try:
        want = np.asarray(jk.flux_forward(
            params, jcfg, jnp.asarray(img), jnp.asarray(txt),
            jnp.asarray(t), guidance=jnp.asarray(g),
            clip_pooled=jnp.asarray(pooled),
            rope_tables=jk.build_rope_from_ids(ids, jcfg.axes_dim,
                                               jcfg.theta),
            policy=jpol), np.float32)
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    flux = convert.flux_from_jax(params, tcfg, device="cpu")
    with torch.no_grad():
        got = tk.flux_forward(
            flux, tcfg, torch.as_tensor(img), torch.as_tensor(txt),
            torch.as_tensor(t), guidance=torch.as_tensor(g),
            clip_pooled=torch.as_tensor(pooled),
            rope_tables=tk.build_rope_from_ids(ids, tcfg.axes_dim,
                                               tcfg.theta, device="cpu"),
            policy=tpol)
    assert got.shape == want.shape and got.dtype == tpol.compute_dtype
    if policy == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        assert _rel(got.float().numpy(), want) < 2e-2


def test_flux_forward_conditioning_and_guidance_required():
    """The guidance embedding is live, and guidance is required when the
    config embeds it (JAX's ValueError)."""
    tcfg = tk.TINY_FLUX
    params = flux_params(jk.init_flux, jk.TINY_FLUX, 2)
    flux = convert.flux_from_jax(params, tcfg, device="cpu")
    img, txt, pooled, ids = _inputs(TINY, 6, (4, 4), (4, 4), seed=3)
    rope = tk.build_rope_from_ids(ids, tcfg.axes_dim, tcfg.theta,
                                  device="cpu")

    def run(g):
        return tk.flux_forward(
            flux, tcfg, torch.as_tensor(img), torch.as_tensor(txt),
            torch.tensor([0.5]), guidance=g,
            clip_pooled=torch.as_tensor(pooled), rope_tables=rope,
            policy=FP32_POLICY)

    with torch.no_grad():
        assert (run(torch.tensor([2.5])) - run(torch.tensor([7.5]))
                ).abs().max() > 1e-6
        with pytest.raises(ValueError, match="guidance"):
            run(None)


# ---------------------------------------------------------------------------
# the text towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_name", ["tiny", "d64"])
def test_clip_text_matches_jax(cfg_name):
    """clip_text_encode's hidden and pooled rows at 1e-5 (fp32, the
    reference route, causal): pooled is the post-LN row at argmax(ids)."""
    kw = dataclasses.asdict(jclip.TINY_CLIP_TEXT)
    if cfg_name == "d64":
        kw.update(hidden_size=128, num_heads=2, intermediate_size=256)
    jcfg, tcfg = jclip.ClipTextConfig(**kw), tclip.ClipTextConfig(**kw)
    params = flux_params(jclip.init_clip_text, jcfg, 4, stacked=("blocks",))
    ids = np.random.default_rng(5).integers(1, 400, (2, 12))
    ids[0, 7], ids[1, 11] = 511, 509    # the EOT row: argmax(ids)
    hj, pj = jclip.clip_text_encode(params, jcfg, jnp.asarray(ids))
    model = convert.clip_text_from_jax(params, tcfg, device="cpu")
    ht, pt = tclip.clip_text_encode(model, torch.as_tensor(ids))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pt[0].numpy(), ht[0, 7].numpy())


def test_t5_shared_pos_matches_jax():
    """T5 v1.1 (TINY_FLUX_T5, shared_pos): t5_from_jax carries layer 0's
    position table only, and encode_padded equals JAX's at 1e-5."""
    cfg_kw = dataclasses.asdict(jp.TINY_FLUX_T5)
    params = jax.tree_util.tree_map(np.asarray, init_t5_encoder(
        jax.random.PRNGKey(6), jp.TINY_FLUX_T5))
    model = convert.t5_from_jax(params, T5Config(**cfg_kw), device="cpu")
    assert "pos_embedding" in model.blocks[0]
    assert "pos_embedding" not in model.blocks[1]
    ids = np.random.default_rng(7).integers(0, 512, (2, 16))
    lens = np.array([9, 16], np.int32)
    want = np.asarray(j_encode_padded(params, jp.TINY_FLUX_T5,
                                      jnp.asarray(ids), jnp.asarray(lens),
                                      compute_dtype=jnp.float32))
    got = t_encode_padded(model, torch.as_tensor(ids), torch.as_tensor(lens),
                          compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def port_pipeline(jpipe, policy=FP32_POLICY):
    """The port's KontextPipeline on the CPU with a JAX pipeline's weights
    (the tiny geometry) and the same hash tokenizers."""
    t = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    t5_cfg = T5Config(**dataclasses.asdict(jpipe.t5_cfg))
    clip_cfg = tclip.ClipTextConfig(**dataclasses.asdict(jpipe.clip_cfg))
    return tp.KontextPipeline(
        convert.flux_from_jax(t(jpipe.flux_params), tk.TINY_FLUX,
                              device="cpu"), tk.TINY_FLUX,
        convert.image_vae_from_jax(t(jpipe.vae_params), tp.TINY_FLUX_VAE,
                                   device="cpu"), tp.TINY_FLUX_VAE,
        convert.t5_from_jax(t(jpipe.t5_params), t5_cfg, device="cpu"),
        t5_cfg, tp._PaddedTok(HashTokenizer(vocab_size=t5_cfg.vocab_size),
                              t5_cfg.text_len),
        convert.clip_text_from_jax(t(jpipe.clip_params), clip_cfg,
                                   device="cpu"),
        clip_cfg, tp._PaddedTok(HashTokenizer(
            vocab_size=clip_cfg.vocab_size), clip_cfg.max_len),
        policy=policy)


@pytest.fixture(scope="module")
def pipes():
    """JAX's tiny pipeline (random_init's geometry, weights from numpy
    seeds: JAX's eager init takes ~30 s) and the port's on its weights."""
    from univid_tpu.models.bagel.autoencoder import init_image_vae
    from univid_tpu.utils.tokenizers import HashTokenizer as JHash

    t5_cfg, clip_cfg = jp.TINY_FLUX_T5, jclip.TINY_CLIP_TEXT
    jpipe = jp.KontextPipeline(
        flux_params(jk.init_flux, jk.TINY_FLUX, 10), jk.TINY_FLUX,
        flux_params(init_image_vae, jp.TINY_FLUX_VAE, 11, stacked=()),
        jp.TINY_FLUX_VAE,
        flux_params(init_t5_encoder, t5_cfg, 12, stacked=()), t5_cfg,
        jp._PaddedTok(JHash(vocab_size=t5_cfg.vocab_size), t5_cfg.text_len),
        flux_params(jclip.init_clip_text, clip_cfg, 13, stacked=("blocks",)),
        clip_cfg,
        jp._PaddedTok(JHash(vocab_size=clip_cfg.vocab_size),
                      clip_cfg.max_len), policy=J_FP32)
    return jpipe, port_pipeline(jpipe)


def _jax_noise(seed, shape):
    return torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), shape, jnp.float32)))


@pytest.mark.parametrize("hw,steps,guidance", [((48, 64), 2, 2.5),
                                               ((32, 48), 3, 4.0)])
def test_kontext_edit_matches_jax(pipes, hw, steps, guidance):
    """KontextPipeline.edit from JAX's noise: the u8 image within one
    level of JAX's (fp32 on both sides); the prompt's T5 and CLIP
    encodings at 1e-5."""
    jpipe, tpipe = pipes
    img = (np.random.default_rng(hw[0]).random(hw + (3,)) * 255).astype(
        np.uint8)
    want = jpipe.edit(img, "T-pose", num_inference_steps=steps,
                      guidance_scale=guidance, seed=3)
    l_tgt = (hw[0] // 4) * (hw[1] // 4)
    got = tpipe.edit(img, "T-pose", num_inference_steps=steps,
                     guidance_scale=guidance,
                     noise=_jax_noise(3, (1, l_tgt, 16)))
    assert got.shape == want.shape == hw + (3,) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    tj, pj = jpipe.encode_prompt("T-pose")
    tt, pt = tpipe.encode_prompt("T-pose")
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)


def test_kontext_edit_conditioning_and_edit_fn(pipes):
    """tests/test_flux.py:256-287 on the port: deterministic for (image,
    prompt, seed); the reference image and the prompt each condition the
    result; make_edit_fn keeps the input's shape; the preferred buckets."""
    _, pipe = pipes
    rng = np.random.default_rng(0)
    img_a = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    img_b = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    out_a = pipe.edit(img_a, "T-pose", num_inference_steps=2, seed=3)
    assert out_a.shape == (48, 64, 3) and out_a.dtype == np.uint8
    np.testing.assert_array_equal(
        out_a, pipe.edit(img_a, "T-pose", num_inference_steps=2, seed=3))
    out_b = pipe.edit(img_b, "T-pose", num_inference_steps=2, seed=3)
    assert np.abs(out_a.astype(int) - out_b.astype(int)).max() > 0
    out_c = pipe.edit(img_a, "arms down by the sides",
                      num_inference_steps=2, seed=3)
    assert np.abs(out_a.astype(int) - out_c.astype(int)).max() > 0
    fn = tp.make_edit_fn(pipeline=pipe, num_inference_steps=2)
    img = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
    out = fn(img, "standardize the pose")
    assert out.shape == img.shape and out.dtype == np.uint8
    assert tp.preferred_resolution(1024, 1024) == (1024, 1024)
    bh, bw = tp.preferred_resolution(720, 1280)
    assert bw > bh
    with pytest.raises(ValueError, match="flux_dir or pipeline"):
        tp.make_edit_fn()


# ---------------------------------------------------------------------------
# converters, manifests, the loader, int8
# ---------------------------------------------------------------------------


def _case_flux():
    sd = sd_from_manifest(JM.flux_transformer_manifest(jk.TINY_FLUX))
    return (TM.flux_transformer_manifest(tk.TINY_FLUX), sd,
            lambda s: TC.convert_flux_transformer(s, tk.TINY_FLUX,
                                                  device="cpu"),
            lambda: JC.convert_flux_transformer(sd, jk.TINY_FLUX),
            lambda t: convert.flux_from_jax(t, tk.TINY_FLUX, device="cpu"),
            STACKED)


def _case_t5():
    sd = sd_from_manifest(JM.t5_hf_manifest(jp.TINY_FLUX_T5))
    cfg = T5Config(**dataclasses.asdict(jp.TINY_FLUX_T5))
    return (TM.t5_hf_manifest(cfg), sd,
            lambda s: TC.convert_t5_hf(s, cfg, device="cpu"),
            lambda: JC.convert_t5_hf(sd, jp.TINY_FLUX_T5),
            lambda t: convert.t5_from_jax(t, cfg, device="cpu"), None)


def _case_clip():
    sd = sd_from_manifest(JM.clip_text_manifest(jclip.TINY_CLIP_TEXT))
    return (TM.clip_text_manifest(tclip.TINY_CLIP_TEXT), sd,
            lambda s: TC.convert_clip_text(s, tclip.TINY_CLIP_TEXT,
                                           device="cpu"),
            lambda: JC.convert_clip_text(sd, jclip.TINY_CLIP_TEXT),
            lambda t: convert.clip_text_from_jax(t, tclip.TINY_CLIP_TEXT,
                                                 device="cpu"), "blocks")


@pytest.mark.parametrize("case", [_case_flux, _case_t5, _case_clip],
                         ids=["flux", "t5_hf", "clip_text"])
def test_converter_equals_jax_leaf_for_leaf(case):
    """The port's manifest is JAX's; its converter reads every key of it
    and gives JAX's tree leaf for leaf (bits and dtypes: bf16 for the
    transformer and T5, fp32 for CLIP by default), the names of
    convert.*_from_jax's module."""
    man, sd, port_fn, jax_fn, from_jax, stacked = case()
    assert man == {k: v.shape for k, v in sd.items()}
    module, leftover = TM.audited(to_torch(sd), port_fn)
    assert leftover == []
    jtree = jax_fn()
    assert_same_module(module, jtree, stacked,
                       from_jax(jax.tree_util.tree_map(np.asarray, jtree)))


@pytest.mark.parametrize("name", ["flux1_kontext_dev", "flux_t5_v1_1_xxl",
                                  "flux_clip_l_text"])
def test_pinned_manifests_regenerate(name):
    man = {"flux1_kontext_dev": lambda: TM.flux_transformer_manifest(
               tk.FluxConfig()),
           "flux_t5_v1_1_xxl": lambda: TM.t5_hf_manifest(tp.FLUX_T5_CONFIG),
           "flux_clip_l_text": lambda: TM.clip_text_manifest(
               tclip.ClipTextConfig())}[name]()
    with open(os.path.join(REPO, "manifests", f"{name}.json")) as fh:
        pinned = {k: tuple(v) for k, v in json.load(fh).items()}
    assert man == pinned


def write_kontext_dir(root, seed=0, extra=None):
    """A Kontext editor dir at the tiny geometry from JAX's manifests
    (numpy, from a seed), with HF's tied embed_tokens and CLIP's
    position_ids beside the keys the converters read; `extra` adds a key
    to the transformer's file. Returns the four state dicts."""
    from safetensors.numpy import save_file

    sds = {
        "flux1-kontext-dev.safetensors": sd_from_manifest(
            JM.flux_transformer_manifest(jk.TINY_FLUX), seed),
        "ae.safetensors": sd_from_manifest(
            TM.flux_ae_manifest(tp.TINY_FLUX_VAE), seed + 1),
        "text_encoder_2/model.safetensors": sd_from_manifest(
            JM.t5_hf_manifest(jp.TINY_FLUX_T5), seed + 2),
        "text_encoder/model.safetensors": sd_from_manifest(
            JM.clip_text_manifest(jclip.TINY_CLIP_TEXT), seed + 3),
    }
    t5 = sds["text_encoder_2/model.safetensors"]
    t5["encoder.embed_tokens.weight"] = t5["shared.weight"].copy()
    sds["text_encoder/model.safetensors"][
        "text_model.embeddings.position_ids"] = np.arange(
            jclip.TINY_CLIP_TEXT.max_len, dtype=np.int64)[None]
    if extra is not None:
        sds["flux1-kontext-dev.safetensors"][extra] = np.zeros(3, np.float32)
    for rel, sd in sds.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        save_file(sd, os.path.join(root, rel))
    return sds


def test_load_kontext_checkpoint_equals_jax(tmp_path):
    """load_kontext_checkpoint(tiny=True) of a synthetic dir: each module
    equal to JAX's converters on the same files leaf for leaf (the
    transformer and both towers in bf16, the AE fp32)."""
    sds = write_kontext_dir(str(tmp_path))
    (flux, fcfg, vae, vcfg, t5, t5_cfg, clip,
     ccfg) = TC.load_kontext_checkpoint(str(tmp_path), device="cpu",
                                        tiny=True)
    assert (fcfg, t5_cfg, ccfg) == (tk.TINY_FLUX, tp.TINY_FLUX_T5,
                                    tclip.TINY_CLIP_TEXT)
    assert vcfg == tp.TINY_FLUX_VAE
    bf16 = jnp.bfloat16
    assert_same_module(flux, JC.convert_flux_transformer(
        sds["flux1-kontext-dev.safetensors"], jk.TINY_FLUX, bf16), STACKED)
    assert_same_module(t5, JC.convert_t5_hf(
        sds["text_encoder_2/model.safetensors"], jp.TINY_FLUX_T5, bf16))
    assert_same_module(clip, JC.convert_clip_text(
        sds["text_encoder/model.safetensors"], jclip.TINY_CLIP_TEXT, bf16),
        "blocks")
    jvae = JC.convert_flux_ae(sds["ae.safetensors"], jp.TINY_FLUX_VAE)
    ref = convert.image_vae_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jvae),
                                     tp.TINY_FLUX_VAE, device="cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(vae.state_dict()[k], v), k


def test_load_kontext_checkpoint_unread_key_raises(tmp_path):
    write_kontext_dir(str(tmp_path), extra="double_blocks.0.img_attn.extra")
    with pytest.raises(ValueError, match="not consumed"):
        TC.load_kontext_checkpoint(str(tmp_path), device="cpu", tiny=True)


def test_quantize_tree_equals_jax():
    """Weight-only int8 on the tiny transformer: the layers quantize_tree
    picks (a block's linear counted over its stack, as JAX's stacked leaf)
    and their codes, scales and biases equal JAX's."""
    params = flux_params(jk.init_flux, jk.TINY_FLUX, 8)
    model = convert.flux_from_jax(params, tk.TINY_FLUX, device="cpu")
    tquant.quantize_tree(model)
    jqp = jax.tree_util.tree_map(np.asarray, jquant.quantize_tree(params))
    assert_same_module(model, jqp, STACKED)
    assert isinstance(model.double_blocks[0].img.qkv, tquant.QuantLinear)
    assert isinstance(model.img_in, tquant.Linear)   # 2,048 < 65,536


def test_quantize_tree_picks_jax_leaves_at_full_size():
    """At FluxConfig() (shapes only: the meta device, jax.eval_shape) the
    port quantizes exactly the layers JAX quantizes."""
    jq = jax.eval_shape(lambda k: jquant.quantize_tree(
        jk.init_flux(k, jk.FluxConfig())), jax.random.PRNGKey(0))
    want = {".".join(str(getattr(p, "key", p)) for p in path[:-1])
            for path, _ in jax.tree_util.tree_leaves_with_path(jq)
            if str(getattr(path[-1], "key", path[-1])) == "qw"}
    model = tk.Flux(tk.FluxConfig(), device="meta")
    tquant.quantize_tree(model)
    got = {name.rsplit(".", 1)[0] for name, _ in model.named_buffers()
           if name.endswith(".qw")}
    stacked = {n.split(".", 2)[0] + "." + n.split(".", 2)[2]
               if n.startswith(STACKED) else n for n in got}
    assert stacked == want
    assert not any(isinstance(m, tquant.Linear) for m in model.modules())


# ---------------------------------------------------------------------------
# fsdp x tp
# ---------------------------------------------------------------------------


def test_flux_fsdp_tp_forward_matches_jax(ranks):
    """tests/test_flux.py:322-352's case: flux_forward sharded by
    flux_param_sharding_rules at fsdp 4 x tp 2 over 8 gloo ranks (each
    rank's heads of the gathered fused qkv / linear1, its columns of
    linear2) equals JAX's unsharded forward at 2e-4 on every rank."""
    jcfg = jk.TINY_FLUX
    img, txt, pooled, ids = _inputs(TINY, 6, (4, 4), (4, 4), seed=2)
    params = flux_params(jk.init_flux, jcfg, 3)
    t, g = np.array([0.5], np.float32), np.array([2.5], np.float32)
    want = np.asarray(jk.flux_forward(
        params, jcfg, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(t),
        guidance=jnp.asarray(g), clip_pooled=jnp.asarray(pooled),
        rope_tables=jk.build_rope_from_ids(ids, jcfg.axes_dim, jcfg.theta),
        policy=J_FP32))
    outs = ranks(8).run(_task_flux_fsdp_tp, TINY, params, img, txt, t, g,
                        pooled, ids)
    d, mlp = jcfg.hidden_size, jcfg.mlp_dim
    for out, shapes in outs:
        # [out, in]: tp on the rows of the fused projections, fsdp on in
        assert shapes == {"double_blocks.0.img.qkv.w": (3 * d // 2, d // 4),
                          "single_blocks.0.linear1.w": ((3 * d + mlp) // 2,
                                                        d // 4),
                          "single_blocks.0.linear2.w": (d // 4,
                                                        (d + mlp) // 2)}
        np.testing.assert_allclose(out, want, atol=2e-4, rtol=2e-4)
