"""The port's WanAnimate (models/wan/animate/*, pipelines/animate.py, its
converters and loader) against univid_tpu's on the CPU.

Parameter trees have the JAX init functions' structure and are filled
from a numpy seed (`np_tree`: non-zero biases and head, norm gains in
[0.5, 1.5], so that every path reaches the output); inputs are numpy
arrays from a seed.
Tolerances: fp32 paths agree to summation order (1e-5 for the towers, 1e-4
for whole models and pipelines over several blocks and steps); under the
bf16 policy each GEMM rounds to bf16 at the same points in both packages
but the two frameworks accumulate in other orders, so whole-model outputs
are held to a relative L2 error of 2e-2 (test_torch_models' bound).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu.core.config import ANIMATE_CONFIGS as JANIMATE
from univid_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.models.wan import animate as ja
from univid_tpu.models.wan.animate import face_blocks as jfb
from univid_tpu.models.wan.animate import motion_encoder as jme
from univid_tpu.pipelines import animate as jpa
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import ANIMATE_CONFIGS
from univid_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from univid_tpu_torch.models.wan import animate as ta
from univid_tpu_torch.models.wan.animate import face_blocks as tfb
from univid_tpu_torch.models.wan.animate import motion_encoder as tme
from univid_tpu_torch.pipelines import animate as tpa

torch.set_num_threads(2)

TINY_CHANNELS = ((4, 16), (8, 16), (16, 8))
# the d=128 config: 10 layers, so two face adapters (after blocks 0 and 5)
D128 = dict(patch_size=(1, 2, 2), text_len=8, in_dim=12, dim=256,
            ffn_dim=512, freq_dim=32, text_dim=32, out_dim=4, num_heads=2,
            num_layers=10, motion_encoder_dim=16, clip_tokens=5, clip_dim=16,
            motion_size=16, motion_dim=4, vae_z_dim=4, face_width=8,
            motion_channels=TINY_CHANNELS)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


STACKED = ("blocks", "layers", "face_adapter")


def np_tree(init_fn, cfg, seed):
    """A parameter tree of init_fn's structure (jax.eval_shape: nothing
    computed) filled from a numpy seed: the motion encoder's convs, linears
    and direction N(0, 1) (EqualConv2d / EqualLinear scale them at run
    time), other weights N(0, 1/fan_in), biases N(0, 0.02^2), one-gain-a-
    channel leaves (norm gains) U(0.5, 1.5), modulations N(0, 1/d),
    embeddings and the rest N(0, 0.02^2). Leading layer axes of the
    stacked subtrees are not fan-in."""
    shapes = jax.eval_shape(lambda k: init_fn(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        name, shape = keys[-1], a.shape
        lead = 1 if keys[0] in STACKED else 0
        rank = len(shape) - lead
        if keys[0] == "motion_encoder" and name in ("w", "direction"):
            x = rng.standard_normal(shape)
        elif name == "w" and rank >= 2:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(
                shape[lead:-1]))
        elif name in ("b", "act_b"):
            x = rng.standard_normal(shape) * 0.02
        elif name == "modulation":
            x = rng.standard_normal(shape) / np.sqrt(shape[-1])
        elif rank == 1:
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = rng.standard_normal(shape) * 0.02
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def animate_params(cfg, seed=0):
    """`np_tree` of init_wan_animate; one tree a (cfg, seed), which callers
    do not modify."""
    return np_tree(ja.init_wan_animate, cfg, seed)


def _jax_pallas(fn, on):
    """fn() with JAX's attention on its Pallas kernels in interpret mode
    (the d=128 route) when `on`."""
    if on:
        jbackend("pallas")
        jfa.set_interpret_mode(True)
    try:
        return fn()
    finally:
        if on:
            jfa.set_interpret_mode(False)
            jbackend(None)


# ---------------------------------------------------------------------------
# the pipeline's host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("real,clip,overlap", [(100, 77, 1), (77, 77, 1),
                                               (9, 5, 1), (200, 77, 5),
                                               (13, 9, 5), (5, 5, 1)])
def test_valid_len_and_padding_match_jax(real, clip, overlap):
    n = jpa.get_valid_len(real, clip, overlap)
    assert tpa.get_valid_len(real, clip, overlap) == n
    frames = list(range(real))
    assert tpa.inputs_padding(frames, n) == jpa.inputs_padding(frames, n)


@pytest.mark.parametrize("mask_len", [0, 1, 5])
@pytest.mark.parametrize("with_pixels", [False, True])
def test_i2v_mask_matches_jax(mask_len, with_pixels):
    lat_t, h, w = 3, 4, 6
    pix = None
    if with_pixels:
        pix = (np.random.default_rng(3).random((1, 9, h, w)) > 0.5).astype(
            np.float32)
    want = np.asarray(jpa.get_i2v_mask(
        lat_t, h, w, mask_len,
        mask_pixel_values=None if pix is None else jnp.asarray(pix)))
    got = tpa.get_i2v_mask(lat_t, h, w, mask_len,
                           mask_pixel_values=None if pix is None
                           else torch.as_tensor(pix)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_replace_mask_downsample_matches_jax():
    """The replace mode's mask: 1 - mask, nearest [::8, ::8], through
    get_i2v_mask with the overlap set: equal bits."""
    mask = (np.random.default_rng(4).random((5, 32, 48)) > 0.5).astype(
        np.float32)
    inv = 1.0 - mask
    want = np.asarray(jpa.get_i2v_mask(2, 4, 6, 1, mask_pixel_values=(
        jnp.asarray(inv[:, ::8, ::8])[None])))
    got = tpa.get_i2v_mask(2, 4, 6, 1, mask_pixel_values=(
        1.0 - torch.as_tensor(mask))[:, ::8, ::8][None]).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# motion encoder, face encoder and face block
# ---------------------------------------------------------------------------


def test_get_motion_matches_jax():
    cfg = JANIMATE["tiny-animate"]()[0]
    params = animate_params(cfg)
    img = np.clip(_rand((3, 16, 16, 3), 1), -1, 1)
    want = np.asarray(jme.get_motion(params["motion_encoder"],
                                     jnp.asarray(img)))
    model = convert.wan_animate_from_jax(params, ANIMATE_CONFIGS[
        "tiny-animate"]()[0], device="cpu")
    got = tme.get_motion(model.motion_encoder, torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t_pix,lat_t", [(77, 20), (13, 4), (5, 2)])
def test_face_encoder_matches_jax(t_pix, lat_t):
    """The causal pyramid takes T frames to ceil(T / 4) rows, heads + 1
    tokens a row."""
    cfg = JANIMATE["tiny-animate"]()[0]
    params = animate_params(cfg)
    x = _rand((2, t_pix, cfg.motion_encoder_dim), 3)
    want = np.asarray(jfb.face_encoder_forward(params["face_encoder"],
                                               jnp.asarray(x)))
    model = convert.wan_animate_from_jax(params, ANIMATE_CONFIGS[
        "tiny-animate"]()[0], device="cpu")
    got = tfb.face_encoder_forward(model.face_encoder,
                                   torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, lat_t, 5, cfg.dim)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_face_block_d128_matches_jax(masked):
    """face_block_forward at d=128 (2 heads of a 256 width), fp32: JAX's
    Pallas kernel in interpret mode against the port's plain version, 3
    latent frames of 12 tokens over 5 motion tokens."""
    jcfg = ja.WanAnimateConfig(**D128)
    params = animate_params(jcfg)
    ad = jax.tree_util.tree_map(lambda a: a[1], params["face_adapter"])
    x = _rand((1, 36, 256), 5)
    mv = _rand((1, 3, 5, 256), 6)
    mask = (np.random.default_rng(7).random((1, 36)) > 0.3).astype(
        np.float32) if masked else None
    want = _jax_pallas(lambda: np.asarray(jfb.face_block_forward(
        ad, jnp.asarray(x), jnp.asarray(mv), 2,
        motion_mask=None if mask is None else jnp.asarray(mask))), True)
    model = convert.wan_animate_from_jax(params, ta.WanAnimateConfig(**D128),
                                         device="cpu")
    got = tfb.face_block_forward(
        model.face_adapter[1], torch.as_tensor(x), torch.as_tensor(mv), 2,
        motion_mask=None if mask is None else torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the animate DiT
# ---------------------------------------------------------------------------


def _forward_inputs(cfg, seed):
    f_lat, hh, ww = 2, 4, 4
    return dict(
        x=_rand((1, f_lat + 1, hh, ww, cfg.in_dim), seed),
        t=np.full((1,), 500.0, np.float32),
        ctx=_rand((1, cfg.text_len, cfg.text_dim), seed + 1, 0.5),
        clip=_rand((1, cfg.clip_tokens, cfg.clip_dim), seed + 2),
        pose=_rand((1, f_lat, hh, ww, cfg.vae_z_dim), seed + 3),
        face=np.clip(_rand((1, 5, cfg.motion_size, cfg.motion_size, 3),
                           seed + 4), -1, 1))


@pytest.mark.parametrize("model", ["tiny", "d128"])
@pytest.mark.parametrize("policy", ["fp32", "default", "bounded",
                                    "softmax_bf16"])
def test_animate_forward_matches_jax(model, policy):
    """wan_animate_forward at tiny-animate (d=8: the reference route) and
    at the 10-layer d=128 config (the kernel route's plain versions; JAX on
    its Pallas kernels in interpret mode): fp32 to 1e-4 rel. L2; the bf16
    policy, bounded_softmax and softmax_bf16 within 2e-2 rel. L2."""
    if model == "tiny":
        jcfg = JANIMATE["tiny-animate"]()[0]
        tcfg = ANIMATE_CONFIGS["tiny-animate"]()[0]
    else:
        jcfg, tcfg = ja.WanAnimateConfig(**D128), ta.WanAnimateConfig(**D128)
    params = animate_params(jcfg)
    inp = _forward_inputs(jcfg, 20)
    jpol = J_FP32 if policy == "fp32" else J_DEFAULT
    tpol = FP32_POLICY if policy == "fp32" else DEFAULT_POLICY
    if policy in ("bounded", "softmax_bf16"):
        flag = {"bounded": "bounded_softmax",
                "softmax_bf16": "softmax_bf16"}[policy]
        jpol = dataclasses.replace(jpol, **{flag: True})
        tpol = dataclasses.replace(tpol, **{flag: True})
    want = _jax_pallas(lambda: np.asarray(ja.wan_animate_forward(
        _jnp(params), jcfg, *(jnp.asarray(inp[k]) for k in
                        ("x", "t", "ctx", "clip", "pose", "face")),
        policy=jpol)), model == "d128")
    net = convert.wan_animate_from_jax(params, tcfg, device="cpu")
    got = ta.wan_animate_forward(
        net, *(torch.as_tensor(inp[k]) for k in
               ("x", "t", "ctx", "clip", "pose", "face")), policy=tpol)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-3
    limit = 1e-4 if policy == "fp32" else 2e-2
    assert _rel(got.numpy(), want) < limit, _rel(got.numpy(), want)


# ---------------------------------------------------------------------------
# CLIP towers
# ---------------------------------------------------------------------------

CLIP_TINY = dict(image_size=28, patch_size=14, dim=16, num_heads=2,
                 num_layers=3)


@pytest.mark.parametrize("hw", [(40, 30), (20, 12), (28, 28)])
def test_clip_preprocess_matches_jax(hw):
    """jax.image.resize 'bicubic' (Keys a = -0.5, antialiased) to 28x28
    from a downsampling, an upsampling and an equal size, then the CLIP
    normalisation."""
    jc, tc = ja.ClipVisionConfig(**CLIP_TINY), ta.ClipVisionConfig(
        **CLIP_TINY)
    frame = np.clip(_rand(hw + (3,), 30, 0.6), -1, 1)
    want = np.asarray(ja.clip_preprocess(jnp.asarray(frame), jc))
    got = ta.clip_preprocess(torch.as_tensor(frame), tc).numpy()
    assert got.shape == want.shape == (28, 28, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_31_block", [True, False])
def test_clip_visual_forward_matches_jax(use_31_block):
    jc, tc = ja.ClipVisionConfig(**CLIP_TINY), ta.ClipVisionConfig(
        **CLIP_TINY)
    params = np_tree(ja.init_clip_vision, jc, 31)
    img = _rand((28, 28, 3), 32)
    want = np.asarray(ja.clip_visual_forward(_jnp(params), jc,
                                             jnp.asarray(img),
                                             use_31_block=use_31_block))
    net = convert.clip_vit_from_jax(params, tc, device="cpu")
    got = ta.clip_visual_forward(net, tc, torch.as_tensor(img),
                                 use_31_block=use_31_block).numpy()
    assert got.shape == want.shape == (5, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


XLMR_TINY = dict(vocab_size=64, max_seq_len=16, pad_id=1, dim=32,
                 num_heads=4, num_layers=2, out_dim=24)


def _xlmr_sd(params, cfg):
    """The reference XLMRobertaWithHead state dict (under `textual.`) of a
    JAX clip_text tree."""
    sd = {"textual.token_embedding.weight": params["token_embed"],
          "textual.type_embedding.weight": params["type_embed"],
          "textual.pos_embedding.weight": params["pos_embed"],
          "textual.norm.weight": params["embed_norm"]["w"],
          "textual.norm.bias": params["embed_norm"]["b"],
          "textual.head.0.weight": params["head"]["fc0"]["w"].T,
          "textual.head.2.weight": params["head"]["fc1"]["w"].T}
    for i in range(cfg.num_layers):
        lyr = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
        b = f"textual.blocks.{i}"
        for k in "qkvo":
            sd[f"{b}.attn.{k}.weight"] = lyr["attn"][k]["w"].T
            sd[f"{b}.attn.{k}.bias"] = lyr["attn"][k]["b"]
        for n in ("norm1", "norm2"):
            sd[f"{b}.{n}.weight"] = lyr[n]["w"]
            sd[f"{b}.{n}.bias"] = lyr[n]["b"]
        for j, fc in ((0, "fc0"), (2, "fc1")):
            sd[f"{b}.ffn.{j}.weight"] = lyr["mlp"][fc]["w"].T
            sd[f"{b}.ffn.{j}.bias"] = lyr["mlp"][fc]["b"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def test_clip_text_forward_and_converter_match_jax():
    """The XLM-R text tower: pad keys masked, the Roberta position ids, the
    masked mean pool and the head, fp32 to 1e-5; its converter from the
    reference state dict equal to JAX's tree and to clip_text_xlmr_from_jax
    bit for bit."""
    from univid_tpu_torch.models.wan.animate.clip_text import (
        convert_clip_text_xlm_roberta)
    jc = ja.ClipTextXlmRobertaConfig(**XLMR_TINY)
    tc = ta.ClipTextXlmRobertaConfig(**XLMR_TINY)
    params = np_tree(ja.init_clip_text, jc, 33)
    ids = np.array([[5, 9, 17, 3, 2, 1, 1, 1],
                    [7, 30, 2, 1, 1, 1, 1, 1]], np.int64)
    want = np.asarray(ja.clip_text_forward(_jnp(params), jc,
                                           jnp.asarray(ids, jnp.int32)))
    net = convert.clip_text_xlmr_from_jax(params, tc, device="cpu")
    got = ta.clip_text_forward(net, tc, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    sd = _xlmr_sd(params, jc)
    jtree = ja.convert_clip_text_xlm_roberta(sd, jc)
    loaded = convert_clip_text_xlm_roberta(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, tc,
        device="cpu")
    ref = convert.clip_text_xlmr_from_jax(_np_tree(jtree), tc, device="cpu")
    for k, t in ref.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k


# ---------------------------------------------------------------------------
# converters and the loader
# ---------------------------------------------------------------------------


def animate_sd(params, cfg):
    """The reference WanAnimateModel state dict of a JAX animate tree
    (model_animate.py naming; the motion encoder's ConvLayers without a
    conv bias, as the reference's EqualConv2d before a FusedLeakyReLU)."""
    sd = {}
    pt, ph, pw = cfg.patch_size

    def lin(key, p):
        sd[f"{key}.weight"] = p["w"].T
        if "b" in p:
            sd[f"{key}.bias"] = p["b"]

    for name, cin in (("patch_embedding", cfg.in_dim),
                      ("pose_patch_embedding", cfg.vae_z_dim)):
        p = params[name.replace("embedding", "embed")]
        sd[f"{name}.weight"] = p["w"].reshape(pt, ph, pw, cin, cfg.dim) \
            .transpose(4, 3, 0, 1, 2)
        sd[f"{name}.bias"] = p["b"]
    for src, dst in (("text_embedding", (0, 2)), ("time_embedding", (0, 2))):
        for j, fc in zip(dst, ("fc0", "fc1")):
            lin(f"{src}.{j}", params[src][fc])
    lin("time_projection.1", params["time_projection"]["fc0"])
    lin("head.head", params["head"]["head"])
    sd["head.modulation"] = params["head"]["modulation"][None]
    ie = params["img_emb"]
    for j, nm in ((0, "ln0"), (4, "ln1")):
        sd[f"img_emb.proj.{j}.weight"] = ie[nm]["w"]
        sd[f"img_emb.proj.{j}.bias"] = ie[nm]["b"]
    lin("img_emb.proj.1", ie["fc0"])
    lin("img_emb.proj.3", ie["fc1"])
    for i in range(cfg.num_layers):
        blk = jax.tree_util.tree_map(lambda a: a[i], params["blocks"])
        b = f"blocks.{i}"
        for mod in ("self_attn", "cross_attn"):
            for k, p in blk[mod].items():
                if k.startswith("norm"):
                    sd[f"{b}.{mod}.{k}.weight"] = p
                else:
                    lin(f"{b}.{mod}.{k}", p)
        lin(f"{b}.ffn.0", blk["ffn"]["fc0"])
        lin(f"{b}.ffn.2", blk["ffn"]["fc1"])
        sd[f"{b}.norm3.weight"] = blk["norm3"]["w"]
        sd[f"{b}.norm3.bias"] = blk["norm3"]["b"]
        sd[f"{b}.modulation"] = blk["modulation"][None]
    me, mp = "motion_encoder.enc.net_app.convs", params["motion_encoder"]

    def conv(key, p):
        sd[f"{key}.weight"] = p["w"].transpose(3, 2, 0, 1)

    conv(f"{me}.0.0", mp["first"])
    sd[f"{me}.0.1.bias"] = mp["first"]["act_b"]
    for i, bp in enumerate(mp["blocks"], start=1):
        conv(f"{me}.{i}.conv1.0", bp["conv1"])
        sd[f"{me}.{i}.conv1.1.bias"] = bp["conv1"]["act_b"]
        conv(f"{me}.{i}.conv2.1", bp["conv2"])
        sd[f"{me}.{i}.conv2.2.bias"] = bp["conv2"]["act_b"]
        conv(f"{me}.{i}.skip.1", bp["skip"])
    conv(f"{me}.{len(mp['blocks']) + 1}", mp["final"])
    for i, fp in enumerate(mp["fc"]):
        lin(f"motion_encoder.enc.fc.{i}", fp)
    sd["motion_encoder.dec.direction.weight"] = mp["direction"]
    fe = params["face_encoder"]
    for nm in ("conv1_local", "conv2", "conv3"):
        sd[f"face_encoder.{nm}.conv.weight"] = fe[nm]["w"].transpose(2, 1, 0)
        sd[f"face_encoder.{nm}.conv.bias"] = fe[nm]["b"]
    lin("face_encoder.out_proj", fe["out_proj"])
    sd["face_encoder.padding_tokens"] = fe["padding_tokens"]
    for j in range(cfg.adapter_layers):
        ad = jax.tree_util.tree_map(lambda a: a[j], params["face_adapter"])
        b = f"face_adapter.fuser_blocks.{j}"
        for k in ("linear1_kv", "linear1_q", "linear2"):
            lin(f"{b}.{k}", ad[k])
        sd[f"{b}.q_norm.weight"] = ad["q_norm"]
        sd[f"{b}.k_norm.weight"] = ad["k_norm"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def clip_sd(params, cfg):
    """The reference CLIPModel's `visual.` state dict of a JAX ViT tree,
    with the keys the visual extraction never reads beside it (textual,
    log_scale, post_norm, head)."""
    p, d = cfg.patch_size, cfg.dim
    sd = {"visual.patch_embedding.weight": params["patch_embed"]["w"]
          .reshape(p, p, 3, d).transpose(3, 2, 0, 1),
          "visual.cls_embedding": params["cls"].reshape(1, 1, d),
          "visual.pos_embedding": params["pos_embed"][None],
          "visual.pre_norm.weight": params["pre_norm"]["w"],
          "visual.pre_norm.bias": params["pre_norm"]["b"],
          "visual.post_norm.weight": np.ones(d, np.float32),
          "visual.post_norm.bias": np.zeros(d, np.float32),
          "visual.head": np.zeros((d, 8), np.float32),
          "textual.token_embedding.weight": np.zeros((4, 8), np.float32),
          "log_scale": np.zeros((), np.float32)}
    for i in range(cfg.num_layers):
        lyr = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
        b = f"visual.transformer.{i}"
        for n, src in (("norm1", "ln1"), ("norm2", "ln2")):
            sd[f"{b}.{n}.weight"] = lyr[src]["w"]
            sd[f"{b}.{n}.bias"] = lyr[src]["b"]
        sd[f"{b}.attn.to_qkv.weight"] = np.concatenate(
            [lyr["attn"][k]["w"].T for k in "qkv"], axis=0)
        sd[f"{b}.attn.to_qkv.bias"] = np.concatenate(
            [lyr["attn"][k]["b"] for k in "qkv"], axis=0)
        sd[f"{b}.attn.proj.weight"] = lyr["attn"]["o"]["w"].T
        sd[f"{b}.attn.proj.bias"] = lyr["attn"]["o"]["b"]
        sd[f"{b}.mlp.0.weight"] = lyr["mlp"]["fc0"]["w"].T
        sd[f"{b}.mlp.0.bias"] = lyr["mlp"]["fc0"]["b"]
        sd[f"{b}.mlp.2.weight"] = lyr["mlp"]["fc1"]["w"].T
        sd[f"{b}.mlp.2.bias"] = lyr["mlp"]["fc1"]["b"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def _torch_sd(sd):
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def _same(module, ref):
    """Two modules' state dicts equal, name for name, dtype for dtype, bit
    for bit."""
    a, b = module.state_dict(), ref.state_dict()
    assert set(a) == set(b)
    for k, t in b.items():
        assert a[k].dtype == t.dtype and torch.equal(a[k], t), k


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_convert_wan_animate_matches_jax(dtype):
    """convert_wan_animate of a reference-layout state dict == JAX's
    converted tree (through wan_animate_from_jax) bit for bit, the DiT in
    `dtype`, the time MLPs, head, modulations, motion encoder and face
    encoder convs in fp32; the converted model's forward == the tree's."""
    from univid_tpu.core import checkpoint as JC
    from univid_tpu_torch.core import checkpoint as TC
    jcfg, tcfg = ja.WanAnimateConfig(**D128), ta.WanAnimateConfig(**D128)
    params = animate_params(jcfg)
    sd = animate_sd(params, jcfg)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jtree = JC.convert_wan_animate(sd, jcfg, dtype=jd)
    got = TC.convert_wan_animate(_torch_sd(sd), tcfg, td, device="cpu")
    ref = convert.wan_animate_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jtree),
                                       tcfg, device="cpu", dtype=td)
    _same(got, ref)
    islands = ("time_embedding.", "time_projection.", "head.",
               "motion_encoder.", "face_encoder.conv")
    for k, t in got.state_dict().items():
        f32 = k.startswith(islands) or k.endswith("modulation")
        assert t.dtype == (torch.float32 if f32 else td), k


def test_convert_clip_vit_matches_jax():
    from univid_tpu.core import checkpoint as JC
    from univid_tpu_torch.core import checkpoint as TC
    jc, tc = ja.ClipVisionConfig(**CLIP_TINY), ta.ClipVisionConfig(
        **CLIP_TINY)
    params = np_tree(ja.init_clip_vision, jc, 34)
    sd = clip_sd(params, jc)
    jtree = JC.convert_clip_vit(sd, jc, dtype=jnp.bfloat16)
    got = TC.convert_clip_vit(_torch_sd(sd), tc, torch.bfloat16,
                              device="cpu")
    _same(got, convert.clip_vit_from_jax(jax.tree_util.tree_map(
        np.asarray, jtree), tc, device="cpu", dtype=torch.bfloat16))


def test_load_wan_animate_checkpoint_matches_jax_and_audits(tmp_path):
    """A WanAnimate dir (the transformer as sharded safetensors with its
    index, Wan2.1_VAE.pth, the CLIP .pth with its text side): the port's
    loader gives JAX's three trees bit for bit, skips the CLIP keys the
    visual extraction never reads, and raises on an unread transformer
    key (JAX's loader does not audit)."""
    from test_torch_checkpoint import sd_from_manifest, write_sharded
    from univid_tpu.core import checkpoint as JC
    from univid_tpu.core.config import WanVAEConfig as JVAE
    from univid_tpu_torch.core import checkpoint as TC
    from univid_tpu_torch.core.config import WanVAEConfig
    from univid_tpu_torch.core.manifest import wan_vae_manifest
    jcfg, tcfg = ja.WanAnimateConfig(**D128), ta.WanAnimateConfig(**D128)
    _, jvae, _ = JANIMATE["tiny-animate"]()
    tvae = WanVAEConfig(**dataclasses.asdict(jvae))
    jc, tc = ja.ClipVisionConfig(**CLIP_TINY), ta.ClipVisionConfig(
        **CLIP_TINY)
    sd = animate_sd(animate_params(jcfg), jcfg)
    write_sharded(str(tmp_path), sd)
    torch.save(_torch_sd(sd_from_manifest(wan_vae_manifest(tvae), 35)),
               str(tmp_path / "Wan2.1_VAE.pth"))
    torch.save(_torch_sd(clip_sd(np_tree(ja.init_clip_vision, jc, 36), jc)),
               str(tmp_path / "clip.pth"))
    jm, jv, jcl = JC.load_wan_animate_checkpoint(str(tmp_path), jcfg,
                                                 JVAE(**dataclasses.asdict(
                                                     jvae)), jc)
    tm, tv, tcl = TC.load_wan_animate_checkpoint(str(tmp_path), tcfg, tvae,
                                                 tc, device="cpu")
    np_ = functools.partial(jax.tree_util.tree_map, np.asarray)
    _same(tm, convert.wan_animate_from_jax(np_(jm), tcfg, device="cpu",
                                           dtype=torch.bfloat16))
    _same(tv, convert.vae_from_jax(np_(jv), tvae, device="cpu"))
    _same(tcl, convert.clip_vit_from_jax(np_(jcl), tc, device="cpu",
                                         dtype=torch.bfloat16))
    extra = dict(sd, **{"blocks.0.extra.weight": np.zeros(3, np.float32)})
    for f in tmp_path.glob("diffusion_pytorch_model*"):
        f.unlink()
    write_sharded(str(tmp_path), extra)
    with pytest.raises(ValueError, match="not consumed"):
        TC.load_wan_animate_checkpoint(str(tmp_path), tcfg, tvae, tc,
                                       device="cpu")


# ---------------------------------------------------------------------------
# the written-out resample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape,out", [
    ((40, 30, 3), (28, 28, 3)),          # down on both axes
    ((20, 12, 3), (28, 28, 3)),          # up on both axes
    ((5, 24, 24, 3), (5, 16, 16, 3)),    # the CLI's face crops (down)
    ((24, 24, 3), (32, 48, 3)),          # the CLI's reference image (up)
    ((33, 17, 3), (16, 40, 3))])         # down one axis, up the other
def test_resize_matches_jax_image_resize(method, shape, out):
    """ops.resize.resize == jax.image.resize (antialiased, Keys' a = -0.5
    for bicubic) in fp32, 1e-5."""
    x = _rand(shape, 60)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method=method))
    from univid_tpu_torch.ops.resize import resize
    got = resize(torch.as_tensor(x), out, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
