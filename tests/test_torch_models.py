"""The port's Wan models against univid_tpu's: DiT forward, VAE decode,
UMT5 encode. Parameter trees have the JAX init functions' structure, are
filled from a numpy seed and reach the port through univid_tpu_torch.convert;
inputs are numpy arrays from a seed.

Tolerances: fp32 paths agree to ~1e-5 relative (conftest pins JAX matmuls
to the highest precision); under the default bf16 compute policy each GEMM
rounds to bf16 (2^-8) at the same points in both packages, but the two
frameworks' bf16 kernels accumulate in other orders, so whole-model outputs
are held to a relative L2 error of 2e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu.core.config import T5Config as JT5Config
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.models.wan.dit import init_wan_dit, wan_dit_forward
from univid_tpu.models.wan.t5 import encode_padded as j_encode_padded
from univid_tpu.models.wan.t5 import init_t5_encoder
from univid_tpu.models.wan.vae_api import init_wan_vae
from univid_tpu.models.wan.vae_api import vae_decode as j_vae_decode
from univid_tpu.models.wan.vae_api import vae_encode as j_vae_encode
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import T5Config, WanDiTConfig
from univid_tpu_torch.core.config import WAN_CONFIGS
from univid_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from univid_tpu_torch.models.wan.dit import wan_dit_forward as t_dit
from univid_tpu_torch.models.wan.t5 import encode_padded as t_encode_padded
from univid_tpu_torch.models.wan.vae_api import vae_decode as t_vae_decode
from univid_tpu_torch.models.wan.vae_api import vae_encode as t_vae_encode
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def np_params(init_fn, cfg, seed, stacked=False):
    """A parameter tree of init_fn's structure and shapes (jax.eval_shape,
    no JAX compile), filled from a numpy seed: linear/conv weights
    N(0, 1/fan_in), biases N(0, 0.02^2), gains U(0.5, 1.5) (non-unit
    qk-norm gains move the softmax bounds), modulations N(0, 1/d),
    embeddings N(0, 1). Leading layer axes (`stacked`) are not fan-in."""
    shapes = jax.eval_shape(functools.partial(init_fn, cfg=cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        top = str(getattr(path[0], "key", path[0]))
        shape = s.shape
        lead = 1 if stacked and top == "blocks" else 0
        if name == "w" and len(shape) - lead >= 2:
            fan_in = int(np.prod(shape[lead:-1]))
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "b":
            x = rng.standard_normal(shape) * 0.02
        elif name in ("modulation",):
            x = rng.standard_normal(shape) / np.sqrt(shape[-1])
        elif name == "pos_embedding":
            x = rng.standard_normal(shape) * 0.1
        elif len(shape) - lead == 1:  # norm gains (incl. norm3 "w")
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


D128 = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=16,
            out_dim=16, text_dim=32, freq_dim=32, text_len=8,
            patch_size=(1, 2, 2))


@pytest.mark.parametrize("model", ["tiny", "d128"])
@pytest.mark.parametrize("policy", ["fp32", "default"])
def test_dit_forward_matches_jax(model, policy):
    """wan_dit_forward at `tiny` (head dim 16: the reference route) and at a
    2-layer d=128 config (the kernel route: fused rope, bounded softmax,
    kv_len from seq_pad_to, the cross path), JAX on its Pallas kernels in
    interpret mode for d=128."""
    if model == "tiny":
        jc, tc = JCONFIGS["tiny"].dit, WAN_CONFIGS["tiny"].dit
        x = _rand((2, 3, 8, 8, jc.in_dim), 0)
        grid = (3, 4, 4)
    else:
        jc, tc = JDiTConfig(**D128), WanDiTConfig(**D128)
        x = _rand((2, 2, 8, 8, 16), 0)
        grid = (2, 4, 4)
    params = np_params(init_wan_dit, jc, 1, stacked=True)
    t = np.array([700.0, 700.0], np.float32)
    ctx = _rand((2, jc.text_len, jc.text_dim), 2, 0.5)
    jpol = J_FP32 if policy == "fp32" else J_DEFAULT
    tpol = FP32_POLICY if policy == "fp32" else DEFAULT_POLICY
    jpol = dataclasses.replace(jpol, bounded_softmax=True)
    tpol = dataclasses.replace(tpol, bounded_softmax=True)
    cos, sin = jrope3d(jc.head_dim, grid)
    kw = dict(seq_pad_to=64, fused_rope=True)
    if model == "d128":
        jbackend("pallas")
        jfa.set_interpret_mode(True)
    try:
        want = wan_dit_forward(params, jc, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(ctx), cos, sin, policy=jpol, **kw)
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    dit = convert.dit_from_jax(params, tc, device="cpu")
    tcos, tsin = trope3d(tc.head_dim, grid, device="cpu")
    got = t_dit(dit, torch.as_tensor(x), torch.as_tensor(t),
                torch.as_tensor(ctx), tcos, tsin, policy=tpol, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    if policy == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    else:
        assert _rel(got.numpy(), want) < 2e-2


@pytest.mark.parametrize("which", ["tiny", "t2v-1.3B", "ti2v-5B"])
def test_vae_decode_matches_jax_and_streams(which):
    """vae_decode, streaming per latent frame, == JAX vae_decode and == the
    port's full-sequence decode, in fp32 (the latent enters the decoder in
    fp32). The d=384 (t2v-1.3B) and d=1024 (ti2v-5B, the full Wan2.2 VAE
    on a 2x2 latent) mid-block attention take the kernel route (JAX: its
    Pallas kernel in interpret mode)."""
    jc, tc = JCONFIGS[which].vae, WAN_CONFIGS[which].vae
    params = np_params(init_wan_vae, jc, 3)
    hw = 2 if which == "ti2v-5B" else 4
    z = _rand((1, 3 if which == "tiny" else 2, hw, hw, jc.z_dim), 4)
    jbackend("pallas" if which != "tiny" else None)
    jfa.set_interpret_mode(which != "tiny")
    try:
        want = np.asarray(jax.jit(lambda p, z: j_vae_decode(p, jc, z))(
            params, jnp.asarray(z)))
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    vae = convert.vae_from_jax(params, tc, device="cpu")
    got = t_vae_decode(vae, torch.as_tensor(z)).numpy()
    full = t_vae_decode(vae, torch.as_tensor(z), streaming=False).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-5)


def test_vae_encode_matches_jax():
    """vae_encode (streaming: first frame, then 4-frame chunks) on the tiny
    VAE == JAX vae_encode, fp32."""
    jc, tc = JCONFIGS["tiny"].vae, WAN_CONFIGS["tiny"].vae
    params = np_params(init_wan_vae, jc, 8)
    video = np.clip(_rand((1, 9, 32, 32, 3), 9, 0.5), -1, 1)
    want = np.asarray(jax.jit(lambda p, v: j_vae_encode(p, jc, v))(
        params, jnp.asarray(video)))
    got = t_vae_encode(convert.vae_from_jax(params, tc, device="cpu"),
                       torch.as_tensor(video)).numpy()
    assert got.shape == want.shape == (1, 3, 2, 2, jc.z_dim)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_vae_encode_ti2v5b_first_frame_matches_jax():
    """The i2v encode at the full Wan2.2 VAE config: one 32x32 frame (the
    non-streaming t == 1 branch, whose stride-2 time convs have no full
    window), spatial patch 2, the encoder's d=640 mid-block attention on
    the kernel route (JAX: its Pallas kernel in interpret mode); fp32,
    1e-4."""
    jc, tc = JCONFIGS["ti2v-5B"].vae, WAN_CONFIGS["ti2v-5B"].vae
    params = np_params(init_wan_vae, jc, 10)
    image = np.clip(_rand((1, 1, 32, 32, 3), 11, 0.5), -1, 1)
    jbackend("pallas")
    jfa.set_interpret_mode(True)
    try:
        want = np.asarray(jax.jit(lambda p, v: j_vae_encode(p, jc, v))(
            params, jnp.asarray(image)))
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    got = t_vae_encode(convert.vae_from_jax(params, tc, device="cpu"),
                       torch.as_tensor(image)).numpy()
    assert got.shape == want.shape == (1, 1, 2, 2, 48)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t5_encode_matches_jax(dtype):
    """UMT5 with per-layer position bias, masked, padded rows zeroed."""
    kw = dict(vocab_size=512, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
              num_layers=2, text_len=16)
    jc, tc = JT5Config(**kw), T5Config(**kw)
    params = np_params(init_t5_encoder, jc, 6)
    ids = np.random.default_rng(7).integers(0, 512, (2, 16)).astype(
        np.int32)
    lens = np.array([11, 16], np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = j_encode_padded(params, jc, jnp.asarray(ids), jnp.asarray(lens),
                           compute_dtype=jd)
    model = convert.t5_from_jax(params, tc, device="cpu")
    got = t_encode_padded(model, torch.as_tensor(ids).long(),
                          torch.as_tensor(lens), compute_dtype=td)
    assert np.all(got.float().numpy()[0, 11:] == 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    else:
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2
