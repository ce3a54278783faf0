"""The port's FLUX image VAE, its checkpoint converter and ops/cfg.py
against univid_tpu's.

Weights come from the JAX init (through convert.image_vae_from_jax) or
from a synthetic FLUX-named state dict (numpy, from a seed); images are
numpy arrays from seeds. The VAE runs in fp32 on both sides: encode and
decode agree to 1e-4 rel. L2 (summation order). The converter is held
leaf for leaf: names, bits and dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univid_tpu.core import checkpoint as JC
from univid_tpu.core.manifest import RecordingDict as JRecordingDict
from univid_tpu.models.bagel import autoencoder as ja
from univid_tpu.ops import cfg as jcfg_ops
from univid_tpu_torch import convert
from univid_tpu_torch.core import checkpoint as TC
from univid_tpu_torch.core import manifest as TM
from univid_tpu_torch.models.bagel import autoencoder as ta
from univid_tpu_torch.ops import cfg as tcfg_ops

torch.set_num_threads(2)
SMALL = dict(ch=16, ch_mult=(1, 2, 2), num_res_blocks=1)
REL_L2 = 1e-4


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _models(cfg_kw, seed=0):
    jcfg, tcfg = ja.ImageVAEConfig(**cfg_kw), ta.ImageVAEConfig(**cfg_kw)
    jp = ja.init_image_vae(jax.random.PRNGKey(seed), jcfg)
    vae = convert.image_vae_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg, device="cpu")
    return jp, jcfg, vae, tcfg


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_kw,shape", [
    (SMALL, (2, 32, 48, 3)),
    ({}, (1, 32, 32, 3)),    # the full ImageVAEConfig()
], ids=["small", "full"])
def test_encode_and_decode_match_jax(cfg_kw, shape):
    """image_vae_encode (the scaled mean) and image_vae_decode == JAX at
    1e-4 rel. L2, fp32 on both sides; the decode of JAX's latent."""
    jp, jcfg, vae, tcfg = _models(cfg_kw)
    x = _image(shape, 1)
    zj = np.asarray(ja.image_vae_encode(jp, jcfg, jnp.asarray(x)))
    zt = ta.image_vae_encode(vae, tcfg, torch.as_tensor(x))
    ds = tcfg.downsample
    assert zt.shape == (shape[0], shape[1] // ds, shape[2] // ds,
                        tcfg.z_channels) and zt.dtype == torch.float32
    assert rel_l2(zt.numpy(), zj) < REL_L2
    yj = np.asarray(ja.image_vae_decode(jp, jcfg, jnp.asarray(zj)))
    yt = ta.image_vae_decode(vae, tcfg, torch.as_tensor(zj.copy()))
    assert yt.shape == shape
    assert rel_l2(yt.numpy(), yj) < REL_L2


def test_image_vae_from_jax_takes_every_leaf():
    """Every JAX leaf lands in the module, convs as [Cout, Cin, kh, kw]."""
    jp, _, vae, _ = _models(SMALL)
    leaves = jax.tree_util.tree_leaves(jp)
    assert sum(p.numel() for p in vae.parameters()) == sum(
        np.asarray(x).size for x in leaves)
    w = np.asarray(jp["encoder"]["down0"]["down"]["w"])   # HWIO
    np.testing.assert_array_equal(vae.encoder.down0.down.w.numpy(),
                                  w.transpose(3, 2, 0, 1))


def test_init_draws_as_jax_draws():
    """init_image_vae's tree has JAX's names and shapes; convs are drawn
    normal / sqrt(fan_in) with zero biases, norms ones and zeros."""
    jp = ja.init_image_vae(jax.random.PRNGKey(0), ja.ImageVAEConfig(**SMALL))
    vae = ta.init_image_vae(torch.Generator().manual_seed(0),
                            ta.ImageVAEConfig(**SMALL), device="cpu")
    want = {k: t[:, :, 0] if t.ndim == 5 else t for k, t in
            convert.jax_tree_to_state_dict(
                jax.tree_util.tree_map(np.asarray, jp)).items()}
    got = vae.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    w = got["decoder.up1.res0.conv1.w"]       # 3x3, 32 -> 32
    assert abs(float(w.std()) * np.sqrt(9 * 32) - 1.0) < 0.1
    assert not got["decoder.up1.res0.conv1.b"].any()
    assert torch.equal(got["encoder.norm_out.w"],
                       torch.ones_like(got["encoder.norm_out.w"]))


def test_vae_runs_with_tf32_off_and_restores_the_flags():
    """_exact_fp32 turns TF32 off inside and restores the caller's flags
    (cuBLAS and cuDNN), on an exception too."""
    mm = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with ta._exact_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(RuntimeError):
            with ta._exact_fp32():
                raise RuntimeError
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


def test_downsample_pad_is_right_and_bottom():
    """'RB' pads one row and one column after the image (FLUX's (0, 1, 0,
    1)) before the stride-2 conv, as JAX's conv2d does."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 6, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    want = ja.conv2d(jnp.asarray(x), {"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)},
                     stride=2, padding="RB")
    p = ta.unn.Node(w=torch.nn.Parameter(torch.as_tensor(
        w.transpose(3, 2, 0, 1).copy())), b=torch.nn.Parameter(
        torch.as_tensor(b)))
    got = ta.conv2d(torch.as_tensor(x), p, stride=2, padding="RB")
    assert got.shape == (1, 4, 3, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_group_norm_matches_jax():
    """fp32 statistics over (H, W, C / groups), affine after; 32 groups,
    or C groups when C < 32."""
    rng = np.random.default_rng(4)
    for c in (16, 64):
        x = (3.0 + rng.standard_normal((2, 5, 7, c))).astype(np.float32)
        w = rng.uniform(0.5, 1.5, c).astype(np.float32)
        b = rng.standard_normal(c).astype(np.float32)
        want = ja.group_norm(jnp.asarray(x), {"w": jnp.asarray(w),
                                              "b": jnp.asarray(b)})
        got = ta.group_norm(torch.as_tensor(x), ta.unn.Node(
            w=torch.nn.Parameter(torch.as_tensor(w)),
            b=torch.nn.Parameter(torch.as_tensor(b))))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the checkpoint converter
# ---------------------------------------------------------------------------


def _flux_sd(cfg, seed=0):
    """A synthetic FLUX-named AE state dict (numpy fp32) of the manifest's
    shapes: conv weights N(0, 1/fan_in), norm gains U(0.5, 1.5), biases
    N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in sorted(TM.flux_ae_manifest(cfg).items()):
        if k.endswith(".weight") and len(s) == 4:
            x = rng.standard_normal(s) / np.sqrt(np.prod(s[1:]))
        elif k.endswith(".weight"):
            x = rng.uniform(0.5, 1.5, s)
        else:
            x = rng.standard_normal(s) * 0.02
        out[k] = np.asarray(x, np.float32)
    return out


@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
def test_convert_flux_ae_equals_jax_leaf_for_leaf(src_dtype):
    """convert_flux_ae on the torch state dict == univid_tpu's
    convert_flux_ae on the same values (a bf16 file widened to fp32 as JAX
    widens it): every leaf's bits, fp32, convs [Cout, Cin, kh, kw]; every
    source key read, and the keys the JAX converter reads are exactly
    flux_ae_manifest's."""
    tcfg, jcfg = ta.ImageVAEConfig(**SMALL), ja.ImageVAEConfig(**SMALL)
    sd = _flux_sd(tcfg)
    src = {k: torch.from_numpy(v.copy()).to(getattr(torch, src_dtype))
           for k, v in sd.items()}
    vae, leftover = TM.audited(src, lambda s: TC.convert_flux_ae(
        s, tcfg, device="cpu"))
    assert leftover == []
    rec = JRecordingDict({k: v.float().numpy() for k, v in src.items()})
    jtree = JC.convert_flux_ae(rec, jcfg)
    assert rec.consumed == set(sd)
    want = {k: t[:, :, 0] if t.ndim == 5 else t for k, t in
            convert.jax_tree_to_state_dict(
                jax.tree_util.tree_map(np.asarray, jtree)).items()}
    got = vae.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == torch.float32, k
        assert torch.equal(got[k], w), k


def test_flux_ae_manifest_matches_the_module_at_full_size():
    """flux_ae_manifest(ImageVAEConfig()) names one source key per leaf
    of the full AE, with the leaf's element count (0.34 GB of fp32)."""
    cfg = ta.ImageVAEConfig()
    man = TM.flux_ae_manifest(cfg)
    vae = ta.ImageVAE(cfg, device="meta")
    assert len(man) == len(vae.state_dict())
    assert sum(int(np.prod(s)) for s in man.values()) == sum(
        p.numel() for p in vae.parameters())
    assert 0.33e9 < 4 * sum(p.numel() for p in vae.parameters()) < 0.34e9
    assert man["encoder.down.1.block.0.nin_shortcut.weight"] == \
        (256, 128, 1, 1)
    assert man["decoder.up.3.upsample.conv.weight"] == (512, 512, 3, 3)


def test_load_flux_ae_checkpoint_reads_ae_safetensors(tmp_path):
    """load_flux_ae_checkpoint on a dir with ae.safetensors (written by
    chip_smoke.py's writer) == the converter on the same tensors; an
    extra key raises, naming it."""
    import chip_smoke

    cfg = ta.ImageVAEConfig(**SMALL)
    sd = {k: torch.from_numpy(v) for k, v in _flux_sd(cfg, 1).items()}

    def write(tensors):
        chip_smoke.write_safetensors(
            str(tmp_path / "ae.safetensors"),
            {k: (t.dtype, tuple(t.shape), lambda t=t: t)
             for k, t in tensors.items()})

    write(sd)
    vae, got_cfg = TC.load_flux_ae_checkpoint(str(tmp_path), cfg,
                                              device="cpu")
    assert got_cfg == cfg
    assert torch.equal(vae.decoder.mid_attn.proj.w,
                       sd["decoder.mid.attn_1.proj_out.weight"])
    assert torch.equal(vae.encoder.down1.res0.shortcut.b,
                       sd["encoder.down.1.block.0.nin_shortcut.bias"])
    write(dict(sd, **{"encoder.extra.weight": torch.zeros(2)}))
    with pytest.raises(ValueError, match="encoder.extra.weight"):
        TC.load_flux_ae_checkpoint(str(tmp_path / "ae.safetensors"), cfg,
                                   device="cpu")


# ---------------------------------------------------------------------------
# ops/cfg.py
# ---------------------------------------------------------------------------


def _velocities(seed, shape=(2, 24, 16)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * s
            for s in (1.0, 1.3, 0.7)]


def test_classifier_free_guidance_matches_jax():
    c, u, _ = _velocities(0)
    want = jcfg_ops.classifier_free_guidance(jnp.asarray(c), jnp.asarray(u),
                                             5.0)
    got = tcfg_ops.classifier_free_guidance(torch.as_tensor(c),
                                            torch.as_tensor(u), 5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["global", "channel", "text_channel"])
@pytest.mark.parametrize("renorm_min", [0.0, 0.4])
def test_cfg_renorm_and_dual_cfg_match_jax(mode, renorm_min):
    """cfg_renorm (norms over every axis but the first, or over axis 1;
    the ratio capped at 1 and blended with renorm_min) and dual_cfg ==
    JAX at 1e-6."""
    c, t, i = _velocities(1)
    g = t + 4.0 * (c - t)
    want = jcfg_ops.cfg_renorm(jnp.asarray(g), jnp.asarray(c), renorm_min,
                               mode)
    got = tcfg_ops.cfg_renorm(torch.as_tensor(g), torch.as_tensor(c),
                              renorm_min, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    want = jcfg_ops.dual_cfg(jnp.asarray(c), jnp.asarray(t), jnp.asarray(i),
                             4.0, 1.5, mode, renorm_min)
    got = tcfg_ops.dual_cfg(torch.as_tensor(c), torch.as_tensor(t),
                            torch.as_tensor(i), 4.0, 1.5, mode, renorm_min)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_cfg_renorm_is_not_the_flow_loops_renorm():
    """ops/cfg.py's renorm (renorm_min + (1 - renorm_min) * min(1, .) over
    axis 1 for 'channel') and the flow loop's inline one (clip(|v| / (|v_|
    + 1e-8), renorm_min, 1) over the last axis) are different functions in
    both packages: ported each as it is, neither routed through the
    other."""
    c, _, _ = _velocities(2, shape=(1, 24, 16))
    g = 3.0 * c[:, ::-1].copy()
    ours = tcfg_ops.cfg_renorm(torch.as_tensor(g), torch.as_tensor(c), 0.3,
                               "channel").numpy()
    n_c = np.linalg.norm(c, axis=-1, keepdims=True)
    n_g = np.linalg.norm(g, axis=-1, keepdims=True)
    loop = g * np.clip(n_c / (n_g + 1e-8), 0.3, 1.0)
    assert rel_l2(ours, loop) > 0.05
    want = jcfg_ops.cfg_renorm(jnp.asarray(g), jnp.asarray(c), 0.3,
                               "channel")
    np.testing.assert_allclose(ours, np.asarray(want), rtol=1e-6, atol=1e-6)
