"""The port's fusion slice against univid_tpu's: the ViT resize, the SigLIP
tower, the BAGEL semantic extractor, the FusionPipeline and the projector
checkpoint loader.

Weights come from the JAX init functions (numpy leaves) and reach the port
through univid_tpu_torch.convert; images, tokens and noise are numpy arrays
from a seed. Tolerances are stated per test: fp32 paths agree to summation
order (1e-5 on resampled pixels and extractor rows, 1e-4 on whole towers
and latents after 2 solver steps); bf16 towers to a relative L2 of 2e-2
(each GEMM rounds to bf16 at the same points, accumulated in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import np_params
from univid_tpu.core.config import FusionConfig as JFusionConfig
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.models.bagel.bagel import BagelConfig as JBagelConfig
from univid_tpu.models.bagel.bagel import init_bagel as j_init_bagel
from univid_tpu.models.bagel.qwen2_mot import Qwen2MoTConfig as JQwenConfig
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.models.bagel.siglip import init_siglip as j_init_siglip
from univid_tpu.models.bagel.siglip import siglip_forward as j_siglip
from univid_tpu.models.bagel.siglip import vit_aligned_resize as j_resize
from univid_tpu.models.fusion.extractor import \
    BagelSemanticExtractor as JExtractor
from univid_tpu.models.fusion.projector import init_context_projector
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.vae_api import init_wan_vae
from univid_tpu.pipelines.fusion import FusionPipeline as JFusion
from univid_tpu.pipelines.ti2v import WanTI2VPipeline as JPipeline
from univid_tpu.utils.tokenizers import HashTokenizer as JHashTokenizer
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import WAN_CONFIGS, FusionConfig
from univid_tpu_torch.core.config import TMAConfig
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.models.bagel.bagel import BagelConfig
from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
from univid_tpu_torch.models.bagel.siglip import (SiglipConfig,
                                                  siglip_forward,
                                                  vit_aligned_resize)
from univid_tpu_torch.models.fusion.extractor import BagelSemanticExtractor
from univid_tpu_torch.pipelines.fusion import FusionPipeline
from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline
from univid_tpu_torch.utils.tokenizers import HashTokenizer

torch.set_num_threads(2)

# the JAX CLI's mock BAGEL (univid_tpu/cli/inference.py:283-291)
LLM = dict(vocab_size=4096, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2)
BAGEL = dict(vit_hidden_size=32, vit_patch_size=14, start_of_image=4090,
             end_of_image=4091, bos_token_id=4092, eos_token_id=4093)
SIGLIP = dict(hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=2, patch_size=14, image_size=224)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _image(hw, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (*hw, 3)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def bagel():
    """(JAX extractor, port extractor, JAX trees, configs) sharing weights."""
    jcfg = JBagelConfig(llm=JQwenConfig(**LLM), **BAGEL)
    jscfg = JSiglipConfig(**SIGLIP)
    params = _np_tree(j_init_bagel(jax.random.PRNGKey(10), jcfg))
    sig = _np_tree(j_init_siglip(jax.random.PRNGKey(11), jscfg))
    jex = JExtractor(params, jcfg, JHashTokenizer(4090), siglip_params=sig,
                     siglip_cfg=jscfg, target_len=256,
                     compute_dtype=jnp.float32)
    cfg = BagelConfig(llm=Qwen2MoTConfig(**LLM), **BAGEL)
    scfg = SiglipConfig(**SIGLIP)
    tex = BagelSemanticExtractor(
        convert.bagel_from_jax(params, cfg, device="cpu", llm_layers=False),
        cfg,
        HashTokenizer(4090),
        siglip=convert.siglip_from_jax(sig, scfg, device="cpu"),
        siglip_cfg=scfg, target_len=256, compute_dtype=torch.float32)
    return jex, tex, params, sig, scfg


def test_bagel_configs_match():
    for a, b in ((JBagelConfig(), BagelConfig()),
                 (JSiglipConfig(), SiglipConfig()),
                 (JQwenConfig(), Qwen2MoTConfig())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert BagelConfig().llm.head_dim == 128
    assert SiglipConfig().hidden_size // SiglipConfig().num_heads == 72


@pytest.mark.parametrize("hw,max_side", [
    ((704, 1280), 224),   # the CLI's 1280x704 image for the mock tower
    ((100, 180), 224),    # height down, width up
    ((50, 60), 224),      # both up
    ((224, 224), 224),    # identity: no resample
])
def test_vit_aligned_resize_matches_jax(hw, max_side):
    """jax.image.resize's antialiased bilinear resample, written out:
    1e-5 absolute on pixels in [-1, 1] (summation order only)."""
    img = _image(hw, 0)
    want = np.asarray(j_resize(jnp.asarray(img), 14, max_side))
    got = vit_aligned_resize(torch.as_tensor(img), 14, max_side).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if hw[0] == max_side:
        assert np.array_equal(got, img)


def test_vit_aligned_resize_full_size_is_exact():
    """At the full tower's 980 px the port's resample is within 1e-6 of a
    float64 evaluation of the same weights; JAX's own result is off that
    by up to 2e-5 on this machine (its CPU einsum), so the port is held to
    JAX at 3e-5 here."""
    from univid_tpu_torch.models.bagel.siglip import _resize_weights
    img = _image((704, 1280), 1)
    got = vit_aligned_resize(torch.as_tensor(img), 14, 980).numpy()
    assert got.shape == (532, 980, 3)
    wh = _resize_weights(704, 532, "cpu").double().numpy()
    ww = _resize_weights(1280, 980, "cpu").double().numpy()
    exact = np.einsum("ywc,wx->yxc", np.einsum(
        "hwc,hy->ywc", img.astype(np.float64), wh), ww)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    want = np.asarray(j_resize(jnp.asarray(img), 14, 980))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_siglip_forward_matches_jax(bagel, dtype):
    """A 9x16-patch image in the 256 bucket: pad patches carry segment -1,
    so pad queries attend to pad keys only; every row (pad rows too) is
    held: fp32 1e-4, bf16 relative L2 2e-2."""
    from univid_tpu.models.bagel.bagel import flattened_position_ids
    _, _, _, sig, scfg = bagel
    n, bucket = 9 * 16, 256
    rng = np.random.default_rng(3)
    patches = np.concatenate([rng.uniform(-1, 1, (n, scfg.patch_dim)),
                              np.zeros((bucket - n, scfg.patch_dim))]) \
        .astype(np.float32)
    pos = np.pad(flattened_position_ids(9, 16, 70), (0, bucket - n))
    segs = np.concatenate([np.zeros(n), np.full(bucket - n, -1)]) \
        .astype(np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    # jnp leaves: a JAX gather clamps the position ids past the 16x16
    # table, as in the extractor's jitted tower (numpy leaves would raise)
    jsig = jax.tree_util.tree_map(jnp.asarray, sig)
    want = np.asarray(j_siglip(jsig, JSiglipConfig(**SIGLIP),
                               jnp.asarray(patches), jnp.asarray(pos),
                               segment_ids=jnp.asarray(segs),
                               compute_dtype=jd), np.float32)
    model = convert.siglip_from_jax(sig, scfg, device="cpu")
    got = siglip_forward(model, scfg, torch.as_tensor(patches),
                         torch.as_tensor(pos), torch.as_tensor(segs),
                         compute_dtype=td).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("name,text,img_hw", [
    ("text-short", "a cat", None),
    # crosses the 16 -> 64 text bucket and pads inside the bucket
    ("text-bucket", " ".join(["word"] * 40), None),
    # text longer than target_len: truncation
    ("text-trunc", " ".join(["word"] * 300), None),
    ("img+text", "a cat on a mat", (100, 180)),
    # image tokens alone exceed target_len: image-only truncation
    ("bigimg", "hi", (500, 700)),
])
def test_extractor_matches_jax(bagel, name, text, img_hw):
    """[target_len, hidden] semantic tokens, fp32: 2e-5 absolute + 1e-5
    relative (tests/test_extractor.py's tolerance); rows past the tokens
    are exactly zero on both sides."""
    jex, tex = bagel[:2]
    image = None if img_hw is None else _image(img_hw, len(name))
    want = np.asarray(jex(text, None if image is None
                          else jnp.asarray(image)))
    got = tex(text, None if image is None
              else torch.as_tensor(image)).numpy()
    assert got.shape == want.shape == (256, 64)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert np.array_equal(got == 0, want == 0)


@pytest.fixture(scope="module")
def fusion_pair(bagel):
    """JAX and port FusionPipelines on the tiny Wan with the CLI's mock
    fusion config, same weights, fp32 policy."""
    jex, tex = bagel[:2]
    jspec, tspec = JCONFIGS["tiny"], WAN_CONFIGS["tiny"]
    dit_p = np_params(init_wan_dit, jspec.dit, 0, stacked=True)
    vae_p = np_params(init_wan_vae, jspec.vae, 1)
    kw = dict(bagel_hidden_dim=64, wan_text_dim=64, wan_text_length=16,
              bagel_sequence_length=16)
    proj = _np_tree(init_context_projector(jax.random.PRNGKey(12),
                                           JFusionConfig(**kw)))
    jwan = JPipeline(jspec, dit_p, vae_p, policy=J_FP32, dispatch_steps=0)
    twan = WanTI2VPipeline(
        tspec, convert.dit_from_jax(dit_p, tspec.dit, device="cpu"),
        convert.vae_from_jax(vae_p, tspec.vae, device="cpu"),
        policy=FP32_POLICY)
    tproj = convert.projector_from_jax(proj, FusionConfig(**kw),
                                       device="cpu")

    def make(alpha):
        return (JFusion(jwan, proj, JFusionConfig(fusion_alpha=alpha, **kw),
                        bagel_extractor=jex),
                FusionPipeline(twan, tproj,
                               FusionConfig(fusion_alpha=alpha, **kw),
                               bagel_extractor=tex))
    return make


@pytest.mark.parametrize("case", ["bagel", "t5", "zeros", "alpha0.5",
                                  "i2v"])
def test_fusion_pipeline_matches_jax(fusion_pair, case):
    """generate_video_with_bagel_context -> the final latent (decode off),
    2 UniPC steps on the tiny Wan, the same initial noise (JAX's draw from
    the seed, handed to the port), TMA over a 16-token prefix: fp32
    latents to 1e-4. 'i2v' runs the extractor on the prompt and a 64x64
    image, which also conditions the video; its first latent frame is the
    image's latent."""
    alpha = 0.5 if case == "alpha0.5" else 1.0
    jf, tf = fusion_pair(alpha)
    rng = np.random.default_rng(5)
    t5 = (rng.standard_normal((2, 16, 64)) * 0.5).astype(np.float32)
    tokens = rng.standard_normal((16, 64)).astype(np.float32)
    image = _image((64, 64), 6) if case == "i2v" else None
    null = case if case in ("t5", "zeros") else "bagel"
    gen = dict(size=(64, 64), frame_num=9, sampling_steps=2, seed=0,
               decode=False)
    tma = dict(enabled=True, weight_max=1.3, text_prefix_len=16)
    from univid_tpu.core.config import TMAConfig as JTMA
    src = dict(text="a red ball", image=image) if case == "i2v" \
        else dict(bagel_tokens=tokens)
    jsrc = dict(src, image=None if image is None else jnp.asarray(image)) \
        if case == "i2v" else dict(bagel_tokens=jnp.asarray(tokens))
    want = np.asarray(jf.generate_video_with_bagel_context(
        **jsrc, t5_context=jnp.asarray(t5[0]),
        t5_context_null=jnp.asarray(t5[1]), null_context=null,
        tma=JTMA(**tma), **gen))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), want.shape,
                                         jnp.float32))
    tsrc = dict(src, image=None if image is None
                else torch.as_tensor(image)) if case == "i2v" \
        else dict(bagel_tokens=torch.as_tensor(tokens))
    got = tf.generate_video_with_bagel_context(
        **tsrc, t5_context=torch.as_tensor(t5[0]),
        t5_context_null=torch.as_tensor(t5[1]), null_context=null,
        tma=TMAConfig(**tma), noise=torch.as_tensor(noise), **gen).numpy()
    assert got.shape == want.shape == (1, 3, 4, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if case == "i2v":
        from univid_tpu_torch.models.wan.vae_api import vae_encode
        z0 = vae_encode(tf.wan.vae, torch.as_tensor(image)[None, None])
        assert torch.equal(torch.as_tensor(got[:, :1]), z0)


def _reference_projector_sd(cfg, seed):
    """A reference ContextProjector state dict (torch layout, Sequential
    indices 0, 1, 4, 5) of cfg's widths, from a numpy seed."""
    rng = np.random.default_rng(seed)
    hidden = cfg.wan_text_dim * cfg.projector_hidden_mult
    shapes = {"0.weight": (hidden, cfg.bagel_hidden_dim), "0.bias": (hidden,),
              "1.weight": (hidden,), "1.bias": (hidden,),
              "4.weight": (cfg.wan_text_dim, hidden),
              "4.bias": (cfg.wan_text_dim,), "5.weight": (cfg.wan_text_dim,),
              "5.bias": (cfg.wan_text_dim,)}
    return {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


@pytest.mark.parametrize("layout", ["context_projector.bagel_to_t5_projector.",
                                    "projector.projection.", ""])
def test_load_projector_checkpoint_matches_jax(tmp_path, layout):
    """A synthetic training_state.pt in the reference layout (container and
    root prefixes, Sequential indices 0, 1, 4, 5) through both loaders:
    the same weights exactly (JAX [in, out] is the port's [out, in]
    transposed)."""
    from univid_tpu.core.checkpoint import load_projector_checkpoint as jload
    from univid_tpu_torch.core.checkpoint import load_projector_checkpoint
    kw = dict(bagel_hidden_dim=24, wan_text_dim=16, wan_text_length=8)
    sd = {layout + k: v for k, v in
          _reference_projector_sd(FusionConfig(**kw), 7).items()}
    path = str(tmp_path / "training_state.pt")
    torch.save(sd, path)
    want = jload(path, JFusionConfig(**kw))
    got = load_projector_checkpoint(path, FusionConfig(**kw), device="cpu")
    for mod in ("fc0", "ln0", "fc1", "ln1"):
        for leaf in ("w", "b"):
            w = np.asarray(want[mod][leaf])
            t = getattr(getattr(got, mod), leaf).detach().numpy()
            assert np.array_equal(t.T if t.ndim == 2 else t, w), (mod, leaf)
    if layout.startswith("context_projector."):
        # the reference trainer's file nests the projector's state dict
        cut = len("context_projector.")
        torch.save({"context_projector": {k[cut:]: v for k, v in sd.items()}},
                   path)
        nested = load_projector_checkpoint(path, FusionConfig(**kw),
                                           device="cpu")
        for name, p in got.named_parameters():
            assert torch.equal(nested.get_parameter(name), p), name


def test_load_projector_checkpoint_reads_port_train_state(tmp_path):
    """The projector that the port's trainer saves (train_state.npz, by
    directory or file) loads back bit for bit."""
    from univid_tpu_torch.core.checkpoint import load_projector_checkpoint
    from univid_tpu_torch.train import fusion_trainer as ft
    fusion = FusionConfig(bagel_hidden_dim=24, wan_text_dim=16,
                          wan_text_length=8, bagel_sequence_length=4)
    # with LoRA factors beside it in the file, as the trainer writes them
    state, _, _ = ft.init_fusion_train_state(
        torch.Generator().manual_seed(0), fusion,
        ft.FusionTrainConfig(train_lora=True),
        dit_cfg=WAN_CONFIGS["tiny"].dit, device="cpu")
    ft.save_train_state(str(tmp_path / "best"), state)
    for path in (tmp_path / "best", tmp_path / "best" / "train_state.npz"):
        got = load_projector_checkpoint(str(path), fusion, device="cpu")
        for name, p in state["trainable"]["projector"].named_parameters():
            assert torch.equal(got.get_parameter(name), p.detach()), name
