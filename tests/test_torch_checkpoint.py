"""The port's checkpoint loading (univid_tpu_torch/core/checkpoint.py)
against univid_tpu's, on synthetic state dicts in the reference's naming.

No real weights exist here. Each state dict is built with numpy from a
seed, from the pinned-manifest generators at small configs, and written
to tmp_path in the published formats: sharded safetensors with an index,
torch .pth files, BAGEL's ema.safetensors, an HF SigLIP directory, and a
tokenizer built with the `tokenizers` package (nothing downloaded).
  * the port's safetensors reader equals `safetensors.safe_open` (F32, F16,
    BF16, metadata, unaligned bytes) and reads chip_smoke.py's writer;
  * each converter gives the module that `convert.*_from_jax` builds from
    the JAX converter's tree: the same names, every leaf bit for bit and of
    the JAX leaf's dtype;
  * the loaded models' forwards equal JAX's (1e-4, fp32 policy, as
    tests/test_torch_pipeline.py; 1e-5 for the SigLIP scorer as
    tests/test_torch_reflection.py), and a `--model tiny --checkpoint_dir`
    directory runs through the port's CLI to an mp4;
  * strictness: an index key absent from the shards, and a key no
    converter reads, raise.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univid_tpu.core import checkpoint as JC
from univid_tpu.core import manifest as JM
from univid_tpu.core.config import T5Config as JT5Config
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.config import WanVAEConfig as JVAEConfig
from univid_tpu.models.bagel.qwen2_mot import Qwen2MoTConfig as JQwenConfig
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.reflection.scorer import SiglipTextConfig as JTextConfig
from univid_tpu_torch import convert
from univid_tpu_torch.core import checkpoint as TC
from univid_tpu_torch.core import manifest as TM
from univid_tpu_torch.core.config import T5Config, WanDiTConfig, \
    WanVAEConfig
from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
from univid_tpu_torch.models.bagel.siglip import SiglipConfig
from univid_tpu_torch.reflection.scorer import SiglipTextConfig

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DIT = dict(model_type="t2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
           freq_dim=32, text_dim=48, num_heads=4, num_layers=2, text_len=16)
VAE = dict(dim=8, dec_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2),
           num_res_blocks=1, temporal_downsample=(False, True, True),
           spatial_patch=2)
T5 = dict(vocab_size=512, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
          num_layers=2, text_len=16)
LLM = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_layers=2, num_heads=2, num_kv_heads=1)
VIT = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
           patch_size=14, image_size=56)
TEXT = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, max_len=8, proj_dim=32)


# ---------------------------------------------------------------------------
# synthetic state dicts and files
# ---------------------------------------------------------------------------


def sd_from_manifest(man, seed=0):
    """{key: fp32 numpy} of the manifest's shapes: matrices N(0, 1/fan_in),
    biases N(0, 0.02^2), norm gains U(0.5, 1.5), modulations N(0, 1/d),
    everything else N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in sorted(man.items()):
        leaf = k.rsplit(".", 1)[-1]
        if "modulation" in k:
            x = rng.standard_normal(s) / np.sqrt(s[-1])
        elif leaf == "gamma" or (leaf == "weight" and len(s) == 1):
            x = rng.uniform(0.5, 1.5, s)
        elif leaf == "weight" and len(s) >= 2 and "embedding" not in k:
            x = rng.standard_normal(s) / np.sqrt(np.prod(s[1:]))
        elif k.endswith("token_embedding.weight") or "embed_tokens" in k:
            x = rng.standard_normal(s)
        else:
            x = rng.standard_normal(s) * 0.02
        out[k] = np.asarray(x, np.float32)
    return out


def to_torch(sd, dtype=None):
    return {k: torch.from_numpy(v.copy()) if dtype is None
            else torch.from_numpy(v.copy()).to(dtype) for k, v in sd.items()}


def write_sharded(path, sd, n_shards=3,
                  index="diffusion_pytorch_model.safetensors.index.json"):
    """sd (numpy) as n_shards safetensors files and their index."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    stem = index.split(".safetensors")[0]
    keys = sorted(sd)
    weight_map, shards = {}, [{} for _ in range(n_shards)]
    for i, k in enumerate(keys):
        fname = f"{stem}-{i % n_shards + 1:05d}-of-{n_shards:05d}" \
                ".safetensors"
        weight_map[k] = fname
        shards[i % n_shards][k] = sd[k]
    for i, shard in enumerate(shards):
        save_file(shard, os.path.join(
            path, f"{stem}-{i + 1:05d}-of-{n_shards:05d}.safetensors"))
    with open(os.path.join(path, index), "w") as f:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map},
                  f)
    return weight_map


def write_tokenizer(path, vocab_size):
    """A word-level tokenizer of `vocab_size` ids (<pad> = 0), saved so that
    transformers' AutoTokenizer loads it offline."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<pad>", "<unk>", "a", "the", "corgi", "runs", "through",
             "sunlit", "meadow", "cat", "dog", "video", "what", "moves"]
    words += [f"w{i}" for i in range(vocab_size - len(words))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "pad_token": "<pad>", "unk_token": "<unk>"}, f)


def assert_same_module(module, jtree, stacked=None, ref=None):
    """The port module's state dict == the JAX tree's, key for key, bit
    for bit and dtype for dtype; `ref`, convert.*_from_jax's module of the
    same tree, has the same names."""
    want = convert.jax_tree_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jtree), stacked=stacked)
    got = module.state_dict()
    assert set(got) == set(want)
    if ref is not None:
        assert set(ref.state_dict()) == set(got)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
        assert got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
    assert all(not p.requires_grad for p in module.parameters())


# ---------------------------------------------------------------------------
# raw loading
# ---------------------------------------------------------------------------


def _mixed_tensors():
    rng = np.random.default_rng(3)
    return {"a.f32": torch.from_numpy(
                rng.standard_normal((3, 5)).astype(np.float32)),
            "b.f16": torch.from_numpy(
                rng.standard_normal((7,)).astype(np.float16)),
            "c.bf16": torch.from_numpy(
                rng.standard_normal((2, 3, 5)).astype(np.float32)).to(
                torch.bfloat16),
            "d.i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "e.scalar": torch.tensor(1.5)}


def test_safetensors_reader_equals_safe_open(tmp_path):
    """F32, F16, BF16, I64 and a 0-d tensor, with __metadata__: the port's
    reader gives safe_open's tensors, dtypes and shapes, and its header
    reader the same (dtype, shape) pairs as JAX's."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    path = str(tmp_path / "m.safetensors")
    save_file(_mixed_tensors(), path, metadata={"format": "pt"})
    got = TC.load_state_dict(path)
    with safe_open(path, framework="pt") as f:
        want = {k: f.get_tensor(k) for k in f.keys()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert TC.read_safetensors_header(path) == \
        JC.read_safetensors_header(path)
    # the tensors are views of a private map: writing one leaves the file
    got["a.f32"].zero_()
    with safe_open(path, framework="pt") as f:
        assert torch.equal(f.get_tensor("a.f32"), want["a.f32"])


def test_reader_reads_the_chip_smoke_writer(tmp_path):
    """chip_smoke.py's own writer (the script needs no `safetensors`):
    safe_open and the port's reader read its file back equal, an
    unaligned bf16 / f32 layout included."""
    import chip_smoke
    from safetensors import safe_open

    tensors = dict(_mixed_tensors(),
                   odd=torch.ones(3, dtype=torch.bfloat16),
                   z=torch.randn(5, generator=torch.Generator()
                                 .manual_seed(0)))
    path = str(tmp_path / "w.safetensors")
    spec = {k: (t.dtype, tuple(t.shape), lambda t=t: t)
            for k, t in tensors.items()}
    n = chip_smoke.write_safetensors(path, spec, metadata={"by": "test"})
    assert n == os.path.getsize(path)
    got = TC.load_state_dict(path)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"by": "test"}
        for k, t in tensors.items():
            assert torch.equal(f.get_tensor(k), t)
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


def test_reader_rejects_a_truncated_file(tmp_path):
    from safetensors.torch import save_file

    path = tmp_path / "t.safetensors"
    save_file(_mixed_tensors(), str(path))
    data = path.read_bytes()
    path.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="bytes"):
        TC.load_state_dict(str(path))


def test_pth_loads_in_its_dtype_with_jax_values(tmp_path):
    """A bf16 .pth loads memory-mapped as bf16 (JAX widens it to fp32
    numpy: the same values), under 'state_dict' / 'model' wrappers too."""
    sd = to_torch(sd_from_manifest({"x.weight": (4, 6), "y": (3,)}),
                  torch.bfloat16)
    for i, obj in enumerate((sd, {"state_dict": sd}, {"model": sd})):
        path = str(tmp_path / f"m{i}.pth")
        torch.save(obj, path)
        got, want = TC.load_state_dict(path), JC.load_state_dict(path)
        assert set(got) == set(want) == set(sd)
        for k in sd:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].float().numpy(), want[k])


def test_sharded_index_loads_and_audits_as_jax(tmp_path):
    """The index's shards load (values equal JAX's); the header-only shapes
    and the audit equal JAX's, clean, then with a corrupted shard."""
    from safetensors.numpy import save_file

    cfg = JDiTConfig(**DIT)
    man = JM.wan_dit_manifest(cfg)
    sd = sd_from_manifest(man)
    weight_map = write_sharded(str(tmp_path), sd)
    got = TC.load_state_dict(str(tmp_path))
    want = JC.load_state_dict(str(tmp_path))
    assert set(got) == set(want) == set(man)
    for k in man:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    shapes = TC.collect_checkpoint_shapes(str(tmp_path))
    assert shapes == JC.collect_checkpoint_shapes(str(tmp_path))
    assert shapes == {k: tuple(v) for k, v in man.items()}
    diff = TC.audit_checkpoint(str(tmp_path), man)
    assert not any(diff.values()) and diff == JC.audit_checkpoint(
        str(tmp_path), man)
    k0 = sorted(man)[0]
    shard = {k: np.zeros(s, np.float32) for k, (_, s) in
             TC.read_safetensors_header(
                 str(tmp_path / weight_map[k0])).items()}
    shard[k0] = np.zeros((3, 3), np.float32)
    save_file(shard, str(tmp_path / weight_map[k0]))
    diff = TC.audit_checkpoint(str(tmp_path), man)
    assert diff == JC.audit_checkpoint(str(tmp_path), man)
    assert any(k0 in s for s in diff["shape_mismatch"])


def test_index_key_absent_from_shards_raises(tmp_path):
    cfg = JDiTConfig(**DIT)
    sd = sd_from_manifest(JM.wan_dit_manifest(cfg))
    write_sharded(str(tmp_path), sd, n_shards=2)
    idx = tmp_path / "diffusion_pytorch_model.safetensors.index.json"
    m = json.loads(idx.read_text())
    m["weight_map"]["ghost.weight"] = sorted(m["weight_map"].values())[0]
    idx.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="absent from the shards"):
        TC.load_state_dict(str(tmp_path))
    with pytest.raises(ValueError, match="absent from shard headers"):
        TC.collect_checkpoint_shapes(str(tmp_path))


def test_audited_strict_raises_on_an_unread_key():
    cfg = WanDiTConfig(**DIT)
    sd = to_torch(sd_from_manifest(TM.wan_dit_manifest(cfg)))
    module, leftover = TM.audited(
        sd, lambda s: TC.convert_wan_dit(s, cfg, device="cpu"))
    assert leftover == []
    sd["blocks.0.stray.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="not consumed"):
        TM.audited(sd, lambda s: TC.convert_wan_dit(s, cfg, device="cpu"))
    with pytest.warns(UserWarning, match="unconsumed"):
        _, leftover = TM.audited(
            sd, lambda s: TC.convert_wan_dit(s, cfg, device="cpu"),
            strict=False)
    assert leftover == ["blocks.0.stray.weight"]


def test_no_module_imports_safetensors_or_transformers():
    """Importing every module of the port loads neither package: weights
    load where neither is installed."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import univid_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('safetensors', 'transformers', 'tokenizers')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# converters against JAX's
# ---------------------------------------------------------------------------


def _case_dit():
    jcfg, tcfg = JDiTConfig(**DIT), WanDiTConfig(**DIT)
    sd = sd_from_manifest(JM.wan_dit_manifest(jcfg))
    return (lambda s: TC.convert_wan_dit(s, tcfg, device="cpu"),
            lambda: JC.convert_wan_dit(sd, jcfg),
            lambda t: convert.dit_from_jax(t, tcfg, device="cpu"),
            sd, "blocks")


def _case_vae():
    jcfg, tcfg = JVAEConfig(**VAE), WanVAEConfig(**VAE)
    sd = sd_from_manifest(JM.wan_vae_manifest(jcfg))
    return (lambda s: TC.convert_wan_vae(s, tcfg, device="cpu"),
            lambda: JC.convert_wan_vae(sd, jcfg),
            lambda t: convert.vae_from_jax(t, tcfg, device="cpu"),
            sd, None)


def _case_umt5():
    jcfg, tcfg = JT5Config(**T5), T5Config(**T5)
    sd = sd_from_manifest(JM.umt5_manifest(jcfg))
    return (lambda s: TC.convert_umt5(s, tcfg, device="cpu"),
            lambda: JC.convert_umt5(sd, jcfg),
            lambda t: convert.t5_from_jax(t, tcfg, device="cpu"),
            sd, None)


def _case_bagel_llm():
    jcfg, tcfg = JQwenConfig(**LLM), Qwen2MoTConfig(**LLM)
    sd = sd_from_manifest(JM.bagel_llm_manifest(jcfg))
    return (lambda s: TC.convert_bagel_llm(s, tcfg, device="cpu"),
            lambda: JC.convert_bagel_llm(sd, jcfg),
            None, sd, "layers")


def _case_siglip(conv_patch):
    def case():
        jcfg, tcfg = JSiglipConfig(**VIT), SiglipConfig(**VIT)
        sd = sd_from_manifest(JM.siglip_vision_manifest(
            jcfg, conv_patch=conv_patch))
        return (lambda s: TC.convert_siglip(s, tcfg, device="cpu"),
                lambda: JC.convert_siglip(sd, jcfg),
                lambda t: convert.siglip_from_jax(t, tcfg, device="cpu"),
                sd, "layers")
    return case


def _case_siglip2_text():
    tcfg = SiglipTextConfig(**TEXT, pooling="hf_last")
    jcfg = JTextConfig(**TEXT, pooling="hf_last")
    man = JM.siglip2_manifest(JSiglipConfig(**VIT), jcfg)
    sd = {k: v for k, v in sd_from_manifest(man).items()
          if k.startswith("text_model.")}
    return (lambda s: TC.convert_siglip2_text(s, tcfg, device="cpu"),
            lambda: JC.convert_siglip2_text(sd, jcfg),
            lambda t: convert.siglip_text_from_jax(t, tcfg, device="cpu"),
            sd, "layers")


def _case_map_head():
    man = JM.siglip2_manifest(JSiglipConfig(**VIT), JTextConfig(**TEXT))
    sd = {k: v for k, v in sd_from_manifest(man).items()
          if k.startswith("vision_model.head.")}
    return (lambda s: TC.convert_siglip_map_head(s, device="cpu"),
            lambda: JC.convert_siglip_map_head(sd),
            lambda t: convert.siglip_map_head_from_jax(t, device="cpu"),
            sd, None)


CONVERTERS = {"wan_dit": _case_dit, "wan_vae": _case_vae,
              "umt5": _case_umt5, "bagel_llm": _case_bagel_llm,
              "siglip_conv_patch": _case_siglip(True),
              "siglip_linear_patch": _case_siglip(False),
              "siglip2_text": _case_siglip2_text,
              "siglip_map_head": _case_map_head}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_equals_jax_leaf_for_leaf(name):
    """The port's converter on the torch state dict == the JAX converter's
    tree on the same values: names, bits and dtypes (bf16 where JAX
    rounds, fp32 where JAX keeps fp32); every source key consumed."""
    port_fn, jax_fn, from_jax, sd, stacked = CONVERTERS[name]()
    module, leftover = TM.audited(to_torch(sd), port_fn)
    assert leftover == []
    jtree = jax_fn()
    ref = None if from_jax is None else from_jax(
        jax.tree_util.tree_map(np.asarray, jtree))
    assert_same_module(module, jtree, stacked, ref)


def test_dit_converter_keeps_jax_leaf_dtypes():
    """The default DiT conversion is bf16 but for the time MLPs, the head
    and every modulation (fp32), as JAX's; a bf16 file gives the same
    module as its fp32 values."""
    cfg = WanDiTConfig(**DIT)
    sd = sd_from_manifest(TM.wan_dit_manifest(cfg))
    dit = TC.convert_wan_dit(to_torch(sd), cfg, device="cpu")
    f32 = {k for k, v in dit.state_dict().items() if v.dtype == torch.float32}
    assert f32 == {k for k in dit.state_dict() if k.startswith(
        ("time_embedding.", "time_projection.", "head."))
        or k.endswith(".modulation")}
    assert dit.blocks[1].modulation.shape == (6, 64)
    assert dit.patch_embed.w.shape == (64, 8 * 1 * 2 * 2)
    half = {k: v.astype(np.float32) for k, v in sd.items()}
    bf = TC.convert_wan_dit(to_torch(half, torch.bfloat16), cfg,
                            device="cpu")
    ref = TC.convert_wan_dit(
        {k: v.to(torch.bfloat16).float()
         for k, v in to_torch(half).items()}, cfg, device="cpu")
    for k, v in bf.state_dict().items():
        assert torch.equal(v, ref.state_dict()[k]), k


# ---------------------------------------------------------------------------
# loaded models against JAX's, and the loaders
# ---------------------------------------------------------------------------


def write_wan_dir(path, spec, seed=0):
    """A reference Wan checkpoint dir of `spec` (JAX's config): the DiT as
    3 shards with an index, Wan2.1_VAE.pth (fp32), the UMT5 .pth (bf16)
    and the google/umt5-xxl tokenizer."""
    write_sharded(path, sd_from_manifest(JM.wan_dit_manifest(spec.dit),
                                         seed))
    torch.save(to_torch(sd_from_manifest(JM.wan_vae_manifest(spec.vae),
                                         seed + 1)),
               os.path.join(path, "Wan2.1_VAE.pth"))
    torch.save(to_torch(sd_from_manifest(JM.umt5_manifest(spec.t5),
                                         seed + 2), torch.bfloat16),
               os.path.join(path, "models_t5_umt5-xxl-enc-bf16.pth"))
    write_tokenizer(os.path.join(path, "google", "umt5-xxl"),
                    spec.t5.vocab_size)


@pytest.fixture(scope="module")
def wan_dir(tmp_path_factory):
    from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
    path = str(tmp_path_factory.mktemp("wan_tiny"))
    write_wan_dir(path, JCONFIGS["tiny"])
    return path


def test_load_wan_checkpoint_equals_jax(wan_dir, tmp_path):
    """load_wan_checkpoint's DiT and VAE == JAX's trees leaf for leaf; a
    dir without a VAE raises FileNotFoundError, as JAX's."""
    from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
    from univid_tpu_torch.core.config import WAN_CONFIGS

    dit, vae = TC.load_wan_checkpoint(wan_dir, WAN_CONFIGS["tiny"],
                                      device="cpu")
    jdit, jvae = JC.load_wan_checkpoint(wan_dir, JCONFIGS["tiny"])
    assert_same_module(dit, jdit, "blocks")
    assert_same_module(vae, jvae)
    assert all(p.dtype == torch.float32 for p in vae.parameters())
    write_sharded(str(tmp_path), sd_from_manifest(
        JM.wan_dit_manifest(JCONFIGS["tiny"].dit)))
    with pytest.raises(FileNotFoundError, match="no VAE"):
        TC.load_wan_checkpoint(str(tmp_path), WAN_CONFIGS["tiny"],
                               device="cpu")


def test_wan_dir_pipeline_matches_jax(wan_dir):
    """The tiny directory through both packages' loaders: UMT5 contexts
    (the checkpoint's tokenizer, fp32 encoders) within 1e-5, then 4 UniPC
    steps of the bf16-leaf DiT under the fp32 policy and the fp32 VAE
    decode within 1e-4, as tests/test_torch_pipeline.py holds them."""
    from univid_tpu.core.config import TMAConfig as JTMA
    from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
    from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
    from univid_tpu.models.wan.vae_api import vae_decode as j_vae_decode
    from univid_tpu.pipelines.encoders import WanTextEncoder as JEncoder
    from univid_tpu.pipelines.ti2v import WanTI2VPipeline as JPipeline
    from univid_tpu_torch.core.config import TMAConfig, WAN_CONFIGS
    from univid_tpu_torch.core.dtypes import FP32_POLICY
    from univid_tpu_torch.models.wan.vae_api import vae_decode
    from univid_tpu_torch.pipelines.encoders import WanTextEncoder
    from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline, \
        padded_seq_len

    jspec, tspec = JCONFIGS["tiny"], WAN_CONFIGS["tiny"]
    prompts = ["a corgi runs through the sunlit meadow", "the cat"]
    jenc = JEncoder.from_checkpoint(wan_dir, jspec, dtype=jnp.float32)
    tenc = WanTextEncoder.from_checkpoint(wan_dir, tspec,
                                          dtype=torch.float32, device="cpu")
    jctx = np.array(jenc(prompts))
    tctx = tenc(prompts).numpy()
    np.testing.assert_allclose(tctx, jctx, rtol=1e-5, atol=1e-5)
    assert np.abs(tctx[0, 7:]).max() == 0   # rows past the 7 words

    jdit, jvae = JC.load_wan_checkpoint(wan_dir, jspec)
    dit, vae = TC.load_wan_checkpoint(wan_dir, tspec, device="cpu")
    size, frames, steps = (64, 64), 9, 4
    f, h, w, c = 3, 4, 4, 4
    seq_len = padded_seq_len(tspec, size, frames)
    noise = np.random.default_rng(5).standard_normal(
        (1, f, h, w, c)).astype(np.float32)
    tma = dict(enabled=True, weight_max=1.3, text_prefix_len=16)
    jpipe = JPipeline(jspec, jdit, jvae, policy=J_FP32, dispatch_steps=0)
    tma_key = tuple(sorted(dataclasses.asdict(JTMA(**tma)).items()))
    jx = jpipe._denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                           False, tma_key)(
        jdit, jnp.asarray(noise), jnp.asarray(jctx[:1]),
        jnp.asarray(jctx[1:]), jnp.zeros_like(jnp.asarray(noise)))
    jvideo = np.asarray(j_vae_decode(jvae, jspec.vae, jx))
    tpipe = WanTI2VPipeline(tspec, dit, vae, policy=FP32_POLICY)
    tx = tpipe.denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                          TMAConfig(**tma))(
        dit, torch.as_tensor(noise), torch.as_tensor(jctx[:1]),
        torch.as_tensor(jctx[1:]), torch.zeros(noise.shape))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(vae_decode(vae, tx).numpy(), jvideo,
                               rtol=1e-4, atol=1e-4)


def test_cli_checkpoint_dir_writes_mp4(wan_dir, tmp_path):
    """`--model tiny --checkpoint_dir DIR --no_bagel` on the CPU loads the
    shards, the VAE, UMT5 and its tokenizer: an mp4 of 9 frames, and the
    init_weights phase timed as with --mock_weights."""
    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.data.video_io import read_video_frames

    meta = inference.main([
        "--model", "tiny", "--checkpoint_dir", wan_dir, "--no_bagel",
        "--device", "cpu", "--video_size", "64x64", "--video_length", "9",
        "--steps", "2", "--output_dir", str(tmp_path)])[0]
    frames = read_video_frames(meta["video_path"])
    assert len(frames) == 9 and frames[0].shape == (64, 64, 3)
    assert {"init_weights", "text_encode", "denoise",
            "vae_decode"} <= set(meta["phase_times_s"])
    assert meta["context_path"] == "umt5"


@pytest.mark.parametrize("case", ["missing_dir", "empty_dir", "bagel_path"])
def test_cli_checkpoint_flags_fail_loudly(case, tmp_path):
    """--checkpoint_dir at a missing or empty dir, and --bagel_path at a
    dir without ema.safetensors, raise (as JAX's CLI does) instead of
    falling back to random weights."""
    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.core.config import WAN_CONFIGS

    if case == "bagel_path":
        args = inference.build_parser().parse_args([
            "--model", "tiny", "--device", "cpu", "--bagel_path",
            str(tmp_path)])
        with pytest.raises(FileNotFoundError):
            inference.build_fusion(args, None, WAN_CONFIGS["tiny"])
        return
    path = str(tmp_path / "nope") if case == "missing_dir" else str(tmp_path)
    with pytest.raises((FileNotFoundError, KeyError)):
        inference.main(["--model", "tiny", "--checkpoint_dir", path,
                        "--no_bagel", "--device", "cpu", "--output_dir",
                        str(tmp_path / "out")])


def test_text_encoder_from_checkpoint_needs_its_files(wan_dir, tmp_path,
                                                     monkeypatch):
    """No UMT5 file: FileNotFoundError; a UMT5 file but no tokenizer:
    load_tokenizer's RuntimeError (what the card's checkpoint run sees),
    raised before the UMT5 is converted."""
    from univid_tpu_torch.core.config import WAN_CONFIGS
    from univid_tpu_torch.pipelines.encoders import WanTextEncoder

    def never(*a, **kw):
        raise AssertionError("the UMT5 was converted before the tokenizer")

    monkeypatch.setattr(TC, "convert_umt5", never)
    spec = WAN_CONFIGS["tiny"]
    with pytest.raises(FileNotFoundError, match="no UMT5"):
        WanTextEncoder.from_checkpoint(str(tmp_path), spec, device="cpu")
    os.link(os.path.join(wan_dir, "models_t5_umt5-xxl-enc-bf16.pth"),
            str(tmp_path / "umt5.pth"))
    with pytest.raises(RuntimeError, match="unavailable offline"):
        WanTextEncoder.from_checkpoint(str(tmp_path), spec, device="cpu")


def _tiny_bagel_configs(monkeypatch):
    """load_bagel_checkpoint builds BAGEL-7B-MoT's configs; both packages'
    are patched to small ones here (a tiny LLM, a 2-layer tower)."""
    import functools

    from univid_tpu.models.bagel import bagel as jb
    from univid_tpu.models.bagel import qwen2_mot as jq
    from univid_tpu.models.bagel import siglip as js
    from univid_tpu_torch.models.bagel import bagel as tb
    from univid_tpu_torch.models.bagel import qwen2_mot as tq
    from univid_tpu_torch.models.bagel import siglip as ts

    vit = dict(VIT, image_size=980)   # BAGEL's 70-per-side position grid
    for mod, cls in ((jq, jq.Qwen2MoTConfig), (tq, tq.Qwen2MoTConfig)):
        monkeypatch.setattr(mod, "Qwen2MoTConfig",
                            functools.partial(cls, **LLM))
    for mod, cls in ((js, js.SiglipConfig), (ts, ts.SiglipConfig)):
        monkeypatch.setattr(mod, "SiglipConfig", functools.partial(cls, **vit))
    for mod, cls in ((jb, jb.BagelConfig), (tb, tb.BagelConfig)):
        monkeypatch.setattr(mod, "BagelConfig", functools.partial(
            cls, vit_hidden_size=VIT["hidden_size"]))
    return JQwenConfig(**LLM), JSiglipConfig(**vit)


def test_load_bagel_checkpoint_consumes_every_key(monkeypatch, tmp_path):
    """A small ema.safetensors of bagel_manifest's keys + a tokenizer: the
    port's Bagel and SigLIP == JAX's trees leaf for leaf (time_embedder
    and llm2vae fp32, the rest bf16); a stray key raises."""
    from safetensors.numpy import save_file

    llm, vit = _tiny_bagel_configs(monkeypatch)
    sd = sd_from_manifest(JM.bagel_manifest(llm, vit))
    save_file(sd, str(tmp_path / "ema.safetensors"))
    write_tokenizer(str(tmp_path), 128)
    bagel, cfg, scfg, sig, tok = TC.load_bagel_checkpoint(
        str(tmp_path), device="cpu")
    jp, _, _, jsig, _ = JC.load_bagel_checkpoint(str(tmp_path))
    assert_same_module(bagel, jp, "llm.layers")
    assert_same_module(sig, jsig, "layers")
    assert bagel.llm2vae.w.dtype == torch.float32
    assert bagel.vae2llm.w.dtype == torch.bfloat16
    assert cfg.llm.hidden_size == 32 and scfg.hidden_size == 32
    assert tok.encode("the cat") == [3, 9]
    save_file(dict(sd, stray=np.zeros(2, np.float32)),
              str(tmp_path / "ema.safetensors"))
    with pytest.raises(ValueError, match="not consumed"):
        TC.load_bagel_checkpoint(str(tmp_path), device="cpu")


def test_qa_cli_model_path_loads_ae_safetensors(monkeypatch, tmp_path):
    """--model_path at a dir with ema.safetensors and ae.safetensors: the
    QA CLI hands the FLUX image VAE (load_flux_ae_checkpoint) to the
    inferencer, as the JAX CLI does; without ae.safetensors, none."""
    import functools

    from safetensors.numpy import save_file

    from univid_tpu_torch.cli import eval_understanding as cli
    from univid_tpu_torch.models.bagel import autoencoder as tae

    llm, vit = _tiny_bagel_configs(monkeypatch)
    save_file(sd_from_manifest(JM.bagel_manifest(llm, vit)),
              str(tmp_path / "ema.safetensors"))
    write_tokenizer(str(tmp_path), 128)
    base = ["--video_dir", str(tmp_path), "--gt_file", "x", "--output_dir",
            str(tmp_path), "--output_name", "b", "--id_from", "1",
            "--id_to", "1", "--device", "cpu", "--model_path",
            str(tmp_path)]
    inf, _ = cli.load_models(cli.build_parser().parse_args(base))
    assert inf.vae is None and inf.vae_cfg is None
    small = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1)
    monkeypatch.setattr(tae, "ImageVAEConfig", functools.partial(
        tae.ImageVAEConfig, **small))
    ae = sd_from_manifest(TM.flux_ae_manifest(tae.ImageVAEConfig()), seed=1)
    save_file(ae, str(tmp_path / "ae.safetensors"))
    inf, _ = cli.load_models(cli.build_parser().parse_args(base))
    assert inf.vae_cfg == tae.ImageVAEConfig()
    np.testing.assert_array_equal(
        inf.vae.decoder.conv_out.w.numpy(), ae["decoder.conv_out.weight"])
    assert inf.vae.encoder.conv_in.w.dtype == torch.float32


def test_load_bagel_checkpoint_for_fusion_places_embed_tokens_only(
        monkeypatch, tmp_path):
    """llm_layers=False (what --bagel_path's fusion extractor loads): the
    LLM keeps embed_tokens only, every other leaf == JAX's; the LLM's
    other keys are still consumed and shape-checked, so a stray key or a
    layer of the wrong shape raises; build_fusion asks for this form."""
    from safetensors.numpy import save_file

    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.core.config import WAN_CONFIGS

    llm, vit = _tiny_bagel_configs(monkeypatch)
    sd = sd_from_manifest(JM.bagel_manifest(llm, vit))
    ema = str(tmp_path / "ema.safetensors")
    save_file(sd, ema)
    write_tokenizer(str(tmp_path), 128)
    bagel, cfg, scfg, sig, tok = TC.load_bagel_checkpoint(
        str(tmp_path), device="cpu", llm_layers=False)
    jp, _, _, jsig, _ = JC.load_bagel_checkpoint(str(tmp_path))
    assert_same_module(bagel, dict(jp, llm={
        "embed_tokens": jp["llm"]["embed_tokens"]}))
    assert_same_module(sig, jsig, "layers")
    assert [k for k in bagel.state_dict() if k.startswith("llm.")] == \
        ["llm.embed_tokens"]
    save_file(dict(sd, stray=np.zeros(2, np.float32)), ema)
    with pytest.raises(ValueError, match="not consumed"):
        TC.load_bagel_checkpoint(str(tmp_path), device="cpu",
                                 llm_layers=False)
    key = "language_model.model.layers.1.mlp.down_proj.weight"
    save_file(dict(sd, **{key: sd[key][:, :-1].copy()}), ema)
    with pytest.raises(RuntimeError, match="size mismatch"):
        TC.load_bagel_checkpoint(str(tmp_path), device="cpu",
                                 llm_layers=False)

    seen = {}

    def spy(path, **kw):
        seen.update(kw)
        raise FileNotFoundError(path)

    monkeypatch.setattr(TC, "load_bagel_checkpoint", spy)
    args = inference.build_parser().parse_args([
        "--model", "tiny", "--device", "cpu", "--bagel_path",
        str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        inference.build_fusion(args, None, WAN_CONFIGS["tiny"])
    assert seen == {"device": torch.device("cpu"), "llm_layers": False}


def _write_siglip_dir(path, vision, text, seed=7):
    from safetensors.numpy import save_file

    sd = sd_from_manifest(JM.siglip2_manifest(vision, text), seed)
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "siglip",
                   "vision_config": {"num_attention_heads": 1},
                   "text_config": {"num_attention_heads": 1}}, f)
    return sd


def test_siglip2_checkpoint_and_scorer_match_jax(tmp_path):
    """load_siglip2_checkpoint reads every key a SigLIP dir holds but the
    logit scalars' bias (as JAX's), its parts == JAX's leaf for leaf, head
    counts from config.json; Siglip2Scorer.from_checkpoint's emb_imgs,
    emb_text and rank_frames == JAX's to 1e-5 (head dim 64)."""
    from univid_tpu.reflection.scorer import Siglip2Scorer as JScorer
    from univid_tpu.utils.tokenizers import HashTokenizer as JHash
    from univid_tpu_torch.reflection.scorer import Siglip2Scorer
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    vision = JSiglipConfig(hidden_size=64, intermediate_size=128,
                           num_layers=2, num_heads=1, patch_size=16,
                           image_size=64)
    text = JTextConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=1, max_len=16, proj_dim=64)
    sd = _write_siglip_dir(str(tmp_path), vision, text)
    seen = []
    real = TC.load_state_dict

    def recording(path):
        seen.append(TM.RecordingDict(real(path)))
        return seen[-1]

    import unittest.mock as um
    with um.patch.object(TC, "load_state_dict", recording):
        parts = TC.load_siglip2_checkpoint(str(tmp_path), device="cpu")
    (rec,) = seen
    assert sorted(set(sd) - rec.consumed) == ["logit_bias"]
    jparts = JC.load_siglip2_checkpoint(str(tmp_path))
    assert parts["vision_cfg"].num_heads == 1 and parts["text_cfg"] == \
        SiglipTextConfig(**dataclasses.asdict(jparts["text_cfg"]))
    assert_same_module(parts["vision"], jparts["vision"], "layers")
    assert_same_module(parts["map_head"], jparts["map_head"])
    assert_same_module(parts["text"], jparts["text"], "layers")
    assert parts["logit_scale"] == jparts["logit_scale"]

    t = Siglip2Scorer.from_checkpoint(str(tmp_path), HashTokenizer(256, reserved=16),
                                      device="cpu")
    j = JScorer.from_checkpoint(str(tmp_path), JHash(256, reserved=16))
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
              for _ in range(4)]
    np.testing.assert_allclose(t.emb_imgs(frames, bs=3),
                               j.emb_imgs(frames, bs=3), atol=1e-5)
    q = "a dog runs"
    np.testing.assert_allclose(t.emb_text(q), j.emb_text(q), atol=1e-5)
    assert t.rank_frames(frames, q, 3)[0] == j.rank_frames(frames, q, 3)[0]


def test_umt5_and_siglip_forwards_match_jax():
    """The converted UMT5 (encode_padded) and SigLIP tower
    (siglip_forward) in fp32 == JAX's on the same state dict, 1e-4."""
    from univid_tpu.models.bagel.siglip import siglip_forward as j_sig
    from univid_tpu.models.wan.t5 import encode_padded as j_enc
    from univid_tpu_torch.models.bagel.siglip import siglip_forward
    from univid_tpu_torch.models.wan.t5 import encode_padded

    jcfg, tcfg = JT5Config(**T5), T5Config(**T5)
    sd = sd_from_manifest(JM.umt5_manifest(jcfg))
    ids = np.random.default_rng(1).integers(1, 512, (2, 16))
    lens = np.array([5, 16])
    want = j_enc(JC.convert_umt5(sd, jcfg, jnp.float32), jcfg,
                 jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32),
                 compute_dtype=jnp.float32)
    got = encode_padded(
        TC.convert_umt5(to_torch(sd), tcfg, torch.float32, device="cpu"),
        torch.as_tensor(ids), torch.as_tensor(lens),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    jv, tv = JSiglipConfig(**VIT), SiglipConfig(**VIT)
    sd = sd_from_manifest(JM.siglip_vision_manifest(jv, conv_patch=False))
    rng = np.random.default_rng(2)
    patches = rng.standard_normal((16, jv.patch_dim)).astype(np.float32)
    pos = np.arange(16)
    want = j_sig(JC.convert_siglip(sd, jv, jnp.float32), jv,
                 jnp.asarray(patches), jnp.asarray(pos),
                 compute_dtype=jnp.float32)
    got = siglip_forward(
        TC.convert_siglip(to_torch(sd), tv, torch.float32, device="cpu"),
        tv, torch.as_tensor(patches), torch.as_tensor(pos),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("file", ["dit", "vae", "umt5", "flux_ae"])
def test_chip_smoke_layout_rules_match_the_converters(file):
    """chip_smoke.py transcribes each converter's layout and dtype rule to
    hold the card's full-width load bit for bit; at the tiny config the
    transcription gives every parameter of the port converter's module,
    with its bits and dtype."""
    import chip_smoke as cs
    from univid_tpu_torch.core.config import WAN_CONFIGS

    from univid_tpu_torch.models.bagel.autoencoder import ImageVAEConfig

    spec = WAN_CONFIGS["tiny"]
    ae = ImageVAEConfig(ch=16, ch_mult=(1, 2, 2), num_res_blocks=1)
    man, convert_fn, rule = {
        "dit": (TM.wan_dit_manifest(spec.dit),
                lambda s: TC.convert_wan_dit(s, spec.dit, device="cpu"),
                lambda k, x: cs.dit_leaf(k, x, spec.dit.dim)),
        "vae": (TM.wan_vae_manifest(spec.vae),
                lambda s: TC.convert_wan_vae(s, spec.vae, device="cpu"),
                lambda k, x: cs.vae_leaf(k, x, spec.vae.num_res_blocks)),
        "umt5": (TM.umt5_manifest(spec.t5),
                 lambda s: TC.convert_umt5(s, spec.t5, device="cpu"),
                 cs.umt5_leaf),
        "flux_ae": (TM.flux_ae_manifest(ae),
                    lambda s: TC.convert_flux_ae(s, ae, device="cpu"),
                    cs.flux_ae_leaf)}[file]
    sd = to_torch(sd_from_manifest(man))
    params = dict(convert_fn(sd).named_parameters())
    seen = set()
    for k, x in sd.items():
        name, want, dtype = rule(k, x)
        assert params[name].dtype == dtype, (k, name)
        assert torch.equal(params[name], want.to(dtype)), (k, name)
        seen.add(name)
    assert seen == set(params)


def test_load_tokenizer_refuses_a_dir_without_tokenizer_files(tmp_path,
                                                              monkeypatch):
    """A checkpoint dir with a config.json and no tokenizer file raises
    load_tokenizer's RuntimeError even where AutoTokenizer would build an
    empty tokenizer from the config alone (transformers 5 does: every word
    its unknown token); a dir with tokenizer.json loads."""
    import transformers

    from univid_tpu_torch.utils.tokenizers import load_tokenizer

    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "siglip2"}))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **k: object()))
    with pytest.raises(RuntimeError, match="no tokenizer file"):
        load_tokenizer(str(tmp_path))
    monkeypatch.undo()
    write_tokenizer(str(tmp_path), 32)
    assert load_tokenizer(str(tmp_path), seq_len=4) \
        .batch_encode_padded(["the cat"]) == ([[3, 9, 0, 0]], [2])
