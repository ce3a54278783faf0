"""The port's manifests (univid_tpu_torch/core/manifest.py) against
univid_tpu's and against the pinned manifests/*.json.

  * the port's generators regenerate the pinned real-scale manifests of
    the models the port has exactly (as tests/test_manifest.py does for
    the JAX generators), and equal the JAX generators at small configs;
  * the port's full-width modules, built on the meta device, hold exactly
    each manifest's parameter count (the converters consume every key:
    tests/test_torch_checkpoint.py);
  * the audit reports missing, unexpected and mis-shaped keys, and a
    membership probe of RecordingDict is not a read.
"""

import math
import os

import numpy as np
import pytest
import torch

from univid_tpu.core import manifest as JM
from univid_tpu.core.config import T5Config as JT5Config
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.config import WanVAEConfig as JVAEConfig
from univid_tpu.models.bagel.qwen2_mot import Qwen2MoTConfig as JQwenConfig
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.reflection import naflex as jnaflex
from univid_tpu.reflection.scorer import SiglipTextConfig as JTextConfig
from univid_tpu_torch.core import manifest as TM
from univid_tpu_torch.core.config import T5Config, WAN_CONFIGS
from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
from univid_tpu_torch.models.bagel.siglip import SiglipConfig
from univid_tpu_torch.reflection import naflex as tnaflex
from univid_tpu_torch.reflection.scorer import SiglipTextConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SO400M_V = dict(hidden_size=1152, intermediate_size=4304, num_layers=27,
                num_heads=16, patch_size=14, image_size=378)
SO400M_T = dict(vocab_size=256000, hidden_size=1152, intermediate_size=4304,
                num_layers=27, num_heads=16, max_len=64, proj_dim=1152)

PINNED = {
    "wan_ti2v-5B_dit": lambda: TM.wan_dit_manifest(
        WAN_CONFIGS["ti2v-5B"].dit),
    "wan_t2v-1.3B_dit": lambda: TM.wan_dit_manifest(
        WAN_CONFIGS["t2v-1.3B"].dit),
    "wan_ti2v-5B_vae": lambda: TM.wan_vae_manifest(
        WAN_CONFIGS["ti2v-5B"].vae),
    "wan_t2v-1.3B_vae": lambda: TM.wan_vae_manifest(
        WAN_CONFIGS["t2v-1.3B"].vae),
    "umt5_xxl": lambda: TM.umt5_manifest(T5Config()),
    "bagel_7b_mot_ema": lambda: TM.bagel_manifest(Qwen2MoTConfig(),
                                                  SiglipConfig()),
    "siglip2_so400m": lambda: TM.siglip2_manifest(
        SiglipConfig(**SO400M_V), SiglipTextConfig(**SO400M_T)),
    "siglip2_naflex": lambda: TM.siglip2_naflex_manifest(
        tnaflex.NaflexVisionConfig(), tnaflex.NaflexTextConfig()),
}


@pytest.mark.parametrize("name", list(PINNED))
def test_pinned_manifest_regenerates(name):
    pinned = TM.load_manifest(os.path.join(REPO, "manifests",
                                           f"{name}.json"))
    assert pinned == {k: tuple(v) for k, v in PINNED[name]().items()}


def _numel(man, skip=()):
    return sum(math.prod(s) for k, s in man.items() if k not in skip)


def _meta_numel(*modules):
    return sum(p.numel() for m in modules for p in m.parameters())


def _module_case(name):
    """(manifest, full-width modules on the meta device, keys no module
    holds)."""
    from univid_tpu_torch.models.bagel.bagel import Bagel, BagelConfig
    from univid_tpu_torch.models.bagel.siglip import Siglip
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.models.wan.t5 import UMT5Encoder
    from univid_tpu_torch.models.wan.vae_api import WanVAE
    from univid_tpu_torch.reflection.scorer import SiglipMapHead, SiglipText

    man = PINNED[name]()
    meta = dict(device="meta")
    if name.endswith("_dit"):
        spec = WAN_CONFIGS[name.split("_")[1]]
        return man, [WanDiT(spec.dit, **meta)], ()
    if name.endswith("_vae"):
        spec = WAN_CONFIGS[name.split("_")[1]]
        return man, [WanVAE(spec.vae, **meta)], ()
    if name == "umt5_xxl":
        return man, [UMT5Encoder(T5Config(), **meta)], ()
    if name == "bagel_7b_mot_ema":
        return man, [Bagel(BagelConfig(), **meta),
                     Siglip(SiglipConfig(), **meta)], ()
    scalars = ("logit_scale", "logit_bias")
    if name == "siglip2_so400m":
        t = SiglipTextConfig(**SO400M_T, pooling="hf_last")
        return man, [Siglip(SiglipConfig(**SO400M_V), **meta),
                     SiglipMapHead(1152, 4304, **meta),
                     SiglipText(t, proj_bias=True, **meta)], scalars
    return man, [tnaflex.NaflexVision(tnaflex.NaflexVisionConfig(), **meta),
                 tnaflex.NaflexText(tnaflex.NaflexTextConfig(), **meta)], \
        scalars


@pytest.mark.parametrize("name", list(PINNED))
def test_full_width_modules_hold_the_manifest(name):
    """The modules a loader fills, at full width on the meta device, have
    exactly the manifest's parameter count (the logit scalars aside)."""
    man, modules, skip = _module_case(name)
    assert _meta_numel(*modules) == _numel(man, skip)


@pytest.mark.parametrize("model,count", [("t2v-A14B", 14_288_491_584),
                                         ("i2v-A14B", 14_288_901_184)])
def test_a14b_expert_holds_the_jax_manifest(model, count):
    """One A14B expert, built on the meta device at full width, holds
    exactly the parameters of JAX's wan_dit_manifest of its config (the
    i2v patch_embed widened to in_dim 36)."""
    from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
    from univid_tpu_torch.models.wan.dit import WanDiT

    man = JM.wan_dit_manifest(JCONFIGS[model].dit)
    assert _numel(man) == count
    assert _meta_numel(WanDiT(WAN_CONFIGS[model].dit, device="meta")) == count
    assert TM.wan_dit_manifest(WAN_CONFIGS[model].dit) == man


GENERATORS = {
    "wan_dit": (lambda m: m.wan_dit_manifest(
        (JDiTConfig if m is JM else WAN_CONFIGS["tiny"].dit.__class__)(
            model_type="t2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
            freq_dim=32, text_dim=48, num_heads=4, num_layers=3,
            text_len=16, cross_attn_norm=False))),
    "wan_vae": (lambda m: m.wan_vae_manifest(
        (JVAEConfig if m is JM else WAN_CONFIGS["tiny"].vae.__class__)(
            dim=8, dec_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2),
            num_res_blocks=1, temporal_downsample=(False, True, True),
            spatial_patch=2))),
    "umt5": (lambda m: m.umt5_manifest(
        (JT5Config if m is JM else T5Config)(
            vocab_size=512, dim=64, dim_attn=32, dim_ffn=128, num_heads=4,
            num_layers=2))),
    "bagel": (lambda m: m.bagel_manifest(
        (JQwenConfig if m is JM else Qwen2MoTConfig)(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, num_kv_heads=1),
        (JSiglipConfig if m is JM else SiglipConfig)(
            hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2))),
    "siglip2": (lambda m: m.siglip2_manifest(
        (JSiglipConfig if m is JM else SiglipConfig)(
            hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2, patch_size=16, image_size=64),
        (JTextConfig if m is JM else SiglipTextConfig)(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=1, num_heads=2, max_len=8, proj_dim=16))),
    "siglip2_naflex": (lambda m: m.siglip2_naflex_manifest(
        (jnaflex if m is JM else tnaflex).NaflexVisionConfig(
            hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2, patch_size=4, num_patches=16),
        (jnaflex if m is JM else tnaflex).NaflexTextConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, max_len=8, proj_dim=32))),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_equals_jax(name):
    assert GENERATORS[name](TM) == GENERATORS[name](JM)


def test_audit_keys_reports_diffs(tmp_path):
    man = {"a.weight": (4, 2), "b.weight": (3,)}
    sd = {"a.weight": torch.zeros(4, 2), "c.weight": torch.zeros(1)}
    diff = TM.audit_keys(sd, man)
    assert diff == JM.audit_keys({k: v.numpy() for k, v in sd.items()}, man)
    assert diff["missing"] == ["b.weight"]
    assert diff["unexpected"] == ["c.weight"]
    sd["b.weight"] = torch.zeros(5)
    assert TM.audit_keys(sd, man)["shape_mismatch"] == \
        ["b.weight: (5,) vs (3,)"]
    with pytest.raises(ValueError, match="does not match"):
        TM.assert_checkpoint_matches(sd, man, "tiny")
    TM.assert_checkpoint_matches({k: torch.zeros(s) for k, s in
                                  man.items()}, man)
    path = str(tmp_path / "m.json")
    TM.save_manifest(path, man)
    assert TM.load_manifest(path) == man == JM.load_manifest(path)


def test_recording_dict_counts_reads_not_probes():
    rec = TM.RecordingDict({"a": 1, "b": 2})
    assert "a" in rec and "z" not in rec and len(rec) == 2
    assert rec["b"] == 2
    assert rec.consumed == {"b"} and sorted(rec) == ["a", "b"]
    params, leftover = TM.audited({"a": np.ones(2), "skip.x": 1,
                                   "ignored": 0},
                                  lambda s: s["a"] * 2, ignore=("skip.",
                                                                "ignored"))
    assert leftover == [] and params.tolist() == [2.0, 2.0]
