"""The port's t2v and i2v slices as a whole against univid_tpu's, and its
CLI.

The same numpy noise and context (and for i2v the same first-frame latent)
go through univid_tpu's WanTI2VPipeline._denoise_fn run (4 UniPC steps,
batch-2 CFG, TMA weights) and the port's WanTI2VPipeline.denoise_fn run,
under the fp32 policy; both latents are then decoded. fp32 throughout:
1e-4 relative covers the summation-order differences accumulated over 4
steps.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import np_params
from univid_tpu.core.config import TMAConfig as JTMA
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.vae_api import init_wan_vae
from univid_tpu.models.wan.vae_api import vae_decode as j_vae_decode
from univid_tpu.pipelines.ti2v import WanTI2VPipeline as JPipeline
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import TMAConfig, WAN_CONFIGS
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.models.wan.vae_api import vae_decode as t_vae_decode
from univid_tpu_torch.pipelines.ti2v import WanTI2VPipeline, padded_seq_len

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_t2v_slice_matches_jax():
    jspec, tspec = JCONFIGS["tiny"], WAN_CONFIGS["tiny"]
    dit_p = np_params(init_wan_dit, jspec.dit, 0, stacked=True)
    vae_p = np_params(init_wan_vae, jspec.vae, 1)
    size, frames, steps = (64, 64), 9, 4
    c, f, h, w = 4, 3, 4, 4   # latent_shape(tiny, 64, 64, 9)
    seq_len = padded_seq_len(tspec, size, frames)
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((1, f, h, w, c)).astype(np.float32)
    ctx = (rng.standard_normal((1, 16, 64)) * 0.5).astype(np.float32)
    nctx = (rng.standard_normal((1, 16, 64)) * 0.5).astype(np.float32)
    tma = dict(enabled=True, weight_max=1.3, text_prefix_len=16)

    jpipe = JPipeline(jspec, dit_p, vae_p, policy=J_FP32,
                            dispatch_steps=0)
    tma_key = tuple(sorted(dataclasses.asdict(JTMA(**tma)).items()))
    jrun = jpipe._denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                             False, tma_key)
    jx = jrun(dit_p, jnp.asarray(noise), jnp.asarray(ctx),
              jnp.asarray(nctx), jnp.zeros_like(jnp.asarray(noise)))
    jvideo = np.asarray(j_vae_decode(vae_p, jspec.vae, jx))

    dit = convert.dit_from_jax(dit_p, tspec.dit, device="cpu")
    vae = convert.vae_from_jax(vae_p, tspec.vae, device="cpu")
    tpipe = WanTI2VPipeline(tspec, dit, vae, policy=FP32_POLICY)
    trun = tpipe.denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                            TMAConfig(**tma))
    tx = trun(dit, torch.as_tensor(noise), torch.as_tensor(ctx),
              torch.as_tensor(nctx), torch.zeros(noise.shape))
    tvideo = t_vae_decode(vae, tx).numpy()

    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tvideo, jvideo, rtol=1e-4, atol=1e-4)
    assert tvideo.shape == (1, frames, 64, 64, 3)


def test_i2v_slice_matches_jax():
    """The i2v branch: the first latent frame is z0 before the loop and
    after every step, its 16 tokens take t = 0; latents to 1e-4 and the
    first frame equal to z0 exactly."""
    jspec, tspec = JCONFIGS["tiny"], WAN_CONFIGS["tiny"]
    dit_p = np_params(init_wan_dit, jspec.dit, 0, stacked=True)
    size, frames, steps = (64, 64), 9, 4
    c, f, h, w = 4, 3, 4, 4
    seq_len = padded_seq_len(tspec, size, frames)
    rng = np.random.default_rng(12)
    noise = rng.standard_normal((1, f, h, w, c)).astype(np.float32)
    z0 = np.zeros_like(noise)
    z0[:, :1] = rng.standard_normal((1, 1, h, w, c))
    ctx = (rng.standard_normal((1, 16, 64)) * 0.5).astype(np.float32)
    nctx = (rng.standard_normal((1, 16, 64)) * 0.5).astype(np.float32)
    tma = dict(enabled=True, weight_max=1.3, text_prefix_len=16)

    jpipe = JPipeline(jspec, dit_p, None, policy=J_FP32,
                            dispatch_steps=0)
    tma_key = tuple(sorted(dataclasses.asdict(JTMA(**tma)).items()))
    jx = jpipe._denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                           True, tma_key)(
        dit_p, jnp.asarray(noise), jnp.asarray(ctx), jnp.asarray(nctx),
        jnp.asarray(z0))
    dit = convert.dit_from_jax(dit_p, tspec.dit, device="cpu")
    tpipe = WanTI2VPipeline(tspec, dit, None, policy=FP32_POLICY)
    tx = tpipe.denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                          TMAConfig(**tma), i2v=True)(
        dit, torch.as_tensor(noise), torch.as_tensor(ctx),
        torch.as_tensor(nctx), torch.as_tensor(z0)).numpy()
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=1e-4, atol=1e-4)
    assert np.array_equal(tx[:, :1], z0[:, :1])


def _write_png(path, w, h, seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        path)
    return str(path)


def test_cli_t2v_tiny_writes_mp4(tmp_path):
    """`--model tiny --mock_weights --no_bagel` on the CPU: 64x64x9, 2
    steps; the mp4 decodes to 9 frames; the sidecar names the UMT5
    context."""
    out_dir = str(tmp_path)
    cmd = [sys.executable, "-m", "univid_tpu_torch.cli.inference",
           "--mode", "t2v", "--no_bagel", "--mock_weights", "--model",
           "tiny", "--video_size", "64x64", "--video_length", "9",
           "--steps", "2", "--device", "cpu", "--output_dir", out_dir]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    meta = json.loads(out.stdout.strip().splitlines()[-1])
    from univid_tpu_torch.data.video_io import read_video_frames
    frames = read_video_frames(meta["video_path"])
    assert len(frames) == 9 and frames[0].shape == (64, 64, 3)
    assert meta["context_path"] == "umt5"


def test_cli_both_modes_with_fusion(tmp_path):
    """`--model tiny --mode both --image <png> --mock_weights --device cpu`
    (fusion on by default): a t2v and an i2v mp4 of 9 frames, each with a
    sidecar whose context_path is bagel_fusion."""
    from univid_tpu_torch.data.video_io import read_video_frames
    img = _write_png(tmp_path / "first.png", 64, 64, 0)
    out_dir = str(tmp_path / "out")
    cmd = [sys.executable, "-m", "univid_tpu_torch.cli.inference",
           "--model", "tiny", "--mode", "both", "--image", img,
           "--mock_weights", "--device", "cpu", "--video_size", "64x64",
           "--video_length", "9", "--steps", "2", "--output_dir", out_dir]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    metas = [json.loads(x) for x in out.stdout.strip().splitlines()[-2:]]
    assert [m["mode"] for m in metas] == ["t2v", "i2v"]
    for m in metas:
        with open(m["video_path"] + ".json") as f:
            assert json.load(f)["context_path"] == "bagel_fusion"
        frames = read_video_frames(m["video_path"])
        assert len(frames) == 9 and frames[0].shape == (64, 64, 3)


@pytest.mark.parametrize("flag", ["use_lora", "training_state"])
def test_cli_merges_lora_and_loads_projector(tmp_path, flag):
    """--use_lora merges load_lora's factors into the DiT in place (w +
    alpha/r * (a b)^T on the masked layers, the rest untouched), and
    --training_state serves a saved projector; both then generate."""
    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.core.config import FusionConfig
    from univid_tpu_torch.train.lora import LoRAConfig, init_lora, save_lora
    base = ["--model", "tiny", "--mock_weights", "--device", "cpu",
            "--video_size", "64x64", "--video_length", "5", "--steps", "1",
            "--output_dir", str(tmp_path / "out")]
    extra = []
    if flag == "use_lora":
        cfg = WAN_CONFIGS["tiny"].dit
        lora = init_lora(torch.Generator().manual_seed(3), cfg,
                         LoRAConfig(rank=4), device="cpu")
        for p in lora["sites"].values():   # non-zero b: the merge moves w
            p["b"].normal_(0.0, 0.1, generator=torch.Generator()
                           .manual_seed(4))
        save_lora(str(tmp_path / "lora"), lora, LoRAConfig(rank=4))
        extra = ["--use_lora", "--lora_path", str(tmp_path / "lora")]
        args = inference.build_parser().parse_args(base)
        spec = inference.model_spec(args)
        plain = inference.build_pipeline(args, spec).dit.state_dict()
        merged = inference.build_pipeline(
            inference.build_parser().parse_args(base + extra), spec).dit
        scale = 32.0 / 4
        for site, p in lora["sites"].items():
            mod, proj = site.split("/")
            for layer in range(cfg.num_layers):
                name = f"blocks.{layer}.{mod}.{proj}.w"
                want = plain[name].float()
                if p["mask"][layer]:
                    want = want + scale * (p["a"][layer] @ p["b"][layer]).T
                np.testing.assert_allclose(
                    merged.state_dict()[name].float().numpy(),
                    want.to(torch.bfloat16).float().numpy(), rtol=0, atol=0)
    else:
        from univid_tpu_torch.core.checkpoint import \
            load_projector_checkpoint
        from univid_tpu_torch.models.fusion.projector import \
            init_context_projector
        fusion = FusionConfig(bagel_hidden_dim=64, wan_text_dim=64,
                              wan_text_length=16, bagel_sequence_length=16)
        proj = init_context_projector(torch.Generator().manual_seed(5),
                                      fusion, device="cpu")
        sd = {f"context_projector.bagel_to_t5_projector.{i}.{leaf}":
              getattr(getattr(proj, m), k).detach()
              for m, i in (("fc0", 0), ("ln0", 1), ("fc1", 4), ("ln1", 5))
              for k, leaf in (("w", "weight"), ("b", "bias"))}
        torch.save(sd, str(tmp_path / "training_state.pt"))
        extra = ["--training_state", str(tmp_path / "training_state.pt")]
        got = load_projector_checkpoint(str(tmp_path / "training_state.pt"),
                                        fusion, device="cpu")
        for name, p in proj.named_parameters():
            assert torch.equal(got.get_parameter(name), p.detach())
    metas = inference.main(base + extra)
    assert len(metas) == 1 and metas[0]["context_path"] == "bagel_fusion"
    assert os.path.exists(metas[0]["video_path"])


@pytest.mark.parametrize("flag", ["--int8", "--qk_int8", "--taylorseer",
                                  "--bf16_softmax"])
def test_cli_serving_knobs(flag, tmp_path):
    """Each serving knob through the port's CLI on the CPU (tiny, mock
    weights, 64x64x9, fusion on): an mp4 and its sidecar naming the knob.
    The tiny DiT's head dim of 16 takes the reference attention route,
    which ignores --qk_int8 and --bf16_softmax as the JAX package's does
    (their kernels are held in tests/test_torch_knobs.py); --int8 runs
    every block GEMM as W8A8 (10 a block and DiT call); --taylorseer 2
    over 8 steps runs 6 DiT steps and 2 Taylor steps."""
    from univid_tpu_torch.cli import inference
    from univid_tpu_torch.core import quant
    from univid_tpu_torch.data.video_io import read_video_frames

    steps = 8 if flag == "--taylorseer" else 2
    extra = [flag, "2"] if flag == "--taylorseer" else [flag]
    quant.W8A8_LAUNCHES["w8a8_linear"] = 0
    meta = inference.main([
        "--model", "tiny", "--mock_weights", "--device", "cpu",
        "--video_size", "64x64", "--video_length", "9", "--steps",
        str(steps), "--output_dir", str(tmp_path)] + extra)[0]
    assert len(read_video_frames(meta["video_path"])) == 9
    knob = flag[2:]
    assert meta["knobs"][knob] == (2 if knob == "taylorseer" else True)
    blocks = WAN_CONFIGS["tiny"].dit.num_layers
    assert quant.W8A8_LAUNCHES["w8a8_linear"] == (
        10 * blocks * steps if knob == "int8" else 0)
    phases = meta["phase_times_s"]
    assert ("taylor_step" in phases) == (knob == "taylorseer")
