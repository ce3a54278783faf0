"""The port's t2v slice as a whole against univid_tpu's, and its CLI.

The same numpy noise and context go through univid_tpu's
WanTI2VPipeline._denoise_fn run (4 UniPC steps, batch-2 CFG, TMA weights)
and the port's WanT2VPipeline.denoise_fn run, under the fp32 policy; both
latents are then decoded. fp32 throughout: 1e-4 relative covers the
summation-order differences accumulated over 4 steps.
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
from univid_tpu.pipelines.ti2v import WanTI2VPipeline
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import TMAConfig, WAN_CONFIGS
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.models.wan.vae_api import vae_decode as t_vae_decode
from univid_tpu_torch.pipelines.ti2v import WanT2VPipeline, padded_seq_len

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

    jpipe = WanTI2VPipeline(jspec, dit_p, vae_p, policy=J_FP32,
                            dispatch_steps=0)
    tma_key = tuple(sorted(dataclasses.asdict(JTMA(**tma)).items()))
    jrun = jpipe._denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                             False, tma_key)
    jx = jrun(dit_p, jnp.asarray(noise), jnp.asarray(ctx),
              jnp.asarray(nctx), jnp.zeros_like(jnp.asarray(noise)))
    jvideo = np.asarray(j_vae_decode(vae_p, jspec.vae, jx))

    dit = convert.dit_from_jax(dit_p, tspec.dit, device="cpu")
    vae = convert.vae_from_jax(vae_p, tspec.vae, device="cpu")
    tpipe = WanT2VPipeline(tspec, dit, vae, policy=FP32_POLICY)
    trun = tpipe.denoise_fn((f, h, w), seq_len, steps, 5.0, 5.0, "unipc",
                            TMAConfig(**tma))
    tx = trun(dit, torch.as_tensor(noise), torch.as_tensor(ctx),
              torch.as_tensor(nctx), torch.zeros(noise.shape))
    tvideo = t_vae_decode(vae, tx).numpy()

    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tvideo, jvideo, rtol=1e-4, atol=1e-4)
    assert tvideo.shape == (1, frames, 64, 64, 3)


def test_cli_t2v_tiny_writes_mp4(tmp_path):
    """`--model tiny --mock_weights --no_bagel` on the CPU: 64x64x9, 2
    steps; the mp4 decodes to 9 frames; later-slice flags are refused."""
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
    refused = subprocess.run(cmd[:-2] + ["--output_dir", out_dir, "--mode",
                                         "i2v"],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
    assert refused.returncode != 0 and "later slice" in refused.stderr


@pytest.mark.parametrize("flags", [
    ["--model", "ti2v-5B", "--no_bagel"],
    ["--mode", "animate", "--no_bagel"],
    ["--int8", "--no_bagel"],
    ["--qk_int8", "--no_bagel"],
    ["--taylorseer", "2", "--no_bagel"],
    [],   # BAGEL fusion is the default
])
def test_cli_refuses_later_slices(flags):
    """Flags of later slices exit up front naming the slice, before any
    weights are drawn; none silently takes another path."""
    from univid_tpu_torch.cli import inference
    with pytest.raises(SystemExit, match="later slice"):
        inference.main(["--mock_weights", "--device", "cpu"] + flags)
