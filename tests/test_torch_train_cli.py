"""The port's training CLI and debug flags against univid_tpu's, on the CPU.

`univid_tpu_torch.cli.train.main` runs as tests/test_e2e_cli.py runs JAX's
(`--model tiny --mock_weights`, here with `--device cpu`): the semantic
objective trains and checkpoints, --train_lora exports an adapter that JAX's
load_lora reads, a second run resumes, an empty dir and a missing card exit.
The slice as a whole: one diffusion step on a batch that each package's
OpenVidDataset reads from the same clip and each package's VAE encodes,
from JAX's mock DiT, VAE and trainables converted by convert.py, with the
same noise and t: the losses within test_diffusion_step_matches_jax's
tolerance (1e-5 relative under FP32_POLICY; 1e-2 under the bf16 default
policy, whose GEMMs round at the same points but sum in other orders).
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from univid_tpu.core.config import FusionConfig as JFusionConfig
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.config import latent_shape
from univid_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.data import openvid as jov
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.vae_api import init_wan_vae
from univid_tpu.train import fusion_trainer as jft
from univid_tpu.train import lora as jlora
from univid_tpu_torch import convert
from univid_tpu_torch.cli import eval_understanding as t_eval
from univid_tpu_torch.cli import inference as t_inference
from univid_tpu_torch.cli import train as t_train
from univid_tpu_torch.core.config import FusionConfig, WAN_CONFIGS
from univid_tpu_torch.core.debug import BUILD_LOGGER, apply_debug_flags
from univid_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY
from univid_tpu_torch.data import openvid as tov
from univid_tpu_torch.data.video_io import save_video
from univid_tpu_torch.train import fusion_trainer as tft
from univid_tpu_torch.train import lora as tlora

torch.set_num_threads(2)


@pytest.fixture
def videos(tmp_path):
    """Two 6-frame 64x64 clips, as tests/test_e2e_cli.py writes them."""
    vids = tmp_path / "videos"
    vids.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        save_video(rng.integers(0, 256, (6, 64, 64, 3), np.uint8),
                   str(vids / f"v{i}.mp4"), fps=8)
    return vids


def _argv(tmp_path, vids, run, *extra):
    return ["--video_dir", str(vids), "--csv_file", str(tmp_path / "x.csv"),
            "--output_dir", str(tmp_path / run), "--model", "tiny",
            "--mock_weights", "--video_size", "64x64", "--video_length", "5",
            "--learning_rate", "3e-3", "--log_interval", "1", "--device",
            "cpu", *extra]


def _losses(text):
    return [float(ln.split("loss=")[1].split()[0])
            for ln in text.splitlines() if ln.startswith("step ")]


# ---------------------------------------------------------------------------
# debug flags
# ---------------------------------------------------------------------------


def test_debug_flags_env_mapping():
    """No variable set (or set to 0 / empty) changes nothing;
    UNIVID_DISABLE_JIT applies nothing (the port is eager); UNIVID_DEBUG_NANS
    turns on anomaly mode with NaN checks (a backward that yields a NaN
    raises); UNIVID_LOG_COMPILES the kernel builds' logger at INFO."""
    logger = logging.getLogger(BUILD_LOGGER)
    level, handlers = logger.level, list(logger.handlers)
    assert not torch.is_anomaly_enabled()
    try:
        assert apply_debug_flags(env={}) == {}
        assert apply_debug_flags(env={"UNIVID_DEBUG_NANS": "0",
                                      "UNIVID_LOG_COMPILES": "",
                                      "UNIVID_DISABLE_JIT": "1"}) == {}
        assert not torch.is_anomaly_enabled()
        assert (logger.level, logger.handlers) == (level, handlers)
        assert apply_debug_flags(env={"UNIVID_DEBUG_NANS": "1",
                                      "UNIVID_LOG_COMPILES": "yes"}) == {
            "detect_anomaly_check_nan": True, "log_kernel_builds": True}
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
        assert logger.isEnabledFor(logging.INFO) and logger.handlers
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x * 0.0 - 1.0).sqrt().sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
        logger.setLevel(level)
        logger.handlers[:] = handlers


@pytest.mark.parametrize("cli", ["inference", "eval_understanding", "train"])
def test_each_cli_applies_debug_nans(cli, tmp_path, monkeypatch):
    """Every port CLI calls apply_debug_flags first thing in `main`, as the
    JAX CLIs do: with UNIVID_DEBUG_NANS=1 anomaly mode is on by the time
    each stops (inference and training on a missing card, the QA CLI on a
    missing ground-truth file). Anomaly mode is turned
    off again before the test ends."""
    monkeypatch.setenv("UNIVID_DEBUG_NANS", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runs = {
        "inference": (t_inference.main, ["--mode", "animate"], SystemExit),
        "eval_understanding": (t_eval.main, [
            "--video_dir", str(tmp_path), "--gt_file",
            str(tmp_path / "absent.json"), "--output_dir",
            str(tmp_path / "out"), "--output_name", "x", "--id_from", "1",
            "--id_to", "1"], FileNotFoundError),
        "train": (t_train.main, ["--output_dir", str(tmp_path / "run")],
                  SystemExit),
    }
    main, argv, stop = runs[cli]
    try:
        with pytest.raises(stop):
            main(argv)
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_semantic_trains_and_checkpoints(tmp_path, videos, capsys):
    """tests/test_e2e_cli.py's run: 6 semantic steps, the loss decreasing,
    `latest/train_state.npz` written, the summary with JAX's keys."""
    out = t_train.main(_argv(tmp_path, videos, "run", "--max_steps", "6",
                             "--save_interval", "3"))
    text = capsys.readouterr().out
    assert out == {"steps": 6, "best_loss": out["best_loss"],
                   "output_dir": str(tmp_path / "run")}
    assert json.loads(text.strip().splitlines()[-1]) == out
    losses = _losses(text)
    assert len(losses) == 6 and losses[-1] < losses[0], losses
    assert out["best_loss"] == pytest.approx(min(losses), abs=1e-6)
    assert os.path.exists(tmp_path / "run" / "latest" / "train_state.npz")
    assert os.path.exists(tmp_path / "run" / "best" / "train_state.npz")


def test_cli_train_lora_exports_an_adapter_jax_reads(tmp_path, videos):
    """--train_lora implies the diffusion objective: best/ and lora_best/
    written; univid_tpu.train.lora.load_lora reads lora_best/, whose b
    factors moved off zero."""
    out = t_train.main(_argv(tmp_path, videos, "run", "--max_steps", "3",
                             "--train_lora", "--lora_rank", "4"))
    assert out["steps"] == 3 and np.isfinite(out["best_loss"])
    run = tmp_path / "run"
    for sub in ("latest", "best"):
        assert os.path.exists(run / sub / "train_state.npz")
    lora, cfg = jlora.load_lora(str(run / "lora_best"))
    assert (cfg.rank, cfg.target_strategy) == (4, "wan_cross_attention")
    assert lora["sites"]
    assert max(float(np.abs(np.asarray(p["b"])).max())
               for p in lora["sites"].values()) > 0


def test_cli_resumes_at_the_saved_step(tmp_path, videos, capsys):
    """A second run with a larger --max_steps resumes from latest/ at the
    saved step and stops at the new cap; --no_resume starts over."""
    t_train.main(_argv(tmp_path, videos, "run", "--max_steps", "3"))
    capsys.readouterr()
    out = t_train.main(_argv(tmp_path, videos, "run", "--max_steps", "5"))
    text = capsys.readouterr().out
    assert out["steps"] == 5
    assert "resumed at step 3" in text
    assert len(_losses(text)) == 2
    out = t_train.main(_argv(tmp_path, videos, "run", "--max_steps", "2",
                             "--no_resume"))
    assert out["steps"] == 2 and "resumed" not in capsys.readouterr().out


def test_cli_empty_video_dir_exits_as_jax(tmp_path):
    """No clip under --video_dir: both CLIs exit with the same message."""
    from univid_tpu.cli.train import main as j_main

    (tmp_path / "empty").mkdir()
    argv = _argv(tmp_path, tmp_path / "empty", "run", "--max_steps", "1")
    j_argv = argv[:argv.index("--device")]
    msgs = []
    for main, args in ((t_train.main, argv), (j_main, j_argv)):
        with pytest.raises(SystemExit) as e:
            main(args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == f"no samples under {tmp_path / 'empty'}"


def test_cli_cuda_without_a_card_exits(tmp_path, videos, monkeypatch):
    """--device cuda (the default) with no card raises SystemExit before any
    weight is drawn."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(tmp_path, videos, "run")
    argv = argv[:argv.index("--device")]
    with pytest.raises(SystemExit, match="no CUDA device"):
        t_train.main(argv)
    with pytest.raises(SystemExit, match="no CUDA device"):
        t_train.main(argv + ["--device", "cuda:0"])


def test_cli_builds_umt5_only_for_the_semantic_objective(tmp_path, videos,
                                                         monkeypatch):
    """A deliberate difference (ROADMAP queue 3): JAX builds UMT5 whatever
    the objective; the port builds it only for the semantic one, the only
    reader of its features (a 5B run's fp32 mock UMT5 is 22.7 GB)."""
    from univid_tpu_torch.pipelines.encoders import WanTextEncoder

    built = []
    real = WanTextEncoder.random_init.__func__

    def spy(cls, *a, **kw):
        built.append(a[0].name if hasattr(a[0], "name") else a[0])
        return real(cls, *a, **kw)

    monkeypatch.setattr(WanTextEncoder, "random_init", classmethod(spy))
    t_train.main(_argv(tmp_path, videos, "lora", "--max_steps", "1",
                       "--train_lora"))
    t_train.main(_argv(tmp_path, videos, "diff", "--max_steps", "1",
                       "--objective", "diffusion"))
    assert built == []
    t_train.main(_argv(tmp_path, videos, "sem", "--max_steps", "1"))
    assert len(built) == 1


class _Built(Exception):
    pass


@pytest.mark.parametrize("mock", [True, False], ids=["mock", "checkpoint"])
def test_cli_bagel_compute_dtype_equals_jax(tmp_path, videos, monkeypatch,
                                            mock):
    """The extractor's compute dtype is the JAX CLI's: fp32 under
    --mock_weights, else bf16, also for the mock BAGEL beside a Wan
    --checkpoint_dir (no --bagel_path). Each CLI runs up to the extractor's
    construction (UMT5's checkpoint load stubbed on the JAX side)."""
    import univid_tpu.models.fusion.extractor as jext
    import univid_tpu.pipelines.encoders as jenc
    import univid_tpu_torch.models.fusion.extractor as text
    from univid_tpu.cli import train as j_train

    seen = {}

    def spy(side):
        def make(*a, compute_dtype, **kw):
            seen[side] = str(compute_dtype).split(".")[-1] \
                if isinstance(compute_dtype, torch.dtype) \
                else np.dtype(compute_dtype).name
            raise _Built
        return make

    monkeypatch.setattr(jext, "BagelSemanticExtractor", spy("jax"))
    monkeypatch.setattr(text, "BagelSemanticExtractor", spy("port"))
    monkeypatch.setattr(
        jenc.WanTextEncoder, "from_checkpoint",
        classmethod(lambda cls, d, spec: cls.random_init(spec)))
    extra = ["--mock_weights"] if mock else \
        ["--checkpoint_dir", str(tmp_path / "wan")]
    argv = [a for a in _argv(tmp_path, videos, "run") if a != "--mock_weights"]
    i = argv.index("--device")
    with pytest.raises(_Built):
        t_train.main(argv + ["--train_lora"] + extra)
    with pytest.raises(_Built):
        j_train.main(argv[:i] + argv[i + 2:] + extra)
    want = "float32" if mock else "bfloat16"
    assert seen == {"jax": want, "port": want}


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mock():
    """JAX's mock models of the tiny config, shared by both policies: the
    DiT from the CLI's seeds with its head redrawn (init_wan_dit), the VAE
    of init_wan_vae's structure from a numpy seed (np_params: JAX's eager
    VAE init takes ~40 s on the CPU), the trainables from
    init_fusion_train_state."""
    from test_torch_models import np_params

    spec = JCONFIGS["tiny"]
    base = init_wan_dit(jax.random.PRNGKey(20), spec.dit)
    hw = base["head"]["head"]["w"]
    base["head"]["head"]["w"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(22), hw.shape, hw.dtype)
    vae_params = np_params(init_wan_vae, spec.vae, 21)
    fkw = dict(bagel_hidden_dim=16, wan_text_dim=spec.dit.text_dim,
               wan_text_length=spec.dit.text_len, bagel_sequence_length=6,
               projector_hidden_mult=2)
    ckw = dict(max_steps=8, learning_rate=3e-3, train_lora=True)
    jfusion, jcfg = JFusionConfig(**fkw), jft.FusionTrainConfig(**ckw)
    jstate, jtx, jtmpl = jft.init_fusion_train_state(
        jax.random.PRNGKey(2), jfusion, jcfg, dit_cfg=spec.dit,
        lora_cfg=jlora.LoRAConfig(rank=2))
    return dict(base=base, vae_params=vae_params, fkw=fkw, ckw=ckw,
                jfusion=jfusion, jcfg=jcfg, jstate=jstate, jtx=jtx,
                jtmpl=jtmpl)


@pytest.mark.parametrize("policy", ["fp32", "default"])
def test_openvid_diffusion_step_matches_jax(tmp_path, policy, jax_mock):
    """One diffusion step: each package's OpenVidDataset reads the same clip
    (equal bits), each package's VAE encodes it (the port's converted from
    JAX's mock VAE: latents to 1e-5 relative L2, fp32 convolutions in
    another order), from JAX's mock DiT and trainables converted by
    convert.py, the same noise, BAGEL tokens and t: the losses within
    test_diffusion_step_matches_jax's tolerance, 1e-5 (fp32) / 1e-2
    (default policy) relative."""
    spec, tspec = JCONFIGS["tiny"], WAN_CONFIGS["tiny"]
    m = jax_mock
    # JAX's step donates its state: each test steps its own copy
    jstate = jax.tree_util.tree_map(lambda x: x.copy(), m["jstate"])
    vids = tmp_path / "videos"
    vids.mkdir()
    save_video(np.random.default_rng(1).integers(0, 256, (9, 48, 80, 3),
                                                 np.uint8),
               str(vids / "clip.mp4"), fps=8)
    size, length = (64, 64), 9   # resized from 80x48 on read
    kw = dict(video_base_path=str(vids), csv_file=str(tmp_path / "x.csv"),
              video_size=size, video_length=length)
    jvideo = jov.OpenVidDataset(jov.OpenVidConfig(**kw))[0]["video"]
    tvideo = tov.OpenVidDataset(tov.OpenVidConfig(**kw))[0]["video"]
    np.testing.assert_array_equal(tvideo, jvideo)

    tfusion = FusionConfig(**m["fkw"])
    tcfg = tft.FusionTrainConfig(**m["ckw"])
    _, f, h, w = latent_shape(spec, *size, length)
    fp32 = policy == "fp32"
    jstep, jencode = jft.make_diffusion_train_step(
        spec, m["jfusion"], m["jcfg"], m["jtx"], m["base"], m["vae_params"],
        (f, h, w), lora_template=m["jtmpl"],
        policy=J_FP32 if fp32 else J_DEFAULT)

    dit = convert.dit_from_jax(m["base"], tspec.dit, device="cpu")
    vae = convert.vae_from_jax(m["vae_params"], tspec.vae, device="cpu")
    ttmpl = convert.lora_from_jax(m["jtmpl"], device="cpu")
    trainable = {"projector": convert.projector_from_jax(
        jstate["trainable"]["projector"], tfusion, device="cpu"),
        "lora": tlora.trainable_sites(ttmpl)}
    ttx = tft.make_fusion_optimizer(tcfg)
    tstate = tft.new_train_state(trainable, ttx)
    tstep, tencode = tft.make_diffusion_train_step(
        tspec, tfusion, tcfg, ttx, dit, vae, (f, h, w), lora_template=ttmpl,
        policy=FP32_POLICY if fp32 else DEFAULT_POLICY)

    jlat = np.asarray(jencode(jvideo[None]))
    tlat = tencode(torch.as_tensor(tvideo)[None])
    assert tuple(tlat.shape) == (1, f, h, w, spec.vae.z_dim)
    assert float(np.linalg.norm(tlat.numpy() - jlat)
                 / np.linalg.norm(jlat)) < 1e-5
    rng = np.random.default_rng(3)
    noise = rng.standard_normal(jlat.shape).astype(np.float32)
    tokens = rng.standard_normal((1, 6, 16)).astype(np.float32)
    t = np.array([400.0], np.float32)
    _, jloss = jstep(jstate, {"latents": jlat, "noise": noise,
                              "bagel_tokens": tokens, "t": t})
    tstate, tloss = tstep(tstate, {
        "latents": tlat, "noise": torch.as_tensor(noise),
        "bagel_tokens": torch.as_tensor(tokens), "t": torch.as_tensor(t)})
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if fp32 else 1e-2)
    assert tstate["step"] == 1
