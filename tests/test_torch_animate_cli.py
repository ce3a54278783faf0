"""The port's WanAnimatePipeline and `--mode animate` CLI against
univid_tpu's on the CPU.

The pipeline: the same parameter trees (test_torch_animate's np_tree), the
same inputs and JAX's own noise (PRNGKey(seed) split once a clip) through
both packages' generate under the fp32 policy: frames within 5e-4 (fp32
summation order over 2 solver steps, two forwards each, and the VAE).
The CLI: both packages' `main` on a src_root_path written here, with the
port's weights, text encoder and noise taken from JAX's mock draws, so
that the videos both CLIs hand to save_video can be compared.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_animate import CLIP_TINY, animate_params, np_tree
from test_torch_models import np_params
from univid_tpu.core.config import ANIMATE_CONFIGS as JANIMATE
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.models.wan import animate as ja
from univid_tpu.models.wan.vae_api import init_wan_vae
from univid_tpu.pipelines import animate as jpa
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import ANIMATE_CONFIGS
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.models.wan import animate as ta
from univid_tpu_torch.pipelines import animate as tpa

torch.set_num_threads(2)


def jax_noise(seed, n_clips, shape):
    """The noise JAX's generate draws: PRNGKey(seed) split once a clip."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_clips):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


def _video(shape, seed, scale=0.3):
    return np.clip(np.random.default_rng(seed).standard_normal(shape)
                   * scale, -1, 1).astype(np.float32)


CASES = {
    # name: (frames, clip_len, refert_num, replace, relight)
    "two_clips": (9, 5, 1, False, False),
    "refert5": (13, 9, 5, False, False),
    "replace": (9, 5, 1, True, False),
    "relight": (9, 5, 1, True, True),
}


def _relight_lora(cfg, seed):
    """A LoRA tree of JAX's layout over two sites, a mask on some layers."""
    rng = np.random.default_rng(seed)
    r, d, n = 4, cfg.dim, cfg.num_layers
    sites = {}
    for site in ("self_attn/q", "cross_attn/v"):
        sites[site] = {
            "a": (rng.standard_normal((n, d, r)) / np.sqrt(d)).astype(
                np.float32),
            "b": (rng.standard_normal((n, r, d)) * 0.1).astype(np.float32),
            "mask": (np.arange(n) % 2 == 0).astype(np.float32)}
    return {"sites": sites, "rank": r, "alpha": 8.0}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(case):
    """WanAnimatePipeline.generate at tiny-animate, 32x32, 2 DPM++ steps at
    guidance 1.5 (two forwards a step, the second with the face blanked),
    with JAX's noise: two clips with refert_num 1, two with refert_num 5
    (the overlap from the decoded tail), replace mode (background and
    inverted mask), and replace mode with a relighting LoRA merged."""
    t_real, clip_len, refert, replace, relight = CASES[case]
    jcfg, jvae, _ = JANIMATE["tiny-animate"]()
    tcfg, tvae, _ = ANIMATE_CONFIGS["tiny-animate"]()
    jc, tc = ja.ClipVisionConfig(**CLIP_TINY), ta.ClipVisionConfig(
        **CLIP_TINY)
    params = animate_params(jcfg)
    vae_p = np_params(init_wan_vae, jvae, 41)
    clip_p = np_tree(ja.init_clip_vision, jc, 42)
    h = w = 32
    cond = _video((t_real, h, w, 3), 43)
    face = _video((t_real, 16, 16, 3), 44)
    ref = _video((h, w, 3), 45)
    bg = mask = None
    if replace:
        bg = _video((t_real, h, w, 3), 46)
        mask = (np.random.default_rng(47).random((t_real, h, w)) > 0.5
                ).astype(np.float32)
    ctx = _video((jcfg.text_len, jcfg.text_dim), 48, 0.5)
    nctx = _video((jcfg.text_len, jcfg.text_dim), 49, 0.5)
    lora = _relight_lora(jcfg, 50) if relight else None
    kw = dict(clip_len=clip_len, refert_num=refert, sampling_steps=2,
              sample_solver="dpm++", guide_scale=1.5, seed=7)
    n_clips = 2
    lat_t = clip_len // 4 + 1
    noise = jax_noise(7, n_clips, (1, lat_t + 1, 2, 2, jvae.z_dim))

    jpipe = jpa.WanAnimatePipeline(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params), jvae,
        jax.tree_util.tree_map(jnp.asarray, vae_p), clip_cfg=jc,
        clip_params=jax.tree_util.tree_map(jnp.asarray, clip_p),
        policy=J_FP32, relight_lora=None if lora is None else
        jax.tree_util.tree_map(jnp.asarray, lora), dispatch_steps=0)
    want = jpipe.generate(jnp.asarray(ctx), jnp.asarray(nctx),
                          cond_video=cond, face_video=face, ref_image=ref,
                          bg_video=bg, mask_video=mask, **kw)

    model = convert.wan_animate_from_jax(params, tcfg, device="cpu")
    tpipe = tpa.WanAnimatePipeline(
        tcfg, model, tvae, convert.vae_from_jax(vae_p, tvae, device="cpu"),
        clip_cfg=tc, clip=convert.clip_vit_from_jax(clip_p, tc,
                                                    device="cpu"),
        policy=FP32_POLICY, relight_lora=None if lora is None else
        convert.lora_from_jax(lora, device="cpu"))
    got = tpipe.generate(torch.as_tensor(ctx), torch.as_tensor(nctx),
                         cond_video=cond, face_video=face, ref_image=ref,
                         bg_video=bg, mask_video=mask,
                         noise=[torch.tensor(n) for n in noise], **kw)
    assert tuple(got.shape) == want.shape == (t_real, h, w, 3)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _blocks(t, h, w, seed):
    """u8 frames [t, h, w, 3] of 8x8 blocks of one colour (smooth enough
    for h264 at the writer's quality)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (t, -(-h // 8), -(-w // 8), 3), np.uint8)
    return np.kron(base, np.ones((1, 8, 8, 1), np.uint8))[:, :h, :w]


def write_src_root(root, frames=9, size=32, face=24, ref=24):
    """A preprocess output dir: pose, background and mask videos at
    size x size, face crops at face x face (resized down to the tiny
    model's 16), a ref x ref reference image (resized up to the pose
    size)."""
    from PIL import Image

    from univid_tpu_torch.data.video_io import save_video
    os.makedirs(root, exist_ok=True)
    for name, side, seed in (("src_pose", size, 1), ("src_face", face, 2),
                             ("src_bg", size, 3), ("src_mask", size, 4)):
        save_video(_blocks(frames, side, side, seed),
                   os.path.join(root, f"{name}.mp4"), fps=30)
    Image.fromarray(_blocks(1, ref, ref, 5)[0]).save(
        os.path.join(root, "src_ref.png"))
    return str(root)


@pytest.mark.parametrize("replace", [False, True])
def test_cli_animate_matches_jax(tmp_path, monkeypatch, replace):
    """`--mode animate --model tiny-animate --mock_weights` through both
    CLIs on one src_root_path (9 frames, clips of 5: two clips; guidance
    1.5, 2 DPM++ steps), JAX's mock DiT, VAE and CLIP drawn by np_tree
    (a non-zero head, so that the DiT reaches the video) and given to the
    port with JAX's mock UMT5 and JAX's noise:
    the videos both hand to save_video agree within the bf16 policy's
    2e-2 rel. L2 (the CLIs' default policy; the fp32 pipeline is held to
    5e-4 above), and the sidecars have the same keys and settings."""
    import univid_tpu.data.video_io as jvio
    import univid_tpu_torch.data.video_io as tvio
    from univid_tpu.cli import inference as jcli
    from univid_tpu.models.wan.t5 import init_t5_encoder
    from univid_tpu_torch.cli import inference as tcli
    from univid_tpu_torch.pipelines.encoders import WanTextEncoder
    from univid_tpu_torch.utils.tokenizers import HashTokenizer

    root = write_src_root(tmp_path / "src")
    flags = ["--mode", "animate", "--model", "tiny-animate",
             "--mock_weights", "--src_root_path", root, "--steps", "2",
             "--clip_len", "5", "--guidance", "1.5", "--solver", "dpm++",
             "--seed", "7"] + (["--replace_flag"] if replace else [])
    videos = {}

    jcfg, jvae, jclip = JANIMATE["tiny-animate"]()
    trees = {"dit": animate_params(jcfg),
             "vae": np_params(init_wan_vae, jvae, 52),
             "clip": np_tree(ja.init_clip_vision, jclip, 51)}

    def drawn(name):
        """JAX's mock init of `name`, replaced by the numpy-filled tree of
        its structure in `trees` (which the port is given too)."""
        return lambda key, cfg, **kw: jax.tree_util.tree_map(
            jnp.asarray, trees[name])

    import univid_tpu.models.wan.vae_api as jvae_api
    monkeypatch.setattr(ja, "init_wan_animate", drawn("dit"))
    monkeypatch.setattr(ja, "init_clip_vision", drawn("clip"))
    monkeypatch.setattr(jvae_api, "init_wan_vae", drawn("vae"))

    def saver(tag, save):
        def save_video(frames, path, **kw):
            videos[tag] = np.asarray(frames)
            return save(frames, path, **kw)
        return save_video

    monkeypatch.setattr(jvio, "save_video", saver("jax", jvio.save_video))
    jmeta = jcli.main(flags + ["--output_dir", str(tmp_path / "j")])[0]

    acfg, vae_cfg, clip_cfg = ANIMATE_CONFIGS["tiny-animate"]()
    t5_spec = tcli.animate_t5_spec(tcli.build_parser().parse_args(flags),
                                   acfg)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def text_encoder(args, spec):
        t5 = convert.t5_from_jax(np_(init_t5_encoder(
            jax.random.PRNGKey(0), spec.t5)), spec.t5, device="cpu")
        return WanTextEncoder(t5, spec.t5, HashTokenizer(
            vocab_size=spec.t5.vocab_size), compute_dtype=torch.float32)

    def animate(args, a, v, c):
        return (convert.wan_animate_from_jax(trees["dit"], a, device="cpu"),
                convert.vae_from_jax(trees["vae"], v, device="cpu"),
                convert.clip_vit_from_jax(trees["clip"], c, device="cpu"))

    generate = tpa.WanAnimatePipeline.generate

    def with_jax_noise(self, *a, **kw):
        shape = (1, kw["clip_len"] // 4 + 2, 2, 2, vae_cfg.z_dim)
        kw["noise"] = [torch.tensor(n) for n in
                       jax_noise(kw["seed"], 2, shape)]
        return generate(self, *a, **kw)

    monkeypatch.setattr(tcli, "build_text_encoder", text_encoder)
    monkeypatch.setattr(tcli, "build_animate", animate)
    monkeypatch.setattr(tpa.WanAnimatePipeline, "generate", with_jax_noise)
    monkeypatch.setattr(tvio, "save_video", saver("port", tvio.save_video))
    tmeta = tcli.main(flags + ["--device", "cpu", "--output_dir",
                               str(tmp_path / "t")])[0]
    assert t5_spec.t5.num_layers == 2 and t5_spec.t5.dim == acfg.text_dim

    assert videos["port"].shape == videos["jax"].shape == (9, 32, 32, 3)
    rel = np.linalg.norm(videos["port"] - videos["jax"]) / np.linalg.norm(
        videos["jax"])
    assert rel < 2e-2, rel   # measured 5.1e-3 and 5.4e-3
    with open(jmeta["video_path"] + ".json") as f:
        jside = json.load(f)
    with open(tmeta["video_path"] + ".json") as f:
        tside = json.load(f)
    assert set(tside) == set(jside) == set(tmeta)
    for k in ("prompt", "mode", "model", "frames", "size", "steps",
              "guidance", "seed", "replace", "refert_num", "clip_len"):
        assert tside[k] == jside[k], k
    from univid_tpu_torch.data.video_io import read_video_frames
    assert len(read_video_frames(tmeta["video_path"])) == 9


@pytest.mark.parametrize("replace", [False, True])
def test_load_animate_inputs_matches_jax(tmp_path, replace):
    """The CLI's inputs as JAX's run_animate reads them: frames in [-1, 1],
    the 24x24 faces resized down to 16 and the 24x24 reference up to the
    32x32 pose size by jax.image.resize 'bilinear', the mask thresholded
    at mid-grey; 1e-5."""
    from univid_tpu.data.video_io import read_video_frames
    from univid_tpu_torch.cli.inference import load_animate_inputs
    from PIL import Image
    root = write_src_root(tmp_path / "src")

    def vid(name):
        return np.stack(read_video_frames(os.path.join(root, name))
                        ).astype(np.float32) / 127.5 - 1.0

    cond, face = vid("src_pose.mp4"), vid("src_face.mp4")
    ref = np.asarray(Image.open(os.path.join(root, "src_ref.png")).convert(
        "RGB"), np.float32) / 127.5 - 1.0
    want = [cond, np.asarray(jax.image.resize(
                jnp.asarray(face), (9, 16, 16, 3), method="bilinear")),
            np.asarray(jax.image.resize(jnp.asarray(ref), (32, 32, 3),
                                        method="bilinear"))]
    if replace:
        want += [vid("src_bg.mp4"),
                 (vid("src_mask.mp4").mean(axis=-1) > 0.0).astype(
                     np.float32)]
    got = load_animate_inputs(root, replace, 16)
    assert (got[3] is None and got[4] is None) == (not replace)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
