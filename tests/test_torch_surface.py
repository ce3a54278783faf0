"""Public functions of univid_tpu that the port's modules lacked until the
animate-preprocess slice, against univid_tpu's on the CPU, on the JAX
tests' own cases: data/video_io.py (read_video_fps, merge_video_audio,
best_output_size, smart_resize, smart_nframes), ops/samplers.py
(dpm_init_state, euler_flow_step), ops/embeddings.py (sincos_2d),
native/ (resize_bilinear's scale / shift, u8_to_f32_affine), and
utils/profiling.py (trace, annotate; the CLI's trace("generate")).

Host formulas copied from JAX are held equal; the samplers within fp32's
1e-6; resize_bilinear within 1e-5 (1e-4 with the u8 scale), JAX's C++
host op when its library is built.
"""

import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.data.video_io as jvio
import univid_tpu.native as jnative
import univid_tpu.ops.embeddings as jemb
import univid_tpu.ops.samplers as jsam
import univid_tpu_torch.data.video_io as tvio
import univid_tpu_torch.native as tnative
import univid_tpu_torch.ops.embeddings as temb
import univid_tpu_torch.ops.samplers as tsam
from univid_tpu.data.openvid import _resize_bilinear
from univid_tpu_torch.utils import profiling


def test_read_video_fps_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for fps in (8, 12, 30):
        path = str(tmp_path / f"v{fps}.mp4")
        tvio.save_video(rng.integers(0, 255, (6, 32, 48, 3), np.uint8),
                        path, fps=fps)
        got = tvio.read_video_fps(path)
        assert got == jvio.read_video_fps(path)
        assert got == pytest.approx(fps)
    missing = str(tmp_path / "none.mp4")
    assert tvio.read_video_fps(missing, default=25.0) == \
        jvio.read_video_fps(missing, default=25.0) == 25.0


def test_merge_video_audio_same_command(monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: calls.append((cmd, kw)))
    assert tvio.merge_video_audio("v.mp4", "a.wav", "o.mp4") == "o.mp4"
    jvio.merge_video_audio("v.mp4", "a.wav", "o.mp4")
    assert calls[0] == calls[1]
    assert calls[0][0][0] == "ffmpeg"


def test_best_output_size_matches_jax():
    for (w, h) in [(1920, 1080), (704, 1280), (500, 500), (1280, 720),
                   (333, 517)]:
        for dw, dh, area in ((16, 16, 1280 * 704), (32, 32, 832 * 480)):
            got = tvio.best_output_size(w, h, dw, dh, area)
            assert got == jvio.best_output_size(w, h, dw, dh, area)
            assert got[0] % dw == 0 and got[1] % dh == 0
            assert got[0] * got[1] <= area
    ow, oh = tvio.best_output_size(1920, 1080, 16, 16, 1280 * 704)
    assert abs(ow / oh - 16 / 9) < 0.1


def test_smart_resize_and_nframes_match_jax():
    for args in ((515, 333), (28, 28), (10, 10), (5000, 4000),
                 (100, 900)):
        assert tvio.smart_resize(*args) == jvio.smart_resize(*args)
    assert tvio.smart_resize(515, 333)[0] % 28 == 0
    for fn in (tvio.smart_resize, jvio.smart_resize):
        with pytest.raises(ValueError, match="aspect ratio"):
            fn(10, 3000)
    for ele, total, fps in (({"nframes": 9}, 100, 30.0),
                            ({"fps": 2.0}, 300, 30.0),
                            ({"fps": 1.0, "min_frames": 6}, 90, 24.0),
                            ({"max_frames": 10}, 600, 30.0)):
        assert tvio.smart_nframes(ele, total, fps) == \
            jvio.smart_nframes(ele, total, fps)
    assert tvio.smart_nframes({"nframes": 9}, 100, 30.0) == 8
    assert tvio.smart_nframes({"fps": 2.0}, 300, 30.0) == 20
    for fn in (tvio.smart_nframes, jvio.smart_nframes):
        with pytest.raises(ValueError, match="nframes should be"):
            fn({"nframes": 1}, 100, 30.0)


@pytest.mark.parametrize("order", [2, 3])
def test_dpm_loop_matches_jax(order):
    """dpm_init_state + dpm_step over 8 steps of the exact linear flow
    field: the port's states equal JAX's within fp32, and land on x0."""
    steps = 8
    sig, _ = jsam.flow_sigmas(steps, shift=3.0)
    rng = np.random.default_rng(order)
    x0 = rng.standard_normal((4, 4)).astype(np.float32)
    eps = rng.standard_normal((4, 4)).astype(np.float32)
    x = (1 - sig[0]) * x0 + sig[0] * eps
    coeffs = tsam.precompute_dpm_solver(sig, solver_order=order)
    jarrs = jsam.precompute_dpm_solver(sig, solver_order=order) \
        .device_arrays()
    t_state = tsam.dpm_init_state(torch.from_numpy(x), order=order)
    j_state = jsam.dpm_init_state(jnp.asarray(x), order=order)
    assert set(t_state) == set(j_state)
    for k in t_state:
        np.testing.assert_array_equal(t_state[k].numpy(),
                                      np.asarray(j_state[k]))
    for i in range(steps):
        v = (t_state["sample"] - torch.from_numpy(x0)) / max(float(sig[i]),
                                                            1e-12)
        t_state = tsam.dpm_step(t_state, coeffs.step(i), v)
        j_state = jsam.dpm_step(j_state, {k: a[i] for k, a in jarrs.items()},
                                jnp.asarray(v.numpy()))
        np.testing.assert_allclose(t_state["sample"].numpy(),
                                   np.asarray(j_state["sample"]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(t_state["sample"].numpy(), x0, rtol=1e-3,
                               atol=1e-3)


def test_euler_flow_step_matches_jax():
    x0 = np.asarray([[1.0, -1.0]], np.float32)
    eps = np.asarray([[0.5, 0.5]], np.float32)
    xt = tsam.add_flow_noise(torch.from_numpy(x0), torch.from_numpy(eps),
                             0.25)
    np.testing.assert_allclose(xt.numpy(), [[0.875, -0.625]])
    out = tsam.euler_flow_step(xt, torch.from_numpy(eps - x0), 0.25, 0.0)
    np.testing.assert_allclose(out.numpy(), x0, atol=1e-6)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    v = rng.standard_normal((2, 3, 4)).astype(np.float32)
    for cur, nxt in ((1.0, 0.75), (0.3, 0.1), (0.05, 0.0)):
        np.testing.assert_allclose(
            tsam.euler_flow_step(torch.from_numpy(x), torch.from_numpy(v),
                                 cur, nxt).numpy(),
            np.asarray(jsam.euler_flow_step(jnp.asarray(x), jnp.asarray(v),
                                            cur, nxt)), rtol=1e-6,
            atol=1e-7)
    bf = tsam.euler_flow_step(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(v), 1.0, 0.5)
    assert bf.dtype == torch.bfloat16


def test_sincos_2d_matches_jax():
    for dim, h, w in ((16, 3, 5), (64, 8, 8), (1152, 4, 2)):
        got = temb.sincos_2d(dim, h, w)
        assert got.dtype == np.float32 and got.shape == (h * w, dim)
        np.testing.assert_array_equal(got, jemb.sincos_2d(dim, h, w))


def test_native_affine_ops_match_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (41, 29, 3), np.uint8)
    got = tnative.resize_bilinear(img, 56, 56, scale=1 / 127.5, shift=-1.0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, jnative.resize_bilinear(img, 56, 56, scale=1 / 127.5,
                                     shift=-1.0), atol=1e-4)
    np.testing.assert_allclose(
        got, _resize_bilinear(img.astype(np.float32), 56, 56) / 127.5 - 1.0,
        atol=1e-6)
    f = rng.random((37, 53, 3), np.float32)
    for kw in ({}, dict(scale=2.0), dict(shift=0.5)):
        np.testing.assert_allclose(tnative.resize_bilinear(f, 24, 64, **kw),
                                   jnative.resize_bilinear(f, 24, 64, **kw),
                                   atol=1e-5)
    np.testing.assert_array_equal(tnative.resize_bilinear(f, 24, 64),
                                  _resize_bilinear(f, 24, 64))
    x = rng.integers(0, 256, (7, 9, 3), np.uint8)
    got = tnative.u8_to_f32_affine(x, 1 / 127.5, -1.0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jnative.u8_to_f32_affine(x, 1 / 127.5,
                                                             -1.0),
                               atol=1e-6)
    np.testing.assert_array_equal(
        got, x.astype(np.float32) * (1 / 127.5) + -1.0)


def test_trace_writes_a_profile(tmp_path, monkeypatch):
    """trace() writes <dir>/<name>/trace.json with the annotated regions
    when UNIVID_PROFILE_DIR (or profile_dir) is set, and nothing when
    neither is."""
    monkeypatch.delenv("UNIVID_PROFILE_DIR", raising=False)
    with profiling.trace("off"):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("UNIVID_PROFILE_DIR", str(tmp_path))
    with profiling.trace("gen"):
        with profiling.annotate("denoise_step"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "gen" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "denoise_step" for e in events)
    with profiling.trace("explicit", profile_dir=str(tmp_path / "p")):
        torch.zeros(2)
    assert (tmp_path / "p" / "explicit" / "trace.json").exists()


def test_cli_traces_generate(tmp_path, monkeypatch):
    """The port's inference CLI wraps its generation in trace("generate"),
    where JAX's CLI does."""
    from univid_tpu_torch.cli.inference import main
    monkeypatch.setenv("UNIVID_PROFILE_DIR", str(tmp_path / "prof"))
    main(["--model", "tiny", "--mode", "t2v", "--mock_weights", "--no_bagel",
          "--device", "cpu", "--video_size", "64x64", "--video_length", "5",
          "--steps", "2", "--output_dir", str(tmp_path / "out")])
    assert (tmp_path / "prof" / "generate" / "trace.json").exists()
