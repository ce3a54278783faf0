"""The port's animate preprocess chain and its CLI against univid_tpu's on
the CPU.

Every function of data/animate_preprocess.py on the same inputs in both
packages: bit-equal where JAX takes its numpy formulas (frame indices,
sizes, face boxes, masks, the cv2 pose render, retargeting, prompts), and
within one u8 level where JAX takes its C++ host op (native
resize_bilinear, when its library is built: the padding resize and the
face crops). The CLI with mock detectors: the arrays both CLIs hand to
save_video, then the port's `--mode animate` on the port's output (the
animate CLI itself is held against JAX's on one src dir in
test_torch_animate_cli.py, the relighting LoRA there too). The CLI with
ONNX detectors and with a SAM2 checkpoint under --ckpt_path, and
--use_flux through the port's Kontext editor.
"""

import contextlib
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import univid_tpu.data.video_io as jvio
import univid_tpu_torch.data.video_io as tvio
from test_animate_preprocess import _face70, _hand, _t_pose
from test_onnx_rt import _vitpose_fixture
from univid_tpu.cli import preprocess_animate as jcli
from univid_tpu.data import animate_preprocess as J
from univid_tpu_torch.cli import preprocess_animate as tcli
from univid_tpu_torch.data import animate_preprocess as T

torch.set_num_threads(2)


def within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_frame_indices_and_sizes_equal():
    for args in ((60, 30.0, 16, 8.0), (10, 30.0, 16, 8.0),
                 (100, 24.0, 33, 30.0)):
        assert T.get_frame_indices(*args) == J.get_frame_indices(*args)
    for args in ((1920, 1080, 1280 * 720, 16), (720, 1280, 832 * 480, 16),
                 (128, 96, 160 * 96, 16), (50, 3000, 64 * 64, 64)):
        assert T.fit_area_size(*args) == J.fit_area_size(*args)


def test_resizes_within_one_level():
    rng = np.random.default_rng(0)
    for shape, h, w in (((100, 50, 3), 64, 64), ((90, 140, 3), 96, 160),
                        ((64, 96, 1), 48, 48)):
        img = rng.integers(0, 255, shape).astype(np.uint8)
        within_one_level(T.padding_resize(img, h, w, (10, 20, 30)),
                         J.padding_resize(img, h, w, (10, 20, 30)))
    img = rng.integers(0, 255, (720, 1280, 3)).astype(np.uint8)
    within_one_level(T.resize_by_area(img, 832 * 480, divisor=16),
                     J.resize_by_area(img, 832 * 480, divisor=16))


def test_face_box_and_crop():
    frame = np.random.default_rng(1).integers(0, 255, (200, 200, 3),
                                              np.uint8)
    kps = np.stack([np.linspace(90, 110, 10), np.linspace(90, 110, 10)],
                   axis=1)
    for scale, normalized, k in ((1.3, False, kps),
                                 (1.5, True, kps / 200.0),
                                 (1.3, False, np.full((5, 2), 40.0))):
        assert T.face_bbox_from_kps(k, scale, (200, 200), normalized) == \
            J.face_bbox_from_kps(k, scale, (200, 200), normalized)
    within_one_level(T.crop_face(frame, kps, normalized=False),
                     J.crop_face(frame, kps, normalized=False))


def test_masks_equal():
    mask = np.zeros((64, 64), np.uint8)
    mask[20:40, 25:35] = 1
    mask[50:52, 5:9] = 1
    for k, it in ((5, 2), (7, 3), (3, 0)):
        np.testing.assert_array_equal(T.dilate_mask(mask, k, it),
                                      J.dilate_mask(mask, k, it))
    d = J.dilate_mask(mask, k=5, iterations=2)
    for wl, hl in ((1, 1), (2, 2), (3, 5)):
        np.testing.assert_array_equal(T.grid_quantize_mask(d, wl, hl),
                                      J.grid_quantize_mask(d, wl, hl))
    np.testing.assert_array_equal(T.mask_bbox(d), J.mask_bbox(d))
    frame = np.random.default_rng(2).integers(0, 255, (64, 64, 3),
                                              np.uint8)
    np.testing.assert_array_equal(T.composite_background(frame, d),
                                  J.composite_background(frame, d))
    empty = np.zeros((32, 32), np.uint8)
    assert T.grid_quantize_mask(empty, 2, 2).sum() == 0
    assert T.dilate_mask(empty, k=3, iterations=1).sum() == 0


def test_draw_pose_and_face_equal():
    canvas = np.zeros((128, 256, 3), np.uint8)
    for kw in ({}, dict(kps_face=_face70(100, 40)), dict(draw_head=False),
               dict(kps_lhand=_hand(70, 60), kps_rhand=_hand(130, 60)),
               dict(threshold=0.95)):
        np.testing.assert_array_equal(T.draw_pose(canvas, _t_pose(), **kw),
                                      J.draw_pose(canvas, _t_pose(), **kw))
    assert canvas.sum() == 0
    img = np.zeros((128, 128, 3), np.uint8)
    for face in (_face70(64, 64), _face70(64, 64)[:68]):
        np.testing.assert_array_equal(T.draw_face_keypoints(img, face),
                                      J.draw_face_keypoints(img, face))
    assert T.POSE_LIMBS == J.POSE_LIMBS and T.FACE_STYLE == J.FACE_STYLE


def test_retarget_equal():
    src = _t_pose(scale=1.0)
    ref = _t_pose(cx=80, cy=50, scale=1.5)
    ref[9, 2] = 0.1     # a low-confidence joint takes the median ratio
    ratios = T.bone_ratios(src, ref)
    assert ratios == J.bone_ratios(src, ref)
    stretched = src.copy()
    stretched[18, 0] += 40      # the foot clamp
    for body, anchor in ((src, ref[1, :2]), (stretched, None)):
        np.testing.assert_array_equal(
            T.retarget_body(body, ratios, anchor=anchor),
            J.retarget_body(body, ratios, anchor=anchor))
    new = J.retarget_body(src, ratios, anchor=ref[1, :2])
    for lh, rh in ((_hand(*src[7, :2]), _hand(*src[4, :2])),
                   (_hand(*src[4, :2]), _hand(*src[7, :2])),   # crossed
                   (None, _hand(*src[4, :2]))):
        got = T.retarget_hands(lh, rh, src, new, ratios)
        want = J.retarget_hands(lh, rh, src, new, ratios)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


def test_pose_hull_and_propagate_equal():
    meta = T.PoseMeta(body=_t_pose(cx=80, cy=40, scale=0.6),
                      lhand=_hand(60, 40), face=_face70(80, 30, r=5)[:, :2])
    jmeta = J.PoseMeta(body=meta.body, lhand=meta.lhand, face=meta.face)
    np.testing.assert_array_equal(T.pose_hull_mask((96, 160), meta),
                                  J.pose_hull_mask((96, 160), jmeta))
    t, h, w = 6, 64, 64
    frames = np.zeros((t, h, w, 3), np.uint8)
    truth = np.zeros((t, h, w), np.uint8)
    for i in range(t):
        x = 10 + 3 * i
        frames[i, 20:40, x:x + 12] = 255
        truth[i, 20:40, x:x + 12] = 1
    np.testing.assert_array_equal(T.propagate_mask(frames, truth[0]),
                                  J.propagate_mask(frames, truth[0]))


def test_editing_prompts_equal():
    body = np.zeros((20, 3), np.float32)
    body[:, 2] = 0.9
    body[:, :2] = (50, 40)
    legs_out = body.copy()
    legs_out[[9, 10, 12, 13], 1] = 500.0
    hidden = body.copy()
    hidden[[3, 4, 6, 7, 9, 10, 12, 13], 2] = 0.1
    for b in (body, legs_out, hidden):
        for hw in ((96, 160), (160, 96)):
            assert T.editing_prompts([T.PoseMeta(body=b)], None, hw) == \
                J.editing_prompts([J.PoseMeta(body=b)], None, hw)


def _pose_fn(pkg):
    def pose_fn(fr):
        h, w = fr.shape[1:3]
        return [pkg.PoseMeta(body=_t_pose(cx=w / 2, cy=h / 3, scale=0.6),
                             face=_face70(w / 2, h / 4, r=6))
                for _ in range(len(fr))]
    return pose_fn


def _mask_fn(fr, metas):
    m = np.zeros(fr.shape[:3], np.uint8)
    m[:, 20:60, 40:100] = 1
    return m


def assert_bundles_match(got, want):
    assert sorted(got) == sorted(want)
    for key in ("frames", "ref_image", "face_video", "bg_video"):
        if key in want:
            within_one_level(got[key], want[key])
    for key in ("pose_video", "aug_masks"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("mode", ["animate", "replace", "hull_fallback"])
def test_pipeline_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 255, (4, 120, 160, 3)).astype(np.uint8)
    refer = rng.integers(0, 255, (90, 140, 3)).astype(np.uint8)
    mask = None if mode == "hull_fallback" else _mask_fn
    kw = dict(resolution_area=(160, 96), replace=mode != "animate",
              retarget=mode == "animate")
    warns = (lambda: pytest.warns(UserWarning, match="pose-hull")) \
        if mode == "hull_fallback" else contextlib.nullcontext
    with warns():
        got = T.AnimatePreprocessPipeline(_pose_fn(T), mask)(frames, refer,
                                                             **kw)
    with warns():
        want = J.AnimatePreprocessPipeline(_pose_fn(J), mask)(frames, refer,
                                                             **kw)
    assert_bundles_match(got, want)
    paths = T.AnimatePreprocessPipeline(_pose_fn(T)).save(
        got, str(tmp_path / "prep"), fps=8)
    assert {os.path.basename(p) for p in paths.values()} == (
        {"src_ref.png", "src_pose.mp4", "src_face.mp4"}
        | ({"src_bg.mp4", "src_mask.mp4"} if kw["replace"] else set()))
    for p in paths.values():
        assert os.path.exists(p)


def test_replace_ignores_retarget():
    frames = np.zeros((2, 64, 64, 3), np.uint8)
    pipe = T.AnimatePreprocessPipeline(_pose_fn(T), _mask_fn)
    with pytest.warns(UserWarning, match="retargeting is ignored"):
        pipe(frames, frames[0], resolution_area=(64, 64), replace=True,
             retarget=True)


def _capture(monkeypatch):
    """The arrays each package's pipeline hands to save_video."""
    videos = {"jax": {}, "port": {}}

    def saver(tag, save):
        def save_video(frames, path, **kw):
            videos[tag][os.path.basename(path)] = np.asarray(frames)
            return save(frames, path, **kw)
        return save_video

    monkeypatch.setattr(jvio, "save_video", saver("jax", jvio.save_video))
    monkeypatch.setattr(tvio, "save_video", saver("port", tvio.save_video))
    return videos


def _drive(tmp_path, frames=8):
    rng = np.random.default_rng(13)
    vid = str(tmp_path / "drive.mp4")
    tvio.save_video(rng.integers(0, 255, (frames, 96, 128, 3), np.uint8),
                    vid, fps=8)
    ref = str(tmp_path / "ref.png")
    Image.fromarray(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)) \
        .save(ref)
    return vid, ref


def assert_outputs_match(videos, tdir, jdir):
    assert sorted(videos["port"]) == sorted(videos["jax"])
    for name, want in videos["jax"].items():
        got = videos["port"][name]
        if name in ("src_pose.mp4", "src_mask.mp4"):
            np.testing.assert_array_equal(got, want)
        else:
            within_one_level(got, want)
    within_one_level(np.asarray(Image.open(os.path.join(tdir, "src_ref.png"))),
                     np.asarray(Image.open(os.path.join(jdir, "src_ref.png"))))
    with open(os.path.join(tdir, "preprocess_meta.json")) as f:
        tmeta = json.load(f)
    with open(os.path.join(jdir, "preprocess_meta.json")) as f:
        jmeta = json.load(f)
    assert sorted(tmeta["paths"]) == sorted(jmeta["paths"])
    for k in ("frames", "size", "replace", "retarget"):
        assert tmeta[k] == jmeta[k], k


@pytest.mark.parametrize("flags", [["--replace_flag", "--retarget_flag"],
                                   ["--retarget_flag"]])
def test_cli_mock_detectors_matches_jax(tmp_path, monkeypatch, flags):
    vid, ref = _drive(tmp_path)
    videos = _capture(monkeypatch)
    common = ["--video_path", vid, "--refer_path", ref,
              "--resolution_area", "160", "96", "--fps", "-1",
              "--mock_detectors"] + flags
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tmeta = tcli.main(common + ["--save_path", tdir, "--device", "cpu"])
    jmeta = jcli.main(common + ["--save_path", jdir])
    assert tmeta["frames"] == jmeta["frames"] == 8
    assert_outputs_match(videos, tdir, jdir)


def test_cli_chain_to_animate(tmp_path):
    """The port's preprocess CLI (mock detectors, replace) then the port's
    `--mode animate` on its output, as tests/test_e2e_cli.py chains the
    JAX CLIs: an 8-frame video and its sidecar; the animate CLI reads the
    port's output as it reads JAX's (JAX's CLI on JAX's output is held
    against the port's on one dir in test_torch_animate_cli.py)."""
    from univid_tpu_torch.cli.inference import load_animate_inputs
    from univid_tpu_torch.cli.inference import main as inference_main

    vid, ref = _drive(tmp_path)
    common = ["--video_path", vid, "--refer_path", ref,
              "--resolution_area", "160", "96", "--fps", "-1",
              "--replace_flag", "--mock_detectors"]
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tcli.main(common + ["--save_path", tdir, "--device", "cpu"])
    jcli.main(common + ["--save_path", jdir])
    got = load_animate_inputs(tdir, True, 16)
    want = load_animate_inputs(jdir, True, 16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).mean() < 2.0 / 255, np.abs(g - w).mean()
    res = inference_main([
        "--mode", "animate", "--model", "tiny-animate", "--mock_weights",
        "--src_root_path", tdir, "--replace_flag", "--clip_len", "5",
        "--steps", "2", "--guidance", "1.0", "--prompt",
        "a person dancing", "--device", "cpu",
        "--output_dir", str(tmp_path / "out")])
    meta = res[0]
    assert meta["mode"] == "animate" and meta["replace"]
    assert len(tvio.read_video_frames(meta["video_path"])) == 8
    assert os.path.exists(meta["video_path"] + ".json")


def test_cli_onnx_and_sam2_ckpt_matches_jax(tmp_path, monkeypatch):
    """--ckpt_path with the published layout: pose2d/ (the ViTPose-shaped
    fixture graph) and sam2/sam2_hiera_large.pt at the tiny config,
    through the port's ONNX executor and SAM2 on the CPU, against JAX's
    CLI on the same files (the SAM2 config pinned to the tiny one in
    both loaders)."""
    from test_torch_sam2 import init_sd
    from univid_tpu.core import checkpoint as JC
    from univid_tpu.models.sam2 import tiny_sam2_config as jtiny
    from univid_tpu_torch.core import checkpoint as TC
    from univid_tpu_torch.models.sam2 import tiny_sam2_config as ttiny

    ckpt = tmp_path / "ckpt"
    (ckpt / "pose2d").mkdir(parents=True)
    (ckpt / "sam2").mkdir()
    (ckpt / "pose2d" / "vitpose_h_wholebody.onnx").write_bytes(
        pathlib.Path(_vitpose_fixture(tmp_path)).read_bytes())
    sd = init_sd(ttiny(64), 11)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(ckpt / "sam2" / "sam2_hiera_large.pt"))
    jload, tload = JC.load_sam2_checkpoint, TC.load_sam2_checkpoint
    monkeypatch.setattr(JC, "load_sam2_checkpoint",
                        lambda p, cfg=None, **kw: jload(p, jtiny(64), **kw))
    monkeypatch.setattr(TC, "load_sam2_checkpoint",
                        lambda p, cfg=None, **kw: tload(p, ttiny(64), **kw))
    vid, ref = _drive(tmp_path, frames=8)   # 4 key frames: the tiny bank
    videos = _capture(monkeypatch)
    common = ["--video_path", vid, "--refer_path", ref,
              "--resolution_area", "160", "96", "--fps", "-1",
              "--replace_flag", "--ckpt_path", str(ckpt)]
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tcli.main(common + ["--save_path", tdir, "--device", "cpu"])
    jcli.main(common + ["--save_path", jdir])
    # the SAM2 masks: equal but for pixels at |logit| ~ 0 (fp32
    # summation order), which the 7x7 dilation spreads
    tm, jm = (videos[k].pop("src_mask.mp4") for k in ("port", "jax"))
    assert np.mean(tm == jm) > 0.99
    for k in ("port", "jax"):
        videos[k].pop("src_bg.mp4")
    assert_outputs_match(videos, tdir, jdir)


def test_cli_refusals(tmp_path):
    with pytest.raises(SystemExit, match="retargeting"):
        tcli.main(["--video_path", "x", "--refer_path", "y",
                   "--save_path", "z", "--use_flux"])
    vid, ref = _drive(tmp_path, frames=2)
    with pytest.raises(SystemExit, match="no detectors"):
        tcli.main(["--video_path", vid, "--refer_path", ref, "--save_path",
                   str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="missing pose checkpoint"):
        tcli.main(["--video_path", vid, "--refer_path", ref, "--save_path",
                   str(tmp_path / "o"), "--device", "cpu", "--ckpt_path",
                   str(tmp_path)])
    with pytest.raises(SystemExit, match="needs the Kontext editor"):
        tcli.main(["--video_path", vid, "--refer_path", ref, "--save_path",
                   str(tmp_path / "o"), "--device", "cpu", "--ckpt_path",
                   str(tmp_path), "--retarget_flag", "--use_flux"],
                  pose_fn=tcli._mock_pose_fn)
    assert tcli.build_parser().parse_args(
        ["--video_path", "a", "--refer_path", "b", "--save_path", "c"]
    ).device == "cuda"


def test_flux_edit_hook_matches_jax(tmp_path):
    """--use_flux with an injected edit_fn: both CLIs edit the reference
    and the first template frame with the same prompts."""
    calls = {"jax": [], "port": []}

    def edit_fn(tag):
        def fn(img, prompt):
            calls[tag].append((img.shape, prompt))
            return img
        return fn

    vid, ref = _drive(tmp_path, frames=4)
    common = ["--video_path", vid, "--refer_path", ref,
              "--resolution_area", "160", "96", "--fps", "-1",
              "--retarget_flag", "--use_flux", "--mock_detectors"]
    meta = tcli.main(common + ["--save_path", str(tmp_path / "t"),
                               "--device", "cpu"], edit_fn=edit_fn("port"))
    jcli.main(common + ["--save_path", str(tmp_path / "j")],
              edit_fn=edit_fn("jax"))
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2
    assert meta["retarget"]


def test_cli_use_flux_with_kontext_editor(tmp_path):
    """--use_flux drives the port's KontextPipeline (tiny, fp32, from a
    seed) as edit_fn through the preprocess chain (tests/test_flux.py's
    case on the port)."""
    from univid_tpu_torch.core.dtypes import FP32_POLICY
    from univid_tpu_torch.pipelines.kontext import (KontextPipeline,
                                                    make_edit_fn)

    rng = np.random.default_rng(0)
    video = tmp_path / "drive.mp4"
    tvio.save_video((rng.random((4, 64, 48, 3)) * 255).astype(np.uint8),
                    str(video), fps=8)
    ref = tmp_path / "ref.png"
    Image.fromarray((rng.random((64, 48, 3)) * 255).astype(np.uint8)) \
        .save(ref)
    pipe = KontextPipeline.random_init(seed=0, tiny=True,
                                       policy=FP32_POLICY, device="cpu")
    out = tmp_path / "prep"
    tcli.main(["--video_path", str(video), "--refer_path", str(ref),
               "--save_path", str(out), "--resolution_area", "64", "48",
               "--retarget_flag", "--use_flux", "--mock_detectors",
               "--device", "cpu"],
              edit_fn=make_edit_fn(pipeline=pipe, num_inference_steps=2,
                                   device="cpu"))
    assert (out / "src_pose.mp4").exists()
    assert jax.devices()[0].platform == "cpu"
