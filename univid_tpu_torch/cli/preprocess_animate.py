"""WanAnimate preprocessing CLI (counterpart of
univid_tpu/cli/preprocess_animate.py; every flag of it plus --device).

Flag-compatible with the reference preprocess_data.py (video / refer /
save paths, resolution_area, fps, replace / retarget flags, mask dilation
parameters). --ckpt_path wires the published checkpoint layout:
`pose2d/vitpose_h_wholebody.onnx` and an optional `det/yolov10m.onnx`
run through the port's torch ONNX executor (data/onnx_rt.py) on
--device; if `sam2/sam2_hiera_large.pt` exists, the port's SAM2 video
segmenter (models/sam2) on --device becomes the mask_fn, otherwise
replacement mode falls back to pose-hull masks. --use_flux (retarget
mode only) edits through pipelines/kontext.make_edit_fn from
`<ckpt_path>/flux`. Custom detectors can be passed programmatically via
`main(argv, pose_fn=..., mask_fn=..., edit_fn=...)`; --mock_detectors
swaps in deterministic synthetic detectors so the deterministic chain
(resize, face crops, pose render, retarget, masks, src_* outputs) runs
hermetically. The output dir is what `cli/inference.py --mode animate`
reads.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="The preprocessing pipeline for Wan-animate "
                    "(PyTorch / CUDA)")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="Detector checkpoint dir (pose2d/*.onnx, "
                        "det/*.onnx, sam2/*.pt)")
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--refer_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--resolution_area", type=int, nargs=2,
                   default=[1280, 720])
    p.add_argument("--fps", type=int, default=30,
                   help="-1 keeps the source fps")
    p.add_argument("--replace_flag", action="store_true")
    p.add_argument("--retarget_flag", action="store_true")
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--k", type=int, default=7)
    p.add_argument("--w_len", type=int, default=1)
    p.add_argument("--h_len", type=int, default=1)
    p.add_argument("--mock_detectors", action="store_true",
                   help="Deterministic synthetic pose/mask detectors "
                        "(hermetic smoke run; chain is identical)")
    p.add_argument("--use_flux", action="store_true",
                   help="FLUX-Kontext canonical-pose editing before "
                        "bone-ratio estimation (retarget mode only; "
                        "uses the port's editor from <ckpt_path>/flux, an "
                        "injected edit_fn, or --mock_detectors)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the detectors and SAM2 run (cuda unless "
                        "'cpu' is asked for)")
    return p


def _mock_pose_fn(frames: np.ndarray):
    """Centered synthetic skeleton per frame (detector stand-in)."""
    from ..data.animate_preprocess import PoseMeta
    t, h, w = frames.shape[:3]
    cx, cy, s = w / 2.0, h / 3.0, min(h, w) / 200.0
    body = np.array([
        [cx, cy - 20 * s], [cx, cy], [cx - 10 * s, cy], [cx - 20 * s, cy],
        [cx - 30 * s, cy], [cx + 10 * s, cy], [cx + 20 * s, cy],
        [cx + 30 * s, cy], [cx - 8 * s, cy + 30 * s],
        [cx - 8 * s, cy + 55 * s], [cx - 8 * s, cy + 80 * s],
        [cx + 8 * s, cy + 30 * s], [cx + 8 * s, cy + 55 * s],
        [cx + 8 * s, cy + 80 * s], [cx - 4 * s, cy - 24 * s],
        [cx + 4 * s, cy - 24 * s], [cx - 8 * s, cy - 22 * s],
        [cx + 8 * s, cy - 22 * s], [cx + 10 * s, cy + 84 * s],
        [cx - 10 * s, cy + 84 * s]], np.float32)
    body = np.concatenate([body, np.ones((20, 1), np.float32)], axis=1)
    return [PoseMeta(body=body.copy()) for _ in range(t)]


def _mock_mask_fn(frames: np.ndarray, metas):
    m = np.zeros(frames.shape[:3], np.uint8)
    h, w = frames.shape[1:3]
    m[:, h // 4: 3 * h // 4, w // 3: 2 * w // 3] = 1
    return m


def main(argv=None, pose_fn=None, mask_fn=None, edit_fn=None):
    """CLI entry. Real detectors (ViTPose / YOLO / SAM2) come from
    --ckpt_path or are injected via pose_fn / mask_fn; with
    --mock_detectors the synthetic stand-ins run the identical
    deterministic chain."""
    args = build_parser().parse_args(argv)
    if args.use_flux and not args.retarget_flag:
        raise SystemExit("Image editing with FLUX can only be used "
                         "when pose retargeting is enabled")
    import torch

    from ..data.animate_preprocess import (AnimatePreprocessPipeline,
                                           get_frame_indices)
    from ..data.video_io import read_video_fps, read_video_frames
    from PIL import Image

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "detectors on the CPU")
    # fp32 products and convolutions in full fp32, as the JAX package's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    frames = np.stack(read_video_frames(args.video_path))
    src_fps = read_video_fps(args.video_path)
    fps = src_fps if args.fps == -1 else args.fps
    n_target = max(int(len(frames) / src_fps * fps), 1)
    idx = get_frame_indices(len(frames), src_fps, n_target, fps)
    frames = frames[idx]
    refer = np.asarray(Image.open(args.refer_path).convert("RGB"))

    if args.mock_detectors:
        pose_fn, mask_fn = _mock_pose_fn, _mock_mask_fn
        if args.use_flux and edit_fn is None:
            edit_fn = lambda img, prompt: img  # noqa: E731
    elif pose_fn is None and args.ckpt_path:
        from ..data.pose2d import Pose2dDriver
        pose_ckpt = os.path.join(args.ckpt_path, "pose2d",
                                 "vitpose_h_wholebody.onnx")
        det_ckpt = os.path.join(args.ckpt_path, "det", "yolov10m.onnx")
        if not os.path.exists(pose_ckpt):
            raise SystemExit(f"missing pose checkpoint: {pose_ckpt} "
                             "(published layout: ckpt_path/pose2d/"
                             "vitpose_h_wholebody.onnx)")
        pose_fn = Pose2dDriver(
            pose_ckpt, det_ckpt if os.path.exists(det_ckpt) else None,
            device=args.device)
        sam_ckpt = os.path.join(args.ckpt_path, "sam2",
                                "sam2_hiera_large.pt")
        if mask_fn is None and os.path.exists(sam_ckpt):
            from ..core.checkpoint import load_sam2_checkpoint
            from ..models.sam2 import build_sam2_mask_fn
            sam, sam_cfg = load_sam2_checkpoint(sam_ckpt,
                                                device=args.device)
            mask_fn = build_sam2_mask_fn(sam, sam_cfg)
    elif pose_fn is None:
        raise SystemExit(
            "no detectors: pass --ckpt_path <dir> with the published "
            "ONNX checkpoints (pose2d/vitpose_h_wholebody.onnx, "
            "det/yolov10m.onnx), run with --mock_detectors for the "
            "hermetic chain, or call main(argv, pose_fn=..., "
            "mask_fn=...) with custom detector callables")

    if args.use_flux and edit_fn is None and args.ckpt_path:
        # the port's FLUX-Kontext editor (pipelines/kontext.py);
        # published layout: ckpt_path/flux/flux1-kontext-dev.safetensors
        # + ae.safetensors + text_encoder(_2)/ + tokenizer(_2)/
        flux_dir = os.path.join(args.ckpt_path, "flux")
        if os.path.exists(os.path.join(flux_dir,
                                       "flux1-kontext-dev.safetensors")):
            from ..pipelines.kontext import make_edit_fn
            edit_fn = make_edit_fn(flux_dir, device=args.device)
    if args.use_flux and edit_fn is None:
        raise SystemExit(
            "--use_flux needs the Kontext editor: put the published "
            "checkpoint under <ckpt_path>/flux/ (flux1-kontext-dev"
            ".safetensors, ae.safetensors, text_encoder/, "
            "text_encoder_2/, tokenizer/, tokenizer_2/), call "
            "main(argv, edit_fn=...), or use --mock_detectors for the "
            "hermetic chain")
    pipe = AnimatePreprocessPipeline(
        pose_fn, mask_fn,
        edit_fn=edit_fn if args.use_flux else None)
    bundle = pipe(frames, refer,
                  resolution_area=tuple(args.resolution_area),
                  replace=args.replace_flag,
                  retarget=args.retarget_flag,
                  iterations=args.iterations, k=args.k,
                  w_len=args.w_len, h_len=args.h_len)
    paths = pipe.save(bundle, args.save_path, fps=int(fps))
    meta = {"paths": paths, "frames": int(bundle["frames"].shape[0]),
            "size": list(bundle["frames"].shape[1:3]),
            "replace": args.replace_flag, "retarget": args.retarget_flag}
    with open(os.path.join(args.save_path, "preprocess_meta.json"),
              "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta), flush=True)
    return meta


if __name__ == "__main__":
    main()
