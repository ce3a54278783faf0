"""Host-side video IO (copy of read_video_frames,
sample_video_frames_uniform, save_video and save_image from
univid_tpu/data/video_io.py): decode with a decord -> imageio/pyav ->
OpenCV fallback chain; save mp4 through imageio (h264) or OpenCV, images
through PIL."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _sample_indices(n: int, k: int) -> List[int]:
    """k near-uniform indices over [0, n) (eval_understanding sampling)."""
    if n <= 0:
        return []
    if k >= n:
        return list(range(n))
    return [int(round(i * (n - 1) / (k - 1))) for i in range(k)] if k > 1 \
        else [n // 2]


def read_video_frames(path: str, num_frames: Optional[int] = None
                      ) -> List[np.ndarray]:
    """Decode frames (RGB uint8 [H, W, 3]); fallback chain decord ->
    imageio/pyav -> OpenCV."""
    errors = []
    try:
        import decord  # type: ignore
        vr = decord.VideoReader(path)
        n = len(vr)
        idx = _sample_indices(n, num_frames) if num_frames else range(n)
        return [vr[i].asnumpy() for i in idx]
    except Exception as e:  # noqa: BLE001
        errors.append(f"decord: {e}")
    try:
        import imageio.v3 as iio  # type: ignore
        frames = iio.imread(path, plugin="pyav")
        n = len(frames)
        idx = _sample_indices(n, num_frames) if num_frames else range(n)
        return [np.asarray(frames[i]) for i in idx]
    except Exception as e:  # noqa: BLE001
        errors.append(f"imageio: {e}")
    try:
        import cv2  # type: ignore
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if frames:
            idx = _sample_indices(len(frames), num_frames) \
                if num_frames else range(len(frames))
            return [frames[i] for i in idx]
        errors.append("cv2: zero frames")
    except Exception as e:  # noqa: BLE001
        errors.append(f"cv2: {e}")
    raise RuntimeError(f"all video decoders failed for {path}: {errors}")


def sample_video_frames_uniform(path: str, num_frames: int = 64
                                ) -> List[np.ndarray]:
    return read_video_frames(path, num_frames=num_frames)


def save_video(frames: np.ndarray, path: str, fps: int = 24,
               quality: int = 8) -> str:
    """frames [T, H, W, 3] float in [-1,1] or uint8 -> mp4 (imageio h264,
    utils/utils.py:90-121 role)."""
    arr = np.asarray(frames)
    if arr.dtype != np.uint8:
        arr = ((np.clip(arr, -1, 1) + 1) * 127.5).round().astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import imageio  # type: ignore
        writer = imageio.get_writer(path, fps=fps, codec="libx264",
                                    quality=quality)
        for f in arr:
            writer.append_data(f)
        writer.close()
        return path
    except Exception:  # noqa: BLE001
        pass
    try:
        import cv2  # type: ignore
        h, w = arr.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        for f in arr:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return path
    except Exception:  # noqa: BLE001
        pass
    # last resort: raw npz next to the requested path
    alt = path + ".npz"
    np.savez_compressed(alt, video=arr, fps=fps)
    return alt


def save_image(image: np.ndarray, path: str) -> str:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        from PIL import Image  # type: ignore
        Image.fromarray(arr).save(path)
        return path
    except Exception:  # noqa: BLE001
        np.savez_compressed(path + ".npz", image=arr)
        return path + ".npz"
