"""Host-side video IO (a copy of univid_tpu/data/video_io.py): decode
with a decord -> imageio/pyav -> OpenCV fallback chain, the container's
fps through the same chain; save mp4 through imageio (h264) or OpenCV,
images through PIL; mux audio with ffmpeg; and the reference's size and
frame-count rules (best_output_size, smart_resize, smart_nframes)."""

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

def read_video_fps(path: str, default: float = 30.0) -> float:
    """Container average fps (decord get_avg_fps / imageio metadata /
    cv2 CAP_PROP_FPS chain; reference process_pipepline.py:45)."""
    try:
        import decord  # type: ignore
        return float(decord.VideoReader(path).get_avg_fps())
    except Exception:  # noqa: BLE001
        pass
    try:
        import imageio.v3 as iio  # type: ignore
        meta = iio.immeta(path, plugin="pyav")
        fps = float(meta.get("fps", 0.0))
        if fps > 0:
            return fps
    except Exception:  # noqa: BLE001
        pass
    try:
        import cv2  # type: ignore
        cap = cv2.VideoCapture(path)
        fps = float(cap.get(cv2.CAP_PROP_FPS))
        cap.release()
        if fps > 0:
            return fps
    except Exception:  # noqa: BLE001
        pass
    return default


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

def merge_video_audio(video_path: str, audio_path: str, out_path: str):
    """ffmpeg mux (utils/utils.py merge_video_audio role)."""
    import subprocess
    subprocess.run(
        ["ffmpeg", "-y", "-i", video_path, "-i", audio_path, "-c:v",
         "copy", "-c:a", "aac", "-shortest", out_path], check=True,
        capture_output=True)
    return out_path
def best_output_size(w: int, h: int, dw: int, dh: int,
                     expected_area: int):
    """Pick the (width, height) divisible by (dw, dh) closest to the
    input aspect ratio with area <= expected_area (reference
    models/wan/utils/utils.py:202-225, used by inference size
    selection)."""
    ratio = w / h
    ow = (expected_area * ratio) ** 0.5

    ow1 = int(ow // dw * dw)
    oh1 = int(expected_area / ow1 // dh * dh)
    ratio1 = ow1 / oh1

    oh = expected_area / ow
    oh2 = int(oh // dh * dh)
    ow2 = int(expected_area / oh2 // dw * dw)
    ratio2 = ow2 / oh2

    if max(ratio / ratio1, ratio1 / ratio) < max(ratio / ratio2,
                                                 ratio2 / ratio):
        return ow1, oh1
    return ow2, oh2
def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 4 * 28 * 28,
                 max_pixels: int = 16384 * 28 * 28,
                 max_ratio: int = 200):
    """Qwen-VL resize rule (reference utils/qwen_vl_utils.py:54-82):
    dims divisible by `factor`, pixel count in [min, max], aspect kept."""
    import math

    if max(height, width) / min(height, width) > max_ratio:
        raise ValueError(f"aspect ratio above {max_ratio}")

    def rnd(v):
        return round(v / factor) * factor

    h_bar = max(factor, rnd(height))
    w_bar = max(factor, rnd(width))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = int(height / beta // factor) * factor
        w_bar = int(width / beta // factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar
def smart_nframes(ele: dict, total_frames: int, video_fps: float,
                  frame_factor: int = 2, default_fps: float = 2.0,
                  fps_min_frames: int = 4, fps_max_frames: int = 768
                  ) -> int:
    """Frame-count rule for the VL prompt expander (reference
    utils/qwen_vl_utils.py:133-170)."""
    import math

    assert not ("fps" in ele and "nframes" in ele)
    if "nframes" in ele:
        nframes = round(ele["nframes"] / frame_factor) * frame_factor
    else:
        fps = ele.get("fps", default_fps)
        min_frames = math.ceil(
            ele.get("min_frames", fps_min_frames) / frame_factor) \
            * frame_factor
        max_frames = int(ele.get("max_frames",
                                 min(fps_max_frames, total_frames))
                         // frame_factor) * frame_factor
        nframes = total_frames / video_fps * fps
        nframes = min(max(nframes, min_frames), max_frames)
        nframes = round(nframes / frame_factor) * frame_factor
    if not (frame_factor <= nframes <= total_frames):
        raise ValueError(
            f"nframes should be in [{frame_factor}, {total_frames}], "
            f"got {nframes}")
    return int(nframes)
