"""ONNX pose/person-detection drivers for animate preprocessing.

Behavioral port of the reference's detector stage
(models/wan/utils/modules/animate/preprocess/pose2d.py:20-428 and
pose2d_utils.py): a YOLO person detector picks the primary subject box,
ViTPose wholebody regresses 133 COCO-wholebody keypoints from heatmaps
(DARK 'unbiased' decode, pose2d_utils.py:790-938), and the 133-point
set is split into the 20-joint openpose-convention body + hands + face
groups (split_kp2ds_for_aa, pose2d_utils.py:1102-1109) that the
preprocess chain consumes as `PoseMeta`.

Counterpart of univid_tpu/data/pose2d.py. The graphs run on the port's
torch ONNX executor (data/onnx_rt.py) on `device` ("cuda" unless the
caller asks for the CPU), so the published `end2end.onnx` checkpoints
work without an onnxruntime binary; pass any ort-compatible session
factory via `session_factory` to use another runtime. Crops, the YOLO
postprocess and the heatmap decode stay numpy on the host, as in the
JAX package: only the graphs run on the device.

The entry point `Pose2dDriver` satisfies the preprocess pipeline's
injection contract: pose_fn(frames u8 [T, H, W, 3]) -> List[PoseMeta]
(data/animate_preprocess.py:538-548).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from .animate_preprocess import PoseMeta
from .onnx_rt import OnnxSession, nms_indices

_IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _session(factory: Optional[Callable], device) -> Callable:
    """The session factory: the caller's, else OnnxSession on `device`."""
    if factory is not None:
        return factory
    return lambda path: OnnxSession(path, device=device)


def _resolve(path: str) -> str:
    """Accept a directory holding end2end.onnx (reference layout,
    pose2d.py:33-34) or a direct .onnx path."""
    if os.path.isdir(path):
        return os.path.join(path, "end2end.onnx")
    return path


# ---------------------------------------------------------------------------
# YOLO person detector
# ---------------------------------------------------------------------------


class YoloDetector:
    """Person detection -> primary-subject xyxy box.

    Postprocess parity with pose2d.py Yolo: supports both the
    end-to-end [N, 6] (xyxy+score+class) output layout and the raw
    [84, N] xywh+class-scores layout, confidence threshold 0.05, NMS
    IoU 0.5, and largest-box subject selection guarded by the
    bbox-shape ratio rule (process_results, pose2d.py:208-268).
    """

    def __init__(self, checkpoint: str, *, threshold_conf: float = 0.05,
                 threshold_iou: float = 0.5,
                 threshold_bbox_shape_ratio: float = 0.4,
                 input_resolution: Tuple[int, int] = (640, 640),
                 person_class: int = 0,
                 session_factory: Optional[Callable] = None,
                 device="cuda"):
        self.sess = _session(session_factory, device)(_resolve(checkpoint))
        self.input_name = self.sess.get_inputs()[0].name
        self.threshold_conf = threshold_conf
        self.threshold_iou = threshold_iou
        self.shape_ratio = threshold_bbox_shape_ratio
        self.res = input_resolution
        self.person_class = person_class

    def _preprocess(self, img: np.ndarray) -> np.ndarray:
        """u8 [H, W, 3] -> f32 [1, 3, ih, iw] in [0, 1] (plain resize,
        matching Yolo.preprocess pose2d.py:90-108 — no letterboxing)."""
        ih, iw = self.res
        ys = (np.arange(ih) + 0.5) * img.shape[0] / ih - 0.5
        xs = (np.arange(iw) + 0.5) * img.shape[1] / iw - 0.5
        yi = np.clip(np.round(ys), 0, img.shape[0] - 1).astype(np.int64)
        xi = np.clip(np.round(xs), 0, img.shape[1] - 1).astype(np.int64)
        small = img[yi[:, None], xi[None, :]].astype(np.float32) / 255.0
        return small.transpose(2, 0, 1)[None]

    def _decode(self, out: np.ndarray, h: int, w: int) -> np.ndarray:
        """-> [K, 6] rows (x1, y1, x2, y2, score, class), NMS applied."""
        out = np.squeeze(np.asarray(out))
        if out.ndim == 1:
            out = out[None]
        if out.shape[-1] != 6 and out.shape[0] in (84, 56):
            out = out.T
        xf = w / self.res[1]
        yf = h / self.res[0]
        if out.shape[-1] == 6:  # end-to-end export: xyxy, score, class
            scores = out[:, 4]
            m = scores >= self.threshold_conf
            boxes = out[m, :4].copy()
            scores = scores[m]
            cls = out[m, 5]
            boxes[:, [0, 2]] *= xf
            boxes[:, [1, 3]] *= yf
            xywh = np.stack([boxes[:, 0], boxes[:, 1],
                             boxes[:, 2] - boxes[:, 0],
                             boxes[:, 3] - boxes[:, 1]], axis=1)
        else:  # raw head: cx, cy, w, h, per-class scores
            cls_scores = out[:, 4:]
            scores = cls_scores.max(axis=-1)
            m = scores >= self.threshold_conf
            cls = cls_scores[m].argmax(axis=-1)
            scores = scores[m]
            xywh_raw = out[m, :4]
            xywh = np.stack([
                (xywh_raw[:, 0] - xywh_raw[:, 2] / 2) * xf,
                (xywh_raw[:, 1] - xywh_raw[:, 3] / 2) * yf,
                xywh_raw[:, 2] * xf, xywh_raw[:, 3] * yf], axis=1)
        xywh = xywh.astype(np.int32).astype(np.float64)
        keep = nms_indices(xywh, scores, self.threshold_conf,
                           self.threshold_iou)
        rows = []
        for i in keep:
            x, y, bw, bh = xywh[i]
            rows.append([x, y, x + bw, y + bh, scores[i], cls[i]])
        return np.asarray(rows, np.float64).reshape(-1, 6)

    def _select(self, dets: np.ndarray) -> Optional[np.ndarray]:
        """Largest person box, skipping boxes whose max side is below
        shape_ratio x the overall max side (pose2d.py:208-245)."""
        person = dets[(dets[:, 5] == self.person_class)
                      & (dets[:, 4] > self.threshold_conf)]
        if not len(person):
            return None
        shapes = np.maximum(person[:, 2] - person[:, 0],
                            person[:, 3] - person[:, 1])
        max_shape = shapes.max()
        best, best_size = None, -np.inf
        for row, shp in zip(person, shapes):
            size = (row[2] - row[0]) * (row[3] - row[1])
            if size > best_size:
                if shp < max_shape * self.shape_ratio:
                    continue
                best, best_size = row, size
        return best[:5] if best is not None else None

    def __call__(self, img: np.ndarray) -> Optional[np.ndarray]:
        """u8 [H, W, 3] -> [5] (x1, y1, x2, y2, score) or None."""
        h, w = img.shape[:2]
        (out,) = self.sess.run(None, {self.input_name:
                                      self._preprocess(img)})
        dets = self._decode(out, h, w)
        return self._select(dets) if len(dets) else None


# ---------------------------------------------------------------------------
# ViTPose wholebody keypoints
# ---------------------------------------------------------------------------


def _box_to_center_scale(bbox_xyxy, input_resolution: Tuple[int, int],
                         rescale: float = 1.25):
    """bbox -> (center, scale/200) with aspect-snap to the crop
    resolution (bbox_from_detector, pose2d_utils.py:1044-1067)."""
    res_h, res_w = input_resolution
    aspect = res_h / float(res_w)
    cx = (bbox_xyxy[0] + bbox_xyxy[2]) / 2.0
    cy = (bbox_xyxy[1] + bbox_xyxy[3]) / 2.0
    bw = bbox_xyxy[2] - bbox_xyxy[0]
    bh = bbox_xyxy[3] - bbox_xyxy[1]
    size = max(bw * aspect, bh)
    scale = np.array([size / aspect, size]) / 200.0 * rescale
    return np.array([cx, cy]), scale


def _crop(img: np.ndarray, center, scale, res: Tuple[int, int]
          ) -> np.ndarray:
    """Crop + resize to res (rows, cols) around center at scale*200 px,
    zero-padded outside the image (crop, pose2d_utils.py:1069-1099).
    The crop box uses max(scale) on both axes like the reference."""
    h200 = 200.0 * max(scale)
    res_h, res_w = res
    # corners come from the inverse get_transform affine
    # (pose2d_utils.py:1004-1041): dst (0, 0) maps to
    # center - box/2, dst (res_w, res_h) to center + box/2, each
    # rounded independently like the reference's transform()
    w_box = h200 * res_w / float(res_h)
    ul_x = int(round(center[0] - w_box / 2.0))
    ul_y = int(round(center[1] - h200 / 2.0))
    br_x = int(round(center[0] + w_box / 2.0))
    br_y = int(round(center[1] + h200 / 2.0))
    out = np.zeros((br_y - ul_y, br_x - ul_x, img.shape[2]), np.float32)
    sy0, sy1 = max(0, ul_y), min(img.shape[0], br_y)
    sx0, sx1 = max(0, ul_x), min(img.shape[1], br_x)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 - ul_y: sy1 - ul_y, sx0 - ul_x: sx1 - ul_x] = \
            img[sy0: sy1, sx0: sx1]
    # bilinear resize to (res_h, res_w)
    yy = (np.arange(res_h) + 0.5) * out.shape[0] / res_h - 0.5
    xx = (np.arange(res_w) + 0.5) * out.shape[1] / res_w - 0.5
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, out.shape[0] - 1)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, out.shape[1] - 1)
    y1 = np.clip(y0 + 1, 0, out.shape[0] - 1)
    x1 = np.clip(x0 + 1, 0, out.shape[1] - 1)
    wy = np.clip(yy - y0, 0, 1)[:, None, None]
    wx = np.clip(xx - x0, 0, 1)[None, :, None]
    res_img = (out[y0[:, None], x0[None, :]] * (1 - wy) * (1 - wx)
               + out[y0[:, None], x1[None, :]] * (1 - wy) * wx
               + out[y1[:, None], x0[None, :]] * wy * (1 - wx)
               + out[y1[:, None], x1[None, :]] * wy * wx)
    return res_img


def _gaussian_blur_heatmaps(hm: np.ndarray, kernel: int) -> np.ndarray:
    """Per-map Gaussian modulation preserving the original max
    (_gaussian_blur, pose2d_utils.py:715-755)."""
    border = (kernel - 1) // 2
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    r = np.arange(kernel) - border
    g1 = np.exp(-(r ** 2) / (2 * sigma * sigma))
    g1 /= g1.sum()
    k, h, w = hm.shape
    out = np.empty_like(hm)
    for i in range(k):
        m = hm[i]
        omax = m.max()
        pad = np.zeros((h + 2 * border, w + 2 * border), np.float32)
        pad[border: border + h, border: border + w] = m
        pad = np.apply_along_axis(
            lambda row: np.convolve(row, g1, mode="same"), 1, pad)
        pad = np.apply_along_axis(
            lambda col: np.convolve(col, g1, mode="same"), 0, pad)
        m2 = pad[border: border + h, border: border + w]
        mmax = m2.max()
        out[i] = m2 * (omax / mmax) if mmax > 0 else m2
    return out


def _taylor_refine(log_hm: np.ndarray, coord: np.ndarray) -> np.ndarray:
    """DARK second-order Taylor offset on the log-heatmap
    (_taylor, pose2d_utils.py:614-648)."""
    h, w = log_hm.shape
    px, py = int(coord[0]), int(coord[1])
    if not (1 < px < w - 2 and 1 < py < h - 2):
        return coord
    dx = 0.5 * (log_hm[py, px + 1] - log_hm[py, px - 1])
    dy = 0.5 * (log_hm[py + 1, px] - log_hm[py - 1, px])
    dxx = 0.25 * (log_hm[py, px + 2] - 2 * log_hm[py, px]
                  + log_hm[py, px - 2])
    dxy = 0.25 * (log_hm[py + 1, px + 1] - log_hm[py - 1, px + 1]
                  - log_hm[py + 1, px - 1] + log_hm[py - 1, px - 1])
    dyy = 0.25 * (log_hm[py + 2, px] - 2 * log_hm[py, px]
                  + log_hm[py - 2, px])
    det = dxx * dyy - dxy * dxy
    if det == 0:
        return coord
    inv = np.array([[dyy, -dxy], [-dxy, dxx]]) / det
    offset = -inv @ np.array([dx, dy])
    return coord + offset


def decode_heatmaps(heatmaps: np.ndarray, center: np.ndarray,
                    scale: np.ndarray, *, unbiased: bool = True,
                    kernel: int = 11
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """[K, H, W] heatmaps -> ([K, 2] image-space coords, [K, 1] scores).

    DARK 'unbiased' decode (keypoints_from_heatmaps unbiased=True,
    pose2d_utils.py:905-913): argmax, Gaussian modulation, log-domain
    Taylor refinement, then the center/scale affine back to the image
    (transform_preds, pose2d_utils.py:279-325). `scale` is in PIXELS
    (the caller passes scale*200 like ViTPose.forward pose2d.py:317)."""
    k, h, w = heatmaps.shape
    flat = heatmaps.reshape(k, -1)
    idx = flat.argmax(axis=1)
    maxvals = flat.max(axis=1, keepdims=True)
    preds = np.stack([idx % w, idx // w], axis=1).astype(np.float64)
    preds[maxvals[:, 0] <= 0] = -1
    if unbiased:
        log_hm = np.log(np.maximum(
            _gaussian_blur_heatmaps(heatmaps.astype(np.float32), kernel),
            1e-10))
        for i in range(k):
            preds[i] = _taylor_refine(log_hm[i], preds[i])
    out = np.empty_like(preds)
    out[:, 0] = preds[:, 0] * (scale[0] / w) + center[0] - scale[0] * 0.5
    out[:, 1] = preds[:, 1] * (scale[1] / h) + center[1] - scale[1] * 0.5
    return out, maxvals


class ViTPoseEstimator:
    """Wholebody 133-keypoint regressor from the end2end.onnx export."""

    def __init__(self, checkpoint: str, *,
                 input_resolution: Tuple[int, int] = (256, 192),
                 rescale: float = 1.25,
                 session_factory: Optional[Callable] = None,
                 device="cuda"):
        self.sess = _session(session_factory, device)(_resolve(checkpoint))
        self.input_name = self.sess.get_inputs()[0].name
        shape = self.sess.get_inputs()[0].shape
        if shape and len(shape) == 4 and isinstance(shape[2], int):
            input_resolution = (shape[2], shape[3])
        self.res = input_resolution
        self.rescale = rescale

    def __call__(self, img: np.ndarray,
                 bbox_xyxy: Optional[np.ndarray]) -> np.ndarray:
        """u8 [H, W, 3] + optional person box -> [133, 3] (x, y, conf)
        keypoints in image pixels."""
        if bbox_xyxy is None or (len(bbox_xyxy) > 4
                                 and bbox_xyxy[4] <= 0) \
                or (bbox_xyxy[2] - bbox_xyxy[0]) < 10 \
                or (bbox_xyxy[3] - bbox_xyxy[1]) < 10:
            bbox_xyxy = np.array([0, 0, img.shape[1], img.shape[0]],
                                 np.float64)
        center, scale = _box_to_center_scale(bbox_xyxy, self.res,
                                             self.rescale)
        crop = _crop(img.astype(np.float32), center, scale, self.res)
        x = ((crop / 255.0 - _IMG_MEAN) / _IMG_STD).transpose(2, 0, 1)
        (hm,) = self.sess.run(None,
                              {self.input_name:
                               x[None].astype(np.float32)})
        pts, prob = decode_heatmaps(np.asarray(hm)[0], center,
                                    scale * 200.0, unbiased=True)
        return np.concatenate([pts, prob], axis=1)


# ---------------------------------------------------------------------------
# 133-keypoint split -> PoseMeta
# ---------------------------------------------------------------------------

# the 20-joint openpose-convention body is averaged pairs of COCO
# wholebody indices (split_kp2ds_for_aa, pose2d_utils.py:1102-1103)
_BODY_IDX_A = [0, 6, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1,
               4, 3, 17, 20]
_BODY_IDX_B = [0, 5, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1,
               4, 3, 18, 21]


def wholebody_to_pose_meta(kp133: np.ndarray) -> PoseMeta:
    """[133, 3] pixel-space wholebody keypoints -> PoseMeta groups."""
    body = (kp133[_BODY_IDX_A] + kp133[_BODY_IDX_B]) / 2.0
    return PoseMeta(body=body.astype(np.float32),
                    lhand=kp133[91:112].astype(np.float32),
                    rhand=kp133[112:133].astype(np.float32),
                    face=kp133[22:91].astype(np.float32))


class Pose2dDriver:
    """pose_fn-contract driver: YOLO subject box -> ViTPose keypoints
    -> PoseMeta per frame (Pose2d.__call__, pose2d.py:349-428)."""

    def __init__(self, pose_checkpoint: str,
                 detector_checkpoint: Optional[str] = None, *,
                 session_factory: Optional[Callable] = None,
                 device="cuda"):
        self.detector = (YoloDetector(detector_checkpoint,
                                      session_factory=session_factory,
                                      device=device)
                         if detector_checkpoint else None)
        self.estimator = ViTPoseEstimator(
            pose_checkpoint, session_factory=session_factory, device=device)

    def __call__(self, frames: np.ndarray) -> List[PoseMeta]:
        metas: List[PoseMeta] = []
        for frame in frames:
            bbox = self.detector(frame) if self.detector else None
            kp = self.estimator(frame, bbox)
            metas.append(wholebody_to_pose_meta(kp))
        return metas
