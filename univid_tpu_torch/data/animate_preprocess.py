"""WanAnimate host-side preprocessing (deterministic chain): a copy of
univid_tpu/data/animate_preprocess.py, numpy, scipy and cv2 on the host
as there.

Behavioral parity with reference models/wan/utils/modules/animate/
preprocess/: frame selection + area resize (utils.py:96-200), padding
resize (utils.py:160-188), face-crop bboxes from face keypoints
(utils.py:199-225), replacement-mode mask dilation + grid augmentation
(utils.py:8-49), the openpose-convention conditioning render
(human_visualization.py:750-905), and a bone-ratio pose retarget
(simplified from retarget_pose.py:309-368 rescale_skeleton).

The neural detectors (ViTPose wholebody and YOLO person detection,
data/pose2d.py over the torch ONNX executor; the SAM2 video segmenter,
models/sam2; the FLUX Kontext editor, pipelines/kontext.py) are injected
as callables (`pose_fn`, `mask_fn`, `edit_fn`). Everything after
detection, the data contract `--mode animate` reads (src_ref.png /
src_pose.mp4 / src_face.mp4 / src_bg.mp4 + src_mask.mp4,
process_pipepline.py:113-160), is produced here.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# frame selection + resizing (utils.py)
# ---------------------------------------------------------------------------


def get_frame_indices(frame_num: int, video_fps: float, clip_length: int,
                      target_fps: float) -> List[int]:
    """Time-uniform resample of a video to clip_length frames at
    target_fps (utils.py:191-198)."""
    times = np.arange(0, clip_length) / target_fps
    idx = np.round(times * video_fps).astype(int)
    return np.clip(idx, 0, frame_num - 1).tolist()


def fit_area_size(orig_w: int, orig_h: int, target_area: int,
                  divisor: int = 64) -> Tuple[int, int]:
    """Largest divisor-aligned (w, h) with w*h <= target_area, tie-broken
    by aspect-ratio fidelity (utils.py calculate_new_size:89-131)."""
    ratio = orig_w / orig_h
    best = None
    max_h = divisor * ((int(math.sqrt(target_area / ratio))
                        + divisor - 1) // divisor)
    for h in range(divisor, max_h + divisor, divisor):
        ideal_w = h * ratio
        for w in (divisor * (int(ideal_w) // divisor),
                  divisor * ((int(ideal_w) + divisor - 1) // divisor)):
            if w <= 0 or w * h > target_area:
                continue
            cand = (-w * h, abs(w / h - ratio), w, h)
            if best is None or cand < best:
                best = cand
    if best is None:
        # fallback: floor-aligned sqrt split (utils.py:141-152)
        h = math.sqrt(target_area / ratio)
        w = target_area / h
        return (int(w // divisor) * divisor, int(h // divisor) * divisor)
    return best[2], best[3]


def padding_resize(img: np.ndarray, height: int, width: int,
                   padding_color: Tuple[int, int, int] = (0, 0, 0)
                   ) -> np.ndarray:
    """Aspect-preserving resize onto a (height, width) canvas with
    centered padding (utils.py:160-188)."""
    from ..native import resize_bilinear
    oh, ow = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    img = img.reshape(oh, ow, c)
    canvas = np.empty((height, width, c), np.float32)
    canvas[:] = np.asarray(padding_color[:c], np.float32)
    if oh / ow > height / width:
        nw = int(height / oh * ow)
        resized = resize_bilinear(img, height, nw)
        pad = (width - nw) // 2
        canvas[:, pad:pad + nw] = resized
    else:
        nh = int(width / ow * oh)
        resized = resize_bilinear(img, nh, width)
        pad = (height - nh) // 2
        canvas[pad:pad + nh] = resized
    return np.uint8(np.clip(canvas, 0, 255))


def resize_by_area(img: np.ndarray, target_area: int,
                   divisor: int = 64) -> np.ndarray:
    """Resize to the best divisor-aligned size of ~target_area
    (utils.py:135-157)."""
    h, w = img.shape[:2]
    nw, nh = fit_area_size(w, h, target_area, divisor)
    return padding_resize(img, nh, nw)


# ---------------------------------------------------------------------------
# face crops (utils.py get_face_bboxes:199-225)
# ---------------------------------------------------------------------------


def face_bbox_from_kps(kps_face: np.ndarray, scale: float,
                       image_shape: Tuple[int, int],
                       normalized: bool = True
                       ) -> Tuple[int, int, int, int]:
    """(x1, x2, y1, y2): face keypoint bbox expanded to `scale`x area,
    with the upward expansion 3x the downward one (faces extend above
    the detected landmarks). kps_face: [N, 2]."""
    h, w = image_shape
    kp = np.asarray(kps_face, np.float32)[:, :2]
    if normalized:
        kp = kp[1:] * np.asarray([w, h], np.float32)
    mn, mx = kp.min(axis=0), kp.max(axis=0)
    iw, ih = mx - mn
    # degenerate landmark boxes (coincident/collinear keypoints from a
    # failed detection) would divide by zero below — fall back to a
    # minimal square so the crop stays valid
    iw = max(float(iw), 1.0)
    ih = max(float(ih), 1.0)
    area = iw * ih * scale
    nw = math.sqrt(area * (iw / ih))
    nh = math.sqrt(area * (ih / iw))
    dw = (nw - iw) / 2
    dh = (nh - ih) / 4
    return (int(max(mn[0] - dw, 0)), int(min(mx[0] + dw, w)),
            int(max(mn[1] - 3 * dh, 0)), int(min(mx[1] + dh, h)))


def crop_face(frame: np.ndarray, kps_face: np.ndarray, scale: float = 1.3,
              out_size: int = 512, normalized: bool = True) -> np.ndarray:
    from ..native import resize_bilinear
    x1, x2, y1, y2 = face_bbox_from_kps(kps_face, scale, frame.shape[:2],
                                        normalized=normalized)
    crop = frame[y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)]
    return np.uint8(np.clip(
        resize_bilinear(crop.astype(np.float32), out_size, out_size),
        0, 255))


# ---------------------------------------------------------------------------
# replacement-mode masks (utils.py:8-49)
# ---------------------------------------------------------------------------


def mask_bbox(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    return np.asarray([xs.min(), ys.min(), xs.max(), ys.max()], np.int32)


def dilate_mask(mask: np.ndarray, k: int = 7,
                iterations: int = 3) -> np.ndarray:
    """Binary dilation with a k x k kernel (utils.py:44-49)."""
    from scipy.ndimage import binary_dilation
    out = binary_dilation(mask.astype(bool),
                          structure=np.ones((k, k), bool),
                          iterations=iterations)
    return out.astype(mask.dtype)


def grid_quantize_mask(mask: np.ndarray, w_len: int = 1,
                       h_len: int = 1) -> np.ndarray:
    """Snap the mask outward to a w_len x h_len grid over its bbox: any
    grid cell touching the mask becomes fully masked (utils.py
    get_aug_mask:25-42 — the coarse contour of arXiv:2502.06145)."""
    mask = mask.copy()
    if not mask.any():
        return mask  # no foreground this frame (occluded/out of view)
    x0, y0, x1, y1 = mask_bbox(mask)
    ws = max((x1 - x0) // w_len, 1)
    hs = max((y1 - y0) // h_len, 1)
    for wx in range(x0, x1, ws):
        we = min(wx + ws, x1)
        for hy in range(y0, y1, hs):
            he = min(hy + hs, y1)
            if mask[hy:he, wx:we].sum() > 0:
                mask[hy:he, wx:we] = 1
    return mask


def composite_background(frame: np.ndarray,
                         mask: np.ndarray) -> np.ndarray:
    """Zero the masked (foreground) region (process_pipepline.py:144)."""
    return np.uint8(frame * (1 - mask[:, :, None]))


# ---------------------------------------------------------------------------
# pose conditioning render (openpose conventions,
# human_visualization.py:750-905)
# ---------------------------------------------------------------------------

# 20-keypoint body order: Nose Neck RShoulder RElbow RWrist LShoulder
# LElbow LWrist RHip RKnee RAnkle LHip LKnee LAnkle REye LEye REar LEar
# LToe RToe. Limb sequence + palette are the public openpose drawing
# constants the checkpoint was trained against (protocol data).
POSE_LIMBS = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8),
              (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 0),
              (0, 14), (14, 16), (0, 15), (15, 17), (13, 18), (10, 19)]
POSE_COLORS = [(255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
               (170, 255, 0), (85, 255, 0), (0, 255, 0), (0, 255, 85),
               (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255),
               (0, 0, 255), (85, 0, 255), (170, 0, 255), (255, 0, 255),
               (255, 0, 170), (255, 0, 85), (200, 200, 0), (100, 100, 0)]

HAND_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7),
              (7, 8), (0, 9), (9, 10), (10, 11), (11, 12), (0, 13),
              (13, 14), (14, 15), (15, 16), (0, 17), (17, 18), (18, 19),
              (19, 20)]

# 68-landmark (+2 eyeballs) face drawing style: per-part polylines and
# eyeball dots. Protocol constants matching the checkpoint's rendering
# convention (human_visualization.py FACE_CUSTOM_STYLE:1136-1145).
FACE_STYLE = {
    "eyeball": {"indexs": [68, 69], "color": (255, 255, 255),
                "connect": False},
    "left_eyebrow": {"indexs": [17, 18, 19, 20, 21], "color": (0, 255, 0)},
    "right_eyebrow": {"indexs": [22, 23, 24, 25, 26],
                      "color": (0, 0, 255)},
    "left_eye": {"indexs": [36, 37, 38, 39, 40, 41],
                 "color": (255, 255, 0), "close": True},
    "right_eye": {"indexs": [42, 43, 44, 45, 46, 47],
                  "color": (255, 0, 255), "close": True},
    "mouth_outside": {"indexs": list(range(48, 60)),
                      "color": (100, 255, 50), "close": True},
    "mouth_inside": {"indexs": [60, 61, 62, 63, 64, 65, 66, 67],
                     "color": (255, 100, 50), "close": True},
}


def draw_face_keypoints(img: np.ndarray, kps: np.ndarray,
                        thickness: int = 2,
                        style: Dict = FACE_STYLE) -> np.ndarray:
    """Render 68/70-point face landmarks: polylines per facial part,
    filled dots for parts marked connect=False (eyeballs). kps: [F, 2+]
    pixel coords. Reference: human_visualization.py draw_face_kp
    (:1147-1165)."""
    import cv2
    img = img.copy()
    n = kps.shape[0]
    for item in style.values():
        idx = [i for i in item["indexs"] if i < n]
        if not idx:
            continue
        pts = np.asarray(kps[idx][:, :2]).astype(np.int32)
        if item.get("connect", True):
            cv2.polylines(img, [pts], item.get("close", False),
                          item["color"], thickness=thickness)
        else:
            for kp in pts:
                cv2.circle(img, (int(kp[0]), int(kp[1])), thickness * 2,
                           item["color"], thickness=-1)
    return img


def draw_pose(canvas: np.ndarray, kps_body: np.ndarray,
              kps_lhand: Optional[np.ndarray] = None,
              kps_rhand: Optional[np.ndarray] = None,
              threshold: float = 0.6,
              kps_face: Optional[np.ndarray] = None,
              draw_head: bool = True) -> np.ndarray:
    """Render an openpose-style conditioning image: limbs as filled
    ellipses at 0.6 brightness, joints as circles, hands as white-ish
    edges, optional 68-pt face-landmark polylines (draw_face_keypoints).
    kps_*: [N, 3] (x_px, y_px, confidence). draw_head=False suppresses
    the head body points (nose/eyes/ears), as in reference
    draw_aapose_new (human_visualization.py:799-801)."""
    import cv2
    img = canvas.copy()
    h, w = img.shape[:2]
    stick = max(int(min(h, w) / 200) - 1, 1)
    if not draw_head:
        kps_body = kps_body.copy()
        kps_body[[0, 14, 15, 16, 17], 2] = 0.0
    for (a, b), color in zip(POSE_LIMBS, POSE_COLORS):
        k1, k2 = kps_body[a], kps_body[b]
        if k1[2] < threshold or k2[2] < threshold:
            continue
        mx, my = (k1[0] + k2[0]) / 2, (k1[1] + k2[1]) / 2
        length = math.hypot(k1[0] - k2[0], k1[1] - k2[1])
        angle = math.degrees(math.atan2(k1[1] - k2[1], k1[0] - k2[0]))
        poly = cv2.ellipse2Poly((int(mx), int(my)),
                                (int(length / 2), stick), int(angle),
                                0, 360, 1)
        cv2.fillConvexPoly(img, poly, [int(c * 0.6) for c in color])
    for kp, color in zip(kps_body, POSE_COLORS):
        if kp[2] >= threshold:
            cv2.circle(img, (int(kp[0]), int(kp[1])), stick, color, -1)
    for hand in (kps_lhand, kps_rhand):
        if hand is None:
            continue
        for i, (a, b) in enumerate(HAND_EDGES):
            if hand[a][2] < threshold or hand[b][2] < threshold:
                continue
            cv2.line(img, (int(hand[a][0]), int(hand[a][1])),
                     (int(hand[b][0]), int(hand[b][1])),
                     POSE_COLORS[i % len(POSE_COLORS)], stick)
    if kps_face is not None:
        # landmark indices are positional (FACE_STYLE parts), so no
        # per-point confidence filter — matches reference draw_face_kp
        # which takes [70, 2] coords without scores
        img = draw_face_keypoints(img, kps_face, thickness=max(stick, 1))
    return img


# ---------------------------------------------------------------------------
# pose retarget (simplified rescale_skeleton, retarget_pose.py:309-368)
# ---------------------------------------------------------------------------

# child keypoint -> parent along POSE_LIMBS, rooted at the neck (1)
_PARENT = {c: p for p, c in
           [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8),
            (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 0),
            (0, 14), (14, 16), (0, 15), (15, 17), (13, 18), (10, 19)]}
_TOPO = [2, 5, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 0, 14, 16, 15, 17,
         18, 19]


def bone_ratios(src_body: np.ndarray, ref_body: np.ndarray,
                threshold: float = 0.4) -> Dict[int, float]:
    """Per-bone length ratio ref/src keyed by child keypoint; bones with
    a low-confidence endpoint fall back to the median visible ratio."""
    ratios: Dict[int, float] = {}
    seen: List[float] = []
    for child in _TOPO:
        p = _PARENT[child]
        ok = (src_body[child, 2] >= threshold
              and src_body[p, 2] >= threshold
              and ref_body[child, 2] >= threshold
              and ref_body[p, 2] >= threshold)
        if ok:
            ls = np.linalg.norm(src_body[child, :2] - src_body[p, :2])
            lr = np.linalg.norm(ref_body[child, :2] - ref_body[p, :2])
            if ls > 1e-6:
                ratios[child] = float(lr / ls)
                seen.append(ratios[child])
    fallback = float(np.median(seen)) if seen else 1.0
    for child in _TOPO:
        ratios.setdefault(child, fallback)
    return ratios


def retarget_body(body: np.ndarray, ratios: Dict[int, float],
                  anchor: Optional[np.ndarray] = None) -> np.ndarray:
    """Re-chain the driving skeleton with the reference character's bone
    lengths: each child keypoint keeps the driving bone DIRECTION but
    takes ref_len = src_len * ratio, walking the tree from the neck.
    `anchor` pins the neck (defaults to the driving neck position).

    Foot bones (toes 18/19) are clamped so the retargeted foot length
    stays within 0.5x the retargeted calf length — reference
    foot_lower_leg_ratio rule (retarget_pose.py:197-206)."""
    out = body.copy()
    out[1, :2] = body[1, :2] if anchor is None else anchor
    ratios = dict(ratios)
    for toe, ankle in ((18, 13), (19, 10)):  # LToe<-LAnkle, RToe<-RAnkle
        calf_new = (np.linalg.norm(body[ankle, :2]
                                   - body[_PARENT[ankle], :2])
                    * ratios[ankle])
        foot_src = np.linalg.norm(body[toe, :2] - body[_PARENT[toe], :2])
        if foot_src > 1e-6 and foot_src * ratios[toe] > 0.5 * calf_new:
            ratios[toe] = 0.5 * calf_new / foot_src
    for child in _TOPO:
        p = _PARENT[child]
        vec = body[child, :2] - body[p, :2]
        out[child, :2] = out[p, :2] + vec * ratios[child]
    return out


def retarget_hand(hand: np.ndarray, wrist_new: np.ndarray,
                  ratio: float) -> np.ndarray:
    """Retarget one 21-point hand to follow its rescaled wrist: scale
    the hand about its root (keypoint 0) by the body's shoulder-bone
    ratio, then translate so the root lands exactly on the retargeted
    wrist. Reference mechanism: deal_hand_keypoints scales about the
    root (retarget_pose.py:106-156), get_handpose_meta applies the
    wrist delta + root-to-wrist snap (:80-103, :268-289) — net effect
    is root -> rescaled wrist, hand scaled by
    max(shoulder bone ratios) (:249-251)."""
    out = hand.copy()
    root = hand[0, :2]
    out[:, :2] = (hand[:, :2] - root) * ratio + wrist_new
    return out


def retarget_hands(lhand: Optional[np.ndarray],
                   rhand: Optional[np.ndarray],
                   old_body: np.ndarray, new_body: np.ndarray,
                   ratios: Dict[int, float], threshold: float = 0.4
                   ) -> Tuple[Optional[np.ndarray],
                              Optional[np.ndarray]]:
    """Both hands retargeted onto the rescaled wrists (LWrist=7,
    RWrist=4 in the 20-kp order). If the detected left-hand root sits
    closer to the DRIVING right wrist than the left one, the hands are
    swapped first — the reference's crossed-arms guard
    (retarget_pose.py:280-289, distances measured in driving space)."""
    ratio = max(ratios.get(2, 1.0), ratios.get(5, 1.0))
    lw, rw = new_body[7, :2], new_body[4, :2]
    if (lhand is not None and rhand is not None
            and lhand[0, 2] >= threshold and rhand[0, 2] >= threshold
            and old_body[7, 2] >= threshold
            and old_body[4, 2] >= threshold):
        d_ll = float(np.linalg.norm(lhand[0, :2] - old_body[7, :2]))
        d_lr = float(np.linalg.norm(lhand[0, :2] - old_body[4, :2]))
        if d_ll > d_lr:
            lhand, rhand = rhand, lhand
    out_l = retarget_hand(lhand, lw, ratio) if lhand is not None else None
    out_r = retarget_hand(rhand, rw, ratio) if rhand is not None else None
    return out_l, out_r


# ---------------------------------------------------------------------------
# deterministic mask fallback (the SAM2 role: sam_utils.py:122,
# video_predictor.py:14 — neural video segmentation replaced by a
# deterministic pose-hull + frame-difference propagation stand-in so
# replacement mode runs with no injected mask_fn)
# ---------------------------------------------------------------------------


def pose_hull_mask(shape: Tuple[int, int], meta: "PoseMeta",
                   threshold: float = 0.3,
                   dilate_frac: float = 0.08) -> np.ndarray:
    """Person foreground mask from a pose estimate: the filled convex
    hull of all confident body/hand/face keypoints, dilated by
    dilate_frac of the hull diagonal (limbs have thickness the bare
    skeleton hull lacks). Deterministic SAM2 stand-in."""
    import cv2
    h, w = shape
    pts = [meta.body[meta.body[:, 2] >= threshold][:, :2]]
    for hand in (meta.lhand, meta.rhand):
        if hand is not None:
            pts.append(hand[hand[:, 2] >= threshold][:, :2])
    if meta.face is not None:
        pts.append(meta.face[:, :2])
    pts = np.concatenate(pts, axis=0) if pts else np.zeros((0, 2))
    mask = np.zeros((h, w), np.uint8)
    if pts.shape[0] < 3:
        return mask
    hull = cv2.convexHull(pts.astype(np.int32))
    cv2.fillConvexPoly(mask, hull, 1)
    x0, y0, x1, y1 = mask_bbox(mask)
    diag = math.hypot(x1 - x0, y1 - y0)
    it = max(int(diag * dilate_frac), 1)
    return dilate_mask(mask, k=3, iterations=it)


def pose_hull_mask_fn(frames: np.ndarray,
                      metas: Sequence["PoseMeta"]) -> np.ndarray:
    """mask_fn-compatible fallback: per-frame pose-hull masks."""
    h, w = frames.shape[1:3]
    return np.stack([pose_hull_mask((h, w), m) for m in metas])


def propagate_mask(frames: np.ndarray, first_mask: np.ndarray, *,
                   search_radius: int = 16, match_threshold: float = 25.0,
                   grow_px: int = 2) -> np.ndarray:
    """Propagate a first-frame foreground mask through the video
    deterministically (the SAM2 video-predictor role without a neural
    tracker). Per step: (1) estimate the object's global translation by
    brute-force template matching of the masked patch over a
    +-search_radius window (argmin mean-abs-diff under the mask);
    (2) shift the mask by that translation; (3) refine by
    motion-consistency — keep candidate pixels (shifted mask grown by
    grow_px) whose current color matches the source pixel they came
    from under the estimated motion. Static or occluded frames carry
    the previous mask."""
    from scipy.ndimage import binary_dilation
    prev = first_mask.astype(bool)
    h, w = prev.shape
    out = [prev]
    for t in range(1, frames.shape[0]):
        ys, xs = np.nonzero(prev)
        if ys.size == 0:
            out.append(prev)
            continue
        f0 = frames[t - 1].astype(np.float32)
        f1 = frames[t].astype(np.float32)
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        tmpl = f0[y0:y1, x0:x1]
        tmask = prev[y0:y1, x0:x1]
        best = (np.inf, 0, 0)
        r = search_radius
        for dy in range(-r, r + 1):
            yy0, yy1 = y0 + dy, y1 + dy
            if yy0 < 0 or yy1 > h:
                continue
            for dx in range(-r, r + 1):
                xx0, xx1 = x0 + dx, x1 + dx
                if xx0 < 0 or xx1 > w:
                    continue
                diff = np.abs(f1[yy0:yy1, xx0:xx1] - tmpl).mean(-1)
                score = float(diff[tmask].mean())
                if score < best[0]:
                    best = (score, dy, dx)
        _, dy, dx = best
        ys2, xs2 = ys + dy, xs + dx
        ok = (ys2 >= 0) & (ys2 < h) & (xs2 >= 0) & (xs2 < w)
        shifted = np.zeros_like(prev)
        shifted[ys2[ok], xs2[ok]] = True
        # motion-consistency refinement: f0 translated by (dy, dx)
        f0s = np.full_like(f1, np.inf)
        sy0, sy1 = max(dy, 0), h + min(dy, 0)
        sx0, sx1 = max(dx, 0), w + min(dx, 0)
        f0s[sy0:sy1, sx0:sx1] = f0[sy0 - dy:sy1 - dy, sx0 - dx:sx1 - dx]
        match = np.abs(f1 - f0s).mean(-1) < match_threshold
        new = shifted & match
        if grow_px > 0:
            # growth ring: only pixels where the object newly arrived —
            # motion-consistent AND changed in place (pure background is
            # consistent too, but unchanged; without the changed test
            # the ring would accrete background every frame)
            ring = binary_dilation(shifted, iterations=grow_px) \
                & ~shifted
            changed = np.abs(f1 - f0).mean(-1) >= match_threshold
            new |= ring & match & changed
        prev = new if new.any() else shifted if shifted.any() else prev
        out.append(prev)
    return np.stack(out).astype(np.uint8)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@dataclass
class PoseMeta:
    """One frame's 2D pose: pixel-space [N, 3] (x, y, conf) arrays."""
    body: np.ndarray                       # [20, 3]
    lhand: Optional[np.ndarray] = None     # [21, 3]
    rhand: Optional[np.ndarray] = None     # [21, 3]
    face: Optional[np.ndarray] = None      # [F, 3]


_TPOSE = ("Change the person to a standard T-pose (facing forward with "
          "arms extended). ")
_APOSE = ("Change the person to a standard pose with the face oriented "
          "forward and arms extending straight down by the sides. ")


def editing_prompts(metas: List["PoseMeta"], ref_meta: "PoseMeta",
                    frame_hw: Tuple[int, int]
                    ) -> Tuple[str, str]:
    """(template_prompt, refer_prompt) for the FLUX-Kontext editor —
    visibility-dependent canonical-pose instructions (reference
    get_editing_prompts, process_pipepline.py:237-276): landscape
    frames get a T-pose, portrait an arms-down pose; the suffix states
    which extremities must stay visible, decided by whether any
    template frame shows confident in-frame elbows/wrists (rows
    3/4/6/7 of the 20-joint body) or knees/ankles (9/10/12/13)."""
    h, w = frame_hw

    def in_frame(kp):
        return (0 <= kp[0] <= w) and (0 <= kp[1] <= h) and kp[2] >= 0.75

    arm_visible = leg_visible = False
    for m in metas:
        b = m.body
        if any(in_frame(b[i]) for i in (3, 4, 6, 7)):
            arm_visible = True
        if any(in_frame(b[i]) for i in (9, 10, 12, 13)):
            leg_visible = True
        if arm_visible and leg_visible:
            break

    def prompt(landscape: bool) -> str:
        base = _TPOSE if landscape else _APOSE
        if leg_visible:
            return base + ("The person is standing. Feet and Hands are "
                           "visible in the image.")
        if arm_visible:
            return base + "Hands are visible in the image."
        return base + "The upper body is visible in the image."

    return prompt(w > h), prompt(w > h)


class AnimatePreprocessPipeline:
    """frames + reference image -> the WanAnimate conditioning bundle.

    pose_fn(frames u8 [T, H, W, 3]) -> List[PoseMeta]  (detector hook,
    the reference's Pose2d ViTPose+YOLO stage); mask_fn(frames, metas)
    -> [T, H, W] u8 foreground masks (SAM2 stage, replacement only).
    Mirrors ProcessPipeline.__call__ (process_pipepline.py:38-210)
    minus the neural stages.
    """

    def __init__(self, pose_fn: Callable, mask_fn: Optional[Callable]
                 = None, edit_fn: Optional[Callable] = None):
        """edit_fn(image u8 [H, W, 3], prompt) -> u8 [H, W, 3]: the
        FLUX-Kontext reference-editing hook (process_pipepline.py:
        36-37, 180-215) — standardizes the reference and first template
        frame into canonical poses before bone-ratio estimation in
        retarget mode. Injection seam like mask_fn (the port's editor:
        pipelines/kontext.make_edit_fn)."""
        self.pose_fn = pose_fn
        self.mask_fn = mask_fn
        self.edit_fn = edit_fn

    def __call__(self, frames: np.ndarray, refer_img: np.ndarray, *,
                 resolution_area: Tuple[int, int] = (1280, 720),
                 replace: bool = False, retarget: bool = False,
                 iterations: int = 3, k: int = 7,
                 w_len: int = 1, h_len: int = 1) -> Dict[str, np.ndarray]:
        area = resolution_area[0] * resolution_area[1]
        frames = np.stack([resize_by_area(f, area, divisor=16)
                           for f in frames])
        h, w = frames.shape[1:3]
        refer = padding_resize(refer_img, h, w)
        metas: List[PoseMeta] = self.pose_fn(frames)

        if retarget and replace:
            # reference: retargeting "only supported in animation mode"
            # (preprocess_data.py:57); the replace branch never retargets
            # — a retargeted skeleton would disagree with the SAM2 masks.
            import warnings
            warnings.warn("pose retargeting is ignored in replacement "
                          "mode (animation-only, as in the reference)")
            retarget = False
        if retarget:
            ref_meta: PoseMeta = self.pose_fn(refer[None])[0]
            ratio_src, ratio_dst = metas[0].body, ref_meta.body
            if self.edit_fn is not None:
                # FLUX-Kontext editing (process_pipepline.py:180-215):
                # standardize both subjects into canonical poses, re-run
                # pose detection on the edits, and estimate bone ratios
                # from the standardized skeletons
                tpl_prompt, ref_prompt = editing_prompts(
                    metas, ref_meta, (h, w))
                ref_edit = padding_resize(
                    np.asarray(self.edit_fn(refer, ref_prompt)), h, w)
                tpl_edit = padding_resize(
                    np.asarray(self.edit_fn(frames[0], tpl_prompt)),
                    h, w)
                ref_edit_meta = self.pose_fn(ref_edit[None])[0]
                tpl_edit_meta = self.pose_fn(tpl_edit[None])[0]
                ratio_src = tpl_edit_meta.body
                ratio_dst = ref_edit_meta.body
            ratios = bone_ratios(ratio_src, ratio_dst)
            anchor = ref_meta.body[1, :2]
            for m in metas:
                new_body = retarget_body(m.body, ratios, anchor=anchor)
                m.lhand, m.rhand = retarget_hands(
                    m.lhand, m.rhand, m.body, new_body, ratios)
                m.body = new_body

        canvas = np.zeros((h, w, 3), np.uint8)
        cond = np.stack([draw_pose(canvas, m.body, m.lhand, m.rhand)
                         for m in metas])
        faces = np.stack([
            crop_face(f, m.face if m.face is not None
                      else m.body[[0, 14, 15, 16, 17]],
                      normalized=False)
            for f, m in zip(frames, metas)])

        out = {"frames": frames, "ref_image": refer, "pose_video": cond,
               "face_video": faces}
        if replace:
            if self.mask_fn is None:
                # deterministic fallback for the SAM2 segmentation role
                # (video_predictor.py:14): pose-hull person masks. For
                # production-quality mattes use the in-repo SAM2 video
                # segmenter (models/sam2.build_sam2_mask_fn, wired by
                # the CLI when ckpt_path/sam2/sam2_hiera_large.pt
                # exists).
                import warnings
                warnings.warn("no mask_fn injected: using the "
                              "deterministic pose-hull mask fallback "
                              "for the SAM2 segmentation stage (supply "
                              "sam2/sam2_hiera_large.pt under "
                              "--ckpt_path for neural masks)")
                masks = pose_hull_mask_fn(frames, metas)
            else:
                masks = self.mask_fn(frames, metas)
            aug = []
            for m in masks:
                d = dilate_mask(m, k=k, iterations=iterations) \
                    if iterations > 0 else m
                aug.append(grid_quantize_mask(d, w_len, h_len)
                           if iterations > 0 else d)
            aug = np.stack(aug)
            out["aug_masks"] = aug
            out["bg_video"] = np.stack(
                [composite_background(f, m)
                 for f, m in zip(frames, aug)])
        return out

    def save(self, bundle: Dict[str, np.ndarray], output_path: str,
             fps: int = 30) -> Dict[str, str]:
        """Write the reference output contract: src_ref.png,
        src_pose.mp4, src_face.mp4 (+ src_bg.mp4) under output_path."""
        from PIL import Image
        from .video_io import save_video
        os.makedirs(output_path, exist_ok=True)
        paths = {}
        p = os.path.join(output_path, "src_ref.png")
        Image.fromarray(bundle["ref_image"]).save(p)
        paths["ref"] = p
        for key, name in (("pose_video", "src_pose.mp4"),
                          ("face_video", "src_face.mp4"),
                          ("bg_video", "src_bg.mp4")):
            if key in bundle:
                paths[key] = save_video(bundle[key],
                                        os.path.join(output_path, name),
                                        fps=fps)
        if "aug_masks" in bundle:
            # src_mask.mp4 (process_pipepline.py replacement outputs):
            # 0/1 masks as a grayscale-rgb video
            m = (bundle["aug_masks"][..., None] * np.uint8(255)) \
                .repeat(3, axis=-1)
            paths["mask_video"] = save_video(
                m, os.path.join(output_path, "src_mask.mp4"), fps=fps)
        return paths
