"""Image transforms and corruption augmentations (host-side, numpy).

Counterpart of univid_tpu/data/transforms.py (reference
models/BAGEL/data/transforms.py:15-287), with the same arithmetic and the
same draws:
  * MaxLongEdgeMinShortEdgeResize: scale so the long edge <= max_size and
    the short edge >= min_size, snap both dims to the stride, cap total
    pixels at max_pixels / img_num, re-cap the long edge;
  * ImageTransform: resize -> [0, 1] -> normalize (mean / std 0.5),
    channels-last [H, W, 3] float32;
  * the corruption augmentations of the editing / inpainting data:
    decolorization, downscale, crop, motion blur, shuffle_patch,
    inpainting. crop, shuffle_patch and inpainting take a random.Random
    (the `random` module without one), drawn in JAX's order, so equal
    seeds give equal images.

The standard instances: vae ImageTransform(1024, 512, 16) and vit
ImageTransform(980, 224, 14).
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np

from ..native import resize_bilinear


def _make_divisible(value: float, stride: int) -> int:
    return max(stride, int(round(value / stride) * stride))


def _apply_scale(width: int, height: int, scale: float, stride: int
                 ) -> Tuple[int, int]:
    return (_make_divisible(round(width * scale), stride),
            _make_divisible(round(height * scale), stride))


class MaxLongEdgeMinShortEdgeResize:
    def __init__(self, max_size: int, min_size: int, stride: int,
                 max_pixels: int):
        self.max_size = max_size
        self.min_size = min_size
        self.stride = stride
        self.max_pixels = max_pixels

    def target_size(self, width: int, height: int, img_num: int = 1
                    ) -> Tuple[int, int]:
        """(new_width, new_height) by the reference's three-stage rule."""
        scale = min(self.max_size / max(width, height), 1.0)
        scale = max(scale, self.min_size / min(width, height))
        w, h = _apply_scale(width, height, scale, self.stride)
        if w * h > self.max_pixels / img_num:
            scale = self.max_pixels / img_num / (w * h)
            w, h = _apply_scale(w, h, scale, self.stride)
        if max(w, h) > self.max_size:
            scale = self.max_size / max(w, h)
            w, h = _apply_scale(w, h, scale, self.stride)
        return w, h

    def __call__(self, img: np.ndarray, img_num: int = 1) -> np.ndarray:
        h0, w0 = img.shape[:2]
        w, h = self.target_size(w0, h0, img_num)
        if (h, w) == (h0, w0):
            return img
        return resize_bilinear(img, h, w)


class ImageTransform:
    """uint8/float [H, W, 3] -> normalized float32 [H, W, 3]."""

    def __init__(self, max_image_size: int, min_image_size: int,
                 image_stride: int, max_pixels: int = 14 * 14 * 9 * 1024,
                 image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5)):
        self.stride = image_stride
        self.resize_transform = MaxLongEdgeMinShortEdgeResize(
            max_image_size, min_image_size, image_stride, max_pixels)
        self.mean = np.asarray(image_mean, np.float32)
        self.std = np.asarray(image_std, np.float32)

    def __call__(self, img: np.ndarray, img_num: int = 1) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = self.resize_transform(img, img_num=img_num)
        return (img - self.mean) / self.std


# the standard tower transforms (eval_understanding.py:457-458)
def vae_transform() -> ImageTransform:
    return ImageTransform(1024, 512, 16)


def vit_transform() -> ImageTransform:
    return ImageTransform(980, 224, 14)


# ---------------------------------------------------------------------------
# corruption augmentations (editing / inpainting data, :118-287)
# ---------------------------------------------------------------------------


def decolorization(img: np.ndarray) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])
    return np.repeat(gray[..., None], 3, axis=-1).astype(img.dtype)


def downscale(img: np.ndarray, scale_factor: float) -> np.ndarray:
    h = max(1, int(round(img.shape[0] * scale_factor)))
    w = max(1, int(round(img.shape[1] * scale_factor)))
    return resize_bilinear(img.astype(np.float32), h, w)


def crop(img: np.ndarray, crop_factors: Tuple[int, int],
         rng: Optional[random.Random] = None):
    """Random crop; returns (crop, [[x0, y0], [x1, y1]])."""
    rng = rng or random
    th, tw = crop_factors
    h, w = img.shape[:2]
    if th > h or tw > w:
        raise ValueError("Crop size exceeds image dimensions")
    x = rng.randint(0, w - tw)
    y = rng.randint(0, h - th)
    return img[y:y + th, x:x + tw], [[x, y], [x + tw, y + th]]


def motion_blur(img: np.ndarray, kernel_size: int = 15, angle: float = 0.0
                ) -> np.ndarray:
    """Linear motion-blur kernel rotated by `angle`, reflect padding."""
    k = np.zeros((kernel_size, kernel_size), np.float32)
    k[kernel_size // 2, :] = 1.0
    # rotate the kernel by sampling the source line
    c = (kernel_size - 1) / 2.0
    ys, xs = np.mgrid[0:kernel_size, 0:kernel_size]
    th = np.deg2rad(angle)
    xr = (xs - c) * np.cos(th) + (ys - c) * np.sin(th) + c
    yr = -(xs - c) * np.sin(th) + (ys - c) * np.cos(th) + c
    xi = np.clip(np.round(xr).astype(int), 0, kernel_size - 1)
    yi = np.clip(np.round(yr).astype(int), 0, kernel_size - 1)
    rk = k[yi, xi]
    rk = rk / (rk.sum() if rk.sum() != 0 else 1.0)

    pad = kernel_size // 2
    x = np.asarray(img, np.float32)
    x = np.pad(x, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
    out = np.zeros_like(np.asarray(img, np.float32))
    for dy in range(kernel_size):
        for dx in range(kernel_size):
            wgt = rk[dy, dx]
            if wgt != 0.0:
                out += wgt * x[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out.astype(img.dtype) if np.issubdtype(
        np.asarray(img).dtype, np.integer) else out


def _patch_grid(h: int, w: int, num_splits: Tuple[int, int]):
    hs, ws = num_splits
    heights = [h // hs] * (hs - 1) + [h - (h // hs) * (hs - 1)]
    widths = [w // ws] * (ws - 1) + [w - (w // ws) * (ws - 1)]
    return heights, widths


def shuffle_patch(img: np.ndarray, num_splits: Tuple[int, int],
                  gap_size: int = 2,
                  rng: Optional[random.Random] = None) -> np.ndarray:
    """Split, shuffle, re-tile with white gaps (:169-218)."""
    rng = rng or random
    h, w = img.shape[:2]
    heights, widths = _patch_grid(h, w, num_splits)
    patches = []
    y = 0
    for ph in heights:
        x = 0
        for pw in widths:
            patches.append(img[y:y + ph, x:x + pw])
            x += pw
        y += ph
    rng.shuffle(patches)

    total_w = sum(widths) + (len(widths) - 1) * gap_size
    total_h = sum(heights) + (len(heights) - 1) * gap_size
    fill = 255 if np.issubdtype(np.asarray(img).dtype, np.integer) else 1.0
    out = np.full((total_h, total_w, img.shape[2]), fill, img.dtype)
    y = 0
    idx = 0
    for ph in heights:
        x = 0
        for pw in widths:
            p = patches[idx]
            out[y:y + p.shape[0], x:x + p.shape[1]] = p
            x += pw + gap_size
            idx += 1
        y += ph + gap_size
    return out


def inpainting(img: np.ndarray, num_splits: Tuple[int, int],
               blank_ratio: float = 0.3,
               blank_color=(255, 255, 255),
               rng: Optional[random.Random] = None) -> np.ndarray:
    """Blank a random subset of patches in place (:220-287)."""
    rng = rng or random
    h, w = img.shape[:2]
    heights, widths = _patch_grid(h, w, num_splits)
    total = len(heights) * len(widths)
    n_blank = max(0, min(int(total * blank_ratio), total))
    blank = set(rng.sample(range(total), n_blank))
    out = np.array(img, copy=True)
    y = 0
    idx = 0
    for ph in heights:
        x = 0
        for pw in widths:
            if idx in blank:
                out[y:y + ph, x:x + pw] = np.asarray(
                    blank_color, img.dtype)
            x += pw
            idx += 1
        y += ph
    return out
