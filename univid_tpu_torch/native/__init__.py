"""Host-side data-loader ops (counterpart of univid_tpu/native/__init__.py).

The JAX package binds native/host_ops.cc through ctypes and keeps an exact
numpy fallback beside each op; the port keeps the numpy formulas only (no
ctypes path, no C++ build): these ops run on the host, they are not a
kernel of the device path.

    resize_bilinear(img, h, w)   half-pixel bilinear
    patchify(image, patch)       [H, W, C] -> patches

JAX's fused u8 scale / shift and u8_to_f32_affine are read only by its
animate preprocessing, which the port does not have yet.
"""

from __future__ import annotations

import numpy as np


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W, C] float or uint8 -> [h, w, C] float32 with half-pixel
    (align_corners=False) sampling."""
    img = np.asarray(img, np.float32)
    sh, sw = img.shape[:2]
    ys = np.clip((np.arange(h) + 0.5) * sh / h - 0.5, 0, sh - 1)
    xs = np.clip((np.arange(w) + 0.5) * sw / w - 0.5, 0, sw - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def patchify(image: np.ndarray, patch: int) -> np.ndarray:
    """[H, W, C] -> [(H/p)*(W/p), p*p*C] float32, (ph, pw, c) inner order
    (BAGEL data_utils.patchify)."""
    image = np.ascontiguousarray(image, np.float32)
    h, w, c = image.shape
    x = image.reshape(h // patch, patch, w // patch, patch, c)
    return x.transpose(0, 2, 1, 3, 4).reshape(-1, patch * patch * c)

