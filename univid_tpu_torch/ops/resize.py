"""jax.image.resize's 'bilinear' and 'bicubic' methods, written out as
separable weight matrices (counterpart of jax._src.image.scale, which the
JAX package calls; the port has no JAX).

Along each axis whose size changes, the output is the input contracted
with an [in, out] matrix (`resize_weights`): the kernel (a triangle for
'bilinear', Keys' cubic with a = -0.5 for 'bicubic') sampled at the
distance of each input pixel centre from each output sample, widened by
1 / scale when downsampling (antialiased), each column normalised to sum
1 and zeroed where the sample lies outside the input. This is not
torch.nn.functional.interpolate: its bicubic uses a = -0.75 and neither
mode antialiases by default.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x):
    return (1.0 - x.abs()).clamp_min(0.0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5, at |x| (x >= 0)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, device,
                   method: str = "bilinear") -> torch.Tensor:
    """[in, out] fp32 weights of jax.image.resize's `method` along one
    axis (compute_weight_mat with antialias)."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x: torch.Tensor, shape: Sequence[int], method: str
           ) -> torch.Tensor:
    """jax.image.resize(x, shape, method) for 'bilinear' or 'bicubic':
    every axis whose size differs is resampled (the rest pass through);
    computed in fp32, returned in x's dtype."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} for a {x.dim()}-d input")
    y = x.float()
    for d, n in enumerate(shape):
        if y.shape[d] != n:
            w = resize_weights(y.shape[d], n, y.device, method)
            y = torch.tensordot(y, w, dims=([d], [0])).movedim(-1, d)
    return y.to(x.dtype)
