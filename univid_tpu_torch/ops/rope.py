"""3D rotary position embedding for video DiTs.

Counterpart of univid_tpu/ops/rope.py: the per-head channel dim d is split
into (t, h, w) bands of half-sizes [c - 2*(c//3), c//3, c//3] (c = d // 2);
angles theta^{-2i/d_band} * position act on adjacent (even, odd) channel
pairs. Tables are built in numpy float64 and handed to torch as fp32;
`apply_rope` rotates in fp32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_dim_split(head_dim: int) -> Tuple[int, int, int]:
    """Half-channel band sizes (t, h, w)."""
    c = head_dim // 2
    return (c - 2 * (c // 3), c // 3, c // 3)


def rope_angles_1d(max_len: int, half_dim: int, theta: float = 10000.0
                   ) -> np.ndarray:
    """[max_len, half_dim] float64 rotation angles."""
    inv = theta ** (-np.arange(0, half_dim, dtype=np.float64) / half_dim)
    return np.outer(np.arange(max_len, dtype=np.float64), inv)


def build_rope_3d(head_dim: int, grid: Tuple[int, int, int],
                  theta: float = 10000.0, dtype=torch.float32,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for a flattened (F, H, W) token grid, each
    [F*H*W, head_dim//2]."""
    f, h, w = grid
    ct, ch, cw = rope_dim_split(head_dim)
    ang_t = rope_angles_1d(f, ct, theta)
    ang_h = rope_angles_1d(h, ch, theta)
    ang_w = rope_angles_1d(w, cw, theta)
    full = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], (f, h, w, ct)),
        np.broadcast_to(ang_h[None, :, None, :], (f, h, w, ch)),
        np.broadcast_to(ang_w[None, None, :, :], (f, h, w, cw)),
    ], axis=-1).reshape(f * h * w, head_dim // 2)
    return (torch.as_tensor(np.cos(full).astype(np.float32)).to(device, dtype),
            torch.as_tensor(np.sin(full).astype(np.float32)).to(device, dtype))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate adjacent channel pairs of x [..., L, N, D] by [L, D/2] tables:
    (x_e cos - x_o sin, x_e sin + x_o cos), in fp32, cast back to x's dtype.
    Written in the swap-multiply form y = x * cosF + swap_pairs(x) * sinF."""
    orig_dtype = x.dtype
    d = x.shape[-1]
    cf = torch.repeat_interleave(cos.float(), 2, dim=-1)
    sf = torch.stack([-sin.float(), sin.float()], dim=-1).reshape(
        *sin.shape[:-1], d)
    xf = x.float()
    sw = xf.reshape(*x.shape[:-1], d // 2, 2).flip(-1).reshape(x.shape)
    y = xf * cf[..., :, None, :] + sw * sf[..., :, None, :]
    return y.to(orig_dtype)
