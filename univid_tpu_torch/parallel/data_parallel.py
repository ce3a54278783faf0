"""A batch over the mesh's `dp` ranks (the SigLIP scorers' frames).

Counterpart of the JAX scorers' `in_shardings=P("dp")`
(univid_tpu/reflection/scorer.py, naflex.py): the rows are padded to a
multiple of dp by repeating the last one, each rank computes its
contiguous share, the results are all-gathered over the dp group and the
pad dropped, so every rank returns every row's result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh import AXIS_DP


def dp_map(mesh, fn, *arrays: np.ndarray) -> torch.Tensor:
    """fn(*shares) -> a tensor with one row per input row, over the rows of
    `arrays` (numpy, equally long) split over mesh["dp"]: the whole result
    [rows, ...] on every rank."""
    group = mesh[AXIS_DP].get_group()
    n, me = dist.get_world_size(group), dist.get_rank(group)
    rows = len(arrays[0])
    pad = -rows % n
    if pad:
        arrays = tuple(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                       for a in arrays)
    m = (rows + pad) // n
    out = fn(*(a[me * m:(me + 1) * m] for a in arrays)).contiguous()
    full = out.new_empty((n * m,) + tuple(out.shape[1:]))
    dist.all_gather_into_tensor(full, out, group=group)
    return full[:rows]
