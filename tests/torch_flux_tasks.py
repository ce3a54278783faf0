"""The rank tasks of tests/test_torch_flux.py: they run in the spawned ranks
of `torch_ranks.Ranks`, which import this module by name, so it imports no
JAX. Inputs arrive as numpy trees and arrays; each task converts and
shards them on its rank.
"""

import torch

from torch_ranks import _mesh
from univid_tpu_torch import convert
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.models.flux import kontext as tk
from univid_tpu_torch.parallel import sharding as tsh


def _task_flux_fsdp_tp(rank, world, cfg_kw, params, img, txt, t, g, pooled,
                       ids):
    """flux_forward on a Flux sharded by flux_param_sharding_rules at fsdp
    4 x tp 2 (fp32): the velocity tokens, and each hot leaf's local shard
    shape."""
    cfg = tk.FluxConfig(**cfg_kw)
    model = convert.flux_from_jax(params, cfg, device="cpu")
    tsh.shard_params(model, _mesh(fsdp=4, tp=2),
                     tsh.flux_param_sharding_rules())
    shapes = {name: tuple(model.get_parameter(name).to_local().shape)
              for name in ("double_blocks.0.img.qkv.w",
                           "single_blocks.0.linear1.w",
                           "single_blocks.0.linear2.w")}
    rope = tk.build_rope_from_ids(ids, cfg.axes_dim, cfg.theta, device="cpu")
    out = tk.flux_forward(model, cfg, torch.as_tensor(img),
                          torch.as_tensor(txt), torch.as_tensor(t),
                          guidance=torch.as_tensor(g),
                          clip_pooled=torch.as_tensor(pooled),
                          rope_tables=rope, policy=FP32_POLICY)
    return out.numpy(), shapes
