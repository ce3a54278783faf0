"""Device mesh over the ranks of a torch.distributed world.

Counterpart of univid_tpu/core/mesh.py. The four axes keep their names and
order:

  dp    data parallel
  fsdp  parameter sharding (FSDP2, `parallel.sharding.shard_params`)
  sp    sequence parallel (Ulysses all-to-all or ring, `parallel`)
  tp    tensor parallel (head- and ffn-structured dims of the rules'
        parameters, `parallel.tensor_parallel`)

The mesh is a `torch.distributed.device_mesh.DeviceMesh` over the world the
caller initialised (`torch.distributed.init_process_group` with its own
address, world size and rank); its collectives run on each axis's process
group. JAX's `shard` / `replicated` NamedSharding helpers have no
counterpart here: a parameter's placement is the spec its sharding rule
gives (`parallel.sharding.apply_sharding_rules`). A train step splits its
batch over the dp x fsdp ranks, the sp and tp ranks holding replicas of
their share; a serving mesh may hold sp > 1 beside tp > 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_SP = "sp"
AXIS_TP = "tp"

ALL_AXES = (AXIS_DP, AXIS_FSDP, AXIS_SP, AXIS_TP)


@dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.sp * self.tp

    def axis_sizes(self) -> Tuple[int, int, int, int]:
        return (self.dp, self.fsdp, self.sp, self.tp)


def make_mesh(spec: MeshSpec, device: str = "cuda") -> DeviceMesh:
    """The named mesh over the initialised world, on `device` ('cuda', or
    'cpu' for gloo groups of CPU tensors); a spec whose size is not the
    world size raises ValueError."""
    world = dist.get_world_size()
    if spec.size != world:
        raise ValueError(
            f"mesh spec {spec} needs {spec.size} devices, have {world}")
    return init_device_mesh(device, spec.axis_sizes(),
                            mesh_dim_names=ALL_AXES)
