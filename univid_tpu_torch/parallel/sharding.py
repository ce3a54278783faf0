"""Parameter sharding rules, applied as FSDP2.

Counterpart of univid_tpu/parallel/sharding.py. The rule lists are the JAX
package's, rewritten for the port's names and layouts: a parameter is
named by its state-dict key (`blocks.3.self_attn.q.w`: the stacked JAX
leaves are one module per block here), and a linear weight is [out, in]
(JAX's [in, out] transposed), so each rule's two axes swap. A spec is a
tuple of axis names or None per dim; `()` replicates.

`apply_sharding_rules` gives every parameter its spec, with JAX's rule that
an axis which does not divide its dim is dropped. `shard_params` applies
the specs' `fsdp` axis as FSDP2 (`fully_shard`, one unit a block and one
for the rest): each parameter is split on the dim its spec names, and a
parameter whose spec has no `fsdp` axis stays whole on every rank. The
port's forwards read each block's tensors directly rather than calling the
block, so FSDP2's forward hooks never fire: every forward gathers a unit
around its use with `gathered`. Tensor parallelism (the specs' `tp` axis)
has no port yet: a mesh with tp > 1 raises.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch.nn as nn
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import Shard

from ..core.mesh import ALL_AXES, AXIS_FSDP, AXIS_SP, AXIS_TP, MeshSpec

Spec = Tuple[Optional[str], ...]
Rules = List[Tuple[str, Spec]]

TP_LATER = ("tensor parallelism (a mesh with tp > 1) is a later slice "
            "(ROADMAP.md queue 1: Multi-GPU tensor parallelism)")

F, T = AXIS_FSDP, AXIS_TP


def dit_param_sharding_rules() -> Rules:
    """Rules for the Wan DiT (models/wan/dit.py names). FSDP shards the
    weight's model dim, TP its head- or ffn-structured dim."""
    return [
        # q, k, v [out = heads, in]; o [out, in = heads]
        (r"blocks\.\d+\.(self_attn|cross_attn)\.(q|k|v)\.w$", (T, F)),
        (r"blocks\.\d+\.(self_attn|cross_attn)\.(q|k|v)\.b$", (T,)),
        (r"blocks\.\d+\.(self_attn|cross_attn)\.o\.w$", (F, T)),
        # ffn: fc0 [ffn, dim], fc1 [dim, ffn]
        (r"blocks\.\d+\.ffn\.fc0\.w$", (T, F)),
        (r"blocks\.\d+\.ffn\.fc0\.b$", (T,)),
        (r"blocks\.\d+\.ffn\.fc1\.w$", (F, T)),
        # the per-block modulation [6, dim] stays whole: it is small
        (r"blocks\.\d+\.modulation$", ()),
        (r"patch_embed\.w$", (F, None)),
        (r"(text_embedding|time_embedding|time_projection)\.fc\d+\.w$",
         (F, None)),
        (r"head\.head\.w$", (None, F)),
    ]


def bagel_llm_param_sharding_rules() -> Rules:
    """Rules for the Qwen2-MoT LM (models/bagel/qwen2_mot.py names), the
    und and gen (MoT) twins alike: BAGEL-7B in bf16 (~15 GB)."""
    return [
        (r"layers\.\d+\.attn(_gen)?\.(q|k|v)\.w$", (T, F)),
        (r"layers\.\d+\.attn(_gen)?\.(q|k|v)\.b$", (T,)),
        (r"layers\.\d+\.attn(_gen)?\.o\.w$", (F, T)),
        (r"layers\.\d+\.mlp(_gen)?\.(gate|up)\.w$", (T, F)),
        (r"layers\.\d+\.mlp(_gen)?\.down\.w$", (F, T)),
        (r"embed_tokens$", (F, None)),
        (r"lm_head\.w$", (F, None)),
    ]


def flux_param_sharding_rules() -> Rules:
    """Rules for the FLUX.1-Kontext transformer, by the names its JAX tree
    takes in the port's layout (double and single blocks one module each).
    No port of the model reads them yet (ROADMAP.md queue 1: FLUX.1
    Kontext)."""
    return [
        (r"double_blocks\.\d+\.(img|txt)\.(qkv|mod)\.w$", (T, F)),
        (r"double_blocks\.\d+\.(img|txt)\.(qkv|mod)\.b$", (T,)),
        (r"double_blocks\.\d+\.(img|txt)\.proj\.w$", (F, T)),
        (r"double_blocks\.\d+\.(img|txt)\.mlp\.fc0\.w$", (T, F)),
        (r"double_blocks\.\d+\.(img|txt)\.mlp\.fc0\.b$", (T,)),
        (r"double_blocks\.\d+\.(img|txt)\.mlp\.fc1\.w$", (F, T)),
        (r"single_blocks\.\d+\.(linear1|mod)\.w$", (T, F)),
        (r"single_blocks\.\d+\.(linear1|mod)\.b$", (T,)),
        (r"single_blocks\.\d+\.linear2\.w$", (F, T)),
        (r"(img_in|txt_in)\.w$", (F, None)),
        (r"(time_in|vector_in|guidance_in)\.(in|out)_layer\.w$", (F, None)),
        (r"final_layer\.(linear|adaLN)\.w$", (None, F)),
    ]


def t5_param_sharding_rules() -> Rules:
    """Rules for the UMT5-XXL encoder (models/wan/t5.py names)."""
    return [
        (r"blocks\.\d+\.attn\.(q|k|v)\.w$", (T, F)),
        (r"blocks\.\d+\.attn\.o\.w$", (F, T)),
        (r"blocks\.\d+\.ffn\.(gate|fc1)\.w$", (T, F)),
        (r"blocks\.\d+\.ffn\.fc2\.w$", (F, T)),
        (r"token_embedding$", (F, None)),
    ]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh or a MeshSpec."""
    if isinstance(mesh, MeshSpec):
        return dict(zip(ALL_AXES, mesh.axis_sizes()))
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def apply_sharding_rules(params, mesh, rules: Rules) -> Dict[str, Spec]:
    """{name: spec} for `params` (a module, or a dict of name -> tensor or
    shape): the first rule whose regex matches the name, with each axis
    that does not divide its dim dropped and the spec padded with None to
    the tensor's rank; () (whole on every rank) where no rule matches."""
    sizes = axis_sizes(mesh)
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    specs = {}
    for name, leaf in items:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        specs[name] = ()
        for pat, spec in rules:
            if re.search(pat, name):
                fixed = tuple(None if ax is None or dim % sizes[ax] else ax
                              for dim, ax in zip(shape, spec))
                specs[name] = fixed + (None,) * (len(shape) - len(fixed))
                break
    return specs


def _refuse_tp(mesh) -> None:
    if axis_sizes(mesh)[AXIS_TP] > 1:
        raise NotImplementedError(TP_LATER)


def check_serving_mesh(mesh, sp_size: int) -> None:
    """A pipeline's sp_size and mesh: sp_size > 1 needs a mesh (JAX's
    ValueError), a mesh with tp > 1 raises NotImplementedError, and
    sp_size must be the size of the mesh's sp axis."""
    if mesh is None:
        if sp_size > 1:
            raise ValueError("sp_size > 1 requires a mesh")
        return
    _refuse_tp(mesh)
    if axis_sizes(mesh)[AXIS_SP] != sp_size:
        raise ValueError(f"sp_size {sp_size} is not the mesh's sp axis "
                         f"({axis_sizes(mesh)[AXIS_SP]})")


def block_units(module: nn.Module) -> List[nn.Module]:
    """The FSDP units of a model besides its root: every member of every
    ModuleList in it (the DiT's and T5's blocks, the LLM's layers)."""
    return [m for lst in module.modules() if isinstance(lst, nn.ModuleList)
            for m in lst]


def shard_params(module: nn.Module, mesh, rules: Rules) -> None:
    """Shard `module` in place over the mesh's fsdp axis by `rules`:
    fully_shard on each of its `block_units`, then on the module. A mesh
    with fsdp = 1 shards nothing; tp > 1 raises NotImplementedError."""
    _refuse_tp(mesh)
    specs = apply_sharding_rules(module, mesh, rules)
    if axis_sizes(mesh)[AXIS_FSDP] == 1:
        return
    dims = {}
    for name, p in module.named_parameters():
        if AXIS_FSDP in specs[name]:
            dims[p] = specs[name].index(AXIS_FSDP)
    whole = {p for p in module.parameters() if p not in dims}

    def placement(p):
        return Shard(dims[p])

    kw = dict(mesh=mesh[AXIS_FSDP], shard_placement_fn=placement,
              ignored_params=whole)
    for unit in block_units(module):
        fully_shard(unit, **kw)
    fully_shard(module, **kw)


def is_sharded(module: nn.Module) -> bool:
    return isinstance(module, FSDPModule)


@contextlib.contextmanager
def gathered(module: nn.Module):
    """The body runs with `module`'s FSDP unit all-gathered (its own
    parameters, not those of nested units), and the unit is sharded again
    after it; a module that is not an FSDP unit passes through."""
    if not isinstance(module, FSDPModule):
        yield module
        return
    module.unshard()
    try:
        yield module
    finally:
        module.reshard()

