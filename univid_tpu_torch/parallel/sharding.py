"""Parameter sharding rules, applied as tensor parallelism and FSDP2.

Counterpart of univid_tpu/parallel/sharding.py. The rule lists are the JAX
package's, rewritten for the port's names and layouts: a parameter is
named by its state-dict key (`blocks.3.self_attn.q.w`: the stacked JAX
leaves are one module per block here), and a linear weight is [out, in]
(JAX's [in, out] transposed), so each rule's two axes swap. A spec is a
tuple of axis names or None per dim; `()` replicates.

`apply_sharding_rules` gives every parameter its spec, with JAX's rule that
an axis which does not divide its dim is dropped. `shard_params` applies
the specs: first the `tp` axis, each such parameter becoming a DTensor of
the rank's slice (`Shard` on its tp dim over the mesh's tp axis; the model
carries its `parallel.tensor_parallel.TensorParallel`), then the `fsdp`
axis as FSDP2 (`fully_shard`, one unit a block and one for the rest): each
parameter is split on the dim its spec names, a tp DTensor under
`fully_shard` becoming a 2-D one over (fsdp, tp). A parameter whose spec
has neither axis stays whole on every rank.

The port's forwards read each block's tensors directly rather than calling
the block, so neither FSDP2's forward hooks nor `parallelize_module`'s
would fire: every forward takes a unit's parameters around their use with
`gathered`, which hands it the rank's local tp shard of each parameter,
unsharded over fsdp, and the forwards run the tp collectives themselves
(`parallel.tensor_parallel`). Under no_grad `gathered` unshards the FSDP
unit (one all-gather a unit) and reshards it after. Under grad it gathers
each fsdp-sharded parameter by an autograd Function whose backward
reduce-scatters (sums) its gradient into the shard: the gathered tensor
lives as long as autograd keeps it, so a unit stays unsharded until its
gradient is reduce-scattered, and a unit recomputed in the backward
(`remat_blocks`) is gathered again there, since the forwards enter
`gathered` inside each recomputed segment.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor, Shard

from ..core.mesh import ALL_AXES, AXIS_FSDP, AXIS_SP, AXIS_TP, MeshSpec
from .tensor_parallel import TensorParallel

Spec = Tuple[Optional[str], ...]
Rules = List[Tuple[str, Spec]]

SP_TP_LATER = ("sequence parallelism (sp > 1) on a mesh with tp > 1 is a "
               "later slice (ROADMAP.md queue 1: Sequence and tensor "
               "parallelism together)")

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
    """Rules for the FLUX.1-Kontext transformer (models/flux/kontext.py
    names: double and single blocks one module each). Their tp axis splits
    the fused qkv, linear1 and modulation rows into contiguous shards that
    hold no whole heads: `flux_forward` gathers those outputs over tp and
    takes each rank's heads from the whole."""
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


def check_serving_mesh(mesh, sp_size: int) -> None:
    """A pipeline's sp_size and mesh: sp_size > 1 needs a mesh (JAX's
    ValueError), sp > 1 beside tp > 1 raises NotImplementedError, and
    sp_size must be the size of the mesh's sp axis. A DiT sharded over tp
    serves at sp_size 1 through the same forward (its TensorParallel)."""
    if mesh is None:
        if sp_size > 1:
            raise ValueError("sp_size > 1 requires a mesh")
        return
    sizes = axis_sizes(mesh)
    if sizes[AXIS_SP] > 1 and sizes[AXIS_TP] > 1:
        raise NotImplementedError(SP_TP_LATER)
    if sizes[AXIS_SP] != sp_size:
        raise ValueError(f"sp_size {sp_size} is not the mesh's sp axis "
                         f"({sizes[AXIS_SP]})")


def block_units(module: nn.Module) -> List[nn.Module]:
    """The FSDP units of a model besides its root: every member of every
    ModuleList in it (the DiT's and T5's blocks, the LLM's layers)."""
    return [m for lst in module.modules() if isinstance(lst, nn.ModuleList)
            for m in lst]


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def shard_params(module: nn.Module, mesh, rules: Rules) -> None:
    """Shard `module` in place by `rules` over the mesh's tp and fsdp axes.
    tp > 1: each parameter with a `tp` axis becomes a DTensor of the rank's
    slice on that dim (`Shard` over mesh["tp"]; the slices are cut from the
    rank's own whole tensor, no collective), and the module carries its
    `TensorParallel`. fsdp > 1: fully_shard on each of its `block_units`,
    then on the module, over mesh["fsdp"]."""
    specs = apply_sharding_rules(module, mesh, rules)
    sizes = axis_sizes(mesh)
    if sizes[AXIS_TP] > 1:
        tp_mesh = mesh[AXIS_TP]
        me, n = tp_mesh.get_local_rank(), sizes[AXIS_TP]
        for name, p in list(module.named_parameters()):
            if AXIS_TP not in specs[name]:
                continue
            d = specs[name].index(AXIS_TP)
            local = p.detach().chunk(n, d)[me].clone()
            owner, leaf = _owner(module, name)
            owner._parameters[leaf] = nn.Parameter(
                DTensor.from_local(local, tp_mesh, [Shard(d)],
                                   run_check=False),
                requires_grad=p.requires_grad)
        module.tensor_parallel = TensorParallel(tp_mesh.get_group(), n, me)
    if sizes[AXIS_FSDP] == 1:
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


def _all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's shards of a tensor concatenated along `dim`, in rank
    order (one all_gather_into_tensor)."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


class _GatherShards(torch.autograd.Function):
    """All-gather of the fsdp shards of a tensor along `dim`; the backward
    reduce-scatters (sums) the gradient back to the shard."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_dim(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        x = g.movedim(ctx.dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def _local_tensor(p: torch.Tensor) -> torch.Tensor:
    """What a forward computes with for parameter p: a plain tensor as it
    is; a DTensor's local tensor (the rank's tp slice), all-gathered over
    fsdp when fsdp shards it (differentiably: `_GatherShards`)."""
    if not isinstance(p, DTensor):
        return p
    t = p.to_local()
    names = p.device_mesh.mesh_dim_names
    if AXIS_FSDP in names:
        i = names.index(AXIS_FSDP)
        t = _GatherShards.apply(t, p.device_mesh.get_group(AXIS_FSDP),
                                p.placements[i].dim)
    return t


def _own_params(module: nn.Module):
    """(owner, name, tensor) of every parameter the unit holds itself: its
    submodules' but those inside a ModuleList (the nested units)."""
    stack = [module]
    while stack:
        m = stack.pop()
        for name, p in m._parameters.items():
            if p is not None:
                yield m, name, p
        stack.extend(c for c in m._modules.values()
                     if c is not None and not isinstance(c, nn.ModuleList))


@contextlib.contextmanager
def gathered(module: nn.Module):
    """The body runs with `module`'s own parameters (not those of nested
    units) replaced by what the forward computes with (`_local_tensor`):
    under no_grad an FSDP unit is unsharded first (one all-gather) and
    sharded again after; under grad each fsdp-sharded parameter is
    gathered on its own, with its gradient path to the shard. A module
    with no DTensor parameter passes through."""
    fsdp = isinstance(module, FSDPModule) and not torch.is_grad_enabled()
    if fsdp:
        module.unshard()
    swapped = []
    try:
        for owner, name, p in list(_own_params(module)):
            if isinstance(p, DTensor):
                owner._parameters[name] = _local_tensor(p)
                swapped.append((owner, name, p))
        yield module
    finally:
        for owner, name, p in reversed(swapped):
            owner._parameters[name] = p
        if fsdp:
            module.reshard()


@torch.no_grad()
def full_tensor(p: torch.Tensor) -> torch.Tensor:
    """The whole parameter on every rank: a DTensor's local tensor
    all-gathered over every mesh axis that shards it (a collective: every
    rank, in the same order), a plain tensor as it is. It calls the
    process groups' all_gather_into_tensor, which gloo takes for CUDA
    tensors (DTensor.full_tensor's functional collectives crash there)."""
    if not isinstance(p, DTensor):
        return p
    t = p.to_local()
    for i, pl in enumerate(p.placements):
        if pl.is_shard():
            t = _all_gather_dim(t, p.device_mesh.get_group(i), pl.dim)
    return t
