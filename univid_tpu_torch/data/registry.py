"""Named-dataset registry and the data-group config.

Counterpart of univid_tpu/data/registry.py (reference
data/dataset_info.py:9-14, data/config/example.yaml, consumed at
dataset_base.py:130-170 with DataConfig:23-43): `load_data_groups` takes
the YAML file's path (yaml is imported only then) or the same shape as a
dict, and returns the `(factory, weight, mandatory)` groups that
`PackedDataset` consumes. `DATASET_REGISTRY` maps group names to their
builders; DATASET_INFO is an argument, each entry with the adapter's
paths:

  t2i_pretrain: {"<name>": {"parquet_paths": [...]}} or {"records": [...]}
  vlm_sft:      {"<name>": {"jsonl_path": ..., "image_dir": ...}}
  unified_edit: {"<name>": {"records": [...]}}
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .datasets import FrameSampler, SftJSONLIterableDataset, \
    T2IIterableDataset
from .interleave_datasets import UnifiedEditIterableDataset
from .transforms import ImageTransform


def _paired_nums(group_cfg) -> List:
    """dataset_names zipped against num_used_data, length-checked: a
    short num_used_data list (config typo) would otherwise silently
    drop the trailing datasets from the group via zip truncation."""
    names = group_cfg["dataset_names"]
    nums = group_cfg.get("num_used_data")
    if nums is None:
        return [None] * len(names)
    if len(nums) != len(names):
        raise ValueError(
            f"num_used_data has {len(nums)} entries for "
            f"{len(names)} dataset_names ({list(names)}); lengths "
            "must match (or omit num_used_data to use all rows)")
    return list(nums)


def _transform(args: Optional[Dict], defaults: Dict) -> ImageTransform:
    a = dict(defaults, **(args or {}))
    return ImageTransform(
        max_image_size=a["max_image_size"],
        min_image_size=a["min_image_size"],
        image_stride=a["image_stride"],
        max_pixels=a.get("max_pixels", 14 * 14 * 9 * 1024))


_VAE_TRANSFORM_DEFAULTS = dict(max_image_size=1024, min_image_size=512,
                               image_stride=16)
_VIT_TRANSFORM_DEFAULTS = dict(max_image_size=980, min_image_size=378,
                               image_stride=14)


def _build_t2i(group_cfg, infos, tokenizer, latent_fn, local_rank,
               world_size, data_status, seed):
    transform = _transform(group_cfg.get("image_transform_args"),
                           _VAE_TRANSFORM_DEFAULTS)
    paths: List[str] = []
    records: List = []
    for name, num in zip(group_cfg["dataset_names"],
                         _paired_nums(group_cfg)):
        info = infos[name]
        if "parquet_paths" in info:
            pp = list(info["parquet_paths"])
            paths.extend(pp if num is None else pp[:num])
        else:
            rr = list(info["records"])
            records.extend(rr if num is None else rr[:num])

    def factory():
        if paths:
            return T2IIterableDataset.from_parquet(
                paths, transform=transform, tokenizer=tokenizer,
                latent_fn=latent_fn, local_rank=local_rank,
                world_size=world_size, data_status=data_status)
        return T2IIterableDataset(
            records, transform=transform, tokenizer=tokenizer,
            latent_fn=latent_fn, local_rank=local_rank,
            world_size=world_size, data_status=data_status)

    return factory


def _build_vlm(group_cfg, infos, tokenizer, latent_fn, local_rank,
               world_size, data_status, seed):
    transform = _transform(group_cfg.get("image_transform_args"),
                           _VIT_TRANSFORM_DEFAULTS)
    fs_args = group_cfg.get("frame_sampler_args") or {}
    sampler = FrameSampler(
        max_num_frames=fs_args.get("max_num_frames", -1),
        min_num_frames=fs_args.get("min_num_frames", 8),
        rng=random.Random(seed))
    jsonl_paths = []
    image_dirs = []
    for name in group_cfg["dataset_names"]:
        info = infos[name]
        jsonl_paths.append(info["jsonl_path"])
        image_dirs.append(info.get("image_dir", ""))

    def factory():
        return SftJSONLIterableDataset(
            jsonl_paths, image_dirs, transform=transform,
            tokenizer=tokenizer, frame_sampler=sampler,
            num_used_data=group_cfg.get("num_used_data"),
            local_rank=local_rank, world_size=world_size,
            shuffle_lines=group_cfg.get("shuffle_lines", False),
            shuffle_seed=group_cfg.get("shuffle_seed", 0),
            data_status=data_status)

    return factory


def _build_edit(group_cfg, infos, tokenizer, latent_fn, local_rank,
                world_size, data_status, seed):
    transform = _transform(group_cfg.get("image_transform_args"),
                           _VAE_TRANSFORM_DEFAULTS)
    vit_transform = _transform(group_cfg.get("vit_image_transform_args"),
                               _VIT_TRANSFORM_DEFAULTS)
    records: List = []
    for name, num in zip(group_cfg["dataset_names"],
                         _paired_nums(group_cfg)):
        rr = list(infos[name]["records"])
        records.extend(rr if num is None else rr[:num])

    def factory():
        return UnifiedEditIterableDataset(
            records, tokenizer=tokenizer, transform=transform,
            vit_transform=vit_transform, latent_fn=latent_fn,
            local_rank=local_rank, world_size=world_size,
            rng=random.Random(seed), data_status=data_status)

    return factory


DATASET_REGISTRY: Dict[str, Callable] = {
    "t2i_pretrain": _build_t2i,
    "vlm_sft": _build_vlm,
    "unified_edit": _build_edit,
}


def load_data_groups(
    config, tokenizer, dataset_info: Dict[str, Dict[str, Dict]], *,
    latent_fn: Optional[Callable] = None, local_rank: int = 0,
    world_size: int = 1, data_status=None, seed: int = 0,
) -> List[Tuple[Callable, float, bool]]:
    """YAML path / dict -> PackedDataset groups.

    `config` is the reference example.yaml shape: top-level keys are
    registry names, each with dataset_names / weight / is_mandatory /
    *_transform_args / num_used_data (dataset_base.py:130-170)."""
    if isinstance(config, str):
        import yaml
        with open(config) as f:
            config = yaml.safe_load(f)
    groups: List[Tuple[Callable, float, bool]] = []
    for name, group_cfg in config.items():
        if name not in DATASET_REGISTRY:
            raise KeyError(
                f"unknown dataset group {name!r}; registered: "
                f"{sorted(DATASET_REGISTRY)}")
        infos = dataset_info.get(name, {})
        missing = [n for n in group_cfg["dataset_names"]
                   if n not in infos]
        if missing:
            raise KeyError(f"group {name!r}: no dataset_info for "
                           f"{missing}")
        factory = DATASET_REGISTRY[name](
            group_cfg, infos, tokenizer, latent_fn, local_rank,
            world_size, data_status, seed)
        groups.append((factory, float(group_cfg.get("weight", 1.0)),
                       bool(group_cfg.get("is_mandatory", False))))
    return groups
