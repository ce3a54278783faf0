"""Token-packing trainer feed for BAGEL packed training.

Counterpart of univid_tpu/data/packed_dataset.py (reference
models/BAGEL/data/dataset_base.py), a numpy copy with the same behaviour:
  * PackedDataset (:45-305): weighted multi-group sampling with mandatory
    groups, token-budget packing to max_num_tokens (36864) with an
    overflow buffer (max 50) drained below prefer_buffer_before, yield
    once expected_num_tokens is reached.
  * pack_sequence (:306-470): per-item text / vit_image / vae_image
    packing with bos/eos + start/end-of-image specials, ce-loss indexes
    with len2weight reweighting, per-split attn modes
    (causal/full/noise), shared rope position per image, a flow timestep
    per noised vae split from numpy's global generator (np.random.randn,
    as in JAX, so one seed gives the same batch in both packages; -inf on
    clean condition images).
  * DistributedIterableDataset (:8-58 of its file): epoch shuffle + rank
    sharding.

to_batch emits fixed-shape numpy arrays (padded to max_num_tokens, pad
tokens in document 0) that feed models/bagel/packed.bagel_packed_forward;
the mask ids are packed into one int32 code per token
(kernels/attention.pack_mask_codes) for the flash kernels' packed mode.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..kernels.attention import pack_mask_codes
from ..models.bagel.packed import build_mask_ids
from ..native import patchify


def len2weight(x: int, loss_reduction: str = "square") -> float:
    """CE loss reweight by answer length (data_utils.py:168-177)."""
    if x == 0:
        return x
    if loss_reduction == "token":
        return 1.0
    if loss_reduction == "sample":
        return 1.0 / x
    if loss_reduction == "square":
        return 1.0 / (x ** 0.5)
    raise NotImplementedError(loss_reduction)


def flattened_position_ids_extrapolate(h: int, w: int, patch: int,
                                       max_side: int) -> np.ndarray:
    hp, wp = h // patch, w // patch
    rows = np.arange(hp)[:, None] * max_side + np.arange(wp)[None, :]
    return rows.reshape(-1).astype(np.int32)


@dataclass
class PackedDataConfig:
    vit_patch_size: int = 14
    max_num_patch_per_side: int = 70
    vae_image_downsample: int = 16     # vae_downsample * latent_patch
    max_latent_size: int = 64
    latent_channel: int = 16
    text_cond_dropout_prob: float = 0.0
    vit_cond_dropout_prob: float = 0.0
    vae_cond_dropout_prob: float = 0.0
    bos_token_id: int = 151644
    eos_token_id: int = 151645
    start_of_image: int = 151652
    end_of_image: int = 151653


class DistributedIterableDataset:
    """Rank/worker file sharding + epoch shuffle
    (distributed_iterable_dataset.py:8-58), with checkpoint data resume:
    `data_status` is the last consumed row index on this rank (the
    reference threads data_status[worker_id] into each dataset and
    restarts at row_start_id + 1, vlm_dataset.py:97-111)."""

    def __init__(self, paths: Sequence, local_rank: int = 0,
                 world_size: int = 1,
                 data_status: Optional[int] = None):
        self.paths = list(paths)
        self.local_rank = local_rank
        self.world_size = world_size
        self.data_status = data_status
        self.rng = random.Random()
        self.paths_per_rank: List = list(self.paths)
        # shard immediately (the reference subclasses call set_epoch in
        # __init__, distributed_iterable_dataset.py init paths) — without
        # this every rank would iterate identical data
        if world_size > 1:
            self.set_epoch()

    def resume_rows(self):
        """enumerate(paths_per_rank) starting after the last consumed
        row; subclass __iter__ loops drive this so a checkpointed
        data_status resumes iteration mid-epoch."""
        start = self.data_status + 1 if self.data_status is not None \
            else 0
        if start:
            print(f"rank-{self.local_rank} "
                  f"{type(self).__name__}: resuming data at row#{start}")
        return enumerate(self.paths_per_rank[start:], start=start)

    def set_epoch(self, seed: int = 42):
        paths = sorted(self.paths, key=repr)
        self.rng.seed(seed)
        self.rng.shuffle(paths)
        per_rank = len(paths) // self.world_size
        self.paths_per_rank = paths[self.local_rank * per_rank:
                                    (self.local_rank + 1) * per_rank]

    def __iter__(self):
        return iter(self.paths_per_rank)


class PackedDataset:
    """Iterable over packed training batches.

    groups: list of (iterable_factory, weight, is_mandatory); each sample
    must be a dict with 'sequence_plan' (list of items with keys
    type/'text'|'vit_image'|'vae_image', enable_cfg, loss,
    special_token_loss, special_token_label?, frame_delta?, split_start?,
    split_end?), 'text_ids_list', 'image_list' (numpy [H, W, C] in
    [-1, 1]), 'num_tokens', and optional 'data_indexes'.
    """

    def __init__(self, groups, data_config: Optional[PackedDataConfig]
                 = None, expected_num_tokens: int = 32768,
                 max_num_tokens_per_sample: int = 16384,
                 max_num_tokens: int = 36864,
                 prefer_buffer_before: int = 16384,
                 max_buffer_size: int = 50, seed: int = 0):
        self.cfg = data_config or PackedDataConfig()
        self.expected_num_tokens = expected_num_tokens
        self.max_num_tokens_per_sample = max_num_tokens_per_sample
        self.max_num_tokens = max_num_tokens
        self.prefer_buffer_before = prefer_buffer_before
        self.max_buffer_size = max_buffer_size
        self.factories = [g[0] for g in groups]
        self.weights = [g[1] for g in groups]
        self.mandatory = [g[2] if len(g) > 2 else False for g in groups]
        self.rng = random.Random(seed)

    # ------------------------------------------------------------------
    def _fresh_status(self) -> Dict:
        keys = ("packed_text_ids packed_text_indexes packed_position_ids "
                "ce_loss_indexes ce_loss_weights packed_label_ids "
                "packed_vit_tokens packed_vit_position_ids vit_seg_ids "
                "packed_vit_token_indexes packed_latent_clean "
                "packed_latent_position_ids packed_vae_token_indexes "
                "packed_timesteps sample_lens split_lens attn_modes"
                ).split()
        st: Dict = {k: [] for k in keys}
        st["curr"] = 0
        st["n_images"] = 0
        return st

    def __iter__(self):
        iters = [iter(f()) if callable(f) else iter(f)
                 for f in self.factories]
        total_w = sum(self.weights)
        cumprobs = [sum(self.weights[:i + 1]) / total_w
                    for i in range(len(self.weights))]
        st = self._fresh_status()
        indexes: List = []
        buffer: List = []

        while True:
            try:
                if st["curr"] == 0:
                    for gi, it in enumerate(iters):
                        if not self.mandatory[gi]:
                            continue
                        while True:
                            sample = next(it)
                            n = sample["num_tokens"] + \
                                2 * len(sample["sequence_plan"])
                            if n < self.max_num_tokens_per_sample:
                                st = self.pack_sequence(sample, st)
                                indexes.append(
                                    sample.get("data_indexes"))
                                break

                if st["curr"] < self.prefer_buffer_before and buffer:
                    sample = buffer.pop(0)
                    from_buffer = True
                else:
                    n = self.rng.random()
                    gi = next((i for i, c in enumerate(cumprobs)
                               if n < c), 0)
                    sample = next(iters[gi])
                    from_buffer = False
            except StopIteration:
                if st["curr"] > 0:
                    yield self.to_batch(st, indexes)
                return

            n = sample["num_tokens"] + 2 * len(sample["sequence_plan"])
            if n > self.max_num_tokens_per_sample:
                continue
            if st["curr"] + n > self.max_num_tokens:
                if len(buffer) < self.max_buffer_size and not from_buffer:
                    buffer.append(sample)
                    continue
                # buffer full: yield the pack and start the fresh one
                # WITH this sample (dropping it would silently lose
                # training data under sustained buffer pressure)
                yield self.to_batch(st, indexes)
                st = self._fresh_status()
                indexes = []

            st = self.pack_sequence(sample, st)
            indexes.append(sample.get("data_indexes"))
            if st["curr"] >= self.expected_num_tokens:
                yield self.to_batch(st, indexes)
                st = self._fresh_status()
                indexes = []

    # ------------------------------------------------------------------
    def pack_sequence(self, sample: Dict, st: Dict) -> Dict:
        cfg = self.cfg
        images = list(sample.get("image_list", []))
        texts = list(sample.get("text_ids_list", []))
        curr = st["curr"]
        curr_rope = 0
        sample_len = 0
        split_lens: List[int] = []
        attn_modes: List[str] = []
        curr_split_len = 0

        for item in sample["sequence_plan"]:
            if item.get("split_start", True):
                curr_split_len = 0

            if item["type"] == "text":
                text_ids = texts.pop(0)
                if item.get("enable_cfg", 0) == 1 and \
                        self.rng.random() < cfg.text_cond_dropout_prob:
                    continue
                shifted = [cfg.bos_token_id] + list(text_ids)
                st["packed_text_ids"].extend(shifted)
                st["packed_text_indexes"].extend(
                    range(curr, curr + len(shifted)))
                if item.get("loss", 0) == 1:
                    st["ce_loss_indexes"].extend(
                        range(curr, curr + len(shifted)))
                    st["ce_loss_weights"].extend(
                        [len2weight(len(shifted))] * len(shifted))
                    st["packed_label_ids"].extend(
                        list(text_ids) + [cfg.eos_token_id])
                curr += len(shifted)
                curr_split_len += len(shifted)
                # <|im_end|>
                st["packed_text_ids"].append(cfg.eos_token_id)
                st["packed_text_indexes"].append(curr)
                if item.get("special_token_loss", 0) == 1:
                    st["ce_loss_indexes"].append(curr)
                    st["ce_loss_weights"].append(1.0)
                    st["packed_label_ids"].append(
                        item["special_token_label"])
                curr += 1
                curr_split_len += 1
                attn_modes.append("causal")
                st["packed_position_ids"].extend(
                    range(curr_rope, curr_rope + curr_split_len))
                curr_rope += curr_split_len

            elif item["type"] == "vit_image":
                image = images.pop(0)
                if item.get("enable_cfg", 0) == 1 and \
                        self.rng.random() < cfg.vit_cond_dropout_prob:
                    curr_rope += 1
                    continue
                st["packed_text_ids"].append(cfg.start_of_image)
                st["packed_text_indexes"].append(curr)
                curr += 1
                curr_split_len += 1

                vit_tokens = patchify(image, cfg.vit_patch_size)
                n_img = vit_tokens.shape[0]
                st["packed_vit_token_indexes"].extend(
                    range(curr, curr + n_img))
                st["packed_vit_tokens"].append(vit_tokens)
                st["packed_vit_position_ids"].append(
                    flattened_position_ids_extrapolate(
                        image.shape[0], image.shape[1],
                        cfg.vit_patch_size, cfg.max_num_patch_per_side))
                st["vit_seg_ids"].extend([st["n_images"]] * n_img)
                st["n_images"] += 1
                curr += n_img
                curr_split_len += n_img

                st["packed_text_ids"].append(cfg.end_of_image)
                st["packed_text_indexes"].append(curr)
                if item.get("special_token_loss", 0) == 1:
                    st["ce_loss_indexes"].append(curr)
                    st["ce_loss_weights"].append(1.0)
                    st["packed_label_ids"].append(
                        item["special_token_label"])
                curr += 1
                curr_split_len += 1
                attn_modes.append("full")
                st["packed_position_ids"].extend(
                    [curr_rope] * curr_split_len)
                curr_rope += 1

            elif item["type"] == "vae_image":
                # image here is a pre-encoded latent [H_lat, W_lat, C]
                latent = images.pop(0)
                if item.get("enable_cfg", 0) == 1 and \
                        self.rng.random() < cfg.vae_cond_dropout_prob:
                    curr_rope += 1
                    continue
                split_start = item.get("split_start", True)
                st["packed_text_ids"].append(cfg.start_of_image)
                st["packed_text_indexes"].append(curr)
                curr += 1
                curr_split_len += 1

                # latent patchify with latent patch p implied by
                # vae_image_downsample config: tokens arrive pre-shaped
                tokens = latent.reshape(-1, latent.shape[-1])
                n_img = tokens.shape[0]
                h_lat = latent.shape[0]
                w_lat = latent.shape[1]
                st["packed_latent_clean"].append(
                    tokens.astype(np.float32))
                st["packed_latent_position_ids"].append(
                    (np.arange(h_lat, dtype=np.int32)[:, None]
                     * cfg.max_latent_size
                     + np.arange(w_lat, dtype=np.int32)[None, :])
                    .reshape(-1))
                st["packed_vae_token_indexes"].extend(
                    range(curr, curr + n_img))
                if item.get("loss", 0) == 1:
                    timestep = np.random.randn() if split_start \
                        else st["packed_timesteps"][-1]
                else:
                    timestep = float("-inf")
                st["packed_timesteps"].extend([timestep] * n_img)
                curr += n_img
                curr_split_len += n_img

                st["packed_text_ids"].append(cfg.end_of_image)
                st["packed_text_indexes"].append(curr)
                if item.get("special_token_loss", 0) == 1:
                    st["ce_loss_indexes"].append(curr)
                    st["ce_loss_weights"].append(1.0)
                    st["packed_label_ids"].append(
                        item["special_token_label"])
                curr += 1
                curr_split_len += 1
                if split_start:
                    if item.get("loss", 0) == 1 and \
                            "frame_delta" not in item:
                        attn_modes.append("noise")
                    else:
                        attn_modes.append("full")
                st["packed_position_ids"].extend([curr_rope] * (n_img + 2))
                if "frame_delta" in item:
                    curr_rope += item["frame_delta"]
                elif item.get("loss", 0) == 0:
                    curr_rope += 1

            if item.get("split_end", True):
                split_lens.append(curr_split_len)
                sample_len += curr_split_len

        st["curr"] = curr
        st["sample_lens"].append(sample_len)
        st["split_lens"].extend(split_lens)
        st["attn_modes"].extend(attn_modes)
        return st

    # ------------------------------------------------------------------
    def to_batch(self, st: Dict, indexes: List) -> Dict[str, np.ndarray]:
        """Fixed-shape numpy batch for bagel_packed_forward; the pack is
        padded to max_num_tokens with document-0 pad tokens."""
        l = st["curr"]
        pad = self.max_num_tokens - l
        doc, fn, nz = build_mask_ids(st["sample_lens"], st["split_lens"],
                                     st["attn_modes"])
        doc = np.concatenate([doc, np.zeros(pad, np.int32)])
        fn = np.concatenate([fn, np.full(pad, -1, np.int32)])
        nz = np.concatenate([nz, np.full(pad, -1, np.int32)])
        pos = np.concatenate([np.asarray(st["packed_position_ids"],
                                         np.int32),
                              np.zeros(pad, np.int32)])
        batch: Dict = {
            "seq_len": self.max_num_tokens,
            "mask_codes": pack_mask_codes(doc, fn, nz),
            "packed_position_ids": pos,
            "packed_text_ids": np.asarray(st["packed_text_ids"],
                                          np.int32),
            "packed_text_indexes": np.asarray(st["packed_text_indexes"],
                                              np.int32),
            "sample_lens": list(st["sample_lens"]),
            "batch_data_indexes": indexes,
        }
        if st["packed_vit_tokens"]:
            batch["packed_vit_patches"] = np.concatenate(
                st["packed_vit_tokens"]).astype(np.float32)
            batch["packed_vit_pos_ids"] = np.concatenate(
                st["packed_vit_position_ids"]).astype(np.int32)
            batch["packed_vit_token_indexes"] = np.asarray(
                st["packed_vit_token_indexes"], np.int32)
            batch["vit_seg_ids"] = np.asarray(st["vit_seg_ids"], np.int32)
        if st["packed_latent_clean"]:
            batch["packed_latent_clean"] = np.concatenate(
                st["packed_latent_clean"]).astype(np.float32)
            batch["packed_latent_pos_ids"] = np.concatenate(
                st["packed_latent_position_ids"]).astype(np.int32)
            batch["packed_vae_token_indexes"] = np.asarray(
                st["packed_vae_token_indexes"], np.int32)
            batch["packed_timesteps"] = np.asarray(st["packed_timesteps"],
                                                   np.float32)
        if st["ce_loss_indexes"]:
            batch["ce_loss_indexes"] = np.asarray(st["ce_loss_indexes"],
                                                  np.int32)
            batch["packed_label_ids"] = np.asarray(st["packed_label_ids"],
                                                   np.int32)
            batch["ce_loss_weights"] = np.asarray(st["ce_loss_weights"],
                                                  np.float32)
        return batch
