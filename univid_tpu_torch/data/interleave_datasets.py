"""Interleaved image-editing datasets.

Counterpart of univid_tpu/data/interleave_datasets.py (reference
models/BAGEL/data/interleave_datasets/):
  * InterleavedBuilder mirrors InterleavedBaseIterableDataset's
    _init_data / _add_text / _add_image / _add_video
    (interleave_t2i_dataset.py:10-130): an image can enter as a noised
    vae target (loss 1), a clean vae condition, and / or a vit condition;
    video frames become one multi-split vae sequence with frame_delta rope
    jumps and split_start / split_end markers;
  * UnifiedEditIterableDataset.parse_row (edit_dataset.py:19-80): a random
    (start, end) image pair of an editing chain, the start image as the
    condition (vae + vit), then either one concatenated instruction -> the
    final noised target, or instruction by instruction -> intermediate
    images (noised target + condition + vit) ending in a final noised
    target.

Samples carry numpy channels-last pixel images for vit entries and latents
from the injected `latent_fn` for vae entries, as
data/packed_dataset.PackedDataset.pack_sequence takes them.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .packed_dataset import DistributedIterableDataset
from .transforms import ImageTransform


class InterleavedBuilder:
    """Sample builder mirroring InterleavedBaseIterableDataset's
    _init_data/_add_* helpers."""

    def __init__(self, tokenizer, transform: ImageTransform,
                 vit_transform: ImageTransform,
                 latent_fn: Callable[[np.ndarray], np.ndarray]):
        self.tokenizer = tokenizer
        self.transform = transform
        self.vit_transform = vit_transform
        self.latent_fn = latent_fn

    def init_data(self) -> Dict:
        return {"sequence_plan": [], "text_ids_list": [],
                "image_list": [], "num_tokens": 0}

    def add_text(self, data, text: str, need_loss: bool,
                 enable_cfg: bool = True) -> Dict:
        ids = self.tokenizer.encode(text)
        data["num_tokens"] += len(ids)
        data["text_ids_list"].append(ids)
        data["sequence_plan"].append({
            "type": "text", "enable_cfg": int(enable_cfg),
            "loss": int(need_loss), "special_token_loss": 0})
        return data

    def _vae_entry(self, data, image, loss: int, enable_cfg: int,
                   **extra):
        latent = np.asarray(self.latent_fn(self.transform(image)))
        data["image_list"].append(latent)
        data["num_tokens"] += latent.shape[0] * latent.shape[1]
        data["sequence_plan"].append(dict(
            {"type": "vae_image", "enable_cfg": enable_cfg, "loss": loss,
             "special_token_loss": 0}, **extra))
        return data

    def add_image(self, data, image: np.ndarray, need_loss: bool,
                  need_vae: bool, need_vit: bool,
                  enable_cfg: bool = True) -> Dict:
        assert need_loss or need_vae or need_vit
        if need_loss:
            data = self._vae_entry(data, image, loss=1, enable_cfg=0)
        if need_vae:
            data = self._vae_entry(data, image, loss=0,
                                   enable_cfg=int(enable_cfg))
        if need_vit:
            vit = self.vit_transform(image)
            data["image_list"].append(vit)
            data["num_tokens"] += \
                (vit.shape[0] // self.vit_transform.stride) \
                * (vit.shape[1] // self.vit_transform.stride)
            data["sequence_plan"].append({
                "type": "vit_image", "enable_cfg": int(enable_cfg),
                "loss": 0, "special_token_loss": 0})
        return data

    def add_video(self, data, frames: Sequence[np.ndarray],
                  frame_indexes: Sequence[int], need_loss: bool,
                  need_vae: bool, enable_cfg: bool = True) -> Dict:
        """Multi-frame vae sequence: ONE attention split spanning all
        frames (split_start/split_end) with frame_delta rope advances
        (interleave_t2i_dataset.py:88-130)."""
        assert int(need_loss) + int(need_vae) == 1
        n = len(frames)
        for idx, (image, fidx) in enumerate(zip(frames, frame_indexes)):
            extra = {"split_start": idx == 0, "split_end": idx == n - 1}
            if idx < n - 1:
                extra["frame_delta"] = frame_indexes[idx + 1] - fidx
            data = self._vae_entry(
                data, image, loss=int(need_loss),
                enable_cfg=0 if need_loss else int(enable_cfg), **extra)
        return data


class UnifiedEditIterableDataset(DistributedIterableDataset):
    """Editing-chain records -> packer samples (edit_dataset.py:19-80).

    records: [{'image_list': [np.ndarray...], 'instruction_list':
    [[str...]...]}] with len(instruction_list) == len(image_list) - 1.
    """

    def __init__(self, records: Sequence[Dict], tokenizer,
                 transform: ImageTransform, vit_transform: ImageTransform,
                 latent_fn: Callable[[np.ndarray], np.ndarray],
                 local_rank: int = 0, world_size: int = 1,
                 rng: Optional[random.Random] = None, data_status=None):
        super().__init__(list(records), local_rank, world_size,
                         data_status=data_status)
        self.builder = InterleavedBuilder(tokenizer, transform,
                                          vit_transform, latent_fn)
        self.rng = rng or random.Random(0)

    def parse_row(self, row: Dict) -> Dict:
        images = row["image_list"]
        instructions = row["instruction_list"]
        n = len(images)
        start = self.rng.choice(range(n - 1))
        max_end = min(start + 3, n)
        end = self.rng.choice(range(start + 1, max_end))

        b = self.builder
        data = b.init_data()
        data = b.add_image(data, images[start], need_loss=False,
                           need_vae=True, need_vit=True)

        if end - start > 1 and self.rng.random() < 0.5:
            # concatenated multi-step instruction -> final target only
            if end == n - 1:
                end -= 1
            text = ""
            for idx in range(start + 1, end + 1):
                text += self.rng.choice(instructions[idx - 1]) + ". "
            data = b.add_text(data, text.rstrip(), need_loss=False)
            data = b.add_image(data, images[end], need_loss=True,
                               need_vae=False, need_vit=False)
        else:
            for idx in range(start + 1, end + 1):
                text = self.rng.choice(instructions[idx - 1])
                data = b.add_text(data, text, need_loss=False)
                last = idx == end
                data = b.add_image(data, images[idx], need_loss=True,
                                   need_vae=not last, need_vit=not last)
        return data

    def __iter__(self) -> Iterator[Dict]:
        for row_idx, row in self.resume_rows():
            try:
                data = self.parse_row(row)
            except Exception as e:  # noqa: BLE001
                # reference prints and skips malformed rows
                # (interleave_datasets 'Error {e} in rg#...')
                print(f"Error {e!r} in unified_edit row#{row_idx}, "
                      "skipping")
                continue
            if not data["sequence_plan"]:
                continue
            data["data_indexes"] = {"data_indexes": row_idx,
                                    "dataset_name": "unified_edit"}
            yield data
