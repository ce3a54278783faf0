"""Dataset adapters feeding the PackedDataset token packer.

Counterpart of univid_tpu/data/datasets.py (the reference BAGEL data
stack), with the same samples for the same seeds:
  * get_frame_indices / FrameSampler (data/video_utils.py:23-127):
    interval-uniform 'rand' / 'middle' sampling, fps-based sampling, and a
    random target frame count in [min_num_frames, max] per video;
  * SftJSONLIterableDataset (data/vlm_dataset.py:20-196): jsonl
    conversations with <image> / <video> placeholders -> interleaved
    vit_image / text elements (loss on gpt turns), the ViT ImageTransform
    per image, per-sample token accounting; samples with no loss skipped;
  * T2IIterableDataset (data/t2i_dataset.py:17-140): caption (cfg-
    droppable, no loss) + noised vae_image (loss 1); the caption chosen
    randomly among the provided variants.

The sources of randomness are JAX's: the random.Random instances, the
`random` module where no instance is given, and numpy's global generator
(FrameSampler's frame count, get_frame_indices' fallback), from which the
port's packer also draws its flow timesteps. Samples carry channels-last
numpy arrays; vae images are encoded to latents through an injected
`latent_fn`; parquet sources are read when pyarrow imports, with JSONL as
the hermetic path.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .packed_dataset import DistributedIterableDataset
from .transforms import ImageTransform


def get_frame_indices(num_frames: int, vlen: int, sample: str = "rand",
                      fix_start: Optional[int] = None, input_fps: float = 1,
                      max_num_frames: int = -1,
                      rng: Optional[random.Random] = None) -> List[int]:
    """(video_utils.py:23-60)."""
    rng = rng or random
    if sample in ("rand", "middle"):
        acc = min(num_frames, vlen)
        intervals = np.linspace(0, vlen, acc + 1).astype(int)
        ranges = [(intervals[i], intervals[i + 1] - 1)
                  for i in range(acc)]
        if fix_start is not None:
            idx = [x[0] + fix_start for x in ranges]
        elif sample == "rand":
            try:
                idx = [rng.choice(range(x[0], max(x[1], x[0] + 1)))
                       for x in ranges]
            except Exception:  # noqa: BLE001
                idx = sorted(np.random.permutation(vlen)[:acc].tolist())
        else:  # middle
            idx = [(x[0] + x[1]) // 2 for x in ranges]
        if len(idx) < num_frames:
            idx = idx + [idx[-1]] * (num_frames - len(idx))
        return idx
    if sample.startswith("fps"):
        out_fps = float(sample[3:])
        duration = vlen / input_fps
        delta = 1.0 / out_fps
        secs = np.arange(delta / 2, duration + delta / 2, delta)
        idx = [int(e) for e in np.around(secs * input_fps) if e < vlen]
        if max_num_frames > 0:
            idx = idx[:max_num_frames]
        return idx
    raise ValueError(sample)


class FrameSampler:
    """(video_utils.py:117-127): a random frame count in
    [min_num_frames, max_num_frames], interval sampling; directories of
    frames (trailing '/') or video files."""

    def __init__(self, max_num_frames: int = -1, min_num_frames: int = 8,
                 sample: str = "rand", rng: Optional[random.Random] = None):
        self.max_num_frames = max_num_frames
        self.min_num_frames = min_num_frames
        self.sample = sample
        self.rng = rng or random

    def __call__(self, path: str) -> List[np.ndarray]:
        if path.endswith("/"):
            files = sorted(os.listdir(path))
            frames = []
            for f in files:
                from PIL import Image
                frames.append(np.asarray(
                    Image.open(os.path.join(path, f)).convert("RGB")))
        else:
            from .video_io import read_video_frames
            frames = [np.asarray(f) for f in read_video_frames(path)]
        vlen = len(frames)
        target = np.random.randint(self.min_num_frames,
                                   max(self.max_num_frames,
                                       self.min_num_frames) + 1) \
            if self.max_num_frames > 0 else vlen
        if vlen > target:
            idx = get_frame_indices(target, vlen, sample=self.sample,
                                    rng=self.rng)
            frames = [frames[i] for i in idx]
        return frames


def _change_format(conversations: List[Dict], num_images: int
                   ) -> List[Dict]:
    """vlm_dataset.change_format (:101-128): interleave text/image
    elements; gpt turns carry CE loss."""
    elements: List[Dict] = []
    for conv in conversations:
        if conv["from"] == "human":
            if "<image>" not in conv["value"]:
                elements.append({"type": "text", "has_loss": 0,
                                 "text": conv["value"]})
            else:
                parts = conv["value"].split("<image>")
                for idx, text in enumerate(parts):
                    if text.strip():
                        elements.append({"type": "text", "has_loss": 0,
                                         "text": text.strip()})
                    if idx != len(parts) - 1 and idx < num_images:
                        elements.append({"type": "image"})
        elif conv["from"] == "gpt":
            elements.append({"type": "text", "has_loss": 1,
                             "text": conv["value"]})
    return elements


class SftJSONLIterableDataset(DistributedIterableDataset):
    """VLM SFT jsonl -> packer samples (vlm_dataset.py:20-196)."""

    def __init__(self, jsonl_path_list: Sequence[str],
                 image_dir_list: Sequence[str], transform: ImageTransform,
                 tokenizer, frame_sampler: Optional[FrameSampler] = None,
                 num_used_data: Optional[Sequence[int]] = None,
                 local_rank: int = 0, world_size: int = 1,
                 shuffle_lines: bool = False, shuffle_seed: int = 0,
                 data_status=None):
        rows = []
        for i, (jp, img_dir) in enumerate(zip(jsonl_path_list,
                                              image_dir_list)):
            with open(jp) as f:
                lines = f.readlines()
            if shuffle_lines:
                r = random.Random(shuffle_seed)
                r.shuffle(lines)
            if num_used_data:
                lines = lines[: num_used_data[i]]
            rows.extend((ln, img_dir) for ln in lines)
        super().__init__(rows, local_rank, world_size,
                         data_status=data_status)
        self.transform = transform
        self.tokenizer = tokenizer
        self.frame_sampler = frame_sampler or FrameSampler()

    def __iter__(self) -> Iterator[Dict]:
        from PIL import Image

        for row_idx, (line, image_dir) in self.resume_rows():
            try:
                item = json.loads(line)
                raw_images = None
                if "image" in item:
                    names = item["image"] if isinstance(item["image"],
                                                        list) \
                        else [item["image"]]
                    raw_images = [np.asarray(Image.open(
                        os.path.join(image_dir, n)).convert("RGB"))
                        for n in names]
                elif "video" in item:
                    raw_images = self.frame_sampler(
                        os.path.join(image_dir, item["video"]))
                    specials = "<image>" * len(raw_images)
                    for conv in item["conversations"]:
                        if "<video>" in conv["value"]:
                            conv["value"] = conv["value"].replace(
                                "<video>", specials)
                            break
                    else:
                        raise ValueError("no <video> placeholder")
            except Exception:  # noqa: BLE001
                continue

            num_tokens = 0
            image_list: List[np.ndarray] = []
            if raw_images:
                for img in raw_images:
                    t = self.transform(img, img_num=len(raw_images))
                    image_list.append(t)
                    num_tokens += (t.shape[0] // self.transform.stride) \
                        * (t.shape[1] // self.transform.stride)

            elements = _change_format(item["conversations"],
                                      len(image_list))
            text_ids_list, sequence_plan = [], []
            for el in elements:
                if el["type"] == "text":
                    ids = self.tokenizer.encode(el["text"])
                    if ids:
                        text_ids_list.append(ids)
                        num_tokens += len(ids)
                        sequence_plan.append({
                            "type": "text", "enable_cfg": 0,
                            "loss": el["has_loss"],
                            "special_token_loss": 0})
                else:
                    sequence_plan.append({
                        "type": "vit_image", "enable_cfg": 0, "loss": 0,
                        "special_token_loss": 0})
            if not any(p["loss"] for p in sequence_plan):
                continue
            yield {
                "image_list": image_list,
                "text_ids_list": text_ids_list,
                "sequence_plan": sequence_plan,
                "num_tokens": num_tokens,
                "data_indexes": {"data_indexes": row_idx,
                                 "dataset_name": "sft_jsonl"},
            }


class T2IIterableDataset(DistributedIterableDataset):
    """T2I records -> packer samples (t2i_dataset.py:17-140): caption
    (cfg-droppable) + noised vae image with MSE loss. Records come from
    jsonl {image: path, captions: {k: v}} or parquet when pyarrow is
    available; latent_fn encodes pixels -> [h_lat, w_lat, patch_dim]."""

    def __init__(self, records: Sequence, transform: ImageTransform,
                 tokenizer, latent_fn: Callable[[np.ndarray], np.ndarray],
                 image_dir: str = "", local_rank: int = 0,
                 world_size: int = 1,
                 rng: Optional[random.Random] = None, data_status=None):
        super().__init__(list(records), local_rank, world_size,
                         data_status=data_status)
        self.transform = transform
        self.tokenizer = tokenizer
        self.latent_fn = latent_fn
        self.image_dir = image_dir
        self.rng = rng or random.Random(0)

    @classmethod
    def from_jsonl(cls, jsonl_path: str, **kw) -> "T2IIterableDataset":
        with open(jsonl_path) as f:
            records = [json.loads(l) for l in f if l.strip()]
        return cls(records, **kw)

    @classmethod
    def from_parquet(cls, parquet_paths: Sequence[str],
                     **kw) -> "T2IIterableDataset":
        """Reference parquet layout (t2i_dataset.py:55-85): row groups
        with `image` (encoded bytes) and `captions` (json-dict string)
        columns; rows stream through the same bytes/caption handling as
        jsonl records."""
        import pyarrow.parquet as pq
        records = []
        for path in parquet_paths:
            fr = pq.ParquetFile(path)
            for rg in range(fr.num_row_groups):
                tbl = fr.read_row_group(rg, columns=["image", "captions"])
                for img, caps in zip(tbl.column("image").to_pylist(),
                                     tbl.column("captions").to_pylist()):
                    records.append({"image": img, "captions": caps})
        return cls(records, **kw)

    def __iter__(self) -> Iterator[Dict]:
        from PIL import Image

        for row_idx, rec in self.resume_rows():
            try:
                if isinstance(rec.get("image"), (bytes, bytearray)):
                    import io
                    img = np.asarray(Image.open(
                        io.BytesIO(rec["image"])).convert("RGB"))
                else:
                    img = np.asarray(Image.open(os.path.join(
                        self.image_dir, rec["image"])).convert("RGB"))
            except Exception:  # noqa: BLE001
                continue
            pix = self.transform(img)
            latent = np.asarray(self.latent_fn(pix))
            num_tokens = latent.shape[0] * latent.shape[1]

            caps = rec.get("captions", {})
            if isinstance(caps, str):
                caps = json.loads(caps)
            tokens = [self.tokenizer.encode(v) for v in caps.values()]
            ids = self.rng.choice(tokens) if tokens else \
                self.tokenizer.encode(" ")
            num_tokens += len(ids)

            yield {
                "image_list": [latent],
                "text_ids_list": [ids],
                "sequence_plan": [
                    {"type": "text", "enable_cfg": 1, "loss": 0,
                     "special_token_loss": 0},
                    {"type": "vae_image", "enable_cfg": 0, "loss": 1,
                     "special_token_loss": 0},
                ],
                "num_tokens": num_tokens,
                "data_indexes": {"data_indexes": row_idx,
                                 "dataset_name": "t2i"},
            }
