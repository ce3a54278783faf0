"""OpenVid-5M training dataset (counterpart of univid_tpu/data/openvid.py).

Reference OpenVidDataset (model_pipeline.py:1904-2108): scan a video
directory, join the OpenVid CSV captions on the 'video' column, filter by
quality (aesthetic >= 4.5, motion >= 3.0, temporal consistency >= 0.8,
duration >= 3 s, caption length > 10), fall back to file-derived records
when the CSV is absent, and load `video_length` frames resized to
`video_size`, normalized to [-1, 1], channels-last [T, H, W, 3] float32.

The JAX package reads the CSV with pandas and falls back to file-derived
records when pandas does not import. The port reads it with the standard
library's `csv` module and applies pandas' semantics itself (`read_csv`),
so a machine without pandas keeps its captions:
  * pandas' default NA strings ('', 'NA', 'nan', 'None', ...) are missing
    values; a column whose present values all parse as numbers is numeric
    (int when every value is an integer literal and none is missing, else
    float, missing as NaN); every other column holds strings;
  * a comparison with a missing score is False (the row goes), as are
    missing `video` / `caption` values (`dropna`);
  * CSV order is kept, duplicates too, and the result is cut to as many
    rows as there are video files (`head`).
It falls back to file-derived records where JAX does: no CSV, a CSV that
does not parse, no `video` column, or no row for a scanned file.

A missing file or a failed decode yields zeros, as in JAX.
"""

from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..native import resize_bilinear

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".flv")

# pandas.read_csv's default na_values (pandas/_libs/parsers.pyx
# STR_NA_VALUES) plus the empty field
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


@dataclass
class OpenVidConfig:
    video_base_path: str = "data/openvid/videos"
    csv_file: str = "data/openvid/OpenVid-1M.csv"
    video_size: Tuple[int, int] = (512, 320)   # (W, H)
    video_length: int = 21
    max_samples: int = 1000
    min_aesthetic_score: float = 4.5
    min_motion_score: float = 3.0
    min_temporal_consistency: float = 0.8
    min_duration: float = 3.0


def _missing(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _number(s: str):
    """int or float of a CSV field, None if it is not a number literal."""
    if "_" in s:   # Python's int / float take '1_000'; pandas does not
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return None


def read_csv(path: str) -> Tuple[List[str], List[Dict], set]:
    """(columns, rows, numeric columns) of a CSV file as pandas.read_csv
    would type them (see the module docstring); rows are dicts in file
    order. Raises csv.Error, UnicodeDecodeError or ValueError (no header, a
    row longer than it) where pandas would fail to parse."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        lines = [r for r in csv.reader(f) if r]   # blank lines skipped
    if not lines:
        raise ValueError(f"{path}: no columns to parse")
    columns, body = lines[0], lines[1:]
    if any(len(r) > len(columns) for r in body):
        raise ValueError(f"{path}: a row has more fields than the header")
    raw = [[r[i] if i < len(r) and r[i] not in NA_STRINGS else None
            for i in range(len(columns))] for r in body]
    typed, numeric = [], set()
    for i, col in enumerate(columns):
        vals = [r[i] for r in raw]
        nums = [None if v is None else _number(v) for v in vals]
        if any(v is not None and n is None for v, n in zip(vals, nums)):
            typed.append([math.nan if v is None else v for v in vals])
            continue
        numeric.add(col)
        if any(v is None for v in vals) or any(
                isinstance(n, float) for n in nums):
            typed.append([math.nan if n is None else float(n) for n in nums])
        else:
            typed.append(nums)
    rows = [{c: typed[i][j] for i, c in enumerate(columns)}
            for j in range(len(body))]
    return columns, rows, numeric


class OpenVidDataset:
    """Map-style dataset; __getitem__ -> {'video': [T, H, W, 3] float32
    in [-1, 1], 'caption': str, 'quality_scores': dict}."""

    def __init__(self, cfg: OpenVidConfig):
        self.cfg = cfg
        self.video_files = self._scan_videos()
        self.records = self._load_and_filter()

    # ------------------------------------------------------------------
    def _scan_videos(self) -> List[str]:
        if not os.path.isdir(self.cfg.video_base_path):
            return []
        files = [f for f in sorted(os.listdir(self.cfg.video_base_path))
                 if f.lower().endswith(VIDEO_EXTENSIONS)]
        return files[: self.cfg.max_samples]

    def _load_and_filter(self) -> List[Dict]:
        if not self.video_files:
            return []
        if not os.path.exists(self.cfg.csv_file):
            return self._records_from_files()
        try:
            columns, rows, numeric = read_csv(self.cfg.csv_file)
        except (OSError, csv.Error, UnicodeDecodeError, ValueError):
            return self._records_from_files()
        if "video" not in columns:
            return self._records_from_files()
        files = set(self.video_files)
        rows = [r for r in rows if r["video"] in files]
        if not rows:
            return self._records_from_files()

        c = self.cfg
        for col, least in (("aesthetic score", c.min_aesthetic_score),
                           ("motion score", c.min_motion_score),
                           ("temporal consistency score",
                            c.min_temporal_consistency),
                           ("seconds", c.min_duration)):
            if col in columns:
                if any(isinstance(r[col], str) for r in rows):
                    raise TypeError(f"{self.cfg.csv_file}: column {col!r} "
                                    "holds text; '>=' needs numbers")
                rows = [r for r in rows if r[col] >= least]   # NaN: False
        rows = [r for r in rows if not _missing(r["video"])]
        if "caption" in columns:
            if "caption" in numeric:
                raise AttributeError(f"{self.cfg.csv_file}: column "
                                     "'caption' holds no text")
            rows = [r for r in rows if not _missing(r["caption"])]
            rows = [r for r in rows if len(str(r["caption"])) > 10]
        return rows[: len(self.video_files)]

    def _records_from_files(self) -> List[Dict]:
        # reference fallback (model_pipeline.py:1996-2012)
        return [{
            "video": f,
            "caption": f"High quality video content: "
                       f"{os.path.splitext(f)[0]}",
            "aesthetic score": 5.0, "motion score": 4.0,
            "temporal consistency score": 0.9, "seconds": 5.0,
        } for f in self.video_files]

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict:
        row = self.records[idx]
        w, h = self.cfg.video_size
        t = self.cfg.video_length
        path = os.path.join(self.cfg.video_base_path, row["video"])
        video = self._load_video(path) if os.path.exists(path) else \
            np.zeros((t, h, w, 3), np.float32)
        return {
            "video": video,
            "caption": str(row["caption"]),
            "quality_scores": {
                "aesthetic": row.get("aesthetic score", 5.0),
                "motion": row.get("motion score", 4.0),
                "temporal": row.get("temporal consistency score", 0.9),
            },
        }

    def _load_video(self, path: str) -> np.ndarray:
        from .video_io import read_video_frames

        w, h = self.cfg.video_size
        t = self.cfg.video_length
        try:
            frames = read_video_frames(path, num_frames=t)
        except Exception:  # noqa: BLE001 -- any decode failure: zeros, as JAX
            return np.zeros((t, h, w, 3), np.float32)
        out = []
        for f in frames[:t]:
            f = np.asarray(f, np.float32) / 255.0
            if f.shape[:2] != (h, w):
                f = resize_bilinear(f, h, w)
            out.append(f)
        # pad by repeating the last frame (model_pipeline.py:2092-2097)
        while len(out) < t:
            out.append(out[-1] if out else np.zeros((h, w, 3), np.float32))
        return (np.stack(out) - 0.5) * 2.0

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
