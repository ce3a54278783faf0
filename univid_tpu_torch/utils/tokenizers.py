"""Deterministic offline tokenizer (copy of univid_tpu/utils/tokenizers.py
HashTokenizer): word -> stable hash bucket, for hermetic runs without a
vocabulary. It is a stand-in, not vocabulary-compatible with checkpoints."""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class HashTokenizer:
    """decode() is lossy (token placeholders) except for ids seen during
    this process's encode calls, which round-trip exactly."""

    vocab_size: int = 151000
    reserved: int = 256  # low ids reserved (never produced by hashing)
    _seen: Dict[int, str] = field(default_factory=dict)

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in re.findall(r"\S+", text):
            h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
            tid = self.reserved + h % (self.vocab_size - self.reserved)
            self._seen[tid] = word
            ids.append(tid)
        return ids

    def decode(self, ids: List[int]) -> str:
        return " ".join(self._seen.get(i, f"<tok{i}>") for i in ids)

    def batch_encode_padded(self, texts: List[str], seq_len: int = 512):
        out_ids, lens = [], []
        for t in texts:
            ids = self.encode(t)[:seq_len]
            lens.append(max(len(ids), 1))
            out_ids.append(ids + [0] * (seq_len - len(ids)))
        return out_ids, lens
