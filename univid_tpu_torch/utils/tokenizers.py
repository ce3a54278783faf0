"""Tokenizers (counterpart of univid_tpu/utils/tokenizers.py).

`load_tokenizer` wraps a local HF tokenizer directory (the UMT5 tokenizer
of a Wan checkpoint, BAGEL's Qwen2 tokenizer, a SigLIP2 checkpoint's) in
`HFTokenizerWrapper`; it needs the `transformers` package, imported when
called, and resolves only local files. `HashTokenizer` is a deterministic
offline stand-in (word -> stable hash bucket) with the same encode /
decode surface for hermetic runs; it is not vocabulary-compatible with
checkpoints.
"""

from __future__ import annotations

import hashlib
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional


# Special token ids appended by the reference (data_utils.py:130-165 adds
# <|im_start|>, <|im_end|>, <|vision_start|>, <|vision_end|> to Qwen2).
QWEN2_SPECIAL_TOKENS = {
    "bos_token_id": 151644,   # <|im_start|>
    "eos_token_id": 151645,   # <|im_end|>
    "start_of_image": 151652,
    "end_of_image": 151653,
}


# the files of a tokenizer directory (one is enough): a `tokenizers`
# serialization, a sentencepiece model, or a BPE / WordPiece vocabulary
TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "spiece.model",
                   "sentencepiece.bpe.model", "vocab.json", "vocab.txt")


def load_tokenizer(path_or_name: str, *, seq_len: Optional[int] = None,
                   clean: str = "whitespace"):
    """transformers' AutoTokenizer from a local path, wrapped; raises
    RuntimeError when the package is missing or the tokenizer is not
    there offline. A directory must hold one of TOKENIZER_FILES: from a
    config.json alone, transformers 5 builds a tokenizer with an empty
    vocabulary (every word its unknown token) instead of raising."""
    try:
        if os.path.isdir(path_or_name) and not any(
                os.path.exists(os.path.join(path_or_name, f))
                for f in TOKENIZER_FILES):
            raise FileNotFoundError("no tokenizer file in the directory ("
                                    + ", ".join(TOKENIZER_FILES) + ")")
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(path_or_name,
                                            local_files_only=True)
        return HFTokenizerWrapper(tok, seq_len=seq_len, clean=clean)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"tokenizer '{path_or_name}' unavailable offline ({e}); pass a "
            "local checkpoint directory or use HashTokenizer for smoke "
            "tests") from e


class HFTokenizerWrapper:
    """Thin wrapper matching the reference HuggingfaceTokenizer surface
    (whitespace cleaning, optional pad / truncate to seq_len)."""

    def __init__(self, tokenizer, seq_len: Optional[int] = None,
                 clean: str = "whitespace"):
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.clean = clean

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return re.sub(r"\s+", " ", text).strip()
        return text

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(self._clean(text),
                                     add_special_tokens=False)

    def decode(self, ids: List[int]) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    def batch_encode_padded(self, texts: List[str],
                            seq_len: Optional[int] = None):
        """(ids [B, seq_len] as lists, lens [B]) for the UMT5 contract;
        `seq_len` defaults to the wrapper's."""
        seq_len = self.seq_len if seq_len is None else seq_len
        out_ids, lens = [], []
        for t in texts:
            ids = self.encode(t)
            if seq_len is not None:
                ids = ids[:seq_len]
            lens.append(len(ids))
            if seq_len is not None:
                ids = ids + [0] * (seq_len - len(ids))
            out_ids.append(ids)
        return out_ids, lens


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
