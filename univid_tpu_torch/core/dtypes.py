"""Dtype policy: bf16 compute with fp32 islands (counterpart of
univid_tpu/core/dtypes.py, with the same flags).

Parameters and activations in bfloat16; fp32 for normalisation statistics,
rotary tables, modulation, time embeddings and solver state. The residual
stream accumulates in fp32 unless BF16_RESIDUAL_POLICY is chosen.
`softmax_bf16` (--bf16_softmax: the flash kernels' softmax chain in bf16)
and `qk_int8` (--qk_int8: int8 QK^T in the self-attention kernel) are
inference knobs of the DiT's attention: self-attention takes both,
cross-attention `softmax_bf16` only; the training forward ignores them, as
the JAX package's does. No gain is claimed for either: the JAX package
measured both slower on its TPU.
`bounded_softmax` pins the flash kernel's softmax reference point at the
qk-norm score bound d * max|g_q| * max|g_k| (exact; no running max).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    residual_dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32
    modulation_dtype: torch.dtype = torch.float32
    time_embed_dtype: torch.dtype = torch.float32
    rope_dtype: torch.dtype = torch.float32
    solver_dtype: torch.dtype = torch.float32
    softmax_bf16: bool = False
    qk_int8: bool = False
    bounded_softmax: bool = False


DEFAULT_POLICY = DTypePolicy()

# residual stream in bf16 (norm statistics and modulation stay fp32)
BF16_RESIDUAL_POLICY = DTypePolicy(residual_dtype=torch.bfloat16)

# full precision, for parity tests
FP32_POLICY = DTypePolicy(param_dtype=torch.float32,
                          compute_dtype=torch.float32)
