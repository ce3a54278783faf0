"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: they skip on machines without one. The file imports neither
JAX nor univid_tpu, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Small shapes; chip_smoke.py holds the kernels at the main path's shapes.
Tolerances: fp32 2e-5 (rounding and the approximate exp2); bf16 2e-2
relative (one bf16 rounding of p and of the output, 2^-8).
"""

import math

import numpy as np
import pytest
import torch

from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d

LOG2E = math.log2(math.e)
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rand(shape, seed, normed=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normed:  # qk-normed rows (norm sqrt(d)), the Wan case
        x = x / np.linalg.norm(x, axis=-1, keepdims=True) * shape[-1] ** 0.5
    return x


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bounded_rope", "running", "cross",
                                  "cross_kvlen", "f32_d384"])
def test_cuda_kernel_matches_plain(cuda_device, mode):
    """Each kernel against its plain version on the card (small shapes; the
    main-path shapes are held in chip_smoke.py)."""
    d = 384 if mode == "f32_d384" else 128
    dt = torch.float32 if mode == "f32_d384" else torch.bfloat16
    lk = 256 if mode.startswith("cross") else 512
    q, k, v = (torch.as_tensor(_rand((2, x, 2, d), s, True)).to(cuda_device,
                                                                 dt)
               for s, x in ((0, 512), (1, lk), (2, lk)))
    kv = torch.tensor([lk, lk - 77], dtype=torch.int32, device=cuda_device)
    tabs = None
    bound = None
    if mode == "bounded_rope":
        tabs = tfa._pad_tables(tfa.build_fused_rope_tables(
            *trope3d(d, (8, 8, 8), device=cuda_device), d), 512, 512,
            LOG2E / math.sqrt(d))
        bound = torch.tensor([1.01 * d * LOG2E / math.sqrt(d)],
                             device=cuda_device)
    with torch.no_grad():
        if mode.startswith("cross"):
            kvl = kv if mode == "cross_kvlen" else None
            got = tfa.cross_attention_padded(q, k, v, kv_len=kvl)
            want = tfa.attention_plain(q, k, v, kv_len=kvl)
        else:
            got = tfa._flash_cuda(q, k, v, kv, bound, tabs)
            want = tfa.attention_plain(q, k, v, kv_len=kv, bound=bound,
                                       rope_tables=tabs)
    torch.cuda.synchronize()
    tol = FP32 if dt == torch.float32 else BF16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
