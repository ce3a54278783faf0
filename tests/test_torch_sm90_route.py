"""The dispatch around the Hopper bf16 forward (csrc/flash_attention_sm90.cu)
on the CPU: which kernel each bf16 forward call reaches on the card
(`bf16_forward_route`), TMA's rules for the kernel's tensor maps on strided
views (`tma_strides`), the kernel's q-tile grid for ragged lengths
(`sm90_q_tiles`), and the function those modes compute at the ragged,
grouped shapes the new kernel splits differently (the plain version here)
against univid_tpu's Pallas kernel in interpret mode.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold it against its plain version and the mma.sync kernel.
Tolerance of the JAX comparison: bf16 2e-2 relative (p and the output round
to bf16, 2^-8, at the same points in both).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu_torch.kernels import flash_attention as tfa

LOG2E = math.log2(math.e)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


Q = _t((1, 128, 14, 128))
KV = _t((1, 256, 14, 128))
KV_G7 = _t((1, 256, 2, 128))

# (mode, kwargs, kv, expected): the kernel name, or the exception raised
ROUTES = {
    "bounded": ("bounded", {}, KV, "sm90"),
    "running": ("running", {}, KV, "sm90"),
    "oneshot": ("oneshot", {}, KV, "sm90"),
    "bounded_lse": ("bounded", dict(lse=True), KV, "sm90"),
    "running_lse": ("running", dict(lse=True), KV, "sm90"),
    "running_grouped": ("running", {}, KV_G7, "sm90"),
    "bounded_grouped_lse": ("bounded", dict(lse=True), KV_G7, "sm90"),
    "sbf16_bounded": ("bounded", dict(softmax_bf16=True), KV, "sm90"),
    "sbf16_running": ("running", dict(softmax_bf16=True), KV, "sm90"),
    "sbf16_oneshot": ("oneshot", dict(softmax_bf16=True), KV_G7, "sm90"),
    "causal": ("running", dict(causal=True), KV_G7, "causal_sm90"),
    "causal_lse": ("running", dict(causal=True, lse=True), KV,
                   "causal_sm90"),
    "segments": ("running", dict(seg="segments"), KV_G7, "sm90"),
    "segments_lse": ("running", dict(seg="segments", lse=True), KV, "sm90"),
    "packed": ("running", dict(seg="packed"), KV, "sm90"),
    "packed_lse": ("running", dict(seg="packed", lse=True), KV, "sm90"),
    "causal_bounded": ("bounded", dict(causal=True), KV,
                       NotImplementedError),
    "packed_oneshot": ("oneshot", dict(seg="packed"), KV,
                       NotImplementedError),
    "causal_segments": ("running", dict(causal=True, seg="segments"), KV,
                        NotImplementedError),
    "sbf16_lse": ("bounded", dict(softmax_bf16=True, lse=True), KV,
                  NotImplementedError),
    "sbf16_causal": ("running", dict(softmax_bf16=True, causal=True), KV,
                     NotImplementedError),
    "sbf16_packed": ("running", dict(softmax_bf16=True, seg="packed"), KV,
                     NotImplementedError),
    "unknown_mode": ("exact", {}, KV, ValueError),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_bf16_forward_route(case):
    """Every unmasked bf16 forward (bounded, running, one-shot; with the
    lse; grouped kv heads; the softmax_bf16 chain) and the segment and
    packed modes (with and without the lse) reach the sm90 kernel, the
    causal mode (with and without the lse) the causal sm90 kernel
    (flash_attention_causal_sm90.cu), none the mma.sync kernel; a call that
    no kernel takes raises."""
    mode, kw, kv, want = ROUTES[case]
    if isinstance(want, str):
        assert tfa.bf16_forward_route(Q, kv, kv, mode=mode, **kw) == want
    else:
        with pytest.raises(want):
            tfa.bf16_forward_route(Q, kv, kv, mode=mode, **kw)


@pytest.mark.parametrize("q, k, exc", [
    (Q.float(), KV.float(), TypeError),
    (Q, KV.float(), TypeError),
    (_t((1, 128, 14, 64)), _t((1, 256, 14, 64)), ValueError),
    (Q, _t((1, 256, 4, 128)), ValueError),   # 14 query heads over 4
])
def test_bf16_forward_route_refuses_operands(q, k, exc):
    """fp32 operands, a head dim other than 128 and a kv head count that
    does not divide the query heads reach no bf16 forward kernel."""
    with pytest.raises(exc):
        tfa.bf16_forward_route(q, k, k, mode="running")


def _cache_slice():
    # BAGEL's KV cache: [B, capacity, kv heads, D], the live rows sliced
    return _t((2, 4096, 4, 128))[:, :2048]


def _stacked_cache_layer():
    return _t((28, 1, 2048, 4, 128))[3]


def _fused_q():
    # q, k, v sliced from one fused [B, L, 3 N D] projection
    qkv = _t((2, 64, 3 * 2 * 128))
    return qkv[..., 2 * 128:4 * 128].view(2, 64, 2, 128)


def _one_head():
    return _t((1, 64, 3, 128))[:, :, 1:2]


def _batch_one_odd_stride():
    # a size-1 batch axis whose stride TMA would refuse (3 elements)
    return torch.as_strided(_t((64 * 256,)), (1, 64, 2, 128),
                            (3, 256, 128, 1))


STRIDES = {
    "contiguous": (lambda: _t((2, 320, 2, 128)),
                   [320 * 256, 256, 128]),
    "kv_cache_slice": (_cache_slice, [4096 * 512, 512, 128]),
    "stacked_cache_layer": (_stacked_cache_layer, [2048 * 512, 512, 128]),
    "fused_projection_q": (_fused_q, [64 * 768, 768, 128]),
    "one_head_of_three": (_one_head, [64 * 384, 384, 128]),
    "batch_of_one": (_batch_one_odd_stride, [64 * 256, 256, 128]),
}


@pytest.mark.parametrize("case", list(STRIDES))
def test_tma_strides_of_views(case):
    """Strided views the paths hand the kernel are read in place: the
    element strides go to the tensor maps as they are; a dimension of size
    1 takes a contiguous tensor's stride (TMA never steps along it)."""
    make, want = STRIDES[case]
    assert tfa.tma_strides(make()) == want


def _misaligned():
    # a base 8 bytes past an aligned allocation
    return _t((2 * 64 * 256 + 4,)).view(-1)[4:].view(2, 64, 2, 128)


def _odd_head_stride():
    return _t((1, 64, 2, 132))[..., :128]


def _transposed_d():
    return _t((1, 64, 128, 2)).transpose(2, 3)


@pytest.mark.parametrize("make, match", [
    (_misaligned, "16-byte aligned base"),
    (_odd_head_stride, "multiples of 16 bytes"),
    (_transposed_d, "unit stride"),
])
def test_tma_strides_refuse_views_tma_cannot_read(make, match):
    """A view that breaks TMA's rules raises before any launch: a base
    that is not 16-byte aligned, a stride that is not a multiple of 16
    bytes, a D axis that is not unit-stride."""
    with pytest.raises(ValueError, match=match):
        tfa.tma_strides(make())


@pytest.mark.parametrize("lq, tiles", [
    (64, 1), (128, 1), (192, 2), (2112, 17), (28672, 224), (32768, 256)])
def test_sm90_q_tiles(lq, tiles):
    """One block per 128 q rows: BAGEL's 2,112-row ViT append (2,050 rows
    padded to 64) takes 17, the last a half tile."""
    assert tfa.sm90_q_tiles(lq) == tiles


def _rand(shape, seed, normed=True):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normed:
        x = x / np.linalg.norm(x, axis=-1, keepdims=True) * shape[-1] ** 0.5
    return x


@pytest.mark.parametrize("bounded", [True, False])
def test_ragged_grouped_forward_matches_pallas(bounded):
    """The function of the sm90 modes at a shape the new kernel tiles
    raggedly (192 q rows: one and a half 128-row tiles; 448 keys: three
    and a half 128-key tiles, kv_len 300 and 448) with 14 query heads over
    2 kv heads: the port's dispatcher (plain version on the CPU) against
    the Pallas kernel in interpret mode on the repeated kv heads, as the
    JAX prefill hands them to it."""
    b, lq, lk, n, nk, d = 2, 192, 448, 14, 2, 128
    q = _rand((b, lq, n, d), 80)
    k = _rand((b, lk, nk, d), 81)
    v = _rand((b, lk, nk, d), 82, normed=False)
    kv = np.array([300, 448], np.int32)
    fb = 1.01 * d / math.sqrt(d) * LOG2E if bounded else None
    rep = lambda x: np.repeat(x, n // nk, axis=2)   # noqa: E731
    want = jfa.flash_attention_padded(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(rep(k), jnp.bfloat16),
        jnp.asarray(rep(v), jnp.bfloat16), block_q=64, block_k=64,
        interpret=True, kv_len=jnp.asarray(kv),
        score_bound=None if fb is None else jnp.float32(fb))
    got = tfa.flash_attention_padded(
        *(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)),
        kv_len=torch.as_tensor(kv),
        score_bound=None if fb is None else torch.tensor(fb))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
