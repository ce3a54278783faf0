"""The port's attention kernels' plain versions and dispatcher against
univid_tpu's Pallas kernels (interpret mode, as tests/test_attention.py
runs them) and its XLA reference.

Tolerances: fp32 inputs agree to 2e-5 (the JAX kernel's online softmax and
the plain version's one-shot max differ only in fp32 rounding); bf16
inputs to 2e-2 relative (p and the output round to bf16, 2^-8, at the same
points in both). The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py and chip_smoke.py hold them against these plain
versions there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu.kernels.attention import attention as jattention
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu_torch.kernels import attention as tatt
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d

torch.set_num_threads(2)
LOG2E = math.log2(math.e)
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rand(shape, seed, normed=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normed:  # qk-normed rows (norm sqrt(d)), the Wan case
        x = x / np.linalg.norm(x, axis=-1, keepdims=True) * shape[-1] ** 0.5
    return x


def _both(x, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jd), torch.as_tensor(x).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounded", [True, False])
def test_flash_fused_rope_kv_len_matches_pallas(dtype, bounded):
    """Fused rope + kv_len (+ bound; + the rotated-k cache on the JAX side)
    == the Pallas kernel: same rounding points (rotated q in q's dtype,
    rotated k in v's dtype, p in v's dtype)."""
    b, l, n, d = 2, 256, 2, 128
    qj, qt = _both(_rand((b, l, n, d), 0, True), dtype)
    kj, kt = _both(_rand((b, l, n, d), 1, True), dtype)
    vj, vt = _both(_rand((b, l, n, d), 2), dtype)
    grid = (4, 8, 8)
    jtabs = jfa.build_fused_rope_tables(*jrope3d(d, grid), d)
    ttabs = tfa.build_fused_rope_tables(*trope3d(d, grid, device="cpu"), d)
    kv = np.array([200, 97], np.int32)
    fb = 1.01 * d / math.sqrt(d) * LOG2E if bounded else None
    want = jfa.flash_attention_padded(
        qj, kj, vj, block_q=128, block_k=128, interpret=True,
        rope_tables=jtabs, kv_len=jnp.asarray(kv), cache_rot_k=True,
        score_bound=None if fb is None else jnp.float32(fb))
    got = tfa.flash_attention_padded(
        qt, kt, vt, rope_tables=ttabs, kv_len=torch.as_tensor(kv),
        score_bound=None if fb is None else torch.tensor(fb))
    np.testing.assert_allclose(_np(got), _np(want),
                               **(FP32 if dtype == "float32" else BF16))


def test_flash_plain_kv_len_d384_fp32_matches_pallas():
    """The VAE mode: one head of d=384, fp32, running max, kv_len; q is
    folded by scale * log2(e) in fp32 inside both wrappers."""
    b, l, n, d = 1, 256, 1, 384
    q, k, v = (_rand((b, l, n, d), s) for s in (3, 4, 5))
    kv = np.array([200], np.int32)
    want = jfa.flash_attention_padded(
        *(jnp.asarray(x) for x in (q, k, v)), block_q=128, block_k=128,
        interpret=True, kv_len=jnp.asarray(kv))
    got = tfa.flash_attention_padded(
        *(torch.as_tensor(x) for x in (q, k, v)), kv_len=torch.as_tensor(kv))
    np.testing.assert_allclose(_np(got), _np(want), **FP32)


@pytest.mark.parametrize("d", [640, 1024])
def test_attention_f32_wide_matches_pallas(d):
    """The ti2v-5B VAE's modes (encoder d=640, decoder d=1024): one head,
    fp32, through both dispatchers, the JAX one on its Pallas kernel in
    interpret mode. Lq = Lk = 200 is padded (to 64 here, to the Pallas
    block there) and kv_len = 150 masks the rest: 1e-5 + 1e-4 |ref|, the
    fp32 limit of the card's kernel against this plain version."""
    q, k, v = (_rand((1, 200, 1, d), s) for s in (20, 21, 22))
    kv = np.array([150], np.int32)
    jbackend("pallas")
    jfa.set_interpret_mode(True)
    try:
        want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          kv_len=jnp.asarray(kv))
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    got = tatt.attention(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), kv_len=torch.as_tensor(kv))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["siglip_pad", "kv_len", "empty_row"])
def test_segment_reference_matches_jax(case):
    """Segment masks on the reference route (d=72, SigLIP's head dim) ==
    the JAX dispatcher's XLA path: 'siglip_pad' pads a 50-patch image to
    64 with segment -1 on both sides (pad queries see pad keys);
    'kv_len' adds a key mask; 'empty_row' gives queries a segment no key
    has, whose rows are exactly zero. fp32, 2e-5."""
    b, l, n, d = 2, 64, 2, 72
    q, k, v = (_rand((b, l, n, d), s) for s in (30, 31, 32))
    segs = np.zeros((b, l), np.int32)
    segs[:, 50:] = -1
    segs[1, 20:35] = 1
    kv_segs, kv = segs.copy(), None
    if case == "kv_len":
        kv = np.array([64, 40], np.int32)
    if case == "empty_row":
        segs[0, 10:14] = 7
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      q_segments=jnp.asarray(segs),
                      kv_segments=jnp.asarray(kv_segs),
                      kv_len=None if kv is None else jnp.asarray(kv))
    got = tatt.attention(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v),
                         q_segments=torch.as_tensor(segs),
                         kv_segments=torch.as_tensor(kv_segs),
                         kv_len=None if kv is None else torch.as_tensor(kv))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FP32)
    if case == "empty_row":
        assert np.all(_np(got)[0, 10:14] == 0.0)


@pytest.mark.parametrize("use_kvlen", [False, True])
@pytest.mark.parametrize("bound", [None, 16.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_matches_pallas_cross_kernel(use_kvlen, bound, dtype):
    """Single-kv-block attention == _cross_attention_padded (one-shot
    softmax by max or by bound; masked p exactly 0)."""
    b, lq, lk, n, d = 2, 512, 128, 3, 128
    sc = LOG2E / math.sqrt(d)
    q = _rand((b, lq, n, d), 6) * np.float32(sc)   # pre-folded
    qj, qt = _both(q, dtype)
    kj, kt = _both(_rand((b, lk, n, d), 7), dtype)
    vj, vt = _both(_rand((b, lk, n, d), 8), dtype)
    kv = np.array([128, 100], np.int32) if use_kvlen else None
    fb = None if bound is None else bound * sc
    want = jfa._cross_attention_padded(
        qj, kj, vj, kv_len=None if kv is None else jnp.asarray(kv),
        score_bound=None if fb is None else jnp.float32(fb), block_q=256,
        softmax_bf16=False, interpret=True)
    got = tfa.cross_attention_padded(
        qt, kt, vt, kv_len=None if kv is None else torch.as_tensor(kv),
        score_bound=None if fb is None else torch.tensor(fb))
    np.testing.assert_allclose(_np(got), _np(want),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("lk", [128, 1024])
def test_zero_kv_len_rows_are_zero(lk):
    """kv_len == 0 gives exact zero rows (one kv block at lk=128, several
    at lk=1024), like the Pallas kernel."""
    b, lq, n, d = 2, 256, 2, 128
    q, k, v = (_rand((b, x, n, d), s) for s, x in ((9, lq), (10, lk),
                                                    (11, lk)))
    kv = np.array([0, lk - 5], np.int32)
    want = jfa.flash_attention_padded(
        *(jnp.asarray(x) for x in (q, k, v)), block_q=128, block_k=128,
        interpret=True, kv_len=jnp.asarray(kv))
    got = tfa.flash_attention_padded(
        *(torch.as_tensor(x) for x in (q, k, v)), kv_len=torch.as_tensor(kv))
    assert np.all(_np(got)[0] == 0.0)
    np.testing.assert_allclose(_np(got), _np(want), **FP32)


def _dispatch_case(seed, lq, lk, n, d, rope, bound):
    q = _rand((2, lq, n, d), seed, True)
    k = _rand((2, lk, n, d), seed + 1, True)
    v = _rand((2, lk, n, d), seed + 2)
    jt = tt = None
    if rope:
        grid = (lq // 40, 5, 8)
        jt = jfa.build_fused_rope_tables(*jrope3d(d, grid), d)
        tt = tfa.build_fused_rope_tables(*trope3d(d, grid, device="cpu"), d)
    sb = 1.01 * d if bound else None
    return q, k, v, jt, tt, sb


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", ["self_rope_bound", "self_plain",
                                  "cross_bound", "d64_reference"])
def test_dispatcher_matches_jax(backend, case):
    """Padding to the tile multiple, kv_len for padded keys, the raw-bound
    fold and the d % 128 route: port `attention` == univid_tpu `attention`
    in fp32 under both JAX backends (both sides compute an exact fp32
    softmax, so the bound changes nothing beyond rounding)."""
    lq, lk, n, d, rope, bound = {
        "self_rope_bound": (200, 200, 2, 128, True, True),
        "self_plain": (200, 200, 2, 128, False, False),
        "cross_bound": (300, 40, 2, 128, False, True),
        "d64_reference": (120, 120, 2, 64, True, False),
    }[case]
    q, k, v, jt, tt, sb = _dispatch_case(12, lq, lk, n, d, rope, bound)
    jbackend(backend)
    jfa.set_interpret_mode(backend == "pallas")
    try:
        want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          rope_tables=jt, score_bound=sb)
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    got = tatt.attention(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), rope_tables=tt, score_bound=sb)
    assert got.shape == (2, lq, n, d)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FP32)


def test_dispatcher_refuses_later_modes():
    """Grouped kv heads under grad are refused (callers repeat them, as JAX
    does); segments need both id arrays, and packed_mode takes no q
    offsets (as in JAX). Causal attention and segment ids under grad take
    the kernel route; the serving knobs are held in test_torch_knobs.py."""
    x = torch.zeros((1, 64, 1, 128))
    with pytest.raises(ValueError, match="both"):
        tatt.attention(x, x, x, q_segments=torch.zeros((1, 64)))
    codes = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(AssertionError, match="q offsets"):
        tatt.attention(x, x, x, q_segments=codes, kv_segments=codes,
                       packed_mode=True, q_offset=3)
    qg = torch.zeros((1, 64, 2, 128), requires_grad=True)
    with pytest.raises(NotImplementedError, match="grouped"):
        tatt.attention(qg, x, x)
    xg = x.clone().requires_grad_(True)
    for kw in (dict(causal=True), dict(q_segments=codes, kv_segments=codes,
                                       packed_mode=True)):
        out = tatt.attention(xg, xg, xg, **kw)
        assert out.shape == x.shape and out.requires_grad


# causal cases: (lq, lk, static q_offset, per-batch q_offsets, kv_len) --
# offsets that are not multiples of 64, a q tile straddling kv_len, the
# padded query tail (rows past kv_len), B = 2 rows with different offsets
CAUSAL = {
    "square": (128, 128, 0, None, None),
    "static_offset": (64, 192, 70, None, (150, 134)),
    "q_offsets": (128, 320, 0, (37, 150), (101, 250)),
    "both": (64, 256, 5, (100, 61), (133, 256)),
}


def _causal_inputs(case, n, nk, d, seed):
    lq, lk, qoff, qoffs, kv = CAUSAL[case]
    q = _rand((2, lq, n, d), seed, True)
    k = _rand((2, lk, nk, d), seed + 1, True)
    v = _rand((2, lk, nk, d), seed + 2)
    return (q, k, v, qoff, None if qoffs is None else np.array(qoffs,
                                                               np.int32),
            None if kv is None else np.array(kv, np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CAUSAL))
def test_causal_plain_matches_pallas(case, dtype):
    """The causal mode's plain version (4 query heads over 2 kv heads,
    d=128) == the Pallas kernel in interpret mode (64-row blocks, its
    runtime dead-block skip and masked/clean split) on the kv heads
    repeated as the JAX prefill repeats them: same rounding points."""
    q, k, v, qoff, qoffs, kv = _causal_inputs(case, 4, 2, 128, 40)
    qj, qt = _both(q, dtype)
    kj, kt = _both(k, dtype)
    vj, vt = _both(v, dtype)
    want = jfa.flash_attention_padded(
        qj, jnp.repeat(kj, 2, axis=2), jnp.repeat(vj, 2, axis=2),
        causal=True, q_offset=qoff, block_q=64, block_k=64, interpret=True,
        q_offsets=None if qoffs is None else jnp.asarray(qoffs),
        kv_len=None if kv is None else jnp.asarray(kv))
    got = tfa.flash_attention_padded(
        qt, kt, vt, causal=True, q_offset=qoff,
        q_offsets=None if qoffs is None else torch.as_tensor(qoffs),
        kv_len=None if kv is None else torch.as_tensor(kv))
    np.testing.assert_allclose(_np(got), _np(want),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("case", ["q_offsets", "both"])
def test_causal_dispatcher_matches_jax(case, d):
    """Port `attention(causal=True, q_offset, q_offsets, kv_len)` on
    unpadded lengths (Lq 100 or 64, Lk 300 or 256) with grouped kv heads
    == the JAX
    dispatcher's XLA path on repeated ones, fp32: d=128 through the
    kernel route's plain version, d=64 through mha_reference."""
    q, k, v, qoff, qoffs, kv = _causal_inputs(case, 4, 2, d, 50)
    q, k, v = q[:, :100], k[:, :300], v[:, :300]
    kv = np.minimum(kv, 300).astype(np.int32)
    want = jattention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                      jnp.repeat(jnp.asarray(v), 2, axis=2), causal=True,
                      q_offset=qoff, q_offsets=jnp.asarray(qoffs),
                      kv_len=jnp.asarray(kv))
    got = tatt.attention(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), causal=True, q_offset=qoff,
                         q_offsets=torch.as_tensor(qoffs),
                         kv_len=torch.as_tensor(kv))
    assert got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **FP32)
