"""The accuracy argument of the fp32 VAE attention kernel
(csrc/flash_attention_f32_tc.cu), on the CPU: its 3xTF32 products emulated
bit for bit in their operands, held against an fp64 reference at the VAE's
head dims within the fp32 kernels' tolerance, and one TF32 product shown to
fall outside it.

TF32 rounding is emulated on the float32 bit pattern: round to nearest,
ties away from zero (cvt.rna.tf32.f32), to 10 mantissa bits. A 3xTF32
product of a and b splits each into hi = tf32(x) and lo = tf32(x - hi) and
sums lo_a hi_b + hi_a lo_b + hi_a hi_b in fp32; the products of TF32
values are exact in fp32, so the emulation differs from the tensor cores
only in summation order. The kernel's form: scores over every key, the
exact row max over the keys below kv_len, p = exp2(s - m) (0 past
kv_len), l = sum p, o = 3xTF32(p, v) / l (0 where l = 0).

Tolerance: PERF.md's fp32 bound, 1e-5 + 1e-4 |ref| elementwise, on
q, k, v ~ N(0, 1), q folded by log2(e) / sqrt(d), 256 queries over 2,048
keys. The tensor cores' fp32 accumulation truncates (rounds toward zero);
on large scores (rows of norm sqrt(d), unfolded: |s| ~ 20-60) the kernel
therefore sums each 16-deep stage's products into a fresh accumulator and
adds that with a round-to-nearest FADD: the last test holds that form,
with truncation emulated, within the card tests' 2e-5 + 2e-5 |ref|, where
one accumulator for every product is not.
"""

import math

import numpy as np
import pytest
import torch

from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
DIMS = [384, 640, 1024]
ATOL, RTOL = 1e-5, 1e-4


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, nearest, ties away), fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, three=True):
    """a @ b on TF32 tensor cores: three products (3xTF32) or one."""
    ah, bh = tf32(a), tf32(b)
    if not three:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def kernel_form(q, k, v, kv_end, three=True):
    """The kernel's function for one head: q [Lq, d] (folded), k, v
    [Lk, d]; keys at or past kv_end take no part."""
    s = product(q, k.T, three)
    live = torch.arange(k.shape[0]) < kv_end
    m = torch.where(live, s, tfa.NEG_INF).amax(-1, keepdim=True)
    p = torch.where(live, torch.exp2(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return product(p, v, three) * inv


def _inputs(d, lq=256, lk=2048):
    rng = np.random.default_rng(d)
    q, k, v = (torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
               for n in (lq, lk, lk))
    return q * (math.log2(math.e) / math.sqrt(d)), k, v


def _ref64(q, k, v):
    s = q.double() @ k.double().T
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return (p @ v.double()) / p.sum(-1, keepdim=True)


def _excess(got, ref):
    """max |got - ref| / (ATOL + RTOL |ref|): within the bound iff <= 1."""
    return float(((got.double() - ref).abs() / (ATOL + RTOL * ref.abs()))
                 .max())


@pytest.mark.parametrize("d", DIMS)
def test_3xtf32_attention_within_fp32_tolerance(d):
    """3xTF32 scores and p v are within the fp32 bound of the fp64
    attention, with a wide margin (the split loses ~2^-22 a product)."""
    q, k, v = _inputs(d)
    assert _excess(kernel_form(q, k, v, k.shape[0]), _ref64(q, k, v)) < 0.1


@pytest.mark.parametrize("d", DIMS)
def test_one_tf32_product_is_outside_the_tolerance(d):
    """One TF32 product rounds each operand to 2^-11: the same attention
    misses the fp32 bound by several times, at many outputs."""
    q, k, v = _inputs(d)
    got = kernel_form(q, k, v, k.shape[0], three=False)
    ref = _ref64(q, k, v)
    assert _excess(got, ref) > 2.0
    over = (got.double() - ref).abs() > ATOL + RTOL * ref.abs()
    assert int(over.sum()) > 0.01 * over.numel()


@pytest.mark.parametrize("d", [384, 1024])
def test_3xtf32_form_matches_plain_with_kv_len(d):
    """The kernel's form (exact row max, p zero past kv_len) against the
    port's plain fp32 attention with kv_len, the VAE's padded keys holding
    50.0: within the fp32 bound; a kv_len = 0 row is exactly 0."""
    q, k, v = _inputs(d, lk=1024)
    kv_end = 1024 - 40
    k[kv_end:] = 50.0
    v[kv_end:] = 50.0
    want = tfa.attention_plain(
        q[None, :, None], k[None, :, None], v[None, :, None],
        kv_len=torch.tensor([kv_end], dtype=torch.int32))[0, :, 0]
    got = kernel_form(q, k, v, kv_end)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert float(kernel_form(q, k, v, 0).abs().max()) == 0.0


def _round_toward_zero(x64):
    """fp64 values rounded to fp32 toward zero (the tensor cores'
    accumulation), as fp64."""
    y = x64.float()
    away = y.double().abs() > x64.abs()
    return torch.where(away, torch.nextafter(y, torch.zeros_like(y)),
                       y).double()


def _mma_scores(a, b, per_stage, k_step=8, stage=16):
    """a @ b as the kernel's mma.sync.m16n8k8 3xTF32 products: each
    instruction adds an exact 8-deep dot product to its accumulator and
    truncates; per_stage: a fresh accumulator a 16-deep stage, added to
    the running sum with a round-to-nearest FADD."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
    part = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], k_step):
        sl = slice(k0, k0 + k_step)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            dot = x[:, sl].double() @ y[sl].double()
            if per_stage:
                part = _round_toward_zero(part + dot)
            else:
                acc = _round_toward_zero(acc + dot)
        if per_stage and (k0 + k_step) % stage == 0:
            acc = (acc + part).float().double()
            part.zero_()
    return acc.float()


@pytest.mark.parametrize("form", ["stage_sums", "one_accumulator",
                                  "fp32"])
def test_stage_sums_bound_truncated_accumulation(form):
    """Unfolded rows of norm sqrt(384) (scores ~ N(0, 384), the card
    test's input) against fp64: with truncating accumulation, one
    accumulator for all 3 x 48 products a score misses 2e-5 + 2e-5 |ref|
    at many outputs; sums of one stage each, added by round-to-nearest,
    stay within it; plain fp32 products and sums miss it too (so the card
    test holds the kernel to this bound against fp64, not fp32)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((n, 384)).astype(np.float32)
               for n in (256, 512, 512))
    q, k, v = (torch.as_tensor(x / np.linalg.norm(x, axis=-1, keepdims=True)
                               * 384 ** 0.5) for x in (q, k, v))
    if form == "fp32":
        s = q @ k.T
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        got = (p @ v) / p.sum(-1, keepdim=True)
    else:
        s = _mma_scores(q, k.T, form == "stage_sums")
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        got = product(p, v) / p.sum(-1, keepdim=True)
    ref = _ref64(q, k, v)
    over = (got.double() - ref).abs() > 2e-5 + 2e-5 * ref.abs()
    if form == "stage_sums":
        assert int(over.sum()) == 0
    elif form == "one_accumulator":
        assert int(over.sum()) > 0.001 * over.numel()
    else:
        assert int(over.sum()) > 0
