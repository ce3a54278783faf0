"""The Hopper int8 QK^T kernel (csrc/flash_attention_int8_sm90.cu) on the
CPU: the arithmetic it uses in place of the int-to-float conversion, and
its walk in plain PyTorch — 128-key kv tiles, the k scale looked up per
64-key half (akq[(kv0 + 64 h) / bw], so a tile may straddle two of the JAX
kernel's kv blocks), tiles at or past kv_len never visited, the kv_len mask
on the tail tile, then the bounded or running-max softmax over those tiles
with softmax_tile's rounding points in both chains — against the plain
version (`int8_scores_plain`, `attention_int8_plain`) and the Pallas
kernel's qk_int8 mode in interpret mode.

The CUDA kernel runs only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold it against its plain version and the mma.sync kernel it
replaced. Tolerances: scores bit for bit (the same integer products, the
same fp32 products in the same order); the walk's output against the plain
version, PERF.md s2's int8 bounds (fp32 chain 1e-3 + 2^-7 |ref|, + 2^-8
max|v| under the running max, whose p round against other references;
bf16 chain rel. L2 < 1e-2, at most 1e-3 of the outputs beyond that, none
beyond 0.2 max|v|); against Pallas 1e-3 mean-relative (bf16, as
tests/test_torch_knobs.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu_torch.kernels import build
from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
LOG2E = math.log2(math.e)
D = 128
S32_MAX = 128 * 127 * 127   # |qi . ki| over d = 128 codes in [-128, 127]
MAGIC_BITS = 0x4B400000     # the bits of 1.5 * 2^23
MAGIC = np.float32(12582912.0)
BK = tfa.INT8_SM90_BLOCK_K


def _magic_float(s32):
    """The kernel's float(s32): the int32 add, the bits as fp32, minus
    1.5 * 2^23 (all in 32-bit arithmetic, as on the card)."""
    bits = s32.astype(np.int32).view(np.uint32) + np.uint32(MAGIC_BITS)
    return bits.view(np.float32) - MAGIC


def test_magic_conversion_exact_over_the_s32_range():
    """Every s32 the d = 128 product can reach, [-2,064,512, 2,064,512]
    (< 2^22), converts exactly: bit for bit float32(s32)."""
    s32 = np.arange(-S32_MAX, S32_MAX + 1, dtype=np.int32)
    got = _magic_float(s32)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32),
                          s32.astype(np.float32).view(np.uint32))
    # the range's ends are reachable: 128 codes of 127 against 127, and of
    # -128 against 127 (-2,080,768: still < 2^22)
    lo = np.int32(-128 * 127 * 128)
    assert _magic_float(np.array([lo]))[0] == np.float32(lo)


def _codes(b, n, lq, lk, bw, seed):
    """The pre-pass's plain codes and scales of seeded q (folded) and k,
    one q row and one k row of equal sign patterns (|s32| at its maximum,
    128 * 127^2) and k rows past 300 at 20 (they set the last block's
    scale, as the DiT's padded rows do)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, n, D)).astype(np.float32)
    k = rng.standard_normal((b, lk, n, D)).astype(np.float32)
    signs = np.where(rng.standard_normal(D) > 0, 1.0, -1.0)
    q[:, 3] = signs
    k[:, 5] = signs
    k[:, 300:] = 20.0
    qs = torch.as_tensor(q) * (LOG2E / math.sqrt(D))
    return tfa.quantize_qk_int8_plain(qs, torch.as_tensor(k), None, bw)


def _walk_scores(qi, sq, ki, akq, bw, kv_len):
    """The kernel's scores, tile by tile (numpy, 32-bit arithmetic): kv
    tile j covers keys 128 j .. 128 j + 127 (rows past Lk read as zero
    codes, as TMA fills them), s32 by integer products, the magic-number
    float, the k scale of each 64-key half, s = x * (sq_row * ak) in fp32,
    keys at or past kv_len -1e30. Tiles never visited stay NaN."""
    qi, ki = qi.numpy().astype(np.int32), ki.numpy().astype(np.int32)
    sq, akq = sq.numpy(), akq.numpy()
    b, n, lq, _ = qi.shape
    lk, nblk = ki.shape[2], akq.shape[-1]
    out = np.full((b, n, lq, lk), np.nan, np.float32)
    cols = np.arange(BK)
    for bi in range(b):
        kv_end = min(max(int(kv_len[bi]), 0), lk)
        for j in range(-(-kv_end // BK)):
            kv0 = j * BK
            tile = np.zeros((n, BK, D), np.int32)
            tile[:, :min(BK, lk - kv0)] = ki[bi, :, kv0:kv0 + BK]
            s32 = np.einsum("nqd,nkd->nqk", qi[bi], tile)
            assert np.abs(s32).max() <= S32_MAX
            ak = [akq[bi, :, kv0 // bw],
                  akq[bi, :, min((kv0 + 64) // bw, nblk - 1)]]
            fac = np.stack([sq[bi] * a[:, None] for a in ak])  # [2, n, lq]
            half = (cols >= 64).astype(np.int64)
            s = _magic_float(s32) * np.moveaxis(fac[half], 0, -1)
            s = np.where(kv0 + cols >= kv_end, np.float32(tfa.NEG_INF), s)
            width = min(BK, lk - kv0)
            out[bi, :, :, kv0:kv0 + width] = s[..., :width]
    return out


WALK_CASES = {
    # bw, lk, kv_len: every 128-key tile straddles two 64-key blocks
    "bw64": (64, 512, [512, 300]),
    # tile 1 (keys 128-255) straddles blocks 0 and 1; kv_len 200 in it
    "bw192": (192, 512, [512, 200]),
    # Lk < 512 so bw = Lk; the last tile half past Lk; kv_len 400 in it
    "bw448": (448, 448, [448, 400]),
    # the DiT's blocks of 2,048 keys; kv_len 2,100 just past the boundary
    "bw2048": (2048, 2304, [2304, 2100]),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_scores_equal_plain(case):
    """The kernel's scores equal `int8_scores_plain`'s (masked by `_dead`)
    bit for bit over every visited tile, and the walk visits exactly the
    tiles below kv_len."""
    bw, lk, kv = WALK_CASES[case]
    qi, sq, ki, akq = _codes(2, 2, 64, lk, bw, seed=bw)
    kv_len = torch.tensor(kv, dtype=torch.int32)
    got = _walk_scores(qi, sq, ki, akq, bw, kv)
    want = tfa.int8_scores_plain(qi, sq, ki, akq, bw)
    dead = tfa._dead(0, 64, lk, "cpu", kv_len=kv_len)
    want = torch.where(dead, torch.tensor(tfa.NEG_INF), want).numpy()
    for bi, end in enumerate(kv):
        visited = -(-end // BK) * BK
        assert np.isnan(got[bi, ..., visited:]).all()
        assert not np.isnan(got[bi, ..., :visited]).any()
        assert np.array_equal(got[bi, ..., :visited].view(np.uint32),
                              want[bi, ..., :visited].view(np.uint32))
        assert (want[bi, ..., end:] == tfa.NEG_INF).all()


def _rb(x):
    return x.to(torch.bfloat16).float()


def _bf16_bits_f32(x):
    """float32 x rounded to bf16 (ties to even), as float32."""
    u = x.astype(np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def _bf16_bits_f64(x):
    """float64 x rounded once to bf16's 8 significant bits (ties to even),
    as float64 (x normal, in bf16's range)."""
    u = x.view(np.uint64)
    half = np.uint64((1 << 44) - 1)
    u = u + half + ((u >> np.uint64(45)) & np.uint64(1))
    return (u & ~np.uint64((1 << 45) - 1)).view(np.float64)


def test_packed_bf16_difference_rounds_as_softmax_tile():
    """The bounded bf16 chain takes s - ref as one fma.rn.bf16x2 on the
    packed bf16 s and ref: the exact difference rounded once to bf16.
    softmax_tile rounds the fp32 difference of the same bf16 values. They
    agree bit for bit: every finite bf16 s of magnitude 2^-40 .. 2^40 (and
    0) against 255 seeded bf16 references and the DiT's folded bound,
    where float64 holds the difference exactly (exponent gap <= 45), and
    against exact rational arithmetic for 4,000 seeded pairs with larger
    gaps (bf16(-1e30), the masked score, among them)."""
    from fractions import Fraction
    a = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    mag = np.abs(a)
    a = a[np.isfinite(a) & ((mag == 0) | ((mag >= 2.0 ** -40)
                                           & (mag <= 2.0 ** 40)))]
    rng = np.random.default_rng(13)
    bound = _bf16_bits_f32(np.array([1.01 * D / math.sqrt(D) * LOG2E]))
    b = np.concatenate([bound, rng.choice(a, 255)])
    exp = lambda x: np.frexp(np.where(x == 0, 1.0, x))[1]  # noqa: E731
    for ref in b:
        twice = _bf16_bits_f32(a - np.float32(ref))    # fp32, then bf16
        diff = a.astype(np.float64) - np.float64(ref)  # exact where kept
        keep = (a == 0) | (np.abs(exp(a) - exp(np.float32(ref))) <= 45)
        once = _bf16_bits_f64(diff[keep])
        assert np.array_equal(twice[keep].astype(np.float64), once), ref
    # larger gaps: exact rationals, rounded once to 8 significant bits
    big = np.concatenate([a[np.abs(a) >= 2.0 ** 30],
                          _bf16_bits_f32(np.array([-1e30]))])
    small = a[(np.abs(a) <= 2.0 ** -10) & (a != 0)]

    def round_once(q):
        if q == 0:
            return 0.0
        e = math.floor(math.log2(abs(q)))
        while Fraction(2) ** e > abs(q):
            e -= 1
        while Fraction(2) ** (e + 1) <= abs(q):
            e += 1
        scaled = q / Fraction(2) ** (e - 7)   # 8 significant bits
        r = round(scaled)                      # Python rounds ties to even
        return float(Fraction(r) * Fraction(2) ** (e - 7))

    for _ in range(4000):
        x, y = rng.choice(big), rng.choice(small)
        if rng.random() < 0.5:
            x, y = y, x
        twice = _bf16_bits_f32(np.array([np.float32(x) - np.float32(y)]))[0]
        assert float(twice) == round_once(Fraction(float(x))
                                          - Fraction(float(y)))


def _walk_forward(qi, sq, ki, akq, v, bw, kv, bound, sbf16):
    """The kernel's output from the walk's scores: per visited tile the
    running max (or the bound) and softmax_tile's rounding points (bf16
    chain: s, the reference, s - ref and p round to bf16; fp32 chain: p in
    fp32 for l, rounded to bf16 for p v), l and acc in fp32, acc rescaled
    by exp2(m_old - m_new), the output acc / l in bf16, 0 where l = 0."""
    s_all = torch.as_tensor(_walk_scores(qi, sq, ki, akq, bw, kv))
    b, n, lq, _ = qi.shape
    vf = v.float()
    out = torch.zeros((b, lq, n, D), dtype=torch.bfloat16)
    for bi in range(b):
        m = torch.full((n, lq, 1), tfa.NEG_INF)
        l = torch.zeros((n, lq, 1))
        acc = torch.zeros((n, lq, D))
        for j in range(-(-min(max(kv[bi], 0), ki.shape[2]) // BK)):
            s = s_all[bi, :, :, j * BK:(j + 1) * BK]
            if sbf16:
                s = _rb(s)
            if bound is None:
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp2(m - m_new)
                l, acc, m = l * corr, acc * corr, m_new
                ref = m
            else:
                ref = torch.full_like(m, bound)
            if sbf16:
                p = _rb(torch.exp2(_rb(s - _rb(ref))))
            else:
                p = torch.exp2(s - ref)
            l = l + p.sum(-1, keepdim=True)
            vt = vf[bi, j * BK:(j + 1) * BK].transpose(0, 1)   # [n, keys, D]
            acc = acc + _rb(p)[..., :vt.shape[1]] @ vt
        o = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
        out[bi] = o.transpose(0, 1).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("mode", ["bounded", "running", "bounded_sbf16",
                                  "running_sbf16"])
def test_walk_forward_within_bounds(mode):
    """The walk's output (bw = 192 straddling a tile, Lq 448, kv_len [300,
    0], v past kv_len 50.0) against `attention_int8_plain` within PERF.md
    s2's int8 bounds; the kv_len = 0 batch row exactly 0 in both."""
    bw, lk, kv = 192, 512, [300, 0]
    qi, sq, ki, akq = _codes(2, 2, 448, lk, bw, seed=3)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, lk, 2, D)).astype(np.float32)).to(torch.bfloat16)
    v[:, 300:] = 50.0
    bound = 1.01 * D / math.sqrt(D) * LOG2E if "bounded" in mode else None
    sbf16 = mode.endswith("sbf16")
    got = _walk_forward(qi, sq, ki, akq, v, bw, kv, bound, sbf16).float()
    want = tfa.attention_int8_plain(
        qi, sq, ki, akq, v, kv_len=torch.tensor(kv, dtype=torch.int32),
        bound=None if bound is None else torch.tensor(bound),
        softmax_bf16=sbf16, block_k=bw).float()
    assert (got[1] == 0).all() and (want[1] == 0).all()
    g, w = got[0], want[0]
    assert bool(torch.isfinite(g).all())
    v_max = float(v[:, :300].float().abs().max())
    err = (g - w).abs()
    lim = 1e-3 + 2.0 ** -7 * w.abs() + (2.0 ** -8 * v_max if bound is None
                                        else 0.0)
    if not sbf16:
        assert bool((err <= lim).all()), float(err.max())
        return
    rel = float((g - w).norm() / w.norm())
    assert rel < 1e-2
    assert float((err > lim).float().mean()) <= 1e-3
    assert float(err.max()) <= 0.2 * v_max


@pytest.mark.parametrize("mode", ["bounded", "running"])
def test_walk_forward_matches_pallas(mode):
    """The walk (fp32 chain) against the Pallas kernel's qk_int8 mode in
    interpret mode at JAX's test shape ([1, 256, 2, 128], bf16 as on the
    card, q folded in bf16 on both sides, kv blocks of 128, kv_len 200):
    1e-3 mean-relative (tests/test_torch_knobs.py's bf16 bound)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 256, 2, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    kv = np.array([200], np.int32)
    fb = 1.01 * D / math.sqrt(D) * LOG2E if mode == "bounded" else None
    want = np.asarray(jfa.flash_attention_padded(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        block_q=128, block_k=128, interpret=True, kv_len=jnp.asarray(kv),
        qk_int8=True, score_bound=None if fb is None else jnp.float32(fb)),
        np.float32)
    codes = tfa.quantize_qk_int8_plain(tfa._fold(q, 1.0 / math.sqrt(D)), k,
                                       None, 128)
    got = _walk_forward(*codes, v, 128, [200], fb, False).float().numpy()
    assert np.abs(got - want).mean() / np.abs(want).mean() < 1e-3


def test_route_on_cpu_is_the_plain_version():
    """On CPU tensors `flash_attention_int8` is `attention_int8_plain`
    (no kernel, no launch counted)."""
    qi, sq, ki, akq = _codes(1, 2, 128, 512, 192, seed=5)
    v = torch.ones((1, 512, 2, D), dtype=torch.bfloat16)
    tfa.reset_launches()
    got = tfa.flash_attention_int8(qi, sq, ki, akq, v, block_k=192)
    want = tfa.attention_int8_plain(qi, sq, ki, akq, v, block_k=192)
    assert torch.equal(got, want)
    assert not any(tfa.LAUNCHES.values())


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises RuntimeError at first use:
    the wrapper never falls back to another kernel."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="flash_attention_int8_sm90"):
        build.load("flash_attention_int8_sm90")


@pytest.mark.parametrize("d", [64, 256])
def test_kernel_checks_refuse_other_head_dims(d):
    """The card kernels read 128-byte code rows and 128-wide v tiles: codes
    of another head dim (made by hand; the pre-pass refuses them) raise
    before a launch, while d = 128 passes the same checks."""
    def args(dd):
        return (torch.zeros((1, 2, 128, dd), dtype=torch.int8),
                torch.ones((1, 2, 128)),
                torch.zeros((1, 2, 256, dd), dtype=torch.int8),
                torch.ones((1, 2, 2)),
                torch.zeros((1, 256, 2, dd), dtype=torch.bfloat16))
    tfa._check_int8_attention(*args(D), None, 128)
    with pytest.raises(ValueError, match="head dim 128"):
        tfa._check_int8_attention(*args(d), None, 128)
