"""The accuracy argument of the fp32 d=128 attention kernels
(csrc/flash_attention_f32_sm90.cu), on the CPU: their split products
emulated bit for bit in their operands, held against fp64 within the fp32
d=128 bounds of PERF.md §2, and one bf16 part shown to fall outside them.

Encoding: each fp32 operand x is three bf16 parts (`split_bf16x3_plain`:
b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1)), and a product a b
is the six terms a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0. Products of
bf16 values are exact, so each 16-deep wgmma step is emulated as an exact
fp64 dot product; the tensor cores add it into the fp32 accumulator with
truncation (round toward zero), emulated as such. The kernels' stage-wise
form: each of the scores' six terms in a fresh accumulator of its own (8
steps over d = 128), the small terms summed by round-to-nearest FADDs,
then the main term; each product over 32 rows (p v, dS k, p^T dO, dS^T
qs) in a fresh tile accumulator (the small terms' 10 steps first, then the
main term's 2), added to the running sum by an FADD (an FMA with the
running max's correction in the forward). Tiles as the kernels': 32 keys a
forward and dq tile, the dq sum split over two consumers (even and odd
tiles) and summed in that order, 32 queries a dk/dv tile. The emulation
differs from the card only in the fp32 row sums' order and exp2's last
bits.

Inputs: rows qk-normed to norm sqrt(d) with per-channel gains in [0.5,
1.5] (the fine-tune's norm weights), q folded by log2(e) / sqrt(d), 256
queries over 256 keys with kv_len 200 and the keys past it holding 50.0.
Bounds (PERF.md §2): output 1e-5 + 1e-4 |ref|, lse 1e-4; dq, dk, dv 1e-4
max|ref| + 1e-4 |ref| and rel. L2 < 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
D = 128
LQ, LK, KV_END = 256, 256, 200
SCALE = D ** -0.5
KT = 32
SMALL = ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def _parts(x, three=True):
    """The bf16 parts of fp32 x as fp64 values: three, or b0 alone."""
    p = tfa.split_bf16x3_plain(x).double()
    return [p[0], p[1], p[2]] if three else [p[0]]


def _rz(x64):
    """fp64 values rounded to fp32 toward zero (the tensor cores'
    accumulation), as fp64."""
    y = x64.float()
    away = y.double().abs() > x64.abs()
    return torch.where(away, torch.nextafter(y, torch.zeros_like(y)),
                       y).double()


def _fp32(x64):
    return x64.float().double()


def scores(a, b, form):
    """a b^T over d = 128 (a [M, 128], b [N, 128] fp32) as the kernels'
    scores_mma: `form` "split" (truncating stage-wise accumulation),
    "exact" (the six terms summed exactly, one rounding) or "one_part"
    (a0 b0 alone, truncating). fp32 result."""
    a_p, b_p = _parts(a, form != "one_part"), _parts(b, form != "one_part")
    if form == "exact":
        return sum(a_p[i] @ b_p[j].T for i, j in ((0, 0),) + SMALL).float()
    def term(i, j):   # 8 truncating steps into a fresh accumulator
        acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64)
        for k0 in range(0, D, 16):
            sl = slice(k0, k0 + 16)
            acc = _rz(acc + a_p[i][:, sl] @ b_p[j][:, sl].T)
        return acc.float()

    main = term(0, 0)
    if form == "one_part":
        return main
    t01, t10, t02, t11, t20 = (term(i, j) for i, j in SMALL)
    return main + (((t01 + t10) + (t02 + t11)) + t20)


def rows(a, b, form):
    """a b over K = 32 rows (a [M, 32] fp32, b [32, 128] fp32) as the
    kernels' rows_mma: a fresh accumulator, the small terms' steps first,
    then the main term's; fp32 result."""
    a_p, b_p = _parts(a, form != "one_part"), _parts(b, form != "one_part")
    if form == "exact":
        return sum(a_p[i] @ b_p[j] for i, j in ((0, 0),) + SMALL).float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
    terms = ((0, 0),) if form == "one_part" else SMALL + ((0, 0),)
    for i, j in terms:
        for k0 in range(0, a.shape[1], 16):
            sl = slice(k0, k0 + 16)
            acc = _rz(acc + a_p[i][:, sl] @ b_p[j][sl])
    return acc.float()


def fwd_form(qs, k, v, kv_end, form, bound=None):
    """The forward kernel's function for one head: qs [Lq, 128] folded, k,
    v [Lk, 128]; 32-key tiles below kv_end, the running max (or the bound),
    o = fma(o, corr, o_tile). (o, lse)."""
    lq = qs.shape[0]
    m = torch.full((lq,), tfa.NEG_INF if bound is None else bound)
    l = torch.zeros(lq)
    o = torch.zeros((lq, D))
    for j0 in range(0, kv_end, KT):
        s = scores(qs, k[j0:j0 + KT], form)
        s = torch.where(torch.arange(j0, j0 + KT) < kv_end, s, tfa.NEG_INF)
        corr = torch.ones(lq)
        if bound is None:
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            m = m_new
        p = torch.exp2(s - m[:, None])
        l = l * corr + p.sum(-1)
        o_t = rows(p, v[j0:j0 + KT], form)
        o = _fp32(o.double() * corr.double()[:, None] + o_t.double()).float()
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log2(torch.where(l > 0, l, 1.0)),
                      -tfa.NEG_INF)
    return o * inv[:, None], lse


def dq_form(qs, k, v, do, lse, delta, kv_end, form):
    """The dq kernel's function: 32-key tiles, consumer c summing tiles c,
    c + 2, ..., dq = (sum_0 + sum_1) * scale."""
    runs = [torch.zeros((qs.shape[0], D)) for _ in range(2)]
    for idx, j0 in enumerate(range(0, kv_end, KT)):
        kt, vt = k[j0:j0 + KT], v[j0:j0 + KT]
        s = scores(qs, kt, form)
        s = torch.where(torch.arange(j0, j0 + KT) < kv_end, s, tfa.NEG_INF)
        p = torch.exp2(s - lse[:, None])
        ds = p * (scores(do, vt, form) - delta[:, None])
        runs[idx % 2] = runs[idx % 2] + rows(ds, kt, form)
    return (runs[0] + runs[1]) * SCALE


def dkv_form(qs, k, v, do, lse, delta, kv_end, form):
    """The dk/dv kernel's function: 32-query tiles; keys at or past kv_end
    take no part (p = 0)."""
    dead = torch.arange(k.shape[0])[:, None] >= kv_end
    dk = torch.zeros((k.shape[0], D))
    dv = torch.zeros((k.shape[0], D))
    for i0 in range(0, qs.shape[0], KT):
        sl = slice(i0, i0 + KT)
        st = torch.where(dead, tfa.NEG_INF, scores(k, qs[sl], form))
        pt = torch.exp2(st - lse[None, sl])
        dst = pt * (scores(v, do[sl], form) - delta[None, sl])
        dv = dv + rows(pt, do[sl], form)
        dk = dk + rows(dst, qs[sl], form)
    return dk * tfa.LN2, dv


def _normed(rng, n, gains):
    x = rng.standard_normal((n, D))
    return x / np.linalg.norm(x, axis=-1, keepdims=True) * D ** 0.5 * gains


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    gq, gk = (rng.uniform(0.5, 1.5, D) for _ in range(2))
    q = _normed(rng, LQ, gq) * (math.log2(math.e) * SCALE)
    k = _normed(rng, LK, gk)
    v = rng.standard_normal((LK, D))
    do = rng.standard_normal((LQ, D)) * 0.1
    k[KV_END:] = 50.0
    v[KV_END:] = 50.0
    return tuple(torch.as_tensor(x, dtype=torch.float32)
                 for x in (q, k, v, do))


def _ref64(qs, k, v, do, kv_end):
    """Attention, its lse and dq, dk, dv in fp64 (exp2 domain, folded q)."""
    qs, k, v, do = (x.double() for x in (qs, k, v, do))
    s = qs @ k.T
    s[:, kv_end:] = -math.inf
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s - m)
    l = e.sum(-1, keepdim=True)
    o = (e @ v) / l
    lse = (m + torch.log2(l))[:, 0]
    p = torch.exp2(s - lse[:, None])
    delta = (do * o).sum(-1)
    ds = p * (do @ v.T - delta[:, None])
    return o, lse, ds @ k * SCALE, ds.T @ qs * math.log(2.0), p.T @ do


def _fwd_excess(got, ref):
    """max |got - ref| / (1e-5 + 1e-4 |ref|): within the bound iff <= 1."""
    return float(((got.double() - ref).abs() / (1e-5 + 1e-4 * ref.abs()))
                 .max())


def _grad_excess(got, ref):
    """max over elements of |got - ref| / (1e-4 max|ref| + 1e-4 |ref|), and
    the rel. L2 error."""
    got = got.double()
    lim = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    rel = float((got - ref).norm() / ref.norm())
    return float(((got - ref).abs() / lim).max()), rel


@pytest.fixture(scope="module")
def case():
    qs, k, v, do = _inputs()
    o64, lse64, dq64, dk64, dv64 = _ref64(qs, k, v, do, KV_END)
    # the backward's residuals: the fp64 forward rounded to fp32, as the
    # card tests take the plain forward's
    o, lse = o64.float(), lse64.float()
    delta = (do * o).sum(-1)
    return dict(qs=qs, k=k, v=v, do=do, o=o, lse=lse, delta=delta, o64=o64,
                lse64=lse64, grads64=(dq64, dk64, dv64))


def _backward(c, form, kv_end=KV_END):
    args = (c["qs"], c["k"], c["v"], c["do"], c["lse"], c["delta"], kv_end,
            form)
    return (dq_form(*args),) + dkv_form(*args)


@pytest.mark.parametrize("form", ["split", "exact"])
def test_split_forward_within_fp32_bounds(case, form):
    """The forward's two products in three bf16 parts, stage-wise
    truncating accumulation ("split", the kernel's form) and exactly summed
    ("exact"): output within 1e-5 + 1e-4 |ref| of fp64, lse within 1e-4,
    with a wide margin."""
    o, lse = fwd_form(case["qs"], case["k"], case["v"], KV_END, form)
    assert _fwd_excess(o, case["o64"]) < 0.3
    assert float((lse.double() - case["lse64"]).abs().max()) < 1e-5


def test_split_forward_bounded_within_fp32_bounds(case):
    """The bounded softmax (p = exp2(s - C) at the folded bound 1.01 * d
    * gain^2, lse C + log2 l), the kernel's form: the same bounds."""
    c_bound = float(1.01 * D * 1.5 ** 2 * math.log2(math.e) * SCALE)
    o, lse = fwd_form(case["qs"], case["k"], case["v"], KV_END, "split",
                      bound=c_bound)
    assert _fwd_excess(o, case["o64"]) < 0.3
    assert float((lse.double() - case["lse64"]).abs().max()) < 1e-5


@pytest.mark.parametrize("form", ["split", "exact"])
def test_split_backward_within_fp32_bounds(case, form):
    """The backward's seven products (the pair's form: S and dP in both
    kernels, dS k, P^T dO, dS^T qs) in three bf16 parts: dq, dk and dv
    within 1e-4 max|ref| + 1e-4 |ref| of fp64 and rel. L2 < 1e-4, with a
    wide margin."""
    for got, ref, name in zip(_backward(case, form), case["grads64"],
                              ("dq", "dk", "dv")):
        excess, rel = _grad_excess(got, ref)
        assert excess < 0.3, name
        assert rel < 1e-5, name


def test_one_bf16_part_is_outside_the_bounds(case):
    """One bf16 part (a0 b0 alone, 8-bit mantissas): the forward misses
    its bound by many times at many outputs, and so do dq, dk and dv."""
    o, lse = fwd_form(case["qs"], case["k"], case["v"], KV_END, "one_part")
    assert _fwd_excess(o, case["o64"]) > 10.0
    over = (o.double() - case["o64"]).abs() > 1e-5 + 1e-4 * case["o64"].abs()
    assert int(over.sum()) > 0.1 * over.numel()
    assert float((lse.double() - case["lse64"]).abs().max()) > 1e-4
    for got, ref, name in zip(_backward(case, "one_part"), case["grads64"],
                              ("dq", "dk", "dv")):
        excess, rel = _grad_excess(got, ref)
        assert excess > 2.0 and rel > 1e-3, name


def test_tile_accumulators_bound_truncated_accumulation():
    """Why every product over rows goes to a fresh 32-row tile accumulator
    added by a round-to-nearest FADD: p v over 16,384 keys (p in [0, 1],
    v ~ N(1, 1), so the sums grow and each truncation loses in one
    direction) in one running truncating accumulator (3,072 adds) misses
    the forward's bound 1e-5 + 1e-4 |ref| of fp64, with a mean relative
    bias below -5e-5; the kernels' tile form stays within 5% of it."""
    rng = np.random.default_rng(1)
    n = 16384
    p = torch.as_tensor(rng.uniform(0, 1, (64, n)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((n, D)) + 1.0,
                        dtype=torch.float32)
    ref = p.double() @ v.double()
    tiles = torch.zeros((64, D))
    for j0 in range(0, n, KT):
        tiles = tiles + rows(p[:, j0:j0 + KT], v[j0:j0 + KT], "split")
    a_p, b_p = _parts(p), _parts(v)
    one = torch.zeros_like(ref)
    for j0 in range(0, n, KT):
        for i, j in SMALL + ((0, 0),):
            for k0 in range(j0, j0 + KT, 16):
                one = _rz(one + a_p[i][:, k0:k0 + 16] @ b_p[j][k0:k0 + 16])
    assert _fwd_excess(tiles, ref) < 0.05
    assert _fwd_excess(one.float(), ref) > 1.0
    assert float(((one - ref) / ref.abs()).mean()) < -5e-5


def test_split_parts_reconstruct_fp32():
    """b0 + b1 + b2 equals x within 2^-24 |x| (the third part's rounding
    leaves ~2^-27), and b0 alone only within 2^-9 |x|."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(4096)
                        * 10.0 ** np.random.default_rng(4).uniform(-6, 6,
                                                                   4096),
                        dtype=torch.float32)
    p = tfa.split_bf16x3_plain(x)
    assert p.dtype == torch.bfloat16 and p.shape == (3, 4096)
    err = (p.double().sum(0) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -24
    assert float(((p[0].double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -12
    assert torch.equal(tfa.split_bf16x3(x), p)   # the CPU route: plain


def test_kv_len_zero_rows_and_dead_keys_are_zero(case):
    """kv_len = 0: the forward's rows are exactly 0 with lse +1e30, and dq,
    dk, dv are exactly 0; with kv_len 200, dk and dv of the keys past it
    are exactly 0."""
    o, lse = fwd_form(case["qs"], case["k"], case["v"], 0, "split")
    assert float(o.abs().max()) == 0.0 and bool((lse == 1e30).all())
    lse_inf = torch.full_like(case["lse"], 1e30)
    c = dict(case, lse=lse_inf, delta=torch.zeros_like(case["delta"]))
    for g in _backward(c, "split", kv_end=0):
        assert float(g.abs().max()) == 0.0
    _, dk, dv = _backward(case, "split")
    assert float(dk[KV_END:].abs().max()) == 0.0
    assert float(dv[KV_END:].abs().max()) == 0.0


def test_split_form_matches_plain_with_kv_len(case):
    """The kernels' forms against the port's plain fp32 versions
    (attention_plain with the lse, _bwd_plain_folded) on the same inputs:
    within the fp32 d=128 bounds."""
    qs, k, v, do = (case[n][None, :, None] for n in ("qs", "k", "v", "do"))
    kv = torch.tensor([KV_END], dtype=torch.int32)
    o_p, lse_p = tfa.attention_plain(qs, k, v, kv_len=kv,
                                     save_residuals=True)
    o, lse = fwd_form(case["qs"], case["k"], case["v"], KV_END, "split")
    np.testing.assert_allclose(o.numpy(), o_p[0, :, 0].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_p[0, 0].numpy(), rtol=0,
                               atol=1e-4)
    want = tfa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv, SCALE)
    c = dict(case, o=o_p[0, :, 0], lse=lse_p[0, 0],
             delta=(case["do"] * o_p[0, :, 0]).sum(-1))
    for got, ref, name in zip(_backward(c, "split"), want,
                              ("dq", "dk", "dv")):
        excess, rel = _grad_excess(got, ref[0, :, 0].double())
        assert excess <= 1.0 and rel < 1e-4, name
