"""The serving knobs on fp32 inputs (softmax_bf16 and qk_int8 in the fp32
d=128 kernels of csrc/flash_attention_f32_sm90.cu, and kernel B's fp32 mode
in csrc/qk_prepass.cu), on the CPU: each new kernel mode's arithmetic
transcribed and held against its plain version (and fp64), the route that
picks the kernel of every fp32 / bf16 x knob x mask call, and
`ulysses_attention` at fp32 with each knob against JAX's on its virtual
devices (Pallas in interpret mode).

What the kernels compute, as transcribed here:
  * the bf16 chain's p is a bf16 value, so p v at fp32 accuracy is p (one
    part) against v's three bf16 parts: three products a 16-key step into
    a fresh tile accumulator (truncating adds, the small parts first),
    added to the running sum by an FADD;
  * int8 QK^T: s = float(s32) * (sq_row * akq_block), the two products
    rounded in that order, akq the k scale of the JAX kv block of bw keys
    that holds the 32-key tile: the plain version's scores bit for bit;
  * kernel B on fp32 rows: the rotation in fp32 (two products and a sum,
    each rounded once), aq = max(max|q32|, 1e-30), codes round(q32 * (127 /
    aq)) half to even; one k scale a (batch, head, block of bw keys) over
    the whole block;
  * the one-shot cross walk (the bf16 chain at Lk <= 512 without a bound):
    a first sweep of the scores for the row max, then the bounded walk
    against bf16(max): p equals the plain one-shot form's p where the
    scores are equal; a running max over 32-key tiles rounds p against
    other references and misses the fp32 bound.

Tolerances: PERF.md s2's fp32 d=128 bound 1e-5 + 1e-4 |ref| where both
sides hold the same p (the int8 fp32 chain, the one-part p v against fp64
and the plain version), its softmax_bf16 bound (rel. L2 < 1e-2, at most
1e-3 of the outputs beyond 1e-3 + 2^-7 |ref|, none beyond 0.2 max|v|)
where the scores' summation orders differ; Ulysses at
tests/test_parallel.py's fp32 1e-5 for qk_int8's fp32 chain and
tests/test_torch_knobs.py's mean-relative knob tolerances otherwise
(softmax_bf16 bounded 1e-5, running 2e-3, with int8 2e-3; JAX with a true
bf16 exp2).
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import univid_tpu.kernels.flash_attention as jfa
from test_torch_f32_d128_tc import _parts, _rz, rows, scores
from test_torch_knobs import _mean_rel, true_bf16_exp2
from test_torch_parallel import _jmesh, _rows
from torch_ranks import _mesh, ranks  # noqa: F401
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d
from univid_tpu_torch.parallel.ulysses import ulysses_attention

torch.set_num_threads(2)
LOG2E = math.log2(math.e)
BF16 = ml_dtypes.bfloat16
D = 128
KT = 32   # the kernels' kv tile


def _rand(shape, seed, normed=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normed:  # qk-normed rows (norm sqrt(d)), the Wan case
        x = x / np.linalg.norm(x, axis=-1, keepdims=True) * shape[-1] ** 0.5
    return x


def _t(x):
    return torch.as_tensor(x)


def _bf(x):
    """x rounded to bf16, kept in fp32."""
    return x.to(torch.bfloat16).float()


def _f32_close(got, want):
    """PERF.md s2's fp32 d=128 bound."""
    err = (got.double() - want.double()).abs()
    return bool((err <= 1e-5 + 1e-4 * want.double().abs()).all())


def _bf16_chain_close(got, want, v_max):
    """PERF.md s2's softmax_bf16 bound."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    lim = 1e-3 + 2.0 ** -7 * w.abs()
    return (float((g - w).norm() / w.norm()) < 1e-2
            and float((err > lim).double().mean()) <= 1e-3
            and float(err.max()) <= 0.2 * v_max)


# ---------------------------------------------------------------------------
# transcriptions of the kernels' arithmetic (one head: q [Lq, 128], k, v
# [Lk, 128], q folded)
# ---------------------------------------------------------------------------


def rows_one_part(p, v):
    """o_tile = p v over the 32 keys of a tile as rows_mma1: p [M, 32] bf16
    values (fp32), v [32, 128] fp32 in three bf16 parts; a fresh
    accumulator, p v2 then p v1 then p v0, two truncating 16-key steps
    each. fp32."""
    p64, v_p = p.double(), _parts(v)
    acc = torch.zeros((p.shape[0], v.shape[1]), dtype=torch.float64)
    for part in (2, 1, 0):
        for k0 in range(0, p.shape[1], 16):
            sl = slice(k0, k0 + 16)
            acc = _rz(acc + p64[:, sl] @ v_p[part][sl])
    return acc.float()


def bf16_chain_walk(s, v, kv_end, mode, bound=None, v_form="parts"):
    """The bf16 chain's walk over 32-key tiles on the scores s [Lq, Lk]
    (fp32, folded) as the SBF16 forward takes them: s, the reference, s -
    ref and p round to bf16, l sums the rounded p in fp32; mode "bounded",
    "running" (m over the tiles, corr in fp32) or "oneshot" (the row max of
    every live score first). p v by `rows_one_part` ("parts") or against
    bf16(v) alone ("one_part_v", a dropped encoding), added by an FADD
    (an FMA with corr under the running max). fp32 [Lq, 128]."""
    lq = s.shape[0]
    live = torch.arange(s.shape[1]) < kv_end
    s = torch.where(live, s, tfa.NEG_INF)
    m = torch.full((lq,), tfa.NEG_INF)
    if mode == "bounded":
        m = torch.full((lq,), float(bound))
    elif mode == "oneshot":
        m = s.amax(-1)
    l = torch.zeros(lq)
    o = torch.zeros((lq, D))
    for j0 in range(0, kv_end, KT):
        st = _bf(s[:, j0:j0 + KT])
        corr = torch.ones(lq)
        if mode == "running":
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp2(m - m_new)
            m = m_new
        ref = _bf(m)
        p = _bf(torch.exp2(_bf(st - ref[:, None])))
        l = l * corr + p.sum(-1)
        vt = v[j0:j0 + KT]
        o_t = (rows_one_part(p, vt) if v_form == "parts"
               else (p.double() @ _bf(vt).double()).float())
        o = (o.double() * corr.double()[:, None] + o_t.double()).float()
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return o * inv[:, None]


def plain_scores(qs, k):
    return torch.einsum("qd,kd->qk", qs, k)


def _one_head(seed, lq=256, lk=512, kv_end=437):
    qs = _t(_rand((lq, D), seed, True)) * (LOG2E / math.sqrt(D))
    k = _t(_rand((lk, D), seed + 1, True))
    v = _t(_rand((lk, D), seed + 2))
    k[kv_end:] = 50.0
    v[kv_end:] = 50.0
    return qs, k, v


def _plain(qs, k, v, kv_end, bound=None, softmax_bf16=True):
    kv = torch.tensor([kv_end], dtype=torch.int32)
    return tfa.attention_plain(qs[None, :, None], k[None, :, None],
                               v[None, :, None], kv_len=kv, bound=bound,
                               softmax_bf16=softmax_bf16)[0, :, 0]


@pytest.mark.parametrize("mode", ["bounded", "oneshot"])
def test_one_part_pv_matches_fp64_and_plain(mode):
    """The bf16 chain's p v as the kernel forms it (p one bf16 part, v
    three: three products a step) on the plain version's scores: within
    the fp32 d=128 bound of the same walk in fp64 and of attention_plain
    (softmax_bf16, fp32 v: the same p, p v in fp32), and the outputs equal
    to fp32 accuracy; v as one bf16 part misses that bound."""
    qs, k, v = _one_head(3)
    kv_end = 437
    bound = 1.01 * D * LOG2E / math.sqrt(D)
    s = plain_scores(qs, k)
    got = bf16_chain_walk(s, v, kv_end, mode, bound)
    want = _plain(qs, k, v, kv_end, torch.tensor(bound)
                  if mode == "bounded" else None)
    assert _f32_close(got, want)
    # the same p in fp64: p v exact, one division
    live = torch.arange(k.shape[0]) < kv_end
    sm = torch.where(live, s, tfa.NEG_INF)
    ref = _bf(torch.full((s.shape[0],), bound) if mode == "bounded"
              else sm.amax(-1))
    p = _bf(torch.exp2(_bf(_bf(sm) - ref[:, None]))).double()
    exact = (p @ v.double()) / p.sum(-1, keepdim=True)
    assert _f32_close(got, exact.float())
    one_part = bf16_chain_walk(s, v, kv_end, mode, bound,
                               v_form="one_part_v")
    assert not _f32_close(one_part, want)


def test_running_bf16_chain_within_its_bound():
    """The SBF16 forward's running max over 32-key tiles against the
    plain one-shot form (softmax_bf16, fp32 v) on the kernel's split-form
    scores: within PERF.md s2's softmax_bf16 bound (the references p
    rounds against differ), not within the fp32 bound."""
    qs, k, v = _one_head(5, lk=704, kv_end=640)
    got = bf16_chain_walk(scores(qs, k, "split"), v, 640, "running")
    want = _plain(qs, k, v, 640)
    assert _bf16_chain_close(got, want, float(v[:640].abs().max()))
    assert not _f32_close(got, want)


def test_one_shot_cross_walk_matches_plain():
    """The cross call's one-shot walk (sweep for the row max, then the
    bounded walk against bf16(max)) at 512 keys with kv_len 437: on the
    plain scores its p equal the plain one-shot form's and the outputs
    agree to the fp32 bound, where a running max over 32-key tiles does
    not; on the kernel's split-form scores within the softmax_bf16
    bound."""
    qs, k, v = _one_head(7)
    s = plain_scores(qs, k)
    want = _plain(qs, k, v, 437)
    assert _f32_close(bf16_chain_walk(s, v, 437, "oneshot"), want)
    assert not _f32_close(bf16_chain_walk(s, v, 437, "running"), want)
    got = bf16_chain_walk(scores(qs, k, "split"), v, 437, "oneshot")
    assert _bf16_chain_close(got, want, float(v[:437].abs().max()))


def _codes(seed, b, lq, lk, n, bw, rope):
    q = _t(_rand((b, lq, n, D), seed, True))
    k = _t(_rand((b, lk, n, D), seed + 1, True))
    tabs = None
    if rope:
        tabs = tfa._pad_tables(tfa.build_fused_rope_tables(
            *trope3d(D, (4, 8, 8), device="cpu"), D), lq, lk,
            LOG2E / math.sqrt(D))
    else:
        q = q * (LOG2E / math.sqrt(D))
    return q, k, tabs, tfa.quantize_qk_int8_plain(q, k, tabs, bw)


@pytest.mark.parametrize("bw", [64, 192, 448])
def test_int8_scores_in_kernel_order_equal_plain(bw):
    """The INT8 forward's scores, tile by tile: s32 from the codes (exact),
    float(s32) * fp32(sq_row * akq[kv0 // bw]) with the 32-key tile's block
    scale: bit-equal to int8_scores_plain (attention_int8_plain's scores),
    at k-scale blocks of 64, 192 (tiles never straddle: bw is a multiple
    of 64) and the whole 448 keys."""
    _, _, _, (qi, sq, ki, akq) = _codes(11, 2, 256, 448, 2, bw, True)
    want = tfa.int8_scores_plain(qi, sq, ki, akq, block_k=bw)
    s32 = torch.einsum("bnqd,bnkd->bnqk", qi.double(), ki.double())
    got = torch.empty_like(want)
    for j0 in range(0, ki.shape[2], KT):
        fac = (sq * akq[..., j0 // bw, None]).float()
        got[..., j0:j0 + KT] = (s32[..., j0:j0 + KT].float()
                                * fac[..., None])
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["bounded", "running"])
def test_int8_fp32_chain_walk_matches_plain(mode):
    """The INT8 forward's fp32 chain (p fp32, split in three parts: six
    products a p v, as the fp32 forward) on the int8 scores: within the
    fp32 d=128 bound of attention_int8_plain on fp32 v; a kv_len = 0 batch
    row exactly 0."""
    q, k, tabs, (qi, sq, ki, akq) = _codes(13, 2, 256, 448, 1, 192, True)
    v = _t(_rand((2, 448, 1, D), 15))
    kv = torch.tensor([401, 0], dtype=torch.int32)
    bound = 1.01 * D * LOG2E / math.sqrt(D)
    want = tfa.attention_int8_plain(
        qi, sq, ki, akq, v, kv_len=kv, block_k=192,
        bound=torch.tensor(bound) if mode == "bounded" else None)
    s = tfa.int8_scores_plain(qi, sq, ki, akq, block_k=192)[0, 0]
    s = torch.where(torch.arange(448) < 401, s, tfa.NEG_INF)
    m = torch.full((256,), bound if mode == "bounded" else tfa.NEG_INF)
    l, o = torch.zeros(256), torch.zeros((256, D))
    for j0 in range(0, 401, KT):
        st = s[:, j0:j0 + KT]
        corr = torch.ones(256)
        if mode == "running":
            m_new = torch.maximum(m, st.amax(-1))
            corr, m = torch.exp2(m - m_new), m_new
        p = torch.exp2(st - m[:, None])
        l = l * corr + p.sum(-1)
        o = (o.double() * corr.double()[:, None]
             + rows(p, v[0, j0:j0 + KT, 0], "split").double()).float()
    got = o / l[:, None]
    assert _f32_close(got, want[0, :, 0])
    assert want.dtype == torch.float32 and bool((want[1] == 0).all())


def _kernel_b(x, cf, sf, rows_per_scale):
    """Kernel B on fp32 rows x [B, L, N, 128] in numpy: the rotation in
    fp32 (each product and the sum rounded once), then per group of
    `rows_per_scale` rows of a (batch, head) (1: q's per-row scale; bw: a k
    block, the last one short) a = max(max|x32|, 1e-30), codes round(x32 *
    fp32(127 / a)) half to even, the scale a * fp32(1 / 127)."""
    x = x.numpy()
    if cf is not None:
        sw = x.reshape(*x.shape[:-1], D // 2, 2)[..., ::-1].reshape(x.shape)
        c, s = cf.numpy()[None, :, None], sf.numpy()[None, :, None]
        x = (x * c).astype(np.float32) + (sw * s).astype(np.float32)
    x = np.transpose(x, (0, 2, 1, 3))   # [B, N, L, D]
    b, n, l, _ = x.shape
    blocks = -(-l // rows_per_scale)
    codes = np.empty(x.shape, np.int8)
    scale = np.empty((b, n, blocks), np.float32)
    for i in range(blocks):
        sl = slice(i * rows_per_scale, (i + 1) * rows_per_scale)
        a = np.maximum(np.abs(x[:, :, sl]).max(axis=(2, 3)),
                       np.float32(1e-30))
        r = (np.float32(127.0) / a).astype(np.float32)
        codes[:, :, sl] = np.round(x[:, :, sl] * r[..., None, None]) \
            .astype(np.int8)
        scale[..., i] = a * np.float32(1.0 / 127.0)
    return codes, scale


@pytest.mark.parametrize("rope", [True, False])
def test_f32_prepass_transcription_equals_plain(rope):
    """Kernel B's fp32 mode transcribed in numpy (no fused multiply-add,
    the fp32 rows never rounded to bf16) equals quantize_qk_int8_plain on
    fp32 q and k bit for bit: codes and scales, k scales over blocks of
    192 keys with the rows past a kv_len of 400 at 20.0 setting the last
    one (JAX's block max ignores kv_len)."""
    q, k, tabs, _ = _codes(17, 2, 256, 448, 3, 192, rope)
    k[:, 400:] = 20.0
    want = tfa.quantize_qk_int8_plain(q, k, tabs, 192)
    cq, sq_t, ck, sk_t = tabs if rope else (None,) * 4
    qi, sq = _kernel_b(q, cq, sq_t, 1)
    ki, akq = _kernel_b(k, ck, sk_t, 192)
    for g, w in zip((qi, sq, ki, akq), want):
        np.testing.assert_array_equal(g, w.numpy())
    assert want[0].dtype == torch.int8 and want[1].dtype == torch.float32


# ---------------------------------------------------------------------------
# the route: which kernel takes each dtype x knob x mask call on the card
# ---------------------------------------------------------------------------

KNOBS = {"none": {}, "softmax_bf16": dict(softmax_bf16=True),
         "qk_int8": dict(qk_int8=True),
         "both": dict(softmax_bf16=True, qk_int8=True)}
MASKS = {"none": {}, "causal": dict(causal=True),
         "segments": dict(seg="segments"), "packed": dict(seg="packed")}


def _expected_f32(knob, mask, mode, lse):
    """The fp32 route's answer, from its rules: a counter name, or the
    exception it raises."""
    kn = KNOBS[knob]
    masked = mask != "none"
    if kn and (masked or lse):
        return NotImplementedError
    if masked and mode != "running":
        return NotImplementedError
    if mode == "oneshot" and kn != dict(softmax_bf16=True):
        return NotImplementedError
    if kn.get("qk_int8"):
        return "flash_attention_f32_sm90_int8" + (
            "_sbf16" if kn.get("softmax_bf16") else "")
    if kn:
        return "flash_attention_f32_sm90_sbf16" + (
            "_oneshot" if mode == "oneshot" else "")
    return "flash_attention_f32_sm90" + ("_lse" if lse else "")


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_route_by_dtype_knob_and_mask(dtype, knob, mask):
    """Every softmax mode and lse flag of one dtype x knob x mask call:
    fp32 d=128 names its mode of flash_attention_f32_sm90.cu
    (`f32_forward_route`) or raises (a knob with a mask or the lse:
    KNOBS_MASKED; a masked bound; the one-shot max outside the bf16 chain);
    bf16 (`bf16_forward_route`: softmax_bf16; qk_int8 takes the int8
    kernel before any route) names sm90 / causal_sm90 or raises. No call
    falls back to a plain version."""
    x = torch.zeros((1, 64, 2, D), dtype=getattr(torch, dtype))
    for mode in ("bounded", "running", "oneshot"):
        for lse in (False, True):
            kw = dict(mode=mode, lse=lse, **MASKS[mask])
            if dtype == "float32":
                want = _expected_f32(knob, mask, mode, lse)
                call = lambda: tfa.f32_forward_route(x, x, x, **KNOBS[knob],
                                                     **kw)
            else:
                kn = dict(KNOBS[knob])
                kn.pop("qk_int8", None)
                masked = mask != "none"
                want = ("causal_sm90" if mask == "causal" else "sm90")
                if (kn and (masked or lse)) or (masked and mode != "running"):
                    want = NotImplementedError
                call = lambda: tfa.bf16_forward_route(x, x, x, **kn, **kw)
            if isinstance(want, str):
                assert call() == want, (mode, lse)
            else:
                with pytest.raises(want):
                    call()


def test_routes_refuse_what_no_kernel_takes():
    """The refusals that stay: KNOBS_MASKED (a knob with causal, segment or
    packed masks, or with the lse: no JAX caller), qk_int8 over grouped kv
    heads, causal with segments, another head dim or dtype."""
    x = torch.zeros((1, 64, 4, D))
    kv = x[:, :, :2]
    with pytest.raises(NotImplementedError, match="no caller"):
        tfa.f32_forward_route(x, x, x, mode="running", softmax_bf16=True,
                              seg="packed")
    with pytest.raises(ValueError, match="kv heads"):
        tfa.f32_forward_route(x, kv, kv, mode="running", qk_int8=True)
    assert tfa.f32_forward_route(x, kv, kv, mode="running",
                                 softmax_bf16=True) \
        == "flash_attention_f32_sm90_sbf16"
    with pytest.raises(NotImplementedError, match="segment ids"):
        tfa.f32_forward_route(x, x, x, mode="running", causal=True,
                              seg="segments")
    with pytest.raises(ValueError, match="head dim"):
        tfa.f32_forward_route(x[..., :64], x[..., :64], x[..., :64],
                              mode="running")
    with pytest.raises(TypeError, match="fp32"):
        tfa.f32_forward_route(x.bfloat16(), x, x, mode="running")
    assert not hasattr(tfa, "KNOBS_F32_LATER")
    # on the CPU a knob with a mask still raises; fp32 knob calls run
    with pytest.raises(NotImplementedError, match="no caller"):
        tfa.flash_attention_padded(x, x, x, causal=True, qk_int8=True)
    out = tfa.flash_attention_padded(x, x, x, softmax_bf16=True,
                                     qk_int8=True)
    assert out.dtype == torch.float32 and out.shape == x.shape


@pytest.mark.parametrize("sbf, oneshot, bounded, kv_heads", [
    (False, False, True, 4), (False, False, False, 2), (True, False, True, 2),
    (True, False, False, 1), (True, True, False, 2), (True, True, False, 4)])
def test_f32_forward_entry_args(monkeypatch, sbf, oneshot, bounded,
                                kv_heads):
    """Every fp32 d=128 forward mode, the bf16 chain and the one-shot max
    included, goes through the one C entry univid_flash_fwd_f32_sm90 with
    k's group (query heads over kv heads), the softmax mode (0 bounded, 1
    running, 2 one-shot) and the softmax_bf16 flag; the launch counts under
    the mode's own name, and under GROUPED_LAUNCHES when grouped."""
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0

    monkeypatch.setattr(tfa, "_fn", lambda lib, sym, types: (
        seen.update(lib=lib, sym=sym, n_types=len(types)) or entry))
    monkeypatch.setattr(tfa, "_stream", lambda t: None)
    b, lq, lk, n = 2, 128, 192, 4
    qp = torch.zeros((3, b, lq, n, D), dtype=torch.bfloat16)
    kp = torch.zeros((3, b, lk, kv_heads, D), dtype=torch.bfloat16)
    bound = torch.ones(1) if bounded else None
    tfa.reset_launches()
    o, lse = tfa._fwd_f32_sm90_parts(qp, kp, kp, None, bound, False,
                                     softmax_bf16=sbf, oneshot=oneshot)
    assert o.shape == (b, lq, n, D) and lse is None
    assert (seen["lib"], seen["sym"]) == ("flash_attention_f32_sm90",
                                          "univid_flash_fwd_f32_sm90")
    args = seen["args"]
    assert len(args) == seen["n_types"] == 24
    softmax, flag, bb, nn, group, lq_, lk_ = args[15:22]
    assert (softmax, flag) == (2 if oneshot else 0 if bounded else 1,
                               int(sbf))
    assert (bb, nn, group, lq_, lk_) == (b, n, n // kv_heads, lq, lk)
    name = ("flash_attention_f32_sm90_sbf16" + ("_oneshot" if oneshot
                                                else "")
            if sbf else "flash_attention_f32_sm90")
    assert {k: v for k, v in tfa.LAUNCHES.items() if v} == {name: 1}
    assert tfa.GROUPED_LAUNCHES[name] == (kv_heads < n)


# ---------------------------------------------------------------------------
# Ulysses at fp32 with each knob, against JAX's on its virtual devices
# ---------------------------------------------------------------------------

ULYSSES = {"softmax_bf16_bounded": (dict(softmax_bf16=True), True),
           "softmax_bf16_running": (dict(softmax_bf16=True), False),
           "qk_int8_bounded": (dict(qk_int8=True), True),
           "qk_int8_running": (dict(qk_int8=True), False),
           "both_bounded": (dict(softmax_bf16=True, qk_int8=True), True)}


def _task_ulysses_knobs(rank, world, q, k, v, kv_len, bound, knobs):
    rows = _rows(rank, world, q.shape[1])
    group = _mesh(sp=world)["sp"].get_group()
    out = ulysses_attention(
        *(torch.as_tensor(t[:, rows]) for t in (q, k, v)), group,
        kv_len=torch.as_tensor(kv_len),
        score_bound=None if bound is None else torch.tensor(bound), **knobs)
    return out.numpy()


@pytest.mark.parametrize("case", list(ULYSSES))
def test_ulysses_f32_knobs_match_jax(case, ranks):
    """ulysses_attention at fp32, d=128 (the kernel route: 2 heads a rank
    after the exchange, kv_len [249, 243] of 256 keys), each knob and both,
    bounded or running: the port's two gloo ranks against JAX's shard_map
    over its virtual devices on the Pallas kernel in interpret mode (a true
    bf16 exp2). qk_int8's fp32 chain at tests/test_parallel.py's fp32
    Ulysses tolerance; the bf16 chain at tests/test_torch_knobs.py's."""
    knobs, bounded = ULYSSES[case]
    world, b, l, n = 2, 2, 256, 4
    q, k = (_rand((b, l, n, D), s, True) for s in (20, 21))
    v = _rand((b, l, n, D), 22)
    kv_len = np.array([l - 7, l - 13], np.int32)
    bound = 1.01 * D if bounded else None
    jkv = jnp.asarray(kv_len)
    jb = None if bound is None else jnp.float32(bound)
    f = jax.shard_map(
        lambda q, k, v: j_ulysses(q, k, v, "sp", kv_len=jkv, score_bound=jb,
                                  **knobs),
        mesh=_jmesh(sp=world), in_specs=(P(None, "sp"),) * 3,
        out_specs=P(None, "sp"), axis_names={"sp"}, check_vma=False)
    jbackend("pallas")
    jfa.set_interpret_mode(True)
    try:
        with true_bf16_exp2():
            want = np.asarray(jax.jit(f)(q, k, v))
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    got = np.concatenate(ranks(world).run(_task_ulysses_knobs, q, k, v,
                                          kv_len, bound, knobs), axis=1)
    assert got.dtype == np.float32
    if not knobs.get("softmax_bf16"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 1e-5 if bounded and not knobs.get("qk_int8") else 2e-3
        assert _mean_rel(got, want) < tol
