"""The one-pass bf16 attention backward (csrc/flash_attention_bwd_sm90.cu)
on the CPU: which kernel each bf16 backward call reaches on the card
(`bf16_backward_route`), the q split of small grids (`bwd_sm90_q_splits`),
and the kernel's walk in plain PyTorch — kv-tile-major, 128-row kv tiles,
64-row q tiles, its rounding points, dq summed in fp32 across kv tiles,
the cross shape's q split — against the plain backward and against
univid_tpu's fused Pallas backward in interpret mode.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold it against its plain version and the mma.sync pair.
Tolerances: the walk against the plain backward, fp32 inputs, 1e-5
relative L2 (only the fp32 summation order differs); bf16 inputs, PERF.md
s2's backward bound, 2^-8 max|ref| + 2^-7 |ref| and 1e-4 relative L2 (the
same rounding points, but where the two fp32 sums differ in the last bit a
bf16 rounding of p, dS or the output flips by one step, 2^-8; measured up
to 4.9e-5); against the Pallas kernel bf16 2e-2 (p, dS and the outputs
round to bf16 at the same points in both).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
LOG2E = math.log2(math.e)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


Q = _t((1, 128, 12, 128))
KV = _t((1, 256, 12, 128))

# (q, k, kwargs, expected): the kernel name, or the exception raised. The
# backward reads only the forward's lse: bounded and running forwards,
# with or without kv_len, reach it alike
ROUTES = {
    "bounded": (Q, KV, {}, "sm90"),
    "running": (Q, KV, {}, "sm90"),
    "kv_len": (Q, _t((1, 320, 12, 128)), {}, "sm90"),
    "cross512": (_t((1, 448, 12, 128)), _t((1, 512, 12, 128)), {}, "sm90"),
    "causal": (Q, KV, dict(causal=True), "mma_sync"),
    "segments": (Q, KV, dict(seg="segments"), "mma_sync"),
    "packed": (Q, KV, dict(seg="packed"), "mma_sync"),
    "grouped_kv": (Q, _t((1, 256, 2, 128)), {}, ValueError),
    "fp32": (_t((1, 128, 12, 128), torch.float32),
             _t((1, 256, 12, 128), torch.float32), {}, TypeError),
    "d64": (_t((1, 128, 12, 64)), _t((1, 256, 12, 64)), {}, ValueError),
    "causal_segments": (Q, KV, dict(causal=True, seg="segments"),
                        NotImplementedError),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_bf16_backward_route(case):
    """The unmasked bf16 d=128 backward runs the sm90 kernel, the causal,
    segment and packed ones the mma.sync pair; grouped kv heads, fp32 and
    d != 128 raise (no kernel takes them; nothing falls back)."""
    q, k, kw, want = ROUTES[case]
    if isinstance(want, str):
        assert tfa.bf16_backward_route(q, k, k, **kw) == want
    else:
        with pytest.raises(want):
            tfa.bf16_backward_route(q, k, k, **kw)


@pytest.mark.parametrize("bn,lq,lk,want", [
    (12, 32768, 32768, 1),    # the self shape: 3,072 blocks
    (12, 32768, 512, 11),     # the cross shape: 48 blocks -> 528
    (4, 512, 512, 8),         # small: at most Lq / 64
    (1, 64, 64, 1),
])
def test_bwd_sm90_q_splits(bn, lq, lk, want):
    assert tfa.bwd_sm90_q_splits(bn, lq, lk) == want


def test_tma_readable():
    """The autograd backward copies a bf16 `do` that TMA cannot read in
    place (`tma_readable` False): strides off 16 bytes or an unaligned
    base."""
    x = torch.zeros((1, 64, 2, 136), dtype=torch.bfloat16)
    assert tfa.tma_readable(x[..., :128].contiguous())
    assert tfa.tma_readable(torch.zeros((1, 64, 2, 256),
                                        dtype=torch.bfloat16)[..., :128])
    assert not tfa.tma_readable(torch.zeros((1, 64, 2, 132),
                                            dtype=torch.bfloat16)[..., :128])
    assert not tfa.tma_readable(x.reshape(-1)[4:4 + 64 * 2 * 128]
                                .view(1, 64, 2, 128))


def _walk(qs, k, v, o, lse, do, kv_len, scale, q_splits=1):
    """flash_attention_bwd_sm90.cu's walk in plain PyTorch: for each
    (b, 128-row kv tile [, q split]) the 64-row q tiles from (kv tile) mod
    (count), S^T = k qs^T, p = exp2(s - lse) (kv rows at or past kv_len
    -1e30), dS = p (dO v^T - delta), dV += r(p)^T dO, dK += r(dS)^T qs,
    dQ += r(dS) k into an fp32 accumulator, r the rounding to the inputs'
    dtype (bf16 on the card); dk and dv summed over the splits; each
    output rounded once to that dtype (dq * scale, dk * ln 2)."""
    b, lq, n, d = qs.shape
    lk = k.shape[1]
    bq, bk = tfa.BWD_BLOCK_Q, tfa.BWD_BLOCK_K
    n_q, kt = lq // bq, -(-lk // bk)
    qf, kf, vf, of, dof = (x.float().permute(0, 2, 1, 3)
                           for x in (qs, k, v, o, do))     # [B, N, L, D]
    delta = (dof * of).sum(-1)                             # [B, N, Lq]
    ends = [lk] * b if kv_len is None else [
        min(max(int(x), 0), lk) for x in kv_len]
    dq = torch.zeros((b, n, lq, d))
    dk = torch.zeros((b, n, lk, d))
    dv = torch.zeros((b, n, lk, d))
    per = -(-n_q // q_splits)
    for bi in range(b):
        for j in range(kt):
            kv0 = j * bk
            if kv0 >= ends[bi]:
                continue   # no loads; zero dk and dv
            rows = slice(kv0, min(kv0 + bk, lk))
            kj, vj = kf[bi, :, rows], vf[bi, :, rows]       # [N, r, D]
            dead = torch.arange(kv0, rows.stop) >= ends[bi]
            for sp in range(q_splits):
                begin = sp * per
                count = max(0, min(n_q, begin + per) - begin)
                dk_part = torch.zeros_like(kj)
                dv_part = torch.zeros_like(vj)
                for it in range(count):
                    i = begin + (it + j % count) % count
                    qr = slice(i * bq, (i + 1) * bq)
                    qi, di = qf[bi, :, qr], dof[bi, :, qr]   # [N, 64, D]
                    s = kj @ qi.transpose(1, 2)              # S^T [N, r, 64]
                    s[:, dead] = tfa.NEG_INF
                    p = torch.exp2(s - lse[bi, :, None, qr])
                    ds = p * (vj @ di.transpose(1, 2)
                              - delta[bi, :, None, qr])
                    pb = p.to(do.dtype).float()
                    dsb = ds.to(qs.dtype).float()
                    dv_part += pb @ di
                    dk_part += dsb @ qi
                    dq[bi, :, qr] += dsb.transpose(1, 2) @ kj
                dk[bi, :, rows] += dk_part
                dv[bi, :, rows] += dv_part

    def out(x, mul):
        return (x * mul).permute(0, 2, 1, 3).to(qs.dtype)

    return out(dq, scale), out(dk, tfa.LN2), out(dv, 1.0)


def _rand(shape, seed, normed=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normed:  # qk-normed rows (norm sqrt(d)), the Wan case
        x = x / np.linalg.norm(x, axis=-1, keepdims=True) * shape[-1] ** 0.5
    return x


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# (lq, lk, kv_len, bounded, q_splits): kv_len 0 rows; Lq % 128 == 64
# (a 64-row q tile at the end of a 128-row pair), Lk % 128 == 64 (a
# 64-row last kv tile); the cross shape at 512 keys with uneven splits and
# one empty split (9 q tiles over 4 splits of 3)
WALKS = {
    "self_kvlen_zero_row": (320, 320, (0, 250), True, 1),
    "running": (256, 256, None, False, 1),
    "ragged_kv": (192, 320, (320, 300), True, 1),
    "cross512_split3": (448, 512, None, True, 3),
    "cross512_empty_split": (576, 512, (512, 77), False, 4),
}


def _walk_case(case):
    lq, lk, kvl, bounded, splits = WALKS[case]
    b, n, d = 2, 2, 128
    q = _rand((b, lq, n, d), 10, True)
    k = _rand((b, lk, n, d), 11, True)
    v = _rand((b, lk, n, d), 12)
    do = _rand((b, lq, n, d), 13)
    if kvl is not None:   # keys past kv_len hold large values
        for r, x in enumerate(kvl):
            k[r, x:] = 50.0
            v[r, x:] = 50.0
    fb = 1.01 * d / math.sqrt(d) * LOG2E if bounded else None
    return q, k, v, do, kvl, fb, splits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WALKS))
def test_walk_matches_plain_backward(case, dtype):
    """The walk against `_bwd_plain_folded` on the same inputs and
    residuals: fp32, another summation order only (1e-5 relative L2);
    bf16, PERF.md s2's backward bound; kv_len = 0 rows exactly zero in dq,
    dk and dv."""
    q, k, v, do, kvl, fb, splits = _walk_case(case)
    dt = getattr(torch, dtype)
    qt, kt, vt, dot = (torch.as_tensor(x).to(dt) for x in (q, k, v, do))
    kv = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    sc = 1.0 / math.sqrt(q.shape[-1])
    qs = tfa._fold(qt, sc)
    bound = None if fb is None else torch.tensor(fb)
    o, lse = tfa.attention_plain(qs, kt, vt, kv_len=kv, save_residuals=True,
                                 bound=bound)
    got = _walk(qs, kt, vt, o, lse, dot, kvl, sc, splits)
    want = tfa._bwd_plain_folded(qs, kt, vt, o, lse, dot, kv, sc)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == w.dtype == dt
        if dt == torch.float32:
            assert _rel(g, w) < 1e-5, name
            continue
        assert _rel(g, w) < 1e-4, name
        g, w = g.float(), w.float()
        lim = 2.0 ** -8 * float(w.abs().max()) + 2.0 ** -7 * w.abs()
        assert bool(((g - w).abs() <= lim).all()), name
    if kvl is not None and 0 in kvl:
        r = kvl.index(0)
        for g in got:
            assert float(g[r].float().abs().max()) == 0.0


def _jlse(lse, b, n):
    """JAX's lane-broadcast [B*N, Lq, 128] lse -> [B, N, Lq]."""
    return np.asarray(lse)[:, :, 0].reshape(b, n, -1)


@pytest.mark.parametrize("case", list(WALKS))
def test_walk_matches_pallas_fused_backward(case):
    """The walk against univid_tpu's one-pass Pallas backward
    (`flash_attention_bwd_padded(..., fused=True, interpret=True)`) from
    the Pallas forward's residuals, bf16 (2e-2)."""
    q, k, v, do, kvl, fb, splits = _walk_case(case)
    b, lq, n, d = q.shape
    qj, kj, vj, dj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    blk = dict(block_q=64 if lq % 128 else 128,
               block_k=64 if k.shape[1] % 128 else 128, interpret=True)
    jkw = dict(blk)
    if kvl is not None:
        jkw["kv_len"] = jnp.asarray(kvl, jnp.int32)
    jo, jl = jfa.flash_attention_padded(
        qj, kj, vj, save_residuals=True,
        **(jkw if fb is None else dict(jkw, score_bound=jnp.float32(fb))))
    want = jfa.flash_attention_bwd_padded(qj, kj, vj, jo, jl, dj, fused=True,
                                          **jkw)
    sc = 1.0 / math.sqrt(d)
    qs = tfa._fold(torch.as_tensor(q).to(torch.bfloat16), sc)
    o = torch.as_tensor(np.array(jo.astype(jnp.float32))).to(torch.bfloat16)
    lse = torch.as_tensor(_jlse(jl, b, n).copy())
    got = _walk(qs, *(torch.as_tensor(x).to(torch.bfloat16) for x in (k, v)),
                o, lse, torch.as_tensor(do).to(torch.bfloat16), kvl, sc,
                splits)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   err_msg=name, **BF16)
