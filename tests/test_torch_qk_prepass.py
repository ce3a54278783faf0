"""The DiT's q / k pre-passes (csrc/qk_prepass.cu) on the CPU.

Kernel A (`qk_norm_rope`: Wan's qk RMS norm as the prologue of the fused
rope rotation) and kernel B (`quantize_qk_int8`) run only on a card, where
tests/test_torch_cuda.py and chip_smoke.py hold them against their plain
versions. Here:

  * `qk_norm_rope_plain` is `rms_norm` then `rotate`, bit for bit, in its
    three modes, and the wrapper takes it for CPU tensors;
  * against JAX's `nn.rms_norm` and the Pallas kernel's in-prologue
    rotation (`_rot`, the same fp32 products and sum) at d = 128;
  * a 2-block d=128 DiT with fused rope hands q and k to `attention`
    before their norm (`qk_norm`) and matches JAX on its Pallas kernels in
    interpret mode, bare and with qk_int8, within the bound the existing
    DiT test holds (rel. L2 < 2e-2 at the bf16 policy);
  * a numpy emulation of kernel A's fp32 sum of squares (each thread's 16-
    byte chunks in order, a warp butterfly, the four warps in order)
    against the plain version's order: how often a normed bf16 value moves,
    and that it moves by one step at most (the card tolerance of PERF.md
    s2 rests on it);
  * an emulation of kernel B's block-max walk (per-group maxima folded per
    block, as the kernel's atomicMax does) gives codes and scales equal to
    `quantize_qk_int8_plain`, at block_k 128, 512 and 2048 with L not a
    multiple of block_k.

XLA's and PyTorch's CPU rsqrt differ by up to 2 fp32 ulps in about half the
rows (measured), so against JAX a normed value can also take its
neighbouring bf16 step: those comparisons take the same bound as the card
(one step of the normed value, carried through the gain and the
rotation), and hold all but 1e-3 of the values to one bf16 ulp.
"""

import dataclasses
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from test_torch_models import D128, np_params
from univid_tpu.core import nn as jnn
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.dit import wan_dit_forward as j_dit
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu_torch import convert
from univid_tpu_torch.core import nn as unn
from univid_tpu_torch.core.config import WanDiTConfig
from univid_tpu_torch.core.dtypes import DEFAULT_POLICY
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.models.wan import dit as tdit
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d

torch.set_num_threads(2)
LOG2E = math.log2(math.e)
EPS = 1e-6
BF16 = ml_dtypes.bfloat16
# one bf16 step of a normed value (2^-7 relative), after the gain's product
# and its rounding (chip_smoke.py QK_STEP)
QK_STEP = 2.0 ** -6 * 1.0625
NT, CH, HG = 128, 16, 8   # kernel A: threads a token, chunks a head, heads a pass


def _pre_norm(shape, seed):
    """bf16 q / k rows before their norm, at the scale of the DiT's
    projections."""
    x = np.random.default_rng(seed).standard_normal(shape) * 3
    return x.astype(np.float32).astype(BF16).astype(np.float32)


def _gains(n, seed):
    g = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    return g.astype(np.float32).astype(BF16).astype(np.float32)


def _tables(d, grid, lq, lk):
    return tfa._pad_tables(tfa.build_fused_rope_tables(
        *trope3d(d, grid, device="cpu"), d), lq, lk, LOG2E / math.sqrt(d))


def _t(x):
    return torch.as_tensor(x).to(torch.bfloat16)


def _rope_abs(x, cf, sf):
    """|x| |cosF| + |swap_pairs(x)| |sinF|: what a rotated value moves by
    per unit of relative change in x."""
    a = x.float().abs()
    sw = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2).flip(-1) \
        .reshape(a.shape)
    return a * cf.abs()[:, None, :] + sw * sf.abs()[:, None, :]


@pytest.mark.parametrize("mode", ["norm_rope", "norm", "rope"])
def test_qk_norm_rope_plain_is_norm_then_rotate(mode):
    """The plain version is core.nn.rms_norm over each token's N * D width,
    then `rotate` into bf16 (q's tables with the fold), bit for bit, with q
    and k of other lengths; `qk_norm_rope` takes it for CPU tensors."""
    b, lq, lk, n, d = 2, 40, 24, 3, 128
    q, k = _t(_pre_norm((b, lq, n, d), 0)), _t(_pre_norm((b, lk, n, d), 1))
    gq, gk = _t(_gains(n * d, 2)), _t(_gains(n * d, 3))
    cq, sq, ck, sk = tabs = _tables(d, (2, 4, 5), lq, lk)
    norm = (gq, gk, EPS) if mode != "rope" else None
    rope = tabs if mode != "norm" else None

    def ref(x, g, c, s):
        if norm is not None:
            x = unn.rms_norm(x.reshape(b, x.shape[1], n * d), g,
                             eps=EPS).reshape(x.shape)
        if rope is not None:
            x = tfa.rotate(x, c, s, torch.bfloat16)
        return x

    want = (ref(q, gq, cq, sq), ref(k, gk, ck, sk))
    for got in (tfa.qk_norm_rope_plain(q, k, norm, rope),
                tfa.qk_norm_rope(q, k, qk_norm=norm, rope_tables=rope)):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and g.is_contiguous()
            assert torch.equal(g, w)


def _jax_rot(x32, c, s):
    """The Pallas kernel's `_rot` (univid_tpu/kernels/flash_attention.py
    :119-135) on [B, L, N, D]: x * cosF + swap_pairs(x) * sinF in fp32,
    the swap as its two lane rolls and a parity select."""
    d = x32.shape[-1]
    lane = jnp.arange(d)
    sw = jnp.where(lane % 2 == 0, jnp.roll(x32, -1, axis=-1),
                   jnp.roll(x32, 1, axis=-1))
    return x32 * c[None, :, None, :] + sw * s[None, :, None, :]


@pytest.mark.parametrize("n", [2, 4])
def test_qk_norm_rope_matches_jax(n):
    """Kernel A's function against JAX at d = 128: nn.rms_norm over the
    token's N * 128 width, then the Pallas prologue's rotation with JAX's
    fused tables (q's folded by scale * log2 e), rounded to bf16."""
    b, l, d = 2, 160, 128
    grid = (5, 4, 8)
    q, k = _pre_norm((b, l, n, d), 10 + n), _pre_norm((b, l, n, d), 20 + n)
    gq, gk = _gains(n * d, 30 + n), _gains(n * d, 40 + n)
    jt = jfa._pad_tables(jfa.build_fused_rope_tables(*jrope3d(d, grid), d),
                         l, l, LOG2E / math.sqrt(d))
    tt = _tables(d, grid, l, l)
    got = tfa.qk_norm_rope(_t(q), _t(k), qk_norm=(_t(gq), _t(gk), EPS),
                           rope_tables=tt)
    for x, g, c, s, y, tc, ts in ((q, gq, jt[0], jt[1], got[0], tt[0], tt[1]),
                                  (k, gk, jt[2], jt[3], got[1], tt[2],
                                   tt[3])):
        normed = jnn.rms_norm(jnp.asarray(x, jnp.bfloat16).reshape(
            b, l, n * d), jnp.asarray(g, jnp.bfloat16), eps=EPS)
        normed = normed.reshape(b, l, n, d)
        want = np.asarray(_jax_rot(normed.astype(jnp.float32), c, s)
                          .astype(jnp.bfloat16).astype(jnp.float32))
        err = np.abs(y.float().numpy() - want)
        lim = (QK_STEP * _rope_abs(torch.as_tensor(
            np.array(normed.astype(jnp.float32))), tc, ts).numpy()
            + 2.0 ** -7 * 1.0625 * np.abs(want))
        assert (err <= lim).all(), float((err - lim).max())
        # all but a few values within one bf16 ulp of JAX's
        assert (err > 2.0 ** -7 * np.abs(want)).mean() < 1e-3


@pytest.mark.parametrize("knob", ["bare", "qk_int8"])
def test_dit_qk_norm_route_matches_jax(knob, monkeypatch):
    """A 2-block d=128 DiT (fused rope, the bound, kv_len from the 64-token
    pad) at the bf16 policy, bare and with qk_int8: every attention call
    gets q and k before their norm (`qk_norm`, the gains of the block)
    and the forward matches JAX on its Pallas kernels in interpret mode
    within test_torch_models' bound for this policy, rel. L2 < 2e-2."""
    jc, tc = JDiTConfig(**D128), WanDiTConfig(**D128)
    params = np_params(init_wan_dit, jc, 1, stacked=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 2, 8, 8, 16)).astype(np.float32)
    t = np.array([700.0, 700.0], np.float32)
    ctx = (rng.standard_normal((2, jc.text_len, jc.text_dim)) * 0.5) \
        .astype(np.float32)
    grid = (2, 4, 4)
    kn = dict(bounded_softmax=True, qk_int8=knob == "qk_int8")
    kw = dict(seq_pad_to=64, fused_rope=True)
    cos, sin = jrope3d(jc.head_dim, grid)
    jbackend("pallas")
    jfa.set_interpret_mode(True)
    try:
        want = np.asarray(j_dit(params, jc, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx), cos, sin,
                                policy=dataclasses.replace(J_DEFAULT, **kn),
                                **kw))
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)

    seen = []
    attention = tdit.attention

    def spy(q, k, v, **a):
        seen.append(a.get("qk_norm"))
        return attention(q, k, v, **a)

    monkeypatch.setattr(tdit, "attention", spy)
    dit = convert.dit_from_jax(params, tc, device="cpu")
    tcos, tsin = trope3d(tc.head_dim, grid, device="cpu")
    with torch.no_grad():
        got = tdit.wan_dit_forward(
            dit, torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx),
            tcos, tsin, policy=dataclasses.replace(DEFAULT_POLICY, **kn),
            **kw).double().numpy()
    assert len(seen) == 2 * tc.num_layers    # self and cross a block
    for i, norm in enumerate(seen):
        blk = dit.blocks[i // 2]
        attn = blk.self_attn if i % 2 == 0 else blk.cross_attn
        gq, gk, eps = norm
        assert eps == EPS and gq.dtype == torch.bfloat16
        assert torch.equal(gq, attn.norm_q.to(torch.bfloat16))
        assert torch.equal(gk, attn.norm_k.to(torch.bfloat16))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 2e-2, err


@pytest.mark.parametrize("trainable", ["q", "gains"])
def test_attention_qk_norm_under_grad_norms_first(trainable):
    """Under grad, q / k or only the gains requiring it, `attention`
    norms q and k by `rms_heads` under autograd and takes the training
    route: its output and every gradient equal those of the call that
    norms first."""
    from univid_tpu_torch.kernels.attention import attention
    b, l, n, d = 1, 64, 2, 128
    q, k, v = (torch.as_tensor(_pre_norm((b, l, n, d), s)) for s in
               (80, 81, 82))
    gq, gk = (torch.as_tensor(_gains(n * d, s)) for s in (83, 84))
    leaves = (q, k, v, gq, gk) if trainable == "q" else (gq, gk)
    runs = []
    for route in ("qk_norm", "first"):
        xs = [t.clone().requires_grad_(any(t is u for u in leaves))
              for t in (q, k, v, gq, gk)]
        tq, tk, tv, tgq, tgk = xs
        if route == "qk_norm":
            o = attention(tq, tk, tv, qk_norm=(tgq, tgk, EPS))
        else:
            o = attention(tfa.rms_heads(tq, tgq, EPS),
                          tfa.rms_heads(tk, tgk, EPS), tv)
        o.square().sum().backward()
        runs.append([o.detach()] + [t.grad for t in xs if t.requires_grad])
    assert len(runs[0]) == 1 + len(leaves)
    for g, w in zip(*runs):
        assert torch.equal(g, w)


def _kernel_a_sum(sq32, n):
    """Kernel A's fp32 sum of squares of each token ([T, n * 128] of
    rounded squares): thread t adds its chunk (t % 16) of heads t // 16 +
    8 i, i in order, each 8 values in order; a butterfly over each warp
    (xor 16, 8, 4, 2, 1: every lane ends with the same sum); the four warps'
    sums in order."""
    t_tok = sq32.shape[0]
    nch = -(-n // HG)
    per = np.zeros((t_tok, NT), np.float32)
    sq = sq32.reshape(t_tok, n, CH, 8)
    for tid in range(NT):
        c, hg = tid % CH, tid // CH
        acc = np.zeros(t_tok, np.float32)
        for i in range(nch):
            h = hg + HG * i
            if h >= n:
                continue
            for j in range(8):
                acc = (acc + sq[:, h, c, j]).astype(np.float32)
        per[:, tid] = acc
    warps = per.reshape(t_tok, NT // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = np.arange(32)
        warps = (warps + warps[:, :, lanes ^ o]).astype(np.float32)
    tot = warps[:, 0, 0]
    for w in range(1, NT // 32):
        tot = (tot + warps[:, w, 0]).astype(np.float32)
    return tot


@pytest.mark.parametrize("n", [12, 24])
def test_kernel_a_sum_order_moves_a_value_by_one_step_at_most(n):
    """Kernel A's sum of squares (emulated in fp32, order above) against
    the plain version's (torch on the CPU): the two sums differ by a few
    fp32 ulps, so rsqrt(mean + eps) does too (both exact here, as in
    float64, rounded to fp32: the order's effect alone). A normed value
    bf16(x r) then moves in a small share of the elements, by one bf16
    step at most; after the gain's product and rounding by <= QK_STEP of
    |y|. With the plain version's r the emulated epilogue equals the plain
    output bit for bit. Measured: the sums differ in 36-39% of the rows,
    by at most 3 ulps; 4.5e-6 (N = 12) and 8.6e-6 (N = 24) of the normed
    values move, each by one step."""
    t_tok, d = 2048, 128
    x = _pre_norm((t_tok, n * d), 50 + n)
    g = _gains(n * d, 60 + n)
    x32 = x.astype(np.float32)
    sq = (x32 * x32).astype(np.float32)
    mean_k = (_kernel_a_sum(sq, n) / np.float32(n * d)).astype(np.float32)
    mean_p = torch.as_tensor(x32).square().mean(-1).numpy()

    def r_of(mean):
        m = (mean + np.float32(EPS)).astype(np.float32)
        return (1.0 / np.sqrt(m.astype(np.float64))).astype(np.float32)

    def epilogue(r):
        nrm = (x32 * r[:, None]).astype(np.float32).astype(BF16)
        y = (nrm.astype(np.float32) * g).astype(np.float32).astype(BF16)
        return nrm.astype(np.float32), y.astype(np.float32)

    n_k, y_k = epilogue(r_of(mean_k))
    n_p, y_p = epilogue(r_of(mean_p))
    plain = unn.rms_norm(torch.as_tensor(x32).to(torch.bfloat16),
                         torch.as_tensor(g).to(torch.bfloat16), eps=EPS)
    # the epilogue's rounding points are the plain version's (with torch's
    # own rsqrt, which rounds like the exact one on these rows or not)
    r_t = torch.rsqrt(torch.as_tensor(mean_p) + EPS).numpy()
    assert np.array_equal(epilogue(r_t)[1], plain.float().numpy())
    ulps = np.abs(mean_k.view(np.int32).astype(np.int64)
                  - mean_p.view(np.int32).astype(np.int64))
    moved = n_k != n_p
    step = np.abs(n_p) * 2.0 ** -7   # a bf16 step is at most 2^-7 |value|
    assert ulps.max() <= 8 and moved.mean() < 1e-3
    assert (np.abs(n_k - n_p) <= step).all()
    assert (np.abs(y_k - y_p) <= QK_STEP * np.abs(y_p)).all()


def _rotate32(x, c, s):
    """The fp32 rotation, products and sum each rounded once (numpy)."""
    d = x.shape[-1]
    sw = x.reshape(*x.shape[:-1], d // 2, 2)[..., ::-1].reshape(x.shape)
    return ((x * c[:, None, :]).astype(np.float32)
            + (sw * s[:, None, :]).astype(np.float32)).astype(np.float32)


def _kernel_b_emulated(q, k, tabs, bw, group=32):
    """Kernel B's walk in numpy: q row scales from each row's max; k maxima
    per group of `group` tokens of one (b, h) (a kernel block's), folded
    per bw block by max (order-free: atomicMax on the bits), then codes
    from 127 / ak, ties to even."""
    cq, sq, ck, sk = (t.numpy() for t in tabs)
    q32 = _rotate32(q, cq, sq).transpose(0, 2, 1, 3)   # [B, N, L, D]
    k32 = _rotate32(k, ck, sk).transpose(0, 2, 1, 3)
    c127 = np.float32(127.0)
    aq = np.maximum(np.abs(q32).max(-1), np.float32(1e-30))
    qi = np.rint(q32 * (c127 / aq)[..., None]).astype(np.int8)
    b, n, lk, _ = k32.shape
    nblk = -(-lk // bw)
    kmax = np.zeros((b, n, nblk), np.float32)
    for l0 in range(0, lk, group):
        m = np.abs(k32[:, :, l0:l0 + group]).max(axis=(2, 3))
        kmax[:, :, l0 // bw] = np.maximum(kmax[:, :, l0 // bw], m)
    ak = np.maximum(kmax, np.float32(1e-30))
    r = np.repeat(c127 / ak, bw, axis=-1)[..., :lk]
    ki = np.rint(k32 * r[..., None]).astype(np.int8)
    return (qi, (aq * np.float32(1.0 / 127.0)).astype(np.float32), ki,
            (ak * np.float32(1.0 / 127.0)).astype(np.float32))


@pytest.mark.parametrize("bw", [128, 512, 2048])
def test_kernel_b_block_max_walk_equals_plain(bw):
    """The emulated walk's codes and scales equal quantize_qk_int8_plain's
    bit for bit, with L = 4,416 (not a multiple of 128, 512 or 2,048: the
    last block is short) and keys past a kv_len of 4,300 large (the block
    max is taken unmasked), over the kernel's 32-token groups."""
    b, l, n, d = 2, 4416, 2, 128
    q = _pre_norm((b, l, n, d), 70) / 4
    k = _pre_norm((b, l, n, d), 71) / 4
    k[:, 4300:] *= 8   # powers of two: still bf16 values
    tabs = _tables(d, (3, 46, 32), l, l)
    want = tfa.quantize_qk_int8_plain(_t(q), _t(k), tabs, bw)
    assert want[3].shape[-1] == -(-l // bw)
    got = _kernel_b_emulated(q, k, tabs, bw)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        assert np.array_equal(g, w.numpy())
