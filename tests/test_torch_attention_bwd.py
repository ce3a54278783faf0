"""The port's training attention (forward with lse, backward, the autograd
Function) against univid_tpu's Pallas kernels in interpret mode and its
XLA reference, on the CPU, where the port runs the kernels' plain versions.

Tolerances: fp32 inputs agree to 1e-4 (lse and outputs: the JAX kernel's
blocked online softmax and the plain one-shot max differ only in fp32
rounding, ~1e-6 relative; gradients add fp32 summation orders over 256
keys); bf16 inputs to 2e-2 (p, dS and the outputs round to bf16, 2^-8, at
the same points in both). The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu.kernels.attention import attention as jattention
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu_torch.kernels import attention as tatt
from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
LOG2E = math.log2(math.e)
FP32 = dict(rtol=1e-4, atol=1e-4)
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
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _jlse(lse, b, n):
    """JAX's lane-broadcast [B*N, Lq, 128] lse -> [B, N, Lq]."""
    return np.asarray(lse)[:, :, 0].reshape(b, n, -1)


@pytest.mark.parametrize("case", ["bounded_kv_len", "running",
                                  "cross_lk512", "kv_len_zero_row"])
def test_forward_lse_matches_pallas(case):
    """save_residuals: (o, lse) == the Pallas kernel's, lse column 0; the
    bound gives C + log2 l, the running max m + log2 l, an empty row +1e30."""
    b, n, d = 2, 2, 128
    lq, lk = (256, 512) if case == "cross_lk512" else (256, 256)
    q = _rand((b, lq, n, d), 0, True)
    k = _rand((b, lk, n, d), 1, True)
    v = _rand((b, lk, n, d), 2)
    kv = {"bounded_kv_len": [200, 97], "running": [256, 131],
          "cross_lk512": None, "kv_len_zero_row": [0, 256]}[case]
    fb = None if case == "running" else 1.01 * d / math.sqrt(d) * LOG2E
    jkw = dict(block_q=128, block_k=128, interpret=True, save_residuals=True)
    if kv is not None:
        jkw["kv_len"] = jnp.asarray(kv, jnp.int32)
    if fb is not None:
        jkw["score_bound"] = jnp.float32(fb)
    jo, jl = jfa.flash_attention_padded(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **jkw)
    to, tl = tfa.flash_attention_padded(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        kv_len=None if kv is None else torch.tensor(kv, dtype=torch.int32),
        score_bound=None if fb is None else torch.tensor(fb),
        save_residuals=True)
    assert tl.shape == (b, n, lq) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **FP32)
    np.testing.assert_allclose(tl.numpy(), _jlse(jl, b, n), **FP32)
    if case == "kv_len_zero_row":
        assert np.all(tl.numpy()[0] == 1e30) and np.all(_np(to)[0] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
def test_backward_matches_pallas(fused, dtype):
    """flash_attention_bwd_padded (plain) == the Pallas backward, both the
    one-pass fused kernel and the two-pass dq / dkv pair, from the same
    bounded forward with kv_len (L = 256, N = 2, D = 128)."""
    b, l, n, d = 2, 256, 2, 128
    qj, qt = _both(_rand((b, l, n, d), 3, True), dtype)
    kj, kt = _both(_rand((b, l, n, d), 4, True), dtype)
    vj, vt = _both(_rand((b, l, n, d), 5), dtype)
    gj, gt = _both(_rand((b, l, n, d), 6), dtype)
    kv = np.array([200, 97], np.int32)
    fb = 1.01 * d / math.sqrt(d) * LOG2E
    jo, jl = jfa.flash_attention_padded(
        qj, kj, vj, block_q=128, block_k=128, interpret=True,
        save_residuals=True, kv_len=jnp.asarray(kv),
        score_bound=jnp.float32(fb))
    want = jfa.flash_attention_bwd_padded(
        qj, kj, vj, jo, jl, gj, kv_len=jnp.asarray(kv), block_q=128,
        block_k=128, interpret=True, fused=fused)
    # the same residuals on both sides: the backward alone is compared
    ot = torch.as_tensor(np.array(_np(jo))).to(qt.dtype)
    lt = torch.as_tensor(_jlse(jl, b, n).copy())
    got = tfa.flash_attention_bwd_padded(qt, kt, vt, ot, lt, gt,
                                         kv_len=torch.as_tensor(kv))
    tol = FP32 if dtype == "float32" else BF16
    for g_, w_, name in zip(got, want, ("dq", "dk", "dv")):
        assert g_.dtype == qt.dtype
        np.testing.assert_allclose(_np(g_), _np(w_), err_msg=name, **tol)
    # keys past kv_len get exactly zero dk, dv
    assert np.all(_np(got[1])[1, 97:] == 0) and np.all(_np(got[2])[1, 97:] == 0)


def test_attention_bwd_plain_is_autograd_of_reference():
    """The plain backward == torch autograd through the fp32 masked softmax
    (mha_reference), fp32, from the plain forward's lse."""
    b, l, n, d = 1, 192, 2, 128
    q, k, v, g = (torch.as_tensor(_rand((b, l, n, d), s)) for s in range(7, 11))
    kv = torch.tensor([150], dtype=torch.int32)
    o, lse = tfa.flash_attention_padded(q, k, v, kv_len=kv,
                                        save_residuals=True)
    got = tfa.attention_bwd_plain(q, k, v, o, lse, g, kv_len=kv)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = tatt.mha_reference(qr, kr, vr, kv_len=kv)
    want = torch.autograd.grad((ref * g).sum(), (qr, kr, vr))
    for g_, w_, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g_), _np(w_), err_msg=name, **FP32)


def _jax_grads(backend, q, k, v, g, kv, sb):
    jbackend(backend)
    jfa.set_interpret_mode(backend == "pallas")
    try:
        def f(q, k, v, sb):
            out = jattention(q, k, v, kv_len=kv, score_bound=sb)
            return jnp.sum(out * g)
        argnums = (0, 1, 2, 3) if sb is not None else (0, 1, 2)
        return jax.grad(f, argnums=argnums)(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), sb)
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("case", ["self_bound_kv_len", "cross_bound",
                                  "self_running", "d64_reference"])
def test_attention_grads_match_jax(backend, case):
    """Port `attention` under grad (the autograd Function over the plain
    versions; the d=64 reference route by plain autograd) == jax.grad of
    JAX `attention` on the Pallas custom VJP (interpret) and on XLA, fp32,
    unpadded lengths. The score bound gets a zero gradient on both sides
    (the analogue of test_bounded_softmax_grad_parity)."""
    lq, lk, n, d, bound, kv = {
        "self_bound_kv_len": (200, 200, 2, 128, True, [200, 150]),
        "cross_bound": (300, 40, 2, 128, True, None),
        "self_running": (130, 130, 2, 128, False, None),
        "d64_reference": (120, 120, 2, 64, False, None),
    }[case]
    q = _rand((2, lq, n, d), 12, True)
    k = _rand((2, lk, n, d), 13, True)
    v = _rand((2, lk, n, d), 14)
    g = _rand((2, lq, n, d), 15)
    jkv = None if kv is None else jnp.asarray(kv, jnp.int32)
    sb = jnp.float32(1.01 * d) if bound else None
    want = _jax_grads(backend, q, k, v, jnp.asarray(g), jkv, sb)
    if bound and backend == "pallas":
        assert float(want[3]) == 0.0
    qt, kt, vt = (torch.as_tensor(x).requires_grad_(True) for x in (q, k, v))
    tb = torch.tensor(1.01 * d, requires_grad=True) if bound else None
    out = tatt.attention(qt, kt, vt, score_bound=tb,
                         kv_len=None if kv is None else torch.tensor(kv))
    assert out.shape == (2, lq, n, d)
    leaves = (qt, kt, vt) + ((tb,) if bound else ())
    got = torch.autograd.grad((out * torch.as_tensor(g)).sum(), leaves,
                              allow_unused=True)
    for g_, w_, name in zip(got[:3], want[:3], ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g_), np.asarray(w_), err_msg=name,
                                   **FP32)
    if bound:
        assert got[3] is None or float(got[3]) == 0.0


def test_attention_under_grad_refuses_fused_rope():
    x = torch.zeros((1, 64, 1, 128), requires_grad=True)
    tabs = tfa.build_fused_rope_tables(torch.ones(64, 64),
                                       torch.zeros(64, 64), 128)
    with pytest.raises(NotImplementedError, match="rope"):
        tatt.attention(x, x, x, rope_tables=tabs)
    with torch.no_grad():   # inference keeps the fused route
        assert tatt.attention(x, x, x, rope_tables=tabs).shape == x.shape


def _masked_case(mode, b=2, l=256, n=2, d=128):
    """Inputs of one masked mode (fp32, d=128) with its mask keywords, JAX
    and port: 'causal' (q_offsets 5 and 70), 'causal_kv_len' (kv_len 130,
    256), 'segments' (3 ids a row; the last 20 queries -1 and keys -2, the
    dispatcher's pad ids), 'packed' (two documents with a full split and a
    noise split, then the pad ids). Also the rows that see some key."""
    q = _rand((b, l, n, d), 60, True)
    k = _rand((b, l, n, d), 61, True)
    v = _rand((b, l, n, d), 62)
    kw = {}
    if mode.startswith("causal"):
        kw = dict(causal=True, q_offsets=np.array([5, 70], np.int32))
        if mode == "causal_kv_len":
            kw = dict(causal=True, kv_len=np.array([130, 256], np.int32))
    else:
        if mode == "segments":
            qs = np.zeros((b, l), np.int32)
            qs[:, 90:] = 1
            qs[1, 170:] = 2
            ks = qs.copy()
        else:
            doc = np.ones((b, l), np.int32)
            doc[:, 120:] = 2
            fn = np.full((b, l), -1, np.int32)
            fn[:, 130:170] = 0
            fn[1, 20:60] = 0
            nz = np.full((b, l), -1, np.int32)
            nz[:, 190:236] = 0
            qs = ks = tatt.pack_mask_codes(doc, fn, nz)
            qs, ks = qs.copy(), ks.copy()
            kw["packed_mode"] = True
        qs[:, -20:] = -1
        ks[:, -20:] = -2
        kw.update(q_segments=qs, kv_segments=ks)
    live = np.ones((b, l), bool)
    if "q_segments" in kw:
        live[:, -20:] = False
    return q, k, v, kw, live


def _as(kw, conv):
    return {key: conv(x) if isinstance(x, np.ndarray) else x
            for key, x in kw.items()}


@pytest.mark.parametrize("mode", ["causal", "causal_kv_len", "segments",
                                  "packed"])
def test_masked_forward_and_backward_match_pallas(mode):
    """The plain forward with lse and the plain backward in the causal,
    segment and packed modes == the Pallas forward (save_residuals) and
    the two-pass backward kernels in interpret mode, fp32, d=128. Rows
    with no live key (the pad ids) are compared only where the JAX kernel
    is defined by design: the port gives them 0 and lse +1e30; their
    cotangent is 0, as the dispatcher's slice makes it."""
    q, k, v, kw, live = _masked_case(mode)
    b, l, n, d = q.shape
    g = _rand((b, l, n, d), 63) * live[:, :, None, None]
    jkw = _as(kw, jnp.asarray)
    tkw = _as(kw, torch.as_tensor)
    jo, jl = jfa.flash_attention_padded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
        block_k=128, interpret=True, save_residuals=True, **jkw)
    to, tl = tfa.flash_attention_padded(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        save_residuals=True, **tkw)
    np.testing.assert_allclose(_np(to)[live], _np(jo)[live], **FP32)
    lse_live = live[:, None, :].repeat(n, axis=1)
    np.testing.assert_allclose(tl.numpy()[lse_live],
                               _jlse(jl, b, n)[lse_live], **FP32)
    assert np.all(_np(to)[~live] == 0.0)
    assert np.all(tl.numpy()[~lse_live] == 1e30)
    want = jfa.flash_attention_bwd_padded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl,
        jnp.asarray(g), block_q=128, block_k=128, interpret=True,
        fused=False, **jkw)
    got = tfa.flash_attention_bwd_padded(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), to, tl,
        torch.as_tensor(g), **tkw)
    for g_, w_, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g_), _np(w_), err_msg=name, **FP32)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["packed", "causal"])
def test_masked_attention_grads_match_jax(backend, mode):
    """Port `attention` under grad on L = 200 (padded to 256 inside, pad
    ids -1 / -2 for the codes) == jax.grad of JAX `attention` on the Pallas
    custom VJP (interpret) and on XLA, fp32: the packed mode of BAGEL
    packed training, and causal with per-row q_offsets."""
    q, k, v, kw, _ = _masked_case(mode)
    lq = 200
    q, k, v = q[:, :lq], k[:, :lq], v[:, :lq]
    kw = {key: (x[:, :lq] if key.endswith("segments") else x)
          for key, x in kw.items()}
    if mode == "packed":   # no pad ids here: the dispatchers add them
        kw["q_segments"] = kw["kv_segments"] = np.ascontiguousarray(
            np.maximum(kw["q_segments"], 0))
    g = _rand(q.shape, 64)
    jbackend(backend)
    jfa.set_interpret_mode(backend == "pallas")
    try:
        jkw = _as(kw, jnp.asarray)

        def f(q_, k_, v_):
            return jnp.sum(jattention(q_, k_, v_, **jkw) * g)
        want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)
    qt, kt, vt = (torch.as_tensor(x).requires_grad_(True) for x in (q, k, v))
    out = tatt.attention(qt, kt, vt, **_as(kw, torch.as_tensor))
    assert out.shape == q.shape
    got = torch.autograd.grad((out * torch.as_tensor(g)).sum(), (qt, kt, vt))
    for g_, w_, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g_), np.asarray(w_), err_msg=name,
                                   **FP32)
