"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: they skip on machines without one. The file imports neither
JAX nor univid_tpu, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Small shapes; chip_smoke.py holds the kernels at the main path's shapes.
Tolerances: fp32 2e-5 (rounding and the approximate exp2; the d=384
kernel on unfolded rows of norm sqrt(d) against the function in fp64,
since fp32 arithmetic itself misses that bound there; the d=640 /
d=1024 kernel and the fp32 d=128 forward at their stated 1e-5 + 1e-4 |ref|,
lse 1e-4; the fp32 d=128 backward 1e-4 max|ref| + 1e-4 |ref| and rel. L2
< 1e-4); bf16 2e-2 relative (one bf16 rounding of p and of the output,
2^-8). The fp32 fine-tune step on the card is held against the CPU as
tests/test_torch_fp32_train.py holds it against JAX.
"""

import math

import numpy as np
import pytest
import torch

from univid_tpu_torch.kernels import attention as tatt
from univid_tpu_torch.kernels import build
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
        elif dt == torch.float32:
            # the same function in fp64: these unfolded rows of norm
            # sqrt(d) give scores ~ N(0, d), on which fp32 arithmetic
            # itself misses this test's bound (tests/test_torch_f32_tc.py)
            got = tfa._flash_cuda(q, k, v, kv, bound, tabs)
            want = _attention_f64(q, k, v, kv)
        else:
            got = tfa._flash_cuda(q, k, v, kv, bound, tabs)
            want = tfa.attention_plain(q, k, v, kv_len=kv, bound=bound,
                                       rope_tables=tabs)
    torch.cuda.synchronize()
    tol = FP32 if dt == torch.float32 else BF16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


def _attention_f64(q, k, v, kv_len):
    """attention_plain's function (running-max mode, kv_len) in fp64 on
    the CPU: [B, L, N, D] with q folded."""
    s = torch.einsum("bqnd,bknd->bnqk", q.double().cpu(), k.double().cpu())
    dead = (torch.arange(k.shape[1])[None, :]
            >= kv_len.cpu()[:, None])[:, None, None, :]
    s = s.masked_fill(dead, -math.inf)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bnqk,bknd->bqnd", p, v.double().cpu())
    return o / p.sum(-1).permute(0, 2, 1)[..., None]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [640, 1024])
def test_cuda_f32_wide_kernel_matches_plain(cuda_device, d):
    """The fp32 kernel at the ti2v-5B VAE's head dims against its plain
    version: batch row 0 has 77 padded keys holding 50.0 (masked by
    kv_len), row 1 has kv_len = 0 and must be exactly zero."""
    lq = lk = 512
    q, k, v = (torch.as_tensor(_rand((2, lq, 1, d), s)).to(cuda_device)
               for s in (7, 8, 9))
    q = q * (LOG2E / math.sqrt(d))
    k[0, lk - 77:] = 50.0
    v[0, lk - 77:] = 50.0
    kv = torch.tensor([lk - 77, 0], dtype=torch.int32, device=cuda_device)
    tfa.reset_launches()
    with torch.no_grad():
        got = tfa._flash_cuda(q, k, v, kv, None, None)
        want = tfa.attention_plain(q, k, v, kv_len=kv)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_f32"] == 1
    assert tfa.F32_LAUNCHES_BY_D == {dd: int(dd == d) for dd in tfa.F32_DIMS}
    assert float(got[1].abs().max()) == 0.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_f32_head_dim_without_kernel_raises(cuda_device):
    """An fp32 head dim with no kernel raises on the card; it never takes
    the plain version there."""
    x = torch.zeros((1, 64, 1, 256), device=cuda_device)
    with pytest.raises(ValueError, match="no torch.float32 kernel"):
        tfa.flash_attention_padded(x, x, x)


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bounded_kvlen", "running", "cross512"])
def test_cuda_training_kernels_match_plain(cuda_device, mode):
    """The forward with lse and the backward (the one-pass sm90 kernel in
    these unmasked modes) against their plain versions on the card (bf16;
    lse to 1e-3 absolute, the
    approximate exp2 and the summation order; gradients to 2e-2 relative
    L2 and elementwise, one bf16 rounding of p, dS and the output)."""
    b, lq, n, d = 2, 512, 2, 128
    lk = 512 if mode == "cross512" else lq
    q = torch.as_tensor(_rand((b, lq, n, d), 3, True)).to(cuda_device,
                                                          torch.bfloat16)
    k, v = (torch.as_tensor(_rand((b, lk, n, d), s, True)).to(
        cuda_device, torch.bfloat16) for s in (4, 5))
    do = torch.as_tensor(_rand((b, lq, n, d), 6)).to(cuda_device,
                                                     torch.bfloat16)
    kv = (torch.tensor([lk - 77, 0], dtype=torch.int32, device=cuda_device)
          if mode == "bounded_kvlen" else None)
    if kv is not None:   # masked keys hold large values
        k[0, lk - 77:] = 50.0
        v[0, lk - 77:] = 50.0
    bound = (None if mode == "running" else
             torch.tensor([1.01 * d * LOG2E / math.sqrt(d)],
                          device=cuda_device))
    qs = tfa._fold(q, 1.0 / math.sqrt(d))
    with torch.no_grad():
        o, lse = tfa.flash_attention_fwd_folded(qs, k, v, kv_len=kv,
                                                score_bound=bound)
        o_p, lse_p = tfa.attention_plain(qs, k, v, kv_len=kv, bound=bound,
                                         save_residuals=True)
        grads = tfa.flash_attention_bwd_folded(
            qs, k, v, o_p, lse_p, do, kv_len=kv, softmax_scale=d ** -0.5)
        want = tfa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv,
                                     d ** -0.5)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_p.float().cpu().numpy(), **BF16)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=0, atol=1e-3)
    for got, ref, name in zip(grads, want, ("dq", "dk", "dv")):
        assert _rel(got, ref) < 2e-2, name
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), err_msg=name,
                                   **BF16)
    if kv is not None:   # kv_len = 0: lse +1e30, zero dq / dk / dv
        assert bool((lse[1] == 1e30).all())
        for gr in grads:
            assert float(gr[1].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_attention_function_grads(cuda_device):
    """attention() under grad on the card (the autograd Function over the
    kernels: the forward with lse, the one-pass sm90 backward) against
    autograd through the fp32 mha_reference, relative L2 (bf16 inputs and
    roundings: 2e-2)."""
    b, l, n, d = 1, 300, 2, 128
    q, k, v, g = (torch.as_tensor(_rand((b, l, n, d), s, s < 5)).to(
        cuda_device, torch.bfloat16) for s in (3, 4, 5, 6))
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    tfa.reset_launches()
    out = tatt.attention(qt, kt, vt, score_bound=1.01 * d)
    got = torch.autograd.grad((out.float() * g.float()).sum(),
                              (qt, kt, vt))
    assert tfa.LAUNCHES["flash_attention_bf16_lse"] == 1
    assert tfa.LAUNCHES["flash_attention_bwd_bf16_sm90"] == 1
    assert tfa.LAUNCHES["flash_attention_bwd_dq_bf16"] == 0
    assert tfa.LAUNCHES["flash_attention_bwd_dkv_bf16"] == 0
    assert tfa.BWD_LAUNCHES_BY_IMPL == {"sm90": 1, "mma_sync": 0}
    qr, kr, vr = (x.float().requires_grad_(True) for x in (q, k, v))
    ref = tatt.mha_reference(qr, kr, vr)
    want = torch.autograd.grad((ref * g.float()).sum(), (qr, kr, vr))
    assert _rel(out.float(), ref) < 2e-2
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _rel(a.float(), w) < 2e-2, name


# causal cases (lq, lk, q_offset, q_offsets, kv_len, group): offsets that
# are not multiples of 64, a q tile straddling kv_len, padded query rows
# past kv_len, B = 3 rows with different offsets, group 1 and 7. Every case
# but the last takes the causal kernel's split-kv pass (`causal_splits`:
# 2, 3, 4, 5 and 5 splits); long_cache_g7 is a question prefill over a
# 4,096-row cache with a kv_len = 47 row at offset 0; square_g7_no_split
# gives 336 blocks and no split
CAUSAL = {
    "square_g1": (192, 192, 0, None, (192, 150, 64), 1),
    "offsets_g7": (128, 512, 0, (37, 250, 384), (101, 300, 450), 7),
    "static_plus_dynamic_g7": (64, 448, 13, (0, 129, 320), (64, 200, 390),
                               7),
    "decode_like_g7": (64, 1024, 0, (1000, 999, 3), (1003, 1024, 10), 7),
    "long_cache_g7": (64, 4096, 0, (3000, 4032, 0), (3047, 4096, 47), 7),
    "square_g7_no_split": (1024, 1024, 0, None, (1024, 1000, 700), 7),
}


def _causal_inputs(cuda_device, case):
    lq, lk, qoff, qoffs, kvl, group = CAUSAL[case]
    nk = 2
    n = nk * group
    q = torch.as_tensor(_rand((3, lq, n, 128), 30, True)).to(
        cuda_device, torch.bfloat16)
    k, v = (torch.as_tensor(_rand((3, lk, nk, 128), s, True)).to(
        cuda_device, torch.bfloat16) for s in (31, 32))
    qo = None if qoffs is None else torch.tensor(qoffs, dtype=torch.int32,
                                                 device=cuda_device)
    kv = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
    for r in range(3):
        k[r, kvl[r]:] = 50.0
        v[r, kvl[r]:] = 50.0
    return q, k, v, qoff, qo, kv


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CAUSAL))
def test_cuda_causal_kernel_matches_plain(cuda_device, case):
    """The causal mode (running max, static q_offset + device q_offsets,
    kv_len, grouped kv heads) on flash_attention_causal_sm90.cu against its
    plain version on the card, bf16 (2e-2: one bf16 rounding of p and of
    the output). Keys past kv_len and past the diagonal hold 50.0: a key
    let through would be far off."""
    q, k, v, qoff, qo, kv = _causal_inputs(cuda_device, case)
    tfa.reset_launches()
    with torch.no_grad():
        got = tfa.flash_attention_padded(q, k, v, kv_len=kv, causal=True,
                                         q_offset=qoff, q_offsets=qo)
        want = tfa.flash_attention_padded(q.cpu(), k.cpu(), v.cpu(),
                                          kv_len=kv.cpu(), causal=True,
                                          q_offset=qoff,
                                          q_offsets=None if qo is None
                                          else qo.cpu())
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bf16_causal"] == 1
    assert tfa.LAUNCHES["flash_attention_bf16"] == 0
    assert tfa.LAUNCHES_BY_IMPL == {"sm90": 0, "causal_sm90": 1,
                                    "mma_sync": 0}
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["square_g1", "decode_like_g7",
                                  "long_cache_g7", "square_g7_no_split"])
def test_cuda_causal_lse_matches_plain(cuda_device, case):
    """The causal forward with lse on flash_attention_causal_sm90.cu (the
    split and the unsplit form) against its plain version and against the
    mma.sync kernel it replaced, on the card: outputs as in `_check_fwd`
    (running max), lse to 1e-3 (the approximate exp2 and the summation
    order). The kernel on grouped kv heads directly; the training forward's
    route (`flash_attention_fwd_folded`, which takes kv heads repeated, as
    the backward does) on the repeated heads."""
    q, k, v, qoff, qo, kv = _causal_inputs(cuda_device, case)
    qs = tfa._fold(q, 128 ** -0.5)
    masks = dict(causal=True, q_offset=qoff, q_offsets=qo)
    n = q.shape[2]
    with torch.no_grad():
        lse = torch.empty((q.shape[0], n, q.shape[1]), device=cuda_device)
        o = tfa._launch_causal_sm90(qs, k, v, kv, qoff, qo, lse=lse)
        o_p, lse_p = tfa.attention_plain(qs, k, v, kv_len=kv,
                                         save_residuals=True, **masks)
        lse_old = torch.empty_like(lse)
        o_old = tfa._launch_bf16(qs, k, v, kv, None, tfa._MODE_RUNNING,
                                 lse=lse_old, causal=True, q_offset=qoff,
                                 q_offsets=qo)
        kr, vr = tfa.repeat_kv(k, n), tfa.repeat_kv(v, n)
        tfa.reset_launches()
        o_r, lse_r = tfa.flash_attention_fwd_folded(qs, kr, vr, kv_len=kv,
                                                    **masks)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bf16_lse"] == 1
    assert tfa.LAUNCHES_BY_IMPL == {"sm90": 0, "causal_sm90": 1,
                                    "mma_sync": 0}
    for got, got_lse, ref, ref_lse in ((o, lse, o_p, lse_p),
                                       (o, lse, o_old, lse_old),
                                       (o_r, lse_r, o_p, lse_p)):
        _check_fwd(got, ref, v, running=True)
        np.testing.assert_allclose(got_lse.cpu().numpy(),
                                   ref_lse.cpu().numpy(), rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_cuda_causal_empty_rows(cuda_device):
    """Rows with no live key on the causal kernel, split (4 splits) and
    unsplit: a batch row with kv_len = 0, and rows whose q_offsets put them
    before key 0 (row < 0), come out exactly 0 with lse +1e30."""
    q = _bf16((2, 128, 14, 128), 33, cuda_device)
    k, v = (_bf16((2, 1024, 2, 128), s, cuda_device) for s in (34, 35))
    qs = tfa._fold(q, 128 ** -0.5)
    kv = torch.tensor([0, 1024], dtype=torch.int32, device=cuda_device)
    qo = torch.tensor([0, -100], dtype=torch.int32, device=cuda_device)
    assert tfa.causal_splits(2, 14, 7, 128, 1024) == 4
    for qq, kk, vv in ((qs, k, v), (qs.repeat(4, 1, 1, 1), k.repeat(
            4, 1, 1, 1), v.repeat(4, 1, 1, 1))):
        b = qq.shape[0]
        with torch.no_grad():
            lse = torch.empty((b, 14, 128), device=cuda_device)
            o = tfa._launch_causal_sm90(qq, kk, vv, kv.repeat(b // 2), 0,
                                        qo.repeat(b // 2), lse=lse)
        torch.cuda.synchronize()
        for r in range(0, b, 2):
            assert float(o[r].abs().max()) == 0.0
            assert bool((lse[r] == 1e30).all())
            assert float(o[r + 1, :100].abs().max()) == 0.0
            assert bool((lse[r + 1, :, :100] == 1e30).all())
            assert bool((lse[r + 1, :, 100:] < 1e29).all())
    assert tfa.causal_splits(8, 14, 7, 128, 1024) == 1


@pytest.mark.cuda
def test_cuda_grouped_running_kernel_matches_plain(cuda_device):
    """The non-causal running-max mode with 14 query heads over 2 kv heads
    (BAGEL's ViT append, group 7) against its plain version."""
    q = torch.as_tensor(_rand((1, 192, 14, 128), 40, True)).to(
        cuda_device, torch.bfloat16)
    k, v = (torch.as_tensor(_rand((1, 640, 2, 128), s, True)).to(
        cuda_device, torch.bfloat16) for s in (41, 42))
    kv = torch.tensor([555], dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        got = tfa.flash_attention_padded(q, k, v, kv_len=kv)
        want = tfa.attention_plain(tfa._fold(q, 128 ** -0.5), k, v,
                                   kv_len=kv)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16)


def _masked_inputs(cuda_device, mode, b=2, l=448, n=4, nk=2):
    """bf16 q [b, l, n, 128] over k, v [b, l, nk, 128] with segment ids or
    packed codes: row 1's second segment (document) starts at key 150, so
    its queries in the third tile meet two wholly masked tiles before
    their first live key; the last 30 queries carry the pad id -1 and the
    last 30 keys -2 (k = v = 50.0 there), so those rows see no key."""
    q = torch.as_tensor(_rand((b, l, n, 128), 50, True)).to(
        cuda_device, torch.bfloat16)
    k, v = (torch.as_tensor(_rand((b, l, nk, 128), s, True)).to(
        cuda_device, torch.bfloat16) for s in (51, 52))
    doc = np.ones((b, l), np.int32)
    doc[0, 200:] = 2
    doc[1, 150:] = 2
    if mode == "segments":
        qs = doc.copy()
    else:
        fn = np.full((b, l), -1, np.int32)
        fn[:, 160:230] = 0          # a full split (ViT-like)
        fn[:, 300:380] = 1          # a noised VAE split
        nz = np.full((b, l), -1, np.int32)
        nz[:, 300:380] = 0
        qs = tatt.pack_mask_codes(doc, fn, nz)
    ks = qs.copy()
    qs[:, -30:] = -1
    ks[:, -30:] = -2
    k[:, -30:] = 50.0
    v[:, -30:] = 50.0
    to = dict(dtype=torch.int32, device=cuda_device)
    return q, k, v, torch.tensor(qs, **to), torch.tensor(ks, **to)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["segments", "packed"])
def test_cuda_masked_forward_matches_plain(cuda_device, mode):
    """The segment and packed modes of the forward (without and with the
    lse; 4 query heads over 2 kv heads without it) against their plain
    version on the card: bf16 outputs to 2e-2, lse to 1e-3; the pad rows
    exactly 0 with lse +1e30; the launches counted by mode."""
    q, k, v, qs, ks = _masked_inputs(cuda_device, mode)
    packed = mode == "packed"
    qf = tfa._fold(q, 128 ** -0.5)
    tfa.reset_launches()
    with torch.no_grad():
        got = tfa.flash_attention_padded(q, k, v, q_segments=qs,
                                         kv_segments=ks, packed_mode=packed)
        want = tfa.attention_plain(qf, k, v, q_segments=qs, kv_segments=ks,
                                   packed_mode=packed)
        kr, vr = tfa.repeat_kv(k, 4), tfa.repeat_kv(v, 4)
        o, lse = tfa.flash_attention_fwd_folded(
            qf, kr, vr, q_segments=qs, kv_segments=ks, packed_mode=packed)
        o_p, lse_p = tfa.attention_plain(qf, kr, vr, q_segments=qs,
                                         kv_segments=ks, packed_mode=packed,
                                         save_residuals=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bf16"] == 1
    assert tfa.LAUNCHES_BY_MODE[f"flash_attention_bf16_{mode}"] == 1
    assert tfa.LAUNCHES_BY_MODE[f"flash_attention_bf16_lse_{mode}"] == 1
    for a, w in ((got, want), (o, o_p)):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **BF16)
        assert float(a[:, -30:].abs().max()) == 0.0
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=0, atol=1e-3)
    assert bool((lse[:, :, -30:] == 1e30).all())
    assert bool((lse[:, :, :-30] < 1e29).all())


# backward cases (lq, lk, q_offset, q_offsets, kv_len): causal offsets that
# are not multiples of 64, a dk/dv tile that no q tile reaches, segment ids
# and packed codes with pad rows
MASKED_BWD = {
    "causal_square": (256, 256, 0, None, None),
    "causal_offsets": (192, 448, 13, (37, 190), (250, 448)),
    "segments": (448, 448, 0, None, None),
    "packed": (448, 448, 0, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MASKED_BWD))
def test_cuda_masked_backward_matches_plain(cuda_device, case):
    """The bf16 backward in the causal (static + device offsets, kv_len),
    segment and packed modes (the one-pass sm90 kernel's list walk since
    it took them) against its plain version on the card, from the plain
    residuals (bf16: 2e-2 relative L2 and elementwise), and against the
    dq and dk/dv mma.sync pair it replaced (PERF.md s2's backward bound);
    rows that see no key give dq = 0 exactly, keys that no row sees dk and
    dv = 0 exactly."""
    lq, lk, qoff, qoffs, kvl = MASKED_BWD[case]
    kw = {}
    if case.startswith("causal"):
        q = torch.as_tensor(_rand((2, lq, 4, 128), 53, True)).to(
            cuda_device, torch.bfloat16)
        k, v = (torch.as_tensor(_rand((2, lk, 4, 128), s, True)).to(
            cuda_device, torch.bfloat16) for s in (54, 55))
        kw = dict(causal=True, q_offset=qoff)
        if qoffs is not None:
            kw["q_offsets"] = torch.tensor(qoffs, dtype=torch.int32,
                                           device=cuda_device)
        mode = "causal"
    else:
        q, k, v, qs, ks = _masked_inputs(cuda_device, case, nk=4)
        kw = dict(q_segments=qs, kv_segments=ks, packed_mode=case == "packed")
        mode = case
    kv = None
    if kvl is not None:
        kv = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
        for r in range(2):
            k[r, kvl[r]:] = 50.0
            v[r, kvl[r]:] = 50.0
    do = torch.as_tensor(_rand(tuple(q.shape), 56)).to(cuda_device,
                                                       torch.bfloat16)
    qs_ = tfa._fold(q, 128 ** -0.5)
    tfa.reset_launches()
    with torch.no_grad():
        o_p, lse_p = tfa.attention_plain(qs_, k, v, kv_len=kv,
                                         save_residuals=True, **kw)
        o, lse = tfa.flash_attention_fwd_folded(qs_, k, v, kv_len=kv, **kw)
        grads = tfa.flash_attention_bwd_folded(
            qs_, k, v, o_p, lse_p, do, kv_len=kv, softmax_scale=128 ** -0.5,
            **kw)
        want = tfa._bwd_plain_folded(qs_, k, v, o_p, lse_p, do, kv,
                                     128 ** -0.5, **kw)
        dq, delta = tfa._bwd_dq_cuda(qs_, k, v, o_p, lse_p, do, kv,
                                     128 ** -0.5, **kw)
        pair = (dq,) + tfa._bwd_dkv_cuda(qs_, k, v, do, lse_p, delta, kv,
                                         **kw)
    torch.cuda.synchronize()
    for name in ("flash_attention_bf16_lse", "flash_attention_bwd_bf16_sm90",
                 "flash_attention_bwd_dq_bf16",
                 "flash_attention_bwd_dkv_bf16"):
        assert tfa.LAUNCHES_BY_MODE[f"{name}_{mode}"] == 1, name
    assert tfa.BWD_LAUNCHES_BY_IMPL == {"sm90": 1, "mma_sync": 0}
    # no plan: the forward and the backward each build their list with one
    # tile_lists launch (the causal forward needs none); the old pre-pass
    # is a baseline
    assert tfa.LAUNCHES["tile_lists"] == (1 if mode == "causal" else 2)
    assert tfa.LAUNCHES["bwd_tile_list"] == 0
    for got, p, name in zip(grads, pair, ("dq", "dk", "dv")):
        _check_bwd(got, p, f"{name} vs the mma.sync pair")
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_p.float().cpu().numpy(), **BF16)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=0, atol=1e-3)
    for got, ref, name in zip(grads, want, ("dq", "dk", "dv")):
        assert _rel(got, ref) < 2e-2, name
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), err_msg=name,
                                   **BF16)
    if "q_segments" in kw:
        assert float(grads[0][:, -30:].abs().max()) == 0.0
        for g in grads[1:]:
            assert float(g[:, -30:].abs().max()) == 0.0
    if kv is not None:   # keys past kv_len: exactly zero dk and dv
        for r in range(2):
            assert not bool(grads[1][r, kvl[r]:].any())
            assert not bool(grads[2][r, kvl[r]:].any())


# the backward's tile-list cases: (mode, kv_len or None, q_offset,
# q_offsets or None): pad ids, kv_len inside a tile and 0, causal offsets
# that are not multiples of 64 and a negative one
BWD_TILE_LISTS = {
    "segments": ("segments", None, 0, None),
    "packed": ("packed", None, 0, None),
    "packed_kv_len": ("packed", (300, 0), 0, None),
    "causal": ("causal", None, 0, None),
    "causal_offsets_kv_len": ("causal", (250, 448), 13, (37, -100)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_TILE_LISTS))
def test_cuda_bwd_tile_list_matches_plain(cuda_device, case):
    """The backward's pre-pass (one launch) gives the plain version's list
    and count exactly, in the segment, packed and causal modes."""
    mode, kvl, qoff, qoffs = BWD_TILE_LISTS[case]
    q, _, _, qs, ks = _masked_inputs(cuda_device, "packed" if mode == "causal"
                                     else mode)
    kw = dict(q_segments=qs, kv_segments=ks, packed_mode=mode == "packed")
    if mode == "causal":
        kw = dict(causal=True, q_offset=qoff, q_offsets=None if qoffs is None
                  else torch.tensor(qoffs, dtype=torch.int32,
                                    device=cuda_device))
    kv = (torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
          if kvl is not None else None)
    tfa.reset_launches()
    lists, count = tfa.bwd_tile_list(q, q.shape[1], kv, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["bwd_tile_list"] == 1
    want = tfa.bwd_tile_list_plain(
        q.shape[0], q.shape[1], q.shape[1], kv_len=None if kv is None
        else kv.cpu(), **{k_: (v_.cpu() if torch.is_tensor(v_) else v_)
                          for k_, v_ in kw.items()})
    assert torch.equal(lists.cpu(), want[0])
    assert torch.equal(count.cpu(), want[1])


# fp32 d=128 (the DiT at its default fp32 policy): forward modes (lq, lk,
# bounded, lse), kv_len (200, 0) where lk == lq; [2, 256, 2, 128] and the
# cross shape q [2, 256, 2, 128] over k, v [2, 512, 2, 128]; lq = 192 ends
# in half of the kernel's 128-row q tile
F32_D128_FWD = {"running": (256, 256, False, False),
                "running_lse": (256, 256, False, True),
                "bounded": (256, 256, True, False),
                "bounded_lse": (256, 256, True, True),
                "cross512": (256, 512, False, False),
                "cross512_lse": (256, 512, False, True),
                "lq192_lse": (192, 192, False, True)}


def _f32_d128_inputs(cuda_device, lk, masked, seed=60, lq=256):
    q = torch.as_tensor(_rand((2, lq, 2, 128), seed, True)).to(cuda_device)
    k, v = (torch.as_tensor(_rand((2, lk, 2, 128), s, True)).to(cuda_device)
            for s in (seed + 1, seed + 2))
    kv = None
    if masked:   # keys past kv_len hold large values
        kv = torch.tensor([200, 0], dtype=torch.int32, device=cuda_device)
        k[0, 200:] = 50.0
        v[0, 200:] = 50.0
    return tfa._fold(q, 128 ** -0.5), k, v, kv


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["sm90", "cuda_cores"])
@pytest.mark.parametrize("mode", list(F32_D128_FWD))
def test_cuda_f32_d128_forward_matches_plain(cuda_device, mode, impl):
    """The fp32 d=128 forward (running max or bounded, with and without the
    lse, kv_len, a half q tile) against its plain version on the card: the
    route's kernel ("sm90": flash_attention_f32_sm90.cu after its three
    split pre-passes) and the CUDA-core baseline it replaced
    (flash_attention_f32_d128.cu, reached by no route); 1e-5 + 1e-4 |ref|
    (summation order and the approximate exp2), lse 1e-4 absolute; kv_len
    = 0 rows exactly 0 with lse +1e30."""
    lq, lk, bounded, lse = F32_D128_FWD[mode]
    qs, k, v, kv = _f32_d128_inputs(cuda_device, lk, lk == lq, lq=lq)
    bound = (torch.tensor([1.01 * 128 * LOG2E / math.sqrt(128)],
                          device=cuda_device) if bounded else None)
    tfa.reset_launches()
    with torch.no_grad():
        if impl == "cuda_cores":
            got, got_lse = tfa._launch_f32_d128(qs, k, v, kv, bound, lse)
        elif lse:
            got, got_lse = tfa.flash_attention_fwd_folded(
                qs, k, v, kv_len=kv, score_bound=bound)
        else:
            got = tfa._flash_cuda(qs, k, v, kv, bound, None)
        want = tfa.attention_plain(qs, k, v, kv_len=kv, bound=bound,
                                   save_residuals=lse)
        if lse:
            want, want_lse = want
    torch.cuda.synchronize()
    if impl == "cuda_cores":
        name = "flash_attention_f32_lse" if lse else "flash_attention_f32_d128"
        assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {name: 1}
    else:
        name = ("flash_attention_f32_sm90_lse" if lse
                else "flash_attention_f32_sm90")
        assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
            name: 1, "split_bf16x3": 3}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    if lse:
        np.testing.assert_allclose(got_lse.cpu().numpy(),
                                   want_lse.cpu().numpy(), rtol=0, atol=1e-4)
    if kv is not None:
        assert float(got[1].abs().max()) == 0.0
        if lse:
            assert bool((got_lse[1] == 1e30).all())


@pytest.mark.cuda
def test_cuda_f32_rope_and_fused_forward_match_plain(cuda_device):
    """The fp32 rope pre-pass equals its plain version exactly (the same
    two fp32 products and sum, each rounded once), and the fp32 serving
    forward with fused rope, bounded, kv_len, matches the plain version."""
    d = 128
    q, k, v, _ = _f32_d128_inputs(cuda_device, 512, False, seed=70)
    tabs = tfa._pad_tables(tfa.build_fused_rope_tables(
        *trope3d(d, (8, 8, 8), device=cuda_device), d), 256, 512,
        LOG2E / math.sqrt(d))
    cq, sq, ck, sk = tabs
    kv = torch.tensor([400, 512], dtype=torch.int32, device=cuda_device)
    bound = torch.tensor([1.01 * d * LOG2E / math.sqrt(d)], device=cuda_device)
    tfa.reset_launches()
    with torch.no_grad():
        qr = tfa._rope_f32(q, cq, sq)
        assert torch.equal(qr, tfa.rotate(q, cq, sq, torch.float32))
        got = tfa.flash_attention_padded(q, k, v, kv_len=kv,
                                         rope_tables=tabs, score_bound=bound)
        want = tfa.attention_plain(q, k, v, kv_len=kv, bound=bound,
                                   rope_tables=tabs)
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        "rope_rotate_f32": 3, "split_bf16x3": 3,
        "flash_attention_f32_sm90": 1}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


def _bwd_close(got, ref, name):
    """dq / dk / dv within 1e-4 max|ref| + 1e-4 |ref|, rel. L2 < 1e-4."""
    got, ref = got.double().cpu(), ref.double().cpu()
    lim = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    assert bool(((got - ref).abs() <= lim).all()), name
    assert _rel(got, ref) < 1e-4, name


def _f32_bwd_case(cuda_device, mode):
    lk = 512 if mode == "cross512" else 256
    qs, k, v, kv = _f32_d128_inputs(cuda_device, lk, lk == 256, seed=80)
    bound = (torch.tensor([1.01 * 128 * LOG2E / math.sqrt(128)],
                          device=cuda_device) if mode == "bounded" else None)
    do = torch.as_tensor(_rand((2, 256, 2, 128), 83)).to(cuda_device)
    with torch.no_grad():
        o_p, lse_p = tfa.attention_plain(qs, k, v, kv_len=kv, bound=bound,
                                         save_residuals=True)
    return qs, k, v, o_p, lse_p, do, kv


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["sm90", "cuda_cores"])
@pytest.mark.parametrize("mode", ["running", "bounded", "cross512"])
def test_cuda_f32_d128_backward_matches_plain(cuda_device, mode, impl):
    """The fp32 dq and dk/dv kernels against their plain version on the
    card, from the plain residuals: the route's pair ("sm90":
    flash_attention_f32_sm90.cu after its four split pre-passes) and the
    CUDA-core baseline it replaced (flash_attention_bwd_f32.cu, reached by
    no route); 1e-4 max|ref| + 1e-4 |ref| and rel. L2 < 1e-4 (summation
    order and the approximate exp2); kv_len = 0 gives zero gradients, and
    dk, dv past kv_len are zero."""
    qs, k, v, o_p, lse_p, do, kv = _f32_bwd_case(cuda_device, mode)
    with torch.no_grad():
        tfa.reset_launches()
        if impl == "cuda_cores":
            dq, delta = tfa._bwd_dq_f32(qs, k, v, o_p, lse_p, do, kv,
                                        128 ** -0.5)
            grads = (dq,) + tfa._bwd_dkv_f32(qs, k, v, do, lse_p, delta, kv)
        else:
            grads = tfa.flash_attention_bwd_folded(qs, k, v, o_p, lse_p, do,
                                                   kv_len=kv,
                                                   softmax_scale=128 ** -0.5)
        want = tfa._bwd_plain_folded(qs, k, v, o_p, lse_p, do, kv,
                                     128 ** -0.5)
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == (
        {"flash_attention_bwd_dq_f32": 1, "flash_attention_bwd_dkv_f32": 1}
        if impl == "cuda_cores" else
        {"split_bf16x3": 4, "flash_attention_bwd_dq_f32_sm90": 1,
         "flash_attention_bwd_dkv_f32_sm90": 1})
    for got, ref, name in zip(grads, want, ("dq", "dk", "dv")):
        assert got.dtype == torch.float32
        _bwd_close(got, ref, name)
    if kv is not None:
        for gr in grads:
            assert float(gr[1].abs().max()) == 0.0
        assert float(grads[1][0, 200:].abs().max()) == 0.0
        assert float(grads[2][0, 200:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["running", "cross512"])
def test_cuda_f32_d128_backward_is_deterministic(cuda_device, mode):
    """The fp32 backward sums every output element in a fixed order (no
    atomics): two runs on the same inputs give bitwise-equal dq, dk, dv."""
    qs, k, v, o_p, lse_p, do, kv = _f32_bwd_case(cuda_device, mode)
    with torch.no_grad():
        runs = [tfa.flash_attention_bwd_folded(qs, k, v, o_p, lse_p, do,
                                               kv_len=kv,
                                               softmax_scale=128 ** -0.5)
                for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, name in zip(*runs, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_f32_d128_failures_raise(cuda_device, monkeypatch):
    """No silent fallback: when the fp32 d=128 kernels' library fails to
    build, or a launch returns an error, the fp32 forward and backward
    raise, and no CUDA-core baseline runs in their place."""
    from univid_tpu_torch.kernels import build

    qs, k, v, o_p, lse_p, do, kv = _f32_bwd_case(cuda_device, "running")

    def calls():
        yield lambda: tfa.flash_attention_fwd_folded(qs, k, v, kv_len=kv)
        yield lambda: tfa._flash_cuda(qs, k, v, kv, None, None)
        yield lambda: tfa.flash_attention_bwd_folded(
            qs, k, v, o_p, lse_p, do, kv_len=kv, softmax_scale=128 ** -0.5)

    def no_build(name):
        raise RuntimeError(f"CUDA kernel build failed: {name}")

    def refused(*args):
        return 1   # cudaErrorInvalidValue

    for patch in ({"load": no_build}, {"_fn": lambda *a: refused}):
        with monkeypatch.context() as m:
            m.setattr(tfa, "_FNS", {})
            for attr, fn in patch.items():
                m.setattr(build if attr == "load" else tfa, attr, fn)
            tfa.reset_launches()
            with torch.no_grad():
                for call in calls():
                    with pytest.raises(RuntimeError):
                        call()
            assert not any(tfa.LAUNCHES[n] for n in (
                "flash_attention_f32_d128", "flash_attention_f32_lse",
                "flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32"))


@pytest.mark.cuda
def test_cuda_f32_masked_modes_raise(cuda_device):
    """fp32 d=128 has no causal, segment or packed kernel mode: on the card
    they raise (the plain version serves CPU tensors only)."""
    x = torch.zeros((1, 64, 1, 128), device=cuda_device)
    codes = torch.zeros((1, 64), dtype=torch.int32, device=cuda_device)
    for kw in (dict(causal=True),
               dict(q_segments=codes, kv_segments=codes)):
        with pytest.raises(NotImplementedError, match="fp32"):
            tfa.flash_attention_padded(x, x, x, **kw)
        with pytest.raises(NotImplementedError, match="fp32"):
            tfa.flash_attention_fwd_folded(x, x, x, **kw)


@pytest.mark.cuda
def test_cuda_fp32_dit_train_step_matches_cpu(cuda_device):
    """Two make_dit_train_step steps at the default policy (FP32_POLICY) on
    a 2-layer d=128 DiT, remat 'attn', 240 tokens padded to 256 (kv_len), on
    the card (the fp32 d=128 kernels) against the same steps on the CPU
    (their plain versions), from one initial state: losses 1e-5 relative,
    each parameter 1e-5 relative + 1e-4 absolute, each tensor's change 5e-4
    relative L2 (tests/test_torch_fp32_train.py says why)."""
    import copy

    from univid_tpu_torch.core.config import WanDiTConfig
    from univid_tpu_torch.models.wan.dit import WanDiT
    from univid_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = WanDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                       in_dim=16, out_dim=16, text_dim=32, freq_dim=32,
                       text_len=8, patch_size=(1, 2, 2))
    gen = torch.Generator().manual_seed(0)
    dit = WanDiT(cfg, device="cpu", gen=gen)
    with torch.no_grad():   # the zero head would block every gradient
        dit.head.head.w.normal_(0.0, 0.02, generator=gen)
    grid = (4, 6, 10)   # 240 tokens
    batch = {"latents": _rand((1, 4, 12, 20, 16), 90),
             "noise": _rand((1, 4, 12, 20, 16), 91),
             "t": np.array([500.0], np.float32),
             "context": _rand((1, 8, 32), 92) * 0.5}

    def run(device):
        model = copy.deepcopy(dit).to(device)
        state, tx = trainer.init_train_state(model, trainer.make_optimizer(
            1e-3))
        step = trainer.make_dit_train_step(
            cfg, tx, rope=trope3d(128, grid, device=device),
            remat_blocks="attn", seq_pad_to=256)
        losses = []
        for _ in range(2):
            state, loss = step(state, {k: torch.as_tensor(v).to(device)
                                       for k, v in batch.items()})
            losses.append(float(loss))
        return losses, {n: p.detach().cpu() for n, p in model.named_parameters()}

    tfa.reset_launches()
    loss_gpu, par_gpu = run(cuda_device)
    used = {n: c for n, c in tfa.LAUNCHES.items() if c}
    loss_cpu, par_cpu = run("cpu")
    # per step: 2 self + 2 x 2 cross forwards with lse (3 split pre-passes
    # each), 4 backward pairs (4 split pre-passes each), on the sm90 kernels
    assert used == {"flash_attention_f32_sm90_lse": 12,
                    "flash_attention_bwd_dq_f32_sm90": 8,
                    "flash_attention_bwd_dkv_f32_sm90": 8,
                    "split_bf16x3": 12 * 3 + 8 * 4}
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-5)
    start = dict(dit.named_parameters())
    for name, w in par_cpu.items():
        np.testing.assert_allclose(par_gpu[name].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
        moved = (w - start[name].detach()).norm()
        assert float((par_gpu[name] - w).norm()) <= 5e-4 * float(moved), name


# --- the serving knobs: softmax_bf16 and qk_int8 ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bounded", "running", "cross_bounded",
                                  "cross_one_shot"])
def test_cuda_softmax_bf16_kernel_matches_plain(cuda_device, mode):
    """The bf16 softmax chain of the bf16 forward (self: bounded, running
    max with fused rope; cross: bounded, one-shot max) against its plain
    version, kv_len [lk, lk - 77] with the masked keys at 50.0, bf16
    tolerance (one p rounding apart, 2^-8; the running max rounds p against
    a reference the plain one-shot form reaches at once)."""
    d, lq = 128, 512
    lk = 256 if mode.startswith("cross") else 512
    q, k, v = (torch.as_tensor(_rand((2, x, 2, d), s, True)).to(
        cuda_device, torch.bfloat16) for s, x in ((20, lq), (21, lk),
                                                  (22, lk)))
    k[1, lk - 77:] = 50.0
    v[1, lk - 77:] = 50.0
    kv = torch.tensor([lk, lk - 77], dtype=torch.int32, device=cuda_device)
    bound = (torch.tensor([1.01 * d * LOG2E / math.sqrt(d)],
                          device=cuda_device) if "bounded" in mode else None)
    tfa.reset_launches()
    with torch.no_grad():
        if mode.startswith("cross"):
            qs = q * torch.tensor(LOG2E / math.sqrt(d), dtype=q.dtype,
                                  device=cuda_device)
            got = tfa.cross_attention_padded(qs, k, v, kv_len=kv,
                                             score_bound=bound,
                                             softmax_bf16=True)
            want = tfa.attention_plain(qs, k, v, kv_len=kv, bound=bound,
                                       softmax_bf16=True)
            name = "cross_attention_bf16_sbf16"
        else:
            tabs = tfa._pad_tables(tfa.build_fused_rope_tables(
                *trope3d(d, (8, 8, 8), device=cuda_device), d), lq, lk,
                LOG2E / math.sqrt(d))
            got = tfa._flash_cuda(q, k, v, kv, bound, tabs,
                                  softmax_bf16=True)
            want = tfa.attention_plain(q, k, v, kv_len=kv, bound=bound,
                                       rope_tables=tabs, softmax_bf16=True)
            name = "flash_attention_bf16_sbf16"
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[name] == 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [True, False])
def test_cuda_int8_prepass_matches_plain(cuda_device, rope):
    """The rope + int8 quantize pre-pass against its plain version: the
    same fp32 rotation (no fused multiply-add), reciprocal, product and
    round-half-to-even give equal codes and scales, bit for bit; k scales
    over blocks of 192 keys (not the 64-key tile; the last block short)."""
    d, l = 128, 448
    q, k = (torch.as_tensor(_rand((2, l, 3, d), s, True)).to(
        cuda_device, torch.bfloat16) for s in (23, 24))
    k[:, 400:] = 20.0   # rows past a kv_len of 400 set the last scale
    tabs = (tfa._pad_tables(tfa.build_fused_rope_tables(
        *trope3d(d, (7, 8, 8), device=cuda_device), d), l, l,
        LOG2E / math.sqrt(d)) if rope else None)
    tfa.reset_launches()
    got = tfa.quantize_qk_int8(q, k, tabs, 192)
    want = tfa.quantize_qk_int8_plain(q, k, tabs, 192)
    torch.cuda.synchronize()
    # kernel B: the q + k-max launch, the k-codes launch
    assert tfa.LAUNCHES["quantize_qk_int8"] == 2
    # the pair it replaced: the same codes
    pair = tfa._quantize_qk_int8_pair(q, k, tabs, 192)
    assert tfa.LAUNCHES["quantize_qk_int8"] == 2
    assert tfa.LAUNCHES["quantize_qk_int8_pair"] == 2
    for out in (got, pair):
        for g, w in zip(out, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


QK_STEP = 2.0 ** -6 * 1.0625   # chip_smoke.py: one bf16 step of n, gained
QK_MODES = {"norm_rope": "qk_norm_rope_bf16", "norm": "qk_norm_bf16",
            "rope": "qk_rope_bf16", "norm_grouped": "qk_norm_bf16"}


def _rope_abs(x, cf, sf):
    a = x.float().abs()
    sw = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2).flip(-1) \
        .reshape(a.shape)
    return a * cf.abs()[:, None, :] + sw * sf.abs()[:, None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(QK_MODES))
def test_cuda_qk_norm_rope_matches_plain(cuda_device, mode):
    """Kernel A against its plain version, q and k of other lengths in one
    launch (k a strided view): norm + rope and norm only within one bf16
    step of the normed value carried through the gain (and the rotation),
    the sum of squares being summed in another order; rope only bit for
    bit; norm only with k of half the heads (grouped kv)."""
    d, lq, lk, n = 128, 448, 320, 5
    nk = 2 if mode == "norm_grouped" else n
    q = torch.as_tensor(_rand((2, lq, n, d), 40) * 3).to(cuda_device,
                                                         torch.bfloat16)
    kb = torch.as_tensor(_rand((2, lk, nk, 2 * d), 41) * 3).to(
        cuda_device, torch.bfloat16)
    k = kb[..., :d]   # rows 512 bytes apart
    gq = torch.as_tensor(np.random.default_rng(42).uniform(
        0.5, 1.5, n * d)).to(cuda_device, torch.bfloat16)
    gk = torch.as_tensor(np.random.default_rng(43).uniform(
        0.5, 1.5, nk * d)).to(cuda_device, torch.bfloat16)
    tabs = tfa._pad_tables(tfa.build_fused_rope_tables(
        *trope3d(d, (7, 8, 8), device=cuda_device), d), lq, lk,
        LOG2E / math.sqrt(d))
    norm = None if mode == "rope" else (gq, gk, 1e-6)
    rope = tabs if mode in ("norm_rope", "rope") else None
    tfa.reset_launches()
    with torch.no_grad():
        got = tfa.qk_norm_rope(q, k, qk_norm=norm, rope_tables=rope)
        want = tfa.qk_norm_rope_plain(q, k, norm, rope)
        normed = tfa.qk_norm_rope_plain(q, k, norm) if norm else None
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[QK_MODES[mode]] == 1
    assert sum(tfa.LAUNCHES.values()) == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.is_contiguous()
        if norm is None:
            assert torch.equal(g, w)
            continue
        lim = QK_STEP * w.float().abs()
        if rope is not None:
            lim = QK_STEP * _rope_abs(normed[i], tabs[2 * i],
                                      tabs[2 * i + 1]) + \
                2.0 ** -7 * 1.0625 * w.float().abs()
        assert bool(((g.float() - w.float()).abs() <= lim).all())
        assert float((g != w).float().mean()) < 1e-3


@pytest.mark.cuda
def test_cuda_qk_prepass_refusals(cuda_device):
    """Kernel A raises on fp32 gains (rms_norm multiplies in x's dtype),
    on fp32 inputs and under grad (of q or of a gain); nothing is
    counted."""
    d, l = 128, 64
    x = torch.as_tensor(_rand((1, l, 2, d), 44)).to(cuda_device,
                                                    torch.bfloat16)
    g = torch.ones(2 * d, device=cuda_device)
    tfa.reset_launches()
    with pytest.raises(TypeError, match="bf16"):
        tfa.qk_norm_rope(x, x, qk_norm=(g, g, 1e-6))
    with pytest.raises(TypeError, match="bf16"):
        tfa.qk_norm_rope(x.float(), x.float(),
                         qk_norm=(g.bfloat16(), g.bfloat16(), 1e-6))
    gb = g.bfloat16()
    with pytest.raises(RuntimeError, match="inference-"):
        tfa.qk_norm_rope(x, x, qk_norm=(gb.clone().requires_grad_(), gb,
                                        1e-6))
    with pytest.raises(RuntimeError, match="inference-only"):
        tfa.qk_norm_rope(x.requires_grad_(), x, qk_norm=(gb, gb, 1e-6))
    assert not any(tfa.LAUNCHES.values())


INT8_IMPLS = {"sm90": tfa.flash_attention_int8,
               "mma_sync": tfa._launch_int8_mma_sync}


def _int8_counter(sbf, impl):
    return (("flash_attention_int8_sbf16" if sbf else "flash_attention_int8")
            + ("" if impl == "sm90" else "_mma_sync"))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", list(INT8_IMPLS))
@pytest.mark.parametrize("mode", ["bounded", "running", "bounded_sbf16"])
def test_cuda_int8_attention_matches_plain(cuda_device, mode, impl):
    """The int8 QK^T kernel (the route's sm90 kernel, and the mma.sync
    kernel it replaced, the same-call baseline) against its plain version
    on the same codes (blocks of 128 keys, kv_len [512, 435], masked keys'
    v at 50.0): the scores are equal (exact integer products, the same fp32
    rescale), so only the softmax's exp2, summation order and p rounding
    differ: bf16 tolerance. The launch counter shows the kernel that ran."""
    d, l = 128, 512
    q, k, v = (torch.as_tensor(_rand((2, l, 2, d), s, True)).to(
        cuda_device, torch.bfloat16) for s in (25, 26, 27))
    v[1, 435:] = 50.0
    kv = torch.tensor([l, 435], dtype=torch.int32, device=cuda_device)
    bound = (torch.tensor([1.01 * d * LOG2E / math.sqrt(d)],
                          device=cuda_device) if "bounded" in mode else None)
    sbf = mode.endswith("sbf16")
    qs = q * torch.tensor(LOG2E / math.sqrt(d), dtype=q.dtype,
                          device=cuda_device)
    codes = tfa.quantize_qk_int8(qs, k, None, 128)
    tfa.reset_launches()
    got = INT8_IMPLS[impl](*codes, v, kv_len=kv, score_bound=bound,
                           softmax_bf16=sbf, block_k=128)
    want = tfa.attention_int8_plain(*codes, v, kv_len=kv, bound=bound,
                                    softmax_bf16=sbf, block_k=128)
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        _int8_counter(sbf, impl): 1}
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16)


# (bw, Lq, Lk, kv_len): bw = 192, tile 1 (keys 128-255) straddling two k
# scales with kv_len 200 in it; Lq = 448 (the last 128-row q tile has one
# live consumer) with bw = Lk = 448, the last kv tile half past Lk; Lq =
# 320, three q tiles: the second cluster's block past Lq loads nothing and
# its peer loads alone; a kv_len = 0 batch row
INT8_EDGES = {"bw192_straddle": (192, 512, 512, [512, 200]),
              "lq448": (448, 448, 448, [448, 400]),
              "lq320_odd_tiles": (128, 320, 384, [384, 250]),
              "kv_len0": (128, 256, 512, [0, 320])}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bounded", "running", "bounded_sbf16",
                                  "running_sbf16"])
@pytest.mark.parametrize("case", list(INT8_EDGES))
def test_cuda_int8_sm90_edges(cuda_device, case, mode):
    """The sm90 int8 kernel at its edges against the plain version within
    PERF.md s2's int8 bounds (`_check_fwd`: + 2^-8 max|v| under the running
    max; the bf16 chain's share bound), keys past kv_len at 50.0 in k and
    v; a kv_len = 0 row exactly 0; one launch on the sm90 kernel."""
    bw, lq, lk, kv_list = INT8_EDGES[case]
    d = 128
    q = torch.as_tensor(_rand((2, lq, 3, d), 31, True)).to(cuda_device,
                                                          torch.bfloat16)
    k, v = (torch.as_tensor(_rand((2, lk, 3, d), s, True)).to(
        cuda_device, torch.bfloat16) for s in (32, 33))
    for bi, end in enumerate(kv_list):
        k[bi, end:] = 50.0
        v[bi, end:] = 50.0
    kv = torch.tensor(kv_list, dtype=torch.int32, device=cuda_device)
    bound = (torch.tensor([1.01 * d * LOG2E / math.sqrt(d)],
                          device=cuda_device) if "bounded" in mode else None)
    sbf = mode.endswith("sbf16")
    qs = q * torch.tensor(LOG2E / math.sqrt(d), dtype=q.dtype,
                          device=cuda_device)
    codes = tfa.quantize_qk_int8(qs, k, None, bw)
    tfa.reset_launches()
    got = tfa.flash_attention_int8(*codes, v, kv_len=kv, score_bound=bound,
                                   softmax_bf16=sbf, block_k=bw)
    want = tfa.attention_int8_plain(*codes, v, kv_len=kv, bound=bound,
                                    softmax_bf16=sbf, block_k=bw)
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        _int8_counter(sbf, "sm90"): 1}
    live = [bi for bi, end in enumerate(kv_list) if end > 0]
    for bi, end in enumerate(kv_list):
        if end == 0:
            assert bool((got[bi] == 0).all())
    live_v = torch.cat([v[bi, :kv_list[bi]] for bi in live])
    _check_fwd(got[live], want[live], live_v, running=bound is None,
               sbf16=sbf)


@pytest.mark.cuda
def test_cuda_int8_sm90_failures_raise(cuda_device, monkeypatch, tmp_path):
    """No fallback: a launch the kernel refuses (a k-scale block that is
    not a multiple of 64, past the wrapper's checks), hand-made codes of
    head dim 64 and a source that does not build all raise, and nothing is
    counted."""
    d, l = 128, 256
    x = torch.as_tensor(_rand((1, l, 2, d), 34, True)).to(cuda_device,
                                                         torch.bfloat16)
    codes = tfa.quantize_qk_int8(x, x, None, 128)
    tfa.reset_launches()
    with pytest.raises(RuntimeError, match="univid_flash_fwd_int8_sm90"):
        tfa._launch_int8_sm90(*codes, x, None, None, False, 96)
    qi, sq, ki, akq = codes
    with pytest.raises(ValueError, match="head dim 128"):
        tfa.flash_attention_int8(qi[..., :64].contiguous(), sq,
                                 ki[..., :64].contiguous(), akq,
                                 x[..., :64].contiguous(), block_k=128)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    monkeypatch.setattr(tfa, "_FNS", {})
    with pytest.raises(RuntimeError, match="build failed"):
        tfa.flash_attention_int8(*codes, x, block_k=128)
    assert not any(tfa.LAUNCHES.values())


@pytest.mark.cuda
def test_cuda_knobs_without_a_kernel_raise(cuda_device):
    """No fallback on the card: fp32 inputs with a knob, a knob with a
    causal mask, and grouped kv heads under qk_int8 raise."""
    x = torch.zeros((1, 64, 2, 128), device=cuda_device)
    for kw in (dict(softmax_bf16=True), dict(qk_int8=True)):
        with pytest.raises(NotImplementedError, match="queue 2"):
            tfa.flash_attention_padded(x, x, x, **kw)
    xb = x.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no caller"):
        tfa.flash_attention_padded(xb, xb, xb, causal=True,
                                   softmax_bf16=True)
    with pytest.raises(ValueError, match="kv heads"):
        tfa.flash_attention_padded(xb, xb[:, :, :1], xb[:, :, :1],
                                   qk_int8=True)


# --- the Hopper bf16 forward (flash_attention_sm90.cu) ----------------------


def _check_fwd(got, want, v, running=False, sbf16=False):
    """PERF.md s2's bounds for the bf16 forward against its plain version:
    1e-3 + 2^-7 |ref| (one bf16 ulp of the output, the summation order and
    the approximate exp2), + 2^-8 max|v| where p rounds against a running
    or one-shot row max (one p in [0.5, 1] on the other bf16 neighbour);
    the softmax_bf16 chain: rel. L2 < 1e-2, at most 1e-3 of the outputs
    beyond that bound and none beyond 0.2 max|v| (a bf16 score rounding
    that flips with the summation order moves its p by up to 9%)."""
    g, w = got.float().cpu(), want.float().cpu()
    assert bool(torch.isfinite(g).all())
    err = (g - w).abs()
    v_max = float(v.float().abs().max())
    lim = 1e-3 + 2.0 ** -7 * w.abs() + (2.0 ** -8 * v_max if running else 0)
    if not sbf16:
        assert bool((err <= lim).all()), float(err.max())
        return
    assert _rel(g, w) < 1e-2
    assert float((err > lim).float().mean()) <= 1e-3
    assert float(err.max()) <= 0.2 * v_max


def _bf16(shape, seed, dev, normed=True):
    return torch.as_tensor(_rand(shape, seed, normed)).to(dev, torch.bfloat16)


def _bound(d, dev):
    return torch.tensor([1.01 * d * LOG2E / math.sqrt(d)], device=dev)


# cases: (lq, lk, heads, kv heads, kv_len); lq 320 and 2112 end in a half
# q tile of the kernel's 128 rows, lk 448 in a half kv tile
SM90 = {
    "bounded_rope_kvlen": (320, 320, 2, 2, (320, 243)),
    "append_group7": (2112, 2560, 14, 2, (2200,)),
    "cross_bounded": (320, 512, 2, 2, None),
    "cross_one_shot_kvlen": (320, 512, 2, 2, (512, 100)),
    "sbf16_bounded": (320, 320, 2, 2, (320, 243)),
    "sbf16_running": (320, 448, 2, 2, (448, 301)),
    "sbf16_cross_one_shot": (320, 512, 2, 2, (512, 100)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SM90))
def test_cuda_sm90_forward_matches_plain(cuda_device, case):
    """Each mode of the Hopper bf16 forward against its plain version on
    the card: bounded with fused rope and a kv_len tail; BAGEL's ViT
    append (2,112 rows, 14 query heads over 2 kv heads, running max); the
    cross route at 512 keys, bounded and one-shot with kv_len; the
    softmax_bf16 chain in the bounded, running and one-shot modes. Keys
    past kv_len hold 50.0; every launch is the sm90 kernel's."""
    lq, lk, n, nk, kvl = SM90[case]
    d = 128
    q = _bf16((len(kvl or (0, 0)), lq, n, d), 60, cuda_device)
    b = q.shape[0]
    k, v = (_bf16((b, lk, nk, d), s, cuda_device) for s in (61, 62))
    kv = None
    if kvl is not None:
        kv = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
        for r, x in enumerate(kvl):
            k[r, x:] = 50.0
            v[r, x:] = 50.0
    sbf = case.startswith("sbf16")
    bound = _bound(d, cuda_device) if "bounded" in case else None
    qs = tfa._fold(q, d ** -0.5)
    tfa.reset_launches()
    with torch.no_grad():
        if "cross" in case:
            got = tfa.cross_attention_padded(qs, k, v, kv_len=kv,
                                             score_bound=bound,
                                             softmax_bf16=sbf)
            want = tfa.attention_plain(qs, k, v, kv_len=kv, bound=bound,
                                       softmax_bf16=sbf)
        elif "rope" in case or sbf:
            grid = (lq // 64, 8, 8)
            tabs = tfa._pad_tables(tfa.build_fused_rope_tables(
                *trope3d(d, grid, device=cuda_device), d), lq, lk,
                LOG2E / math.sqrt(d))
            got = tfa._flash_cuda(q, k, v, kv, bound, tabs,
                                  softmax_bf16=sbf)
            want = tfa.attention_plain(q, k, v, kv_len=kv, bound=bound,
                                       rope_tables=tabs, softmax_bf16=sbf)
        else:
            got = tfa.flash_attention_padded(q, k, v, kv_len=kv)
            want = tfa.attention_plain(qs, k, v, kv_len=kv)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES_BY_IMPL == {"sm90": 1, "causal_sm90": 0,
                                    "mma_sync": 0}
    _check_fwd(got, want, v, running=bound is None, sbf16=sbf)


@pytest.mark.cuda
@pytest.mark.parametrize("bounded", [True, False])
def test_cuda_sm90_lse_and_empty_rows(cuda_device, bounded):
    """The training forward with lse on the sm90 kernel (bounded and
    running max, 320 rows over 448 keys): outputs as above, lse to 1e-3;
    the batch row with kv_len = 0 is exactly 0 with lse +1e30."""
    d = 128
    q = _bf16((2, 320, 2, d), 63, cuda_device)
    k, v = (_bf16((2, 448, 2, d), s, cuda_device) for s in (64, 65))
    k[1, 301:] = 50.0
    v[1, 301:] = 50.0
    kv = torch.tensor([0, 301], dtype=torch.int32, device=cuda_device)
    bound = _bound(d, cuda_device) if bounded else None
    qs = tfa._fold(q, d ** -0.5)
    tfa.reset_launches()
    with torch.no_grad():
        o, lse = tfa.flash_attention_fwd_folded(qs, k, v, kv_len=kv,
                                                score_bound=bound)
        o_p, lse_p = tfa.attention_plain(qs, k, v, kv_len=kv, bound=bound,
                                         save_residuals=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bf16_lse"] == 1
    assert tfa.LAUNCHES_BY_IMPL == {"sm90": 1, "causal_sm90": 0,
                                    "mma_sync": 0}
    _check_fwd(o, o_p, v, running=not bounded)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=0, atol=1e-3)
    assert float(o[0].abs().max()) == 0.0
    assert bool((lse[0] == 1e30).all())


@pytest.mark.cuda
def test_cuda_sm90_strided_views(cuda_device):
    """Strided inputs read in place through the tensor maps: q, k and v
    sliced from one fused [B, L, 3 N D] projection, and k, v as the first
    448 rows of a 1,024-row KV cache whose later rows hold 50.0; a view
    that breaks TMA's rules (a base 8 bytes off) raises."""
    d, n, l = 128, 2, 448
    qkv = _bf16((1, l, 3 * n * d), 66, cuda_device)
    q, k, v = (qkv[..., i * n * d:(i + 1) * n * d].view(1, l, n, d)
               for i in range(3))
    cache = _bf16((2, 1024, 1, d), 67, cuda_device)
    cache[:, l:] = 50.0
    ck, cv = cache[:1, :l], cache[1:, :l]
    kv = torch.tensor([400], dtype=torch.int32, device=cuda_device)
    bound = _bound(d, cuda_device)
    tfa.reset_launches()
    with torch.no_grad():
        for kk, vv in ((k, v), (ck, cv)):
            got = tfa.flash_attention_padded(q, kk, vv, kv_len=kv,
                                             score_bound=bound)
            want = tfa.attention_plain(tfa._fold(q, d ** -0.5),
                                       kk.contiguous(), vv.contiguous(),
                                       kv_len=kv, bound=bound)
            _check_fwd(got, want, vv)
        bad = qkv.view(-1)[4:4 + l * n * d].view(1, l, n, d)
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention_padded(q, bad, v, kv_len=kv)
    assert tfa.LAUNCHES_BY_IMPL == {"sm90": 2, "causal_sm90": 0,
                                    "mma_sync": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bounded", "running", "oneshot"])
def test_cuda_sm90_matches_mma_sync_kernel(cuda_device, mode):
    """The new kernel against the mma.sync kernel it replaces in these
    modes (still compiled, reached through its C entry point), same inputs
    in one process: the same arithmetic in another summation order, so
    the kernel-vs-plain bound holds between them."""
    d = 128
    q = tfa._fold(_bf16((2, 512, 4, d), 68, cuda_device), d ** -0.5)
    lk = 512
    k, v = (_bf16((2, lk, 2, d), s, cuda_device) for s in (69, 70))
    kv = torch.tensor([lk, 390], dtype=torch.int32, device=cuda_device)
    bound = _bound(d, cuda_device) if mode == "bounded" else None
    with torch.no_grad():
        new = tfa._launch_sm90(q, k, v, kv, bound, mode)
        old = tfa._launch_bf16(q, k, v, kv, bound, tfa._MODES[mode])
    torch.cuda.synchronize()
    _check_fwd(new, old, v, running=mode != "bounded")


@pytest.mark.cuda
def test_cuda_masked_forward_stays_on_mma_sync(cuda_device):
    """The split of the masked modes (LAUNCHES_BY_IMPL): the segment and
    packed forwards run on the sm90 kernel, one tile-list pre-pass each;
    the causal mode on the causal sm90 kernel; none stays on the mma.sync
    kernel."""
    tfa.reset_launches()
    with torch.no_grad():
        for mode in ("segments", "packed"):
            q, k, v, qs, ks = _masked_inputs(cuda_device, mode)
            tfa.flash_attention_padded(q, k, v, q_segments=qs, kv_segments=ks,
                                       packed_mode=mode == "packed")
        tfa.flash_attention_padded(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES_BY_IMPL == {"sm90": 2, "causal_sm90": 1,
                                    "mma_sync": 0}
    assert tfa.LAUNCHES["tile_lists"] == 2
    assert tfa.LAUNCHES["mask_tile_list"] == 0


# tile-list cases: (mode, kv_len of the two rows or None)
TILE_LISTS = {"segments": ("segments", None), "packed": ("packed", None),
              "segments_kv_len": ("segments", (448, 190)),
              "packed_kv_len": ("packed", (300, 0)),
              "segments_lq_704_lk_448": ("segments", None)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILE_LISTS))
def test_cuda_mask_tile_list_matches_plain(cuda_device, case):
    """The pre-pass's list and count equal the plain version's exactly
    (ragged q tiles, pad ids, kv_len inside a tile and 0, Lq != Lk)."""
    mode, kvl = TILE_LISTS[case]
    _, _, _, qs, ks = _masked_inputs(cuda_device, mode)
    if case == "segments_lq_704_lk_448":
        qs = torch.cat([qs, qs[:, :256] + 1], dim=1).contiguous()
    kv = (torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
          if kvl is not None else None)
    lists, count = tfa.mask_tile_list(qs, ks, kv, mode == "packed")
    torch.cuda.synchronize()
    want = tfa.mask_tile_list_plain(qs.cpu(), ks.cpu(),
                                    kv.cpu() if kv is not None else None,
                                    mode == "packed")
    assert torch.equal(lists.cpu(), want[0])
    assert torch.equal(count.cpu(), want[1])


# the new kernel's cases: (mode, kv_len or None, q_offset, q_offsets or
# None, Lq): pad ids, kv_len inside a tile and 0, a ragged last forward q
# tile (Lq 704 over Lk 448), causal offsets that are not multiples of 64
# and a negative one
RUN_TILE_LISTS = {
    "packed": ("packed", None, 0, None, 448),
    "packed_kv_len": ("packed", (300, 0), 0, None, 448),
    "segments": ("segments", None, 0, None, 448),
    "segments_kv_len": ("segments", (448, 190), 0, None, 448),
    "segments_lq_704_lk_448": ("segments", None, 0, None, 704),
    "causal": ("causal", None, 0, None, 448),
    "causal_offsets_kv_len": ("causal", (250, 448), 13, (37, -100), 448),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RUN_TILE_LISTS))
def test_cuda_tile_lists_match_plain(cuda_device, case):
    """csrc/mask_tiles_sm90.cu: one launch gives the forward's and the
    backward's lists and counts of the plain versions exactly (the
    backward's alone in the causal mode)."""
    mode, kvl, qoff, qoffs, lq = RUN_TILE_LISTS[case]
    _, _, _, qs, ks = _masked_inputs(cuda_device, "packed" if mode == "causal"
                                     else mode)
    if lq == 704:
        qs = torch.cat([qs, qs[:, :256] + 1], dim=1).contiguous()
    kw = dict(q_segments=qs, kv_segments=ks, packed_mode=mode == "packed")
    if mode == "causal":
        kw = dict(causal=True, q_offset=qoff, q_offsets=None if qoffs is None
                  else torch.tensor(qoffs, dtype=torch.int32,
                                    device=cuda_device))
    kv = (torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
          if kvl is not None else None)
    b, lk = 2, ks.shape[1]
    tfa.reset_launches()
    fwd, bwd = tfa.tile_lists(b, lq, lk, cuda_device, kv_len=kv, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["tile_lists"] == 1
    cpu = {k_: (v_.cpu() if torch.is_tensor(v_) else v_)
           for k_, v_ in kw.items()}
    kv_cpu = kv.cpu() if kv is not None else None
    want_bwd = tfa.bwd_tile_list_plain(b, lq, lk, kv_len=kv_cpu, **cpu)
    assert torch.equal(bwd[0].cpu(), want_bwd[0])
    assert torch.equal(bwd[1].cpu(), want_bwd[1])
    if mode == "causal":
        assert fwd is None
    else:
        want_fwd = tfa.mask_tile_list_plain(cpu["q_segments"],
                                            cpu["kv_segments"], kv_cpu,
                                            mode == "packed")
        assert torch.equal(fwd[0].cpu(), want_fwd[0])
        assert torch.equal(fwd[1].cpu(), want_fwd[1])


@pytest.mark.cuda
def test_cuda_tile_plan_launches_once(cuda_device):
    """A tile plan (`build_tile_plan`: one tile_lists launch) serves two
    packed attention calls under grad, forward and backward, with no other
    tile-list launch; their outputs equal those of calls that take the
    codes (and build their own plan: one launch each), and their
    gradients agree within the backward's atomics (bf16 2e-2)."""
    q, k, v, qs, ks = _masked_inputs(cuda_device, "packed", nk=4)
    l = q.shape[1] - 10   # unpadded: the plan pads 438 -> 448
    q, k, v = (x[:, :l].detach().clone().requires_grad_(True)
               for x in (q, k, v))
    qs, ks = qs[:, :l].contiguous(), ks[:, :l].contiguous()
    tfa.reset_launches()
    plan = tfa.build_tile_plan(qs, ks, packed_mode=True)
    outs = [tatt.attention(q, k, v, packed_mode=True, tile_plan=plan)
            for _ in range(2)]
    sum(o.float().sum() for o in outs).backward()
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["tile_lists"] == 1
    assert tfa.LAUNCHES["mask_tile_list"] == tfa.LAUNCHES["bwd_tile_list"] == 0
    assert tfa.LAUNCHES_BY_MODE["flash_attention_bwd_bf16_sm90_packed"] == 2
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    tfa.reset_launches()
    want = [tatt.attention(q, k, v, q_segments=qs, kv_segments=ks,
                           packed_mode=True) for _ in range(2)]
    sum(o.float().sum() for o in want).backward()
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["tile_lists"] == 2
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    for g, x, name in zip(got, (q, k, v), "qkv"):
        assert _rel(g, x.grad) < 2e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["segments", "packed"])
def test_cuda_sm90_masked_matches_mma_sync_kernel(cuda_device, mode):
    """The sm90 segment / packed forward (with the lse, kv_len inside a
    tile) against the mma.sync kernel it replaces (still compiled), same
    inputs: outputs within the running-max bound, lse 1e-3, pad rows 0
    with lse +1e30 in both."""
    q, k, v, qs, ks = _masked_inputs(cuda_device, mode)
    qf = tfa._fold(q, 128 ** -0.5)
    kv = torch.tensor([448, 300], dtype=torch.int32, device=cuda_device)
    b, l, n, _ = q.shape
    lse_new, lse_old = (torch.empty((b, n, l), device=cuda_device)
                        for _ in range(2))
    with torch.no_grad():
        new = tfa._launch_sm90(qf, k, v, kv, None, "running", lse=lse_new,
                               q_segments=qs, kv_segments=ks, seg=mode)
        old = tfa._launch_bf16(qf, k, v, kv, None, tfa._MODE_RUNNING,
                               lse=lse_old, q_segments=qs, kv_segments=ks,
                               seg=mode)
    torch.cuda.synchronize()
    _check_fwd(new, old, v, running=True)
    np.testing.assert_allclose(lse_new.cpu().numpy(), lse_old.cpu().numpy(),
                               rtol=0, atol=1e-3)
    assert float(new[:, -30:].abs().max()) == 0.0
    assert bool((lse_new[:, :, -30:] == 1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 640, 1024])
def test_cuda_f32_tc_matches_simt_kernel(cuda_device, d):
    """The 3xTF32 VAE kernel against the CUDA-core kernel it replaces
    (still compiled) and the plain version: batch row 0 with 70 keys past
    kv_len holding 50.0, row 1 with kv_len = 0 (exactly 0); Lq = 384 (a
    ragged 128-row score tile) over Lk = 448."""
    q, k, v = (torch.as_tensor(_rand((2, lx, 1, d), s)).to(cuda_device)
               for s, lx in ((11, 384), (12, 448), (13, 448)))
    q = q * (LOG2E / math.sqrt(d))
    k[0, 378:] = 50.0
    v[0, 378:] = 50.0
    kv = torch.tensor([378, 0], dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        new = tfa._launch_f32_tc(q, k, v, kv)
        old = tfa._launch_f32_simt(q, k, v, kv)
        want = tfa.attention_plain(q, k, v, kv_len=kv)
    torch.cuda.synchronize()
    assert float(new[1].abs().max()) == 0.0
    for got in (new, old):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)


# --- the one-pass Hopper bf16 backward (flash_attention_bwd_sm90.cu) -------


def _check_bwd(got, ref, name):
    """PERF.md s2's backward bound: 2^-8 max|ref| + 2^-7 |ref| elementwise
    and relative L2 < 1e-2 (p and dS round to bf16 at the same points on
    both sides; an fp32 difference of ~1e-6 flips some roundings by one
    bf16 step)."""
    g, w = got.float().cpu(), ref.float().cpu()
    assert bool(torch.isfinite(g).all()), name
    lim = 2.0 ** -8 * float(w.abs().max()) + 2.0 ** -7 * w.abs()
    assert bool(((g - w).abs() <= lim).all()), (name, float((g - w).abs()
                                                              .max()))
    assert _rel(g, w) < 1e-2, name


# cases: (lq, lk, kv_len or None, bounded, q_splits or None for the
# wrapper's choice, 8 at these shapes): the split path (dk, dv through the
# fp32 accumulators) and the direct one (q_splits 1); lq 448 ends in half a
# 128-row pair of q tiles, lk 320 in a 64-row kv tile
BWD_SM90 = {
    "bounded_kvlen": (512, 512, (435, 0), True, None),
    "bounded_kvlen_direct": (512, 512, (435, 0), True, 1),
    "running": (512, 512, None, False, None),
    "cross512": (512, 512, None, True, None),
    "ragged_lk320": (448, 320, (320, 190), True, 1),
    "ragged_lk320_split3": (448, 320, (320, 190), False, 3),
}


def _bwd_sm90_inputs(cuda_device, case):
    lq, lk, kvl, bounded, splits = BWD_SM90[case]
    b, n, d = 2, 2, 128
    q = _bf16((b, lq, n, d), 80, cuda_device)
    k, v = (_bf16((b, lk, n, d), s, cuda_device) for s in (81, 82))
    do = _bf16((b, lq, n, d), 83, cuda_device, normed=False)
    kv = None
    if kvl is not None:   # keys past kv_len hold large values
        kv = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
        for r, x in enumerate(kvl):
            k[r, x:] = 50.0
            v[r, x:] = 50.0
    qs = tfa._fold(q, d ** -0.5)
    bound = _bound(d, cuda_device) if bounded else None
    with torch.no_grad():
        o, lse = tfa.attention_plain(qs, k, v, kv_len=kv, bound=bound,
                                     save_residuals=True)
    return qs, k, v, o, lse, do, kv, splits


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_SM90))
def test_cuda_bwd_sm90_matches_plain_and_pair(cuda_device, case):
    """The one-pass sm90 backward against its plain version and against
    the mma.sync pair it replaces in these modes (still compiled, same
    inputs, one process), from the plain residuals: PERF.md s2's backward
    bound for both; keys past kv_len get exactly zero dk and dv, and a
    kv_len = 0 row exactly zero dq, dk and dv."""
    qs, k, v, o, lse, do, kv, splits = _bwd_sm90_inputs(cuda_device, case)
    sc = 128 ** -0.5
    tfa.reset_launches()
    with torch.no_grad():
        got = tfa._launch_bwd_sm90(qs, k, v, o, lse, do, kv, sc,
                                   q_splits=splits)
        want = tfa._bwd_plain_folded(qs, k, v, o, lse, do, kv, sc)
        dq, delta = tfa._bwd_dq_cuda(qs, k, v, o, lse, do, kv, sc)
        pair = (dq,) + tfa._bwd_dkv_cuda(qs, k, v, do, lse, delta, kv)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd_bf16_sm90"] == 1
    for g, w, p, name in zip(got, want, pair, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _check_bwd(g, w, name)
        _check_bwd(g, p, f"{name} vs the mma.sync pair")
    if kv is not None:
        for r, x in enumerate(kv.tolist()):
            assert not bool(got[1][r, x:].any()) and not bool(
                got[2][r, x:].any())
            if x == 0:
                assert not bool(got[0][r].any())


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1])
def test_cuda_bwd_sm90_repeat_within_tolerance(cuda_device, splits):
    """The kernel sums dq (and, split, dk and dv) by atomic reductions in
    an order that changes from run to run: two calls on the same inputs
    agree within the backward bound, not bitwise."""
    qs, k, v, o, lse, do, kv, _ = _bwd_sm90_inputs(cuda_device,
                                                   "bounded_kvlen")
    with torch.no_grad():
        a = tfa._launch_bwd_sm90(qs, k, v, o, lse, do, kv, 128 ** -0.5,
                                 q_splits=splits)
        b = tfa._launch_bwd_sm90(qs, k, v, o, lse, do, kv, 128 ** -0.5,
                                 q_splits=splits)
    torch.cuda.synchronize()
    for x, y, name in zip(a, b, ("dq", "dk", "dv")):
        _check_bwd(x, y, name)


@pytest.mark.cuda
def test_cuda_bwd_route_counts(cuda_device):
    """flash_attention_bwd_folded follows bf16_backward_route: the
    unmasked and the segment call both on the sm90 kernel, none on the
    mma.sync pair (BWD_LAUNCHES_BY_IMPL); a strided do that TMA cannot
    read raises in the sm90 wrapper (the autograd Function copies such a
    do)."""
    qs, k, v, o, lse, do, kv, _ = _bwd_sm90_inputs(cuda_device, "running")
    seg = torch.zeros((2, 512), dtype=torch.int32, device=cuda_device)
    tfa.reset_launches()
    with torch.no_grad():
        tfa.flash_attention_bwd_folded(qs, k, v, o, lse, do, kv_len=kv,
                                       softmax_scale=128 ** -0.5)
        tfa.flash_attention_bwd_folded(qs, k, v, o, lse, do, kv_len=kv,
                                       softmax_scale=128 ** -0.5,
                                       q_segments=seg, kv_segments=seg)
        wide = torch.zeros((2, 512, 2, 132), dtype=torch.bfloat16,
                           device=cuda_device)
        wide[..., :128] = do
        with pytest.raises(ValueError, match="16 bytes"):
            tfa._launch_bwd_sm90(qs, k, v, o, lse, wide[..., :128], kv,
                                 128 ** -0.5)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES_BY_IMPL == {"sm90": 2, "mma_sync": 0}
    assert tfa.LAUNCHES["flash_attention_bwd_bf16_sm90"] == 2
    assert tfa.LAUNCHES_BY_MODE[
        "flash_attention_bwd_bf16_sm90_segments"] == 1
    assert tfa.LAUNCHES["flash_attention_bwd_dq_bf16"] == 0


@pytest.mark.cuda
def test_cuda_small_bagel_packed_train_matches_cpu(cuda_device):
    """BAGEL packed training, forward and backward, on a small d=128 BAGEL
    (chip_smoke.py's `_small_train_models`: hidden 512, 2 layers; 250
    tokens of the four sample kinds, freeze_und) on the card against the
    CPU (plain versions), same bf16 weights and noise: loss rel. error
    < 2e-2 and every gradient leaf's rel. L2 < 3e-2 (PERF.md s2: cuBLAS
    and the CPU round each GEMM at other points); the 2 packed backward
    calls on the sm90 kernel, none on the mma.sync pair."""
    import copy

    import chip_smoke as cs
    from univid_tpu_torch.models.bagel.packed import bagel_packed_forward

    cfg, scfg, bagel, sig = cs._small_train_models()
    batch, _ = cs.bagel_train_batch(cfg, cs.SMALL_TRAIN_SIZES, 6, 250)
    noise = torch.randn(batch["packed_latent_clean"].shape,
                        generator=torch.Generator().manual_seed(8))

    def run(device):
        model = copy.deepcopy(bagel).to(device)
        for p in model.parameters():
            p.requires_grad_(True)
        out = bagel_packed_forward(model, cfg, batch, noise=noise,
                                   siglip_params=copy.deepcopy(sig).to(device),
                                   siglip_cfg=scfg,
                                   compute_dtype=torch.bfloat16,
                                   freeze_und=True)
        loss = cs._train_loss(out)
        loss.backward()
        return float(loss.detach()), {nm: p.grad.detach().float().cpu()
                             for nm, p in model.named_parameters()
                             if p.grad is not None}

    tfa.reset_launches()
    loss_g, grads_g = run(cuda_device)
    assert tfa.BWD_LAUNCHES_BY_IMPL == {"sm90": 2, "mma_sync": 0}
    assert tfa.LAUNCHES_BY_MODE["flash_attention_bwd_bf16_sm90_packed"] == 2
    # the pass's tile plan: one tile_lists launch for both layers, both
    # directions; the old pre-passes are baselines
    assert tfa.LAUNCHES["tile_lists"] == 1
    assert tfa.LAUNCHES["mask_tile_list"] == tfa.LAUNCHES["bwd_tile_list"] == 0
    loss_c, grads_c = run("cpu")
    assert math.isfinite(loss_g)
    assert abs(loss_g - loss_c) / abs(loss_c) < 2e-2
    assert set(grads_g) == set(grads_c)
    for nm, g in grads_c.items():
        assert _rel(grads_g[nm], g) < 3e-2, nm


@pytest.mark.cuda
def test_cuda_checkpoint_loads_straight_onto_the_card(cuda_device,
                                                      tmp_path):
    """A small Wan checkpoint dir (the DiT as two safetensors shards with
    an index, written by chip_smoke.py's own writer, and Wan2.1_VAE.pth)
    loads onto the card: every leaf on the card, of the CPU load's dtype
    (bf16, with fp32 time MLPs, head and modulations; the VAE fp32), and
    bit for bit the CPU load."""
    import json

    import chip_smoke as cs
    from univid_tpu_torch.core import manifest as tm
    from univid_tpu_torch.core.checkpoint import load_wan_checkpoint
    from univid_tpu_torch.core.config import WAN_CONFIGS

    spec = WAN_CONFIGS["tiny"]
    gen = torch.Generator().manual_seed(0)
    man = tm.wan_dit_manifest(spec.dit)
    keys = sorted(man)
    weight_map = {}
    for i, part in enumerate((keys[::2], keys[1::2])):
        name = f"diffusion_pytorch_model-{i + 1:05d}-of-00002.safetensors"
        cs.write_safetensors(str(tmp_path / name), {
            k: (torch.float32, man[k],
                lambda k=k: torch.randn(man[k], generator=gen))
            for k in part})
        weight_map.update(dict.fromkeys(part, name))
    (tmp_path / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    torch.save({k: torch.randn(s, generator=gen) for k, s in
                tm.wan_vae_manifest(spec.vae).items()},
               str(tmp_path / "Wan2.1_VAE.pth"))
    on_card = load_wan_checkpoint(str(tmp_path), spec, device=cuda_device)
    on_cpu = load_wan_checkpoint(str(tmp_path), spec, device="cpu")
    for card, cpu in zip(on_card, on_cpu):
        want = cpu.state_dict()
        got = card.state_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].is_cuda and got[k].dtype == w.dtype, k
            assert torch.equal(got[k].cpu(), w), k
    dit = on_card[0]
    assert dit.time_embedding.fc0.w.dtype == torch.float32
    assert dit.blocks[0].self_attn.q.w.dtype == torch.bfloat16
