"""The full DiT fine-tune at its default fp32 policy: the port against
univid_tpu, and the fp32 attention route under grad.

make_dit_train_step trains every DiT parameter at FP32_POLICY in both
packages (the default of both). Here it runs on a 2-layer d=128 DiT (dim
256, 2 heads; the kernel route), 256 video tokens, AdamW lr 1e-3, two
steps, with the JAX package on its Pallas kernels in interpret mode (so its
kernels, not the XLA reference, are the reference) and the port on its
kernels' plain versions (CPU tensors). On the card the same port code runs
the fp32 d=128 CUDA kernels (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances (fp32 throughout, JAX matmuls pinned to the highest precision
by conftest): losses 1e-5 relative; each parameter 1e-5 relative + 1e-4
absolute; each tensor's change (theta_2 - theta_0) to 5e-4 relative L2.
Adam moves an element by about lr * g / |g|, so an element whose gradient
is at the level of fp32 summation noise moves by a rounding-dependent part
of lr. test_dit_train_step_matches_jax holds the tiny config (head dim 16)
to 1e-5 absolute and 1e-4 relative L2; this model has 1.5 M parameters, and
in each case 1-3 elements land 1.3e-5 to 6.0e-5 apart (up to 6% of lr; the
worst in text_embedding.fc1.w), which moves that tensor's change by up to
1.6e-4 relative L2 (measured on the CPU): the absolute term is 10% of lr.
"""
PARAM = dict(rtol=1e-5, atol=1e-4)
MOVED_REL_L2 = 5e-4

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from test_torch_models import D128, np_params
from univid_tpu.core.config import WanDiTConfig as JDiTConfig
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.kernels.attention import set_attention_backend as jbackend
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu.train import trainer as jtrainer
from univid_tpu_torch import convert
from univid_tpu_torch.core.config import WanDiTConfig
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.kernels import attention as tatt
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d
from univid_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
GRID = (4, 8, 8)   # latent frames x (h, w) / patch (1, 2, 2): 256 tokens

# (remat_blocks, bounded_softmax, seq_pad_to): the 'attn' case also pads
# the tokens as the main path does (32,760 -> 32,768 there), so kv_len
# masks the padded keys
CASES = {"no_remat": (False, False, None),
         "remat_attn_kv_len": ("attn", False, 320),
         "remat_bounded": (True, True, None)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _sd(tree):
    """A JAX DiT tree as the port's state dict (numpy, PyTorch layouts)."""
    return {k: v.float().numpy() for k, v in
            convert.jax_tree_to_state_dict(tree, "blocks").items()}


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_dit_train_step_matches_jax(case, monkeypatch):
    """Two make_dit_train_step steps at FP32_POLICY, port vs JAX (Pallas
    interpret): losses, every parameter, every tensor's change."""
    remat, bounded, pad = CASES[case]
    jc, tc = JDiTConfig(**D128), WanDiTConfig(**D128)
    assert tc.head_dim == 128
    params = np_params(init_wan_dit, jc, 1, stacked=True)
    # the zero-init head would block every gradient
    params["head"]["head"]["w"] = jnp.asarray(
        _rand(params["head"]["head"]["w"].shape, 9, 0.02))
    x = _rand((1, GRID[0], 2 * GRID[1], 2 * GRID[2], jc.in_dim), 0)
    batch = {"latents": x, "noise": _rand(x.shape, 7),
             "t": np.array([500.0], np.float32),
             "context": _rand((1, jc.text_len, jc.text_dim), 2, 0.5)}
    kw = dict(remat_blocks=remat, seq_pad_to=pad)
    jpol = dataclasses.replace(J_FP32, bounded_softmax=bounded)
    tpol = dataclasses.replace(FP32_POLICY, bounded_softmax=bounded)

    jstate, jtx = jtrainer.init_train_state(params,
                                            jtrainer.make_optimizer(1e-3))
    jstep = jtrainer.make_dit_train_step(
        jc, jtx, rope=jrope3d(jc.head_dim, GRID), policy=jpol, **kw)
    jlosses = []
    jbackend("pallas")
    jfa.set_interpret_mode(True)
    try:
        for _ in range(2):
            jstate, jloss = jstep(jstate, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
            jlosses.append(float(jloss))
    finally:
        jfa.set_interpret_mode(False)
        jbackend(None)

    dit = convert.dit_from_jax(params, tc, device="cpu")
    tstate, ttx = ttrainer.init_train_state(dit, ttrainer.make_optimizer(1e-3))
    tstep = ttrainer.make_dit_train_step(
        tc, ttx, rope=trope3d(tc.head_dim, GRID, device="cpu"), policy=tpol,
        **kw)
    calls = []
    real = tatt.flash_attention_fwd_folded
    monkeypatch.setattr(tatt, "flash_attention_fwd_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for i in range(2):
        tstate, tloss = tstep(tstate, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
        np.testing.assert_allclose(float(tloss), jlosses[i], rtol=1e-5,
                                   err_msg=f"step {i}")
    # 2 layers x 2 steps: self + cross forwards with lse, each block's
    # forwards once more under remat True, the cross forward under 'attn'
    assert len(calls) == 2 * {False: 4, True: 8, "attn": 6}[remat]
    assert tstate["step"] == 2

    start = _sd(params)
    got = dict(dit.named_parameters())
    for name, w in _sd(jstate["params"]).items():
        g = got[name].detach().numpy()
        np.testing.assert_allclose(g, w, err_msg=name, **PARAM)
        moved = w - start[name]
        assert np.linalg.norm(g - w) <= MOVED_REL_L2 * np.linalg.norm(moved), \
            name


@pytest.mark.parametrize("bounded", [False, True])
def test_fp32_attention_under_grad_takes_flash_attention(bounded,
                                                        monkeypatch):
    """attention() on fp32 d=128 tensors under grad goes through the
    FlashAttention autograd Function (the forward with lse, then the
    backward pair), whose plain versions run here on the CPU tensors; its
    output and gradients match autograd through the fp32 mha_reference
    (2e-5: summation order). 100 tokens pad to 128 with kv_len."""
    ran = {"fwd_lse": 0, "bwd": 0}
    plain_fwd, plain_bwd = tfa.attention_plain, tfa._bwd_plain_folded

    def fwd(*a, **kw):
        ran["fwd_lse"] += bool(kw.get("save_residuals"))
        return plain_fwd(*a, **kw)

    def bwd(*a, **kw):
        ran["bwd"] += 1
        return plain_bwd(*a, **kw)

    monkeypatch.setattr(tfa, "attention_plain", fwd)
    monkeypatch.setattr(tfa, "_bwd_plain_folded", bwd)
    d = 128
    q, k, v, g = (torch.as_tensor(_rand((1, 100, 2, d), s)) for s in range(4))
    q = q / q.norm(dim=-1, keepdim=True) * d ** 0.5   # qk-normed rows
    k = k / k.norm(dim=-1, keepdim=True) * d ** 0.5
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = tatt.attention(qt, kt, vt,
                         score_bound=1.01 * d if bounded else None)
    fns = {type(f).__name__ for f, _ in out.grad_fn.next_functions if f}
    assert "FlashAttentionBackward" in fns, fns
    got = torch.autograd.grad((out * g).sum(), (qt, kt, vt))
    assert ran == {"fwd_lse": 1, "bwd": 1}
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = tatt.mha_reference(qr, kr, vr)
    want = torch.autograd.grad((ref * g).sum(), (qr, kr, vr))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
