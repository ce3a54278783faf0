"""int8 quantization (--int8): the port's core/quant.py against univid_tpu's,
the counterparts of tests/test_quant.py's seven cases.

Weights and inputs come from numpy seeds; JAX trees reach the port through
univid_tpu_torch.convert (a quantized tree carries its int8 codes as they
are). Tolerances: the port's codes and scales equal JAX's exactly (the same
division, round-half-to-even and clip); outputs on the same codes agree to
1e-5 relative L2 in fp32 (summation order; a per-token activation code
can flip where the two inputs differ by an ulp, measured at most 2e-7);
the quantization error bounds are tests/test_quant.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_models import np_params
from univid_tpu.core import nn as jnn
from univid_tpu.core import quant as jquant
from univid_tpu.core.config import WAN_CONFIGS as JCONFIGS
from univid_tpu.core.dtypes import FP32_POLICY as J_FP32
from univid_tpu.models.bagel import qwen2_mot as jq
from univid_tpu.models.wan.dit import init_wan_dit
from univid_tpu.models.wan.dit import wan_dit_forward as j_dit
from univid_tpu.ops.rope import build_rope_3d as jrope3d
from univid_tpu_torch import convert
from univid_tpu_torch.core import nn as tnn
from univid_tpu_torch.core import quant as tquant
from univid_tpu_torch.core.config import WAN_CONFIGS
from univid_tpu_torch.core.dtypes import FP32_POLICY
from univid_tpu_torch.models.bagel import qwen2_mot as tq
from univid_tpu_torch.models.wan.dit import wan_dit_forward as t_dit
from univid_tpu_torch.ops.rope import build_rope_3d as trope3d

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _linear(in_dim, out_dim, seed, bias=True):
    """A numpy {'w': [in, out], 'b'} tree and the port's Linear on it."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((in_dim, out_dim)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(out_dim).astype(np.float32)
    lin = tnn.Linear(in_dim, out_dim, bias=bias, device="cpu")
    with torch.no_grad():
        lin.w.copy_(torch.as_tensor(p["w"].T))
        if bias:
            lin.b.copy_(torch.as_tensor(p["b"]))
    return {k: jnp.asarray(v) for k, v in p.items()}, lin


def test_quantize_linear_roundtrip_error():
    jp, lin = _linear(256, 128, 0)
    q = tquant.quantize_linear(lin)
    jqp = jquant.quantize_linear(jp)
    assert q.qw.dtype == torch.int8 and tuple(q.scale.shape) == (128,)
    np.testing.assert_array_equal(q.qw.numpy(), np.asarray(jqp["qw"]).T)
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jqp["scale"]))
    deq = q.qw.float() * q.scale[:, None]
    rel = float((deq - lin.w).abs().max() / lin.w.abs().max())
    assert rel < 0.01  # half-ULP of 1/127 per channel


def test_linear_quantized_matches_dense():
    jp, lin = _linear(64, 48, 1)
    x = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    dense = tnn.linear(lin, torch.as_tensor(x), compute_dtype=torch.float32)
    q = tquant.quantize_linear(lin)
    quant = tnn.linear(q, torch.as_tensor(x), compute_dtype=torch.float32)
    assert _rel(quant, dense) < 0.01
    want = jnn.linear(jquant.quantize_linear(jp), jnp.asarray(x),
                      compute_dtype=jnp.float32)
    assert _rel(quant, want) < 1e-6


def test_w8a8_linear_matches_dense():
    jp, lin = _linear(96, 80, 2)
    x = np.random.default_rng(2).standard_normal((7, 96)).astype(np.float32)
    dense = tnn.linear(lin, torch.as_tensor(x), compute_dtype=torch.float32)
    q = tquant.quantize_linear_w8a8(lin)
    assert q.qw8.dtype == torch.int8 and getattr(q, "qw", None) is None
    quant = tnn.linear(q, torch.as_tensor(x), compute_dtype=torch.float32)
    # W8A8 adds the activation-quant error to the weight quant's
    assert _rel(quant, dense) < 0.02
    want = jnn.linear(jquant.quantize_linear_w8a8(jp), jnp.asarray(x),
                      compute_dtype=jnp.float32)
    assert _rel(quant, want) < 1e-6


def test_w8a8_linear_runs_an_int8_product(monkeypatch):
    """The product takes int8 operands and gives int32 (torch._int_mm),
    counted once a call; odd shapes (k = 13, n = 5) are exact too."""
    seen = []
    int_mm = torch._int_mm

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    _, lin = _linear(32, 16, 3, bias=False)
    q = tquant.quantize_linear_w8a8(lin)
    tquant.W8A8_LAUNCHES["w8a8_linear"] = 0
    y = tnn.linear(q, torch.ones((4, 32), dtype=torch.bfloat16),
                   compute_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert seen == [(torch.int8, torch.int8)]
    assert tquant.W8A8_LAUNCHES["w8a8_linear"] == 1
    a = torch.randint(-127, 128, (3, 13), dtype=torch.int8)
    w = torch.randint(-127, 128, (5, 13), dtype=torch.int8)
    got = tquant.int8_matmul(a, w)
    assert got.dtype == torch.int32
    assert torch.equal(got, a.int() @ w.int().t())


def _tiny_dit_case():
    cfg = JCONFIGS["tiny"].dit
    p = np_params(init_wan_dit, cfg, 0, stacked=True)
    x = np.random.default_rng(1).standard_normal(
        (1, 5, 8, 8, cfg.in_dim)).astype(np.float32)
    ctx = (np.random.default_rng(2).standard_normal(
        (1, cfg.text_len, cfg.text_dim)) * 0.02).astype(np.float32)
    grid = (5, 8 // cfg.patch_size[1], 8 // cfg.patch_size[2])
    return cfg, p, x, np.array([500.0], np.float32), ctx, grid


def test_quantize_dit_w8a8_forward_close():
    """The tiny DiT (fp32): quantize_dit_w8a8 gives JAX's codes and scales
    leaf for leaf (block projections and FFN only; the head stays dense);
    the W8A8 forward stays within tests/test_quant.py's 1.5% of the dense
    one, and the converted JAX W8A8 tree's forward equals JAX's (1e-5)."""
    cfg, p, x, t, ctx, grid = _tiny_dit_case()
    tcfg = WAN_CONFIGS["tiny"].dit
    jqt = jquant.quantize_dit_w8a8(p)
    dit = tquant.quantize_dit_w8a8(convert.dit_from_jax(p, tcfg,
                                                        device="cpu"))
    blk = dit.blocks[0]
    assert blk.self_attn.q.qw8.dtype == torch.int8
    assert blk.ffn.fc1.qw8.dtype == torch.int8
    assert isinstance(dit.head.head, tnn.Linear)   # the head stays dense
    sd = dit.state_dict()
    for i in range(tcfg.num_layers):
        for sub in tquant._DIT_W8A8_SUBPATHS:
            mod, proj = sub.split(".")
            leaf = jqt["blocks"][mod][proj]
            np.testing.assert_array_equal(
                sd[f"blocks.{i}.{sub}.qw8"].numpy(),
                np.asarray(leaf["qw8"][i]).T)
            np.testing.assert_array_equal(sd[f"blocks.{i}.{sub}.scale"].numpy(),
                                          np.asarray(leaf["scale"][i]))
    cos, sin = trope3d(tcfg.head_dim, grid, device="cpu")
    args = (torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx),
            cos, sin)
    dense = t_dit(convert.dit_from_jax(p, tcfg, device="cpu"), *args,
                  policy=FP32_POLICY)
    quant = t_dit(dit, *args, policy=FP32_POLICY)
    assert _rel(quant, dense) < 0.015
    jcos, jsin = jrope3d(cfg.head_dim, grid)
    want = j_dit(jqt, cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                 jcos, jsin, policy=J_FP32)
    got = t_dit(convert.dit_from_jax(jqt, tcfg, device="cpu"), *args,
                policy=FP32_POLICY)
    assert isinstance(convert.dit_from_jax(jqt, tcfg, device="cpu")
                      .blocks[1].cross_attn.o, tquant.QuantLinear)
    assert _rel(got, want) < 1e-5
    assert _rel(quant, want) < 1e-5


def _mot(min_size=None):
    cfg_kw = dict(num_heads=4, num_kv_heads=2)
    if min_size is None:
        cfg_kw.update(vocab_size=512, hidden_size=256, intermediate_size=512)
    else:
        cfg_kw.update(vocab_size=128, hidden_size=64, intermediate_size=128)
    jcfg = jq.Qwen2MoTConfig(num_layers=2, **cfg_kw)
    tcfg = tq.Qwen2MoTConfig(num_layers=2, **cfg_kw)
    params = np_params(jq.init_qwen2_mot, jcfg, 4, stacked=True)
    model = tq.init_qwen2_mot(None, tcfg, device="cpu")
    model.load_state_dict(convert.jax_tree_to_state_dict(params, "layers"))
    return jcfg, tcfg, params, model


def test_quantize_tree_structure_and_bytes():
    """Weight-only quantization of a Qwen2-MoT: embeddings skipped, every
    layer's linears (both experts) quantized, norms untouched, bytes down
    to < 65% of bf16; codes equal JAX's."""
    jcfg, tcfg, params, model = _mot()
    model = model.to(torch.bfloat16)
    base = tquant.quantized_bytes(model)
    tquant.quantize_tree(model)
    lyr = model.layers[0]
    assert lyr.attn.q.qw.dtype == torch.int8
    assert lyr.mlp_gen.down.qw.dtype == torch.int8
    assert model.embed_tokens.dtype == torch.bfloat16
    assert lyr.attn.q_norm.dtype == torch.bfloat16
    assert tquant.quantized_bytes(model) < 0.65 * base
    jqp = jquant.quantize_tree(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), params))
    np.testing.assert_array_equal(
        lyr.attn.q.qw.numpy(), np.asarray(jqp["layers"]["attn"]["q"]["qw"][0]).T)


def test_quantized_mot_forward_close_to_dense():
    """quantize_tree(min_size=1) on a small Qwen2-MoT (fp32): the und
    forward within 5% of the dense one and the same argmax logit, as in
    tests/test_quant.py; the port's quantized forward equals JAX's on the
    same codes (1e-5)."""
    jcfg, tcfg, params, model = _mot(min_size=1)
    x = np.random.default_rng(1).standard_normal(
        (8, jcfg.hidden_size)).astype(np.float32)
    pos = np.arange(8)

    def run(m):
        h, _ = tq.qwen2_mot_forward(
            m, tcfg, torch.as_tensor(x[None]), torch.as_tensor(pos[None]),
            tq.init_kv_cache(tcfg, 16, dtype=torch.float32, device="cpu"),
            mode="und", compute_dtype=torch.float32)
        return h[0], tq.lm_head_logits(m, tcfg, h[0, -1:], torch.float32)

    h_d, lg_d = run(model)
    tquant.quantize_tree(model, min_size=1)
    h_q, lg_q = run(model)
    assert _rel(h_q, h_d) < 0.05
    assert int(lg_d.argmax()) == int(lg_q.argmax())
    jqp = jquant.quantize_tree(params, min_size=1)
    jh, _ = jq.qwen2_mot_forward(jqp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 jq.init_kv_cache(jcfg, 16, jnp.float32),
                                 mode="und", compute_dtype=jnp.float32)
    assert _rel(h_q, jh) < 1e-5
