"""BAGEL at fp32 compute on the port's attention kernel route, against
univid_tpu's BAGEL on its Pallas kernels in interpret mode, on the CPU.

A narrow BAGEL whose head dim is 128 (hidden 256, 2 query heads over 1 kv
head, 2 layers: tests/test_torch_bagel.py's), compute_dtype fp32: the ViT
append (non-causal, grouped kv heads over the un-repeated cache, kv_len),
the question's causal prefill (q_offsets, kv_len) and BAGEL packed
training's pass (the packed forward with lse and the backward) take the
fp32 d=128 kernels' route, whose plain versions run here; JAX is forced
onto its Pallas kernels (`set_attention_backend("pallas")`,
`set_interpret_mode(True)`, restored after each test). Weights from the
JAX init through convert.py. Tolerances: the loss 1e-5 relative, every
other tensor 1e-4 relative L2 (fp32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from tests.test_torch_bagel import models  # noqa: F401  (the fixture)
from tests.test_torch_packed import (_configs, _jax_batch, _loss_terms,
                                     _models, _port_batch)
from tests.test_packed_training import _samples
from univid_tpu.kernels.attention import set_attention_backend
from univid_tpu.models.bagel import bagel as jb
from univid_tpu.models.bagel import qwen2_mot as jq
from univid_tpu.models.bagel.packed import bagel_packed_forward as j_forward
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu_torch import convert
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.models.bagel import bagel as tb
from univid_tpu_torch.models.bagel import qwen2_mot as tq
from univid_tpu_torch.models.bagel.packed import bagel_packed_forward
from univid_tpu_torch.models.bagel.siglip import SiglipConfig
from tests.test_torch_packed import SIGLIP as PACK_SIGLIP

torch.set_num_threads(2)


@pytest.fixture
def pallas():
    """JAX's attention on its Pallas kernels in interpret mode, restored."""
    set_attention_backend("pallas")
    jfa.set_interpret_mode(True)
    try:
        yield
    finally:
        jfa.set_interpret_mode(False)
        set_attention_backend(None)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _caches(tc, jc):
    return [(tc["cache"][kv][:, 0].numpy(), np.asarray(jc["cache"][kv]))
            for kv in ("k", "v")]


def _prefill(fwd, head, llm, cfg, ctx, ids, n, f32, pos):
    """update_context_text's forward with the final norm, and the logits of
    its valid rows (the question prefill's)."""
    h, cache = fwd(llm, cfg, ids, pos, ctx["cache"], mode="und",
                   q_valid=n, is_causal=True, compute_dtype=f32,
                   final_norm=True)
    return head(llm, cfg, h, compute_dtype=f32), cache


def test_vit_append_and_prefill_match_jax_pallas(models, pallas):
    """update_context_vit (a 64-row bucket, 35 valid) then the text prefill
    (a 32-row bucket, 22 valid) at fp32 over a 192-row cache: the port's
    grouped ViT append and causal prefill (its kernels' plain versions)
    against JAX on its Pallas kernels: each cache after each step, and
    the prefill's logits."""
    jp, jcfg, model, cfg = models
    rng = np.random.default_rng(26)
    feats = rng.standard_normal((64, 32)).astype(np.float32)
    pos = np.pad(jb.flattened_position_ids(5, 7, 8), (0, 29))
    ids = np.concatenate([[510], rng.integers(0, 500, 20), [511],
                          np.zeros(10, np.int64)])
    jc = jb.init_gen_context(jcfg, 192, dtype=jnp.float32)
    jc = jb.update_context_vit(jp, jcfg, jc, jnp.asarray(feats),
                               jnp.asarray(pos), compute_dtype=jnp.float32,
                               n_valid=jnp.asarray(35, jnp.int32))
    tc = tb.init_gen_context(cfg, 192, dtype=torch.float32, device="cpu")
    tc = tb.update_context_vit(model, cfg, tc, torch.as_tensor(feats[None]),
                               torch.as_tensor(pos[None]),
                               compute_dtype=torch.float32, n_valid=35)
    assert tc["cache"]["len_host"] == [int(jc["cache"]["len"])] == [37]
    for got, want in _caches(tc, jc):
        assert _rel(got, want) < 1e-4

    jx = jp["llm"]["embed_tokens"][jnp.asarray(ids)]
    jlog, jcache = _prefill(
        jq.qwen2_mot_forward, jq.lm_head_logits, jp["llm"], jcfg.llm, jc,
        jx, jnp.asarray(22, jnp.int32), jnp.float32,
        jc["rope"] + jnp.arange(len(ids)))
    tx = model.llm.embed_tokens[torch.as_tensor(ids[None])]
    tlog, tcache = _prefill(
        tq.qwen2_mot_forward, tq.lm_head_logits, model.llm, cfg.llm, tc,
        tx, 22, torch.float32,
        tc["rope"][:, None] + torch.arange(len(ids))[None])
    assert _rel(tlog[0, :22].numpy(), np.asarray(jlog)[:22]) < 1e-4
    for kv in ("k", "v"):
        assert _rel(tcache[kv][:, 0].numpy(), np.asarray(jcache[kv])) < 1e-4
    assert tcache["len_host"] == [int(jcache["len"])] == [59]


def test_packed_pass_matches_jax_pallas(pallas):
    """bagel_packed_forward at fp32 on the d=128 variant (the plain packed
    forward with lse and backward under `FlashAttention`) against JAX's on
    its Pallas custom VJP in interpret mode: the loss within 1e-5
    relative, every gradient leaf within 1e-4 relative L2 (a leaf JAX gives
    exactly 0 is 0 or absent on the port)."""
    jcfg, tcfg = _configs("d128")
    params, sig, bagel, tsig = _models(jcfg, tcfg)
    s1, s2 = _samples()
    jbatch = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in _jax_batch([s1, s2]).items()}
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(
        key, jbatch["packed_latent_clean"].shape, jnp.float32))
    jsig = JSiglipConfig(**PACK_SIGLIP)

    def jloss(p):
        out = j_forward(p, jcfg, jbatch, rng=key, siglip_params=sig,
                        siglip_cfg=jsig, compute_dtype=jnp.float32)
        return jnp.sum(out["mse"]) + jnp.sum(out["ce"] * out["ce_weights"])

    jl, jgrad = jax.value_and_grad(jloss)(params)
    for p in bagel.parameters():
        p.requires_grad_(True)
    out = bagel_packed_forward(bagel, tcfg, _port_batch([s1, s2]),
                               noise=torch.as_tensor(noise),
                               siglip_params=tsig,
                               siglip_cfg=SiglipConfig(**PACK_SIGLIP),
                               compute_dtype=torch.float32)
    loss = _loss_terms(out)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    loss.backward()
    want = convert.jax_tree_to_state_dict(jgrad, stacked="llm.layers")
    got = dict(bagel.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        w = w.numpy()
        g = got[name].grad
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        if not np.any(w):
            assert not np.any(g), name
            continue
        assert _rel(g, w) < 1e-4, name
    assert not any(tfa.LAUNCHES_BY_MODE.values())
