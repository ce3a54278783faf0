"""BAGEL packed training on the port against univid_tpu, on the CPU.

The same seeded inputs go through the JAX functions and the port's: the
mask ids and codes, the packer's batches, `bagel_packed_forward`'s outputs
and the gradients of its loss (the port's parameters from the JAX init,
through convert.bagel_from_jax; the flow noise is JAX's draw, fed in), and
the freeze_und and per-sample-loop properties of tests/test_packed_training.py.
TINY's head dim is 8 (both packages take the reference attention); the
d=128 variant sends the port through the flash kernels' plain versions
under autograd (`FlashAttention` in packed mode) against JAX's XLA path.

Tolerances: fp32 on both sides; outputs 1e-4 (summation order over two
layers), gradients 2e-4 relative + 1e-6 absolute (the backward adds the
attention's recomputed p and fp32 sums over the pack).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_bagel import TINY as JTINY
from tests.test_packed_training import (_make_sample_batch, _reference_mask,
                                        _samples)
from univid_tpu.data import packed_dataset as jpd
from univid_tpu.kernels.attention import pack_mask_codes as jpack
from univid_tpu.models.bagel.bagel import BagelConfig as JBagelConfig
from univid_tpu.models.bagel.bagel import init_bagel as j_init_bagel
from univid_tpu.models.bagel.packed import bagel_packed_forward as j_forward
from univid_tpu.models.bagel.packed import build_mask_ids as j_build_mask_ids
from univid_tpu.models.bagel.qwen2_mot import Qwen2MoTConfig as JQwenConfig
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.models.bagel.siglip import init_siglip as j_init_siglip
from univid_tpu_torch import convert
from univid_tpu_torch.data import packed_dataset as tpd
from univid_tpu_torch.kernels import attention as tatt
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.models.bagel.bagel import BagelConfig
from univid_tpu_torch.models.bagel.packed import (bagel_packed_forward,
                                                  build_mask_ids)
from univid_tpu_torch.models.bagel.qwen2_mot import Qwen2MoTConfig
from univid_tpu_torch.models.bagel.siglip import SiglipConfig

torch.set_num_threads(2)
OUT = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=2e-4, atol=1e-6)
SIGLIP = dict(hidden_size=16, intermediate_size=32, num_layers=1,
              num_heads=2, patch_size=2, image_size=16)
# TINY's LLM with d=128 heads: hidden 256 over 2 query heads, 1 kv head
LLM_D128 = dict(vocab_size=200, hidden_size=256, intermediate_size=64,
                num_layers=2, num_heads=2, num_kv_heads=1)


def _configs(variant):
    """(JAX BagelConfig, port BagelConfig) of TINY or its d=128 variant."""
    jcfg = JTINY
    if variant == "d128":
        jcfg = JBagelConfig(**{**JTINY.__dict__,
                               "llm": JQwenConfig(**LLM_D128)})
    fields = {k: v for k, v in jcfg.__dict__.items() if k != "llm"}
    return jcfg, BagelConfig(llm=Qwen2MoTConfig(**jcfg.llm.__dict__),
                             **fields)


def _models(jcfg, tcfg):
    params = j_init_bagel(jax.random.PRNGKey(0), jcfg)
    # the zero-init llm2vae blocks the mse path's signal: randomize
    params["llm2vae"]["w"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(9), params["llm2vae"]["w"].shape)
    sig = j_init_siglip(jax.random.PRNGKey(1), JSiglipConfig(**SIGLIP))
    params = jax.tree_util.tree_map(np.asarray, params)
    sig = jax.tree_util.tree_map(np.asarray, sig)
    bagel = convert.bagel_from_jax(params, tcfg, device="cpu")
    tsig = convert.siglip_from_jax(sig, SiglipConfig(**SIGLIP), device="cpu")
    return params, sig, bagel, tsig


def _port_batch(samples):
    """The port's packer on the samples of test_packed_training (its
    _make_sample_batch's configuration), under np.random.seed(123)."""
    np.random.seed(123)   # pack_sequence draws the flow timesteps
    ds = tpd.PackedDataset(
        [(lambda: iter([]), 1.0)],
        data_config=tpd.PackedDataConfig(
            vit_patch_size=2, max_num_patch_per_side=8, max_latent_size=8,
            bos_token_id=192, eos_token_id=193, start_of_image=190,
            end_of_image=191),
        max_num_tokens=128)
    st = ds._fresh_status()
    for s in samples:
        st = ds.pack_sequence(s, st)
    return ds.to_batch(st, [])


def _jax_batch(samples):
    np.random.seed(123)
    return _make_sample_batch(None, JSiglipConfig(**SIGLIP), None, samples)


def test_mask_codes_match_jax_and_reference_predicate():
    """build_mask_ids and pack_mask_codes equal JAX's exactly (numpy and
    torch inputs), pad ids -1 / -2 included, and the port's predicate on
    the codes is create_sparse_mask's (_reference_mask)."""
    sample_lens = [10, 8, 5]
    split_lens = [4, 3, 3, 5, 3, 2, 3]
    attn_modes = ["causal", "full", "noise", "causal", "noise", "full",
                  "noise"]
    got = build_mask_ids(sample_lens, split_lens, attn_modes)
    want = j_build_mask_ids(sample_lens, split_lens, attn_modes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    codes = tatt.pack_mask_codes(*got)
    np.testing.assert_array_equal(codes, np.asarray(jpack(*want)))
    np.testing.assert_array_equal(
        tatt.pack_mask_codes(*(torch.as_tensor(x) for x in got)).numpy(),
        codes)
    pads = tatt.pack_mask_codes(np.array([-1, -1]), np.array([-1, -1]),
                                np.array([-1, -1]))
    np.testing.assert_array_equal(pads, np.asarray(jpack(
        np.array([-1, -1]), np.array([-1, -1]), np.array([-1, -1]))))
    n = len(codes)
    row, col = np.arange(n)[:, None], np.arange(n)[None, :]
    ref = _reference_mask(sample_lens, split_lens, attn_modes)
    np.testing.assert_array_equal(   # numpy in, numpy out
        tfa.packed_mask_allowed(codes[:, None], codes[None, :], row, col),
        ref)
    tc = torch.as_tensor(codes)
    np.testing.assert_array_equal(tfa.packed_mask_allowed(
        tc[:, None], tc[None, :], torch.as_tensor(row),
        torch.as_tensor(col)).numpy(), ref)
    # the dispatcher's pad ids: a pad query (-1) against a pad key (-2)
    # passes nothing, so does either against a real token
    assert not tfa.packed_mask_allowed(torch.tensor(-1), torch.tensor(-2),
                                       torch.tensor(5), torch.tensor(3))
    assert not tfa.packed_mask_allowed(torch.tensor(-1), tc[0],
                                       torch.tensor(5), torch.tensor(0))


def test_to_batch_matches_jax():
    """The port's PackedDataset.to_batch equals JAX's array for array on
    test_packed_training's samples, under the same np.random.seed."""
    s1, s2 = _samples()
    got, want = _port_batch([s1, s2]), _jax_batch([s1, s2])
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def test_packer_budgets_and_bookkeeping():
    """tests/test_packed_training.py's packer test on the port's dataset."""
    s1, s2 = _samples()

    def gen():
        yield dict(s1)
        yield dict(s2)
        yield dict(s1)

    ds = tpd.PackedDataset(
        [(gen, 1.0)],
        data_config=tpd.PackedDataConfig(
            vit_patch_size=2, max_num_patch_per_side=8, max_latent_size=8,
            bos_token_id=192, eos_token_id=193, start_of_image=190,
            end_of_image=191),
        expected_num_tokens=20, max_num_tokens_per_sample=64,
        max_num_tokens=128)
    b = list(ds)[0]
    assert b["seq_len"] == 128 and b["mask_codes"].shape == (128,)
    assert b["packed_vit_patches"].shape == (4, 2 * 2 * 3)
    assert list(b["packed_label_ids"]) == [5, 6, 7, 193]
    np.testing.assert_allclose(b["ce_loss_weights"], tpd.len2weight(4))
    vae_pos = b["packed_position_ids"][b["packed_vae_token_indexes"]]
    assert len(set(vae_pos.tolist())) == 1
    assert tpd.len2weight(4) == jpd.len2weight(4)


def test_distributed_iterable_sharding():
    paths = [f"f{i}" for i in range(8)]
    r0 = tpd.DistributedIterableDataset(paths, local_rank=0, world_size=2)
    r1 = tpd.DistributedIterableDataset(paths, local_rank=1, world_size=2)
    r0.set_epoch(3)
    r1.set_epoch(3)
    a, b = list(r0), list(r1)
    assert len(a) == len(b) == 4 and not set(a) & set(b)
    assert set(a) | set(b) == set(paths)
    j0 = jpd.DistributedIterableDataset(paths, local_rank=0, world_size=2)
    j0.set_epoch(3)
    assert a == list(j0)


def _loss_terms(out):
    return out["mse"].sum() + (out["ce"] * out["ce_weights"]).sum()


@pytest.mark.parametrize("variant,freeze", [("d8", False), ("d8", True),
                                            ("d128", False)])
def test_packed_forward_and_grads_match_jax(variant, freeze):
    """bagel_packed_forward (fp32, JAX's noise fed in) == JAX's on the
    two-sample pack (a ViT image with an answer; a prompt with a noised VAE
    latent): the mse and ce terms, then every gradient of sum(mse) +
    sum(ce * ce_weights), leaf by leaf (JAX names through
    convert.jax_tree_to_state_dict), None on the port counting as 0."""
    jcfg, tcfg = _configs(variant)
    params, sig, bagel, tsig = _models(jcfg, tcfg)
    s1, s2 = _samples()
    jb = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in _jax_batch([s1, s2]).items()}
    rng = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(
        rng, jb["packed_latent_clean"].shape, jnp.float32))
    jsig_cfg = JSiglipConfig(**SIGLIP)

    def jloss(p):
        out = j_forward(p, jcfg, jb, rng=rng, siglip_params=sig,
                        siglip_cfg=jsig_cfg, compute_dtype=jnp.float32,
                        freeze_und=freeze)
        return (jnp.sum(out["mse"])
                + jnp.sum(out["ce"] * out["ce_weights"])), out

    (jl, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    for p in bagel.parameters():
        p.requires_grad_(True)
    out = bagel_packed_forward(bagel, tcfg, _port_batch([s1, s2]),
                               noise=torch.as_tensor(noise),
                               siglip_params=tsig,
                               siglip_cfg=SiglipConfig(**SIGLIP),
                               compute_dtype=torch.float32,
                               freeze_und=freeze)
    for key in ("mse", "ce", "ce_weights", "mse_mask"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(jout[key]), err_msg=key, **OUT)
    loss = _loss_terms(out)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **OUT)
    loss.backward()
    want = convert.jax_tree_to_state_dict(jgrad, stacked="llm.layers")
    got = dict(bagel.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        tol = GRAD
        if variant == "d128":
            # the flash plain versions' exp2-domain softmax (scale * log2 e
            # folded into q) against JAX's exp: a gradient element that
            # cancels to ~1e-3 of its leaf's largest keeps ~1e-5 absolute
            tol = dict(GRAD, atol=GRAD["atol"] + GRAD["rtol"]
                       * float(np.abs(w.numpy()).max()))
        np.testing.assert_allclose(g, w.numpy(), err_msg=name, **tol)


def test_freeze_und_zeroes_und_expert_grads():
    """test_packed_training's freeze_und test on the port (d=128 heads:
    the packed kernel route's plain versions): with freeze_und the und
    experts get no gradient (None or exactly 0) from sum(mse), the gen
    experts do; without it the und attention trains too."""
    jcfg, tcfg = _configs("d128")
    _, _, bagel, tsig = _models(jcfg, tcfg)
    s1, s2 = _samples()
    batch = _port_batch([s1, s2])

    def grads(freeze):
        bagel.zero_grad(set_to_none=True)
        for p in bagel.parameters():
            p.requires_grad_(True)
        out = bagel_packed_forward(
            bagel, tcfg, batch, rng=torch.Generator().manual_seed(7),
            siglip_params=tsig, siglip_cfg=SiglipConfig(**SIGLIP),
            compute_dtype=torch.float32, freeze_und=freeze)
        out["mse"].sum().backward()
        return {n: (0.0 if p.grad is None else float(p.grad.abs().max()))
                for n, p in bagel.named_parameters()}

    frozen, free = grads(True), grads(False)
    layers = range(tcfg.llm.num_layers)
    for name in ("q", "k", "v", "o"):
        # without freeze_und the und rows reach the mse through later
        # layers' keys and values (the last layer's und q and o do not)
        assert max(free[f"llm.layers.{i}.attn.{name}.w"]
                   for i in layers) > 0.0, name
    for i in layers:
        pre = f"llm.layers.{i}."
        for name in ("q", "k", "v", "o"):
            assert frozen[f"{pre}attn.{name}.w"] == 0.0, name
        for name in ("gate", "up", "down"):
            assert frozen[f"{pre}mlp.{name}.w"] == 0.0, name
        assert frozen[f"{pre}attn_gen.q.w"] > 0.0
        assert frozen[f"{pre}mlp_gen.gate.w"] > 0.0
    assert frozen["llm.norm"] == 0.0
    assert frozen["vae2llm.w"] > 0.0 and frozen["llm2vae.w"] > 0.0


def test_packed_forward_matches_per_sample_loop():
    """test_packed_training's oracle on the port: the pack's ce terms are
    sample 1's alone and its mse terms sample 2's alone (same generator
    seed: sample 1 has no latents, so the noise rows line up)."""
    jcfg, tcfg = _configs("d8")
    _, _, bagel, tsig = _models(jcfg, tcfg)
    s1, s2 = _samples()

    def run(samples):
        with torch.no_grad():
            return bagel_packed_forward(
                bagel, tcfg, _port_batch(samples),
                rng=torch.Generator().manual_seed(7), siglip_params=tsig,
                siglip_cfg=SiglipConfig(**SIGLIP),
                compute_dtype=torch.float32)

    both, alone1, alone2 = run([s1, s2]), run([s1]), run([s2])
    np.testing.assert_allclose(both["ce"].numpy(), alone1["ce"].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(both["mse"].numpy(), alone2["mse"].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert both["mse"].shape[0] == 6 and bool(both["mse_mask"].all())
