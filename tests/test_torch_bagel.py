"""The port's BAGEL LLM and understanding path against univid_tpu's.

A tiny BAGEL whose head dim is 128 (hidden 256, 2 query heads over 1 kv
head), so the causal text prefill and the ViT append take the attention
kernel route (the kernels' plain versions on the CPU) while JAX runs its
XLA reference: the two routes are held against each other. Weights come
from the JAX init (numpy leaves, through convert.bagel_from_jax); ids,
embeddings and images are numpy arrays from seeds. fp32 throughout:
forwards and caches agree to 1e-4 (summation order); greedy tokens
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univid_tpu.models.bagel import bagel as jb
from univid_tpu.models.bagel import qwen2_mot as jq
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.models.bagel.siglip import init_siglip as j_init_siglip
from univid_tpu.pipelines.interleave import InterleaveInferencer as JInfer
from univid_tpu.utils.tokenizers import HashTokenizer as JHashTokenizer
from univid_tpu_torch import convert
from univid_tpu_torch.models.bagel import bagel as tb
from univid_tpu_torch.models.bagel import qwen2_mot as tq
from univid_tpu_torch.models.bagel.siglip import SiglipConfig
from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
from univid_tpu_torch.utils.tokenizers import HashTokenizer

torch.set_num_threads(2)
F32 = dict(rtol=1e-4, atol=1e-4)
LLM = dict(vocab_size=512, hidden_size=256, intermediate_size=96,
           num_layers=2, num_heads=2, num_kv_heads=1)
SPECIAL = dict(start_of_image=508, end_of_image=509, bos_token_id=510,
               eos_token_id=511)
VIT = dict(vit_hidden_size=32, vit_patch_size=14,
           vit_max_num_patch_per_side=8)
SIGLIP = dict(hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=2, patch_size=14, image_size=56)


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX config, port Bagel, port config) sharing weights;
    non-unit norms and gen-expert norms so MoT routing shows."""
    jcfg = jb.BagelConfig(llm=jq.Qwen2MoTConfig(**LLM), **SPECIAL, **VIT)
    jp = jb.init_bagel(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    layers = dict(jp["llm"]["layers"])
    for name in ("input_ln_gen", "post_ln_gen"):
        layers[name] = jnp.asarray(rng.uniform(0.5, 1.5, layers[name].shape),
                                   jnp.float32)
    gen_attn = dict(layers["attn_gen"])
    gen_attn["q_norm"] = jnp.asarray(
        rng.uniform(0.5, 1.5, gen_attn["q_norm"].shape), jnp.float32)
    layers["attn_gen"] = gen_attn
    jp = dict(jp, llm=dict(jp["llm"], layers=layers))
    cfg = tb.BagelConfig(llm=tq.Qwen2MoTConfig(**LLM), **SPECIAL, **VIT)
    model = convert.bagel_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   cfg, device="cpu")
    return jp, jcfg, model, cfg


def _cache_np(cache):
    """port cache [layers, 1, cap, kv, d] -> the JAX layout."""
    return cache["k"][:, 0].numpy(), cache["v"][:, 0].numpy()


def test_bagel_from_jax_takes_every_leaf(models):
    jp, _, model, _ = models
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    np.testing.assert_array_equal(
        model.llm.layers[1].attn_gen.q_norm.numpy(),
        np.asarray(jp["llm"]["layers"]["attn_gen"]["q_norm"][1]))


def test_rope_tables_and_rotation_match_jax():
    pos = np.arange(40) * 7
    jc, js = jq.rope_tables(jnp.asarray(pos), 128, 1e6)
    tc, ts = tq.rope_tables(torch.as_tensor(pos), 128, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    x = np.random.default_rng(1).standard_normal((40, 3, 128)) \
        .astype(np.float32)
    want = jq.apply_rope_half(jnp.asarray(x), jc, js)
    got = tq.apply_rope_half(torch.as_tensor(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode", ["und", "gen"])
def test_forward_matches_jax_and_prefill_decode_equals_full(models, mode):
    """qwen2_mot_forward (und, and gen with und_rows) == JAX on a 20-row
    causal prefill of 40-row padding (q_valid) then 3 decode rows; the
    port's prefill + decode equals its own full pass; the cache matches
    JAX's row for row, padding rows included."""
    jp, jcfg, model, cfg = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 256)).astype(np.float32)
    pos = np.arange(40)
    und = np.array([0, 7], np.int32) if mode == "gen" else None
    kw = dict(mode=mode, compute_dtype=jnp.float32)
    jc = jq.init_kv_cache(jcfg.llm, 96, dtype=jnp.float32)
    jh, jc = jq.qwen2_mot_forward(
        jp["llm"], jcfg.llm, jnp.asarray(x), jnp.asarray(pos), jc,
        q_valid=jnp.asarray(20, jnp.int32),
        und_rows=None if und is None else jnp.asarray(und), **kw)
    tc = tq.init_kv_cache(cfg.llm, 96, dtype=torch.float32, device="cpu")
    tkw = dict(mode=mode, compute_dtype=torch.float32,
               und_rows=None if und is None else torch.as_tensor(und).long())
    th, tc = tq.qwen2_mot_forward(
        model.llm, cfg.llm, torch.as_tensor(x[None]),
        torch.as_tensor(pos[None]), tc, q_valid=20, **tkw)
    np.testing.assert_allclose(th[0, :20].numpy(), np.asarray(jh[:20]), **F32)
    for got, want in zip(_cache_np(tc), (jc["k"], jc["v"])):
        np.testing.assert_allclose(got, np.asarray(want), **F32)
    assert tc["len_host"] == [20] and int(tc["len"][0]) == 20
    steps = []
    for i in range(20, 23):
        jd, jc = jq.qwen2_mot_forward(jp["llm"], jcfg.llm,
                                      jnp.asarray(x[i:i + 1]),
                                      jnp.asarray(pos[i:i + 1]), jc,
                                      compute_dtype=jnp.float32)
        td, tc = tq.qwen2_mot_forward(model.llm, cfg.llm,
                                      torch.as_tensor(x[None, i:i + 1]),
                                      torch.as_tensor(pos[None, i:i + 1]), tc,
                                      compute_dtype=torch.float32)
        np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), **F32)
        steps.append(td[0])
    full = tq.init_kv_cache(cfg.llm, 96, dtype=torch.float32, device="cpu")
    if mode == "und":   # gen mode's und rows sit at fixed row indices
        hf, _ = tq.qwen2_mot_forward(model.llm, cfg.llm,
                                     torch.as_tensor(x[None, :23]),
                                     torch.as_tensor(pos[None, :23]), full,
                                     compute_dtype=torch.float32)
        inc = torch.cat([th[0, :20]] + steps)
        np.testing.assert_allclose(inc.numpy(), hf[0].numpy(), **F32)


def test_padded_query_tail_is_masked(models):
    """Rows past q_valid change neither the valid rows nor what a later
    decode step sees (the counterpart of tests/test_qwen2_mot.py)."""
    _, _, model, cfg = models
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((1, 8, 256)).astype(np.float32))
    pos = torch.arange(8)[None]
    kw = dict(compute_dtype=torch.float32)

    def cache():
        return tq.init_kv_cache(cfg.llm, 64, dtype=torch.float32,
                                device="cpu")

    ha, ca = tq.qwen2_mot_forward(model.llm, cfg.llm, x[:, :6], pos[:, :6],
                                  cache(), **kw)
    xp = torch.cat([x[:, :6], torch.full((1, 2, 256), 99.0)], dim=1)
    hb, cb = tq.qwen2_mot_forward(model.llm, cfg.llm, xp, pos, cache(),
                                  q_valid=6, **kw)
    np.testing.assert_allclose(hb[0, :6].numpy(), ha[0].numpy(), **F32)
    assert cb["len_host"] == [6]
    nxt = x[:, 6:7]
    da, _ = tq.qwen2_mot_forward(model.llm, cfg.llm, nxt, pos[:, 6:7], ca,
                                 **kw)
    db, _ = tq.qwen2_mot_forward(model.llm, cfg.llm, nxt, pos[:, 6:7], cb,
                                 **kw)
    np.testing.assert_allclose(da.numpy(), db.numpy(), **F32)


def test_batched_rows_keep_their_own_cursor(models):
    """B = 2 rows at different cache lengths == each row alone (the
    vmapped JAX callers' semantics): per-row causal offsets in the kernel
    route, per-row cursors in the append."""
    _, _, model, cfg = models
    rng = np.random.default_rng(4)
    pre = [rng.standard_normal((1, n, 256)).astype(np.float32)
           for n in (5, 19)]
    text = rng.standard_normal((2, 40, 256)).astype(np.float32)
    kw = dict(compute_dtype=torch.float32)
    c2 = tq.init_kv_cache(cfg.llm, 128, batch=2, dtype=torch.float32,
                          device="cpu")
    xpad = np.zeros((2, 19, 256), np.float32)
    xpad[0, :5], xpad[1] = pre[0][0], pre[1][0]
    _, c2 = tq.qwen2_mot_forward(model.llm, cfg.llm, torch.as_tensor(xpad),
                                 torch.arange(19)[None], c2, q_valid=[5, 19],
                                 **kw)
    pos2 = torch.tensor([[5], [19]]) + torch.arange(40)[None]
    h2, c2 = tq.qwen2_mot_forward(model.llm, cfg.llm, torch.as_tensor(text),
                                  pos2, c2, **kw)
    for r, n in enumerate((5, 19)):
        c1 = tq.init_kv_cache(cfg.llm, 128, dtype=torch.float32,
                              device="cpu")
        _, c1 = tq.qwen2_mot_forward(model.llm, cfg.llm,
                                     torch.as_tensor(pre[r]),
                                     torch.arange(n)[None], c1, **kw)
        h1, c1 = tq.qwen2_mot_forward(model.llm, cfg.llm,
                                      torch.as_tensor(text[r:r + 1]),
                                      pos2[r:r + 1], c1, **kw)
        np.testing.assert_allclose(h2[r].numpy(), h1[0].numpy(), **F32)
        np.testing.assert_allclose(c2["k"][:, r, :n + 40].numpy(),
                                   c1["k"][:, 0, :n + 40].numpy(), **F32)
    assert c2["len_host"] == [45, 59]


def test_cache_overflow_raises_where_jax_overwrites(models):
    """A 16-row bucketed append at length 40 of a 48-row cache: JAX's
    dynamic_update_slice clamps the start to 32 and overwrites valid rows
    32..39; the port raises ValueError naming the capacity."""
    jp, jcfg, model, cfg = models
    ids = np.random.default_rng(5).integers(0, 500, 40)
    jc = jb.init_gen_context(jcfg, 48, dtype=jnp.float32)
    jc = jb.update_context_text(jp, jcfg, jc, jnp.asarray(ids),
                                compute_dtype=jnp.float32)
    before = np.asarray(jc["cache"]["k"]).copy()
    jc2 = jb.update_context_text(jp, jcfg, jc, jnp.asarray(ids[:16]),
                                 compute_dtype=jnp.float32, n_valid=4)
    after = np.asarray(jc2["cache"]["k"])
    assert not np.allclose(after[:, 32:40], before[:, 32:40])
    tc = tb.init_gen_context(cfg, 48, dtype=torch.float32, device="cpu")
    tc = tb.update_context_text(model, cfg, tc, torch.as_tensor(ids[None]),
                                compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="capacity 48"):
        tb.update_context_text(model, cfg, tc, torch.as_tensor(ids[None, :16]),
                               compute_dtype=torch.float32, n_valid=4)


def test_context_updates_and_greedy_decode_match_jax(models):
    """Bucketed ViT append (n_valid) then bucketed text prefill (n_valid),
    caches and rope cursor == JAX; 6 greedy tokens equal, length too."""
    jp, jcfg, model, cfg = models
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((64, 32)).astype(np.float32)
    pos = np.pad(jb.flattened_position_ids(5, 7, 8), (0, 29))
    ids = np.concatenate([[510], rng.integers(0, 500, 20), [511],
                          np.zeros(10, np.int64)])
    jc = jb.init_gen_context(jcfg, 160, dtype=jnp.float32)
    jc = jb.update_context_vit(jp, jcfg, jc, jnp.asarray(feats),
                               jnp.asarray(pos), compute_dtype=jnp.float32,
                               n_valid=jnp.asarray(35, jnp.int32))
    jc = jb.update_context_text(jp, jcfg, jc, jnp.asarray(ids),
                                compute_dtype=jnp.float32,
                                n_valid=jnp.asarray(22, jnp.int32))
    tc = tb.init_gen_context(cfg, 160, dtype=torch.float32, device="cpu")
    tc = tb.update_context_vit(model, cfg, tc, torch.as_tensor(feats[None]),
                               torch.as_tensor(pos[None]),
                               compute_dtype=torch.float32, n_valid=35)
    tc = tb.update_context_text(model, cfg, tc, torch.as_tensor(ids[None]),
                                compute_dtype=torch.float32, n_valid=22)
    assert int(tc["rope"][0]) == int(jc["rope"]) == 23
    assert tc["cache"]["len_host"] == [int(jc["cache"]["len"])] == [59]
    for got, want in zip(_cache_np(tc["cache"]),
                         (jc["cache"]["k"], jc["cache"]["v"])):
        np.testing.assert_allclose(got, np.asarray(want), **F32)
    jt, jl = jb.generate_text(jp, jcfg, jc, 6, compute_dtype=jnp.float32)
    tt, tl = tb.generate_text(model, cfg, tc, 6, compute_dtype=torch.float32)
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
    assert int(tl[0]) == int(jl)


def test_sampled_decode_is_deterministic_per_seed(models):
    """jax.random and torch.Generator draw different tokens, so the sampled
    path is held to determinism per seed and to the vocabulary."""
    _, _, model, cfg = models
    ids = torch.as_tensor(np.random.default_rng(7).integers(0, 500,
                                                            (2, 12)))

    def run(seed):
        ctx = tb.init_gen_context(cfg, 64, batch=2, dtype=torch.float32,
                                  device="cpu")
        ctx = tb.update_context_text(model, cfg, ctx, ids,
                                     compute_dtype=torch.float32)
        return tb.generate_text(model, cfg, ctx, 8, do_sample=True,
                                temperature=1.5,
                                rng=torch.Generator().manual_seed(seed),
                                compute_dtype=torch.float32)[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < LLM["vocab_size"]


@pytest.fixture(scope="module")
def inferencers(models):
    jp, jcfg, model, cfg = models
    jscfg = JSiglipConfig(**SIGLIP)
    sig = j_init_siglip(jax.random.PRNGKey(1), jscfg)
    j = JInfer(jp, jcfg, JHashTokenizer(500), siglip_params=sig,
               siglip_cfg=jscfg, capacity=512, compute_dtype=jnp.float32)
    t = InterleaveInferencer(
        model, cfg, HashTokenizer(500),
        siglip=convert.siglip_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              sig),
                                       SiglipConfig(**SIGLIP), device="cpu"),
        siglip_cfg=SiglipConfig(**SIGLIP), capacity=512,
        compute_dtype=torch.float32)
    return j, t


# longer than 32 tokens with bos / eos: the prefill takes the causal kernel
# route (shorter ones take the decode-shaped einsums, as in JAX)
LONG = ("Describe the main objects and the actions in this single frame "
        "concisely, naming every person, animal and vehicle you can see, "
        "where each of them stands in the picture, and what each of them "
        "appears to be doing right now.")


def _frames(n, seed, sizes=((28, 28),)):
    return [np.random.default_rng(seed + i).uniform(
        -1, 1, (*sizes[i % len(sizes)], 3)).astype(np.float32)
        for i in range(n)]


def test_caption_frames_batched_matches_jax(inferencers):
    """3 frames of 2x2, 2x3 and 3x3 patches captioned as one batch (rows
    at different cache lengths: per-row causal offsets in the prompt's
    prefill) == JAX's vmapped program, token for token (4 greedy
    tokens)."""
    j, t = inferencers
    frames = _frames(3, 10, sizes=((28, 28), (28, 42), (42, 42)))
    want = j.caption_frames([jnp.asarray(f) for f in frames], LONG,
                            max_length=4)
    got = t.caption_frames(frames, LONG, max_length=4)
    assert got == want and len(got) == 3


def test_video_understanding_and_chat_match_jax(inferencers):
    """2 frames (ViT appends) + a question (bucketed causal prefill over
    the cache) + 4 greedy tokens == JAX; chat on one image likewise."""
    j, t = inferencers
    frames = _frames(2, 20)
    q = LONG
    want = j.video_understanding([jnp.asarray(f) for f in frames], q,
                                 max_think_token_n=4)
    got = t.video_understanding(frames, q, max_think_token_n=4)
    assert got == want
    assert t.chat(frames[:1], q, max_length=4) == \
        j.chat([jnp.asarray(frames[0])], q, max_length=4)
