"""The port's Pyramid Reflection against univid_tpu's: the SigLIP2 scorer
(text tower, image tower, attention-pool head), MMR selection, and
reflexion_answer_one end to end with the offline judge and reflector;
then the port's eval_understanding CLI once on the CPU.

Weights come from the JAX inits (numpy leaves, through convert); frames
are seeded uint8 arrays. fp32: embeddings agree to 1e-5, the selected
frame indices and the whole trace (answers are greedy tokens) exactly.
The BAGEL here is the JAX CLI's mock (hidden 64, head dim 16: the
reference attention route); tests/test_torch_bagel.py holds the kernel
route.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univid_tpu.core.checkpoint import convert_siglip_map_head
from univid_tpu.models.bagel import bagel as jb
from univid_tpu.models.bagel import qwen2_mot as jq
from univid_tpu.models.bagel.siglip import SiglipConfig as JSiglipConfig
from univid_tpu.models.bagel.siglip import init_siglip as j_init_siglip
from univid_tpu.pipelines.interleave import InterleaveInferencer as JInfer
from univid_tpu.reflection import clients as jclients
from univid_tpu.reflection import mmr as jmmr
from univid_tpu.reflection import reflexion as jrefl
from univid_tpu.reflection import scorer as jscorer
from univid_tpu.utils.tokenizers import HashTokenizer as JHashTokenizer
from univid_tpu_torch import convert
from univid_tpu_torch.core import nn as unn
from univid_tpu_torch.models.bagel import bagel as tb
from univid_tpu_torch.models.bagel import qwen2_mot as tq
from univid_tpu_torch.models.bagel.siglip import SiglipConfig
from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
from univid_tpu_torch.reflection import clients as tclients
from univid_tpu_torch.reflection import mmr as tmmr
from univid_tpu_torch.reflection import reflexion as trefl
from univid_tpu_torch.reflection import scorer as tscorer
from univid_tpu_torch.utils.tokenizers import HashTokenizer

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX CLI's mock models (univid_tpu/cli/eval_understanding.py:102-114)
LLM = dict(vocab_size=4096, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2)
BAGEL = dict(vit_hidden_size=32, vit_patch_size=14, start_of_image=4090,
             end_of_image=4091, bos_token_id=4092, eos_token_id=4093)
SIGLIP = dict(hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=2, patch_size=14, image_size=224)
# a small scorer: 2-layer towers of head dim 64 (the default's head dim)
VISION = dict(hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=1, patch_size=16, image_size=64)
TEXT = dict(vocab_size=4096, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=1, max_len=16, proj_dim=32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def scorers():
    """(JAX scorer, port scorer) with the same towers and projection."""
    j = jscorer.Siglip2Scorer(vision_cfg=JSiglipConfig(**VISION),
                              text_cfg=jscorer.SiglipTextConfig(**TEXT),
                              tokenizer=JHashTokenizer(4090), image_size=64,
                              seed=3)
    vcfg, tcfg = SiglipConfig(**VISION), tscorer.SiglipTextConfig(**TEXT)
    proj = unn.Linear(64, 32, bias=False, init="empty", device="cpu")
    proj.load_state_dict(convert.jax_tree_to_state_dict(
        _np_tree(j.img_proj)))
    t = tscorer.Siglip2Scorer(
        vision_params=convert.siglip_from_jax(_np_tree(j.vision_params),
                                              vcfg, device="cpu"),
        vision_cfg=vcfg,
        text_params=convert.siglip_text_from_jax(_np_tree(j.text_params),
                                                 tcfg, device="cpu"),
        text_cfg=tcfg, tokenizer=HashTokenizer(4090), image_size=64,
        img_proj=proj, device="cpu")
    return j, t


def _pool(n, seed, hw=(28, 28)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for _ in range(n)]


def test_scorer_embeddings_and_ranking_match_jax(scorers):
    """emb_imgs (uint8 frames, PIL-bicubic resized, two batches), emb_text
    and rank_frames == JAX to 1e-5; the same top-k indices."""
    j, t = scorers
    frames = _pool(5, 0, hw=(48, 80))
    np.testing.assert_allclose(t.emb_imgs(frames, bs=3),
                               j.emb_imgs(frames, bs=3), atol=1e-5)
    q = "a dog running on the beach at sunset"
    np.testing.assert_allclose(t.emb_text(q), j.emb_text(q), atol=1e-5)
    assert t.rank_frames(frames, q, 3)[0] == j.rank_frames(frames, q, 3)[0]


def test_text_tower_hf_last_and_map_head_match_jax():
    """siglip_text_forward with HF last-token pooling, and the
    attention-pooling head on [N, d] features, == JAX to 1e-5."""
    cfg = jscorer.SiglipTextConfig(**dict(TEXT, pooling="hf_last"))
    tp = jscorer.init_siglip_text(jax.random.PRNGKey(4), cfg)
    ids = np.random.default_rng(1).integers(0, 4096, (2, 16))
    want = jscorer.siglip_text_forward(tp, cfg, jnp.asarray(ids))
    tcfg = tscorer.SiglipTextConfig(**dict(TEXT, pooling="hf_last"))
    got = tscorer.siglip_text_forward(
        convert.siglip_text_from_jax(_np_tree(tp), tcfg, device="cpu"),
        tcfg, torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    rng = np.random.default_rng(2)
    d, m = 64, 96
    prefix = "vision_model.head"
    sd = {f"{prefix}.probe": rng.standard_normal((1, 1, d)),
          f"{prefix}.attention.in_proj_weight":
              rng.standard_normal((3 * d, d)) * 0.1,
          f"{prefix}.attention.in_proj_bias": rng.standard_normal(3 * d),
          f"{prefix}.attention.out_proj.weight":
              rng.standard_normal((d, d)) * 0.1,
          f"{prefix}.attention.out_proj.bias": rng.standard_normal(d),
          f"{prefix}.layernorm.weight": rng.uniform(0.5, 1.5, d),
          f"{prefix}.layernorm.bias": rng.standard_normal(d),
          f"{prefix}.mlp.fc1.weight": rng.standard_normal((m, d)) * 0.1,
          f"{prefix}.mlp.fc1.bias": rng.standard_normal(m),
          f"{prefix}.mlp.fc2.weight": rng.standard_normal((d, m)) * 0.1,
          f"{prefix}.mlp.fc2.bias": rng.standard_normal(d)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    head = convert_siglip_map_head(sd)
    feats = rng.standard_normal((20, d)).astype(np.float32)
    want = jscorer.map_head_forward(head, jnp.asarray(feats), 4)
    got = tscorer.map_head_forward(
        convert.siglip_map_head_from_jax(_np_tree(head), device="cpu"),
        torch.as_tensor(feats), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mmr_and_clients_are_the_same_code():
    rng = np.random.default_rng(5)
    embs = rng.standard_normal((12, 8))
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    q = rng.standard_normal(8)
    for k, lam in ((4, 0.5), (12, 0.2), (3, 0.9)):
        assert tmmr.mmr_select(embs, q, k, lam) == \
            jmmr.mmr_select(embs, q, k, lam)
    jj, tj = jclients.NoOpJudge(), tclients.NoOpJudge()
    assert tj.classify_qtype("q") == jj.classify_qtype("q")
    assert tj.summarize_frames(["a"]) == jj.summarize_frames(["a"])
    assert tj.eval_answer("q", "c", "a") == jj.eval_answer("q", "c", "a")
    assert tj.answer_from_global("q", "c") == jj.answer_from_global("q", "c")
    assert tclients.NoOpReflector().reflect() == \
        jclients.NoOpReflector().reflect()
    assert tclients._parse_json_blob('x {"score": 0.9} y') == {"score": 0.9}
    r, j = tclients.make_reflection_clients("")
    assert isinstance(r, tclients.NoOpReflector)
    assert isinstance(j, tclients.NoOpJudge)


@pytest.fixture(scope="module")
def bagels():
    jcfg = jb.BagelConfig(llm=jq.Qwen2MoTConfig(**LLM), **BAGEL)
    jp = jb.init_bagel(jax.random.PRNGKey(0), jcfg)
    jsig = j_init_siglip(jax.random.PRNGKey(1), JSiglipConfig(**SIGLIP))
    j = JInfer(jp, jcfg, JHashTokenizer(4090), siglip_params=jsig,
               siglip_cfg=JSiglipConfig(**SIGLIP), compute_dtype=jnp.float32)
    cfg = tb.BagelConfig(llm=tq.Qwen2MoTConfig(**LLM), **BAGEL)
    t = InterleaveInferencer(
        convert.bagel_from_jax(_np_tree(jp), cfg, device="cpu"), cfg,
        HashTokenizer(4090),
        siglip=convert.siglip_from_jax(_np_tree(jsig), SiglipConfig(**SIGLIP),
                                       device="cpu"),
        siglip_cfg=SiglipConfig(**SIGLIP), compute_dtype=torch.float32)
    return j, t


class _DynamicJudge:
    """The offline judge, but every question is 'dynamic'."""

    def __init__(self, base):
        self.base = base

    def classify_qtype(self, question):
        return {"qtype": "dynamic", "rationale": "test"}

    def __getattr__(self, name):
        return getattr(self.base, name)


@pytest.mark.parametrize("branch", ["static", "dynamic"])
def test_reflexion_trace_matches_jax(bagels, scorers, branch):
    """reflexion_answer_one on an 8-frame pool of 28x28 frames, 4 decode
    tokens, the offline clients: seed captions, SigLIP2 top-k rounds
    (static K = 4, 8, 16) or the MMR pyramid (dynamic 8 -> 4 -> 2), the
    fallback: the port's trace == JAX's."""
    jbagel, tbagel = bagels
    jsc, tsc = scorers
    pool = _pool(8, 7)
    kw = dict(pool_frames=8, max_think_token_n=4, dynamic_seq=(8, 4, 2))
    question = "what is the person holding?"

    def run(mod, clients, bagel, sc):
        refl, judge = clients.make_reflection_clients("")
        if branch == "dynamic":
            judge = _DynamicJudge(judge)
        return mod.reflexion_answer_one(
            "video1.mp4", question, bagel, refl, judge, sc,
            mod.ReflexionConfig(**kw), frames=pool)

    want = run(jrefl, jclients, jbagel, jsc)
    got = run(trefl, tclients, tbagel, tsc)
    assert got == want
    assert [r["K"] for r in got[1]["rounds"]] == \
        ([4, 8, 8] if branch == "static" else [8, 4, 2])


def test_eval_understanding_cli_on_cpu(tmp_path):
    """The port's CLI, --mock_weights --device cpu, on a seeded 10-frame
    64x64 video: the trace file with every key and three static rounds,
    and the summary JSON."""
    from univid_tpu_torch.cli import eval_understanding as cli
    from univid_tpu_torch.data.video_io import save_video

    vdir = tmp_path / "videos"
    frames = np.random.default_rng(0).integers(0, 256, (10, 64, 64, 3),
                                               dtype=np.uint8)
    save_video(frames, str(vdir / "video1.mp4"), fps=8)
    gt = vdir / "gt.json"
    gt.write_text(json.dumps([{"video_id": 1, "question": "what moves?",
                               "answer": "a ball"}]))
    out = tmp_path / "out"
    summary = cli.main([
        "--video_dir", str(vdir), "--gt_file", str(gt), "--output_dir",
        str(out), "--output_name", "batch1", "--id_from", "1", "--id_to",
        "1", "--mock_weights", "--device", "cpu", "--pool_frames", "6",
        "--max_think_token_n", "4", "--save_frames_root", "",
        "--deepseek_api_key", ""])
    assert summary["num_samples"] == 1
    trace = json.loads((out / "video1_reflexion.json").read_text())
    assert {"video", "question", "qtype_init", "global_caption", "rounds",
            "fallback", "qtype_final", "final_answer"} <= set(trace)
    assert [r["K"] for r in trace["rounds"]] == [4, 6, 6]
    assert json.loads((out / "batch1.json").read_text())["num_samples"] == 1


def test_cli_checkpoint_flags_fail_loudly(tmp_path):
    """--model_path at a dir without ema.safetensors, and --siglip_ckpt at
    an empty dir, raise (as the JAX CLI does) instead of falling back to
    random weights."""
    from univid_tpu_torch.cli import eval_understanding as cli
    base = ["--video_dir", str(tmp_path), "--gt_file", "x", "--output_dir",
            str(tmp_path), "--output_name", "b", "--id_from", "1",
            "--id_to", "1", "--device", "cpu"]
    with pytest.raises(FileNotFoundError):
        cli.load_models(cli.build_parser().parse_args(
            base + ["--model_path", str(tmp_path)]))
    with pytest.raises(KeyError):
        cli.load_models(cli.build_parser().parse_args(
            base + ["--mock_weights", "--siglip_ckpt", str(tmp_path)]))