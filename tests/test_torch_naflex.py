"""The port's SigLIP2-NaFlex scorer (univid_tpu_torch/reflection/naflex.py)
against univid_tpu's, and against transformers' Siglip2Model.

  * the host side (the max-patches resize rule, the antialiased position
    grid resize, the patchify preprocessing) equals JAX's exactly;
  * random-init towers (JAX's init, through convert) and a small HF
    Siglip2Model's state dict (convert_naflex_checkpoint: JAX's leaves bit
    for bit) give emb_imgs, emb_text and rank_frames equal to JAX's at
    1e-5 (as tests/test_torch_reflection.py holds the so400m scorer), the
    same ranking, and HF's features at 2e-4 (as tests/test_naflex.py);
  * from_checkpoint on a save_pretrained directory reads the head counts
    from config.json; the QA CLI dispatches a `model_type: siglip2`
    directory to it and falls back to the LM tokenizer with a warning.
Text ids are in the vocabulary: emb_text wraps others by `% vocab_size`,
as JAX's does (a reference-side caveat, ROADMAP.md queue 3).
"""


import jax
import numpy as np
import pytest
import torch

from univid_tpu.reflection import naflex as jn
from univid_tpu_torch import convert
from univid_tpu_torch.reflection import naflex as tn

torch.set_num_threads(2)
VISION = dict(hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=4, patch_size=4, num_patches=16, max_num_patches=16)
TEXT = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_len=8, proj_dim=32)


class TinyTok:
    vocab_size = 128

    def encode(self, s):
        return [ord(c) % 127 + 1 for c in s][:8]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(n, seed, hw):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (*hw, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("hw", [(480, 832), (97, 53), (16, 1024),
                                (224, 224), (3, 7)])
def test_resize_rule_equals_jax(hw):
    assert tn.get_image_size_for_max_num_patches(hw[0], hw[1], 16, 256) \
        == jn.get_image_size_for_max_num_patches(hw[0], hw[1], 16, 256)


@pytest.mark.parametrize("target", [(4, 4), (7, 2), (2, 8), (16, 16),
                                    (31, 2), (1, 5)])
def test_pos_resize_equals_jax(target):
    grid = np.random.default_rng(0).normal(size=(16, 16, 8)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        tn.resize_positional_embeddings_np(grid, *target, 512),
        jn.resize_positional_embeddings_np(grid, *target, 512))


def test_preprocess_equals_jax():
    frames = _frames(2, 1, (37, 61)) + _frames(1, 2, (128, 16)) \
        + [np.random.default_rng(3).uniform(-1, 1, (20, 20, 3))
           .astype(np.float32)]
    for a, b in zip(tn.naflex_preprocess(frames, 4, 16),
                    jn.naflex_preprocess(frames, 4, 16)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def random_scorers():
    """(JAX scorer, port scorer) over JAX's random-init towers."""
    j = jn.Siglip2NaflexScorer(vision_cfg=jn.NaflexVisionConfig(**VISION),
                               text_cfg=jn.NaflexTextConfig(**TEXT),
                               tokenizer=TinyTok())
    vcfg = tn.NaflexVisionConfig(**VISION)
    tcfg = tn.NaflexTextConfig(**TEXT)
    t = tn.Siglip2NaflexScorer(
        vision_params=convert.naflex_vision_from_jax(
            _np_tree(j.vision_params), vcfg, device="cpu"),
        vision_cfg=vcfg,
        text_params=convert.naflex_text_from_jax(
            _np_tree(j.text_params), tcfg, device="cpu"),
        text_cfg=tcfg, tokenizer=TinyTok(), device="cpu")
    return j, t


def test_random_init_scorer_matches_jax(random_scorers):
    """Mixed aspect ratios in two batches: emb_imgs, emb_text (in-vocab
    ids) and rank_frames == JAX to 1e-5, the same top-k."""
    j, t = random_scorers
    assert t.compute_dtype == torch.float32
    frames = _frames(3, 4, (24, 36)) + _frames(2, 5, (50, 13))
    np.testing.assert_allclose(t.emb_imgs(frames, bs=3),
                               j.emb_imgs(frames, bs=3), atol=1e-5)
    np.testing.assert_allclose(t.emb_text("what happens?"),
                               j.emb_text("what happens?"), atol=1e-5)
    assert t.rank_frames(frames, "a cat", 3)[0] == \
        j.rank_frames(frames, "a cat", 3)[0]
    assert t.emb_imgs([]).shape == (0, 32)
    assert t.rank_frames([], "a cat", 3) == ([], [])


def test_emb_text_wraps_ids_as_jax(random_scorers):
    """Out-of-vocab ids wrap by `% vocab_size` on both sides (the
    reference-side alias kept, not fixed)."""
    j, t = random_scorers

    class Wide:
        vocab_size = 128

        def encode(self, s):
            return [5, 130, 300]

    j.tokenizer, t.tokenizer = Wide(), Wide()
    try:
        np.testing.assert_allclose(t.emb_text("x"), j.emb_text("x"),
                                   atol=1e-5)
    finally:
        j.tokenizer, t.tokenizer = TinyTok(), TinyTok()


def _tiny_hf_model():
    from transformers import Siglip2Config, Siglip2Model

    cfg = Siglip2Config(
        text_config={"vocab_size": 128, "hidden_size": 32,
                     "intermediate_size": 64, "num_hidden_layers": 2,
                     "num_attention_heads": 4,
                     "max_position_embeddings": 8, "projection_size": 32},
        vision_config={"hidden_size": 32, "intermediate_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 4,
                       "patch_size": 4, "num_patches": 16,
                       "num_channels": 3})
    torch.manual_seed(0)
    return Siglip2Model(cfg).eval()


@pytest.fixture(scope="module")
def hf_model():
    return _tiny_hf_model()


def test_converter_equals_jax_leaf_for_leaf(hf_model):
    """convert_naflex_checkpoint on the HF state dict == JAX's trees (the
    position grid fp32), and the same configs."""
    from test_torch_checkpoint import assert_same_module

    sd = {k: v.detach().clone() for k, v in hf_model.state_dict().items()}
    tv, tvc, tt, ttc = tn.convert_naflex_checkpoint(
        sd, vision_heads=4, text_heads=4, device="cpu")
    jv, jvc, jt, jtc = jn.convert_naflex_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, vision_heads=4,
        text_heads=4)
    assert tvc == tn.NaflexVisionConfig(**jvc.__dict__)
    assert ttc == tn.NaflexTextConfig(**jtc.__dict__)
    assert_same_module(tv, jv, "layers",
                       convert.naflex_vision_from_jax(_np_tree(jv), tvc,
                                                      device="cpu"))
    assert_same_module(tt, jt, "layers",
                       convert.naflex_text_from_jax(_np_tree(jt), ttc,
                                                    device="cpu"))
    bf = tn.convert_naflex_checkpoint(sd, torch.bfloat16, device="cpu")[0]
    assert bf.pos_embed.dtype == torch.float32
    assert bf.head.q.w.dtype == torch.bfloat16


def test_features_match_hf(hf_model):
    """Image features (the processor's own inputs) and text features
    (right padding, the mask as a key mask, the last token pooled) ==
    HF's Siglip2Model at 2e-4."""
    from transformers.models.siglip2.image_processing_siglip2 import \
        Siglip2ImageProcessor

    sd = dict(hf_model.state_dict())
    v, vcfg, t, tcfg = tn.convert_naflex_checkpoint(
        sd, vision_heads=4, text_heads=4, device="cpu")
    imgs = _frames(1, 2, (23, 41)) + _frames(1, 6, (64, 64))
    hf_in = Siglip2ImageProcessor(patch_size=4, max_num_patches=16) \
        .preprocess(imgs, return_tensors="pt")
    ids = np.array([[5, 9, 17, 3, 0, 0, 0, 0]], np.int64)
    with torch.no_grad():
        ref_img = hf_model.get_image_features(
            pixel_values=hf_in["pixel_values"],
            pixel_attention_mask=hf_in["pixel_attention_mask"],
            spatial_shapes=hf_in["spatial_shapes"]).numpy()
        ref_txt = hf_model.get_text_features(
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.from_numpy((ids != 0).astype(np.int64))
        ).numpy()
        px, shapes, lens = tn.naflex_preprocess(imgs, 4, 16)
        grid = v.pos_embed.numpy().reshape(4, 4, 32)
        pos = np.stack([tn.resize_positional_embeddings_np(grid, h, w, 16)
                        for h, w in shapes])
        got_img = tn.naflex_vision_forward(
            v, vcfg, torch.as_tensor(px), torch.as_tensor(pos),
            torch.as_tensor(lens)).numpy()
        got_txt = tn.naflex_text_forward(
            t, tcfg, torch.as_tensor(ids),
            kv_len=torch.tensor([4], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got_img, ref_img, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_txt, ref_txt, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def naflex_dir(hf_model, tmp_path_factory):
    path = tmp_path_factory.mktemp("siglip2_naflex")
    hf_model.save_pretrained(path, safe_serialization=True)
    return str(path)


def test_from_checkpoint_matches_jax_and_hf(naflex_dir, hf_model):
    """A save_pretrained dir: the head counts from config.json; emb_imgs,
    emb_text and rank_frames == JAX's from_checkpoint to 1e-5, and the
    rank order of HF's normalised cosine scores."""
    from transformers.models.siglip2.image_processing_siglip2 import \
        Siglip2ImageProcessor

    t = tn.Siglip2NaflexScorer.from_checkpoint(naflex_dir, TinyTok(),
                                               device="cpu")
    j = jn.Siglip2NaflexScorer.from_checkpoint(naflex_dir,
                                               tokenizer=TinyTok())
    assert t.vision_cfg.num_heads == 4 and t.text_cfg.num_heads == 4
    frames = _frames(6, 3, (31, 47)) + _frames(2, 7, (19, 33))
    np.testing.assert_allclose(t.emb_imgs(frames), j.emb_imgs(frames),
                               atol=1e-5)
    np.testing.assert_allclose(t.emb_text("a cat"), j.emb_text("a cat"),
                               atol=1e-5)
    idx, scores = t.rank_frames(frames, "a cat", topk=3)
    assert idx == j.rank_frames(frames, "a cat", topk=3)[0]
    assert scores == sorted(scores, reverse=True)

    hf_in = Siglip2ImageProcessor(patch_size=4, max_num_patches=16) \
        .preprocess(frames, return_tensors="pt")
    q = TinyTok().encode("a cat")
    ids = np.zeros((1, 8), np.int64)
    ids[0, :len(q)] = q
    with torch.no_grad():
        v = torch.nn.functional.normalize(hf_model.get_image_features(
            pixel_values=hf_in["pixel_values"],
            pixel_attention_mask=hf_in["pixel_attention_mask"],
            spatial_shapes=hf_in["spatial_shapes"]), dim=-1)
        tt = torch.nn.functional.normalize(hf_model.get_text_features(
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.from_numpy((ids != 0).astype(np.int64))),
            dim=-1)
        sims = (v @ tt.T).squeeze(-1).numpy()
    assert idx == np.argsort(-sims)[:3].tolist()
    np.testing.assert_allclose(scores, sims[idx], rtol=1e-3, atol=1e-3)


def test_reflexion_mmr_runs_over_the_naflex_scorer(random_scorers):
    from univid_tpu_torch.reflection.mmr import mmr_select

    _, t = random_scorers
    v = t.emb_imgs(_frames(8, 4, (24, 36)))
    q = t.emb_text("what happens?")
    assert v.shape == (8, 32) and q.shape == (1, 32)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, rtol=1e-4)
    assert len(mmr_select(v, q, 4, 0.5)) == 4


@pytest.mark.parametrize("model_type", ["siglip2", "siglip"])
def test_qa_cli_dispatches_siglip_ckpt(model_type, naflex_dir, tmp_path,
                                       capsys, monkeypatch):
    """--siglip_ckpt DIR: config.json's model_type 'siglip2' gives the
    NaFlex scorer, 'siglip' the fixed-resolution one (from a SigLIP dir);
    without tokenizer files the CLI warns and takes the LM's tokenizer,
    and the weights are converted once."""
    from test_torch_checkpoint import _write_siglip_dir
    from univid_tpu.models.bagel.siglip import SiglipConfig as JSig
    from univid_tpu.reflection.scorer import SiglipTextConfig as JText
    from univid_tpu_torch.cli import eval_understanding as cli
    from univid_tpu_torch.core import checkpoint as TC
    from univid_tpu_torch.reflection.scorer import Siglip2Scorer

    calls = []
    for mod, name in ((tn, "convert_naflex_checkpoint"),
                      (TC, "load_siglip2_checkpoint")):
        def counted(*a, _real=getattr(mod, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    path = naflex_dir
    if model_type == "siglip":
        path = str(tmp_path / "siglip")
        _write_siglip_dir(path, JSig(hidden_size=64, intermediate_size=128,
                                     num_layers=1, num_heads=1,
                                     patch_size=16, image_size=64),
                          JText(vocab_size=4096, hidden_size=64,
                                intermediate_size=128, num_layers=1,
                                num_heads=1, max_len=16, proj_dim=64))
    args = cli.build_parser().parse_args([
        "--video_dir", str(tmp_path), "--gt_file", "x", "--output_dir",
        str(tmp_path), "--output_name", "b", "--id_from", "1", "--id_to",
        "1", "--device", "cpu", "--mock_weights", "--siglip_ckpt", path])
    _, scorer = cli.load_models(args)
    want = tn.Siglip2NaflexScorer if model_type == "siglip2" \
        else Siglip2Scorer
    assert type(scorer) is want
    assert calls == (["convert_naflex_checkpoint"] if model_type ==
                     "siglip2" else ["load_siglip2_checkpoint"])
    assert "using the LM tokenizer" in capsys.readouterr().err
    assert scorer.tokenizer.vocab_size == 4090
    assert scorer.emb_text("what moves?").shape[0] == 1
