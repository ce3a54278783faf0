"""The port's training data feeds against univid_tpu's, on the CPU: the host
ops, the transforms and augmentations, BAGEL's data adapters, the registry,
the packer fed by the registry's groups, and the OpenVid dataset.

The same inputs (numpy from a seed, files written to tmp_path) and the same
seeds go through both packages; both draw from the same sources of
randomness (random.Random instances, the `random` module, numpy's global
generator), so everything is held bit for bit: arrays equal, token ids,
plans and records equal. JAX's host ops take their numpy path here (its
ctypes library switched off inside each test by `jax_numpy_host_ops`): the
C++ library rounds bilinear weights in its own order. The one tolerance is
against that library, in one test: tests/test_native.py's.
"""

import csv
import io
import json
import math
import os
import random

import numpy as np
import pytest

import univid_tpu.native as jnative
from univid_tpu.data import datasets as jds
from univid_tpu.data import interleave_datasets as jid
from univid_tpu.data import openvid as jov
from univid_tpu.data import packed_dataset as jpd
from univid_tpu.data import registry as jreg
from univid_tpu.data import transforms as jtf
from univid_tpu_torch import native as tnative
from univid_tpu_torch.data import datasets as tds
from univid_tpu_torch.data import interleave_datasets as tid
from univid_tpu_torch.data import openvid as tov
from univid_tpu_torch.data import packed_dataset as tpd
from univid_tpu_torch.data import registry as treg
from univid_tpu_torch.data import transforms as ttf
from univid_tpu_torch.data.video_io import save_video


class _Tok:
    def encode(self, s):
        return [ord(c) % 100 + 2 for c in s][:12]


def latent_fn(pix):
    """Stub VAE, the same numpy function on both sides: 8x downsample by
    striding, 4 channels."""
    return np.ascontiguousarray(pix[::8, ::8, :1].repeat(4, -1)) \
        .astype(np.float32)


@pytest.fixture(autouse=True)
def jax_numpy_host_ops(monkeypatch):
    """univid_tpu.native's numpy fallback inside the test (its `_load`
    returns None); nothing of the JAX package changes outside it."""
    monkeypatch.setattr(jnative, "_load", lambda: None)


def _same(got, want, path="value"):
    """Equal element by element: arrays bit for bit with the same dtype,
    NaN where NaN, everything else ==."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), path
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif hasattr(want, "shape"):   # numpy, or a jax array
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, \
            (path, type(got), getattr(got, "dtype", None), want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), (path, got)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# host ops
# ---------------------------------------------------------------------------


def _host_cases():
    rng = np.random.default_rng(0)
    f32 = rng.random((37, 53, 3), np.float32)
    u8 = rng.integers(0, 256, (41, 29, 3), np.uint8)
    small = rng.random((16, 16, 1), np.float32)
    patches = rng.random((42, 28, 5), np.float32)
    return [
        ("resize f32", lambda m: m.resize_bilinear(f32, 24, 64)),
        # on the [-1, 1] scale of tests/test_native.py's u8 case
        ("resize u8", lambda m: m.resize_bilinear(u8, 56, 56)
         / np.float32(127.5) - np.float32(1.0)),
        ("resize up", lambda m: m.resize_bilinear(small, 33, 47)),
        ("resize identity", lambda m: m.resize_bilinear(small, 16, 16)),
        ("patchify", lambda m: m.patchify(patches, 14)),
        ("patchify 7", lambda m: m.patchify(patches, 7)),
    ]


def test_host_ops_equal_jax_numpy_path():
    """Bit-equal to univid_tpu.native's numpy fallback, and the packer's
    patchify is this one, equal to JAX's patchify_np."""
    for name, op in _host_cases():
        _same(op(tnative), op(jnative), name)
    img = np.random.default_rng(5).random((28, 28, 3), np.float32)
    assert tpd.patchify is tnative.patchify
    _same(tnative.patchify(img, 14), jpd.patchify_np(img, 14))


def test_host_ops_within_native_library_tolerances(monkeypatch):
    """Against JAX's C++ host ops (libuv_host.so, built from
    native/host_ops.cc): tests/test_native.py's tolerances, resize 1e-5
    (u8 input, on the [-1, 1] scale: 1e-4), patchify equal."""
    monkeypatch.undo()   # JAX's ctypes library back on
    if not jnative.available():
        assert jnative.build(verbose=True), "g++ build of host_ops.cc"
    tol = {"resize u8": 1e-4, "patchify": 0.0, "patchify 7": 0.0}
    for name, op in _host_cases():
        np.testing.assert_allclose(op(tnative), op(jnative),
                                   atol=tol.get(name, 1e-5), rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wh", [(1920, 1080), (333, 515), (4000, 500),
                                (100, 100), (224, 224), (2048, 2048)])
@pytest.mark.parametrize("cfg", [(1024, 512, 16), (980, 224, 14)])
def test_resize_matches_jax(wh, cfg):
    """tests/test_transforms.py's cases: the target size and the resized
    image (a seeded float image of that size), bit for bit."""
    w, h = wh
    args = (*cfg, 14 * 14 * 9 * 1024)
    tr, jr = ttf.MaxLongEdgeMinShortEdgeResize(*args), \
        jtf.MaxLongEdgeMinShortEdgeResize(*args)
    assert tr.target_size(w, h) == jr.target_size(w, h)
    assert tr.target_size(w, h, img_num=3) == jr.target_size(w, h, img_num=3)
    img = np.random.default_rng(w + h).random((h, w, 3), np.float32)
    _same(tr(img), jr(img))


def test_image_transform_matches_jax():
    """ImageTransform on uint8 and float images, the two tower transforms
    and img_num > 1, bit for bit."""
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (515, 333, 3), np.uint8)
    f = rng.random((100, 700, 3)).astype(np.float32)
    for make in ("vae_transform", "vit_transform"):
        t, j = getattr(ttf, make)(), getattr(jtf, make)()
        _same(t(u8), j(u8), make)
        _same(t(f, img_num=2), j(f, img_num=2), make)
    t, j = ttf.ImageTransform(56, 28, 14), jtf.ImageTransform(56, 28, 14)
    _same(t(u8[:40, :30]), j(u8[:40, :30]))


AUGMENTATIONS = {
    "decolorization": lambda m, img, rng: m.decolorization(img),
    "downscale": lambda m, img, rng: m.downscale(img, 0.37),
    "crop": lambda m, img, rng: m.crop(img, (16, 12), rng=rng),
    "motion_blur": lambda m, img, rng: m.motion_blur(img, kernel_size=5,
                                                     angle=30.0),
    "shuffle_patch": lambda m, img, rng: m.shuffle_patch(img, (2, 3),
                                                         gap_size=2, rng=rng),
    "inpainting": lambda m, img, rng: m.inpainting(img, (4, 4),
                                                   blank_ratio=0.3, rng=rng),
}


@pytest.mark.parametrize("aug", sorted(AUGMENTATIONS))
def test_augmentation_matches_jax(aug):
    """Each corruption augmentation on uint8 and float images, with a seeded
    random.Random and with the `random` module (seeded), bit for bit."""
    fn = AUGMENTATIONS[aug]
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 255, (64, 48, 3), np.uint8),
                rng.random((64, 48, 3)).astype(np.float32)):
        for seed in (0, 7):
            _same(fn(ttf, img, random.Random(seed)),
                  fn(jtf, img, random.Random(seed)), f"{aug} {seed}")
        random.seed(11)
        got = fn(ttf, img, None)
        random.seed(11)
        _same(got, fn(jtf, img, None), f"{aug} random module")


# ---------------------------------------------------------------------------
# BAGEL's data adapters
# ---------------------------------------------------------------------------


FRAME_CASES = {
    "rand": dict(num_frames=4, vlen=16, sample="rand"),
    "rand_many": dict(num_frames=7, vlen=100, sample="rand"),
    "middle": dict(num_frames=4, vlen=16, sample="middle"),
    "fix_start": dict(num_frames=4, vlen=16, sample="rand", fix_start=1),
    "short_padded": dict(num_frames=6, vlen=3, sample="middle"),
    "fps": dict(num_frames=0, vlen=30, sample="fps0.5", input_fps=1,
                max_num_frames=8),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_get_frame_indices_matches_jax(case):
    """Every mode, with a seeded random.Random and the seeded `random`
    module."""
    kw = FRAME_CASES[case]
    assert tds.get_frame_indices(**kw, rng=random.Random(3)) == \
        jds.get_frame_indices(**kw, rng=random.Random(3))
    random.seed(4)
    got = tds.get_frame_indices(**kw)
    random.seed(4)
    assert got == jds.get_frame_indices(**kw)


def _clip(path, n, h, w, seed):
    frames = np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                  np.uint8)
    save_video(frames, str(path), fps=8)
    return frames


def test_frame_sampler_matches_jax(tmp_path):
    """A video file and a directory of frames; numpy's global generator
    (the frame count) and a random.Random (the indices) seeded alike."""
    from PIL import Image

    _clip(tmp_path / "v.mp4", 12, 32, 32, 0)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(10):
        Image.fromarray(np.full((16, 24, 3), 20 * i, np.uint8)).save(
            str(frames_dir / f"{i:03d}.png"))
    for path in (str(tmp_path / "v.mp4"), str(frames_dir) + "/"):
        for kw in (dict(max_num_frames=8, min_num_frames=3),
                   dict(max_num_frames=-1), dict(max_num_frames=6,
                                                 sample="middle")):
            np.random.seed(5)
            got = tds.FrameSampler(**kw, rng=random.Random(1))(path)
            np.random.seed(5)
            _same(got, jds.FrameSampler(**kw, rng=random.Random(1))(path),
                  f"{path} {kw}")


def test_change_format_matches_jax():
    convs = [
        [{"from": "human", "value": "look <image> and <image> now"},
         {"from": "gpt", "value": "an answer"}],
        [{"from": "human", "value": "<image><image><image> three"},
         {"from": "gpt", "value": "yes"},
         {"from": "human", "value": "no image here"},
         {"from": "gpt", "value": "fine"}],
        [{"from": "system", "value": "ignored"},
         {"from": "human", "value": "  <image>  "}],
    ]
    for c in convs:
        for n in (0, 1, 2, 3):
            assert tds._change_format(c, n) == jds._change_format(c, n)


def _images(d, names, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i, name in enumerate(names):
        h, w = 30 + 7 * i, 40 + 5 * i
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            str(d / name))


def _sft_files(tmp_path):
    """Two JSONL files: single and multi image rows, a video row, a row
    without a gpt turn (skipped), a row whose image is absent (skipped)."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir(exist_ok=True)
    _images(img_dir, ["a.png", "b.png", "c.png"])
    _clip(img_dir / "v.mp4", 10, 28, 28, 3)
    rows = [
        {"image": "a.png", "conversations": [
            {"from": "human", "value": "<image> what is this?"},
            {"from": "gpt", "value": "a noisy square"}]},
        {"image": ["b.png", "c.png"], "conversations": [
            {"from": "human", "value": "<image> then <image>, compare"},
            {"from": "gpt", "value": "they differ"}]},
        {"video": "v.mp4", "conversations": [
            {"from": "human", "value": "<video> what moves?"},
            {"from": "gpt", "value": "nothing much"}]},
        {"image": "a.png", "conversations": [
            {"from": "human", "value": "<image> hi"}]},
        {"image": "absent.png", "conversations": [
            {"from": "human", "value": "<image> ?"},
            {"from": "gpt", "value": "never seen"}]},
        {"conversations": [{"from": "human", "value": "text only"},
                           {"from": "gpt", "value": "a reply"}]},
    ]
    paths = []
    for k, part in enumerate((rows[:3], rows[3:])):
        p = tmp_path / f"sft{k}.jsonl"
        with open(p, "w") as f:
            for r in part:
                f.write(json.dumps(r) + "\n")
        paths.append(str(p))
    return paths, [str(img_dir)] * 2


@pytest.mark.parametrize("variant", ["plain", "shuffled_cut"])
def test_sft_jsonl_matches_jax(tmp_path, variant):
    paths, dirs = _sft_files(tmp_path)
    kw = dict(shuffle_lines=True, shuffle_seed=3, num_used_data=[3, 2]) \
        if variant == "shuffled_cut" else {}

    def run(m, tf):
        np.random.seed(9)
        return list(m.SftJSONLIterableDataset(
            paths, dirs, transform=tf.ImageTransform(56, 28, 14),
            tokenizer=_Tok(), frame_sampler=m.FrameSampler(
                max_num_frames=4, min_num_frames=2, rng=random.Random(2)),
            **kw))

    got, want = run(tds, ttf), run(jds, jtf)
    assert len(want) >= 2
    _same(got, want)


def _t2i_records(tmp_path):
    from PIL import Image

    _images(tmp_path, ["p.png", "q.png"], seed=4)
    recs = [{"image": "p.png", "captions": {"a": "a red thing",
                                            "b": "something red"}},
            {"image": "missing.png", "captions": {"a": "skipped"}},
            {"image": "q.png", "captions": json.dumps({"s": "q caption"})},
            {"image": "p.png", "captions": {}}]
    buf = io.BytesIO()
    Image.fromarray(np.full((40, 24, 3), 90, np.uint8)).save(buf, "PNG")
    recs.append({"image": buf.getvalue(), "captions": {"x": "from bytes"}})
    return recs


@pytest.mark.parametrize("source", ["jsonl", "parquet"])
def test_t2i_matches_jax(tmp_path, source):
    """From JSONL (paths, a missing image, a JSON-string caption, no
    caption) and from parquet (two row groups of image bytes), with the
    caption drawn by a seeded random.Random."""
    kw = dict(tokenizer=_Tok(), latent_fn=latent_fn, image_dir=str(tmp_path))
    if source == "jsonl":
        recs = [r for r in _t2i_records(tmp_path)
                if not isinstance(r["image"], bytes)]
        jp = tmp_path / "t2i.jsonl"
        with open(jp, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")

        def run(m, tf, seed):
            return list(m.T2IIterableDataset.from_jsonl(
                str(jp), transform=tf.ImageTransform(32, 16, 16),
                rng=random.Random(seed), **kw))
    else:
        import pyarrow as pa
        import pyarrow.parquet as pq
        from PIL import Image

        blobs = []
        for v in (90, 160, 30):
            buf = io.BytesIO()
            Image.fromarray(np.full((32, 48, 3), v, np.uint8)).save(buf,
                                                                   "PNG")
            blobs.append(buf.getvalue())
        pp = str(tmp_path / "shard.parquet")
        pq.write_table(pa.table({
            "image": blobs,
            "captions": [json.dumps({"s": "grey", "l": "a grey square"}),
                         json.dumps({"s": "light"}),
                         json.dumps({"s": "dark", "l": "a dark one"})]}),
            pp, row_group_size=2)

        def run(m, tf, seed):
            return list(m.T2IIterableDataset.from_parquet(
                [pp], transform=tf.ImageTransform(32, 16, 16),
                rng=random.Random(seed), **kw))
    for seed in (0, 1):
        got, want = run(tds, ttf, seed), run(jds, jtf, seed)
        assert len(want) >= 3
        _same(got, want)


def _edit_records(n_rows=3):
    rng = np.random.default_rng(6)
    return [{"image_list": [rng.random((32 + 16 * (i % 2), 32, 3))
                            .astype(np.float32) for _ in range(2 + r)],
             "instruction_list": [[f"step {k} a", f"step {k} b"]
                                  for k in range(1 + r)]}
            for r, i in zip(range(n_rows), range(n_rows))] + \
        [{"image_list": [], "instruction_list": []}]   # malformed: skipped


def test_unified_edit_and_video_builder_match_jax(capsys):
    """Editing chains of 2-4 images and a malformed row (printed and
    skipped), over four seeds of the row draws; then the video builder."""
    recs = _edit_records()
    for seed in range(4):
        def run(m, tf):
            return list(m.UnifiedEditIterableDataset(
                recs, tokenizer=_Tok(),
                transform=tf.ImageTransform(32, 16, 16),
                vit_transform=tf.ImageTransform(28, 14, 14),
                latent_fn=latent_fn, rng=random.Random(seed)))
        got, want = run(tid, ttf), run(jid, jtf)
        assert len(want) == 3
        _same(got, want, f"seed {seed}")
    out = capsys.readouterr().out
    assert "in unified_edit row#3, skipping" in out

    images = recs[2]["image_list"]
    for need_loss in (True, False):
        def build(m, tf):
            b = m.InterleavedBuilder(_Tok(), tf.ImageTransform(32, 16, 16),
                                     tf.ImageTransform(28, 14, 14),
                                     latent_fn)
            d = b.add_text(b.init_data(), "a clip", need_loss=False)
            return b.add_video(d, images, [0, 4, 9, 11], need_loss=need_loss,
                               need_vae=not need_loss)
        _same(build(tid, ttf), build(jid, jtf))


def test_data_status_resume_and_rank_shards_match_jax(tmp_path):
    """data_status resumes after the last consumed row; world_size 2 shards
    the rows by the epoch shuffle: the same rows on both sides."""
    recs = [r for r in _t2i_records(tmp_path)
            if not isinstance(r["image"], bytes)]
    for status in (None, 0, 2):
        for rank in (0, 1):
            def run(m, tf):
                return list(m.T2IIterableDataset(
                    recs * 2, transform=tf.ImageTransform(32, 16, 16),
                    tokenizer=_Tok(), latent_fn=latent_fn,
                    image_dir=str(tmp_path), local_rank=rank, world_size=2,
                    data_status=status))
            _same(run(tds, ttf), run(jds, jtf), f"{status} {rank}")


# ---------------------------------------------------------------------------
# the registry and the pack
# ---------------------------------------------------------------------------


REGISTRY_YAML = """
t2i_pretrain:
  dataset_names:
  - toy_t2i
  - toy_t2i_b
  num_used_data: [2, 1]
  image_transform_args:
    image_stride: 16
    max_image_size: 32
    min_image_size: 16
  is_mandatory: true
  weight: 2
vlm_sft:
  dataset_names:
  - toy_vlm
  image_transform_args:
    image_stride: 14
    max_image_size: 56
    min_image_size: 28
  frame_sampler_args:
    max_num_frames: 4
    min_num_frames: 2
  is_mandatory: false
  weight: 1
unified_edit:
  dataset_names:
  - toy_edit
  image_transform_args:
    image_stride: 16
    max_image_size: 32
    min_image_size: 16
  vit_image_transform_args:
    image_stride: 14
    max_image_size: 28
    min_image_size: 14
  weight: 1.5
"""


def _png_bytes(shape, seed):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, shape, np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _registry_setup(tmp_path):
    import yaml

    paths, dirs = _sft_files(tmp_path)
    # the registry's t2i records carry their image bytes (it sets no
    # image_dir)
    recs = [{"image": _png_bytes((32 + 8 * (i % 3), 32, 3), i),
             "captions": {"s": f"picture {i}", "l": f"a long caption {i}"}}
            for i in range(6)]
    info = {
        "t2i_pretrain": {"toy_t2i": {"records": recs},
                         "toy_t2i_b": {"records": recs[::-1]}},
        "vlm_sft": {"toy_vlm": {"jsonl_path": paths[0],
                                "image_dir": dirs[0]}},
        "unified_edit": {"toy_edit": {"records": _edit_records()}},
    }
    cfg_path = tmp_path / "data.yaml"
    cfg_path.write_text(REGISTRY_YAML)
    return yaml.safe_load(REGISTRY_YAML), str(cfg_path), info


@pytest.mark.parametrize("config", ["yaml", "dict"])
def test_load_data_groups_matches_jax(tmp_path, config):
    """Three groups from a YAML file and from the same dict: weights,
    mandatory flags and every group's samples equal."""
    as_dict, path, info = _registry_setup(tmp_path)
    cfg = path if config == "yaml" else as_dict
    tg = treg.load_data_groups(cfg, _Tok(), info, latent_fn=latent_fn,
                               seed=3)
    jg = jreg.load_data_groups(cfg, _Tok(), info, latent_fn=latent_fn,
                               seed=3)
    assert [(w, m) for _, w, m in tg] == [(w, m) for _, w, m in jg] == \
        [(2.0, True), (1.0, False), (1.5, False)]
    for (tf_, _, _), (jf_, _, _) in zip(tg, jg):
        np.random.seed(1)
        got = list(tf_())
        np.random.seed(1)
        _same(got, list(jf_()))


def test_load_data_groups_errors_match_jax():
    """An unknown group, a dataset without info and a short num_used_data
    raise the same errors with the same messages."""
    cases = [({"nope": {"dataset_names": ["x"]}}, {}),
             ({"t2i_pretrain": {"dataset_names": ["absent"]}}, {}),
             ({"t2i_pretrain": {"dataset_names": ["a", "b"],
                                "num_used_data": [1]}},
              {"t2i_pretrain": {"a": {"records": []}, "b": {"records": []}}})]
    for cfg, info in cases:
        errs = []
        for m in (treg, jreg):
            with pytest.raises((KeyError, ValueError)) as e:
                m.load_data_groups(cfg, _Tok(), info)
            errs.append((type(e.value), str(e.value)))
        assert errs[0] == errs[1]


def test_registry_fed_pack_matches_jax(tmp_path):
    """The slice's data path end to end: the port's PackedDataset over the
    port's registry groups gives the same to_batch arrays, pack for pack,
    as JAX's PackedDataset over JAX's groups (numpy's global generator, the
    flow timesteps' source, seeded alike)."""
    as_dict, _, info = _registry_setup(tmp_path)
    # every t2i record, so the mandatory group outlasts a few packs
    as_dict["t2i_pretrain"].pop("num_used_data")
    pcfg = dict(max_latent_size=8, bos_token_id=190, eos_token_id=191,
                start_of_image=192, end_of_image=193)

    def packs(reg, pd):
        groups = reg.load_data_groups(as_dict, _Tok(), info,
                                      latent_fn=latent_fn, seed=2)
        np.random.seed(0)
        return list(pd.PackedDataset(
            groups, data_config=pd.PackedDataConfig(**pcfg),
            expected_num_tokens=64, max_num_tokens=128,
            max_num_tokens_per_sample=120, seed=4))

    got, want = packs(treg, tpd), packs(jreg, jpd)
    assert len(want) >= 3
    assert any("packed_vit_patches" in b and "packed_latent_clean" in b
               for b in want)
    _same(got, want)


# ---------------------------------------------------------------------------
# OpenVid
# ---------------------------------------------------------------------------

HEADER = ["video", "caption", "aesthetic score", "motion score",
          "temporal consistency score", "seconds"]


def _csv(path, rows, header=HEADER):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _openvid_case(tmp_path, case):
    """(video dir, CSV path, video_size, video_length) of one case."""
    vids = tmp_path / "videos"
    vids.mkdir()
    size, length = (32, 32), 6
    n, hw = 8, (32, 32)
    if case == "short_clip_padded":
        n = 3
    if case == "resize":
        hw, size = (40, 48), (24, 20)
    for i in range(3):
        _clip(vids / f"vid{i}.mp4", n, *hw, seed=10 + i)
    good = "a lovely long caption about a dog"
    rows = {
        "no_csv": None,
        "filter_csv": [["vid0.mp4", good, 5.0, 4.0, 0.9, 5.0],
                       ["vid1.mp4", "too low aesthetic quality sample",
                        2.0, 4.0, 0.9, 5.0],
                       ["vid2.mp4", "short", 5.0, 4.0, 0.9, 5.0]],
        "nan_score": [["vid0.mp4", good, 5.0, "", 0.9, 5.0],
                      ["vid1.mp4", good + " 1", "nan", 4.0, 0.9, 5.0],
                      ["vid2.mp4", good + " 2", 4.5, 3.0, 0.8, 3]],
        "empty_caption": [["vid0.mp4", "", 5.0, 4.0, 0.9, 5.0],
                          ["vid1.mp4", "NA", 5.0, 4.0, 0.9, 5.0],
                          ["vid2.mp4", good, 5.0, 4.0, 0.9, 5.0]],
        "absent_file": [["vid9.mp4", good, 5.0, 4.0, 0.9, 5.0],
                        ["broken.mp4", good + " b", 5.0, 4.0, 0.9, 5.0],
                        ["vid1.mp4", good, 6.0, 5.0, 1.0, 7.5]],
        "no_video_column": [["vid0.mp4", good, 5.0, 4.0, 0.9, 5.0]],
        "duplicates": [["vid1.mp4", good, 5.0, 4.0, 0.9, 5.0]] * 3
                      + [["vid0.mp4", good, 5.0, 4.0, 0.9, 5.0]] * 2,
        "short_clip_padded": [["vid0.mp4", good, 5.0, 4.0, 0.9, 5.0]],
        "resize": [["vid2.mp4", good, 5.0, 4.0, 0.9, 5.0],
                   ["vid0.mp4", good, 5.0, 4.0, 0.9, 5.0]],
    }[case]
    csv_path = tmp_path / "data.csv"
    if case == "absent_file":   # a file that does not decode: zeros
        (vids / "broken.mp4").write_bytes(b"not a video at all")
    if case == "filter_csv":    # extra columns, typed as pandas types them
        _csv(csv_path, [r + [m, f] for r, m, f in zip(
            rows, ["pan", "", "static"], [121, 81, 100])],
             HEADER + ["camera motion", "frame"])
    elif case == "no_video_column":
        _csv(csv_path, rows, ["clip"] + HEADER[1:])
    elif rows is not None:
        _csv(csv_path, rows)
    return str(vids), str(csv_path), size, length


@pytest.mark.parametrize("case", [
    "no_csv", "filter_csv", "nan_score", "empty_caption", "absent_file",
    "no_video_column", "duplicates", "short_clip_padded", "resize"])
def test_openvid_matches_jax(tmp_path, case):
    """Records and every item (clip bit for bit, caption, quality scores)
    equal to JAX's OpenVidDataset, whose CSV goes through pandas."""
    vids, csv_path, size, length = _openvid_case(tmp_path, case)
    t = tov.OpenVidDataset(tov.OpenVidConfig(
        video_base_path=vids, csv_file=csv_path, video_size=size,
        video_length=length))
    j = jov.OpenVidDataset(jov.OpenVidConfig(
        video_base_path=vids, csv_file=csv_path, video_size=size,
        video_length=length))
    assert len(j) > 0
    _same(t.records, j.records, "records")
    for i in range(len(j)):
        got, want = t[i], j[i]
        assert got["video"].shape == (length, size[1], size[0], 3)
        _same(got, want, f"item {i}")
    if case == "absent_file":
        assert [r["video"] for r in t.records] == ["broken.mp4", "vid1.mp4"]
        assert not t[0]["video"].any() and t[1]["video"].any()
    if case == "short_clip_padded":   # the last frame repeated
        v = t[0]["video"]
        np.testing.assert_array_equal(v[3], v[2])
        np.testing.assert_array_equal(v[5], v[2])
