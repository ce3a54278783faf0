"""The port's SAM2 video segmenter against univid_tpu's on the CPU.

Both predictors run the same parameter tree (JAX's convert_sam2 of a
state dict drawn at the init's scale, converted by sam2_from_jax) on the same frames and clicks; JAX's steps record
each step's chosen mask slot. Held to:
the low-res logits of every frame within 1e-4 rel. L2, the chosen mask
slot equal, the binary masks equal wherever |logit| > 1e-3 (fp32
summation order only). Then the counterparts of tests/test_sam2.py on
the port: the fixed-capacity bank's key mask and ring staleness, the
bf16 path, the mask_fn adapter, the manifest pinned to
manifests/sam2_hiera_large.json, and the .pt loader against JAX's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univid_tpu.core import checkpoint as JC
from univid_tpu.core import manifest as JM
from univid_tpu.data.animate_preprocess import PoseMeta as JPoseMeta
from univid_tpu.models import sam2 as J
from univid_tpu.models.sam2 import predictor as JP
from univid_tpu.models.sam2 import sam_heads as JS
from univid_tpu_torch.convert import sam2_from_jax
from univid_tpu_torch.core import checkpoint as TC
from univid_tpu_torch.core import manifest as TM
from univid_tpu_torch.data.animate_preprocess import PoseMeta
from univid_tpu_torch.models import sam2 as T
from univid_tpu_torch.models.sam2 import predictor as TP
from univid_tpu_torch.models.sam2 import sam_heads as TS

torch.set_num_threads(2)

JCFG = J.tiny_sam2_config(64)
TCFG = T.tiny_sam2_config(64)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def hiera_l_widths(image_size=128):
    """Hiera-L's widths and heads (embed 144, 2 heads doubling, mem d 256,
    decoder heads d 32 / 16), depth cut to 5 blocks and 2 memory layers.
    Returns (JAX config, port config)."""
    def cfg(pkg):
        return pkg.Sam2Config(
            image_size=image_size,
            hiera=pkg.HieraConfig(stages=(1, 1, 2, 1),
                                  global_att_blocks=(3,)),
            head=pkg.SamHeadConfig(image_size=image_size,
                                   embedding_grid=image_size // 16),
            memory=pkg.MemoryConfig(num_layers=2,
                                    feat_size=image_size // 16))
    return cfg(J), cfg(T)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def init_sd(cfg, seed):
    """A published-layout state dict at its init's scale, numpy fp32:
    weights U(+-1/sqrt(fan_in)), norm gains 1 + N(0, 0.02^2), biases,
    position and no-memory embeddings N(0, 0.02^2), the random-Fourier
    matrix N(0, 1), the layer scales 1e-6."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in sorted(TM.sam2_manifest(cfg).items()):
        if k.endswith("gaussian_matrix"):
            v = rng.standard_normal(shape)
        elif k.endswith(".gamma"):
            v = np.full(shape, 1e-6)
        elif k.endswith(".weight") and len(shape) >= 2:
            lim = 1.0 / np.sqrt(np.prod(shape[1:]))
            v = rng.uniform(-lim, lim, shape)
        elif k.endswith(".weight"):
            v = 1.0 + 0.02 * rng.standard_normal(shape)
        else:
            v = 0.02 * rng.standard_normal(shape)
        out[k] = v.astype(np.float32)
    return out


def jax_params(jcfg, seed):
    """JAX's tree from its own converter (JAX's init_sam2 takes ~40 s to
    trace here)."""
    sd = init_sd(jcfg, seed)
    return JM.audited(sd, lambda s: JC.convert_sam2(s, jcfg, jnp.float32),
                      ignore=("sam_prompt_encoder.mask_downscaling.",))[0]


@pytest.fixture(scope="module")
def params():
    return jax_params(JCFG, 0)


@pytest.fixture(scope="module")
def tparams(params):
    return sam2_from_jax(np_tree(params), TCFG, device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(3)
    f = rng.randint(0, 60, (6, 48, 40, 3), np.uint8)
    # a bright moving square: something for the masks to latch onto
    for t in range(6):
        f[t, 8 + 2 * t: 24 + 2 * t, 6: 22] = 230
    return f


CLICKS = np.array([[14.0, 16.0], [18.0, 20.0]], np.float32)


@pytest.fixture(scope="module")
def jax_recorder():
    """JAX's predictor with its two steps jitted anew (fresh trace caches)
    around a select_masks that reports each step's chosen mask slot by a
    debug callback; every low-res logit map it returns is recorded too,
    in order. Module-wide, so that each step compiles once."""
    rec = {"slots": [], "low": []}
    select = JP.select_masks

    def recording_select(cfg, masks, iou, toks, multimask):
        best = jnp.argmax(iou[0, 1:]) + 1
        if not multimask:
            stab = JS._stability_score(masks[:, 0], cfg.stability_delta)[0]
            best = jnp.where(stab >= cfg.stability_thresh, 0, best)
        jax.debug.callback(lambda b: rec["slots"].append(int(b)), best,
                           ordered=True)
        return select(cfg, masks, iou, toks, multimask)

    to_video = JP.Sam2VideoPredictor._to_video_res

    def recording_to_video(self, state, low):
        rec["low"].append(np.array(low))
        return to_video(self, state, low)

    cond_step = JP._cond_frame_step.__wrapped__
    prop_step = JP._propagate_step.__wrapped__

    # new function objects: jit's trace cache is keyed on the function
    def cond(params, cfg, img, points, labels, multimask, binarize):
        return cond_step(params, cfg, img, points, labels, multimask,
                         binarize)

    def prop(params, cfg, img, t, bank):
        return prop_step(params, cfg, img, t, bank)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "select_masks", recording_select)
        mp.setattr(JP, "_cond_frame_step", jax.jit(
            cond, static_argnames=("cfg", "multimask", "binarize")))
        mp.setattr(JP, "_propagate_step", jax.jit(
            prop, static_argnames=("cfg",)))
        mp.setattr(JP.Sam2VideoPredictor, "_to_video_res",
                   recording_to_video)
        yield rec


@pytest.fixture
def jax_rec(jax_recorder):
    for v in jax_recorder.values():
        v.clear()
    return jax_recorder


def _run(pred, frames, clicks):
    """clicks: {frame: (points, labels)} -> (video-res logits [T, H, W],
    state)."""
    state = pred.init_state_v2(list(frames))
    for fi, (pts, lab) in clicks.items():
        pred.add_new_points(state, fi, 1, pts, lab)
    outs = list(pred.propagate_in_video(state))
    assert [t for t, _, _ in outs] == list(range(min(clicks), len(frames)))
    return np.stack([m[0, 0] for _, _, m in outs]), state


def _port_record(state, clicks):
    """The port's low-res logits and slots in JAX's recording order: the
    clicks' steps, then each frame as propagation yields it."""
    low = [state["cond"][fi]["mask"] for fi in clicks]
    slots = [state["cond"][fi]["slot"] for fi in clicks]
    for t in range(min(clicks), state["num_frames"]):
        if t in state["cond"]:
            low.append(state["cond"][t]["mask"])
        else:
            low.append(state["tracked"][t]["mask"])
            slots.append(state["tracked"][t]["slot"])
    return low, slots


def assert_logits_match(got, want, tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel < tol, rel
        sure = np.abs(w) > 1e-3
        np.testing.assert_array_equal(g[sure] > 0, w[sure] > 0)


CLICK_CASES = {
    "two_points": {0: (CLICKS, np.array([1, 1], np.int32))},
    "one_point_multimask": {0: (np.array([[20.0, 24.0]], np.float32),
                                np.array([1], np.int32))},
    "two_cond_frames": {0: (CLICKS, np.array([1, 1], np.int32)),
                        3: (CLICKS + 2.0, np.array([1, 0], np.int32))},
    "late_start": {2: (CLICKS, np.array([1, 1], np.int32))},
}


@pytest.mark.parametrize("case", sorted(CLICK_CASES))
def test_predictor_matches_jax(case, params, tparams, frames, jax_rec):
    clicks = CLICK_CASES[case]
    want_video, _ = _run(J.Sam2VideoPredictor(params, JCFG), frames, clicks)
    got_video, state = _run(T.Sam2VideoPredictor(tparams, TCFG), frames,
                            clicks)
    low, slots = _port_record(state, clicks)
    assert slots == jax_rec["slots"]
    assert_logits_match(low, jax_rec["low"])
    assert got_video.shape == (6 - min(clicks), 48, 40)
    assert np.isfinite(got_video).all()
    np.testing.assert_allclose(got_video, want_video, rtol=1e-4, atol=1e-4)


def test_hiera_l_widths_match_jax(jax_rec):
    """Hiera-L's widths and heads (embed 144, 2 heads doubling a stage,
    memory d 256, decoder heads of d 32 / 16), depth cut, at a 128 image
    (grid 8): one click frame and two propagated frames."""
    jcfg, tcfg = hiera_l_widths(128)
    params = jax_params(jcfg, 4)
    tparams = sam2_from_jax(np_tree(params), tcfg, device="cpu")
    rng = np.random.RandomState(8)
    f = rng.randint(0, 60, (3, 96, 80, 3), np.uint8)
    for t in range(3):
        f[t, 20 + 4 * t: 60 + 4 * t, 12: 44] = 230
    clicks = {0: (np.array([[28.0, 40.0], [30.0, 50.0]], np.float32),
                  np.array([1, 1], np.int32))}
    _run(J.Sam2VideoPredictor(params, jcfg), f, clicks)
    _, state = _run(T.Sam2VideoPredictor(tparams, tcfg), f, clicks)
    low, slots = _port_record(state, clicks)
    assert slots == jax_rec["slots"]
    assert_logits_match(low, jax_rec["low"])


def test_predictor_end_to_end(tparams, frames):
    pred = T.Sam2VideoPredictor(tparams, TCFG)
    state = pred.init_state_v2(list(frames))
    fi, ids, mask = pred.add_new_points(state, 0, 1, CLICKS,
                                        np.array([1, 1], np.int32))
    assert (fi, ids) == (0, [1])
    assert mask.shape == (1, 1, 48, 40)
    outs = list(pred.propagate_in_video(state))
    assert [t for t, _, _ in outs] == list(range(6))
    for _, oids, m in outs:
        assert oids == [1] and m.shape == (1, 1, 48, 40)
        assert np.isfinite(m).all()
    # frame 0 is the conditioning frame: propagation returns its stored
    # mask exactly
    np.testing.assert_array_equal(outs[0][2], mask)
    with pytest.raises(NotImplementedError, match="single-object"):
        pred.add_new_points(state, 1, 2, CLICKS, np.array([1, 1]))


def test_propagation_deterministic(tparams, frames):
    pred = T.Sam2VideoPredictor(tparams, TCFG)
    clicks = CLICK_CASES["two_points"]
    np.testing.assert_array_equal(_run(pred, frames, clicks)[0],
                                  _run(pred, frames, clicks)[0])


def _step_inputs(tparams, frames):
    pred = T.Sam2VideoPredictor(tparams, TCFG)
    state = pred.init_state_v2(list(frames))
    pred.add_new_points(state, 0, 1, CLICKS, np.array([1, 1], np.int32))
    bank = pred.make_bank(state, [0])
    img = torch.from_numpy(state["images"][1][None])
    return pred, bank, img


def test_key_mask_hides_invalid_bank_slots(tparams, frames):
    """Garbage in INVALID bank slots must not change the output: the
    fixed-capacity bank is only correct if the key mask really masks."""
    pred, bank, img = _step_inputs(tparams, frames)
    with torch.no_grad():
        clean = TP.propagate_step(tparams, TCFG, img, 1, bank)
        garbage = dict(bank)
        for k, valid in (("cond_mem", "cond_valid"),
                         ("cond_ptrs", "cond_valid"),
                         ("ring_mem", "ring_valid"), ("ptrs", "ptr_valid")):
            arr = bank[k].clone()
            arr[~bank[valid]] = 1e4
            garbage[k] = arr
        dirty = TP.propagate_step(tparams, TCFG, img, 1, garbage)
    for a, b in zip(clean, dirty):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_ring_staleness(tparams, frames):
    """A ring entry older than ring_slots frames is masked out at read
    time: stepping at t and at t + ring_slots + ptr_ring_slots with the
    same single ring entry gives different conditioning, and the stale
    read equals an empty-ring read. push leaves its input bank as it
    was."""
    pred, bank, img = _step_inputs(tparams, frames)
    ring_before = bank["ring_mem"].clone()
    with torch.no_grad():
        _, ptr, mem, _, _ = TP.propagate_step(tparams, TCFG, img, 1, bank)
        bank2 = pred.push(bank, 1, mem[0], ptr[0])
        torch.testing.assert_close(bank["ring_mem"], ring_before)
        assert bool(bank2["ring_valid"][1]) and int(bank2["ring_t"][1]) == 1
        fresh = TP.propagate_step(tparams, TCFG, img, 2, bank2)[0]
        stale_t = 2 + TCFG.ring_slots + TCFG.ptr_ring_slots
        stale = TP.propagate_step(tparams, TCFG, img, stale_t, bank2)[0]
        empty = TP.propagate_step(tparams, TCFG, img, stale_t, bank)[0]
    torch.testing.assert_close(stale, empty, atol=1e-5, rtol=0)
    assert not torch.allclose(fresh, stale)


def test_bank_memory_layout_matches_jax(params, tparams, frames):
    """The memory cross-attention's keys for one query frame equal JAX's:
    the conditioning slots, the ring with its time encodings, the pointer
    tokens and the key mask (the 57,436-key bank at 1024 has this
    layout)."""
    pred, bank, img = _step_inputs(tparams, frames)
    with torch.no_grad():
        _, ptr, mem, _, _ = TP.propagate_step(tparams, TCFG, img, 1, bank)
        bank2 = pred.push(bank, 1, mem[0], ptr[0])
        memory, pos, key_mask, n_ptr = TP.bank_memory(tparams, TCFG, 3,
                                                      bank2)
    g = TCFG.grid
    n = g * g
    c, r, pr = TCFG.max_cond_frames, TCFG.ring_slots, TCFG.ptr_ring_slots
    assert memory.shape == (1, (c + r) * n + (c + pr) * TCFG.ptr_chunks,
                            TCFG.memory.mem_dim)
    assert n_ptr == (c + pr) * TCFG.ptr_chunks
    want = np.zeros(memory.shape[1], bool)
    want[:n] = True                                    # cond slot 0
    want[(c + 1) * n: (c + 2) * n] = True              # ring slot 1 (t=1)
    ptr0 = (c + r) * n
    want[ptr0: ptr0 + TCFG.ptr_chunks] = True          # cond pointer 0
    want[ptr0 + (c + 1) * TCFG.ptr_chunks:
         ptr0 + (c + 2) * TCFG.ptr_chunks] = True      # ring pointer 1
    np.testing.assert_array_equal(key_mask.numpy(), want)
    tpos = np.asarray(params["maskmem_tpos_enc"])
    # ring slot 1 holds frame 1, 2 frames before t = 3: tpos index 1
    np.testing.assert_allclose(
        (memory[0, (c + 1) * n: (c + 2) * n]
         - bank2["ring_mem"][1]).numpy(),
        np.broadcast_to(tpos[1], (n, TCFG.memory.mem_dim)), atol=1e-6)


def test_bf16_compute_path(tparams, frames, monkeypatch):
    """compute_dtype=bf16 (bf16 products, fp32 softmax / norm islands)
    stays finite and close to the fp32 masks: > 98% of each frame's mask
    pixels agree wherever both runs chose the same mask slot. bf16
    rounding moves a logit by ~1%, so the single-mask head's stability
    choice (slot 0 while >= 98% of its pixels clear +-0.05) may flip only
    where the fp32 score lies within 0.01 of the threshold: two pixels of
    a ~200-pixel mask at the 16 x 16 low-res grid."""
    stab = []
    select = TP.select_masks

    def recording_select(cfg, masks, iou, toks, multimask):
        if not multimask:
            stab.append(float(TS.stability_score(
                masks[:, 0].float(), cfg.stability_delta)[0]))
        return select(cfg, masks, iou, toks, multimask)

    monkeypatch.setattr(TP, "select_masks", recording_select)
    clicks = CLICK_CASES["two_points"]
    m32, s32 = _run(T.Sam2VideoPredictor(tparams, TCFG), frames, clicks)
    stab32 = dict(zip(range(6), stab))
    m16, s16 = _run(T.Sam2VideoPredictor(tparams, dataclasses.replace(
        TCFG, compute_dtype=torch.bfloat16)), frames, clicks)
    assert np.isfinite(m16).all()
    slots32 = _port_record(s32, clicks)[1]
    slots16 = _port_record(s16, clicks)[1]
    # one slot for the click step, then frames 1..5
    for i, (a, b) in enumerate(zip(slots32, slots16)):
        if a == b:
            agree = np.mean((m16[i] > 0) == (m32[i] > 0))
            assert agree > 0.98, f"frame {i}: bf16 agreement {agree:.3f}"
        else:
            assert abs(stab32[i] - TCFG.head.stability_thresh) < 0.01, \
                (i, a, b, stab32[i])


def test_fill_small_holes_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((32, 32)).astype(np.float32) + 0.8
    logits[4:6, 4:6] = -1.0          # 4-px hole -> filled
    logits[10:14, 10:14] = -1.0      # 16-px hole -> kept
    for area in (0, 1, 8, 20):
        np.testing.assert_array_equal(
            TP.fill_small_holes(logits, area),
            JP._fill_small_holes(logits, area))
    out = TP.fill_small_holes(logits, 8)
    assert (out[4:6, 4:6] == 0.1).all() and (out[10:14, 10:14] == -1).all()


def test_normalize_frames_matches_jax(frames):
    got = TP.normalize_frames(TCFG, list(frames))
    want = JP._normalize_frames(JCFG, list(frames))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _mask_fn_inputs():
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 60, (12, 48, 40, 3), np.uint8)
    for t in range(12):
        frames[t, 8 + t: 24 + t, 6: 22] = 230
    body = np.zeros((20, 3), np.float32)
    for j, (x, y) in zip((0, 1, 2, 5, 8, 11),
                         [(14, 12), (14, 18), (10, 18), (18, 18),
                          (12, 30), (16, 30)]):
        body[j] = (x, y, 0.9)
    return frames, body


def test_mask_fn_adapter_matches_jax(params, tparams):
    """build_sam2_mask_fn: [T, H, W] uint8 from frames + PoseMeta, the
    reference keyframe rule (12 frames: 4 conditioning frames, 8
    propagated), against JAX's masks; and T.KEY_POINT_INDICES."""
    frames, body = _mask_fn_inputs()
    got = T.build_sam2_mask_fn(tparams, TCFG)(
        frames, [PoseMeta(body=body) for _ in range(12)])
    want = J.build_sam2_mask_fn(params, JCFG)(
        frames, [JPoseMeta(body=body) for _ in range(12)])
    assert got.shape == frames.shape[:3] and got.dtype == np.uint8
    assert set(np.unique(got)) <= {0, 1}
    assert np.mean(got == want) > 0.999
    assert T.KEY_POINT_INDICES == JP.KEY_POINT_INDICES


def _manifest_sd(cfg, seed=0):
    man = TM.sam2_manifest(cfg)
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in man.items()}


def test_manifest_matches_jax():
    for jc, tc in ((JCFG, TCFG), hiera_l_widths(256)):
        assert TM.sam2_manifest(tc) == JM.sam2_manifest(jc)


def test_converter_matches_jax(frames):
    """convert_sam2 on a manifest-shaped state dict equals sam2_from_jax
    of JAX's convert_sam2, leaf for leaf, and runs."""
    sd = _manifest_sd(TCFG)
    want, _ = JM.audited(sd, lambda s: JC.convert_sam2(s, JCFG,
                                                       jnp.float32),
                         ignore=("sam_prompt_encoder.mask_downscaling.",))
    ref = sam2_from_jax(np_tree(want), TCFG, device="cpu").state_dict()
    got, leftover = TM.audited(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        lambda s: TC.convert_sam2(s, TCFG, device="cpu"),
        ignore=("sam_prompt_encoder.mask_downscaling.",))
    assert leftover == []
    got_sd = got.state_dict()
    assert sorted(got_sd) == sorted(ref)
    for k, v in ref.items():
        assert got_sd[k].dtype == v.dtype, k
        torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0)
    pred = T.Sam2VideoPredictor(got, TCFG)
    state = pred.init_state_v2([np.zeros((32, 32, 3), np.uint8)] * 2)
    _, _, m = pred.add_new_points(state, 0, 1, np.array([[16.0, 16.0]]),
                                  np.array([1]))
    assert np.isfinite(m).all()


def test_strict_audit_catches_extra_keys():
    sd = {k: torch.from_numpy(v) for k, v in _manifest_sd(TCFG).items()}
    sd["image_encoder.trunk.blocks.99.renamed.weight"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="not consumed"):
        TM.audited(sd, lambda s: TC.convert_sam2(s, TCFG, device="cpu"),
                   ignore=("sam_prompt_encoder.mask_downscaling.",))


def test_load_sam2_checkpoint_matches_jax(tmp_path):
    """A .pt with the weights under "model": the port's loader equals
    JAX's load_sam2_checkpoint (converted), and an unread key raises."""
    sd = _manifest_sd(TCFG, seed=3)
    path = str(tmp_path / "sam2_hiera_large.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    got, cfg = TC.load_sam2_checkpoint(path, TCFG, device="cpu")
    assert cfg is TCFG
    want, _ = JC.load_sam2_checkpoint(path, JCFG)
    ref = sam2_from_jax(np_tree(want), TCFG, device="cpu").state_dict()
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
    sd["extra.weight"] = np.zeros(2, np.float32)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    with pytest.raises(ValueError, match="not consumed"):
        TC.load_sam2_checkpoint(path, TCFG, device="cpu")


def test_full_scale_manifest_pinned():
    """The real-scale manifest regenerated by the port equals the
    committed JSON, and the full Hiera-L module has its shapes."""
    man = {k: list(v) for k, v in TM.sam2_manifest(T.Sam2Config()).items()}
    with open(os.path.join(ROOT, "manifests", "sam2_hiera_large.json")) \
            as f:
        pinned = json.load(f)
    assert man == pinned
    model = T.init_sam2(T.Sam2Config(), device="meta")
    n = sum(p.numel() for p in model.parameters())
    skipped = sum(np.prod(v) for k, v in pinned.items()
                  if k.startswith("sam_prompt_encoder.mask_downscaling."))
    assert n == sum(np.prod(v) for v in pinned.values()) - skipped
