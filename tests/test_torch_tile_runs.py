"""The masked modes' tile lists from runs of equal codes, and the tile plan,
on the CPU.

csrc/mask_tiles_sm90.cu builds the forward's list (128-row q tiles over
128-key kv tiles) and the one-pass backward's (128-key kv tiles over
64-row q tiles) in one launch, deciding each 64 x 128 flag from the runs
of equal codes in its q tile and its kv tile, not pair by pair. The kernel
runs only on a card (tests/test_torch_cuda.py and chip_smoke.py hold it
against the plain lists there); its rule, emulated by
`tile_lists_by_runs`, is held here list for list and count for count
against the pair-based plain lists `mask_tile_list_plain` and
`bwd_tile_list_plain`: on packs of the port's packer (as they come and
padded by `build_tile_plan` with the dispatcher's pad ids), kv_len cutting
a tile mid-way, at its edge and at 0, segment ids in runs of one and runs
over many tiles, two batch rows with different codes, the backward's
causal mode with q_offset and device q_offsets, and random
pack_mask_codes codes. Then the tile plan: built once a BAGEL packed pass
and handed to every layer (outputs and gradients equal to calls that take
the codes), and refused by `attention` where it does not match the call.
Every comparison is exact: the lists are integer work.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_mask_tiles import _pack_codes
from univid_tpu_torch.kernels import attention as tatt
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.models.bagel import packed as tpacked
from univid_tpu_torch.models.bagel.qwen2_mot import (Qwen2MoTConfig,
                                                     init_qwen2_mot)

torch.set_num_threads(2)


def _assert_lists_equal(b, lq, lk, **masks):
    """The run rule's lists equal the plain lists on these masks; returns
    the (fwd, bwd) counts of live tiles."""
    fwd, bwd = tfa.tile_lists_by_runs(b, lq, lk, **masks)
    want_bwd = tfa.bwd_tile_list_plain(b, lq, lk, **masks)
    assert torch.equal(bwd[0], want_bwd[0])
    assert torch.equal(bwd[1], want_bwd[1])
    if masks.get("causal"):
        assert fwd is None
        return None, int(bwd[1].sum())
    want_fwd = tfa.mask_tile_list_plain(
        masks["q_segments"], masks["kv_segments"], masks.get("kv_len"),
        masks.get("packed_mode", False))
    assert torch.equal(fwd[0], want_fwd[0])
    assert torch.equal(fwd[1], want_fwd[1])
    return int(fwd[1].sum()), int(bwd[1].sum())


def _full_share(lists):
    live = lists >= 0
    return int((live & (lists % 2 == 1)).sum()), int(live.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_rule_on_packer_packs(seed):
    """A 1,024-token pack of BAGEL's four sample kinds as the packer gives
    it: both lists equal, with live, dead and full tiles in each."""
    c = _pack_codes(seed)
    l = c.shape[1]
    fwd, bwd = tfa.tile_lists_by_runs(1, l, l, q_segments=c, kv_segments=c,
                                      packed_mode=True)
    _assert_lists_equal(1, l, l, q_segments=c, kv_segments=c,
                        packed_mode=True)
    for lists, tiles in ((fwd[0], (l // 128) ** 2),
                         (bwd[0], (l // 64) * (l // 128))):
        full, live = _full_share(lists)
        assert 0 < full < live < tiles


@pytest.mark.parametrize("seed,length", [(0, 900), (1, 800), (2, 650)])
def test_run_rule_on_padded_packs(seed, length):
    """A pack cut to `length` tokens and padded by `build_tile_plan` as the
    dispatcher pads it (q -1, kv -2, to a multiple of 64 that is not one
    of 128; kv_len the real length): the plan's codes and kv_len give
    equal lists, and its pad rows are in no list."""
    c = _pack_codes(seed)[:, :length]
    plan = tfa.build_tile_plan(c, c, packed_mode=True)
    lp = plan.q_codes.shape[1]
    assert lp % 64 == 0 and lp % 128 != 0 and lp - length < 64
    assert plan.kv_len.tolist() == [length]
    _assert_lists_equal(1, lp, lp, kv_len=plan.kv_len,
                        q_segments=plan.q_codes, kv_segments=plan.kv_codes,
                        packed_mode=True)
    _, bwd = tfa.tile_lists_by_runs(1, lp, lp, kv_len=plan.kv_len,
                                    q_segments=plan.q_codes,
                                    kv_segments=plan.kv_codes,
                                    packed_mode=True)
    # the last q tile of 64 holds the pad rows alone when length <= lp - 64
    last = lp // 64 - 1
    if length <= last * 64:
        assert not bool((bwd[0] >> 1 == last).any())


@pytest.mark.parametrize("kv_len", [(700, 768), (768, 0), (0, 1000)])
def test_run_rule_with_kv_len(kv_len):
    """Two batch rows with different packs, kv_len cutting a kv tile
    mid-way (700), at a tile edge (768) and at 0 (no live tile)."""
    c = torch.cat([_pack_codes(0), _pack_codes(1)], dim=0)
    kv = torch.tensor(kv_len, dtype=torch.int32)
    nf, nb = _assert_lists_equal(2, 1024, 1024, kv_len=kv, q_segments=c,
                                 kv_segments=c, packed_mode=True)
    assert nf > 0 and nb > 0


def _segments(kind):
    """(q ids [B, Lq], kv ids [B, Lk])."""
    rng = np.random.default_rng(3)
    if kind == "alternating":   # runs of one row / key
        q = np.arange(448)[None] % 2
        k = (np.arange(320)[None] + 1) % 2
    elif kind == "long":       # three segments, each over many tiles
        q = np.zeros((1, 2048), np.int64)
        q[0, 700:] = 1
        q[0, 1650:] = 2
        k = q.copy()
    else:                      # two rows, ids in random runs of 1-40
        rows = []
        for _ in range(2):
            lens = rng.integers(1, 41, 64)
            rows.append(np.repeat(rng.integers(0, 4, 64), lens)[:576])
        q = np.stack(rows)
        k = q[:, :448].copy()
        k[1] = k[1][::-1]
    return (torch.as_tensor(q, dtype=torch.int32),
            torch.as_tensor(k, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["alternating", "long", "b2_random"])
@pytest.mark.parametrize("with_kv_len", [False, True])
def test_run_rule_on_segments(kind, with_kv_len):
    """Segment ids: runs of length 1 (the rule's worst case, as many run
    pairs as the pair walk), runs spanning many tiles, and two rows with
    different ids in random runs (kv ids reversed in the second)."""
    q, k = _segments(kind)
    b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    kv = (torch.tensor([lk - 70, 129][:b], dtype=torch.int32)
          if with_kv_len else None)
    _assert_lists_equal(b, lq, lk, kv_len=kv, q_segments=q, kv_segments=k)


@pytest.mark.parametrize("q_offset,q_offsets,kv_len,lq", [
    (0, None, None, 448),
    (13, None, (250, 448), 192),
    (0, (37, -100), (250, 448), 448),
    (5, (1200, 64), None, 256),
])
def test_run_rule_causal_backward(q_offset, q_offsets, kv_len, lq):
    """The backward's causal mode (no forward list): static q_offset and
    device q_offsets, negative ones too, with kv_len, over 448 keys."""
    masks = dict(causal=True, q_offset=q_offset)
    if q_offsets is not None:
        masks["q_offsets"] = torch.tensor(q_offsets, dtype=torch.int32)
    if kv_len is not None:
        masks["kv_len"] = torch.tensor(kv_len, dtype=torch.int32)
    _assert_lists_equal(2, lq, 448, **masks)


def _random_codes(rng, length, n_docs, n_fn, n_nz, mean_run):
    """pack_mask_codes codes in random runs: doc, full/noise split and
    noise split ids drawn per run (-1 for none)."""
    out = []
    while len(out) < length:
        run = int(rng.geometric(1.0 / mean_run))
        code = tatt.pack_mask_codes(rng.integers(0, n_docs),
                                    rng.integers(-1, n_fn),
                                    rng.integers(-1, n_nz))
        out += [int(code)] * run
    return np.asarray(out[:length], np.int32)


@pytest.mark.parametrize("seed", range(8))
def test_run_rule_on_random_codes(seed):
    """Random packed codes, B = 2, Lq != Lk, runs of mean length 1.5 to
    60, kv_len or none: both lists equal."""
    rng = np.random.default_rng(100 + seed)
    lq, lk = int(rng.integers(1, 9)) * 64, int(rng.integers(1, 9)) * 64
    mean_run = [1.5, 4, 20, 60][seed % 4]
    q = np.stack([_random_codes(rng, lq, 3, 3, 3, mean_run)
                  for _ in range(2)])
    k = q.copy() if lq == lk and seed % 2 else np.stack(
        [_random_codes(rng, lk, 3, 3, 3, mean_run) for _ in range(2)])
    kv = (torch.tensor(rng.integers(0, lk + 1, 2), dtype=torch.int32)
          if seed % 3 else None)
    _assert_lists_equal(2, lq, lk, kv_len=kv, q_segments=torch.as_tensor(q),
                        kv_segments=torch.as_tensor(k), packed_mode=True)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=st.data())
def test_run_rule_on_drawn_codes(data):
    """Codes drawn by hypothesis: per run a doc in [-1, 2], a full/noise
    split in [-1, 2] and a noise split in [-1, 2] (packed) or an id in
    [0, 3] (segments), runs of 1-130, Lq and Lk of 1-5 tiles of 64, and a
    kv_len anywhere in [0, Lk] or none."""
    packed = data.draw(st.booleans())
    lq = 64 * data.draw(st.integers(1, 5))
    lk = 64 * data.draw(st.integers(1, 5))

    def codes(length):
        out = []
        while len(out) < length:
            run = data.draw(st.integers(1, 130))
            if packed:
                c = int(tatt.pack_mask_codes(*(data.draw(st.integers(-1, 2))
                                               for _ in range(3))))
            else:
                c = data.draw(st.integers(0, 3))
            out += [c] * run
        return out[:length]

    q = torch.tensor([codes(lq)], dtype=torch.int32)
    k = torch.tensor([codes(lk)], dtype=torch.int32)
    kv = data.draw(st.one_of(st.none(), st.integers(0, lk)))
    kv = None if kv is None else torch.tensor([kv], dtype=torch.int32)
    _assert_lists_equal(1, lq, lk, kv_len=kv, q_segments=q, kv_segments=k,
                        packed_mode=packed)


def test_tile_plan_on_the_cpu():
    """`build_tile_plan` on the CPU: the dispatcher's padding (q -1, kv -2
    up to a multiple of 64), kv_len = Lk where it pads keys and none is
    given, the caller's kv_len kept; no lists (the plain versions read the
    codes); `check` refuses another B, length, mode or device."""
    q = torch.arange(200, dtype=torch.int32)[None].repeat(2, 1) // 50
    k = torch.arange(130, dtype=torch.int32)[None].repeat(2, 1) // 50
    plan = tfa.build_tile_plan(q, k, packed_mode=False)
    assert plan.q_codes.shape == (2, 256) and plan.kv_codes.shape == (2, 192)
    assert plan.q_codes.dtype == torch.int32 and plan.q_codes.is_contiguous()
    assert torch.equal(plan.q_codes[:, :200], q)
    assert bool((plan.q_codes[:, 200:] == -1).all())
    assert bool((plan.kv_codes[:, 130:] == -2).all())
    assert plan.kv_len.tolist() == [130, 130]
    assert plan.fwd is None and plan.bwd is None
    plan.check(2, 256, 192, False, "cpu")
    own = tfa.build_tile_plan(q.numpy(), k[:, :128].numpy(), kv_len=[90, 0])
    assert own.kv_len.tolist() == [90, 0] and own.kv_codes.shape == (2, 128)
    assert tfa.build_tile_plan(q[:, :192], q[:, :192]).kv_len is None
    for args in ((1, 256, 192, False), (2, 192, 192, False),
                 (2, 256, 256, False), (2, 256, 192, True)):
        with pytest.raises(ValueError, match="built for"):
            plan.check(*args, "cpu")
    with pytest.raises(ValueError, match="lies on"):
        plan.check(2, 256, 192, False, "meta")
    with pytest.raises(ValueError, match=r"\[B, Lq\]"):
        tfa.build_tile_plan(q[0], k[0])


def _qkv(b, l, n=2, d=128, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((b, l, n, d)),
                            dtype=torch.float32) for _ in range(3)]


@pytest.mark.parametrize("case", ["batch", "lq", "lk", "mode", "codes",
                                  "kv_len", "causal"])
def test_attention_refuses_a_plan_that_does_not_match(case):
    """attention() with a tile plan: another B, padded Lq or Lk, or
    packed_mode than the plan's, or codes, kv_len or causal beside it,
    raise; the matching call runs (and pads 250 -> 256 itself)."""
    c = _pack_codes(0)[:, :250]
    plan = tfa.build_tile_plan(c, c, packed_mode=True)
    q, k, v = _qkv(1, 250)
    o = tatt.attention(q, k, v, packed_mode=True, tile_plan=plan)
    assert torch.equal(o, tatt.attention(q, k, v, q_segments=c,
                                         kv_segments=c, packed_mode=True))
    kw = dict(packed_mode=True, tile_plan=plan)
    if case == "batch":
        q, k, v = _qkv(2, 250)
    elif case == "lq":
        q = q[:, :190]
    elif case == "lk":
        k, v = k[:, :120], v[:, :120]
    elif case == "mode":
        kw["packed_mode"] = False
    elif case == "codes":
        kw.update(q_segments=c, kv_segments=c)
    elif case == "kv_len":
        kw["kv_len"] = torch.tensor([250], dtype=torch.int32)
    else:
        kw["causal"] = True
    with pytest.raises(ValueError, match="tile plan"):
        tatt.attention(q, k, v, **kw)


def _small_mot():
    """A 2-layer MoT with d=128 heads (hidden 256, 2 query heads over 1 kv
    head), fp32 on the CPU, seeded; non-unit qk norms."""
    cfg = Qwen2MoTConfig(vocab_size=64, hidden_size=256, intermediate_size=96,
                         num_layers=2, num_heads=2, num_kv_heads=1)
    gen = torch.Generator().manual_seed(5)
    params = init_qwen2_mot(gen, cfg, device="cpu")
    with torch.no_grad():
        for layer in params.layers:
            for a in (layer.attn, layer.attn_gen):
                a.q_norm.uniform_(0.5, 1.5, generator=gen)
                a.k_norm.uniform_(0.5, 1.5, generator=gen)
    return cfg, params


def test_packed_forward_builds_the_plan_once(monkeypatch):
    """qwen2_mot_packed_forward builds one tile plan a pass (its 2 layers'
    attention calls take it and build none), and its hidden states and
    the gradients of the input rows and of every weight equal those of
    the same pass whose attention calls take the codes (one plan a call)."""
    cfg, params = _small_mot()
    codes = _pack_codes(1)[0, :500]
    rng = np.random.default_rng(2)
    seq = torch.as_tensor(rng.standard_normal((500, cfg.hidden_size)),
                          dtype=torch.float32)
    pos = torch.arange(500)
    und = torch.arange(0, 500, 3)
    builds = {"pass": 0, "call": 0}

    def counted(where, fn):
        def build_plan(*a, **kw):
            builds[where] += 1
            return fn(*a, **kw)
        return build_plan

    monkeypatch.setattr(tpacked, "build_tile_plan",
                        counted("pass", tfa.build_tile_plan))
    monkeypatch.setattr(tatt, "build_tile_plan",
                        counted("call", tfa.build_tile_plan))
    leaves = [p for p in params.parameters()]

    def run():
        x = seq.clone().requires_grad_(True)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        h = tpacked.qwen2_mot_packed_forward(params, cfg, x, pos, codes, und,
                                             compute_dtype=torch.float32)
        (h * torch.linspace(-1, 1, h.numel()).reshape(h.shape)).sum() \
            .backward()
        return h.detach(), [x.grad] + [p.grad for p in leaves]

    h, grads = run()
    assert builds == {"pass": 1, "call": 0}

    plain_attention = tatt.attention

    def with_codes(q, k, v, *, packed_mode, tile_plan):
        lq = q.shape[1]
        return plain_attention(q, k, v, q_segments=tile_plan.q_codes[:, :lq],
                               kv_segments=tile_plan.kv_codes[:, :lq],
                               packed_mode=packed_mode)

    monkeypatch.setattr(tpacked, "attention", with_codes)
    h_c, grads_c = run()
    assert builds == {"pass": 2, "call": cfg.num_layers}
    assert torch.equal(h, h_c)
    assert len(grads) == len(grads_c) == len(leaves) + 1
    for g, g_c in zip(grads, grads_c):
        assert (g is None) == (g_c is None)
        if g is not None:
            assert torch.equal(g, g_c)
