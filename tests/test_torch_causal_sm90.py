"""The causal bf16 forward of csrc/flash_attention_causal_sm90.cu on the
CPU: its split-kv plan (`causal_splits`, `causal_split_plan`), its packing
of query heads (`causal_slot`), and its arithmetic
(`causal_split_plain`: per-split running max over 128-key tiles, p rounded
to bf16 against it, fp32 partials, the lse merge) against univid_tpu's
Pallas kernel in interpret mode and against the plain version.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there.

Tolerances: against the Pallas kernel, fp32 2e-5 (the same function; the
tile sizes, the running max's reference points and the merge differ only
in fp32 rounding) and bf16 2e-2 relative (p and the output round to bf16,
2^-8, against other reference points: the Pallas kernel's 64-key blocks,
the emulation's 128-key tiles of each split), the lse to 2e-5 (fp32 sums of
fp32 p in both); against the plain version PERF.md s2's causal forward
bound, 1e-3 + 2^-7 |ref| elementwise (bf16) and 1e-3 on the lse, or 2e-6
+ 2e-5 |ref| in fp32.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rand(shape, seed, normed=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if normed:  # qk-normed rows (norm sqrt(d))
        x = x / np.linalg.norm(x, axis=-1, keepdims=True) * shape[-1] ** 0.5
    return x


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# (a) the split plan
# ---------------------------------------------------------------------------

# (b, lq, lk, q_offset, q_offsets, kv_len): offsets at the cache's end,
# kv_len = 0 rows, rows before key 0 (negative device offsets), a static
# offset with and without device ones
PLANS = {
    "prefill_end_of_cache": (1, 64, 20480, 0, (20480 - 64,), (20480,)),
    "prefill_bagel": (2, 64, 20480, 0, (19168, 0), (19215, 0)),
    "lq128_static": (2, 128, 1024, 37, None, (1024, 500)),
    "lq128_both": (3, 128, 1024, 5, (0, 700, -90), (133, 1024, 60)),
    "square_2048": (1, 2048, 2048, 0, None, (2000,)),
    "square_2048_offsets": (2, 2048, 2560, 0, (0, 512), (2000, 2560)),
}


def _live_end(row, kv_end):
    """Keys [0, end) that a query at absolute row `row` sees."""
    return min(max(row + 1, 0), kv_end)


@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("splits", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("case", list(PLANS))
def test_split_plan_covers_each_live_key_once(case, splits, group):
    """For every row of every block, each key it sees lies in exactly one
    split's tiles, and no split reaches past Lk: the splits of a block are
    disjoint, ascending ranges of whole 128-key tiles that together cover
    the live keys of all its rows (a split wholly past them is empty)."""
    b, lq, lk, qoff, qoffs, kvl = PLANS[case]
    qo = None if qoffs is None else torch.tensor(qoffs, dtype=torch.int32)
    kv = torch.tensor(kvl, dtype=torch.int32)
    plan = tfa.causal_split_plan(b, group, lq, lk, splits, kv_len=kv,
                                 q_offset=qoff, q_offsets=qo).numpy()
    n_slots = group * lq // tfa.CAUSAL_SLOT
    assert plan.shape == (b, tfa.causal_pairs(group, lq), splits, 2)
    kt = -(-lk // 128)
    for bi in range(b):
        off = qoff + (0 if qoffs is None else qoffs[bi])
        kv_end = min(max(kvl[bi], 0), lk)
        for p in range(plan.shape[1]):
            t0, t1 = plan[bi, p, :, 0], plan[bi, p, :, 1]
            assert np.all(t0 <= t1) and np.all(t1 <= kt)
            assert np.all(t1[:-1] <= t0[1:])        # disjoint, ascending
            covered = np.zeros(kt * 128, np.int64)
            for a, z in zip(t0, t1):
                covered[a * 128:z * 128] += 1
            for s in range(2 * p, min(2 * p + 2, n_slots)):
                _, pos0 = tfa.causal_slot(s, group)
                for i in (pos0, pos0 + 31, pos0 + 63):
                    end = _live_end(off + i, kv_end)
                    assert np.all(covered[:end] == 1), (p, s, i)


def test_split_count_depends_on_shapes_only():
    """S is a function of (B, N, group, Lq, Lk) and the SM count alone: no
    device tensor enters it. At BAGEL's shapes: the question prefill's 16
    blocks take 8 splits, the B = 16 captioning shape (256 blocks) and the
    square 2,048 prefill (448 blocks) none; a grid that fills half the SMs
    takes none; S never exceeds the kv tiles or 16."""
    assert list(inspect.signature(tfa.causal_splits).parameters) == [
        "b", "n", "group", "lq", "lk", "sms"]
    assert tfa.causal_splits(1, 28, 7, 64, 20480) == 8
    assert tfa.causal_splits(16, 28, 7, 64, 2624) == 1
    assert tfa.causal_splits(1, 28, 7, 2048, 2048) == 1
    assert tfa.causal_splits(1, 28, 1, 2048, 2048) == 1
    assert tfa.causal_splits(3, 14, 7, 64, 1024) == 5
    assert tfa.causal_splits(1, 4, 2, 64, 128) == 1        # one kv tile
    assert tfa.causal_splits(1, 1, 1, 64, 1 << 20) == 16   # capped
    for b in (1, 2, 4, 8, 16, 64):
        for lq in (64, 128, 2048):
            s = tfa.causal_splits(b, 28, 7, lq, 20480)
            blocks = b * 4 * tfa.causal_pairs(7, lq)
            assert 1 <= s <= tfa.CAUSAL_MAX_SPLITS
            assert s == 1 or blocks * s <= tfa.H100_SMS


# ---------------------------------------------------------------------------
# (b) the packing of query heads
# ---------------------------------------------------------------------------


def _unpacked(row, group):
    """Packed row -> (head in the group, position), through `causal_slot`."""
    head, pos0 = tfa.causal_slot(row // 64, group)
    return head, pos0 + row % 64


@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("lq", [64, 128, 2048])
def test_packed_rows_round_trip(lq, group):
    """Packed row <-> (head in the group, position) is a bijection of the
    kv head's group * Lq rows onto [group] x [Lq], inverted by packed row =
    ((position // 64) * group + head) * 64 + position % 64; each 64-row
    slot is one head at 64 consecutive positions, position-major."""
    pairs = [_unpacked(r, group) for r in range(group * lq)]
    assert len(set(pairs)) == group * lq
    assert all(0 <= h < group and 0 <= i < lq for h, i in pairs)
    assert all(((i // 64) * group + h) * 64 + i % 64 == r
               for r, (h, i) in enumerate(pairs))
    for s in range(group * lq // 64):
        h0, pos0 = tfa.causal_slot(s, group)
        assert [_unpacked(s * 64 + r, group) for r in range(64)] == [
            (h0, pos0 + r) for r in range(64)]


# ---------------------------------------------------------------------------
# (c) the emulation against the Pallas kernel, (d) against the plain version
# ---------------------------------------------------------------------------

# (b, lq, lk, nk, group, q_offset, q_offsets, kv_len, splits): a question
# prefill over a cache with a kv_len = 0 batch row (rows with no live key);
# two heads over one kv head each at Lq = 128 with a static and device
# offsets; group 7 at Lq = 192 (an odd slot count: a block with one slot)
CASES = {
    "prefill_g7_empty_row": (2, 64, 512, 1, 7, 0, (300, 37), (347, 0), None),
    "lq128_g1_both": (2, 128, 384, 2, 1, 5, (100, 61), (233, 384), 2),
    "lq192_g7_odd_slots": (1, 192, 384, 1, 7, 0, (150,), (342,), 3),
}


def _case(name, seed):
    b, lq, lk, nk, group, qoff, qoffs, kvl, splits = CASES[name]
    n = nk * group
    q = _rand((b, lq, n, 128), seed, True)
    k = _rand((b, lk, nk, 128), seed + 1, True)
    v = _rand((b, lk, nk, 128), seed + 2)
    qo = None if qoffs is None else np.array(qoffs, np.int32)
    return q, k, v, qoff, qo, np.array(kvl, np.int32), group, splits


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_emulation_matches_pallas(case, dtype, lse):
    """`causal_split_plain` (folded q, the kernel's packing, split plan,
    128-key tiles and merge) == the Pallas causal kernel in interpret mode
    on the kv heads repeated as the JAX prefill repeats them
    (qwen2_mot.py's jnp.repeat), with and without save_residuals (lse
    column 0); rows with no live key exactly 0 with lse +1e30 in both."""
    q, k, v, qoff, qo, kv, group, splits = _case(case, 60)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    qj, kj, vj = (jnp.asarray(x, jd) for x in (q, k, v))
    jout = jfa.flash_attention_padded(
        qj, jnp.repeat(kj, group, axis=2), jnp.repeat(vj, group, axis=2),
        causal=True, q_offset=qoff, block_q=64, block_k=128, interpret=True,
        q_offsets=None if qo is None else jnp.asarray(qo),
        kv_len=jnp.asarray(kv), save_residuals=lse)
    qt, kt, vt = (torch.as_tensor(x).to(td) for x in (q, k, v))
    got = tfa.causal_split_plain(
        tfa._fold(qt, 128 ** -0.5), kt, vt, kv_len=torch.as_tensor(kv),
        q_offset=qoff, q_offsets=None if qo is None else torch.as_tensor(qo),
        splits=splits, save_residuals=lse)
    tol = FP32 if dtype == "float32" else BF16
    if lse:
        (got, got_lse), (jo, jl) = got, jout
        b, _, n, _ = q.shape
        want_lse = np.asarray(jl)[:, :, 0].reshape(b, n, -1)
        np.testing.assert_allclose(got_lse.numpy(), want_lse, **FP32)
    else:
        jo = jout
    np.testing.assert_allclose(_np(got), _np(jo), **tol)
    empty = np.nonzero(kv == 0)[0]
    for bi in empty:
        assert float(got[bi].abs().max()) == 0.0
        if lse:
            assert bool((got_lse[bi] == 1e30).all())


# (b, lq, lk, nk, group, q_offset, q_offsets, kv_len) at the path's
# packing: BAGEL's question prefill cut to a 4,096-row cache, the batched
# captioning shape at B = 4, a square prefill with a kv_len tail
PLAIN_CASES = {
    "question_prefill": (1, 64, 4096, 2, 7, 0, (3500,), (3547,)),
    "batched_b4": (4, 64, 1536, 1, 7, 0, (1198, 1235, 1272, 1309),
                   (1238, 1275, 1312, 1349)),
    "square_640": (1, 640, 640, 2, 7, 0, None, (600,)),
}


@pytest.mark.parametrize("splits", [None, 1, 2, 5, 16])
@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_split_emulation_within_causal_bound(case, splits):
    """The emulation (bf16, any split count: the default S, none, 2, 5,
    16) against `attention_plain` within PERF.md s2's causal forward bound
    1e-3 + 2^-7 |ref| elementwise, lse to 1e-3: p rounds to bf16 against
    each split's running max here and against the row max there, and the
    merge's fp32 rescale keeps that difference inside one output ulp. fp32
    (no p rounding): 2e-6 + 2e-5 |ref|."""
    b, lq, lk, nk, group, qoff, qoffs, kvl = PLAIN_CASES[case]
    n = nk * group
    q = _rand((b, lq, n, 128), 70, True)
    k = _rand((b, lk, nk, 128), 71, True)
    v = _rand((b, lk, nk, 128), 72)
    qo = None if qoffs is None else torch.tensor(qoffs, dtype=torch.int32)
    kv = torch.tensor(kvl, dtype=torch.int32)
    for td in (torch.bfloat16, torch.float32):
        qs = tfa._fold(torch.as_tensor(q).to(td), 128 ** -0.5)
        kt, vt = (torch.as_tensor(x).to(td) for x in (k, v))
        got, got_lse = tfa.causal_split_plain(
            qs, kt, vt, kv_len=kv, q_offset=qoff, q_offsets=qo,
            splits=splits, save_residuals=True)
        want, want_lse = tfa.attention_plain(
            qs, kt, vt, kv_len=kv, causal=True, q_offset=qoff, q_offsets=qo,
            save_residuals=True)
        err = (got.float() - want.float()).abs()
        if td == torch.bfloat16:
            lim = 1e-3 + 2.0 ** -7 * want.float().abs()
        else:
            lim = 2e-6 + 2e-5 * want.float().abs()
        assert bool((err <= lim).all()), float((err - lim).max())
        assert float((got_lse - want_lse).abs().max()) <= 1e-3


def test_split_emulation_rows_with_no_live_key():
    """Rows before key 0 (a negative device offset) and a kv_len = 0 batch
    row: exactly 0 with lse +1e30, under 3 splits, as the plain version."""
    q = tfa._fold(torch.as_tensor(_rand((2, 128, 7, 128), 80, True)).to(
        torch.bfloat16), 128 ** -0.5)
    k, v = (torch.as_tensor(_rand((2, 512, 1, 128), s, True)).to(
        torch.bfloat16) for s in (81, 82))
    kv = torch.tensor([512, 0], dtype=torch.int32)
    qo = torch.tensor([-40, 3], dtype=torch.int32)
    o, lse = tfa.causal_split_plain(q, k, v, kv_len=kv, q_offsets=qo,
                                    splits=3, save_residuals=True)
    o_p, lse_p = tfa.attention_plain(q, k, v, kv_len=kv, causal=True,
                                     q_offsets=qo, save_residuals=True)
    assert float(o[0, :40].abs().max()) == 0.0 and float(o[1].abs().max()) \
        == 0.0
    assert bool((lse[0, :, :40] == 1e30).all()) and bool((lse[1] == 1e30)
                                                         .all())
    assert bool((lse[0, :, 40:] < 1e29).all())
    assert torch.equal(lse == 1e30, lse_p == 1e30)
    assert float((o.float() - o_p.float()).abs().max()) <= 1e-3 + 2 ** -7 * \
        float(o_p.float().abs().max())
