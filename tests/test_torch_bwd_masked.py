"""The masked modes of the one-pass bf16 attention backward
(csrc/flash_attention_bwd_sm90.cu) on the CPU: its kv-major tile list
(`bwd_tile_list_plain`: for each 128-key kv tile the 64-row q tiles with a
live pair, and which of them need no compare) against the dense `_dead`
predicate, tile by tile, in the causal (static and device offsets, kv_len),
segment and packed modes, on a pack built by the port's packer, padded with
the dispatcher's pad ids and cut by kv_len; and the kernel's walk of that
list in plain PyTorch (`_walk` of tests/test_torch_bwd_sm90.py with a mask:
only the listed q tiles, the predicate only in tiles not flagged full, the
kernel's rounding points) against the plain backward and univid_tpu's fused
Pallas backward in interpret mode.

The CUDA pre-pass and kernel run only on a card: tests/test_torch_cuda.py
and chip_smoke.py hold the kernel's list against this plain one exactly and
the kernel against its plain version and the mma.sync pair.
Tolerances: fp32, 1e-5 relative L2 (only the fp32 summation order, and
against JAX its exp2, differ); bf16, PERF.md s2's backward bound, 2^-8
max|ref| + 2^-7 |ref| and 1e-4 relative L2 against the plain backward, 1e-2
against JAX (the same rounding points; an fp32 difference of ~1e-6 flips a
bf16 rounding of p or dS by one step, 2^-8). Against JAX live rows only: the
pad rows' lse differs by design (ROADMAP queue 3, rows with no live key),
and their cotangent is zero, as the dispatcher's slice makes it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from tests.test_torch_attention_bwd import _masked_case
from tests.test_torch_bwd_sm90 import _jlse, _rel, _walk
from tests.test_torch_mask_tiles import _pack_codes
from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
BQ, BK = tfa.BWD_BLOCK_Q, tfa.BWD_BLOCK_K   # the kernel's q and kv tiles


def _i32(x):
    return None if x is None else torch.as_tensor(np.asarray(x, np.int32))


def _list_case(name):
    """(B, Lq, Lk, kv_len or None, masks) of one tile-list case."""
    if name.startswith("pack"):
        c = _pack_codes()
        if name == "pack":
            return 1, c.shape[1], c.shape[1], None, dict(
                q_segments=c, kv_segments=c, packed_mode=True)
        # the dispatcher's padding: 64 rows past a multiple of 64, pad ids
        # -1 (queries) / -2 (keys); kv_len inside a document
        lp = (c.shape[1] + 63) // 64 * 64 + 64
        qc = torch.full((1, lp), -1, dtype=torch.int32)
        kc = torch.full((1, lp), -2, dtype=torch.int32)
        qc[:, :c.shape[1]] = c
        kc[:, :c.shape[1]] = c
        kv_len = _i32([c.shape[1] - 150]) if name == "pack_kv_len" else None
        return 1, lp, lp, kv_len, dict(q_segments=qc, kv_segments=kc,
                                       packed_mode=True)
    if name == "segments":
        _, _, _, kw, _ = _masked_case("segments", l=448)
        return 2, 448, 448, _i32([448, 250]), dict(
            q_segments=_i32(kw["q_segments"]),
            kv_segments=_i32(kw["kv_segments"]))
    # causal: a static offset and device offsets not multiples of 64, kv_len
    # inside a tile, a row whose keys all lie past its queries (offset < 0)
    offsets = {"causal": None, "causal_offsets": [37, 190],
               "causal_negative": [-200, 0]}[name]
    kv_len = None if name == "causal" else _i32([250, 448])
    return 2, 448, 448, kv_len, dict(causal=True, q_offset=13 if offsets
                                     else 0, q_offsets=_i32(offsets))


LIST_CASES = ["pack", "pack_padded", "pack_kv_len", "segments", "causal",
              "causal_offsets", "causal_negative"]


def _alive(b, lq, lk, kv_len, masks):
    """The allowed pairs, bool [B, Lq, Lk] (`_dead`'s complement)."""
    dead = tfa._dead(0, lq, lk, "cpu", kv_len=kv_len, **masks)
    return (~dead[:, 0]).expand(b, lq, lk)


@pytest.mark.parametrize("case", LIST_CASES)
def test_bwd_tile_list_matches_dead_predicate(case):
    """q tile i is in kv tile j's list iff some pair of its 64 rows and a
    key of tile j is allowed; the list is ascending, its count is right and
    the entries past the count are -1; some tiles are skipped."""
    b, lq, lk, kv_len, masks = _list_case(case)
    lists, count = tfa.bwd_tile_list_plain(b, lq, lk, kv_len=kv_len, **masks)
    alive = _alive(b, lq, lk, kv_len, masks)
    nq, kt = lq // BQ, -(-lk // BK)
    assert lists.shape == (b, kt, nq) and count.shape == (b, kt)
    assert lists.dtype == count.dtype == torch.int32
    n_live = 0
    for bi in range(b):
        for j in range(kt):
            want = [i for i in range(nq) if bool(
                alive[bi, i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK].any())]
            n = int(count[bi, j])
            assert [int(x) >> 1 for x in lists[bi, j, :n]] == want
            assert bool((lists[bi, j, n:] == -1).all())
            n_live += n
    assert 0 < n_live < b * kt * nq


@pytest.mark.parametrize("case", LIST_CASES)
def test_bwd_full_flag_is_exact(case):
    """A listed q tile is flagged full iff every pair of its 64 rows and
    the kv tile's BK keys is allowed (a key at or past Lk or kv_len counts
    as dead): the kernel skips the compare only where nothing is masked."""
    b, lq, lk, kv_len, masks = _list_case(case)
    lists, count = tfa.bwd_tile_list_plain(b, lq, lk, kv_len=kv_len, **masks)
    alive = _alive(b, lq, lk, kv_len, masks)
    kinds = set()
    for bi in range(b):
        for j in range(count.shape[1]):
            for e in lists[bi, j, :int(count[bi, j])].tolist():
                i, full = e >> 1, bool(e & 1)
                tile = alive[bi, i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK]
                assert full == (tile.shape[1] == BK and bool(tile.all())), \
                    (bi, j, i)
                kinds.add(full)
    assert kinds == {True, False}   # both kinds of tile occur


# walk cases: (mode of _masked_case, L, extra mask keywords). L = 384 (the
# JAX kernels' masks take 128-row blocks); 448 ends in a 64-row kv tile
WALKS = {
    "causal_q_offsets": ("causal", 384, {}),
    "causal_static_kv_len": ("causal", 384, dict(q_offset=13,
                                                 kv_len=[300, 200])),
    "segments": ("segments", 384, {}),
    "packed": ("packed", 384, {}),
    "packed_kv_len": ("packed", 384, dict(kv_len=[330, 250])),
    "packed_448": ("packed", 448, {}),
}
JAX_WALKS = [c for c in WALKS if WALKS[c][1] % 128 == 0]


def _walk_case(case):
    """q, k, v, dO (numpy fp32 [2, L, 2, 128], seeded), kv_len (a tuple or
    None), the mask keywords (numpy), the rows that see some key. Keys no
    query may see (pad ids, past kv_len) hold 50.0; dO is zero on rows that
    see no key."""
    mode, lq, extra = WALKS[case]
    q, k, v, kw, live = _masked_case(mode, l=lq)
    kw = dict(kw)
    kvl = extra.get("kv_len")
    if "q_offset" in extra:
        kw["q_offset"] = extra["q_offset"]
    kw.pop("kv_len", None)
    kv_t = _i32(kvl)
    alive = _alive(2, lq, lq, kv_t, _tmasks(kw))
    live = live & alive.any(-1).numpy()
    drop = ~alive.any(1).numpy()                      # [B, Lk]
    k[drop] = 50.0
    v[drop] = 50.0
    do = np.random.default_rng(64).standard_normal(q.shape).astype(
        np.float32) * live[:, :, None, None]
    return q, k, v, do, kvl, kw, live


def _tmasks(kw):
    return {key: (_i32(x) if key.endswith(("segments", "offsets")) else x)
            for key, x in kw.items()}


def _check(got, want, dt, rel, name):
    assert got.dtype == want.dtype == dt, name
    if dt == torch.float32:
        assert _rel(got, want) < 1e-5, name
        return
    assert _rel(got, want) < rel, name
    g, w = got.float(), want.float()
    lim = 2.0 ** -8 * float(w.abs().max()) + 2.0 ** -7 * w.abs()
    assert bool(((g - w).abs() <= lim).all()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WALKS))
def test_masked_walk_matches_plain_backward(case, dtype):
    """The list-driven walk against `_bwd_plain_folded` on the same inputs
    and the plain forward's residuals; rows that see no key (pad ids, lse
    +1e30) give exactly zero dq, keys no row sees exactly zero dk and dv,
    whatever their cotangent."""
    q, k, v, do, kvl, kw, live = _walk_case(case)
    do = np.random.default_rng(65).standard_normal(q.shape).astype(
        np.float32)   # pad rows too: they must still add nothing
    dt = getattr(torch, dtype)
    qt, kt, vt, dot = (torch.as_tensor(x).to(dt) for x in (q, k, v, do))
    masks = _tmasks(kw)
    kv = _i32(kvl)
    sc = q.shape[-1] ** -0.5
    qs = tfa._fold(qt, sc)
    o, lse = tfa.attention_plain(qs, kt, vt, kv_len=kv, save_residuals=True,
                                 **masks)
    got = _walk(qs, kt, vt, o, lse, dot, kvl, sc, **masks)
    want = tfa._bwd_plain_folded(qs, kt, vt, o, lse, dot, kv, sc, **masks)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _check(g, w, dt, 1e-4, name)
    alive = _alive(2, q.shape[1], k.shape[1], kv, masks)
    no_key = ~alive.any(-1)                 # [B, Lq]
    no_query = ~alive.any(1)                # [B, Lk]
    assert bool((got[0][no_key] == 0).all())
    for g in got[1:]:
        assert bool((g[no_query] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", JAX_WALKS)
def test_masked_walk_matches_pallas_fused_backward(case, dtype):
    """The list-driven walk against univid_tpu's one-pass Pallas backward
    (`flash_attention_bwd_padded(..., fused=True, interpret=True)`) under
    the same mask, from the Pallas forward's residuals: dq on the rows that
    see some key, dk and dv on every key."""
    q, k, v, do, kvl, kw, live = _walk_case(case)
    b, lq, n, d = q.shape
    jdt = getattr(jnp, dtype)
    dt = getattr(torch, dtype)
    qj, kj, vj, dj = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jkw = {key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}
    if kvl is not None:
        jkw["kv_len"] = jnp.asarray(kvl, jnp.int32)
    blk = dict(block_q=128, block_k=128, interpret=True)
    jo, jl = jfa.flash_attention_padded(qj, kj, vj, save_residuals=True,
                                        **blk, **jkw)
    want = jfa.flash_attention_bwd_padded(qj, kj, vj, jo, jl, dj, fused=True,
                                          **blk, **jkw)
    sc = d ** -0.5
    qs = tfa._fold(torch.as_tensor(q).to(dt), sc)
    o = torch.as_tensor(np.array(jo.astype(jnp.float32))).to(dt)
    lse = torch.as_tensor(_jlse(jl, b, n).copy())
    got = _walk(qs, *(torch.as_tensor(x).to(dt) for x in (k, v)), o, lse,
                torch.as_tensor(do).to(dt), kvl, sc, **_tmasks(kw))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        w = torch.as_tensor(np.array(w.astype(jnp.float32))).to(dt)
        if name == "dq":
            g, w = g[torch.as_tensor(live)], w[torch.as_tensor(live)]
        _check(g, w, dt, 1e-2, name)
