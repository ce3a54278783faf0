"""The masked modes of the fp32 d=128 attention kernels
(csrc/flash_attention_f32_sm90.cu) on the CPU: the three kernels' walks
transcribed in plain PyTorch and held against the plain forward and
backward, and the plain versions against univid_tpu's Pallas kernels.

The walks (`fwd_walk`, `dq_walk`, `dkv_walk`) follow the kernels step by
step: three bf16 parts an operand and six-term products (the split form of
tests/test_torch_f32_d128_tc.py: each of the scores' terms in a fresh
truncating accumulator, each product over 32 rows in a fresh tile
accumulator added by an FADD, an FMA with the correction in the forward);
the forward's 128-row q tile as two 64-row consumers over 32-key tiles, the
dq kernel's 64-row q tile over 32-key tiles taken by two consumers in turn,
the dk/dv kernel's 64-row kv tile over 32-row q tiles. Which tiles a block
walks and where it runs the predicate, as the kernels decide it: the causal
range from the offsets (tiles past a block's last row never loaded, the
predicate only where a tile crosses the diagonal or kv_len); in the segment
and packed modes the forward list of `tile_lists` (each 128-key entry four
32-key tiles, the last cut at kv_len) for the forward and the dq kernel,
the backward's kv-major list (each 64-row q entry two 32-row q tiles) for
the dk/dv kernel, the predicate only in tiles not flagged full; grouped kv
heads in the forward (query head h reads kv head h // group).

Cases: causal with a static offset, with device q_offsets and kv_len, in
the QA prefill's form (64 query rows over a longer cache, offsets past its
start, kv_len, grouped kv heads), segment ids with kv_len, a BAGEL pack
(`_pack_codes` of tests/test_torch_mask_tiles.py, cut to 200 tokens and
padded as the dispatcher pads, -1 / -2), and grouped kv heads (non-causal
with kv_len, and causal). Narrow shapes: 2-4 heads, Lq <= 256.

Bounds (PERF.md s2, fp32 d=128): forward 1e-5 + 1e-4 |ref|, lse 1e-4; dq,
dk, dv 1e-4 max|ref| + 1e-4 |ref| and rel. L2 < 1e-4; rows with no live key
exactly 0 with lse +1e30, keys no row sees exactly 0 in dk and dv. Against
JAX's `flash_attention_padded` / `flash_attention_bwd_padded` in interpret
mode: the plain versions on live rows at 1e-5 relative L2 (the pad rows'
lse differs by design, ROADMAP queue 3).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from tests.test_torch_bwd_sm90 import _jlse
from tests.test_torch_f32_d128_tc import SMALL, _rz
from tests.test_torch_mask_tiles import _pack_codes
from univid_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)
D = 128
KT = 32                      # the kernels' streamed tile
FQ, RQ = 128, 64             # the forward's q tile, the backward's resident tile
NEG = tfa.NEG_INF


# ---------------------------------------------------------------------------
# the split products, batched over heads
# ---------------------------------------------------------------------------


def _parts(x):
    p = tfa.split_bf16x3_plain(x).double()
    return p[0], p[1], p[2]


def scores(a, b):
    """a b^T over d = 128 (a [N, M, 128], b [N, K, 128] fp32) as the
    kernels' scores_mma: six terms, each 8 truncating steps into a fresh
    accumulator, the small terms summed by round-to-nearest adds, then the
    main one. fp32 [N, M, K]."""
    a_p, b_p = _parts(a), _parts(b)

    def term(i, j):
        acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float64)
        for k0 in range(0, D, 16):
            sl = slice(k0, k0 + 16)
            acc = _rz(acc + a_p[i][..., sl] @ b_p[j][..., sl].transpose(-1, -2))
        return acc.float()

    t01, t10, t02, t11, t20 = (term(i, j) for i, j in SMALL)
    return term(0, 0) + (((t01 + t10) + (t02 + t11)) + t20)


def rows(a, b):
    """a b over K = 32 rows (a [N, M, 32], b [N, 32, 128] fp32) as rows_mma:
    a fresh accumulator, the small terms' steps first, then the main
    term's. fp32 [N, M, 128]."""
    a_p, b_p = _parts(a), _parts(b)
    acc = torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float64)
    for i, j in SMALL + ((0, 0),):
        for k0 in range(0, a.shape[-1], 16):
            sl = slice(k0, k0 + 16)
            acc = _rz(acc + a_p[i][..., sl] @ b_p[j][..., sl, :])
    return acc.float()


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------


class Mask:
    """One call's mask as the kernels read it: mode None, "causal",
    "segments" or "packed"; per batch row the causal offset, the codes and
    the two tile lists (the plain lists, which the card's tile_lists kernel
    writes bit for bit)."""

    def __init__(self, b, lq, lk, kv_len=None, causal=False, q_offset=0,
                 q_offsets=None, q_segments=None, kv_segments=None,
                 packed_mode=False):
        self.lq, self.lk = lq, lk
        self.ends = [lk] * b if kv_len is None else [
            min(max(int(x), 0), lk) for x in kv_len]
        self.mode = ("causal" if causal else None if q_segments is None
                     else "packed" if packed_mode else "segments")
        self.offs = [q_offset + (0 if q_offsets is None else int(q_offsets[i]))
                     for i in range(b)]
        self.qc, self.kc = q_segments, kv_segments
        if self.mode in ("segments", "packed"):
            self.fwd, self.bwd = tfa.tile_lists(
                b, lq, lk, "cpu", kv_len=_kvl(kv_len), q_segments=q_segments,
                kv_segments=kv_segments, packed_mode=packed_mode)

    def seg(self):
        return self.mode in ("segments", "packed")

    def kv_steps(self, bi, r0, n_rows):
        """(kv tile, need) of a forward / dq block's steps: q rows r0 ..
        r0 + n_rows - 1 of batch row bi."""
        end = self.ends[bi]
        n = -(-end // KT)
        if self.mode == "causal":
            first = r0 + self.offs[bi]
            last = first + n_rows - 1
            n = 0 if last < 0 else min(n, last // KT + 1)
            return [(j, (j + 1) * KT > end or (j + 1) * KT - 1 > first)
                    for j in range(n)]
        if self.seg():
            lst, cnt = self.fwd
            qt = r0 // FQ
            out = []
            for e in range(int(cnt[bi, qt])):
                code = int(lst[bi, qt, e])
                for sub in range(4):
                    j = (code >> 1) * 4 + sub
                    if j * KT < end:   # only the last entry reaches kv_end
                        out.append((j, not code & 1))
            return out
        return [(j, (j + 1) * KT > end) for j in range(n)]

    def q_steps(self, bi, kv0):
        """(q tile, need) of a dk/dv block's steps (kv rows kv0 .. kv0 +
        63); keys at or past kv_len are dead in every step."""
        nq = self.lq // KT
        if self.mode == "causal":
            off = self.offs[bi]
            x = kv0 - off - (KT - 1)
            i0 = 0 if x <= 0 else min(-(-x // KT), nq)
            return [(i, i * KT + off < kv0 + RQ - 1) for i in range(i0, nq)]
        if self.seg():
            lst, cnt = self.bwd
            kt = kv0 // 128
            return [((int(lst[bi, kt, e]) >> 1) * 2 + sub,
                     not int(lst[bi, kt, e]) & 1)
                    for e in range(int(cnt[bi, kt])) for sub in range(2)]
        return [(i, False) for i in range(nq)]

    def dead(self, bi, rows_, cols):
        """The predicate on q rows `rows_` x keys `cols` (pack indices):
        bool [len(rows_), len(cols)], with kv_len."""
        r, c = rows_[:, None], cols[None, :]
        d = (c >= self.ends[bi]).expand(len(rows_), len(cols))
        if self.mode == "causal":
            d = d | (c > r + self.offs[bi])
        elif self.seg():
            qc, kc = self.qc[bi][rows_][:, None], self.kc[bi][cols][None, :]
            if self.mode == "packed":
                d = d | ~tfa.packed_mask_allowed(qc, kc, r, c)
            else:
                d = d | (qc != kc)
        return d


def fwd_walk(qs, k, v, mk):
    """The forward kernel: (o fp32 [B, Lq, N, 128], lse [B, N, Lq])."""
    b, lq, n, _ = qs.shape
    k, v = tfa.repeat_kv(k, n), tfa.repeat_kv(v, n)   # head h reads h // g
    o = torch.zeros(qs.shape)
    lse = torch.zeros((b, n, lq))
    for bi in range(b):
        for q0 in range(0, lq, FQ):
            n_cons = 2 if q0 + 64 < lq else 1
            steps = mk.kv_steps(bi, q0, 64 * n_cons)
            for c in range(n_cons):
                r = torch.arange(q0 + 64 * c, q0 + 64 * c + 64)
                qt = qs[bi, r].transpose(0, 1)                     # [N, 64, D]
                m = torch.full((n, 64), NEG)
                l = torch.zeros((n, 64))
                acc = torch.zeros((n, 64, D))
                for j, need in steps:
                    cols = torch.arange(j * KT, j * KT + KT)
                    s = scores(qt, k[bi, cols].transpose(0, 1))
                    dead = None
                    if need:
                        dead = mk.dead(bi, r, cols)[None].expand_as(s)
                        s = s.masked_fill(dead, NEG)
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - m_new)
                    m = m_new
                    p = torch.exp2(s - m[..., None])
                    if dead is not None:
                        p = p.masked_fill(dead, 0.0)
                    l = l * corr + p.sum(-1)
                    o_t = rows(p, v[bi, cols].transpose(0, 1))
                    # the kernel's FMA: one rounding of o * corr + o_t
                    acc = (acc.double() * corr.double()[..., None]
                           + o_t.double()).float()
                inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
                o[bi, r] = (acc * inv[..., None]).transpose(0, 1)
                lse[bi, :, r] = torch.where(
                    l > 0, m + torch.log2(torch.where(l > 0, l, 1.0)), -NEG)
    return o, lse


def dq_walk(qs, k, v, do, lse, delta, mk, scale):
    """The dq kernel: each 64-row q tile over its steps, step s taken by
    consumer s % 2, dq = (sum_0 + sum_1) * scale."""
    b, lq, n, _ = qs.shape
    dq = torch.zeros(qs.shape)
    for bi in range(b):
        for q0 in range(0, lq, RQ):
            r = torch.arange(q0, q0 + RQ)
            qt, dot = (x[bi, r].transpose(0, 1) for x in (qs, do))
            lr, dl = lse[bi][:, r], delta[bi][:, r]
            runs = [torch.zeros((n, RQ, D)) for _ in range(2)]
            for s_i, (j, need) in enumerate(mk.kv_steps(bi, q0, RQ)):
                cols = torch.arange(j * KT, j * KT + KT)
                kt, vt = k[bi, cols].transpose(0, 1), v[bi, cols].transpose(0, 1)
                s = scores(qt, kt)
                if need:
                    s = s.masked_fill(mk.dead(bi, r, cols)[None], NEG)
                p = torch.exp2(s - lr[..., None])
                ds = p * (scores(dot, vt) - dl[..., None])
                runs[s_i % 2] = runs[s_i % 2] + rows(ds, kt)
            dq[bi, r] = ((runs[0] + runs[1]) * scale).transpose(0, 1)
    return dq


def dkv_walk(qs, k, v, do, lse, delta, mk):
    """The dk/dv kernel: each 64-row kv tile below kv_len over its 32-row q
    tiles; kv rows at or past kv_len dead in every step."""
    b, lk, n, _ = k.shape
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for bi in range(b):
        end = mk.ends[bi]
        for kv0 in range(0, min(end, lk), RQ):
            kr = torch.arange(kv0, kv0 + RQ)
            kt, vt = k[bi, kr].transpose(0, 1), v[bi, kr].transpose(0, 1)
            dead_rows = (kr >= end)[None, :, None]
            a_dk = torch.zeros((n, RQ, D))
            a_dv = torch.zeros((n, RQ, D))
            for i, need in mk.q_steps(bi, kv0):
                r = torch.arange(i * KT, i * KT + KT)
                qt, dot = (x[bi, r].transpose(0, 1) for x in (qs, do))
                st = scores(kt, qt)
                dead = dead_rows.expand_as(st)
                if need:
                    dead = dead | mk.dead(bi, r, kr).T[None]
                pt = torch.exp2(st.masked_fill(dead, NEG) - lse[bi][:, None, r])
                dst = pt * (scores(vt, dot) - delta[bi][:, None, r])
                a_dv = a_dv + rows(pt, dot)
                a_dk = a_dk + rows(dst, qt)
            dk[bi, kr] = (a_dk * tfa.LN2).transpose(0, 1)
            dv[bi, kr] = a_dv.transpose(0, 1)
    return dk, dv


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def _normed(rng, shape, gains):
    x = rng.standard_normal(shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True) * D ** 0.5 * gains


def _case(name):
    """(q, k, v, do numpy fp32 [B, L, N(k), 128] seeded, kv_len tuple or
    None, mask keywords (numpy), the query rows that see some key)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, lq, lk, n, nk = 2, 256, 256, 2, 2
    kv_len = None
    kw = {}
    if name == "causal":
        kw = dict(causal=True, q_offset=13)
    elif name == "causal_offsets":
        kw = dict(causal=True, q_offsets=np.array([37, 100], np.int32))
        kv_len = (200, 256)
    elif name == "causal_prefill":   # the QA prefill's form, narrow
        lq, lk, n, nk = 64, 256, 4, 1
        kw = dict(causal=True, q_offsets=np.array([150, 171], np.int32))
        kv_len = (197, 235)
    elif name == "causal_grouped":
        n = 4
        kw = dict(causal=True, q_offset=5)
        kv_len = (180, 256)
    elif name == "grouped":
        n, nk = 4, 1
        kv_len = (190, 64)
    elif name == "segments":
        qs = np.zeros((b, lq), np.int32)
        qs[:, 70:] = 1
        qs[1, 150:] = 2
        qs[:, -20:] = -1
        ks = qs.copy()
        ks[:, -20:] = -2
        kw = dict(q_segments=qs, kv_segments=ks)
        kv_len = (256, 200)
    elif name == "packed":
        c = np.asarray(_pack_codes()[:, :200])
        plan = tfa.build_tile_plan(torch.as_tensor(c), torch.as_tensor(c),
                                   packed_mode=True)
        b, lq = plan.q_codes.shape
        lk = lq
        kw = dict(q_segments=plan.q_codes.numpy(),
                  kv_segments=plan.kv_codes.numpy(), packed_mode=True)
        kv_len = tuple(int(x) for x in plan.kv_len)
    q = _normed(rng, (b, lq, n, D), rng.uniform(0.5, 1.5, D))
    k = _normed(rng, (b, lk, nk, D), rng.uniform(0.5, 1.5, D))
    v = rng.standard_normal((b, lk, nk, D))
    do = rng.standard_normal((b, lq, n, D)) * 0.1
    mk = Mask(b, lq, lk, kv_len, **_t(kw))
    alive = np.stack([~mk.dead(bi, torch.arange(lq), torch.arange(lk))
                      .numpy() for bi in range(b)])
    live = alive.any(-1)
    # keys no query may see hold 50.0, as in the fp32 accuracy tests
    k = np.where(alive.any(1)[:, :, None, None], k, 50.0)
    v = np.where(alive.any(1)[:, :, None, None], v, 50.0)
    f = (lambda x: x.astype(np.float32))
    return f(q), f(k), f(v), f(do), kv_len, kw, live


def _t(kw):
    return {key: (torch.as_tensor(x) if isinstance(x, np.ndarray) else x)
            for key, x in kw.items()}


CASES = ["causal", "causal_offsets", "causal_prefill", "causal_grouped",
         "grouped", "segments", "packed"]
BWD_CASES = [c for c in CASES if "grouped" not in c and c != "causal_prefill"]


def _kvl(kv_len):
    return None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)


def _fwd_excess(got, ref):
    return float(((got.double() - ref.double()).abs()
                  / (1e-5 + 1e-4 * ref.double().abs())).max())


def _grad_ok(got, ref):
    got, ref = got.double(), ref.double()
    lim = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    rel = float((got - ref).norm() / ref.norm())
    return bool(((got - ref).abs() <= lim).all()) and rel < 1e-4, rel


@pytest.fixture(scope="module")
def walked():
    """Each case's walk and plain results, computed once."""
    out = {}
    for name in CASES:
        q, k, v, do, kv_len, kw, live = _case(name)
        qt, kt, vt, dot = (torch.as_tensor(x) for x in (q, k, v, do))
        masks, kvl = _t(kw), _kvl(kv_len)
        sc = D ** -0.5
        qs = tfa._fold(qt, sc)
        mk = Mask(q.shape[0], q.shape[1], k.shape[1], kv_len, **masks)
        po, plse = tfa.attention_plain(qs, kt, vt, kv_len=kvl,
                                       save_residuals=True, **masks)
        rec = dict(q=q, k=k, v=v, do=do, kv_len=kv_len, kw=kw, live=live,
                   qs=qs, mk=mk, po=po, plse=plse, sc=sc,
                   walk=fwd_walk(qs, kt, vt, mk))
        if name in BWD_CASES:
            delta = (dot * po).sum(-1).transpose(1, 2)
            rec["dq"] = dq_walk(qs, kt, vt, dot, plse, delta, mk, sc)
            rec["dkv"] = dkv_walk(qs, kt, vt, dot, plse, delta, mk)
            rec["plain_bwd"] = tfa._bwd_plain_folded(qs, kt, vt, po, plse,
                                                     dot, kvl, sc, **masks)
        out[name] = rec
    return out


@pytest.mark.parametrize("case", CASES)
def test_forward_walk_within_fp32_bounds(walked, case):
    """The forward kernel's walk against the plain forward with lse: output
    within 1e-5 + 1e-4 |ref|, lse within 1e-4 on live rows; rows with no
    live key exactly 0 with lse +1e30."""
    c = walked[case]
    o, lse = c["walk"]
    live = torch.as_tensor(c["live"])
    assert _fwd_excess(o, c["po"]) <= 1.0
    lse_live = live[:, None, :].expand_as(lse)
    assert float((lse - c["plse"])[lse_live].abs().max()) <= 1e-4
    assert bool((o[~live] == 0).all())
    assert bool((lse[~lse_live] == -NEG).all())
    assert bool((c["plse"][~lse_live] == -NEG).all())


@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_walks_within_fp32_bounds(walked, case):
    """The dq and dk/dv kernels' walks against the plain backward, from the
    plain forward's residuals: each within 1e-4 max|ref| + 1e-4 |ref| and
    rel. L2 < 1e-4; dq exactly 0 on rows that see no key, dk and dv
    exactly 0 on keys no row sees (past kv_len included)."""
    c = walked[case]
    want = c["plain_bwd"]
    got = (c["dq"],) + c["dkv"]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        ok, rel = _grad_ok(g, w)
        assert ok, (name, rel)
    live = torch.as_tensor(c["live"])
    assert bool((got[0][~live] == 0).all())
    mk = c["mk"]
    for bi in range(len(mk.ends)):
        seen = ~mk.dead(bi, torch.arange(mk.lq), torch.arange(mk.lk)).all(0)
        for g in got[1:]:
            assert bool((g[bi][~seen] == 0).all())


@pytest.mark.parametrize("case", ["causal_offsets", "segments", "packed"])
def test_walk_skips_and_predicate_only_where_needed(walked, case):
    """The walks leave out every tile the dense predicate kills, and a tile
    a walk takes without the predicate has no dead pair (so skipping the
    compare changes nothing)."""
    mk = walked[case]["mk"]
    b = len(mk.ends)
    for bi in range(b):
        alive = ~mk.dead(bi, torch.arange(mk.lq), torch.arange(mk.lk))
        for r0, n_rows in [(q0, RQ) for q0 in range(0, mk.lq, RQ)]:
            steps = dict(mk.kv_steps(bi, r0, n_rows))
            for j in range(mk.lk // KT):
                blk = alive[r0:r0 + n_rows, j * KT:(j + 1) * KT]
                if bool(blk.any()):
                    assert j in steps, (bi, r0, j)
                if j in steps and not steps[j]:
                    assert bool(blk.all()), (bi, r0, j)
        for kv0 in range(0, mk.ends[bi], RQ):
            steps = dict(mk.q_steps(bi, kv0))
            for i in range(mk.lq // KT):
                blk = alive[i * KT:(i + 1) * KT, kv0:kv0 + RQ]
                blk = blk[:, :max(0, min(RQ, mk.ends[bi] - kv0))]
                if bool(blk.any()):
                    assert i in steps, (bi, kv0, i)
                if i in steps and not steps[i]:
                    assert bool(blk.all()), (bi, kv0, i)


def _jax_fwd_bwd(q, k, v, do, kv_len, kw):
    jkw = {key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}
    if kv_len is not None:
        jkw["kv_len"] = jnp.asarray(kv_len, jnp.int32)
    blk = dict(block_q=128, block_k=128, interpret=True)
    qj, kj, vj, dj = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jl = jfa.flash_attention_padded(qj, kj, vj, save_residuals=True,
                                        **blk, **jkw)
    grads = jfa.flash_attention_bwd_padded(qj, kj, vj, jo, jl, dj,
                                           fused=True, **blk, **jkw)
    return jo, jl, grads


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", ["causal_offsets", "causal_grouped",
                                  "segments", "packed"])
def test_plain_versions_match_pallas(walked, case):
    """The plain forward (with lse) and backward against JAX's Pallas
    forward and fused backward in interpret mode under the same mask, on
    live rows, at 1e-5 relative L2 (fp32 summation order and JAX's exp2
    differ); grouped kv heads against JAX on the repeated heads, as the
    JAX prefill repeats them."""
    c = walked[case]
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    b, lq, n, _ = q.shape
    live = c["live"]
    do = do * live[:, :, None, None]   # the dispatcher's slice: pad rows 0
    kr, vr = (np.repeat(x, n // x.shape[2], axis=2) for x in (k, v))
    jo, jl, jgrads = _jax_fwd_bwd(q, kr, vr, do, c["kv_len"], c["kw"])
    po, plse = c["po"], c["plse"]
    assert _rel(po.numpy()[live], np.asarray(jo)[live]) < 1e-5
    lse_live = live[:, None, :].repeat(n, axis=1)
    assert _rel(plse.numpy()[lse_live], _jlse(jl, b, n)[lse_live]) < 1e-5
    if case == "causal_grouped":
        return
    got = tfa._bwd_plain_folded(
        c["qs"], *(torch.as_tensor(x) for x in (k, v)), po, plse,
        torch.as_tensor(do), _kvl(c["kv_len"]), c["sc"], **_t(c["kw"]))
    for g, w, name in zip(got, jgrads, ("dq", "dk", "dv")):
        g, w = g.numpy(), np.asarray(w)
        if name == "dq":
            g, w = g[live], w[live]
        assert _rel(g, w) < 1e-5, name


def test_plain_kernel_routes_cpu_take_every_mode():
    """On CPU tensors the routes (`flash_attention_fwd_folded`,
    `flash_attention_bwd_folded`, `attention`) take the new modes through
    the plain versions: causal with device offsets and grouped kv heads
    without grad, the packed pass under grad; the launch counters stay 0."""
    from univid_tpu_torch.kernels.attention import attention
    q, k, v, do, kv_len, kw, live = _case("causal_grouped")
    tfa.reset_launches()
    out = attention(*(torch.as_tensor(x) for x in (q, k, v)),
                    kv_len=_kvl(kv_len), **_t(kw))
    want = tfa.attention_plain(
        tfa._fold(torch.as_tensor(q), D ** -0.5), torch.as_tensor(k),
        torch.as_tensor(v), kv_len=_kvl(kv_len), **_t(kw))
    assert torch.equal(out, want)
    assert not any(tfa.LAUNCHES_BY_MODE.values())
    assert not any(tfa.GROUPED_LAUNCHES.values())
