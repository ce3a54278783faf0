"""The masked modes' block-sparse tile skip on the CPU: the tile list of
`mask_tile_list_plain` (which kv tiles of 128 keys each 128-row q tile must
visit, and which of them need no compare) against the dense `_dead`
predicate, tile by tile, on packs built by the port's packer (as they come
and padded with the dispatcher's pad ids), with kv_len, and on segment ids;
and a plain forward that visits only the listed tiles, as the sm90 kernel
walks them (running max, the compare and select only in tiles not flagged
full), against the dense plain forward and the Pallas kernel in interpret
mode.

The CUDA pre-pass and kernel run only on a card: tests/test_torch_cuda.py
and chip_smoke.py hold the kernel's list against this plain one exactly.
Tolerances: the walk against the dense plain forward 1e-6 (fp32, another
summation order and reference point); against JAX 1e-4 (fp32, as in
tests/test_torch_attention_bwd.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import univid_tpu.kernels.flash_attention as jfa
from tests.test_torch_attention_bwd import _jlse, _masked_case
from univid_tpu_torch.data.packed_dataset import (PackedDataConfig,
                                                  PackedDataset)
from univid_tpu_torch.kernels import flash_attention as tfa
from univid_tpu_torch.models.bagel.bagel import BagelConfig

torch.set_num_threads(2)
BQ = BK = 128   # the sm90 kernel's q and kv tiles
WALK = dict(rtol=1e-6, atol=1e-6)
FP32 = dict(rtol=1e-4, atol=1e-4)


def _pack_codes(seed=0):
    """pack_mask_codes codes [1, L] of one pack of BAGEL's four sample kinds
    (VLM, T2I, edit, text-only), built by the port's PackedDataset at a
    small size (~650 tokens and the packer's pad tokens up to 1,024:
    several 128-token tiles a document)."""
    cfg = BagelConfig()
    rng = np.random.default_rng(seed)
    np.random.seed(seed)   # pack_sequence draws the flow timesteps

    def item(kind, loss):
        return {"type": kind, "enable_cfg": 0, "loss": loss,
                "special_token_loss": 0}

    def ids(n):
        return rng.integers(0, cfg.start_of_image - 4, n).tolist()

    def image(side):
        return rng.uniform(-1, 1, (side, side, 3)).astype(np.float32)

    def latent(side):
        return rng.standard_normal(
            (side, side, cfg.patch_latent_dim)).astype(np.float32)

    samples = [
        {"sequence_plan": [item("vit_image", 0), item("text", 0),
                           item("text", 1)],
         "text_ids_list": [ids(24), ids(60)], "image_list": [image(112)]},
        {"sequence_plan": [item("text", 0), item("vae_image", 1)],
         "text_ids_list": [ids(20)], "image_list": [latent(12)]},
        {"sequence_plan": [item("text", 0), item("vit_image", 0),
                           item("vae_image", 0), item("vae_image", 1)],
         "text_ids_list": [ids(16)],
         "image_list": [image(56), latent(6), latent(6)]},
        {"sequence_plan": [item("text", 1)], "text_ids_list": [ids(200)],
         "image_list": []},
    ]
    ds = PackedDataset([(lambda: iter([]), 1.0)], data_config=PackedDataConfig(
        vit_patch_size=cfg.vit_patch_size,
        max_num_patch_per_side=cfg.vit_max_num_patch_per_side,
        max_latent_size=cfg.max_latent_size,
        latent_channel=cfg.latent_channel, bos_token_id=cfg.bos_token_id,
        eos_token_id=cfg.eos_token_id, start_of_image=cfg.start_of_image,
        end_of_image=cfg.end_of_image), max_num_tokens=1024)
    st = ds._fresh_status()
    for s in samples:
        st = ds.pack_sequence(s, st)
    return torch.as_tensor(np.asarray(ds.to_batch(st, [])["mask_codes"]),
                           dtype=torch.int32)[None]


def _segments():
    """Segment ids [2, 704] (3 a row, boundaries inside tiles) and kv ids
    [2, 448] of another length (a q tile's row range is not its key
    range)."""
    qs = np.zeros((2, 704), np.int32)
    qs[0, 300:] = 1
    qs[0, 610:] = 2
    qs[1, 90:] = 1
    qs[1, 500:] = 2
    ks = np.zeros((2, 448), np.int32)
    ks[:, 200:] = 1
    ks[1, 400:] = 2
    return torch.as_tensor(qs), torch.as_tensor(ks)


def _case(name):
    """(q codes [B, Lq], kv codes [B, Lk], kv_len or None, packed_mode)."""
    if name.startswith("pack"):
        c = _pack_codes()
        if name == "pack":
            return c, c, None, True
        # the dispatcher's padding: Lq, Lk up to a multiple of 64 and 64
        # more, pad ids -1 (queries) / -2 (keys), kv_len the real length
        lp = (c.shape[1] + 63) // 64 * 64 + 64
        qc = torch.full((1, lp), -1, dtype=torch.int32)
        kc = torch.full((1, lp), -2, dtype=torch.int32)
        qc[:, :c.shape[1]] = c
        kc[:, :c.shape[1]] = c
        kv_len = torch.tensor([c.shape[1]], dtype=torch.int32)
        if name == "pack_kv_len":   # a kv_len inside a document
            kv_len = torch.tensor([c.shape[1] - 150], dtype=torch.int32)
        return qc, kc, kv_len, True
    qs, ks = _segments()
    if name == "segments_kv_len":
        return qs, ks, torch.tensor([448, 250], dtype=torch.int32), False
    return qs, ks, None, False


CASES = ["pack", "pack_padded", "pack_kv_len", "segments", "segments_kv_len"]


def _alive(qc, kc, kv_len, packed):
    """The allowed pairs, bool [B, Lq, Lk] (`_dead`'s complement)."""
    dead = tfa._dead(0, qc.shape[1], kc.shape[1], "cpu", kv_len=kv_len,
                     q_segments=qc, kv_segments=kc, packed_mode=packed)
    return ~dead[:, 0]


@pytest.mark.parametrize("case", CASES)
def test_tile_list_matches_dead_predicate(case):
    """Tile j is in q tile i's list iff some pair of a row below Lq and a
    key of tile j is allowed; the list is ascending, its count is right
    and the entries past the count are -1."""
    qc, kc, kv_len, packed = _case(case)
    lists, count = tfa.mask_tile_list_plain(qc, kc, kv_len, packed)
    alive = _alive(qc, kc, kv_len, packed)
    b, lq, lk = alive.shape
    qt, kt = -(-lq // BQ), -(-lk // BK)
    assert lists.shape == (b, qt, kt) and count.shape == (b, qt)
    assert lists.dtype == count.dtype == torch.int32
    n_live = 0
    for bi in range(b):
        for i in range(qt):
            want = [j for j in range(kt) if bool(
                alive[bi, i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK].any())]
            n = int(count[bi, i])
            assert [int(x) >> 1 for x in lists[bi, i, :n]] == want
            assert bool((lists[bi, i, n:] == -1).all())
            n_live += n
    # the cases skip tiles: the list is a strict subset of the dense grid
    assert 0 < n_live < b * qt * kt


@pytest.mark.parametrize("case", CASES)
def test_full_flag_is_exact(case):
    """A listed tile is flagged full iff every pair of its rows below Lq
    and its BK keys is allowed (a key at or past Lk or kv_len counts as
    dead): the kernel skips the compare only where nothing is masked."""
    qc, kc, kv_len, packed = _case(case)
    lists, count = tfa.mask_tile_list_plain(qc, kc, kv_len, packed)
    alive = _alive(qc, kc, kv_len, packed)
    b, lq, lk = alive.shape
    n_full = n_part = 0
    for bi in range(b):
        for i in range(count.shape[1]):
            for e in lists[bi, i, :int(count[bi, i])].tolist():
                j, full = e >> 1, bool(e & 1)
                tile = alive[bi, i * BQ:(i + 1) * BQ, j * BK:(j + 1) * BK]
                want = tile.shape[1] == BK and bool(tile.all())
                assert full == want, (bi, i, j)
                n_full += full
                n_part += not full
    assert n_full > 0 and n_part > 0   # both kinds of tile occur


def _walk(qs, k, v, qc, kc, kv_len, packed, builder="pair"):
    """The sm90 kernel's walk in plain fp32: per (b, q tile) only the listed
    kv tiles, a running max (a row with none yet takes the reference 0),
    the predicate applied only in tiles not flagged full. The list from
    `builder`: "pair" the plain list (`mask_tile_list_plain`), "runs" the
    new kernel's rule (`tile_lists_by_runs`). (o, lse)."""
    if builder == "runs":
        (lists, count), _ = tfa.tile_lists_by_runs(
            qc.shape[0], qc.shape[1], kc.shape[1], kv_len=kv_len,
            q_segments=qc, kv_segments=kc, packed_mode=packed)
    else:
        lists, count = tfa.mask_tile_list_plain(qc, kc, kv_len, packed)
    alive = _alive(qc, kc, kv_len, packed)
    b, lq, n, d = qs.shape
    o = torch.zeros_like(qs)
    lse = torch.full((b, n, lq), 1e30)
    for bi in range(b):
        for i in range(count.shape[1]):
            r0, r1 = i * BQ, min((i + 1) * BQ, lq)
            qt = qs[bi, r0:r1].transpose(0, 1)          # [n, rows, d]
            m = torch.full((n, r1 - r0, 1), tfa.NEG_INF)
            l = torch.zeros((n, r1 - r0, 1))
            acc = torch.zeros((n, r1 - r0, d))
            for e in lists[bi, i, :int(count[bi, i])].tolist():
                j, full = e >> 1, e & 1
                c0, c1 = j * BK, min((j + 1) * BK, k.shape[1])
                s = qt @ k[bi, c0:c1].transpose(0, 1).transpose(1, 2)
                if not full:
                    s = s.masked_fill(~alive[bi, r0:r1, c0:c1], tfa.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                ref = torch.where(m_new == tfa.NEG_INF, 0.0, m_new)
                corr = torch.exp2(m - ref)
                p = torch.exp2(s - ref)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p @ v[bi, c0:c1].transpose(0, 1)
                m = m_new
            live = l > 0
            o[bi, r0:r1] = torch.where(live, acc / torch.where(live, l, 1.0),
                                       0.0).transpose(0, 1)
            lse[bi, :, r0:r1] = torch.where(
                live, m + torch.log2(torch.where(live, l, 1.0)), 1e30)[..., 0]
    return o, lse


def _qkv(lq, lk, b, seed, n=2, d=128):
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((b, lq, n, d)).astype(np.float32) * 0.15
    k, v = (rng.standard_normal((b, lk, n, d)).astype(np.float32)
            for _ in range(2))
    return torch.as_tensor(qs), torch.as_tensor(k), torch.as_tensor(v)


@pytest.mark.parametrize("case", CASES)
def test_tile_walk_matches_dense_forward(case):
    """The listed tiles alone, walked as the kernel walks them, give the
    dense plain forward's output and lse (fp32, 1e-6): no skipped tile held
    a live pair and no tile flagged full held a dead one. Rows with no live
    key are exactly 0 with lse +1e30 in both."""
    qc, kc, kv_len, packed = _case(case)
    qs, k, v = _qkv(qc.shape[1], kc.shape[1], qc.shape[0], 7)
    # keys no query may see (pad ids, at or past kv_len) hold large values
    drop = kc == -2
    if kv_len is not None:
        drop |= torch.arange(kc.shape[1])[None, :] >= kv_len[:, None]
    k[drop] = 50.0
    v[drop] = 50.0
    want_o, want_lse = tfa.attention_plain(
        qs, k, v, kv_len=kv_len, q_segments=qc, kv_segments=kc,
        packed_mode=packed, save_residuals=True)
    got_o, got_lse = _walk(qs, k, v, qc, kc, kv_len, packed)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), **WALK)
    fin = want_lse < 1e29
    np.testing.assert_allclose(got_lse[fin].numpy(), want_lse[fin].numpy(),
                               **WALK)
    assert bool((got_lse[~fin] == 1e30).all())
    assert bool((got_o.transpose(1, 2)[~fin] == 0).all())


@pytest.mark.parametrize("mode,builder", [
    pytest.param("packed", "pair", id="packed"),
    pytest.param("segments", "pair", id="segments"),
    pytest.param("packed", "runs", id="packed-runs"),
    pytest.param("segments", "runs", id="segments-runs")])
def test_tile_walk_matches_pallas_kernel(mode, builder):
    """The walk against univid_tpu's Pallas kernel in interpret mode
    (save_residuals, fp32, d=128) on the small packed and segment cases of
    the backward tests (pad ids -1 / -2 in the last 20 rows and keys),
    over the plain list ("pair") and over the new kernel's run rule
    ("runs"): equal on the rows that see a key; the pad rows 0 with lse
    +1e30."""
    q, k, v, kw, live = _masked_case(mode)
    b, l, n, d = q.shape
    qs = tfa._fold(torch.as_tensor(q), d ** -0.5)
    jo, jl = jfa.flash_attention_padded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
        block_k=128, interpret=True, save_residuals=True,
        q_segments=jnp.asarray(kw["q_segments"]),
        kv_segments=jnp.asarray(kw["kv_segments"]),
        packed_mode=kw.get("packed_mode", False))
    to, tl = _walk(qs, torch.as_tensor(k), torch.as_tensor(v),
                   torch.as_tensor(kw["q_segments"]),
                   torch.as_tensor(kw["kv_segments"]), None,
                   kw.get("packed_mode", False), builder)
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live], **FP32)
    lse_live = live[:, None, :].repeat(n, axis=1)
    np.testing.assert_allclose(tl.numpy()[lse_live],
                               _jlse(jl, b, n)[lse_live], **FP32)
    assert np.all(to.numpy()[~live] == 0.0)
    assert np.all(tl.numpy()[~lse_live] == 1e30)
