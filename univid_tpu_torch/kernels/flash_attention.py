"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of univid_tpu/kernels/flash_attention.py for the modes the t2v
and training paths reach:

  * `flash_attention_padded` — `_flash_kernel`: non-causal attention in the
    exp2 domain with the fused-rope prologue, the bounded softmax (or a
    running max), `kv_len` masking and zero rows when l == 0. bf16 d=128
    runs csrc/flash_attention_sm90.cu (wgmma, TMA, warp specialisation) in
    its unmasked modes (DiT self-attention, the training forward, BAGEL's
    ViT append) and its segment and packed ones (BAGEL packed training,
    over the forward tile list of `tile_lists`: the live kv tiles of each
    q tile),
    and csrc/flash_attention_causal_sm90.cu in the causal one
    (`bf16_forward_route`); fp32 d=128 runs
    csrc/flash_attention_f32_sm90.cu (the DiT at the fp32 policy, serving
    and training: wgmma on three bf16 parts of each operand, split by the
    pre-pass `split_bf16x3`, at fp32 accuracy; the fp32 cross-attention at
    Lk = 512 takes it too; the rope pre-pass `rope_rotate_f32` of
    csrc/flash_attention_f32_d128.cu rotates first); fp32 d=384, 640 and 1024
    run csrc/flash_attention_f32_tc.cu (VAE mid-block attention of the
    t2v-1.3B and the ti2v-5B VAEs: 3xTF32 tensor-core products over a
    materialised score matrix). With
    `save_residuals=True` (the training forward) it also returns the
    per-row exp2-domain lse, fp32 [B, N, Lq]. `causal` with a static
    `q_offset` and a device `q_offsets` int32 [B] is `_flash_kernel`'s
    causal mode (BAGEL's KV-cache prefill), bf16 d=128 with and without
    the lse on csrc/flash_attention_causal_sm90.cu (wgmma / TMA, the query
    heads of one kv head packed over one k / v stream, a split-kv pass and
    an lse merge when its blocks cannot fill the card: `causal_splits`,
    from the shapes alone; `causal_split_plain` emulates its arithmetic for
    the tests), counted apart as `flash_attention_bf16_causal`. `q_segments`
    [B, Lq] / `kv_segments` [B, Lk] int32 are its segment mode, and with
    `packed_mode` the same ids are pack_mask_codes codes (BAGEL packed
    training's mask): running max, with and without the lse.
  * `cross_attention_padded` — `_cross_kernel`: single-kv-block attention
    (Lk <= 512) with a one-shot softmax by the row max or by the bound, on
    csrc/flash_attention_sm90.cu.
  * `softmax_bf16` (the Wan serving knob --bf16_softmax) on both: the
    softmax chain in bf16 (bf16 scores and reference point, a bf16 s - ref
    and exp2, the row sum of the rounded p in fp32), non-causal and
    unsegmented: bf16 d=128 on csrc/flash_attention_sm90.cu (counted apart
    as `flash_attention_bf16_sbf16` and `cross_attention_bf16_sbf16`);
    fp32 d=128 (the Wan DiT under an fp32 policy) on the SBF16 modes of
    csrc/flash_attention_f32_sm90.cu, p one bf16 part against v's three
    (`f32_forward_route`; `flash_attention_f32_sm90_sbf16`, and
    `..._sbf16_oneshot` for the cross call at Lk <= 512 without a bound,
    which sweeps QK^T for the row max first, as JAX's one-block
    `_cross_kernel` takes it).
  * `qk_int8` (--qk_int8) — `_flash_kernel`'s int8 QK^T mode: the pre-pass
    `quantize_qk_int8` (fused rope in fp32, per-row q scales, one k scale per
    JAX kv block of `block_k` keys) and `flash_attention_int8` (int8 x int8
    -> int32 scores rescaled in fp32, the fp32 or the bf16 softmax chain,
    p v in bf16), d=128 with kv_len and the bound: the pre-pass on
    csrc/qk_prepass.cu (kernel B, blocks over tokens with all their heads;
    bf16 or fp32 rows, `quantize_qk_int8` / `quantize_qk_int8_f32`), the
    attention on csrc/flash_attention_int8_sm90.cu for bf16 v (s8 wgmma,
    TMA, warp specialisation; `flash_attention_int8` and
    `flash_attention_int8_sbf16`) and on the INT8 modes of
    csrc/flash_attention_f32_sm90.cu for fp32 v (s8 wgmma scores, p v at
    fp32 accuracy on v's three bf16 parts: `flash_attention_f32_sm90_int8`
    and `..._int8_sbf16`).
  * `qk_norm_rope` — the fused-rope prologue (`_rot`, :119-135) with Wan's
    qk RMS norm over the token's N * D width as its own prologue (the JAX
    package's XLA fusion before the kernel): norm + rope, norm only, or
    rope only, q and k in one launch of csrc/qk_prepass.cu (kernel A);
    counted as `qk_norm_rope_bf16`, `qk_norm_bf16` and `qk_rope_bf16`.
    `flash_attention_padded(qk_norm=(gain_q, gain_k, eps))` takes q and k
    before their norm: on the card's bf16 route kernel A norms (and
    rotates) them, elsewhere `qk_norm_rope_plain` does.
  * `flash_attention_bwd_padded` — `_flash_bwd_fused_kernel` and the
    two-pass `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel`: dq, dk, dv
    rebuilt from the lse. bf16 d=128 (`bf16_backward_route`): every mode
    on csrc/flash_attention_bwd_sm90.cu, the one-pass form on wgmma / TMA
    (three launches: delta and the zeroed fp32 accumulators, the main
    kernel, the accumulators to bf16; not deterministic: dq sums by atomic
    reductions): the unmasked ones with or without kv_len at any Lk, and
    causal (static and device offsets), segment and packed masks, which
    walk a kv-major tile list (for each kv tile the q tiles with a live
    pair). fp32 d=128 with
    kv_len on csrc/flash_attention_f32_sm90.cu (a dq kernel, which also
    writes delta, and a dk/dv kernel, on the split operands; deterministic:
    no atomics), under the causal, segment and packed masks too.
    The fp32 d=128 forward (with and without the lse) takes every mask and
    grouped kv heads as well: BAGEL-7B-MoT at fp32 compute reaches them
    (`InterleaveInferencer(..., compute_dtype=torch.float32)`: the ViT
    appends over the un-repeated cache, grouped with kv_len, and the
    question's causal prefill with q_offsets; the packed training pass at
    fp32: the packed forward with lse and both backward kernels). The
    causal walks come from the offsets on the device; the segment and
    packed ones read the tile lists of `tile_lists` (the forward list in
    the forward and dq kernels, the backward's in the dk/dv kernel).
    Launches by mode in `LAUNCHES_BY_MODE`, the grouped ones also in
    `GROUPED_LAUNCHES`. Grouped kv heads in the backward raise (the packed
    pass repeats them first, as JAX does).

Every mask goes through `_dead`, the counterpart of the JAX package's
`_mask_scores`, which the plain forward and backward share.

The masked modes' tile lists: `tile_lists` builds the forward's and the
backward's in one launch of csrc/mask_tiles_sm90.cu, from the runs of
equal codes in each tile (`tile_lists_by_runs` emulates its rule; the
plain versions `mask_tile_list_plain` and `bwd_tile_list_plain` decide
pair by pair). `build_tile_plan` pads a pass's codes and builds both lists
once (`TilePlan`); every attention call of the pass reads them
(`tile_plan=`), and a call without a plan builds its own.

Inputs are [B, L, N, D] and already padded (Lq, Lk multiples of TILE); k
and v may have N / group heads (grouped-query attention: query head h reads
kv head h // group; the plain version repeats them, as the JAX prefill
does);
`kernels/attention.py` pads and wraps the training pair in an autograd
Function. Each wrapper takes its plain PyTorch version only for tensors on
the CPU; on CUDA tensors it launches its kernel or raises. `LAUNCHES`
counts kernel launches per wrapper; `LAUNCHES_BY_MODE` splits those of the
forward, the forward with lse and the two backward kernels by mask mode;
`LAUNCHES_BY_IMPL` splits every bf16 forward launch (self, cross, lse,
knob and masked modes) by the kernel that ran it, `BWD_LAUNCHES_BY_IMPL`
every bf16 backward call. The kernels each new one replaced stay compiled
and reachable (`_launch_bf16`, the mma.sync kernel, for the segment,
packed and causal modes,
`_launch_f32_simt` for the fp32 VAE mode, `_bwd_dq_cuda` /
`_bwd_dkv_cuda`, the mma.sync pair, for every bf16 backward,
`_launch_f32_d128` and `_bwd_dq_f32` / `_bwd_dkv_f32`, the fp32 d=128
CUDA-core kernels; `_launch_int8_mma_sync`, the mma.sync int8 QK^T
kernel; `_rope_bf16`, the bf16 rope pre-pass kernel A replaced;
`_quantize_qk_int8_pair`, the int8 pre-pass pair kernel B replaced;
`mask_tile_list` and `bwd_tile_list`, the tile-list pre-passes
`tile_lists` replaced) as
the same-call baselines of chip_smoke.py and the card tests;
no route reaches them, and they keep their launch counters' names
(`flash_attention_f32_d128`, `flash_attention_f32_lse`,
`flash_attention_bwd_dq_f32`, `flash_attention_bwd_dkv_f32`) beside the
new kernels' (`..._f32_sm90`); the int8 baseline counts as
`flash_attention_int8_mma_sync` and `flash_attention_int8_sbf16_mma_sync`,
the pre-pass baselines as `rope_rotate_bf16` and `quantize_qk_int8_pair`,
the tile-list ones as `mask_tile_list` and `bwd_tile_list` (the new
kernel as `tile_lists`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from ..core.nn import rms_norm

NEG_INF = -1e30
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
TILE = 64           # padded-length multiple the kernels take
CROSS_MAX_LK = 512  # single-kv-block route (the TPU's one kv block)
F32_DIMS = (384, 640, 1024)  # fp32 head dims of the VAE kernels
D128 = 128          # head dim of the DiT kernels (bf16, and fp32 d=128)
SM90_BLOCK_Q = 128  # q rows per block of flash_attention_sm90.cu
SM90_BLOCK_K = 128  # kv rows per tile of flash_attention_sm90.cu
CAUSAL_SLOT = 64    # q rows of a slot of flash_attention_causal_sm90.cu
CAUSAL_MAX_SPLITS = 16   # its split-kv ranges at most
BWD_BLOCK_Q = 64    # q rows per tile of flash_attention_bwd_sm90.cu
BWD_BLOCK_K = 128   # kv rows per block of flash_attention_bwd_sm90.cu
INT8_SM90_BLOCK_Q = 128  # q rows per block of flash_attention_int8_sm90.cu
INT8_SM90_BLOCK_K = 128  # kv rows per tile of flash_attention_int8_sm90.cu
H100_SMS = 132      # the card's SMs: q splits fill them at small grids
QK_PREPASS_MAX_HEADS = 40   # csrc/qk_prepass.cu: 8 heads a pass, 5 passes
KNOBS_MASKED = (
    "softmax_bf16 / qk_int8 with causal, segment or packed masks: no caller "
    "and no kernel mode (the JAX package's knobs serve the Wan DiT)")

# kernel launches per wrapper (reset by callers that count a run)
LAUNCHES = {"flash_attention_bf16": 0, "flash_attention_bf16_causal": 0,
            "cross_attention_bf16": 0,
            "flash_attention_f32": 0, "rope_rotate_bf16": 0,
            "flash_attention_bf16_lse": 0, "flash_attention_bwd_dq_bf16": 0,
            "flash_attention_bwd_dkv_bf16": 0,
            "flash_attention_f32_d128": 0, "flash_attention_f32_lse": 0,
            "rope_rotate_f32": 0, "flash_attention_bwd_dq_f32": 0,
            "flash_attention_bwd_dkv_f32": 0,
            "flash_attention_bf16_sbf16": 0, "cross_attention_bf16_sbf16": 0,
            "quantize_qk_int8": 0, "flash_attention_int8": 0,
            "flash_attention_int8_sbf16": 0,
            "flash_attention_int8_mma_sync": 0,
            "flash_attention_int8_sbf16_mma_sync": 0, "mask_tile_list": 0,
            "flash_attention_bwd_bf16_sm90": 0, "bwd_tile_list": 0,
            "split_bf16x3": 0, "flash_attention_f32_sm90": 0,
            "flash_attention_f32_sm90_lse": 0,
            "flash_attention_bwd_dq_f32_sm90": 0,
            "flash_attention_bwd_dkv_f32_sm90": 0,
            "qk_norm_rope_bf16": 0, "qk_norm_bf16": 0, "qk_rope_bf16": 0,
            "quantize_qk_int8_pair": 0, "tile_lists": 0,
            "flash_attention_f32_sm90_sbf16": 0,
            "flash_attention_f32_sm90_sbf16_oneshot": 0,
            "flash_attention_f32_sm90_int8": 0,
            "flash_attention_f32_sm90_int8_sbf16": 0,
            "quantize_qk_int8_f32": 0}
# the flash_attention_f32 launches split by head dim
F32_LAUNCHES_BY_D = {d: 0 for d in F32_DIMS}
# launches of the masked modes: each is also counted under its kernel's name
# in LAUNCHES (the causal forward without lse under
# flash_attention_bf16_causal)
MASK_MODES = ("causal", "segments", "packed")
LAUNCHES_BY_MODE = {
    f"{name}_{mode}": 0
    for name in ("flash_attention_bf16", "flash_attention_bf16_lse",
                 "flash_attention_bwd_dq_bf16", "flash_attention_bwd_dkv_bf16",
                 "flash_attention_bwd_bf16_sm90", "flash_attention_f32_sm90",
                 "flash_attention_f32_sm90_lse",
                 "flash_attention_bwd_dq_f32_sm90",
                 "flash_attention_bwd_dkv_f32_sm90")
    for mode in MASK_MODES
    if (name, mode) != ("flash_attention_bf16", "causal")}
# the fp32 d=128 forward launches over grouped kv heads (k, v with N / group
# heads), of any mask mode: BAGEL's ViT appends and KV-cache prefill at fp32
GROUPED_LAUNCHES = {"flash_attention_f32_sm90": 0,
                    "flash_attention_f32_sm90_lse": 0,
                    "flash_attention_f32_sm90_sbf16": 0,
                    "flash_attention_f32_sm90_sbf16_oneshot": 0}
# every bf16 forward launch by its kernel: "sm90" flash_attention_sm90.cu
# (the unmasked, segment and packed modes), "causal_sm90"
# flash_attention_causal_sm90.cu (causal), "mma_sync" flash_attention.cu (no
# route reaches it: it stays at 0)
LAUNCHES_BY_IMPL = {"sm90": 0, "causal_sm90": 0, "mma_sync": 0}
# every bf16 backward call by its kernel: "sm90" flash_attention_bwd_sm90.cu
# (every mode), "mma_sync" the dq and dk/dv pair of flash_attention_bwd.cu
# (no route reaches it: it stays at 0)
BWD_LAUNCHES_BY_IMPL = {"sm90": 0, "mma_sync": 0}
_SEG_MODE = {None: 0, "segments": 1, "packed": 2}
_BWD_MASK_MODE = {None: 0, "segments": 1, "packed": 2, "causal": 3}

_MODE_BOUNDED, _MODE_RUNNING, _MODE_ONESHOT = 0, 1, 2
_MODES = {"bounded": _MODE_BOUNDED, "running": _MODE_RUNNING,
          "oneshot": _MODE_ONESHOT}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for d in F32_LAUNCHES_BY_D:
        F32_LAUNCHES_BY_D[d] = 0
    for name in LAUNCHES_BY_MODE:
        LAUNCHES_BY_MODE[name] = 0
    for name in LAUNCHES_BY_IMPL:
        LAUNCHES_BY_IMPL[name] = 0
    for name in BWD_LAUNCHES_BY_IMPL:
        BWD_LAUNCHES_BY_IMPL[name] = 0
    for name in GROUPED_LAUNCHES:
        GROUPED_LAUNCHES[name] = 0


def _count(name, mode=None, impl=None):
    LAUNCHES[name] += 1
    if mode is not None:
        LAUNCHES_BY_MODE[f"{name}_{mode}"] += 1
    if impl is not None:
        LAUNCHES_BY_IMPL[impl] += 1


# ---------------------------------------------------------------------------
# rope tables (same convention as the JAX package)
# ---------------------------------------------------------------------------


def build_fused_rope_tables(cos: torch.Tensor, sin: torch.Tensor, d: int,
                            softmax_scale: Optional[float] = None):
    """[L, d/2] rope tables -> (cos_q, sin_q, cos_k, sin_k), fp32 [L, d], in
    the swap-multiply convention (cosF = repeat(cos, 2), sinF =
    interleave(-sin, +sin)); the q pair folds in softmax_scale * log2(e)."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    sc = softmax_scale * LOG2E
    c32 = cos.float()
    s32 = sin.float()
    cf = torch.repeat_interleave(c32, 2, dim=-1)
    sf = torch.stack([-s32, s32], dim=-1).reshape(s32.shape[0], -1)
    return cf * sc, sf * sc, cf, sf


def _pad_tables(tables, lq, lk, scale_const):
    """Pad the 4 tables to the padded q/k lengths with the identity rotation
    (cos = 1, scaled for q; sin = 0)."""
    cq, sq, ck, sk = tables

    def pad(t, length, fill):
        if t.shape[0] >= length:
            return t[:length]
        extra = t.new_full((length - t.shape[0], t.shape[1]), fill)
        return torch.cat([t, extra], dim=0)

    return (pad(cq, lq, scale_const), pad(sq, lq, 0.0),
            pad(ck, lk, 1.0), pad(sk, lk, 0.0))


def rotate(x: torch.Tensor, cf: torch.Tensor, sf: torch.Tensor,
           out_dtype) -> torch.Tensor:
    """y = x * cosF + swap_pairs(x) * sinF in fp32 over [B, L, N, D] with
    [L, D] tables; rounded to out_dtype."""
    x32 = x.float()
    sw = x32.reshape(*x.shape[:-1], x.shape[-1] // 2, 2).flip(-1)
    sw = sw.reshape(x.shape)
    return (x32 * cf[:, None, :] + sw * sf[:, None, :]).to(out_dtype)


def rms_heads(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """Wan's qk-norm on [B, L, N, D]: `core.nn.rms_norm` over each token's
    whole N * D width (fp32 mean of squares, rsqrt, cast back, times the
    gain in x's dtype)."""
    b, l, n, d = x.shape
    return rms_norm(x.reshape(b, l, n * d), gain, eps=eps).reshape(b, l, n, d)


def qk_norm_rope_plain(q, k, qk_norm=None, rope_tables=None):
    """`qk_norm_rope` in plain PyTorch: with qk_norm = (gain_q, gain_k,
    eps) `rms_heads` of q and k, then with rope_tables (cq, sq, ck, sk)
    `rotate` each into its own dtype. Returns contiguous (q, k)."""
    if qk_norm is not None:
        gq, gk, eps = qk_norm
        q, k = rms_heads(q, gq, eps), rms_heads(k, gk, eps)
    if rope_tables is not None:
        cq, sq, ck, sk = rope_tables
        q, k = rotate(q, cq, sq, q.dtype), rotate(k, ck, sk, k.dtype)
    return q.contiguous(), k.contiguous()


# ---------------------------------------------------------------------------
# plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------


def repeat_kv(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, L, N / group, D] -> [B, L, N, D], kv head j serving query heads
    j * group .. (j + 1) * group - 1 (jnp.repeat along the head axis)."""
    if x.shape[2] == n:
        return x
    if n % x.shape[2]:
        raise ValueError(f"{n} query heads over {x.shape[2]} kv heads")
    return torch.repeat_interleave(x, n // x.shape[2], dim=2)


def causal_rows(lq, q_offset, q_offsets, device):
    """Absolute row of each query: arange(lq) + q_offset (+ q_offsets[b]),
    [1 or B, lq] int64."""
    row = torch.arange(lq, device=device)[None, :] + q_offset
    if q_offsets is not None:
        row = row + q_offsets.to(device).long()[:, None]
    return row


def packed_mask_allowed(qc, kc, row, col):
    """BAGEL's packed-training predicate on pack_mask_codes codes (doc in
    bits 16+, full/noise split id + 1 in bits 8-15, noise split id + 1 in
    bits 0-7; data_utils.py create_sparse_mask): (causal or same full /
    noise split) and not a foreign noise split and same document. row and
    col are the pack's own indices. Arithmetic shifts, so the pad ids -1
    and -2 give doc -1 and pass nothing. Works on torch tensors and numpy
    arrays alike (int32, broadcasting)."""
    doc_q, doc_k = qc >> 16, kc >> 16
    fn_q, fn_k = (qc >> 8) & 0xFF, (kc >> 8) & 0xFF
    nz_q, nz_k = qc & 0xFF, kc & 0xFF
    causal = row >= col
    full_noise = (fn_q == fn_k) & (fn_q > 0)
    remove_noise = ~((nz_k > 0) & (nz_q != nz_k))
    return (causal | full_noise) & remove_noise & (doc_q == doc_k)


def _dead(i0, i1, lk, device, *, kv_len=None, causal=False, q_offset=0,
          q_offsets=None, q_segments=None, kv_segments=None,
          packed_mode=False):
    """The masked (query, key) pairs of query rows i0 .. i1 - 1 over lk
    keys, bool [B or 1, 1, i1 - i0, lk], or None when nothing is masked:
    keys at or past kv_len[b]; with `causal`, keys past the query's row
    (`causal_rows`); with segments, keys whose id differs from the query's;
    with packed_mode, the pairs `packed_mask_allowed` refuses (rows and
    columns the pack's own indices). The kernels' shared predicate (the
    JAX package's `_mask_scores`)."""
    cols = torch.arange(lk, device=device)
    dead = None

    def add(m):
        nonlocal dead
        dead = m if dead is None else dead | m

    if kv_len is not None:
        add((cols[None, :] >= kv_len.to(device)[:, None])[:, None, None, :])
    if causal:
        rows = causal_rows(i1 - i0, q_offset + i0, q_offsets, device)
        add((cols[None, None, :] > rows[:, :, None])[:, None])
    if q_segments is not None:
        qs = q_segments.to(device)[:, i0:i1, None]
        ks = kv_segments.to(device)[:, None, :]
        if packed_mode:
            rows = torch.arange(i0, i1, device=device)[None, :, None]
            add(~packed_mask_allowed(qs, ks, rows, cols[None, None, :])[:, None])
        else:
            add((qs != ks)[:, None])
    return dead


def mask_tile_list_plain(q_segments, kv_segments, kv_len=None,
                         packed_mode=False):
    """The masked modes' forward tile list in plain PyTorch (the forward
    list of `tile_lists`, and of the old pre-pass `mask_tile_list`), pair
    by pair: for each (b, 128-row q tile) the kv tiles of 128
    keys that hold at least one pair `_dead` allows, ascending, as
    (tile << 1) | full, full when every pair of the tile's 128 keys (rows
    below Lq; keys past Lk count as dead) is allowed; -1 past the count.
    Returns (list int32 [B, q_tiles, kv_tiles], count int32 [B, q_tiles])."""
    block_q, block_k = SM90_BLOCK_Q, SM90_BLOCK_K
    b, lq = q_segments.shape
    lk = kv_segments.shape[1]
    qt, kt = -(-lq // block_q), -(-lk // block_k)
    dead = _dead(0, lq, lk, q_segments.device, kv_len=kv_len,
                 q_segments=q_segments, kv_segments=kv_segments,
                 packed_mode=packed_mode)[:, 0]
    alive = torch.zeros((b, qt * block_q, kt * block_k), dtype=torch.bool,
                        device=dead.device)
    alive[:, :lq, :lk] = ~dead
    tiles = alive.reshape(b, qt, block_q, kt, block_k)
    live = tiles.any(dim=4).any(dim=2)                       # [B, qt, kt]
    # rows past Lq do not exist: they never make a tile less than full
    alive[:, lq:, :lk] = True
    full = alive.reshape(b, qt, block_q, kt, block_k).all(dim=4).all(dim=2)
    count = live.sum(dim=-1).to(torch.int32)
    return _compact(live, full, count)


def _compact(live, full, count):
    """Live tiles first, in ascending order (a stable sort of the dead
    flag), as (tile << 1) | full; -1 past the count."""
    codes = torch.arange(live.shape[-1], device=live.device) * 2 + full.long()
    order = torch.sort((~live).to(torch.int8), dim=-1, stable=True).indices
    lists = torch.gather(torch.where(live, codes, -1), -1, order)
    return lists.to(torch.int32), count


def bwd_tile_list_plain(b, lq, lk, device="cpu", *, kv_len=None,
                        causal=False, q_offset=0, q_offsets=None,
                        q_segments=None, kv_segments=None, packed_mode=False):
    """The one-pass backward's tile list in plain PyTorch (the backward
    list of `tile_lists`, and of the old pre-pass `bwd_tile_list`), pair
    by pair: for each (b, kv tile of 128 keys) the 64-row q tiles
    that hold at least one pair `_dead` allows (any of its masks), ascending,
    as (tile << 1) | full, full when every pair of the tile's 64 rows and
    128 keys is allowed (keys past Lk count as dead); -1 past the count. Lq
    is a multiple of 64. Returns (list int32 [B, kv_tiles, Lq / 64], count
    int32 [B, kv_tiles])."""
    bq, bk = BWD_BLOCK_Q, BWD_BLOCK_K
    nq, kt = lq // bq, -(-lk // bk)
    dead = _dead(0, lq, lk, device, kv_len=kv_len, causal=causal,
                 q_offset=q_offset, q_offsets=q_offsets, q_segments=q_segments,
                 kv_segments=kv_segments, packed_mode=packed_mode)
    alive = torch.zeros((b, lq, kt * bk), dtype=torch.bool, device=device)
    alive[:, :, :lk] = True if dead is None else ~dead[:, 0]
    tiles = alive.reshape(b, nq, bq, kt, bk)
    live = tiles.any(dim=4).any(dim=2).transpose(1, 2)       # [B, kt, nq]
    full = tiles.all(dim=4).all(dim=2).transpose(1, 2)
    return _compact(live, full, live.sum(dim=-1).to(torch.int32))


def _runs(codes):
    """(starts, codes) of the runs of equal values in a 1-D int array."""
    starts = np.flatnonzero(np.r_[True, codes[1:] != codes[:-1]])
    return starts, codes[starts]


def _runs_flag(qc, q0, kc, kv0, whole, packed):
    """csrc/mask_tiles_sm90.cu's rule for one tile: rows q0 + i with codes
    qc against keys kv0 + j with codes kc (the keys below kv_end), from
    their runs alone: 0 dead, 1 live, 3 full (every run pair full and
    `whole`). On one run pair the packed predicate is decided from its
    corners: any pair iff base & (fn | r1 >= c0), every pair iff base & (fn
    | r0 >= c1)."""
    if len(kc) == 0:
        return 0
    qs, qv = _runs(qc)
    ks, kv = _runs(kc)
    r0, r1 = q0 + qs, q0 + np.r_[qs[1:], len(qc)] - 1
    c0, c1 = kv0 + ks, kv0 + np.r_[ks[1:], len(kc)] - 1
    cq, ck = qv[:, None], kv[None, :]
    if packed:
        nz_q, nz_k = cq & 0xFF, ck & 0xFF
        base = ((cq >> 16) == (ck >> 16)) & ~((nz_k > 0) & (nz_q != nz_k))
        fn_q = (cq >> 8) & 0xFF
        fn = (fn_q == ((ck >> 8) & 0xFF)) & (fn_q > 0)
        any_ = base & (fn | (r1[:, None] >= c0[None, :]))
        all_ = base & (fn | (r0[:, None] >= c1[None, :]))
    else:
        any_ = all_ = cq == ck
    if not any_.any():
        return 0
    return 3 if whole and all_.all() else 1


def tile_lists_by_runs(b, lq, lk, *, kv_len=None, causal=False, q_offset=0,
                       q_offsets=None, q_segments=None, kv_segments=None,
                       packed_mode=False):
    """The rule of `tile_lists`' kernel (csrc/mask_tiles_sm90.cu) in numpy,
    for the tests: each 64 x 128 flag from the runs of equal codes in its
    q tile and its kv tile (`_runs_flag`; the causal mode by the corner
    rule of the backward's list), each forward 128 x 128 flag the OR
    (live) and AND (full) of its two halves (a half past Lq counts as
    full), both compacted as the plain lists are. Returns (fwd, bwd), each
    (list, count) equal to `mask_tile_list_plain` / `bwd_tile_list_plain`
    on the same masks; fwd None in the causal mode. Lq is a multiple of
    64."""
    bq, bk = BWD_BLOCK_Q, BWD_BLOCK_K
    nq, kt = lq // bq, -(-lk // bk)
    ends = np.full(b, lk) if kv_len is None else np.clip(
        np.asarray(kv_len.cpu() if torch.is_tensor(kv_len) else kv_len),
        0, lk)
    offs = np.zeros(b, np.int64) if q_offsets is None else np.asarray(
        q_offsets.cpu() if torch.is_tensor(q_offsets) else q_offsets,
        np.int64)
    if not causal:
        qcs = np.asarray(q_segments.cpu(), np.int32)
        kcs = np.asarray(kv_segments.cpu(), np.int32)
    flags = np.zeros((b, nq, kt), np.int8)
    for bi in range(b):
        for j in range(kt):
            kv0 = j * bk
            n_keys = max(0, min(bk, int(ends[bi]) - kv0))
            whole = n_keys == bk
            for i in range(nq):
                q0 = i * bq
                if causal:
                    row0 = q0 + q_offset + int(offs[bi])
                    any_ = n_keys > 0 and kv0 <= row0 + bq - 1
                    flags[bi, i, j] = (3 if whole and kv0 + bk - 1 <= row0
                                       else 1) if any_ else 0
                else:
                    flags[bi, i, j] = _runs_flag(
                        qcs[bi, q0:q0 + bq], q0, kcs[bi, kv0:kv0 + n_keys],
                        kv0, whole, packed_mode)
    live, full = torch.as_tensor(flags != 0), torch.as_tensor(flags == 3)
    bwd = _compact(live.transpose(1, 2), full.transpose(1, 2),
                   live.sum(dim=1).to(torch.int32))
    if causal:
        return None, bwd
    if nq % 2:   # the last forward tile's second half lies past Lq
        live = torch.cat([live, torch.zeros_like(live[:, :1])], dim=1)
        full = torch.cat([full, torch.ones_like(full[:, :1])], dim=1)
    live = live[:, 0::2] | live[:, 1::2]
    full = full[:, 0::2] & full[:, 1::2]
    return _compact(live, full, live.sum(dim=-1).to(torch.int32)), bwd


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The segment or packed mask of one pass, built once by
    `build_tile_plan` and handed to each of its attention calls: the codes
    padded to the kernels' multiple of 64 (queries with -1, keys with -2,
    as the dispatcher pads them), the kv_len that masks the padded keys (or
    the caller's), and on the card both tile lists, (list, count) of
    `mask_tile_list_plain` (fwd) and of `bwd_tile_list_plain` (bwd), which
    the forward and backward kernels read instead of building their own.
    On the CPU the lists are None: the plain versions read the codes."""
    q_codes: torch.Tensor
    kv_codes: torch.Tensor
    kv_len: Optional[torch.Tensor]
    packed_mode: bool
    fwd: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    bwd: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def check(self, b, lq, lk, packed_mode, device):
        """Raise unless the plan was built for B rows of padded Lq, Lk
        codes, in this mode, on this device."""
        got = (self.q_codes.shape[0], self.q_codes.shape[1],
               self.kv_codes.shape[1], self.packed_mode)
        if got != (b, lq, lk, bool(packed_mode)):
            raise ValueError(
                f"the tile plan was built for (B, Lq, Lk, packed_mode) = "
                f"{got}, the call is {(b, lq, lk, bool(packed_mode))} "
                "(padded lengths)")
        if self.q_codes.device != torch.device(device):
            raise ValueError(f"the tile plan lies on {self.q_codes.device}, "
                             f"the call on {device}")


def build_tile_plan(q_segments, kv_segments, kv_len=None, packed_mode=False,
                    device=None):
    """The `TilePlan` of q_segments [B, Lq] / kv_segments [B, Lk] (int32
    ids, or pack_mask_codes codes with packed_mode) and kv_len [B] or None
    (the caller's, on the unpadded keys), on `device` (default: the codes'):
    the codes padded as `kernels.attention.attention` pads them, kv_len = Lk
    when it pads keys and none is given, and on the card both tile lists
    from one launch of `tile_lists`."""
    if device is None:
        device = (q_segments.device if torch.is_tensor(q_segments)
                  else "cpu")
    qc = torch.as_tensor(q_segments, dtype=torch.int32).to(device)
    kc = torch.as_tensor(kv_segments, dtype=torch.int32).to(device)
    if qc.dim() != 2 or kc.dim() != 2 or qc.shape[0] != kc.shape[0]:
        raise ValueError("segment ids are [B, Lq] and [B, Lk]")
    b, lq = qc.shape
    lk = kc.shape[1]
    lq_pad, lk_pad = -(-lq // TILE) * TILE, -(-lk // TILE) * TILE
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32).to(device)
    elif lk_pad != lk:
        kv_len = torch.full((b,), lk, dtype=torch.int32, device=device)
    qc = F.pad(qc, (0, lq_pad - lq), value=-1).contiguous()
    kc = F.pad(kc, (0, lk_pad - lk), value=-2).contiguous()
    fwd = bwd = None
    if qc.is_cuda:
        fwd, bwd = tile_lists(b, lq_pad, lk_pad, qc.device, kv_len=kv_len,
                              q_segments=qc, kv_segments=kc,
                              packed_mode=packed_mode)
    return TilePlan(qc, kc, kv_len, bool(packed_mode), fwd, bwd)


def causal_pairs(group, lq):
    """Blocks along the packed rows of one kv head in
    flash_attention_causal_sm90.cu: its group * Lq query rows as slots of 64
    (`causal_slot`), two slots a block, the last one alone when the count
    is odd."""
    return -(-group * (lq // CAUSAL_SLOT) // 2)


def causal_slot(slot, group):
    """Slot -> (head within the kv head's group, first position): the
    position-major packing of the kv head's group * Lq query rows, slot =
    (position // 64) * group + head, packed row = slot * 64 + position %
    64."""
    return slot % group, slot // group * CAUSAL_SLOT


def causal_splits(b, n, group, lq, lk, sms=H100_SMS):
    """The causal kernel's split-kv count S, from the shapes alone (never
    from q_offsets or kv_len, which stay on the device): 1 while its blocks
    (B x kv heads x `causal_pairs`) fill at least half the SMs, else
    min(sms // blocks, kv tiles of 128 keys, 16)."""
    blocks = b * (n // group) * causal_pairs(group, lq)
    if 2 * blocks > sms:
        return 1
    return max(1, min(sms // blocks, -(-lk // SM90_BLOCK_K),
                      CAUSAL_MAX_SPLITS))


def causal_split_plan(b, group, lq, lk, splits, *, kv_len=None,
                      q_offset=0, q_offsets=None):
    """The kv tiles each block of the causal kernel walks, as it computes
    them on the device: int64 [B, pairs, splits, 2] of (t0, t1), 128-key
    tiles [t0, t1) (the same for every kv head). A block's live keys end at
    end = clamp(q_offset + q_offsets[b] + its last slot's last position + 1,
    0, kv_len[b]); its ceil(end / 128) tiles are cut into `splits` ranges
    of ceil(n / splits), the later ones empty when n < splits."""
    n_slots = group * (lq // CAUSAL_SLOT)
    kv_end = (torch.full((b,), lk, dtype=torch.int64) if kv_len is None
              else kv_len.cpu().long().clamp(0, lk))
    off = torch.full((b,), q_offset, dtype=torch.int64)
    if q_offsets is not None:
        off = off + q_offsets.cpu().long()
    plan = torch.zeros((b, causal_pairs(group, lq), splits, 2),
                       dtype=torch.int64)
    for p in range(plan.shape[1]):
        last = min(2 * p + 1, n_slots - 1)
        end = torch.minimum((off + causal_slot(last, group)[1]
                             + CAUSAL_SLOT).clamp_min(0), kv_end)
        nt = -(-end // SM90_BLOCK_K)
        per = -(-nt // splits)
        for s in range(splits):
            t0 = torch.minimum(s * per, nt)
            plan[:, p, s, 0] = t0
            plan[:, p, s, 1] = torch.minimum(t0 + per, nt)
    return plan


def causal_split_plain(q, k, v, *, kv_len=None, q_offset=0, q_offsets=None,
                       splits=None, save_residuals=False):
    """The causal kernel's arithmetic emulated in plain PyTorch (a test
    reference; no path calls it): q folded [B, Lq, N, D], k, v [B, Lk, N /
    group, D]. For each block (b, kv head, pair of slots) and split of
    `causal_split_plan` (splits: `causal_splits` by default), the running
    max over its 128-key tiles: s masked to -1e30 past each row's diagonal
    or kv_len, m_new = max(m, rowmax s), p = exp2(s - m_new) (reference 0
    while m_new is -1e30), l = l 2^(m - m_new) + sum p, acc = acc 2^(m -
    m_new) + p (rounded to v's dtype) v, all fp32; then the merge: m* the
    largest m of the splits with l > 0, l = sum l_s 2^(m_s - m*), o = sum
    acc_s 2^(m_s - m*) / l in q's dtype, lse = m* + log2 l; rows that no
    split saw are 0 with lse +1e30."""
    b, lq, n, d = q.shape
    lk, nk = k.shape[1], k.shape[2]
    group = n // nk
    if splits is None:
        splits = causal_splits(b, n, group, lq, lk)
    plan = causal_split_plan(b, group, lq, lk, splits, kv_len=kv_len,
                             q_offset=q_offset, q_offsets=q_offsets)
    rows_abs = causal_rows(lq, q_offset, q_offsets, "cpu").expand(b, lq)
    kv_end = (torch.full((b,), lk) if kv_len is None
              else kv_len.cpu().long().clamp(0, lk))
    n_slots = group * (lq // CAUSAL_SLOT)
    out = torch.zeros(q.shape, dtype=q.dtype)
    lse = torch.full((b, n, lq), -NEG_INF, dtype=torch.float32)
    qf, kf, vf = (x.detach().cpu().float() for x in (q, k, v))
    for bi in range(b):
        for hk in range(nk):
            for p in range(plan.shape[1]):
                slots = [causal_slot(s, group)
                         for s in range(2 * p, min(2 * p + 2, n_slots))]
                qb = torch.cat([qf[bi, pos:pos + CAUSAL_SLOT, hk * group + j]
                                for j, pos in slots])
                rows = torch.cat([rows_abs[bi, pos:pos + CAUSAL_SLOT]
                                  for _, pos in slots])
                parts = []
                for t0, t1 in plan[bi, p].tolist():
                    m = torch.full((len(rows),), NEG_INF)
                    l = torch.zeros(len(rows))
                    acc = torch.zeros((len(rows), d))
                    for j in range(t0, t1):
                        cols = torch.arange(j * SM90_BLOCK_K,
                                            min((j + 1) * SM90_BLOCK_K, lk))
                        s = qb @ kf[bi, cols, hk].T
                        s = s.masked_fill((cols[None, :] >= kv_end[bi])
                                          | (cols[None, :] > rows[:, None]),
                                          NEG_INF)
                        m_new = torch.maximum(m, s.amax(dim=-1))
                        ref = torch.where(m_new == NEG_INF, 0.0, m_new)
                        pt = torch.exp2(s - ref[:, None])
                        corr = torch.exp2(m - m_new)
                        l = l * corr + pt.sum(dim=-1)
                        acc = acc * corr[:, None] + pt.to(v.dtype).float() \
                            @ vf[bi, cols, hk]
                        m = m_new
                    parts.append((m, l, acc))
                ms = torch.stack([m for m, _, _ in parts])
                ls = torch.stack([l for _, l, _ in parts])
                m_star = torch.where(ls > 0, ms, NEG_INF).amax(dim=0)
                wgt = torch.where(ls > 0, torch.exp2(ms - m_star), 0.0)
                l_tot = (ls * wgt).sum(dim=0)
                acc = sum(a * w_[:, None] for (_, _, a), w_ in
                          zip(parts, wgt))
                inv = torch.where(l_tot > 0, 1.0 / torch.where(
                    l_tot > 0, l_tot, 1.0), 0.0)
                o_rows = (acc * inv[:, None]).to(q.dtype)
                lse_rows = torch.where(l_tot > 0, m_star + torch.log2(
                    torch.where(l_tot > 0, l_tot, 1.0)), -NEG_INF)
                for i, (j, pos) in enumerate(slots):
                    sl = slice(i * CAUSAL_SLOT, (i + 1) * CAUSAL_SLOT)
                    out[bi, pos:pos + CAUSAL_SLOT, hk * group + j] = o_rows[sl]
                    lse[bi, hk * group + j, pos:pos + CAUSAL_SLOT] = \
                        lse_rows[sl]
    out = out.to(q.device)
    return (out, lse.to(q.device)) if save_residuals else out


def _softmax_pv(s, mask, bound, softmax_bf16, vf, v_dtype):
    """One query chunk's softmax and p @ v on folded fp32 scores s
    [B, N, q, Lk] (`mask`: the dead pairs or None): (acc [B, q, N, D] fp32,
    l [B, N, q, 1], ref). The reference point is the bound or the row max
    (the one-shot form, equal in exact arithmetic to a running max). With
    softmax_bf16 the chain is the kernels' bf16 one: s and the reference
    round to bf16, s - ref is a bf16 difference, exp2 gives a bf16 p, and l
    sums those p in fp32."""
    if mask is not None:
        s = s.masked_fill(mask, NEG_INF)
    ref = bound if bound is not None else s.amax(dim=-1, keepdim=True)
    if softmax_bf16:
        ref_b = torch.as_tensor(ref, device=s.device).to(torch.bfloat16)
        p = torch.exp2(s.to(torch.bfloat16) - ref_b).float()
    else:
        p = torch.exp2(s - ref)
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bnqk,bknd->bqnd", p.to(v_dtype).float(), vf)
    return acc, l, ref


def _normalise(acc, l, out_dtype):
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return (acc * inv.permute(0, 2, 1, 3)).to(out_dtype)


def attention_plain(q, k, v, *, kv_len=None, bound=None, rope_tables=None,
                    save_residuals: bool = False, causal: bool = False,
                    q_offset: int = 0, q_offsets=None, q_segments=None,
                    kv_segments=None, packed_mode: bool = False,
                    softmax_bf16: bool = False, q_chunk: int = 1024):
    """The kernels' function in plain PyTorch, over padded [B, L, N, D].

    Scores are in the folded (scale * log2 e) domain: q carries the fold,
    or the q rope tables do. bound: folded score bound (fp32 scalar
    tensor) -> p = exp2(s - bound); None -> p = exp2(s - rowmax(s)), the
    one-shot form, equal in exact arithmetic to the running max. Masked
    keys (`_dead`: kv_len, causal, segments, packed codes) get s = -1e30
    and p = 0; rows with l == 0 are zero. k and v with
    fewer heads than q are repeated (`repeat_kv`). p is rounded to v's
    dtype before p @ v; l and the accumulator stay fp32. softmax_bf16: the
    bf16 softmax chain (`_softmax_pv`). save_residuals ->
    (out, lse): lse fp32 [B, N, Lq] = ref + log2 l, ref the bound or the
    row max, +1e30 where l == 0."""
    if rope_tables is not None:
        cq, sq, ck, sk = rope_tables
        q = rotate(q, cq, sq, q.dtype)
        k = rotate(k, ck, sk, v.dtype)
    b, lq, n, _ = q.shape
    lk = k.shape[1]
    kf = repeat_kv(k, n).float()
    vf = repeat_kv(v, n).float()
    masks = dict(kv_len=kv_len, causal=causal, q_offset=q_offset,
                 q_offsets=q_offsets, q_segments=q_segments,
                 kv_segments=kv_segments, packed_mode=packed_mode)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
           if save_residuals else None)
    for i0 in range(0, lq, q_chunk):
        s = torch.einsum("bqnd,bknd->bnqk", q[:, i0:i0 + q_chunk].float(), kf)
        mask = _dead(i0, min(i0 + q_chunk, lq), lk, q.device, **masks)
        acc, l, ref = _softmax_pv(s, mask, bound, softmax_bf16, vf, v.dtype)
        out[:, i0:i0 + q_chunk] = _normalise(acc, l, q.dtype)
        if save_residuals:
            lse[:, :, i0:i0 + q_chunk] = torch.where(
                l > 0, ref + torch.log2(torch.where(l > 0, l, 1.0)),
                -NEG_INF)[..., 0]
    return (out, lse) if save_residuals else out


def quantize_qk_int8_plain(q, k, rope_tables=None, block_k: int = 512):
    """The int8 pre-pass in plain PyTorch (`quantize_qk_int8`): q, k padded
    [B, L, N, D]; rope_tables the padded fused-rope tables or None (q then
    already folded). Rotation in fp32; q per row: aq = max(max|q32|, 1e-30),
    codes round(q32 * (127 / aq)), sq = aq * (1 / 127); k per (b, h, block
    of block_k rows, the last one short): ak = max(max|k32|, 1e-30) over
    the block, codes round(k32 * (127 / ak)), akq = ak * (1 / 127). Returns
    (qi int8 [B, N, Lq, D], sq fp32 [B, N, Lq], ki int8 [B, N, Lk, D],
    akq fp32 [B, N, ceil(Lk / block_k)])."""
    if rope_tables is not None:
        cq, sq_t, ck, sk_t = rope_tables
        q32, k32 = rotate(q, cq, sq_t, torch.float32), \
            rotate(k, ck, sk_t, torch.float32)
    else:
        q32, k32 = q.float(), k.float()
    q32, k32 = q32.transpose(1, 2), k32.transpose(1, 2)   # [B, N, L, D]
    c127 = torch.tensor(127.0, device=q.device)

    def codes(x, a):   # the division 127 / a first, then the product
        return torch.round(x * c127.div(a)).to(torch.int8)

    aq = q32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    b, n, lk, d = k32.shape
    nblk = -(-lk // block_k)
    blocks = torch.nn.functional.pad(k32, (0, 0, 0, nblk * block_k - lk))
    ak = blocks.reshape(b, n, nblk, block_k * d).abs().amax(dim=-1) \
        .clamp_min(1e-30)
    ak_rows = ak.repeat_interleave(block_k, dim=-1)[..., :lk, None]
    return (codes(q32, aq).contiguous(), (aq * (1.0 / 127.0))[..., 0],
            codes(k32, ak_rows).contiguous(), ak * (1.0 / 127.0))


def _int8_scores(qi, sq, kf, ak_cols):
    s32 = torch.einsum("bnqd,bnkd->bnqk", qi.float(), kf)
    return s32 * (sq[..., None] * ak_cols)


def int8_scores_plain(qi, sq, ki, akq, block_k: int = 512):
    """The int8 QK^T kernels' scores before the mask, fp32 [B, N, Lq, Lk]:
    s = float(qi ki^T) * (sq_row * akq_block), the two products rounded in
    that order (the integer products and their sums are exact in fp32:
    |s32| <= 127^2 * D < 2^24); key j takes akq[..., j // block_k]."""
    lk = ki.shape[2]
    ak_cols = akq.repeat_interleave(block_k, dim=-1)[..., None, :lk]
    return _int8_scores(qi, sq, ki.float(), ak_cols)


def attention_int8_plain(qi, sq, ki, akq, v, *, kv_len=None, bound=None,
                         softmax_bf16: bool = False, block_k: int = 512,
                         q_chunk: int = 1024):
    """The int8 QK^T kernel's function in plain PyTorch, on the pre-pass's
    codes and scales (`quantize_qk_int8_plain`) and bf16 v [B, Lk, N, D]:
    the scores of `int8_scores_plain`, keys at or past kv_len masked on the
    fp32 s, then `_softmax_pv` (bounded or one-shot max, fp32 or bf16
    chain)."""
    b, n, lq, d = qi.shape
    lk = ki.shape[2]
    kf = ki.float()
    vf = v.float()
    ak_cols = akq.repeat_interleave(block_k, dim=-1)[..., None, :lk]
    out = torch.empty((b, lq, n, d), dtype=v.dtype, device=v.device)
    for i0 in range(0, lq, q_chunk):
        sl = slice(i0, i0 + q_chunk)
        s = _int8_scores(qi[:, :, sl], sq[:, :, sl], kf, ak_cols)
        mask = _dead(i0, min(i0 + q_chunk, lq), lk, v.device, kv_len=kv_len)
        acc, l, _ = _softmax_pv(s, mask, bound, softmax_bf16, vf, v.dtype)
        out[:, sl] = _normalise(acc, l, v.dtype)
    return out


def attention_bwd_plain(q, k, v, o, lse, do, *, kv_len=None,
                        softmax_scale=None, q_chunk: int = 1024, **masks):
    """The backward kernels' function in plain PyTorch: dq, dk, dv of
    `flash_attention_padded` from its output o and lse, for RAW q (folded
    here as on the TPU). Rounding points of the JAX kernels: qs = q * scale
    * log2e in q's dtype; p = exp2(qs k^T - lse) in fp32 (masked keys
    -1e30, `_dead`; masks: causal, q_offset, q_offsets, q_segments,
    kv_segments, packed_mode); delta = sum(do * o) in fp32; ds = p * (dp -
    delta); dq = scale * sum ds(k dtype) k -> q's dtype; dk = ln2 * sum
    ds^T(q dtype) qs, dv = sum p^T(do dtype) do, accumulated in fp32, cast
    once."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    return _bwd_plain_folded(_fold(q, softmax_scale), k, v, o, lse, do,
                             kv_len, softmax_scale, q_chunk, **masks)


def _fold(q, softmax_scale):
    """q * softmax_scale * log2(e), the constant rounded to q's dtype first
    (the JAX wrappers' fold)."""
    return q * torch.tensor(softmax_scale * LOG2E, dtype=q.dtype,
                            device=q.device)


def _bwd_plain_folded(qs, k, v, o, lse, do, kv_len, softmax_scale,
                      q_chunk=1024, **masks):
    b, lq, n, d = qs.shape
    lk = k.shape[1]
    kf = k.float()
    vf = v.float()
    dq = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=qs.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=qs.device)
    for i0 in range(0, lq, q_chunk):
        sl = slice(i0, i0 + q_chunk)
        qc, doc = qs[:, sl], do[:, sl]
        t = torch.einsum("bqnd,bknd->bnqk", qc.float(), kf)
        dead = _dead(i0, min(i0 + q_chunk, lq), lk, qs.device, kv_len=kv_len,
                     **masks)
        if dead is not None:
            t = t.masked_fill(dead, NEG_INF)
        p = torch.exp2(t - lse[:, :, sl, None])
        dp = torch.einsum("bqnd,bknd->bnqk", doc.float(), vf)
        delta = (doc.float() * o[:, sl].float()).sum(-1)       # [b, q, n]
        ds = p * (dp - delta.permute(0, 2, 1)[..., None])
        dq[:, sl] = (torch.einsum("bnqk,bknd->bqnd", ds.to(k.dtype).float(),
                                  kf) * softmax_scale).to(qs.dtype)
        dv += torch.einsum("bnqk,bqnd->bknd", p.to(do.dtype).float(),
                           doc.float())
        dk += torch.einsum("bnqk,bqnd->bknd", ds.to(qs.dtype).float(),
                           qc.float())
    return dq, (dk * LN2).to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_FNS = {}


def _fn(lib_name: str, sym: str, argtypes):
    key = (lib_name, sym)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(build.load(lib_name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _strides(*ts):
    vals = []
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError("attention kernels need unit stride along D")
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda_inputs(q, k, v, kv_len, dtype, d_ok, *more,
                       group_ok=False):
    for t in (q, k, v, *more):
        if not t.is_cuda or t.dtype != dtype:
            raise TypeError(f"kernel takes {dtype} CUDA tensors, got "
                            f"{t.dtype} on {t.device}")
    if q.shape[-1] not in d_ok:
        raise ValueError(f"no {dtype} kernel for head dim {q.shape[-1]} "
                         f"(built: {d_ok})")
    if k.shape[2] != q.shape[2] and not (
            group_ok and k.shape[2] == v.shape[2]
            and q.shape[2] % k.shape[2] == 0):
        raise ValueError(f"{q.shape[2]} query heads over {k.shape[2]} kv "
                         "heads: only the forward kernels group them")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the kernel wrappers are not differentiable: "
                           "kernels.attention.attention routes a call that "
                           "needs a gradient through its autograd Function")
    if q.shape[1] % TILE or k.shape[1] % TILE:
        raise ValueError("pad Lq and Lk to multiples of 64 (kernels/"
                         "attention.py does)")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or kv_len.device != q.device):
        raise TypeError("kv_len must be int32 on the kernel's device")


def _check_masks(q, lk, q_offsets, q_segments, kv_segments, packed_mode,
                 causal):
    """The mask operands a kernel takes: q_offsets int32 [B], segment ids
    int32 [B, Lq] / [B, Lk], contiguous, on the kernel's device. Returns
    the segment mode (None, 'segments' or 'packed')."""
    b, lq = q.shape[:2]
    if q_offsets is not None and (q_offsets.dtype != torch.int32
                                  or q_offsets.device != q.device
                                  or tuple(q_offsets.shape) != (b,)):
        raise TypeError("q_offsets must be int32 [B] on the kernel's device")
    if q_segments is None and kv_segments is None:
        if packed_mode:
            raise ValueError("packed_mode takes the codes as q_segments and "
                             "kv_segments")
        return None
    for t, length in ((q_segments, lq), (kv_segments, lk)):
        if (t is None or t.dtype != torch.int32 or t.device != q.device
                or tuple(t.shape) != (b, length) or not t.is_contiguous()):
            raise TypeError("segment ids must be contiguous int32 [B, L] on "
                            "the kernel's device, for q and kv both")
    if causal:
        raise NotImplementedError(
            "causal attention with segment ids has no caller and no kernel "
            "mode (packed_mode carries its own causal term)")
    return "packed" if packed_mode else "segments"


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check_aligned(*ts):
    """The fp32 kernels read rows in 16-byte pieces: 16-byte aligned data
    and strides that are multiples of 4 elements."""
    for t in ts:
        if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:-1]):
            raise ValueError("the fp32 kernels need 16-byte aligned rows "
                             "(strides multiples of 4)")


def _f32_masks(q, k, kv_len, bound, tile_plan=None, fwd=True, bwd=False, *,
               causal=False, q_offset=0, q_offsets=None, q_segments=None,
               kv_segments=None, packed_mode=False):
    """The mask of an fp32 d=128 call on csrc/flash_attention_f32_sm90.cu:
    (mode, fwd lists, bwd lists), mode None, "causal", "segments" or
    "packed"; in the segment and packed modes the forward's and (with
    `bwd`) the backward's tile lists, the plan's (`TilePlan`) or else from
    one `tile_lists` launch; None otherwise. Raises for what no kernel
    takes: a bound with a mask (the masked modes take the running max, as
    in bf16), causal with segments."""
    seg = _check_masks(q, k.shape[1], q_offsets, q_segments, kv_segments,
                       packed_mode, causal)
    mode = "causal" if causal else seg
    if mode is not None and bound is not None:
        raise NotImplementedError("the causal, segment and packed modes take "
                                  "the running max only")
    if seg is None:
        return mode, None, None
    b, lq = q.shape[:2]
    lk = k.shape[1]
    if tile_plan is not None:
        shapes = dict(fwd=(b, sm90_q_tiles(lq), -(-lk // SM90_BLOCK_K)),
                      bwd=(b, -(-lk // BWD_BLOCK_K), lq // BWD_BLOCK_Q))
        return (mode, *(_plan_lists(tile_plan, w, shapes[w]) if want
                        else None for w, want in (("fwd", fwd),
                                                  ("bwd", bwd))))
    f, bl = tile_lists(b, lq, lk, q.device, kv_len=kv_len,
                       q_segments=q_segments, kv_segments=kv_segments,
                       packed_mode=packed_mode, fwd=fwd, bwd=bwd)
    return mode, f, bl


def _f32_mask_args(mode, lists, q_offset=0, q_offsets=None, q_segments=None,
                   kv_segments=None, **_):
    """The mask operands of the fp32 d=128 entry points: (mode, q_offsets,
    q_offset, q_seg, kv_seg, list, count, list width)."""
    lst, cnt = lists if lists is not None else (None, None)
    return (_BWD_MASK_MODE[mode], _ptr(q_offsets), int(q_offset),
            _ptr(q_segments), _ptr(kv_segments), _ptr(lst), _ptr(cnt),
            0 if lst is None else lst.shape[2])


_F32_MASK_ARGTYPES = [_I, _P, _I, _P, _P, _P, _P, _I]


def _launch_f32_d128(q, k, v, kv_len, bound, save_lse):
    """csrc/flash_attention_f32_d128.cu, the CUDA-core fp32 d=128 forward
    that `_launch_f32_sm90` replaced (running max, or bounded with
    `bound`): (o, lse fp32 [B, N, Lq] or None). A baseline reached only by
    chip_smoke.py and the card tests."""
    b, lq, n, d = q.shape
    _check_aligned(q, k, v)
    o = torch.empty((b, lq, n, d), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    fn = _fn("flash_attention_f32_d128", "univid_flash_fwd_f32_d128",
             [_P] * 7 + [_I] * 4 + [_P, _P])
    strides = _strides(q, k, v, o)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _ptr(kv_len), _ptr(bound), _ptr(lse), b, n, lq, k.shape[1],
             ctypes.addressof(strides), _stream(q))
    build.check(err, "univid_flash_fwd_f32_d128")
    _count("flash_attention_f32_lse" if save_lse
           else "flash_attention_f32_d128")
    return o, lse


def split_bf16x3_plain(x):
    """fp32 x -> bf16 [3, *x.shape], the three parts of
    csrc/flash_attention_f32_sm90.cu's operands: b0 = bf16(x), b1 =
    bf16(x - b0), b2 = bf16(x - b0 - b1), each rounded to nearest even
    (both differences are exact in fp32), so x = b0 + b1 + b2 + O(2^-27
    |x|)."""
    b0 = x.to(torch.bfloat16)
    r = x - b0.float()
    b1 = r.to(torch.bfloat16)
    return torch.stack((b0, b1, (r - b1.float()).to(torch.bfloat16)))


def split_bf16x3(x):
    """The split pre-pass (`split_bf16x3_kernel`, one launch): fp32 [B, L,
    N, 128] -> bf16 parts [3, B, L, N, 128], contiguous. The plain version
    on CPU tensors."""
    if not x.is_cuda:
        return split_bf16x3_plain(x)
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[-1] != D128:
        raise TypeError("the split pre-pass takes fp32 [B, L, N, 128] "
                        "CUDA tensors")
    _check_aligned(x)
    b, l, n, d = x.shape
    out = torch.empty((3, b, l, n, d), dtype=torch.bfloat16, device=x.device)
    fn = _fn("flash_attention_f32_sm90", "univid_split_bf16x3",
             [_P, _P, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_longlong, _P])
    err = fn(x.data_ptr(), out.data_ptr(), b, l, n, x.stride(0),
             x.stride(1), x.stride(2), _stream(x))
    build.check(err, "univid_split_bf16x3")
    _count("split_bf16x3")
    return out


def _launch_f32_sm90(q, k, v, kv_len, bound, save_lse, mode=None,
                     lists=None, **masks):
    """The fp32 d=128 forward on csrc/flash_attention_f32_sm90.cu (running
    max, or bounded with `bound`) on folded q (k, v with N / group heads):
    the split pre-pass of q, k and v, then the kernel (four launches), under
    `mode` (`_f32_masks`: None, "causal", "segments" or "packed", with the
    forward list `lists` and the masks' operands) or the softmax_bf16 /
    oneshot modes of `_fwd_f32_sm90_parts`. (o, lse fp32 [B, N, Lq] or
    None)."""
    return _fwd_f32_sm90_parts(*(split_bf16x3(t) for t in (q, k, v)),
                               kv_len, bound, save_lse, mode, lists, **masks)


def _fwd_f32_sm90_parts(qp, kp, vp, kv_len, bound, save_lse, mode=None,
                        lists=None, *, softmax_bf16=False, oneshot=False,
                        **masks):
    """The forward kernel alone on split parts (`split_bf16x3`) of folded
    q [B, Lq, N, 128] and of k, v [B, Lk, N / group, 128]: (o, lse or
    None). The softmax is bounded with `bound` (an fp32 [1] on the
    device), else the running max, or with `oneshot` the one-shot max.
    softmax_bf16: the bf16 chain (unmasked but for kv_len, no lse), p one
    bf16 part, so p v is three bf16 products, exact in p."""
    _, b, lq, n, d = qp.shape
    group = n // kp.shape[3]
    softmax = ("oneshot" if oneshot else "running" if bound is None
               else "bounded")
    o = torch.empty((b, lq, n, d), dtype=torch.float32, device=qp.device)
    lse = (torch.empty((b, n, lq), dtype=torch.float32, device=qp.device)
           if save_lse else None)
    fn = _fn("flash_attention_f32_sm90", "univid_flash_fwd_f32_sm90",
             [_P] * 7 + _F32_MASK_ARGTYPES + [_I] * 7 + [_P, _P])
    strides = (ctypes.c_longlong * 3)(*o.stride()[:3])
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
             _ptr(kv_len), _ptr(bound), _ptr(lse),
             *_f32_mask_args(mode, lists, **masks), _MODES[softmax],
             int(softmax_bf16), b, n, group, lq, kp.shape[2],
             ctypes.addressof(strides), _stream(qp))
    build.check(err, "univid_flash_fwd_f32_sm90")
    if softmax_bf16:
        name = "flash_attention_f32_sm90_sbf16" + ("_oneshot" if oneshot
                                                   else "")
    else:
        name = ("flash_attention_f32_sm90_lse" if save_lse
                else "flash_attention_f32_sm90")
    _count(name, mode)
    if group > 1:
        GROUPED_LAUNCHES[name] += 1
    return o, lse


def _launch_f32_tc(q, k, v, kv_len):
    """csrc/flash_attention_f32_tc.cu on padded fp32 [B, L, N, D], D in
    F32_DIMS, q folded: 3xTF32 scores into an fp32 [B * N, Lq, Lk] scratch
    (with each row's max over each 128-key tile), the row max, p and 1 / l
    in place, then 3xTF32 p v (three launches, one call)."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    _check_aligned(q, k, v)
    o = torch.empty((b, lq, n, d), dtype=torch.float32, device=q.device)
    scores = torch.empty((b * n, lq, lk), dtype=torch.float32,
                         device=q.device)
    tile_max = torch.empty((b * n, lq, -(-lk // 128)), dtype=torch.float32,
                           device=q.device)
    inv_l = torch.empty((b * n, lq), dtype=torch.float32, device=q.device)
    fn = _fn("flash_attention_f32_tc", "univid_flash_fwd_f32_tc",
             [_P] * 8 + [_I] * 5 + [_P, _P])
    strides = _strides(q, k, v, o)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _ptr(kv_len), scores.data_ptr(), tile_max.data_ptr(),
             inv_l.data_ptr(), b, n, lq, lk, d, ctypes.addressof(strides),
             _stream(q))
    build.check(err, "univid_flash_fwd_f32_tc")
    return o


def _launch_f32_simt(q, k, v, kv_len):
    """csrc/flash_attention_f32.cu, the CUDA-core kernel that
    `_launch_f32_tc` replaced (the same function; a baseline reached only
    by chip_smoke.py and the card tests)."""
    b, lq, n, d = q.shape
    o = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    fn = _fn("flash_attention_f32", "univid_flash_fwd_f32",
             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P])
    strides = _strides(q, k, v, o)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _ptr(kv_len), b, n, lq, k.shape[1], d, ctypes.addressof(strides),
             _stream(q))
    build.check(err, "univid_flash_fwd_f32")
    return o


def _rope_f32(x, cf, sf):
    b, l, n, d = x.shape
    if x.stride(-1) != 1 or x.data_ptr() % 8 or any(s % 2 for s in
                                                     x.stride()[:-1]):
        raise ValueError("the fp32 rope kernel reads aligned pairs along D")
    y = torch.empty((b, l, n, d), dtype=torch.float32, device=x.device)
    fn = _fn("flash_attention_f32_d128", "univid_rope_rotate_f32",
             [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_longlong, _P])
    err = fn(x.data_ptr(), cf.data_ptr(), sf.data_ptr(), y.data_ptr(), b, l,
             n, d, x.stride(0), x.stride(1), x.stride(2), _stream(x))
    build.check(err, "univid_rope_rotate_f32")
    _count("rope_rotate_f32")
    return y


def _launch_bf16(q, k, v, kv_len, bound, mode, lse=None, causal=False,
                 q_offset=0, q_offsets=None, q_segments=None,
                 kv_segments=None, seg=None, softmax_bf16=False):
    """csrc/flash_attention.cu, the mma.sync bf16 forward: every mode the
    sm90 kernels took, causal included. No route reaches it: the same-call
    baseline of chip_smoke.py and the card tests."""
    b, lq, n, d = q.shape
    o = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    fn = _fn("flash_attention", "univid_flash_fwd_bf16",
             [_P] * 10 + [_I] * 11 + [_P, _P])
    strides = _strides(q, k, v, o)  # host array, read during the launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _ptr(kv_len), _ptr(bound), _ptr(lse), _ptr(q_offsets),
             _ptr(q_segments), _ptr(kv_segments), mode, int(causal),
             _SEG_MODE[seg], int(softmax_bf16), int(q_offset),
             n // k.shape[2], b, n, lq, k.shape[1], d,
             ctypes.addressof(strides), _stream(q))
    build.check(err, "univid_flash_fwd_bf16")
    return o


def _forward_route_checks(q, k, v, dtype, what, *, mode, lse, knobs, causal,
                          seg):
    """The checks `bf16_forward_route` and `f32_forward_route` share: q, k,
    v of `dtype` ("the {what} forward") at d=128, grouped kv heads that
    divide the query heads, a known softmax mode, no knob with a mask or
    the lse (KNOBS_MASKED), no causal with segments, the running max under
    a mask."""
    for t in (q, k, v):
        if t.dtype != dtype:
            raise TypeError(f"the {what} forward takes {dtype} tensors, got "
                            f"{t.dtype}")
        if t.dim() != 4 or t.shape[-1] != D128:
            raise ValueError(f"no {what} forward kernel for shape "
                             f"{tuple(t.shape)} (head dim {D128})")
    if k.shape[2] != v.shape[2] or q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads over {k.shape[2]} / "
                         f"{v.shape[2]} kv heads")
    if mode not in _MODES:
        raise ValueError(f"unknown softmax mode {mode!r}")
    masked = causal or seg is not None
    if knobs and (masked or lse):
        raise NotImplementedError(KNOBS_MASKED + "; the training forward "
                                  "takes no knob")
    if causal and seg is not None:
        raise NotImplementedError(
            "causal attention with segment ids has no caller and no kernel "
            "mode (packed_mode carries its own causal term)")
    if masked and mode != "running":
        raise NotImplementedError(
            "the causal, segment and packed kernel modes have the running "
            "max only (no caller bounds a masked softmax)")


def bf16_forward_route(q, k, v, *, mode, lse=False, softmax_bf16=False,
                       causal=False, seg=None):
    """The kernel that takes a bf16 attention forward on the card: "sm90"
    (csrc/flash_attention_sm90.cu) for every unmasked mode and for the
    segment and packed ones, "causal_sm90"
    (csrc/flash_attention_causal_sm90.cu) for the causal one, with and
    without the lse. The mma.sync kernel (csrc/flash_attention.cu) is no
    route's: the same-call baseline only.
    mode: "bounded", "running" or "oneshot"; seg: None, "segments" or
    "packed". Both kernels read grouped kv heads (k and v with N / group
    heads). Raises for a call no kernel takes; never falls back."""
    _forward_route_checks(q, k, v, torch.bfloat16, "bf16", mode=mode,
                          lse=lse, knobs=softmax_bf16, causal=causal, seg=seg)
    return "causal_sm90" if causal else "sm90"


def f32_forward_route(q, k, v, *, mode, lse=False, softmax_bf16=False,
                      qk_int8=False, causal=False, seg=None):
    """The kernel that takes an fp32 d=128 attention forward on the card,
    by its launch counter; every one is a mode of
    csrc/flash_attention_f32_sm90.cu: "flash_attention_f32_sm90" (with the
    lse "..._lse"; every mask, grouped kv heads) on the split operands;
    with softmax_bf16 "flash_attention_f32_sm90_sbf16" (bounded or running)
    or "..._sbf16_oneshot" (mode "oneshot": the row max over every key
    first, the cross call at Lk <= 512 without a bound), grouped kv heads
    too; with qk_int8 "flash_attention_f32_sm90_int8" or "..._int8_sbf16"
    on the int8 pre-pass's codes (bounded or running). mode: "bounded",
    "running" or "oneshot"; seg: None, "segments" or "packed". Raises for a
    call no kernel takes (a knob with a mask or the lse, qk_int8 over
    grouped kv heads, a bound with a mask); never falls back."""
    _forward_route_checks(q, k, v, torch.float32, "fp32 d=128", mode=mode,
                          lse=lse, knobs=softmax_bf16 or qk_int8,
                          causal=causal, seg=seg)
    if mode == "oneshot" and (qk_int8 or not softmax_bf16):
        raise NotImplementedError(
            "the one-shot max is the bf16 chain's cross mode; the fp32 chain "
            "and int8 QK^T take the bound or the running max")
    if qk_int8:
        if k.shape[2] != q.shape[2]:
            raise ValueError("the int8 kernel takes as many kv heads as q "
                             "heads")
        return "flash_attention_f32_sm90_int8" + ("_sbf16" if softmax_bf16
                                                  else "")
    if softmax_bf16:
        return "flash_attention_f32_sm90_sbf16" + ("_oneshot"
                                                   if mode == "oneshot"
                                                   else "")
    return "flash_attention_f32_sm90" + ("_lse" if lse else "")


def sm90_q_tiles(lq):
    """Blocks along q of flash_attention_sm90.cu: 128-row q tiles, the last
    one ragged when Lq % 128 == 64 (its rows past Lq read as zeros and are
    never stored)."""
    return -(-lq // SM90_BLOCK_Q)


def tma_strides(t):
    """The (b, l, h) element strides of a bf16 [B, L, N, D] operand as the
    sm90 kernel's tensor maps take them. TMA's rules: a 16-byte aligned
    base, unit stride along D, strides that are multiples of 16 bytes (8
    elements). A dimension of size 1 is never stepped along: it takes the
    stride a contiguous tensor would have. Raises ValueError when a rule
    fails (a view that TMA cannot read in place)."""
    shape, stride = t.shape, t.stride()   # read once: a call's host time
    if len(shape) != 4 or stride[3] != 1:
        raise ValueError("the sm90 kernel's tensor maps need unit stride "
                         "along D")
    if t.data_ptr() % 16:
        raise ValueError("the sm90 kernel's tensor maps need a 16-byte "
                         "aligned base")
    st = list(stride[:3])
    inner = shape[3]   # one step of the next inner dimension, in elements
    for i in (2, 1, 0):
        if shape[i] == 1:
            st[i] = inner
        if st[i] <= 0 or st[i] % 8:
            raise ValueError(f"the sm90 kernel's tensor maps need strides "
                             f"that are multiples of 16 bytes, got "
                             f"{tuple(stride)}")
        inner = st[i] * shape[i]
    return st


def tma_readable(t):
    """Whether the sm90 kernels' tensor maps read `t` in place
    (`tma_strides` does not raise)."""
    try:
        tma_strides(t)
    except ValueError:
        return False
    return True


def mask_tile_list(q_segments, kv_segments, kv_len=None, packed_mode=False):
    """The forward's old tile-list pre-pass: (list, count) of
    `mask_tile_list_plain` at the sm90 kernel's 128 x 128 tiles, one launch
    of mask_tiles_kernel (csrc/flash_attention_sm90.cu), which decides its
    flags pair by pair; the plain version on the CPU. `tile_lists`
    replaced it on every route: the same-call baseline of chip_smoke.py
    and the card tests."""
    if not q_segments.is_cuda:
        return mask_tile_list_plain(q_segments, kv_segments, kv_len,
                                    packed_mode)
    b, lq = q_segments.shape
    lk = kv_segments.shape[1]
    qt, kt = sm90_q_tiles(lq), -(-lk // SM90_BLOCK_K)
    lists = torch.empty((b, qt, kt), dtype=torch.int32,
                        device=q_segments.device)
    count = torch.empty((b, qt), dtype=torch.int32, device=q_segments.device)
    fn = _fn("flash_attention_sm90", "univid_mask_tile_list",
             [_P] * 5 + [_I] * 6 + [_P])
    err = fn(q_segments.data_ptr(), kv_segments.data_ptr(), _ptr(kv_len),
             lists.data_ptr(), count.data_ptr(),
             _SEG_MODE["packed" if packed_mode else "segments"], b, lq, lk,
             qt, kt, _stream(q_segments))
    build.check(err, "univid_mask_tile_list")
    _count("mask_tile_list")
    return lists, count


def tile_lists(b, lq, lk, device, *, kv_len=None, causal=False, q_offset=0,
               q_offsets=None, q_segments=None, kv_segments=None,
               packed_mode=False, fwd=True, bwd=True):
    """The masked modes' tile lists over padded Lq, Lk (multiples of 64):
    (fwd, bwd), fwd the forward's (list, count) of `mask_tile_list_plain`
    (None in the causal mode or when `fwd` is False), bwd the backward's
    of `bwd_tile_list_plain` (None when `bwd` is False), under one mask
    (segments, packed codes, or causal with q_offset / q_offsets) and
    kv_len. On the card both come from one launch of
    csrc/mask_tiles_sm90.cu (`tile_lists_by_runs` emulates its rule); on
    the CPU (`device`) the plain versions."""
    masks = dict(causal=causal, q_offset=q_offset, q_offsets=q_offsets,
                 q_segments=q_segments, kv_segments=kv_segments,
                 packed_mode=packed_mode)
    fwd = fwd and not causal
    if torch.device(device).type != "cuda":
        return ((mask_tile_list_plain(q_segments, kv_segments, kv_len,
                                      packed_mode) if fwd else None),
                (bwd_tile_list_plain(b, lq, lk, device, kv_len=kv_len,
                                     **masks) if bwd else None))
    if lq % TILE or lk % TILE or not (fwd or bwd):
        raise ValueError("the tile lists take Lq, Lk padded to multiples of "
                         "64, and at least one list")
    if causal == (q_segments is not None):
        raise ValueError("the tile lists take one mask: causal, or segment "
                         "ids for q and kv")
    for t, shape in ((q_segments, (b, lq)), (kv_segments, (b, lk)),
                     (kv_len, (b,)), (q_offsets, (b,))):
        if t is not None and (t.dtype != torch.int32 or not t.is_cuda
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise TypeError(f"the tile lists take contiguous int32 {shape} "
                            "codes, kv_len and q_offsets on the card")
    mode = "causal" if causal else "packed" if packed_mode else "segments"
    qt, kt = sm90_q_tiles(lq), -(-lk // SM90_BLOCK_K)
    out = []
    for want, shape in ((fwd, ((b, qt, kt), (b, qt))),
                        (bwd, ((b, kt, lq // BWD_BLOCK_Q), (b, kt)))):
        out.append(tuple(torch.empty(sh, dtype=torch.int32, device=device)
                         for sh in shape) if want else None)
    fn = _fn("mask_tiles_sm90", "univid_tile_lists", [_P] * 8 + [_I] * 5
             + [_P])
    err = fn(_ptr(q_segments), _ptr(kv_segments), _ptr(kv_len),
             _ptr(q_offsets), *(_ptr(t) for lc in out
                                for t in (lc or (None, None))),
             _BWD_MASK_MODE[mode], int(q_offset), b, lq, lk,
             torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "univid_tile_lists")
    _count("tile_lists")
    return out[0], out[1]


def _plan_lists(tile_plan, which, shape):
    """The plan's forward or backward (list, count), which the call's
    kernel reads: raises unless the plan has them at this call's shape."""
    lists = getattr(tile_plan, which)
    if lists is None or tuple(lists[0].shape) != shape:
        raise ValueError(f"the tile plan has no {which} list of shape "
                         f"{shape} on the card")
    return lists


def _launch_sm90(q, k, v, kv_len, bound, mode, lse=None, softmax_bf16=False,
                 q_segments=None, kv_segments=None, seg=None, tile_plan=None):
    """flash_attention_sm90.cu on padded bf16 [B, L, N, 128] (k, v with N /
    group heads): mode "bounded" (`bound` the folded score bound, an fp32
    [1] on the device), "running" or "oneshot"; lse fp32 [B, N, Lq] or
    None. seg "segments" or "packed" (running max): the codes q_segments
    [B, Lq] / kv_segments [B, Lk] and the forward's tile list, the plan's
    (`TilePlan`, built for these codes) or else from `tile_lists` first."""
    b, lq, n, d = q.shape
    o = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    st = tma_strides(q) + tma_strides(k) + tma_strides(v) + list(
        o.stride()[:3])
    strides = (ctypes.c_longlong * 12)(*st)  # host array, read at launch
    if seg is None:
        fn = _fn("flash_attention_sm90", "univid_flash_fwd_sm90",
                 [_P] * 7 + [_I] * 8 + [_P, _P])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _ptr(kv_len), _ptr(bound), _ptr(lse), _MODES[mode],
                 int(softmax_bf16), n // k.shape[2], b, n, lq, k.shape[1],
                 sm90_q_tiles(lq), ctypes.addressof(strides), _stream(q))
        build.check(err, "univid_flash_fwd_sm90")
        return o
    if mode != "running" or softmax_bf16 or bound is not None:
        raise NotImplementedError("the segment and packed modes take the "
                                  "running max and the fp32 chain only")
    if kv_segments.data_ptr() % 16:
        raise ValueError("the sm90 kernel copies kv codes in bulk: a "
                         "16-byte aligned kv_segments")
    if tile_plan is not None:
        lists, count = _plan_lists(tile_plan, "fwd", (
            b, sm90_q_tiles(lq), -(-k.shape[1] // SM90_BLOCK_K)))
    else:
        (lists, count), _ = tile_lists(
            b, lq, k.shape[1], q.device, kv_len=kv_len,
            q_segments=q_segments, kv_segments=kv_segments,
            packed_mode=seg == "packed", bwd=False)
    fn = _fn("flash_attention_sm90", "univid_flash_fwd_sm90_masked",
             [_P] * 10 + [_I] * 8 + [_P, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _ptr(kv_len), _ptr(lse), q_segments.data_ptr(),
             kv_segments.data_ptr(), lists.data_ptr(), count.data_ptr(),
             _SEG_MODE[seg], n // k.shape[2], b, n, lq, k.shape[1],
             sm90_q_tiles(lq), lists.shape[2], ctypes.addressof(strides),
             _stream(q))
    build.check(err, "univid_flash_fwd_sm90_masked")
    return o


def _launch_causal_sm90(q, k, v, kv_len, q_offset=0, q_offsets=None,
                        lse=None):
    """csrc/flash_attention_causal_sm90.cu on padded bf16 [B, L, N, 128]
    (k, v with N / group heads), q folded: the causal mode, query i of
    batch b at row i + q_offset + q_offsets[b], kv_len, the running max; lse
    fp32 [B, N, Lq] or None. With S = `causal_splits` > 1 the kernel writes
    fp32 partials into scratch [S, B, N, Lq, 128] and [S, B, N, Lq, 2] and
    a second launch merges them."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    group = n // k.shape[2]
    o = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    st = tma_strides(q) + tma_strides(k) + tma_strides(v) + list(
        o.stride()[:3])
    strides = (ctypes.c_longlong * 12)(*st)  # host array, read at launch
    splits = causal_splits(b, n, group, lq, lk)
    part_o = part_ml = None
    if splits > 1:   # one allocation: [S, B, N, Lq, 128], then [.., 2]
        rows = splits * b * n * lq
        part = torch.empty(rows * (d + 2), dtype=torch.float32,
                           device=q.device)
        part_o, part_ml = part[:rows * d], part[rows * d:]
    fn = _fn("flash_attention_causal_sm90", "univid_flash_fwd_causal_sm90",
             [_P] * 9 + [_I] * 7 + [_P, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _ptr(kv_len), _ptr(q_offsets), _ptr(lse), _ptr(part_o),
             _ptr(part_ml), int(q_offset), splits, group, b, n, lq, lk,
             ctypes.addressof(strides), _stream(q))
    build.check(err, "univid_flash_fwd_causal_sm90")
    return o


def _prepass_input(t):
    """A bf16 or fp32 [B, L, N, 128] operand as csrc/qk_prepass.cu reads it
    in 16-byte chunks: unit stride along D, a 16-byte aligned base, (b, l,
    h) strides multiples of 16 bytes; another view is copied first."""
    step = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s % step for s in t.stride()[:3]):
        return t.contiguous()
    return t


def _check_prepass(q, k, dtypes=(torch.bfloat16,)):
    for t in (q, k):
        if (not t.is_cuda or t.dtype not in dtypes or t.dim() != 4
                or t.shape[-1] != D128):
            names = " or ".join({torch.bfloat16: "bf16",
                                 torch.float32: "fp32"}[d] for d in dtypes)
            raise TypeError(f"the q / k pre-passes take {names} CUDA tensors "
                            f"[B, L, N, {D128}], got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if q.dtype != k.dtype:
        raise TypeError(f"q ({q.dtype}) and k ({k.dtype}) differ in dtype")
    if q.shape[0] != k.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch")
    if max(q.shape[2], k.shape[2]) > QK_PREPASS_MAX_HEADS:
        raise ValueError(f"the q / k pre-passes take at most "
                         f"{QK_PREPASS_MAX_HEADS} heads")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        raise RuntimeError("the q / k pre-passes are inference-only: "
                           "training norms and rotates under autograd")


def _tables(rope_tables, lq, lk):
    """The four fp32 [L, 128] rope tables as the kernels read them."""
    tabs = tuple(t.float().contiguous() for t in rope_tables)
    for t, length in zip(tabs, (lq, lq, lk, lk)):
        if t.dim() != 2 or t.shape[0] < length or t.shape[1] != D128:
            raise ValueError(f"rope table {tuple(t.shape)} does not cover "
                             f"[{length}, {D128}]")
    return tabs


def qk_norm_rope(q, k, *, qk_norm=None, rope_tables=None):
    """Kernel A of csrc/qk_prepass.cu, one launch for q [B, Lq, N, 128] and
    k [B, Lk, Nk, 128] bf16 (Nk may be N / group): with qk_norm = (gain_q,
    gain_k, eps), the gains bf16 [N * 128] and [Nk * 128], each token's RMS
    norm over its whole width; with
    rope_tables (cq, sq, ck, sk, fp32 [L, 128], q's with the fold) the
    rotation, in fp32, rounded to bf16. Norm + rope, norm only or rope
    only; returns contiguous (q, k) as `qk_norm_rope_plain`, which runs for
    CPU tensors. Counted as `qk_norm_rope_bf16`, `qk_norm_bf16` or
    `qk_rope_bf16`."""
    if qk_norm is None and rope_tables is None:
        raise ValueError("qk_norm_rope needs qk_norm, rope_tables or both")
    if not q.is_cuda:
        return qk_norm_rope_plain(q, k, qk_norm, rope_tables)
    _check_prepass(q, k)
    q, k = _prepass_input(q), _prepass_input(k)
    b, lq, n, d = q.shape
    lk, nk = k.shape[1], k.shape[2]
    gq = gk = None
    eps = 0.0
    if qk_norm is not None:
        gq, gk, eps = qk_norm
        for g, t in ((gq, q), (gk, k)):
            if (g.dtype != torch.bfloat16 or g.device != q.device
                    or tuple(g.shape) != (t.shape[2] * d,)):
                raise TypeError(f"qk-norm gains must be bf16 [N * {d}] on "
                                "the kernel's device (rms_norm multiplies "
                                "in x's dtype)")
            if torch.is_grad_enabled() and g.requires_grad:
                raise RuntimeError("the q / k pre-passes are inference-"
                                   "only: trainable gains norm under "
                                   "autograd")
        gq, gk = gq.contiguous(), gk.contiguous()
    tabs = (None,) * 4 if rope_tables is None else _tables(rope_tables,
                                                           lq, lk)
    yq = torch.empty((b, lq, n, d), dtype=torch.bfloat16, device=q.device)
    yk = torch.empty((b, lk, nk, d), dtype=torch.bfloat16, device=q.device)
    ll = ctypes.c_longlong
    fn = _fn("qk_prepass", "univid_qk_norm_rope",
             [_P] * 10 + [_I] * 5 + [ll] * 6 + [ctypes.c_float, _P])
    err = fn(q.data_ptr(), k.data_ptr(), yq.data_ptr(), yk.data_ptr(),
             _ptr(gq), _ptr(gk), *(_ptr(t) for t in tabs), b, lq, lk, n, nk,
             *q.stride()[:3], *k.stride()[:3], float(eps), _stream(q))
    build.check(err, "univid_qk_norm_rope")
    _count("qk_norm_bf16" if rope_tables is None else
           "qk_rope_bf16" if qk_norm is None else "qk_norm_rope_bf16")
    return yq, yk


def _rope_bf16(x, cf, sf):
    """univid_rope_rotate_bf16 of csrc/flash_attention.cu, the rope
    pre-pass that `qk_norm_rope` replaced: a baseline reached only by
    chip_smoke.py and the card tests (counter `rope_rotate_bf16`)."""
    b, l, n, d = x.shape
    y = torch.empty((b, l, n, d), dtype=torch.bfloat16, device=x.device)
    fn = _fn("flash_attention", "univid_rope_rotate_bf16",
             [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_longlong, _P])
    if x.stride(-1) != 1:
        raise ValueError("rope kernel needs unit stride along D")
    err = fn(x.data_ptr(), cf.data_ptr(), sf.data_ptr(), y.data_ptr(), b, l,
             n, d, x.stride(0), x.stride(1), x.stride(2), _stream(x))
    build.check(err, "univid_rope_rotate_bf16")
    _count("rope_rotate_bf16")
    return y


def _bound_tensor(bound, device):
    if bound is None:
        return None
    return torch.as_tensor(bound, dtype=torch.float32).to(device).reshape(1)


def _flash_cuda(q, k, v, kv_len, bound, rope_tables, causal=False,
                q_offset=0, q_offsets=None, q_segments=None, kv_segments=None,
                packed_mode=False, softmax_bf16=False, tile_plan=None):
    if q.dtype == torch.bfloat16:
        _check_cuda_inputs(q, k, v, kv_len, torch.bfloat16, (128,),
                           group_ok=True)
        seg = _check_masks(q, k.shape[1], q_offsets, q_segments, kv_segments,
                           packed_mode, causal)
        mode = "bounded" if bound is not None else "running"
        impl = bf16_forward_route(q, k, v, mode=mode,
                                  softmax_bf16=softmax_bf16, causal=causal,
                                  seg=seg)
        if rope_tables is not None:
            if seg is not None:
                raise NotImplementedError(
                    "fused rope does not compose with segment masks (as in "
                    "the JAX kernel)")
            q, k = qk_norm_rope(q, k, rope_tables=rope_tables)
        if causal:
            o = _launch_causal_sm90(q, k, v, kv_len, q_offset, q_offsets)
            _count("flash_attention_bf16_causal", impl=impl)
            return o
        o = _launch_sm90(q, k, v, kv_len, _bound_tensor(bound, q.device),
                         mode, softmax_bf16=softmax_bf16,
                         q_segments=q_segments, kv_segments=kv_segments,
                         seg=seg, tile_plan=tile_plan)
        _count("flash_attention_bf16_sbf16" if softmax_bf16
               else "flash_attention_bf16", seg, impl=impl)
        return o
    if q.dtype == torch.float32 and q.shape[-1] == D128:
        _check_cuda_inputs(q, k, v, kv_len, torch.float32, (D128,),
                           group_ok=True)
        masks = dict(causal=causal, q_offset=q_offset, q_offsets=q_offsets,
                     q_segments=q_segments, kv_segments=kv_segments,
                     packed_mode=packed_mode)
        seg = _check_masks(q, k.shape[1], q_offsets, q_segments, kv_segments,
                           packed_mode, causal)
        # the bf16 chain's cross call (Lk <= 512, no bound) takes the
        # one-shot max, as JAX's one-block _cross_kernel does
        softmax = ("bounded" if bound is not None else "oneshot"
                   if softmax_bf16 and k.shape[1] <= CROSS_MAX_LK
                   else "running")
        name = f32_forward_route(q, k, v, mode=softmax,
                                 softmax_bf16=softmax_bf16, causal=causal,
                                 seg=seg)
        mode, lists, _ = _f32_masks(q, k, kv_len, bound, tile_plan, **masks)
        if rope_tables is not None:
            if mode in ("segments", "packed"):
                raise NotImplementedError(
                    "fused rope does not compose with segment masks (as in "
                    "the JAX kernel)")
            cq, sq, ck, sk = (t.float().contiguous() for t in rope_tables)
            q = _rope_f32(q, cq, sq)
            k = _rope_f32(k, ck, sk)
        o, _ = _launch_f32_sm90(q, k, v, kv_len,
                                _bound_tensor(bound, q.device), False, mode,
                                lists, softmax_bf16=softmax_bf16,
                                oneshot=softmax == "oneshot", **masks)
        return o
    if q.dtype == torch.float32:
        _check_cuda_inputs(q, k, v, kv_len, torch.float32,
                           F32_DIMS + (D128,))
        if (rope_tables is not None or bound is not None or causal
                or q_segments is not None or softmax_bf16):
            raise NotImplementedError(
                "the fp32 kernel has the VAE's plain mode only (no fused "
                "rope, no bound, not causal, no segments, no knob)")
        o = _launch_f32_tc(q, k, v, kv_len)
        _count("flash_attention_f32")
        F32_LAUNCHES_BY_D[q.shape[-1]] += 1
        return o
    raise TypeError(f"no attention kernel for {q.dtype}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def cross_attention_padded(q, k, v, *, kv_len=None, score_bound=None,
                           softmax_bf16: bool = False):
    """Single-kv-block attention (Lk <= 512). q is already scale * log2(e)
    folded; score_bound is in the folded domain; softmax_bf16: the bf16
    softmax chain."""
    if not q.is_cuda:
        return attention_plain(q, k, v, kv_len=kv_len, bound=score_bound,
                               softmax_bf16=softmax_bf16)
    _check_cuda_inputs(q, k, v, kv_len, torch.bfloat16, (128,),
                       group_ok=True)
    if k.shape[1] > CROSS_MAX_LK:
        raise ValueError(f"cross kernel takes Lk <= {CROSS_MAX_LK}")
    mode = "bounded" if score_bound is not None else "oneshot"
    impl = bf16_forward_route(q, k, v, mode=mode, softmax_bf16=softmax_bf16)
    o = _launch_sm90(q, k, v, kv_len, _bound_tensor(score_bound, q.device),
                     mode, softmax_bf16=softmax_bf16)
    _count("cross_attention_bf16_sbf16" if softmax_bf16
           else "cross_attention_bf16", impl=impl)
    return o


def _check_int8_inputs(*ts):
    for t in ts:
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.shape[-1] != D128:
            raise TypeError("the int8 kernels take bf16 CUDA tensors of "
                            f"head dim {D128}, got {t.dtype} {tuple(t.shape)} "
                            f"on {t.device}")
        if t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:-1]) \
                or t.stride(-1) != 1:
            raise ValueError("the int8 pre-pass reads aligned bf16 pairs")


def quantize_qk_int8(q, k, rope_tables=None, block_k: int = 512):
    """The qk_int8 pre-pass: (qi, sq, ki, akq) of `quantize_qk_int8_plain`,
    from padded q, k [B, L, N, 128] bf16 or fp32 (rope_tables padded, or
    None with q already folded); the k scale's block of block_k keys (a
    multiple of 64: every 64-key tile of the kernel lies in one block). On
    the card kernel B of csrc/qk_prepass.cu: a launch that writes q's codes
    and folds each k block's max by atomicMax, then a launch that writes
    k's codes; counted as `quantize_qk_int8` (bf16) or
    `quantize_qk_int8_f32` (fp32 rows, rotated from fp32 and never rounded
    to bf16), two a call. The plain version on the CPU."""
    if block_k <= 0 or block_k % TILE:
        raise ValueError(f"block_k {block_k} is not a multiple of {TILE}")
    if not q.is_cuda:
        return quantize_qk_int8_plain(q, k, rope_tables, block_k)
    _check_prepass(q, k, (torch.bfloat16, torch.float32))
    if k.shape[2] != q.shape[2]:
        raise ValueError("the int8 kernel takes as many kv heads as q heads")
    q, k = _prepass_input(q), _prepass_input(k)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    nblk = -(-lk // block_k)
    tabs = (None,) * 4 if rope_tables is None else _tables(rope_tables,
                                                           lq, lk)
    qi = torch.empty((b, n, lq, d), dtype=torch.int8, device=q.device)
    sq = torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
    ki = torch.empty((b, n, lk, d), dtype=torch.int8, device=q.device)
    akq = torch.empty((b, n, nblk), dtype=torch.float32, device=q.device)
    kmax = torch.zeros((b, n, nblk), dtype=torch.int32, device=q.device)
    ll = ctypes.c_longlong
    f32 = q.dtype == torch.float32
    sym = "univid_quant_qk_int8_f32" if f32 else "univid_quant_qk_int8"
    fn = _fn("qk_prepass", sym, [_P] * 11 + [_I] * 5 + [ll] * 6 + [_P])
    err = fn(q.data_ptr(), k.data_ptr(), *(_ptr(t) for t in tabs),
             qi.data_ptr(), sq.data_ptr(), ki.data_ptr(), akq.data_ptr(),
             kmax.data_ptr(), b, lq, lk, n, block_k, *q.stride()[:3],
             *k.stride()[:3], _stream(q))
    build.check(err, sym)
    LAUNCHES["quantize_qk_int8_f32" if f32 else "quantize_qk_int8"] += 2
    return qi, sq, ki, akq


def _quantize_qk_int8_pair(q, k, rope_tables=None, block_k: int = 512):
    """quant_q_kernel / quant_k_kernel of csrc/flash_attention_int8.cu, the
    pre-pass kernel B replaced (two launches a call, k swept twice, the
    tables read once a head): a baseline reached only by chip_smoke.py and
    the card tests, counted as `quantize_qk_int8_pair`."""
    if block_k <= 0 or block_k % TILE:
        raise ValueError(f"block_k {block_k} is not a multiple of {TILE}")
    _check_int8_inputs(q, k)
    if k.shape[2] != q.shape[2]:
        raise ValueError("the int8 kernel takes as many kv heads as q heads")
    tabs = ((None,) * 4 if rope_tables is None else
            tuple(t.float().contiguous() for t in rope_tables))
    b, lq, n, d = q.shape
    lk = k.shape[1]
    qi = torch.empty((b, n, lq, d), dtype=torch.int8, device=q.device)
    sq = torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
    ki = torch.empty((b, n, lk, d), dtype=torch.int8, device=q.device)
    akq = torch.empty((b, n, -(-lk // block_k)), dtype=torch.float32,
                      device=q.device)
    ll = ctypes.c_longlong
    fq = _fn("flash_attention_int8", "univid_quant_q_int8",
             [_P] * 5 + [_I] * 4 + [ll] * 3 + [_P])
    err = fq(q.data_ptr(), _ptr(tabs[0]), _ptr(tabs[1]), qi.data_ptr(),
             sq.data_ptr(), b, lq, n, d, *q.stride()[:3], _stream(q))
    build.check(err, "univid_quant_q_int8")
    fk = _fn("flash_attention_int8", "univid_quant_k_int8",
             [_P] * 5 + [_I] * 5 + [ll] * 3 + [_P])
    err = fk(k.data_ptr(), _ptr(tabs[2]), _ptr(tabs[3]), ki.data_ptr(),
             akq.data_ptr(), b, lk, n, d, block_k, *k.stride()[:3],
             _stream(k))
    build.check(err, "univid_quant_k_int8")
    LAUNCHES["quantize_qk_int8_pair"] += 2
    return qi, sq, ki, akq


def _check_int8_attention(qi, sq, ki, akq, v, kv_len, block_k):
    b, n, lq, d = qi.shape
    lk = ki.shape[2]
    for t, dt, shape in ((qi, torch.int8, (b, n, lq, d)),
                         (ki, torch.int8, (b, n, lk, d)),
                         (sq, torch.float32, (b, n, lq)),
                         (akq, torch.float32, (b, n, -(-lk // block_k)))):
        if (t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != v.device):
            raise TypeError("qi, sq, ki, akq must be the pre-pass's outputs "
                            f"for block_k {block_k}")
    if (v.dtype not in (torch.bfloat16, torch.float32)
            or tuple(v.shape) != (b, lk, n, d)):
        raise TypeError("v must be bf16 or fp32 [B, Lk, N, D]")
    if d != D128:
        raise ValueError(f"the int8 attention kernels take head dim {D128}, "
                         f"not {d}")
    if lq % TILE or lk % TILE or block_k % TILE:
        raise ValueError(f"Lq, Lk and block_k must be multiples of {TILE}")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or kv_len.device != v.device):
        raise TypeError("kv_len must be int32 on the kernel's device")
    if v.stride(-1) != 1:
        raise ValueError("attention kernels need unit stride along D")


def _launch_int8_sm90(qi, sq, ki, akq, v, kv_len, bound, softmax_bf16,
                      block_k):
    """csrc/flash_attention_int8_sm90.cu on checked operands (bound the
    folded score bound, an fp32 [1] on the device, or None: running max).
    v is read through a TMA map: a view TMA cannot read is copied first."""
    b, n, lq, d = qi.shape
    if not tma_readable(v):
        v = v.contiguous()
    o = torch.empty((b, lq, n, d), dtype=v.dtype, device=v.device)
    st = tma_strides(v) + list(o.stride()[:3])
    strides = (ctypes.c_longlong * 6)(*st)  # host array, read at launch
    fn = _fn("flash_attention_int8_sm90", "univid_flash_fwd_int8_sm90",
             [_P] * 8 + [_I] * 8 + [_P, _P])
    err = fn(qi.data_ptr(), sq.data_ptr(), ki.data_ptr(), akq.data_ptr(),
             v.data_ptr(), o.data_ptr(), _ptr(kv_len), _ptr(bound),
             _MODE_BOUNDED if bound is not None else _MODE_RUNNING,
             int(softmax_bf16), b, n, lq, ki.shape[2], block_k,
             -(-lq // INT8_SM90_BLOCK_Q), ctypes.addressof(strides),
             _stream(v))
    build.check(err, "univid_flash_fwd_int8_sm90")
    return o


def _f32_int8_parts(qi, sq, ki, akq, vp, kv_len, bound, softmax_bf16,
                    block_k):
    """The fp32 d=128 forward's int8 QK^T mode on
    csrc/flash_attention_f32_sm90.cu, on checked codes and scales of the
    pre-pass and the split parts of v: s8 wgmma scores rescaled in the plain
    version's order, the fp32 chain's p as three bf16 parts (six products a
    p v) or the bf16 chain's as one (three). fp32 [B, Lq, N, 128]."""
    b, n, lq, d = qi.shape
    o = torch.empty((b, lq, n, d), dtype=torch.float32, device=vp.device)
    fn = _fn("flash_attention_f32_sm90", "univid_flash_fwd_f32_int8_sm90",
             [_P] * 8 + [_I] * 7 + [_P, _P])
    strides = (ctypes.c_longlong * 3)(*o.stride()[:3])
    err = fn(qi.data_ptr(), sq.data_ptr(), ki.data_ptr(), akq.data_ptr(),
             vp.data_ptr(), o.data_ptr(), _ptr(kv_len), _ptr(bound),
             _MODE_BOUNDED if bound is not None else _MODE_RUNNING,
             int(softmax_bf16), b, n, lq, ki.shape[2], block_k,
             ctypes.addressof(strides), _stream(vp))
    build.check(err, "univid_flash_fwd_f32_int8_sm90")
    return o


def flash_attention_int8(qi, sq, ki, akq, v, *, kv_len=None, score_bound=None,
                         softmax_bf16: bool = False, block_k: int = 512):
    """The int8 QK^T attention on the pre-pass's codes and scales, v [B, Lk,
    N, 128] -> [B, Lq, N, 128] in v's dtype: bounded (score_bound, folded)
    or running max, kv_len, the fp32 or the bf16 softmax chain. On the
    card: bf16 v on csrc/flash_attention_int8_sm90.cu (one launch), fp32 v
    on the int8 mode of csrc/flash_attention_f32_sm90.cu (`_f32_int8_parts`
    after the split pre-pass of v; counted as
    `flash_attention_f32_sm90_int8` or `..._int8_sbf16`)."""
    if not v.is_cuda:
        return attention_int8_plain(qi, sq, ki, akq, v, kv_len=kv_len,
                                    bound=score_bound,
                                    softmax_bf16=softmax_bf16,
                                    block_k=block_k)
    _check_int8_attention(qi, sq, ki, akq, v, kv_len, block_k)
    if v.dtype == torch.float32:   # v alone is split: q and k are codes
        o = _f32_int8_parts(qi, sq, ki, akq, split_bf16x3(v), kv_len,
                            _bound_tensor(score_bound, v.device),
                            softmax_bf16, block_k)
        _count("flash_attention_f32_sm90_int8_sbf16" if softmax_bf16
               else "flash_attention_f32_sm90_int8")
        return o
    o = _launch_int8_sm90(qi, sq, ki, akq, v, kv_len,
                          _bound_tensor(score_bound, v.device), softmax_bf16,
                          block_k)
    _count("flash_attention_int8_sbf16" if softmax_bf16
           else "flash_attention_int8")
    return o


def _launch_int8_mma_sync(qi, sq, ki, akq, v, *, kv_len=None,
                          score_bound=None, softmax_bf16: bool = False,
                          block_k: int = 512):
    """`flash_attention_int8` on flash_fwd_int8_kernel of
    csrc/flash_attention_int8.cu (mma.sync m16n8k32 over 64 x 64 tiles,
    cp.async), the kernel the sm90 one replaced: a baseline reached only by
    chip_smoke.py and the card tests, counted as
    `flash_attention_int8[_sbf16]_mma_sync`."""
    _check_int8_attention(qi, sq, ki, akq, v, kv_len, block_k)
    if v.dtype != torch.bfloat16:
        raise TypeError("the mma.sync int8 kernel takes bf16 v")
    b, n, lq, d = qi.shape
    o = torch.empty((b, lq, n, d), dtype=v.dtype, device=v.device)
    bound = _bound_tensor(score_bound, v.device)
    fn = _fn("flash_attention_int8", "univid_flash_fwd_int8",
             [_P] * 8 + [_I] * 7 + [_P, _P])
    st = v.stride()[:3] + o.stride()[:3]
    strides = (ctypes.c_longlong * 6)(*st)
    err = fn(qi.data_ptr(), sq.data_ptr(), ki.data_ptr(), akq.data_ptr(),
             v.data_ptr(), o.data_ptr(), _ptr(kv_len), _ptr(bound),
             _MODE_BOUNDED if bound is not None else _MODE_RUNNING,
             int(softmax_bf16), b, n, lq, ki.shape[2], block_k,
             ctypes.addressof(strides), _stream(v))
    build.check(err, "univid_flash_fwd_int8")
    _count("flash_attention_int8_sbf16_mma_sync" if softmax_bf16
           else "flash_attention_int8_mma_sync")
    return o


def flash_attention_padded(q, k, v, *, kv_len=None, softmax_scale=None,
                           rope_tables=None, score_bound=None,
                           save_residuals: bool = False, causal: bool = False,
                           q_offset: int = 0, q_offsets=None, q_segments=None,
                           kv_segments=None, packed_mode: bool = False,
                           softmax_bf16: bool = False, qk_int8: bool = False,
                           block_k: int = 512, qk_norm=None, tile_plan=None):
    """Attention over padded [B, L, N, D] (k, v may have N / group heads).

    rope_tables: build_fused_rope_tables output -> q and k rotated first
    (rotated q kept in q's dtype, rotated k in v's dtype). Without them q is
    folded by softmax_scale * log2(e) in q's dtype. score_bound: proven
    upper bound on the FOLDED scores -> bounded softmax. causal: query i of
    batch b is row i + q_offset + q_offsets[b] (q_offsets int32 [B] on q's
    device, never read on the host) and sees keys at or before its row.
    q_segments [B, Lq], kv_segments [B, Lk] (int32): a query sees only keys
    of its own id; with packed_mode they are pack_mask_codes codes and the
    BAGEL packed-training predicate applies (`packed_mask_allowed`; no q
    offsets). bf16 with Lk <= 512, no rope, no mask but kv_len takes the
    single-kv-block cross route, except with save_residuals, which returns
    (o, lse) from the generic kernel (the training forward; lse as in
    `attention_plain`). softmax_bf16: the bf16 softmax chain. qk_int8: the
    int8 QK^T route (`quantize_qk_int8`, whose k scales span blocks of
    min(block_k, Lk) keys, the JAX kernel's kv block, then
    `flash_attention_int8`); it takes every Lk, as the JAX kernel's
    generic grid does. The knobs take kv_len and the bound, no other mask,
    and no lse. qk_norm = (gain_q, gain_k, eps): q and k (bf16, D = 128)
    arrive before Wan's qk RMS norm over each token's N * D width;
    `qk_norm_rope` norms them (and rotates them with rope_tables, unless
    qk_int8 takes the rotation); `attention` passes it only on the card's
    no-grad bf16 route and norms first on every other. tile_plan: the
    `TilePlan` of these codes, whose tile list the segment and packed
    kernels read (without one they build it first)."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if lq % TILE or lk % TILE:
        raise ValueError(f"pad Lq, Lk ({lq}, {lk}) to multiples of {TILE}")
    if causal and q_offset < 0:
        raise ValueError("a causal q_offset is a row index (>= 0)")
    # the packed mode's causal term reads the pack's own row indices
    assert not (packed_mode and (q_offset != 0 or q_offsets is not None)), \
        "packed_mode does not support q offsets"
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    masks = dict(causal=causal, q_offset=q_offset, q_offsets=q_offsets,
                 q_segments=q_segments, kv_segments=kv_segments,
                 packed_mode=packed_mode)
    knobs = softmax_bf16 or qk_int8
    if knobs and (causal or q_segments is not None or kv_segments is not None
                  or save_residuals):
        raise NotImplementedError(KNOBS_MASKED + "; the training forward "
                                  "takes no knob")
    if save_residuals:
        if rope_tables is not None or qk_norm is not None:
            raise NotImplementedError(
                "the training forward takes normed and rotated q and k (the "
                "JAX package's training path applies both outside the "
                "kernel)")
        return flash_attention_fwd_folded(_fold(q, softmax_scale), k, v,
                                          kv_len=kv_len,
                                          score_bound=score_bound,
                                          tile_plan=tile_plan, **masks)
    rotated = rope_tables is not None   # q's tables carry the fold
    if rotated:
        rope_tables = _pad_tables(rope_tables, lq, lk,
                                  softmax_scale * LOG2E)
    if qk_norm is not None:
        if qk_int8 or not rotated:   # norm only
            q, k = qk_norm_rope(q, k, qk_norm=qk_norm)
        else:   # norm + rope in one pass
            q, k = qk_norm_rope(q, k, qk_norm=qk_norm,
                                rope_tables=rope_tables)
            rope_tables = None
    if not rotated:
        q = _fold(q, softmax_scale)
    if qk_int8:
        bw = min(block_k, lk)
        qi, sq, ki, akq = quantize_qk_int8(q, k, rope_tables, bw)
        return flash_attention_int8(qi, sq, ki, akq, v, kv_len=kv_len,
                                    score_bound=score_bound,
                                    softmax_bf16=softmax_bf16, block_k=bw)
    # the cross kernel is bf16; fp32 calls (the fp32 DiT's cross-attention,
    # the VAE on small frames) stay on the flash route, the same function
    if (not rotated and lk <= CROSS_MAX_LK
            and q.dtype == torch.bfloat16 and not causal
            and q_segments is None):
        return cross_attention_padded(q, k, v, kv_len=kv_len,
                                      score_bound=score_bound,
                                      softmax_bf16=softmax_bf16)
    if q.is_cuda:
        return _flash_cuda(q, k, v, kv_len, score_bound, rope_tables,
                           softmax_bf16=softmax_bf16, tile_plan=tile_plan,
                           **masks)
    return attention_plain(q, k, v, kv_len=kv_len, bound=score_bound,
                           rope_tables=rope_tables, softmax_bf16=softmax_bf16,
                           **masks)


def flash_attention_fwd_folded(qs, k, v, *, kv_len=None, score_bound=None,
                               causal=False, q_offset=0, q_offsets=None,
                               q_segments=None, kv_segments=None,
                               packed_mode=False, tile_plan=None):
    """The training forward on an already folded qs: (o, lse fp32
    [B, N, Lq]), bounded or running max, any Lk that is a multiple of 64
    (the generic kernel, also at the Lk = 512 cross shape); the masks of
    `flash_attention_padded` (running max only) and its tile_plan."""
    masks = dict(causal=causal, q_offset=q_offset, q_offsets=q_offsets,
                 q_segments=q_segments, kv_segments=kv_segments,
                 packed_mode=packed_mode)
    if not qs.is_cuda:
        return attention_plain(qs, k, v, kv_len=kv_len, bound=score_bound,
                               save_residuals=True, **masks)
    if qs.dtype == torch.float32:
        _check_cuda_inputs(qs, k, v, kv_len, torch.float32, (D128,),
                           group_ok=True)
        mode, lists, _ = _f32_masks(qs, k, kv_len, score_bound, tile_plan,
                                    **masks)
        return _launch_f32_sm90(qs, k, v, kv_len,
                                _bound_tensor(score_bound, qs.device), True,
                                mode, lists, **masks)
    _check_cuda_inputs(qs, k, v, kv_len, torch.bfloat16, (D128,))
    seg = _check_masks(qs, k.shape[1], q_offsets, q_segments, kv_segments,
                       packed_mode, causal)
    b, lq, n, _ = qs.shape
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=qs.device)
    mode = "bounded" if score_bound is not None else "running"
    impl = bf16_forward_route(qs, k, v, mode=mode, lse=True, causal=causal,
                              seg=seg)
    bound = _bound_tensor(score_bound, qs.device)
    if impl == "sm90":
        o = _launch_sm90(qs, k, v, kv_len, bound, mode, lse=lse,
                         q_segments=q_segments, kv_segments=kv_segments,
                         seg=seg, tile_plan=tile_plan)
    else:
        o = _launch_causal_sm90(qs, k, v, kv_len, q_offset, q_offsets,
                                lse=lse)
    _count("flash_attention_bf16_lse", "causal" if causal else seg,
           impl=impl)
    return o, lse


def flash_attention_bwd_padded(q, k, v, o, lse, do, *, kv_len=None,
                               softmax_scale=None, causal=False, q_offset=0,
                               q_offsets=None, q_segments=None,
                               kv_segments=None, packed_mode=False):
    """dq, dk, dv of `flash_attention_padded` for RAW q (folded here as on
    the TPU), from its output o, its lse and the output cotangent do, all
    padded [B, L, N, D] (lse [B, N, Lq]), under the forward's masks."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    assert not (packed_mode and (q_offset != 0 or q_offsets is not None)), \
        "packed_mode does not support q offsets"
    return flash_attention_bwd_folded(
        _fold(q, softmax_scale), k, v, o, lse, do, kv_len=kv_len,
        softmax_scale=softmax_scale, causal=causal, q_offset=q_offset,
        q_offsets=q_offsets, q_segments=q_segments, kv_segments=kv_segments,
        packed_mode=packed_mode)


def flash_attention_bwd_folded(qs, k, v, o, lse, do, *, kv_len=None,
                               softmax_scale, tile_plan=None, **masks):
    """The backward on the folded qs of the forward: the plain version on
    the CPU; on the card, bf16: the kernel `bf16_backward_route` names (the
    one-pass sm90 kernel, under every mask); fp32: the fp32 pair of
    csrc/flash_attention_f32_sm90.cu (the split pre-passes, dq and delta,
    then dk/dv). masks: causal, q_offset, q_offsets, q_segments,
    kv_segments, packed_mode (bf16 only); tile_plan: the `TilePlan` of the
    segment or packed codes, whose backward list the kernel walks."""
    if not qs.is_cuda:
        return _bwd_plain_folded(qs, k, v, o, lse, do, kv_len, softmax_scale,
                                 **masks)
    if qs.dtype == torch.float32:
        return _bwd_f32_sm90(qs, k, v, o, lse, do, kv_len, softmax_scale,
                             tile_plan, **masks)
    impl = bf16_backward_route(qs, k, v)  # the launch checks the masks
    out = _launch_bwd_sm90(qs, k, v, o, lse, do, kv_len, softmax_scale,
                           tile_plan=tile_plan, **masks)
    BWD_LAUNCHES_BY_IMPL[impl] += 1
    return out


def bf16_backward_route(q, k, v, *, causal=False, seg=None):
    """The kernel that takes a bf16 attention backward on the card: "sm90"
    (csrc/flash_attention_bwd_sm90.cu, the one-pass form) for every call,
    whatever the forward's softmax (the backward reads only its lse), with
    or without kv_len, at any Lk (the cross shape too), unmasked or under
    a causal (static and device offsets), segment or packed mask. The
    mma.sync pair of csrc/flash_attention_bwd.cu ("mma_sync") is no
    route's kernel: it stays built as the same-call baseline. seg: None,
    "segments" or "packed". Raises for a call no kernel takes (not bf16,
    head dim other than 128, grouped kv heads, causal with segments);
    never falls back."""
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the bf16 backward takes bf16 tensors, got "
                            f"{t.dtype}")
        if t.dim() != 4 or t.shape[-1] != D128:
            raise ValueError(f"no bf16 backward kernel for shape "
                             f"{tuple(t.shape)} (head dim {D128})")
    if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads over {k.shape[2]} kv "
                         "heads: the backward kernels take as many kv heads "
                         "as query heads (repeat them first)")
    if causal and seg is not None:
        raise NotImplementedError(
            "causal attention with segment ids has no caller and no kernel "
            "mode (packed_mode carries its own causal term)")
    if seg not in (None, "segments", "packed"):
        raise ValueError(f"unknown segment mode {seg!r}")
    return "sm90"


def bwd_sm90_q_splits(bn, lq, lk, sms=H100_SMS):
    """Blocks a kv tile along q of flash_attention_bwd_sm90.cu: 1 when the
    B * N * ceil(Lk / 128) kv-tile blocks fill the card's `sms` SMs (the
    self shape); else enough splits for about four blocks an SM (the cross
    shape, 512 keys: 48 blocks -> 11 splits), at most Lq / 64."""
    base = bn * -(-lk // BWD_BLOCK_K)
    if base >= sms:
        return 1
    return max(1, min(lq // BWD_BLOCK_Q, 4 * sms // base))


def bwd_tile_list(qs, lk, kv_len=None, *, causal=False, q_offset=0,
                  q_offsets=None, q_segments=None, kv_segments=None,
                  packed_mode=False):
    """The masked backward's old tile-list pre-pass: (list, count) of
    `bwd_tile_list_plain` for the folded q `qs` [B, Lq, N, D] over lk keys
    under one mask (causal, segments or packed), one launch of
    bwd_tiles_kernel (csrc/flash_attention_bwd_sm90.cu), pair by pair; the
    plain version on the CPU. `tile_lists` replaced it on every route: the
    same-call baseline of chip_smoke.py and the card tests."""
    b, lq = qs.shape[:2]
    masks = dict(causal=causal, q_offset=q_offset, q_offsets=q_offsets,
                 q_segments=q_segments, kv_segments=kv_segments,
                 packed_mode=packed_mode)
    if not qs.is_cuda:
        return bwd_tile_list_plain(b, lq, lk, qs.device, kv_len=kv_len,
                                   **masks)
    seg = _check_masks(qs, lk, q_offsets, q_segments, kv_segments,
                       packed_mode, causal)
    mode = "causal" if causal else seg
    if mode is None:
        raise ValueError("the tile list serves the causal, segment and "
                         "packed modes")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or kv_len.device != qs.device):
        raise TypeError("kv_len must be int32 on the kernel's device")
    kt = -(-lk // BWD_BLOCK_K)
    lists = torch.empty((b, kt, lq // BWD_BLOCK_Q), dtype=torch.int32,
                        device=qs.device)
    count = torch.empty((b, kt), dtype=torch.int32, device=qs.device)
    fn = _fn("flash_attention_bwd_sm90", "univid_bwd_tile_list",
             [_P] * 6 + [_I] * 5 + [_P])
    err = fn(_ptr(q_segments), _ptr(kv_segments), _ptr(kv_len),
             _ptr(q_offsets), lists.data_ptr(), count.data_ptr(),
             _BWD_MASK_MODE[mode], int(q_offset), b, lq, lk, _stream(qs))
    build.check(err, "univid_bwd_tile_list")
    _count("bwd_tile_list")
    return lists, count


def _launch_bwd_sm90(qs, k, v, o, lse, do, kv_len, softmax_scale,
                     q_splits=None, *, causal=False, q_offset=0,
                     q_offsets=None, q_segments=None, kv_segments=None,
                     packed_mode=False, tile_plan=None):
    """csrc/flash_attention_bwd_sm90.cu on padded bf16 [B, L, N, 128]:
    (dq, dk, dv) from qs (folded), k, v, o, lse and do, kv_len or None.
    q_splits: blocks a kv tile along q (`bwd_sm90_q_splits` of the card's
    SMs by default; > 1 sums dk and dv through fp32 accumulators). Under a
    causal, segment or packed mask each kv tile walks its tile list in one
    block (q_splits 1): the backward list of `tile_plan` (segments and
    packed codes), else one `tile_lists` launch first."""
    _check_bwd_inputs(qs, k, v, do, lse, kv_len, o)
    b, lq, n, d = qs.shape
    lk = k.shape[1]
    if lse.data_ptr() % 16:
        raise ValueError("the sm90 backward copies lse rows in bulk: a "
                         "16-byte aligned lse")
    seg = _check_masks(qs, lk, q_offsets, q_segments, kv_segments,
                       packed_mode, causal)
    mode = "causal" if causal else seg
    if mode is not None:
        return _launch_bwd_sm90_masked(
            qs, k, v, o, lse, do, kv_len, softmax_scale, q_splits, mode,
            causal=causal, q_offset=q_offset, q_offsets=q_offsets,
            q_segments=q_segments, kv_segments=kv_segments,
            packed_mode=packed_mode, tile_plan=tile_plan)
    if q_splits is None:
        q_splits = bwd_sm90_q_splits(
            b * n, lq, lk,
            torch.cuda.get_device_properties(qs.device).multi_processor_count)
    if not 1 <= q_splits <= lq // BWD_BLOCK_Q:
        raise ValueError(f"q_splits {q_splits} outside "
                         f"[1, {lq // BWD_BLOCK_Q}]")
    dq = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    delta = torch.empty((b, n, lq), dtype=torch.float32, device=qs.device)
    kv_floats = b * n * -(-lk // BWD_BLOCK_K) * BWD_BLOCK_K * d
    acc = torch.empty(b * n * lq * d + (2 * kv_floats if q_splits > 1 else 0),
                      dtype=torch.float32, device=qs.device)
    strides = _bwd_sm90_strides(qs, k, v, o, do, dq, dk, dv)
    fn = _fn("flash_attention_bwd_sm90", "univid_flash_bwd_sm90",
             [_P] * 12 + [_I] * 5 + [ctypes.c_float, _P, _P])
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), _ptr(kv_len), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), acc.data_ptr(),
             b, n, lq, lk, q_splits, softmax_scale, ctypes.addressof(strides),
             _stream(qs))
    build.check(err, "univid_flash_bwd_sm90")
    _count("flash_attention_bwd_bf16_sm90")
    return dq, dk, dv


def _bwd_sm90_strides(qs, k, v, o, do, dq, dk, dv):
    st = (tma_strides(qs) + tma_strides(k) + tma_strides(v) + tma_strides(o)
          + tma_strides(do) + list(dq.stride()[:3]) + list(dk.stride()[:3])
          + list(dv.stride()[:3]))
    return (ctypes.c_longlong * 24)(*st)  # host array, read at launch


def _launch_bwd_sm90_masked(qs, k, v, o, lse, do, kv_len, softmax_scale,
                            q_splits, mode, tile_plan=None, **masks):
    """The masked modes of `_launch_bwd_sm90` (mode "causal", "segments"
    or "packed"): the tile list (the plan's, or one `tile_lists` launch),
    then delta, the main kernel's walk of it and the accumulators to
    bf16."""
    b, lq, n, d = qs.shape
    lk = k.shape[1]
    if q_splits not in (None, 1):
        raise ValueError("the masked modes walk each kv tile's list in one "
                         "block: q_splits 1")
    codes = (masks["q_segments"], masks["kv_segments"])
    if mode != "causal" and any(t.data_ptr() % 16 for t in codes):
        raise ValueError("the sm90 backward copies codes in bulk: 16-byte "
                         "aligned q_segments and kv_segments")
    if tile_plan is not None:
        lists, count = _plan_lists(tile_plan, "bwd", (
            b, -(-lk // BWD_BLOCK_K), lq // BWD_BLOCK_Q))
    else:
        _, (lists, count) = tile_lists(b, lq, lk, qs.device, kv_len=kv_len,
                                       fwd=False, **masks)
    dq = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    delta = torch.empty((b, n, lq), dtype=torch.float32, device=qs.device)
    acc = torch.empty(b * n * lq * d, dtype=torch.float32, device=qs.device)
    strides = _bwd_sm90_strides(qs, k, v, o, do, dq, dk, dv)
    fn = _fn("flash_attention_bwd_sm90", "univid_flash_bwd_sm90_masked",
             [_P] * 17 + [_I] * 6 + [ctypes.c_float, _P, _P])
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), _ptr(kv_len),
             _ptr(masks["q_offsets"]), _ptr(codes[0]), _ptr(codes[1]),
             lists.data_ptr(), count.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), acc.data_ptr(),
             _BWD_MASK_MODE[mode], int(masks["q_offset"]), b, n, lq, lk,
             softmax_scale, ctypes.addressof(strides), _stream(qs))
    build.check(err, "univid_flash_bwd_sm90_masked")
    _count("flash_attention_bwd_bf16_sm90", mode)
    return dq, dk, dv


def _check_bwd_inputs(qs, k, v, do, lse, kv_len, *more,
                      dtype=torch.bfloat16):
    _check_cuda_inputs(qs, k, v, kv_len, dtype, (D128,), do, *more)
    b, lq, n, _ = qs.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, n, lq)
            or not lse.is_contiguous() or lse.device != qs.device):
        raise ValueError("lse must be contiguous fp32 [B, N, Lq] on the "
                         "kernel's device")


def _bwd_mask_args(qs, k, causal, q_offset, q_offsets, q_segments,
                   kv_segments, packed_mode):
    """The mask operands of the two backward kernels and the counter's
    mode."""
    seg = _check_masks(qs, k.shape[1], q_offsets, q_segments, kv_segments,
                       packed_mode, causal)
    args = (_ptr(q_offsets), _ptr(q_segments), _ptr(kv_segments))
    flags = (int(causal), int(q_offset), _SEG_MODE[seg])
    return args, flags, "causal" if causal else seg


def _bwd_dq_cuda(qs, k, v, o, lse, do, kv_len, softmax_scale, *,
                 causal=False, q_offset=0, q_offsets=None, q_segments=None,
                 kv_segments=None, packed_mode=False):
    """dq (q's dtype) and delta = rowsum(do * o), fp32 [B, N, Lq]."""
    _check_bwd_inputs(qs, k, v, do, lse, kv_len, o)
    args, flags, mode = _bwd_mask_args(qs, k, causal, q_offset, q_offsets,
                                       q_segments, kv_segments, packed_mode)
    b, lq, n, d = qs.shape
    dq = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    delta = torch.empty((b, n, lq), dtype=torch.float32, device=qs.device)
    fn = _fn("flash_attention_bwd", "univid_flash_bwd_dq_bf16",
             [_P] * 12 + [_I] * 8 + [ctypes.c_float, _P, _P])
    strides = _strides(qs, k, v, o, do, dq)
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), _ptr(kv_len), *args,
             dq.data_ptr(), delta.data_ptr(), b, n, lq, k.shape[1], d, *flags,
             softmax_scale, ctypes.addressof(strides), _stream(qs))
    build.check(err, "univid_flash_bwd_dq_bf16")
    _count("flash_attention_bwd_dq_bf16", mode)
    return dq, delta


def _bwd_dkv_cuda(qs, k, v, do, lse, delta, kv_len, *, causal=False,
                  q_offset=0, q_offsets=None, q_segments=None,
                  kv_segments=None, packed_mode=False):
    """dk, dv (k's and v's dtype) from the dq kernel's delta."""
    _check_bwd_inputs(qs, k, v, do, lse, kv_len)
    if delta.shape != lse.shape or not delta.is_contiguous():
        raise ValueError("delta must be contiguous fp32 [B, N, Lq]")
    args, flags, mode = _bwd_mask_args(qs, k, causal, q_offset, q_offsets,
                                       q_segments, kv_segments, packed_mode)
    b, lq, n, d = qs.shape
    lk = k.shape[1]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    fn = _fn("flash_attention_bwd", "univid_flash_bwd_dkv_bf16",
             [_P] * 12 + [_I] * 8 + [_P, _P])
    strides = _strides(qs, k, v, do, dk, dv)
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _ptr(kv_len), *args,
             dk.data_ptr(), dv.data_ptr(), b, n, lq, lk, d, *flags,
             ctypes.addressof(strides), _stream(qs))
    build.check(err, "univid_flash_bwd_dkv_bf16")
    _count("flash_attention_bwd_dkv_bf16", mode)
    return dk, dv


def _bwd_f32_sm90(qs, k, v, o, lse, do, kv_len, softmax_scale,
                  tile_plan=None, **masks):
    """dq, dk, dv of the fp32 d=128 forward on csrc/flash_attention_f32_sm90.cu:
    the split pre-passes of qs, k, v and do, the dq kernel (dq and delta =
    rowsum(do * o), fp32 [B, N, Lq]), then the dk/dv kernel (six launches),
    under the forward's mask (causal from the offsets; segments and packed
    over both tile lists, the plan's or one `tile_lists` launch's).
    Deterministic: no output element is summed by atomics. k and v have as
    many heads as qs."""
    _check_bwd_inputs(qs, k, v, do, lse, kv_len, o, dtype=torch.float32)
    _check_aligned(qs, k, v, o, do)
    if lse.data_ptr() % 16:
        raise ValueError("the fp32 backward copies lse rows in bulk: a "
                         "16-byte aligned lse")
    mode, fwd, bwd = _f32_masks(qs, k, kv_len, None, tile_plan, bwd=True,
                                **masks)
    parts = [split_bf16x3(t) for t in (qs, k, v, do)]
    dq, delta = _bwd_dq_f32_sm90_parts(*parts, o, do, lse, kv_len,
                                       softmax_scale, mode, fwd, **masks)
    return (dq,) + _bwd_dkv_f32_sm90_parts(*parts, lse, delta, kv_len, mode,
                                           bwd, **masks)


def _bwd_dq_f32_sm90_parts(qp, kp, vp, dop, o, do, lse, kv_len,
                           softmax_scale, mode=None, lists=None, **masks):
    """The dq kernel alone on split parts of qs, k, v, do (fp32 o and do
    for delta), under `mode` with the forward list `lists`: (dq, delta
    fp32 [B, N, Lq])."""
    _, b, lq, n, d = qp.shape
    lk = kp.shape[2]
    dq = torch.empty((b, lq, n, d), dtype=torch.float32, device=o.device)
    delta = torch.empty((b, n, lq), dtype=torch.float32, device=o.device)
    fn = _fn("flash_attention_f32_sm90", "univid_flash_bwd_dq_f32_sm90",
             [_P] * 8 + _F32_MASK_ARGTYPES + [_P, _P] + [_I] * 4
             + [ctypes.c_float, _P, _P])
    st = (ctypes.c_longlong * 9)(*o.stride()[:3], *do.stride()[:3],
                                 *dq.stride()[:3])
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
             o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(kv_len),
             *_f32_mask_args(mode, lists, **masks), dq.data_ptr(),
             delta.data_ptr(), b, n, lq, lk, softmax_scale,
             ctypes.addressof(st), _stream(o))
    build.check(err, "univid_flash_bwd_dq_f32_sm90")
    _count("flash_attention_bwd_dq_f32_sm90", mode)
    return dq, delta


def _bwd_dkv_f32_sm90_parts(qp, kp, vp, dop, lse, delta, kv_len, mode=None,
                            lists=None, **masks):
    """The dk/dv kernel alone on split parts of qs, k, v, do and the dq
    kernel's delta, under `mode` with the backward list `lists`: (dk,
    dv)."""
    _, b, lq, n, d = qp.shape
    lk = kp.shape[2]
    dk = torch.empty((b, lk, n, d), dtype=torch.float32, device=lse.device)
    dv = torch.empty((b, lk, n, d), dtype=torch.float32, device=lse.device)
    fn = _fn("flash_attention_f32_sm90", "univid_flash_bwd_dkv_f32_sm90",
             [_P] * 7 + _F32_MASK_ARGTYPES + [_P, _P] + [_I] * 4 + [_P, _P])
    st = (ctypes.c_longlong * 6)(*dk.stride()[:3], *dv.stride()[:3])
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _ptr(kv_len),
             *_f32_mask_args(mode, lists, **masks), dk.data_ptr(),
             dv.data_ptr(), b, n, lq, lk, ctypes.addressof(st), _stream(lse))
    build.check(err, "univid_flash_bwd_dkv_f32_sm90")
    _count("flash_attention_bwd_dkv_f32_sm90", mode)
    return dk, dv


def _bwd_dq_f32(qs, k, v, o, lse, do, kv_len, softmax_scale):
    """csrc/flash_attention_bwd_f32.cu's dq kernel, the CUDA-core
    baseline of `_bwd_f32_sm90` (reached only by chip_smoke.py and the card
    tests): dq and delta = rowsum(do * o), fp32 [B, N, Lq], of the fp32
    d=128 forward."""
    _check_bwd_inputs(qs, k, v, do, lse, kv_len, o, dtype=torch.float32)
    _check_aligned(qs, k, v, o, do)
    b, lq, n, d = qs.shape
    dq = torch.empty(qs.shape, dtype=torch.float32, device=qs.device)
    delta = torch.empty((b, n, lq), dtype=torch.float32, device=qs.device)
    fn = _fn("flash_attention_bwd_f32", "univid_flash_bwd_dq_f32",
             [_P] * 9 + [_I] * 4 + [ctypes.c_float, _P, _P])
    strides = _strides(qs, k, v, o, do, dq)
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), _ptr(kv_len), dq.data_ptr(),
             delta.data_ptr(), b, n, lq, k.shape[1], softmax_scale,
             ctypes.addressof(strides), _stream(qs))
    build.check(err, "univid_flash_bwd_dq_f32")
    _count("flash_attention_bwd_dq_f32")
    return dq, delta


def _bwd_dkv_f32(qs, k, v, do, lse, delta, kv_len):
    """The CUDA-core baseline's dk/dv kernel: dk, dv of the fp32 d=128
    forward, from the dq kernel's delta."""
    _check_bwd_inputs(qs, k, v, do, lse, kv_len, dtype=torch.float32)
    _check_aligned(qs, k, v, do)
    if delta.shape != lse.shape or not delta.is_contiguous():
        raise ValueError("delta must be contiguous fp32 [B, N, Lq]")
    b, lq, n, d = qs.shape
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    fn = _fn("flash_attention_bwd_f32", "univid_flash_bwd_dkv_f32",
             [_P] * 9 + [_I] * 4 + [_P, _P])
    strides = _strides(qs, k, v, do, dk, dv)
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _ptr(kv_len), dk.data_ptr(),
             dv.data_ptr(), b, n, lq, k.shape[1],
             ctypes.addressof(strides), _stream(qs))
    build.check(err, "univid_flash_bwd_dkv_f32")
    _count("flash_attention_bwd_dkv_f32")
    return dk, dv
