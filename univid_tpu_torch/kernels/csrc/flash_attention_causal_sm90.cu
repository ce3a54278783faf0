// The causal bf16 attention forward for Hopper (sm_90a): wgmma, TMA and warp
// specialisation, grouped query heads packed over one k / v stream, and a
// split-kv pass with an lse merge when the grid cannot fill the card.
//
// Replaces the Pallas TPU kernel _flash_kernel of
// univid_tpu/kernels/flash_attention.py (:44) in its causal mode: a static
// q_offset and the device q_offsets int32 [B] (:161-188), kv_len, the
// running max, k and v with N / group heads, with and without its
// save_residuals form (:339-352, the exp2-domain lse m + log2 l, +1e30 where
// l = 0, fp32 [B, N, Lq]). BAGEL's KV-cache prefill: the question over the
// cache, the 2,048-token text bucket, the batched captioning shape.
// Query i of batch b is row i + q_offset + q_offsets[b] and sees key c iff
// c <= row and c < kv_len[b]. flash_attention.cu's mma.sync kernel, which
// served this mode before, stays built as its same-call baseline.
//
// The arithmetic is flash_attention_sm90.cu's running-max mode: scores in
// the exp2 domain (softmax_scale * log2 e folded into q), p rounded to bf16
// against the block's own running max before p v, l and the accumulator in
// fp32; a row with no live key ends exactly 0 with lse +1e30.
//
// What bounds it: the question prefill (q [1, 64, 28, 128] over ~19,200
// live rows of a 20,480-row cache, 4 kv heads) does 17.6 GFLOP on 39 MB of
// live k and v: 17.8 us on the tensor cores against 11.7 us of bytes, so
// the tensor cores bound it, but only if the work reaches every SM. The
// square 2,048 prefill and the B = 16 captioning shape are flop-bound and
// give hundreds of blocks. The mma.sync kernel ran one block per (head,
// 64 rows): 28 blocks on 132 SMs at the prefill, each query head reading
// its kv head's whole cache again (~275 MB for 39 MB).
//
// Design:
//   * the tile walk needs no pre-pass: a query row's live keys are the
//     prefix [0, min(row + 1, kv_len[b])). Producer and consumers compute
//     the walk from q_offsets[b] and kv_len[b], read on the device; tiles
//     past the block's last row or kv_len are never loaded; only the tiles
//     a consumer's diagonal or kv_len crosses compare and select;
//   * packing (position-major): the group * Lq rows of one kv head's query
//     heads are slots of 64 rows, slot s = (Lq position chunk t, head j) with
//     s = t * group + j, head = kv head * group + j, rows 64 t .. 64 t + 63.
//     A block takes two consecutive slots, one per consumer warpgroup, and
//     loads each k / v tile once for both: at Lq = 64 the 7 heads of a group
//     are 4 blocks, so the cache of each kv head is read 4 times (7 before);
//     at Lq >= 128 the pairs hold two heads at one position chunk or, across
//     a chunk boundary, positions 64 apart. A row's causal limit depends on
//     its position only, so the mask is the unpacked one;
//   * split-kv: S (from B, N, group, Lq, Lk only, never from the device's
//     offsets: `causal_splits` in flash_attention.py) is 1 unless the
//     blocks fall short of half the 132 SMs; then S = min(132 / blocks,
//     kv tiles, 16). A block's live tiles [0, ceil(end / 128)), end the
//     live keys of its last row, are cut into S ranges of ceil(n / S) whole
//     128-key tiles (keys past `end` are dead for every row of the block).
//     Each split writes fp32 partials for its rows: the unnormalised
//     accumulator [S, B, N, Lq, 128] and (m, l) [S, B, N, Lq]; a split with
//     no tile loads nothing and writes m = -1e30, l = 0. A second launch
//     merges them (causal_merge_kernel, one warp a row): m* = max m_s over
//     the splits with l_s > 0, l = sum l_s 2^(m_s - m*), o = sum acc_s
//     2^(m_s - m*) / l, rounded to bf16 once, lse = m* + log2 l (+1e30 and
//     o = 0 where no split saw a key). A second launch rather than a last
//     block behind an atomic counter: it keeps the main kernel free of
//     cross-block state and costs one launch a call, the same order as the
//     merge's own bytes (7.3 MB of partials at the prefill, read from L2).
//     At the question prefill 16 blocks take S = 8 (128 blocks, ~19 tiles
//     each); the B = 16 and square shapes (256 and 448 blocks) do not split;
//   * launch order: the split varies fastest, then (b, kv head), then the
//     pair of slots from the last (the longest prefix) to the first, so the
//     square prefill starts its longest q tiles first;
//   * the block is flash_attention_sm90.cu's: three warpgroups, warpgroup 0
//     the producer (one thread issues every TMA load, setmaxnreg.dec 24; it
//     computes the walk after the register cut, no producer register lives
//     across it), warpgroups 1 and 2 consumers of one 64-row slot each
//     (setmaxnreg.inc 240); q [64, 128] per consumer (two [64, 64] boxes
//     each, since the two slots may be different heads), rings of two k and
//     two v [128, 128] stages (160 KB); s = q k^T on wgmma m64n128k16 from
//     shared memory, p to wgmma A fragments in registers, o += p v on
//     m64n64k16 with v MN-major; s_{j+1} and p_j v_j issued back to back,
//     the last tile's p v peeled off the loop (no branch between a product's
//     issue and its wait: C7513 / C7514).

#include <cuda.h>

#include <climits>

#include "bf16_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int C_ROWS = 64;        // q rows of a slot (one consumer warpgroup)
constexpr int C_BN = 128;         // kv rows per tile
constexpr int C_STAGES = 2;       // k and v ring depth
constexpr int C_THREADS = 384;    // producer + two consumer warpgroups
constexpr int MAX_SPLITS = 16;
constexpr int MERGE_WARPS = 8;    // rows a merge block
constexpr uint32_t Q_BOX_BYTES = C_ROWS * SUB * 2;     // one [64, 64] box
constexpr uint32_t KV_TILE_BYTES = 2 * C_BN * SUB * 2; // a [128, 128] tile

struct Smem {
  __nv_bfloat16 q[2][2][C_ROWS * SUB];   // per consumer: two [64, 64] boxes
  __nv_bfloat16 k[C_STAGES][2][C_BN * SUB];
  __nv_bfloat16 v[C_STAGES][2][C_BN * SUB];
  uint64_t q_full;
  uint64_t k_full[C_STAGES], k_empty[C_STAGES];
  uint64_t v_full[C_STAGES], v_empty[C_STAGES];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;   // + alignment slack

// the first position of slot s (position-major packing)
__device__ __forceinline__ int slot_pos(int s, int group) { return s / group * C_ROWS; }

// A block's place and walk: (b, kv head, pair of slots, split), and the kv
// tiles [t0, t1) of its split. The same function of the block index, the
// shapes, q_offsets[b] and kv_len[b] for producer and consumers.
struct Walk {
  int b, hk, pair, split, n_cons;
  int off;      // q_offset + q_offsets[b]: the absolute row of position 0
  int kv_end;   // kv_len[b] clamped to [0, lk]
  int t0, t1;
};

__device__ __forceinline__ Walk causal_walk(const int* kv_len, const int* q_offsets,
                                            int q_offset, int splits, int group, int n_kv,
                                            int B, int lq, int lk) {
  Walk w;
  const int n_slots = group * (lq / C_ROWS);
  const int n_pairs = (n_slots + 1) / 2;
  int lin = (int)blockIdx.x;
  w.split = lin % splits;
  lin /= splits;
  const int bkv = lin % (B * n_kv);
  w.pair = n_pairs - 1 - lin / (B * n_kv);   // the longest prefixes first
  w.b = bkv / n_kv;
  w.hk = bkv % n_kv;
  w.n_cons = min(2, n_slots - 2 * w.pair);
  w.kv_end = lk;
  if (kv_len != nullptr) w.kv_end = min(max(__ldg(kv_len + w.b), 0), lk);
  w.off = q_offset + (q_offsets != nullptr ? __ldg(q_offsets + w.b) : 0);
  // every live key of the block's rows lies below the last slot's last row + 1
  const int last = slot_pos(2 * w.pair + w.n_cons - 1, group) + C_ROWS;
  const int end = min(max(w.off + last, 0), w.kv_end);
  const int nt = (end + C_BN - 1) / C_BN;
  const int per = (nt + splits - 1) / splits;
  w.t0 = min(w.split * per, nt);
  w.t1 = min(w.t0 + per, nt);
  return w;
}

__global__ void __launch_bounds__(C_THREADS, 1)
flash_fwd_causal_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
                             const int* __restrict__ q_offsets, float* __restrict__ lse,
                             float* __restrict__ part_o, float2* __restrict__ part_ml,
                             int q_offset, int splits, int group, int n_heads, int B, int lq,
                             int lk, long long o_sb, long long o_sl, long long o_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles need 1024-byte aligned shared addresses
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  const int tid = threadIdx.x, wg = tid / 128;
  const int n_kv = n_heads / group;

  if (tid == 0) {
    // consumers with a slot
    const int n_cons =
        causal_walk(kv_len, q_offsets, q_offset, splits, group, n_kv, B, lq, lk).n_cons;
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < C_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 4 * n_cons);
      mbar_init(&sm.v_empty[s], 4 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      const Walk w = causal_walk(kv_len, q_offsets, q_offset, splits, group, n_kv, B, lq, lk);
      if (w.t1 > w.t0) {
        mbar_expect_tx(&sm.q_full, w.n_cons * 2 * Q_BOX_BYTES);
        for (int c = 0; c < w.n_cons; ++c) {
          const int s = 2 * w.pair + c;
          const int h = w.hk * group + s % group, pos = slot_pos(s, group);
          tma_load(sm.q[c][0], &q_map, &sm.q_full, 0, h, pos, w.b);
          tma_load(sm.q[c][1], &q_map, &sm.q_full, SUB, h, pos, w.b);
        }
        for (int j = w.t0; j < w.t1; ++j) {
          const int it = j - w.t0, st = it % C_STAGES;
          const uint32_t parity = ((it / C_STAGES) & 1) ^ 1;
          mbar_wait(&sm.k_empty[st], parity);
          mbar_expect_tx(&sm.k_full[st], KV_TILE_BYTES);
          tma_load(sm.k[st][0], &k_map, &sm.k_full[st], 0, w.hk, j * C_BN, w.b);
          tma_load(sm.k[st][1], &k_map, &sm.k_full[st], SUB, w.hk, j * C_BN, w.b);
          mbar_wait(&sm.v_empty[st], parity);
          mbar_expect_tx(&sm.v_full[st], KV_TILE_BYTES);
          tma_load(sm.v[st][0], &v_map, &sm.v_full[st], 0, w.hk, j * C_BN, w.b);
          tma_load(sm.v[st][1], &v_map, &sm.v_full[st], SUB, w.hk, j * C_BN, w.b);
        }
      }
    }
  } else {
    // ---- consumers: one 64-row slot each --------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const Walk w = causal_walk(kv_len, q_offsets, q_offset, splits, group, n_kv, B, lq, lk);
    const int c = wg - 1;
    if (c >= w.n_cons) return;   // an odd slot count: no second slot
    const int wq = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int slot = 2 * w.pair + c;
    const int h = w.hk * group + slot % group;
    const int pos = slot_pos(slot, group) + 16 * wq;   // this warp's first position
    const int row = w.off + pos;                        // ... and its absolute row
    const int c_first = w.off + slot_pos(slot, group);  // the slot's first row
    const int n_tiles = w.t1 - w.t0;
    // tile j needs the compare and select unless each of its keys lies at or
    // before the slot's first row and below kv_end
    auto needs_mask = [&](int j) {
      return (j + 1) * C_BN - 1 > c_first || (j + 1) * C_BN > w.kv_end;
    };

    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
    // per-thread partial row sums (rows g and g + 8), reduced over the quad
    // at the end; m_r: the running max
    float l_r[2] = {0.f, 0.f};
    float m_r[2] = {NEG_INF, NEG_INF};

    if (n_tiles > 0) {
      mbar_wait(&sm.q_full, 0);
      int kit = 0, vit = 0;
      float s[16][4];
      uint32_t pa[8][4];   // p as wgmma A fragments (bf16 pairs)
      // issue s = q k^T for the next k tile (async); returns its stage
      auto qk_issue = [&]() {
        const int st = kit % C_STAGES;
        mbar_wait(&sm.k_full[st], (kit / C_STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < SUB / 16; ++kk)
            wgmma_ss_m64n128(&s[0][0], sw128_desc(&sm.q[c][hf][16 * kk], 1, 64),
                             sw128_desc(&sm.k[st][hf][16 * kk], 1, 64), hf | kk);
        wgmma_commit();
        ++kit;
        return st;
      };
      // once the product landed for tile j: mask (-1e30) the keys past the
      // query's row or at or past kv_end (only in tiles that need it), then
      // release the k stage
      auto qk_done = [&](int st, int j) {
        fence_regs<64>(&s[0][0]);
        if (needs_mask(j)) {
          const int kv0 = j * C_BN;
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kv0 + n * 8 + 2 * t + (e & 1);
              if (col >= w.kv_end || col > row + g + 8 * (e >> 1)) s[n][e] = NEG_INF;
            }
        }
        if (lane == 0) mbar_arrive(&sm.k_empty[st]);
      };
      // p rounded to bf16 (v's dtype): keys 16 kk .. 16 kk + 15 are the
      // n-tiles 2 kk and 2 kk + 1 of s
      auto to_pa = [&]() {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
      };

      // tile t0's scores and p, then per tile j: issue s_{j+1} = q k_{j+1}^T
      // and acc += p_j v_j back to back; the softmax of s_{j+1} runs while
      // p_j v_j is on the tensor cores; the running max's rescale of acc
      // waits for that product. GUARD: a row whose running max is still
      // -1e30 (a tile wholly past its diagonal) takes the reference 0
      {
        const int st = qk_issue();
        wgmma_wait<0>();
        qk_done(st, w.t0);
        softmax_tile<RUNNING, false, true, 16, 16>(s, m_r, l_r, acc, 0.f);
        to_pa();
      }
      // acc += p_j v_j for the tile in stage `vst` (async; committed)
      auto pv_issue = [&](int vst) {
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            // v rows 16 kk .. 16 kk + 15 of sub-tile hf (d 64 hf .. 64 hf + 63)
            wgmma_rs_m64n64_tb(&acc[8 * hf][0], pa[kk],
                               sw128_desc(&sm.v[vst][hf][16 * kk * SUB], 64, 64));
        wgmma_commit();
      };
      auto pv_done = [&](int vst) {
        fence_regs<64>(&acc[0][0]);
        fence_regs<32>(&pa[0][0]);
        if (lane == 0) mbar_arrive(&sm.v_empty[vst]);
        ++vit;
      };
      for (int i = 0; i + 1 < n_tiles; ++i) {
        const int vst = vit % C_STAGES;
        mbar_wait(&sm.v_full[vst], (vit / C_STAGES) & 1);
        const int kst = qk_issue();   // s_{j+1}
        pv_issue(vst);                // acc += p_j v_j
        const float m_old[2] = {m_r[0], m_r[1]};
        wgmma_wait<1>();   // s_{j+1} landed; p_j v_j may still run
        qk_done(kst, w.t0 + i + 1);
        softmax_tile<RUNNING, false, true, 16, 0>(s, m_r, l_r, nullptr, 0.f);
        wgmma_wait<0>();
        pv_done(vst);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float corr = fast_exp2(m_old[r] - m_r[r]);
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            acc[n][2 * r] *= corr;
            acc[n][2 * r + 1] *= corr;
          }
        }
        to_pa();
      }
      {   // the last tile's p v
        const int vst = vit % C_STAGES;
        mbar_wait(&sm.v_full[vst], (vit / C_STAGES) & 1);
        pv_issue(vst);
        wgmma_wait<0>();
        pv_done(vst);
      }
    }
    if (splits == 1) {
      store_rows<RUNNING, 16>(
          acc, l_r, m_r, 0.f,
          lse != nullptr ? lse + ((long long)w.b * n_heads + h) * lq + pos + g : nullptr,
          o + w.b * o_sb + h * o_sh + (long long)pos * o_sl, o_sl, g, t);
    } else {
      // the split's partials of rows g and g + 8: acc, and (m, l)
      const long long prow = (((long long)w.split * B + w.b) * n_heads + h) * lq + pos + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(0xffffffff, l, 1);
        l += __shfl_xor_sync(0xffffffff, l, 2);
        if (t == 0) part_ml[prow + 8 * r] = make_float2(m_r[r], l);
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = n * 8 + 2 * t;
        *reinterpret_cast<float2*>(part_o + prow * 128 + col) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(part_o + (prow + 8) * 128 + col) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

// The split-kv merge: one warp a row of [B, N, Lq] (lane l: columns 4 l ..
// 4 l + 3); o bf16 with strides, lse fp32 [B, N, Lq] or null.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
causal_merge_kernel(const float* __restrict__ part_o, const float2* __restrict__ part_ml,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int splits,
                    int n_heads, int lq, long long rows, long long o_sb, long long o_sl,
                    long long o_sh) {
  const long long r = (long long)blockIdx.x * MERGE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int i = (int)(r % lq);
  const long long bh = r / lq;
  const int h = (int)(bh % n_heads), b = (int)(bh / n_heads);
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[s * rows + r];
    if (ml.y > 0.f) m = fmaxf(m, ml.x);
  }
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[s * rows + r];
    if (ml.y > 0.f) {
      const float wgt = exp2f(ml.x - m);
      l += ml.y * wgt;
      const float4 p = reinterpret_cast<const float4*>(part_o + (s * rows + r) * 128)[lane];
      a.x += p.x * wgt;
      a.y += p.y * wgt;
      a.z += p.z * wgt;
      a.w += p.w * wgt;
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
      o + b * o_sb + (long long)i * o_sl + h * o_sh + 4 * lane);
  op[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
  op[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  if (lse != nullptr && lane == 0) lse[r] = l > 0.f ? m + log2f(l) : -NEG_INF;
}

}  // namespace

extern "C" {

// q, o: bf16 [B, lq, N, 128]; k, v: bf16 [B, lk, N / group, 128]; element
// strides st = (q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h),
// unit stride along D; q, k and v 16-byte aligned with strides that are
// multiples of 8 elements (TMA's rules; the Python wrapper checks them); o
// 8-byte aligned rows. lq and lk are multiples of 64. Query i of batch b is
// row i + q_offset + q_offsets[b] (q_offset >= 0; q_offsets int32 [B] on the
// device, or null) and sees the keys at or before it below kv_len[b]
// (kv_len int32 [B] on the device, or null). lse: null, or fp32 [B, N, lq]
// contiguous. splits: 1, or up to 16 with part_o fp32 [splits, B, N, lq,
// 128] and part_ml fp32 [splits, B, N, lq, 2], contiguous (the merge then
// runs as a second launch).
int univid_flash_fwd_causal_sm90(const void* q, const void* k, const void* v, void* o,
                                 const void* kv_len, const void* q_offsets, void* lse,
                                 void* part_o, void* part_ml, int q_offset, int splits,
                                 int group, int B, int N, int lq, int lk, const long long* st,
                                 void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || B <= 0 || group < 1 ||
      N % group != 0 || q_offset < 0 || splits < 1 || splits > MAX_SPLITS ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, lq, N, st, C_ROWS) ||
      !make_map(&km, k, B, lk, N / group, st + 3, C_BN) ||
      !make_map(&vm, v, B, lk, N / group, st + 6, C_BN))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_causal_sm90_kernel;
  // once a process (the prefill calls it once a layer, and the host's time
  // a call is of the order of the kernel's at the question's shape):
  // setmaxnreg moves registers between the block's warpgroups, so the
  // block must start with at least what the producer (24) and the
  // consumers (240) end with, or the consumers' setmaxnreg.inc would wait
  // forever; and the dynamic shared memory above 48 KB
  static cudaError_t ready = cudaErrorNotReady;
  if (ready == cudaErrorNotReady) {
    cudaFuncAttributes attr;
    ready = cudaFuncGetAttributes(&attr, kern);
    if (ready == cudaSuccess && attr.numRegs * C_THREADS < 128 * 24 + 256 * 240)
      ready = cudaErrorInvalidConfiguration;
    if (ready == cudaSuccess)
      ready = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  }
  if (ready != cudaSuccess) return (int)ready;
  cudaError_t err;
  const int n_slots = group * (lq / C_ROWS);
  const long long blocks = (long long)(n_slots + 1) / 2 * splits * B * (N / group);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<(unsigned)blocks, C_THREADS, SMEM_BYTES, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_offsets), static_cast<float*>(lse), static_cast<float*>(part_o),
      static_cast<float2*>(part_ml), q_offset, splits, group, N, B, lq, lk, st[9], st[10],
      st[11]);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long rows = (long long)B * N * lq;
  causal_merge_kernel<<<(unsigned)((rows + MERGE_WARPS - 1) / MERGE_WARPS), MERGE_WARPS * 32, 0,
                        s>>>(static_cast<const float*>(part_o),
                             static_cast<const float2*>(part_ml),
                             static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), splits, N,
                             lq, rows, st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // extern "C"
