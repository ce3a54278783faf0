// Flash attention forward for Hopper, bf16 in and out, rebuilt on wgmma,
// TMA and warp specialisation (sm_90a). The unmasked modes of the bf16
// forward and its segment and packed modes (with a block-sparse tile skip);
// flash_attention_causal_sm90.cu has the causal one (this file's block
// and tile walk, with the query heads of one kv head packed over one k / v
// stream and a split-kv pass).
//
// Replaces two Pallas TPU kernels of univid_tpu/kernels/flash_attention.py
// in these modes (all at D = 128, k and v with N / group heads):
//   * _flash_kernel (:44): the bounded softmax p = exp2(s - C) with no max
//     and no rescale (DiT self-attention after the q / k pre-pass, kernel A
//     of qk_prepass.cu), or the running max
//     (BAGEL's ViT append over the KV cache, 28 query heads over 4 kv
//     heads); kv_len masking; its save_residuals mode (:343-352), the
//     training forward, with the exp2-domain lse C + log2 l or m + log2 l,
//     +1e30 where l = 0, as fp32 [B, N, Lq];
//   * _cross_kernel (:355): Lk <= 512 keys with the bound, or the one-shot
//     softmax (the exact row max over every live key first, then p against
//     it), with and without kv_len;
//   * the softmax_bf16 chain of both (:259-265, :402-403) in the bounded,
//     running and one-shot modes: softmax_tile of bf16_tiles.cuh, with its
//     rounding points;
//   * _flash_kernel's segment and packed modes (:191-210), with and without
//     save_residuals, running max only: BAGEL packed training. int32 codes
//     q_seg [B, Lq] and kv_seg [B, Lk]; a query sees a key of its own id
//     (segments) or as packed_allowed says (pack_mask_codes codes). The
//     TPU kernel's `need` predicate (:309-336), which skips dead kv blocks
//     and the compare of wholly live ones, becomes a pre-pass
//     (mask_tiles_kernel, one launch a call): for each (b, 128-row q tile)
//     the ascending list of the 128-key kv tiles with at least one allowed
//     pair, each with a flag set when every pair of the tile is allowed.
//     The list does not depend on the head. Producer and consumers walk it:
//     dead tiles are never loaded, fully live ones skip the compare and
//     select, the rest apply the predicate on the wgmma fragment. A q tile
//     with an empty list issues no load and writes zero rows (lse +1e30).
//     These modes meet wholly masked tiles before a row's first live key,
//     so a row whose running max is still -1e30 takes the reference 0
//     (softmax_tile's GUARD): rows with no live key at all end with l = 0.
// The arithmetic is flash_attention.cu's: scores in the exp2 domain with
// softmax_scale * log2 e folded into q (or its rope tables), p rounded to
// bf16 before p v, l and the accumulator in fp32, the output divided by l
// and exactly 0 where l = 0 (kv_len = 0 rows). kv tiles at or past kv_len
// are never loaded; only the tail tile compares and selects.
//
// What bounds it: at the DiT's self-attention shapes (t2v-1.3B [2, 32768,
// 12, 128], ti2v-5B [2, 28672, 24, 128]) the work is 4 L^2 d flops a head
// against 4 L d bytes, ~16k flops a byte: the tensor cores bound it (19.44
// ms at the 5B shape at 989 TFLOP/s). The Ampere form (mma.sync m16n8k16
// over 64 x 64 tiles with cp.async and two block barriers a tile) reached
// 28% of that peak: mma.sync does not reach Hopper's tensor-core rate, and
// each warp re-read whole k and v tiles from shared memory for 16 q rows.
// The packed mode at BAGEL's training pack ([1, 4096, 28, 128], 19.4% of
// the (row, key) pairs live, in 24.6% of the 128 x 128 tiles) computes the
// live tiles whole; the mma.sync kernel computed every tile below kv_len.
//
// Design:
//   * one block of three warpgroups per (b*h, 128-row q tile): warpgroup 0
//     is the producer, one elected thread issues every TMA load and the
//     warpgroup gives its registers away (setmaxnreg.dec 24); warpgroups 1
//     and 2 are consumers of 64 q rows each (setmaxnreg.inc 240);
//   * shared memory: the q tile [128, 128] bf16 once, and rings of two
//     stages of k and of v tiles [128, 128], each tile as two [128, 64]
//     sub-tiles of 128-byte rows with the 128-byte swizzle that TMA writes
//     and wgmma reads (160 KB); full and empty mbarriers per stage, the
//     full ones completed by TMA's transaction count, the empty ones by one
//     arrival per consumer warp;
//   * s = q k^T: wgmma m64n128k16, q and k from shared memory (K-major),
//     8 k-steps into 64 fp32 registers a thread. A warp's m64nN fragment is
//     the m16n8 fragment of mma.sync repeated over N / 8, so the softmax,
//     the epilogue and their rounding points are bf16_tiles.cuh's
//     (softmax_tile, store_rows) unchanged;
//   * o += p v: p converts in registers to wgmma's A fragments (no trip
//     through shared memory); v [kv, d] row-major is B in MN-major form
//     (the transpose flag), two m64n64k16 products per 16 keys;
//   * overlap: the producer keeps up to two k and two v tiles in flight
//     ahead of the consumers; two consumer warpgroups share the SM, so one's
//     softmax overlaps the other's products; and within a warpgroup
//     s_{j+1} = q k_{j+1}^T and acc += p_j v_j are issued back to back, so
//     the softmax of s_{j+1} runs while p_j v_j is on the tensor cores (the
//     running max's rescale of acc waits for that product). The last tile's
//     p v is peeled off the loop: with a branch around the s_{j+1} product
//     ptxas serialised every wgmma (C7514);
//   * the masked modes' codes: each query row's code is read once from
//     global memory; each kv tile's 128 codes arrive with its k tile, a
//     bulk copy into the k stage counted in the stage's transaction bytes,
//     and the consumers read them before they release the stage;
//   * ragged edges: Lq and Lk are multiples of 64. TMA zero-fills rows past
//     L; the tail kv tile is masked at kv_len (<= Lk); a consumer whose 64
//     rows all lie past Lq (the last q tile when Lq % 128 = 64) leaves at
//     once and the empty barriers count only the live consumers' warps;
//   * the tensor maps (4-D: D, heads, rows, batch, from the tensors'
//     strides, so strided views of a KV cache or a fused projection are
//     read in place) are built on the host with cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPointByVersion (no -lcuda), and
//     passed as __grid_constant__ kernel parameters.

#include <cooperative_groups.h>
#include <cuda.h>

#include <climits>

#include "bf16_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int H_BM = 128;        // q rows per block (two consumers of 64)
constexpr int H_BN = 128;        // kv rows per tile
constexpr int H_STAGES = 2;      // k and v ring depth
constexpr int H_THREADS = 384;   // producer + two consumer warpgroups
constexpr uint32_t SUB_BYTES = H_BN * SUB * 2;   // one [128, 64] sub-tile
constexpr uint32_t TILE_BYTES = 2 * SUB_BYTES;   // a [128, 128] tile

struct Smem {
  __nv_bfloat16 q[2][H_BM * SUB];
  __nv_bfloat16 k[H_STAGES][2][H_BN * SUB];
  __nv_bfloat16 v[H_STAGES][2][H_BN * SUB];
  int kc[H_STAGES][H_BN];   // the k stage's kv codes (masked modes)
  uint64_t q_full;
  uint64_t k_full[H_STAGES], k_empty[H_STAGES];
  uint64_t v_full[H_STAGES], v_empty[H_STAGES];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;   // + alignment slack

// The pre-pass of the masked modes: for each (b, 128-row q tile) the kv
// tiles that hold at least one allowed pair of a query row below lq and a
// key below kv_len, ascending, as (tile << 1) | full, full when every pair
// of the tile's 128 keys is allowed (so a tile that reaches past kv_len or
// Lk is never full); -1 past the count. list [B, q_tiles, kt_max], count
// [B, q_tiles]. A cluster of MT_CLUSTER blocks takes one q tile: warp w of
// block r checks kv tiles r + MT_CLUSTER (w + MT_WARPS i) and writes each
// flag into the leader block's shared memory; after the cluster barrier the
// leader compacts them in order. A pair needs equal ids (segments) or equal
// documents (packed, code >> 16): a kv tile whose id range, or whose set of
// ids mod 32, does not meet the q tile's is dead without a pair check;
// otherwise lane l checks key columns l, l + 32, l + 64, l + 96 against
// every row, and stops once the tile is known live and not full.
constexpr int MT_CLUSTER = 8;   // blocks a q tile
constexpr int MT_WARPS = 8;     // warps a block

template <int SEG>
__device__ __forceinline__ int range_key(int code) {
  return SEG == PACKED ? (code >> 16) : code;
}

// the min, max and (ids mod 32) bit set of one warp's keys
__device__ __forceinline__ void warp_keys(int& lo, int& hi, unsigned& bits) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffff, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffff, hi, off));
    bits |= __shfl_xor_sync(0xffffffff, bits, off);
  }
}

template <int SEG>
__global__ void __cluster_dims__(MT_CLUSTER, 1, 1) __launch_bounds__(MT_WARPS * 32)
mask_tiles_kernel(const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                  const int* __restrict__ kv_len, int* __restrict__ list,
                  int* __restrict__ count, int lq, int lk, int kt_max) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int flags[];   // kt_max: 0 dead, 1 live, 3 full (the leader's)
  __shared__ int qcs[H_BM];
  __shared__ int q_lo, q_hi, n_live;
  __shared__ unsigned q_bits;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, qt = blockIdx.x / MT_CLUSTER, q_tiles = gridDim.x / MT_CLUSTER;
  const int q0 = qt * H_BM, n_rows = min(H_BM, lq - q0);
  const int* kvb = kv_seg + (long long)b * lk;
  if (tid < n_rows) qcs[tid] = q_seg[(long long)b * lq + q0 + tid];
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_kt = (kv_end + H_BN - 1) / H_BN;
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    unsigned bits = 0;
    for (int r = lane; r < n_rows; r += 32) {
      const int key = range_key<SEG>(qcs[r]);
      lo = min(lo, key);
      hi = max(hi, key);
      bits |= 1u << (key & 31);
    }
    warp_keys(lo, hi, bits);
    if (lane == 0) {
      q_lo = lo;
      q_hi = hi;
      q_bits = bits;
    }
  }
  __syncthreads();
  int* lead = cluster.map_shared_rank(flags, 0);
  for (int j = rank + MT_CLUSTER * warp; j < n_kt; j += MT_CLUSTER * MT_WARPS) {
    int kc[4], col[4];
    bool live[4];
    int lo = INT_MAX, hi = INT_MIN;
    unsigned bits = 0;
    bool all = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      col[i] = j * H_BN + lane + 32 * i;
      live[i] = col[i] < kv_end;
      kc[i] = live[i] ? kvb[col[i]] : 0;
      if (live[i]) {
        const int key = range_key<SEG>(kc[i]);
        lo = min(lo, key);
        hi = max(hi, key);
        bits |= 1u << (key & 31);
      }
      all = all && live[i];
    }
    warp_keys(lo, hi, bits);
    int flag = 0;
    if (lo <= q_hi && hi >= q_lo && (bits & q_bits) != 0) {   // ids may meet
      bool any = false;
      for (int r0 = 0; r0 < n_rows; r0 += 32) {
        for (int r = r0; r < min(r0 + 32, n_rows); ++r) {
          const int qc = qcs[r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool ok = live[i] && seg_allowed<SEG>(qc, kc[i], q0 + r, col[i]);
            any = any || ok;
            all = all && ok;
          }
        }
        if (__any_sync(0xffffffff, any) && !__all_sync(0xffffffff, all)) break;
      }
      any = __any_sync(0xffffffff, any);
      all = __all_sync(0xffffffff, all);
      flag = any ? (all ? 3 : 1) : 0;
    }
    if (lane == 0) lead[j] = flag;
  }
  cluster.sync();   // every flag is in the leader's shared memory
  if (rank != 0) return;
  int* out = list + ((long long)b * q_tiles + qt) * kt_max;
  if (warp == 0) {
    int n = 0;
    for (int j0 = 0; j0 < n_kt; j0 += 32) {
      const int j = j0 + lane;
      const int f = j < n_kt ? flags[j] : 0;
      const unsigned ballot = __ballot_sync(0xffffffff, f != 0);
      if (f != 0) out[n + __popc(ballot & ((1u << lane) - 1))] = (j << 1) | (f >> 1);
      n += __popc(ballot);
    }
    if (lane == 0) {
      n_live = n;
      count[(long long)b * q_tiles + qt] = n;
    }
  }
  __syncthreads();
  for (int i = n_live + tid; i < kt_max; i += blockDim.x) out[i] = -1;
}

template <int MODE, bool SBF16, int SEG>
__global__ void __launch_bounds__(H_THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
                      const float* __restrict__ bound, float* __restrict__ lse,
                      const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                      const int* __restrict__ tile_list, const int* __restrict__ tile_count,
                      int kt_max, int group, int n_heads, int lq, int lk, long long o_sb,
                      long long o_sl, long long o_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles need 1024-byte aligned shared addresses
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int hk = h / group;   // the kv head this query head reads
  const int q0 = blockIdx.x * H_BM;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  // masked modes: the pre-pass's list of this q tile's live kv tiles
  const long long tile_at = (long long)b * gridDim.x + blockIdx.x;
  const int* list = SEG != NO_SEG ? tile_list + tile_at * kt_max : nullptr;
  const int n_tiles = SEG != NO_SEG ? tile_count[tile_at] : (kv_end + H_BN - 1) / H_BN;
  // the kv tile of step i, and whether it needs the compare and select
  auto tile_of = [&](int i) { return SEG != NO_SEG ? (__ldg(list + i) >> 1) : i; };
  auto needs_mask = [&](int i) {
    return SEG != NO_SEG ? (__ldg(list + i) & 1) == 0 : (i + 1) * H_BN > kv_end;
  };
  const int n_cons = (q0 + 64 < lq) ? 2 : 1;   // consumers with rows below lq

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < H_STAGES; ++s) {
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
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(&sm.q_full, 2 * H_BM * SUB * 2);
      tma_load(sm.q[0], &q_map, &sm.q_full, 0, h, q0, b);
      tma_load(sm.q[1], &q_map, &sm.q_full, SUB, h, q0, b);
      int kit = 0, vit = 0;
      // wait until the consumers freed the stage, then load the tile into
      // it (a k tile of the masked modes with its kv codes)
      auto load = [&](const CUtensorMap* map, __nv_bfloat16 (*ring)[2][H_BN * SUB],
                      uint64_t* full, uint64_t* empty, int& it, int j, bool codes) {
        const int st = it % H_STAGES;
        mbar_wait(&empty[st], ((it / H_STAGES) & 1) ^ 1);
        const uint32_t code_bytes = codes ? 4 * min(H_BN, lk - j * H_BN) : 0;
        mbar_expect_tx(&full[st], TILE_BYTES + code_bytes);
        tma_load(ring[st][0], map, &full[st], 0, hk, j * H_BN, b);
        tma_load(ring[st][1], map, &full[st], SUB, hk, j * H_BN, b);
        if (codes)
          bulk_load(sm.kc[st], kv_seg + (long long)b * lk + j * H_BN, code_bytes, &full[st]);
        ++it;
      };
      if (MODE == ONESHOT)   // the row-max pass reads every k tile first
        for (int j = 0; j < n_tiles; ++j)
          load(&k_map, sm.k, sm.k_full, sm.k_empty, kit, j, false);
      for (int i = 0; i < n_tiles; ++i) {
        const int j = tile_of(i);
        load(&k_map, sm.k, sm.k_full, sm.k_empty, kit, j, SEG != NO_SEG);
        load(&v_map, sm.v, sm.v_full, sm.v_empty, vit, j, false);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    if (c >= n_cons) return;   // every row of this warpgroup lies past lq
    const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * c + 16 * w;   // this warp's first q row
    const float c_bound = (MODE == BOUNDED) ? *bound : 0.f;   // folded bound

    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
    // per-thread partial row sums (rows g and g + 8), reduced over the quad
    // at the end; m_r: running max (RUNNING) or row max (ONESHOT)
    float l_r[2] = {0.f, 0.f};
    float m_r[2] = {NEG_INF, NEG_INF};
    // masked modes: the codes of this thread's rows g and g + 8
    int qc[2] = {0, 0};
    if (SEG != NO_SEG) {
      qc[0] = __ldg(q_seg + (long long)b * lq + row0 + g);
      qc[1] = __ldg(q_seg + (long long)b * lq + row0 + g + 8);
    }

    if (n_tiles > 0) {
      mbar_wait(&sm.q_full, 0);
      int kit = 0, vit = 0;
      float s[16][4];
      uint32_t pa[8][4];   // p as wgmma A fragments (bf16 pairs)
      // issue s = q k^T for the next k tile (async); returns its stage
      auto qk_issue = [&]() {
        const int st = kit % H_STAGES;
        mbar_wait(&sm.k_full[st], (kit / H_STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < SUB / 16; ++kk)
            wgmma_ss_m64n128(&s[0][0],
                             sw128_desc(&sm.q[hf][64 * c * SUB + 16 * kk], 1, 64),
                             sw128_desc(&sm.k[st][hf][16 * kk], 1, 64), hf | kk);
        wgmma_commit();
        ++kit;
        return st;
      };
      // once the product landed for step i: mask (-1e30) the keys at or
      // past kv_end and, in the masked modes, the pairs their predicate
      // refuses (only in tiles that need it), then release the k stage
      auto qk_done = [&](int st, int i) {
        fence_regs<64>(&s[0][0]);
        if (needs_mask(i)) {
          const int kv0 = tile_of(i) * H_BN;
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = n * 8 + 2 * t + (e & 1);
              bool dead = kv0 + c >= kv_end;
              if (SEG != NO_SEG)
                dead = dead || !seg_allowed<SEG>(qc[e >> 1], sm.kc[st][c],
                                                 row0 + g + 8 * (e >> 1), kv0 + c);
              if (dead) s[n][e] = NEG_INF;
            }
        }
        if (SEG != NO_SEG) __syncwarp();   // every lane has read the stage's codes
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

      if (MODE == ONESHOT) {
        // pass 1: the exact row max over every live key (_cross_kernel's
        // one-shot softmax); pass 2 takes it as each row's reference point
        for (int j = 0; j < n_tiles; ++j) {
          const int st = qk_issue();
          wgmma_wait<0>();
          qk_done(st, j);
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            m_r[0] = fmaxf(m_r[0], fmaxf(s[n][0], s[n][1]));
            m_r[1] = fmaxf(m_r[1], fmaxf(s[n][2], s[n][3]));
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffff, m_r[i], 1));
          m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffff, m_r[i], 2));
        }
      }

      // tile 0's scores and p, then per tile j: issue s_{j+1} = q k_{j+1}^T
      // and acc += p_j v_j back to back; the softmax of s_{j+1} runs while
      // p_j v_j is on the tensor cores. The running max's rescale of acc
      // waits for that product (softmax_tile with no acc, then acc *= corr)
      {
        const int st = qk_issue();
        wgmma_wait<0>();
        qk_done(st, 0);
        softmax_tile<MODE, SBF16, SEG != NO_SEG, 16, 16>(s, m_r, l_r, acc, c_bound);
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
      for (int j = 0; j + 1 < n_tiles; ++j) {
        const int vst = vit % H_STAGES;
        mbar_wait(&sm.v_full[vst], (vit / H_STAGES) & 1);
        const int kst = qk_issue();   // s_{j+1}
        pv_issue(vst);                // acc += p_j v_j
        const float m_old[2] = {m_r[0], m_r[1]};
        wgmma_wait<1>();   // s_{j+1} landed; p_j v_j may still run
        qk_done(kst, j + 1);
        softmax_tile<MODE, SBF16, SEG != NO_SEG, 16, 0>(s, m_r, l_r, nullptr, c_bound);
        wgmma_wait<0>();
        pv_done(vst);
        if (MODE == RUNNING) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float corr = fast_exp2(m_old[i] - m_r[i]);
#pragma unroll
            for (int n = 0; n < 16; ++n) {
              acc[n][2 * i] *= corr;
              acc[n][2 * i + 1] *= corr;
            }
          }
        }
        to_pa();
      }
      {   // the last tile's p v
        const int vst = vit % H_STAGES;
        mbar_wait(&sm.v_full[vst], (vit / H_STAGES) & 1);
        pv_issue(vst);
        wgmma_wait<0>();
        pv_done(vst);
      }
    }
    // rows past lq never reach here (lq is a multiple of 64)
    store_rows<MODE, 16>(acc, l_r, m_r, c_bound,
                         lse != nullptr ? lse + (long long)bh * lq + row0 + g : nullptr,
                         o + b * o_sb + h * o_sh + (long long)row0 * o_sl, o_sl, g, t);
  }
}

// the masked modes' operands: codes [B, lq] / [B, lk] and the pre-pass's
// list; all null for the unmasked modes
struct MaskArgs {
  const int* q_seg = nullptr;
  const int* kv_seg = nullptr;
  const int* list = nullptr;
  const int* count = nullptr;
  int kt_max = 0;
};

template <int MODE, bool SBF16, int SEG = NO_SEG>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
                   const void* kv_len, const void* bound, void* lse, int group, int B, int N,
                   int lq, int lk, int q_tiles, const long long* st, cudaStream_t stream,
                   const MaskArgs& ma = MaskArgs()) {
  auto kern = flash_fwd_sm90_kernel<MODE, SBF16, SEG>;
  // setmaxnreg moves registers between the block's warpgroups: the block
  // must start with at least what the producer (24) and the consumers
  // (240) end with, or the consumers' setmaxnreg.inc would wait forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * H_THREADS < 128 * 24 + 256 * 240) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(q_tiles, B * N);
  kern<<<grid, H_THREADS, SMEM_BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len),
      static_cast<const float*>(bound), static_cast<float*>(lse), ma.q_seg, ma.kv_seg, ma.list,
      ma.count, ma.kt_max, group, N, lq, lk, st[9], st[10], st[11]);
  return cudaGetLastError();
}

bool make_maps(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm, const void* q, const void* k,
               const void* v, int B, int N, int group, int lq, int lk, const long long* st) {
  return make_map(qm, q, B, lq, N, st, H_BM) &&
         make_map(km, k, B, lk, N / group, st + 3, H_BN) &&
         make_map(vm, v, B, lk, N / group, st + 6, H_BN);
}

}  // namespace

extern "C" {

// q, o: bf16 [B, lq, N, 128]; k, v: bf16 [B, lk, N / group, 128]; element
// strides st = (q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h),
// unit stride along D; q, k and v 16-byte aligned with strides that are
// multiples of 8 elements (TMA's rules; the Python wrapper checks them).
// lq and lk are multiples of 64; q_tiles = ceil(lq / 128) blocks along q.
// kv_len: int32 [B] on the device, or null. mode: 0 bounded (reference point
// *bound, an fp32 scalar on the device), 1 running max, 2 one-shot max.
// lse: null, or fp32 [B, N, lq] contiguous (not with softmax_bf16).
// softmax_bf16: the bf16 softmax chain (softmax_tile in bf16_tiles.cuh).
int univid_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                          const void* kv_len, const void* bound, void* lse, int mode,
                          int softmax_bf16, int group, int B, int N, int lq, int lk, int q_tiles,
                          const long long* st, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || group < 1 || N % group != 0 ||
      q_tiles != (lq + H_BM - 1) / H_BM || (mode == BOUNDED && bound == nullptr) ||
      (softmax_bf16 && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_maps(&qm, &km, &vm, q, k, v, B, N, group, lq, lk, st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UNIVID_SM90_LAUNCH(M, SB) \
  launch<M, SB>(qm, km, vm, o, kv_len, bound, lse, group, B, N, lq, lk, q_tiles, st, s)
  if (softmax_bf16) {
    switch (mode) {
      case BOUNDED: return (int)UNIVID_SM90_LAUNCH(BOUNDED, true);
      case RUNNING: return (int)UNIVID_SM90_LAUNCH(RUNNING, true);
      case ONESHOT: return (int)UNIVID_SM90_LAUNCH(ONESHOT, true);
    }
  } else {
    switch (mode) {
      case BOUNDED: return (int)UNIVID_SM90_LAUNCH(BOUNDED, false);
      case RUNNING: return (int)UNIVID_SM90_LAUNCH(RUNNING, false);
      case ONESHOT: return (int)UNIVID_SM90_LAUNCH(ONESHOT, false);
    }
  }
#undef UNIVID_SM90_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The masked modes' pre-pass: q_seg int32 [B, lq], kv_seg int32 [B, lk]
// (contiguous), kv_len int32 [B] or null; seg_mode 1 segments, 2 packed.
// Writes list int32 [B, q_tiles, kt_max] (kt_max = ceil(lk / 128)) and
// count int32 [B, q_tiles] (mask_tiles_kernel: one launch, clusters of
// MT_CLUSTER blocks a q tile).
int univid_mask_tile_list(const void* q_seg, const void* kv_seg, const void* kv_len,
                          void* list, void* count, int seg_mode, int B, int lq, int lk,
                          int q_tiles, int kt_max, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 ||
      q_tiles != (lq + H_BM - 1) / H_BM || kt_max != (lk + H_BN - 1) / H_BN)
    return (int)cudaErrorInvalidValue;
  dim3 grid(q_tiles * MT_CLUSTER, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kern)(const int*, const int*, const int*, int*, int*, int, int, int);
  if (seg_mode == SEGMENTS)
    kern = mask_tiles_kernel<SEGMENTS>;
  else if (seg_mode == PACKED)
    kern = mask_tiles_kernel<PACKED>;
  else
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kt_max * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  kern<<<grid, MT_WARPS * 32, smem, s>>>(
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int*>(kv_len), static_cast<int*>(list), static_cast<int*>(count), lq, lk,
      kt_max);
  return (int)cudaGetLastError();
}

// The segment (seg_mode 1) and packed (2) modes: running max, kv_len, the
// lse (or null), q_seg / kv_seg as for the pre-pass and its list and
// count; the other operands as for univid_flash_fwd_sm90. q_seg and kv_seg
// 16-byte aligned (each kv tile's codes arrive by a bulk copy).
int univid_flash_fwd_sm90_masked(const void* q, const void* k, const void* v, void* o,
                                 const void* kv_len, void* lse, const void* q_seg,
                                 const void* kv_seg, const void* list, const void* count,
                                 int seg_mode, int group, int B, int N, int lq, int lk,
                                 int q_tiles, int kt_max, const long long* st, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || group < 1 || N % group != 0 ||
      q_tiles != (lq + H_BM - 1) / H_BM || kt_max != (lk + H_BN - 1) / H_BN ||
      q_seg == nullptr || kv_seg == nullptr || list == nullptr || count == nullptr ||
      reinterpret_cast<uintptr_t>(kv_seg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_maps(&qm, &km, &vm, q, k, v, B, N, group, lq, lk, st))
    return (int)cudaErrorInvalidValue;
  MaskArgs ma;
  ma.q_seg = static_cast<const int*>(q_seg);
  ma.kv_seg = static_cast<const int*>(kv_seg);
  ma.list = static_cast<const int*>(list);
  ma.count = static_cast<const int*>(count);
  ma.kt_max = kt_max;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg_mode == SEGMENTS)
    return (int)launch<RUNNING, false, SEGMENTS>(qm, km, vm, o, kv_len, nullptr, lse, group, B,
                                                 N, lq, lk, q_tiles, st, s, ma);
  if (seg_mode == PACKED)
    return (int)launch<RUNNING, false, PACKED>(qm, km, vm, o, kv_len, nullptr, lse, group, B, N,
                                               lq, lk, q_tiles, st, s, ma);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
