// Flash attention backward for Hopper (sm_90a), bf16 in and out, as one
// pass on wgmma, TMA and warp specialisation: dq, dk and dv from one
// recompute of p, 5 products a tile pair.
//
// Replaces, for every bf16 backward at D = 128 with as many kv heads as
// query heads (the unmasked modes: bounded or running-max forward, with or
// without kv_len, the self shape and the cross shape of 512 keys; and the
// masked ones: causal with a static q_offset and device q_offsets [B],
// segment ids, BAGEL's packed codes, each with or without kv_len), the
// Pallas TPU kernels of univid_tpu/kernels/flash_attention.py:
//   * _flash_bwd_fused_kernel (:1057), the one-pass form: dq in fp32
//     scratch, dk and dv resident, 5 products, masks by _mask_scores
//     (:794);
//   * _flash_bwd_dq_kernel (:831) and _flash_bwd_dkv_kernel (:940), the
//     two-pass form. flash_attention_bwd.cu (mma.sync) is that form; it
//     stays built as this kernel's same-call baseline, and no route
//     reaches it.
// Arithmetic and rounding points as the JAX kernel's (qs = q * scale *
// log2 e rounded to bf16 by the caller; delta = rowsum(dO * O) in fp32):
//     s = qs k^T,  p = exp2(s - lse),  dS = p * (dO v^T - delta),
//     dV += bf16(p)^T dO,  dK += bf16(dS)^T qs,  dQ += bf16(dS) k,
// fp32 sums, each output rounded once: dq = bf16(acc * softmax_scale),
// dk = bf16(acc * ln 2), dv = bf16(acc). Keys at or past kv_len, and the
// pairs a mask refuses, score -1e30 (p = 0); a kv_len = 0 row gives
// exactly zero dq, dk and dv, and so do rows and keys that no pair
// reaches (pad ids: q -1 with lse +1e30, kv -2).
//
// NOT DETERMINISTIC: each dq element is the sum of one fp32 partial per kv
// tile, added into an fp32 accumulator by atomic reductions from blocks
// that run in no fixed order, so the summation order (and the last bits of
// dq) changes from run to run; at the cross shape's q split the same holds
// for dk and dv. The mma.sync pair was deterministic. Hold the kernel to
// tolerances, never to bitwise equality.
//
// What bounds it: at the DiT self-attention shape ([1, 32768, 12, 128],
// kv 32760) the work is 5 products of 2 Lq Lk d flops a head, 16.67 ms at
// 989 TFLOP/s against ~0.1 ms of bytes: the tensor cores. Under a mask the
// work is 5 products over the live pairs only (BAGEL's training pack: 19.4%
// of the pairs, in 24.6% of the 64 x 128 tile pairs). The mma.sync pair it
// replaces reached 22% of the unmasked bound (76.45 ms) and visited every
// masked tile: (1) mma.sync m16n8k16 never reaches Hopper's tensor-core
// rate (the forward in that form reached 28%); (2) 64 x 64 tiles, 4 warps a
// block, fed by cp.async behind block barriers; (3) 7 products, s and dp
// recomputed by both kernels; (4) 255 registers with spills. What this
// design does:
//   (1) every product is a wgmma: S^T = k qs^T and dP^T = v dO^T with both
//       operands K-major in shared memory (m64n64k16); dV += P^T dO and
//       dK += dS^T qs with A from registers and B (dO, qs) MN-major through
//       the transpose flag; dQ = dS k with A (dS^T in shared memory) and B
//       (k) both MN-major;
//   (2) one block of three warpgroups per (b*h, 128-row kv tile [, q
//       split]): warpgroup 0 is the producer (setmaxnreg.dec 24), one
//       thread issues the k and v tiles once and then streams the 64-row qs
//       and dO tiles by TMA and the lse and delta rows by bulk copy through
//       a ring of B_STAGES stages (full barriers by transaction count, empty
//       barriers by one arrival a consumer warp); warpgroups 1 and 2
//       (setmaxnreg.inc 240) own 64 kv rows each and keep their fp32 dk and
//       dv (64 x 128 each) in registers for the whole q walk;
//   (3) 5 products: p and dS are built once a tile pair, on the fragments;
//       dS^T goes to shared memory as bf16 (double-buffered, one named
//       barrier of the two consumers a tile), and each consumer computes
//       one half of d of dQ_partial = dS k (64 x 64 fp32, 32 registers), so
//       no thread holds a 64 x 128 partial on top of dk and dv;
//   (4) the partial is added into an fp32 accumulator in the wgmma
//       fragment order by red.global.add.v4.f32 (four floats an
//       instruction, a warp's 32 reductions on 512 contiguous bytes), and a
//       post-pass rounds it to bf16 dq in [B, L, N, D]. Traffic: each dq
//       element gets Lk / 128 adds (~51 GB through L2 a self-shape call).
//       Each block starts its q walk at (its kv tile) mod (its q tiles), so
//       the blocks of one head add into different rows at a time;
//   (5) the masked modes walk a kv-major tile list (bwd_tiles_kernel, one
//       pre-pass launch a call): for each (b, kv tile) the ascending 64-row
//       q tiles with at least one allowed pair, each flagged full when
//       every pair is allowed. The transpose of the forward's list
//       (mask_tiles_kernel of flash_attention_sm90.cu) at this kernel's
//       tiles, with the same predicate (seg_allowed of bf16_tiles.cuh; the
//       causal rule from q_offset + q_offsets[b]). The producer streams
//       only the listed q tiles, each with its 64 q codes by a bulk copy in
//       the stage's transaction count; the block's 128 kv codes arrive once
//       with k and v. Full tiles take the unmasked path; the others set
//       s = -1e30 on every refused pair before the exp2. The rotation of
//       (4) applies inside the list. A kv tile with an empty list loads
//       nothing and stores zero dk and dv. The grid runs heads fastest
//       and the kv tiles in index order.
// Three launches a call (four with a mask): [bwd_tiles_kernel,]
// bwd_pre_kernel (delta = rowsum(dO * O), fp32 [B, N, Lq], and the zeroed
// accumulators), the main kernel, and bwd_post_kernel (the
// accumulators to bf16). kv tiles at or past kv_len issue no loads and
// write zero dk and dv. Where B * N * kv tiles is small in an unmasked call
// (the cross shape: 4 kv tiles x 12 heads = 48 blocks for 132 SMs) the q
// range splits over q_splits blocks a kv tile (a launch parameter); dk and
// dv are then summed like dq (fp32 accumulators, the post-pass converts).
// Ragged lengths: Lq and Lk are multiples of 64; TMA zero-fills rows past
// L, the tail kv tile (kv_len or a 64-row last tile) masks its rows at or
// past the end, and a consumer whose 64 rows lie past Lk stores nothing.

#include <cuda.h>

#include <climits>

#include "bf16_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int B_BN = 128;       // kv rows a block (two consumers of 64)
constexpr int B_BM = 64;        // q rows a tile
constexpr int B_STAGES = 2;     // qs / dO ring depth
constexpr int B_THREADS = 384;  // producer + two consumer warpgroups
constexpr float LN2 = 0.6931471805599453f;
constexpr uint32_t Q_SUB_BYTES = B_BM * SUB * 2;    // one [64, 64] bf16 sub-tile
constexpr uint32_t KV_SUB_BYTES = B_BN * SUB * 2;   // one [128, 64] bf16 sub-tile
constexpr int DQ_TILE = B_BM * 128;    // floats of a q tile's dq accumulator
constexpr int KV_TILE = B_BN * 128;    // floats of a kv tile's dk (or dv) accumulator
constexpr int PRE_WARPS = 8;           // rows a pre-pass block
constexpr int POST_THREADS = 256;
constexpr int TL_WARPS = 32;           // warps a tile-list block
// the mask modes: NO_SEG, SEGMENTS and PACKED of bf16_tiles.cuh, and
constexpr int CAUSAL = 3;

struct Smem {
  __nv_bfloat16 k[2][B_BN * SUB];                // resident k tile (d halves)
  __nv_bfloat16 v[2][B_BN * SUB];                // resident v tile
  __nv_bfloat16 q[B_STAGES][2][B_BM * SUB];      // qs tiles
  __nv_bfloat16 dout[B_STAGES][2][B_BM * SUB];   // dO tiles
  __nv_bfloat16 ds[2][B_BN * SUB];               // dS^T [128 kv, 64 q], two buffers
  float lse[B_STAGES][B_BM];
  float delta[B_STAGES][B_BM];
  int kc[B_BN];                 // the kv tile's codes (segment / packed)
  int qc[B_STAGES][B_BM];       // the q tiles' codes
  int ent[B_STAGES];            // the stage's list entry (masked modes)
  uint64_t kv_full;
  uint64_t full[B_STAGES], empty[B_STAGES];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;   // + alignment slack

__device__ __forceinline__ void red_add_v4(float* dst, const float* x) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(x[0]),
               "f"(x[1]), "f"(x[2]), "f"(x[3])
               : "memory");
}

// The masked modes' pre-pass: for each (b, 128-row kv tile) the 64-row q
// tiles that hold at least one allowed pair of a query row and a key below
// kv_len, ascending, as (tile << 1) | full, full when every pair of the
// tile's 64 rows and 128 keys is allowed (so a tile that reaches past
// kv_len or Lk is never full); -1 past the count. list [B, kv_tiles, n_q],
// count [B, kv_tiles]. One block a (kv tile, b); warp w checks q tiles w,
// w + TL_WARPS, ... and block-wide flags are compacted in order by warp 0.
// CAUSAL: a key sees rows at or after it (row position i + q_offset +
// q_offsets[b]), decided from the tile corners. SEGMENTS / PACKED: a q tile
// whose id range, or set of ids mod 32, does not meet the kv tile's is dead
// without a pair check; otherwise lane l checks keys l, l + 32, l + 64,
// l + 96 against every row (seg_allowed, the forward's predicate), counting
// the allowed pairs, and stops once the tile is known live and not full.
template <int MASK>
__global__ void __launch_bounds__(TL_WARPS * 32)
bwd_tiles_kernel(const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 const int* __restrict__ kv_len, const int* __restrict__ q_offsets, int q_offset,
                 int* __restrict__ list, int* __restrict__ count, int lq, int lk) {
  extern __shared__ int flags[];   // n_q: 0 dead, 1 live, 3 full
  __shared__ int kcs[B_BN];
  __shared__ int qcs[TL_WARPS][B_BM];   // each warp's q tile codes
  __shared__ int k_lo, k_hi, n_live;
  __shared__ unsigned k_bits;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j = blockIdx.x, b = blockIdx.y, kv_tiles = gridDim.x, n_q = lq / B_BM;
  const int kv0 = j * B_BN;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_keys = max(0, min(B_BN, kv_end - kv0));   // keys of the tile below kv_end
  const bool whole = n_keys == B_BN;
  auto key_of = [](int code) { return MASK == PACKED ? (code >> 16) : code; };
  if (MASK != CAUSAL) {
    if (tid < n_keys) kcs[tid] = kv_seg[(long long)b * lk + kv0 + tid];
    __syncthreads();
    if (warp == 0) {
      int lo = INT_MAX, hi = INT_MIN;
      unsigned bits = 0;
      for (int c = lane; c < n_keys; c += 32) {
        const int key = key_of(kcs[c]);
        lo = min(lo, key);
        hi = max(hi, key);
        bits |= 1u << (key & 31);
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffff, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffff, hi, o));
        bits |= __shfl_xor_sync(0xffffffff, bits, o);
      }
      if (lane == 0) {
        k_lo = lo;
        k_hi = hi;
        k_bits = bits;
      }
    }
    __syncthreads();
  }
  const long long off = MASK == CAUSAL
                            ? (long long)q_offset + (q_offsets != nullptr ? q_offsets[b] : 0)
                            : 0;
  for (int i = warp; i < n_q; i += TL_WARPS) {
    const int q0 = i * B_BM;
    int flag = 0;
    if (MASK == CAUSAL) {
      // rows q0 + off .. q0 + off + 63 see keys at or before their position
      const bool any = n_keys > 0 && kv0 <= q0 + off + B_BM - 1;
      const bool all = whole && kv0 + B_BN - 1 <= q0 + off;
      flag = any ? (all ? 3 : 1) : 0;
    } else if (n_keys > 0) {
      int* qw = qcs[warp];
      qw[lane] = q_seg[(long long)b * lq + q0 + lane];
      qw[lane + 32] = q_seg[(long long)b * lq + q0 + 32 + lane];
      __syncwarp();
      int lo = min(key_of(qw[lane]), key_of(qw[lane + 32]));
      int hi = max(key_of(qw[lane]), key_of(qw[lane + 32]));
      unsigned bits = (1u << (key_of(qw[lane]) & 31)) | (1u << (key_of(qw[lane + 32]) & 31));
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffff, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffff, hi, o));
        bits |= __shfl_xor_sync(0xffffffff, bits, o);
      }
      if (lo <= k_hi && hi >= k_lo && (bits & k_bits) != 0) {   // ids may meet
        int n_ok = 0;   // this lane's allowed pairs in rows 0 .. r
        for (int r = 0; r < B_BM; ++r) {
          const int qc = qw[r];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int c = lane + 32 * m;
            n_ok += c < n_keys && seg_allowed<MASK>(qc, kcs[c], q0 + r, kv0 + c);
          }
          if ((r & 15) == 15 && __any_sync(0xffffffff, n_ok > 0) &&
              !__all_sync(0xffffffff, n_ok == 4 * (r + 1)))
            break;   // live, and not full
        }
        const bool any = __any_sync(0xffffffff, n_ok > 0);
        const bool all = whole && __all_sync(0xffffffff, n_ok == 4 * B_BM);
        flag = any ? (all ? 3 : 1) : 0;
      }
      __syncwarp();   // the warp's next q tile rewrites qw
    }
    if (lane == 0) flags[i] = flag;
  }
  __syncthreads();
  int* out = list + ((long long)b * kv_tiles + j) * n_q;
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < n_q; i0 += 32) {
      const int i = i0 + lane;
      const int f = i < n_q ? flags[i] : 0;
      const unsigned ballot = __ballot_sync(0xffffffff, f != 0);
      if (f != 0) out[n + __popc(ballot & ((1u << lane) - 1))] = (i << 1) | (f >> 1);
      n += __popc(ballot);
    }
    if (lane == 0) {
      n_live = n;
      count[(long long)b * kv_tiles + j] = n;
    }
  }
  __syncthreads();
  for (int i = n_live + tid; i < n_q; i += blockDim.x) out[i] = -1;
}

// The pre-pass: delta[bh, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in
// fp32 (one warp a row), and the fp32 accumulators zeroed (`n_acc4` float4).
__global__ void __launch_bounds__(PRE_WARPS * 32)
bwd_pre_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
               float* __restrict__ delta, float4* __restrict__ acc, long long n_acc4,
               int n_heads, int lq, long long rows, long long o_sb, long long o_sl,
               long long o_sh, long long d_sb, long long d_sl, long long d_sh) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_threads = (long long)gridDim.x * blockDim.x;
  for (long long x = gtid; x < n_acc4; x += n_threads) acc[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long r = (long long)blockIdx.x * PRE_WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int bh = (int)(r / lq), i = (int)(r % lq), b = bh / n_heads, h = bh % n_heads;
  const uint2 ov = *reinterpret_cast<const uint2*>(o + b * o_sb + i * o_sl + h * o_sh + 4 * lane);
  const uint2 dv = *reinterpret_cast<const uint2*>(dout + b * d_sb + i * d_sl + h * d_sh +
                                                   4 * lane);
  const float2 o0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.x));
  const float2 o1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.y));
  const float2 d0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.x));
  const float2 d1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.y));
  float s = d0.x * o0.x;
  s = fmaf(d0.y, o0.y, s);
  s = fmaf(d1.x, o1.x, s);
  s = fmaf(d1.y, o1.y, s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffff, s, off);
  if (lane == 0) delta[r] = s;
}

// The masked modes' operands: codes [B, lq] / [B, lk], the causal
// offsets, the pre-pass's list and count; all null for the unmasked modes.
struct MaskArgs {
  const int* q_seg = nullptr;
  const int* kv_seg = nullptr;
  const int* q_offsets = nullptr;
  int q_offset = 0;
  const int* list = nullptr;
  const int* count = nullptr;
};

// The main kernel. Unmasked (MASK NO_SEG): grid (kv_tiles * q_splits,
// B * N); block (kv tile j, split) walks q tiles [split * per, min(n_q,
// (split + 1) * per)). Masked: grid (B * N, kv_tiles), heads fastest; block
// y takes kv tile y and walks that tile's list.
// q_splits == 1 (SPLIT false): dk, dv stored as bf16; else added into the
// fp32 accumulators dk_acc / dv_acc [B * N, kv_tiles, KV_TILE] (fragment
// order: consumer c, d half hf, n-tile n, thread tw: c * KV_TILE / 2 +
// (hf * 8 + n) * 512 + tw * 4). dq_acc [B * N, Lq / 64, DQ_TILE]: consumer
// (d half) c, n-tile n, thread tw at c * DQ_TILE / 2 + n * 512 + tw * 4.
template <bool SPLIT, int MASK>
__global__ void __launch_bounds__(B_THREADS, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ kv_len,
                      float* __restrict__ dq_acc, float* __restrict__ dk_acc,
                      float* __restrict__ dv_acc, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int n_heads, int lq, int lk, int kv_tiles,
                      int q_splits, long long dk_sb, long long dk_sl, long long dk_sh,
                      long long dv_sb, long long dv_sl, long long dv_sh, const MaskArgs ma) {
  constexpr bool MASKED = MASK != NO_SEG;
  constexpr bool CODES = MASK == SEGMENTS || MASK == PACKED;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles need 1024-byte aligned shared addresses
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = MASKED ? blockIdx.x : blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int n_q = lq / B_BM;
  int j = blockIdx.x % kv_tiles, split = blockIdx.x / kv_tiles;
  if (MASKED) {
    j = blockIdx.y;
    split = 0;
  }
  const int kv0 = j * B_BN;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  // masked: this kv tile's list of live q tiles
  const int* list = MASKED ? ma.list + ((long long)b * kv_tiles + j) * n_q : nullptr;
  const int n_entries = MASKED ? __ldg(ma.count + (long long)b * kv_tiles + j) : n_q;
  const int per = (n_entries + q_splits - 1) / q_splits;
  const int i_begin = split * per;
  const int count = max(0, min(n_entries, i_begin + per) - i_begin);
  const bool live = kv0 < kv_end && count > 0;
  const bool tail = kv0 + B_BN > kv_end;   // rows at or past kv_end are masked
  const int rot = count > 0 ? j % count : 0;
  // step it's entry: the list's (q tile << 1) | full, or the unmasked
  // walk's q tile << 1 (its tail rows are masked by `tail`)
  auto entry = [&](int it) {
    const int e = i_begin + (it + rot) % count;
    return MASKED ? __ldg(list + e) : e << 1;
  };

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load -----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && live) {
      // the kv tile's codes (segment / packed) arrive with k and v
      const uint32_t kc_bytes = CODES ? 4 * min(B_BN, lk - kv0) : 0;
      mbar_expect_tx(&sm.kv_full, 4 * KV_SUB_BYTES + kc_bytes);
      tma_load(sm.k[0], &k_map, &sm.kv_full, 0, h, kv0, b);
      tma_load(sm.k[1], &k_map, &sm.kv_full, SUB, h, kv0, b);
      tma_load(sm.v[0], &v_map, &sm.kv_full, 0, h, kv0, b);
      tma_load(sm.v[1], &v_map, &sm.kv_full, SUB, h, kv0, b);
      if (CODES) bulk_load(sm.kc, ma.kv_seg + (long long)b * lk + kv0, kc_bytes, &sm.kv_full);
      // entry(it), with the rotation kept as a wrapped index (x = (it +
      // rot) % count): the modulo cost the masked modes a spill at 24
      // registers
      for (int it = 0, x = rot; it < count; ++it, x = x + 1 == count ? 0 : x + 1) {
        const int e = MASKED ? __ldg(list + i_begin + x) : (i_begin + x) << 1;
        const int i = e >> 1, st = it % B_STAGES;
        mbar_wait(&sm.empty[st], ((it / B_STAGES) & 1) ^ 1);
        // the consumers read it after the stage's full barrier (the
        // arrive below releases it)
        if (MASKED) sm.ent[st] = e;
        mbar_expect_tx(&sm.full[st], 4 * Q_SUB_BYTES + 2 * B_BM * 4 + (CODES ? B_BM * 4 : 0));
        tma_load(sm.q[st][0], &q_map, &sm.full[st], 0, h, i * B_BM, b);
        tma_load(sm.q[st][1], &q_map, &sm.full[st], SUB, h, i * B_BM, b);
        tma_load(sm.dout[st][0], &do_map, &sm.full[st], 0, h, i * B_BM, b);
        tma_load(sm.dout[st][1], &do_map, &sm.full[st], SUB, h, i * B_BM, b);
        const long long row = (long long)bh * lq + i * B_BM;
        bulk_load(sm.lse[st], lse + row, B_BM * 4, &sm.full[st]);
        bulk_load(sm.delta[st], delta + row, B_BM * 4, &sm.full[st]);
        if (CODES)
          bulk_load(sm.qc[st], ma.q_seg + (long long)b * lq + i * B_BM, B_BM * 4, &sm.full[st]);
      }
    }
  } else {
    // ---- consumers: 64 kv rows each ------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1, tw = tid % 128, w = tw / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = 64 * c + 16 * w + g;   // this thread's kv rows row0, row0 + 8 of the tile
    // masked modes: this thread's kv rows row0 + dr (dr 0 or 8) are at or
    // past kv_end when dr >= kv_rem; CAUSAL: key row0 + dr sees q row qi
    // of tile i when dr - qi <= i * 64 + c_off (its position q_offset +
    // q_offsets[b] + i * 64 + qi, relative to the key)
    const int kv_rem = kv_end - kv0 - row0;
    const int c_off =
        MASK == CAUSAL
            ? ma.q_offset + (ma.q_offsets != nullptr ? __ldg(ma.q_offsets + b) : 0) - kv0 - row0
            : 0;

    float dka[2][8][4], dva[2][8][4];   // [d half][n-tile][fragment]
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[hf][n][e] = dva[hf][n][e] = 0.f;

    if (live) {
      mbar_wait(&sm.kv_full, 0);
      float s[8][4], dp[8][4], dqa[8][4];
      uint32_t pa[4][4], da[4][4];   // bf16 p^T and dS^T as wgmma A fragments
      for (int it = 0; it < count; ++it) {
        const int st = it % B_STAGES, buf = it & 1;
        mbar_wait(&sm.full[st], (it / B_STAGES) & 1);
        const int ent = MASKED ? sm.ent[st] : entry(it), i = ent >> 1;
        // S^T = k_c qs^T, then dP^T = v_c dO^T: 64 kv x 64 q, K = 128 (d)
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < SUB / 16; ++kk)
            wgmma_ss_m64n64<0, 0>(&s[0][0], sw128_desc(&sm.k[hf][64 * c * SUB + 16 * kk], 1, 64),
                                  sw128_desc(&sm.q[st][hf][16 * kk], 1, 64), hf | kk);
        wgmma_commit();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < SUB / 16; ++kk)
            wgmma_ss_m64n64<0, 0>(&dp[0][0], sw128_desc(&sm.v[hf][64 * c * SUB + 16 * kk], 1, 64),
                                  sw128_desc(&sm.dout[st][hf][16 * kk], 1, 64), hf | kk);
        wgmma_commit();
        // p^T = exp2(s^T - lse[q]) while dP^T runs; kv rows at or past
        // kv_end (only in the tail tile) score -1e30, and in the masked
        // modes' tiles not flagged full every pair the mask refuses
        wgmma_wait<1>();
        fence_regs<32>(&s[0][0]);
        if constexpr (MASKED) {
          if ((ent & 1) == 0) {
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qi = 8 * n + 2 * t + (e & 1), dr = 8 * (e >> 1);
                bool dead = dr >= kv_rem;
                if constexpr (MASK == CAUSAL)
                  dead = dead || dr - qi > i * B_BM + c_off;
                else
                  dead = dead || !seg_allowed<MASK>(sm.qc[st][qi], sm.kc[row0 + dr],
                                                    i * B_BM + qi, kv0 + row0 + dr);
                if (dead) s[n][e] = NEG_INF;
              }
          }
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * n + 2 * t]);
            s[n][0] = fast_exp2(s[n][0] - l2.x);
            s[n][1] = fast_exp2(s[n][1] - l2.y);
            s[n][2] = fast_exp2(s[n][2] - l2.x);
            s[n][3] = fast_exp2(s[n][3] - l2.y);
          }
        } else {
          const bool mask0 = tail && kv0 + row0 >= kv_end;
          const bool mask1 = tail && kv0 + row0 + 8 >= kv_end;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * n + 2 * t]);
            s[n][0] = fast_exp2((mask0 ? NEG_INF : s[n][0]) - l2.x);
            s[n][1] = fast_exp2((mask0 ? NEG_INF : s[n][1]) - l2.y);
            s[n][2] = fast_exp2((mask1 ? NEG_INF : s[n][2]) - l2.x);
            s[n][3] = fast_exp2((mask1 ? NEG_INF : s[n][3]) - l2.y);
          }
        }
        // dS^T = p^T * (dP^T - delta[q])
        wgmma_wait<0>();
        fence_regs<32>(&dp[0][0]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 d2 = *reinterpret_cast<const float2*>(&sm.delta[st][8 * n + 2 * t]);
          dp[n][0] = s[n][0] * (dp[n][0] - d2.x);
          dp[n][1] = s[n][1] * (dp[n][1] - d2.y);
          dp[n][2] = s[n][2] * (dp[n][2] - d2.x);
          dp[n][3] = s[n][3] * (dp[n][3] - d2.y);
        }
        // bf16 A fragments: q columns 16 kk .. 16 kk + 15 are n-tiles 2 kk, 2 kk + 1
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          da[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
          da[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
          da[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          da[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        }
        // bf16 dS^T into shared memory for dQ, 128-byte swizzle: row r,
        // 16-byte chunk n at chunk n ^ (r % 8) (r % 8 == g for both rows)
        {
          __nv_bfloat16* dsb = sm.ds[buf];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int n = 2 * kk + half;
              const int off = (((n ^ g) << 3) + 2 * t);
              *reinterpret_cast<uint32_t*>(dsb + row0 * SUB + off) = da[kk][2 * half];
              *reinterpret_cast<uint32_t*>(dsb + (row0 + 8) * SUB + off) = da[kk][2 * half + 1];
            }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        // dV += p^T dO, dK += dS^T qs: A from registers, B MN-major
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_m64n64_tb(&dva[hf][0][0], pa[kk],
                               sw128_desc(&sm.dout[st][hf][16 * kk * SUB], 64, 64));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_m64n64_tb(&dka[hf][0][0], da[kk],
                               sw128_desc(&sm.q[st][hf][16 * kk * SUB], 64, 64));
        wgmma_commit();
        // both consumers' dS^T rows are in shared memory
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        // dQ[:, 64 c .. 64 c + 63] = dS k[:, 64 c ..]: A = dS^T (MN-major),
        // B = k's d half c (MN-major), K = 128 (kv)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < B_BN / 16; ++kk)
          wgmma_ss_m64n64<1, 1>(&dqa[0][0], sw128_desc(&sm.ds[buf][16 * kk * SUB], 64, 64),
                                sw128_desc(&sm.k[c][16 * kk * SUB], 64, 64), kk);
        wgmma_commit();
        wgmma_wait<1>();   // dV and dK landed: the stage is free
        fence_regs<64>(&dva[0][0][0]);
        fence_regs<64>(&dka[0][0][0]);
        fence_regs<16>(&pa[0][0]);
        fence_regs<16>(&da[0][0]);
        if (lane == 0) mbar_arrive(&sm.empty[st]);
        wgmma_wait<0>();
        fence_regs<32>(&dqa[0][0]);
        float* dst = dq_acc + ((long long)bh * n_q + i) * DQ_TILE + c * (DQ_TILE / 2) + tw * 4;
#pragma unroll
        for (int n = 0; n < 8; ++n) red_add_v4(dst + n * 512, dqa[n]);
      }
    }
    // dk, dv of this consumer's 64 rows (none past Lk)
    if (kv0 + 64 * c < lk) {
      if (SPLIT) {
        if (live) {
          const long long base = ((long long)bh * kv_tiles + j) * KV_TILE + c * (KV_TILE / 2) + tw * 4;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              red_add_v4(dk_acc + base + (hf * 8 + n) * 512, dka[hf][n]);
              red_add_v4(dv_acc + base + (hf * 8 + n) * 512, dva[hf][n]);
            }
        }
      } else {
        const long long r = kv0 + row0;
        __nv_bfloat16* kp = dk + b * dk_sb + h * dk_sh + r * dk_sl;
        __nv_bfloat16* vp = dv + b * dv_sb + h * dv_sh + r * dv_sl;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int col = 64 * hf + 8 * n + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(kp + col) =
                __floats2bfloat162_rn(dka[hf][n][0] * LN2, dka[hf][n][1] * LN2);
            *reinterpret_cast<__nv_bfloat162*>(kp + 8 * dk_sl + col) =
                __floats2bfloat162_rn(dka[hf][n][2] * LN2, dka[hf][n][3] * LN2);
            *reinterpret_cast<__nv_bfloat162*>(vp + col) =
                __floats2bfloat162_rn(dva[hf][n][0], dva[hf][n][1]);
            *reinterpret_cast<__nv_bfloat162*>(vp + 8 * dv_sl + col) =
                __floats2bfloat162_rn(dva[hf][n][2], dva[hf][n][3]);
          }
      }
    }
  }
}

// The post-pass: the fp32 accumulators (fragment order) to bf16 outputs in
// [B, L, N, 128]: dq = acc * scale; at a q split also dk = acc * ln 2 and
// dv = acc (rows past lk skipped). One float4 a thread, grid-stride.
__global__ void __launch_bounds__(POST_THREADS)
bwd_post_kernel(const float4* __restrict__ acc_q, const float4* __restrict__ acc_k,
                const float4* __restrict__ acc_v, __nv_bfloat16* __restrict__ dq,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n_heads,
                int lq, int lk, int kv_tiles, float scale, long long n_q4, long long n_kv4,
                long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                long long k_sh, long long v_sb, long long v_sl, long long v_sh) {
  const long long n_threads = (long long)gridDim.x * blockDim.x;
  const int n_q = lq / B_BM;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x; x < n_q4 + 2 * n_kv4;
       x += n_threads) {
    if (x < n_q4) {
      const long long tile = x / (DQ_TILE / 4);
      const int f = (int)(x % (DQ_TILE / 4));
      const int bh = (int)(tile / n_q), i = (int)(tile % n_q);
      const int c = f / 1024, n = (f / 128) % 8, tw = f % 128;
      const int lane = tw % 32, row = i * B_BM + 16 * (tw / 32) + lane / 4;
      const int col = 64 * c + 8 * n + 2 * (lane % 4);
      const float4 a = acc_q[x];
      __nv_bfloat16* p = dq + (bh / n_heads) * q_sb + (bh % n_heads) * q_sh + (long long)row * q_sl + col;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a.x * scale, a.y * scale);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * q_sl) =
          __floats2bfloat162_rn(a.z * scale, a.w * scale);
    } else {
      const bool is_k = x - n_q4 < n_kv4;
      const long long y = is_k ? x - n_q4 : x - n_q4 - n_kv4;
      const long long tile = y / (KV_TILE / 4);
      const int f = (int)(y % (KV_TILE / 4));
      const int bh = (int)(tile / kv_tiles), jt = (int)(tile % kv_tiles);
      const int c = f / 2048, chunk = (f / 128) % 16, tw = f % 128;
      const int lane = tw % 32, row = jt * B_BN + 64 * c + 16 * (tw / 32) + lane / 4;
      if (row >= lk) continue;   // a ragged last tile's rows past Lk
      const int col = 64 * (chunk / 8) + 8 * (chunk % 8) + 2 * (lane % 4);
      const float4 a = is_k ? acc_k[y] : acc_v[y];
      const float mul = is_k ? LN2 : 1.f;
      const long long sb = is_k ? k_sb : v_sb, sl = is_k ? k_sl : v_sl, sh = is_k ? k_sh : v_sh;
      __nv_bfloat16* p = (is_k ? dk : dv) + (bh / n_heads) * sb + (bh % n_heads) * sh +
                         (long long)row * sl + col;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a.x * mul, a.y * mul);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * sl) = __floats2bfloat162_rn(a.z * mul, a.w * mul);
    }
  }
}

template <bool SPLIT, int MASK>
cudaError_t launch_main(const CUtensorMap& qm, const CUtensorMap& dom, const CUtensorMap& km,
                        const CUtensorMap& vm, const void* lse, const float* delta,
                        const void* kv_len, float* acc, void* dk, void* dv, int B, int N, int lq,
                        int lk, int kv_tiles, int q_splits, const long long* st,
                        cudaStream_t stream, const MaskArgs& ma) {
  auto kern = flash_bwd_sm90_kernel<SPLIT, MASK>;
  // setmaxnreg moves registers between the block's warpgroups: the block
  // must start with at least what the producer (24) and the consumers
  // (240) end with, or the consumers' setmaxnreg.inc would wait forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * B_THREADS < 128 * 24 + 256 * 240) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long dq_floats = (long long)B * N * lq * 128;
  const long long kv_floats = (long long)B * N * kv_tiles * KV_TILE;
  float* dk_acc = SPLIT ? acc + dq_floats : nullptr;
  float* dv_acc = SPLIT ? acc + dq_floats + kv_floats : nullptr;
  const dim3 grid = MASK != NO_SEG ? dim3(B * N, kv_tiles) : dim3(kv_tiles * q_splits, B * N);
  kern<<<grid, B_THREADS, SMEM_BYTES, stream>>>(
      qm, dom, km, vm, static_cast<const float*>(lse), delta, static_cast<const int*>(kv_len),
      acc, dk_acc, dv_acc, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), N,
      lq, lk, kv_tiles, q_splits, st[18], st[19], st[20], st[21], st[22], st[23], ma);
  return cudaGetLastError();
}

// The three launches of a call: delta and the zeroed accumulators; the
// main kernel; the accumulators to bf16. The masked modes' list and count
// are already on the stream (univid_bwd_tile_list).
int run(const void* qs, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, const void* kv_len, void* dq, void* dk, void* dv, void* delta,
        void* acc, int B, int N, int lq, int lk, int q_splits, float scale, const long long* st,
        void* stream, int mask_mode, const MaskArgs& ma) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || B <= 0 || N <= 0 ||
      q_splits < 1 || q_splits > lq / B_BM || reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, dom, km, vm;
  if (!make_map(&qm, qs, B, lq, N, st, B_BM) || !make_map(&dom, dout, B, lq, N, st + 12, B_BM) ||
      !make_map(&km, k, B, lk, N, st + 3, B_BN) || !make_map(&vm, v, B, lk, N, st + 6, B_BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kv_tiles = (lk + B_BN - 1) / B_BN;
  const long long rows = (long long)B * N * lq;
  const long long n_q4 = rows * 128 / 4;
  const long long n_kv4 = q_splits > 1 ? (long long)B * N * kv_tiles * KV_TILE / 4 : 0;
  float* accf = static_cast<float*>(acc);

  const long long pre_blocks = (rows + PRE_WARPS - 1) / PRE_WARPS;
  bwd_pre_kernel<<<(unsigned)pre_blocks, PRE_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), static_cast<float4*>(acc), n_q4 + 2 * n_kv4, N, lq, rows, st[9],
      st[10], st[11], st[12], st[13], st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

#define UNIVID_BWD_MAIN(SP, M)                                                                \
  launch_main<SP, M>(qm, dom, km, vm, lse, static_cast<float*>(delta), kv_len, accf, dk, dv, \
                     B, N, lq, lk, kv_tiles, q_splits, st, s, ma)
  switch (mask_mode) {
    case NO_SEG:
      err = q_splits > 1 ? UNIVID_BWD_MAIN(true, NO_SEG) : UNIVID_BWD_MAIN(false, NO_SEG);
      break;
    case SEGMENTS: err = UNIVID_BWD_MAIN(false, SEGMENTS); break;
    case PACKED: err = UNIVID_BWD_MAIN(false, PACKED); break;
    case CAUSAL: err = UNIVID_BWD_MAIN(false, CAUSAL); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef UNIVID_BWD_MAIN
  if (err != cudaSuccess) return (int)err;

  const long long total = n_q4 + 2 * n_kv4;
  long long post_blocks = (total + POST_THREADS - 1) / POST_THREADS;
  if (post_blocks > 132LL * 16) post_blocks = 132LL * 16;   // grid-stride beyond
  const long long dq_floats = rows * 128;
  bwd_post_kernel<<<(unsigned)post_blocks, POST_THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(accf), reinterpret_cast<const float4*>(accf + dq_floats),
      reinterpret_cast<const float4*>(accf + dq_floats + 4 * n_kv4),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), N, lq, lk, kv_tiles, scale, n_q4, n_kv4, st[15], st[16],
      st[17], st[18], st[19], st[20], st[21], st[22], st[23]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qs (folded by softmax_scale * log2 e), k, v, o, dO: bf16 [B, L, N, 128]
// (k, v with N heads) with element strides st = (qs, k, v, o, dO, dq, dk,
// dv) x (b, l, h), unit stride along D; qs, k, v and dO 16-byte aligned
// with strides that are multiples of 8 elements (TMA's rules), o 8-byte
// aligned with strides that are multiples of 4 (the Python wrapper checks
// them). lq and lk multiples of 64. lse: fp32 [B, N, lq] contiguous,
// 16-byte aligned; kv_len int32 [B] on the device or null. dq [B, lq, N,
// 128], dk, dv [B, lk, N, 128] bf16 outputs; delta fp32 [B, N, lq]
// contiguous scratch; acc fp32 scratch of B N lq 128 floats, plus 2 B N
// ceil(lk / 128) 128 128 when q_splits > 1, 16-byte aligned (zeroed here).
// q_splits in [1, lq / 64]: blocks a kv tile along q. Three launches.
int univid_flash_bwd_sm90(const void* qs, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, const void* kv_len, void* dq,
                          void* dk, void* dv, void* delta, void* acc, int B, int N, int lq, int lk,
                          int q_splits, float scale, const long long* st, void* stream) {
  return run(qs, k, v, o, dout, lse, kv_len, dq, dk, dv, delta, acc, B, N, lq, lk, q_splits,
             scale, st, stream, NO_SEG, MaskArgs());
}

// The masked modes' pre-pass (bwd_tiles_kernel, one launch): mask_mode 1
// segments, 2 packed (q_seg int32 [B, lq], kv_seg int32 [B, lk],
// contiguous), 3 causal (q_offset, q_offsets int32 [B] or null); kv_len
// int32 [B] or null. Writes list int32 [B, ceil(lk / 128), lq / 64] and
// count int32 [B, ceil(lk / 128)].
int univid_bwd_tile_list(const void* q_seg, const void* kv_seg, const void* kv_len,
                         const void* q_offsets, void* list, void* count, int mask_mode,
                         int q_offset, int B, int lq, int lk, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || B <= 0 ||
      (mask_mode != CAUSAL && (q_seg == nullptr || kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(lq / B_BM) * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  void (*kern)(const int*, const int*, const int*, const int*, int, int*, int*, int, int);
  switch (mask_mode) {
    case SEGMENTS: kern = bwd_tiles_kernel<SEGMENTS>; break;
    case PACKED: kern = bwd_tiles_kernel<PACKED>; break;
    case CAUSAL: kern = bwd_tiles_kernel<CAUSAL>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  dim3 grid((lk + B_BN - 1) / B_BN, B);
  kern<<<grid, TL_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offsets), q_offset,
      static_cast<int*>(list), static_cast<int*>(count), lq, lk);
  return (int)cudaGetLastError();
}

// The masked modes (mask_mode as for the pre-pass): the operands of
// univid_flash_bwd_sm90 at q_splits 1, the codes (16-byte aligned: they
// arrive by bulk copies) or the causal offsets, the pre-pass's list and
// count. Four launches with the pre-pass.
int univid_flash_bwd_sm90_masked(const void* qs, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, const void* kv_len,
                                 const void* q_offsets, const void* q_seg, const void* kv_seg,
                                 const void* list, const void* count, void* dq,
                                 void* dk, void* dv, void* delta, void* acc, int mask_mode,
                                 int q_offset, int B, int N, int lq, int lk, float scale,
                                 const long long* st, void* stream) {
  const bool codes = mask_mode == SEGMENTS || mask_mode == PACKED;
  if ((mask_mode != CAUSAL && !codes) || list == nullptr || count == nullptr ||
      (codes && (q_seg == nullptr || kv_seg == nullptr ||
                 reinterpret_cast<uintptr_t>(q_seg) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(kv_seg) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  MaskArgs ma;
  ma.q_seg = static_cast<const int*>(q_seg);
  ma.kv_seg = static_cast<const int*>(kv_seg);
  ma.q_offsets = static_cast<const int*>(q_offsets);
  ma.q_offset = q_offset;
  ma.list = static_cast<const int*>(list);
  ma.count = static_cast<const int*>(count);
  return run(qs, k, v, o, dout, lse, kv_len, dq, dk, dv, delta, acc, B, N, lq, lk, 1, scale, st,
             stream, mask_mode, ma);
}

}  // extern "C"
