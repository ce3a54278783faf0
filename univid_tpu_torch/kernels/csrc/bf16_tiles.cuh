// Building blocks of the tensor-core attention forwards (flash_attention.cu,
// flash_attention_int8.cu, flash_attention_sm90.cu,
// flash_attention_causal_sm90.cu): the segment and packed
// mask predicates, cp.async tile copies into XOR-swizzled shared
// memory, ldmatrix fragment loads, the bf16 mma.sync product, and the
// per-tile softmax update in the exp2 domain with its two chains, fp32 and
// bf16 (_flash_kernel's and _cross_kernel's softmax_bf16 mode,
// univid_tpu/kernels/flash_attention.py:259-265, :402-403).
//
// Fragment layout: a warp owns 16 query rows; thread (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, score columns 8n + 2t + {0, 1} of
// each 8-column n-tile: s[n][0..1] on row g, s[n][2..3] on row g + 8.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;      // q rows per block
constexpr int BC = 64;      // kv rows per tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;

enum Mode { BOUNDED = 0, RUNNING = 1, ONESHOT = 2 };
enum Seg { NO_SEG = 0, SEGMENTS = 1, PACKED = 2 };

// BAGEL's packed-training predicate on pack_mask_codes codes (arithmetic
// shifts: pad ids -1 / -2 give doc -1 and fn 255 and never pass it)
__device__ __forceinline__ bool packed_allowed(int qc, int kc, int row, int col) {
  const int fn_q = (qc >> 8) & 0xFF, fn_k = (kc >> 8) & 0xFF;
  const int nz_q = qc & 0xFF, nz_k = kc & 0xFF;
  return (row >= col || (fn_q == fn_k && fn_q > 0)) && !(nz_k > 0 && nz_q != nz_k) &&
         (qc >> 16) == (kc >> 16);
}

// a query with code qc at pack row `row` may see the key kc at `col`
// (SEGMENTS: equal ids; PACKED: packed_allowed)
template <int SEG>
__device__ __forceinline__ bool seg_allowed(int qc, int kc, int row, int col) {
  return SEG == PACKED ? packed_allowed(qc, kc, row, col) : qc == kc;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to the nearest bf16 (ties to even), kept as an fp32 value
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Element offset of 16-byte chunk `c` of row `r` in a swizzled [rows, D]
// bf16 tile (D/8 chunks per row, chunk index XOR-ed with r % 8).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Copy a [64, D] bf16 tile (row stride `ld` elements) into swizzled smem.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < 64 * CH; i += NTHREADS) {
    int r = i / CH, c = i % CH;
    cp_async16(dst + swz<D>(r, c), src + r * ld + c * 8);
  }
}

// One 64-key tile's softmax update, in place: the scores s[NT][4] (folded,
// exp2 domain, masked keys -1e30) become p. MODE BOUNDED: reference point
// c_bound; RUNNING: the running max m_r, whose growth rescales l_r and acc
// by exp2(m_old - m_new); ONESHOT: m_r already holds the exact row max.
// SBF16 (softmax_bf16): s is rounded to bf16 before anything else, the
// reference point too (a running max of bf16 scores is one already), s - ref
// rounds to bf16 and exp2 gives a bf16 p; l adds those rounded p in fp32;
// the running max and its correction stay fp32. GUARD: a row with no live
// key yet (reference still -1e30) takes the reference 0, so its p are
// exp2(-1e30) = 0 and not exp2(0) = 1.
template <int MODE, bool SBF16, bool GUARD, int NT, int OT>
__device__ __forceinline__ void softmax_tile(float (*s)[4], float* m_r, float* l_r,
                                             float (*acc)[4], float c_bound) {
  if (SBF16) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = round_bf16(s[n][j]);
  }
  if (MODE == RUNNING) {
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mc[0] = fmaxf(mc[0], fmaxf(s[n][0], s[n][1]));
      mc[1] = fmaxf(mc[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffff, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffff, mc[i], 2));
      float m_new = fmaxf(m_r[i], mc[i]);
      float corr = fast_exp2(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr;
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
  }
  float ref[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ref[i] = (MODE == BOUNDED) ? c_bound : m_r[i];
    if (GUARD && ref[i] == NEG_INF) ref[i] = 0.f;
    if (SBF16) ref[i] = round_bf16(ref[i]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = ref[j >> 1];
      s[n][j] = SBF16 ? round_bf16(fast_exp2(round_bf16(s[n][j] - r)))
                      : fast_exp2(s[n][j] - r);
    }
    l_r[0] += s[n][0] + s[n][1];
    l_r[1] += s[n][2] + s[n][3];
  }
}

// acc += p v for one 64-key tile: p (fragments of softmax_tile's output)
// rounded to bf16, v the swizzled [64, D] bf16 tile in shared memory.
template <int D>
__device__ __forceinline__ void pv_tile(float (*acc)[4], float (*p)[4],
                                        const __nv_bfloat16* Vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bfr[4];
      int mi = lane >> 3, rr = lane & 7;
      int r = kk * 16 + (mi & 1) * 8 + rr;
      int c = dp * 2 + (mi >> 1);
      ldmatrix_x4_trans(bfr, Vs + swz<D>(r, c));
      mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
      mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
    }
  }
}

// The warp's 16 output rows: acc / l (rows with l == 0 exactly 0), bf16, at
// op (row g of the warp's rows at op, row g + 8 at op + 8 * o_sl). With
// lse_row (this thread's row g of lse; row g + 8 at lse_row + 8) also the
// exp2-domain lse: the reference point (c_bound, or the row max m_r) plus
// log2 l, +1e30 where l == 0.
template <int MODE, int OT>
__device__ __forceinline__ void store_rows(float (*acc)[4], const float* l_r, const float* m_r,
                                           float c_bound, float* lse_row,
                                           __nv_bfloat16* op, long long o_sl, int g, int t) {
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[i] = l > 0.f ? 1.f / l : 0.f;
    if (lse_row != nullptr && t == 0) {
      const float ref = (MODE == BOUNDED) ? c_bound : m_r[i];
      lse_row[8 * i] = l > 0.f ? ref + log2f(l) : -NEG_INF;
    }
  }
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    int col = n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(op + (long long)g * o_sl + col) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(op + (long long)(g + 8) * o_sl + col) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

}  // namespace
