// fp32 attention for Hopper (sm_90a) on the tensor cores at fp32 accuracy
// (3xTF32): the single-head VAE mid-block attention at d = 384, 640, 1024.
//
// Replaces the plain mode of univid_tpu/kernels/flash_attention.py::
// _flash_kernel (:44) as the Wan VAEs reach it (models/wan/vae.py:282-289):
// d=384 in the t2v-1.3B decoder ([1, 6240 -> 6272, 1, 384]), d=640 in the
// ti2v-5B encoder and d=1024 in its decoder ([1, 3520, 1, d]). fp32 q, k,
// v; softmax_scale * log2 e folded into q by the wrapper; keys at or past
// kv_len take no part; rows with l == 0 (kv_len = 0) are exactly 0. It
// takes the place of flash_attention_f32.cu (CUDA-core FFMA, kept
// compiled as the same-call baseline), whose two limits were the 1 x 4
// register tile (one LDS.128 fed 3-4 FMAs) and 16-row q blocks that each
// streamed the whole of k and v from L2 (6.3 GB a launch at d=1024).
//
// Products at fp32 accuracy on TF32 tensor cores: each operand x splits
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, 10-bit mantissas), and
// every product accumulates lo*hi + hi*lo + hi*hi in fp32 with
// mma.sync.m16n8k8.tf32. x - hi is exact and lo carries the next 11 bits,
// so the split loses ~2^-22 relative; the dropped lo*lo term is ~2^-22
// too. One TF32 product alone would round each operand to 2^-11. The
// tensor cores' fp32 accumulation truncates where an FADD rounds to
// nearest: on large sums (scores of norm-sqrt(d) rows, |s| ~ 20-60) that
// bias grew over the 3 d / 8 accumulations a score to 3e-4 (a model of it
// gave the 1.2e-4 output error the card showed). So each 16-deep stage
// sums its six products into a fresh accumulator, and an FADD adds that
// to the running sum: the truncation acts on small partial sums only.
//
// Form: the materialised score matrix, not the flash form. B * N is 1 on
// the paths and S is at most 6272^2 fp32 = 157 MB, so three kernels:
//   1. flash_f32_scores_kernel: S = q k^T (3xTF32) for the kv tiles below
//      kv_len, into a [B * N, Lq, Lk] fp32 buffer the wrapper allocates,
//      and each row's max over each 128-key tile's live keys;
//   2. flash_f32_softmax_kernel: per row the exact max m (of the tile
//      maxima), then p = exp2(s - m) written over s (0 for the keys from
//      kv_len to the next multiple of 16) and l = sum p; writes 1 / l (0
//      if l = 0);
//   3. flash_f32_pv_kernel: O = P v / l (3xTF32) over the keys below
//      kv_len.
// The flash form would keep a [rows, d] fp32 accumulator per block: at
// d=1024 a 64-row tile is 256 KB, the whole register file of an SM, so its
// columns would have to be split across blocks that each recompute
// q k^T. The exact row max replaces the running max: the same function,
// another rounding order. HBM traffic for S: written twice, read twice
// (~0.63 GB at d=384, ~0.19 ms); k and v stream from L2 once per 128
// (scores) or 64 (output) query rows, 8x / 4x fewer passes than before.
//
// What bounds it: 4 * Lq * kv * d flops a head; at 3xTF32 that is 3x that
// work at the dense TF32 rate (495 TFLOP/s), 0.31 ms at d=1024 (the fp32
// CUDA cores' 67 TFLOP/s would take 0.76 ms for the plain 1x). Bytes:
// q, k, v, o once each, a few MB: the tensor cores bound it. mma.sync
// reaches about a quarter of that TF32 rate here (PERF.md §6); wgmma,
// with v transposed into K-major tiles (TF32 takes no transpose), is the
// way past it.
//
// Tiles: 128 x 128 score tiles (8 warps, 64 x 32 each) and 64 x 128 output
// tiles (4 warps: d / 128 column tiles x Lq / 64 row tiles, so d=384 gives
// 294 blocks, not 147, on 132 SMs); depth 16 a stage, three cp.async
// stages; padded shared rows (20 floats for [rows, 16] stages, 136 for
// [16, 128] v stages) make every fragment load conflict-free. A fragments
// (and the score GEMM's k fragments) load with ldmatrix: an 8 x 8 b16
// matrix is an 8 x 4 fp32 one, and each thread receives element (lane / 4,
// lane % 4) of each, which is the m16n8k8 tf32 fragment layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;         // output columns a block: keys (S) or d (O)
constexpr int BK = 16;          // reduction depth a stage
constexpr int STAGES = 3;
constexpr int LDA = BK + 4;     // padded row of a [rows, 16] stage
constexpr int LDB = BN + 8;     // padded row of a [16, 128] v stage
constexpr int QK_BM = 128;      // query rows of a score block (8 warps)
constexpr int PV_BM = 64;       // query rows of an output block (4 warps)
constexpr int ROWS_WARPS = 8;   // rows (one a warp) of a softmax block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the 16 bytes instead
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest STAGES - 2 committed groups are complete
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// four 8 x 4 fp32 matrices from shared memory (lanes 8 m .. 8 m + 7 give
// the row addresses of matrix m); r[m] = matrix m's (lane / 4, lane % 4)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const float* p) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 (cvt.rna: nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block's [BM, 128] tile of A B over k in [0, k_end) (k_end rounded
// up to 16: A holds zeros there, or the caller ignores those columns),
// 3xTF32, into acc: warp w owns rows 64 (w / 4) .. +63 and columns
// 32 (w % 4) .. +31 as 4 x 4 m16n8 fragments. A: a [*, K] matrix (row
// stride a_ld), rows at or past a_lim read as 0. B: PV false, rows (the n
// index) of a [*, K] matrix (b_ld), rows at or past b_lim read as 0; PV
// true, a [K, *] matrix (b_ld) from column 0 of the block's tile, rows at
// or past b_lim read as 0.
template <int BM, bool PV>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4][4], const float* __restrict__ A,
                                          long long a_ld, int a_lim, const float* __restrict__ B,
                                          long long b_ld, int b_lim, int k_end, float* smem) {
  constexpr int THREADS = BM * 2;
  constexpr int A_FLOATS = BM * LDA;
  constexpr int B_FLOATS = PV ? BK * LDB : BN * LDA;
  constexpr int STAGE = A_FLOATS + B_FLOATS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n_k = (k_end + BK - 1) / BK;

  auto load = [&](int kt) {
    if (kt < n_k) {
      float* as = smem + (kt % STAGES) * STAGE;
      float* bs = as + A_FLOATS;
      const int k0 = kt * BK;
      for (int i = tid; i < BM * (BK / 4); i += THREADS) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        const bool ok = r < a_lim;
        cp_async16(as + r * LDA + c, A + (long long)(ok ? r : 0) * a_ld + k0 + c, ok ? 16 : 0);
      }
      if (PV) {
        for (int i = tid; i < BK * (BN / 4); i += THREADS) {
          const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
          const bool ok = k0 + r < b_lim;
          cp_async16(bs + r * LDB + c, B + (long long)(ok ? k0 + r : 0) * b_ld + c, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < BN * (BK / 4); i += THREADS) {
          const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
          const bool ok = r < b_lim;
          cp_async16(bs + r * LDA + c, B + (long long)(ok ? r : 0) * b_ld + k0 + c, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_stages();
    __syncthreads();   // stage kt landed; every warp is done with kt - 1
    load(kt + STAGES - 1);
    const float* as = smem + (kt % STAGES) * STAGE;
    const float* bs = as + A_FLOATS;
    float part[4][4][4] = {};   // this stage's products (see the header)
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
      const int mi = lane >> 3, rr = lane & 7;   // ldmatrix: matrix, row
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // rows 16 i + {0..7, 8..15} x columns ks + {0..3, 4..7}: a0 .. a3
        uint32_t x[4];
        ldsm_x4(x, as + (wm + 16 * i + 8 * (mi & 1) + rr) * LDA + ks + 4 * (mi >> 1));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]), ah[i][e], al[i][e]);
      }
      if (PV) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split_tf32(bs[(ks + t + 4 * e) * LDB + wn + 8 * j + g], bh[j][e], bl[j][e]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          // key rows 8 (j + {0, 1}) x columns ks + {0..3, 4..7}: b0, b1 of
          // n-tiles j and j + 1
          uint32_t x[4];
          ldsm_x4(x, bs + (wn + 8 * (j + (mi >> 1)) + rr) * LDA + ks + 4 * (mi & 1));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(x[e]), bh[j + (e >> 1)][e & 1], bl[j + (e >> 1)][e & 1]);
        }
      }
      // the small terms first; 16 independent accumulators between two
      // products into the same one
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], ah[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
}

template <int BM, bool PV>
constexpr int gemm_smem_bytes() {
  return STAGES * (BM * LDA + (PV ? BK * LDB : BN * LDA)) * (int)sizeof(float);
}

__device__ __forceinline__ int kv_end_of(const int* kv_len, int b, int lk) {
  return kv_len != nullptr ? min(max(kv_len[b], 0), lk) : lk;
}

// S[z, i, j] = q_i . k_j (folded scores), z = b * N + h, for the key tiles
// below kv_len, and tile_max[z, i, j / 128] = the max of row i over the
// tile's keys below kv_len; blocks (key tile, 128-row tile, z)
__global__ void __launch_bounds__(QK_BM * 2, 1)
flash_f32_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        float* __restrict__ S, float* __restrict__ tile_max,
                        const int* __restrict__ kv_len, int n_heads, int lq, int lk, int d,
                        long long q_sb, long long q_sl, long long q_sh, long long k_sb,
                        long long k_sl, long long k_sh) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z, b = z / n_heads, h = z % n_heads;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * QK_BM;
  const int kv_end = kv_end_of(kv_len, b, lk);
  if (n0 >= kv_end) return;   // no live key in the tile
  const float* qp = q + b * q_sb + h * q_sh + (long long)m0 * q_sl;
  const float* kp = k + b * k_sb + h * k_sh + (long long)n0 * k_sl;
  float acc[4][4][4] = {};
  gemm_tile<QK_BM, false>(acc, qp, q_sl, lq - m0, kp, k_sl, lk - n0, d, smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float* sp = S + ((long long)z * lq + m0) * lk + n0;
  __syncthreads();   // every warp is done with the stages: smem holds row maxima
  float* wmax = smem;   // [QK_BM rows][4 column warps]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm + 16 * i + g + 8 * hh;
      float m = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + 2 * t;
        if (n0 + c < kv_end) m = fmaxf(m, acc[i][j][2 * hh]);
        if (n0 + c + 1 < kv_end) m = fmaxf(m, acc[i][j][2 * hh + 1]);
        if (m0 + r < lq && n0 + c < lk)
          *reinterpret_cast<float2*>(sp + (long long)r * lk + c) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 2));
      if (t == 0) wmax[r * 4 + (warp & 3)] = m;
    }
  __syncthreads();
  const int kt = (lk + BN - 1) / BN;
  if (threadIdx.x < QK_BM && m0 + threadIdx.x < lq) {
    const float* wr = wmax + threadIdx.x * 4;
    tile_max[((long long)z * lq + m0 + threadIdx.x) * kt + blockIdx.x] =
        fmaxf(fmaxf(wr[0], wr[1]), fmaxf(wr[2], wr[3]));
  }
}

// Row i of S over the keys below kv_len, in place: m = the row max (of
// the score kernel's tile maxima), then p = exp2(s - m) over s and
// l = sum p; p = 0 from kv_len up to the next multiple of 16 (the output
// GEMM's depth); inv_l[z, i] = 1 / l, or 0 when l = 0 (kv_len = 0). One
// warp a row.
__global__ void __launch_bounds__(ROWS_WARPS * 32)
flash_f32_softmax_kernel(float* __restrict__ S, const float* __restrict__ tile_max,
                         float* __restrict__ inv_l, const int* __restrict__ kv_len,
                         int n_heads, int lq, int lk) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_WARPS + (threadIdx.x >> 5), z = blockIdx.y;
  if (row >= lq) return;
  const int kv_end = kv_end_of(kv_len, z / n_heads, lk);
  float* sr = S + ((long long)z * lq + row) * lk;
  const int end4 = kv_end & ~3;
  const int kt = (lk + BN - 1) / BN, live_kt = (kv_end + BN - 1) / BN;
  const float* tm = tile_max + ((long long)z * lq + row) * kt;
  float m = NEG_INF;
  for (int j = lane; j < live_kt; j += 32) m = fmaxf(m, tm[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, off));
  float l = 0.f;
  for (int c = 4 * lane; c < end4; c += 128) {
    float4 x = *reinterpret_cast<const float4*>(sr + c);
    x.x = fast_exp2(x.x - m);
    x.y = fast_exp2(x.y - m);
    x.z = fast_exp2(x.z - m);
    x.w = fast_exp2(x.w - m);
    l += (x.x + x.y) + (x.z + x.w);
    *reinterpret_cast<float4*>(sr + c) = x;
  }
  for (int c = end4 + lane; c < kv_end; c += 32) {
    const float p = fast_exp2(sr[c] - m);
    l += p;
    sr[c] = p;
  }
  const int end16 = (kv_end + BK - 1) / BK * BK;   // <= lk (a multiple of 64)
  for (int c = kv_end + lane; c < end16; c += 32) sr[c] = 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffff, l, off);
  if (lane == 0) inv_l[(long long)z * lq + row] = l > 0.f ? 1.f / l : 0.f;
}

// o[b, i, h, :] = sum_j P[z, i, j] v[b, j, h, :] / l_i over the keys below
// kv_len; blocks (128-column d tile, 64-row tile, z), two a SM
__global__ void __launch_bounds__(PV_BM * 2, 2)
flash_f32_pv_kernel(const float* __restrict__ P, const float* __restrict__ inv_l,
                    const float* __restrict__ v, float* __restrict__ o,
                    const int* __restrict__ kv_len, int n_heads, int lq, int lk, long long v_sb,
                    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
                    long long o_sh) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z, b = z / n_heads, h = z % n_heads;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * PV_BM;
  const int kv_end = kv_end_of(kv_len, b, lk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wn = warp * 32;   // one warp row: wm = 0
  float acc[4][4][4] = {};
  gemm_tile<PV_BM, true>(acc, P + ((long long)z * lq + m0) * lk, lk, lq - m0,
                         v + b * v_sb + h * v_sh + n0, v_sl, lk, kv_end, smem);
  const float* il = inv_l + (long long)z * lq + m0;
  float inv[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * i + g + 8 * hh;
      inv[i][hh] = m0 + r < lq ? il[r] : 0.f;
    }

  float* op = o + b * o_sb + h * o_sh + (long long)m0 * o_sl + n0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * i + g + 8 * hh;
      if (m0 + r >= lq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(op + (long long)r * o_sl + wn + 8 * j + 2 * t) =
            make_float2(acc[i][j][2 * hh] * inv[i][hh], acc[i][j][2 * hh + 1] * inv[i][hh]);
    }
}

}  // namespace

extern "C" {

// q, k, v, o: fp32 [B, L, N, D] with element strides st = (q_b, q_l, q_h,
// k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h), unit stride along D,
// 16-byte aligned rows (strides multiples of 4). lq and lk multiples of
// 64; D a multiple of 128. kv_len: int32 [B] on the device, or null. q
// arrives scale * log2 e folded. scores: fp32 [B * N, lq, lk] scratch;
// tile_max: fp32 [B * N, lq, ceil(lk / 128)] scratch; inv_l: fp32
// [B * N, lq] scratch. Three launches on `stream`.
int univid_flash_fwd_f32_tc(const void* q, const void* k, const void* v, void* o,
                            const void* kv_len, void* scores, void* tile_max, void* inv_l,
                            int B, int N, int lq, int lk, int D, const long long* st,
                            void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || D % BN != 0 || B <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kvl = static_cast<const int*>(kv_len);
  float* S = static_cast<float*>(scores);
  float* il = static_cast<float*>(inv_l);
  float* tm = static_cast<float*>(tile_max);

  constexpr int qk_smem = gemm_smem_bytes<QK_BM, false>();
  constexpr int pv_smem = gemm_smem_bytes<PV_BM, true>();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_scores_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, qk_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_f32_pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pv_smem);
  if (err != cudaSuccess) return (int)err;

  dim3 g1((lk + BN - 1) / BN, (lq + QK_BM - 1) / QK_BM, B * N);
  flash_f32_scores_kernel<<<g1, QK_BM * 2, qk_smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), S, tm, kvl, N, lq, lk, D, st[0],
      st[1], st[2], st[3], st[4], st[5]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 g2((lq + ROWS_WARPS - 1) / ROWS_WARPS, B * N);
  flash_f32_softmax_kernel<<<g2, ROWS_WARPS * 32, 0, s>>>(S, tm, il, kvl, N, lq, lk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 g3(D / BN, (lq + PV_BM - 1) / PV_BM, B * N);
  flash_f32_pv_kernel<<<g3, PV_BM * 2, pv_smem, s>>>(
      S, il, static_cast<const float*>(v), static_cast<float*>(o), kvl, N, lq, lk, st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // extern "C"
