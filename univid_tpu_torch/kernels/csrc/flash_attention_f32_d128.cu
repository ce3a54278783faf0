// Flash attention forward for Hopper (sm_90a), fp32 at d=128, on CUDA cores:
// the SAME-CALL BASELINE of flash_attention_f32_sm90.cu, which took every
// fp32 d=128 forward call (the full DiT fine-tune at its default fp32
// policy, fp32 DiT serving, the fp32 cross-attention at 512 keys) onto the
// tensor cores at fp32 accuracy. No route reaches this kernel: chip_smoke.py
// and the card tests time and check it beside the new one
// (flash_attention.py's `_launch_f32_d128`, counters
// flash_attention_f32_d128 / flash_attention_f32_lse). The rope pre-pass
// below (univid_rope_rotate_f32) is still the route's: fp32 serving with
// fused rope rotates q and k here first.
//
// It computes, at fp32 and d=128, univid_tpu/kernels/flash_attention.py::
// _flash_kernel (:44) in the modes the DiT reaches:
//   * the running max, or the bounded softmax p = exp2(s - C) at the
//     folded score bound C (:266-275);
//   * kv_len: keys at or past kv_len[b] get -1e30, kv tiles wholly past it
//     are never loaded; rows with l == 0 are exactly zero;
//   * save_residuals (:343-352), the training forward: with an lse pointer
//     the kernel also writes the exp2-domain log-sum-exp, m + log2 l (C +
//     log2 l under the bound), +1e30 for rows with l == 0, fp32 [B, N, Lq];
//   * the fused-rope prologue (:119-135, :157): rope_rotate_f32 below
//     rotates q and k once, in a pre-pass, as univid_rope_rotate_bf16 does
//     for bf16 (serving only: training rotates outside the kernel, as JAX
//     does).
// It also computes the function of _cross_kernel (:355) at fp32: the port
// sends fp32 cross-attention (Lk = 512) to this kernel, whose running max
// over the 8 kv tiles gives the one-shot softmax's value.
// q arrives folded by softmax_scale * log2(e) in q's dtype (or through the
// q rope tables). Multi-head [B, L, N, D] with element strides.
//
// What bounds it: 4 Lq Lk d flops per head, in full fp32 (the plain version
// and the TPU kernel compute fp32 products; TF32 would round them). At the
// t2v-1.3B training shape [1, 32768, 12, 128], kv 32,760, that is 6.6
// TFLOP against 0.8 GB: operations, 98.5 ms at 67 TFLOP/s. The cross shape
// (Lk = 512) is bound by operations too (1.54 ms), by 3x over its bytes.
//
// Design. One block of 256 threads takes one (b*h, 128-row q tile). The q
// tile stays in shared memory; 64-key k and v tiles stream through one
// buffer each, by cp.async: v_j loads while S = Q k_j^T runs, k_{j+1}
// while O += P v_j runs (fp32_tiles.cuh has the products). Each thread
// holds an 8 x 4 score tile and an 8 x 8 output tile in registers; the
// online softmax reduces each row over its half warp by shuffles; p goes
// to a shared [128, 64] tile for the P V product. Shared memory: 256 x 132
// + 128 x 68 floats, 166 KB (one block an SM). A 64-row q tile (4 x 4 and
// 4 x 8 register tiles, 116 KB) took 200.2 ms at the training shape
// against 162.4 ms for 128 rows (NVIDIA H100 80GB HBM3, 700 W): the wider
// tile halves the k and v loads from shared memory per FFMA. lq need only
// be a multiple of 64: a last half tile is zero-filled and not stored.
//
// ptxas (sm_90a): 228-254 registers over the four instantiations (bound x
// lse), 0 bytes spilled; the rope kernel 28 registers.

#include "fp32_tiles.cuh"

using namespace f32tile;

namespace {

constexpr int RM = 8;         // rows a thread, a 128-row q tile
constexpr int BQ = 16 * RM;
constexpr int SMEM = (int)sizeof(float) * ((BQ + 2 * BT) * LD + BQ * LDP);

template <bool BOUNDED, bool LSE>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_f32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          const int* __restrict__ kv_len, const float* __restrict__ bound,
                          float* __restrict__ lse, int n_heads, int lq, int lk,
                          long long q_sb, long long q_sl, long long q_sh,
                          long long k_sb, long long k_sl, long long k_sh,
                          long long v_sb, long long v_sl, long long v_sh,
                          long long o_sb, long long o_sl, long long o_sh) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;              // [BQ, LD]
  float* Ks = Qs + BQ * LD;    // [64, LD]
  float* Vs = Ks + BT * LD;    // [64, LD]
  float* Ps = Vs + BT * LD;    // [BQ, LDP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, lq - q0);   // lq is a multiple of 64, not of BQ
  const float* kp = k + b * k_sb + h * k_sh;
  const float* vp = v + b * v_sb + h * v_sh;

  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + BT - 1) / BT;
  const float c_bound = BOUNDED ? *bound : 0.f;   // folded score bound

  float acc[RM][8];
  float m_r[RM], l_r[RM];   // running max (or the bound) and this thread's share of l
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_r[i] = BOUNDED ? c_bound : NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  if (n_tiles > 0) {
    load_tile<BQ>(Qs, q + b * q_sb + h * q_sh + (long long)q0 * q_sl, q_sl, q_valid, tid);
    load_tile<BT>(Ks, kp, k_sl, BT, tid);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BT;
    cp_async_wait_all();
    __syncthreads();   // k_j landed; every thread is done with v_{j-1} and P
    load_tile<BT>(Vs, vp + (long long)kv0 * v_sl, v_sl, BT, tid);
    cp_async_commit();

    float s[RM][4];
    prod_xyt<RM>(s, Qs, Ks, ty, tx);
    if (kv0 + BT > kv_end) {   // the kv_len tail tile
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (kv0 + tx + 16 * jj >= kv_end)
#pragma unroll
          for (int i = 0; i < RM; ++i) s[i][jj] = NEG_INF;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (!BOUNDED) {
        // the first tile holds key 0 < kv_end, so m is finite from then on
        const float mc = row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
        const float m_new = fmaxf(m_r[i], mc);
        const float corr = fast_exp2(m_r[i] - m_new);
        m_r[i] = m_new;
        l_r[i] *= corr;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
      }
      float* prow = Ps + (ty + 16 * i) * LDP + tx;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = fast_exp2(s[i][jj] - m_r[i]);
        l_r[i] += p;
        prow[16 * jj] = p;
      }
    }

    cp_async_wait_all();
    __syncthreads();   // v_j landed; P is complete; every thread is done with k_j
    if (j + 1 < n_tiles) {
      load_tile<BT>(Ks, kp + (long long)(kv0 + BT) * k_sl, k_sl, BT, tid);
      cp_async_commit();
    }
    prod_pz<RM>(acc, Ps, Vs, ty, tx);
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float l = row_sum(l_r[i]);
    const int row = ty + 16 * i;
    if (row < q_valid) {
      store_row8(ob + (long long)(q0 + row) * o_sl, acc[i], l > 0.f ? 1.f / l : 0.f, tx);
      // exp2-domain lse: the reference point (bound or row max) plus
      // log2 l; +1e30 for empty rows, so that the backward's p is 0
      if (LSE && tx == 0)
        lse[(long long)bh * lq + q0 + row] = l > 0.f ? m_r[i] + log2f(l) : -NEG_INF;
    }
  }
}

// y = x * cosF + swap_pairs(x) * sinF (swap_pairs(x)[i] = x[i ^ 1]): two
// fp32 products and a sum, each rounded once, as the plain version's. x
// [B, L, N, D] strided, tables [L, D] fp32, y contiguous fp32.
__global__ void rope_rotate_f32_kernel(const float* __restrict__ x, const float* __restrict__ cf,
                                       const float* __restrict__ sf, float* __restrict__ y,
                                       int L, int N, int D, long long x_sb, long long x_sl,
                                       long long x_sh, long long total_pairs) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_pairs) return;
  const int dp = (int)(i % (D / 2));
  long long rest = i / (D / 2);
  const int h = (int)(rest % N);
  rest /= N;
  const int l = (int)(rest % L);
  const int b = (int)(rest / L);
  const int d = 2 * dp;
  const float2 xv = *reinterpret_cast<const float2*>(x + b * x_sb + l * x_sl + h * x_sh + d);
  const float2 c = *reinterpret_cast<const float2*>(cf + (long long)l * D + d);
  const float2 s = *reinterpret_cast<const float2*>(sf + (long long)l * D + d);
  float2 out;
  out.x = __fadd_rn(__fmul_rn(xv.x, c.x), __fmul_rn(xv.y, s.x));
  out.y = __fadd_rn(__fmul_rn(xv.y, c.y), __fmul_rn(xv.x, s.y));
  *reinterpret_cast<float2*>(y + 2 * i) = out;
}

template <bool BOUNDED, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* kv_len,
                   const void* bound, void* lse, int B, int N, int lq, int lk,
                   const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_f32_d128_kernel<BOUNDED, LSE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BQ - 1) / BQ, B * N);
  kern<<<grid, NTHREADS, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<const int*>(kv_len), static_cast<const float*>(bound),
      static_cast<float*>(lse), N, lq, lk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: fp32 [B, L, N, 128] with element strides st = (q_b, q_l, q_h,
// k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h), unit stride along D,
// multiples of 4 and 16-byte aligned rows. lq and lk are multiples of 64.
// kv_len: int32 [B] on the device, or null. bound: null (running max) or
// an fp32 scalar on the device, the folded score bound. lse: null, or fp32
// [B, N, lq] contiguous (the training forward).
int univid_flash_fwd_f32_d128(const void* q, const void* k, const void* v, void* o,
                              const void* kv_len, const void* bound, void* lse, int B, int N,
                              int lq, int lk, const long long* st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lq % 64 != 0 || lk % BT != 0) return (int)cudaErrorInvalidValue;
  if (bound != nullptr)
    return (int)(lse != nullptr
                     ? launch<true, true>(q, k, v, o, kv_len, bound, lse, B, N, lq, lk, st, s)
                     : launch<true, false>(q, k, v, o, kv_len, bound, lse, B, N, lq, lk, st, s));
  return (int)(lse != nullptr
                   ? launch<false, true>(q, k, v, o, kv_len, bound, lse, B, N, lq, lk, st, s)
                   : launch<false, false>(q, k, v, o, kv_len, bound, lse, B, N, lq, lk, st, s));
}

// y [B, L, N, D] contiguous fp32 = rope(x) with fp32 tables [L, D]; x rows
// 8-byte aligned.
int univid_rope_rotate_f32(const void* x, const void* cf, const void* sf, void* y, int B, int L,
                           int N, int D, long long x_sb, long long x_sl, long long x_sh,
                           void* stream) {
  if (D % 2 != 0) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)B * L * N * (D / 2);
  const int threads = 256;
  const long long blocks = (pairs + threads - 1) / threads;
  rope_rotate_f32_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cf), static_cast<const float*>(sf),
      static_cast<float*>(y), L, N, D, x_sb, x_sl, x_sh, pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
