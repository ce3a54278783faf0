// Flash attention forward for Hopper (sm_90a), fp32 inputs, on CUDA cores.
//
// Replaces the plain mode of univid_tpu/kernels/flash_attention.py::
// _flash_kernel (:44) as the Wan VAE decoder's mid-block attention reaches
// it (models/wan/vae.py:289): one head of d=384, fp32 q/k/v (the latent
// enters the decoder in fp32), running-max online softmax in the exp2
// domain (softmax_scale*log2e folded into q by the wrapper, in q's dtype),
// kv_len masking with dead kv tiles skipped, zero rows when l == 0.
//
// What bounds it: ~1.3e12 flops per decoded 480p video in 21 launches of
// 6240 tokens; full fp32 keeps it on the CUDA cores (67 TFLOP/s peak), so
// operations bound it, and shared-memory loads feeding the FMAs bound it
// in practice. The work is small next to the decoder's convolutions, so
// the design stays plain: fp32 throughout, matching the TPU kernel's fp32
// matmuls, instead of a bf16 or TF32 tensor-core path that would round.
//
// Design: one block of 128 threads per (b*h, 32-row q tile); q, k and v
// tiles of 32 rows live in shared memory (rows padded by 4 floats against
// bank conflicts). Each thread computes 8 scores of one row, one warp per
// 8 rows runs the online softmax with a lane per key, and each thread
// accumulates 96 output columns of one row in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 32;
constexpr int BC = 32;
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     const int* __restrict__ kv_len, int n_heads, int lk,
                     long long q_sb, long long q_sl, long long q_sh,
                     long long k_sb, long long k_sl, long long k_sh,
                     long long v_sb, long long v_sl, long long v_sh,
                     long long o_sb, long long o_sl, long long o_sh) {
  constexpr int LD = D + 4;       // padded row of the q and k tiles
  constexpr int LP = BC + 1;      // padded row of the p tile
  constexpr int CPT = D / 4;      // output columns per thread
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ks = Qs + BR * LD;
  float* Vs = Ks + BC * LD;
  float* Ps = Vs + BC * D;
  float* corr_s = Ps + BR * LP;
  float* l_s = corr_s + BR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = tid >> 2, cq = tid & 3;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * BR;

  const float* qp = q + b * q_sb + h * q_sh + (long long)q0 * q_sl;
  const float* kp = k + b * k_sb + h * k_sh;
  const float* vp = v + b * v_sb + h * v_sh;

  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + BC - 1) / BC;

  for (int i = tid; i < BR * D / 4; i += NTHREADS) {
    int r = i / (D / 4), c = (i % (D / 4)) * 4;
    *reinterpret_cast<float4*>(Qs + r * LD + c) =
        *reinterpret_cast<const float4*>(qp + r * q_sl + c);
  }

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m_w[BR / 4], l_w[BR / 4];  // softmax state of this warp's 8 rows
#pragma unroll
  for (int i = 0; i < BR / 4; ++i) {
    m_w[i] = NEG_INF;
    l_w[i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BC;
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BC * D / 4; i += NTHREADS) {
      int r = i / (D / 4), c = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(Ks + r * LD + c) =
          *reinterpret_cast<const float4*>(kp + (long long)(kv0 + r) * k_sl + c);
      *reinterpret_cast<float4*>(Vs + r * D + c) =
          *reinterpret_cast<const float4*>(vp + (long long)(kv0 + r) * v_sl + c);
    }
    __syncthreads();

    float s[BC / 4];
#pragma unroll
    for (int i = 0; i < BC / 4; ++i) s[i] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv = *reinterpret_cast<const float4*>(Qs + row * LD + d);
#pragma unroll
      for (int i = 0; i < BC / 4; ++i) {
        float4 kv = *reinterpret_cast<const float4*>(Ks + (cq + 4 * i) * LD + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BC / 4; ++i) {
      int col = kv0 + cq + 4 * i;
      Ps[row * LP + cq + 4 * i] = col < kv_end ? s[i] : NEG_INF;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < BR / 4; ++i) {
      int r = warp * (BR / 4) + i;
      float sv = Ps[r * LP + lane];
      float mc = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffff, mc, off));
      float m_new = fmaxf(m_w[i], mc);
      float p = fast_exp2(sv - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffff, ps, off);
      float corr = fast_exp2(m_w[i] - m_new);
      l_w[i] = l_w[i] * corr + ps;
      m_w[i] = m_new;
      Ps[r * LP + lane] = p;
      if (lane == 0) corr_s[r] = corr;
    }
    __syncthreads();

    const float corr = corr_s[row];
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[jj] *= corr;
    for (int kv = 0; kv < BC; ++kv) {
      float p = Ps[row * LP + kv];
      const float* vr = Vs + kv * D + cq;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[jj] = fmaf(p, vr[4 * jj], acc[jj]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < BR / 4; ++i) l_s[warp * (BR / 4) + i] = l_w[i];
  }
  __syncthreads();
  const float l = l_s[row];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* op = o + b * o_sb + h * o_sh + (long long)(q0 + row) * o_sl + cq;
#pragma unroll
  for (int jj = 0; jj < CPT; ++jj) op[4 * jj] = acc[jj] * inv;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* kv_len,
                   int B, int N, int lq, int lk, const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_f32_kernel<D>;
  constexpr int LD = D + 4;
  const int smem =
      (int)sizeof(float) * (BR * LD + BC * LD + BC * D + BR * (BC + 1) + 2 * BR);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(lq / BR, B * N);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<const int*>(kv_len),
      N, lk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: fp32 [B, L, N, D] with element strides st = (q_b, q_l, q_h,
// k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h), unit stride along D, rows
// 16-byte aligned. lq and lk are multiples of 32. kv_len: int32 [B] on the
// device, or null. Running-max softmax; q arrives scale*log2e-folded.
int univid_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                         const void* kv_len, int B, int N, int lq, int lk, int D,
                         const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lq % BR != 0 || lk % BC != 0) return (int)cudaErrorInvalidValue;
  if (D == 384) return (int)launch<384>(q, k, v, o, kv_len, B, N, lq, lk, strides, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
