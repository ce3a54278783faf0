// Flash attention forward for Hopper (sm_90a), fp32, on CUDA cores: the
// single-head VAE mid-block attention at d = 384, 640 and 1024. The paths
// run flash_attention_f32_tc.cu (3xTF32 on the tensor cores) in its
// place; this kernel stays compiled, reached only through its C entry
// point, as the same-call baseline of chip_smoke.py and the card tests.
//
// Replaces the plain mode of univid_tpu/kernels/flash_attention.py::
// _flash_kernel (:44) as the Wan VAEs reach it (models/wan/vae.py:282-289):
// d=384 in the t2v-1.3B decoder, d=640 in the ti2v-5B encoder (the i2v
// first-frame encode) and d=1024 in the ti2v-5B decoder. fp32 q/k/v;
// running-max online softmax in the exp2 domain (softmax_scale*log2e folded
// into q by the wrapper, in q's dtype); keys at or past kv_len get -1e30
// and kv tiles wholly past it are never loaded; rows with l == 0 are
// exactly zero.
//
// What bounds it: 4*L^2*d flops per launch (5.1e10 at L=3520, d=1024) on
// the CUDA cores' 67 TFLOP/s fp32, so operations. Full fp32, as the TPU
// kernel's fp32 products, and not TF32 or bf16 tensor cores, which would
// round.
//
// Design. Tiles of whole rows do not fit: 32-row q, k and v tiles take
// 395 KB at d=1024, more than a block's 227 KB. One block of 256 threads
// takes one (b*h, 16-row q tile). The q tile stays in shared memory (64 KB
// at d=1024); k and v stream through a double-buffered ring of [64 keys x
// 64 columns] chunks filled by cp.async, one chunk ahead of the compute.
// For each 64-key tile, S = Q K^T accumulates over the d/64 k chunks, the
// online softmax runs on the [16 x 64] score tile in shared memory, then
// O += P V runs over the d/64 v chunks. Each thread keeps 4 output columns
// of one row per chunk in registers, d/16 floats in all (64 at d=1024).
// Within a warp 8 rows share each k or v load and 4 threads share each q
// or p load. Each thread's register tile is 1 x 4 in both products, so an
// LDS.128 (four quarter-warp wavefronts) feeds 3-4 FMAs: shared-memory
// issue, not the FMA pipe, bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;        // q rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int DC = 64;        // columns per streamed chunk
constexpr int LDC = DC + 4;   // padded row of a chunk buffer
constexpr int LDP = BK + 4;   // padded row of the score / p tile
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest committed group are complete
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 4) + 2 * BK * LDC + BQ * LDP + 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          const int* __restrict__ kv_len, int n_heads, int lk,
                          long long q_sb, long long q_sl, long long q_sh,
                          long long k_sb, long long k_sl, long long k_sh,
                          long long v_sb, long long v_sl, long long v_sh,
                          long long o_sb, long long o_sl, long long o_sh) {
  constexpr int LDQ = D + 4;   // padded row of the q tile
  constexpr int NC = D / DC;   // chunks per k or v tile
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Cs = Qs + BQ * LDQ;          // two chunk buffers
  float* Ps = Cs + 2 * BK * LDC;      // scores, then p
  float* corr_s = Ps + BQ * LDP;
  float* l_s = corr_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // products: row of the q tile; 16-column group and sub-index in the chunk
  const int row = (warp >> 2) * 8 + (lane >> 2);
  const int grp = (warp & 3) * 16, sub = lane & 3;
  // softmax: 16 threads (a half warp) per row, 4 keys each
  const int srow = tid >> 4, sc = (tid & 15) * 4;

  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * BQ;
  const float* qp = q + b * q_sb + h * q_sh + (long long)q0 * q_sl;
  const float* kp = k + b * k_sb + h * k_sh;
  const float* vp = v + b * v_sb + h * v_sh;

  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int n_chunks = n_tiles * 2 * NC;

  // chunk g of the stream: tile g / (2 NC), k chunks then v chunks
  auto stage = [&](int g) {
    if (g < n_chunks) {
      const int t = g / (2 * NC), r = g % (2 * NC);
      const bool is_v = r >= NC;
      const int c0 = (is_v ? r - NC : r) * DC;
      const float* src = is_v ? vp : kp;
      const long long sl = is_v ? v_sl : k_sl;
      float* dst = Cs + (g & 1) * BK * LDC;
#pragma unroll
      for (int m = 0; m < BK * DC / 4 / NTHREADS; ++m) {
        const int i = tid + m * NTHREADS, rr = i / (DC / 4), cc = (i % (DC / 4)) * 4;
        cp_async16(dst + rr * LDC + cc, src + (long long)(t * BK + rr) * sl + c0 + cc);
      }
    }
    cp_async_commit();  // empty past the end: keeps one group per step
  };

  for (int i = tid; i < BQ * D / 4; i += NTHREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    cp_async16(Qs + r * LDQ + c, qp + r * q_sl + c);
  }
  stage(0);  // commits the q tile with chunk 0

  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;  // softmax state of row srow

  int g = 0;
  for (int t = 0; t < n_tiles; ++t) {
    // ---- S = Q K^T over the k chunks ------------------------------------
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < NC; ++c, ++g) {
      stage(g + 1);
      cp_async_wait_prev();
      __syncthreads();
      const float* Kc = Cs + (g & 1) * BK * LDC;
      const float* Qr = Qs + row * LDQ + c * DC;
#pragma unroll 4
      for (int d = 0; d < DC; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(Qr + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(Kc + (grp + sub + 4 * j) * LDC + d);
          s[j] = fmaf(qv.x, kv.x, s[j]);
          s[j] = fmaf(qv.y, kv.y, s[j]);
          s[j] = fmaf(qv.z, kv.z, s[j]);
          s[j] = fmaf(qv.w, kv.w, s[j]);
        }
      }
      __syncthreads();  // buffer g & 1 is refilled by stage(g + 2)
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = grp + sub + 4 * j;
      Ps[row * LDP + key] = t * BK + key < kv_end ? s[j] : NEG_INF;
    }
    __syncthreads();

    // ---- online softmax on the score tile ----------------------------------
    {
      float4 sv = *reinterpret_cast<const float4*>(Ps + srow * LDP + sc);
      float mc = fmaxf(fmaxf(sv.x, sv.y), fmaxf(sv.z, sv.w));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffff, mc, off));
      const float m_new = fmaxf(m_run, mc);
      sv.x = fast_exp2(sv.x - m_new);
      sv.y = fast_exp2(sv.y - m_new);
      sv.z = fast_exp2(sv.z - m_new);
      sv.w = fast_exp2(sv.w - m_new);
      float ps = (sv.x + sv.y) + (sv.z + sv.w);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffff, ps, off);
      const float corr = fast_exp2(m_run - m_new);
      l_run = l_run * corr + ps;
      m_run = m_new;
      *reinterpret_cast<float4*>(Ps + srow * LDP + sc) = sv;
      if ((tid & 15) == 0) corr_s[srow] = corr;
    }
    __syncthreads();

    // ---- O = corr * O + P V over the v chunks ------------------------------
    const float corr = corr_s[row];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] *= corr;
    const float* Pr = Ps + row * LDP;
#pragma unroll
    for (int c = 0; c < NC; ++c, ++g) {
      stage(g + 1);
      cp_async_wait_prev();
      __syncthreads();
      const float* Vc = Cs + (g & 1) * BK * LDC + grp + sub * 4;
#pragma unroll 4
      for (int j = 0; j < BK; j += 4) {
        const float4 p = *reinterpret_cast<const float4*>(Pr + j);
        const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(Vc + (j + jj) * LDC);
          acc[c][0] = fmaf(pj[jj], vv.x, acc[c][0]);
          acc[c][1] = fmaf(pj[jj], vv.y, acc[c][1]);
          acc[c][2] = fmaf(pj[jj], vv.z, acc[c][2]);
          acc[c][3] = fmaf(pj[jj], vv.w, acc[c][3]);
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait_all();

  if ((tid & 15) == 0) l_s[srow] = l_run;
  __syncthreads();
  const float l = l_s[row];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* op = o + b * o_sb + h * o_sh + (long long)(q0 + row) * o_sl + grp + sub * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float4 r;
    r.x = acc[c][0] * inv;
    r.y = acc[c][1] * inv;
    r.z = acc[c][2] * inv;
    r.w = acc[c][3] * inv;
    *reinterpret_cast<float4*>(op + c * DC) = r;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* kv_len,
                   int B, int N, int lq, int lk, const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_f32_kernel<D>;
  const int smem = (int)sizeof(float) * smem_floats<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(lq / BQ, B * N);
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
// 16-byte aligned. lq is a multiple of 16 and lk of 64. kv_len: int32 [B] on
// the device, or null. Running-max softmax; q arrives scale*log2e-folded.
// D is 384, 640 or 1024.
int univid_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                         const void* kv_len, int B, int N, int lq, int lk, int D,
                         const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lq % BQ != 0 || lk % BK != 0) return (int)cudaErrorInvalidValue;
  if (D == 384) return (int)launch<384>(q, k, v, o, kv_len, B, N, lq, lk, strides, s);
  if (D == 640) return (int)launch<640>(q, k, v, o, kv_len, B, N, lq, lk, strides, s);
  if (D == 1024) return (int)launch<1024>(q, k, v, o, kv_len, B, N, lq, lk, strides, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
