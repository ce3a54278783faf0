// Flash attention backward for Hopper (sm_90a), fp32 at d=128, on CUDA
// cores: the SAME-CALL BASELINE of flash_attention_f32_sm90.cu's dq and
// dk/dv kernels, which took every fp32 d=128 backward (the full DiT
// fine-tune at its default fp32 policy) onto the tensor cores at fp32
// accuracy. No route reaches these kernels: chip_smoke.py and the card
// tests time and check them beside the new ones (flash_attention.py's
// `_bwd_dq_f32` / `_bwd_dkv_f32`, counters flash_attention_bwd_dq_f32 /
// flash_attention_bwd_dkv_f32).
//
// They compute, at fp32 and d=128 with kv_len masking, the Pallas backward
// kernels of univid_tpu/kernels/flash_attention.py, which rebuild p from
// the forward's exp2-domain lse (p = exp2(qs k^T - lse), qs = q * scale *
// log2e) and compute, with delta = rowsum(dO * O) and dS = p * (dO v^T -
// delta), dq = scale * dS k, dk = ln2 * dS^T qs, dv = p^T dO:
//   * _flash_bwd_dq_kernel (:831)   -> flash_bwd_dq_f32_kernel (it also
//     writes delta, the pre-pass the dk/dv kernel reads);
//   * _flash_bwd_dkv_kernel (:940)  -> flash_bwd_dkv_f32_kernel;
//   * _flash_bwd_fused_kernel (:1057) -> the pair back to back, as in the
//     bf16 pair (flash_attention_bwd.cu says why a GPU grid has no one-pass
//     counterpart without atomics).
// Keys at or past kv_len get -1e30 before p = exp2(s - lse); rows with no
// live key carry the forward's lse sentinel +1e30, so their p is 0. Every
// rounding is to fp32, as in the plain version: none beyond the products'
// own. No atomics: every output element is written by exactly one block,
// so the pair is deterministic. The masked modes (causal, segments, packed,
// grouped kv heads) have no fp32 caller and no mode here.
//
// What bounds it: at the t2v-1.3B training shape [1, 32768, 12, 128], kv
// 32,760, the dq kernel does 3 products of 2 Lq Lk d flops per head (9.9
// TFLOP, 148 ms at the 67 TFLOP/s fp32 peak) and the dk/dv kernel 4 (13.2
// TFLOP, 197 ms): operations. At the cross shape (Lk = 512) the dk/dv grid
// has 8 x B*N blocks, fewer than the card's 132 SMs, each sweeping every q
// tile: it is bound by its grid's parallelism.
//
// Design (fp32_tiles.cuh has the register-tiled FFMA products; 256 threads,
// 64-row tiles, RM = 4):
//   dq  kernel: one block per (b*h, 64-row q tile). qs and dO stay in
//       shared memory; k and v tiles stream through one buffer each, by
//       cp.async: k_j loads while dP = dO v_j^T runs, v_{j+1} while S = qs
//       k_j^T and dQ += dS k_j run. delta is computed once per q tile, from
//       dO in shared memory and O read once from device memory.
//   dkv kernel: one block per (b*h, 64-row kv tile). k and v stay in shared
//       memory; qs, dO, lse and delta tiles stream through: q_i loads while
//       dP^T = v dO_i^T runs, dO_{i+1} while dK += dS^T qs_i runs. It
//       computes the transposed products (S^T = k qs^T, dP^T = v dO^T), so
//       that P^T and dS^T are the left operands of dV += P^T dO and dK +=
//       dS^T qs. The dk and dv accumulators are 2 x 64 x 128 fp32 a block,
//       64 registers a thread. kv tiles wholly at or past kv_len are written
//       as zeros.
// Shared memory: dq 4 x 64 x 132 + 64 x 68 floats + 512 B (150 KB); dk/dv
// 4 x 64 x 132 + 2 x 64 x 68 floats + 512 B (167 KB). One block an SM.
//
// ptxas (sm_90a): dq 168 registers, dk/dv 226, 0 bytes spilled. Times at
// the training shape (NVIDIA H100 80GB HBM3, 700 W): dq 289.4 ms, dk/dv
// 371.5 ms, 51% and 53% of the fp32 peak.

#include "fp32_tiles.cuh"

using namespace f32tile;

namespace {

constexpr float LN2 = 0.6931471805599453f;
constexpr int RM = 4;   // 64 rows a tile: 16 row groups x 4

struct Strides {
  long long b, l, h;
};

// ---------------------------------------------------------------------------
// dq (+ delta): grid (Lq / 64, B * N)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const int* __restrict__ kv_len, float* __restrict__ dq,
                        float* __restrict__ delta, int n_heads, int lq, int lk, float scale,
                        Strides sq, Strides sk, Strides sv, Strides so, Strides sdo,
                        Strides sdq) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;               // [64, LD]
  float* Ds = Qs + BT * LD;     // dO [64, LD]
  float* Ks = Ds + BT * LD;     // [64, LD]
  float* Vs = Ks + BT * LD;     // [64, LD]
  float* Ss = Vs + BT * LD;     // dS [64, LDP]
  float* lse_s = Ss + BT * LDP;
  float* delta_s = lse_s + BT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * BT;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + BT - 1) / BT;

  load_tile<BT>(Qs, q + b * sq.b + h * sq.h + (long long)q0 * sq.l, sq.l, BT, tid);
  load_tile<BT>(Ds, dout + b * sdo.b + h * sdo.h + (long long)q0 * sdo.l, sdo.l, BT, tid);
  load_row64(lse_s, lse + (long long)bh * lq + q0, tid);
  if (n_tiles > 0) load_tile<BT>(Vs, vp, sv.l, BT, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // delta_r = sum_d dO_rd * O_rd in fp32: 4 threads a row, O read once
  {
    const int r = tid >> 2, part = (tid & 3) * 32;
    const float* orow = o + b * so.b + h * so.h + (long long)(q0 + r) * so.l + part;
    const float* drow = Ds + r * LD + part;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 32; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(orow + c);
      const float4 g = *reinterpret_cast<const float4*>(drow + c);
      acc = fmaf(g.x, a.x, acc);
      acc = fmaf(g.y, a.y, acc);
      acc = fmaf(g.z, a.z, acc);
      acc = fmaf(g.w, a.w, acc);
    }
    acc += __shfl_xor_sync(0xffffffff, acc, 1);
    acc += __shfl_xor_sync(0xffffffff, acc, 2);
    if ((tid & 3) == 0) {
      delta_s[r] = acc;
      delta[(long long)bh * lq + q0 + r] = acc;
    }
  }
  __syncthreads();
  float lse_r[RM], dl_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    lse_r[i] = lse_s[ty + 16 * i];
    dl_r[i] = delta_s[ty + 16 * i];
  }

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BT;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();   // v_j landed; every thread is done with k_{j-1} and dS
    }
    load_tile<BT>(Ks, kp + (long long)kv0 * sk.l, sk.l, BT, tid);
    cp_async_commit();

    float dp[RM][4];
    prod_xyt<RM>(dp, Ds, Vs, ty, tx);   // dP = dO v_j^T

    cp_async_wait_all();
    __syncthreads();   // k_j landed; every thread is done with v_j
    if (j + 1 < n_tiles) {
      load_tile<BT>(Vs, vp + (long long)(kv0 + BT) * sv.l, sv.l, BT, tid);
      cp_async_commit();
    }

    float s[RM][4];
    prod_xyt<RM>(s, Qs, Ks, ty, tx);    // S = qs k_j^T
    const bool tail = kv0 + BT > kv_end;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float x = (tail && kv0 + tx + 16 * jj >= kv_end) ? NEG_INF : s[i][jj];
        const float p = fast_exp2(x - lse_r[i]);
        Ss[(ty + 16 * i) * LDP + tx + 16 * jj] = p * (dp[i][jj] - dl_r[i]);
      }
    __syncthreads();   // dS is complete
    prod_pz<RM>(acc, Ss, Ks, ty, tx);   // dQ += dS k_j
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < RM; ++i)
    store_row8(dqb + (long long)(q0 + ty + 16 * i) * sdq.l, acc[i], scale, tx);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (Lk / 64, B * N)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kv_len, float* __restrict__ dk,
                         float* __restrict__ dv, int n_heads, int lq, int lk, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;               // [64, LD], resident
  float* Vs = Ks + BT * LD;     // [64, LD], resident
  float* Qs = Vs + BT * LD;     // q tile [64, LD]
  float* Ds = Qs + BT * LD;     // dO tile [64, LD]
  float* Pt = Ds + BT * LD;     // P^T [64 kv, LDP]
  float* St = Pt + BT * LDP;    // dS^T [64 kv, LDP]
  float* lse_s = St + BT * LDP;
  float* dl_s = lse_s + BT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int kv0 = blockIdx.x * BT;
  const int n_q = lq / BT;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;

  if (kv0 >= kv_end) {   // every p of this tile is 0: dk = dv = 0
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < BT * (D / 4); i += NTHREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(dkb + (long long)(kv0 + r) * sdk.l + c) = z;
      *reinterpret_cast<float4*>(dvb + (long long)(kv0 + r) * sdv.l + c) = z;
    }
    return;
  }

  const float* qp = q + b * sq.b + h * sq.h;
  const float* dop = dout + b * sdo.b + h * sdo.h;
  const float* lsep = lse + (long long)bh * lq;
  const float* dlp = delta + (long long)bh * lq;

  load_tile<BT>(Ks, k + b * sk.b + h * sk.h + (long long)kv0 * sk.l, sk.l, BT, tid);
  load_tile<BT>(Vs, v + b * sv.b + h * sv.h + (long long)kv0 * sv.l, sv.l, BT, tid);
  load_tile<BT>(Ds, dop, sdo.l, BT, tid);
  cp_async_commit();

  // this thread's kv rows kv0 + ty + 16 i: live below kv_end (the tail tile)
  bool live[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) live[i] = kv0 + ty + 16 * i < kv_end;

  float dk_acc[RM][8], dv_acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const long long qn = (long long)t * BT;
    cp_async_wait_all();
    __syncthreads();   // dO_t landed; every thread is done with q_{t-1}, P^T, dS^T
    load_tile<BT>(Qs, qp + qn * sq.l, sq.l, BT, tid);
    load_row64(lse_s, lsep + qn, tid);
    load_row64(dl_s, dlp + qn, tid);
    cp_async_commit();

    float dpt[RM][4];
    prod_xyt<RM>(dpt, Vs, Ds, ty, tx);   // dP^T = v dO_t^T

    cp_async_wait_all();
    __syncthreads();   // q_t, lse and delta landed
    float st[RM][4];
    prod_xyt<RM>(st, Ks, Qs, ty, tx);    // S^T = k qs_t^T
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;        // the q row of this column
      const float l_c = lse_s[c], d_c = dl_s[c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = fast_exp2((live[i] ? st[i][jj] : NEG_INF) - l_c);
        Pt[(ty + 16 * i) * LDP + c] = p;
        St[(ty + 16 * i) * LDP + c] = p * (dpt[i][jj] - d_c);
      }
    }
    __syncthreads();   // P^T and dS^T are complete
    prod_pz<RM>(dv_acc, Pt, Ds, ty, tx);   // dV += P^T dO_t
    __syncthreads();   // every thread is done with dO_t
    if (t + 1 < n_q) {
      load_tile<BT>(Ds, dop + (qn + BT) * sdo.l, sdo.l, BT, tid);
      cp_async_commit();
    }
    prod_pz<RM>(dk_acc, St, Qs, ty, tx);   // dK += dS^T qs_t
  }

  // dk was accumulated against the folded qs: dk_raw = ln2 * dS^T qs
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long row = kv0 + ty + 16 * i;
    store_row8(dkb + row * sdk.l, dk_acc[i], LN2, tx);
    store_row8(dvb + row * sdv.l, dv_acc[i], 1.f, tx);
  }
}

Strides st3(const long long* p) { return Strides{p[0], p[1], p[2]}; }

constexpr int DQ_SMEM = (int)sizeof(float) * (4 * BT * LD + BT * LDP + 2 * BT);
constexpr int DKV_SMEM = (int)sizeof(float) * (4 * BT * LD + 2 * BT * LDP + 2 * BT);

}  // namespace

extern "C" {

// All fp32 [B, L, N, 128] tensors with element strides (b, l, h) per tensor
// in `strides`, unit stride along D, multiples of 4 and 16-byte aligned
// rows; lq and lk multiples of 64. lse: fp32 [B, N, lq] from the forward;
// kv_len: int32 [B] on the device, or null.

// dq [B, lq, N, D] and delta (fp32 [B, N, lq], contiguous) from q (folded
// by scale * log2e), k, v, o, dO. strides: q, k, v, o, dO, dq.
int univid_flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, const void* kv_len, void* dq,
                            void* delta, int B, int N, int lq, int lk, float scale,
                            const long long* st, void* stream) {
  if (lq % BT != 0 || lk % BT != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lq / BT, B * N);
  flash_bwd_dq_f32_kernel<<<grid, NTHREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const int*>(kv_len), static_cast<float*>(dq),
      static_cast<float*>(delta), N, lq, lk, scale, st3(st), st3(st + 3), st3(st + 6),
      st3(st + 9), st3(st + 12), st3(st + 15));
  return (int)cudaGetLastError();
}

// dk, dv [B, lk, N, D] from q (folded), k, v, dO, lse and the dq kernel's
// delta. strides: q, k, v, dO, dk, dv.
int univid_flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kv_len, void* dk,
                             void* dv, int B, int N, int lq, int lk, const long long* st,
                             void* stream) {
  if (lq % BT != 0 || lk % BT != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lk / BT, B * N);
  flash_bwd_dkv_f32_kernel<<<grid, NTHREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(kv_len), static_cast<float*>(dk),
      static_cast<float*>(dv), N, lq, lk, st3(st), st3(st + 3), st3(st + 6), st3(st + 9),
      st3(st + 12), st3(st + 15));
  return (int)cudaGetLastError();
}

}  // extern "C"
