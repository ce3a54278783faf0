// int8 QK^T flash attention forward for Hopper (sm_90a): the qk_int8 mode of
// univid_tpu/kernels/flash_attention.py::_flash_kernel (:44; :104-105,
// :137-156, :213-233), the Wan serving knob --qk_int8. Two parts, which no
// route reaches any more: the pre-pass, replaced by kernel B of
// qk_prepass.cu (its same-call baseline _quantize_qk_int8_pair, counted as
// quantize_qk_int8_pair), and the attention kernel flash_fwd_int8_kernel,
// replaced by flash_attention_int8_sm90.cu (s8 wgmma, TMA multicast, warp
// specialisation; its same-call baseline _launch_int8_mma_sync, counted as
// flash_attention_int8[_sbf16]_mma_sync).
//
//   * the pre-pass (quant_q_kernel, quant_k_kernel) rotates q and k in fp32
//     with the fused-rope tables (q's fold softmax_scale * log2 e; without
//     tables q arrives folded in its own dtype and k as it is) and quantizes
//     straight from the fp32 rows, as the TPU kernel's prologue does:
//       q: per row, aq = max(max|q32|, 1e-30), codes round(q32 * (127 / aq))
//          (ties to even), scale sq = aq * (1 / 127);
//       k: one scale per (batch, head, kv block of the JAX kernel's block_k
//          keys), ak = max(max|k32|, 1e-30) over the whole block, rows past
//          kv_len included (the TPU kernel takes the block's max unmasked),
//          codes round(k32 * (127 / ak)), stored scale akq = ak * (1 / 127).
//     Rounding the rotation to bf16 first (the serving rope pre-pass) would
//     flip codes, so the rotation stays fp32 here, products and sum each
//     rounded once (no fused multiply-add), as on the TPU.
//   * flash_fwd_int8_kernel (the baseline): s32 = q_codes k_codes^T on the
//     int8 tensor cores (mma.sync m16n8k32 s8 x s8 -> s32, exact),
//     s = float(s32) * (sq_row *
//     akq_block) in that order, the kv_len mask on the fp32 s, then the
//     bounded or running-max softmax, fp32 or bf16 chain (the softmax_bf16
//     knob composed, bf16_tiles.cuh softmax_tile), and p v as the bf16 mma
//     on bf16 v. kv tiles past kv_len are never loaded; every 64-key tile
//     lies inside one JAX block, since block_k is a multiple of 64.
//
// What bounds it: at the ti2v-5B shape ([2, 28672, 24, 128], kv 27,280)
// QK^T at the int8 rate (1,979 TOPS) takes 4.86 ms and p v at the bf16 rate
// 9.72 ms: the tensor cores bound it, with half the bf16 kernel's QK^T time.
// The pre-pass moves bytes (two bf16 reads of k, one of q, int8 codes out).
//
// Design: the bf16 forward's (flash_attention.cu) with int8 operands: one
// block of 4 warps per (b*h, 64-row q tile), the q tile's codes kept as
// mma A fragments in registers, k codes and bf16 v streamed through
// XOR-swizzled shared memory with cp.async (v_j under q k_j^T, k_{j+1} under
// p v_j). An int8 row of 128 codes is 8 chunks of 16 bytes; ldmatrix reads
// 8 x 16-byte matrices whatever their element type, so the same fragment
// addressing serves both products. It reaches ~30% of its bound at the
// 5B shape; the sm90 kernel that replaced it is on wgmma and TMA.

#include "bf16_tiles.cuh"

namespace {

constexpr int D = 128;
constexpr float INV127 = (float)(1.0 / 127.0);   // the TPU kernel's 1.0 / 127.0
constexpr int QROWS = 8;                          // q rows per pre-pass block

// Byte offset of 16-byte chunk `c` of row `r` in a swizzled [rows, 128]
// int8 tile (8 chunks a row, chunk index XOR-ed with r % 8).
__device__ __forceinline__ int swz8(int r, int c) { return r * D + ((c ^ (r & 7)) << 4); }

// Copy a [64, 128] int8 tile (contiguous rows) into swizzled smem.
__device__ __forceinline__ void load_tile_i8(int8_t* dst, const int8_t* src, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * 8; i += NTHREADS) {
    int r = i >> 3, c = i & 7;
    cp_async16(dst + swz8(r, c), src + r * D + c * 16);
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's 4 values of row (b, l, h) (d = 4 * lane .. 4 * lane + 3) in
// fp32: rotated by the [L, D] tables when cf is set (y = x * cosF +
// swap_pairs(x) * sinF, the two products and the sum each rounded once),
// else x as it is.
__device__ __forceinline__ void row_values(float* y, const __nv_bfloat16* x, const float* cf,
                                           const float* sf, int l, int lane) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(x + 4 * lane);
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(x + 4 * lane + 2);
  const float xv[4] = {__bfloat162float(a.x), __bfloat162float(a.y), __bfloat162float(c.x),
                       __bfloat162float(c.y)};
  if (cf == nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = xv[i];
    return;
  }
  const float* cr = cf + (long long)l * D + 4 * lane;
  const float* sr = sf + (long long)l * D + 4 * lane;
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = __fadd_rn(__fmul_rn(xv[i], cr[i]), __fmul_rn(xv[i ^ 1], sr[i]));
}

__device__ __forceinline__ uint32_t quant4(const float* y, float r) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int code = __float2int_rn(__fmul_rn(y[i], r));
    packed |= (uint32_t)(code & 0xFF) << (8 * i);
  }
  return packed;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

// q: one warp per row; codes qi [B, N, L, D] and scales sq [B, N, L].
__global__ void quant_q_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ cf,
                               const float* __restrict__ sf, int8_t* __restrict__ qi,
                               float* __restrict__ sq, int L, int N, long long x_sb,
                               long long x_sl, long long x_sh, long long rows) {
  const long long row = (long long)blockIdx.x * QROWS + (threadIdx.x >> 5);  // over [B, N, L]
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int l = (int)(row % L);
  const long long bh = row / L;
  const int h = (int)(bh % N), b = (int)(bh / N);
  float y[4];
  row_values(y, x + b * x_sb + l * x_sl + h * x_sh, cf, sf, l, lane);
  float m = fmaxf(fmaxf(fabsf(y[0]), fabsf(y[1])), fmaxf(fabsf(y[2]), fabsf(y[3])));
  const float aq = fmaxf(warp_max(m), 1e-30f);
  *reinterpret_cast<uint32_t*>(qi + row * D + 4 * lane) = quant4(y, __fdiv_rn(127.f, aq));
  if (lane == 0) sq[row] = __fmul_rn(aq, INV127);
}

// k: one block per (kv block of bw rows, b * N + h); a first sweep takes the
// block's max |k32|, a second writes the codes. Codes ki [B, N, L, D], scales
// akq [B, N, nblk].
__global__ void quant_k_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ cf,
                               const float* __restrict__ sf, int8_t* __restrict__ ki,
                               float* __restrict__ akq, int L, int N, int bw, long long x_sb,
                               long long x_sl, long long x_sh) {
  __shared__ float wmax[NTHREADS / 32];
  const int blk = blockIdx.x, bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blk * bw, r1 = min(r0 + bw, L);
  const __nv_bfloat16* xp = x + b * x_sb + h * x_sh;
  float m = 0.f;
  for (int l = r0 + warp; l < r1; l += NTHREADS / 32) {
    float y[4];
    row_values(y, xp + l * x_sl, cf, sf, l, lane);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(y[0]), fabsf(y[1])), fmaxf(fabsf(y[2]), fabsf(y[3]))));
  }
  m = warp_max(m);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) m = fmaxf(m, wmax[w]);
  const float ak = fmaxf(m, 1e-30f);
  const float r = __fdiv_rn(127.f, ak);
  if (threadIdx.x == 0) akq[(long long)bh * gridDim.x + blk] = __fmul_rn(ak, INV127);
  int8_t* kp = ki + (long long)bh * L * D;
  for (int l = r0 + warp; l < r1; l += NTHREADS / 32) {
    float y[4];
    row_values(y, xp + l * x_sl, cf, sf, l, lane);
    *reinterpret_cast<uint32_t*>(kp + (long long)l * D + 4 * lane) = quant4(y, r);
  }
}

template <int MODE, bool SBF16>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_int8_kernel(const int8_t* __restrict__ qi, const float* __restrict__ sq,
                      const int8_t* __restrict__ ki, const float* __restrict__ akq,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      const int* __restrict__ kv_len, const float* __restrict__ bound,
                      int n_heads, int lq, int lk, int bw, int nblk, long long v_sb,
                      long long v_sl, long long v_sh, long long o_sb, long long o_sl,
                      long long o_sh) {
  constexpr int KS = D / 32;   // k-steps of the int8 product (32 codes each)
  constexpr int NT = BC / 8;   // n-tiles of s per warp
  constexpr int OT = D / 8;    // n-tiles of the output per warp

  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Ks = Qs + BR * D;
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Ks + BC * D);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * BR;
  const int8_t* kp = ki + (long long)bh * lk * D;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const float* akp = akq + (long long)bh * nblk;

  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + BC - 1) / BC;
  const float c_bound = (MODE == BOUNDED) ? *bound : 0.f;  // folded score bound
  // the row scales of this thread's rows g and g + 8
  const float* sqp = sq + (long long)bh * lq + q0 + warp * 16 + g;
  const float sq_r[2] = {sqp[0], sqp[8]};

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float l_r[2] = {0.f, 0.f};
  float m_r[2] = {NEG_INF, NEG_INF};

  uint32_t qa[KS][4];
  if (n_tiles > 0) {
    load_tile_i8(Qs, qi + ((long long)bh * lq + q0) * D, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      int r = warp * 16 + (lane & 15);
      int c = kk * 2 + (lane >> 4);
      ldmatrix_x4(qa[kk], Qs + swz8(r, c));
    }
    load_tile_i8(Ks, kp, tid);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BC;
    cp_async_wait_all();
    __syncthreads();  // k_j landed; every warp is done with v_{j-1}
    load_tile<D>(Vs, vp + (long long)kv0 * v_sl, v_sl, tid);
    cp_async_commit();

    int s32[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s32[n][jj] = 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        int mi = lane >> 3, rr = lane & 7;
        int r = np * 16 + (mi >> 1) * 8 + rr;
        int c = kk * 2 + (mi & 1);
        ldmatrix_x4(bfr, Ks + swz8(r, c));
        mma_s8(s32[2 * np], qa[kk], bfr[0], bfr[1]);
        mma_s8(s32[2 * np + 1], qa[kk], bfr[2], bfr[3]);
      }
    }
    // s = float(s32) * (sq * (ak / 127)), the TPU kernel's order; the
    // kv_len mask goes on the fp32 scores
    const float ak = akp[kv0 / bw];
    const float fac[2] = {__fmul_rn(sq_r[0], ak), __fmul_rn(sq_r[1], ak)};
    const bool tail = kv0 + BC > kv_end;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[n][jj] = __fmul_rn(__int2float_rn(s32[n][jj]), fac[jj >> 1]);
        if (tail && kv0 + n * 8 + 2 * t + (jj & 1) >= kv_end) s[n][jj] = NEG_INF;
      }

    softmax_tile<MODE, SBF16, false, NT, OT>(s, m_r, l_r, acc, c_bound);

    cp_async_wait_all();
    __syncthreads();  // v_j landed; every warp is done with k_j
    if (j + 1 < n_tiles) {
      load_tile_i8(Ks, kp + (long long)(kv0 + BC) * D, tid);
      cp_async_commit();
    }
    pv_tile<D>(acc, s, Vs, lane);
  }

  store_rows<MODE, OT>(acc, l_r, m_r, c_bound, nullptr,
                       o + b * o_sb + h * o_sh + (long long)(q0 + warp * 16) * o_sl, o_sl, g, t);
}

template <int MODE, bool SBF16>
cudaError_t launch(const void* qi, const void* sq, const void* ki, const void* akq,
                   const void* v, void* o, const void* kv_len, const void* bound, int B, int N,
                   int lq, int lk, int bw, const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_int8_kernel<MODE, SBF16>;
  const int smem = (BR + BC) * D + BC * D * (int)sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nblk = (lk + bw - 1) / bw;
  dim3 grid(lq / BR, B * N);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(sq),
      static_cast<const int8_t*>(ki), static_cast<const float*>(akq),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(kv_len), static_cast<const float*>(bound), N, lq, lk, bw, nblk,
      st[0], st[1], st[2], st[3], st[4], st[5]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q pre-pass. x: bf16 [B, L, N, 128] (element strides x_sb, x_sl, x_sh,
// unit along D, even); cf, sf: fp32 [L, 128] rope tables (the q pair, with
// the fold) or both null (x already folded). qi: int8 [B, N, L, 128]
// contiguous; sq: fp32 [B, N, L].
int univid_quant_q_int8(const void* x, const void* cf, const void* sf, void* qi, void* sq,
                        int B, int L, int N, int Dh, long long x_sb, long long x_sl,
                        long long x_sh, void* stream) {
  if (Dh != D || (cf == nullptr) != (sf == nullptr)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * N * L;
  quant_q_kernel<<<(unsigned)((rows + QROWS - 1) / QROWS), QROWS * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(cf),
      static_cast<const float*>(sf), static_cast<int8_t*>(qi), static_cast<float*>(sq), L, N,
      x_sb, x_sl, x_sh, rows);
  return (int)cudaGetLastError();
}

// k pre-pass: as the q pre-pass with the k tables (unscaled) or none; one
// scale per (b, h, block of bw rows): akq fp32 [B, N, ceil(L / bw)].
int univid_quant_k_int8(const void* x, const void* cf, const void* sf, void* ki, void* akq,
                        int B, int L, int N, int Dh, int bw, long long x_sb, long long x_sl,
                        long long x_sh, void* stream) {
  if (Dh != D || bw <= 0 || (cf == nullptr) != (sf == nullptr)) return (int)cudaErrorInvalidValue;
  dim3 grid((L + bw - 1) / bw, B * N);
  quant_k_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(cf),
      static_cast<const float*>(sf), static_cast<int8_t*>(ki), static_cast<float*>(akq), L, N,
      bw, x_sb, x_sl, x_sh);
  return (int)cudaGetLastError();
}

// The attention. qi, sq, ki, akq: the pre-passes' outputs (lq, lk multiples
// of 64; bw, the k scale's block width, a multiple of 64); v, o: bf16
// [B, L, N, 128], element strides st = (v_b, v_l, v_h, o_b, o_l, o_h), unit
// along D. kv_len: int32 [B] on the device, or null. mode: 0 bounded (*bound,
// the folded score bound, fp32 on the device), 1 running max.
// softmax_bf16: the bf16 softmax chain.
int univid_flash_fwd_int8(const void* qi, const void* sq, const void* ki, const void* akq,
                          const void* v, void* o, const void* kv_len, const void* bound,
                          int mode, int softmax_bf16, int B, int N, int lq, int lk, int bw,
                          const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lq % BR != 0 || lk % BC != 0 || bw <= 0 || bw % BC != 0 ||
      (mode == BOUNDED && bound == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == BOUNDED)
    return softmax_bf16
               ? (int)launch<BOUNDED, true>(qi, sq, ki, akq, v, o, kv_len, bound, B, N, lq, lk, bw, strides, s)
               : (int)launch<BOUNDED, false>(qi, sq, ki, akq, v, o, kv_len, bound, B, N, lq, lk, bw, strides, s);
  if (mode == RUNNING)
    return softmax_bf16
               ? (int)launch<RUNNING, true>(qi, sq, ki, akq, v, o, kv_len, bound, B, N, lq, lk, bw, strides, s)
               : (int)launch<RUNNING, false>(qi, sq, ki, akq, v, o, kv_len, bound, B, N, lq, lk, bw, strides, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
