// Flash attention backward for Hopper (sm_90a): bf16 in, fp32 accumulators.
//
// Replaces the three Pallas TPU backward kernels of
// univid_tpu/kernels/flash_attention.py, all of which rebuild p from the
// forward's exp2-domain lse (p = exp2(qs k^T - lse), qs = q * scale * log2e
// rounded to q's dtype) and compute, with delta = rowsum(dO * O) and
// dS = p * (dO v^T - delta),
//     dq = scale * dS k,   dk = ln2 * dS^T qs,   dv = p^T dO:
//   * _flash_bwd_dkv_kernel (:940)   -> flash_bwd_dkv_kernel below;
//   * _flash_bwd_dq_kernel (:831)    -> flash_bwd_dq_kernel below;
//   * _flash_bwd_fused_kernel (:1057), the one-pass form that keeps dk and
//     dv resident in VMEM for the whole sweep -> the pair together. Blocks
//     of a GPU grid run in no order and share no scratch, so a dk/dv tile is
//     block-local here and the one pass has no direct counterpart; its
//     5-instead-of-7 matmul saving (dq by fp32 atomics inside the dk/dv
//     kernel) is later performance work.
// The pair is deterministic: no atomics, every output element is written by
// exactly one block.
//
// Masks (the shared predicate `_mask_scores` :794-828, which must match the
// forward's): keys at or past kv_len; causal, with a static q_offset and a
// device q_offsets [B] (query i sees key c iff c <= i + q_offset +
// q_offsets[b]); segment ids (q_seg [B, Lq] == kv_seg [B, Lk]); and the
// packed mode on pack_mask_codes codes (BAGEL packed training:
//   (row >= col || (fn_q == fn_k && fn_q > 0))
//   && !(nz_k > 0 && nz_q != nz_k) && doc_q == doc_k,
// row and col the pack's own indices). A template flag each. Causal skips
// dead tiles on both sides: the dq kernel never loads a kv tile past its q
// tile's last row, the dk/dv kernel starts at the first q tile whose last
// row reaches its kv tile (and writes zeros when none does). The segment
// and packed modes visit every tile below kv_len, as the TPU kernels do.
// Masked scores are -1e30 before p = exp2(s - lse); rows with no live key
// carry the forward's lse sentinel +1e30, so their p is 0 either way.
//
// What bounds it: at the DiT self-attention shape (Lq = Lk = 32768, d=128)
// the work is 7 products of 2*Lq*Lk*d flops per head (3 in dq, 4 in dk/dv)
// against ~10 bytes per (row, d) element: the tensor cores bound it. At the
// cross shape (Lk = 512) the dk/dv kernel has only Lk/64 * B*N blocks, fewer
// than the card's SMs, each looping over all q tiles: it is bound by its
// grid's parallelism. In the packed mode every tile is computed and masked
// while 22% of the training pack's tiles hold a live pair, so the kernels
// do ~5x the work of their live-pair bound.
//
// Design (FA2-style, simple first): 4 warps per block, bf16 mma.sync
// m16n8k16 with fp32 accumulators, 64-row tiles in shared memory with the
// XOR swizzle of flash_attention.cu, fed by cp.async.
//   dq  kernel: one block per (b*h, 64-row q tile); qs and dO stay in shared
//       memory, k and v tiles stream through (k double-buffered so that
//       k_{j+1} loads while dS k_j runs); each warp owns 16 q rows and keeps
//       its dq rows in registers. It also computes delta for its q tile
//       (from dO and O, once) and writes it to a small fp32 [B, N, Lq]
//       buffer: the pre-pass that the dk/dv kernel reads.
//   dkv kernel: one block per (b*h, 64-row kv tile); k and v stay in shared
//       memory, qs / dO / lse / delta tiles stream through two buffers; each
//       warp owns 16 kv rows and keeps their dk and dv (2 x 16 x 128 fp32)
//       in registers. It computes the transposed products
//       s^T = k qs^T and dp^T = v dO^T, so that p^T and dS^T are already the
//       A operands of dv += p^T dO and dk += dS^T qs. kv tiles wholly at or
//       past kv_len are skipped and written as zeros.
// Rounding points as on the TPU: p to dO's dtype before p^T dO, dS to k's
// dtype before dS k and to q's dtype before dS^T qs; outputs rounded once.
// Not yet used: wgmma, TMA, warp specialisation (later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;      // q rows per tile
constexpr int BC = 64;      // kv rows per tile
constexpr int D = 128;      // head dim
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
enum Seg { NO_SEG = 0, SEGMENTS = 1, PACKED = 2 };

constexpr int KS = D / 16;  // k-steps of a product over d
constexpr int NT = 64 / 8;  // n-tiles of a 16 x 64 score fragment
constexpr int OT = D / 8;   // n-tiles of a 16 x d accumulator

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// BAGEL's packed-training predicate on pack_mask_codes codes (arithmetic
// shifts: pad ids -1 / -2 give doc -1 and fn 255 and never pass it)
__device__ __forceinline__ bool packed_allowed(int qc, int kc, int row, int col) {
  const int fn_q = (qc >> 8) & 0xFF, fn_k = (kc >> 8) & 0xFF;
  const int nz_q = qc & 0xFF, nz_k = kc & 0xFF;
  return (row >= col || (fn_q == fn_k && fn_q > 0)) && !(nz_k > 0 && nz_q != nz_k) &&
         (qc >> 16) == (kc >> 16);
}

// Whether the score of a query (code qc, pack row `row` = q index,
// absolute causal row `arow`) and a key (code kc, index `col`) is masked.
template <bool CAUSAL, int SEG>
__device__ __forceinline__ bool masked(int row, int arow, int col, int kv_end, int qc, int kc) {
  bool dead = col >= kv_end;
  if (CAUSAL) dead = dead || col > arow;
  if (SEG == SEGMENTS) dead = dead || qc != kc;
  if (SEG == PACKED) dead = dead || !packed_allowed(qc, kc, row, col);
  return dead;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Element offset of 16-byte chunk `c` of row `r` in a swizzled [rows, D]
// bf16 tile (D/8 chunks per row, chunk index XOR-ed with r % 8).
__device__ __forceinline__ int swz(int r, int c) { return r * D + ((c ^ (r & 7)) << 3); }

// Copy a [64, D] bf16 tile (row stride `ld` elements) into swizzled smem.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < 64 * CH; i += NTHREADS) {
    int r = i / CH, c = i % CH;
    cp_async16(dst + swz(r, c), src + r * ld + c * 8);
  }
}

// 64 contiguous 4-byte values (16-byte aligned) into smem.
template <typename T>
__device__ __forceinline__ void load_row64(T* dst, const T* src, int tid) {
  if (tid < 16) cp_async16(dst + tid * 4, src + tid * 4);
}

// acc[16 x 64] = A[16 rows of this warp, D] * B[64 rows, D]^T, both swizzled
// [*, D] tiles in smem (A rows start at a_row0).
__device__ __forceinline__ void mma_abt(float (*acc)[4], const __nv_bfloat16* A, int a_row0,
                                        const __nv_bfloat16* B, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, A + swz(a_row0 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[4];
      int mi = lane >> 3, rr = lane & 7;
      ldmatrix_x4(bfr, B + swz(np * 16 + (mi >> 1) * 8 + rr, kk * 2 + (mi & 1)));
      mma_bf16(acc[2 * np], a, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], a, bfr[2], bfr[3]);
    }
  }
}

// acc[16 x D] += P[16 x 64] (fp32 fragments, rounded to bf16 here) * B[64, D]
// with B a swizzled [64, D] tile in smem (read transposed by ldmatrix).
__device__ __forceinline__ void mma_pb(float (*acc)[4], const float (*p)[4],
                                       const __nv_bfloat16* B, int lane) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bfr[4];
      int mi = lane >> 3, rr = lane & 7;
      ldmatrix_x4_trans(bfr, B + swz(kk * 16 + (mi & 1) * 8 + rr, dp * 2 + (mi >> 1)));
      mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
      mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
    }
  }
}

// Write a warp's [16, D] fp32 accumulator, times `mul`, as bf16 rows.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld, const float (*acc)[4],
                                           float mul, int g, int t) {
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    int col = n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)g * ld + col) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)(g + 8) * ld + col) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

struct Strides {
  long long b, l, h;
};

// ---------------------------------------------------------------------------
// dq (+ delta): grid (Lq / 64, B * N)
// ---------------------------------------------------------------------------
template <bool CAUSAL, int SEG>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ kv_len, const int* __restrict__ q_offsets,
                    int q_offset, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int n_heads,
                    int lq, int lk, float scale, Strides sq, Strides sk, Strides sv, Strides so,
                    Strides sdo, Strides sdq) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ds = Qs + BR * D;     // dO tile
  __nv_bfloat16* Ks0 = Ds + BR * D;    // k double buffer
  __nv_bfloat16* Ks1 = Ks0 + BC * D;
  __nv_bfloat16* Vs = Ks1 + BC * D;    // holds O before the loop
  float* delta_s = reinterpret_cast<float*>(Vs + BC * D);
  int* Kc = reinterpret_cast<int*>(delta_s + BR);   // [2][BC] kv codes, with k

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * BR;

  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;
  const int* ksp = SEG != NO_SEG ? kv_seg + (long long)b * lk : nullptr;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  int n_tiles = (kv_end + BC - 1) / BC;
  // causal: absolute row of the tile's first query; kv tiles past its last
  // row are dead for the whole tile
  int row0 = 0;
  if (CAUSAL) {
    row0 = q0 + q_offset + (q_offsets != nullptr ? q_offsets[b] : 0);
    n_tiles = min(n_tiles, (max(row0 + BR, 0) + BC - 1) / BC);
  }
  // the codes of this thread's query rows g and g + 8
  int qc[2] = {0, 0};
  if (SEG != NO_SEG) {
    const int* qsp = q_seg + (long long)b * lq + q0 + warp * 16 + g;
    qc[0] = qsp[0];
    qc[1] = qsp[8];
  }
  auto load_k = [&](__nv_bfloat16* dst, int j) {
    load_tile(dst, kp + (long long)j * BC * sk.l, sk.l, tid);
    if (SEG != NO_SEG) load_row64(Kc + (j & 1) * BC, ksp + j * BC, tid);
  };

  load_tile(Qs, q + b * sq.b + h * sq.h + (long long)q0 * sq.l, sq.l, tid);
  load_tile(Ds, dout + b * sdo.b + h * sdo.h + (long long)q0 * sdo.l, sdo.l, tid);
  load_tile(Vs, o + b * so.b + h * so.h + (long long)q0 * so.l, so.l, tid);
  if (n_tiles > 0) load_k(Ks0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // delta_i = sum_d dO_id * O_id in fp32, one thread per row
  if (tid < BR) {
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 8; ++c) {
      const __nv_bfloat162* dr = reinterpret_cast<const __nv_bfloat162*>(Ds + swz(tid, c));
      const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(Vs + swz(tid, c));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 a = __bfloat1622float2(dr[e]);
        float2 bb = __bfloat1622float2(orow[e]);
        acc = fmaf(a.x, bb.x, acc);
        acc = fmaf(a.y, bb.y, acc);
      }
    }
    delta_s[tid] = acc;
    delta[(long long)bh * lq + q0 + tid] = acc;
  }
  __syncthreads();  // delta_s written; every thread is done with O in Vs

  const int r0 = warp * 16 + g;
  const float lse_r[2] = {lse[(long long)bh * lq + q0 + r0], lse[(long long)bh * lq + q0 + r0 + 8]};
  const float dl_r[2] = {delta_s[r0], delta_s[r0 + 8]};

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const __nv_bfloat16* Kt = (j & 1) ? Ks1 : Ks0;
    __nv_bfloat16* Kn = (j & 1) ? Ks0 : Ks1;
    if (j > 0) {
      cp_async_wait<0>();
      __syncthreads();  // k_j landed; every warp is done with v_{j-1}, k_{j-1}
    }
    load_tile(Vs, vp + (long long)j * BC * sv.l, sv.l, tid);
    cp_async_commit();
    const bool more = j + 1 < n_tiles;
    if (more) {
      load_k(Kn, j + 1);
      cp_async_commit();
    }

    // p = exp2(qs k_j^T - lse), masked keys at -1e30; only kv_len-tail,
    // causal-diagonal and segment / packed tiles pay the compare
    float s[NT][4];
    mma_abt(s, Qs, warp * 16, Kt, lane);
    const int kv0 = j * BC;
    const int* kcj = Kc + (j & 1) * BC;
    const bool check = kv0 + BC > kv_end || (CAUSAL && kv0 + BC - 1 > row0) || SEG != NO_SEG;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        const int c = n * 8 + 2 * t + (e & 1), r = warp * 16 + g + 8 * (e >> 1);
        if (check && masked<CAUSAL, SEG>(q0 + r, row0 + r, kv0 + c, kv_end, qc[e >> 1],
                                         SEG != NO_SEG ? kcj[c] : 0))
          x = NEG_INF;
        s[n][e] = fast_exp2(x - lse_r[e >> 1]);
      }

    if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();  // v_j landed

    // dS = p * (dO v_j^T - delta)
    float dp[NT][4];
    mma_abt(dp, Ds, warp * 16, Vs, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - dl_r[e >> 1]);

    // dq += dS k_j
    mma_pb(acc, dp, Kt, lane);
  }

  store_rows(dq + b * sdq.b + h * sdq.h + (long long)(q0 + warp * 16) * sdq.l, sdq.l, acc, scale,
             g, t);
}

// ---------------------------------------------------------------------------
// dk, dv: grid (Lk / 64, B * N)
// ---------------------------------------------------------------------------
template <bool CAUSAL, int SEG>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, const int* __restrict__ q_offsets,
                     int q_offset, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n_heads,
                     int lq, int lk, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BC * D;
  __nv_bfloat16* Qs = Vs + BC * D;         // [2][BR * D]
  __nv_bfloat16* Ds = Qs + 2 * BR * D;     // [2][BR * D]
  float* lse_s = reinterpret_cast<float*>(Ds + 2 * BR * D);  // [2][BR]
  float* dl_s = lse_s + 2 * BR;                              // [2][BR]
  int* qc_s = reinterpret_cast<int*>(dl_s + 2 * BR);         // [2][BR] q codes

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int kv0 = blockIdx.x * BC;
  const int n_q = lq / BR;

  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  __nv_bfloat16* dkp = dk + b * sdk.b + h * sdk.h + (long long)kv0 * sdk.l;
  __nv_bfloat16* dvp = dv + b * sdv.b + h * sdv.h + (long long)kv0 * sdv.l;
  // causal: query i sits at row i + off; q tiles whose last row is above
  // this kv tile's first key see none of it
  int off = 0, i_start = 0;
  if (CAUSAL) {
    off = q_offset + (q_offsets != nullptr ? q_offsets[b] : 0);
    const int x = kv0 - off - (BR - 1);
    i_start = x <= 0 ? 0 : (x + BR - 1) / BR;
  }

  if (kv0 >= kv_end || i_start >= n_q) {
    // every p of this tile is 0: dk = dv = 0 (the outputs are torch.empty)
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < BC * D / 2; i += NTHREADS) {
      int r = i / (D / 2), c = 2 * (i % (D / 2));
      *reinterpret_cast<__nv_bfloat162*>(dkp + (long long)r * sdk.l + c) = z;
      *reinterpret_cast<__nv_bfloat162*>(dvp + (long long)r * sdv.l + c) = z;
    }
    return;
  }

  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* dop = dout + b * sdo.b + h * sdo.h;
  const float* lsep = lse + (long long)bh * lq;
  const float* dlp = delta + (long long)bh * lq;

  const int* qsp = SEG != NO_SEG ? q_seg + (long long)b * lq : nullptr;
  // q tile i (rows, dO, lse, delta and codes) into buffer `buf`
  auto load_q = [&](int buf, int i) {
    const long long qn = (long long)i * BR;
    load_tile(Qs + buf * BR * D, qp + qn * sq.l, sq.l, tid);
    load_tile(Ds + buf * BR * D, dop + qn * sdo.l, sdo.l, tid);
    load_row64(lse_s + buf * BR, lsep + qn, tid);
    load_row64(dl_s + buf * BR, dlp + qn, tid);
    if (SEG != NO_SEG) load_row64(qc_s + buf * BR, qsp + qn, tid);
  };

  load_tile(Ks, k + b * sk.b + h * sk.h + (long long)kv0 * sk.l, sk.l, tid);
  load_tile(Vs, v + b * sv.b + h * sv.h + (long long)kv0 * sv.l, sv.l, tid);
  load_q(0, i_start);
  cp_async_commit();

  // this warp's kv rows g and g + 8 (and their codes)
  const int kr = kv0 + warp * 16 + g;
  int kc[2] = {0, 0};
  if (SEG != NO_SEG) {
    kc[0] = kv_seg[(long long)b * lk + kr];
    kc[1] = kv_seg[(long long)b * lk + kr + 8];
  }

  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int i = i_start; i < n_q; ++i) {
    const int cur = (i - i_start) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + 1 < n_q) {
      load_q(cur ^ 1, i + 1);
      cp_async_commit();
    }
    const __nv_bfloat16* Qc = Qs + cur * BR * D;
    const __nv_bfloat16* Dc = Ds + cur * BR * D;
    const float* lc = lse_s + cur * BR;
    const float* dc = dl_s + cur * BR;
    const int* qcc = qc_s + cur * BR;

    // p^T = exp2(k qs^T - lse[col]); rows = this warp's kv rows, dead past
    // kv_end, past (causal) their query's row, or by segment / packed code
    float s[NT][4];
    mma_abt(s, Ks, warp * 16, Qc, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), qi = i * BR + c;
        const bool dead = masked<CAUSAL, SEG>(qi, qi + off, kr + 8 * (e >> 1), kv_end,
                                              SEG != NO_SEG ? qcc[c] : 0, kc[e >> 1]);
        s[n][e] = fast_exp2((dead ? NEG_INF : s[n][e]) - lc[c]);
      }

    // dv += p^T dO
    mma_pb(dv_acc, s, Dc, lane);

    // dS^T = p^T * (v dO^T - delta[col]);  dk += dS^T qs
    float dp[NT][4];
    mma_abt(dp, Vs, warp * 16, Dc, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - dc[n * 8 + 2 * t + (e & 1)]);
    mma_pb(dk_acc, dp, Qc, lane);
  }

  // dk was accumulated against the folded qs: dk_raw = ln2 * dS^T qs
  store_rows(dkp + (long long)(warp * 16) * sdk.l, sdk.l, dk_acc, LN2, g, t);
  store_rows(dvp + (long long)(warp * 16) * sdv.l, sdv.l, dv_acc, 1.f, g, t);
}

Strides st3(const long long* p) { return Strides{p[0], p[1], p[2]}; }

template <bool CAUSAL, int SEG>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, const void* kv_len,
                      const void* q_offsets, int q_offset, const void* q_seg, const void* kv_seg,
                      void* dq, void* delta, int B, int N, int lq, int lk, float scale,
                      const long long* st, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<CAUSAL, SEG>;
  const int smem = (2 * BR + 3 * BC) * D * (int)sizeof(__nv_bfloat16) +
                   BR * (int)sizeof(float) + 2 * BC * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(lq / BR, B * N);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offsets), q_offset,
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<__nv_bfloat16*>(dq), static_cast<float*>(delta), N, lq, lk, scale, st3(st),
      st3(st + 3), st3(st + 6), st3(st + 9), st3(st + 12), st3(st + 15));
  return cudaGetLastError();
}

template <bool CAUSAL, int SEG>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* kv_len,
                       const void* q_offsets, int q_offset, const void* q_seg,
                       const void* kv_seg, void* dk, void* dv, int B, int N, int lq, int lk,
                       const long long* st, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<CAUSAL, SEG>;
  const int smem = (2 * BC + 4 * BR) * D * (int)sizeof(__nv_bfloat16) +
                   4 * BR * (int)sizeof(float) + 2 * BR * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(lk / BC, B * N);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offsets), q_offset,
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), N, lq, lk, st3(st),
      st3(st + 3), st3(st + 6), st3(st + 9), st3(st + 12), st3(st + 15));
  return cudaGetLastError();
}

// Which mask: 0 none, 1 causal, 2 segments, 3 packed; -1 for a refused one
// (causal with segment codes has no caller).
int mask_kind(int causal, int seg_mode, const void* q_seg, const void* kv_seg) {
  if (seg_mode < NO_SEG || seg_mode > PACKED) return -1;
  if (seg_mode != NO_SEG && (causal || q_seg == nullptr || kv_seg == nullptr)) return -1;
  return causal ? 1 : (seg_mode == NO_SEG ? 0 : 1 + seg_mode);
}

}  // namespace

extern "C" {

// All bf16 [B, L, N, D] tensors with element strides (b, l, h) per tensor in
// `strides` and unit stride along D; D = 128; lq and lk multiples of 64.
// lse: fp32 [B, N, lq] from the forward; kv_len: int32 [B] or null. causal:
// query i of batch b is row i + q_offset + q_offsets[b] (q_offsets int32
// [B] on the device, or null) and sees keys at or before it. seg_mode (not
// with causal): 1 segment ids, 2 packed codes; q_seg int32 [B, lq] and
// kv_seg int32 [B, lk], contiguous.

// dq [B, lq, N, D] and delta (fp32 [B, N, lq], contiguous) from
// q (folded by scale * log2e), k, v, o, dO. strides: q, k, v, o, dO, dq.
int univid_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, const void* kv_len,
                             const void* q_offsets, const void* q_seg, const void* kv_seg,
                             void* dq, void* delta, int B, int N, int lq, int lk, int d,
                             int causal, int q_offset, int seg_mode, float scale,
                             const long long* st, void* stream) {
  if (d != D || lq % BR != 0 || lk % BC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mask_kind(causal, seg_mode, q_seg, kv_seg)) {
    case 0: return (int)launch_dq<false, NO_SEG>(q, k, v, o, dout, lse, kv_len, nullptr, 0, nullptr, nullptr, dq, delta, B, N, lq, lk, scale, st, s);
    case 1: return (int)launch_dq<true, NO_SEG>(q, k, v, o, dout, lse, kv_len, q_offsets, q_offset, nullptr, nullptr, dq, delta, B, N, lq, lk, scale, st, s);
    case 2: return (int)launch_dq<false, SEGMENTS>(q, k, v, o, dout, lse, kv_len, nullptr, 0, q_seg, kv_seg, dq, delta, B, N, lq, lk, scale, st, s);
    case 3: return (int)launch_dq<false, PACKED>(q, k, v, o, dout, lse, kv_len, nullptr, 0, q_seg, kv_seg, dq, delta, B, N, lq, lk, scale, st, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dk, dv [B, lk, N, D] from q (folded), k, v, dO, lse and the dq kernel's
// delta. strides: q, k, v, dO, dk, dv.
int univid_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* kv_len,
                              const void* q_offsets, const void* q_seg, const void* kv_seg,
                              void* dk, void* dv, int B, int N, int lq, int lk, int d,
                              int causal, int q_offset, int seg_mode, const long long* st,
                              void* stream) {
  if (d != D || lq % BR != 0 || lk % BC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mask_kind(causal, seg_mode, q_seg, kv_seg)) {
    case 0: return (int)launch_dkv<false, NO_SEG>(q, k, v, dout, lse, delta, kv_len, nullptr, 0, nullptr, nullptr, dk, dv, B, N, lq, lk, st, s);
    case 1: return (int)launch_dkv<true, NO_SEG>(q, k, v, dout, lse, delta, kv_len, q_offsets, q_offset, nullptr, nullptr, dk, dv, B, N, lq, lk, st, s);
    case 2: return (int)launch_dkv<false, SEGMENTS>(q, k, v, dout, lse, delta, kv_len, nullptr, 0, q_seg, kv_seg, dk, dv, B, N, lq, lk, st, s);
    case 3: return (int)launch_dkv<false, PACKED>(q, k, v, dout, lse, delta, kv_len, nullptr, 0, q_seg, kv_seg, dk, dv, B, N, lq, lk, st, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
