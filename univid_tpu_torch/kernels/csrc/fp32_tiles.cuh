// Shared pieces of the fp32 d=128 attention kernels (CUDA cores, sm_90a):
// cp.async tile loads into padded shared memory and the two register-tiled
// FFMA products that every fp32 d=128 kernel is built from.
//
// Thread roles: 256 threads; tx = tid & 15 is a column group, ty = tid >> 4
// a row group, so the 16 threads of one row group are one half warp (row
// reductions are 4 shuffles). A thread owns rows ty + 16 i (i < RM) of a
// product and, in a [rows, 64] score product, columns tx + 16 j (j < 4); in
// a [rows, 128] product, columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. 67 + 4 tx.
//
// Shared tiles are fp32 [rows, 128] with a padded row of LD = 132 floats
// (16 distinct rows read by a half warp land in 16 distinct 16-byte bank
// groups, two per bank group), and score tiles [rows, 64] with LDP = 68.
//
//   prod_xyt: C[RM][4]  = X Y^T over d      (X, Y [*, 128] tiles)
//             per 4 values of d: RM + 4 LDS.128 (the X loads broadcast
//             within a half warp) feed 16 RM FFMA;
//   prod_pz:  C[RM][8] += P Z over 64 rows  (P a [*, 64] score tile, Z a
//             [64, 128] tile), per 4 rows: RM + 8 LDS.128 feed 32 RM FFMA.
// Every sum runs in fp32 in index order (fmaf chains): the products are
// full fp32, as the TPU kernels' fp32 products are, never TF32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32tile {

constexpr int D = 128;         // head dim
constexpr int LD = D + 4;      // padded row of a [rows, 128] tile
constexpr int BT = 64;         // rows of a streamed tile; columns of a score tile
constexpr int LDP = BT + 4;    // padded row of a [rows, 64] score tile
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [0, ROWS) of a [*, 128] fp32 tile (row stride `ld` elements) into
// shared memory with row stride LD, by cp.async; rows at or past n_valid
// are zero-filled instead. A warp copies one 512-byte row.
template <int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld,
                                          int n_valid, int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * (D / 4); i += NTHREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    if (r < n_valid)
      cp_async16(dst + r * LD + c, src + r * ld + c);
    else
      *reinterpret_cast<float4*>(dst + r * LD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// 64 contiguous fp32 values (16-byte aligned) into shared memory.
__device__ __forceinline__ void load_row64(float* dst, const float* src, int tid) {
  if (tid < 16) cp_async16(dst + tid * 4, src + tid * 4);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// c[i][j] = sum_d X[ty + 16 i][d] * Y[tx + 16 j][d]
template <int RM>
__device__ __forceinline__ void prod_xyt(float (&c)[RM][4], const float* X, const float* Y,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  const float* xr = X + ty * LD;
  const float* yr = Y + tx * LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RM], b[4];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(xr + 16 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(yr + 16 * j * LD + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
}

// c[i][0..3] += sum_r P[ty + 16 i][r] * Z[r][4 tx .. 4 tx + 3],
// c[i][4..7] += sum_r P[ty + 16 i][r] * Z[r][64 + 4 tx .. 67 + 4 tx], r < 64
template <int RM>
__device__ __forceinline__ void prod_pz(float (&c)[RM][8], const float* P, const float* Z,
                                        int ty, int tx) {
  const float* pr = P + ty * LDP;
  const float* zc = Z + 4 * tx;
#pragma unroll 2
  for (int r = 0; r < BT; r += 4) {
    float4 p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = *reinterpret_cast<const float4*>(pr + 16 * i * LDP + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 z0 = *reinterpret_cast<const float4*>(zc + (r + rr) * LD);
      const float4 z1 = *reinterpret_cast<const float4*>(zc + (r + rr) * LD + 64);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float pv = comp(p[i], rr);
        c[i][0] = fmaf(pv, z0.x, c[i][0]);
        c[i][1] = fmaf(pv, z0.y, c[i][1]);
        c[i][2] = fmaf(pv, z0.z, c[i][2]);
        c[i][3] = fmaf(pv, z0.w, c[i][3]);
        c[i][4] = fmaf(pv, z1.x, c[i][4]);
        c[i][5] = fmaf(pv, z1.y, c[i][5]);
        c[i][6] = fmaf(pv, z1.z, c[i][6]);
        c[i][7] = fmaf(pv, z1.w, c[i][7]);
      }
    }
  }
}

// Row ty + 16 i of a [rows, 128] product (this thread's 8 columns), times
// `mul`, to global memory at `row_ptr` (the row's first element).
__device__ __forceinline__ void store_row8(float* row_ptr, const float (&c)[8], float mul,
                                           int tx) {
  *reinterpret_cast<float4*>(row_ptr + 4 * tx) =
      make_float4(c[0] * mul, c[1] * mul, c[2] * mul, c[3] * mul);
  *reinterpret_cast<float4*>(row_ptr + 64 + 4 * tx) =
      make_float4(c[4] * mul, c[5] * mul, c[6] * mul, c[7] * mul);
}

// Sum (or max) over the 16 threads of a row group (one half warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffff, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, off));
  return x;
}

}  // namespace f32tile
