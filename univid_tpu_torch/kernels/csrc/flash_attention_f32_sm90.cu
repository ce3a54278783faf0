// fp32 attention at d = 128 for Hopper (sm_90a) on the tensor cores at fp32
// accuracy: wgmma on three bf16 parts of each operand, fed by TMA, in
// warp-specialised blocks. The forward and the backward of the full DiT
// fine-tune at its default fp32 policy, and of fp32 DiT serving.
//
// Replaces, at fp32 and d = 128, the Pallas TPU kernels of
// univid_tpu/kernels/flash_attention.py in the modes the DiT reaches:
//   * _flash_kernel (:44): the running max or the bounded softmax p =
//     exp2(s - C) at the folded score bound C (:266-275); kv_len: keys at
//     or past kv_len[b] score -1e30, kv tiles wholly past it are never
//     loaded, rows with l == 0 are exactly 0; save_residuals (:343-352):
//     the exp2-domain lse, m + log2 l (C + log2 l under the bound), +1e30
//     where l == 0, fp32 [B, N, Lq];
//   * _cross_kernel (:355) at fp32: the port sends fp32 cross-attention
//     (Lk = 512) to the same forward, whose running max over the kv tiles
//     gives the one-shot softmax's value;
//   * _flash_bwd_dq_kernel (:831), _flash_bwd_dkv_kernel (:940) and
//     _flash_bwd_fused_kernel (:1057) at fp32, with kv_len: p = exp2(qs k^T
//     - lse), delta = rowsum(dO * O), dS = p * (dO v^T - delta), dq = scale
//     * dS k, dk = ln 2 * dS^T qs, dv = p^T dO, as a dq kernel (which also
//     writes delta) and a dk/dv kernel, 7 products a tile pair.
// q arrives folded by softmax_scale * log2 e (the wrapper's _fold, or the
// fp32 rope pre-pass univid_rope_rotate_f32 of flash_attention_f32_d128.cu,
// which stays as it is). flash_attention_f32_d128.cu and
// flash_attention_bwd_f32.cu, the CUDA-core kernels this file replaced,
// stay built as the same-call baselines; no route reaches them.
//
// What bounds it: one product at the fine-tune's self shape [1, 32768, 12,
// 128], kv 32,760, is 2 Lq Lk d N = 3.3 TFLOP. The CUDA cores' fp32 FFMA
// (67 TFLOP/s) held the forward (2 products) at 98 ms and the backward pair
// (7) at 344 ms of bound; they reached 51-61% of it. On the tensor cores at
// fp32 accuracy each product costs six bf16 products (989 TFLOP/s), the
// same as three TF32 ones (495): bounds of 40 ms (forward) and 140 ms
// (pair). Bytes are ~1 GB a call: the tensor cores bound every kernel here.
//
// Operand encoding: three bf16 parts, x = b0 + b1 + b2 (b0 = bf16(x), b1 =
// bf16(x - b0), b2 = bf16(x - b0 - b1); each difference is exact in fp32,
// so |x - b0 - b1 - b2| <= 2^-27 |x|), and a product a b as the six terms
// a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0 (the dropped terms are
// ~2^-24 of it): fp32 accuracy, like 3xTF32 (flash_attention_f32_tc.cu),
// at the same tensor-core time (6 / 989 = 3 / 495), but
//   * 6 bytes an element in shared memory, not 8 (TF32 hi and lo), and
//     shared memory is what binds these tiles (below);
//   * bf16 wgmma takes the transpose flag, so the products that contract
//     over rows (p v, dS k, p^T dO, dS^T qs) read v, k, dO and qs as they
//     are (MN-major), as flash_attention_bwd_sm90.cu does. TF32 wgmma takes
//     K-major operands only: each of those would need a transposed copy.
// Operands from shared memory (q, k, v, dO) are split once, by a pre-pass
// (split_bf16x3_kernel: fp32 [B, L, N, 128] -> bf16 [3, B, L, N, 128], one
// launch a tensor a call); the register operands p and dS are split on
// the wgmma fragments, once a tile.
// Shared-memory budget (227 KB an SM): a [rows, 128] tile takes 768 B a row
// in three parts. The forward keeps a 128-row q tile (96 KB) and rings of
// two 32-row k and v stages (2 x 2 x 24 KB): 192 KB. The dq kernel keeps
// its 64-row qs and dO tiles (96 KB) and one 32-row k + v stage for each of
// its two consumers (96 KB): 192 KB. The dk/dv kernel keeps its 64-row k and
// v tiles (96 KB), two 32-row qs + dO stages (96 KB) and two 64 x 32 fp32 p
// tiles (16 KB): 209 KB. (k and v resident for 128 rows alone would take
// 192 KB.)
//
// Accumulation: Hopper's tensor cores add each product into the fp32
// accumulator with truncation, not round to nearest (flash_attention_f32_
// tc.cu measured a 3e-4 bias on long sums). So no accumulator here takes
// more than a tile's adds: each of the scores' six terms (8 adds of 16-deep
// products over d = 128) has a fresh accumulator of its own, and FADDs sum
// the small terms and then the main one; every product that contracts over
// rows (p v, dS k, p^T dO, dS^T qs: 12 adds, small terms first) goes to a
// fresh tile accumulator, and an FADD adds that to the running sum in
// registers. Nothing else rounds beyond fp32.
//
// Kernels (warp specialisation as flash_attention_sm90.cu: warpgroup 0 the
// producer, one thread issuing every TMA load, setmaxnreg.dec 24; two
// consumer warpgroups, setmaxnreg.inc 240; full barriers by transaction
// count, empty barriers by one arrival a consumer warp):
//   * the scores (s = q k^T and its kin, K = d = 128, 32 columns): both
//     operands K-major in shared memory, the streamed operand's three parts
//     stacked along N ([d half][part][32 rows]), so that a k16 step is
//     three products, a0 [b0|b1|b2] (m64n96k16), a1 [b0|b1] (m64n64k16)
//     and a2 b0 (m64n32k16): 12 KB of shared memory for the six terms where
//     six m64n32k16 products read 18 (the SM reads 128 B a clock; the
//     tensor cores take 96 clocks for the six terms);
//   * forward, one block a (b*h, 128-row q tile): each consumer owns 64 q
//     rows; per 32-key tile the scores, the online softmax on the
//     fragments, p split, o_tile = p v (m64n64k16, p from registers, v
//     MN-major), o = o * corr + o_tile;
//   * dq, one block a (b*h, 64-row q tile): delta from O and dO in fp32
//     first; consumer c takes the 32-key tiles c, c + 2, ... into its own
//     stage and its own dq sum: s = qs k^T, then dP = dO v^T, dS,
//     dq_tile = dS k (m64n64k16, k MN-major); at the end consumer 1's sum
//     goes through shared memory and consumer 0 writes (dq_0 + dq_1) *
//     scale;
//   * dk/dv, one block a (b*h, 64-row kv tile), 32-row q tiles streamed:
//     consumer 0 computes S^T = k qs^T, P^T, hands P^T to consumer 1 in
//     shared memory, and accumulates dV += P^T dO; consumer 1 computes
//     dP^T = v dO^T, dS^T = P^T (dP^T - delta), and accumulates dK +=
//     dS^T qs: two products each a tile.
// DETERMINISTIC: every output element is written by one thread, from sums
// taken in a fixed order (no atomics), so two runs give the same bits.
// Ragged lengths: Lq and Lk are multiples of 64. TMA zero-fills rows past
// L; the tail kv tile masks keys at or past kv_len; a forward consumer whose
// 64 rows lie past Lq leaves at once.

#include <cuda.h>

#include "bf16_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int THREADS = 384;     // producer + two consumer warpgroups
constexpr int PARTS = 3;
constexpr int KT = 32;           // rows of a streamed tile (kv in fwd / dq, q in dk/dv)
constexpr int F_BM = 128;        // q rows of a forward block
constexpr int R_BM = 64;         // resident rows of a dq / dk-dv block
constexpr int STAGES = 2;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SPLIT_THREADS = 256;

typedef __nv_bfloat16 bf16;
constexpr int SUB_T = KT * SUB;    // elements of a [32, 64] sub-tile
constexpr int SUB_R = R_BM * SUB;  // [64, 64]
constexpr int SUB_F = F_BM * SUB;  // [128, 64]
// bytes of a streamed tile's three parts, and of a resident one's
constexpr uint32_t T_BYTES = PARTS * 2 * SUB_T * 2;
constexpr uint32_t R_BYTES = PARTS * 2 * SUB_R * 2;

// the five small terms of a split product, s = 0..4: (a part, b part) =
// (0, 1), (1, 0), (0, 2), (1, 1), (2, 0); the main term is (0, 0)
__host__ __device__ constexpr int small_a(int s) { return s == 4 ? 2 : (s == 1 || s == 3); }
__host__ __device__ constexpr int small_b(int s) { return s == 2 ? 2 : (s == 0 || s == 3); }

// d[16] (+)= A (smem, K-major) * B (smem, K-major): wgmma m64n32k16
__device__ __forceinline__ void wgmma_ss_m64n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[48] (+)= A (smem, K-major) * B (smem, K-major): wgmma m64n96k16
__device__ __forceinline__ void wgmma_ss_m64n96(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A (registers, bf16 fragments) * B (smem, MN-major): m64n64k16
__device__ __forceinline__ void wgmma_rs_m64n64_t(float* d, const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// (x0, x1) -> three bf16x2 parts, x = p0 + p1 + p2 + O(2^-27 |x|)
__device__ __forceinline__ void split3_pair(float x0, float x1, uint32_t& p0, uint32_t& p1,
                                            uint32_t& p2) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x0, x1);
  const float2 af = __bfloat1622float2(a);
  const float r0 = x0 - af.x, r1 = x1 - af.y;   // exact
  const __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 c = __floats2bfloat162_rn(r0 - bf.x, r1 - bf.y);
  p0 = *reinterpret_cast<const uint32_t*>(&a);
  p1 = *reinterpret_cast<const uint32_t*>(&b);
  p2 = *reinterpret_cast<const uint32_t*>(&c);
}

// a [64, 32] fp32 fragment (x[n][e], n-tiles of 8 columns) as the three
// parts of a wgmma A operand over K = 32 (two k16 steps): a[part][kk][4]
__device__ __forceinline__ void split_frag(const float (&x)[4][4], uint32_t (&a)[PARTS][2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    split3_pair(x[2 * kk][0], x[2 * kk][1], a[0][kk][0], a[1][kk][0], a[2][kk][0]);
    split3_pair(x[2 * kk][2], x[2 * kk][3], a[0][kk][1], a[1][kk][1], a[2][kk][1]);
    split3_pair(x[2 * kk + 1][0], x[2 * kk + 1][1], a[0][kk][2], a[1][kk][2], a[2][kk][2]);
    split3_pair(x[2 * kk + 1][2], x[2 * kk + 1][3], a[0][kk][3], a[1][kk][3], a[2][kk][3]);
  }
}

// The scores' three fresh accumulators: x0 = a0 [b0|b1|b2] (n-tiles 0-3
// a0 b0, 4-7 a0 b1, 8-11 a0 b2), x1 = a1 [b0|b1], x2 = a2 b0, each 64 rows
// x 32 columns a term; every term takes 8 truncating adds.
struct Scores {
  float x0[12][4], x1[8][4], x2[4][4];
};

// x (64 x 32) = A B^T over K = 128 in the split form: A rows from `a`
// ([d half][part][rows * 64], K-major, `a_rows` rows a sub-tile, the
// warpgroup's 64 rows from row `a_row0`), B's 32 rows from `b` ([d
// half][part][32 * 64], so that parts 0 .. p - 1 of one half are 32 p
// consecutive rows and one descriptor reads them as one operand). Three
// products a k16 step (m64n96, m64n64, m64n32) on 2 + 3, 2 + 2 and 2 + 1 KB
// of shared memory: the six terms at 125 B a clock, under the SM's 128 (as
// six m64n32 products they would read 188). The caller commits, waits and
// sums (score()).
__device__ __forceinline__ void scores_mma(Scores& x, const bf16* a, int a_rows, int a_row0,
                                           const bf16* b) {
  // the descriptors below are these two plus offsets (16-byte units in the
  // address field); opaque here, so that the compiler rebuilds them at each
  // call instead of holding 24 of them in registers across the caller's loop
  uint64_t da = sw128_desc(a + a_row0 * SUB, 1, 64), db = sw128_desc(b, 1, 64);
  asm volatile("" : "+l"(da), "+l"(db));
  const int a_part = a_rows * SUB / 8;   // one part of A, in 16-byte units
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk) {
      const uint64_t dak = da + hf * PARTS * a_part + 2 * kk;
      const uint64_t dbk = db + hf * PARTS * SUB_T / 8 + 2 * kk;
      wgmma_ss_m64n96(&x.x0[0][0], dak, dbk, hf | kk);
      wgmma_ss_m64n64<0, 0>(&x.x1[0][0], dak + a_part, dbk, hf | kk);
      wgmma_ss_m64n32(&x.x2[0][0], dak + 2 * a_part, dbk, hf | kk);
    }
}

// the score at fragment (n, e): the main term plus the small terms, summed
// smallest first by round-to-nearest adds
__device__ __forceinline__ float score(const Scores& x, int n, int e) {
  return x.x0[n][e] + (((x.x0[4 + n][e] + x.x1[n][e]) + (x.x0[8 + n][e] + x.x1[4 + n][e])) +
                       x.x2[n][e]);
}

__device__ __forceinline__ void fence_scores(Scores& x) {
  fence_regs<48>(&x.x0[0][0]);
  fence_regs<32>(&x.x1[0][0]);
  fence_regs<16>(&x.x2[0][0]);
}

// acc (64 x 128, [d half][n-tile][4]) = A B over K = 32 rows in the split
// form, fresh: A from registers (a[part][kk]), B a streamed [d
// half][part][32 * 64] tile read MN-major (rows are K). Small terms first,
// the main term last; the caller commits and waits.
__device__ __forceinline__ void rows_mma(float (&acc)[2][8][4], const uint32_t (&a)[PARTS][2][4],
                                           const bf16* b) {
  uint64_t db = sw128_desc(b, 64, 64);   // opaque, as in scores_mma
  asm volatile("" : "+l"(db));
  constexpr int PART = SUB_T / 8, ROWS16 = 16 * SUB / 8;   // 16-byte units
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs_m64n64_t(&acc[hf][0][0], a[small_a(s)][kk],
                          db + (hf * PARTS + small_b(s)) * PART + kk * ROWS16, s | kk);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_rs_m64n64_t(&acc[hf][0][0], a[0][kk], db + hf * PARTS * PART + kk * ROWS16, 1);
  }
}

// the three parts of a streamed or resident tile, [d half][part][rows *
// 64]: tma_load of [rows, 64] boxes of part p from the part map (batch
// index p * B + b)
__device__ __forceinline__ void load_parts(bf16* dst, int sub_elems, const CUtensorMap* map,
                                           uint64_t* bar, int h, int row, int b, int B) {
#pragma unroll
  for (int p = 0; p < PARTS; ++p)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      tma_load(dst + (hf * PARTS + p) * sub_elems, map, bar, hf * SUB, h, row, p * B + b);
}

// ---------------------------------------------------------------------------
// the split pre-pass: fp32 x [B, L, N, 128] (strides sb, sl, sh) -> bf16
// parts [3, B, L, N, 128] contiguous; four elements a thread, grid-stride
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SPLIT_THREADS)
split_bf16x3_kernel(const float* __restrict__ x, bf16* __restrict__ out, int L, int N,
                    long long sb, long long sl, long long sh, long long n4) {
  const long long total = 4 * n4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;
    const int d = (int)(e % 128);
    long long r = e / 128;
    const int h = (int)(r % N);
    r /= N;
    const int l = (int)(r % L);
    const long long b = r / L;
    const float4 v = *reinterpret_cast<const float4*>(x + b * sb + l * sl + h * sh + d);
    uint2 p0, p1, p2;
    split3_pair(v.x, v.y, p0.x, p1.x, p2.x);
    split3_pair(v.z, v.w, p0.y, p1.y, p2.y);
    *reinterpret_cast<uint2*>(out + e) = p0;
    *reinterpret_cast<uint2*>(out + total + e) = p1;
    *reinterpret_cast<uint2*>(out + 2 * total + e) = p2;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
struct FwdSmem {
  bf16 q[2][PARTS][SUB_F];
  bf16 k[STAGES][2][PARTS][SUB_T];
  bf16 v[STAGES][2][PARTS][SUB_T];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
};
constexpr int FWD_SMEM = (int)sizeof(FwdSmem) + 1024;   // + alignment slack

template <bool BOUNDED>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                          const int* __restrict__ kv_len, const float* __restrict__ bound,
                          float* __restrict__ lse, int B, int n_heads, int lq, int lk,
                          long long o_sb, long long o_sl, long long o_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw + pad);

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * F_BM;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + KT - 1) / KT;
  const int n_cons = (q0 + 64 < lq) ? 2 : 1;   // consumers with rows below lq

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 4 * n_cons);
      mbar_init(&sm.v_empty[s], 4 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(&sm.q_full, PARTS * 2 * SUB_F * 2);
      load_parts(&sm.q[0][0][0], SUB_F, &q_map, &sm.q_full, h, q0, b, B);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES, ph = ((j / STAGES) & 1) ^ 1;
        mbar_wait(&sm.k_empty[st], ph);
        mbar_expect_tx(&sm.k_full[st], T_BYTES);
        load_parts(&sm.k[st][0][0][0], SUB_T, &k_map, &sm.k_full[st], h, j * KT, b, B);
        mbar_wait(&sm.v_empty[st], ph);
        mbar_expect_tx(&sm.v_full[st], T_BYTES);
        load_parts(&sm.v[st][0][0][0], SUB_T, &v_map, &sm.v_full[st], h, j * KT, b, B);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  if (c >= n_cons) return;
  const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * c + 16 * w;   // this warp's first q row
  const float c_bound = BOUNDED ? *bound : 0.f;

  float o_run[2][8][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_run[hf][n][e] = 0.f;
  float m_r[2] = {BOUNDED ? c_bound : NEG_INF, BOUNDED ? c_bound : NEG_INF};
  float l_r[2] = {0.f, 0.f};   // this thread's share of rows g, g + 8

  if (n_tiles > 0) mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, ph = (j / STAGES) & 1;
    Scores x;
    mbar_wait(&sm.k_full[st], ph);
    wgmma_fence();
    scores_mma(x, &sm.q[0][0][0], F_BM, 64 * c, &sm.k[st][0][0][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_scores(x);
    if (lane == 0) mbar_arrive(&sm.k_empty[st]);
    const int kv0 = j * KT;
    const bool tail = kv0 + KT > kv_end;
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = score(x, n, e);
        if (tail && kv0 + 8 * n + 2 * t + (e & 1) >= kv_end) s[n][e] = NEG_INF;
      }
    float corr[2] = {1.f, 1.f};
    if (!BOUNDED) {
      // the first tile holds key 0 < kv_end, so m is finite from then on
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mc = NEG_INF;
#pragma unroll
        for (int n = 0; n < 4; ++n) mc = fmaxf(mc, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffff, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffff, mc, 2));
        const float m_new = fmaxf(m_r[i], mc);
        corr[i] = fast_exp2(m_r[i] - m_new);
        m_r[i] = m_new;
        l_r[i] *= corr[i];
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(s[n][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[n][e];
      }
    uint32_t pa[PARTS][2][4];
    split_frag(s, pa);
    float o_t[2][8][4];
    mbar_wait(&sm.v_full[st], ph);
    wgmma_fence();
    rows_mma(o_t, pa, &sm.v[st][0][0][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(&o_t[0][0][0]);
    fence_regs<24>(&pa[0][0][0]);
    if (lane == 0) mbar_arrive(&sm.v_empty[st]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o_run[hf][n][e] = BOUNDED ? o_run[hf][n][e] + o_t[hf][n][e]
                                    : fmaf(o_run[hf][n][e], corr[e >> 1], o_t[hf][n][e]);
  }

  // rows past lq never reach here (lq is a multiple of 64)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[i] = l > 0.f ? 1.f / l : 0.f;
    // exp2-domain lse: the reference point (bound or row max) plus log2 l;
    // +1e30 for empty rows, so that the backward's p is 0
    if (lse != nullptr && t == 0)
      lse[(long long)bh * lq + row0 + g + 8 * i] = l > 0.f ? m_r[i] + log2f(l) : -NEG_INF;
  }
  float* ob = o + b * o_sb + h * o_sh + (long long)(row0 + g) * o_sl;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * hf + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(ob + col) =
          make_float2(o_run[hf][n][0] * inv[0], o_run[hf][n][1] * inv[0]);
      *reinterpret_cast<float2*>(ob + 8 * o_sl + col) =
          make_float2(o_run[hf][n][2] * inv[1], o_run[hf][n][3] * inv[1]);
    }
}

// ---------------------------------------------------------------------------
// backward: dq (+ delta)
// ---------------------------------------------------------------------------
struct DqSmem {
  bf16 q[2][PARTS][SUB_R];
  bf16 dout[2][PARTS][SUB_R];
  bf16 k[2][2][PARTS][SUB_T];   // one stage a consumer
  bf16 v[2][2][PARTS][SUB_T];
  float delta[R_BM];
  uint64_t qd_full, full[2], empty[2];
};
constexpr int DQ_SMEM = (int)sizeof(DqSmem) + 1024;

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ o, const float* __restrict__ dout,
                             const float* __restrict__ lse, const int* __restrict__ kv_len,
                             float* __restrict__ dq, float* __restrict__ delta, int B,
                             int n_heads, int lq, int lk, float scale, long long o_sb,
                             long long o_sl, long long o_sh, long long d_sb, long long d_sl,
                             long long d_sh, long long q_sb, long long q_sl, long long q_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw + pad);

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * R_BM;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + KT - 1) / KT;

  if (tid == 0) {
    mbar_init(&sm.qd_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);   // the stage's consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(&sm.qd_full, 2 * R_BYTES);
      load_parts(&sm.q[0][0][0], SUB_R, &q_map, &sm.qd_full, h, q0, b, B);
      load_parts(&sm.dout[0][0][0], SUB_R, &do_map, &sm.qd_full, h, q0, b, B);
      // tile j goes to consumer j % 2's stage
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % 2;
        mbar_wait(&sm.empty[st], ((j / 2) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * T_BYTES);
        load_parts(&sm.k[st][0][0][0], SUB_T, &k_map, &sm.full[st], h, j * KT, b, B);
        load_parts(&sm.v[st][0][0][0], SUB_T, &v_map, &sm.full[st], h, j * KT, b, B);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, ct = tid - 128, tw = tid % 128;
  const int w = tw / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // delta = rowsum(dO * O) in fp32, four threads a row, from device memory
  {
    const int r = ct / 4, part = (ct % 4) * 32;
    const float* orow = o + b * o_sb + h * o_sh + (long long)(q0 + r) * o_sl + part;
    const float* drow = dout + b * d_sb + h * d_sh + (long long)(q0 + r) * d_sl + part;
    float acc = 0.f;
#pragma unroll
    for (int x = 0; x < 32; x += 4) {
      const float4 a = *reinterpret_cast<const float4*>(orow + x);
      const float4 gv = *reinterpret_cast<const float4*>(drow + x);
      acc = fmaf(gv.x, a.x, acc);
      acc = fmaf(gv.y, a.y, acc);
      acc = fmaf(gv.z, a.z, acc);
      acc = fmaf(gv.w, a.w, acc);
    }
    acc += __shfl_xor_sync(0xffffffff, acc, 1);
    acc += __shfl_xor_sync(0xffffffff, acc, 2);
    if ((ct & 3) == 0) {
      sm.delta[r] = acc;
      delta[(long long)bh * lq + q0 + r] = acc;
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * w + g + 8 * i;
    lse_r[i] = __ldg(lse + (long long)bh * lq + q0 + r);
    dl_r[i] = sm.delta[r];
  }

  float dq_run[2][8][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_run[hf][n][e] = 0.f;

  if (c < n_tiles) mbar_wait(&sm.qd_full, 0);
  for (int j = c, it = 0; j < n_tiles; j += 2, ++it) {
    Scores x;
    float s[4][4];
    mbar_wait(&sm.full[c], it & 1);
    // S = qs k^T, then dP = dO v^T: 64 q x 32 kv, K = 128 (d), one after
    // the other in the same accumulators
    wgmma_fence();
    scores_mma(x, &sm.q[0][0][0], R_BM, 0, &sm.k[c][0][0][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_scores(x);
    const int kv0 = j * KT;
    const bool tail = kv0 + KT > kv_end;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = score(x, n, e);
        if (tail && kv0 + 8 * n + 2 * t + (e & 1) >= kv_end) v = NEG_INF;
        s[n][e] = fast_exp2(v - lse_r[e >> 1]);
      }
    wgmma_fence();
    scores_mma(x, &sm.dout[0][0][0], R_BM, 0, &sm.v[c][0][0][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_scores(x);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= score(x, n, e) - dl_r[e >> 1];
    uint32_t da[PARTS][2][4];
    split_frag(s, da);
    // dq_tile = dS k: A = dS (registers), B = k (MN-major), K = 32 (kv)
    float dq_t[2][8][4];
    wgmma_fence();
    rows_mma(dq_t, da, &sm.k[c][0][0][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(&dq_t[0][0][0]);
    fence_regs<24>(&da[0][0][0]);
    if (lane == 0) mbar_arrive(&sm.empty[c]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_run[hf][n][e] += dq_t[hf][n][e];
  }

  // dq = (consumer 0's sum + consumer 1's sum) * scale, in that order:
  // consumer 1 hands its sum over in shared memory (the k stages, free now)
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float4* red = reinterpret_cast<float4*>(&sm.k[0][0][0][0]);
  if (c == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        red[(hf * 8 + n) * 128 + tw] =
            make_float4(dq_run[hf][n][0], dq_run[hf][n][1], dq_run[hf][n][2], dq_run[hf][n][3]);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (c == 1) return;
  float* qb = dq + b * q_sb + h * q_sh + (long long)(q0 + 16 * w + g) * q_sl;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 x = red[(hf * 8 + n) * 128 + tw];
      const int col = 64 * hf + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(qb + col) =
          make_float2((dq_run[hf][n][0] + x.x) * scale, (dq_run[hf][n][1] + x.y) * scale);
      *reinterpret_cast<float2*>(qb + 8 * q_sl + col) =
          make_float2((dq_run[hf][n][2] + x.z) * scale, (dq_run[hf][n][3] + x.w) * scale);
    }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------
struct DkvSmem {
  bf16 k[2][PARTS][SUB_R];
  bf16 v[2][PARTS][SUB_R];
  bf16 q[STAGES][2][PARTS][SUB_T];
  bf16 dout[STAGES][2][PARTS][SUB_T];
  float4 p[2][R_BM * KT / 4];   // P^T fragments, consumer 0 -> consumer 1
  float lse[STAGES][KT];
  float delta[STAGES][KT];
  uint64_t kv_full, full[STAGES], empty[STAGES], p_full[2], p_empty[2];
};
constexpr int DKV_SMEM = (int)sizeof(DkvSmem) + 1024;

// One consumer's walk over the q tiles of a dk/dv block. ROLE 0: S^T = k
// qs^T, P^T = exp2(S^T - lse[q]) (dead kv rows score -1e30), P^T to the
// other consumer, run += P^T dO (dV). ROLE 1: dP^T = v dO^T, dS^T = P^T
// (dP^T - delta[q]), run += dS^T qs (dK). Each product: A from registers or
// shared memory, K-major; the row products' B MN-major, K = 32 (q).
template <int ROLE>
__device__ __forceinline__ void dkv_consume(DkvSmem& sm, float (&run)[2][8][4], int n_q,
                                            bool dead0, bool dead1, int tw, int t, int lane) {
  for (int i = 0; i < n_q; ++i) {
    const int st = i % STAGES, ph = (i / STAGES) & 1, pb = i & 1, pph = (i >> 1) & 1;
    Scores x;
    float s[4][4];
    mbar_wait(&sm.full[st], ph);
    wgmma_fence();
    if (ROLE == 0)
      scores_mma(x, &sm.k[0][0][0], R_BM, 0, &sm.q[st][0][0][0]);
    else
      scores_mma(x, &sm.v[0][0][0], R_BM, 0, &sm.dout[st][0][0][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_scores(x);
    if (ROLE == 0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * n + 2 * t]);
        s[n][0] = fast_exp2((dead0 ? NEG_INF : score(x, n, 0)) - l2.x);
        s[n][1] = fast_exp2((dead0 ? NEG_INF : score(x, n, 1)) - l2.y);
        s[n][2] = fast_exp2((dead1 ? NEG_INF : score(x, n, 2)) - l2.x);
        s[n][3] = fast_exp2((dead1 ? NEG_INF : score(x, n, 3)) - l2.y);
      }
      mbar_wait(&sm.p_empty[pb], pph ^ 1);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sm.p[pb][n * 128 + tw] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      mbar_arrive(&sm.p_full[pb]);
    } else {
      // dP^T - delta first, so that the accumulators are free before P^T
      // arrives
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(&sm.delta[st][8 * n + 2 * t]);
        s[n][0] = score(x, n, 0) - d2.x;
        s[n][1] = score(x, n, 1) - d2.y;
        s[n][2] = score(x, n, 2) - d2.x;
        s[n][3] = score(x, n, 3) - d2.y;
      }
      mbar_wait(&sm.p_full[pb], pph);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 p = sm.p[pb][n * 128 + tw];
        s[n][0] *= p.x;
        s[n][1] *= p.y;
        s[n][2] *= p.z;
        s[n][3] *= p.w;
      }
      mbar_arrive(&sm.p_empty[pb]);
    }
    uint32_t pa[PARTS][2][4];
    split_frag(s, pa);
    float acc[2][8][4];
    wgmma_fence();
    rows_mma(acc, pa, ROLE == 0 ? &sm.dout[st][0][0][0] : &sm.q[st][0][0][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(&acc[0][0][0]);
    fence_regs<24>(&pa[0][0][0]);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[hf][n][e] += acc[hf][n][e];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const int* __restrict__ kv_len, float* __restrict__ dk,
                              float* __restrict__ dv, int B, int n_heads, int lq, int lk,
                              long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                              long long v_sl, long long v_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw + pad);

  // each role derives its indices after its setmaxnreg: nothing but tid is
  // live across it, so no value has to survive the producer's 24 registers
  // (ptxas spills one that does)
  const int tid = threadIdx.x, wg = tid / 128;
  auto kv_end_of = [&](int b) {
    return kv_len != nullptr ? min(max(__ldg(kv_len + b), 0), lk) : lk;
  };

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);   // one arrival a consumer warp
      mbar_init(&sm.p_full[s], 128);
      mbar_init(&sm.p_empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
    const int kv0 = blockIdx.x * R_BM, n_q = lq / KT;
    if (tid == 0 && kv0 < kv_end_of(b)) {
      mbar_expect_tx(&sm.kv_full, 2 * R_BYTES);
      load_parts(&sm.k[0][0][0], SUB_R, &k_map, &sm.kv_full, h, kv0, b, B);
      load_parts(&sm.v[0][0][0], SUB_R, &v_map, &sm.kv_full, h, kv0, b, B);
      for (int i = 0; i < n_q; ++i) {
        const int st = i % STAGES;
        mbar_wait(&sm.empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * T_BYTES + 2 * KT * 4);
        load_parts(&sm.q[st][0][0][0], SUB_T, &q_map, &sm.full[st], h, i * KT, b, B);
        load_parts(&sm.dout[st][0][0][0], SUB_T, &do_map, &sm.full[st], h, i * KT, b, B);
        const long long row = (long long)bh * lq + i * KT;
        bulk_load(sm.lse[st], lse + row, KT * 4, &sm.full[st]);
        bulk_load(sm.delta[st], delta + row, KT * 4, &sm.full[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int kv0 = blockIdx.x * R_BM, n_q = lq / KT, kv_end = kv_end_of(b);
  const bool live = kv0 < kv_end;
  const int c = wg - 1, tw = tid % 128, w = tw / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = 16 * w + g;   // this thread's kv rows row0, row0 + 8 of the tile
  // rows at or past kv_end (only in the tail tile) take no part
  const bool dead0 = kv0 + row0 >= kv_end, dead1 = kv0 + row0 + 8 >= kv_end;

  // consumer 0: dV; consumer 1: dK
  float run[2][8][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[hf][n][e] = 0.f;
  if (live) {
    mbar_wait(&sm.kv_full, 0);
    if (c == 0)
      dkv_consume<0>(sm, run, n_q, dead0, dead1, tw, t, lane);
    else
      dkv_consume<1>(sm, run, n_q, dead0, dead1, tw, t, lane);
  }
  // dk was accumulated against the folded qs: dk = ln 2 * dS^T qs
  const float mul = c == 0 ? 1.f : LN2;
  float* base = c == 0 ? dv + b * v_sb + h * v_sh + (long long)(kv0 + row0) * v_sl
                       : dk + b * k_sb + h * k_sh + (long long)(kv0 + row0) * k_sl;
  const long long sl = c == 0 ? v_sl : k_sl;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * hf + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(base + col) =
          make_float2(run[hf][n][0] * mul, run[hf][n][1] * mul);
      *reinterpret_cast<float2*>(base + 8 * sl + col) =
          make_float2(run[hf][n][2] * mul, run[hf][n][3] * mul);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// the part maps of a bf16 [3, B, L, N, 128] contiguous parts tensor
bool parts_map(CUtensorMap* map, const void* parts, int B, int L, int N, int box_rows) {
  const long long st[3] = {(long long)L * N * 128, (long long)N * 128, 128};
  return make_map(map, parts, PARTS * B, L, N, st, box_rows);
}

// setmaxnreg moves registers between the block's warpgroups: the block
// must start with at least what the producer (24) and the consumers (240)
// end with, or the consumers' setmaxnreg.inc would wait forever
template <typename K>
cudaError_t prepare(K kern, int smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * THREADS < 128 * 24 + 256 * 240) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x fp32 [B, L, N, 128] with element strides (sb, sl, sh), unit stride
// along D, 16-byte aligned rows -> out bf16 [3, B, L, N, 128] contiguous,
// the three parts (x = out[0] + out[1] + out[2] + O(2^-27 |x|)).
int univid_split_bf16x3(const void* x, void* out, int B, int L, int N, long long sb,
                        long long sl, long long sh, void* stream) {
  if (B <= 0 || L <= 0 || N <= 0 || !aligned16(x) || sb % 4 || sl % 4 || sh % 4 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)B * L * N * 32;
  long long blocks = (n4 + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond
  split_bf16x3_kernel<<<(unsigned)blocks, SPLIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<bf16*>(out), L, N, sb, sl, sh, n4);
  return (int)cudaGetLastError();
}

// The forward. qp, kp, vp: the split parts (univid_split_bf16x3) of the
// folded q [B, lq, N, 128] and of k, v [B, lk, N, 128], 16-byte aligned.
// o fp32 [B, lq, N, 128] with element strides o_st = (b, l, h), unit
// stride along D, 8-byte aligned rows. kv_len int32 [B] on the device or
// null; bound null (running max) or the folded score bound, an fp32 scalar
// on the device; lse null or fp32 [B, N, lq] contiguous. lq, lk multiples
// of 64.
int univid_flash_fwd_f32_sm90(const void* qp, const void* kp, const void* vp, void* o,
                              const void* kv_len, const void* bound, void* lse, int B, int N,
                              int lq, int lk, const long long* o_st, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || B <= 0 || N <= 0 ||
      !aligned16(qp) || !aligned16(kp) || !aligned16(vp))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!parts_map(&qm, qp, B, lq, N, F_BM) || !parts_map(&km, kp, B, lk, N, KT) ||
      !parts_map(&vm, vp, B, lk, N, KT))
    return (int)cudaErrorInvalidValue;
  auto kern = bound != nullptr ? flash_fwd_f32_sm90_kernel<true> : flash_fwd_f32_sm90_kernel<false>;
  cudaError_t err = prepare(kern, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lq + F_BM - 1) / F_BM, B * N);
  kern<<<grid, THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<float*>(o), static_cast<const int*>(kv_len),
      static_cast<const float*>(bound), static_cast<float*>(lse), B, N, lq, lk, o_st[0], o_st[1],
      o_st[2]);
  return (int)cudaGetLastError();
}

// dq and delta. qp, kp, vp, dop: the split parts of the folded qs, k, v and
// dO (16-byte aligned). o, dout: fp32 [B, lq, N, 128] (16-byte aligned
// rows); dq fp32 [B, lq, N, 128] (8-byte aligned rows); element strides st
// = (o, dout, dq) x (b, l, h). lse fp32 [B, N, lq] from the forward; delta
// fp32 [B, N, lq] contiguous, written here; kv_len int32 [B] or null.
int univid_flash_bwd_dq_f32_sm90(const void* qp, const void* kp, const void* vp, const void* dop,
                                 const void* o, const void* dout, const void* lse,
                                 const void* kv_len, void* dq, void* delta, int B, int N, int lq,
                                 int lk, float scale, const long long* st, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || B <= 0 || N <= 0 ||
      !aligned16(qp) || !aligned16(kp) || !aligned16(vp) || !aligned16(dop))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, dm, km, vm;
  if (!parts_map(&qm, qp, B, lq, N, R_BM) || !parts_map(&dm, dop, B, lq, N, R_BM) ||
      !parts_map(&km, kp, B, lk, N, KT) || !parts_map(&vm, vp, B, lk, N, KT))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_f32_sm90_kernel;
  cudaError_t err = prepare(kern, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lq / R_BM, B * N);
  kern<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, dm, km, vm, static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const int*>(kv_len), static_cast<float*>(dq),
      static_cast<float*>(delta), B, N, lq, lk, scale, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

// dk and dv. qp, kp, vp, dop as for the dq kernel; lse and the dq kernel's
// delta, fp32 [B, N, lq] contiguous, 16-byte aligned; dk, dv fp32 [B, lk,
// N, 128] (8-byte aligned rows) with element strides st = (dk, dv) x (b, l,
// h). kv tiles at or past kv_len are written as zeros.
int univid_flash_bwd_dkv_f32_sm90(const void* qp, const void* kp, const void* vp,
                                  const void* dop, const void* lse, const void* delta,
                                  const void* kv_len, void* dk, void* dv, int B, int N, int lq,
                                  int lk, const long long* st, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || B <= 0 || N <= 0 ||
      !aligned16(qp) || !aligned16(kp) || !aligned16(vp) || !aligned16(dop) ||
      !aligned16(lse) || !aligned16(delta))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, dm, km, vm;
  if (!parts_map(&qm, qp, B, lq, N, KT) || !parts_map(&dm, dop, B, lq, N, KT) ||
      !parts_map(&km, kp, B, lk, N, R_BM) || !parts_map(&vm, vp, B, lk, N, R_BM))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_f32_sm90_kernel;
  cudaError_t err = prepare(kern, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lk / R_BM, B * N);
  kern<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, dm, km, vm, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<float*>(dk), static_cast<float*>(dv), B, N, lq,
      lk, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

}  // extern "C"
