// int8 QK^T flash attention forward rebuilt for Hopper (sm_90a) on s8
// wgmma, TMA multicast and warp specialisation: the qk_int8 mode of
// univid_tpu/kernels/flash_attention.py::_flash_kernel (:44; :104-105,
// :137-156, :213-233), with its softmax_bf16 chain (:259-265) composed: the
// Wan serving knobs --qk_int8 and --qk_int8 --bf16_softmax. Every card call
// of flash_attention_int8() runs it; flash_attention_int8.cu keeps the
// pre-pass (quant_q_kernel, quant_k_kernel) that writes its operands, and
// its mma.sync attention kernel as the same-call baseline.
//
// The function is the mma.sync kernel's, score for score:
//   * s32 = qi ki^T on the int8 tensor cores (s8 x s8 -> s32, exact);
//   * s = float(s32) * (sq_row * akq_block), the two products rounded in
//     that order; float(s32) exact either way (s32_to_float): I2F, or the
//     magic-number add (|s32| <= 128 * 127 * 127 = 2,064,512 < 2^22, so the
//     integer add s32 + 0x4B400000, the bits of 1.5 * 2^23, is the bit
//     pattern of the float 1.5 * 2^23 + s32, and one exact fp32 subtraction
//     of 1.5 * 2^23 leaves float(s32));
//   * the kv_len mask on the fp32 s (only the tail tile compares);
//   * the bounded or running-max softmax of bf16_tiles.cuh, fp32 or bf16
//     chain, with softmax_tile's rounding points (softmax_pack below rounds
//     two values per conversion instruction, takes the bounded bf16
//     chain's s - ref as one packed bf16 fma, and writes p straight into
//     the A fragments of p v), then store_rows: the output divided by l,
//     exactly 0 where l = 0 (kv_len = 0 rows).
// Only the exp2's approximation, the summation order and p's rounding
// against a running max over 128-key tiles (not 64) differ from the plain
// version (attention_int8_plain). ex2.approx.ftz.bf16x2 would take the
// packed bf16 s - ref at once, but it does not round as round_bf16 of the
// fp32 ex2 does for every bf16 input, so the bf16 chain keeps the fp32
// ex2.
//
// What bounds it: at the ti2v-5B shape ([2, 28672, 24, 128], kv 27,280)
// QK^T at the int8 rate (1,979 TOPS) takes 4.86 ms and p v at the bf16 rate
// 9.72 ms: 14.57 ms of tensor-core time. Each of the 3.75e10 live scores
// also needs one exp2 and, for p v, a bf16 conversion on the XU (16 a
// clock an SM: ~10 ms for the exp2 alone), and 4-7 integer and fp32
// instructions (conversion, scale, s - ref, l); the bf16 chain three bf16
// roundings. Measured (PERF.md §6): the kernel sits near the time of
// that per-score work plus the products, not near the tensor-core bound;
// the k / v tiles' traffic from L2 (110 GB a call at 128-row q tiles) set
// an 18 ms floor of its own before the clusters below halved it.
//
// Design (flash_attention_sm90.cu's, with int8 operands):
//   * one block of three warpgroups per (b*h, 128-row q tile): warpgroup 0
//     the producer (one thread issues every TMA load; setmaxnreg.dec 24),
//     warpgroups 1 and 2 consumers of 64 q rows each (setmaxnreg.inc 240);
//   * clusters of CLUSTER = 2 blocks, two q tiles of one head: each block
//     loads half of every k tile (64 rows) and of every v tile (64
//     columns) and multicasts it into both, so each byte of k and v leaves
//     L2 once a 256-row pair; a stage is refilled once every consumer warp
//     of the pair released it (remote mbarrier arrivals, predicated: no
//     branch between a product's issue and its wait). A block whose q tile
//     lies past Lq (odd q-tile counts) loads nothing and its peer loads
//     whole tiles alone; both meet at a cluster barrier before they exit;
//   * shared memory: the q codes [128, 128] (16 KB) once; rings of STAGES
//     = 2 k-code tiles [128 keys, 128] (16 KB: a 128-code row is one
//     128-byte swizzle row, so an int8 tile is one sub-tile) and bf16 v
//     tiles [128, 128] (32 KB, two [128, 64] sub-tiles): 112 KB; full and
//     empty mbarriers per stage. The codes come through 3-D tensor maps
//     (128 bytes, rows, b*h) of CU_TENSOR_MAP_DATA_TYPE_UINT8, 128-byte
//     swizzle, boxes of 128 q rows and 64 k rows; rows past Lq or Lk read
//     as zeros;
//   * s = q k^T: wgmma m64n128k32 s32.s8.s8, both operands K-major in
//     shared memory (8-bit wgmma has no transpose), 4 k-steps of 32 bytes
//     (the bf16 descriptor's 32-byte advance); the s32 fragment has the f32
//     layout, so the softmax and the epilogue are the bf16 kernel's;
//   * float(s32): I2F in the fp32 chain, whose exp2 and one conversion a
//     pair leave the XU room while the integer pipe is the busier one; the
//     magic-number add in the bf16 chain, whose three roundings fill the
//     XU;
//   * the k scale: one per JAX kv block of bw keys, bw a multiple of 64, so
//     each 64-key half of a 128-key tile lies in one block: n-tiles 0-7 take
//     akq[kv0 / bw], 8-15 akq[(kv0 + 64) / bw] (a tile may straddle two
//     blocks, as at bw = 192), loaded a tile ahead;
//   * o += p v: p as register A fragments, v MN-major (the transpose
//     flag), two m64n64k16 products per 16 keys;
//   * overlap: s_{j+1} = q k_{j+1}^T and acc += p_j v_j are issued back to
//     back, so the conversion and softmax of s_{j+1} run under p_j v_j; the
//     last tile's p v is peeled off the loop (no branch between a product's
//     issue and its wait: C7514);
//   * ragged edges: Lq is a multiple of 64, so the last q tile may have
//     one live consumer (the empty barriers count only live consumers'
//     warps); kv tiles at or past kv_len are never loaded.
// Each of these choices was timed on the card against its alternative (a
// third stage, blocks without clusters, I2F or the magic add in both
// chains, the fp32 s - ref then a rounding) at the path's shapes, and was
// the faster or level (PERF.md §6).

#include <cuda.h>

#include "bf16_tiles.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int I_BM = 128;         // q rows per block (two consumers of 64)
constexpr int I_BN = 128;         // kv rows per tile
constexpr int I_THREADS = 384;    // producer + two consumer warpgroups
constexpr int ROW = 128;          // bytes of an int8 code row (d = 128)
constexpr int STAGES = 2;         // k / v ring depth
constexpr int CLUSTER = 2;        // q tiles sharing a k / v load
constexpr int PARTS = 2;          // TMA boxes a k tile (64 rows) and a v tile (64 columns)
constexpr uint32_t Q_BYTES = I_BM * ROW;
constexpr uint32_t K_BYTES = I_BN * ROW;
constexpr uint32_t V_BYTES = 2 * I_BN * SUB * 2;
// float(s32) for |s32| < 2^22: the bits of 1.5 * 2^23 + s32, minus 1.5 * 2^23
constexpr uint32_t MAGIC_BITS = 0x4B400000u;
constexpr float MAGIC = 12582912.0f;

static_assert(CLUSTER == PARTS, "one part of each k / v tile a block");

struct Smem {
  int8_t q[I_BM * ROW];
  int8_t k[STAGES][I_BN * ROW];
  __nv_bfloat16 v[STAGES][2][I_BN * SUB];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;   // + alignment slack

// a [128 rows, 128 bytes] box of a 3-D (bytes, rows, b*h) int8 tensor map
__device__ __forceinline__ void tma_load_codes(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// the same box into the shared memory of every block of the cluster in
// `mask`, at the same offset, completing on each block's `bar`
__device__ __forceinline__ void tma_load_codes_mc(void* dst, const CUtensorMap* map,
                                                  uint64_t* bar, int row, int bh,
                                                  uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(bh),
      "h"(mask)
      : "memory");
}

// a [box rows, 64 columns] box of a 4-D (D, heads, rows, batch) bf16 map,
// multicast as tma_load_codes_mc
__device__ __forceinline__ void tma_load_mc(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int head, int row, int batch,
                                            uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "h"(mask)
      : "memory");
}

// where `pred`: arrive on the barrier at `bar`'s offset in block `rank` of
// the cluster (predicated, not branched: the releases sit between a
// product's issue and its wait)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 remote;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(rank), "r"((int)pred)
      : "memory");
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// d[64] (+)= A (smem, K-major) * B (smem, K-major): wgmma m64n128k32, s8 in,
// s32 out (8-bit wgmma takes no transpose flag and no operand scales)
__device__ __forceinline__ void wgmma_s8_m64n128(uint32_t* d, uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// float(s32), exact either way (|s32| < 2^22): I2F on the XU (the exp2's
// and the bf16 conversions' unit), or the magic-number add on the integer
// and fp32 pipes. The fp32 chain leaves the XU room and fills the integer
// pipe, the bf16 chain the reverse (PERF.md §6)
template <bool SBF16>
__device__ __forceinline__ float s32_to_float(uint32_t v) {
  return SBF16 ? __fsub_rn(__uint_as_float(v + MAGIC_BITS), MAGIC) : __int2float_rn((int)v);
}

// a and b rounded to the nearest bf16 (ties to even) by one conversion;
// returns the pair packed as a bf16x2 (a low), a and b become the rounded
// values as fp32
__device__ __forceinline__ uint32_t round_pair(float& a, float& b) {
  const uint32_t u = pack_bf16(a, b);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xFFFF0000u);
  return u;
}

// softmax_tile (bf16_tiles.cuh) for one 128-key tile of scores s[16][4],
// with its rounding points, writing p as the bf16 A fragments of p v
// (pn[kk] holds keys 16 kk .. 16 kk + 15) instead of back into s. MODE
// BOUNDED: reference point c_bound; RUNNING: the running max m_r grows,
// l_r is rescaled here and the caller rescales the accumulator. SBF16: s,
// the reference, s - ref and p each round to bf16 (p's rounding is its
// packing), l adds the rounded p in fp32; fp32 chain: p = exp2(s - ref) in
// fp32, added to l unrounded, rounded to bf16 only for p v.
template <int MODE, bool SBF16>
__device__ __forceinline__ void softmax_pack(float (*s)[4], float* m_r, float* l_r,
                                             float c_bound, uint32_t (*pn)[4]) {
  if (SBF16 && MODE == BOUNDED) {
    // the bounded bf16 chain on packed pairs: s rounds by its packing, and
    // s - ref is one fma.rn.bf16x2 (ref * -1 + s, rounded once). For two
    // bf16 values that equals round_bf16 of their fp32 difference: the
    // fp32 difference is exact unless one operand is below 2^-16 of the
    // other, and then both roundings give the larger one
    // (tests/test_torch_int8_sm90.py)
    const uint32_t ref2 = pack_bf16(c_bound, c_bound);   // ref rounded to bf16
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      uint32_t u[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t d;
        asm("fma.rn.bf16x2 %0, %1, %2, %3;"
            : "=r"(d)
            : "r"(ref2), "r"(0xBF80BF80u), "r"(pack_bf16(s[n][2 * i], s[n][2 * i + 1])));
        float a = fast_exp2(__uint_as_float(d << 16));
        float b = fast_exp2(__uint_as_float(d & 0xFFFF0000u));
        u[i] = round_pair(a, b);
        l_r[i] += a + b;
      }
      pn[n / 2][2 * (n & 1)] = u[0];
      pn[n / 2][2 * (n & 1) + 1] = u[1];
    }
    return;
  }
  if (SBF16) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      round_pair(s[n][0], s[n][1]);
      round_pair(s[n][2], s[n][3]);
    }
  }
  if (MODE == RUNNING) {
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      mc[0] = fmaxf(mc[0], fmaxf(s[n][0], s[n][1]));
      mc[1] = fmaxf(mc[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffff, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffff, mc[i], 2));
      const float m_new = fmaxf(m_r[i], mc[i]);
      l_r[i] *= fast_exp2(m_r[i] - m_new);
      m_r[i] = m_new;
    }
  }
  float ref[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ref[i] = (MODE == BOUNDED) ? c_bound : m_r[i];
    if (SBF16) ref[i] = round_bf16(ref[i]);
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    uint32_t u[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float a = s[n][2 * i] - ref[i], b = s[n][2 * i + 1] - ref[i];
      if (SBF16) round_pair(a, b);
      a = fast_exp2(a);
      b = fast_exp2(b);
      u[i] = SBF16 ? round_pair(a, b) : pack_bf16(a, b);
      l_r[i] += a + b;
    }
    pn[n / 2][2 * (n & 1)] = u[0];
    pn[n / 2][2 * (n & 1) + 1] = u[1];
  }
}

// live consumers of the q tile at q0: 64-row halves below lq
__device__ __forceinline__ int live_consumers(int q0, int lq) {
  return (q0 < lq) + (q0 + 64 < lq);
}

template <int MODE, bool SBF16>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(I_THREADS, 1)
flash_fwd_int8_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const float* __restrict__ sq, const float* __restrict__ akq,
                           __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
                           const float* __restrict__ bound, int n_heads, int lq, int lk, int bw,
                           int nblk, long long o_sb, long long o_sl, long long o_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles need 1024-byte aligned shared addresses (the same
  // offset in both blocks of the cluster: multicast writes there)
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const uint32_t rank = blockIdx.x % CLUSTER;   // cluster dims (CLUSTER, 1, 1)
  const int q0 = blockIdx.x * I_BM;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + I_BN - 1) / I_BN;   // the same in both blocks
  const int n_cons = live_consumers(q0, lq);
  // both blocks compute: each loads its share of every k and v tile into
  // both. A block whose q tile lies past lq (the last cluster when the q
  // tiles are odd) loads and computes nothing, and its peer loads alone
  const int n_peer = live_consumers((blockIdx.x ^ 1) * I_BM, lq);
  const bool shared = n_cons > 0 && n_peer > 0;
  // arrivals that release a stage: each consumer warp of the cluster
  // arrives once on each block's barrier when shared, else CLUSTER times on
  // its own block's
  const int release_warps = 4 * (shared ? n_cons + n_peer : CLUSTER * n_cons);

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], release_warps);
      mbar_init(&sm.v_empty[s], release_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // every barrier of the cluster is initialised

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----------------------
    // a stage is refilled once every consumer warp that reads it (both
    // blocks' when shared) released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && n_tiles > 0 && n_cons > 0) {
      const uint16_t mask = shared ? (1u << CLUSTER) - 1 : 1u << rank;
      const int part0 = shared ? (int)rank : 0, parts = shared ? 1 : PARTS;
      mbar_expect_tx(&sm.q_full, Q_BYTES);
      tma_load_codes(sm.q, &q_map, &sm.q_full, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        mbar_wait(&sm.k_empty[st], parity);
        mbar_expect_tx(&sm.k_full[st], K_BYTES);
        // k rows 64 p .. 64 p + 63 of the tile, v columns 64 p .. 64 p + 63
        for (int p = part0; p < part0 + parts; ++p)
          tma_load_codes_mc(&sm.k[st][p * (I_BN / PARTS) * ROW], &k_map, &sm.k_full[st],
                            j * I_BN + p * (I_BN / PARTS), bh, mask);
        mbar_wait(&sm.v_empty[st], parity);
        mbar_expect_tx(&sm.v_full[st], V_BYTES);
        for (int p = part0; p < part0 + parts; ++p)
          tma_load_mc(sm.v[st][p], &v_map, &sm.v_full[st], SUB * p, h, j * I_BN, b, mask);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    if (c < n_cons) {   // else every row of this warpgroup lies past lq
      const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
      const int row0 = q0 + 64 * c + 16 * w;   // this warp's first q row
      const float c_bound = (MODE == BOUNDED) ? *bound : 0.f;   // folded bound

      float acc[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
      // per-thread partial row sums (rows g and g + 8), reduced over the
      // quad at the end; m_r: the running max (RUNNING)
      float l_r[2] = {0.f, 0.f};
      float m_r[2] = {NEG_INF, NEG_INF};

      if (n_tiles > 0) {
        // the q scales of this thread's rows g and g + 8, and this head's
        // k scales
        const float* sqp = sq + (long long)bh * lq + row0 + g;
        const float sq_r[2] = {__ldg(sqp), __ldg(sqp + 8)};
        const float* akp = akq + (long long)bh * nblk;
        mbar_wait(&sm.q_full, 0);
        int kit = 0, vit = 0;
        uint32_t si[64];     // s32 = q k^T (the wgmma accumulator)
        float s[16][4];      // the fp32 scores, then p
        uint32_t pa[8][4];   // p as wgmma A fragments (bf16 pairs), in flight
        uint32_t pn[8][4];   // the next tile's p
        float ak[2];         // the k scales of the next tile's two halves
        // the stage's buffer is read: release it in every block that loads
        // into it
        auto release = [&](uint64_t* bar) {
#pragma unroll
          for (int r = 0; r < CLUSTER; ++r)
            mbar_arrive_cluster(bar, shared ? r : rank, lane == 0);
        };
        // k scales of tile j's 64-key halves, loaded before they are needed
        auto ak_load = [&](int j) {
          const int kv0 = j * I_BN;
          ak[0] = __ldg(akp + kv0 / bw);
          ak[1] = __ldg(akp + min((kv0 + 64) / bw, nblk - 1));
        };
        // issue s32 = q k^T for the next k tile (async); returns its stage
        auto qk_issue = [&]() {
          const int st = kit % STAGES;
          mbar_wait(&sm.k_full[st], (kit / STAGES) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < ROW / 32; ++kk)
            wgmma_s8_m64n128(si, sw128_desc(&sm.q[64 * c * ROW + 32 * kk], 1, 64),
                             sw128_desc(&sm.k[st][32 * kk], 1, 64), kk);
          wgmma_commit();
          ++kit;
          return st;
        };
        // once the product landed for kv tile j: release the k stage, then
        // s = float(s32) * (sq_row * akq_block) and the kv_len mask
        // (-1e30) on the tail tile
        auto qk_done = [&](int st, int j) {
          fence_regs<64>(si);
          release(&sm.k_empty[st]);
          const int kv0 = j * I_BN;
          float fac[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) fac[i][hf] = __fmul_rn(sq_r[i], ak[hf]);
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = __fmul_rn(s32_to_float<SBF16>(si[4 * n + e]), fac[e >> 1][n >> 3]);
          if (kv0 + I_BN > kv_end) {   // the tail tile: one uniform branch
#pragma unroll
            for (int n = 0; n < 16; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (kv0 + n * 8 + 2 * t + (e & 1) >= kv_end) s[n][e] = NEG_INF;
          }
        };
        // acc += p_j v_j for the tile in stage `vst` (async; committed)
        auto pv_issue = [&](int vst) {
          wgmma_fence();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              // v rows 16 kk .. 16 kk + 15 of sub-tile hf (d 64 hf ..)
              wgmma_rs_m64n64_tb(&acc[8 * hf][0], pa[kk],
                                 sw128_desc(&sm.v[vst][hf][16 * kk * SUB], 64, 64));
          wgmma_commit();
        };
        auto pv_done = [&](int vst) {
          fence_regs<64>(&acc[0][0]);
          fence_regs<32>(&pa[0][0]);
          release(&sm.v_empty[vst]);
          ++vit;
        };
        auto take_p = [&]() {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
        };

        // tile 0's scores and p, then per tile j: issue s_{j+1} = q
        // k_{j+1}^T and acc += p_j v_j back to back; the conversion and
        // softmax of s_{j+1} run while p_j v_j is on the tensor cores. The
        // running max's rescale of acc waits for that product
        {
          ak_load(0);
          const int st = qk_issue();
          wgmma_wait<0>();
          qk_done(st, 0);
          softmax_pack<MODE, SBF16>(s, m_r, l_r, c_bound, pn);
          take_p();
        }
        for (int j = 0; j + 1 < n_tiles; ++j) {
          const int vst = vit % STAGES;
          ak_load(j + 1);
          mbar_wait(&sm.v_full[vst], (vit / STAGES) & 1);
          const int kst = qk_issue();   // s_{j+1}
          pv_issue(vst);                // acc += p_j v_j
          const float m_old[2] = {m_r[0], m_r[1]};
          wgmma_wait<1>();   // s_{j+1} landed; p_j v_j may still run
          qk_done(kst, j + 1);
          softmax_pack<MODE, SBF16>(s, m_r, l_r, c_bound, pn);
          wgmma_wait<0>();
          pv_done(vst);
          if (MODE == RUNNING) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float corr = fast_exp2(m_old[i] - m_r[i]);
#pragma unroll
              for (int n = 0; n < 16; ++n) {
                acc[n][2 * i] *= corr;
                acc[n][2 * i + 1] *= corr;
              }
            }
          }
          take_p();
        }
        {   // the last tile's p v
          const int vst = vit % STAGES;
          mbar_wait(&sm.v_full[vst], (vit / STAGES) & 1);
          pv_issue(vst);
          wgmma_wait<0>();
          pv_done(vst);
        }
      }
      store_rows<MODE, 16>(acc, l_r, m_r, c_bound, nullptr,
                           o + b * o_sb + h * o_sh + (long long)row0 * o_sl, o_sl, g, t);
    }
  }
  // no block leaves while the other may still write into its shared
  // memory or arrive on its barriers
  cluster_sync();
}

// int8 codes [bh, rows, 128] contiguous as a 3-D map (128 bytes, rows, bh)
// of [box_rows, 128 bytes] boxes, 128-byte swizzle, rows past `rows` zeros
bool make_code_map(CUtensorMap* map, const void* base, int rows, int bh, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)ROW, (cuuint64_t)rows, (cuuint64_t)bh};
  cuuint64_t strides[2] = {(cuuint64_t)ROW, (cuuint64_t)rows * ROW};
  cuuint32_t box[3] = {(cuuint32_t)ROW, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, bool SBF16>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const void* sq, const void* akq, void* o, const void* kv_len,
                   const void* bound, int B, int N, int lq, int lk, int bw, int q_tiles,
                   const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_int8_sm90_kernel<MODE, SBF16>;
  // setmaxnreg moves registers between the block's warpgroups: the block
  // must start with at least what the producer (24) and the consumers
  // (240) end with, or the consumers' setmaxnreg.inc would wait forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * I_THREADS < 128 * 24 + 256 * 240) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int nblk = (lk + bw - 1) / bw;
  // whole clusters: a block past lq loads its share and computes nothing
  dim3 grid((q_tiles + CLUSTER - 1) / CLUSTER * CLUSTER, B * N);
  kern<<<grid, I_THREADS, SMEM_BYTES, stream>>>(
      qm, km, vm, static_cast<const float*>(sq), static_cast<const float*>(akq),
      static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len),
      static_cast<const float*>(bound), N, lq, lk, bw, nblk, st[3], st[4], st[5]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The attention on the pre-pass's operands (univid_quant_q_int8 /
// univid_quant_k_int8 of flash_attention_int8.cu): qi int8 [B, N, lq, 128]
// and ki int8 [B, N, lk, 128], contiguous and 16-byte aligned; sq fp32
// [B, N, lq]; akq fp32 [B, N, ceil(lk / bw)], bw a multiple of 64. v, o:
// bf16 [B, L, N, 128], element strides st = (v_b, v_l, v_h, o_b, o_l, o_h),
// unit along D; v 16-byte aligned with strides that are multiples of 8
// elements (TMA's rules; the Python wrapper checks them). lq and lk are
// multiples of 64; q_tiles = ceil(lq / 128). kv_len: int32 [B] on the
// device, or null. mode: 0 bounded (*bound, the folded score bound, fp32 on
// the device), 1 running max. softmax_bf16: the bf16 softmax chain.
int univid_flash_fwd_int8_sm90(const void* qi, const void* sq, const void* ki, const void* akq,
                               const void* v, void* o, const void* kv_len, const void* bound,
                               int mode, int softmax_bf16, int B, int N, int lq, int lk, int bw,
                               int q_tiles, const long long* st, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || bw <= 0 || bw % 64 != 0 ||
      q_tiles != (lq + I_BM - 1) / I_BM || (mode == BOUNDED && bound == nullptr) ||
      reinterpret_cast<uintptr_t>(qi) % 16 != 0 || reinterpret_cast<uintptr_t>(ki) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_code_map(&qm, qi, lq, B * N, I_BM) ||
      !make_code_map(&km, ki, lk, B * N, I_BN / PARTS) ||
      !make_map(&vm, v, B, lk, N, st, I_BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UNIVID_INT8_SM90_LAUNCH(M, SB) \
  launch<M, SB>(qm, km, vm, sq, akq, o, kv_len, bound, B, N, lq, lk, bw, q_tiles, st, s)
  if (mode == BOUNDED)
    return softmax_bf16 ? (int)UNIVID_INT8_SM90_LAUNCH(BOUNDED, true)
                        : (int)UNIVID_INT8_SM90_LAUNCH(BOUNDED, false);
  if (mode == RUNNING)
    return softmax_bf16 ? (int)UNIVID_INT8_SM90_LAUNCH(RUNNING, true)
                        : (int)UNIVID_INT8_SM90_LAUNCH(RUNNING, false);
#undef UNIVID_INT8_SM90_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
