// Flash attention forward for Hopper, bf16 in and out, rebuilt on wgmma,
// TMA and warp specialisation (sm_90a). The unmasked modes of the bf16
// forward: flash_attention.cu keeps the causal, segment and packed ones.
//
// Replaces two Pallas TPU kernels of univid_tpu/kernels/flash_attention.py
// in these modes (all at D = 128, k and v with N / group heads):
//   * _flash_kernel (:44): the bounded softmax p = exp2(s - C) with no max
//     and no rescale (DiT self-attention after the rope pre-pass
//     univid_rope_rotate_bf16 of flash_attention.cu), or the running max
//     (BAGEL's ViT append over the KV cache, 28 query heads over 4 kv
//     heads); kv_len masking; its save_residuals mode (:343-352), the
//     training forward, with the exp2-domain lse C + log2 l or m + log2 l,
//     +1e30 where l = 0, as fp32 [B, N, Lq];
//   * _cross_kernel (:355): Lk <= 512 keys with the bound, or the one-shot
//     softmax (the exact row max over every live key first, then p against
//     it), with and without kv_len;
//   * the softmax_bf16 chain of both (:259-265, :402-403) in the bounded,
//     running and one-shot modes: softmax_tile of bf16_tiles.cuh, with its
//     rounding points.
// The arithmetic is flash_attention.cu's: scores in the exp2 domain with
// softmax_scale * log2 e folded into q (or its rope tables), p rounded to
// bf16 before p v, l and the accumulator in fp32, the output divided by l
// and exactly 0 where l = 0 (kv_len = 0 rows). kv tiles at or past kv_len
// are never loaded; only the tail tile compares and selects.
//
// What bounds it: at the DiT's self-attention shapes (t2v-1.3B [2, 32768,
// 12, 128], ti2v-5B [2, 28672, 24, 128]) the work is 4 L^2 d flops a head
// against 4 L d bytes, ~16k flops a byte: the tensor cores bound it (19.44
// ms at the 5B shape at 989 TFLOP/s). The Ampere form (mma.sync m16n8k16
// over 64 x 64 tiles with cp.async and two block barriers a tile) reached
// 28% of that peak: mma.sync does not reach Hopper's tensor-core rate, and
// each warp re-read whole k and v tiles from shared memory for 16 q rows.
//
// Design:
//   * one block of three warpgroups per (b*h, 128-row q tile): warpgroup 0
//     is the producer, one elected thread issues every TMA load and the
//     warpgroup gives its registers away (setmaxnreg.dec 24); warpgroups 1
//     and 2 are consumers of 64 q rows each (setmaxnreg.inc 240);
//   * shared memory: the q tile [128, 128] bf16 once, and rings of two
//     stages of k and of v tiles [128, 128], each tile as two [128, 64]
//     sub-tiles of 128-byte rows with the 128-byte swizzle that TMA writes
//     and wgmma reads (160 KB); full and empty mbarriers per stage, the
//     full ones completed by TMA's transaction count, the empty ones by one
//     arrival per consumer warp;
//   * s = q k^T: wgmma m64n128k16, q and k from shared memory (K-major),
//     8 k-steps into 64 fp32 registers a thread. A warp's m64nN fragment is
//     the m16n8 fragment of mma.sync repeated over N / 8, so the softmax,
//     the epilogue and their rounding points are bf16_tiles.cuh's
//     (softmax_tile, store_rows) unchanged;
//   * o += p v: p converts in registers to wgmma's A fragments (no trip
//     through shared memory); v [kv, d] row-major is B in MN-major form
//     (the transpose flag), two m64n64k16 products per 16 keys;
//   * overlap: the producer keeps up to two k and two v tiles in flight
//     ahead of the consumers; two consumer warpgroups share the SM, so one's
//     softmax overlaps the other's products; and within a warpgroup
//     s_{j+1} = q k_{j+1}^T and acc += p_j v_j are issued back to back, so
//     the softmax of s_{j+1} runs while p_j v_j is on the tensor cores (the
//     running max's rescale of acc waits for that product). The last tile's
//     p v is peeled off the loop: with a branch around the s_{j+1} product
//     ptxas serialised every wgmma (C7514);
//   * ragged edges: Lq and Lk are multiples of 64. TMA zero-fills rows past
//     L; the tail kv tile is masked at kv_len (<= Lk); a consumer whose 64
//     rows all lie past Lq (the last q tile when Lq % 128 = 64) leaves at
//     once and the empty barriers count only the live consumers' warps;
//   * the tensor maps (4-D: D, heads, rows, batch, from the tensors'
//     strides, so strided views of a KV cache or a fused projection are
//     read in place) are built on the host with cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPointByVersion (no -lcuda), and
//     passed as __grid_constant__ kernel parameters.

#include <cuda.h>

#include "bf16_tiles.cuh"

namespace {

constexpr int H_BM = 128;        // q rows per block (two consumers of 64)
constexpr int H_BN = 128;        // kv rows per tile
constexpr int H_STAGES = 2;      // k and v ring depth
constexpr int H_THREADS = 384;   // producer + two consumer warpgroups
constexpr int SUB = 64;          // bf16 columns of a 128-byte swizzled row
constexpr uint32_t SUB_BYTES = H_BN * SUB * 2;   // one [128, 64] sub-tile
constexpr uint32_t TILE_BYTES = 2 * SUB_BYTES;   // a [128, 128] tile

struct Smem {
  __nv_bfloat16 q[2][H_BM * SUB];
  __nv_bfloat16 k[H_STAGES][2][H_BN * SUB];
  __nv_bfloat16 v[H_STAGES][2][H_BN * SUB];
  uint64_t q_full;
  uint64_t k_full[H_STAGES], k_empty[H_STAGES];
  uint64_t v_full[H_STAGES], v_empty[H_STAGES];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + 1024;   // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a [128 rows, 64 columns] box of a 4-D (D, heads, rows, batch) tensor map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)(lbo & 0x3FFF) << 16;
  d |= (uint64_t)(sbo & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running (in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of registers an async wgmma writes
// (or writes of registers it reads) across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64] (+)= A (smem, K-major) * B (smem, K-major): wgmma m64n128k16, bf16 in, fp32 out
__device__ __forceinline__ void wgmma_ss_m64n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A (registers, bf16 fragments) * B (smem, MN-major): wgmma m64n64k16
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float* d, const uint32_t* a, uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int MODE, bool SBF16>
__global__ void __launch_bounds__(H_THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
                      const float* __restrict__ bound, float* __restrict__ lse, int group,
                      int n_heads, int lq, int lk, long long o_sb, long long o_sl,
                      long long o_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles need 1024-byte aligned shared addresses
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int hk = h / group;   // the kv head this query head reads
  const int q0 = blockIdx.x * H_BM;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int n_tiles = (kv_end + H_BN - 1) / H_BN;
  const int n_cons = (q0 + 64 < lq) ? 2 : 1;   // consumers with rows below lq

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < H_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 4 * n_cons);
      mbar_init(&sm.v_empty[s], 4 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(&sm.q_full, 2 * H_BM * SUB * 2);
      tma_load(sm.q[0], &q_map, &sm.q_full, 0, h, q0, b);
      tma_load(sm.q[1], &q_map, &sm.q_full, SUB, h, q0, b);
      int kit = 0, vit = 0;
      // wait until the consumers freed the stage, then load the tile into it
      auto load = [&](const CUtensorMap* map, __nv_bfloat16 (*ring)[2][H_BN * SUB],
                      uint64_t* full, uint64_t* empty, int& it, int j) {
        const int st = it % H_STAGES;
        mbar_wait(&empty[st], ((it / H_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], TILE_BYTES);
        tma_load(ring[st][0], map, &full[st], 0, hk, j * H_BN, b);
        tma_load(ring[st][1], map, &full[st], SUB, hk, j * H_BN, b);
        ++it;
      };
      if (MODE == ONESHOT)   // the row-max pass reads every k tile first
        for (int j = 0; j < n_tiles; ++j) load(&k_map, sm.k, sm.k_full, sm.k_empty, kit, j);
      for (int j = 0; j < n_tiles; ++j) {
        load(&k_map, sm.k, sm.k_full, sm.k_empty, kit, j);
        load(&v_map, sm.v, sm.v_full, sm.v_empty, vit, j);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    if (c >= n_cons) return;   // every row of this warpgroup lies past lq
    const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * c + 16 * w;   // this warp's first q row
    const float c_bound = (MODE == BOUNDED) ? *bound : 0.f;   // folded bound

    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
    // per-thread partial row sums (rows g and g + 8), reduced over the quad
    // at the end; m_r: running max (RUNNING) or row max (ONESHOT)
    float l_r[2] = {0.f, 0.f};
    float m_r[2] = {NEG_INF, NEG_INF};

    if (n_tiles > 0) {
      mbar_wait(&sm.q_full, 0);
      int kit = 0, vit = 0;
      float s[16][4];
      uint32_t pa[8][4];   // p as wgmma A fragments (bf16 pairs)
      // issue s = q k^T for the next k tile (async); returns its stage
      auto qk_issue = [&]() {
        const int st = kit % H_STAGES;
        mbar_wait(&sm.k_full[st], (kit / H_STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < SUB / 16; ++kk)
            wgmma_ss_m64n128(&s[0][0],
                             sw128_desc(&sm.q[hf][64 * c * SUB + 16 * kk], 1, 64),
                             sw128_desc(&sm.k[st][hf][16 * kk], 1, 64), hf | kk);
        wgmma_commit();
        ++kit;
        return st;
      };
      // once the product landed: release the k stage, mask keys at or past
      // kv_end (-1e30) in the tail tile j
      auto qk_done = [&](int st, int j) {
        fence_regs<64>(&s[0][0]);
        if (lane == 0) mbar_arrive(&sm.k_empty[st]);
        const int kv0 = j * H_BN;
        if (kv0 + H_BN > kv_end) {
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (kv0 + n * 8 + 2 * t + (e & 1) >= kv_end) s[n][e] = NEG_INF;
        }
      };
      // p rounded to bf16 (v's dtype): keys 16 kk .. 16 kk + 15 are the
      // n-tiles 2 kk and 2 kk + 1 of s
      auto to_pa = [&]() {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
      };

      if (MODE == ONESHOT) {
        // pass 1: the exact row max over every live key (_cross_kernel's
        // one-shot softmax); pass 2 takes it as each row's reference point
        for (int j = 0; j < n_tiles; ++j) {
          const int st = qk_issue();
          wgmma_wait<0>();
          qk_done(st, j);
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            m_r[0] = fmaxf(m_r[0], fmaxf(s[n][0], s[n][1]));
            m_r[1] = fmaxf(m_r[1], fmaxf(s[n][2], s[n][3]));
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffff, m_r[i], 1));
          m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffff, m_r[i], 2));
        }
      }

      // tile 0's scores and p, then per tile j: issue s_{j+1} = q k_{j+1}^T
      // and acc += p_j v_j back to back; the softmax of s_{j+1} runs while
      // p_j v_j is on the tensor cores. The running max's rescale of acc
      // waits for that product (softmax_tile with no acc, then acc *= corr)
      {
        const int st = qk_issue();
        wgmma_wait<0>();
        qk_done(st, 0);
        softmax_tile<MODE, SBF16, false, 16, 16>(s, m_r, l_r, acc, c_bound);
        to_pa();
      }
      // acc += p_j v_j for the tile in stage `vst` (async; committed)
      auto pv_issue = [&](int vst) {
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            // v rows 16 kk .. 16 kk + 15 of sub-tile hf (d 64 hf .. 64 hf + 63)
            wgmma_rs_m64n64_tb(&acc[8 * hf][0], pa[kk],
                               sw128_desc(&sm.v[vst][hf][16 * kk * SUB], 64, 64));
        wgmma_commit();
      };
      auto pv_done = [&](int vst) {
        fence_regs<64>(&acc[0][0]);
        fence_regs<32>(&pa[0][0]);
        if (lane == 0) mbar_arrive(&sm.v_empty[vst]);
        ++vit;
      };
      for (int j = 0; j + 1 < n_tiles; ++j) {
        const int vst = vit % H_STAGES;
        mbar_wait(&sm.v_full[vst], (vit / H_STAGES) & 1);
        const int kst = qk_issue();   // s_{j+1}
        pv_issue(vst);                // acc += p_j v_j
        const float m_old[2] = {m_r[0], m_r[1]};
        wgmma_wait<1>();   // s_{j+1} landed; p_j v_j may still run
        qk_done(kst, j + 1);
        softmax_tile<MODE, SBF16, false, 16, 0>(s, m_r, l_r, nullptr, c_bound);
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
        to_pa();
      }
      {   // the last tile's p v
        const int vst = vit % H_STAGES;
        mbar_wait(&sm.v_full[vst], (vit / H_STAGES) & 1);
        pv_issue(vst);
        wgmma_wait<0>();
        pv_done(vst);
      }
    }
    // rows past lq never reach here (lq is a multiple of 64)
    store_rows<MODE, 16>(acc, l_r, m_r, c_bound,
                         lse != nullptr ? lse + (long long)bh * lq + row0 + g : nullptr,
                         o + b * o_sb + h * o_sh + (long long)row0 * o_sl, o_sl, g, t);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// bf16 [B, L, N, 128] with element strides (sb, sl, sh) and unit stride
// along D as a 4-D map (D, N, L, B) of [128 rows, 64 columns] boxes, 128-byte
// swizzle, rows past L read as zeros
bool make_map(CUtensorMap* map, const void* base, int B, int L, int N, const long long* st) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {128, (cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  cuuint32_t box[4] = {SUB, 1, H_BN, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, bool SBF16>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
                   const void* kv_len, const void* bound, void* lse, int group, int B, int N,
                   int lq, int lk, int q_tiles, const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_sm90_kernel<MODE, SBF16>;
  // setmaxnreg moves registers between the block's warpgroups: the block
  // must start with at least what the producer (24) and the consumers
  // (240) end with, or the consumers' setmaxnreg.inc would wait forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * H_THREADS < 128 * 24 + 256 * 240) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(q_tiles, B * N);
  kern<<<grid, H_THREADS, SMEM_BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len),
      static_cast<const float*>(bound), static_cast<float*>(lse), group, N, lq, lk, st[9],
      st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: bf16 [B, lq, N, 128]; k, v: bf16 [B, lk, N / group, 128]; element
// strides st = (q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h),
// unit stride along D; q, k and v 16-byte aligned with strides that are
// multiples of 8 elements (TMA's rules; the Python wrapper checks them).
// lq and lk are multiples of 64; q_tiles = ceil(lq / 128) blocks along q.
// kv_len: int32 [B] on the device, or null. mode: 0 bounded (reference point
// *bound, an fp32 scalar on the device), 1 running max, 2 one-shot max.
// lse: null, or fp32 [B, N, lq] contiguous (not with softmax_bf16).
// softmax_bf16: the bf16 softmax chain (softmax_tile in bf16_tiles.cuh).
int univid_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                          const void* kv_len, const void* bound, void* lse, int mode,
                          int softmax_bf16, int group, int B, int N, int lq, int lk, int q_tiles,
                          const long long* st, void* stream) {
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || group < 1 || N % group != 0 ||
      q_tiles != (lq + H_BM - 1) / H_BM || (mode == BOUNDED && bound == nullptr) ||
      (softmax_bf16 && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, lq, N, st) || !make_map(&km, k, B, lk, N / group, st + 3) ||
      !make_map(&vm, v, B, lk, N / group, st + 6))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UNIVID_SM90_LAUNCH(M, SB) \
  launch<M, SB>(qm, km, vm, o, kv_len, bound, lse, group, B, N, lq, lk, q_tiles, st, s)
  if (softmax_bf16) {
    switch (mode) {
      case BOUNDED: return (int)UNIVID_SM90_LAUNCH(BOUNDED, true);
      case RUNNING: return (int)UNIVID_SM90_LAUNCH(RUNNING, true);
      case ONESHOT: return (int)UNIVID_SM90_LAUNCH(ONESHOT, true);
    }
  } else {
    switch (mode) {
      case BOUNDED: return (int)UNIVID_SM90_LAUNCH(BOUNDED, false);
      case RUNNING: return (int)UNIVID_SM90_LAUNCH(RUNNING, false);
      case ONESHOT: return (int)UNIVID_SM90_LAUNCH(ONESHOT, false);
    }
  }
#undef UNIVID_SM90_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
