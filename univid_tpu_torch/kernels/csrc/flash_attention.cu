// Flash attention forward for Hopper (sm_90a), bf16 inputs, fp32 softmax (or
// the bf16 chain of the softmax_bf16 mode), on Ampere's mma.sync.
//
// What it serves on the paths: nothing. Every mode below moved to a Hopper
// kernel: the unmasked modes (bounded, running and one-shot, with kv_len,
// the lse and softmax_bf16) and the segment and packed modes to
// flash_attention_sm90.cu (wgmma, TMA, warp specialisation; the masked
// ones with a block-sparse tile skip), the causal mode (BAGEL's KV-cache
// prefill, with and without the lse) to flash_attention_causal_sm90.cu
// (query heads packed over one k / v stream, a split-kv pass with an lse
// merge); the bf16 rope pre-pass univid_rope_rotate_bf16 gave way to
// kernel A of qk_prepass.cu. Their instantiations here stay compiled,
// reached only through the C entry point, as the same-call baselines of
// chip_smoke.py and the card tests: the causal one is the causal kernel's.
//
// Replaces two Pallas TPU kernels of univid_tpu/kernels/flash_attention.py:
//   * _flash_kernel (:44) in its DiT self-attention mode: fused 3D-RoPE
//     prologue, bounded softmax p = exp2(s - C) with no running max (or the
//     running-max form when no bound is given), kv_len masking with dead
//     kv tiles skipped, zero output rows when l == 0;
//   * _cross_kernel (:355): single-kv-block attention (Lk <= 512) with a
//     one-shot softmax by the row max or by the bound, optional kv_len;
//   * _flash_kernel's save_residuals mode (:343-352), the training forward:
//     with an lse pointer the kernel also writes the per-row exp2-domain
//     log-sum-exp, C + log2 l under the bound, m + log2 l with the running
//     max, +1e30 for rows with l == 0, as fp32 [B, N, Lq] (the TPU's
//     128-lane broadcast of it is a layout device and is not copied). The
//     backward kernels (flash_attention_bwd.cu) rebuild p from it;
//   * _flash_kernel's causal mode with a static q_offset and the dynamic
//     per-batch q_offsets (:161-188, :314-336), BAGEL's KV-cache prefill:
//     query i of batch b sits at row r = i + q_offset + q_offsets[b] and
//     sees key c iff c <= r and c < kv_len[b]. kv tiles that start past the
//     q tile's last row, or at or past kv_len, are never loaded (the TPU's
//     runtime skip); tiles wholly below the diagonal and kv_len run without
//     mask ops; only diagonal and kv_len-tail tiles compare and select.
//     q_offsets is read on the device (never copied to the host).
//   * _flash_kernel's segment and packed modes (:191-210), BAGEL packed
//     training: int32 codes per token, q_seg [B, Lq] and kv_seg [B, Lk]. In
//     the segment mode a query sees the keys of its own id; in the packed
//     mode the codes are pack_mask_codes' (doc << 16 | fn << 8 | nz) and a
//     query at pack index `row` sees the key at `col` iff
//       (row >= col || (fn_q == fn_k && fn_q > 0))
//       && !(nz_k > 0 && nz_q != nz_k) && doc_q == doc_k,
//     the create_sparse_mask predicate (causal text, full ViT / clean VAE
//     splits, noised VAE splits that no other split may read). Every kv tile
//     below kv_len is visited (flash_attention_sm90.cu skips the dead
//     ones); each block reads its 64 q codes once and each tile's 64 kv
//     codes with the k tile. These modes, like the causal one, meet
//     wholly masked tiles before a row's first live key, so a row whose
//     running max is still -1e30 takes the reference point 0 (p = 0, not
//     exp2(0) = 1): rows with no live key at all (the dispatcher's pad ids,
//     q -1 against kv -2) end with l = 0, a zero output and lse +1e30.
//
//   * the softmax_bf16 mode of _flash_kernel (:259-265) and _cross_kernel
//     (:402-403), the Wan serving knob --bf16_softmax, in the bounded,
//     running-max and one-shot modes (not causal, no segments, no lse): the
//     fp32 score tile rounds to bf16, the reference point too, s - ref is a
//     bf16 difference and exp2 gives a bf16 p, which the row sum adds in
//     fp32 (softmax_tile in bf16_tiles.cuh). The exp2 is a true exp2
//     (ex2.approx, then one rounding): the JAX package's CPU lowering of
//     exp2 on bf16, exp(bf16(0.69140625 * x)), is a reference-side caveat
//     and is not copied.
//
// Grouped-query attention: k and v may have N / group heads; query head h
// reads kv head h / group (BAGEL's 28 query heads over 4 kv heads read the
// un-repeated cache, where the JAX package repeats it 7x before its kernel).
//
// What bounds it: at the main-path shape (q, k, v [2, 32768, 12, 128])
// the work is 4*L*L*d flops per head against 4*L*d bytes, ~16k flops per
// byte: the tensor cores bound it. The cross shape (32768 q x 512 kv) is
// also flop-bound, but only by ~2x, so its q/out traffic matters. The
// causal prefill of a short prompt over a long cache (64 q rows over
// ~19k cached rows) reads the cache once per query head, and one block per
// (head, 64 rows) leaves most SMs idle (28 blocks on 132 SMs):
// flash_attention_causal_sm90.cu packs the heads of a kv head and splits
// the keys. The packed-training pack ([1, 4096, 28, 128]) has
// 19% live (row, key) pairs in 22% of its tiles: the bound counts the live
// pairs (operations), but the kernel computes every tile below kv_len and
// masks, so it does ~5x the bound's work.
//
// Design (FA2-style, simple first): one block of 4 warps per (b*h, 64-row
// q tile); each warp owns 16 q rows. The q tile is loaded once and kept as
// mma.sync A fragments in registers; k and v tiles of 64 rows stream
// through shared memory with cp.async (v_j loads while s = q k_j^T runs,
// k_{j+1} loads while p v_j runs). bf16 mma.sync m16n8k16 with fp32
// accumulators; the softmax runs on the accumulator fragments in the exp2
// domain (softmax_scale*log2e is folded into q, or into the q rope tables,
// before this kernel). Shared tiles use an XOR swizzle of 16-byte chunks so
// ldmatrix reads are free of bank conflicts. The TPU kernel's rotated-k
// VMEM cache has no counterpart: the rope_rotate kernel below rotates q and
// k once, in a pre-pass, into bf16 scratch (rounding points as on the TPU:
// rotated q in q's dtype, rotated k in v's dtype).
// Not used here: wgmma, TMA, warp specialisation (flash_attention_sm90.cu
// and flash_attention_causal_sm90.cu have them).

#include "bf16_tiles.cuh"

namespace {

template <int D, int MODE, bool CAUSAL, int SEG, bool SBF16>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o,
                      const int* __restrict__ kv_len,
                      const float* __restrict__ bound,
                      float* __restrict__ lse,
                      const int* __restrict__ q_offsets, int q_offset,
                      const int* __restrict__ q_seg,
                      const int* __restrict__ kv_seg,
                      int group, int n_heads, int lq,
                      int lk, long long q_sb, long long q_sl, long long q_sh,
                      long long k_sb, long long k_sl, long long k_sh,
                      long long v_sb, long long v_sl, long long v_sh,
                      long long o_sb, long long o_sl, long long o_sh) {
  constexpr int KS = D / 16;   // k-steps of the q k^T product
  constexpr int NT = BC / 8;   // n-tiles of s per warp
  constexpr int OT = D / 8;    // n-tiles of the output per warp

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BR * D;
  __nv_bfloat16* Vs = Ks + BC * D;
  int* Kc = reinterpret_cast<int*>(Vs + BC * D);   // the k tile's 64 kv codes

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int q0 = blockIdx.x * BR;
  // the codes of this thread's query rows g and g + 8
  int qc[2] = {0, 0};
  if (SEG != NO_SEG) {
    const int* qsp = q_seg + (long long)b * lq + q0 + warp * 16 + g;
    qc[0] = qsp[0];
    qc[1] = qsp[8];
  }
  const int hk = h / group;   // the kv head this query head reads
  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh + (long long)q0 * q_sl;
  const __nv_bfloat16* kp = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + hk * v_sh;

  const int* ksp = SEG != NO_SEG ? kv_seg + (long long)b * lk : nullptr;
  // the k tile at kv row kv0, with its codes
  auto load_k = [&](int kv0) {
    load_tile<D>(Ks, kp + (long long)kv0 * k_sl, k_sl, tid);
    if (SEG != NO_SEG && tid < BC / 4) cp_async16(Kc + tid * 4, ksp + kv0 + tid * 4);
  };

  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  int n_tiles = (kv_end + BC - 1) / BC;
  // causal: absolute row of the tile's first query; kv tiles that start past
  // its last row (row0 + BR - 1) are dead for every row of the tile
  int row0 = 0;
  if (CAUSAL) {
    row0 = q0 + q_offset + (q_offsets != nullptr ? q_offsets[b] : 0);
    const int live_cols = max(row0 + BR, 0);
    n_tiles = min(n_tiles, (live_cols + BC - 1) / BC);
  }
  const float c_bound = (MODE == BOUNDED) ? *bound : 0.f;  // folded score bound

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // per-thread partial row sums (rows g and g+8), reduced over the quad at
  // the end; m_r: running max (RUNNING) or reference point (ONESHOT)
  float l_r[2] = {0.f, 0.f};
  float m_r[2] = {NEG_INF, NEG_INF};

  uint32_t qa[KS][4];

  if (n_tiles > 0) {
    load_tile<D>(Qs, qp, q_sl, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      int r = warp * 16 + (lane & 15);
      int c = kk * 2 + (lane >> 4);
      ldmatrix_x4(qa[kk], Qs + swz<D>(r, c));
    }
  }

  // s = q k^T for the k tile in smem -> fragments s[NT][4]; only kv_len-tail,
  // (causal) diagonal and segment / packed tiles pay the compare + select: a
  // key is dead past kv_end, past its query's row, or by its code
  auto qk = [&](float (*s)[4], int kv0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        int mi = lane >> 3, rr = lane & 7;
        int r = np * 16 + (mi >> 1) * 8 + rr;
        int c = kk * 2 + (mi & 1);
        ldmatrix_x4(bfr, Ks + swz<D>(r, c));
        mma_bf16(s[2 * np], qa[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bfr[2], bfr[3]);
      }
    }
    const bool tail = kv0 + BC > kv_end;
    const bool diag = CAUSAL && kv0 + BC - 1 > row0;
    if (tail || diag || SEG != NO_SEG) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n * 8 + 2 * t + (j & 1), col = kv0 + c;
          const int r = warp * 16 + g + 8 * (j >> 1);
          bool dead = col >= kv_end;
          if (CAUSAL) dead = dead || col > row0 + r;
          if (SEG == SEGMENTS) dead = dead || qc[j >> 1] != Kc[c];
          if (SEG == PACKED) dead = dead || !packed_allowed(qc[j >> 1], Kc[c], q0 + r, col);
          if (dead) s[n][j] = NEG_INF;
        }
    }
  };

  if (MODE == ONESHOT) {
    // pass 1: the exact row max over every live key (the one-shot softmax
    // of _cross_kernel), then pass 2 runs with it as a per-row reference
    for (int j = 0; j < n_tiles; ++j) {
      load_tile<D>(Ks, kp + (long long)j * BC * k_sl, k_sl, tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      float s[NT][4];
      qk(s, j * BC);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        m_r[0] = fmaxf(m_r[0], fmaxf(s[n][0], s[n][1]));
        m_r[1] = fmaxf(m_r[1], fmaxf(s[n][2], s[n][3]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffff, m_r[i], 1));
      m_r[i] = fmaxf(m_r[i], __shfl_xor_sync(0xffffffff, m_r[i], 2));
    }
  }

  if (n_tiles > 0) {
    load_k(0);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // k_j landed; every warp is done with v_{j-1}
    load_tile<D>(Vs, vp + (long long)j * BC * v_sl, v_sl, tid);
    cp_async_commit();

    float s[NT][4];
    qk(s, j * BC);

    softmax_tile<MODE, SBF16, CAUSAL || SEG != NO_SEG, NT, OT>(s, m_r, l_r, acc, c_bound);

    cp_async_wait_all();
    __syncthreads();  // v_j landed; every warp is done with k_j
    if (j + 1 < n_tiles) {
      load_k((j + 1) * BC);
      cp_async_commit();
    }
    // acc += p v_j, p rounded to bf16 (v's dtype) as on the TPU
    pv_tile<D>(acc, s, Vs, lane);
  }

  // with lse: C + log2 l (bounded) or m + log2 l, +1e30 for empty rows, so
  // that the backward's exp2(s - lse) is exactly 0 there
  store_rows<MODE, OT>(acc, l_r, m_r, c_bound,
                       lse != nullptr ? lse + (long long)bh * lq + q0 + warp * 16 + g : nullptr,
                       o + b * o_sb + h * o_sh + (long long)(q0 + warp * 16) * o_sl, o_sl, g, t);
}

// y = x * cosF + swap_pairs(x) * sinF in fp32 (swap_pairs(x)[i] = x[i ^ 1]),
// rounded to bf16. x [B, L, N, D] strided, tables [L, D] fp32, y contiguous.
__global__ void rope_rotate_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                        const float* __restrict__ cf,
                                        const float* __restrict__ sf,
                                        __nv_bfloat16* __restrict__ y, int L, int N,
                                        int D, long long x_sb, long long x_sl,
                                        long long x_sh, long long total_pairs) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_pairs) return;
  int dp = (int)(i % (D / 2));
  long long rest = i / (D / 2);
  int h = (int)(rest % N);
  rest /= N;
  int l = (int)(rest % L);
  int b = (int)(rest / L);
  int d = 2 * dp;
  __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
      x + b * x_sb + l * x_sl + h * x_sh + d);
  float x0 = __bfloat162float(xv.x), x1 = __bfloat162float(xv.y);
  const float* c = cf + (long long)l * D + d;
  const float* s = sf + (long long)l * D + d;
  float y0 = __fadd_rn(__fmul_rn(x0, c[0]), __fmul_rn(x1, s[0]));
  float y1 = __fadd_rn(__fmul_rn(x1, c[1]), __fmul_rn(x0, s[1]));
  *reinterpret_cast<__nv_bfloat162*>(y + 2 * i) = __floats2bfloat162_rn(y0, y1);
}

template <int D, int MODE, bool CAUSAL, int SEG, bool SBF16 = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* kv_len,
                   const void* bound, void* lse, const void* q_offsets, int q_offset,
                   const void* q_seg, const void* kv_seg, int group, int B, int N, int lq,
                   int lk, const long long* st, cudaStream_t stream) {
  auto kern = flash_fwd_bf16_kernel<D, MODE, CAUSAL, SEG, SBF16>;
  const int smem = (BR + 2 * BC) * D * (int)sizeof(__nv_bfloat16) + BC * (int)sizeof(int);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(lq / BR, B * N);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(kv_len), static_cast<const float*>(bound),
      static_cast<float*>(lse), static_cast<const int*>(q_offsets), q_offset,
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), group, N, lq, lk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: bf16 [B, L, N, D]; k, v: bf16 [B, L, N / group, D]; element strides
// st = (q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h) and unit
// stride along D. lq and lk are multiples of 64. kv_len: int32 [B] on the
// device, or null. mode: 0 bounded (reference point *bound, an fp32 scalar
// on the device, the folded score bound), 1 running max, 2 one-shot max
// (bound may be null). lse: null, or fp32 [B, N, lq] contiguous that
// receives the exp2-domain log-sum-exp of every row (the training forward).
// causal (running max only): query i of batch b is row i + q_offset +
// q_offsets[b] (q_offsets: int32 [B] on the device, or null) and sees keys
// at or before it. seg_mode (running max only, not causal): 1 segments, 2
// packed codes; q_seg int32 [B, lq] and kv_seg int32 [B, lk], contiguous.
// softmax_bf16 (not causal, no segments, no lse): the softmax chain in bf16
// (bf16_tiles.cuh softmax_tile), in any of the three modes.
int univid_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                          const void* kv_len, const void* bound, void* lse,
                          const void* q_offsets, const void* q_seg, const void* kv_seg,
                          int mode, int causal, int seg_mode, int softmax_bf16, int q_offset,
                          int group, int B, int N, int lq, int lk, int D,
                          const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128 || lq % BR != 0 || lk % BC != 0 || group < 1 || N % group != 0)
    return (int)cudaErrorInvalidValue;
  if (softmax_bf16) {
    if (causal || seg_mode != NO_SEG || lse != nullptr) return (int)cudaErrorInvalidValue;
    switch (mode) {
      case BOUNDED: return (int)launch<128, BOUNDED, false, NO_SEG, true>(q, k, v, o, kv_len, bound, nullptr, nullptr, 0, nullptr, nullptr, group, B, N, lq, lk, strides, s);
      case RUNNING: return (int)launch<128, RUNNING, false, NO_SEG, true>(q, k, v, o, kv_len, bound, nullptr, nullptr, 0, nullptr, nullptr, group, B, N, lq, lk, strides, s);
      case ONESHOT: return (int)launch<128, ONESHOT, false, NO_SEG, true>(q, k, v, o, kv_len, bound, nullptr, nullptr, 0, nullptr, nullptr, group, B, N, lq, lk, strides, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (causal) {
    if (mode != RUNNING || seg_mode != NO_SEG) return (int)cudaErrorInvalidValue;
    return (int)launch<128, RUNNING, true, NO_SEG>(q, k, v, o, kv_len, bound, lse, q_offsets,
                                                   q_offset, nullptr, nullptr, group, B, N, lq,
                                                   lk, strides, s);
  }
  if (seg_mode != NO_SEG) {
    if (mode != RUNNING || q_seg == nullptr || kv_seg == nullptr)
      return (int)cudaErrorInvalidValue;
    if (seg_mode == SEGMENTS)
      return (int)launch<128, RUNNING, false, SEGMENTS>(q, k, v, o, kv_len, bound, lse, nullptr,
                                                        0, q_seg, kv_seg, group, B, N, lq, lk,
                                                        strides, s);
    if (seg_mode == PACKED)
      return (int)launch<128, RUNNING, false, PACKED>(q, k, v, o, kv_len, bound, lse, nullptr, 0,
                                                      q_seg, kv_seg, group, B, N, lq, lk,
                                                      strides, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (mode) {
    case BOUNDED: return (int)launch<128, BOUNDED, false, NO_SEG>(q, k, v, o, kv_len, bound, lse, nullptr, 0, nullptr, nullptr, group, B, N, lq, lk, strides, s);
    case RUNNING: return (int)launch<128, RUNNING, false, NO_SEG>(q, k, v, o, kv_len, bound, lse, nullptr, 0, nullptr, nullptr, group, B, N, lq, lk, strides, s);
    case ONESHOT: return (int)launch<128, ONESHOT, false, NO_SEG>(q, k, v, o, kv_len, bound, lse, nullptr, 0, nullptr, nullptr, group, B, N, lq, lk, strides, s);
  }
  return (int)cudaErrorInvalidValue;
}

// y [B, L, N, D] contiguous bf16 = rope(x) with fp32 tables [L, D].
int univid_rope_rotate_bf16(const void* x, const void* cf, const void* sf, void* y, int B,
                            int L, int N, int D, long long x_sb, long long x_sl,
                            long long x_sh, void* stream) {
  if (D % 2 != 0) return (int)cudaErrorInvalidValue;
  long long pairs = (long long)B * L * N * (D / 2);
  int threads = 256;
  long long blocks = (pairs + threads - 1) / threads;
  rope_rotate_bf16_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(cf),
      static_cast<const float*>(sf), static_cast<__nv_bfloat16*>(y), L, N, D, x_sb, x_sl,
      x_sh, pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
