// The DiT's q / k pre-passes for Hopper (sm_90a): the qk RMS norm and the
// fused-rope rotation (kernel A, qk_norm_rope_kernel), and the int8
// quantization of the qk_int8 mode (kernel B, quant_qk_atomic_*).
//
// Replaces the prologues of _flash_kernel in
// univid_tpu/kernels/flash_attention.py (:44):
//   * the fused-rope prologue (_rot :119-135, used at :157 and :305): q and
//     k rotated in fp32 by the [L, 128] swap-multiply tables (q's carry
//     softmax_scale * log2 e), y = x * cosF + swap_pairs(x) * sinF, the two
//     products and the sum each rounded once (no fused multiply-add, as on
//     the TPU), then rounded to bf16. Its input, Wan's qk-norm
//     (univid_tpu/models/wan/dit.py:146-156, nn.rms_norm), is an XLA fusion
//     on the TPU that writes the bf16 rows the prologue reads; here the
//     norm is this kernel's own prologue, so the pre-norm rows are read
//     once and the normed and rotated rows written once:
//       ss   = sum of x32^2 over the token's whole N * 128 width (fp32),
//       r    = rsqrtf(ss / (N * 128) + eps),
//       n    = bf16(x32 * r), y = bf16(n * gain),
//     the rounding points of rms_norm (cast back, then the gain in bf16).
//     rsqrtf is the rsqrt torch.rsqrt runs on the card (MUFU.RSQ, within
//     2 ulp), so on the card this kernel and its plain version differ only
//     in the order of the fp32 sum of squares (tests/test_torch_qk_prepass.py
//     counts how often that moves a bf16 value: at most one step).
//     Three modes: norm + rope (self-attention), norm only (the
//     cross-attention's q and k, and kernel B's input), rope only (q and k
//     that arrive normed). One launch for q and k.
//   * the qk_int8 prologue (:137-156, :213-226), kernel B: from the normed
//     bf16 rows, or the fp32 rows of the fp32 DiT (a template on the
//     element type: Raw8 loads 16 or 32 bytes a chunk), the rotation in
//     fp32 (never rounded to bf16 first), then
//       q: per row, aq = max(max|q32|, 1e-30), codes round(q32 * (127 / aq))
//          (ties to even), sq = aq * (1 / 127);
//       k: one scale per (batch, head, block of bw keys), ak = max(max|k32|,
//          1e-30) over the whole block unmasked, codes round(k32 * (127 /
//          ak)), akq = ak * (1 / 127).
//
// What bounds them: bytes. Kernel A at the ti2v-5B shape (q and k [2,
// 28672, 24 * 128] bf16) reads 704 MB and writes 704 MB, plus the tables:
// 0.44 ms at 3.35 TB/s. Kernel B reads 704 MB of bf16 and writes 352 MB of
// codes: 0.33 ms; in fp32 at t2v-1.3B's [2, 32768, 12 * 128] it reads 805
// MB and the tables' 67 and writes 201 MB of codes: 0.32 ms.
//
// Design. A token's whole row (N heads of 128) is one unit: 128 threads,
// thread t owns the 16-byte chunk t % 16 of heads t / 16 + 8 i, so the
// rope table chunk it needs is the same for all its heads and is read once
// a token, not once a head. The sum of squares is reduced by warp shuffles,
// then once through shared memory (double-buffered: one barrier a token).
// Kernel A strides over the tokens (l-major, so the batch rows of one
// position share a table row in L2), a grid sized to the card's occupancy.
// Kernel B runs blocks over groups of tokens with all their heads; a q
// row's max is a shuffle over its 16 threads. Its k block max: a first
// launch writes q's codes and folds each (b, h, block) max of k into a
// zeroed scratch by atomicMax on the float's bits (a max is order-free:
// deterministic); a second launch writes k's codes. k is read twice. (A
// cluster design that read k once, combining each block's max over
// distributed shared memory, was slower on the H100; PERF.md.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head dim
constexpr int CH = D / 8;       // 16-byte chunks of a head row
constexpr int NT = 128;         // threads a token: 8 head groups x 16 chunks
constexpr int HG = NT / CH;     // heads a pass
constexpr int MAX_NCH = 5;      // passes a token: N <= 40 heads
constexpr int QGROUP = 32;      // tokens a kernel B block (a divisor of every bw)
constexpr float INV127 = (float)(1.0 / 127.0);   // the TPU kernel's 1.0 / 127.0
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void unpack8(const uint4& r, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return r;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8f(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// y = x * cosF + swap_pairs(x) * sinF, each product and the sum rounded once
__device__ __forceinline__ void rotate8(float* v, const float* cs, const float* sn) {
  float y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(__fmul_rn(v[j], cs[j]), __fmul_rn(v[j ^ 1], sn[j]));
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = y[j];
}

__device__ __forceinline__ float absmax8(const float* v) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  return m;
}

// the max over the 16 threads of a head row (lanes 0-15 and 16-31 apart)
__device__ __forceinline__ float row_max16(float m) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return m;
}

// codes round(y * r), ties to even, as 8 bytes in element order
__device__ __forceinline__ uint2 quant8(const float* y, float r) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j >> 2] |= (uint32_t)(__float2int_rn(__fmul_rn(y[j], r)) & 0xFF) << (8 * (j & 3));
  return make_uint2(w[0], w[1]);
}

// ---------------------------------------------------------------------------
// kernel A: norm, rope, or both
// ---------------------------------------------------------------------------

struct NormOperand {
  const __nv_bfloat16* x;     // token (b, l), head h at x + b sb + l sl + h sh
  __nv_bfloat16* y;           // [B, L, N, 128] contiguous
  const __nv_bfloat16* gain;  // [N * 128], or null: no norm
  const float* cf;            // [L, 128] rope tables, or null: no rope
  const float* sf;
  long long sb, sl, sh;
  int L, N;                   // tokens, heads (k may have fewer: grouped kv)
};

struct NormArgs {
  NormOperand op[2];   // q, k
  long long n0;        // B * L of q: tokens [0, n0) are q's, then k's
  long long total;
  int B;
  float eps;
};

// token t's operand, batch row and position (l-major: b fastest)
__device__ __forceinline__ const NormOperand& token_of(const NormArgs& a, long long t, int& b,
                                                       int& l) {
  const bool is_k = t >= a.n0;
  const long long u = is_k ? t - a.n0 : t;
  l = (int)(u / a.B);
  b = (int)(u % a.B);
  return is_k ? a.op[1] : a.op[0];
}

template <int NCH>
__device__ __forceinline__ void load_row(uint4* raw, const NormOperand& op, int b, int l, int hg,
                                         int c) {
  const __nv_bfloat16* xr = op.x + b * op.sb + l * op.sl + c * 8;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int h = hg + HG * i;
    raw[i] = h < op.N ? *reinterpret_cast<const uint4*>(xr + h * op.sh) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int NCH>
__global__ void __launch_bounds__(NT) qk_norm_rope_kernel(const __grid_constant__ NormArgs a) {
  __shared__ float red[2][NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % CH, hg = tid / CH;
  int parity = 0, b, l;
  uint4 raw[NCH];   // the next token's row, loaded a token ahead
  if ((long long)blockIdx.x < a.total) {
    const NormOperand& op0 = token_of(a, blockIdx.x, b, l);
    load_row<NCH>(raw, op0, b, l, hg, c);
  }
  for (long long t = blockIdx.x; t < a.total; t += gridDim.x) {
    const NormOperand& op = token_of(a, t, b, l);
    const int n = op.N;
    float v[NCH][8];
#pragma unroll
    for (int i = 0; i < NCH; ++i) unpack8(raw[i], v[i]);
    if (t + gridDim.x < a.total) {
      int bn, ln;
      const NormOperand& on = token_of(a, t + gridDim.x, bn, ln);
      load_row<NCH>(raw, on, bn, ln, hg, c);
    }
    if (op.gain != nullptr) {   // uniform over the block: q and k both or neither
      float ss = 0.f;           // this thread's chunks, in order; absent heads add 0
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[i][j], v[i][j]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(FULL, ss, o));
      if (lane == 0) red[parity][warp] = ss;
      __syncthreads();
      float tot = red[parity][0];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) tot = __fadd_rn(tot, red[parity][w]);
      parity ^= 1;
      const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, (float)(n * D)), a.eps));
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int h = hg + HG * i;
        if (h >= n) continue;
        float g[8];
        unpack8(*reinterpret_cast<const uint4*>(op.gain + h * D + c * 8), g);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[i][j] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(v[i][j], r)), g[j]));
      }
    }
    if (op.cf != nullptr) {
      float cs[8], sn[8];
      load8f(op.cf + (long long)l * D + c * 8, cs);
      load8f(op.sf + (long long)l * D + c * 8, sn);
#pragma unroll
      for (int i = 0; i < NCH; ++i) rotate8(v[i], cs, sn);
    }
    __nv_bfloat16* yr = op.y + ((long long)b * op.L + l) * n * D + c * 8;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int h = hg + HG * i;
      if (h < n) *reinterpret_cast<uint4*>(yr + h * D) = pack8(v[i]);
    }
  }
}

template <int NCH>
cudaError_t launch_norm(const NormArgs& a, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_norm_rope_kernel<NCH>, NT, 0);
  if (err != cudaSuccess) return err;
  const long long want = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(a.total < want ? a.total : want);
  qk_norm_rope_kernel<NCH><<<grid, NT, 0, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel B: the int8 pre-pass
// ---------------------------------------------------------------------------

// 8 consecutive elements of a head row as one thread loads them: 16 bytes
// of bf16 or 32 of fp32 (the fp32 mode: the fp32 DiT's q and k)
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { r = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void values(float* v) const { unpack8(r, v); }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void values(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <typename T>
struct QuantArgs {
  const T* q;                // [B, L, N, 128] at b sb + l sl + h sh, unit along D
  const T* k;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh;
  const float* cq;           // rope tables [L, 128], or all null (q arrives folded)
  const float* sq_t;
  const float* ck;
  const float* sk_t;
  int8_t* qi;                // [B, N, Lq, 128]
  float* sq;                 // [B, N, Lq]
  int8_t* ki;                // [B, N, Lk, 128]
  float* akq;                // [B, N, nblk]
  unsigned* kmax;            // [B, N, nblk] float bits, zeroed
  int B, N, Lq, Lk, bw, nblk;
  int q_blocks;              // blocks of q groups: B * ceil(Lq / QGROUP)
};

// One thread's share of a token's row: its chunk of each of its heads and
// the rope table chunk of the token's position, as loaded.
template <typename T, int NCH>
struct Chunks {
  Raw8<T> x[NCH];
  float4 c0, c1, s0, s1;
};

template <typename T, int NCH>
__device__ __forceinline__ void load_chunks(Chunks<T, NCH>& t, const T* x, long long sb,
                                            long long sl, long long sh, const float* cf,
                                            const float* sf, int N, int b, int l, int hg, int c) {
  const T* xr = x + b * sb + l * sl + c * 8;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int h = hg + HG * i;
    if (h < N)
      t.x[i].load(xr + h * sh);
    else
      t.x[i].zero();
  }
  if (cf != nullptr) {
    const float* cr = cf + (long long)l * D + c * 8;
    const float* sr = sf + (long long)l * D + c * 8;
    t.c0 = *reinterpret_cast<const float4*>(cr);
    t.c1 = *reinterpret_cast<const float4*>(cr + 4);
    t.s0 = *reinterpret_cast<const float4*>(sr);
    t.s1 = *reinterpret_cast<const float4*>(sr + 4);
  }
}

// the fp32 values of the chunks, rotated when rope
template <typename T, int NCH>
__device__ __forceinline__ void chunk_values(float (&v)[NCH][8], const Chunks<T, NCH>& t, bool rope) {
  const float cs[8] = {t.c0.x, t.c0.y, t.c0.z, t.c0.w, t.c1.x, t.c1.y, t.c1.z, t.c1.w};
  const float sn[8] = {t.s0.x, t.s0.y, t.s0.z, t.s0.w, t.s1.x, t.s1.y, t.s1.z, t.s1.w};
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    t.x[i].values(v[i]);
    if (rope) rotate8(v[i], cs, sn);
  }
}

// q codes and row scales of tokens [l0, l1) of batch row b, 128 threads a
// token, each token's row loaded while the one before is quantized
template <typename T, int NCH>
__device__ __forceinline__ void quant_q_tokens(const QuantArgs<T>& a, int b, int l0, int l1, int tid) {
  const int c = tid % CH, hg = tid / CH;
  const bool rope = a.cq != nullptr;
  Chunks<T, NCH> cur, nxt;
  if (l0 < l1) load_chunks(cur, a.q, a.q_sb, a.q_sl, a.q_sh, a.cq, a.sq_t, a.N, b, l0, hg, c);
  for (int l = l0; l < l1; ++l) {
    if (l + 1 < l1) load_chunks(nxt, a.q, a.q_sb, a.q_sl, a.q_sh, a.cq, a.sq_t, a.N, b, l + 1, hg, c);
    float v[NCH][8];
    chunk_values(v, cur, rope);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int h = hg + HG * i;
      const float aq = fmaxf(row_max16(absmax8(v[i])), 1e-30f);   // absent heads: 0, unused
      if (h >= a.N) continue;
      const long long row = ((long long)b * a.N + h) * a.Lq + l;
      *reinterpret_cast<uint2*>(a.qi + row * D + c * 8) = quant8(v[i], __fdiv_rn(127.f, aq));
      if (c == 0) a.sq[row] = __fmul_rn(aq, INV127);
    }
    cur = nxt;
  }
}

// Launch 1: blocks [0, q_blocks) write q's codes for QGROUP
// tokens each; the rest take QGROUP k tokens (inside one bw block) and fold
// each head's max |k32| into kmax by atomicMax on the bits (non-negative
// floats order as unsigned integers).
template <typename T, int NCH>
__global__ void __launch_bounds__(NT) quant_qk_atomic_max_kernel(const __grid_constant__ QuantArgs<T> a) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < a.q_blocks) {
    const int b = blockIdx.x % a.B, l0 = (blockIdx.x / a.B) * QGROUP;
    quant_q_tokens<T, NCH>(a, b, l0, min(l0 + QGROUP, a.Lq), tid);
    return;
  }
  const int g = blockIdx.x - a.q_blocks;
  const int b = g % a.B, l0 = (g / a.B) * QGROUP, l1 = min(l0 + QGROUP, a.Lk);
  const int c = tid % CH, hg = tid / CH;
  const bool rope = a.ck != nullptr;
  float m[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) m[i] = 0.f;
  Chunks<T, NCH> cur, nxt;
  load_chunks(cur, a.k, a.k_sb, a.k_sl, a.k_sh, a.ck, a.sk_t, a.N, b, l0, hg, c);
  for (int l = l0; l < l1; ++l) {
    if (l + 1 < l1) load_chunks(nxt, a.k, a.k_sb, a.k_sl, a.k_sh, a.ck, a.sk_t, a.N, b, l + 1, hg, c);
    float v[NCH][8];
    chunk_values(v, cur, rope);
#pragma unroll
    for (int i = 0; i < NCH; ++i) m[i] = fmaxf(m[i], absmax8(v[i]));   // absent heads: 0
    cur = nxt;
  }
  const int blk = l0 / a.bw;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const float mm = row_max16(m[i]);
    const int h = hg + HG * i;
    if (h < a.N && c == 0)
      atomicMax(a.kmax + ((long long)b * a.N + h) * a.nblk + blk, __float_as_uint(mm));
  }
}

// Launch 2: k's codes from the block maxima; the first group
// of each block writes its akq.
template <typename T, int NCH>
__global__ void __launch_bounds__(NT) quant_qk_atomic_codes_kernel(const __grid_constant__ QuantArgs<T> a) {
  const int tid = threadIdx.x, c = tid % CH, hg = tid / CH;
  const int b = blockIdx.x % a.B, l0 = (blockIdx.x / a.B) * QGROUP;
  const int l1 = min(l0 + QGROUP, a.Lk), blk = l0 / a.bw;
  const bool rope = a.ck != nullptr;
  Chunks<T, NCH> cur, nxt;
  load_chunks(cur, a.k, a.k_sb, a.k_sl, a.k_sh, a.ck, a.sk_t, a.N, b, l0, hg, c);
  float r[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int h = hg + HG * i;
    r[i] = 0.f;
    if (h >= a.N) continue;
    const long long idx = ((long long)b * a.N + h) * a.nblk + blk;
    const float ak = fmaxf(__uint_as_float(a.kmax[idx]), 1e-30f);
    r[i] = __fdiv_rn(127.f, ak);
    if (c == 0 && l0 % a.bw == 0) a.akq[idx] = __fmul_rn(ak, INV127);
  }
  for (int l = l0; l < l1; ++l) {
    if (l + 1 < l1) load_chunks(nxt, a.k, a.k_sb, a.k_sl, a.k_sh, a.ck, a.sk_t, a.N, b, l + 1, hg, c);
    float v[NCH][8];
    chunk_values(v, cur, rope);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int h = hg + HG * i;
      if (h < a.N)
        *reinterpret_cast<uint2*>(a.ki + (((long long)b * a.N + h) * a.Lk + l) * D + c * 8) =
            quant8(v[i], r[i]);
    }
    cur = nxt;
  }
}

template <typename T, int NCH>
cudaError_t launch_quant(QuantArgs<T> a, cudaStream_t s) {
  const int q_groups = (a.Lq + QGROUP - 1) / QGROUP, k_groups = (a.Lk + QGROUP - 1) / QGROUP;
  a.q_blocks = a.B * q_groups;
  quant_qk_atomic_max_kernel<T, NCH><<<a.q_blocks + a.B * k_groups, NT, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quant_qk_atomic_codes_kernel<T, NCH><<<a.B * k_groups, NT, 0, s>>>(a);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
inline bool strides8(long long a, long long b, long long c) { return a % 8 == 0 && b % 8 == 0 && c % 8 == 0; }
// element strides of 16-byte steps: multiples of 8 (bf16) or 4 (fp32) elements
template <typename T>
inline bool strides16(long long a, long long b, long long c) {
  constexpr long long e = 16 / sizeof(T);
  return a % e == 0 && b % e == 0 && c % e == 0;
}

// kernel B in the element type T of q and k (bf16, or fp32: the fp32 DiT)
template <typename T>
int quant_qk_int8(const void* q, const void* k, const void* cq, const void* sq_t, const void* ck,
                  const void* sk_t, void* qi, void* sq, void* ki, void* akq, void* kmax, int B,
                  int Lq, int Lk, int N, int bw, long long q_sb, long long q_sl, long long q_sh,
                  long long k_sb, long long k_sl, long long k_sh, void* stream) {
  const bool rope = cq != nullptr;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || N <= 0 || N > HG * MAX_NCH || bw <= 0 || bw % 64 != 0 ||
      (rope != (sq_t != nullptr)) || (rope != (ck != nullptr)) || (rope != (sk_t != nullptr)) ||
      !aligned16(q) || !aligned16(k) || !strides16<T>(q_sb, q_sl, q_sh) ||
      !strides16<T>(k_sb, k_sl, k_sh) || kmax == nullptr ||
      (rope && (!aligned16(cq) || !aligned16(sq_t) || !aligned16(ck) || !aligned16(sk_t))))
    return (int)cudaErrorInvalidValue;
  QuantArgs<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.q_sb = q_sb; a.q_sl = q_sl; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sl = k_sl; a.k_sh = k_sh;
  a.cq = static_cast<const float*>(cq);
  a.sq_t = static_cast<const float*>(sq_t);
  a.ck = static_cast<const float*>(ck);
  a.sk_t = static_cast<const float*>(sk_t);
  a.qi = static_cast<int8_t*>(qi);
  a.sq = static_cast<float*>(sq);
  a.ki = static_cast<int8_t*>(ki);
  a.akq = static_cast<float*>(akq);
  a.kmax = static_cast<unsigned*>(kmax);
  a.B = B; a.N = N; a.Lq = Lq; a.Lk = Lk; a.bw = bw;
  a.nblk = (Lk + bw - 1) / bw;
  a.q_blocks = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + HG - 1) / HG) {
    case 1: return (int)launch_quant<T, 1>(a, s);
    case 2: return (int)launch_quant<T, 2>(a, s);
    case 3: return (int)launch_quant<T, 3>(a, s);
    case 4: return (int)launch_quant<T, 4>(a, s);
    case 5: return (int)launch_quant<T, 5>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel A. q [B, Lq, Nq, 128] and k [B, Lk, Nk, 128] bf16, element strides
// (sb, sl, sh) each, unit along D, 16-byte aligned rows (strides multiples
// of 8); yq, yk contiguous bf16 outputs of the same shapes. gq, gk: bf16
// [Nq * 128], [Nk * 128] gains (both, or both null: no norm); cq, sq, ck,
// sk: fp32 [Lq or Lk, 128] rope tables (all four, or all null: no rope); at
// least one of the two. One launch; Nq, Nk <= 8 * MAX_NCH.
int univid_qk_norm_rope(const void* q, const void* k, void* yq, void* yk, const void* gq,
                        const void* gk, const void* cq, const void* sq, const void* ck,
                        const void* sk, int B, int Lq, int Lk, int Nq, int Nk, long long q_sb,
                        long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                        long long k_sh, float eps, void* stream) {
  const bool norm = gq != nullptr, rope = cq != nullptr;
  const int N = Nq > Nk ? Nq : Nk;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Nq <= 0 || Nk <= 0 || N > HG * MAX_NCH ||
      (norm != (gk != nullptr)) ||
      (rope != (sq != nullptr)) || (rope != (ck != nullptr)) || (rope != (sk != nullptr)) ||
      (!norm && !rope) || !aligned16(q) || !aligned16(k) || !aligned16(yq) || !aligned16(yk) ||
      !strides8(q_sb, q_sl, q_sh) || !strides8(k_sb, k_sl, k_sh) ||
      (norm && (!aligned16(gq) || !aligned16(gk))) ||
      (rope && (!aligned16(cq) || !aligned16(sq) || !aligned16(ck) || !aligned16(sk))))
    return (int)cudaErrorInvalidValue;
  NormArgs a;
  a.op[0] = {static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(yq),
             static_cast<const __nv_bfloat16*>(gq), static_cast<const float*>(cq),
             static_cast<const float*>(sq), q_sb, q_sl, q_sh, Lq, Nq};
  a.op[1] = {static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(yk),
             static_cast<const __nv_bfloat16*>(gk), static_cast<const float*>(ck),
             static_cast<const float*>(sk), k_sb, k_sl, k_sh, Lk, Nk};
  a.n0 = (long long)B * Lq;
  a.total = a.n0 + (long long)B * Lk;
  a.B = B;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + HG - 1) / HG) {
    case 1: return (int)launch_norm<1>(a, s);
    case 2: return (int)launch_norm<2>(a, s);
    case 3: return (int)launch_norm<3>(a, s);
    case 4: return (int)launch_norm<4>(a, s);
    case 5: return (int)launch_norm<5>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel B. q [B, Lq, N, 128], k [B, Lk, N, 128] bf16 (strides as for
// kernel A); cq, sq_t, ck, sk_t: fp32 rope tables (q's with the fold) or
// all null (q arrives folded, both unrotated). Writes qi int8 [B, N, Lq,
// 128], sq fp32 [B, N, Lq], ki int8 [B, N, Lk, 128], akq fp32 [B, N,
// ceil(Lk / bw)]; bw a multiple of 64; kmax uint32 [B, N, ceil(Lk / bw)]
// zeroed by the caller. Two launches.
int univid_quant_qk_int8(const void* q, const void* k, const void* cq, const void* sq_t,
                         const void* ck, const void* sk_t, void* qi, void* sq, void* ki,
                         void* akq, void* kmax, int B, int Lq, int Lk, int N, int bw,
                         long long q_sb, long long q_sl, long long q_sh, long long k_sb,
                         long long k_sl, long long k_sh, void* stream) {
  return quant_qk_int8<__nv_bfloat16>(q, k, cq, sq_t, ck, sk_t, qi, sq, ki, akq, kmax, B, Lq, Lk,
                                      N, bw, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, stream);
}

// Kernel B on fp32 q and k (the fp32 DiT's): as univid_quant_qk_int8, the
// strides multiples of 4 elements; the rotation in fp32 from the fp32 rows.
int univid_quant_qk_int8_f32(const void* q, const void* k, const void* cq, const void* sq_t,
                             const void* ck, const void* sk_t, void* qi, void* sq, void* ki,
                             void* akq, void* kmax, int B, int Lq, int Lk, int N, int bw,
                             long long q_sb, long long q_sl, long long q_sh, long long k_sb,
                             long long k_sl, long long k_sh, void* stream) {
  return quant_qk_int8<float>(q, k, cq, sq_t, ck, sk_t, qi, sq, ki, akq, kmax, B, Lq, Lk, N, bw,
                              q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, stream);
}

}  // extern "C"
