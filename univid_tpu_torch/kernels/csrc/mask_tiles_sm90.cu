// The masked modes' tile lists for the NVIDIA H100 (sm_90a), both from one
// launch: the forward's list (flash_attention_sm90.cu's 128-row q tiles,
// for each the live 128-key kv tiles) and the one-pass backward's
// (flash_attention_bwd_sm90.cu's 128-key kv tiles, for each the live
// 64-row q tiles), as (tile << 1) | full with -1 past the count. Built once
// a pass from the codes of the segment or packed mask (the backward's list
// also in the causal mode) and handed to every layer's attention call.
//
// Replaces the pre-passes mask_tiles_kernel (flash_attention_sm90.cu) and
// bwd_tiles_kernel (flash_attention_bwd_sm90.cu), which decide the
// `need` / `run` predicates of univid_tpu/kernels/flash_attention.py
// (:309-336, :1113-1120, :1161-1169) pair by pair and stay built as
// same-call baselines. The plain versions are mask_tile_list_plain and
// bwd_tile_list_plain; tile_lists_by_runs emulates this kernel's rule.
//
// Bound: bytes (each code read once, the lists written once), ~1e-5 ms at
// the 4,096-token pack: far below a launch, so the launch and the latency
// of a block's few dependent steps are what it costs. Its design:
//   * Runs, not pairs. Within a tile a row or key starts a run where its
//     code differs from its neighbour's (warp ballots). On one pair of runs
//     (rows r0..r1 with code cq, keys c0..c1 with code ck) the packed
//     predicate (cq, ck fixed; causal term r >= c) is decided from the
//     corners: any pair allowed iff base && (fn || r1 >= c0), every pair
//     iff base && (fn || r0 >= c1); in segments mode both iff cq == ck. A
//     tile is live if any of its run pairs is, full if every run pair is
//     full and no key of it is cut by kv_len or Lk. Exact for any codes;
//     the cost is (q runs) x (kv runs) a 64 x 128 flag, never more than the
//     pair walk's.
//   * One launch, no grid-wide step. A row block takes one 128-row q tile:
//     its two 64-row halves' flags against every kv tile, OR (live) and
//     AND (full) of the halves, compacted into the forward's list; a
//     column block takes one kv tile: its flags against every 64-row q
//     tile, compacted into the backward's list. So each 64 x 128 flag is
//     decided twice, by two blocks in parallel, instead of once and then
//     read back after a grid-wide barrier. Rows past Lq never make a
//     forward tile less than full, as in the plain list.
//   * The grid from the shapes: ceil(Lq / 128) + ceil(Lk / 128) blocks a
//     batch row (64 at the 4,096-token pack: one wave; 576 at 36,864).
#include <cuda_runtime.h>

namespace {

constexpr int SEGMENTS = 1, PACKED = 2, CAUSAL = 3;   // the wrappers' mask modes
constexpr int FQ = 128;      // q rows of a forward tile
constexpr int BQ = 64;       // q rows of a backward tile (half a forward one)
constexpr int BK = 128;      // keys of a kv tile (both lists)
constexpr int WARPS = 16;    // warps a block
constexpr int MAX_FLAGS = 16 * 1024;   // dynamic shared bytes, one a tile: Lq, Lk <= 1M

// The runs of equal codes among codes[0 .. n) (n <= 32 * W, global or
// shared): run k starts at start[k] with code code[k]. Warp-wide; returns
// the run count.
template <int W>
__device__ __forceinline__ int warp_runs(const int* codes, int n, int* start, int* code,
                                         int lane) {
  int base = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int i = 32 * w + lane;
    const int c = i < n ? codes[i] : 0;
    const bool s = i < n && (i == 0 || c != codes[i - 1]);
    const unsigned m = __ballot_sync(0xffffffff, s);
    if (s) {
      const int k = base + __popc(m & ((1u << lane) - 1));
      start[k] = i;
      code[k] = c;
    }
    base += __popc(m);
  }
  __syncwarp();
  return base;
}

// One pair of runs: rows r0..r1 with code cq against keys c0..c1 with code
// ck (pack indices). any |= some pair allowed, all &= every pair allowed.
template <int MODE>
__device__ __forceinline__ void run_pair(int cq, int ck, int r0, int r1, int c0, int c1,
                                         bool& any, bool& all) {
  if (MODE == SEGMENTS) {
    any = any || cq == ck;
    all = all && cq == ck;
    return;
  }
  // packed_allowed of bf16_tiles.cuh with the causal term left open
  const int nz_q = cq & 0xFF, nz_k = ck & 0xFF;
  const bool base = (cq >> 16) == (ck >> 16) && !(nz_k > 0 && nz_q != nz_k);
  const int fn_q = (cq >> 8) & 0xFF;
  const bool fn = fn_q == ((ck >> 8) & 0xFF) && fn_q > 0;
  any = any || (base && (fn || r1 >= c0));
  all = all && base && (fn || r0 >= c1);
}

// The flag of one 64-row q tile (rows q0 .. q0 + 63, nq runs) and one kv
// tile (keys kv0 .. kv0 + n_keys - 1, nk runs): 0 dead, 1 live, 3 full
// (every pair allowed and `whole`: no key cut). Warp-wide.
template <int MODE>
__device__ __forceinline__ int runs_flag(const int* qs, const int* qc, int nq, int q0,
                                         const int* ks, const int* kc, int nk, int kv0,
                                         int n_keys, bool whole, int lane) {
  bool any = false, all = true;
  for (int p = lane; p < nq * nk; p += 32) {
    const int i = p / nk, j = p - i * nk;
    const int r0 = q0 + qs[i], r1 = q0 + (i + 1 < nq ? qs[i + 1] : BQ) - 1;
    const int c0 = kv0 + ks[j], c1 = kv0 + (j + 1 < nk ? ks[j + 1] : n_keys) - 1;
    run_pair<MODE>(qc[i], kc[j], r0, r1, c0, c1, any, all);
  }
  any = __any_sync(0xffffffff, any);
  all = __all_sync(0xffffffff, all);
  return any ? (all && whole ? 3 : 1) : 0;
}

// flags[0 .. n) compacted in order into out[0 .. width): (i << 1) | full
// for the live ones, -1 past their count, which goes to *count.
__device__ __forceinline__ void compact(const unsigned char* flags, int n, int width, int* out,
                                        int* count, int* n_live) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    int m = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int f = i < n ? flags[i] : 0;
      const unsigned bal = __ballot_sync(0xffffffff, f != 0);
      if (f != 0) out[m + __popc(bal & ((1u << lane) - 1))] = (i << 1) | (f >> 1);
      m += __popc(bal);
    }
    if (lane == 0) {
      *count = m;
      *n_live = m;
    }
  }
  __syncthreads();
  for (int i = *n_live + threadIdx.x; i < width; i += blockDim.x) out[i] = -1;
}

// grid (n_fwd + n_bwd, B): blocks [0, n_fwd) the forward's 128-row q tiles
// (n_fwd is 0 in the causal mode and when no forward list is asked for),
// the rest the backward's kv tiles (none when no backward list is).
template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
tile_lists_kernel(const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                  const int* __restrict__ kv_len, const int* __restrict__ q_offsets,
                  int q_offset, int* __restrict__ fwd_list, int* __restrict__ fwd_count,
                  int* __restrict__ bwd_list, int* __restrict__ bwd_count, int lq, int lk,
                  int n_fwd) {
  extern __shared__ unsigned char flags[];   // this block's list: 0 dead, 1 live, 3 full
  __shared__ int q_start[WARPS][BQ], q_code[WARPS][BQ];   // each warp's q runs
  __shared__ int k_start[WARPS][BK], k_code[WARPS][BK];   // each warp's kv runs
  __shared__ int n_runs[2], n_live;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int kt = (lk + BK - 1) / BK, n_q = lq / BQ;
  int kv_end = lk;
  if (kv_len != nullptr) kv_end = min(max(kv_len[b], 0), lk);
  const int* qb = q_seg != nullptr ? q_seg + (long long)b * lq : nullptr;
  const int* kb = kv_seg != nullptr ? kv_seg + (long long)b * lk : nullptr;

  if ((int)blockIdx.x < n_fwd) {   // a forward q tile against every kv tile
    const int qt = blockIdx.x, q0 = qt * FQ;
    const bool two = q0 + BQ < lq;   // the second half exists (Lq % 64 == 0)
    if (warp < 2 && (warp == 0 || two)) {
      const int n = warp_runs<2>(qb + q0 + warp * BQ, BQ, q_start[warp], q_code[warp], lane);
      if (lane == 0) n_runs[warp] = n;
    }
    __syncthreads();
    const int n_kt = (kv_end + BK - 1) / BK;   // tiles past kv_end hold no live key
    int* ks = k_start[warp];
    int* kc = k_code[warp];
    for (int j = warp; j < n_kt; j += WARPS) {
      const int kv0 = j * BK, n_keys = min(BK, kv_end - kv0);
      const int nk = warp_runs<4>(kb + kv0, n_keys, ks, kc, lane);
      const bool whole = kv0 + BK <= kv_end;   // no key cut by kv_len or Lk
      int f = runs_flag<MODE>(q_start[0], q_code[0], n_runs[0], q0, ks, kc, nk, kv0, n_keys,
                              whole, lane);
      if (two) {
        const int f1 = runs_flag<MODE>(q_start[1], q_code[1], n_runs[1], q0 + BQ, ks, kc, nk,
                                       kv0, n_keys, whole, lane);
        f = (f | f1) != 0 ? (f == 3 && f1 == 3 ? 3 : 1) : 0;
      }
      if (lane == 0) flags[j] = (unsigned char)f;
      __syncwarp();   // the warp's next kv tile rewrites its runs
    }
    __syncthreads();
    const int q_tiles = (lq + FQ - 1) / FQ;
    compact(flags, n_kt, kt, fwd_list + ((long long)b * q_tiles + qt) * kt,
            fwd_count + (long long)b * q_tiles + qt, &n_live);
    return;
  }

  // a backward kv tile against every 64-row q tile
  const int j = blockIdx.x - n_fwd, kv0 = j * BK;
  const int n_keys = max(0, min(BK, kv_end - kv0));
  // from kv_end itself: written as `n_keys == BK`, the flag came out false
  // for a tile of 128 keys below kv_end on the card (nvcc 12.8, -O3)
  const bool whole = kv0 + BK <= kv_end;
  if (MODE != CAUSAL) {
    if (warp == 0) {
      const int n = warp_runs<4>(kb + kv0, n_keys, k_start[0], k_code[0], lane);
      if (lane == 0) n_runs[0] = n;
    }
    __syncthreads();
  }
  const long long off =
      MODE == CAUSAL ? (long long)q_offset + (q_offsets != nullptr ? q_offsets[b] : 0) : 0;
  for (int i = warp; i < n_q; i += WARPS) {
    const int q0 = i * BQ;
    int f = 0;
    if (MODE == CAUSAL) {
      // rows q0 + off .. q0 + off + 63 see the keys at or before their row
      const bool any = n_keys > 0 && kv0 <= q0 + off + BQ - 1;
      const bool all = whole && kv0 + BK - 1 <= q0 + off;
      f = any ? (all ? 3 : 1) : 0;
    } else if (n_keys > 0) {
      const int nq = warp_runs<2>(qb + q0, BQ, q_start[warp], q_code[warp], lane);
      f = runs_flag<MODE>(q_start[warp], q_code[warp], nq, q0, k_start[0], k_code[0],
                          n_runs[0], kv0, n_keys, whole, lane);
      __syncwarp();   // the warp's next q tile rewrites its runs
    }
    if (lane == 0) flags[i] = (unsigned char)f;
  }
  __syncthreads();
  compact(flags, n_q, n_q, bwd_list + ((long long)b * kt + j) * n_q,
          bwd_count + (long long)b * kt + j, &n_live);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Both lists in one launch. q_seg [B, lq] / kv_seg [B, lk] int32 codes
// (null in the causal mode), kv_len int32 [B] or null, q_offsets int32 [B]
// or null with the static q_offset (causal only); fwd_list [B,
// ceil(lq / 128), ceil(lk / 128)] and fwd_count [B, ceil(lq / 128)], or
// both null (no forward list; always in the causal mode); bwd_list [B,
// ceil(lk / 128), lq / 64] and bwd_count [B, ceil(lk / 128)], or both
// null. mode 1 segments, 2 packed, 3 causal.
int univid_tile_lists(const void* q_seg, const void* kv_seg, const void* kv_len,
                      const void* q_offsets, void* fwd_list, void* fwd_count, void* bwd_list,
                      void* bwd_count, int mode, int q_offset, int B, int lq, int lk,
                      void* stream) {
  const bool fwd = fwd_list != nullptr, bwd = bwd_list != nullptr;
  if (lq % 64 != 0 || lk % 64 != 0 || lq <= 0 || lk <= 0 || B <= 0 || B > 65535 ||
      (fwd != (fwd_count != nullptr)) || (bwd != (bwd_count != nullptr)) || !(fwd || bwd) ||
      (mode == CAUSAL && fwd) || (mode != CAUSAL && (q_seg == nullptr || kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int kt = (lk + BK - 1) / BK, q_tiles = (lq + FQ - 1) / FQ;
  const int n_fwd = fwd ? q_tiles : 0, n_bwd = bwd ? kt : 0;
  const int n_fwd_flags = fwd ? kt : 0, n_bwd_flags = bwd ? lq / BQ : 0;
  const int smem = n_fwd_flags > n_bwd_flags ? n_fwd_flags : n_bwd_flags;   // one a tile
  if (smem > MAX_FLAGS) return (int)cudaErrorInvalidValue;
  void (*kern)(const int*, const int*, const int*, const int*, int, int*, int*, int*, int*, int,
               int, int);
  switch (mode) {
    case SEGMENTS: kern = tile_lists_kernel<SEGMENTS>; break;
    case PACKED: kern = tile_lists_kernel<PACKED>; break;
    case CAUSAL: kern = tile_lists_kernel<CAUSAL>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  dim3 grid(n_fwd + n_bwd, B);
  kern<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offsets), q_offset,
      static_cast<int*>(fwd_list), static_cast<int*>(fwd_count), static_cast<int*>(bwd_list),
      static_cast<int*>(bwd_count), lq, lk, n_fwd);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel (one block of 32 threads): the floor a
// launch costs, timed beside the tile lists.
int univid_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
