// Round-B bit costs: literal bits with their prefix sum, and match gains
// of every position.
//
//   litbits[b, i] = lcost[b, lit[b, i]]
//   pref[b, i]    = litbits[b, 0] + ... + litbits[b, i - 1]  (pref[b, 0] = 0)
//   gain[b, i]    = pref[b, min(i + len, T)] - pref[b, i]
//                   - (lcost[b, 257 + lcode] + lext + dcost[b, dcode] + dext)
//                   (NEG_GAIN where len < 3); with a hot lane, the hot
//                   candidate replaces the round-A one on a strictly
//                   greater gain.
//
// Replaces decompress_tpu/ops/cost_pl.py: litbits_pl (_litbits_kernel) and
// gain_pl (_gain_kernel), and the XLA cumsum that built the prefix
// between them.  The TPU kernels padded the 286- and 30-entry tables to
// 384 and 128 lanes and read them through select trees of 128-lane
// gathers, and cut the prefix sum into 512-wide per-row slabs so that
// pref[i + len] stayed a lane gather.  Here each block stages its
// segment's tables in shared memory (1 KB for litbits, 1.3 KB for gain)
// and the prefix sum is one int32[B, T + 1] row per segment in device
// memory: gain reads pref[i] coalesced, and pref[i + len] lies within 258
// entries of it, in the same or a neighbouring cache line of a row the
// block is already streaming.
//
// Bound on the H100: device memory.  litbits_pref moves 9 bytes per
// position (1 in, 4 + 4 out), gain 28, or 36 with the hot lane (two or
// four int32 in, two prefix reads, three int32 out).  litbits_pref is a
// reduce-then-scan over tiles of 4096 positions, 16 a thread read as one
// 16-byte load: the first launch writes each tile's sum of bits, the
// second adds its row's earlier tile sums, scans its tile (shuffles in
// each warp, then the warp sums), and writes both outputs through shared
// memory with consecutive threads on consecutive addresses.  The payload
// is read twice (1 byte a position each time): the scan looks the bits up
// again instead of reading back 4-byte bits, as a separate cumsum would.
// gain is one pass, one thread per position.  Any B and T; integer sums,
// so exact in any order.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "codes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;            // positions per thread (grid-stride)
constexpr int kNegGain = -(1 << 29);     // "no match" gain
constexpr int kMinMatch = 3;

int tiles_per_row(int T) {
  return std::max(1, (T + kThreads * kPerThread - 1) / (kThreads * kPerThread));
}

constexpr int kScanWarps = kThreads / 32;
constexpr int kPerScanThread = 16;                  // bytes per thread: one 16-byte load
constexpr int kScanTile = kThreads * kPerScanThread;  // 4096 positions per block
constexpr int kPad = kPerScanThread + 1;            // shared row pitch, off the banks' period

int scan_tiles(int T) { return std::max(1, (T + kScanTile - 1) / kScanTile); }

__device__ void stage_lit_costs(int* s_cost, const int* lcost, int b) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cost[i] = lcost[b * dtt::kNumLit + i];
  __syncthreads();
}

// The bits of the 16 literals row[i .. i + 16) (i a multiple of 16); 0
// at or past T.  One 16-byte load where the row is 16-byte aligned and
// the 16 bytes lie inside it (the batch payload's rows are).
__device__ __forceinline__ void sixteen_costs(const uint8_t* row, int i, int T, const int* s_cost,
                                              int (&c)[kPerScanThread]) {
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 && i + kPerScanThread <= T) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m) c[4 * q + m] = s_cost[(w[q] >> (8 * m)) & 0xff];
  } else {
#pragma unroll
    for (int m = 0; m < kPerScanThread; ++m) c[m] = i + m < T ? s_cost[row[i + m]] : 0;
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Launch one: tile_sums[b, tile] = the bits of the tile's literals.
__global__ void litbits_tally_kernel(const uint8_t* __restrict__ lit, int lit_stride,
                                     const int* __restrict__ lcost, int* __restrict__ tile_sums,
                                     int T) {
  __shared__ int s_cost[256];
  __shared__ int s_warp[kScanWarps];
  const int b = blockIdx.y;
  stage_lit_costs(s_cost, lcost, b);
  int c[kPerScanThread];
  sixteen_costs(lit + static_cast<size_t>(b) * lit_stride,
                blockIdx.x * kScanTile + threadIdx.x * kPerScanThread, T, s_cost, c);
  int sum = 0;
#pragma unroll
  for (int m = 0; m < kPerScanThread; ++m) sum += c[m];
  sum = warp_sum(sum);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tile = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) tile += s_warp[w];
    tile_sums[b * gridDim.x + blockIdx.x] = tile;
  }
}

// Launch two: each block adds its row's earlier tile sums, scans its own
// tile and writes its litbits and pref[i + 1] (the block of tile 0 also
// pref[0] = 0).
__global__ void litbits_scan_kernel(const uint8_t* __restrict__ lit, int lit_stride,
                                    const int* __restrict__ lcost,
                                    const int* __restrict__ tile_sums, int* __restrict__ litbits,
                                    int* __restrict__ pref, int T) {
  __shared__ int s_cost[256];
  __shared__ int s_warp[kScanWarps];
  __shared__ int s_before;
  __shared__ int s_bits[kThreads * kPad];
  __shared__ int s_pref[kThreads * kPad];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {  // the row's bits before this tile
    int before = 0;
    for (int k = lane; k < tile; k += 32) before += tile_sums[b * gridDim.x + k];
    before = warp_sum(before);
    if (lane == 0) s_before = before;
  }
  stage_lit_costs(s_cost, lcost, b);  // its barrier publishes s_before too
  int c[kPerScanThread];
  sixteen_costs(lit + static_cast<size_t>(b) * lit_stride,
                tile * kScanTile + threadIdx.x * kPerScanThread, T, s_cost, c);
  int own = 0;
#pragma unroll
  for (int m = 0; m < kPerScanThread; ++m) own += c[m];
  int incl = own;  // inclusive scan of the threads' sums within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = s_before + incl - own;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) run += w < warp ? s_warp[w] : 0;
#pragma unroll
  for (int m = 0; m < kPerScanThread; ++m) {
    run += c[m];
    s_bits[threadIdx.x * kPad + m] = c[m];
    s_pref[threadIdx.x * kPad + m] = run;
  }
  __syncthreads();
  int* lrow = litbits + static_cast<size_t>(b) * T;
  int* prow = pref + static_cast<size_t>(b) * (T + 1);
  const int t0 = tile * kScanTile;
#pragma unroll
  for (int r = 0; r < kPerScanThread; ++r) {
    const int k = r * kThreads + threadIdx.x;  // position in the tile
    if (t0 + k < T) {
      const int at = (k / kPerScanThread) * kPad + k % kPerScanThread;
      lrow[t0 + k] = s_bits[at];
      prow[t0 + k + 1] = s_pref[at];
    }
  }
  if (tile == 0 && threadIdx.x == 0) prow[0] = 0;
}

// Gain of the match (len, dist) at position i of a segment whose prefix
// row is prow and whose cost tables are staged in s_lc / s_dc.
__device__ __forceinline__ int match_gain(int len, int dist, int i, const int* __restrict__ prow,
                                          const int* s_lc, const int* s_dc, int T) {
  if (len < kMinMatch) return kNegGain;
  int lcode, lex, lval, dcode, dex, dval;
  dtt::length_code(len, lcode, lex, lval);
  dtt::dist_code(dist, dcode, dex, dval);
  const int cost = s_lc[257 + lcode] + lex + s_dc[dcode] + dex;
  return prow[min(i + len, T)] - prow[i] - cost;
}

__global__ void gain_kernel(const int* __restrict__ length, const int* __restrict__ dist,
                            const int* __restrict__ hot_len, const int* __restrict__ hot_dist,
                            const int* __restrict__ pref, const int* __restrict__ lcost,
                            const int* __restrict__ dcost, int* __restrict__ out_len,
                            int* __restrict__ out_dist, int* __restrict__ out_gain, int T) {
  __shared__ int s_lc[dtt::kNumLit];
  __shared__ int s_dc[dtt::kNumDist];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < dtt::kNumLit; i += blockDim.x) s_lc[i] = lcost[b * dtt::kNumLit + i];
  for (int i = threadIdx.x; i < dtt::kNumDist; i += blockDim.x) s_dc[i] = dcost[b * dtt::kNumDist + i];
  __syncthreads();

  const size_t row = static_cast<size_t>(b) * T;
  const int* prow = pref + static_cast<size_t>(b) * (T + 1);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < T; i += gridDim.x * blockDim.x) {
    int len = length[row + i];
    int d = dist[row + i];
    int g = match_gain(len, d, i, prow, s_lc, s_dc, T);
    if (hot_len != nullptr) {
      const int hl = hot_len[row + i];
      const int hd = hot_dist[row + i];
      const int hg = match_gain(hl, hd, i, prow, s_lc, s_dc, T);
      if (hg > g) {
        len = hl;
        d = hd;
        g = hg;
      }
    }
    out_len[row + i] = len;
    out_dist[row + i] = d;
    out_gain[row + i] = g;
  }
}

}  // namespace

// lit: uint8 rows of T bytes, lit_stride apart; lcost: int32[B, 286];
// tile_sums: int32[B, ceil(T / 4096)] scratch (at least one a row);
// litbits: int32[B, T]; pref: int32[B, T + 1].
extern "C" int dtt_litbits_pref(const uint8_t* lit, int lit_stride, const int* lcost,
                                int* tile_sums, int* litbits, int* pref, int B, int T,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(scan_tiles(T), B);
  litbits_tally_kernel<<<grid, kThreads, 0, s>>>(lit, lit_stride, lcost, tile_sums, T);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  litbits_scan_kernel<<<grid, kThreads, 0, s>>>(lit, lit_stride, lcost, tile_sums, litbits, pref,
                                                T);
  return static_cast<int>(cudaGetLastError());
}

// length, dist: int32[B, T]; hot_len, hot_dist: int32[B, T] or both null
// (no hot lane); pref: int32[B, T + 1]; lcost: int32[B, 286]; dcost:
// int32[B, 30]; out_len, out_dist, out_gain: int32[B, T].
extern "C" int dtt_gain(const int* length, const int* dist, const int* hot_len,
                        const int* hot_dist, const int* pref, const int* lcost, const int* dcost,
                        int* out_len, int* out_dist, int* out_gain, int B, int T, void* stream) {
  gain_kernel<<<dim3(tiles_per_row(T), B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      length, dist, hot_len, hot_dist, pref, lcost, dcost, out_len, out_dist, out_gain, T);
  return static_cast<int>(cudaGetLastError());
}
