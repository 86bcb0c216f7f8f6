// Round-B bit costs: literal bits and match gains of every position.
//
//   litbits[b, i] = lcost[b, lit[b, i]]
//   gain[b, i]    = pref[b, min(i + len, T)] - pref[b, i]
//                   - (lcost[b, 257 + lcode] + lext + dcost[b, dcode] + dext)
//                   (NEG_GAIN where len < 3); with a hot lane, the hot
//                   candidate replaces the round-A one on a strictly
//                   greater gain.
//
// Replaces decompress_tpu/ops/cost_pl.py: litbits_pl (_litbits_kernel) and
// gain_pl (_gain_kernel).  The TPU kernels padded the 286- and 30-entry
// tables to 384 and 128 lanes and read them through select trees of
// 128-lane gathers, and cut the prefix sum into 512-wide per-row slabs so
// that pref[i + len] stayed a lane gather.  Here each block stages its
// segment's tables in shared memory (1 KB for litbits, 1.3 KB for gain)
// and reads the prefix sum, one int32[B, T + 1] row per segment, straight
// from device memory: pref[i] is coalesced and pref[i + len] lies within
// 258 entries of it, so it hits the same or a neighbouring cache line of
// a row the block is already streaming.
//
// Bound on the H100: device memory.  litbits moves 5 bytes per position
// (1 in, 4 out), gain 28, or 36 with the hot lane (two or four int32 in,
// two prefix reads, three int32 out).  One thread per position, a
// grid-stride loop over a few positions each, consecutive threads on
// consecutive addresses; every table read is in shared memory.  Any B
// and T.

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

__global__ void litbits_kernel(const uint8_t* __restrict__ lit, int lit_stride,
                               const int* __restrict__ lcost, int* __restrict__ out, int T) {
  __shared__ int s_cost[256];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cost[i] = lcost[b * dtt::kNumLit + i];
  __syncthreads();

  const uint8_t* row = lit + static_cast<size_t>(b) * lit_stride;
  int* orow = out + static_cast<size_t>(b) * T;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < T; i += gridDim.x * blockDim.x)
    orow[i] = s_cost[row[i]];
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
// out: int32[B, T].
extern "C" int dtt_litbits(const uint8_t* lit, int lit_stride, const int* lcost, int* out, int B,
                           int T, void* stream) {
  litbits_kernel<<<dim3(tiles_per_row(T), B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lit, lit_stride, lcost, out, T);
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
