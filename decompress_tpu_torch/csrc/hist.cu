// Per-segment symbol histograms of the marked parse: hist_lit[b, 286]
// counts on-path symbols (literal byte, or 257 + length code for a
// match; EOB not counted), hist_dist[b, 30] counts match distance codes.
//
// Replaces decompress_tpu/ops/hist_pl.py: histograms_pl (_hist_kernel),
// which accumulated 286 + 30 masked per-bin reductions per tile into a
// VMEM block carried across a segment's grid steps.
//
// Bound on the H100: device-memory reads, 11 bytes per position (two
// flags, two int32, one byte).  The first design read them a byte and an
// int32 at a time in a grid-stride loop, added each block's histogram
// into the output with global atomics (so the output needed two zero
// fills, three launches a call) and reached 46% of its bound.
//
// The design: one thread-block cluster per segment (16 blocks where the
// card allows that non-portable size, else 8), each block a contiguous
// 1/16 (1/8) of the segment, one 16-position chunk a thread.  A thread
// issues all of its chunk's loads before it uses any: the two flag rows
// as one uint4 each, length and distance as four int4 each, the payload
// row (a strided view that may be unaligned) as one uint4 where it is
// 16-byte aligned and bytes where it is not; rows whose flag or int rows
// are not 16-byte aligned, and the ragged row end, take byte and int
// loads.  Codes come from two small tables in shared memory and only
// where a position is on the path or a match.  Each warp counts into its
// own shared-memory histogram (316 bins).  The cluster adds the blocks'
// histograms through distributed shared memory: block q owns 1/16 (1/8)
// of the bins, every block stores its sums of them into q's shared memory
// (remote stores, which do not wait), and after one cluster barrier q
// adds what it received and writes its bins with plain stores.  So every
// output bin is written once: no zero fill, no global atomic, one launch,
// and a result that is the same in every run.  On the H100, variants of
// this kernel timed against each other showed the cluster's launch and
// its reduction each costing more than a plain grid of the same blocks,
// and contention on the shared atomics not limiting it (one histogram a
// block, or two a warp, timed the same).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "codes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;  // positions a thread takes at a time: one 16-byte load a flag row
constexpr int kBins = dtt::kNumLit + dtt::kNumDist;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes from p (16-byte aligned) as 4 little-endian words
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint32_t (&w)[kVec / 4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

// kVec int32 from p (16-byte aligned)
__device__ __forceinline__ void load_ints(const int* p, int (&v)[kVec]) {
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) {
    const int4 x = reinterpret_cast<const int4*>(p)[q];
    v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
  }
}

// Length and distance codes by table, in shared memory: lcode[length - 3]
// and, as zlib's _dist_code, dcode[d] for d = distance - 1 < 256 and
// dcode[256 + (d >> 7)] above (a code's extra bits are 7 or more there).
struct Codes {
  uint8_t lcode[256];
  uint8_t dcode[512];

  __device__ void build() {
    for (int i = threadIdx.x; i < 512; i += blockDim.x) {
      int code, extra, val;
      if (i < 256) {
        dtt::length_code(i + 3, code, extra, val);
        lcode[i] = static_cast<uint8_t>(code);
      }
      dtt::dist_code(i < 256 ? i + 1 : ((i - 256) << 7) + 1, code, extra, val);
      dcode[i] = static_cast<uint8_t>(code);
    }
  }
  // the clamps of dtt::length_code and dtt::dist_code
  __device__ __forceinline__ int len(int length) const {
    return lcode[min(max(length - 3, 0), 255)];
  }
  __device__ __forceinline__ int dist(int distance) const {
    const int d = min(max(distance - 1, 0), (1 << 15) - 1);
    return dcode[d < 256 ? d : 256 + (d >> 7)];
  }
};

// one position into a warp's histogram h: an on-path literal or match
// symbol, and a match's distance code (on the path or not)
__device__ __forceinline__ void count(int* h, const Codes& codes, bool op, bool m, int length,
                                      int distance, int literal) {
  if (op) atomicAdd(h + (m ? 257 + codes.len(length) : literal), 1);
  if (m) atomicAdd(h + dtt::kNumLit + codes.dist(distance), 1);
}

__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint8_t* __restrict__ on_path, const uint8_t* __restrict__ is_match,
                const int* __restrict__ length, const int* __restrict__ dist,
                const uint8_t* __restrict__ lit, int lit_stride, int* __restrict__ hist_lit,
                int* __restrict__ hist_dist, int T) {
  __shared__ int s_warp[kWarps][kBins];
  __shared__ int s_recv[kBins + 16];  // the cluster's partial sums of this block's bins
  __shared__ Codes codes;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  // first half of a barrier whose second half, before the first remote
  // store, ensures every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) (&s_warp[0][0])[i] = 0;
  codes.build();
  __syncthreads();

  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * T;
  const uint8_t* op_row = on_path + row;
  const uint8_t* m_row = is_match + row;
  const int* len_row = length + row;
  const int* dist_row = dist + row;
  const uint8_t* lit_row = lit + static_cast<size_t>(b) * lit_stride;
  const bool vec = aligned16(op_row) && aligned16(m_row) && aligned16(len_row) &&
                   aligned16(dist_row);
  const bool lit_vec = aligned16(lit_row);
  const int nchunks = (T + kVec - 1) / kVec;
  const int per = (nchunks + nrank - 1) / nrank;
  const int c_end = min(nchunks, (rank + 1) * per);
  int* h = s_warp[threadIdx.x / 32];
  for (int c = rank * per + threadIdx.x; c < c_end; c += kThreads) {
    const int i0 = c * kVec;
    if (vec && i0 + kVec <= T) {
      // every load of the chunk issued before any is used
      uint32_t ow[kVec / 4], mw[kVec / 4], lw[kVec / 4] = {};
      int lens[kVec], dists[kVec];
      load_bytes(op_row + i0, ow);
      load_bytes(m_row + i0, mw);
      load_ints(len_row + i0, lens);
      load_ints(dist_row + i0, dists);
      if (lit_vec) load_bytes(lit_row + i0, lw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool op = (ow[j / 4] >> (8 * (j % 4))) & 0xff;
        const bool m = (mw[j / 4] >> (8 * (j % 4))) & 0xff;
        if (!op && !m) continue;
        const int literal = lit_vec ? static_cast<int>((lw[j / 4] >> (8 * (j % 4))) & 0xff)
                                    : lit_row[i0 + j];
        count(h, codes, op, m, lens[j], dists[j], literal);
      }
    } else {
      for (int i = i0; i < min(i0 + kVec, T); ++i) {
        const bool op = op_row[i];
        const bool m = m_row[i];
        if (op || m) count(h, codes, op, m, len_row[i], dist_row[i], lit_row[i]);
      }
    }
  }
  __syncthreads();

  // block q owns bins [q * per_bin, (q + 1) * per_bin): each block sends
  // its sum of a bin to the owner's s_recv (remote stores do not wait),
  // and after one cluster barrier each owner adds what it received
  const int per_bin = (kBins + nrank - 1) / nrank;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_warp[w][i];
    const int q = i / per_bin;
    cluster.map_shared_rank(s_recv, q)[rank * per_bin + i - q * per_bin] = v;
  }
  cluster.sync();
  for (int j = threadIdx.x; j < per_bin && rank * per_bin + j < kBins; j += kThreads) {
    int v = 0;
    for (int q = 0; q < nrank; ++q) v += s_recv[q * per_bin + j];
    const int i = rank * per_bin + j;
    if (i < dtt::kNumLit)
      hist_lit[b * dtt::kNumLit + i] = v;
    else
      hist_dist[b * dtt::kNumDist + i - dtt::kNumLit] = v;
  }
}

// The launch of a grid of `rows` clusters of cs blocks each (attr is the
// configuration's storage for its one attribute).
cudaLaunchConfig_t clusters(int cs, int rows, cudaStream_t stream, cudaLaunchAttribute& attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// blocks in a segment's cluster: 16 where the card schedules that
// non-portable size, else the portable 8 (decided once)
int cluster_blocks() {
  static int size = 0;
  if (size == 0) {
    size = 8;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = clusters(16, 1, nullptr, attr);
    int active = 0;
    if (cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveClusters(&active, hist_kernel, &cfg) == cudaSuccess && active > 0)
      size = 16;
    cudaGetLastError();  // a refused probe is not an error of the launch
  }
  return size;
}

}  // namespace

extern "C" int dtt_hist_cluster_blocks() { return cluster_blocks(); }

// on_path, is_match: bool[B, T]; length, dist: int32[B, T]; lit: uint8
// rows of T bytes, lit_stride apart; hist_lit: int32[B, 286] and
// hist_dist: int32[B, 30], every bin written.
extern "C" int dtt_histograms(const uint8_t* on_path, const uint8_t* is_match, const int* length,
                              const int* dist, const uint8_t* lit, int lit_stride, int* hist_lit,
                              int* hist_dist, int B, int T, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      clusters(cluster_blocks(), B, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, hist_kernel, on_path, is_match, length, dist,
                                             lit, lit_stride, hist_lit, hist_dist, T);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
