// Mark path: the positions visited by walking a strictly increasing jump
// array g (i < g[i] <= P) from 0, per segment.
//
// Replaces decompress_tpu/ops/parse_pl.py: mark_path_pl — the Pallas
// _exit_kernel and _refine_kernel and the XLA row-hop lax.scan between
// them.  Same three stages, with 1024-position chunks instead of
// 128-lane rows:
//   1. chunk_exit_kernel: one block per (segment, chunk) builds the
//      chunk's pointer-doubling levels and writes exit[i] = first walk
//      value >= chunk end from i, plus a compact head table: the exits
//      of each chunk's first kHeadW positions;
//   2. chunk_hop_kernel: one thread per segment stages the segment's
//      head table in shared memory by bulk copies (TMA, one per group of
//      kGroup chunks, each completing on its own mbarrier) through a ring
//      of kStages groups (at P = 2^17 the whole 147 KB table is in flight
//      at once; a larger P wraps the ring), and hops across the P/C chunk
//      entries as each group lands;
//   3. chunk_refine_kernel: rebuilds the levels and refines each
//      position's entry top-down; on_path = entry == i.
//
// Bound on the H100: latency, not bandwidth.  The data is 4 bytes in
// and 1 byte out per position (~5 MB per 8-segment batch), but every
// doubling level is a dependent gather and stage 2 is a serial chain of
// P/C = 128 steps.  What the design does about it:
//   - the hop walks at shared-memory latency, not device-memory latency:
//     on the parse's jump arrays a walk enters a chunk at an offset below
//     MAX_MATCH = 258 (the step into the chunk is at most 258 long), so
//     the head table holds every exit the walk reads; an offset >= kHeadW
//     (a generic g) reads exits[] in device memory, so the kernel is
//     exact for every input with no host check;
//   - levels 1..5 of the doubling stay inside a warp (a level-k block is
//     2^k <= 32 aligned positions) and are built by __shfl_sync on
//     registers, with no shared memory or barrier; only levels 6..10 use
//     shared memory and __syncthreads(), and the refine pass reads its
//     low levels by shuffles too;
//   - exit and refine issue more instructions than they wait on (1024
//     threads a block, two blocks an SM), so both are templated on the
//     chunk size (every level unrolled, no per-level guard), walk values
//     are kept relative to the chunk start (a level's test is one xor
//     and compare), and refine loads its entry before it builds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunkLogMax = 10;
constexpr int kWarpLog = 5;  // levels <= 5 lie inside one warp
constexpr int kHeadW = 288;  // MAX_MATCH + 1 = 259, rounded up to 32
constexpr int kGroup = 8;    // chunks of heads per bulk copy
constexpr int kStages = 16;  // groups in the hop's shared-memory ring
constexpr int kSlot = kGroup * kHeadW;                                   // ints per group
constexpr int kHopSmem = kStages * kSlot * static_cast<int>(sizeof(int));  // 147,456 bytes

static_assert(kHeadW % 4 == 0, "bulk copies move whole 16-byte pieces");

// Shared memory of a chunk's levels kWarpLog..kLog: level k at [k - kWarpLog].
template <int kLog>
using Levels = int[kLog >= kWarpLog ? kLog - kWarpLog + 1 : 1][1 << kLog];

// Levels 0..kUpto of ex[k][j] = walk value after entering at base + j and
// stepping until leaving j's aligned 2^k block, relative to base.  Levels
// 0..4 go to reg (each thread its own position's), levels 5..kUpto to
// sh[k - kWarpLog]; returns ex[kUpto][j].  A value rel lies in j's
// level-k block iff (rel ^ j) < 2^k (rel > j >= 0; the walk's end P is
// outside every block).  For k <= 5 the value stepped to, ex[k-1][rel],
// has rel inside j's level-k block, so inside the warp: a shuffle from
// lane rel & 31.
template <int kLog, int kUpto>
__device__ __forceinline__ int build_levels(const int* __restrict__ g_row, int base, int j,
                                            int (&reg)[kWarpLog], Levels<kLog>& sh) {
  constexpr unsigned kMask = kLog >= 5 ? 0xffffffffu : (1u << (1 << kLog)) - 1u;
  int rel = g_row[base + j] - base;
  reg[0] = rel;
#pragma unroll
  for (int k = 1; k <= (kUpto < kWarpLog ? kUpto : kWarpLog); ++k) {
    const bool inside = (rel ^ j) < (1 << k);
    const int stepped = __shfl_sync(kMask, rel, inside ? rel & 31 : j & 31);
    rel = inside ? stepped : rel;
    if (k < kWarpLog) reg[k] = rel;
  }
  if constexpr (kUpto >= kWarpLog) {
    sh[0][j] = rel;
    __syncthreads();
#pragma unroll
    for (int k = kWarpLog + 1; k <= kUpto; ++k) {
      if ((rel ^ j) < (1 << k)) rel = sh[k - 1 - kWarpLog][rel];
      sh[k - kWarpLog][j] = rel;
      __syncthreads();
    }
  }
  return rel;
}

template <int kLog>
__global__ void __launch_bounds__(1 << kLog)
    chunk_exit_kernel(const int* __restrict__ g, int* __restrict__ exits, int* __restrict__ heads,
                      int P) {
  __shared__ Levels<kLog> sh;
  const size_t row = static_cast<size_t>(blockIdx.y) * P;
  const int base = blockIdx.x << kLog;
  const int j = threadIdx.x;
  int reg[kWarpLog];
  const int out = base + build_levels<kLog, kLog>(g + row, base, j, reg, sh);
  exits[row + base + j] = out;
  if (j < kHeadW)
    heads[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kHeadW + j] = out;
}

template <int kLog>
__global__ void __launch_bounds__(1 << kLog)
    chunk_refine_kernel(const int* __restrict__ g, const int* __restrict__ entries,
                        uint8_t* __restrict__ on_path, int P) {
  __shared__ Levels<kLog> sh;
  constexpr unsigned kMask = kLog >= 5 ? 0xffffffffu : (1u << (1 << kLog)) - 1u;
  const size_t row = static_cast<size_t>(blockIdx.y) * P;
  const int base = blockIdx.x << kLog;
  const int j = threadIdx.x;
  // e = first walk value >= the start of j's level-(k + 1) block, relative
  // to base; loaded first, so its latency hides under the level build
  int e = entries[static_cast<size_t>(blockIdx.y) * (P >> kLog) + blockIdx.x] - base;
  int reg[kWarpLog];
  build_levels<kLog, kLog - 1>(g + row, base, j, reg, sh);
  // step where j is in the right half of its level-(k + 1) block and e
  // in the left half (e < the start of j's level-k block)
#pragma unroll
  for (int k = kLog - 1; k >= kWarpLog; --k) {
    if (((j >> k) & 1) && e < (j & ~((1 << k) - 1))) e = sh[k - kWarpLog][e];
  }
  // below level 5 that left half is in the warp
#pragma unroll
  for (int k = (kLog < kWarpLog ? kLog : kWarpLog) - 1; k >= 0; --k) {
    const bool step = ((j >> k) & 1) && e < (j & ~((1 << k) - 1));
    const int stepped = __shfl_sync(kMask, reg[k], step ? e & 31 : j & 31);
    e = step ? stepped : e;
  }
  on_path[row + base + j] = e == j;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Bulk copy (TMA) of one group of head rows into its ring slot, completing
// on the slot's mbarrier.
__device__ __forceinline__ void load_group(int* slot, const int* src, unsigned bytes,
                                           uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(slot)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wait_group(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One thread per segment: it issues every copy and walks.
__global__ void __launch_bounds__(1)
    chunk_hop_kernel(const int* __restrict__ exits, const int* __restrict__ heads,
                     int* __restrict__ entries, int P, int chunk_log) {
  extern __shared__ __align__(128) int ring[];  // kStages slots of kGroup head rows
  __shared__ __align__(8) uint64_t full[kStages];
  const int b = blockIdx.x;
  const int chunk = 1 << chunk_log;
  const int nchunks = P >> chunk_log;
  const int ngroups = (nchunks + kGroup - 1) / kGroup;
  const int* hrow = heads + static_cast<size_t>(b) * nchunks * kHeadW;
  const int* erow = exits + static_cast<size_t>(b) * P;
  int* out = entries + static_cast<size_t>(b) * nchunks;
  for (int i = 0; i < kStages; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[i])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto issue = [&](int grp) {
    const int c0 = grp * kGroup;
    const unsigned bytes = min(kGroup, nchunks - c0) * kHeadW * sizeof(int);
    load_group(ring + (grp % kStages) * kSlot, hrow + static_cast<size_t>(c0) * kHeadW, bytes,
               &full[grp % kStages]);
  };
  for (int grp = 0; grp < min(kStages, ngroups); ++grp) issue(grp);
  // a walk enters chunk c at off = w - c * chunk; heads hold off < lim
  const int lim = min(chunk, kHeadW);
  int w = 0;  // first walk value >= the current chunk's start
  for (int grp = 0; grp < ngroups; ++grp) {
    wait_group(&full[grp % kStages], (grp / kStages) & 1);
    const int* s = ring + (grp % kStages) * kSlot;
    const int c0 = grp * kGroup;
    const int c1 = min(c0 + kGroup, nchunks);
    for (int c = c0; c < c1; ++c) {
      out[c] = w;
      const int off = w - c * chunk;
      int next = s[(c - c0) * kHeadW + min(off, lim - 1)];
      if (off >= lim) next = off < chunk ? erow[w] : w;  // a far entry, or the chunk skipped
      w = next;
    }
    if (grp + kStages < ngroups) {  // refill the slot just walked
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(grp + kStages);
    }
  }
}

template <int kLog>
cudaError_t launch(const int* g, int* exits, int* heads, int* entries, uint8_t* on_path, int B,
                   int P, cudaStream_t s) {
  const dim3 grid(P >> kLog, B);
  chunk_exit_kernel<kLog><<<grid, 1 << kLog, 0, s>>>(g, exits, heads, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_hop_kernel<<<B, 1, kHopSmem, s>>>(exits, heads, entries, P, kLog);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_refine_kernel<kLog><<<grid, 1 << kLog, 0, s>>>(g, entries, on_path, P);
  return cudaGetLastError();
}

}  // namespace

// g, exits: int32[B, P]; heads: int32[B, P >> chunk_log, 288] scratch,
// 16-byte aligned; entries: int32[B, P >> chunk_log] scratch; on_path:
// uint8[B, P].  P a power of two, 1 <= chunk_log <= 10.
extern "C" int dtt_mark_path(const int* g, int* exits, int* heads, int* entries,
                             uint8_t* on_path, int B, int P, int chunk_log, void* stream) {
  if (chunk_log < 1 || chunk_log > kChunkLogMax || (P >> chunk_log) << chunk_log != P ||
      (reinterpret_cast<uintptr_t>(heads) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      chunk_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHopSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (chunk_log) {
    case 1: err = launch<1>(g, exits, heads, entries, on_path, B, P, s); break;
    case 2: err = launch<2>(g, exits, heads, entries, on_path, B, P, s); break;
    case 3: err = launch<3>(g, exits, heads, entries, on_path, B, P, s); break;
    case 4: err = launch<4>(g, exits, heads, entries, on_path, B, P, s); break;
    case 5: err = launch<5>(g, exits, heads, entries, on_path, B, P, s); break;
    case 6: err = launch<6>(g, exits, heads, entries, on_path, B, P, s); break;
    case 7: err = launch<7>(g, exits, heads, entries, on_path, B, P, s); break;
    case 8: err = launch<8>(g, exits, heads, entries, on_path, B, P, s); break;
    case 9: err = launch<9>(g, exits, heads, entries, on_path, B, P, s); break;
    case 10: err = launch<10>(g, exits, heads, entries, on_path, B, P, s); break;
  }
  return static_cast<int>(err);
}
