// DEFLATE symbol decode of split rows: every row of every member decodes
// its commands at once, one thread per row.
//
// Row r of member m starts at bit start[r] of the member's body and
// decodes the commands that start before stop[r] (an interior row) or
// up to and including the end-of-block symbol (the final row, stop 0).
// cmds[r, :] gets the row's commands, kind << 26 | dist << 10 | value
// (kind 0 literal, 1 copy, 2 end), then the end filler 2 << 26; ok[r] =
// done and not bad; ncmds[r] = commands written.  An end-of-block in an
// interior row, an invalid code or an invalid distance code marks the row
// bad; a row still running after max_cmds commands is not done.
//
// Replaces decompress_tpu/ops/inflate_pl.py: _decode_pallas (its
// _decode_kernel).  The TPU kernel ran 128 rows in lockstep as vector
// lanes: it staged per-lane word slabs, read each lane's window through a
// where-chain over a per-row scalar window base, padded stalled lanes with
// NOP slots, and looked its tables up through select trees of 128-lane
// gathers.  Here a thread is a row and runs its own loop: it reads its
// bits straight from the member's word row (two 32-bit loads per peek,
// clamped to the row, so a corrupt stream never reads out of bounds) and
// writes only real commands.  One block per member stages the member's
// four tables (1024-entry roots, 2048/1024-entry subtables: 20 KB) in
// shared memory.
//
// Bound on the H100: latency of each row's serial chain (a peek, two
// dependent table reads, a second peek and two more per command), not
// bytes: the bytes moved are the body once and the commands written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRootSize = 1024;
constexpr int kLitSub = 2048;
constexpr int kDistSub = 1024;
constexpr int kThreads = 256;
constexpr int kEnd = 2 << 26;
constexpr int kClsInvalid = 0;
constexpr int kClsLen = 2;
constexpr int kClsEob = 3;
constexpr int kClsSub = 4;

// word wi of a member's row, the index clamped to the row
__device__ __forceinline__ uint64_t word_at(const uint32_t* w, int nw, int64_t wi) {
  return w[wi < 0 ? 0 : (wi < nw - 1 ? wi : nw - 1)];
}

// 32 stream bits from bit o of a member's word row (LSB-first)
__device__ __forceinline__ uint32_t peek32(const uint32_t* w, int nw, int64_t o) {
  const int64_t wi = o >> 5;
  return static_cast<uint32_t>(((word_at(w, nw, wi + 1) << 32) | word_at(w, nw, wi)) >> (o & 31));
}

// table entry of the code at the front of peek (root, then subtable)
__device__ __forceinline__ int lookup(const int* root, const int* sub, int sub_size,
                                      uint32_t peek) {
  const uint32_t idx15 = __brev(peek) >> 17;  // first 15 stream bits, MSB-first
  int e = root[idx15 >> 5];
  if ((e >> 24) == kClsSub) {
    const int s = (e & 0xFFFF) + static_cast<int>(idx15 & 31);
    e = sub[s < sub_size ? s : sub_size - 1];
  }
  return e;
}

__global__ void inflate_rows_kernel(const uint32_t* __restrict__ words, int nw,
                                    const int* __restrict__ lit_root,
                                    const int* __restrict__ lit_sub,
                                    const int* __restrict__ dist_root,
                                    const int* __restrict__ dist_sub,
                                    const int* __restrict__ row_ptr,
                                    const int* __restrict__ start, const int* __restrict__ stop,
                                    int* __restrict__ cmds, uint8_t* __restrict__ ok,
                                    int* __restrict__ ncmds, int max_cmds) {
  __shared__ int s_lr[kRootSize];
  __shared__ int s_ls[kLitSub];
  __shared__ int s_dr[kRootSize];
  __shared__ int s_ds[kDistSub];
  const int m = blockIdx.x;
  for (int i = threadIdx.x; i < kRootSize; i += blockDim.x) {
    s_lr[i] = lit_root[static_cast<size_t>(m) * kRootSize + i];
    s_dr[i] = dist_root[static_cast<size_t>(m) * kRootSize + i];
  }
  for (int i = threadIdx.x; i < kLitSub; i += blockDim.x)
    s_ls[i] = lit_sub[static_cast<size_t>(m) * kLitSub + i];
  for (int i = threadIdx.x; i < kDistSub; i += blockDim.x)
    s_ds[i] = dist_sub[static_cast<size_t>(m) * kDistSub + i];
  __syncthreads();

  const uint32_t* w = words + static_cast<size_t>(m) * nw;
  for (int r = row_ptr[m] + threadIdx.x; r < row_ptr[m + 1]; r += blockDim.x) {
    int64_t o = start[r];
    const int64_t st = stop[r];
    const bool interior = st > 0;
    bool done = false;
    bool bad = false;
    int n = 0;
    int* out = cmds + static_cast<size_t>(r) * max_cmds;
    for (; n < max_cmds; ++n) {
      if (interior && o >= st) break;
      const uint32_t peek = peek32(w, nw, o);
      const int e = lookup(s_lr, s_ls, kLitSub, peek);
      const int cls = e >> 24;
      const int nb = (e >> 20) & 15;
      const int xtr = (e >> 16) & 15;
      const int pay = e & 0xFFFF;
      const bool is_len = cls == kClsLen;
      const bool is_eob = cls == kClsEob;
      const int c1 = nb + xtr;
      const uint32_t peek2 = peek32(w, nw, o + c1);
      const int d = lookup(s_dr, s_ds, kDistSub, peek2);
      if (cls == kClsInvalid || (is_len && (d >> 24) == kClsInvalid) || (is_eob && interior)) {
        bad = true;
        break;
      }
      if (is_eob) {
        out[n++] = kEnd;
        o += c1;
        done = true;
        break;
      }
      if (is_len) {
        const int dnb = (d >> 20) & 15;
        const int dxn = (d >> 16) & 15;
        const int len = pay + 3 + static_cast<int>((peek >> nb) & ((1u << xtr) - 1u));
        const int dist = (d & 0xFFFF) + 1 + static_cast<int>((peek2 >> dnb) & ((1u << dxn) - 1u));
        out[n] = (1 << 26) | (dist << 10) | len;
        o += c1 + dnb + dxn;
      } else {
        out[n] = pay;
        o += c1;
      }
    }
    done = done || (interior && o >= st);
    ok[r] = done && !bad;
    ncmds[r] = n;
    for (int s = n; s < max_cmds; ++s) out[s] = kEnd;
  }
}

}  // namespace

// words: int32[m, nw] member body words; lit_root/dist_root: int32[m,
// 1024], lit_sub: int32[m, 2048], dist_sub: int32[m, 1024]; row_ptr:
// int32[m + 1]; start, stop: int32[R]; cmds: int32[R, max_cmds]; ok:
// bool[R]; ncmds: int32[R].
extern "C" int dtt_inflate_rows(const uint32_t* words, int nw, const int* lit_root,
                                const int* lit_sub, const int* dist_root, const int* dist_sub,
                                const int* row_ptr, const int* start, const int* stop, int* cmds,
                                uint8_t* ok, int* ncmds, int m, int max_cmds, void* stream) {
  if (m > 0)
    inflate_rows_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        words, nw, lit_root, lit_sub, dist_root, dist_sub, row_ptr, start, stop, cmds, ok,
        ncmds, max_cmds);
  return static_cast<int>(cudaGetLastError());
}
