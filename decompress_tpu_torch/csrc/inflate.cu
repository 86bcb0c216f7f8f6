// DEFLATE symbol decode of split rows: every row of every member decodes
// its commands at once, one warp per row.
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
// gathers.  Here a row reads its bits from its own window in shared memory
// and writes only real commands.
//
// Bound on the H100: not bytes (the body is read once and the commands
// written once) but the serial chain of each command, a peek, two
// dependent table reads, a second peek and two more, and the instructions
// that chain issues.  A row of 8,192 bits holds up to ~1,000 commands, so
// one thread a row (the first design) waited on ~860 such steps, and a
// block a member filled 65 of the 132 SMs with 44 live threads a block.
//
// The design: Huffman codes synchronise themselves: a decode started at an
// arbitrary bit falls onto the true codeword boundaries after a while.  A
// row splits into 32 lane ranges of L = ceil(span / 32) bits (span: to
// stop for an interior row, to the body's bit length for the final row),
// and lane k owns the commands that start in its range.  Three phases,
// each a walk of about L bits a lane:
//   1. speculate: each lane decodes from its lower bound until its cursor
//      passes its upper bound, and records its exit bit, its command count
//      and how it ended (ran out, end-of-block, bad code, max_cmds reached).
//      It starts where a walk from 256 bits before its range first lands
//      in the range, which is more often a true codeword start (DEFLATE's
//      raw extra bits and its switch between two alphabets make it
//      synchronise slowly: without that walk, 2.4 rounds a row followed);
//   2. synchronise: lane k takes lane k-1's exit (__shfl_up_sync) as its
//      start and decodes again where that differs from the start it used,
//      while __any_sync finds such a lane.  Lane 0's start is exact, so
//      after round j lanes 0..j are exact: at most 31 rounds.  A lane after
//      the first lane that ended (a ballot) is dead: its results drop.
//      Where the final row's exact decode reaches the body's end with no
//      end-of-block (a corrupt stream), its last lane then goes on alone,
//      with no upper bound, as the serial loop would; bounding it until
//      then keeps a speculative start past the end-of-block from decoding
//      the zero padding up to max_cmds;
//   3. write: an exclusive warp scan of the counts gives each lane its
//      output offset; each lane decodes its range a third time and writes
//      its commands below max_cmds, and the warp fills the rest of the row
//      with the end filler, coalesced.
// The first lane that ended decides the row as the serial loop would: a
// bad code or end-of-block in an interior row, or max_cmds reached, marks
// it not ok; an end-of-block in the final row is ok within max_cmds; an
// interior row where no lane ended is ok within max_cmds.  A row with
// span <= 0 runs on lane 0 alone.  A block is 8 warps on 8 rows of one
// member, which stages the member's four tables (1024-entry roots,
// 2048/1024-entry subtables: 20 KB) in shared memory, and each warp its
// row's first 320 words (10,240 bits: an 8,192-bit row and its warm-up),
// so that a peek is two shared loads; bits past them come from the
// member's word row, clamped to it, so a corrupt stream never reads out of
// bounds.  Bit positions are int32 relative to the row's first word.  A
// (member, first row) map per block, built on the host, gives the grid
// (~360 blocks on the 132 SMs).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRootSize = 1024;
constexpr int kLitSub = 2048;
constexpr int kDistSub = 1024;
constexpr int kWarps = 8;  // rows per block, one warp each
constexpr int kLanes = 32;
constexpr unsigned kMask = 0xffffffffu;
constexpr int kEnd = 2 << 26;
constexpr int kClsInvalid = 0;
constexpr int kClsLen = 2;
constexpr int kClsEob = 3;
constexpr int kClsSub = 4;
constexpr int kUnbounded = INT32_MAX;
constexpr int kWarmBits = 256;  // bits a lane decodes before its range, uncounted
constexpr int kWinWords = 320;       // words of a row staged in shared memory (10,240 bits)

// how a lane's walk ended
constexpr int kRan = 0;   // its cursor reached its upper bound
constexpr int kEob = 1;   // end-of-block of the final row (counted as a command)
constexpr int kBad = 2;   // invalid code or distance code, or end-of-block in an interior row
constexpr int kFull = 3;  // its command cap reached short of its upper bound

// word wi of a member's row, the index clamped to the row
__device__ __forceinline__ uint64_t word_at(const uint32_t* w, int nw, int64_t wi) {
  return w[wi < 0 ? 0 : (wi < nw - 1 ? wi : nw - 1)];
}

// The bits a warp reads, at positions relative to base_bit (the row's
// start rounded down to a word): the row's first kWinWords words in
// shared memory, and the member's word row behind them.
struct Bits {
  const uint32_t* w;  // the member's word row
  int nw;
  const uint32_t* win;  // win[i] = word_at(w, nw, base_bit / 32 + i)
  int64_t base_bit;

  // 32 stream bits from relative bit r >= 0 (LSB-first)
  __device__ __forceinline__ uint32_t peek32(int r) const {
    if (static_cast<unsigned>(r) < (kWinWords - 1) * 32u) {
      const int i = r >> 5;
      const uint64_t two = (static_cast<uint64_t>(win[i + 1]) << 32) | win[i];
      return static_cast<uint32_t>(two >> (r & 31));
    }
    const int64_t wi = (base_bit + r) >> 5;
    return static_cast<uint32_t>(((word_at(w, nw, wi + 1) << 32) | word_at(w, nw, wi)) >> (r & 31));
  }
};

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

struct Tables {
  const int* lit_root;
  const int* lit_sub;
  const int* dist_root;
  const int* dist_sub;
};

struct Walk {
  int o;      // exit bit, relative (the bad symbol's start for kBad)
  int n;      // commands decoded
  int end;    // how it ended
};

// Decode the commands that start in [o, hi), at most cap of them; with
// kWrite, each command i goes to out[i].
template <bool kWrite>
__device__ Walk walk(const Bits& bits, const Tables& t, int o, int hi, bool interior, int cap,
                     int* out) {
  int n = 0;
  while (o < hi) {
    if (n == cap) return {o, n, kFull};
    const uint32_t peek = bits.peek32(o);
    const int e = lookup(t.lit_root, t.lit_sub, kLitSub, peek);
    const int cls = e >> 24;
    const int nb = (e >> 20) & 15;
    const int xtr = (e >> 16) & 15;
    const int pay = e & 0xFFFF;
    const int c1 = nb + xtr;
    if (cls == kClsInvalid) return {o, n, kBad};
    if (cls == kClsEob) {
      if (interior) return {o, n, kBad};
      if (kWrite) out[n] = kEnd;
      return {o + c1, n + 1, kEob};
    }
    int cmd = pay;
    if (cls == kClsLen) {
      const uint32_t peek2 = bits.peek32(o + c1);
      const int d = lookup(t.dist_root, t.dist_sub, kDistSub, peek2);
      if ((d >> 24) == kClsInvalid) return {o, n, kBad};
      const int dnb = (d >> 20) & 15;
      const int dxn = (d >> 16) & 15;
      const int len = pay + 3 + static_cast<int>((peek >> nb) & ((1u << xtr) - 1u));
      const int dist = (d & 0xFFFF) + 1 + static_cast<int>((peek2 >> dnb) & ((1u << dxn) - 1u));
      cmd = (1 << 26) | (dist << 10) | len;
      o += dnb + dxn;
    }
    if (kWrite) out[n] = cmd;
    o += c1;
    ++n;
  }
  return {o, n, kRan};
}

__global__ void __launch_bounds__(kWarps * kLanes)
    inflate_rows_kernel(const uint32_t* __restrict__ words, int nw,
                        const int* __restrict__ lit_root, const int* __restrict__ lit_sub,
                        const int* __restrict__ dist_root, const int* __restrict__ dist_sub,
                        const int* __restrict__ row_ptr, const int* __restrict__ start,
                        const int* __restrict__ stop, const int* __restrict__ nbits,
                        const int2* __restrict__ blocks, int* __restrict__ cmds,
                        uint8_t* __restrict__ ok, int* __restrict__ ncmds,
                        int* __restrict__ rounds, int max_cmds) {
  __shared__ __align__(16) int s_lr[kRootSize];
  __shared__ __align__(16) int s_ls[kLitSub];
  __shared__ __align__(16) int s_dr[kRootSize];
  __shared__ __align__(16) int s_ds[kDistSub];
  __shared__ uint32_t s_win[kWarps][kWinWords];
  const int2 blk = blocks[blockIdx.x];  // (member, first row)
  const int m = blk.x;
  {
    const int4* lr = reinterpret_cast<const int4*>(lit_root + static_cast<size_t>(m) * kRootSize);
    const int4* ls = reinterpret_cast<const int4*>(lit_sub + static_cast<size_t>(m) * kLitSub);
    const int4* dr = reinterpret_cast<const int4*>(dist_root + static_cast<size_t>(m) * kRootSize);
    const int4* ds = reinterpret_cast<const int4*>(dist_sub + static_cast<size_t>(m) * kDistSub);
    for (int i = threadIdx.x; i < kRootSize / 4; i += blockDim.x) {
      reinterpret_cast<int4*>(s_lr)[i] = lr[i];
      reinterpret_cast<int4*>(s_dr)[i] = dr[i];
      reinterpret_cast<int4*>(s_ds)[i] = ds[i];
    }
    for (int i = threadIdx.x; i < kLitSub / 4; i += blockDim.x)
      reinterpret_cast<int4*>(s_ls)[i] = ls[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & (kLanes - 1);
  const int r = blk.y + static_cast<int>(threadIdx.x / kLanes);
  if (r >= row_ptr[m + 1]) return;  // the member's last block may hold fewer rows
  const Tables t{s_lr, s_ls, s_dr, s_ds};
  const int64_t st = start[r];
  const uint32_t* w = words + static_cast<size_t>(m) * nw;
  uint32_t* win = s_win[threadIdx.x / kLanes];
  const int64_t base = st >> 5;
  for (int i = lane; i < kWinWords; i += kLanes)
    win[i] = static_cast<uint32_t>(word_at(w, nw, base + i));
  __syncwarp();
  const Bits bits{w, nw, win, base * 32};
  // positions from here on are relative to base * 32, as int: a row spans
  // less than 2^30 bits (inflate_cu.stage checks it)
  const int64_t sp = stop[r];
  const bool interior = sp > 0;
  const int rs = static_cast<int>(st - base * 32);  // the row's start, 0..31
  const int64_t span = (interior ? sp : static_cast<int64_t>(nbits[m])) - st;
  const int covered = static_cast<int>(span > 0 ? span : 0);
  const int L = (covered + kLanes - 1) / kLanes;
  const int last = span > 0 ? kLanes - 1 : 0;  // the lane whose range runs to the row's end
  const int lo = rs + min(lane * L, covered);
  const int hi = lane == last ? rs + (interior ? static_cast<int>(sp - st) : covered)
                              : rs + min((lane + 1) * L, covered);

  // 1. speculate, from the first command start at or past lo that a walk
  // from kWarmBits before lo finds (lo itself if that walk ends early)
  int s = lo;
  if (lane > 0 && lane <= last) {
    const Walk warm =
        walk<false>(bits, t, max(rs, lo - kWarmBits), lo, interior, max_cmds, nullptr);
    if (warm.end == kRan) s = warm.o;
  }
  Walk a = walk<false>(bits, t, s, hi, interior, max_cmds, nullptr);

  // 2. synchronise
  int nr = 0;
  bool dead;
  for (;;) {
    const int prev = __shfl_up_sync(kMask, a.o, 1);
    const unsigned ended = __ballot_sync(kMask, a.end != kRan);
    dead = (ended & ((1u << lane) - 1u)) != 0;
    const bool redo = lane > 0 && !dead && prev != s;
    if (!__any_sync(kMask, redo)) break;
    if (redo) {
      s = prev;
      a = walk<false>(bits, t, s, hi, interior, max_cmds, nullptr);
    }
    ++nr;
  }

  // the final row's exact decode ran to the body's end without an
  // end-of-block: its last lane goes on, unbounded, to an end-of-block, a
  // bad code or max_cmds commands of its own
  unsigned ended = __ballot_sync(kMask, a.end != kRan);
  if (!interior && ended == 0) {
    if (lane == last) {
      const Walk b = walk<false>(bits, t, a.o, kUnbounded, false, max_cmds - a.n, nullptr);
      a = {b.o, a.n + b.n, b.end};
    }
    ended = __ballot_sync(kMask, a.end != kRan);
  }

  // 3. write
  const int cnt = dead ? 0 : a.n;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const int v = __shfl_up_sync(kMask, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kMask, incl, kLanes - 1);
  const int off = incl - cnt;
  const int how = __shfl_sync(kMask, a.end, ended ? __ffs(ended) - 1 : 0);
  const int n = min(total, max_cmds);
  const bool good = total <= max_cmds && (ended ? how == kEob : interior);
  int* out = cmds + static_cast<size_t>(r) * max_cmds;
  if (cnt > 0 && off < max_cmds)
    walk<true>(bits, t, s, !interior && lane == last ? kUnbounded : hi, interior,
               min(cnt, max_cmds - off), out + off);
  for (int i = n + lane; i < max_cmds; i += kLanes) out[i] = kEnd;
  if (lane == 0) {
    ok[r] = good;
    ncmds[r] = n;
    if (rounds != nullptr) rounds[r] = nr;
  }
}

}  // namespace

// words: int32[m, nw] member body words; lit_root/dist_root: int32[m,
// 1024], lit_sub: int32[m, 2048], dist_sub: int32[m, 1024]; row_ptr:
// int32[m + 1]; start, stop: int32[R]; nbits: int32[m] body bit lengths;
// blocks: int32[nblocks, 2] (member, first row) of each block of 8 rows;
// cmds: int32[R, max_cmds]; ok: bool[R]; ncmds: int32[R]; rounds:
// int32[R] synchronisation rounds of each row, or null.
extern "C" int dtt_inflate_rows(const uint32_t* words, int nw, const int* lit_root,
                                const int* lit_sub, const int* dist_root, const int* dist_sub,
                                const int* row_ptr, const int* start, const int* stop,
                                const int* nbits, const int* blocks, int nblocks, int* cmds,
                                uint8_t* ok, int* ncmds, int* rounds, int max_cmds, void* stream) {
  if (nblocks > 0)
    inflate_rows_kernel<<<nblocks, kWarps * kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        words, nw, lit_root, lit_sub, dist_root, dist_sub, row_ptr, start, stop, nbits,
        reinterpret_cast<const int2*>(blocks), cmds, ok, ncmds, rounds, max_cmds);
  return static_cast<int>(cudaGetLastError());
}
