// Round A's candidate search: the probe record of every position, the
// rank-space probe of the sorted hash buckets, then the winner's exact
// extension with the runs, hash3 and clamp merges.
//
// Replaces XLA code of decompress_tpu/ops/lz77.py: _match_candidates (no
// Pallas kernel): the words, the fingerprint pyramid, the probe fields
// and the run lengths (lz77.py:174-224, 283-330, 515-526), probe_step
// (lz77.py:354, a lax.scan over the K previous sorted ranks at :457 and
// :464) with the packed-winner scatter, and the winner's descend
// (lz77.py:570) or exact linear extension, then the merges.  As eager
// torch the record build was ~200 launches over int64 [B, T] arrays, the
// scan ~150 launches per k, and the rest ~160 launches a batch.
//
// fields: one block per (row, tile of kFieldsTile positions).  The block
// stages its tile's bytes with the 223 bytes ahead a record reads (the
// 257 a capped run reads) and kBehind behind in shared memory, every
// index taken mod T (the torch code built the words and fingerprints
// with torch.roll, which wraps at the row end).  It builds the words,
// then the doubling chain of the fingerprint pyramid level by level in
// shared memory as uint32 with native 32-bit multiplies (the torch
// code's int64 _mul32 exists only because torch has no uint32 product),
// and writes each output once, coalesced: the word, the unsorted sort
// key (below), the probe record (below), the span walk's fingerprints
// 128..8 on "span", and the four run lengths d = 1..4 over the payload,
// capped at MAX_MATCH (extend reads them only through that cap).  The runs come
// from a bitmap of data[q] == data[q - d] (a warp ballot a 32-position
// word, false past the row end) and a reverse scan of each word's first
// false position over the tile and its halo: a run costs one bitmap word
// and the scan's value, not up to 258 compares.
//
// Key and record.  With m = w * HASH_MUL (mod 2^32), whose top 15 bits
// are the bucket hash, the key is hash15 << (pos_bits + kKeyLow) | pos <<
// kKeyLow | m's low kKeyLow bits: it sorts as (hash, pos) does, positions
// being unique, and carries m whole, so w = m * kHashMulInv.  The record
// holds the ladder's other fields: 8 words on the full ladder (32 bytes,
// one sector: the probe's random gather of a record costs one sector,
// where the 9 fields took two), 3 and a zero on the short one.  The
// kernel writes a warp's 32 full records through shared memory, so that
// each store of the warp covers 512 contiguous bytes.
//
// probe: one block per (row, tile of kTile ranks).  The block stages the
// keys and probe records of its tile and of the K ranks before it (none
// before the row's start) in shared memory, each record gathered by
// position as 16-byte cp.async copies (L2 only) into a rank-major layout
// (48 bytes a full record there) whose 16-byte reads are free of bank
// conflicts when a warp's 32 consecutive ranks read them: a record is
// read from device memory once a block instead of K times.  Each thread
// then walks its rank's predecessors in shared memory: a candidate's word
// comes from its key, its record's first vector (fields 1-4) only where
// it shares 3 bytes, the rest only where its first 8 bytes match.  A
// candidate can win only if it has the rank's hash, lies within max_dist
// and at or after valid_lo; in the sorted order each of these fails for
// good at the first predecessor that breaks it, so the walk stops there,
// on one compare of keys.  A candidate that cannot win changes nothing:
// its score is the -2^30 sentinel and both the best and the runner-up
// move only on a strictly greater score (the first maximum in k order
// wins, the reference's argmax parity).  History positions (pos < hist)
// write nothing; the packed winner goes straight to its position,
// out[b, pos - hist].
//
// extend: one thread per payload position.  It unpacks the winner and
// resolves its length by mode: "rec" (levels 5-12) the floor plus the
// common prefix of the 16 words at the floor, the runner-up too at top2
// (the longer, or tied, nearer kept); "span" (levels 1-4) spans 128 to 4
// of the fingerprints, then the exact 0..3-byte refine and the tier-1
// fix-up; "exact" (force_exact) 4-byte steps to MAX_MATCH + 4.  Then the
// runs merge over d = 1..4, hash3 where the length is under MIN_MATCH,
// and the clamps to MAX_MATCH, the row's valid end, TOO_FAR at length 3
// and MIN_MATCH.  The hash3 candidates (a sort) come in from torch.
//
// Index rules, each where the plain code has it, since they decide bytes:
//  - the words w and the fingerprints wrap at the row end (word T - 1
//    holds bytes T - 1, 0, 1, 2); fields builds them so, extend reads
//    them as given;
//  - the runs compare data[q] with data[(q - d) mod T] and stop at the
//    row end;
//  - the rec descent reads word (start + 4j) mod T, start clamped to T - 1;
//  - the span walk, the refine and the exact extension clamp their index
//    to T - 1.
// Scores fit int32 (grade <= 224 and 224 << 17 < 2^30); the packed word
// cand << 12 | floor << 3 | tier << 1 | has is int64 (cand << 12 passes
// 2^31 on rows of 2^19 bytes and more).
//
// Bound on the H100: device memory.  fields reads the bytes once and
// writes 8 + 8 + 32 B a position (8 + 8 + 16 + 40 on "span") and 16 B a
// payload position of runs.  probe reads each sorted key (8 B) and record
// (32 B, one sector, at R = 9, 16 at R = 4) once (plus the K-rank halo
// of each tile, 6% at K = 16) and writes 8 B a payload position (16 at
// top2), scattered by position; the shared-memory walk is at most K x (R
// + 2) words a rank.  extend reads the packed word(s), the 4 run lengths
// and the hash3 candidate once and writes 8 B a position; its gathers of
// w around the winner and the position (and of the fingerprints on the
// span walk) hit L2, where the batch's 10 MB of words stay.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 256;     // probe: ranks per block, one thread each
constexpr int kThreads = 256;  // extend: positions per block
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kTooFar = 4096;
constexpr int kNegInf = -(1 << 30);
constexpr int kRecWords = 16;  // the rec descent's 64 bytes
constexpr int kSpans = 5;      // span-walk fingerprints: 128, 64, 32, 16, 8

// fields: the hash constants of lz77 (HASH_MUL, PREMIX_MUL, MIX_ROT, HASH_BITS)
constexpr uint32_t kHashMul = 2654435761u;
constexpr uint32_t kPremixMul = 2246822519u;
constexpr int kMixRot = 13;
constexpr int kHashBits = 15;
constexpr int kKeyLow = 32 - kHashBits;  // m's bits below the position in a key
constexpr uint32_t kKeyLowMask = (1u << kKeyLow) - 1;
constexpr uint32_t kHashMulInv = 244002641u;  // kHashMul * kHashMulInv == 1 mod 2^32
static_assert(kHashMul * kHashMulInv == 1u, "the inverse of the hash multiplier");
constexpr int kFieldsTile = 1024;   // positions per block
constexpr int kFieldsThreads = 256;
constexpr int kBehind = 4;          // the runs' largest distance
// the runs' bitmap: 32-position words from the tile's start, covering the
// tile and the 257 positions a capped run past its last position reads
constexpr int kRunWords = (kFieldsTile + kMaxMatch + 31) / 32;
constexpr int kFieldBytes = kBehind + 32 * kRunWords;  // staged bytes, from t0 - kBehind
// the pyramid's levels, each as far past the tile as a record reads it:
// the 32-byte fingerprint at +192 (the last field), the 64-byte at +128
constexpr int kFp64 = kFieldsTile + 128;
constexpr int kFp32 = kFieldsTile + 192;
constexpr int kFp16 = kFp32 + 16;
constexpr int kFp8 = kFp16 + 8;
constexpr int kWords = kFp8 + 4;
constexpr int kNoFalse = 1 << 30;  // no false compare in the bitmap's reach
static_assert(kWords + 3 <= kFieldBytes - kBehind, "the words read staged bytes only");
static_assert(kRunWords <= 64, "one warp scans a distance's bitmap, two words a lane");

// Equal low-order bytes of two words, given their xor (0..4).
__device__ __forceinline__ int prefix_bytes_equal(uint32_t x) {
  return x == 0 ? 4 : (__ffs(static_cast<int>(x)) - 1) >> 3;
}

// The ladder's rungs above the two exact words (lz77 _ladder_rungs), from
// the xors of the probe fields: a rung counts while every rung before it
// hit.  Short ladder (R = 4): the 16- and 64-byte fingerprints.  Full
// ladder (R = 9): the 16-byte fingerprint and six packed pairs of 16-bit
// hashes, floors 10, 12, 14, 16, 20, 24, 32, 48, 64, 96, 128, 192, 224.
template <int R>
__device__ __forceinline__ int rung_grade(const uint32_t (&x)[R]) {
  if constexpr (R == 4) {
    if (x[2] != 0) return 0;
    return x[3] != 0 ? 8 : 56;
  } else {
    const uint32_t hi = 0xFFFF0000u, lo = 0x0000FFFFu;
    const bool hit[13] = {(x[3] & hi) == 0, (x[3] & lo) == 0, (x[4] & hi) == 0, x[2] == 0,
                          (x[4] & lo) == 0, (x[5] & hi) == 0, (x[5] & lo) == 0,
                          (x[6] & hi) == 0, (x[6] & lo) == 0, (x[7] & hi) == 0,
                          (x[7] & lo) == 0, (x[8] & lo) == 0, (x[8] & hi) == 0};
    constexpr int kWeight[13] = {2, 2, 2, 2, 4, 4, 8, 16, 16, 32, 32, 64, 32};
    int g = 0;
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      if (!hit[i]) break;
      g += kWeight[i];
    }
    return g;
  }
}

__device__ __forceinline__ uint32_t mix(uint32_t a, uint32_t b) {
  return (a ^ ((b << kMixRot) | (b >> (32 - kMixRot)))) * kHashMul;
}

// h16(a) << 16 | h16(b): two 16-bit hashes in one field (lz77 _pack2).
__device__ __forceinline__ int pack2(uint32_t a, uint32_t b) {
  return static_cast<int>((((a * kHashMul) >> 16) << 16) | ((b * kHashMul) >> 16));
}

// Index of the first false compare at or after bitmap word k's start, or kNoFalse.
__device__ __forceinline__ int first_false(uint32_t bits, int k) {
  return bits == 0xFFFFFFFFu ? kNoFalse : 32 * k + __ffs(static_cast<int>(~bits)) - 1;
}

__global__ void __launch_bounds__(kFieldsThreads)
    fields_kernel(const uint8_t* __restrict__ data, int64_t* __restrict__ w_out,
                  int64_t* __restrict__ key_out, int32_t* __restrict__ rec_out,
                  int64_t* __restrict__ span_out, int32_t* __restrict__ runs_out, int B, int T,
                  int hist, int pos_bits, int full) {
  __shared__ uint8_t s_byte[kFieldBytes];  // byte (t0 - kBehind + i) mod T
  __shared__ uint32_t s_w[kWords];         // the pyramid, index j = position t0 + j
  __shared__ uint32_t s_f8[kFp8];
  __shared__ uint32_t s_f16[kFp16];
  __shared__ uint32_t s_f32[kFp32];
  __shared__ uint32_t s_f64[kFp64];
  __shared__ uint32_t s_bits[4][kRunWords];     // bit j of word k: compare at t0 + 32k + j
  __shared__ int s_next[4][kRunWords + 1];      // first false at or after word k's start
  __shared__ int4 s_stage[kFieldsThreads / 32][2 * 32];  // each warp's 32 full records
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFieldsTile;
  const uint8_t* row = data + static_cast<size_t>(b) * T;
  for (int i = threadIdx.x; i < kFieldBytes; i += blockDim.x) {
    const int q = (t0 - kBehind + i) % T;
    s_byte[i] = row[q < 0 ? q + T : q];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kWords; j += blockDim.x) {
    const uint8_t* c = s_byte + kBehind + j;
    s_w[j] = c[0] | (c[1] << 8) | (c[2] << 16) | (static_cast<uint32_t>(c[3]) << 24);
  }
  if (runs_out != nullptr) {
    const int lane = threadIdx.x & 31;
    for (int wd = threadIdx.x >> 5; wd < 4 * kRunWords; wd += kFieldsThreads / 32) {
      const int d = wd / kRunWords + 1, k = wd % kRunWords;
      const int j = 32 * k + lane;
      const bool eq = t0 + j < T && s_byte[kBehind + j] == s_byte[kBehind + j - d];
      const uint32_t bits = __ballot_sync(0xFFFFFFFFu, eq);
      if (lane == 0) s_bits[d - 1][k] = bits;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kFp8; j += blockDim.x)
    s_f8[j] = mix(s_w[j] * kPremixMul, s_w[j + 4] * kPremixMul);
  if (runs_out != nullptr && threadIdx.x < 128) {
    // the reverse scan: a suffix minimum of each word's first false
    // position, one warp a distance, words 2 lane and 2 lane + 1 a lane
    const int d = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int k0 = 2 * lane, k1 = k0 + 1;
    const int v0 = k0 < kRunWords ? first_false(s_bits[d][k0], k0) : kNoFalse;
    const int v1 = k1 < kRunWords ? first_false(s_bits[d][k1], k1) : kNoFalse;
    int m = min(v0, v1);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(0xFFFFFFFFu, m, off);
      if (lane + off < 32) m = min(m, o);
    }
    int after = __shfl_down_sync(0xFFFFFFFFu, m, 1);
    if (lane == 31) after = kNoFalse;
    const int n1 = min(v1, after);
    if (k1 < kRunWords) s_next[d][k1] = n1;
    if (k0 < kRunWords) s_next[d][k0] = min(v0, n1);
    if (lane == 0) s_next[d][kRunWords] = kNoFalse;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kFp16; j += blockDim.x) s_f16[j] = mix(s_f8[j], s_f8[j + 8]);
  __syncthreads();
  for (int j = threadIdx.x; j < kFp32; j += blockDim.x) s_f32[j] = mix(s_f16[j], s_f16[j + 16]);
  __syncthreads();
  for (int j = threadIdx.x; j < kFp64; j += blockDim.x) s_f64[j] = mix(s_f32[j], s_f32[j + 32]);
  __syncthreads();

  const size_t plane = static_cast<size_t>(B) * T;
  const int S = T - hist;
  const int lane = threadIdx.x & 31;
  int4* stage = s_stage[threadIdx.x >> 5];
  // a warp takes 32 consecutive positions at a time
  for (int base = threadIdx.x & ~31; base < kFieldsTile; base += kFieldsThreads) {
    if (t0 + base >= T) break;  // the same for the whole warp
    const int i = base + lane;
    const int p = t0 + i;
    const bool live = p < T;
    const size_t o = static_cast<size_t>(b) * T + p;
    const uint32_t w = s_w[i];
    const uint32_t f128 = mix(s_f64[i], s_f64[i + 64]);
    if (live) {
      const uint32_t m = w * kHashMul;
      w_out[o] = w;
      key_out[o] = (static_cast<int64_t>(m >> kKeyLow) << (pos_bits + kKeyLow)) |
                   (static_cast<int64_t>(p) << kKeyLow) | (m & kKeyLowMask);
    }
    if (full) {
      stage[2 * lane] = make_int4(static_cast<int>(s_w[i + 4]), static_cast<int>(s_f16[i]),
                                  pack2(s_w[i + 6], s_f8[i + 4]), pack2(s_w[i + 10], s_w[i + 16]));
      stage[2 * lane + 1] = make_int4(pack2(s_f16[i + 8], s_f32[i]), pack2(s_f16[i + 32], s_f64[i]),
                                      pack2(s_f32[i + 64], f128), pack2(s_f32[i + 192], s_f64[i + 128]));
      __syncwarp();
      // the warp's records are 64 contiguous vectors: 2 coalesced stores
      int4* dst = reinterpret_cast<int4*>(rec_out) + (static_cast<size_t>(b) * T + t0 + base) * 2;
      const int n = 2 * min(32, T - (t0 + base));
#pragma unroll
      for (int v = 0; v < 2; ++v)
        if (lane + 32 * v < n) dst[lane + 32 * v] = stage[lane + 32 * v];
      __syncwarp();
    } else if (live) {
      reinterpret_cast<int4*>(rec_out)[o] = make_int4(
          static_cast<int>(s_w[i + 4]), static_cast<int>(s_f16[i]), static_cast<int>(s_f64[i]), 0);
    }
    if (!live) continue;
    if (span_out != nullptr) {  // fingerprints 128, 64, 32, 16, 8
      span_out[o] = f128;
      span_out[plane + o] = s_f64[i];
      span_out[2 * plane + o] = s_f32[i];
      span_out[3 * plane + o] = s_f16[i];
      span_out[4 * plane + o] = s_f8[i];
    }
    if (runs_out != nullptr && p >= hist) {
      const int k = i >> 5;
      const size_t ro = static_cast<size_t>(b) * S + (p - hist);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const uint32_t from = ~s_bits[d][k] & (0xFFFFFFFFu << (i & 31));
        const int nf = from != 0 ? 32 * k + __ffs(static_cast<int>(from)) - 1 : s_next[d][k + 1];
        runs_out[static_cast<size_t>(d) * B * S + ro] = min(nf - i, kMaxMatch);
      }
    }
  }
}

// The packed winner word of a best (score, cand, p4) at position pos.
__device__ __forceinline__ int64_t pack_winner(int score, int cand, int p4, int pos) {
  const bool has = score > kNegInf;
  const int grade = has ? min(max((score + (pos - cand)) >> 17, 0), kMaxMatch) : 0;
  return (static_cast<int64_t>(max(cand, 0)) << 12) | (grade << 3) |
         ((p4 >= 4 ? 2 : 1) << 1) | (has ? 1 : 0);
}

template <int R, bool kTop2>
__global__ void __launch_bounds__(kTile)
    probe_kernel(const int64_t* __restrict__ skey, const int32_t* __restrict__ rec,
                 const int64_t* __restrict__ valid_lo, const int64_t* __restrict__ valid_hi,
                 int64_t* __restrict__ out, int64_t* __restrict__ out2, int T, int hist,
                 int pos_bits, int max_dist, int K) {
  constexpr int V = R == 4 ? 1 : 2;   // 16-byte vectors a record: fields 1..R-1
  constexpr int SV = R == 4 ? 1 : 3;  // ... staged (a pad keeps 16-byte reads conflict-free)
  extern __shared__ int4 s_mem[];
  const int span = kTile + K;  // staged ranks: the halo, then the tile
  int4* s_rec = s_mem;         // rank-major: staged rank i's record at [i SV, i SV + V)
  int64_t* s_key = reinterpret_cast<int64_t*>(s_rec + span * SV);
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int lo = max(r0 - K, 0);
  const int n = min(r0 + kTile, T) - lo;
  const int64_t* krow = skey + static_cast<size_t>(b) * T;
  const int4* rrow = reinterpret_cast<const int4*>(rec) + static_cast<size_t>(b) * T * V;
  const int64_t pos_mask = (int64_t{1} << pos_bits) - 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t key = krow[lo + i];
    s_key[i] = key;
    const int p = static_cast<int>((key >> kKeyLow) & pos_mask);
#pragma unroll
    for (int m = 0; m < V; ++m)
      __pipeline_memcpy_async(s_rec + i * SV + m, rrow + static_cast<size_t>(p) * V + m, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int li = r0 + static_cast<int>(threadIdx.x) - lo;  // this rank, staged
  if (li >= n) return;                                     // past the row's end
  const int64_t key = s_key[li];
  const int p = static_cast<int>((key >> kKeyLow) & pos_mask);
  if (p < hist) return;  // a history position: not in the output
  int best = kNegInf, best_cand = 0, best_p4 = 0;
  int second = kNegInf, cand2 = 0, p42 = 0;
  if (p < valid_hi[b]) {
    // A predecessor's key is at most this one's.  It has this hash iff it
    // is at least base (the key cut to its hash), and then its position
    // is (key - base) >> kKeyLow: one compare of keys stops the walk at
    // the first predecessor of another bucket, past max_dist or before
    // valid_lo.  A word is (hash | the key's low bits) * kHashMulInv.
    const int64_t base = key >> (pos_bits + kKeyLow) << (pos_bits + kKeyLow);
    const int64_t stop =
        base + (max(max(valid_lo[b], static_cast<int64_t>(p) - max_dist), int64_t{0})
                << kKeyLow);
    const uint32_t hash_bits = static_cast<uint32_t>(key >> (pos_bits + kKeyLow)) << kKeyLow;
    uint32_t f[4 * V + 1];
    f[0] = (hash_bits | (static_cast<uint32_t>(key) & kKeyLowMask)) * kHashMulInv;
#pragma unroll
    for (int m = 0; m < V; ++m) {
      const int4 v = s_rec[li * SV + m];
      f[4 * m + 1] = v.x, f[4 * m + 2] = v.y, f[4 * m + 3] = v.z, f[4 * m + 4] = v.w;
    }
    // li < K only at the row's start, where ranks before 0 are padding
    const int kmax = min(K, li);
    for (int k = 1; k <= kmax; ++k) {
      const int lj = li - k;
      const int64_t kj = s_key[lj];
      if (kj < stop) break;
      const int cp = static_cast<int>((kj - base) >> kKeyLow);  // < p: same bucket
      uint32_t x[R];
      x[0] = f[0] ^ ((hash_bits | (static_cast<uint32_t>(kj) & kKeyLowMask)) * kHashMulInv);
      const int plen4 = prefix_bytes_equal(x[0]);
      if (plen4 < kMinMatch) continue;  // not usable: the sentinel score
      int grade = plen4;
      if (x[0] == 0) {
        const int4 c = s_rec[lj * SV];  // fields 1-4; the rest only past 8 equal bytes
        x[1] = f[1] ^ static_cast<uint32_t>(c.x);
        grade += prefix_bytes_equal(x[1]);
        if (x[1] == 0) {
          x[2] = f[2] ^ static_cast<uint32_t>(c.y);
          x[3] = f[3] ^ static_cast<uint32_t>(c.z);
          if constexpr (V == 2) {
            const int4 c1 = s_rec[lj * SV + 1];
            x[4] = f[4] ^ static_cast<uint32_t>(c.w);
            x[5] = f[5] ^ static_cast<uint32_t>(c1.x);
            x[6] = f[6] ^ static_cast<uint32_t>(c1.y);
            x[7] = f[7] ^ static_cast<uint32_t>(c1.z);
            x[8] = f[8] ^ static_cast<uint32_t>(c1.w);
          }
          grade += rung_grade<R>(x);
        }
      }
      const int score = (grade << 17) - (p - cp);
      if (score > best) {
        if (kTop2) {
          second = best;
          cand2 = best_cand;
          p42 = best_p4;
        }
        best = score;
        best_cand = cp;
        best_p4 = plen4;
      } else if (kTop2 && score > second) {
        second = score;
        cand2 = cp;
        p42 = plen4;
      }
    }
  }
  const size_t o = static_cast<size_t>(b) * (T - hist) + (p - hist);
  out[o] = pack_winner(best, best_cand, best_p4, p);
  if (kTop2) out2[o] = pack_winner(second, cand2, p42, p);
}

struct Winner {
  bool has;
  int tier, floor, cand, dist;  // cand is 0 where !has; dist = pos - (packed >> 12)
};

__device__ __forceinline__ Winner unpack(int64_t packed, int pos) {
  Winner v;
  v.has = (packed & 1) != 0;
  v.tier = static_cast<int>((packed >> 1) & 3);
  v.floor = static_cast<int>((packed >> 3) & 0x1FF);
  const int cand = static_cast<int>(packed >> 12);
  v.cand = v.has ? cand : 0;
  v.dist = pos - cand;
  return v;
}

__device__ __forceinline__ uint32_t word(const int64_t* __restrict__ row, int q) {
  return static_cast<uint32_t>(row[q]);
}

// floor + the common prefix of the 16 words at the floor past the
// candidate and past the position, word j at (start + 4j) mod T.
__device__ int rec_descent(const int64_t* __restrict__ wr, const Winner& v, int pos, int T) {
  if (!v.has) return 0;
  const int cs = min(v.cand + v.floor, T - 1);
  const int ps = min(pos + v.floor, T - 1);
  int lcp = 0;
  for (int j = 0; j < kRecWords; ++j) {
    const uint32_t x = word(wr, (cs + 4 * j) % T) ^ word(wr, (ps + 4 * j) % T);
    lcp += prefix_bytes_equal(x);
    if (x != 0) break;
  }
  return v.floor + lcp;
}

struct Spans {
  const int64_t* fp[kSpans];  // spans 128, 64, 32, 16, 8
};

// The span walk from the floor over spans 128 .. 4 (4: the word itself),
// then the exact 0..3-byte refine and the tier-1 fix-up; indices clamp.
__device__ int span_walk(const int64_t* __restrict__ wr, const Spans& spans, size_t row,
                         const Winner& v, int pos, int T) {
  if (!v.has) return 0;
  int len = v.floor;
#pragma unroll
  for (int s = 0; s <= kSpans; ++s) {
    const int span = 128 >> s;
    const int64_t* f = s < kSpans ? spans.fp[s] + row : wr;
    if (len + span <= kMaxMatch + 4 && f[min(v.cand + len, T - 1)] == f[min(pos + len, T - 1)])
      len += span;
  }
  const int rem = prefix_bytes_equal(word(wr, min(v.cand + len, T - 1)) ^
                                     word(wr, min(pos + len, T - 1)));
  len += min(rem, 3);
  return v.tier == 1 && len < kMinMatch ? kMinMatch : len;
}

// The exact linear extension in 4-byte steps up to MAX_MATCH + 4; indices clamp.
__device__ int exact_extension(const int64_t* __restrict__ wr, const Winner& v, int pos, int T) {
  if (!v.has) return 0;
  int len = 0;
  for (int off = 0; off < kMaxMatch + 4; off += 4) {
    const int e = prefix_bytes_equal(word(wr, min(v.cand + off, T - 1)) ^
                                     word(wr, min(pos + off, T - 1)));
    len += e;
    if (e != 4) break;
  }
  return len;
}

template <int kMode>  // 0 exact, 1 rec, 2 span (probe_cu.MODES)
__global__ void __launch_bounds__(kThreads)
    extend_kernel(const int64_t* __restrict__ w, const int64_t* __restrict__ packed,
                  const int64_t* __restrict__ packed2, Spans spans,
                  const int32_t* __restrict__ runs, const int64_t* __restrict__ cand3,
                  const int64_t* __restrict__ valid_lo, const int64_t* __restrict__ valid_hi,
                  int32_t* __restrict__ out_len, int32_t* __restrict__ out_dist, int B, int T,
                  int hist) {
  const int S = T - hist;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const int b = blockIdx.y;
  const int pos = hist + i;
  const size_t row = static_cast<size_t>(b) * T;
  const size_t o = static_cast<size_t>(b) * S + i;
  const int64_t* wr = w + row;
  const Winner v = unpack(packed[o], pos);
  int length;
  int dist = v.dist;
  if (kMode == 0) {
    length = exact_extension(wr, v, pos, T);
  } else if (kMode == 1) {
    length = rec_descent(wr, v, pos, T);
    if (packed2 != nullptr) {
      const Winner v2 = unpack(packed2[o], pos);
      const int length2 = rec_descent(wr, v2, pos, T);
      if (length2 > length || (length2 == length && v2.dist < dist)) {
        length = length2;
        dist = v2.dist;
      }
    }
  } else {
    length = span_walk(wr, spans, row, v, pos, T);
  }
  const int64_t vlo = valid_lo[b], vhi = valid_hi[b];
  if (runs != nullptr) {
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      const bool src_ok = pos - d >= vlo && pos < vhi;
      const int len_d = src_ok ? min(runs[(static_cast<size_t>(d - 1) * B + b) * S + i],
                                     kMaxMatch) : 0;
      if (len_d > length || (len_d == length && d < dist)) {
        dist = d;
        length = len_d;
      }
    }
  }
  if (cand3 != nullptr) {
    const int64_t c3 = cand3[o];
    if (length < kMinMatch && c3 >= 0) {
      length = kMinMatch;
      dist = pos - static_cast<int>(c3);
    }
  }
  length = min(length, kMaxMatch);
  const int64_t room = vhi - pos;  // valid bytes from pos on
  if (room < length) length = room > 0 ? static_cast<int>(room) : 0;
  if (length == kMinMatch && dist > kTooFar) length = 0;
  out_len[o] = length >= kMinMatch ? length : 0;
  out_dist[o] = dist;
}

template <int R>
cudaError_t launch_probe(dim3 grid, size_t smem, cudaStream_t s, const int64_t* skey,
                         const int32_t* rec, const int64_t* valid_lo, const int64_t* valid_hi,
                         int64_t* out, int64_t* out2, int T, int hist, int pos_bits,
                         int max_dist, int K) {
  if (out2 != nullptr)
    probe_kernel<R, true><<<grid, kTile, smem, s>>>(skey, rec, valid_lo, valid_hi, out, out2, T,
                                                    hist, pos_bits, max_dist, K);
  else
    probe_kernel<R, false><<<grid, kTile, smem, s>>>(skey, rec, valid_lo, valid_hi, out, out2,
                                                     T, hist, pos_bits, max_dist, K);
  return cudaGetLastError();
}

}  // namespace

// data: uint8[B, T]; w, key: int64[B, T] (the words, the unsorted keys
// carrying them); rec: int32[B, T, 8] on the full ladder (full != 0),
// int32[B, T, 4] on the short one (word 3 zero); spans:
// int64[5, B, T] fingerprints 128, 64, 32, 16, 8, or null; runs:
// int32[4, B, T - hist] run lengths capped at MAX_MATCH, or null.
// 0 <= hist < T.
extern "C" int dtt_fields(const uint8_t* data, int64_t* w, int64_t* key, int32_t* rec,
                          int64_t* spans, int32_t* runs, int B, int T, int hist, int pos_bits,
                          int full, void* stream) {
  const dim3 grid((T + kFieldsTile - 1) / kFieldsTile, B);
  fields_kernel<<<grid, kFieldsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, w, key, rec, spans, runs, B, T, hist, pos_bits, full);
  return static_cast<int>(cudaGetLastError());
}

// skey: int64[B, T] the sorted keys of dtt_fields; rec: its records by
// position (R = 4: int32[B, T, 4]; R = 9: int32[B, T, 8]), 16-byte
// aligned; valid_lo, valid_hi: int64[B]; out (and out2 at top2, else
// null): int64[B, T - hist].  0 < K, 0 <= hist < T, pos_bits + kKeyLow +
// kHashBits <= 63; shared memory (kTile + K) * (16 SV + 8) bytes, SV = 1
// or 3 (at most 48 KB: K <= 621 at R = 9).
extern "C" int dtt_probe(const int64_t* skey, const int32_t* rec, const int64_t* valid_lo,
                         const int64_t* valid_hi, int64_t* out, int64_t* out2, int B, int T,
                         int hist, int pos_bits, int max_dist, int K, int R, void* stream) {
  const dim3 grid((T + kTile - 1) / kTile, B);
  const int staged = R == 4 ? 16 : 48;  // a record's bytes in shared memory
  const size_t smem = static_cast<size_t>(staged + 8) * (kTile + K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 4)
    return static_cast<int>(launch_probe<4>(grid, smem, s, skey, rec, valid_lo, valid_hi, out,
                                            out2, T, hist, pos_bits, max_dist, K));
  if (R == 9)
    return static_cast<int>(launch_probe<9>(grid, smem, s, skey, rec, valid_lo, valid_hi, out,
                                            out2, T, hist, pos_bits, max_dist, K));
  return static_cast<int>(cudaErrorInvalidValue);
}

// w: int64[B, T] words; packed (packed2 at top2 on "rec", else null):
// int64[B, T - hist]; fp128..fp8: int64[B, T] fingerprints on "span", else
// null; runs: int32[4, B, T - hist] or null; cand3: int64[B, T - hist] or null;
// valid_lo, valid_hi: int64[B]; length, dist: int32[B, T - hist]; mode 0
// exact, 1 rec, 2 span.
extern "C" int dtt_extend(const int64_t* w, const int64_t* packed, const int64_t* packed2,
                          const int64_t* fp128, const int64_t* fp64, const int64_t* fp32,
                          const int64_t* fp16, const int64_t* fp8, const int32_t* runs,
                          const int64_t* cand3, const int64_t* valid_lo,
                          const int64_t* valid_hi, int32_t* length, int32_t* dist, int B, int T,
                          int hist, int mode, void* stream) {
  const dim3 grid((T - hist + kThreads - 1) / kThreads, B);
  const Spans spans{{fp128, fp64, fp32, fp16, fp8}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    extend_kernel<0><<<grid, kThreads, 0, s>>>(w, packed, packed2, spans, runs, cand3, valid_lo,
                                               valid_hi, length, dist, B, T, hist);
  else if (mode == 1)
    extend_kernel<1><<<grid, kThreads, 0, s>>>(w, packed, packed2, spans, runs, cand3, valid_lo,
                                               valid_hi, length, dist, B, T, hist);
  else if (mode == 2)
    extend_kernel<2><<<grid, kThreads, 0, s>>>(w, packed, packed2, spans, runs, cand3, valid_lo,
                                               valid_hi, length, dist, B, T, hist);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
