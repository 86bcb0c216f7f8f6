// Round A's candidate search: the rank-space probe of the sorted hash
// buckets, then the winner's exact extension with the runs, hash3 and
// clamp merges.
//
// Replaces XLA code of decompress_tpu/ops/lz77.py: _match_candidates (no
// Pallas kernel): probe_step (lz77.py:354, a lax.scan over the K previous
// sorted ranks at :457 and :464) with the packed-winner scatter, and the
// winner's descend (lz77.py:570) or exact linear extension, then the
// merges.  As eager torch the scan was ~150 launches per k over int64
// [B, T] arrays, and the rest ~160 launches a batch.
//
// probe: one block per (row, tile of kTile ranks).  The block stages the
// positions, hashes and R-word probe records of its tile and of the K
// ranks before it (none before the row's start) in shared memory, the
// records gathered by position with cp.async and stored field-major, so
// that a warp's 32 consecutive ranks read 32 consecutive words.  Each
// thread then walks its rank's predecessors in shared memory: a record is
// read from device memory once a block instead of K times.  A candidate
// can win only if it has the rank's hash, lies within max_dist and at or
// after valid_lo; in the sorted order each of these fails for good at the
// first predecessor that breaks it, so the walk stops there.  A candidate
// that cannot win changes nothing: its score is the -2^30 sentinel and
// both the best and the runner-up move only on a strictly greater score
// (the first maximum in k order wins, the reference's argmax parity).
// History positions (pos < hist) write nothing; the packed winner goes
// straight to its position, out[b, pos - hist].
//
// extend: one thread per payload position.  It unpacks the winner and
// resolves its length by mode: "rec" (levels 5-12) the floor plus the
// common prefix of the 16 words at the floor, the runner-up too at top2
// (the longer, or tied, nearer kept); "span" (levels 1-4) spans 128 to 4
// of the fingerprints, then the exact 0..3-byte refine and the tier-1
// fix-up; "exact" (force_exact) 4-byte steps to MAX_MATCH + 4.  Then the
// runs merge over d = 1..4, hash3 where the length is under MIN_MATCH,
// and the clamps to MAX_MATCH, the row's valid end, TOO_FAR at length 3
// and MIN_MATCH.  The run lengths (a suffix scan) and the hash3 candidates
// (a sort) come in from torch.
//
// Index rules, each where the plain code has it, since they decide bytes:
//  - the words w and the fingerprints were built with torch.roll, so they
//    wrap at the row end (word T - 1 holds bytes T - 1, 0, 1, 2); they
//    are inputs and are read as given;
//  - the rec descent reads word (start + 4j) mod T, start clamped to T - 1;
//  - the span walk, the refine and the exact extension clamp their index
//    to T - 1.
// Scores fit int32 (grade <= 224 and 224 << 17 < 2^30); the packed word
// cand << 12 | floor << 3 | tier << 1 | has is int64 (cand << 12 passes
// 2^31 on rows of 2^19 bytes and more).
//
// Bound on the H100: device memory.  probe reads each sorted key (8 B)
// and record (4R B) once (plus the K-rank halo of each tile, 6% at K = 16)
// and writes 8 B a payload position (16 at top2), scattered by position;
// the shared-memory walk is K x (R + 2) words a rank at most.  extend
// reads the packed word(s), the 4 run lengths and the hash3 candidate
// once and writes 8 B a position; its gathers of w around the winner and
// the position (and of the fingerprints on the span walk) hit L2, where
// the batch's 10 MB of words stay.

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
  extern __shared__ int32_t s_mem[];
  const int span = kTile + K;  // staged ranks: the halo, then the tile
  int32_t* s_pos = s_mem;
  int32_t* s_hash = s_pos + span;
  int32_t* s_rec = s_hash + span;  // field-major: field j of staged rank i at j * span + i
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int lo = max(r0 - K, 0);
  const int n = min(r0 + kTile, T) - lo;
  const int64_t* krow = skey + static_cast<size_t>(b) * T;
  const int32_t* rrow = rec + static_cast<size_t>(b) * T * R;
  const int64_t pos_mask = (int64_t{1} << pos_bits) - 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t key = krow[lo + i];
    const int p = static_cast<int>(key & pos_mask);
    s_pos[i] = p;
    s_hash[i] = static_cast<int>(key >> pos_bits);
    const int32_t* src = rrow + static_cast<size_t>(p) * R;
#pragma unroll
    for (int j = 0; j < R; ++j) __pipeline_memcpy_async(s_rec + j * span + i, src + j, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int li = r0 + static_cast<int>(threadIdx.x) - lo;  // this rank, staged
  if (li >= n) return;                                     // past the row's end
  const int p = s_pos[li];
  if (p < hist) return;  // a history position: not in the output
  int best = kNegInf, best_cand = 0, best_p4 = 0;
  int second = kNegInf, cand2 = 0, p42 = 0;
  if (p < valid_hi[b]) {
    const int h = s_hash[li];
    const int64_t vlo = valid_lo[b];
    uint32_t f[R];
#pragma unroll
    for (int j = 0; j < R; ++j) f[j] = static_cast<uint32_t>(s_rec[j * span + li]);
    // li < K only at the row's start, where ranks before 0 are padding
    const int kmax = min(K, li);
    for (int k = 1; k <= kmax; ++k) {
      const int lj = li - k;
      const int cp = s_pos[lj];  // < p: same bucket, earlier rank
      if (s_hash[lj] != h || p - cp > max_dist || cp < vlo) break;
      uint32_t x[R];
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = f[j] ^ static_cast<uint32_t>(s_rec[j * span + lj]);
      const int plen4 = prefix_bytes_equal(x[0]);
      if (plen4 < kMinMatch) continue;  // not usable: the sentinel score
      int grade = plen4;
      if (x[0] == 0) {
        grade += prefix_bytes_equal(x[1]);
        if (x[1] == 0) grade += rung_grade<R>(x);
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

// skey: int64[B, T] sorted keys hash << pos_bits | pos; rec: int32[B, T, R]
// probe fields by position (R = 4 short ladder, 9 full); valid_lo,
// valid_hi: int64[B]; out (and out2 at top2, else null): int64[B, T - hist].
// 0 < K, 0 <= hist < T; shared memory (R + 2) * (kTile + K) * 4 bytes
// (at most 48 KB: K <= 861 at R = 9).
extern "C" int dtt_probe(const int64_t* skey, const int32_t* rec, const int64_t* valid_lo,
                         const int64_t* valid_hi, int64_t* out, int64_t* out2, int B, int T,
                         int hist, int pos_bits, int max_dist, int K, int R, void* stream) {
  const dim3 grid((T + kTile - 1) / kTile, B);
  const size_t smem = static_cast<size_t>(R + 2) * (kTile + K) * sizeof(int32_t);
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
