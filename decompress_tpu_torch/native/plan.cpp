// plan: host block planning of one batch of DEFLATE blocks in one call,
// and round B's bit-cost tables of one batch in another.
//
// The native form of ``de.plan_blocks`` (its model: the reference's
// Python planner): for each row of a batch it builds the length-limited
// Huffman trees of the row's histograms, serializes the dynamic header,
// prices the stored, fixed and dynamic encodings exactly, chooses one and
// writes the header pairs and the bit-reversed canonical code tables the
// device packer reads.  Every step follows the Python
// planner's order of operations, so the output is byte for byte the
// same:
//   * tree build: a heap keyed (freq, symbol) for leaves and
//     (freq, n + id) for internal nodes, so a leaf wins a tie and, among
//     internal nodes, the earlier one;
//   * depths walked from the last internal node down, clamped at the
//     length limit, every clamped node counted as overflow;
//   * overflow redistributed on the per-length counts as zlib's
//     gen_bitlen does, then lengths reassigned in (freq, symbol) order;
//   * the code-length RLE of RFC 1951 3.2.7 and the precode built with a
//     limit of 7 bits.
//
// The same ``code_lengths`` gives ``lz77._cost_tables_host`` its tables
// (the reference's Python tables are its model): the two code
// lengths of each row, 13 bits for every symbol the row never used.
//
// Build: g++ -O3 -shared -fPIC plan.cpp -o libplan.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr int kMaxBits = 15;
constexpr int kMaxPrecodeBits = 7;
constexpr int kLitSyms = 286;
constexpr int kDistSyms = 30;
constexpr int kFixedLitSyms = 288;
constexpr int kPrecodeSyms = 19;
constexpr int kEob = 256;
constexpr int kHdrPad = 1024;
// the longest header: 14 bits of counts, 19 precode lengths, and one
// symbol and one extra field for each of the 286 + 30 code lengths
constexpr int kMaxHeader = 3 + kPrecodeSyms + 2 * (kLitSyms + kDistSyms);

enum Kind : int8_t { kStored = 0, kFixed = 1, kDynamic = 2 };
enum Force : int32_t { kForceNone = 0, kForceFixed = 1, kForceDynamic = 2 };
enum Shared : int32_t { kSharedNone = 0, kSharedSum = 1, kSharedGiven = 2 };

const int kPrecodeOrder[kPrecodeSyms] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                         11, 4,  12, 3, 13, 2, 14, 1, 15};
// extra bits of length codes 257..285 and distance codes 0..29 (RFC 1951 3.2.5)
const int kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                              2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kDistExtra[kDistSyms] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                   6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

struct HeapItem {
  int64_t freq;
  int64_t tie;
  int id;
  bool operator>(const HeapItem& o) const {
    return freq != o.freq ? freq > o.freq : tie > o.tie;
  }
};

// Depth-limited Huffman code lengths of ``freqs[0..n)`` into
// ``lengths``; returns the number of nodes pushed past ``max_length``.
int code_lengths(const int64_t* freqs, int n, int max_length, int32_t* lengths) {
  std::fill(lengths, lengths + n, 0);
  std::vector<int> used;
  used.reserve(n);
  for (int s = 0; s < n; s++)
    if (freqs[s] > 0) used.push_back(s);
  const int nu = static_cast<int>(used.size());
  if (nu == 0) {  // still two 1-bit codes, so the tree is complete
    lengths[0] = 1;
    lengths[std::min(1, n - 1)] = 1;
    return 0;
  }
  if (nu == 1) {
    lengths[used[0]] = 1;
    lengths[used[0] != 0 ? 0 : 1] = 1;
    return 0;
  }
  std::vector<HeapItem> items;
  items.reserve(2 * nu);
  std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<HeapItem>> heap(
      std::greater<HeapItem>(), std::move(items));
  for (int rank = 0; rank < nu; rank++) heap.push({freqs[used[rank]], used[rank], rank});
  std::vector<int> parent(2 * nu, -1);
  int next_id = nu;
  while (heap.size() > 1) {
    HeapItem a = heap.top();
    heap.pop();
    HeapItem b = heap.top();
    heap.pop();
    parent[a.id] = next_id;
    parent[b.id] = next_id;
    heap.push({a.freq + b.freq, static_cast<int64_t>(n) + next_id, next_id});
    next_id++;
  }
  std::vector<int32_t> depth(next_id, 0);
  int overflow = 0;
  for (int node = next_id - 2; node >= 0; node--) {
    if (parent[node] >= 0) {
      int d = depth[parent[node]] + 1;
      if (d > max_length) {
        d = max_length;
        overflow++;
      }
      depth[node] = d;
    }
  }
  for (int rank = 0; rank < nu; rank++) lengths[used[rank]] = depth[rank];
  if (overflow > 0) {
    int64_t bl_count[kMaxBits + 2] = {0};
    for (int s = 0; s < n; s++)
      if (lengths[s] > 0) bl_count[lengths[s]]++;
    // split a code of the deepest non-full level, retiring one
    // max-length code, until the Kraft sum is whole again
    for (int left = overflow; left > 0; left -= 2) {
      int bits = max_length - 1;
      while (bits > 0 && bl_count[bits] == 0) bits--;
      bl_count[bits]--;
      bl_count[bits + 1] += 2;
      bl_count[max_length]--;
    }
    // the longest lengths go to the least frequent symbols
    std::sort(used.begin(), used.end(), [freqs](int x, int y) {
      return freqs[x] != freqs[y] ? freqs[x] < freqs[y] : x < y;
    });
    std::fill(lengths, lengths + n, 0);
    int li = max_length;
    for (int s : used) {
      while (li > 0 && bl_count[li] == 0) li--;
      lengths[s] = li;
      bl_count[li]--;
    }
  }
  return overflow;
}

// LSB-first canonical codes of ``lengths[0..n)`` (0 for unused symbols).
void canonical_codes(const int32_t* lengths, int n, uint32_t* codes) {
  int64_t bl_count[kMaxBits + 1] = {0};
  for (int s = 0; s < n; s++)
    if (lengths[s] > 0 && lengths[s] <= kMaxBits) bl_count[lengths[s]]++;
  int64_t next_code[kMaxBits + 1] = {0};
  int64_t code = 0;
  for (int bits = 1; bits <= kMaxBits; bits++) {
    code = (code + bl_count[bits - 1]) << 1;
    next_code[bits] = code;
  }
  for (int s = 0; s < n; s++) {
    const int len = lengths[s];
    if (len <= 0) {
      codes[s] = 0;
      continue;
    }
    uint32_t v = static_cast<uint32_t>(next_code[len]++), r = 0;
    for (int k = 0; k < kMaxBits; k++) {
      r = (r << 1) | (v & 1);
      v >>= 1;
    }
    codes[s] = r >> (kMaxBits - len);
  }
}

struct Header {
  uint32_t values[kMaxHeader];
  int32_t nbits[kMaxHeader];
  int count = 0;
  int64_t bit_length = 0;

  void put(uint32_t v, int32_t nb) {
    values[count] = v;
    nbits[count] = nb;
    count++;
    bit_length += nb;
  }
};

// HLIT/HDIST/HCLEN, the precode lengths and the RLE'd code lengths.
void build_header(const int32_t* lit, const int32_t* dist, Header* h) {
  int hlit = 257;
  for (int s = kLitSyms - 1; s >= 0; s--)
    if (lit[s] != 0) {
      hlit = std::max(257, s + 1);
      break;
    }
  int hdist = 1;
  for (int s = kDistSyms - 1; s >= 0; s--)
    if (dist[s] != 0) {
      hdist = s + 1;
      break;
    }
  int32_t seq[kLitSyms + kDistSyms];
  std::copy(lit, lit + hlit, seq);
  std::copy(dist, dist + hdist, seq + hlit);
  const int n = hlit + hdist;

  int32_t rle_sym[kLitSyms + kDistSyms], rle_val[kLitSyms + kDistSyms],
      rle_bits[kLitSyms + kDistSyms];
  int nr = 0;
  auto emit = [&](int sym, int val, int bits) {
    rle_sym[nr] = sym;
    rle_val[nr] = val;
    rle_bits[nr] = bits;
    nr++;
  };
  for (int i = 0; i < n;) {
    const int v = seq[i];
    int j = i + 1;
    while (j < n && seq[j] == v) j++;
    int run = j - i;
    if (v == 0) {
      while (run >= 11) {
        const int r = std::min(run, 138);
        emit(18, r - 11, 7);
        run -= r;
      }
      if (run >= 3) {
        emit(17, run - 3, 3);
        run = 0;
      }
      for (; run > 0; run--) emit(0, 0, 0);
    } else {
      emit(v, 0, 0);
      run--;
      while (run >= 3) {
        const int r = std::min(run, 6);
        emit(16, r - 3, 2);
        run -= r;
      }
      for (; run > 0; run--) emit(v, 0, 0);
    }
    i = j;
  }

  int64_t pre_freq[kPrecodeSyms] = {0};
  for (int k = 0; k < nr; k++) pre_freq[rle_sym[k]]++;
  int32_t pre_len[kPrecodeSyms];
  uint32_t pre_code[kPrecodeSyms];
  code_lengths(pre_freq, kPrecodeSyms, kMaxPrecodeBits, pre_len);
  canonical_codes(pre_len, kPrecodeSyms, pre_code);
  int hclen = kPrecodeSyms;
  while (hclen > 4 && pre_len[kPrecodeOrder[hclen - 1]] == 0) hclen--;

  h->count = 0;
  h->bit_length = 0;
  h->put(hlit - 257, 5);
  h->put(hdist - 1, 5);
  h->put(hclen - 4, 4);
  for (int k = 0; k < hclen; k++) h->put(pre_len[kPrecodeOrder[k]], 3);
  for (int k = 0; k < nr; k++) {
    h->put(pre_code[rle_sym[k]], pre_len[rle_sym[k]]);
    if (rle_bits[k]) h->put(rle_val[k], rle_bits[k]);
  }
}

// bits of the symbol section, extra bits included, header excluded
int64_t symbol_cost(const int64_t* hl, const int64_t* hd, const int32_t* lit_bits,
                    const int32_t* dist_bits) {
  int64_t cost = 0;
  for (int s = 0; s < kLitSyms; s++)
    cost += hl[s] * (lit_bits[s] + (s > kEob ? kLengthExtra[s - kEob - 1] : 0));
  for (int s = 0; s < kDistSyms; s++) cost += hd[s] * (dist_bits[s] + kDistExtra[s]);
  return cost;
}

// a stored block of n bytes starting on a byte boundary: 3 header bits,
// 5 of padding and LEN/NLEN for each chunk of up to 65535 bytes
int64_t stored_cost(int64_t n) {
  const int64_t nchunks = std::max<int64_t>(1, (n + 65534) / 65535);
  return 40 + (nchunks - 1) * 40 + 8 * n;
}

struct Tree {
  int32_t lit[kLitSyms];
  int32_t dist[kDistSyms];
  Header header;
  bool overflow = false;

  void build(const int64_t* hl, const int64_t* hd) {
    const int o1 = code_lengths(hl, kLitSyms, kMaxBits, lit);
    const int o2 = code_lengths(hd, kDistSyms, kMaxBits, dist);
    overflow = o1 > 0 || o2 > 0;
    build_header(lit, dist, &header);
  }
};

}  // namespace

extern "C" {

// Plans rows [0, b) of a batch.  Inputs: hist_lit int64[b, 286] (EOB not
// counted), hist_dist int64[b, 30], n_valid int64[b], final_flags
// uint8[b]; force 0 (cheapest), 1 (fixed or stored), 2 (dynamic or
// stored); shared 0 (a tree per row), 1 (one tree of the rows' summed
// counts), 2 (the tree given in s_lit, s_dist and s_hdr_*).  Outputs, one
// row each of [b_pad, ...] arrays the caller has zeroed: hdr_vals and
// hdr_bits [1024], lit_codes and lit_bits [286], dist_codes and dist_bits
// [30], eob_vals and eob_bits [1]; kinds int8[b] (0 stored, 1 fixed,
// 2 dynamic); *overflow_rows the rows whose literal or distance tree was
// redistributed to fit 15 bits.  Returns 0, or -1 where a given header
// does not fit its row.
int tpuz_plan_blocks(int64_t b, const int64_t* hist_lit, const int64_t* hist_dist,
                     const int64_t* n_valid, const uint8_t* final_flags, int32_t force,
                     int32_t shared, const int32_t* s_lit, const int32_t* s_dist,
                     const uint32_t* s_hdr_vals, const int32_t* s_hdr_bits, int64_t s_hdr_n,
                     int64_t s_hdr_bit_length, uint32_t* hdr_vals, int32_t* hdr_bits,
                     uint32_t* lit_codes, int32_t* lit_bits, uint32_t* dist_codes,
                     int32_t* dist_bits, uint32_t* eob_vals, int32_t* eob_bits, int8_t* kinds,
                     int64_t* overflow_rows) {
  int32_t fixed_lit[kFixedLitSyms];
  uint32_t fixed_lit_codes[kFixedLitSyms];
  for (int s = 0; s < kFixedLitSyms; s++)
    fixed_lit[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
  canonical_codes(fixed_lit, kFixedLitSyms, fixed_lit_codes);
  int32_t fixed_dist[kDistSyms];
  uint32_t fixed_dist_codes[kDistSyms];
  std::fill(fixed_dist, fixed_dist + kDistSyms, 5);
  canonical_codes(fixed_dist, kDistSyms, fixed_dist_codes);

  Tree tree;
  bool shared_tree = shared != kSharedNone;
  const int32_t* dyn_lit = tree.lit;
  const int32_t* dyn_dist = tree.dist;
  const uint32_t* hdr_v = tree.header.values;
  const int32_t* hdr_b = tree.header.nbits;
  int64_t hdr_n = 0, hdr_len = 0;
  bool shared_overflow = false;
  if (shared == kSharedSum) {
    std::vector<int64_t> hl_sum(kLitSyms, 0), hd_sum(kDistSyms, 0);
    for (int64_t i = 0; i < b; i++) {
      for (int s = 0; s < kLitSyms; s++) hl_sum[s] += hist_lit[i * kLitSyms + s];
      for (int s = 0; s < kDistSyms; s++) hd_sum[s] += hist_dist[i * kDistSyms + s];
    }
    hl_sum[kEob] += b;  // one EOB per block
    tree.build(hl_sum.data(), hd_sum.data());
    shared_overflow = tree.overflow;
    hdr_n = tree.header.count;
    hdr_len = tree.header.bit_length;
  } else if (shared == kSharedGiven) {
    dyn_lit = s_lit;
    dyn_dist = s_dist;
    hdr_v = s_hdr_vals;
    hdr_b = s_hdr_bits;
    hdr_n = s_hdr_n;
    hdr_len = s_hdr_bit_length;
  }
  if (hdr_n + 2 > kHdrPad) return -1;

  int64_t overflowed = 0;
  uint32_t lc[kLitSyms], dc[kDistSyms];
  for (int64_t i = 0; i < b; i++) {
    int64_t hl[kLitSyms], hd[kDistSyms];
    std::copy(hist_lit + i * kLitSyms, hist_lit + (i + 1) * kLitSyms, hl);
    std::copy(hist_dist + i * kDistSyms, hist_dist + (i + 1) * kDistSyms, hd);
    hl[kEob] += 1;
    if (!shared_tree) {
      tree.build(hl, hd);
      hdr_n = tree.header.count;
      hdr_len = tree.header.bit_length;
    }
    overflowed += shared_tree ? shared_overflow : tree.overflow;
    const int64_t cost_dyn = 3 + hdr_len + symbol_cost(hl, hd, dyn_lit, dyn_dist);
    const int64_t cost_fix = 3 + symbol_cost(hl, hd, fixed_lit, fixed_dist);
    const int64_t cost_sto = stored_cost(n_valid[i]);
    // forbidding dynamic trees does not forbid stored blocks (zlib's
    // Z_FIXED), or incompressible data would expand
    const int64_t cost_packed = force == kForceFixed ? cost_fix : std::min(cost_dyn, cost_fix);
    if (cost_sto < cost_packed) {
      kinds[i] = kStored;
      continue;
    }
    const bool fixed = force == kForceFixed || (force == kForceNone && cost_fix <= cost_dyn);
    kinds[i] = fixed ? kFixed : kDynamic;
    const int32_t* ll = fixed ? fixed_lit : dyn_lit;
    const int32_t* dl = fixed ? fixed_dist : dyn_dist;
    const uint32_t* lcodes = fixed_lit_codes;
    const uint32_t* dcodes = fixed_dist_codes;
    if (!fixed) {
      canonical_codes(ll, kLitSyms, lc);
      canonical_codes(dl, kDistSyms, dc);
      lcodes = lc;
      dcodes = dc;
    }
    uint32_t* lco = lit_codes + i * kLitSyms;
    int32_t* lbo = lit_bits + i * kLitSyms;
    std::copy(lcodes, lcodes + kLitSyms, lco);
    std::copy(ll, ll + kLitSyms, lbo);
    std::copy(dcodes, dcodes + kDistSyms, dist_codes + i * kDistSyms);
    std::copy(dl, dl + kDistSyms, dist_bits + i * kDistSyms);
    eob_vals[i] = lcodes[kEob];
    eob_bits[i] = ll[kEob];
    uint32_t* hv = hdr_vals + i * kHdrPad;
    int32_t* hb = hdr_bits + i * kHdrPad;
    hv[0] = final_flags[i] ? 1 : 0;
    hb[0] = 1;
    hv[1] = fixed ? 1 : 2;
    hb[1] = 2;
    if (!fixed) {
      std::copy(hdr_v, hdr_v + hdr_n, hv + 2);
      std::copy(hdr_b, hdr_b + hdr_n, hb + 2);
    }
  }
  *overflow_rows = overflowed;
  return 0;
}

// Round B's bit-cost tables of rows [0, b) (the native form of
// ``lz77._cost_tables_host``).  Inputs: hist_lit int64[b, 286] (EOB not
// counted), hist_dist int64[b, 30].  Outputs: lit_cost float32[b, 286]
// and dist_cost float32[b, 30], each symbol's 15-bit-limited code length
// with one EOB counted, or 13 where the length is 0; *overflow_rows the
// rows whose literal or distance tree was redistributed to fit 15 bits.
void tpuz_cost_tables(int64_t b, const int64_t* hist_lit, const int64_t* hist_dist,
                      float* lit_cost, float* dist_cost, int64_t* overflow_rows) {
  constexpr float kUnused = 13.0f;
  int64_t overflowed = 0;
  int64_t hl[kLitSyms];
  int32_t ll[kLitSyms], dl[kDistSyms];
  for (int64_t i = 0; i < b; i++) {
    std::copy(hist_lit + i * kLitSyms, hist_lit + (i + 1) * kLitSyms, hl);
    hl[kEob] += 1;
    const int o1 = code_lengths(hl, kLitSyms, kMaxBits, ll);
    const int o2 = code_lengths(hist_dist + i * kDistSyms, kDistSyms, kMaxBits, dl);
    overflowed += o1 > 0 || o2 > 0;
    float* lit_row = lit_cost + i * kLitSyms;
    float* dist_row = dist_cost + i * kDistSyms;
    for (int s = 0; s < kLitSyms; s++) lit_row[s] = ll[s] > 0 ? ll[s] : kUnused;
    for (int s = 0; s < kDistSyms; s++) dist_row[s] = dl[s] > 0 ? dl[s] : kUnused;
  }
  *overflow_rows = overflowed;
}

}  // extern "C"
