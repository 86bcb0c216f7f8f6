// CRC-32 of each row of a byte matrix, whole on the card: out[i] =
// zlib.crc32(row_i[:lengths[i]], init[i]).
//
// Replaces decompress_tpu/ops/checksum.py: _crc_matmul_pallas (each
// 256-byte chunk's zero-init register as a float32 GF(2) product on the
// TPU's matrix unit) together with the work around it: the back-aligned,
// power-of-two padded copy of the rows, _crc32_register_jit's combine tree
// of 32x32 products, and crc32_batch_device's host finish (init and final
// XOR).
//
// Bound on the H100: device memory.  The function reads each row's first
// lengths[i] bytes once and writes 8 bytes a row; for the sharded decode's
// 65 rows (8,388,608 payload bytes) that is 0.0025 ms at 3.35 TB/s.
//
// Design.  Two facts about the zero-init register carry it: leading zero
// bytes are no-ops, and the register of A || B is advance(reg(A), |B|) ^
// reg(B), where advance(r, n) shifts r through n zero bytes (a GF(2)
// linear map).  So the row is cut into 16-byte pieces, each folded alone,
// and the pieces' registers are advanced to the row's end and XORed.
// - Virtual alignment: the row's pointer is rounded down to 16 bytes and
//   the bytes before it read as zero (no-ops), so every piece is one
//   aligned 16-byte load; bytes at and past the length are never read.
// - A block of 256 threads covers kSpans sub-spans of 4,096 bytes; in each
//   sub-span neighbouring threads load neighbouring pieces (coalesced).
//   All of a block's loads are issued before the first that must arrive,
//   so their latencies overlap, and the tables are stored to shared
//   memory while the pieces are in flight.  A thread folds its kSpans
//   pieces as independent chains through a byte table kept once per lane
//   in shared memory (no bank conflicts), then joins them by "advance
//   4,096 bytes".
//   A warp folds its 32 lanes by shuffles and "advance 16 * 2^j bytes"
//   (j < 5), and warp 0 the block's 8 warps by "advance 512 * 2^j bytes"
//   (j < 3).  Those nine operators are eight 16-entry tables each, one per
//   hex digit of the register (4.5 KB in all, no bank conflicts).
// - Warp 0 advances the block's register to the row's end (by a length
//   known only on the card) with one 32-word GF(2) matrix per nonzero hex
//   digit of the distance, a warp-wide matrix-vector product by
//   __reduce_xor_sync, and XORs it into the row's word.  The shift through
//   one zero byte has order 2^32 - 1, so a block register that ran past
//   the row's end (trailing zeros of the last sub-span) goes back by
//   advancing 2^32 - 1 - z bytes.  Block 0 adds the init term,
//   advance(init ^ ~0, length) ^ ~0.  XOR is exact and order-free, so the
//   result is deterministic; the output words are zeroed by a memset first.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 16;
constexpr int kSub = kThreads * kPiece;        // bytes of one sub-span
constexpr int kWarpBytes = 32 * kPiece;        // bytes of a warp in a sub-span
constexpr int kOps = 9;                        // 16 * 2^j bytes, j = 0..8
constexpr int kOpWords = 8 * 16;
constexpr int kSmemBytes = (256 * 32 + kOps * kOpWords) * 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kOrder = 0xffffffffLL;       // order of the one-byte shift

// One aligned piece at virtual offset o (the row's bytes live at virtual
// [a, nv)), with the bytes outside that range as zero and never read.
__device__ __forceinline__ uint4 load_piece(const uint8_t* base, int64_t o, int a, int64_t nv) {
  if (o >= a && o + kPiece <= nv) return __ldg(reinterpret_cast<const uint4*>(base + o));
  uint32_t w[4] = {0, 0, 0, 0};
  if (o + kPiece > a && o < nv) {
#pragma unroll
    for (int i = 0; i < kPiece; ++i) {
      const int64_t q = o + i;
      if (q >= a && q < nv) w[i >> 2] |= static_cast<uint32_t>(__ldg(base + q)) << (8 * (i & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Zero-init register of 16 bytes; rep holds the byte table once per lane.
__device__ __forceinline__ uint32_t fold_piece(uint4 v, const uint32_t* rep, int lane) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r ^= w[q];
#pragma unroll
    for (int i = 0; i < 4; ++i) r = (r >> 8) ^ rep[((r & 0xFFu) << 5) | lane];
  }
  return r;
}

// r through a fixed number of zero bytes: one 16-entry table per hex digit
// of r (16 consecutive words sit in 16 banks, so lanes never conflict).
__device__ __forceinline__ uint32_t advance_op(const uint32_t* t, uint32_t r) {
  uint32_t x = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) x ^= t[q * 16 + ((r >> (4 * q)) & 15u)];
  return x;
}

// "Advance n zero bytes", n < 2^32, as one 32-word GF(2) matrix per
// nonzero hex digit of n, lane j holding word j of each: loaded by
// load_advance ahead of its use, applied by advance_by to an r that is the
// same in every lane.  nibble[(p * 16 + d) * 32 + j] is the image of bit j
// through d * 16^p bytes.
struct Advance {
  uint32_t n;
  uint32_t col[8];
};

__device__ __forceinline__ Advance load_advance(const uint32_t* __restrict__ nibble, uint32_t n,
                                                int lane) {
  Advance adv;
  adv.n = n;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t d = (n >> (4 * p)) & 15u;
    adv.col[p] = d ? __ldg(nibble + ((p * 16 + d) << 5) + lane) : 0u;
  }
  return adv;
}

__device__ __forceinline__ uint32_t advance_by(const Advance& adv, uint32_t r, int lane) {
#pragma unroll
  for (int p = 0; p < 8; ++p)
    if ((adv.n >> (4 * p)) & 15u)
      r = __reduce_xor_sync(kFull, ((r >> lane) & 1u) ? adv.col[p] : 0u);
  return r;
}

template <int kSpans>
__global__ void __launch_bounds__(kThreads)
    crc_rows_kernel(const uint8_t* __restrict__ data, int64_t stride, int width,
                    const int* __restrict__ lengths, const int64_t* __restrict__ init,
                    const uint32_t* __restrict__ byte_table, const uint4* __restrict__ ops,
                    const uint32_t* __restrict__ nibble, unsigned long long* __restrict__ out,
                    int blocks_per_row) {
  extern __shared__ uint4 smem4[];
  __shared__ uint32_t warp_reg[kThreads / 32];
  uint32_t* rep = reinterpret_cast<uint32_t*>(smem4);  // [256][32]
  const uint32_t* op = rep + 256 * 32;                   // [kOps][8][16]

  const int row = blockIdx.x / blocks_per_row;
  const int blk = blockIdx.x % blocks_per_row;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Loads in the order their results are needed, each issued before the
  // work that waits on an earlier one: the length, this warp's 32 words of
  // the byte table and the operator tables, the pieces, then warp 0's
  // advance matrices; the tables are stored to shared memory only after
  // the pieces are in flight.
  const int len = min(max(lengths[row], 0), width);
  constexpr int kOpLoads = (kOps * kOpWords / 4 + kThreads - 1) / kThreads;
  const uint32_t table_word = __ldg(byte_table + warp * 32 + lane);
  uint4 op_v[kOpLoads];
#pragma unroll
  for (int i = 0; i < kOpLoads; ++i)
    if (tid + i * kThreads < kOps * kOpWords / 4) op_v[i] = __ldg(ops + tid + i * kThreads);

  const uint8_t* p = data + row * stride;
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15u);
  const uint8_t* base = p - a;  // virtual byte v at base + v; only [a, nv) is read
  const int64_t nv = a + len;
  const int64_t span0 = static_cast<int64_t>(blk) * kSpans * kSub;
  const bool has_data = span0 < nv;
  if (!has_data && blk != 0) return;

  const int64_t first = span0 + warp * kWarpBytes;
  const bool warp_data = has_data && first < nv;
  uint4 v[kSpans];
  if (warp_data) {
#pragma unroll
    for (int k = 0; k < kSpans; ++k)
      v[k] = load_piece(base, first + k * kSub + lane * kPiece, a, nv);
  }
  Advance to_end, over_row;
  uint32_t start = 0;
  if (warp == 0) {
    // the block's register ends at its span's end
    const int64_t shift = nv - (span0 + kSpans * kSub);
    const uint32_t n = static_cast<uint32_t>(shift >= 0 ? shift : shift + kOrder);
    if (has_data) to_end = load_advance(nibble, n, lane);
    if (blk == 0) {
      over_row = load_advance(nibble, static_cast<uint32_t>(len), lane);
      if (init != nullptr) start = static_cast<uint32_t>(init[row]);
    }
  }
  // warp w stores table rows 32w..32w+31, each 32 copies (8 uint4) long
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t t = __shfl_sync(kFull, table_word, 4 * i + (lane >> 3));
    smem4[warp * 256 + i * 32 + lane] = make_uint4(t, t, t, t);
  }
#pragma unroll
  for (int i = 0; i < kOpLoads; ++i)
    if (tid + i * kThreads < kOps * kOpWords / 4) smem4[256 * 8 + tid + i * kThreads] = op_v[i];
  __syncthreads();

  uint32_t contrib = 0;
  if (has_data) {
    uint32_t r = 0;
    if (warp_data) {
      uint32_t reg[kSpans];
#pragma unroll
      for (int k = 0; k < kSpans; ++k) reg[k] = fold_piece(v[k], rep, lane);
      r = reg[0];
#pragma unroll
      for (int k = 1; k < kSpans; ++k) r = advance_op(op + 8 * kOpWords, r) ^ reg[k];
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const uint32_t other = __shfl_down_sync(kFull, r, 1 << j);
        r = advance_op(op + j * kOpWords, r) ^ other;
      }
    }
    // lane 0: the warp's register, ending at its last sub-span's lane 31
    if (lane == 0) warp_reg[warp] = r;
    __syncthreads();
    if (warp == 0) {
      r = lane < kThreads / 32 ? warp_reg[lane] : 0u;
#pragma unroll
      for (int j = 5; j < 8; ++j) {
        const uint32_t other = __shfl_down_sync(kFull, r, 1 << (j - 5));
        r = advance_op(op + j * kOpWords, r) ^ other;
      }
      contrib = advance_by(to_end, __shfl_sync(kFull, r, 0), lane);
    }
  }
  if (blk == 0 && warp == 0) contrib ^= advance_by(over_row, ~start, lane) ^ kFull;
  if (tid == 0 && contrib != 0) atomicXor(out + row, static_cast<unsigned long long>(contrib));
}

template <int kSpans>
cudaError_t launch(const uint8_t* data, int64_t stride, int m, int width, const int* lengths,
                   const int64_t* init, const uint32_t* byte_table, const uint32_t* ops,
                   const uint32_t* nibble, unsigned long long* out, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        crc_rows_kernel<kSpans>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int64_t span = static_cast<int64_t>(kSpans) * kSub;
  const int blocks_per_row = static_cast<int>((width + kPiece - 1 + span - 1) / span);
  const int64_t blocks = static_cast<int64_t>(blocks_per_row) * m;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  crc_rows_kernel<kSpans><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(
      data, stride, width, lengths, init, byte_table, reinterpret_cast<const uint4*>(ops), nibble,
      out, blocks_per_row);
  return cudaGetLastError();
}

}  // namespace

// data: uint8 rows of `width` bytes, `stride` bytes apart; lengths: int32[m];
// init: int64[m] or null (0); byte_table: uint32[256]; ops: uint32[9][8][16]
// (advance 16 * 2^j bytes, j = 0..8), 16-byte aligned; nibble:
// uint32[8][16][32]; out: int64[m], zeroed here.  spans: 1, 2, 4 or 8
// sub-spans of 4,096 bytes a block.
extern "C" int dtt_crc_rows(const uint8_t* data, long long stride, int m, int width,
                            const int* lengths, const long long* init, const uint32_t* byte_table,
                            const uint32_t* ops, const uint32_t* nibble, long long* out, int spans,
                            void* stream) {
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(m) * sizeof(long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto fn = spans == 1 ? launch<1> : spans == 2 ? launch<2> : spans == 4 ? launch<4>
                 : spans == 8 ? launch<8> : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  e = fn(data, stride, m, width, lengths, reinterpret_cast<const int64_t*>(init), byte_table, ops,
         nibble, reinterpret_cast<unsigned long long*>(out), s);
  return static_cast<int>(e);
}
