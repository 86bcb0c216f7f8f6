// Per-chunk CRC-32 registers: out[c, j] = bit j of the zero-init CRC-32
// register after chunk c's 256 bytes (no init, no final XOR).
//
// Replaces decompress_tpu/ops/checksum.py: _crc_matmul_pallas, which
// computed the same register as a GF(2) product on the TPU's matrix unit:
// bits[M, 2048] @ H[2048, 32] in float32, parity folded in the kernel.
// The register is linear in the message bits, so the classic table-driven
// CRC, r = (r >> 8) ^ T[(r ^ byte) & 0xFF] from r = 0, gives the same bits
// with 256 table lookups per chunk instead of a 2048-deep product.
//
// Bound on the H100: device memory, 256 bytes read and 128 bytes written
// per chunk.  One thread per chunk walks its bytes (16-byte vector loads)
// with the 1 KB byte table in shared memory; a warp then writes its 32
// chunks' register bits together, lane j writing bit j of each, so every
// store is one coalesced 128-byte row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;
constexpr int kThreads = 256;

__global__ void crc_chunks_kernel(const uint8_t* __restrict__ chunks,
                                  const uint32_t* __restrict__ table,
                                  int* __restrict__ out, int m) {
  __shared__ uint32_t t[256];
  t[threadIdx.x] = table[threadIdx.x];  // blockDim.x == 256
  __syncthreads();

  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t reg = 0;
  if (c < m) {
    const uint4* p = reinterpret_cast<const uint4*>(chunks + c * kChunk);
#pragma unroll 4
    for (int k = 0; k < kChunk / 16; ++k) {
      const uint4 v = p[k];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b) reg = (reg >> 8) ^ t[(reg ^ (w[q] >> (8 * b))) & 0xFF];
    }
  }

  const int lane = threadIdx.x & 31;
  const int64_t warp_base = c - lane;
  for (int i = 0; i < 32; ++i) {
    const uint32_t r = __shfl_sync(0xffffffffu, reg, i);
    const int64_t ci = warp_base + i;
    if (ci < m) out[ci * 32 + lane] = static_cast<int>((r >> lane) & 1u);
  }
}

}  // namespace

// chunks: uint8[m, 256], 16-byte aligned; table: the 256-entry CRC-32 byte
// table; out: int32[m, 32].
extern "C" int dtt_crc_chunks(const uint8_t* chunks, const uint32_t* table, int* out, int m,
                              void* stream) {
  if (m > 0) {
    const int blocks = (m + kThreads - 1) / kThreads;
    crc_chunks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(chunks, table,
                                                                                   out, m);
  }
  return static_cast<int>(cudaGetLastError());
}
