// tpuz: native runtime pieces of decompress_tpu.
//
// Plays the role of the reference's native layer (SURVEY §2 #23–25):
//   * scalar Adler-32 / CRC-32 (+ combines)  — checkseum.c's role
//   * an independent LZO1X-1 codec           — the minilzo oracle's role
//   * a resumable streaming raw-DEFLATE inflater — the byte-serial
//     fast path for foreign streams (De.Inf's role, de.ml:510–1824),
//     used by the streaming Python API and the CLI.
//
// Written from the RFC 1951/1950 specs and the classic two-level
// decode-table construction; no code is copied from any existing
// implementation.
//
// Build: g++ -O3 -shared -fPIC tpuz.cpp -o libtpuz.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define TPUZ_X86 1
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Checksums.
// ---------------------------------------------------------------------------

static const uint32_t ADLER_MOD = 65521;

static uint32_t adler32_scalar(const uint8_t* p, uint64_t n, uint32_t prev) {
  uint32_t s1 = prev & 0xffff, s2 = (prev >> 16) & 0xffff;
  while (n > 0) {
    uint64_t chunk = n > 5552 ? 5552 : n;  // max before 32-bit overflow
    n -= chunk;
    for (uint64_t i = 0; i < chunk; i++) {
      s1 += *p++;
      s2 += s1;
    }
    s1 %= ADLER_MOD;
    s2 %= ADLER_MOD;
  }
  return (s2 << 16) | s1;
}

#ifdef TPUZ_X86
// AVX2 Adler-32: 32 bytes per step.  Per block i (s1_i = s1 before it):
//   s1 += sum(b);  s2 += 32*s1_i + sum_j (32-j)*b_j
// so across a group: s2 += 32*(B*s1 + sum_i presum_i) + weighted, with
// presums tracked by adding the running byte-sum vector before each
// block.  Group size keeps every u32 lane clear of overflow; the final
// combine runs in u64.
__attribute__((target("avx2")))
static uint32_t adler32_avx2(const uint8_t* p, uint64_t n, uint32_t prev) {
  uint64_t s1 = prev & 0xffff, s2 = (prev >> 16) & 0xffff;
  const __m256i zero = _mm256_setzero_si256();
  const __m256i wts = _mm256_setr_epi8(
      32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
      16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1);
  const __m256i ones16 = _mm256_set1_epi16(1);
  while (n >= 32) {
    uint64_t blocks = n / 32;
    if (blocks > 173) blocks = 173;  // 173*32 = 5536 bytes per mod round
    n -= blocks * 32;
    uint64_t nb = blocks;
    __m256i vps = zero, vs1 = zero, vs2 = zero;
    for (; nb--; p += 32) {
      __m256i c = _mm256_loadu_si256((const __m256i*)p);
      vps = _mm256_add_epi32(vps, vs1);
      vs1 = _mm256_add_epi32(vs1, _mm256_sad_epu8(c, zero));
      __m256i m = _mm256_maddubs_epi16(c, wts);
      vs2 = _mm256_add_epi32(vs2, _mm256_madd_epi16(m, ones16));
    }
    uint32_t lane[8];
    uint64_t h1 = 0, h2 = 0, hp = 0;
    _mm256_storeu_si256((__m256i*)lane, vs1);
    for (int i = 0; i < 8; i++) h1 += lane[i];
    _mm256_storeu_si256((__m256i*)lane, vs2);
    for (int i = 0; i < 8; i++) h2 += lane[i];
    _mm256_storeu_si256((__m256i*)lane, vps);
    for (int i = 0; i < 8; i++) hp += lane[i];
    s2 = (s2 + 32 * (blocks * s1 + hp) + h2) % ADLER_MOD;
    s1 = (s1 + h1) % ADLER_MOD;
  }
  if (n)
    return adler32_scalar(p, n, (uint32_t)((s2 << 16) | s1));
  return (uint32_t)((s2 << 16) | s1);
}

static int adler_avx2_usable() {
  static int usable = -1;
  if (usable < 0) {
    usable = 0;
    if (__builtin_cpu_supports("avx2")) {
      uint8_t buf[301];
      uint32_t x = 0x87654321u;
      for (int i = 0; i < 301; i++) {
        x = x * 1103515245u + 12345u;
        buf[i] = (uint8_t)(x >> 16);
      }
      usable = adler32_avx2(buf, 301, 0xABCD1234u) ==
               adler32_scalar(buf, 301, 0xABCD1234u);
    }
  }
  return usable;
}
#endif  // TPUZ_X86

uint32_t tpuz_adler32(const uint8_t* p, uint64_t n, uint32_t prev) {
#ifdef TPUZ_X86
  if (n >= 64 && adler_avx2_usable()) return adler32_avx2(p, n, prev);
#endif
  return adler32_scalar(p, n, prev);
}

static uint32_t crc_table[8][256];
static bool crc_init_done = false;

static void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xff];
  crc_init_done = true;
}

static uint32_t crc32_slice8(const uint8_t* p, uint64_t n, uint32_t prev) {
  crc_init();
  uint32_t c = ~prev;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = crc_table[7][lo & 0xff] ^ crc_table[6][(lo >> 8) & 0xff] ^
        crc_table[5][(lo >> 16) & 0xff] ^ crc_table[4][lo >> 24] ^
        crc_table[3][hi & 0xff] ^ crc_table[2][(hi >> 8) & 0xff] ^
        crc_table[1][(hi >> 16) & 0xff] ^ crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ crc_table[0][(c ^ *p++) & 0xff];
  return ~c;
}

#ifdef TPUZ_X86
// ---- PCLMULQDQ-folded CRC-32 ----------------------------------------
// Classic 4-accumulator carryless folding (the reflected variant of the
// well-known Intel technique).  All constants are DERIVED at init from
// x^n mod P, so nothing is transcribed: the stored-form identity used is
//   clmul(R_64(a), R_33(m)) = R_128(a*m) >> 32 = R_128(a * m * x^32)
// hence folding by x^S uses m = x^(S+64-32) (high qword) and
// m = x^(S-32) (low qword).  A one-time self-check against the table
// path guards the whole construction (falls back on any mismatch or
// missing CPU support).

// x^n mod P in normal bit order (bit i = coeff of x^i), P = x^32 + 0x04C11DB7
static uint32_t xn_mod_p(uint64_t n) {
  uint32_t r = 1;
  for (uint64_t i = 0; i < n; i++) {
    uint32_t hi = r & 0x80000000u;
    r <<= 1;
    if (hi) r ^= 0x04C11DB7u;
  }
  return r;
}

// folding constant: R_33(x^n mod P) as a 64-bit clmul operand
static uint64_t crc_k(uint64_t n) {
  uint32_t v = xn_mod_p(n), r = 0;
  for (int i = 0; i < 32; i++) { r = (r << 1) | (v & 1); v >>= 1; }
  return (uint64_t)r << 1;
}

// raw reflected register update, no pre/post inversion: feeding the
// STORED bytes of a folded accumulator through this with reg=0 performs
// the final (a * x^32) mod P reduction exactly.
static uint32_t crc_raw_update(uint32_t reg, const uint8_t* p, uint64_t n) {
  while (n--) reg = (reg >> 8) ^ crc_table[0][(reg ^ *p++) & 0xff];
  return reg;
}

__attribute__((target("pclmul,sse4.1")))
static inline __m128i crc_fold(__m128i acc, __m128i k) {
  return _mm_xor_si128(_mm_clmulepi64_si128(acc, k, 0x00),
                       _mm_clmulepi64_si128(acc, k, 0x11));
}

__attribute__((target("pclmul,sse4.1")))
static uint32_t crc32_clmul(const uint8_t* p, uint64_t n, uint32_t prev) {
  static const __m128i k512 = _mm_set_epi64x((long long)crc_k(480),
                                             (long long)crc_k(544));
  static const __m128i k128 = _mm_set_epi64x((long long)crc_k(96),
                                             (long long)crc_k(160));
  __m128i a0 = _mm_loadu_si128((const __m128i*)(p + 0));
  __m128i a1 = _mm_loadu_si128((const __m128i*)(p + 16));
  __m128i a2 = _mm_loadu_si128((const __m128i*)(p + 32));
  __m128i a3 = _mm_loadu_si128((const __m128i*)(p + 48));
  a0 = _mm_xor_si128(a0, _mm_cvtsi32_si128((int)~prev));
  p += 64; n -= 64;
  while (n >= 64) {
    a0 = _mm_xor_si128(crc_fold(a0, k512), _mm_loadu_si128((const __m128i*)(p + 0)));
    a1 = _mm_xor_si128(crc_fold(a1, k512), _mm_loadu_si128((const __m128i*)(p + 16)));
    a2 = _mm_xor_si128(crc_fold(a2, k512), _mm_loadu_si128((const __m128i*)(p + 32)));
    a3 = _mm_xor_si128(crc_fold(a3, k512), _mm_loadu_si128((const __m128i*)(p + 48)));
    p += 64; n -= 64;
  }
  __m128i a = _mm_xor_si128(crc_fold(a0, k128), a1);
  a = _mm_xor_si128(crc_fold(a, k128), a2);
  a = _mm_xor_si128(crc_fold(a, k128), a3);
  while (n >= 16) {
    a = _mm_xor_si128(crc_fold(a, k128), _mm_loadu_si128((const __m128i*)p));
    p += 16; n -= 16;
  }
  uint8_t accb[16];
  _mm_storeu_si128((__m128i*)accb, a);
  uint32_t reg = crc_raw_update(0, accb, 16);
  reg = crc_raw_update(reg, p, n);
  return ~reg;
}

static int crc_clmul_usable() {
  static int usable = -1;
  if (usable < 0) {
    usable = 0;
    if (__builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1")) {
      crc_init();
      uint8_t buf[257];
      uint32_t x = 0x12345678u;
      for (int i = 0; i < 257; i++) {
        x = x * 1103515245u + 12345u;
        buf[i] = (uint8_t)(x >> 16);
      }
      usable = crc32_clmul(buf, 257, 0xDEADBEEFu) ==
               crc32_slice8(buf, 257, 0xDEADBEEFu);
    }
  }
  return usable;
}
#endif  // TPUZ_X86

uint32_t tpuz_crc32(const uint8_t* p, uint64_t n, uint32_t prev) {
#ifdef TPUZ_X86
  if (n >= 64 && crc_clmul_usable()) return crc32_clmul(p, n, prev);
#endif
  return crc32_slice8(p, n, prev);
}

// GF(2) 32x32 matrix ops for crc32_combine (zlib algebra, re-derived).
static void gf2_matsq(uint32_t* sq, const uint32_t* m) {
  for (int j = 0; j < 32; j++) {
    uint32_t v = m[j], r = 0;
    for (int b = 0; b < 32 && v; b++, v >>= 1)
      if (v & 1) r ^= m[b];
    sq[j] = r;
  }
}

uint32_t tpuz_crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  // operator: advance register by one zero byte
  crc_init();
  uint32_t even[32], odd[32];
  for (int j = 0; j < 32; j++) {
    uint32_t v = 1u << j;
    odd[j] = (v >> 8) ^ crc_table[0][v & 0xff];
  }
  // odd = M^1; square repeatedly applying set bits of len2
  uint32_t* a = odd;
  uint32_t* b = even;
  while (len2) {
    if (len2 & 1) {
      uint32_t r = 0, v = crc1;
      for (int bit = 0; bit < 32 && v; bit++, v >>= 1)
        if (v & 1) r ^= a[bit];
      crc1 = r;
    }
    len2 >>= 1;
    if (!len2) break;
    gf2_matsq(b, a);
    uint32_t* t = a; a = b; b = t;
  }
  return crc1 ^ crc2;
}

uint32_t tpuz_adler32_combine(uint32_t a1, uint32_t a2, uint64_t len2) {
  uint64_t rem = len2 % ADLER_MOD;
  uint64_t s1_1 = a1 & 0xffff, s2_1 = (a1 >> 16) & 0xffff;
  uint64_t s1_2 = a2 & 0xffff, s2_2 = (a2 >> 16) & 0xffff;
  uint64_t s1 = (s1_1 + s1_2 + ADLER_MOD - 1) % ADLER_MOD;
  uint64_t s2 = (s2_1 + s2_2 + rem * (s1_1 + ADLER_MOD - 1)) % ADLER_MOD;
  return (uint32_t)((s2 << 16) | s1);
}

// ---------------------------------------------------------------------------
// LZO1X (independent oracle implementation).
// ---------------------------------------------------------------------------

#define TPUZ_OK 0
#define TPUZ_E_INPUT (-1)
#define TPUZ_E_OUTPUT (-2)
#define TPUZ_E_DATA (-3)

int tpuz_lzo1x_decompress(const uint8_t* in, uint64_t in_len, uint8_t* out,
                          uint64_t out_cap, uint64_t* out_len) {
  const uint8_t* ip = in;
  const uint8_t* const ip_end = in + in_len;
  uint8_t* op = out;
  uint8_t* const op_end = out + out_cap;
  int state = 0;

#define NEED_IN(k) do { if ((uint64_t)(ip_end - ip) < (uint64_t)(k)) return TPUZ_E_INPUT; } while (0)
#define NEED_OUT(k) do { if ((uint64_t)(op_end - op) < (uint64_t)(k)) return TPUZ_E_OUTPUT; } while (0)

  NEED_IN(1);
  if (*ip > 17) {
    uint32_t t = *ip++ - 17;
    NEED_IN(t);
    NEED_OUT(t);
    for (uint32_t i = 0; i < t; i++) *op++ = *ip++;
    state = t < 4 ? (int)t : 4;
  }

  for (;;) {
    NEED_IN(1);
    uint32_t t = *ip++;
    uint32_t len, dist, s;
    if (t < 16) {
      if (state == 0) {
        if (t == 0) {
          len = 15;
          while (ip < ip_end && *ip == 0) { len += 255; ip++; if (len > (1u<<26)) return TPUZ_E_DATA; }
          NEED_IN(1);
          len += *ip++;
        } else {
          len = t;
        }
        len += 3;
        NEED_IN(len);
        NEED_OUT(len);
        memcpy(op, ip, len);
        op += len; ip += len;
        state = 4;
        continue;
      }
      NEED_IN(1);
      uint32_t nxt = *ip++;
      if (state >= 1 && state <= 3) {
        dist = (t >> 2) + (nxt << 2) + 1;
        len = 2;
      } else {  // state == 4
        dist = (t >> 2) + (nxt << 2) + 2049;
        len = 3;
      }
      s = t & 3;
    } else if (t < 32) {  // M4
      len = t & 7;
      if (len == 0) {
        len = 7;
        while (ip < ip_end && *ip == 0) { len += 255; ip++; if (len > (1u<<26)) return TPUZ_E_DATA; }
        NEED_IN(1);
        len += *ip++;
      }
      len += 2;
      NEED_IN(2);
      uint32_t le = ip[0] | (ip[1] << 8);
      ip += 2;
      dist = 16384 + ((t & 8) << 11) + (le >> 2);
      s = le & 3;
      if (dist == 16384) break;  // end marker
    } else if (t < 64) {  // M3
      len = t & 31;
      if (len == 0) {
        len = 31;
        while (ip < ip_end && *ip == 0) { len += 255; ip++; if (len > (1u<<26)) return TPUZ_E_DATA; }
        NEED_IN(1);
        len += *ip++;
      }
      len += 2;
      NEED_IN(2);
      uint32_t le = ip[0] | (ip[1] << 8);
      ip += 2;
      dist = (le >> 2) + 1;
      s = le & 3;
    } else {  // M2
      len = (t >> 5) + 1;
      NEED_IN(1);
      dist = ((t >> 2) & 7) + (*ip++ << 3) + 1;
      s = t & 3;
    }
    if (dist > (uint64_t)(op - out)) return TPUZ_E_DATA;
    NEED_OUT(len);
    const uint8_t* src = op - dist;
    for (uint32_t i = 0; i < len; i++) op[i] = src[i];  // overlap-correct
    op += len;
    if (s) {
      NEED_IN(s);
      NEED_OUT(s);
      for (uint32_t i = 0; i < s; i++) *op++ = *ip++;
    }
    state = (int)s;
  }
  if (ip != ip_end) return TPUZ_E_DATA;
  *out_len = (uint64_t)(op - out);
  return TPUZ_OK;
#undef NEED_IN
#undef NEED_OUT
}

// Simple greedy LZO1X-1-style compressor: hash-4 table, window 48K.
int tpuz_lzo1x_compress(const uint8_t* in, uint64_t n, uint8_t* out,
                        uint64_t out_cap, uint64_t* out_len) {
  uint8_t* op = out;
  uint8_t* const op_end = out + out_cap;
  uint32_t htab[1 << 14];
  for (int i = 0; i < (1 << 14); i++) htab[i] = 0xffffffffu;

#define PUT(b) do { if (op >= op_end) return TPUZ_E_OUTPUT; *op++ = (uint8_t)(b); } while (0)

  uint64_t lit_start = 0;
  uint64_t i = 0;
  bool first = true;

  auto emit_run = [&](uint64_t lo, uint64_t hi) -> int {
    uint64_t run = hi - lo;
    if (run == 0) return 0;
    if (first && run <= 238) {
      PUT(run + 17);
    } else if (run < 4) {
      return TPUZ_E_DATA;  // never by construction
    } else if (run <= 18) {
      PUT(run - 3);
    } else {
      PUT(0);
      uint64_t rem = run - 18;
      while (rem > 255) { PUT(0); rem -= 255; }
      PUT(rem);
    }
    if ((uint64_t)(op_end - op) < run) return TPUZ_E_OUTPUT;
    memcpy(op, in + lo, run);
    op += run;
    first = false;
    return 0;
  };

  while (i + 4 <= n) {
    uint32_t v;
    memcpy(&v, in + i, 4);
    uint32_t h = (v * 0x9E3779B1u) >> 18;  // 14 bits
    uint32_t cand = htab[h];
    htab[h] = (uint32_t)i;
    uint64_t dist = (cand == 0xffffffffu) ? 0 : i - cand;
    if (cand != 0xffffffffu && dist >= 1 && dist <= 49151) {
      uint32_t cv;
      memcpy(&cv, in + cand, 4);
      uint64_t pend_run = i - lit_start;
      // a standalone literal run of 1..3 is not encodable mid-stream
      // (it would ride a previous match's trailing bits, already
      // emitted); defer matching until the run reaches 4
      bool run_ok = first || pend_run == 0 || pend_run >= 4;
      if (cv == v && run_ok) {
        // extend
        uint64_t len = 4;
        uint64_t maxl = n - i;
        if (maxl > 0x7000) maxl = 0x7000;
        while (len < maxl && in[cand + len] == in[i + len]) len++;
        {
          if (emit_run(lit_start, i)) return TPUZ_E_OUTPUT;
          first = false;
          // trailing literals: decided after we know next match; emit 0
          // here and let short runs be impossible by construction:
          // we always attach up to 3 literals following the match.
          uint64_t q = i + len;
          uint64_t s = 0;
          // look ahead: attach 1..3 literals if fewer than 4 remain
          // before either EOF or the next likely match; cheap rule:
          // attach if remaining input after match is 1..3 bytes.
          if (n - q > 0 && n - q < 4) s = n - q;
          // emit match
          if (dist <= 2048 && len <= 8) {
            PUT(((len - 1) << 5) | (((dist - 1) & 7) << 2) | s);
            PUT((dist - 1) >> 3);
          } else if (dist <= 16384) {
            uint64_t base = len - 2;
            if (base < 32) PUT(32 | base);
            else {
              PUT(32);
              uint64_t rem = base - 31;
              while (rem > 255) { PUT(0); rem -= 255; }
              PUT(rem);
            }
            uint32_t le = (uint32_t)(((dist - 1) << 2) | s);
            PUT(le & 0xff); PUT(le >> 8);
          } else {
            uint64_t d = dist - 16384;
            uint64_t base = len - 2;
            uint32_t tt = 16 | ((d >> 11) & 8);
            if (base < 8) PUT(tt | base);
            else {
              PUT(tt);
              uint64_t rem = base - 7;
              while (rem > 255) { PUT(0); rem -= 255; }
              PUT(rem);
            }
            uint32_t le = (uint32_t)(((d & 0x3fff) << 2) | s);
            PUT(le & 0xff); PUT(le >> 8);
          }
          for (uint64_t k = 0; k < s; k++) PUT(in[q + k]);
          // index skipped positions sparsely
          for (uint64_t k = i + 1; k < q && k + 4 <= n; k += 2) {
            uint32_t vv;
            memcpy(&vv, in + k, 4);
            htab[(vv * 0x9E3779B1u) >> 18] = (uint32_t)k;
          }
          i = q + s;
          lit_start = i;
          continue;
        }
      }
    }
    i++;
  }
  // Trailing literals.  A mid-stream tail of 1..3 is impossible by
  // construction: every match whose end leaves fewer than 4 bytes
  // attaches them as its trailing literals, so any standalone tail run
  // here is either the whole (short) input (first-byte form) or >= 4.
  if (lit_start < n) {
    if (emit_run(lit_start, n)) return TPUZ_E_OUTPUT;
  }
  PUT(0x11); PUT(0x00); PUT(0x00);
  *out_len = (uint64_t)(op - out);
  return TPUZ_OK;
#undef PUT
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Resumable streaming raw-DEFLATE inflater.
//
// Byte-serial fast path for foreign streams (the device batch decoder
// handles member-parallel archives).  State machine with suspendable
// NEEDBITS at every read point, 32 KiB ring window mirroring output
// (the reference's WInf blit2 discipline, de.ml:163–205), and the
// whole-byte give-back at end of stream (de.ml:1459–1466).
// ---------------------------------------------------------------------------

extern "C" {

enum {
  TPUZ_AWAIT = 0,
  TPUZ_FLUSH = 1,
  TPUZ_END = 2,
  TPUZ_MALFORMED = -3,
};

// decode-table entry: flags<<28 | nbits<<16 | value (same packing as the
// python core so tests can cross-check)
static const int32_t F_SYMBOL = 0, F_LINK = 1, F_INVALID = 2;
#define ENTRY(f, n, v) ((int32_t)(((f) << 28) | ((n) << 16) | (v)))
#define E_FLAGS(e) ((e) >> 28)
#define E_NBITS(e) (((e) >> 16) & 0xfff)
#define E_VALUE(e) ((e) & 0xffff)

struct Huff {
  int32_t table[1 << 12];
  int root_bits;
};

static uint32_t rev_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

// Build two-level table. Returns 0 ok, -1 invalid. allow_incomplete for
// degenerate distance trees.
static int huff_build(Huff* h, const uint8_t* lens, int n, int root_bits,
                      int allow_incomplete) {
  int counts[16] = {0};
  int nsyms = 0, max_len = 0;
  for (int i = 0; i < n; i++) {
    counts[lens[i]]++;
    if (lens[i]) { nsyms++; if (lens[i] > max_len) max_len = lens[i]; }
  }
  // kraft
  long long slack = 1 << 15;
  for (int l = 1; l <= 15; l++) slack -= (long long)counts[l] << (15 - l);
  if (slack < 0) return -1;
  if (slack > 0 && !(allow_incomplete && nsyms <= 1)) return -1;
  int rb = root_bits;
  if (max_len && max_len < rb) rb = max_len;
  if (rb < 1) rb = 1;
  h->root_bits = root_bits;  // caller always peeks root_bits
  int root_size = 1 << rb;
  int cap = 1 << 12;
  for (int i = 0; i < cap; i++) h->table[i] = ENTRY(F_INVALID, 0, 0);
  if (nsyms == 0) {
    // replicate invalid root across the full peek width
    for (int i = root_size; i < (1 << root_bits); i++) h->table[i] = h->table[i & (root_size - 1)];
    return 0;
  }
  // canonical codes
  int next_code[17];
  int code = 0;
  next_code[0] = 0;
  for (int l = 1; l <= 16; l++) { code = (code + counts[l - 1]) << 1; next_code[l] = code; }
  int total = 1 << root_bits;  // subtables start after the padded root
  // first pass: subtable allocation per root prefix for long codes
  // (we walk symbols in canonical order)
  int sub_off[1 << 11];
  int sub_bits_arr[1 << 11];
  for (int i = 0; i < (1 << 11); i++) { sub_off[i] = -1; sub_bits_arr[i] = 0; }
  if (max_len > rb) {
    // compute per-prefix max length
    int codes2[16];
    memcpy(codes2, next_code, sizeof(codes2));
    for (int l = 1; l <= 15; l++) {
      for (int s = 0; s < n; s++) {
        if (lens[s] != l) continue;
        uint32_t c = rev_bits(codes2[l]++, l);
        if (l <= rb) continue;
        uint32_t p = c & (root_size - 1);
        if ((int)(l - rb) > sub_bits_arr[p]) sub_bits_arr[p] = l - rb;
      }
    }
    for (int p = 0; p < root_size; p++) {
      if (sub_bits_arr[p]) {
        sub_off[p] = total;
        total += 1 << sub_bits_arr[p];
        if (total > cap) return -1;
        h->table[p] = ENTRY(F_LINK, sub_bits_arr[p], sub_off[p]);
      }
    }
  }
  // second pass: fill entries
  for (int l = 1; l <= 15; l++) {
    for (int s = 0; s < n; s++) {
      if (lens[s] != l) continue;
      uint32_t c = rev_bits(next_code[l]++, l);
      if (l <= rb) {
        for (int idx = c; idx < root_size; idx += 1 << l)
          h->table[idx] = ENTRY(F_SYMBOL, l, s);
      } else {
        uint32_t p = c & (root_size - 1);
        int sb = sub_bits_arr[p];
        uint32_t rem = c >> rb;
        for (int idx = rem; idx < (1 << sb); idx += 1 << (l - rb))
          h->table[sub_off[p] + idx] = ENTRY(F_SYMBOL, l, s);
      }
    }
  }
  // pad root to the full peek width
  for (int i = root_size; i < (1 << root_bits); i++) h->table[i] = h->table[i & (root_size - 1)];
  return 0;
}

static const uint16_t LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
  35,43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,
  4,4,4,4,5,5,5,5,0};
static const uint16_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,
  193,257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
static const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,
  9,9,10,10,11,11,12,12,13,13};
static const uint8_t PRECODE_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,
  2,14,1,15};

enum Mode {
  M_HEAD = 0, M_STORED_LEN, M_STORED_COPY, M_TABLE_SIZES, M_TABLE_PRE,
  M_TABLE_LENS, M_TABLE_REP, M_SYM, M_LENEXTRA, M_DISTSYM, M_DISTEXTRA,
  M_COPY, M_DONE, M_BAD,
};

struct TpuzInflate {
  uint64_t hold;
  int bits;
  int mode;
  int final_block;
  uint32_t stored_rem;
  int hlit, hdist, hclen, lenidx;
  uint8_t lens[320];
  Huff pre, lit, dist;
  int fixed_ready;
  uint32_t rep_sym, rep_bits_val;
  uint32_t sym_len, copy_len, copy_dist;
  uint8_t window[32768];
  uint64_t total_out;
  uint32_t win_limit;  // negotiated window (zl.ml:247-280: allocate (cinfo+8))
  const char* err;
  // fused decode tables for the bulk loop: one 32-bit entry carries the
  // whole command arithmetic (code bits, extra-bit count, length/dist
  // base or literal byte), so a symbol resolves with a single load and
  // no base/extra side lookups.  Layout:
  //   bits 0..3   code bits
  //   bits 4..7   extra bits (length/dist) or sub-bits (link)
  //   bits 8..23  payload: literal byte / length base / dist base / link offset
  //   bit 31 literal|dist, bit 30 length, bit 29 EOB, bit 28 link; 0 invalid
  uint32_t flit[1 << 12];
  uint32_t fdist[1 << 12];
};

TpuzInflate* tpuz_inflate_new() {
  TpuzInflate* s = (TpuzInflate*)calloc(1, sizeof(TpuzInflate));
  s->win_limit = 32768;
  return s;
}
void tpuz_inflate_free(TpuzInflate* s) { free(s); }
// Snapshot a decoder mid-stream (reference "immutable style" decoders,
// zl.ml:146-164: a copied decoder value resumes independently).  The
// struct is flat POD — err points at static strings — so one memcpy
// captures the bit buffer, mode, tables, and window.
TpuzInflate* tpuz_inflate_clone(const TpuzInflate* s) {
  TpuzInflate* c = (TpuzInflate*)malloc(sizeof(TpuzInflate));
  if (c) memcpy(c, s, sizeof(*c));
  return c;
}
void tpuz_inflate_reset(TpuzInflate* s) {
  uint32_t keep_limit = s->win_limit ? s->win_limit : 32768;
  memset(s, 0, sizeof(*s));
  s->win_limit = keep_limit;
}

// Restrict back-references to a 2^bits window (decode side of
// window_bits; a stream referencing further is "invalid distance").
void tpuz_inflate_set_window_bits(TpuzInflate* s, int wbits) {
  s->win_limit = (wbits >= 8 && wbits <= 15) ? (1u << wbits) : 32768;
}
const char* tpuz_inflate_error(TpuzInflate* s) { return s->err ? s->err : ""; }
uint64_t tpuz_inflate_total_out(TpuzInflate* s) { return s->total_out; }

// After TPUZ_END: pop whole bytes still buffered in the hold (they were
// consumed from earlier run() calls' inputs).  Returns the byte count,
// oldest byte first.
int tpuz_inflate_takeback(TpuzInflate* s, uint8_t* out, int cap) {
  // the low (bits % 8) bits are padding inside the byte the stream
  // ended in — not give-backable; whole bytes follow them
  s->hold >>= (s->bits & 7);
  s->bits -= s->bits & 7;
  int n = 0;
  while (s->bits >= 8 && n < cap) {
    out[n++] = (uint8_t)(s->hold & 0xff);
    s->hold >>= 8;
    s->bits -= 8;
  }
  return n;
}

// Window-cursor control (reference `unsafe_set_cursor`, de.ml:1826 /
// de.mli:669): git-style delta consumers position the ring cursor
// directly instead of feeding a dictionary.  The cursor IS total_out
// (the ring index is total_out & 32767).
void tpuz_inflate_set_cursor(TpuzInflate* s, uint64_t pos) {
  s->total_out = pos;
}
uint64_t tpuz_inflate_cursor(const TpuzInflate* s) { return s->total_out; }
// Reset the stream machine for a NEW raw-deflate stream while keeping
// the window ring and cursor — the delta flow: decode the base object,
// reset-keep-window, decode the delta whose far distances resolve into
// the base's bytes (no set_dictionary copy).
void tpuz_inflate_reset_keep_window(TpuzInflate* s) {
  uint8_t win[32768];
  memcpy(win, s->window, sizeof(win));
  uint64_t tout = s->total_out;
  uint32_t keep_limit = s->win_limit ? s->win_limit : 32768;
  memset(s, 0, sizeof(*s));
  memcpy(s->window, win, sizeof(win));
  s->total_out = tout;
  s->win_limit = keep_limit;
}

int tpuz_inflate_set_dictionary(TpuzInflate* s, const uint8_t* dict, uint32_t len) {
  if (len > 32768) { dict += len - 32768; len = 32768; }
  // place dictionary as if it were prior output
  for (uint32_t i = 0; i < len; i++)
    s->window[(s->total_out + i) & 32767] = dict[i];
  s->total_out += len;
  return 0;
}

// root peek widths: 11 covers the common 10/11-bit litlen codes of big
// dynamic blocks without a subtable hop (libdeflate-style; capacity
// bound ~2342 of 4096 entries), 9 likewise for dist codes.
#define LIT_RB 11
#define DIST_RB 9

#define FL_LIT (1u << 31)   // litlen table: literal / dist table: valid dist
#define FL_LEN (1u << 30)
#define FL_EOB (1u << 29)
#define FL_LINK (1u << 28)

// Re-pack the two-level tables into the fused form above.  Entry
// semantics are position-independent (links are offsets into the same
// array), so a flat elementwise pass over both 4 Ki tables suffices.
static void fuse_tables(TpuzInflate* s) {
  for (int i = 0; i < (1 << 12); i++) {
    int32_t e = s->lit.table[i];
    uint32_t f = 0;
    if (E_FLAGS(e) == F_SYMBOL) {
      uint32_t v = E_VALUE(e), nb = E_NBITS(e);
      if (v < 256) f = FL_LIT | (v << 8) | nb;
      else if (v == 256) f = FL_EOB | nb;
      else if (v <= 285)
        f = FL_LEN | ((uint32_t)LEN_BASE[v - 257] << 8) |
            ((uint32_t)LEN_EXTRA[v - 257] << 4) | nb;
      // 286/287: leave invalid (fixed tree reserves them)
    } else if (E_FLAGS(e) == F_LINK) {
      f = FL_LINK | ((uint32_t)E_VALUE(e) << 8) | ((uint32_t)E_NBITS(e) << 4);
    }
    s->flit[i] = f;
    e = s->dist.table[i];
    f = 0;
    if (E_FLAGS(e) == F_SYMBOL) {
      uint32_t v = E_VALUE(e), nb = E_NBITS(e);
      if (v <= 29)
        f = FL_LIT | ((uint32_t)DIST_BASE[v] << 8) |
            ((uint32_t)DIST_EXTRA[v] << 4) | nb;
    } else if (E_FLAGS(e) == F_LINK) {
      f = FL_LINK | ((uint32_t)E_VALUE(e) << 8) | ((uint32_t)E_NBITS(e) << 4);
    }
    s->fdist[i] = f;
  }
}

static void build_fixed(TpuzInflate* s) {
  uint8_t lens[288];
  for (int i = 0; i < 144; i++) lens[i] = 8;
  for (int i = 144; i < 256; i++) lens[i] = 9;
  for (int i = 256; i < 280; i++) lens[i] = 7;
  for (int i = 280; i < 288; i++) lens[i] = 8;
  huff_build(&s->lit, lens, 288, LIT_RB, 0);
  uint8_t dl[32];
  for (int i = 0; i < 32; i++) dl[i] = 5;
  huff_build(&s->dist, dl, 32, DIST_RB, 0);
  fuse_tables(s);
}

int tpuz_inflate_run(TpuzInflate* s, const uint8_t* __restrict src,
                     uint64_t src_len, uint64_t* src_pos,
                     uint8_t* __restrict dst, uint64_t dst_cap,
                     uint64_t* dst_pos) {
  uint64_t sp = *src_pos;
  uint64_t dp = *dst_pos;
  uint64_t hold = s->hold;
  int bits = s->bits;
  const uint64_t tout0 = s->total_out;  // total_out == tout0 + (dp - dp_entry)
  const uint64_t sp_entry = sp;

  const uint64_t dp_entry = dp;
#define TOUT ((uint64_t)(tout0 + (dp - dp_entry)))
#define MIRROR() do { \
    uint64_t prod = dp - dp_entry; \
    uint64_t take = prod > 32768 ? 32768 : prod; \
    for (uint64_t k = take; k > 0; k--) \
      s->window[(TOUT - k) & 32767] = dst[dp - k]; \
  } while (0)
#define SAVE() do { MIRROR(); s->hold = hold; s->bits = bits; s->total_out = TOUT; *src_pos = sp; *dst_pos = dp; } while (0)
#define AWAIT() do { SAVE(); return TPUZ_AWAIT; } while (0)
#define FLUSHED() do { SAVE(); return TPUZ_FLUSH; } while (0)
#define BAD(msg) do { s->mode = M_BAD; s->err = msg; SAVE(); return TPUZ_MALFORMED; } while (0)
#define NEEDBITS(k) do { while (bits < (int)(k)) { if (sp >= src_len) AWAIT(); hold |= (uint64_t)src[sp++] << bits; bits += 8; } } while (0)
#define DROPBITS(k) do { hold >>= (k); bits -= (k); } while (0)
#define OUTBYTE(b) do { dst[dp++] = (uint8_t)(b); } while (0)

#define DECODE(H, RB, EVAR) \
  for (;;) { \
    if (bits <= 32 && sp + 4 <= src_len) { \
      uint32_t _w; memcpy(&_w, src + sp, 4); \
      hold |= (uint64_t)_w << bits; bits += 32; sp += 4; \
    } \
    EVAR = (H).table[hold & ((1u << (RB)) - 1)]; \
    if (E_FLAGS(EVAR) == F_LINK) \
      EVAR = (H).table[E_VALUE(EVAR) + ((hold >> (RB)) & ((1u << E_NBITS(EVAR)) - 1))]; \
    if (E_FLAGS(EVAR) == F_SYMBOL && E_NBITS(EVAR) <= bits) break; \
    if (bits >= 15) { EVAR = -1; break; } \
    if (sp >= src_len) AWAIT(); \
    hold |= (uint64_t)src[sp++] << bits; \
    bits += 8; \
  }

  for (;;) {
    switch (s->mode) {
      case M_HEAD: {
        NEEDBITS(3);
        s->final_block = hold & 1;
        int btype = (hold >> 1) & 3;
        DROPBITS(3);
        if (btype == 0) {
          DROPBITS(bits & 7);  // align
          s->mode = M_STORED_LEN;
        } else if (btype == 1) {
          build_fixed(s);
          s->mode = M_SYM;
        } else if (btype == 2) {
          s->mode = M_TABLE_SIZES;
        } else {
          BAD("invalid kind of block");
        }
        break;
      }
      case M_STORED_LEN: {
        NEEDBITS(32);
        uint32_t len = hold & 0xffff;
        uint32_t nlen = (hold >> 16) & 0xffff;
        if (len != (nlen ^ 0xffff)) BAD("invalid complement of length");
        DROPBITS(32);
        s->stored_rem = len;
        s->mode = M_STORED_COPY;
        break;
      }
      case M_STORED_COPY: {
        while (s->stored_rem > 0) {
          if (bits >= 8) {
            if (dp >= dst_cap) FLUSHED();
            OUTBYTE(hold & 0xff);
            DROPBITS(8);
            s->stored_rem--;
            continue;
          }
          if (sp >= src_len) AWAIT();
          if (dp >= dst_cap) FLUSHED();
          OUTBYTE(src[sp++]);
          s->stored_rem--;
        }
        s->mode = s->final_block ? M_DONE : M_HEAD;
        break;
      }
      case M_TABLE_SIZES: {
        NEEDBITS(14);
        s->hlit = (hold & 31) + 257;
        s->hdist = ((hold >> 5) & 31) + 1;
        s->hclen = ((hold >> 10) & 15) + 4;
        DROPBITS(14);
        if (s->hlit > 286 || s->hdist > 30) BAD("invalid dictionary");
        s->lenidx = 0;
        memset(s->lens, 0, 19);
        s->mode = M_TABLE_PRE;
        break;
      }
      case M_TABLE_PRE: {
        while (s->lenidx < s->hclen) {
          NEEDBITS(3);
          s->lens[PRECODE_ORDER[s->lenidx]] = hold & 7;
          DROPBITS(3);
          s->lenidx++;
        }
        if (huff_build(&s->pre, s->lens, 19, 7, 0) != 0) BAD("invalid dictionary");
        s->lenidx = 0;
        memset(s->lens, 0, sizeof(s->lens));
        s->mode = M_TABLE_LENS;
        break;
      }
      case M_TABLE_LENS: {
        int total = s->hlit + s->hdist;
        while (s->lenidx < total) {
          int32_t e;
          DECODE(s->pre, 7, e);
          if (E_FLAGS(e) != F_SYMBOL) BAD("invalid dictionary");
          int nb = E_NBITS(e);
          int sym = E_VALUE(e);
          if (sym < 16) {
            DROPBITS(nb);
            s->lens[s->lenidx++] = sym;
          } else {
            int eb = sym == 16 ? 2 : (sym == 17 ? 3 : 7);
            NEEDBITS(nb + eb);  // keep the symbol unconsumed until the
            DROPBITS(nb);       // extra bits are present (resumable)
            int rep = (sym == 16 ? 3 : (sym == 17 ? 3 : 11)) + (hold & ((1u << eb) - 1));
            DROPBITS(eb);
            if (sym == 16) {
              if (s->lenidx == 0) BAD("invalid dictionary");
              if (s->lenidx + rep > total) BAD("invalid dictionary");
              uint8_t prev = s->lens[s->lenidx - 1];
              for (int i = 0; i < rep; i++) s->lens[s->lenidx++] = prev;
            } else {
              if (s->lenidx + rep > total) BAD("invalid dictionary");
              s->lenidx += rep;
            }
          }
        }
        if (s->lens[256] == 0) BAD("invalid dictionary");
        if (huff_build(&s->lit, s->lens, s->hlit, LIT_RB, 0) != 0)
          BAD("invalid dictionary");
        if (huff_build(&s->dist, s->lens + s->hlit, s->hdist, DIST_RB, 1) != 0)
          BAD("invalid dictionary");
        fuse_tables(s);
        s->mode = M_SYM;
        break;
      }
      case M_SYM: {
        // ---- fast bulk loop (inflate_fast style): with >= 48 bits
        // buffered a whole literal or len+dist command decodes without
        // refill checks (15+5+15+13 = 48 max), and 260 output bytes
        // cover any copy. Falls through to the careful path otherwise.
        for (;;) {
          if (bits < 56) {  // careful paths can leave bits up to 64
            if (sp + 8 <= src_len) {
              // branch-free refill: one 8-byte load tops the hold up
              // to 56..63 bits; sp advances by the bytes that fully fit
              uint64_t _w; memcpy(&_w, src + sp, 8);
              hold |= _w << bits;
              sp += (63 - bits) >> 3;
              bits |= 56;
              // keep the state-machine invariant: hold is zero above
              // `bits` (stored blocks read src directly; stale
              // duplicate bits of the next byte would corrupt refills)
              hold &= ~0ull >> (64 - bits);
            } else {
              while (bits <= 56 && sp < src_len) {
                hold |= (uint64_t)src[sp++] << bits; bits += 8;
              }
            }
          }
          // 280 bytes of dst slack: the longest copy is 258 bytes and
          // the chunked copies below overshoot by up to 7.
          if (bits < 48 || dst_cap - dp < 280) break;
          uint32_t e = s->flit[hold & ((1 << LIT_RB) - 1)];
          if (__builtin_expect(e & FL_LINK, 0))
            e = s->flit[((e >> 8) & 0xffff) +
                        ((hold >> LIT_RB) & ((1u << ((e >> 4) & 15)) - 1))];
          if ((int32_t)e < 0) {
            // literal chain: >=48 bits at entry leave >=33 after one
            // 15-bit code, so two more root-resolved literals always
            // have their bits buffered (root peek LIT_RB=11, code <= 15)
            DROPBITS(e & 15);
            dst[dp++] = (uint8_t)(e >> 8);
            e = s->flit[hold & ((1 << LIT_RB) - 1)];
            if ((int32_t)e < 0) {
              DROPBITS(e & 15);
              dst[dp++] = (uint8_t)(e >> 8);
              e = s->flit[hold & ((1 << LIT_RB) - 1)];
              if ((int32_t)e < 0) {
                DROPBITS(e & 15);
                dst[dp++] = (uint8_t)(e >> 8);
                // typical literal codes are 8–9 bits, so two more often
                // still fit the refill; guard each with a bits check
                e = s->flit[hold & ((1 << LIT_RB) - 1)];
                if ((int32_t)e < 0 && (int)(e & 15) <= bits) {
                  DROPBITS(e & 15);
                  dst[dp++] = (uint8_t)(e >> 8);
                  e = s->flit[hold & ((1 << LIT_RB) - 1)];
                  if ((int32_t)e < 0 && (int)(e & 15) <= bits) {
                    DROPBITS(e & 15);
                    dst[dp++] = (uint8_t)(e >> 8);
                  }
                }
              }
            }
            continue;
          }
          if (e & FL_LEN) {
            // the extra bits sit just above the code bits in the hold;
            // one shift extracts them, one combined drop retires both
            uint32_t cb = e & 15, eb = (e >> 4) & 15;
            uint32_t len = ((e >> 8) & 0x1ff) +
                           (uint32_t)((hold >> cb) & ((1u << eb) - 1));
            DROPBITS(cb + eb);
            uint32_t d = s->fdist[hold & ((1 << DIST_RB) - 1)];
            if (__builtin_expect(d & FL_LINK, 0))
              d = s->fdist[((d >> 8) & 0xffff) +
                           ((hold >> DIST_RB) & ((1u << ((d >> 4) & 15)) - 1))];
            if (__builtin_expect(!(d & FL_LIT), 0)) BAD("invalid distance code");
            uint32_t dcb = d & 15, deb = (d >> 4) & 15;
            uint32_t dist = ((d >> 8) & 0xffff) +
                            (uint32_t)((hold >> dcb) & ((1u << deb) - 1));
            DROPBITS(dcb + deb);
            if (__builtin_expect(dist > s->win_limit, 0)) BAD("invalid distance");
            uint64_t produced = dp - dp_entry;
            if (dist <= produced) {
              // dist <= produced <= TOUT, so no history-range check needed
              uint8_t* dstp = dst + dp;
              if (dist >= 16) {
                // non-overlapping 16-byte chunks; overshoot < 16 is
                // covered by the 280-byte slack and overwritten later
                const uint8_t* srcp = dstp - dist;
                for (uint32_t k = 0; k < len; k += 16)
                  memcpy(dstp + k, srcp + k, 16);
              } else if (dist >= 8) {
                const uint8_t* srcp = dstp - dist;
                for (uint32_t k = 0; k < len; k += 8)
                  memcpy(dstp + k, srcp + k, 8);
              } else {
                // short period: seed 8 pattern bytes, then step by the
                // largest multiple of dist that fits one 8-byte chunk
                // (the chunk's tail garbage is re-written next step)
                uint32_t d8 = (8 / dist) * dist;
                uint32_t k = 0, seed = len < 8 ? len : 8;
                for (; k < seed; k++) dstp[k] = dstp[(int64_t)k - dist];
                for (; k + 8 <= len; k += d8) memcpy(dstp + k, dstp + k - d8, 8);
                for (; k < len; k++) dstp[k] = dstp[(int64_t)k - dist];
              }
              dp += len;
            } else {
              if (dist > TOUT) BAD("invalid distance");
              for (uint32_t k = 0; k < len; k++) {
                uint8_t b = (dist <= (uint64_t)(dp - dp_entry))
                    ? dst[dp - dist]
                    : s->window[(TOUT - dist) & 32767];
                OUTBYTE(b);
              }
            }
            continue;
          }
          if (e & FL_EOB) {
            DROPBITS(e & 15);
            s->mode = s->final_block ? M_DONE : M_HEAD;
            goto sym_done;
          }
          BAD("invalid literal/length");
        }
        // ---- careful path: suspendable at every read/write ----
        for (;;) {
          int32_t e;
          DECODE(s->lit, LIT_RB, e);
          if (E_FLAGS(e) != F_SYMBOL) BAD("invalid literal/length");
          int nb = E_NBITS(e);
          int sym = E_VALUE(e);
          if (sym < 256) {
            if (dp >= dst_cap) FLUSHED();
            DROPBITS(nb);
            OUTBYTE(sym);
            continue;
          }
          DROPBITS(nb);
          if (sym == 256) {
            s->mode = s->final_block ? M_DONE : M_HEAD;
            break;
          }
          if (sym > 285) BAD("invalid literal/length");
          s->sym_len = sym - 257;
          s->mode = M_LENEXTRA;
          break;
        }
        sym_done:
        break;
      }
      case M_LENEXTRA: {
        int eb = LEN_EXTRA[s->sym_len];
        NEEDBITS(eb);
        s->copy_len = LEN_BASE[s->sym_len] + (hold & ((1u << eb) - 1));
        DROPBITS(eb);
        s->mode = M_DISTSYM;
        break;
      }
      case M_DISTSYM: {
        int32_t e;
        DECODE(s->dist, DIST_RB, e);
        if (E_FLAGS(e) != F_SYMBOL) BAD("invalid distance code");
        int sym = E_VALUE(e);
        if (sym > 29) BAD("invalid distance code");
        DROPBITS(E_NBITS(e));
        s->rep_sym = sym;
        s->mode = M_DISTEXTRA;
        break;
      }
      case M_DISTEXTRA: {
        int eb = DIST_EXTRA[s->rep_sym];
        NEEDBITS(eb);
        s->copy_dist = DIST_BASE[s->rep_sym] + (hold & ((1u << eb) - 1));
        DROPBITS(eb);
        if (s->copy_dist > TOUT || s->copy_dist > s->win_limit) BAD("invalid distance");
        s->mode = M_COPY;
        break;
      }
      case M_COPY: {
        uint64_t produced = dp - dp_entry;
        if (s->copy_dist <= produced) {
          // source entirely inside this run's dst output
          uint64_t n = s->copy_len;
          uint64_t room = dst_cap - dp;
          if (n > room) n = room;
          const uint8_t* srcp = dst + dp - s->copy_dist;
          uint8_t* dstp = dst + dp;
          if (s->copy_dist >= 8) {
            uint64_t k = 0;
            for (; k + 8 <= n; k += 8) memcpy(dstp + k, srcp + k, 8);
            for (; k < n; k++) dstp[k] = srcp[k];
          } else {
            for (uint64_t k = 0; k < n; k++) dstp[k] = srcp[k];
          }
          dp += n;
          s->copy_len -= (uint32_t)n;
          if (s->copy_len > 0) FLUSHED();
        } else {
          // source (partly) in the window ring from previous runs
          while (s->copy_len > 0) {
            if (dp >= dst_cap) FLUSHED();
            uint64_t back = s->copy_dist;
            uint8_t b;
            if (back <= (uint64_t)(dp - dp_entry))
              b = dst[dp - back];
            else
              b = s->window[(TOUT - back) & 32767];
            OUTBYTE(b);
            s->copy_len--;
          }
        }
        s->mode = M_SYM;
        break;
      }
      case M_DONE: {
        // give back whole unconsumed bytes (de.ml:1459–1466).  Only
        // bytes consumed by THIS call can be returned through src_pos;
        // whole bytes buffered by earlier calls stay in the hold and
        // are retrieved via tpuz_inflate_takeback().
        while (bits >= 8 && sp > sp_entry) { bits -= 8; sp--; }
        hold &= bits >= 64 ? ~0ull : ((1ull << bits) - 1);
        SAVE();
        return TPUZ_END;
      }
      case M_BAD:
        SAVE();
        return TPUZ_MALFORMED;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LZ77 command expansion (host side of the member-parallel decoder):
// cmds are packed kind<<26 | dist<<10 | value (kind 0=literal byte,
// 1=copy of `value` bytes at `dist`, 2=end).
// ---------------------------------------------------------------------------

extern "C" int tpuz_expand_cmds(const uint32_t* cmds, uint64_t n_cmds,
                                uint8_t* out, uint64_t cap,
                                uint64_t* out_len) {
  uint64_t op = 0;
  for (uint64_t i = 0; i < n_cmds; i++) {
    uint32_t c = cmds[i];
    uint32_t kind = c >> 26;
    if (kind == 2) break;
    if (kind == 3) continue;  // NOP slot (device lane window exhausted)
    if (kind == 0) {
      if (op >= cap) return TPUZ_E_OUTPUT;
      out[op++] = (uint8_t)(c & 0x3ff);
      continue;
    }
    uint32_t len = c & 0x3ff;
    uint32_t dist = (c >> 10) & 0xffff;
    if (dist == 0 || dist > op) return TPUZ_E_DATA;
    if (op + len > cap) return TPUZ_E_OUTPUT;
    const uint8_t* src = out + op - dist;
    uint8_t* dst = out + op;
    if (dist >= 8) {
      uint32_t k = 0;
      for (; k + 8 <= len; k += 8) memcpy(dst + k, src + k, 8);
      for (; k < len; k++) dst[k] = src[k];
    } else {
      for (uint32_t k = 0; k < len; k++) dst[k] = src[k];
    }
    op += len;
  }
  *out_len = op;
  return TPUZ_OK;
}
