// The read upload at 2 bits a base: a host packer that writes a batch into
// its pinned ring buffer, and the kernel `unpack_reads` that turns it back
// into the int8 codes and int32 lengths the query kernels take.
//
// Replaces no TPU kernel: the JAX session hands XLA its int8 batch as it
// is.  On the card a batch of 65,536 reads of 100 bases crossed the link as
// 104 B a read (the int8 codes and an int32 length, two copies) at 40-47
// GB/s, the largest device operation of a sample.  Every value is a 2-bit
// code (both parsers replace N by a random base), so a read can travel as
// ceil(Lp / 4) bytes of codes and a 2-byte length: 27 B at Lp 100.
//
// A packed batch of B reads of Lp bases, one buffer and one copy:
//   bytes [0, B * P)        the codes, P = ceil(Lp / 4) bytes a read,
//                           row-major: base j in bits 2 (j % 4) of byte
//                           j / 4, the spare bits of a row's last byte zero
//   bytes [B * P, off)      zero (off = B * P rounded up to 16)
//   bytes [off, off + 2 B)  the lengths, uint16
//
// Host: cammiq_pack_reads reads the source rows in place, at any row
// stride, ORs together every code byte's bits above the low two and every
// length's bits above the low sixteen, and says whether the batch packs; a
// batch that holds a code outside 0..3 (the JAX tests' -1) goes up
// unpacked.  AVX2 where the CPU has it (128 bases a step: two multiply-adds
// fold four codes into a byte), a scalar loop elsewhere and for each row's
// last Lp % 32 bases; rows that lie back to back, Lp a multiple of 4, pack
// as one stream.  Bound: reading the source, B * Lp bytes, at the host's
// memory rate, as the int8 copy it replaces; one thread, since more threads
// only contend for that rate and for cores the host shares.
//
// Device: one thread a packed byte, its four codes in one 32-bit store
// where Lp is a multiple of 4; a warp reads 32 adjacent bytes and writes
// 128.  Bound: 27 B read and 104 B written a read at Lp 100, 8.6 MB a
// batch of 65,536: 2.6 us at 3.35 TB/s, about the launch's own cost.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>
// the AVX2 path in the host pass only: the device pass never sees it
#if defined(__x86_64__) && !defined(__CUDA_ARCH__)
#define CAMMIQ_AVX2 1
#include <immintrin.h>
#endif

namespace {

constexpr int kThreads = 256;

struct Packed {
  int P;            // bytes a read
  long long off;    // the lengths' offset
  long long bytes;  // the whole buffer
  Packed(int B, int Lp) {
    P = (Lp + 3) / 4;
    off = ((long long)B * P + 15) / 16 * 16;
    bytes = off + 2LL * B;
  }
};

// Bases [j, Lp) of one row, j a multiple of 4, into d[j / 4 ...]; returns
// the OR of their bytes.  A multiply gathers a word's four codes: base t of
// the word, at bit 8t, lands at bit 18 + 2t of w * 0x41041, and no other
// partial product reaches bits 18-25.
inline uint32_t pack_span(const uint8_t* s, long long j, long long Lp,
                          uint8_t* d) {
  uint32_t acc = 0;
  for (; j + 4 <= Lp; j += 4) {
    uint32_t w;
    std::memcpy(&w, s + j, 4);
    acc |= w;
    d[j >> 2] = (uint8_t)(((uint64_t)(w & 0x03030303u) * 0x41041u) >> 18);
  }
  if (j < Lp) {
    uint32_t b = 0;
    for (long long t = 0; j + t < Lp; ++t) {
      acc |= s[j + t];
      b |= (s[j + t] & 3u) << (2 * t);
    }
    d[j >> 2] = (uint8_t)b;
  }
  return acc;
}

// B rows; true where every code byte is in 0..3.  Rows back to back with
// Lp a multiple of 4 pack as one stream: their packed rows are too.
bool pack_rows_scalar(const uint8_t* src, long long stride, int Lp, int P,
                      int B, uint8_t* dst) {
  uint32_t acc = 0;
  if (stride == Lp && (Lp & 3) == 0)
    acc = pack_span(src, 0, (long long)B * Lp, dst);
  else
    for (int r = 0; r < B; ++r)
      acc |= pack_span(src + r * stride, 0, Lp, dst + (long long)r * P);
  return (acc & 0xFCFCFCFCu) == 0;
}

#ifdef CAMMIQ_AVX2
// int32 lane k: the packed byte of bytes 4k..4k+3 of v, (c0 + 4 c1) +
// 16 (c2 + 4 c3) by two multiply-adds
__attribute__((target("avx2"))) inline __m256i fold4(__m256i v) {
  return _mm256_madd_epi16(_mm256_maddubs_epi16(v, _mm256_set1_epi16(0x0401)),
                           _mm256_set1_epi32(0x00100001));
}

// Bytes [0, n) of s into d[0, ceil(n / 4)), their OR into acc and tail:
// 128 bytes a step into one 32-byte store, then 32 into 8, then pack_span.
__attribute__((target("avx2"))) inline void pack_span_avx2(
    const uint8_t* s, long long n, uint8_t* d, __m256i& acc, uint32_t& tail) {
  // packus interleaves the 128-bit lanes: dword k of the result belongs at
  // position order[k]
  const __m256i order = _mm256_setr_epi32(0, 4, 1, 5, 2, 6, 3, 7);
  // byte 0 of each int32 into the low 4 bytes of its 128-bit lane
  const __m256i pick = _mm256_setr_epi8(
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
  long long j = 0;
  for (; j + 128 <= n; j += 128) {
    const __m256i v0 = _mm256_loadu_si256((const __m256i*)(s + j));
    const __m256i v1 = _mm256_loadu_si256((const __m256i*)(s + j + 32));
    const __m256i v2 = _mm256_loadu_si256((const __m256i*)(s + j + 64));
    const __m256i v3 = _mm256_loadu_si256((const __m256i*)(s + j + 96));
    acc = _mm256_or_si256(acc, _mm256_or_si256(_mm256_or_si256(v0, v1),
                                               _mm256_or_si256(v2, v3)));
    const __m256i lo = _mm256_packus_epi32(fold4(v0), fold4(v1));
    const __m256i hi = _mm256_packus_epi32(fold4(v2), fold4(v3));
    _mm256_storeu_si256(
        (__m256i*)(d + (j >> 2)),
        _mm256_permutevar8x32_epi32(_mm256_packus_epi16(lo, hi), order));
  }
  for (; j + 32 <= n; j += 32) {
    const __m256i v = _mm256_loadu_si256((const __m256i*)(s + j));
    acc = _mm256_or_si256(acc, v);
    const __m256i t = _mm256_shuffle_epi8(fold4(v), pick);
    const uint64_t w = (uint32_t)_mm256_cvtsi256_si32(t) |
                       (uint64_t)(uint32_t)_mm256_extract_epi32(t, 4) << 32;
    std::memcpy(d + (j >> 2), &w, 8);
  }
  tail |= pack_span(s, j, n, d);
}

__attribute__((target("avx2"))) bool pack_rows_avx2(
    const uint8_t* src, long long stride, int Lp, int P, int B, uint8_t* dst) {
  __m256i acc = _mm256_setzero_si256();
  uint32_t tail = 0;
  if (stride == Lp && (Lp & 3) == 0)
    pack_span_avx2(src, (long long)B * Lp, dst, acc, tail);
  else
    for (int r = 0; r < B; ++r)
      pack_span_avx2(src + r * stride, Lp, dst + (long long)r * P, acc, tail);
  return _mm256_testz_si256(acc, _mm256_set1_epi8((char)0xFC)) &&
         (tail & 0xFCFCFCFCu) == 0;
}

bool has_avx2() {
  static const bool yes = __builtin_cpu_supports("avx2");
  return yes;
}
#endif

// One packed byte a thread: its four codes into one 32-bit store where Lp
// is a multiple of 4 (every row then starts 4-byte aligned), four byte
// stores elsewhere; threads t < B also copy length t.
__global__ void __launch_bounds__(kThreads)
unpack_reads_kernel(const uint8_t* __restrict__ packed,
                    const uint16_t* __restrict__ lens16, int B, int Lp, int P,
                    int8_t* __restrict__ codes, int32_t* __restrict__ lengths) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t < (unsigned)B) lengths[t] = lens16[t];
  if (t >= (unsigned)B * (unsigned)P) return;
  const unsigned b = t / (unsigned)P;
  const unsigned q = t - b * (unsigned)P;
  const uint32_t x = __ldg(packed + t);
  // code k of the byte into byte k of the word
  const uint32_t w = (x & 3u) | ((x << 6) & 0x300u) | ((x << 12) & 0x30000u) |
                     ((x << 18) & 0x3000000u);
  int8_t* out = codes + (size_t)b * Lp + 4 * q;
  if ((Lp & 3) == 0) {
    *reinterpret_cast<uint32_t*>(out) = w;
  } else {
    const int n = Lp - 4 * (int)q < 4 ? Lp - 4 * (int)q : 4;
    for (int k = 0; k < n; ++k) out[k] = (int8_t)(w >> (8 * k));
  }
}

int pack_reads(const void* codes, long long row_stride, int B, int Lp,
               const void* lengths, void* out, bool simd) {
  const Packed L(B, Lp);
  const auto* src = (const uint8_t*)codes;
  auto* dst = (uint8_t*)out;
  std::memset(dst + (long long)B * L.P, 0, L.off - (long long)B * L.P);
#ifdef CAMMIQ_AVX2
  const bool ok = simd && has_avx2()
                      ? pack_rows_avx2(src, row_stride, Lp, L.P, B, dst)
                      : pack_rows_scalar(src, row_stride, Lp, L.P, B, dst);
#else
  (void)simd;
  const bool ok = pack_rows_scalar(src, row_stride, Lp, L.P, B, dst);
#endif
  const auto* len = (const int32_t*)lengths;
  auto* lens = (uint16_t*)(dst + L.off);
  uint32_t high = 0;
  for (int r = 0; r < B; ++r) {
    const uint32_t l = (uint32_t)len[r];
    high |= l;
    lens[r] = (uint16_t)l;
  }
  return ok && (high >> 16) == 0;
}

}  // namespace

// codes: B rows of Lp int8 at `row_stride` bytes; lengths int32 [B]; out:
// the packed batch, Packed(B, Lp).bytes bytes.  Returns 1 where the batch
// packed, 0 where a code lies outside 0..3 or a length outside 0..65535
// (what `out` then holds is unspecified).  Host memory only; no CUDA call.
extern "C" int cammiq_pack_reads(const void* codes, long long row_stride,
                                 int B, int Lp, const void* lengths,
                                 void* out) {
  return pack_reads(codes, row_stride, B, Lp, lengths, out, true);
}

// The same with the scalar loop alone, whatever the CPU has: for tests.
extern "C" int cammiq_pack_reads_scalar(const void* codes,
                                        long long row_stride, int B, int Lp,
                                        const void* lengths, void* out) {
  return pack_reads(codes, row_stride, B, Lp, lengths, out, false);
}

// packed: Packed(B, Lp).bytes bytes on the device, as cammiq_pack_reads
// wrote them; codes int8 [B, Lp] (16-byte aligned), lengths int32 [B].
extern "C" int cammiq_unpack_reads(const void* packed, int B, int Lp,
                                   void* codes, void* lengths, void* stream) {
  if (B <= 0) return 0;
  const Packed L(B, Lp);
  const long long work = (long long)B * (L.P > 1 ? L.P : 1);
  const int blocks = (int)((work + kThreads - 1) / kThreads);
  const auto* base = (const uint8_t*)packed;
  unpack_reads_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      base, (const uint16_t*)(base + L.off), B, Lp, L.P, (int8_t*)codes,
      (int32_t*)lengths);
  return (int)cudaGetLastError();
}
