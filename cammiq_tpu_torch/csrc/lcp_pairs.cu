// Kernel 4: LCP of suffix-array neighbours, clamped.
//
// Replaces the blockwise adjacent-suffix compare of the JAX device build,
// cammiq_tpu/ops/lcp.py:lcp_jax (called with max_lcp = LCP_CLAMP = 65535 by
// index/builder.py:69-71), whose semantics it follows:
//   out[i] = min(lcp(text[sa[i-1]:], text[sa[i]:]), clamp) for 0 < i < m,
//   out[0] = out[m] = 0, and positions at or past n never match.
// There is no Pallas original: the XLA version materialises [n, 64] gathers
// per round, about 300 GB of int64 indices at n = 6e8.
//
// One thread per adjacent pair.  Each thread walks both suffixes 8 bytes
// at a time: one aligned 64-bit load per suffix and step, funnel-shifted
// with the previous word (the shift is fixed for the whole walk), and the
// first differing byte is __ffsll of the XOR / 8 (little-endian).  The
// text is padded by the wrapper to whole words plus two, so no load leaves
// the buffer; the walk stops at min(clamp, n - max(a, b)) bytes.
// Bound on the card: the work is the sum of the LCPs / 8 dependent loads
// per thread, not n; a warp runs as long as its longest LCP (thousands of
// bytes inside repeats shared by many genomes), so it is latency-bound
// there and byte-bound elsewhere.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 8 text bytes starting at byte `p` of a stream whose previous aligned word
// was `lo`; `sh` = 8 * (p & 7) stays constant while p advances by 8.
__device__ __forceinline__ uint64_t window(uint64_t lo, uint64_t hi, int sh) {
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

__global__ void lcp_pairs_kernel(const uint64_t* __restrict__ words,
                                 long long n, const int32_t* __restrict__ sa,
                                 long long m, int clamp,
                                 int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > m) return;
  if (i == 0 || i == m) {
    out[i] = 0;
    return;
  }
  const long long a = sa[i];
  const long long b = sa[i - 1];
  long long lim = n - (a > b ? a : b);
  if (lim > clamp) lim = clamp;
  long long qa = a >> 3, qb = b >> 3;
  const int sa_sh = (int)(a & 7) * 8, sb_sh = (int)(b & 7) * 8;
  uint64_t wa = words[qa], wb = words[qb];
  long long l = 0;
  while (l < lim) {
    const uint64_t na = words[++qa];
    const uint64_t nb = words[++qb];
    const uint64_t x = window(wa, na, sa_sh) ^ window(wb, nb, sb_sh);
    if (x) {
      l += (__ffsll((long long)x) - 1) >> 3;
      break;
    }
    l += 8;
    wa = na;
    wb = nb;
  }
  out[i] = (int32_t)(l < lim ? l : lim);
}

}  // namespace

// words: the text as uint64 words, padded to (n + 7) / 8 + 2 words; sa:
// int32 [m] ranks (any contiguous run of a suffix array); out: int32 [m+1].
extern "C" int cammiq_lcp_pairs(const void* words, long long n, const void* sa,
                                long long m, int clamp, void* out,
                                void* stream) {
  if (m < 0 || n < 0 || clamp < 0) return (int)cudaErrorInvalidValue;
  const long long threads = m + 1;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  lcp_pairs_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)words, n, (const int32_t*)sa, m, clamp,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
