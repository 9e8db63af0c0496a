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
// The work is the sum of the LCPs, not n.  In random text most LCPs are
// short (about log4 n = 15 bytes), but inside repeats shared by many
// genomes they run to thousands of bytes, and one thread per pair walking
// 8 bytes a step leaves its warp waiting for its longest pair, each step a
// 32-byte sector read for 8 useful bytes.  So one call runs two phases,
// with no host sync between them:
//   1. short, one thread per pair: compare at most 32 bytes (4 aligned
//      64-bit loads per suffix, funnel-shifted by the suffix's fixed
//      misalignment; the first differing byte is __ffsll of the XOR / 8).
//      Finished pairs write their LCP; the rest are appended to a device
//      worklist, the slot taken by one atomicAdd per warp;
//   2. long, one warp per pair: a persistent grid claims 32 pairs at a
//      time from the worklist through an atomic cursor (its length is read
//      on the device), each lane fetching one pair's rank and suffixes.
//      Each lane loads one aligned word of each suffix at consecutive
//      offsets - 256 bytes a step, two steps per iteration, coalesced -
//      takes the next word from its neighbour lane (__shfl_down_sync) for
//      the funnel shift, and __ballot_sync of the differing lanes gives
//      the first mismatching word (__ffs) and byte (__ffsll).
// Both stop at min(clamp, n - max(a, b)).  The wrapper pads the text to
// whole words plus 66, so no load leaves the buffer.
// Bound on the card: bytes at full n - the text, sa and out once each
// (5.4 GB at n = 6e8).  What holds both phases far above it is access, not
// volume: in rank order every suffix starts at a random text position, so
// the thread phase reads a 32-byte sector or two per suffix for ~15 useful
// bytes, and the warp phase walks each repeat copy once per pair.  The
// permuted-LCP (Phi array) order, which reads one suffix of each pair in
// text order and does O(n) work in all, is the next design (ROADMAP queue
// 2 (j)).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShortWords = 4;          // phase 1 compares 32 bytes
constexpr int kShortBytes = 8 * kShortWords;
constexpr int kWarpsPerSm = 64;         // phase 2's persistent grid
constexpr int kClaim = 32;              // worklist entries per claim

// 8 text bytes starting at byte `p` of a stream whose aligned word at p
// is `lo` and the next one `hi`; `sh` = 8 * (p & 7).
__device__ __forceinline__ uint64_t window(uint64_t lo, uint64_t hi, int sh) {
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

__global__ void __launch_bounds__(kThreads)
lcp_short_kernel(const uint64_t* __restrict__ words, long long n,
                 const int32_t* __restrict__ sa, long long m, int clamp,
                 int32_t* __restrict__ out, int32_t* __restrict__ work,
                 int* __restrict__ work_len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool push = false;
  if (i == 0 || i == m) {
    out[i] = 0;
  } else if (i < m) {
    const long long a = sa[i];
    const long long b = sa[i - 1];
    long long lim = n - (a > b ? a : b);
    if (lim > clamp) lim = clamp;
    long long qa = a >> 3, qb = b >> 3;
    const int sha = (int)(a & 7) * 8, shb = (int)(b & 7) * 8;
    uint64_t wa = words[qa], wb = words[qb];
    long long l = 0;
    bool done = false;
#pragma unroll
    for (int s = 0; s < kShortWords; ++s) {
      if (l >= lim) break;
      const uint64_t na = words[++qa];
      const uint64_t nb = words[++qb];
      const uint64_t x = window(wa, na, sha) ^ window(wb, nb, shb);
      if (x) {
        l += (__ffsll((long long)x) - 1) >> 3;
        done = true;
        break;
      }
      l += 8;
      wa = na;
      wb = nb;
    }
    if (done || l >= lim) {
      out[i] = (int32_t)(l < lim ? l : lim);
    } else {
      push = true;
    }
  }
  // warp-aggregated append: one atomicAdd per warp
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, push);
  if (ballot) {
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(work_len, __popc(ballot));
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    if (push) work[base + __popc(ballot & ((1u << lane) - 1u))] = (int32_t)i;
  }
}

// 8 bytes of each of the two suffixes at lane `lane`'s place in a 256-byte
// step starting at word q: the lane's word and its neighbour's (lane 31
// takes `next`, the first word of the following step, or loads it).
__device__ __forceinline__ uint64_t step_xor(uint64_t la, uint64_t lb,
                                             uint64_t na, uint64_t nb,
                                             int sha, int shb) {
  uint64_t ha = __shfl_down_sync(0xFFFFFFFFu, la, 1);
  uint64_t hb = __shfl_down_sync(0xFFFFFFFFu, lb, 1);
  if ((threadIdx.x & 31) == 31) {
    ha = na;
    hb = nb;
  }
  return window(la, ha, sha) ^ window(lb, hb, shb);
}

__global__ void __launch_bounds__(kThreads)
lcp_long_kernel(const uint64_t* __restrict__ words, long long n,
                const int32_t* __restrict__ sa, int clamp,
                int32_t* __restrict__ out, const int32_t* __restrict__ work,
                const int* __restrict__ work_len, int* __restrict__ cursor) {
  const int lane = threadIdx.x & 31;
  const int len = *work_len;
  for (;;) {
    // claim kClaim worklist entries; lane j fetches entry j's rank and
    // suffixes, so the chain cursor -> rank -> suffix is paid per claim
    int base = 0;
    if (lane == 0) base = atomicAdd(cursor, kClaim);
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    if (base >= len) return;
    const int cnt = min(kClaim, len - base);
    long long my_i = 0, my_a = 0, my_b = 0, my_res = 0;
    if (lane < cnt) {
      my_i = work[base + lane];
      my_a = sa[my_i];
      my_b = sa[my_i - 1];
    }
    for (int k = 0; k < cnt; ++k) {
      const long long a = __shfl_sync(0xFFFFFFFFu, my_a, k);
      const long long b = __shfl_sync(0xFFFFFFFFu, my_b, k);
      long long lim = n - (a > b ? a : b);
      if (lim > clamp) lim = clamp;
      // l stays a multiple of 8 past a and b, so the shifts are fixed
      const int sha = (int)(a & 7) * 8, shb = (int)(b & 7) * 8;
      long long res = lim;
      // two 256-byte steps per iteration, all four loads issued together
      for (long long l = kShortBytes; l < lim; l += 512) {
        const long long qa = (a + l) >> 3, qb = (b + l) >> 3;
        const uint64_t la0 = words[qa + lane], lb0 = words[qb + lane];
        const uint64_t la1 = words[qa + 32 + lane], lb1 = words[qb + 32 + lane];
        uint64_t na1 = 0, nb1 = 0;
        if (lane == 31) {
          na1 = words[qa + 64];
          nb1 = words[qb + 64];
        }
        const uint64_t x0 = step_xor(la0, lb0, __shfl_sync(0xFFFFFFFFu, la1, 0),
                                     __shfl_sync(0xFFFFFFFFu, lb1, 0), sha, shb);
        const uint64_t x1 = step_xor(la1, lb1, na1, nb1, sha, shb);
        const unsigned d0 = __ballot_sync(0xFFFFFFFFu, x0 != 0);
        const unsigned d1 = __ballot_sync(0xFFFFFFFFu, x1 != 0);
        if (d0 | d1) {
          const int f = d0 ? __ffs(d0) - 1 : __ffs(d1) - 1;
          const uint64_t xf = __shfl_sync(0xFFFFFFFFu, d0 ? x0 : x1, f);
          const long long d = l + (d0 ? 0 : 256) + 8LL * f +
                              ((__ffsll((long long)xf) - 1) >> 3);
          res = d < lim ? d : lim;
          break;
        }
      }
      if (lane == k) my_res = res;
    }
    if (lane < cnt) out[my_i] = (int32_t)my_res;
  }
}

}  // namespace

// words: the text as uint64 words, padded to (n + 7) / 8 + 66 words (the
// long phase reads up to 65 words past a position < n); sa:
// int32 [m] ranks (any contiguous run of a suffix array); out: int32
// [m + 1]; work: int32 [m + 2], the worklist, then its length and cursor.
extern "C" int cammiq_lcp_pairs(const void* words, long long n, const void* sa,
                                long long m, int clamp, void* out, void* work,
                                void* stream) {
  if (m < 0 || n < 0 || clamp < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* wl = (int32_t*)work;
  int* counters = (int*)(wl + m);  // [length, cursor]
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (m + 1 + kThreads - 1) / kThreads;
  lcp_short_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const uint64_t*)words, n, (const int32_t*)sa, m, clamp, (int32_t*)out,
      wl, counters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int long_blocks = sms * kWarpsPerSm * 32 / kThreads;
  lcp_long_kernel<<<long_blocks, kThreads, 0, s>>>(
      (const uint64_t*)words, n, (const int32_t*)sa, clamp, (int32_t*)out, wl,
      counters, counters + 1);
  return (int)cudaGetLastError();
}
