// Kernel 5: OCC neighbour walks of the uniqueness stage, in rank order.
//
// Replaces the while-loops of the JAX device build, which have no Pallas
// original: cammiq_tpu/index/unique_jax.py:_adjacent_count_jax (132-166,
// as occ_unique_jax calls it) and the two walks of occ_doubly_jax
// (179-226).  The XLA loops make about a dozen full-size passes for every
// step, up to 255 (unique) or 511 (doubly) steps in each direction.
//
// One thread per rank i.  It walks up (j = i + d) and then down
// (j = i - d), keeping the running min of the crossing LCP (lcp[i + d]
// going up, lcp[i - d + 1] going down), and stops at the first failing
// step, as the JAX carry `alive = ok` does:
//   unique: fails when j leaves [0, n), gsa[j] != gsa[i], or the running
//           min <= lcp0[i]; d <= 255.  occ = min(1 + up + down, 255).
//   doubly: only ranks with lcp0[i] <= ulmax and i > end_excl walk (the
//           rest give 0); fails when j leaves (end_excl - 1, n), gsa[j] is
//           neither gsa[i] nor g2[i], or the running min <= lcp0[i];
//           d <= 511.  Each passing step adds gsa[j] == gsa[i] to c1 and
//           gsa[j] == g2[i] to c2; occ = min(1 + c1, 255),
//           occ2 = min(c2, 255).
// Bound on the card: bytes.  Neighbouring threads read neighbouring
// lcp/gsa words at every step, so the loads coalesce; most walks end at
// the first or second step, and the long ones lie inside repeats.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSaturate = 255;  // index/unique.py:OCC_SATURATE

__global__ void occ_unique_kernel(const int32_t* __restrict__ lcp,
                                  const int32_t* __restrict__ lcp0,
                                  const int32_t* __restrict__ gsa,
                                  long long n, int32_t* __restrict__ occ) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t g = gsa[i];
  const int32_t th = lcp0[i];
  int cnt = 1;
  int32_t rm = INT_MAX;
  for (int d = 1; d <= kSaturate && i + d < n; ++d) {
    rm = min(rm, lcp[i + d]);
    if (gsa[i + d] != g || rm <= th) break;
    ++cnt;
  }
  rm = INT_MAX;
  for (int d = 1; d <= kSaturate && i - d >= 0; ++d) {
    rm = min(rm, lcp[i - d + 1]);
    if (gsa[i - d] != g || rm <= th) break;
    ++cnt;
  }
  occ[i] = min(cnt, kSaturate);
}

__global__ void occ_doubly_kernel(const int32_t* __restrict__ lcp,
                                  const int32_t* __restrict__ lcp0,
                                  const int32_t* __restrict__ gsa,
                                  const int32_t* __restrict__ g2,
                                  long long n, long long end_excl, int ulmax,
                                  int32_t* __restrict__ occ,
                                  int32_t* __restrict__ occ2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t th = lcp0[i];
  if (!(th <= ulmax && i > end_excl)) {
    occ[i] = 0;
    occ2[i] = 0;
    return;
  }
  const int32_t g = gsa[i];
  const int32_t h = g2[i];
  int c1 = 0, c2 = 0;
  int32_t rm = INT_MAX;
  for (int d = 1; d <= 2 * kSaturate + 1 && i + d < n; ++d) {
    const int32_t gj = gsa[i + d];
    if (gj != g && gj != h) break;
    rm = min(rm, lcp[i + d]);
    if (rm <= th) break;
    c1 += gj == g;
    c2 += gj == h;
  }
  rm = INT_MAX;
  for (int d = 1; d <= 2 * kSaturate + 1 && i - d >= end_excl; ++d) {
    const int32_t gj = gsa[i - d];
    if (gj != g && gj != h) break;
    rm = min(rm, lcp[i - d + 1]);
    if (rm <= th) break;
    c1 += gj == g;
    c2 += gj == h;
  }
  occ[i] = min(1 + c1, kSaturate);
  occ2[i] = min(c2, kSaturate);
}

}  // namespace

// lcp: int32 [n+1]; lcp0, gsa: int32 [n]; g2: int32 [n] (rank order) for
// the doubly walk or null for the unique one; occ (and occ2 when doubly):
// int32 [n] in rank order.
extern "C" int cammiq_occ_count(const void* lcp, const void* lcp0,
                                const void* gsa, const void* g2, long long n,
                                long long end_excl, int ulmax, void* occ,
                                void* occ2, void* stream) {
  if (n <= 0) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (g2 == nullptr) {
    occ_unique_kernel<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)lcp, (const int32_t*)lcp0, (const int32_t*)gsa, n,
        (int32_t*)occ);
  } else {
    occ_doubly_kernel<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)lcp, (const int32_t*)lcp0, (const int32_t*)gsa,
        (const int32_t*)g2, n, end_excl, ulmax, (int32_t*)occ,
        (int32_t*)occ2);
  }
  return (int)cudaGetLastError();
}
