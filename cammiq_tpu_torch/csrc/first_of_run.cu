// Kernel 1: first-of-run segmented scan.
//
// Replaces the Pallas kernel benchmarks/pallas_repro.py:first_of_run_scan_pallas
// (the one Pallas kernel this code base wrote) and its XLA twin
// query/sortjoin.py:_first_of_run_scan, whose semantics it follows:
//   out_k[i] = values_k[j] for the last j <= i with is_start[j],
//   and values_k[0] when no start precedes i.
// Equivalently out_k[i] = values_k[idx[i]] with idx the inclusive prefix max
// of (is_start[j] ? j : 0): the segmented scan becomes a max-scan of
// indices plus a gather, for any number of value arrays (nv <= 4).
//
// The TPU kernel walked its grid in order and carried (last value, seen)
// in SMEM from one block to the next.  Hopper blocks run in parallel, so
// three simple passes take its place:
//   1. local: each block scans its tile (2048 elements), writes the output
//      of every element that has a start before it inside the tile, and
//      emits the tile's summary (first and last start index, or none);
//   2. summaries: one block scans the per-tile last-start indices into the
//      carry index of every tile (exclusive prefix max, 0 when none);
//   3. fix-up: each tile fills its leading run (elements before its first
//      start) from values_k[carry].
// Bound on the card: bytes - one read of is_start and nv reads + writes of
// int32 per element, plus the value gathers (sequential within a run).
// Decoupled look-back (one pass) is queued.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxValues = 4;
constexpr int kScanThreads = 1024;

struct Arrays {
  const int32_t* v[kMaxValues];
  int32_t* o[kMaxValues];
};

// Exclusive prefix max over the block (identity -1); *total gets the
// block-wide max.  All threads of the block must call it.
__device__ int block_exclusive_max(int x, int* total) {
  __shared__ int warp_max[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc = max(inc, y);
  }
  int excl = __shfl_up_sync(0xFFFFFFFFu, inc, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) warp_max[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_max[lane] : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w = max(w, y);
    }
    warp_max[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int result = max(excl, warp > 0 ? warp_max[warp - 1] : -1);
  *total = warp_max[nwarps - 1];
  __syncthreads();  // warp_max is reused by the next call
  return result;
}

__global__ void local_scan_kernel(const uint8_t* __restrict__ is_start,
                                  int n, int nv, Arrays a,
                                  int* __restrict__ tile_first,
                                  int* __restrict__ tile_last) {
  __shared__ int first_start;
  if (threadIdx.x == 0) first_start = INT_MAX;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  int loc[kItems];
  int run = -1;
  int mine_first = INT_MAX;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < n && is_start[i]) {
      run = (int)i;
      mine_first = min(mine_first, (int)i);
    }
    loc[k] = run;
  }
  if (mine_first != INT_MAX) atomicMin(&first_start, mine_first);
  int total;
  const int before = block_exclusive_max(run, &total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    const int idx = max(loc[k], before);
    if (i < n && idx >= 0) {
      for (int v = 0; v < nv; ++v) a.o[v][i] = a.v[v][idx];
    }
  }
  if (threadIdx.x == 0) {
    tile_first[blockIdx.x] = first_start;  // synced inside the block scan
    tile_last[blockIdx.x] = total;
  }
}

__global__ void summary_scan_kernel(const int* __restrict__ tile_last,
                                    int ntiles, int* __restrict__ carry) {
  int running = -1;
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const int x = j < ntiles ? tile_last[j] : -1;
    int total;
    const int excl = block_exclusive_max(x, &total);
    if (j < ntiles) {
      const int c = max(running, excl);
      carry[j] = c < 0 ? 0 : c;
    }
    running = max(running, total);
  }
}

__global__ void fixup_kernel(int n, int nv, Arrays a,
                             const int* __restrict__ tile_first,
                             const int* __restrict__ carry) {
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long end = min((long long)tile_first[blockIdx.x],
                            min(t0 + kTile, (long long)n));
  const int c = carry[blockIdx.x];
  for (long long i = t0 + threadIdx.x; i < end; i += blockDim.x) {
    for (int v = 0; v < nv; ++v) a.o[v][i] = a.v[v][c];
  }
}

}  // namespace

extern "C" int cammiq_first_of_run_tile() { return kTile; }

extern "C" int cammiq_first_of_run(const void* is_start, int n, int nv,
                                   const void* v0, const void* v1,
                                   const void* v2, const void* v3, void* o0,
                                   void* o1, void* o2, void* o3,
                                   void* tile_first, void* tile_last,
                                   void* carry, void* stream) {
  if (nv < 1 || nv > kMaxValues) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Arrays a;
  const void* vs[kMaxValues] = {v0, v1, v2, v3};
  void* os[kMaxValues] = {o0, o1, o2, o3};
  for (int k = 0; k < kMaxValues; ++k) {
    a.v[k] = (const int32_t*)vs[k];
    a.o[k] = (int32_t*)os[k];
  }
  const int ntiles = (n + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  local_scan_kernel<<<ntiles, kThreads, 0, s>>>(
      (const uint8_t*)is_start, n, nv, a, (int*)tile_first, (int*)tile_last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  summary_scan_kernel<<<1, kScanThreads, 0, s>>>((const int*)tile_last, ntiles,
                                                 (int*)carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fixup_kernel<<<ntiles, kThreads, 0, s>>>(n, nv, a, (const int*)tile_first,
                                           (const int*)carry);
  return (int)cudaGetLastError();
}
