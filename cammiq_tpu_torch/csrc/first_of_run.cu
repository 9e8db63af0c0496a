// Kernel 1: first-of-run segmented scan, one pass with decoupled look-back.
//
// Replaces the Pallas kernel benchmarks/pallas_repro.py:first_of_run_scan_pallas
// (the one Pallas kernel this code base wrote) and its XLA twin
// query/sortjoin.py:_first_of_run_scan, whose semantics it follows:
//   forward: idx[i] = the last j <= i with is_start[j], 0 when none;
//   reverse: idx[i] = the first j >= i with is_start[j], n - 1 when none;
// and out_k[i] = values_k[idx[i]] for nv = 1..4 value arrays, or, with
// nv = 0 (index mode), idx itself.  Forward, value mode is the twin's
// scan (values_k[0] before the first start); the build's run bounds are
// index mode, forward and reverse, with no value array read.
//
// The TPU kernel walked its grid in order and carried (last value, seen)
// from one block to the next.  Hopper blocks run in parallel, so the carry
// crosses tiles by decoupled look-back (Merrill and Garland, 2016):
//   - each block takes its tile from an atomic counter, so every tile it
//     waits on has already started (forward progress);
//   - the scan is a max-scan of a key q (q = i forward, n - 1 - i reverse,
//     so the reverse scan is the forward one over mirrored positions);
//   - a tile that holds a start knows its inclusive prefix at once (its
//     own last start) and publishes it; a tile with none publishes
//     "aggregate" and, after its look-back, its prefix.  Each status is one
//     64-bit word: state in bits 32-33, q + 1 in the low 32 bits;
//   - one warp looks back over 32 predecessors at a time for the nearest
//     published prefix, waiting only while a nearer tile has not
//     published (tiles with no start contribute nothing to a max); the
//     look-back and the status words are cammiq_common.cuh's, which the
//     probe compaction shares.
// Memory access: each thread reads its 16 flags with one 16-byte load;
// results go through shared memory (swizzled, conflict-free) from the
// blocked layout to a striped one, so every store is a coalesced int4.
// The status words and tile counter are zeroed by one memset on the
// stream before the launch (no kernel).
// Bound on the card: bytes - index mode reads 1 byte and writes 4 per
// element (the build's run bounds at n = 6e8: 3.0 GB for both directions),
// value mode adds nv reads and writes of int32.
#include "cammiq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // flags per thread: one 16-byte load
constexpr int kTile = kThreads * kItems;
constexpr int kMaxValues = 4;

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

// physical int4 slot of logical slot 4 * c + r (chunk c, quarter r): rows of
// 8 slots then never hold two slots of one store or one load instruction
__device__ __forceinline__ int swizzle(int c, int r) {
  return 4 * c + (r ^ ((c >> 1) & 3));
}

template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
first_of_run_kernel(const uint8_t* __restrict__ flags, int n, int ntiles,
                    int nv, Arrays a, int32_t* __restrict__ idx_out,
                    unsigned long long* __restrict__ status,
                    unsigned* __restrict__ counter) {
  __shared__ int s_tile;
  __shared__ int s_carry;
  __shared__ __align__(16) int s_idx[kTile];
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int t = s_tile;                             // processing order
  const int tile = kReverse ? ntiles - 1 - t : t;   // tile in memory
  // chunk of this thread; threads run in processing order
  const int c = kReverse ? kThreads - 1 - (int)threadIdx.x : (int)threadIdx.x;
  const long long t0 = (long long)tile * kTile;
  const long long i0 = t0 + (long long)c * kItems;

  uint8_t f[kItems];
  if (i0 + kItems <= n && (reinterpret_cast<uintptr_t>(flags) & 15) == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(flags + i0);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < kItems; ++j) f[j] = (ws[j >> 2] >> (8 * (j & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) f[j] = i0 + j < n ? flags[i0 + j] : 0;
  }
  // running max of q over this thread's items, in processing order
  int loc[kItems];
  int run = -1;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int j = kReverse ? kItems - 1 - s : s;
    if (f[j]) run = kReverse ? (int)(n - 1 - (i0 + j)) : (int)(i0 + j);
    loc[j] = run;
  }
  int total;
  const int before = block_exclusive_max(run, &total);

  // statuses carry q + 1, so a tile with no start publishes 0, the
  // identity of the max
  if (threadIdx.x == 0) {  // publish before looking back
    if (t == 0 || total >= 0) {
      store_status(status + t, kStatePrefix, (unsigned)(total + 1));
    } else {
      store_status(status + t, kStateAggregate, 0u);
    }
  }
  if (threadIdx.x < 32) {
    const int carry = t > 0 ? (int)look_back(status, t, 0u, MaxOp()) - 1 : -1;
    if (threadIdx.x == 0) {
      s_carry = carry;
      if (t > 0 && total < 0)
        store_status(status + t, kStatePrefix, (unsigned)(carry + 1));
    }
  }
  __syncthreads();
  const int pre = max(before, s_carry);

  int4* s4 = reinterpret_cast<int4*>(s_idx);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = max(max(loc[4 * r + e], pre), 0);
      x[e] = kReverse ? n - 1 - q : q;
    }
    s4[swizzle(c, r)] = make_int4(x[0], x[1], x[2], x[3]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    const int m = threadIdx.x + k * kThreads;  // logical int4 slot, striped
    const int4 v = s4[swizzle(m >> 2, m & 3)];
    const long long i = t0 + 4LL * m;
    const int ix[4] = {v.x, v.y, v.z, v.w};
    if (i + 4 <= n) {
      if (nv == 0) *reinterpret_cast<int4*>(idx_out + i) = v;
#pragma unroll
      for (int u = 0; u < kMaxValues; ++u) {
        if (u < nv) {
          const int32_t* src = a.v[u];
          *reinterpret_cast<int4*>(a.o[u] + i) =
              make_int4(src[ix[0]], src[ix[1]], src[ix[2]], src[ix[3]]);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e >= n) break;
        if (nv == 0) idx_out[i + e] = ix[e];
#pragma unroll
        for (int u = 0; u < kMaxValues; ++u) {
          if (u < nv) a.o[u][i + e] = a.v[u][ix[e]];
        }
      }
    }
  }
}

}  // namespace

extern "C" int cammiq_first_of_run_tile() { return kTile; }

// is_start: bool [n]; nv value arrays v0..v3 (int32 [n]) and outputs
// o0..o3, or, with nv = 0, the index output idx (int32 [n]); scratch: 8 *
// (ceil(n / tile) + 1) bytes for the tile statuses and the tile counter.
// Outputs must be 16-byte aligned (the wrapper allocates them).
extern "C" int cammiq_first_of_run(const void* is_start, int n, int nv,
                                   int reverse, const void* v0,
                                   const void* v1, const void* v2,
                                   const void* v3, void* o0, void* o1,
                                   void* o2, void* o3, void* idx,
                                   void* scratch, void* stream) {
  if (nv < 0 || nv > kMaxValues) return (int)cudaErrorInvalidValue;
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
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (ntiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  auto* status = (unsigned long long*)scratch;
  auto* counter = (unsigned*)(status + ntiles);
  if (reverse) {
    first_of_run_kernel<true><<<ntiles, kThreads, 0, s>>>(
        (const uint8_t*)is_start, n, ntiles, nv, a, (int32_t*)idx, status,
        counter);
  } else {
    first_of_run_kernel<false><<<ntiles, kThreads, 0, s>>>(
        (const uint8_t*)is_start, n, ntiles, nv, a, (int32_t*)idx, status,
        counter);
  }
  return (int)cudaGetLastError();
}
