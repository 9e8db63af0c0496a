// Segmented inclusive min-scan of the device build's LCP0 stages, one pass
// with decoupled look-back.
//
// Replaces cammiq_tpu/ops/scans_jax.py:segmented_cummin_jax and
// segmented_cummin_rev_jax (16-38), XLA work with no Pallas original: a
// Hillis-Steele doubling with a boundary guard, log2(n) full passes.  For
// non-negative int32 v and bool flags [n]:
//   forward: out[i] = min v[s..i], s the last j <= i with flags[j], 0 when
//            none;
//   reverse: out[i] = min v[i..e], e the first j >= i with flags[j], n - 1
//            when none.
// The reverse scan is the forward one over mirrored positions: tiles are
// taken from the back and each thread walks its items backward, so no
// array is flipped.
//
// Design, one tile of 4096 elements a block:
//   - each block takes its tile from an atomic counter, so every tile it
//     waits on has already started (forward progress);
//   - values arrive as coalesced 16-byte loads, striped over the block,
//     into shared memory (swizzled, conflict-free) and are read back as
//     each thread's 16 consecutive items.  A v that is not 16-byte aligned
//     (the build's reverse scan reads lcp[1:n+1]) is read as the aligned
//     int4s around it and realigned with a shuffle from the next lane;
//   - each thread reads its 16 flags with one 16-byte load, scans its
//     items, and the block scans the threads' (flag, min) pairs, packed
//     into one word (the flag in bit 31: values are below 2^31);
//   - a tile that holds a flag knows its inclusive prefix (the min from
//     its last flag to its end) and publishes it at once; a tile with none
//     publishes its min as its aggregate and, after its look-back, its
//     prefix.  So a tile waits only on predecessors back to the nearest
//     flagged tile, and only its elements before its first flag take the
//     carry.  The look-back and the status words are cammiq_common.cuh's
//     (MinOp, identity 0xFFFFFFFF);
//   - results go back through shared memory, so every store is a
//     coalesced int4.
// Bound on the card: bytes.  4 B of v and 1 B of flag read and 4 B written
// an element: at the build's n = 600,008,000, 5.4 GB a direction, 1.61 ms
// at 3.35 TB/s.  The status words and the tile counter are zeroed by one
// memset on the stream before the launch.
#include "cammiq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                   // items a thread
constexpr int kTile = kThreads * kItems;
constexpr int kSlots = kTile / 4;            // int4 slots a tile
constexpr unsigned kFlag = 0x80000000u;      // a packed pair's flag bit
constexpr unsigned kNoValue = 0x7FFFFFFFu;   // a packed pair's empty min
constexpr unsigned kIdentity = 0xFFFFFFFFu;  // MinOp's identity (statuses)

__device__ __forceinline__ unsigned umin(unsigned a, unsigned b) { return a < b ? a : b; }

// pair a, then pair b in processing order: b's min when b holds a flag,
// else the min of both, flagged when a is
__device__ __forceinline__ unsigned combine(unsigned a, unsigned b) {
  return (b & kFlag) ? b : (a & kFlag) | umin(a & ~kFlag, b);
}

// Exclusive scan of the threads' packed pairs in thread order (identity
// kNoValue); *total gets the block's inclusive pair.  Called once a block.
__device__ unsigned block_exclusive_scan(unsigned x, unsigned* total) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned warp_inc[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc = combine(y, inc);
  }
  unsigned excl = __shfl_up_sync(0xFFFFFFFFu, inc, 1);
  if (lane == 0) excl = kNoValue;
  if (lane == 31) warp_inc[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kWarps ? warp_inc[lane] : kNoValue;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w = combine(y, w);
    }
    if (lane < kWarps) warp_inc[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_inc[kWarps - 1];
  return warp > 0 ? combine(warp_inc[warp - 1], excl) : excl;
}

// physical int4 slot of logical slot 4 * c + r (chunk c, quarter r): rows of
// 8 slots then never hold two slots of one store or one load instruction
__device__ __forceinline__ int swizzle(int c, int r) {
  return 4 * c + (r ^ ((c >> 1) & 3));
}

__device__ __forceinline__ int4 shfl_down4(int4 x) {
  return make_int4(__shfl_down_sync(0xFFFFFFFFu, x.x, 1),
                   __shfl_down_sync(0xFFFFFFFFu, x.y, 1),
                   __shfl_down_sync(0xFFFFFFFFu, x.z, 1),
                   __shfl_down_sync(0xFFFFFFFFu, x.w, 1));
}

// 8 blocks an SM (32 registers): 2048 threads with their loads in flight
template <bool kReverse>
__global__ void __launch_bounds__(kThreads, 8)
segmented_min_kernel(const int32_t* __restrict__ v,
                     const uint8_t* __restrict__ flags, int n, int ntiles,
                     int32_t* __restrict__ out,
                     unsigned long long* __restrict__ status,
                     unsigned* __restrict__ counter) {
  __shared__ int s_tile;
  __shared__ unsigned s_carry;
  __shared__ __align__(16) int32_t s_val[kTile];
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int t = s_tile;                             // processing order
  const int tile = kReverse ? ntiles - 1 - t : t;   // tile in memory
  // chunk of this thread; threads run in processing order
  const int c = kReverse ? kThreads - 1 - (int)threadIdx.x : (int)threadIdx.x;
  const long long t0 = (long long)tile * kTile;
  const long long i0 = t0 + (long long)c * kItems;
  const int lane = threadIdx.x & 31;
  int4* s4 = reinterpret_cast<int4*>(s_val);

  // values: the aligned int4s that hold the tile, striped over the block;
  // v + t0 lies `a` elements past base's start (a is the same in every
  // tile).  An int4 is read only when it holds an element below n, so no
  // read leaves v's allocation.
  const int a = (int)((reinterpret_cast<uintptr_t>(v) >> 2) & 3);
  const int4* base = reinterpret_cast<const int4*>(
      reinterpret_cast<uintptr_t>(v + t0) & ~(uintptr_t)15);
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kSlots / kThreads; ++k) {
    const int m = threadIdx.x + k * kThreads;
    const long long first = t0 + 4LL * m - a;  // element index of base[m].x
    int4 x = first < n ? base[m] : zero;
    if (a) {  // slot m: x's elements a..3, then the next int4's 0..a-1
      int4 y = shfl_down4(x);
      if (lane == 31) y = first + 4 < n ? base[m + 1] : zero;
      x = a == 1 ? make_int4(x.y, x.z, x.w, y.x)
        : a == 2 ? make_int4(x.z, x.w, y.x, y.y)
                 : make_int4(x.w, y.x, y.y, y.z);
    }
    s4[swizzle(m >> 2, m & 3)] = x;
  }
  // this thread's 16 flags, packed four to a word
  unsigned fw[4];
  if (i0 + kItems <= n && (reinterpret_cast<uintptr_t>(flags) & 15) == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(flags + i0);
    fw[0] = w.x;
    fw[1] = w.y;
    fw[2] = w.z;
    fw[3] = w.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fw[r] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i = i0 + 4 * r + e;
        if (i < n && flags[i]) fw[r] |= 1u << (8 * e);
      }
    }
  }
  const long long left = n - i0;  // items of this thread below n
  __syncthreads();
  // running min of this thread's items in processing order, back to its
  // own slots (so no value is held across the block scan); bit j of
  // `seen`: a flag at or before item j.  Items past n hold no value.
  unsigned run = kNoValue, seen = 0;
  bool any = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int r = kReverse ? 3 - s : s;
    const int4 q = s4[swizzle(c, r)];
    unsigned x[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z, (unsigned)q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = kReverse ? 3 - u : u;
      const int j = 4 * r + e;
      const bool in = j < left;
      if (in && ((fw[r] >> (8 * e)) & 0xFFu)) {
        run = x[e];
        any = true;
      } else {
        run = umin(run, in ? x[e] : kNoValue);
      }
      x[e] = run;
      seen |= (unsigned)any << j;
    }
    s4[swizzle(c, r)] = make_int4((int)x[0], (int)x[1], (int)x[2], (int)x[3]);
  }
  unsigned total;
  const unsigned before = block_exclusive_scan((any ? kFlag : 0u) | run, &total);
  const unsigned tile_min = total & ~kFlag;

  if (threadIdx.x == 0) {  // publish before looking back
    if (t == 0 || (total & kFlag)) {
      store_status(status + t, kStatePrefix, tile_min);
    } else {
      store_status(status + t, kStateAggregate, tile_min);
    }
  }
  if (threadIdx.x < 32) {
    const unsigned carry = t > 0 ? look_back(status, t, kIdentity, MinOp()) : kIdentity;
    if (threadIdx.x == 0) {
      s_carry = carry;
      if (t > 0 && !(total & kFlag))
        store_status(status + t, kStatePrefix, umin(carry, tile_min));
    }
  }
  __syncthreads();
  // what this thread's items before its first flag take: the block's pairs
  // before it, and the tiles' carry unless one of those pairs is flagged
  const unsigned pre = (before & kFlag) ? before & ~kFlag : umin(before, s_carry);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int4 q = s4[swizzle(c, r)];
    const unsigned x[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z, (unsigned)q.w};
    int o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * r + e;
      o[e] = (int)((seen >> j) & 1u ? x[e] : umin(x[e], pre));
    }
    s4[swizzle(c, r)] = make_int4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSlots / kThreads; ++k) {
    const int m = threadIdx.x + k * kThreads;  // logical int4 slot, striped
    const int4 q = s4[swizzle(m >> 2, m & 3)];
    const long long i = t0 + 4LL * m;
    if (i + 4 <= n) {
      *reinterpret_cast<int4*>(out + i) = q;
    } else {
      const int qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n) out[i + e] = qs[e];
      }
    }
  }
}

}  // namespace

extern "C" int cammiq_segmented_min_tile() { return kTile; }

// v: int32 [n], non-negative; flags: bool [n]; out: int32 [n], 16-byte
// aligned (the wrapper allocates it); scratch: 8 * (ceil(n / tile) + 1)
// bytes for the tile statuses and the tile counter.
extern "C" int cammiq_segmented_min(const void* v, const void* flags, int n,
                                    int reverse, void* out, void* scratch,
                                    void* stream) {
  if (n <= 0) return 0;
  const int ntiles = (n + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (ntiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  auto* status = (unsigned long long*)scratch;
  auto* counter = (unsigned*)(status + ntiles);
  if (reverse) {
    segmented_min_kernel<true><<<ntiles, kThreads, 0, s>>>(
        (const int32_t*)v, (const uint8_t*)flags, n, ntiles, (int32_t*)out,
        status, counter);
  } else {
    segmented_min_kernel<false><<<ntiles, kThreads, 0, s>>>(
        (const int32_t*)v, (const uint8_t*)flags, n, ntiles, (int32_t*)out,
        status, counter);
  }
  return (int)cudaGetLastError();
}
