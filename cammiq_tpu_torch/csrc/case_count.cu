// The per-read case analysis of a query batch and its rcount accumulation,
// in one launch.
//
// Replaces cammiq_tpu/query/classify.py:case_analysis (160-260) followed by
// rcounts_from_case (263-275), both XLA: per read, a sort of the [S] slots
// carrying their rids, a sort of the singles' rids, a two-key sort of the
// pairs, first-occurrence flags and sums over each, then scatters into
// cnts_u/cnts_d and, for rcount, a scatter of every slot of the batch
// (unassigned and repeated ones aimed at a dump element).  Here one block
// owns one read and needs no sort for the case flags:
//
//   in:  slots, rid1, rid2 int32 [B, S] (slot = global entry id, BIG =
//        empty), lengths int32 [B], G, sc_mode, and up to two rcount
//        targets (out, lo): out[e] counts entry id lo + e, e < size;
//   out: counts int32 [2G + 2] added to (cnts_u | cnts_d | nundet |
//        nconf), pair_lo / pair_hi int32 [B], the rcount targets added to.
//
// 1. One pass over the row (coalesced loads of the slot ids; a slot's rids
//    are loaded only where it is valid, so a warp fetches only the rid
//    sectors its valid lanes touch): the valid slots (slot < BIG)
//    are appended to shared memory, order immaterial, and four block
//    reductions give the flags.  Singles (rid2 == 0, rid1 < BIG): the min
//    and max rid1, so U = 0, 1 (min == max) or more, and r* = the min.
//    Pairs (rid2 != 0, lo = min(rid1, rid2) < BIG): the lexicographic min
//    and max of (lo, hi), so P = 0, 1 (min == max) or more, and (a1, b1) =
//    the min.  Equal slot ids carry identical payloads (the JAX source's
//    own premise, classify.py:170), so these reductions over every valid
//    slot equal JAX's over the distinct ones.
// 2. When P >= 1 and U <= 1: three block ANDs over the staged pairs, "every
//    pair holds x" for x = r*, a1, b1 (a repeated pair changes no AND).
// 3. Thread 0 applies JAX's case table, adds to cnts_u/cnts_d (genome ids
//    lie in [0, G); one outside is dropped), nundet and nconf (reads with
//    length > 0) and writes the read's pair (sc mode).
// 4. Only an assigned read touches rcount: its staged slot ids are sorted
//    in shared memory (bitonic, n rounded up to a power of two) and the
//    first of each run in a target's id range is added atomically.  No slot
//    of an unassigned read and no empty slot is ever written.
//
// A row with more valid slots than the block stages (kMaxStage; only rows
// wider than that can have them) takes steps 2 and 4 from device memory:
// the ANDs over the row, and a slot counts where no earlier column holds
// it (quadratic, exact).
//
// Bound on the card: the slot ids are read once (4 bytes a slot) and the
// rids only in the 32-byte sectors that hold a valid slot's; the outputs
// are 8 bytes a read and the few rcount elements the assigned reads
// touch.  At the gather engine's [8192, 300], 12,895 valid slots of
// 2,457,600, that is at most 10.7 MB, 0.0032 ms at 3.35 TB/s.  A block is
// a handful of barriers and, for an assigned read, a sort of its valid
// slots (about two a read at config #3), so the kernel should be bound by
// its loads; small blocks (32 to 256 threads by width) keep many reads in
// flight per SM.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kMaxStage = 16384;  // valid slots a block stages: 192 KB
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kKeyMin = -kKeyMax - 1;

struct Target {
  int32_t* out;  // null: no target
  long long lo, size;
};

struct Targets {
  Target t[2];
};

// (lo, hi) as one int64 that orders as JAX's two-key sort of int32 does
__device__ __forceinline__ long long pair_key(int lo, int hi) {
  return (long long)lo * 4294967296LL + (long long)((unsigned)hi ^ 0x80000000u);
}

__device__ __forceinline__ int key_lo(long long k) { return (int)(k >> 32); }

__device__ __forceinline__ int key_hi(long long k) {
  return (int)((unsigned)(k & 0xFFFFFFFFLL) ^ 0x80000000u);
}

struct Red {
  int mn, mx;          // singles' rid1
  long long pmn, pmx;  // pairs' keys
};

__device__ __forceinline__ Red combine(Red a, Red b) {
  return Red{a.mn < b.mn ? a.mn : b.mn, a.mx > b.mx ? a.mx : b.mx,
             a.pmn < b.pmn ? a.pmn : b.pmn, a.pmx > b.pmx ? a.pmx : b.pmx};
}

__device__ __forceinline__ Red warp_reduce(Red r) {
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const Red o{__shfl_xor_sync(kFull, r.mn, d), __shfl_xor_sync(kFull, r.mx, d),
                __shfl_xor_sync(kFull, r.pmn, d), __shfl_xor_sync(kFull, r.pmx, d)};
    r = combine(r, o);
  }
  return r;
}

__device__ __forceinline__ void add_count(int32_t* cnt, int idx, int G) {
  if (idx >= 0 && idx < G) atomicAdd(cnt + idx, 1);
}

__device__ __forceinline__ void add_targets(const Targets& tg, int s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long d = (long long)s - tg.t[i].lo;
    if (tg.t[i].out && d >= 0 && d < tg.t[i].size) atomicAdd(tg.t[i].out + d, 1);
  }
}

// ascending bitonic sort of a[0, n), n a power of two, by the whole block
__device__ void bitonic_sort(int* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const int x = a[i], y = a[l];
          if ((x > y) == ((i & k) == 0)) {
            a[i] = y;
            a[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
case_count_kernel(const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ rid1,
                  const int32_t* __restrict__ rid2,
                  const int32_t* __restrict__ lengths, int S, int cap, int G,
                  int sc_mode, int32_t* __restrict__ counts,
                  int32_t* __restrict__ pair_lo, int32_t* __restrict__ pair_hi,
                  Targets tg) {
  extern __shared__ __align__(16) int smem[];
  int* st_slot = smem;
  int* st_r1 = smem + cap;
  int* st_r2 = smem + 2 * cap;
  __shared__ Red s_red[kMaxThreads / 32];
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x;
  const int b = blockIdx.x;
  const long long row = (long long)b * S;
  if (tid == 0) s_n = 0;
  __syncthreads();

  // 1. stage the valid slots, reduce the singles and the pairs
  Red r{kBig, INT32_MIN, kKeyMax, kKeyMin};
  for (int j0 = 0; j0 < S; j0 += T) {
    const int j = j0 + tid;
    int s = kBig, r1 = 0, r2 = 0;
    if (j < S) {
      s = slots[row + j];
      if (s < kBig) {  // an empty slot's rids are never read
        r1 = rid1[row + j];
        r2 = rid2[row + j];
      }
    }
    const bool valid = s < kBig;
    if (valid) {
      if (r2 == 0) {
        if (r1 < kBig) {
          r.mn = min(r.mn, r1);
          r.mx = max(r.mx, r1);
        }
      } else {
        const int lo = min(r1, r2), hi = max(r1, r2);
        if (lo < kBig) {
          const long long k = pair_key(lo, hi);
          r.pmn = k < r.pmn ? k : r.pmn;
          r.pmx = k > r.pmx ? k : r.pmx;
        }
      }
    }
    const unsigned m = __ballot_sync(kFull, valid);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&s_n, __popc(m));
    at = __shfl_sync(kFull, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (valid && at < cap) {
      st_slot[at] = s;
      st_r1[at] = r1;
      st_r2[at] = r2;
    }
  }
  r = warp_reduce(r);
  if (lane == 0) s_red[warp] = r;
  __syncthreads();
  r = s_red[0];
  for (int w = 1; w < T / 32; ++w) r = combine(r, s_red[w]);
  const int n = s_n;
  const bool staged = n <= cap;

  const int U = r.mn == kBig ? 0 : (r.mn == r.mx ? 1 : 2);
  const int rstar = r.mn;
  const int P = r.pmn == kKeyMax ? 0 : (r.pmn == r.pmx ? 1 : 2);
  const int a1 = P ? key_lo(r.pmn) : kBig;
  const int b1 = P ? key_hi(r.pmn) : kBig;

  // 2. "every pair holds x" for r*, a1 and b1
  bool in_r = true, in_a = true, in_b = true;
  if (P >= 1 && U <= 1) {
    const int lim = staged ? n : S;
    for (int k = tid; k < lim; k += T) {
      int x1, x2;
      if (staged) {
        x1 = st_r1[k];
        x2 = st_r2[k];
      } else {
        if (slots[row + k] >= kBig) continue;
        x1 = rid1[row + k];
        x2 = rid2[row + k];
      }
      if (x2 == 0) continue;
      in_r &= x1 == rstar || x2 == rstar;
      in_a &= x1 == a1 || x2 == a1;
      in_b &= x1 == b1 || x2 == b1;
    }
    in_r = __syncthreads_and(in_r);
    in_a = __syncthreads_and(in_a);
    in_b = __syncthreads_and(in_b);
  }

  // 3. JAX's case table
  const bool undet = P == 0 && U == 0;
  const bool case_u_only = P == 0 && U == 1;
  const bool case_ud = P >= 1 && U == 1 && in_r;
  const bool case_pair = P == 1 && U == 0;
  const bool case_isect = P >= 2 && U == 0 && (int)in_a + (int)in_b == 1;
  const bool assigned = case_u_only || case_ud || case_pair || case_isect;
  if (tid == 0) {
    int32_t* cnts_u = counts;
    int32_t* cnts_d = counts + G;
    if (case_u_only || case_ud) add_count(cnts_u, rstar, G);
    if (case_ud) add_count(cnts_d, rstar, G);
    if (case_pair) {
      add_count(cnts_d, a1, G);
      add_count(cnts_d, b1, G);
    }
    if (case_isect) add_count(cnts_d, in_a ? a1 : b1, G);
    const bool real = lengths[b] > 0;
    if (undet && real) atomicAdd(counts + 2 * G, 1);
    if (!undet && !assigned && real) atomicAdd(counts + 2 * G + 1, 1);
    const bool pair = sc_mode && case_pair && real;
    pair_lo[b] = pair ? a1 : -1;
    pair_hi[b] = pair ? b1 : -1;
  }

  // 4. the assigned read's distinct slots into the rcount targets
  if (!assigned || !(tg.t[0].out || tg.t[1].out)) return;
  if (staged) {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int k = n + tid; k < n2; k += T) st_slot[k] = kBig;
    __syncthreads();
    bitonic_sort(st_slot, n2);
    for (int k = tid; k < n; k += T) {
      const int s = st_slot[k];
      if (k == 0 || st_slot[k - 1] != s) add_targets(tg, s);
    }
  } else {
    for (int j = tid; j < S; j += T) {
      const int s = slots[row + j];
      if (s >= kBig) continue;
      bool first = true;
      for (int k = 0; k < j && first; ++k) first = slots[row + k] != s;
      if (first) add_targets(tg, s);
    }
  }
}

}  // namespace

// slots, rid1, rid2 int32 [B, S], lengths int32 [B]; counts int32 [2G + 2]
// (added to), pair_lo / pair_hi int32 [B]; rcount targets rc0 / rc1 (null
// for none) of size0 / size1 elements counting ids from lo0 / lo1.
extern "C" int cammiq_case_count(const void* slots, const void* rid1,
                                 const void* rid2, const void* lengths, int B,
                                 int S, int G, int sc_mode, void* counts,
                                 void* pair_lo, void* pair_hi, void* rc0,
                                 long long lo0, long long size0, void* rc1,
                                 long long lo1, long long size1, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  int cap = 1;
  while (cap < S && cap < kMaxStage) cap <<= 1;
  int threads = 32;
  while (threads < kMaxThreads && threads * 4 < S) threads <<= 1;
  const int smem = 3 * cap * (int)sizeof(int);
  if (smem > 32 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        case_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  Targets tg;
  tg.t[0] = Target{(int32_t*)rc0, lo0, size0};
  tg.t[1] = Target{(int32_t*)rc1, lo1, size1};
  case_count_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const int32_t*)rid1, (const int32_t*)rid2,
      (const int32_t*)lengths, S, cap, G, sc_mode, (int32_t*)counts,
      (int32_t*)pair_lo, (int32_t*)pair_hi, tg);
  return (int)cudaGetLastError();
}
