// The per-read case analysis of a query batch and its rcount accumulation,
// in one launch.
//
// Replaces cammiq_tpu/query/classify.py:case_analysis (160-260) followed by
// rcounts_from_case (263-275), both XLA: per read, a sort of the [S] slots
// carrying their rids, a sort of the singles' rids, a two-key sort of the
// pairs, first-occurrence flags and sums over each, then scatters into
// cnts_u/cnts_d and, for rcount, a scatter of every slot of the batch
// (unassigned and repeated ones aimed at a dump element).  No sort here:
//
//   in:  slots, rid1, rid2 int32 [B, S] (slot = global entry id, BIG =
//        empty), lengths int32 [B], G, sc_mode, and an optional rcount
//        int32 [size]: rcount[e] counts entry id e, e < size;
//   out: counts int32 [2G + 2] added to (cnts_u | cnts_d | nundet |
//        nconf), pair_lo / pair_hi int32 [B], rcount added to.
//
// Group path (S <= kGroupMaxS, every main-path width): a group of g lanes
// owns a read, g the smallest power of two >= min(S, 32), at least 8; a
// block of 256 threads holds 256 / g reads.  Only warp-level collectives
// over the group's own lanes; no block barrier.
//
// 1. Each lane loads its ceil(S / g) slot ids into registers before it
//    uses any (16-byte loads when the row allows): one round trip.
// 2. The valid slots (slot < BIG) are compacted by ballot into the
//    group's stage in shared memory (64 entries at g = 32, g below), as
//    (slot, column); then each lane loads rid1 and rid2 of its staged
//    entries, all issued together: a second round trip, and only the rid
//    sectors of valid slots are touched.
// 3. Shuffle reductions over the group: the singles' (rid2 == 0, rid1 <
//    BIG) min and max rid1, so U = 0, 1 (min == max) or more, r* = the min;
//    the pairs' (lo = min(rid1, rid2) < BIG) lexicographic min and max of
//    (lo, hi), so P = 0, 1 or more, (a1, b1) = the min.  Equal slot ids
//    carry identical payloads (the JAX source's own premise,
//    classify.py:170), so these reductions over every valid slot equal
//    JAX's over the distinct ones.  When P >= 1 and U <= 1: three group
//    ANDs, "every pair holds x" for x = r*, a1, b1.
// 4. The group's first lane applies JAX's case table, adds to cnts_u /
//    cnts_d (genome ids lie in [0, G); one outside is dropped) and writes
//    the read's pair (sc mode).
// 5. Only an assigned read touches rcount: a staged entry counts where no
//    earlier staged entry holds its id (about 1.6 valid slots a read at
//    config #3: a handful of compares).  No slot of an unassigned read
//    and no empty slot is ever written.
// 6. nundet and nconf (reads with length > 0): a ballot a warp, then one
//    atomic each a block.  Warps 1.. leave their sums in shared memory and
//    arrive on a named barrier without waiting; only warp 0 waits there,
//    at its very end, and adds the block's two sums.
// A row with more valid slots than the stage takes steps 3 and 5 from
// device memory with its g lanes (quadratic, exact).
//
// Block path (S > kGroupMaxS: only after the session has doubled maxm
// far, e.g. the sort join's [64, 4096]): one block a read; its valid slots
// are appended to shared memory, four block reductions give the flags,
// and an assigned read's staged ids are sorted (bitonic) for the first of
// each run.  A row with more valid slots than that block stages
// (kMaxStage) takes steps 3 and 5 from device memory.
//
// Bound on the card: the slot ids are read once (4 bytes a slot) and the
// rids only in the 32-byte sectors that hold a valid slot's; the outputs
// are 8 bytes a read and the few rcount elements the assigned reads
// touch.  At the gather engine's [8192, 300], 12,895 valid slots of
// 2,457,600, that is at most 10.9 MB, 0.0032 ms at 3.35 TB/s; at the sort
// join's [8192, 16] 1.2 MB, 0.00036 ms.  The group path is latency-bound:
// two dependent load round trips per read, 512 (S = 16) or 1024 (S =
// 300) blocks of 256 threads, one or two waves.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kMaxStage = 16384;  // valid slots a block-path block stages: 192 KB
constexpr int kMaxThreads = 256;
constexpr int kGroupThreads = 256;  // a group-path block
constexpr int kGroupMaxS = 1024;    // the widest row of the group path
constexpr int kGroupStage = 64;     // valid slots a 32-lane group stages
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kKeyMin = -kKeyMax - 1;

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

__device__ __forceinline__ Red red_empty() {
  return Red{kBig, INT32_MIN, kKeyMax, kKeyMin};
}

// one valid slot's payload into a partial reduction
__device__ __forceinline__ void fold(Red& r, int r1, int r2) {
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

__device__ __forceinline__ Red combine(Red a, Red b) {
  return Red{a.mn < b.mn ? a.mn : b.mn, a.mx > b.mx ? a.mx : b.mx,
             a.pmn < b.pmn ? a.pmn : b.pmn, a.pmx > b.pmx ? a.pmx : b.pmx};
}

// over the `lanes` lanes of `mask` (xor partners stay inside the group)
__device__ __forceinline__ Red group_reduce(Red r, unsigned mask, int lanes) {
  for (int d = lanes >> 1; d; d >>= 1) {
    const Red o{__shfl_xor_sync(mask, r.mn, d), __shfl_xor_sync(mask, r.mx, d),
                __shfl_xor_sync(mask, r.pmn, d), __shfl_xor_sync(mask, r.pmx, d)};
    r = combine(r, o);
  }
  return r;
}

__device__ __forceinline__ void add_count(int32_t* cnt, int idx, int G) {
  if (idx >= 0 && idx < G) atomicAdd(cnt + idx, 1);
}

// +1 at entry id s of a non-null rcount of `size` elements
__device__ __forceinline__ void add_rcount(int32_t* rcount, long long size, int s) {
  if (s >= 0 && s < size) atomicAdd(rcount + s, 1);
}

// A read's flags from its reduction, then (decide) JAX's case table.
struct Case {
  int U, P, rstar, a1, b1;
  bool undet, u_only, ud, pair, isect, assigned, in_a;
  __device__ __forceinline__ explicit Case(const Red& r)
      : U(r.mn == kBig ? 0 : (r.mn == r.mx ? 1 : 2)),
        P(r.pmn == kKeyMax ? 0 : (r.pmn == r.pmx ? 1 : 2)),
        rstar(r.mn),
        a1(P ? key_lo(r.pmn) : kBig),
        b1(P ? key_hi(r.pmn) : kBig) {}
  __device__ __forceinline__ bool needs_ands() const { return P >= 1 && U <= 1; }
  // in_r, in_a, in_b: every pair holds r*, a1, b1
  __device__ __forceinline__ void decide(bool in_r, bool in_a_, bool in_b) {
    in_a = in_a_;
    undet = P == 0 && U == 0;
    u_only = P == 0 && U == 1;
    ud = P >= 1 && U == 1 && in_r;
    pair = P == 1 && U == 0;
    isect = P >= 2 && U == 0 && (int)in_a + (int)in_b == 1;
    assigned = u_only || ud || pair || isect;
  }
};

// A decided read into cnts_u / cnts_d and its pair (sc mode); nundet and
// nconf are the caller's.
__device__ __forceinline__ void apply_case(const Case& c, int G, int sc_mode,
                                           bool real, int32_t* counts,
                                           int32_t* pair_lo, int32_t* pair_hi,
                                           long long b) {
  int32_t* cnts_u = counts;
  int32_t* cnts_d = counts + G;
  if (c.u_only || c.ud) add_count(cnts_u, c.rstar, G);
  if (c.ud) add_count(cnts_d, c.rstar, G);
  if (c.pair) {
    add_count(cnts_d, c.a1, G);
    add_count(cnts_d, c.b1, G);
  }
  if (c.isect) add_count(cnts_d, c.in_a ? c.a1 : c.b1, G);
  const bool pair = sc_mode && c.pair && real;
  pair_lo[b] = pair ? c.a1 : -1;
  pair_hi[b] = pair ? c.b1 : -1;
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- group path: LANES lanes a read, each lane NV vectors of VW slots

template <int LANES, int VW, int NV>
__global__ void __launch_bounds__(kGroupThreads)
case_count_groups(const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ rid1,
                  const int32_t* __restrict__ rid2,
                  const int32_t* __restrict__ lengths, int B, int S, int G,
                  int sc_mode, int32_t* __restrict__ counts,
                  int32_t* __restrict__ pair_lo, int32_t* __restrict__ pair_hi,
                  int32_t* __restrict__ rcount, long long rc_size) {
  constexpr int R = kGroupThreads / LANES;  // reads a block
  constexpr int CAP = LANES < 32 ? LANES : kGroupStage;
  constexpr int EPL = CAP / LANES;  // stage entries a lane
  constexpr int SPL = VW * NV;      // slots a lane
  __shared__ int st_slot[R * CAP];
  __shared__ int st_x1[R * CAP];  // the column, then rid1
  __shared__ int st_x2[R * CAP];  // rid2
  __shared__ int s_part[kGroupThreads / 32][2];
  const int tid = threadIdx.x, wl = tid & 31, warp = tid >> 5;
  const int lane = tid & (LANES - 1), grp = tid / LANES;
  const int gbase = wl & ~(LANES - 1);  // the group's first lane in its warp
  const unsigned gmask = LANES == 32 ? kFull : ((1u << LANES) - 1u) << gbase;
  const long long first = (long long)blockIdx.x * R;
  const int active = (int)min((long long)R, (long long)B - first);
  const int nwarps = (active * LANES + 31) / 32;
  if (warp >= nwarps) return;  // every group of this warp lies past B
  const long long b = first + grp;
  bool undet_real = false, conf_real = false;  // the group's first lane's
  if (grp < active) {
    const long long row = b * S;
    int* gs = st_slot + grp * CAP;
    int* g1 = st_x1 + grp * CAP;
    int* g2 = st_x2 + grp * CAP;
    // 1. the row's slot ids, all in flight
    int s[SPL];
    const int len = lane == 0 ? __ldg(lengths + b) : 0;
    if (VW == 4) {
      const int4* r4 = reinterpret_cast<const int4*>(slots + row);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + k * LANES;
        int4 x = make_int4(kBig, kBig, kBig, kBig);
        if (4 * v < S) x = __ldg(r4 + v);
        s[4 * k] = x.x;
        s[4 * k + 1] = x.y;
        s[4 * k + 2] = x.z;
        s[4 * k + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = lane + k * LANES;
        s[k] = j < S ? __ldg(slots + row + j) : kBig;
      }
    }
    // 2. compact the valid ones into the stage as (slot, column)
    int n = 0;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      if ((i / VW) * LANES * VW >= S) break;  // the row has ended (uniform)
      const bool valid = s[i] < kBig;
      const unsigned m = (__ballot_sync(gmask, valid) & gmask) >> gbase;
      const int at = n + __popc(m & ((1u << lane) - 1u));
      if (valid && at < CAP) {
        gs[at] = s[i];
        g1[at] = VW * (lane + (i / VW) * LANES) + i % VW;
      }
      n += __popc(m);
    }
    __syncwarp(gmask);
    const bool staged = n <= CAP;
    // ... and their rids, all in flight; a row past the stage folds from
    // its registers and device memory
    Red r = red_empty();
    if (staged) {
      int x1[EPL], x2[EPL];
#pragma unroll
      for (int t = 0; t < EPL; ++t) {
        const int e = lane + t * LANES;
        x1[t] = x2[t] = 0;
        if (e < n) {
          const int c = g1[e];
          x1[t] = __ldg(rid1 + row + c);
          x2[t] = __ldg(rid2 + row + c);
        }
      }
#pragma unroll
      for (int t = 0; t < EPL; ++t) {
        const int e = lane + t * LANES;
        if (e < n) {
          fold(r, x1[t], x2[t]);
          g1[e] = x1[t];
          g2[e] = x2[t];
        }
      }
      __syncwarp(gmask);
    } else {
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        if (s[i] < kBig) {
          const long long c = row + VW * (lane + (i / VW) * LANES) + i % VW;
          fold(r, __ldg(rid1 + c), __ldg(rid2 + c));
        }
      }
    }
    // 3. the flags
    r = group_reduce(r, gmask, LANES);
    Case c(r);
    bool in_r = true, in_a = true, in_b = true;
    if (c.needs_ands()) {
      if (staged) {
#pragma unroll
        for (int t = 0; t < EPL; ++t) {
          const int e = lane + t * LANES;
          if (e < n && g2[e] != 0) {
            const int x1 = g1[e], x2 = g2[e];
            in_r &= x1 == c.rstar || x2 == c.rstar;
            in_a &= x1 == c.a1 || x2 == c.a1;
            in_b &= x1 == c.b1 || x2 == c.b1;
          }
        }
      } else {
        for (int j = lane; j < S; j += LANES) {
          if (slots[row + j] >= kBig) continue;
          const int x1 = rid1[row + j], x2 = rid2[row + j];
          if (x2 == 0) continue;
          in_r &= x1 == c.rstar || x2 == c.rstar;
          in_a &= x1 == c.a1 || x2 == c.a1;
          in_b &= x1 == c.b1 || x2 == c.b1;
        }
      }
      in_r = __all_sync(gmask, in_r);
      in_a = __all_sync(gmask, in_a);
      in_b = __all_sync(gmask, in_b);
    }
    // 4. the case table, applied by the group's first lane
    c.decide(in_r, in_a, in_b);
    if (lane == 0) {
      const bool real = len > 0;
      apply_case(c, G, sc_mode, real, counts, pair_lo, pair_hi, b);
      undet_real = c.undet && real;
      conf_real = !c.undet && !c.assigned && real;
    }
    // 5. the assigned read's distinct slots into rcount
    if (c.assigned && rcount) {
      if (staged) {
#pragma unroll
        for (int t = 0; t < EPL; ++t) {
          const int e = lane + t * LANES;
          if (e < n) {
            const int v = gs[e];
            bool fresh = true;
            for (int q = 0; q < e && fresh; ++q) fresh = gs[q] != v;
            if (fresh) add_rcount(rcount, rc_size, v);
          }
        }
      } else {
        for (int j = lane; j < S; j += LANES) {
          const int v = slots[row + j];
          if (v >= kBig) continue;
          bool fresh = true;
          for (int q = 0; q < j && fresh; ++q) fresh = slots[row + q] != v;
          if (fresh) add_rcount(rcount, rc_size, v);
        }
      }
    }
  }
  // 6. the block's nundet and nconf: one atomic each
  __syncwarp();
  const int nu = __popc(__ballot_sync(kFull, undet_real));
  const int nc = __popc(__ballot_sync(kFull, conf_real));
  if (nwarps > 1) {
    if (wl == 0) {
      s_part[warp][0] = nu;
      s_part[warp][1] = nc;
      __threadfence_block();
    }
    __syncwarp();
    if (warp) {
      named_arrive(1, nwarps * 32);
      return;
    }
    named_sync(1, nwarps * 32);
  }
  if (wl == 0) {
    int su = nu, sc = nc;
    for (int w = 1; w < nwarps; ++w) {
      su += s_part[w][0];
      sc += s_part[w][1];
    }
    if (su) atomicAdd(counts + 2 * G, su);
    if (sc) atomicAdd(counts + 2 * G + 1, sc);
  }
}

// ---- block path: one block a read, for rows wider than kGroupMaxS

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
case_count_block(const int32_t* __restrict__ slots,
                 const int32_t* __restrict__ rid1,
                 const int32_t* __restrict__ rid2,
                 const int32_t* __restrict__ lengths, int S, int cap, int G,
                 int sc_mode, int32_t* __restrict__ counts,
                 int32_t* __restrict__ pair_lo, int32_t* __restrict__ pair_hi,
                 int32_t* __restrict__ rcount, long long rc_size) {
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

  // stage the valid slots, reduce the singles and the pairs
  Red r = red_empty();
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
    if (valid) fold(r, r1, r2);
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
  r = group_reduce(r, kFull, 32);
  if (lane == 0) s_red[warp] = r;
  __syncthreads();
  r = s_red[0];
  for (int w = 1; w < T / 32; ++w) r = combine(r, s_red[w]);
  const int n = s_n;
  const bool staged = n <= cap;
  Case c(r);

  // "every pair holds x" for r*, a1 and b1
  bool in_r = true, in_a = true, in_b = true;
  if (c.needs_ands()) {
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
      in_r &= x1 == c.rstar || x2 == c.rstar;
      in_a &= x1 == c.a1 || x2 == c.a1;
      in_b &= x1 == c.b1 || x2 == c.b1;
    }
    in_r = __syncthreads_and(in_r);
    in_a = __syncthreads_and(in_a);
    in_b = __syncthreads_and(in_b);
  }

  c.decide(in_r, in_a, in_b);
  if (tid == 0) {
    const bool real = lengths[b] > 0;
    apply_case(c, G, sc_mode, real, counts, pair_lo, pair_hi, b);
    if (c.undet && real) atomicAdd(counts + 2 * G, 1);
    if (!c.undet && !c.assigned && real) atomicAdd(counts + 2 * G + 1, 1);
  }

  // the assigned read's distinct slots into rcount
  if (!c.assigned || !rcount) return;
  if (staged) {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int k = n + tid; k < n2; k += T) st_slot[k] = kBig;
    __syncthreads();
    bitonic_sort(st_slot, n2);
    for (int k = tid; k < n; k += T) {
      const int s = st_slot[k];
      if (k == 0 || st_slot[k - 1] != s) add_rcount(rcount, rc_size, s);
    }
  } else {
    for (int j = tid; j < S; j += T) {
      const int s = slots[row + j];
      if (s >= kBig) continue;
      bool first = true;
      for (int k = 0; k < j && first; ++k) first = slots[row + k] != s;
      if (first) add_rcount(rcount, rc_size, s);
    }
  }
}

// ---- launch geometry

using GroupKernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                             const int32_t*, int, int, int, int, int32_t*,
                             int32_t*, int32_t*, int32_t*, long long);

struct Geometry {
  GroupKernel fn;  // null: the block path
  int lanes, vw, nv;
};

// 32 lanes, nv 16-byte loads a lane (nv <= 8)
GroupKernel group_kernel_vec(int nv) {
  switch (nv) {
    case 1: return case_count_groups<32, 4, 1>;
    case 2: return case_count_groups<32, 4, 2>;
    case 3: return case_count_groups<32, 4, 3>;
    case 4: return case_count_groups<32, 4, 4>;
    case 5: return case_count_groups<32, 4, 5>;
    case 6: return case_count_groups<32, 4, 6>;
    case 7: return case_count_groups<32, 4, 7>;
    default: return case_count_groups<32, 4, 8>;
  }
}

// 32 lanes, nv 4-byte loads a lane (a power of two <= 32)
GroupKernel group_kernel_scalar(int nv) {
  switch (nv) {
    case 1: return case_count_groups<32, 1, 1>;
    case 2: return case_count_groups<32, 1, 2>;
    case 4: return case_count_groups<32, 1, 4>;
    case 8: return case_count_groups<32, 1, 8>;
    case 16: return case_count_groups<32, 1, 16>;
    default: return case_count_groups<32, 1, 32>;
  }
}

// The group path's kernel for [B, S] rows starting at `slots`: g lanes, 16-byte
// loads (vw = 4) where S > 16 divides by 4 and the rows are 16-byte aligned,
// else one slot a load (nv rounded up to a power of two).
Geometry geometry(int S, const void* slots) {
  if (S > kGroupMaxS) return Geometry{nullptr, 0, 0, 0};
  if (S <= 8) return Geometry{case_count_groups<8, 1, 1>, 8, 1, 1};
  if (S <= 16) return Geometry{case_count_groups<16, 1, 1>, 16, 1, 1};
  if (S % 4 == 0 && (reinterpret_cast<uintptr_t>(slots) & 15) == 0) {
    const int nv = (S + 127) / 128;
    return Geometry{group_kernel_vec(nv), 32, 4, nv};
  }
  int nv = 1;
  while (nv * 32 < S) nv <<= 1;
  return Geometry{group_kernel_scalar(nv), 32, 1, nv};
}

void block_shape(int S, int* cap, int* threads) {
  *cap = 1;
  while (*cap < S && *cap < kMaxStage) *cap <<= 1;
  *threads = 32;
  while (*threads < kMaxThreads && *threads * 4 < S) *threads <<= 1;
}

}  // namespace

// slots, rid1, rid2 int32 [B, S], lengths int32 [B]; counts int32 [2G + 2]
// (added to), pair_lo / pair_hi int32 [B]; rcount int32 [rc_size] (null
// for none) counting entry ids from 0.
extern "C" int cammiq_case_count(const void* slots, const void* rid1,
                                 const void* rid2, const void* lengths, int B,
                                 int S, int G, int sc_mode, void* counts,
                                 void* pair_lo, void* pair_hi, void* rcount,
                                 long long rc_size, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const Geometry geo = geometry(S, slots);
  if (geo.fn) {
    const int R = kGroupThreads / geo.lanes;
    geo.fn<<<(B + R - 1) / R, kGroupThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)slots, (const int32_t*)rid1, (const int32_t*)rid2,
        (const int32_t*)lengths, B, S, G, sc_mode, (int32_t*)counts,
        (int32_t*)pair_lo, (int32_t*)pair_hi, (int32_t*)rcount, rc_size);
    return (int)cudaGetLastError();
  }
  int cap, threads;
  block_shape(S, &cap, &threads);
  const int smem = 3 * cap * (int)sizeof(int);
  if (smem > 32 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        case_count_block, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  case_count_block<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const int32_t*)rid1, (const int32_t*)rid2,
      (const int32_t*)lengths, S, cap, G, sc_mode, (int32_t*)counts,
      (int32_t*)pair_lo, (int32_t*)pair_hi, (int32_t*)rcount, rc_size);
  return (int)cudaGetLastError();
}

// cammiq_case_count with its 14 arguments packed as int64 in that order
// (pointers as addresses, null as 0): the caller converts one argument,
// not 14.
extern "C" int cammiq_case_count_packed(const long long* a) {
  return cammiq_case_count((const void*)a[0], (const void*)a[1], (const void*)a[2],
                           (const void*)a[3], (int)a[4], (int)a[5], (int)a[6],
                           (int)a[7], (void*)a[8], (void*)a[9], (void*)a[10],
                           (void*)a[11], a[12], (void*)a[13]);
}

// The launch of cammiq_case_count for [B, S] rows at `slots`, into out[10]:
// path (1 group, 0 block), lanes a read, reads a block, blocks, threads a
// block, registers a thread, resident blocks an SM, slots a load, loads a
// lane, shared bytes a block.
extern "C" int cammiq_case_count_geometry(int B, int S, const void* slots,
                                          int* out) {
  const Geometry geo = geometry(S, slots);
  cudaFuncAttributes attr;
  int resident = 0;
  cudaError_t err;
  if (geo.fn) {
    const int R = kGroupThreads / geo.lanes;
    err = cudaFuncGetAttributes(&attr, geo.fn);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, geo.fn,
                                                          kGroupThreads, 0);
    const int vals[10] = {1, geo.lanes, R, (B + R - 1) / R, kGroupThreads,
                          attr.numRegs, resident, geo.vw, geo.nv,
                          (int)attr.sharedSizeBytes};
    for (int i = 0; i < 10; ++i) out[i] = vals[i];
    return (int)err;
  }
  int cap, threads;
  block_shape(S, &cap, &threads);
  const int smem = 3 * cap * (int)sizeof(int);
  err = cudaFuncGetAttributes(&attr, case_count_block);
  if (err == cudaSuccess && smem > 32 * 1024)
    err = cudaFuncSetAttribute(case_count_block,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, case_count_block,
                                                        threads, smem);
  const int vals[10] = {0, threads, 1, B, threads, attr.numRegs, resident, 1,
                        (S + threads - 1) / threads,
                        (int)attr.sharedSizeBytes + smem};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return (int)err;
}
