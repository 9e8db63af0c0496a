// The sort join's match assembly: a batch's [KP] match list into [B, maxm]
// per-read slots, in one cooperative launch.
//
// Replaces the XLA assembly of cammiq_tpu/query/sortjoin.py:1276-1307 (a
// two-key lax.sort of (read, gid) carrying rid1/rid2, newkey/newread
// flags, a cumsum and _first_of_run_scan for each distinct match's rank
// within its read, and three .at[flat_t].set scatters), which the port
// ran as an int64 torch.sort (cub's radix sort, several launches and
// memsets), a cumsum, a first_of_run launch and three fill + scatter
// pairs: some seventy device operations a batch, each paid on the host.
//
//   in:  mrow, me int32 [KP] (cuckoo_verify's list: row = read * O +
//        offset, e an erec/prec row), counts int32 [2] on the device (only
//        the first min(counts[0], KP) matches are read; the rest is never
//        touched), prec int32 [E, 3] (gid, rid1, rid2), O, B, maxm, eu;
//   out: slots, rid1, rid2 int32 [B, maxm] and in_u uint8 [B, maxm]: row r
//        holds read r's distinct gids in ascending order, the first maxm
//        of them, each with the rids of any one of its matches (equal ids
//        carry equal payloads, cuckoo_verify.cu's note); the rest of the
//        row BIG, 0, 0, false; overflow int32 [1] the distinct (read, gid)
//        pairs beyond maxm, summed over the batch.
// Every output element is written; the result does not depend on the
// list's order (cuckoo_verify appends with atomics).
//
// Bound on the card: bytes - 8 a valid match read (row and entry), the
// 32-byte prec sectors the valid matches touch, 13 a slot written (the
// dense [B, maxm] rows).  At config #3 (12,895 matches, [8192, 16]) that
// is 2.3 MB, 0.00069 ms at 3.35 TB/s.  The kernel is bound by latency
// instead: a launch, a grid barrier and chains of dependent loads.
//
// Design.  Each read has a bucket of S = 4 g 16-byte entries (g = 8, 16 or
// 32 lanes, the power of two at or above maxm, between 8 and 32), so a
// read's matches land in place and no counting sort is needed:
//   A. a thread a valid match: its prec row is loaded while the atomic on
//      cnt[read] that gives its index k within the read is in flight; k <
//      S stores (gid, rid1, rid2) as one int4 in the bucket; the match
//      that takes k = S puts the read on the wide list, and every match
//      with k >= S is spilled: (match, k) to a list of its own;
//   one grid barrier (its last arrival takes the wide and spill counts
//   and zeroes them for the next launch);
//   D. every read by a group of g lanes, each lane holding up to 4 of the
//      read's entries in registers (one coalesced 16-byte load a round,
//      the first round and the count fetched together, the next read's
//      while this one is written): a match is its gid's first when no
//      lower lane of its round (__match_any_sync) and no earlier round
//      (shuffles) holds the gid; its rank is the number of first matches
//      with a smaller gid (each lane's entries against every first match,
//      one shuffle each).  The group writes its row, valid and empty
//      slots, resets cnt[read] and counts what passed maxm.
// A list with a read past S matches (uniform after the barrier) takes a
// fallback before D, with two more barriers: block 0 scans the wide
// reads' counts; every match of a wide read (its bucket, then its spilled
// ones through their k) goes to its place in a packed run; then one block
// a wide read sorts its run (bitonic in shared memory up to 4096 matches;
// beyond, first-occurrence flags and ranks counted from device memory,
// exact) and writes its row, which the group path skips.  Its 32 KB of
// static shared memory goes to every block; the launch keeps 2 blocks an
// SM, fewer than the occupancy allows (5 at 48 registers), so it costs no
// residency, and the group path's reads of other blocks' data go through
// the L2 (__ldcg), so the smaller L1 it leaves costs no hits.
// cnt, the barrier's words and the two counts are state kept per stream by
// the wrapper, zeroed once and left at zero by every launch; the buckets
// and the fallback's arrays are per-stream scratch, written before they
// are read.  No memset, no host sync.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kBucketPerLane = 4;  // a read's bucket: 4 entries a lane
constexpr int kWideStage = 4096;   // wide path: matches a block sorts in shared memory
constexpr int kBlocksPerSM = 2;
constexpr int kStateWords = 6;     // state words before cnt
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Params {
  const int32_t* mrow;
  const int32_t* me;
  const int32_t* counts;
  const int32_t* prec;
  int kp, O, B, maxm, eu;
  int32_t* slots;
  int32_t* rid1;
  int32_t* rid2;
  uint8_t* in_u;
  int32_t* overflow;
  // state kept per stream, zero at rest: the barrier's (count,
  // generation), the wide reads' and spilled matches' counts, the first
  // barrier's copy of those two (written by every launch before it is
  // read), cnt [B]
  unsigned* bar;
  int32_t* wide_n;
  int32_t* spill_n;
  int32_t* snap;
  int32_t* cnt;
  // scratch kept per stream: the buckets [B * S]; the fallback's spilled
  // (match, k) [KP], wide list [B], each read's place in it [B], the wide
  // runs' starts [B + 1], their gid / rid1 / rid2 and flags [KP]
  int4* bucket;
  int2* spill;
  int32_t* wide;
  int32_t* widx;
  int32_t* woff;
  int32_t* gg;
  int32_t* g1;
  int32_t* g2;
  int32_t* flag;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the (co-resident) grid arrives before any leaves.  The
// last to arrive resets the count and advances the generation the others
// wait on; with `take`, it first moves the wide and spill counts into
// snap and zeroes them.
__device__ void grid_sync(const Params& p, bool take) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(p.bar + 1);
    __threadfence();
    if (atomicAdd(p.bar, 1u) == gridDim.x - 1) {
      if (take) {
        p.snap[0] = atomicExch(p.wide_n, 0);
        p.snap[1] = atomicExch(p.spill_n, 0);
      }
      atomicExch(p.bar, 0u);
      __threadfence();
      atomicAdd(p.bar + 1, 1u);
    } else {
      while (ld_acquire(p.bar + 1) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Exclusive prefix sum of x over the block; *total gets the block's sum.
// Every thread of the block must call it.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int result = inc - x + (warp ? warp_sum[warp - 1] : 0);
  *total = warp_sum[kThreads / 32 - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return result;
}

__device__ __forceinline__ void put(const Params& p, int r, int d, int g, int a,
                                    int b) {
  const long long at = (long long)r * p.maxm + d;
  p.slots[at] = g;
  p.rid1[at] = a;
  p.rid2[at] = b;
  p.in_u[at] = g < kBig && g < p.eu;
}

// match i's read, or -1 for a row outside [0, B * O)
__device__ __forceinline__ int read_of(const Params& p, int i) {
  const int row = __ldg(p.mrow + i);
  if (row < 0) return -1;
  const int r = row / p.O;
  return r < p.B ? r : -1;
}

__device__ __forceinline__ int4 payload(const Params& p, int i) {
  const int32_t* pr = p.prec + 3ll * __ldg(p.me + i);
  return make_int4(__ldg(pr), __ldg(pr + 1), __ldg(pr + 2), 0);
}

// ascending bitonic sort of a[0, n), n a power of two, by the whole block
__device__ void bitonic_sort(unsigned long long* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long x = a[i], y = a[l];
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

// Wide read w by the whole block, from its packed run: its D distinct
// gids, ranked, the first maxm written.
__device__ void wide_read(const Params& p, int w, unsigned long long* keys) {
  const int r = __ldcg(p.wide + w);
  const int base = __ldcg(p.woff + w);
  const int n = __ldcg(p.woff + w + 1) - base;
  int D = 0;
  if (n <= kWideStage) {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    // (gid, its place in the run): signed order kept by flipping bit 31
    for (int k = threadIdx.x; k < n2; k += kThreads)
      keys[k] = k < n ? ((unsigned long long)((unsigned)__ldcg(p.gg + base + k) ^ 0x80000000u)
                         << 32) | (unsigned)k
                      : ~0ull;
    __syncthreads();
    bitonic_sort(keys, n2);
    const int per = (n + kThreads - 1) / kThreads;
    const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
    int c = 0;
    for (int k = lo; k < hi; ++k)
      c += k == 0 || (keys[k] >> 32) != (keys[k - 1] >> 32);
    int d = block_exclusive_sum(c, &D);
    for (int k = lo; k < hi; ++k) {
      if (k == 0 || (keys[k] >> 32) != (keys[k - 1] >> 32)) {
        if (d < p.maxm) {
          const int j = base + (int)(keys[k] & 0xFFFFFFFFull);
          put(p, r, d, __ldcg(p.gg + j), __ldcg(p.g1 + j), __ldcg(p.g2 + j));
        }
        ++d;
      }
    }
  } else {
    // quadratic from device memory: first-occurrence flags, then each
    // first match's rank
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int v = p.gg[base + j];
      bool first = true;
      for (int k = 0; k < j && first; ++k) first = p.gg[base + k] != v;
      p.flag[base + j] = first;
    }
    __syncthreads();
    int c = 0;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      if (!p.flag[base + j]) continue;
      ++c;
      const int v = p.gg[base + j];
      int d = 0;
      for (int k = 0; k < n; ++k) d += p.flag[base + k] && p.gg[base + k] < v;
      if (d < p.maxm) put(p, r, d, v, p.g1[base + j], p.g2[base + j]);
    }
    block_exclusive_sum(c, &D);
  }
  for (int k = threadIdx.x; k < p.maxm; k += kThreads)
    if (k >= D) put(p, r, k, kBig, 0, 0);
  if (threadIdx.x == 0 && D > p.maxm) atomicAdd(p.overflow, D - p.maxm);
  __syncthreads();  // keys are reused by the block's next wide read
}

// Read r's row by its group of LANES lanes, from its m <= S bucket entries
// (e0: this lane's entry of the first round, already loaded); returns the
// distinct gids past maxm.
template <int LANES>
__device__ __forceinline__ int group_row(const Params& p, int r, int m, int4 e0,
                                         int lane, unsigned gmask, unsigned lt) {
  constexpr int T = kBucketPerLane;
  constexpr int S = LANES * T;
  int x[T], a[T], b[T];
  x[0] = e0.x;
  a[0] = e0.y;
  b[0] = e0.z;
#pragma unroll
  for (int t = 1; t < T; ++t) {
    x[t] = a[t] = b[t] = 0;
    if (t * LANES < m) {  // uniform: the round holds a match
      const int4 e = __ldcg(p.bucket + (long long)r * S + t * LANES + lane);
      x[t] = e.x;
      a[t] = e.y;
      b[t] = e.z;
    }
  }
  // first within its round: no lower lane holds the gid (the lanes past m
  // are above every valid one, so their stale entries never count)
  bool first[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    first[t] = false;
    if (t * LANES < m) {
      const unsigned same = __match_any_sync(gmask, x[t]);  // every lane calls it
      first[t] = t * LANES + lane < m && (same & lt) == 0;
    }
  }
  // ... and no earlier round (full, since a later one holds a match) does
#pragma unroll
  for (int u = 0; u < T - 1; ++u) {
    if ((u + 1) * LANES >= m) break;
    for (int s = 0; s < LANES; ++s) {
      const int y = __shfl_sync(gmask, x[u], s, LANES);
#pragma unroll
      for (int t = u + 1; t < T; ++t) first[t] = first[t] && y != x[t];
    }
  }
  // rank: the first matches with a smaller gid (BIG stands in for the
  // others, never smaller than any gid)
  int rank[T] = {};
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (u * LANES >= m) break;
    const int c = min(LANES, m - u * LANES);
    const int mine = first[u] ? x[u] : kBig;
    for (int s = 0; s < c; ++s) {
      const int y = __shfl_sync(gmask, mine, s, LANES);
#pragma unroll
      for (int t = 0; t < T; ++t) rank[t] += y < x[t];
    }
  }
  unsigned nfirst = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    nfirst += first[t];
    if (first[t] && rank[t] < p.maxm) put(p, r, rank[t], x[t], a[t], b[t]);
  }
  const int D = (int)__reduce_add_sync(gmask, nfirst);
  for (int k = D + lane; k < p.maxm; k += LANES) put(p, r, k, kBig, 0, 0);
  return D > p.maxm ? D - p.maxm : 0;
}

template <int LANES>
__global__ void __launch_bounds__(kThreads)
match_assemble_kernel(Params p) {
  constexpr int S = LANES * kBucketPerLane;  // a read's bucket
  constexpr int R = kThreads / LANES;         // groups a block
  __shared__ unsigned long long keys[kWideStage];
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int n = min(max(__ldg(p.counts), 0), p.kp);

  // A. each match into its read's bucket, or spilled past it
  if (tid == 0) *p.overflow = 0;
  for (int i = tid; i < n; i += stride) {
    const int r = read_of(p, i);
    if (r < 0) continue;
    const int4 v = payload(p, i);  // in flight with the atomic
    const int k = atomicAdd(p.cnt + r, 1);
    if (k < S) {
      p.bucket[(long long)r * S + k] = v;
    } else {
      if (k == S) {
        const int w = atomicAdd(p.wide_n, 1);
        p.wide[w] = r;
        p.widx[r] = w;
      }
      p.spill[atomicAdd(p.spill_n, 1)] = make_int2(i, k);
    }
  }
  grid_sync(p, true);

  const int wn = __ldcg(p.snap);
  if (wn > 0) {
    // the fallback: block 0 scans the wide reads' counts into woff
    if (blockIdx.x == 0) {
      int carry = 0;
      for (int w0 = 0; w0 < wn; w0 += kThreads) {
        const int w = w0 + threadIdx.x;
        const int c = w < wn ? __ldcg(p.cnt + __ldcg(p.wide + w)) : 0;
        int total;
        const int e = block_exclusive_sum(c, &total);
        if (w < wn) p.woff[w] = carry + e;
        carry += total;
      }
      if (threadIdx.x == 0) p.woff[wn] = carry;
    }
    grid_sync(p, false);
    // every match of a wide read into its run: the buckets, then the
    // spilled matches at their index k
    const int from_buckets = wn * S;
    const int total = from_buckets + __ldcg(p.snap + 1);
    for (int q = tid; q < total; q += stride) {
      int at;
      int4 v;
      if (q < from_buckets) {
        const int w = q / S, t = q % S;
        v = __ldcg(p.bucket + (long long)__ldcg(p.wide + w) * S + t);
        at = __ldcg(p.woff + w) + t;
      } else {
        const int2 s = __ldcg(p.spill + (q - from_buckets));
        v = payload(p, s.x);
        at = __ldcg(p.woff + __ldcg(p.widx + read_of(p, s.x))) + s.y;
      }
      p.gg[at] = v.x;
      p.g1[at] = v.y;
      p.g2[at] = v.z;
    }
    grid_sync(p, false);
    for (int w = blockIdx.x; w < wn; w += gridDim.x) wide_read(p, w, keys);
  }

  // D. every other read by a group; the next read's count and first round
  // are fetched while this one is written
  const int lane = threadIdx.x & (LANES - 1), grp = threadIdx.x / LANES;
  const int wl = threadIdx.x & 31;
  const int gbase = wl & ~(LANES - 1);
  const unsigned gmask = LANES == 32 ? kFull : ((1u << LANES) - 1u) << gbase;
  const unsigned lt = (1u << wl) - 1u;
  const int rstride = gridDim.x * R;
  int r = blockIdx.x * R + grp;
  int m = 0, over = 0;
  int4 e0 = make_int4(0, 0, 0, 0);
  if (r < p.B) {
    if (lane == 0) m = __ldcg(p.cnt + r);
    e0 = __ldcg(p.bucket + (long long)r * S + lane);
  }
  for (; r < p.B; r += rstride) {
    m = __shfl_sync(gmask, m, 0, LANES);
    if (lane == 0 && m) p.cnt[r] = 0;
    const int rn = r + rstride;
    int mn = 0;
    int4 en = make_int4(0, 0, 0, 0);
    if (rn < p.B) {
      if (lane == 0) mn = __ldcg(p.cnt + rn);
      en = __ldcg(p.bucket + (long long)rn * S + lane);
    }
    if (m <= S) over += group_row<LANES>(p, r, m, e0, lane, gmask, lt);
    m = mn;
    e0 = en;
  }
  if (lane == 0 && over) atomicAdd(p.overflow, over);
}

using Kernel = void (*)(Params);

int lanes_for(int maxm) { return maxm <= 8 ? 8 : maxm <= 16 ? 16 : 32; }

Kernel kernel_for(int lanes) {
  switch (lanes) {
    case 8: return match_assemble_kernel<8>;
    case 16: return match_assemble_kernel<16>;
    default: return match_assemble_kernel<32>;
  }
}

// blocks of a launch: as many as the work needs, at most kBlocksPerSM an
// SM and never more than can be resident at once (the grid barrier needs
// every block running); the card's SM count and the kernel's occupancy
// are read once a device
cudaError_t grid_blocks(int kp, int B, int lanes, int* blocks, int* per_sm) {
  static int cache[64][3][2] = {};  // device, lanes 8/16/32: SMs, blocks an SM
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  int* c = cache[dev][lanes == 8 ? 0 : lanes == 16 ? 1 : 2];
  if (!c[0]) {
    int sms = 0, coop = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel_for(lanes),
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    c[0] = sms;
    c[1] = occ;
  }
  *per_sm = c[1];
  const long long reads_per_block = kThreads / lanes;
  const long long need = std::max({1LL, (kp + kThreads - 1LL) / kThreads,
                                   (B + reads_per_block - 1) / reads_per_block});
  const long long most = (long long)c[0] * std::min(c[1], kBlocksPerSM);
  *blocks = (int)std::min(need, most);
  return cudaSuccess;
}

}  // namespace

// The 17 arguments, int64 each (pointers as addresses): mrow, me, counts,
// prec, kp, O, B, maxm, eu, slots, rid1, rid2, in_u, overflow, state
// (int32 [6 + B]: the barrier's two words, the wide and spill counts, the
// first barrier's copy of them, cnt; zero at rest but the copy),
// scratch (int32 [4 B S + 6 kp + 3 B + 1], 16-byte aligned, S = 4 lanes:
// buckets, spilled (match, k), wide list, places, starts, gid / rid1 /
// rid2 / flags), stream.
extern "C" int cammiq_match_assemble_packed(const long long* a) {
  Params p;
  p.mrow = (const int32_t*)a[0];
  p.me = (const int32_t*)a[1];
  p.counts = (const int32_t*)a[2];
  p.prec = (const int32_t*)a[3];
  p.kp = (int)a[4];
  p.O = (int)a[5];
  p.B = (int)a[6];
  p.maxm = (int)a[7];
  p.eu = (int)a[8];
  p.slots = (int32_t*)a[9];
  p.rid1 = (int32_t*)a[10];
  p.rid2 = (int32_t*)a[11];
  p.in_u = (uint8_t*)a[12];
  p.overflow = (int32_t*)a[13];
  int32_t* state = (int32_t*)a[14];
  p.bar = (unsigned*)state;
  p.wide_n = state + 2;
  p.spill_n = state + 3;
  p.snap = state + 4;
  p.cnt = state + kStateWords;
  const int lanes = lanes_for(p.maxm);
  const long long kp = p.kp, B = p.B, S = kBucketPerLane * lanes;
  int32_t* s = (int32_t*)a[15];
  p.bucket = (int4*)s;
  p.spill = (int2*)(s + 4 * B * S);
  p.wide = s + 4 * B * S + 2 * kp;
  p.widx = p.wide + B;
  p.woff = p.widx + B;
  p.gg = p.woff + B + 1;
  p.g1 = p.gg + kp;
  p.g2 = p.g1 + kp;
  p.flag = p.g2 + kp;
  const Kernel fn = kernel_for(lanes);
  int blocks = 0, per_sm = 0;
  cudaError_t err = grid_blocks(p.kp, p.B, lanes, &blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks), dim3(kThreads),
                                    args, 0, (cudaStream_t)a[16]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch for kp, B and maxm, into out[8]: lanes a read, reads a
// group-path block, blocks, threads a block, registers a thread, resident
// blocks an SM, static shared bytes a block, the buckets' bytes.
extern "C" int cammiq_match_assemble_geometry(int kp, int B, int maxm,
                                              long long* out) {
  const int lanes = lanes_for(maxm);
  const Kernel fn = kernel_for(lanes);
  int blocks = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) err = grid_blocks(kp, B, lanes, &blocks, &per_sm);
  const long long vals[8] = {lanes, kThreads / lanes, blocks, kThreads, attr.numRegs,
                             per_sm, (long long)attr.sharedSizeBytes,
                             16LL * B * kBucketPerLane * lanes};
  for (int i = 0; i < 8; ++i) out[i] = err == cudaSuccess ? vals[i] : 0;
  return (int)err;
}
