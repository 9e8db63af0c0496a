// The sort join's match assembly: a batch's [KP] match list into [B, maxm]
// per-read slots, in one cooperative launch.
//
// Replaces the XLA assembly of cammiq_tpu/query/sortjoin.py:1268-1307 (a
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
// A counting sort by read, then a sort and dedup within each read, as four
// phases of one grid whose blocks are all resident (cudaLaunchCooperative-
// Kernel), separated by three grid barriers:
//   A. each match takes its index within its read from an atomic on
//      cnt[read], and adds one to its 256-read tile's count part[tile];
//   B. a block a tile: the exclusive prefix of the tiles before it (from
//      part) and a block scan of its reads' counts give off[r], the start
//      of read r's matches; cnt is reset to 0; a read with more matches
//      than its group stages goes on the wide list;
//   C. each match's (gid, rid1, rid2) is copied from prec to its place in
//      the grouped arrays (off[read] + its index); part is reset to 0;
//   D. wide reads first, one block a read: the gids, with their place in
//      the read, sorted (bitonic, in shared memory, up to 4096 matches;
//      beyond that, first-occurrence flags and ranks counted from device
//      memory, quadratic and exact); then every other read by a group of
//      g lanes (g = 8, 16 or 32, the power of two at or above maxm,
//      between 8 and 32), up to 4 g matches staged in shared memory:
//      a match is its gid's first in the read when no earlier match holds
//      it, and its rank is the number of first matches with a smaller gid.
//      A first match of rank below maxm writes its slot; the lanes write
//      the row's empty slots; the group adds what passed maxm to overflow.
// cnt, part and the barrier's words are state kept per stream by the
// wrapper, zeroed once when it is made and left at zero by every launch;
// the other scratch is the caller's torch.empty.  No memset, no host sync.
//
// Bound on the card: bytes - 8 a valid match read (row and entry), the
// 32-byte prec sector a valid match touches, 13 a slot written (the dense
// [B, maxm] rows).  At config #3 (12,895 matches, [8192, 16]) that is
// 2.2 MB, 0.00066 ms at 3.35 TB/s.  The kernel is latency-bound instead:
// four phases of one or two dependent loads each, three grid barriers.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kThreads = 256;      // a block, and the reads of a tile in B
constexpr int kTileLog = 8;
constexpr int kStagePerLane = 4;   // group path: matches a lane stages
constexpr int kWideStage = 4096;   // wide path: matches a block sorts in shared memory
constexpr int kBlocksPerSM = 2;
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
  // state kept per stream, zero at rest: barrier (count, generation),
  // cnt [B], part [ceil(B / 256)]
  unsigned* bar;
  int32_t* cnt;
  int32_t* part;
  // scratch: a match's index within its read (phases A-C; the wide path's
  // flags in D), off [B + 1], the grouped gid / rid1 / rid2 [KP], the wide
  // list [B] and its length
  int32_t* local;
  int32_t* off;
  int32_t* gg;
  int32_t* g1;
  int32_t* g2;
  int32_t* wide;
  int32_t* wide_n;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the (co-resident) grid arrives before any leaves.  The
// last to arrive resets the count and advances the generation the others
// wait on.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (ld_acquire(bar + 1) == gen) __nanosleep(32);
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

// One read by the whole block: its D distinct gids, ranked, the first maxm
// written; returns D (on every thread).
__device__ int wide_read(const Params& p, int r, unsigned long long* keys) {
  const int base = __ldcg(p.off + r);
  const int n = __ldcg(p.off + r + 1) - base;
  int D = 0;
  if (n <= kWideStage) {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    // (gid, its place in the read): signed order kept by flipping bit 31
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
    // quadratic from device memory: first-occurrence flags into local[]
    // (free since phase C), then each first match's rank
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int v = p.gg[base + j];
      bool first = true;
      for (int k = 0; k < j && first; ++k) first = p.gg[base + k] != v;
      p.local[base + j] = first;
    }
    __syncthreads();
    int c = 0;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      if (!p.local[base + j]) continue;
      ++c;
      const int v = p.gg[base + j];
      int d = 0;
      for (int k = 0; k < n; ++k) d += p.local[base + k] && p.gg[base + k] < v;
      if (d < p.maxm) put(p, r, d, v, p.g1[base + j], p.g2[base + j]);
    }
    block_exclusive_sum(c, &D);
  }
  for (int k = threadIdx.x; k < p.maxm; k += kThreads)
    if (k >= D) put(p, r, k, kBig, 0, 0);
  if (threadIdx.x == 0 && D > p.maxm) atomicAdd(p.overflow, D - p.maxm);
  __syncthreads();  // keys are reused by the block's next wide read
  return D;
}

template <int LANES>
__global__ void __launch_bounds__(kThreads)
match_assemble_kernel(Params p) {
  constexpr int CAP = LANES * kStagePerLane;  // matches a group stages
  constexpr int R = kThreads / LANES;         // groups a block
  __shared__ unsigned long long smem[kWideStage];
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int n = min(max(__ldg(p.counts), 0), p.kp);
  const int T = (p.B + kThreads - 1) / kThreads;

  // A. each match's index within its read; the reads' and tiles' counts
  if (tid == 0) {
    *p.overflow = 0;
    *p.wide_n = 0;
  }
  for (int i = tid; i < n; i += stride) {
    const int r = read_of(p, i);
    int k = -1;
    if (r >= 0) {
      k = atomicAdd(p.cnt + r, 1);
      atomicAdd(p.part + (r >> kTileLog), 1);
    }
    p.local[i] = k;
  }
  grid_sync(p.bar);

  // B. off[r]: the tiles before r's, then a block scan of the tile
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    int s = 0;
    for (int u = threadIdx.x; u < t; u += kThreads) s += __ldcg(p.part + u);
    int prefix, total;
    block_exclusive_sum(s, &prefix);
    const int r = t * kThreads + threadIdx.x;
    const int c = r < p.B ? __ldcg(p.cnt + r) : 0;
    const int e = block_exclusive_sum(c, &total);
    if (r < p.B) {
      p.off[r] = prefix + e;
      p.cnt[r] = 0;
      if (c > CAP) p.wide[atomicAdd(p.wide_n, 1)] = r;
    }
    if (t == T - 1 && threadIdx.x == 0) p.off[p.B] = prefix + total;
  }
  grid_sync(p.bar);

  // C. the payloads into their read's run
  for (int u = tid; u < T; u += stride) p.part[u] = 0;
  for (int i = tid; i < n; i += stride) {
    const int k = p.local[i];
    if (k < 0) continue;
    const int at = __ldcg(p.off + read_of(p, i)) + k;
    const int32_t* pr = p.prec + 3ll * __ldg(p.me + i);
    p.gg[at] = __ldg(pr);
    p.g1[at] = __ldg(pr + 1);
    p.g2[at] = __ldg(pr + 2);
  }
  grid_sync(p.bar);

  // D. wide reads, one block each, then every other read by a group
  const int wn = __ldcg(p.wide_n);
  for (int w = blockIdx.x; w < wn; w += gridDim.x)
    wide_read(p, __ldcg(p.wide + w), smem);

  int* stage = reinterpret_cast<int*>(smem);                       // [R * CAP]
  uint8_t* flag = reinterpret_cast<uint8_t*>(stage + R * CAP);      // [R * CAP]
  const int lane = threadIdx.x & (LANES - 1), grp = threadIdx.x / LANES;
  const int gbase = (threadIdx.x & 31) & ~(LANES - 1);
  const unsigned gmask = LANES == 32 ? kFull : ((1u << LANES) - 1u) << gbase;
  int* sg = stage + grp * CAP;
  uint8_t* sf = flag + grp * CAP;
  for (int r = blockIdx.x * R + grp; r < p.B; r += gridDim.x * R) {
    const int base = __ldcg(p.off + r);
    const int m = __ldcg(p.off + r + 1) - base;
    if (m > CAP) continue;  // a wide read, written above
    int g[kStagePerLane], x1[kStagePerLane], x2[kStagePerLane];
#pragma unroll
    for (int t = 0; t < kStagePerLane; ++t) {
      const int j = lane + t * LANES;
      g[t] = kBig;
      x1[t] = x2[t] = 0;
      if (j < m) {
        g[t] = __ldcg(p.gg + base + j);
        x1[t] = __ldcg(p.g1 + base + j);
        x2[t] = __ldcg(p.g2 + base + j);
      }
    }
#pragma unroll
    for (int t = 0; t < kStagePerLane; ++t)
      if (lane + t * LANES < m) sg[lane + t * LANES] = g[t];
    __syncwarp(gmask);
    bool first[kStagePerLane];
#pragma unroll
    for (int t = 0; t < kStagePerLane; ++t) {
      const int j = lane + t * LANES;
      first[t] = j < m;
      for (int k = 0; k < j && first[t]; ++k) first[t] = sg[k] != g[t];
      if (j < m) sf[j] = first[t];
    }
    __syncwarp(gmask);
    unsigned nfirst = 0;
#pragma unroll
    for (int t = 0; t < kStagePerLane; ++t) {
      if (!first[t]) continue;
      ++nfirst;
      int d = 0;
      for (int k = 0; k < m; ++k) d += sf[k] && sg[k] < g[t];
      if (d < p.maxm) put(p, r, d, g[t], x1[t], x2[t]);
    }
    const int D = (int)__reduce_add_sync(gmask, nfirst);
    for (int k = lane; k < p.maxm; k += LANES)
      if (k >= D) put(p, r, k, kBig, 0, 0);
    if (lane == 0 && D > p.maxm) atomicAdd(p.overflow, D - p.maxm);
    __syncwarp(gmask);  // the stage is reused by the group's next read
  }
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

// The 18 arguments, int64 each (pointers as addresses): mrow, me, counts,
// prec, kp, O, B, maxm, eu, slots, rid1, rid2, in_u, overflow, state
// (int32 [2 + bcap + ceil(bcap / 256)]: the barrier's two words, cnt,
// part; zero at rest), bcap, scratch (int32 [4 kp + 2 B + 2]), stream.
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
  const long long bcap = a[15];
  p.bar = (unsigned*)state;
  p.cnt = state + 2;
  p.part = state + 2 + bcap;
  int32_t* s = (int32_t*)a[16];
  const long long kp = p.kp, B = p.B;
  p.local = s;
  p.gg = s + kp;
  p.g1 = s + 2 * kp;
  p.g2 = s + 3 * kp;
  p.off = s + 4 * kp;
  p.wide = s + 4 * kp + B + 1;
  p.wide_n = s + 4 * kp + 2 * B + 1;
  const int lanes = lanes_for(p.maxm);
  const Kernel fn = kernel_for(lanes);
  int blocks = 0, per_sm = 0;
  cudaError_t err = grid_blocks(p.kp, p.B, lanes, &blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks), dim3(kThreads),
                                    args, 0, (cudaStream_t)a[17]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch for kp, B and maxm, into out[7]: lanes a read, reads a
// group-path block, blocks, threads a block, registers a thread, resident
// blocks an SM, static shared bytes a block.
extern "C" int cammiq_match_assemble_geometry(int kp, int B, int maxm, int* out) {
  const int lanes = lanes_for(maxm);
  const Kernel fn = kernel_for(lanes);
  int blocks = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) err = grid_blocks(kp, B, lanes, &blocks, &per_sm);
  const int vals[7] = {lanes, kThreads / lanes, blocks, kThreads, attr.numRegs,
                       per_sm, (int)attr.sharedSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = err == cudaSuccess ? vals[i] : 0;
  return (int)err;
}
