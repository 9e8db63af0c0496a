// Kernel 3: cuckoo span lookup + bucket-scan verify, emitting a compacted
// match list.
//
// Replaces query/sortjoin.py:_cuckoo_pos/_cuckoo_lookup (214-223, 323-341),
// the bucket scan with _verify (1142-1239) and the found-slot compaction
// (1268-1282: a sort of the [K, n_colors] found slots cut to the static
// capacity KP, with the matches beyond it counted as overflow_hits).  JAX
// kept three forms of the scan (unrolled selects, unrolled scatter,
// segment-expanded) only to bound TPU program size; one loop here covers
// every max_bucket and n_colors.
//
// Input: probe_bloom's survivors - rows[0..n) (row = read * O + offset)
// and their 32-bit prefix hashes - with n read from device memory, so the
// host never learns it.  The grid is persistent (as many blocks as fit on
// the card at once) and walks the survivors with a grid-stride loop
// bounded by *n.  Per survivor, one thread:
//   - loads both cuckoo sides' 48-byte rows (three 16-byte loads each)
//     before using either, and takes the (start, count) span of its hash
//     (side 0 wins, as jnp.where(f1, ...) does);
//   - recomputes its kw probe words from the int8 codes;
//   - walks erec[start .. start+count) from the end: an entry matches when
//     its length fits the rest of the read and every length-masked 2-bit
//     word is equal.  JAX's found[i, color] keeps the LAST match of each
//     color (later c overwrites earlier); walking backwards, the first
//     match of a color is that one, and a bit mask skips the color after
//     it (n_colors <= 64).
// Each kept match appends (row, e) to the output with a warp-aggregated
// atomic (one atomicAdd per group of lanes that match together): slots
// below KP are written; counts[0] gets every match, counts[1] those beyond
// KP (the session widens KP and re-runs the pass when it is nonzero).
// The list's order is not deterministic; every later step sorts it on
// read << 31 | gid, and equal (read, gid) rows carry equal payloads.
//
// Bound on the card: dependent random gathers - two 48-byte cuckoo rows
// per survivor (a 0.4 GB table at config #3), then count x (kw+1)*4-byte
// erec rows (0.3 GB); 8 bytes in and 8 out per survivor and match.
// Loading both cuckoo rows at once halves the dependent latency of the
// lookup; spans are short (max_bucket 4 at config #3), so threads of a
// warp diverging on span length cost little.
#include <cooperative_groups.h>

#include "cammiq_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 4;      // CUCKOO_SLOTS
constexpr int kRegWords = 16;  // probe words kept in registers

struct Side {
  bool found;
  uint32_t start, count;
};

// one side's row: keys [0, 4), starts [4, 8), counts [8, 12)
__device__ __forceinline__ Side cuckoo_side(const uint4 (&r)[3], uint32_t key) {
  const uint32_t k[kSlots] = {r[0].x, r[0].y, r[0].z, r[0].w};
  const uint32_t st[kSlots] = {r[1].x, r[1].y, r[1].z, r[1].w};
  const uint32_t ct[kSlots] = {r[2].x, r[2].y, r[2].z, r[2].w};
  Side s{false, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool hit = k[i] == key && ct[i] > 0u;
    s.found |= hit;
    s.start += hit ? st[i] : 0u;
    s.count += hit ? ct[i] : 0u;
  }
  return s;
}

__device__ __forceinline__ void load_row(const uint4* tab, uint32_t pos,
                                         uint4 (&r)[3]) {
  const uint4* p = tab + (size_t)pos * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = __ldg(p + i);
}

// append (row, e): one atomic per group of lanes that append together
__device__ __forceinline__ void append(int32_t row, int32_t e,
                                       int32_t* __restrict__ mrow,
                                       int32_t* __restrict__ me, int kp,
                                       int32_t* __restrict__ counts) {
  cg::coalesced_group g = cg::coalesced_threads();
  const int size = (int)g.size();
  int base = 0;
  if (g.thread_rank() == 0) {
    base = atomicAdd(counts, size);
    const int over = min(max(base + size - kp, 0), size);
    if (over) atomicAdd(counts + 1, over);
  }
  base = g.shfl(base, 0);
  const int slot = base + (int)g.thread_rank();
  if (slot < kp) {
    mrow[slot] = row;
    me[slot] = e;
  }
}

__global__ void __launch_bounds__(kThreads)
cuckoo_verify_kernel(const int32_t* __restrict__ rows,
                     const uint32_t* __restrict__ keys,
                     const int32_t* __restrict__ n_in,
                     const int8_t* __restrict__ codes, int Lp, int O,
                     const int32_t* __restrict__ lengths,
                     const uint4* __restrict__ cuckoo, int tlog,
                     const uint32_t* __restrict__ erec, int kw, long long E,
                     int n_colors, int32_t* __restrict__ mrow,
                     int32_t* __restrict__ me, int kp,
                     int32_t* __restrict__ counts) {
  const int n = *n_in;
  const int stride = kw + 1;
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < n;
       k += gridDim.x * kThreads) {
    const int32_t row = rows[k];
    const uint32_t key = keys[k];

    // _cuckoo_pos(which=0 / which=1); both rows in flight before either
    // is used
    const uint32_t p0 = (key * 0x9E3779B1u) >> (32 - tlog);
    uint32_t z = (key ^ 0x85EBCA6Bu) * 0xC2B2AE35u;
    z ^= z >> 15;
    const uint32_t p1 = z >> (32 - tlog);
    uint4 r0[3], r1[3];
    load_row(cuckoo, p0, r0);
    load_row(cuckoo, p1, r1);
    const Side s0 = cuckoo_side(r0, key);
    const Side s1 = cuckoo_side(r1, key);
    if (!s0.found && !s1.found) continue;
    const long long start = (long long)(int32_t)(s0.found ? s0.start : s1.start);
    const int count = (int32_t)(s0.found ? s0.count : s1.count);

    const int r = row / O;
    const int o = row - r * O;
    const int8_t* read = codes + (long long)r * Lp;
    uint32_t pw[kRegWords];
#pragma unroll
    for (int w = 0; w < kRegWords; ++w)
      pw[w] = w < kw ? pack16(read, Lp, o + 16 * w) : 0u;
    const int avail = lengths[r] - o;

    unsigned long long kept = 0;  // colors whose last match is emitted
    for (int c = count - 1; c >= 0; --c) {
      const long long e = start + c < E - 1 ? start + c : E - 1;
      const uint32_t* er = erec + e * stride;
      const uint32_t tail = __ldg(er + kw);
      const int elen = (int)(tail & 0xFFFFu);
      const int ecol = (int)(tail >> 16);
      if (elen > avail || ecol >= n_colors || ((kept >> ecol) & 1ull)) continue;
      bool ok = true;
#pragma unroll
      for (int w = 0; w < kRegWords; ++w) {
        if (w < kw && ok) {
          const int nb = min(max(elen - 16 * w, 0), 16);
          ok = (pw[w] & base_mask(nb)) == __ldg(er + w);
        }
      }
      for (int w = kRegWords; w < kw && ok; ++w) {
        const int nb = min(max(elen - 16 * w, 0), 16);
        ok = (pack16(read, Lp, o + 16 * w) & base_mask(nb)) == __ldg(er + w);
      }
      if (ok) {
        kept |= 1ull << ecol;
        append(row, (int32_t)e, mrow, me, kp, counts);
      }
    }
  }
}

// persistent grid: as many blocks as are resident at once on the card
cudaError_t grid_blocks(int* out) {
  static int blocks[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!blocks[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cuckoo_verify_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = blocks[dev];
  return cudaSuccess;
}

}  // namespace

// rows int32 / keys uint32 [cap] with their count n (int32 [1], on the
// device), int8 codes [B, Lp], int32 lengths [B], the cuckoo table
// [2^tlog, 12], erec [E, kw + 1]; outputs mrow / me int32 [kp] and counts
// int32 [2] = (matches found, matches beyond kp).
extern "C" int cammiq_cuckoo_verify(const void* rows, const void* keys,
                                    const void* n, int cap, const void* codes,
                                    int Lp, int O, const void* lengths,
                                    const void* cuckoo, int tlog,
                                    const void* erec, int kw, long long E,
                                    int n_colors, void* mrow, void* me, int kp,
                                    void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess || cap == 0) return (int)err;
  int blocks = 0;
  err = grid_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  cuckoo_verify_kernel<<<blocks, kThreads, 0, s>>>(
      (const int32_t*)rows, (const uint32_t*)keys, (const int32_t*)n,
      (const int8_t*)codes, Lp, O, (const int32_t*)lengths,
      (const uint4*)cuckoo, tlog, (const uint32_t*)erec, kw, E, n_colors,
      (int32_t*)mrow, (int32_t*)me, kp, (int32_t*)counts);
  return (int)cudaGetLastError();
}
