// Kernel 2: probe words + h-prefix hash + blocked-bloom membership, and the
// stream compaction of the rows that pass it.
//
// Replaces, fused into one pass: query/probe.py:pack_rolling16, the kw-word
// window stack and prefix masks of query/sortjoin.py:collect_matches_sortjoin
// (867-898), _hash_prefix (411-432), _bloom_bits/_bloom_maybe (130-176) and
// the compaction of the maybe rows (sortjoin.py:929-941: a sort of every
// row's flagged key, cut to a static capacity K1).  JAX materialised the
// [B, Lp] rolling words, the [B*O, kw] window stack and the [N] maybe mask
// in HBM.  Here nothing of size N but the survivors leaves the chip:
//
//   out: rows[0..n) = the rows i = b * O + o whose three bloom bits are
//        set, in ascending order (what torch.nonzero(maybe) gives), keys
//        = their 32-bit prefix hashes, and n itself, on the device.  The
//        capacity is N, so the compaction never overflows.
//
// A block owns a tile of R whole reads (one contiguous R * Lp-byte span of
// the [B, Lp] codes, R chosen so a tile holds ~1024 rows):
//   1. it stages the span into shared memory with 16-byte loads (a byte
//      load at each ragged end, whatever the alignment of the span);
//   2. packs each position's 16-base word once, by pack16's OR formula:
//      a shift-register rolling word would not reproduce a -1 code, which
//      pack16 widens to 0xFFFFFFFF (every bit above 2s set);
//   3. hashes each row's h-prefix from the two words it needs and tests
//      it in two levels (four rows in flight per thread at each): the
//      level-1 word, of the bloom OR-folded to fit the L2, then, only for
//      the rows whose three bits are set there, the bloom word itself; the
//      level-2 test is balloted into one bit per row in shared memory;
//   4. takes its output offset from a sum-scan over tiles by decoupled
//      look-back (cammiq_common.cuh, shared with first_of_run: tiles are
//      taken from an atomic counter, one 64-bit status word each), so the
//      order across tiles is kept in one pass;
//   5. writes each survivor's row and key (recomputed from the shared
//      words) at offset + its rank among the tile's set bits.
// The last tile writes n.  Every offset is probed whatever the read's
// length (as JAX does); the length check happens in the verify kernel.
// Optionally each tile adds the rows it sent to level 2 and its survivors
// to counts[0] and counts[1] (one atomic each, from warp 0).
//
// Two levels: the fold merges words (2i, 2i+1) and keeps the bit
// positions (_bloom_bits does not depend on the log), so a key whose bits
// are set in the bloom has them set in the fold, and the survivors are
// those of the bloom alone, bit for bit.  Without a level-1 table every row
// goes to level 2, as before.
//
// Bound on the card: one random 4-byte gather per row.  The bloom at the
// device cap is 2^24 words, 64 MB, larger than the 50 MB L2, so a gather
// there takes a 32-byte HBM sector; the level-1 table (2^22 words, 16 MB,
// on the H100: query/sortjoin.py:level1_log) stays in the L2, and only its
// passers, the true prefix hits and the fold's false positives (4-10% of
// the rows at configs #3 and #4), gather from the bloom.  The codes are
// read once, 8 bytes written per survivor (2.6% of the rows at config #3).
#include "cammiq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 1024;  // rows a tile aims at (whole reads)
constexpr int kIlp = 4;          // gathers in flight per thread at each level
// dynamic shared memory a launch takes without opting in (48 KB less the
// static shared words)
constexpr int kDefaultSmem = 48 * 1024 - 256;

struct Layout {  // dynamic shared memory of one tile
  int stage;     // code bytes staged, 16-byte aligned
  int words;     // uint32 [R * Lp] packed words
  int bits;      // uint32 [nbits] survivor ballots
  int pre;       // uint32 [nbits] exclusive prefix of their popcounts
  int bytes;

  __host__ __device__ Layout(int R, int Lp, int O) {
    const int nb = R * Lp;
    const int nbits = ((R * O + kThreads * kIlp - 1) / (kThreads * kIlp)) * kWarps * kIlp;
    stage = 0;
    words = ((nb + 32 + 15) / 16) * 16;
    bits = words + 4 * nb;
    pre = bits + 4 * nbits;
    bytes = pre + 4 * nbits;
  }
};

__device__ __forceinline__ uint32_t probe_key(const uint32_t* w, int Lp,
                                              int o, int h, uint32_t m0,
                                              uint32_t m1) {
  const uint32_t lo = o < Lp ? w[o] & m0 : 0u;
  const uint32_t hi = (h > 16 && o + 16 < Lp) ? w[o + 16] & m1 : 0u;
  return hash_prefix_lo(lo, hi);
}

// L2 eviction priorities for the two levels' gathers: the table the L2
// holds (the level-1 fold, or a bloom within the L2's budget) loads as
// evict_last, so the batch's other kernels between two launches and the
// level-2 gathers evict it last; the bloom behind a fold loads as
// evict_first, its lines read once.  Measured on the H100 at 65,536 x 100
// against a 2^24-word filter: 0.0852 ms against 0.0888 ms without hints,
// 0.0888 against 0.0929 after 40 MB of other writes.
__device__ __forceinline__ uint64_t l2_policy_last() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint64_t l2_policy_first() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint32_t ldg_hint(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__global__ void __launch_bounds__(kThreads)
probe_bloom_kernel(const int8_t* __restrict__ codes, int B, int Lp, int O,
                   int h, int R, int ntiles, const uint32_t* __restrict__ bloom,
                   int bloom_log, const uint32_t* __restrict__ l1, int l1_log,
                   int32_t* __restrict__ rows_out,
                   uint32_t* __restrict__ keys_out, int32_t* __restrict__ n_out,
                   unsigned* __restrict__ counts,
                   unsigned long long* __restrict__ status,
                   unsigned* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tile;
  __shared__ unsigned s_base;
  __shared__ unsigned s_level2;  // the tile's rows sent to level 2
  const Layout L(R, Lp, O);
  int8_t* stage = reinterpret_cast<int8_t*>(smem + L.stage);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + L.words);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);
  unsigned* pre = reinterpret_cast<unsigned*>(smem + L.pre);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    s_tile = (int)atomicAdd(counter, 1u);
    s_level2 = 0;
  }
  __syncthreads();
  const int t = s_tile;
  const int b0 = t * R;
  const int rb = min(R, B - b0);  // reads in this tile
  const int nb = rb * Lp;
  const int items = rb * O;

  // 1. stage the codes: aligned 16-byte granules, bytes at the ragged ends
  const int8_t* src = codes + (long long)b0 * Lp;
  const int head = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const int8_t* base = src - head;  // stage[x] holds base[x]
  const int ngran = (head + nb + 15) / 16;
  for (int g = tid; g < ngran; g += kThreads) {
    const int x0 = 16 * g;
    if (x0 >= head && x0 + 16 <= head + nb) {
      *reinterpret_cast<int4*>(stage + x0) =
          __ldg(reinterpret_cast<const int4*>(base + x0));
    } else {
      for (int x = max(x0, head); x < min(x0 + 16, head + nb); ++x) stage[x] = base[x];
    }
  }
  __syncthreads();

  // 2. one word per position, pack16's OR formula
  for (int j = tid; j < nb; j += kThreads) {
    const int r = j / Lp;
    const int p = j - r * Lp;
    const int8_t* row = stage + head + r * Lp;
    uint32_t w = 0;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint32_t c = p + s < Lp ? (uint32_t)(int32_t)row[p + s] : 0u;
      w |= c << (2 * s);
    }
    words[j] = w;
  }
  __syncthreads();

  // 3. hash + the two-level test, one ballot word per warp and row group
  const uint32_t m0 = base_mask(h < 16 ? h : 16);
  const uint32_t m1 = h > 16 ? base_mask(h - 16) : 0u;
  const uint32_t wshift = 32 - bloom_log;
  const uint32_t l1shift = 32 - l1_log;
  const int nbits = ((items + kThreads * kIlp - 1) / (kThreads * kIlp)) * kWarps * kIlp;
  unsigned level2 = 0;  // lane 0: the warp's rows sent to level 2
  const uint64_t resident = l2_policy_last();
  const uint64_t level2_policy = l1 != nullptr ? l2_policy_first() : resident;
  for (int c0 = 0; c0 < items; c0 += kThreads * kIlp) {
    uint32_t key[kIlp], got[kIlp];
    bool live[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int j = c0 + u * kThreads + tid;
      key[u] = 0;
      got[u] = ~0u;
      live[u] = j < items;
      if (live[u]) {
        const int r = j / O;
        key[u] = probe_key(words + r * Lp, Lp, j - r * O, h, m0, m1);
        if (l1 != nullptr) got[u] = ldg_hint(l1 + (key[u] >> l1shift), resident);
      }
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {  // level 2, the level-1 passers only
      const uint32_t need = bloom_bits(key[u]);
      live[u] = live[u] && (got[u] & need) == need;
      got[u] = live[u] ? ldg_hint(bloom + (key[u] >> wshift), level2_policy) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const uint32_t need = bloom_bits(key[u]);
      const unsigned sent = __ballot_sync(0xFFFFFFFFu, live[u]);
      const unsigned ballot =
          __ballot_sync(0xFFFFFFFFu, live[u] && (got[u] & need) == need);
      if (lane == 0) {
        bits[(c0 + u * kThreads) / 32 + warp] = ballot;
        level2 += __popc(sent);
      }
    }
  }
  if (counts != nullptr && lane == 0) atomicAdd(&s_level2, level2);
  __syncthreads();

  // 4. the tile's count and the exclusive prefix of each ballot word (warp
  // 0), then its output offset by look-back
  if (warp == 0) {
    unsigned run = 0;
    for (int k0 = 0; k0 < nbits; k0 += 32) {
      const int k = k0 + lane;
      const unsigned c = k < nbits ? __popc(bits[k]) : 0u;
      unsigned inc = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
        if (lane >= d) inc += y;
      }
      if (k < nbits) pre[k] = run + inc - c;
      run += __shfl_sync(0xFFFFFFFFu, inc, 31);
    }
    if (lane == 0)  // publish before looking back
      store_status(status + t, t == 0 ? kStatePrefix : kStateAggregate, run);
    const unsigned excl = t > 0 ? look_back(status, t, 0u, SumOp()) : 0u;
    if (lane == 0) {
      if (t > 0) store_status(status + t, kStatePrefix, excl + run);
      if (t == ntiles - 1) *n_out = (int32_t)(excl + run);
      s_base = excl;
      if (counts != nullptr) {
        atomicAdd(counts, s_level2);
        atomicAdd(counts + 1, run);
      }
    }
  }
  __syncthreads();

  // 5. survivors, in row order
  const int row0 = b0 * O;  // rows of a tile are contiguous: i = b0 * O + j
  for (int j = tid; j < items; j += kThreads) {
    const unsigned word = bits[j >> 5];
    const unsigned below = word & ((1u << (j & 31)) - 1u);
    if ((word >> (j & 31)) & 1u) {
      const unsigned pos = s_base + pre[j >> 5] + __popc(below);
      const int r = j / O;
      rows_out[pos] = row0 + j;
      keys_out[pos] = probe_key(words + r * Lp, Lp, j - r * O, h, m0, m1);
    }
  }
}

}  // namespace

// Reads a tile holds: ~kTileRows rows, halved until the tile's shared
// memory fits the default; one read of a longer Lp opts in to more.
static int tile_reads(int B, int Lp, int O) {
  int R = (kTileRows + O - 1) / O;
  if (R > B) R = B;
  while (R > 1 && Layout(R, Lp, O).bytes > kDefaultSmem) R = (R + 1) / 2;
  return R;
}

extern "C" int cammiq_probe_bloom_tiles(int B, int Lp, int h) {
  const int O = Lp - h + 1 > 1 ? Lp - h + 1 : 1;
  if (B <= 0) return 0;
  const int R = tile_reads(B, Lp, O);
  return (B + R - 1) / R;
}

// codes int8 [B, Lp]; the level-1 table l1 [2^l1_log] (null: one level);
// outputs rows int32 [N], keys uint32 [N], n int32 [1] (N = B * O);
// counts int32 [2] (null: none) += the rows sent to level 2, the survivors;
// scratch: 8 * (tiles + 1) bytes for the tile statuses and the tile
// counter (cammiq_probe_bloom_tiles gives the tile count).
extern "C" int cammiq_probe_bloom(const void* codes, int B, int Lp, int h,
                                  const void* bloom, int bloom_log,
                                  const void* l1, int l1_log,
                                  void* rows, void* keys, void* n,
                                  void* counts, void* scratch, void* stream) {
  const int O = Lp - h + 1 > 1 ? Lp - h + 1 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaMemsetAsync(n, 0, sizeof(int32_t), s);
  const int R = tile_reads(B, Lp, O);
  const int ntiles = (B + R - 1) / R;
  const int smem = Layout(R, Lp, O).bytes;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        probe_bloom_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (ntiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  auto* status = (unsigned long long*)scratch;
  probe_bloom_kernel<<<ntiles, kThreads, smem, s>>>(
      (const int8_t*)codes, B, Lp, O, h, R, ntiles, (const uint32_t*)bloom,
      bloom_log, (const uint32_t*)l1, l1_log, (int32_t*)rows, (uint32_t*)keys,
      (int32_t*)n, (unsigned*)counts, status, (unsigned*)(status + ntiles));
  return (int)cudaGetLastError();
}

extern "C" const char* cammiq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
