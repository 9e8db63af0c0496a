// The gather engine's probe: for every (read, offset), both strands, both
// FlatIndex tables, the matched entry as a match slot.
//
// Replaces cammiq_tpu/query/classify.py:collect_matches (78-137) around
// cammiq_tpu/query/probe.py:probe_strand (129-193), both XLA.  JAX builds
// the [B, Lp] rolling words of both strands, the [B, O] window words, and
// walks max_probes table gathers and max_bucket entry gathers over every
// (read, offset) in lockstep, whatever each one found.  Here one thread
// owns one output slot and stops at its first hit:
//
//   out: slots, rid1, rid2 int32 and in_u bool [B, 4 O], O = max(Lp - h +
//        1, 1), columns [unique fwd | unique rc | doubly fwd | doubly rc];
//        slot = entry + base or BIG, rid1/rid2 of the entry or 0.
//
// A block owns a tile of R whole reads:
//   1. it stages their codes into shared memory;
//   2. packs every position's 16-base word of the forward strand
//      (cammiq_common.cuh:pack16) and of the reverse complement (rc[t] =
//      3 - codes[len-1-t] for t < len, else 0, as an int8: a -1 becomes 4,
//      whose bit 2 spills into the next field, as JAX's uint32 OR does);
//   3. one thread per output slot (o fastest, so the writes coalesce):
//      the h-prefix (lo, hi) from the window words W_w = word[o + 16 w]
//      (0 at or past Lp), hash_prefix & (T - 1), up to max_probes linear
//      steps over 16-byte table rows taking the FIRST with lo, hi equal and
//      start >= 0 (no stop at an empty row: JAX walks them all), then up to
//      min(count, max_bucket) entries taking the FIRST whose length fits
//      the read (len - o) and whose kw key words all equal the masked
//      window words.  Both early exits are exact: JAX keeps the first hit.
//
// Bound on the card: a miss reads max_probes contiguous table rows (one or
// a few sectors), a table hit one entry record (32 bytes) per entry
// scanned; the codes are read once and 13 bytes are written per slot.
// The table rows are random reads into a table larger than the L2, so each
// thread's chain of dependent loads (row, then record) sets the time;
// many threads in flight (one per slot) hide it.
#include "cammiq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSlots = 256;  // (read, offset) rows a tile aims at
constexpr int kDefaultSmem = 48 * 1024;
constexpr int32_t kBig = 0x7FFFFFFF;

struct Table {
  const uint32_t* erec;  // [E, rw]: kw key words, length, rid1, rid2
  const int4* trec;      // [T]: lo, hi, start, count
  int E, rw, kw;
  uint32_t tmask;
  int probes, bucket, base;
};

// cammiq_tpu/index/table.py:hash_prefix (the flat tables' hash, not the
// sort join's _hash_prefix)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t flat_hash_prefix(uint32_t lo, uint32_t hi) {
  return mix32(lo ^ mix32(hi + 0x9E3779B9u));
}

// shared memory of a tile: codes (R * Lp bytes, rounded up to 16), then
// the forward and reverse words (R * Lp each)
__host__ __device__ inline int smem_bytes(int R, int Lp) {
  return ((R * Lp + 15) / 16) * 16 + 8 * R * Lp;
}

// probe_strand for one (offset, strand, table), written to output slot i:
// the first table row of the prefix, then the first entry that fits
__device__ __forceinline__ void probe(
    const Table& t, const uint32_t* words, int Lp, int o, int avail, int h,
    uint32_t m0, uint32_t m1, long long i, bool unique,
    int32_t* __restrict__ slots, int32_t* __restrict__ rid1,
    int32_t* __restrict__ rid2, bool* __restrict__ in_u) {
  auto W = [&](int w) -> uint32_t {
    const int x = o + 16 * w;
    return x < Lp ? words[x] : 0u;
  };
  const uint32_t lo = W(0) & m0;
  const uint32_t hi = h > 16 ? W(1) & m1 : 0u;
  const uint32_t slot0 = flat_hash_prefix(lo, hi) & t.tmask;
  int bstart = -1, bcount = 0;
  for (int p = 0; p < t.probes; ++p) {
    const int4 r = __ldg(t.trec + ((slot0 + (uint32_t)p) & t.tmask));
    if ((uint32_t)r.x == lo && (uint32_t)r.y == hi && r.z >= 0) {
      bstart = r.z;
      bcount = r.w;
      break;
    }
  }
  int found = -1;
  const int n = bstart < 0 ? 0 : min(bcount, t.bucket);
  for (int c = 0; c < n; ++c) {
    const int e = min(bstart + c, t.E - 1);
    const uint32_t* rec = t.erec + (long long)e * t.rw;
    const int elen = (int)__ldg(rec + t.kw);
    if (elen > avail) continue;
    bool match = true;
    for (int w = 0; w < t.kw; ++w) {
      const int nb = min(max(elen - 16 * w, 0), 16);
      match &= (W(w) & base_mask(nb)) == __ldg(rec + w);
    }
    if (match) {
      found = e;
      break;
    }
  }
  if (found < 0) {
    slots[i] = kBig;
    rid1[i] = 0;
    rid2[i] = 0;
    in_u[i] = false;
  } else {
    const uint32_t* rec = t.erec + (long long)found * t.rw;
    slots[i] = found + t.base;
    rid1[i] = (int32_t)__ldg(rec + t.kw + 1);
    rid2[i] = (int32_t)__ldg(rec + t.kw + 2);
    in_u[i] = unique;
  }
}

__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(const int8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths, int B, int Lp, int O,
                    int h, int R, Table tu, Table td,
                    int32_t* __restrict__ slots, int32_t* __restrict__ rid1,
                    int32_t* __restrict__ rid2, bool* __restrict__ in_u) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b0 = blockIdx.x * R;
  const int rb = min(R, B - b0);
  const int nb = rb * Lp;
  int8_t* stage = reinterpret_cast<int8_t*>(smem);
  uint32_t* fwd = reinterpret_cast<uint32_t*>(smem + ((R * Lp + 15) / 16) * 16);
  uint32_t* rev = fwd + R * Lp;
  const int tid = threadIdx.x;

  // 1. the tile's codes
  const int8_t* src = codes + (long long)b0 * Lp;
  for (int x = tid; x < nb; x += kThreads) stage[x] = src[x];
  __syncthreads();

  // 2. both strands' words
  for (int j = tid; j < nb; j += kThreads) {
    const int r = j / Lp;
    const int p = j - r * Lp;
    const int8_t* row = stage + r * Lp;
    const int len = lengths[b0 + r];
    fwd[j] = pack16(row, Lp, p);
    uint32_t w = 0;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int x = p + s;
      uint32_t c = 0;
      if (x < Lp && x < len) {
        const int q = min(max(len - 1 - x, 0), Lp - 1);
        c = (uint32_t)(int32_t)(int8_t)(3 - (int)row[q]);
      }
      w |= c << (2 * s);
    }
    rev[j] = w;
  }
  __syncthreads();

  // 3. one thread per output slot: k = column group, then read, offset
  const uint32_t m0 = base_mask(h < 16 ? h : 16);
  const uint32_t m1 = h > 16 ? base_mask(h - 16) : 0u;
  const int per_k = rb * O;
  const int S = 4 * O;
  for (int j = tid; j < 4 * per_k; j += kThreads) {
    const int k = j / per_k;
    const int rem = j - k * per_k;
    const int r = rem / O;
    const int o = rem - r * O;
    const uint32_t* words = (k & 1 ? rev : fwd) + r * Lp;
    const int avail = lengths[b0 + r] - o;
    const long long i = (long long)(b0 + r) * S + k * O + o;
    if (k < 2)
      probe(tu, words, Lp, o, avail, h, m0, m1, i, true, slots, rid1, rid2, in_u);
    else
      probe(td, words, Lp, o, avail, h, m0, m1, i, false, slots, rid1, rid2, in_u);
  }
}

}  // namespace

// Reads a tile holds: ~kTileSlots (read, offset) rows, halved until its
// shared memory fits the default; one read of a longer Lp opts in to more.
static int gather_tile_reads(int B, int Lp, int O) {
  int R = (kTileSlots + O - 1) / O;
  if (R > B) R = B;
  while (R > 1 && smem_bytes(R, Lp) > kDefaultSmem) R = (R + 1) / 2;
  return R;
}

static Table make_table(const void* erec, int E, int rw, int kw,
                        const void* trec, int tbits, int probes, int bucket,
                        int base) {
  Table t;
  t.erec = (const uint32_t*)erec;
  t.trec = (const int4*)trec;
  t.E = E;
  t.rw = rw;
  t.kw = kw;
  t.tmask = tbits >= 32 ? 0xFFFFFFFFu : ((1u << tbits) - 1u);
  t.probes = probes;
  t.bucket = bucket;
  t.base = base;
  return t;
}

// codes int8 [B, Lp], lengths int32 [B]; per table: erec int32 [E, rw],
// trec int32 [2^tbits, 4], max_probes, max_bucket, id base; outputs slots,
// rid1, rid2 int32 and in_u bool [B, 4 O].  B * 4 O < 2^31.
extern "C" int cammiq_gather_probe(
    const void* codes, const void* lengths, int B, int Lp, int h,
    const void* u_erec, int u_E, int u_rw, int u_kw, const void* u_trec,
    int u_tbits, int u_probes, int u_bucket, int u_base,
    const void* d_erec, int d_E, int d_rw, int d_kw, const void* d_trec,
    int d_tbits, int d_probes, int d_bucket, int d_base,
    void* slots, void* rid1, void* rid2, void* in_u, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int O = Lp - h + 1 > 1 ? Lp - h + 1 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  const int R = gather_tile_reads(B, Lp, O);
  const int smem = smem_bytes(R, Lp);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Table tu = make_table(u_erec, u_E, u_rw, u_kw, u_trec, u_tbits,
                              u_probes, u_bucket, u_base);
  const Table td = make_table(d_erec, d_E, d_rw, d_kw, d_trec, d_tbits,
                              d_probes, d_bucket, d_base);
  gather_probe_kernel<<<(B + R - 1) / R, kThreads, smem, s>>>(
      (const int8_t*)codes, (const int32_t*)lengths, B, Lp, O, h, R, tu, td,
      (int32_t*)slots, (int32_t*)rid1, (int32_t*)rid2, (bool*)in_u);
  return (int)cudaGetLastError();
}
