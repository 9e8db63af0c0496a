// The gather engine's probe: for every (read, offset), both strands, both
// FlatIndex tables, the matched entry as a match slot.
//
// Replaces cammiq_tpu/query/classify.py:collect_matches (78-137) around
// cammiq_tpu/query/probe.py:probe_strand (129-193), both XLA.  JAX builds
// the [B, Lp] rolling words of both strands, the [B, O] window words, and
// walks max_probes table gathers and max_bucket entry gathers over every
// (read, offset) in lockstep, whatever each one found.  Here a thread
// stops each walk as soon as its answer is known:
//
//   out: slots, rid1, rid2 int32 and in_u bool [B, 4 O], O = max(Lp - h +
//        1, 1), columns [unique fwd | unique rc | doubly fwd | doubly rc];
//        slot = entry + base or BIG, rid1/rid2 of the entry or 0.
//
// A block owns a tile of R whole reads:
//   1. it stages their codes and lengths into shared memory;
//   2. packs every position's 16-base word of the forward strand
//      (cammiq_common.cuh:pack16), stages the reverse complement (rc[t] =
//      3 - codes[len-1-t] for t < len, else 0, as an int8: a -1 becomes 4,
//      whose bit 2 spills into the next field, as JAX's uint32 OR does)
//      and packs its words the same way;
//   3. one thread per (strand, read, offset), offset fastest so the writes
//      coalesce: the h-prefix (lo, hi) from the window words W_w =
//      word[o + 16 w] (0 at or past Lp) and its hash, then a walk in each
//      table from hash & (T - 1), the two walks stepped together, then
//      in each table's bucket up to min(count, max_bucket) entries taking
//      the FIRST whose length fits the read (len - o) and whose kw key
//      words all equal the masked window words; two output slots written.
//
// A walk stops at the first row that holds the prefix (start >= 0, lo and
// hi equal: a hit) or is empty (start < 0: a miss), capped at max_probes
// rows and wrapping with & (T - 1) as JAX's does.  Stopping at an empty
// row gives JAX's answer bit for bit.  Both builders of device tables
// place buckets with index/table.py:_assign_slots, in hash order, slot_i =
// max(h_i, slot_{i-1} + 1), and never past row T - 1 (they grow the table
// instead).  So a bucket stored at row s with hash h has every row of
// [h, s] occupied, and each prefix has one row.  A probe of hash h that
// meets an empty row r before its prefix cannot find it at a row past r,
// nor after wrapping (its row is >= h); JAX's walk finds nothing either.
// query/probe.py:stage_index checks this invariant of every table it
// stages and raises on a table that breaks it.  The stop test is start <
// 0, never a key compare: an empty row has lo = hi = 0, as does a read
// whose h-prefix is all A.  The first matching row and the first fitting
// entry are exact early exits too: JAX keeps the first hit.
//
// Bound on the card: per probe, the table rows up to its hit or its first
// empty row (about 2.2 rows of 16 bytes at the unique table's load factor
// 0.46), one entry record per entry scanned; the codes are read once and
// 13 bytes are written per slot.  The unique table is larger than the L2,
// so its walks are random DRAM reads, one 32-byte sector (two rows) per
// step; a walk's sector is loaded whole before any compare, and the two
// tables' walks of one prefix load together, so one or two round trips
// end nearly every pair of walks instead of a chain of dependent row
// loads.  Small tiles (one read of 100 bases: 150 threads' work) keep many
// blocks resident, so one block's staging overlaps others' walks.  What
// still holds it back is latency: each block is a chain of a codes load,
// four barriers and one or two walk round trips per item (PERF.md).
#include "cammiq_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileItems = 128;  // (strand, read, offset) items a tile aims at
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

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// shared memory of a tile: codes (R * Lp bytes), lengths (R ints), then
// the forward and reverse words (R * Lp each)
__host__ __device__ inline int smem_bytes(int R, int Lp) {
  return round16(R * Lp) + round16(4 * R) + 8 * R * Lp;
}

// One table's walk for prefix (lo, hi): rows slot0, slot0 + 1, ...
// (masked), at most t.probes, one 32-byte sector (two rows) at a time.
// The first sector holds slot0 and, if slot0 is even, the row after it.
// It ends at the first row holding the prefix (b = its start, count) or
// at an empty row or the cap (b.x = -1).
struct Walk {
  uint32_t slot0;
  int p;  // walk index of the sector's first row (-1: the row before slot0)
  bool done;
  int2 b;
};

__device__ __forceinline__ Walk walk_start(const Table& t, uint32_t hash) {
  const uint32_t slot0 = hash & t.tmask;
  return Walk{slot0, -(int)(slot0 & 1u), false, make_int2(-1, 0)};
}

struct Sector {
  int4 a, b;  // rows p and p + 1 of a walk
};

__device__ __forceinline__ int4 walk_row(const Table& t, const Walk& w, int q) {
  return !w.done && q >= 0 && q < t.probes
             ? __ldg(t.trec + ((w.slot0 + (uint32_t)q) & t.tmask))
             : make_int4(0, 0, -1, 0);
}

__device__ __forceinline__ Sector walk_load(const Table& t, const Walk& w) {
  return Sector{walk_row(t, w, w.p), walk_row(t, w, w.p + 1)};
}

// ends the walk at row r (walk index q) if it is empty or holds the prefix
__device__ __forceinline__ bool walk_row_ends(Walk& w, int4 r, int q, uint32_t lo,
                                              uint32_t hi) {
  if (q < 0) return false;  // the sector's row before slot0
  if (r.z >= 0 && ((uint32_t)r.x != lo || (uint32_t)r.y != hi)) return false;
  w.done = true;            // an empty row (or past the cap) is a miss
  if (r.z >= 0) w.b = make_int2(r.z, r.w);
  return true;
}

__device__ __forceinline__ void walk_check(const Table& t, Walk& w, Sector sec,
                                           uint32_t lo, uint32_t hi) {
  if (w.done || walk_row_ends(w, sec.a, w.p, lo, hi) ||
      walk_row_ends(w, sec.b, w.p + 1, lo, hi))
    return;
  w.p += 2;
  w.done = w.p >= t.probes;
}

// The rest of probe_strand for one (offset, strand, table), written to
// output slot i: the first entry of bucket b that fits
__device__ __forceinline__ void finish(
    const Table& t, int2 b, const uint32_t* words, int Lp, int o, int avail,
    long long i, bool unique, int32_t* __restrict__ slots,
    int32_t* __restrict__ rid1, int32_t* __restrict__ rid2,
    bool* __restrict__ in_u) {
  auto W = [&](int w) -> uint32_t {
    const int x = o + 16 * w;
    return x < Lp ? words[x] : 0u;
  };
  int found = -1;
  const int n = b.x < 0 ? 0 : min(b.y, t.bucket);
  for (int c = 0; c < n; ++c) {
    const int e = min(b.x + c, t.E - 1);
    const uint32_t* rec = t.erec + (long long)e * t.rw;
    // the length and the key words are loaded together, compared after
    const int elen = (int)__ldg(rec + t.kw);
    bool match = true;
#pragma unroll 4
    for (int w = 0; w < t.kw; ++w) {
      const int nb = min(max(elen - 16 * w, 0), 16);
      match &= (W(w) & base_mask(nb)) == __ldg(rec + w);
    }
    if (match && elen <= avail) {
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
  int* lens = reinterpret_cast<int*>(smem + round16(R * Lp));
  uint32_t* fwd = reinterpret_cast<uint32_t*>(smem + round16(R * Lp) + round16(4 * R));
  uint32_t* rev = fwd + R * Lp;
  const int tid = threadIdx.x;

  // 1. the tile's codes and lengths
  const int8_t* src = codes + (long long)b0 * Lp;
  for (int x = tid; x < nb; x += kThreads) stage[x] = src[x];
  for (int r = tid; r < rb; r += kThreads) lens[r] = lengths[b0 + r];
  __syncthreads();

  // 2. the forward words, and a copy of the codes in the reverse words'
  // space; from it the reverse complement into the codes' space (rc[t] =
  // 3 - codes[len - 1 - t] for t < len, else 0), and its words
  int8_t* copy = reinterpret_cast<int8_t*>(rev);
  for (int j = tid; j < nb; j += kThreads) {
    const int r = j / Lp;
    fwd[j] = pack16(stage + r * Lp, Lp, j - r * Lp);
    copy[j] = stage[j];
  }
  __syncthreads();
  for (int j = tid; j < nb; j += kThreads) {
    const int r = j / Lp;
    const int t = j - r * Lp;
    const int len = lens[r];
    stage[j] = t < len ? (int8_t)(3 - copy[r * Lp + min(len - 1 - t, Lp - 1)]) : 0;
  }
  __syncthreads();
  for (int j = tid; j < nb; j += kThreads) {
    const int r = j / Lp;
    rev[j] = pack16(stage + r * Lp, Lp, j - r * Lp);
  }
  __syncthreads();

  // 3. one thread per (strand, read, offset), j = (s * rb + r) * O + o:
  // one prefix and hash for the two output slots it gives, the unique
  // table's (column group s) and the doubly table's (s + 2), whose walks
  // step together; (s, r, o) advance by kThreads without a division
  const uint32_t m0 = base_mask(h < 16 ? h : 16);
  const uint32_t m1 = h > 16 ? base_mask(h - 16) : 0u;
  const int per_s = rb * O;
  const int S = 4 * O;
  const int dr = kThreads / O, dO = kThreads - dr * O;
  int s = tid / per_s;
  int r = (tid - s * per_s) / O;
  int o = tid - s * per_s - r * O;
  for (int j = tid; j < 2 * per_s; j += kThreads) {
    const uint32_t* words = (s ? rev : fwd) + r * Lp;
    const uint32_t lo = (o < Lp ? words[o] : 0u) & m0;
    const uint32_t hi = h > 16 ? (o + 16 < Lp ? words[o + 16] : 0u) & m1 : 0u;
    const uint32_t hash = flat_hash_prefix(lo, hi);
    Walk wu = walk_start(tu, hash), wd = walk_start(td, hash);
    while (!(wu.done && wd.done)) {
      const Sector su = walk_load(tu, wu), sd = walk_load(td, wd);
      walk_check(tu, wu, su, lo, hi);
      walk_check(td, wd, sd, lo, hi);
    }
    const int avail = lens[r] - o;
    const long long i = (long long)(b0 + r) * S + s * O + o;
    finish(tu, wu.b, words, Lp, o, avail, i, true, slots, rid1, rid2, in_u);
    finish(td, wd.b, words, Lp, o, avail, i + 2 * O, false, slots, rid1, rid2, in_u);
    o += dO;
    r += dr;
    if (o >= O) {
      o -= O;
      ++r;
    }
    while (r >= rb) {
      r -= rb;
      ++s;
    }
  }
}

}  // namespace

// Reads a tile holds: ~kTileItems (strand, read, offset) items, halved
// until its shared memory fits the default; one read of a longer Lp opts
// in to more.
static int gather_tile_reads(int B, int Lp, int O) {
  int R = (kTileItems + 2 * O - 1) / (2 * O);
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
