// Kernel 3: cuckoo span lookup + bucket-scan verify.
//
// Replaces query/sortjoin.py:_cuckoo_pos/_cuckoo_lookup (214-223, 323-341)
// and the bucket scan with _verify (1142-1239).  JAX kept three forms of the
// scan (unrolled selects, unrolled scatter, segment-expanded) only to bound
// TPU program size; one loop here covers every max_bucket and n_colors.
//
// One thread per surviving probe row: it looks up both cuckoo sides (side 0
// wins, as jnp.where(f1, ...) does) for the (start, count) span of its
// 32-bit prefix hash, recomputes its kw probe words from the int8 codes, and
// walks erec[start .. start+count).  An entry matches when its length fits
// the rest of the read and every length-masked 2-bit word is equal; a match
// writes found[i, color] = e, later c overwriting earlier as the where-chain
// does (within a color keys are prefix-free, so at most one matches).
//
// Bound on the card: dependent random gathers - two 48-byte cuckoo rows
// (a 0.4 GB table at config #3), then count x (kw+1)*4-byte erec rows (0.3
// GB).  Rows are read whole through the read-only path; the bucket walk
// touches consecutive rows, so a span is usually one or two 128-byte
// lines.  Threads of a warp diverge on span length; spans are short
// (max_bucket 4 at config #3), so the simple per-thread loop is kept.
#include "cammiq_common.cuh"

namespace {

constexpr int kSlots = 4;     // CUCKOO_SLOTS
constexpr int kRow = 3 * kSlots;
constexpr int kRegWords = 16; // probe words kept in registers

__device__ __forceinline__ bool cuckoo_side(const uint32_t* __restrict__ tab,
                                            uint32_t pos, uint32_t key,
                                            uint32_t* start, uint32_t* count) {
  const uint32_t* row = tab + (size_t)pos * kRow;
  bool f = false;
  uint32_t st = 0, ct = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const uint32_t c = __ldg(row + 2 * kSlots + s);
    const bool hit = (__ldg(row + s) == key) && c > 0u;
    f |= hit;
    st += hit ? __ldg(row + kSlots + s) : 0u;
    ct += hit ? c : 0u;
  }
  *start = st;
  *count = ct;
  return f;
}

__global__ void cuckoo_verify_kernel(
    const long long* __restrict__ rows, long long K,
    const uint32_t* __restrict__ khlo, const int8_t* __restrict__ codes,
    int Lp, int O, const int32_t* __restrict__ lengths,
    const uint32_t* __restrict__ cuckoo, int tlog,
    const uint32_t* __restrict__ erec, int kw, long long E, int n_colors,
    int32_t* __restrict__ found) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  int32_t* out = found + i * n_colors;
  for (int c = 0; c < n_colors; ++c) out[c] = -1;

  const long long pos = rows[i];
  const long long r = pos / O;
  const int o = (int)(pos - r * O);
  const uint32_t key = khlo[pos];

  // _cuckoo_pos(which=0 / which=1)
  const uint32_t p0 = (key * 0x9E3779B1u) >> (32 - tlog);
  uint32_t z = (key ^ 0x85EBCA6Bu) * 0xC2B2AE35u;
  z ^= z >> 15;
  const uint32_t p1 = z >> (32 - tlog);
  uint32_t s0, c0, s1, c1;
  const bool f0 = cuckoo_side(cuckoo, p0, key, &s0, &c0);
  const bool f1 = cuckoo_side(cuckoo, p1, key, &s1, &c1);
  if (!f0 && !f1) return;
  const long long start = (long long)(int32_t)(f0 ? s0 : s1);
  const int count = (int32_t)(f0 ? c0 : c1);

  const int8_t* row = codes + r * Lp;
  uint32_t pw[kRegWords];
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    pw[w] = w < kw ? pack16(row, Lp, o + 16 * w) : 0u;
  const int avail = lengths[r] - o;
  const int stride = kw + 1;

  for (int c = 0; c < count; ++c) {
    const long long e = start + c < E - 1 ? start + c : E - 1;
    const uint32_t* er = erec + e * stride;
    const uint32_t tail = __ldg(er + kw);
    const int elen = (int)(tail & 0xFFFFu);
    const int ecol = (int)(tail >> 16);
    if (elen > avail) continue;
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
      ok = (pack16(row, Lp, o + 16 * w) & base_mask(nb)) == __ldg(er + w);
    }
    if (ok && ecol < n_colors) out[ecol] = (int32_t)e;
  }
}

}  // namespace

extern "C" int cammiq_cuckoo_verify(const void* rows, long long K,
                                    const void* khlo, const void* codes,
                                    int Lp, int O, const void* lengths,
                                    const void* cuckoo, int tlog,
                                    const void* erec, int kw, long long E,
                                    int n_colors, void* found, void* stream) {
  if (K == 0) return 0;
  const int threads = 128;
  const long long blocks = (K + threads - 1) / threads;
  cuckoo_verify_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)rows, K, (const uint32_t*)khlo, (const int8_t*)codes,
      Lp, O, (const int32_t*)lengths, (const uint32_t*)cuckoo, tlog,
      (const uint32_t*)erec, kw, E, n_colors, (int32_t*)found);
  return (int)cudaGetLastError();
}
