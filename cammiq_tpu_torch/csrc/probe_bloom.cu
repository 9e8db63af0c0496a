// Kernel 2: probe words + h-prefix hash + blocked-bloom membership.
//
// Replaces, fused into one pass: query/probe.py:pack_rolling16, the kw-word
// window stack and prefix masks of query/sortjoin.py:collect_matches_sortjoin
// (867-898), _hash_prefix (411-432) and _bloom_bits/_bloom_maybe (130-176).
// JAX materialised the [B, Lp] rolling words and the [B*O, kw] window stack
// in HBM; here each thread packs the two prefix words it needs straight from
// the int8 codes and writes only the outputs.
//
// One thread per (read b, offset o), N = B * O, O = Lp - h + 1: every offset
// is probed whatever the read's length (as JAX does); the length check
// happens in the verify kernel.
//
// Bound on the card: one random 4-byte gather per probe into the 64 MB
// bloom (2^24 words: larger than the 50 MB L2, so most gathers go to HBM),
// plus 5 bytes written per probe.  Code reads are coalesced and L1-served
// (neighbouring threads read overlapping windows of one row).  Nothing to
// do about the gather in a first version; a 2^23-word fold that fits L2 is
// queued as a measurement.
#include "cammiq_common.cuh"

namespace {

__global__ void probe_bloom_kernel(const int8_t* __restrict__ codes, int Lp,
                                   int O, int h,
                                   const uint32_t* __restrict__ bloom,
                                   int bloom_log, long long N,
                                   uint8_t* __restrict__ maybe,
                                   uint32_t* __restrict__ khlo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long b = i / O;
  const int o = (int)(i - b * O);
  const int8_t* row = codes + b * Lp;
  const uint32_t lo = pack16(row, Lp, o) & base_mask(h < 16 ? h : 16);
  const uint32_t hi = h > 16 ? (pack16(row, Lp, o + 16) & base_mask(h - 16)) : 0u;
  const uint32_t key = hash_prefix_lo(lo, hi);
  const uint32_t word = __ldg(bloom + (key >> (32 - bloom_log)));
  const uint32_t need = bloom_bits(key);
  maybe[i] = (uint8_t)((word & need) == need);
  khlo[i] = key;
}

}  // namespace

extern "C" int cammiq_probe_bloom(const void* codes, long long B, int Lp,
                                  int h, const void* bloom, int bloom_log,
                                  void* maybe, void* khlo, void* stream) {
  const int O = Lp - h + 1 > 1 ? Lp - h + 1 : 1;
  const long long N = B * O;
  if (N == 0) return 0;
  const int threads = 256;
  const long long blocks = (N + threads - 1) / threads;
  probe_bloom_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, Lp, O, h, (const uint32_t*)bloom, bloom_log, N,
      (uint8_t*)maybe, (uint32_t*)khlo);
  return (int)cudaGetLastError();
}

extern "C" const char* cammiq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
