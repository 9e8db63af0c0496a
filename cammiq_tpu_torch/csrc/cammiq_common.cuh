// Device helpers shared by the kernels: 2-bit rolling words, the h-prefix
// hash and the blocked-bloom bit mask (each the uint32 twin of a function
// in cammiq_tpu/query, named beside it; wraparound arithmetic on uint32_t
// reproduces jnp.uint32 bit for bit), and the decoupled look-back across
// tiles that the single-pass scans use.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// query/probe.py:pack_rolling16: word at base t packs codes[t + s] into
// bits 2s (s < 16); codes at or past Lp read as 0.  A code is widened
// int8 -> int32 -> uint32 exactly as codes.astype(jnp.uint32) does, so a
// -1 (non-ACGT) code sets every bit from 2s up.
__device__ __forceinline__ uint32_t pack16(const int8_t* row, int Lp, int t) {
  uint32_t w = 0;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int x = t + s;
    const uint32_t c = x < Lp ? (uint32_t)(int32_t)row[x] : 0u;
    w |= c << (2 * s);
  }
  return w;
}

// mask of the low `nb` bases (2 bits each), nb in [0, 16]
__device__ __forceinline__ uint32_t base_mask(int nb) {
  return nb >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nb)) - 1u);
}

// query/sortjoin.py:_hash_prefix, primary (32-bit) half
__device__ __forceinline__ uint32_t hash_prefix_lo(uint32_t lo, uint32_t hi) {
  uint32_t x = lo ^ (hi * 0x9E3779B1u);
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// query/sortjoin.py:_bloom_bits
__device__ __forceinline__ uint32_t bloom_bits(uint32_t key) {
  const uint32_t z = key * 0x9E3779B1u;
  return (1u << ((z >> 16) & 31u)) | (1u << ((z >> 21) & 31u)) |
         (1u << ((z >> 26) & 31u));
}

// ---- decoupled look-back (Merrill and Garland, 2016)
//
// A single-pass scan over tiles: each block takes its tile from an atomic
// counter (so every tile it waits on has already started), publishes its
// tile's aggregate, looks back for the exclusive prefix, and publishes its
// inclusive prefix.  A tile's status is one 64-bit word: state in bits
// 32-33, a 32-bit value in the low bits.  The status words and the counter
// are zeroed (a memset on the stream) before the launch.
constexpr unsigned kStateAggregate = 1;  // value = the tile's own aggregate
constexpr unsigned kStatePrefix = 2;     // value = inclusive prefix

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned state, unsigned value) {
  const unsigned long long v = ((unsigned long long)state << 32) | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

struct MaxOp {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; }
};
// identity 0xFFFFFFFF; exact on the non-negative int32 values it scans
struct MinOp {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a < b ? a : b; }
};

// Exclusive prefix of tile t under `op` (identity `identity`): the values
// of tiles t-1, t-2, ... combined back to and including the nearest
// published prefix.  Run by one whole warp; every lane gets the result.
// Lane 0 reads the nearest predecessor; the warp waits only while a tile
// nearer than the nearest prefix has not published.
template <class Op>
__device__ unsigned look_back(const unsigned long long* status, int t,
                              unsigned identity, Op op) {
  const int lane = threadIdx.x & 31;
  unsigned acc = identity;
  for (int base = t - 1;;) {
    const int p = base - lane;
    const unsigned long long w =
        p >= 0 ? load_status(status + p)
               : ((unsigned long long)kStatePrefix << 32) | identity;
    const unsigned state = (unsigned)(w >> 32);
    const unsigned unpublished = __ballot_sync(0xFFFFFFFFu, state == 0);
    const unsigned prefix = __ballot_sync(0xFFFFFFFFu, state == kStatePrefix);
    // lanes up to and including the nearest prefix (all 32 when none)
    const unsigned upto = prefix ? (prefix & (0u - prefix)) * 2u - 1u : 0xFFFFFFFFu;
    if (unpublished & upto) continue;
    unsigned v = (upto >> lane) & 1u ? (unsigned)w : identity;
#pragma unroll
    for (int d = 16; d; d >>= 1) v = op(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
    acc = op(acc, v);
    if (prefix) return acc;
    base -= 32;  // 32 tiles with no prefix yet: look further back
  }
}
