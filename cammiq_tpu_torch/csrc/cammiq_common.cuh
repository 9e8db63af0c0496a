// Device helpers shared by the probe kernels: 2-bit rolling words, the
// h-prefix hash and the blocked-bloom bit mask.  Each is the uint32 twin of
// a function in cammiq_tpu/query (named beside it); wraparound arithmetic
// on uint32_t reproduces jnp.uint32 bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// query/probe.py:pack_rolling16: word at base t packs codes[t + s] into
// bits 2s (s < 16); codes at or past Lp read as 0.  A code is widened
// int8 -> int32 -> uint32 exactly as codes.astype(jnp.uint32) does.
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
