// The repo's one multiplicative hash of (row, global owner, salt) and the
// 24-bit dither drawn from it: the same bits as the reference's
// ops/gossip.py hash_mix_u32 / _hash_uniform(bits=24) and the plain
// version in aiocluster_torch/ops/gossip.py. Native uint32 arithmetic
// (wrapping multiply, logical shifts).
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t hash_mix_u32(uint32_t i, uint32_t j, uint32_t s) {
  uint32_t h = (i * 0x9E3779B1u) ^ (j * 0x85EBCA77u) ^ (s * 0xC2B2AE3Du);
  h = (h ^ (h >> 15)) * 0x27D4EB2Fu;
  return h ^ (h >> 13);
}

// u = ((h >> 8) as int32 as f32) * 2^-24, clipped to [1e-12, 1 - 2^-24]:
// the top 24 bits are exact in f32, so u is exact and its maximum is
// already 1 - 2^-24 (the upper clip is kept for parity).
__device__ __forceinline__ float dither24(uint32_t h) {
  const float u = static_cast<float>(static_cast<int32_t>(h >> 8)) *
                  (1.0f / 16777216.0f);
  const float lo = 1e-12f;
  const float hi = 1.0f - 5.9604644775390625e-8f;
  return u < lo ? lo : (u > hi ? hi : u);
}
