// Counter-based Philox4x32-10 (Salmon et al., SC'11; the Random123
// constants) and the two transforms the samplers draw with. The same words
// are computed in tensor ops by ops/philox.py, so a kernel and its plain
// version see the same random bits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace l2hmc {

__device__ inline uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// U[0, 1) from the top 24 bits, as unsigned (fused_dynamics.py:1066-1076).
__device__ inline float uniform24(uint32_t w) {
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f);
}

// Box-Muller with u1 clamped at 1e-7 (fused_dynamics.py:1079-1083).
__device__ inline float box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = fmaxf(uniform24(w1), 1e-7f);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958647f * uniform24(w2));
}

}  // namespace l2hmc
