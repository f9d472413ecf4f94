// The rounding of a product's activation operand, shared by the four VAE
// kernels (vae_cluster.cuh, vae_common.cuh) and by the bfloat16
// instantiations of the S/T/Q nets of the trajectory and chain kernels
// (l2hmc_lanes.cuh, l2hmc_sites.cuh): a forward and a backward pass must
// round alike for the trajectory to invert, and the kernels alike to agree
// with their plain versions (ops/operands.py).
#pragma once
#include <cuda_bf16.h>

#include <type_traits>

namespace l2hmc {

// x as a product's operand of type TW reads it: itself for float, rounded
// to the nearest bfloat16 (ties to even) for __nv_bfloat16.
template <class TW>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same<TW, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

}  // namespace l2hmc
