// The trajectory kernel (trajectory.cu) with bfloat16 operands in the S/T/Q
// nets' products: TW = __nv_bfloat16, every energy spec on both lane
// configurations, and past 64 wide the site-parallel configuration's specs
// (site_traj_kernel).
//
// Replaces the Pallas kernel _make_kernel with cd = bfloat16
// (l2hmc_tpu/ops/fused_dynamics.py:645, _dot_in :151 through _apply_stq
// :190; FusedDynamics.compute_dtype :685).
//
// A translation unit of its own: the sources build in parallel, one nvcc
// each, so the bfloat16 instantiations do not lengthen trajectory.cu's
// build. The weights arrive rounded to bfloat16 in the float32 block; each
// activation is rounded where a product reads it (l2hmc_lanes.cuh). The
// products of two bfloat16 values are exact in float32, so the kernel
// differs from its plain version (the plain trajectory with KernelInputs.cd
// = bfloat16) only where a float32 sum in another order rounds to another
// bfloat16 value.
#define L2HMC_BF16_UNIT
#include "trajectory.cu"

// Plain C entry point, as l2hmc_trajectory, with bfloat16 operands.
extern "C" int l2hmc_trajectory_bf16(const float* params, int D, int H, int H2,
                                     int T, int kind, int nc, int reverse,
                                     int hmc, const float* x, const float* v,
                                     float* xo, float* vo, float* ld, int N,
                                     void* stream) {
  return l2hmc::trajectory_entry<__nv_bfloat16>(
      params, l2hmc::Dims{D, H, H2, T, nc}, kind, reverse, hmc, x, v, xo, vo,
      ld, N, stream);
}
