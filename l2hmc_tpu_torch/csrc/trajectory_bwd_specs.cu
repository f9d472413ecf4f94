// The backward kernel (trajectory_bwd.cu) on sites for the RoughWell, Gmm
// and Funnel specs: trajectory_bwd.cu compiled again with
// L2HMC_BWD_SPECS_UNIT, which instantiates site_traj_bwd_kernel for these
// three specs and no lane-group kernel.
//
// Replaces, with trajectory_bwd.cu, the Pallas kernel _make_bwd_kernel /
// DifferentiableFusedDynamics (l2hmc_tpu/ops/fused_dynamics.py:801,
// pallas_call at :1024) on RoughWellEnergy :422, GmmEnergy :446 and
// FunnelEnergy :501 past 64 wide.
//
// A translation unit of its own so that it builds beside trajectory_bwd.cu:
// ten site instantiations in one source took nvcc 230-271 s on the card's
// host, the build's longest by ~150 s.
#define L2HMC_BWD_SPECS_UNIT
#include "trajectory_bwd.cu"

// Plain C entry point, as l2hmc_trajectory_bwd, on sites for these specs
// (cudaErrorInvalidValue for another spec, or widths the lane groups serve).
extern "C" int l2hmc_trajectory_bwd_specs(const float* params, int D, int H, int H2, int T,
                                          int kind, int nc, int reverse, int hmc,
                                          const float* x, const float* v, const float* dX,
                                          const float* dV, const float* dld, float* dx,
                                          float* dv, float* grads, float* scratch, int N,
                                          void* stream) {
  using namespace l2hmc;
  const Dims d{D, H, H2, T, nc};
  if (N <= 0) return 0;
  if (pick_lanes(d) != 3) return static_cast<int>(cudaErrorInvalidValue);
  return trajectory_bwd_sites(params, d, kind, reverse, hmc, x, v, dX, dV, dld, dx, dv, grads,
                              scratch, N, static_cast<cudaStream_t>(stream));
}
