// The chain kernel (chain.cu) with bfloat16 operands in the S/T/Q nets'
// products: TW = __nv_bfloat16 on the lane groups (every spec but Phi4) and
// on the site-parallel configuration (every spec; l2hmc_sites.cuh).
//
// Replaces the Pallas kernel _make_chain_kernel with cd = bfloat16
// (l2hmc_tpu/ops/fused_dynamics.py:1103, _dot_in :151 through _apply_stq
// :190; FusedChainSampler.compute_dtype :1242), loop_traj included: as in
// chain.cu, the trajectory loops over T at run time at every width.
//
// A translation unit of its own, so that the bfloat16 instantiations build
// beside chain.cu's in parallel and do not lengthen its build. The weights
// arrive rounded to bfloat16 in the float32 block; each activation is
// rounded where a product reads it. Random numbers, energies, Hamiltonians,
// the accept and the trace are chain.cu's, in float32.
#define L2HMC_BF16_UNIT
#include "chain.cu"

// Plain C entry point, as l2hmc_chain, with bfloat16 operands (the
// site-parallel geometry is chain.cu's l2hmc_chain_site_*).
extern "C" int l2hmc_chain_bf16(const float* params, int D, int H, int H2,
                                int T, int kind, int nc, int hmc,
                                const float* x, float* xo, float* acc,
                                float* trace, float* scratch, int N, int K,
                                unsigned long long seed, void* stream) {
  return l2hmc::chain_entry<__nv_bfloat16>(
      params, l2hmc::Dims{D, H, H2, T, nc}, kind, hmc, x, xo, acc, trace,
      scratch, N, K, seed, stream);
}
