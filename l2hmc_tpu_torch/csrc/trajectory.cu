// Fused T-step L2HMC trajectory, one thread per chain.
//
// Replaces the Pallas kernel _make_kernel / FusedDynamics
// (l2hmc_tpu/ops/fused_dynamics.py:645, pallas_call at :718).
//
// Bound on the card: operations. Per chain and substep it does four S/T/Q
// net applications (about 2*(2DH) + 2*H*H2 + 3*2*H2*D FLOP each, ~400 at
// SCG width), two energy gradients and the elementwise updates, with a dozen
// exp/tanh per net application; it reads x, v and writes X, V, logdet once,
// a few tens of bytes per chain. The design keeps every intermediate in
// registers or thread-local memory and the weights in shared memory, loaded
// once per block, so device memory sees only the state.
//
// State layout (D, N): element i of chain n at i * N + n, so neighbouring
// threads touch neighbouring addresses. N need not divide the block.
#include "l2hmc_common.cuh"

namespace l2hmc {

template <class C>
__global__ void trajectory_kernel(const float* __restrict__ params, Dims d,
                                  int reverse, int hmc,
                                  const float* __restrict__ xin,
                                  const float* __restrict__ vin,
                                  float* __restrict__ xo,
                                  float* __restrict__ vo,
                                  float* __restrict__ ld, int N) {
  extern __shared__ float smem[];
  const Block B = load_block(params, smem, d);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float x[C::DM], v[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    x[i] = xin[static_cast<size_t>(i) * N + n];
    v[i] = vin[static_cast<size_t>(i) * N + n];
  }
  const float l = trajectory<C>(B, d, hmc != 0, reverse != 0, x, v);
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    xo[static_cast<size_t>(i) * N + n] = x[i];
    vo[static_cast<size_t>(i) * N + n] = v[i];
  }
  ld[n] = l;
}

template <class C>
static cudaError_t launch_trajectory(const float* params, Dims d, int reverse,
                                     int hmc, const float* x, const float* v,
                                     float* xo, float* vo, float* ld, int N,
                                     cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_floats(d)) * sizeof(float);
  cudaError_t e = allow_smem(trajectory_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (N + kThreads - 1) / kThreads;
  trajectory_kernel<C><<<blocks, kThreads, smem, stream>>>(
      params, d, reverse, hmc, x, v, xo, vo, ld, N);
  return cudaGetLastError();
}

}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// float32: params (the packed block), x, v, xo, vo as (D, N), ld as (N,).
// Returns a cudaError_t as int; 0 means the launch was accepted.
extern "C" int l2hmc_trajectory(const float* params, int D, int H, int H2,
                                int T, int reverse, int hmc, const float* x,
                                const float* v, float* xo, float* vo,
                                float* ld, int N, void* stream) {
  using namespace l2hmc;
  const Dims d{D, H, H2, T};
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_cfg(d)) {
    case 1:
      return launch_trajectory<Small>(params, d, reverse, hmc, x, v, xo, vo,
                                      ld, N, s);
    case 2:
      return launch_trajectory<Wide>(params, d, reverse, hmc, x, v, xo, vo,
                                     ld, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
