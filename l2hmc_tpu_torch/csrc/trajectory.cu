// Fused T-step L2HMC trajectory, a lane group per chain.
//
// Replaces the Pallas kernel _make_kernel / FusedDynamics
// (l2hmc_tpu/ops/fused_dynamics.py:645, pallas_call at :718).
//
// Bound on the card: operations. Per chain and substep it does four S/T/Q
// net applications (about 2*(2DH) + 2*H*H2 + 3*2*H2*D FLOP each, ~400 at
// SCG width), two energy gradients and the elementwise updates, with a dozen
// exp/tanh per net application; it reads x, v and writes X, V, logdet once,
// a few tens of bytes per chain.
//
// Design. One thread per chain left the SCG instantiation a serial chain of
// ~19 k dependent operations per thread, on 32 of the card's 132 SMs at
// 2048 chains (blocks of 64 threads): the time was flat from 1024 to 8192
// chains. Here a group of L lanes runs one chain, each lane on its share of
// the hidden units and head outputs (lane_traj_step, l2hmc_lanes.cuh, the
// substep the backward kernel recomputes with): SCG takes L = 16 with its
// widths fixed at compile time (ScgLanes), widths up to 64 L = 32 with two
// units a lane (WideLanes). Blocks of kLaneThreads threads, so 1024 chains
// make 128 blocks. The target's energy is a template parameter En, an
// energy spec of l2hmc_common.cuh; every spec is instantiated on both lane
// configurations, and the entry point picks one by the spec's kind and the
// widths. Every sum over units gathers by __shfl_sync and adds in
// index order (the plain versions: _apply_stq and _trajectory_step in
// ops/fused_dynamics.py), so the outputs are those of the per-thread kernel
// this replaced. The weights are read from shared memory, loaded once per
// block; device memory sees only the state. Lane 0 of a group writes X, V
// and logdet; a group past the last chain runs on a copy of it and writes
// nothing.
//
// State layout (D, N): element i of chain n at i * N + n. N need not divide
// the block.
//
// Operands: TW, float here; trajectory_bf16.cu compiles this file again for
// TW = __nv_bfloat16 (the JAX kernel's cd = bfloat16) in a translation unit
// of its own, with its own entry point, l2hmc_trajectory_bf16, so that the
// two builds run side by side.
#include "l2hmc_lanes.cuh"

namespace l2hmc {

template <class C, class En, class TW>
__global__ void __launch_bounds__(kLaneThreads) trajectory_kernel(
    const float* __restrict__ params, Dims din, int reverse, int hmc,
    const float* __restrict__ xin, const float* __restrict__ vin,
    float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ ld,
    int N) {
  extern __shared__ float smem[];
  const Block B = load_block(params, smem, din);
  const Dims d = lane_dims<C>(din);
  const int chain = (blockIdx.x * kLaneThreads + threadIdx.x) / C::L;
  const bool live = chain < N;  // past N: a copy of the last chain, no writes
  const int n = live ? chain : N - 1;
  const int lane = lane_of<C>();
  const size_t sN = static_cast<size_t>(N);
  float x[C::DM], v[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    x[i] = xin[i * sN + n];
    v[i] = vin[i * sN + n];
  }
  float l = 0.f;
  for (int k = 0; k < d.T; ++k) {
    const int step = reverse ? d.T - 1 - k : k;
    l += lane_traj_step<C, En, TW>(B, d, hmc != 0, reverse != 0, step, x, v, lane);
  }
  if (!live || lane != 0) return;
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    xo[i * sN + n] = x[i];
    vo[i * sN + n] = v[i];
  }
  ld[n] = l;
}

template <class C, class En, class TW>
static int launch_trajectory(const float* params, Dims d, int reverse,
                                     int hmc, const float* x, const float* v,
                                     float* xo, float* vo, float* ld, int N,
                                     cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_floats(d)) * sizeof(float);
  cudaError_t e = allow_smem(trajectory_kernel<C, En, TW>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long lanes = static_cast<long long>(N) * C::L;
  const int blocks = static_cast<int>((lanes + kLaneThreads - 1) / kLaneThreads);
  trajectory_kernel<C, En, TW><<<blocks, kLaneThreads, smem, stream>>>(
      params, d, reverse, hmc, x, v, xo, vo, ld, N);
  return static_cast<int>(cudaGetLastError());
}

// Every energy spec on both lane configurations, with TW operands.
template <class TW>
static int trajectory_entry(const float* params, Dims d, int kind, int reverse,
                            int hmc, const float* x, const float* v, float* xo,
                            float* vo, float* ld, int N, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<ScgLanes>(d, kind, [&](auto c, auto e) {
    return launch_trajectory<decltype(c), decltype(e), TW>(
        params, d, reverse, hmc, x, v, xo, vo, ld, N, s);
  });
}

}  // namespace l2hmc

#ifndef L2HMC_BF16_UNIT
// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// float32: params (the packed block, with nc floats of the energy spec's
// constants), x, v, xo, vo as (D, N), ld as (N,). kind is the energy spec's
// (Gauss 0, RoughWell 1, Gmm 2, Funnel 3). Returns a cudaError_t as int; 0
// means the launch was accepted.
extern "C" int l2hmc_trajectory(const float* params, int D, int H, int H2,
                                int T, int kind, int nc, int reverse, int hmc,
                                const float* x, const float* v, float* xo,
                                float* vo, float* ld, int N, void* stream) {
  return l2hmc::trajectory_entry<float>(params, l2hmc::Dims{D, H, H2, T, nc},
                                       kind, reverse, hmc, x, v, xo, vo, ld, N,
                                       stream);
}
#endif
