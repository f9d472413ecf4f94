// K whole Metropolis-Hastings steps of the direction-randomised L2HMC
// sampler in one launch, one thread per chain, optionally writing the
// post-MH state of every step to a (K, D, N) trace.
//
// Replaces the Pallas kernel _make_chain_kernel / FusedChainSampler
// (l2hmc_tpu/ops/fused_dynamics.py:1103, pallas_call at :1350).
//
// Bound on the card: operations. Each MH step is one T-step trajectory per
// chain (see trajectory.cu) plus two Hamiltonians and a few Philox rounds;
// device memory sees the start state, the final state and acceptance, and
// with a trace D * 4 bytes per chain and step. The weights sit in shared
// memory and the chain in registers for all K steps.
//
// Differences from the TPU kernel, by design:
//  - Random numbers come from counter-based Philox4x32-10 keyed by the
//    64-bit seed, with counter (global chain index, MH step, slot, 0):
//    slot 0 gives the direction uniform (word 0) and the accept uniform
//    (word 1); slot 1 + j gives the normals 2j and 2j + 1 by Box-Muller.
//    The draws do not depend on the block size, and the plain PyTorch
//    version (ops/philox.py) reproduces them bit for bit.
//  - The direction is picked before the trajectory and only the chosen one
//    runs. The TPU kernel runs both and mixes them arithmetically; with a
//    select the unchosen trajectory cannot influence the result, so running
//    it is wasted work. The accept is a select too, so a non-finite
//    rejected proposal cannot leak into the state.
//  - The trace goes straight to device memory; the TPU kernel's VMEM ring
//    and DMA existed only for Mosaic.
#include "l2hmc_common.cuh"
#include "philox.cuh"

namespace l2hmc {

template <class C>
__global__ void chain_kernel(const float* __restrict__ params, Dims d, int hmc,
                             const float* __restrict__ xin,
                             float* __restrict__ xo,
                             float* __restrict__ acc_out,
                             float* __restrict__ trace, int N, int K,
                             uint2 key) {
  extern __shared__ float smem[];
  const Block B = load_block(params, smem, d);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float x[C::DM], v[C::DM], xp[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    x[i] = xin[static_cast<size_t>(i) * N + n];
  }
  float accepted = 0.f;
  for (int k = 0; k < K; ++k) {
#pragma unroll (C::UD)
    for (int j = 0; j < (C::DM + 1) / 2; ++j) {
      if (2 * j >= d.D) break;
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(n), static_cast<uint32_t>(k),
                     static_cast<uint32_t>(1 + j), 0u),
          key);
      v[2 * j] = box_muller(r.x, r.y);
      if (2 * j + 1 < d.D) v[2 * j + 1] = box_muller(r.z, r.w);
    }
    const uint4 r0 = philox4x32_10(
        make_uint4(static_cast<uint32_t>(n), static_cast<uint32_t>(k), 0u, 0u),
        key);
    const bool forward = uniform24(r0.x) < 0.5f;
    const float u_acc = uniform24(r0.y);

    const float h0 = gauss_energy<C>(B, d, x) + kinetic<C>(d, v);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      xp[i] = x[i];
    }
    const float lj = trajectory<C>(B, d, hmc != 0, !forward, xp, v);
    const float h1 = gauss_energy<C>(B, d, xp) + kinetic<C>(d, v);
    // exp(min(a, 0)) with NaN kept NaN (fminf would turn it into 0), then
    // the NaN guard maps it to 0
    const float a = h0 - h1 + lj;
    float px = expf(a > 0.f ? 0.f : a);
    if (!isfinite(px)) px = 0.f;
    if (px - u_acc >= 0.f) {
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        x[i] = xp[i];
      }
      accepted += 1.f;
    }
    if (trace != nullptr) {
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        trace[(static_cast<size_t>(k) * d.D + i) * N + n] = x[i];
      }
    }
  }
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    xo[static_cast<size_t>(i) * N + n] = x[i];
  }
  acc_out[n] = accepted * (1.0f / static_cast<float>(K));
}

template <class C>
static cudaError_t launch_chain(const float* params, Dims d, int hmc,
                                const float* x, float* xo, float* acc,
                                float* trace, int N, int K, uint2 key,
                                cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_floats(d)) * sizeof(float);
  cudaError_t e = allow_smem(chain_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (N + kThreads - 1) / kThreads;
  chain_kernel<C><<<blocks, kThreads, smem, stream>>>(params, d, hmc, x, xo,
                                                      acc, trace, N, K, key);
  return cudaGetLastError();
}

}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Device pointers to float32:
// params (the packed block), x and xo as (D, N), acc as (N,), trace as
// (K, D, N) or null. Returns a cudaError_t as int; 0 means accepted.
extern "C" int l2hmc_chain(const float* params, int D, int H, int H2, int T,
                           int hmc, const float* x, float* xo, float* acc,
                           float* trace, int N, int K,
                           unsigned long long seed, void* stream) {
  using namespace l2hmc;
  const Dims d{D, H, H2, T};
  if (N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint2 key = make_uint2(static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                               static_cast<uint32_t>(seed >> 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_cfg(d)) {
    case 1:
      return launch_chain<Small>(params, d, hmc, x, xo, acc, trace, N, K, key,
                                 s);
    case 2:
      return launch_chain<Wide>(params, d, hmc, x, xo, acc, trace, N, K, key,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
