// K whole Metropolis-Hastings steps of the direction-randomised L2HMC
// sampler in one launch, a lane group per chain, optionally writing the
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
// Design. One thread per chain left each MH step a serial chain of ~19 k
// dependent operations, on 16 of the card's 132 SMs at 1024 chains: the
// time per step was flat from 1024 to 8192 chains. Here a group of lanes
// runs one chain for all K steps, its T substeps through lane_traj_step
// (l2hmc_lanes.cuh, the trajectory kernel's substep). Each chain draws its
// own direction, so two chains in one warp would run the substep's two
// branches while its full-warp shuffles name both: the group is a whole
// warp, L = 32. At the SCG widths that is ScgChainLanes (widths fixed at
// compile time, one hidden unit a lane, lanes 10-31 repeating the last
// unit's arithmetic); other widths up to 64 take WideLanes. 16-lane groups
// with shuffles on the group's own mask ran 1024 chains 1.45x slower on an
// H100 (a warp whose two chains disagree runs both branches in turn), and
// the trajectory kernels 14-25% slower (a warp sync before every shuffle).
// Blocks of kLaneThreads threads, four chains. Past 64 wide (up to 4096,
// the phi^4 lattice's 64 x 64) or past hidden 64 (up to 128) a lane group
// cannot hold the state and the block cannot hold the weights:
// l2hmc_sites.cuh runs those widths, a tile of chains a block with the
// threads over the sites, and the phi^4 lattice at every width
// (site_chain). The state (x, the proposal,
// v) is replicated in every lane, and every lane draws the same Philox
// words and forms h0, h1, the log-det sum and the accept on its own copy in
// one order, so the whole group decides alike with no shuffle. Lane 0
// writes the trace row, the final state and the acceptance; a group past
// the last chain runs to the end on a copy of it and writes nothing.
//
// Differences from the TPU kernel, by design:
//  - Random numbers come from counter-based Philox4x32-10 keyed by the
//    64-bit seed, with counter (global chain index, MH step, slot, 0):
//    slot 0 gives the direction uniform (word 0) and the accept uniform
//    (word 1); slot 1 + j gives the normals 2j and 2j + 1 by Box-Muller.
//    The draws do not depend on L or the block size, and the plain PyTorch
//    version (ops/philox.py) reproduces them bit for bit.
//  - The direction is picked before the trajectory and only the chosen one
//    runs. The TPU kernel runs both and mixes them arithmetically; with a
//    select the unchosen trajectory cannot influence the result, so running
//    it is wasted work. The accept is a select too, so a non-finite
//    rejected proposal cannot leak into the state.
//  - The trace goes straight to device memory; the TPU kernel's VMEM ring
//    and DMA existed only for Mosaic.
//
// Operands: TW, float here; chain_bf16.cu compiles this file again for
// TW = __nv_bfloat16 (the JAX kernel's cd = bfloat16), lane groups and the
// site-parallel configuration alike, in a translation unit of its own with
// its own entry point, l2hmc_chain_bf16.
#include "l2hmc_lanes.cuh"
#include "l2hmc_sites.cuh"
#include "philox.cuh"

namespace l2hmc {

// The SCG widths (D = 2, H = H2 = 10) on a whole warp.
typedef LaneCfg<2, 32, 1, 1, 10> ScgChainLanes;

template <class C, class En, class TW>
__global__ void __launch_bounds__(kLaneThreads) chain_kernel(
    const float* __restrict__ params, Dims din, int hmc,
    const float* __restrict__ xin, float* __restrict__ xo,
    float* __restrict__ acc_out, float* __restrict__ trace, int N, int K,
    uint2 key) {
  static_assert(C::L == 32, "a chain's own direction needs a warp of its own");
  extern __shared__ float smem[];
  const Block B = load_block(params, smem, din);
  const Dims d = lane_dims<C>(din);
  const int chain = (blockIdx.x * kLaneThreads + threadIdx.x) / C::L;
  const bool live = chain < N;  // past N: a copy of the last chain, no writes
  const int n = live ? chain : N - 1;
  const int lane = lane_of<C>();
  const bool writer = live && lane == 0;
  const size_t sN = static_cast<size_t>(N);
  float x[C::DM], v[C::DM], xp[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    x[i] = xin[i * sN + n];
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
    const bool reverse = !(uniform24(r0.x) < 0.5f);
    const float u_acc = uniform24(r0.y);

    const float h0 = En::template energy<C>(B, d, x) + kinetic<C>(d, v);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      xp[i] = x[i];
    }
    float lj = 0.f;
    for (int t = 0; t < d.T; ++t) {
      const int step = reverse ? d.T - 1 - t : t;
      lj += lane_traj_step<C, En, TW>(B, d, hmc != 0, reverse, step, xp, v, lane);
    }
    const float h1 = En::template energy<C>(B, d, xp) + kinetic<C>(d, v);
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
    if (trace != nullptr && writer) {
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        trace[(static_cast<size_t>(k) * d.D + i) * sN + n] = x[i];
      }
    }
  }
  if (!writer) return;
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    xo[i * sN + n] = x[i];
  }
  acc_out[n] = accepted * (1.0f / static_cast<float>(K));
}

template <class C, class En, class TW>
static int launch_chain(const float* params, Dims d, int hmc,
                                const float* x, float* xo, float* acc,
                                float* trace, int N, int K, uint2 key,
                                cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_floats(d)) * sizeof(float);
  cudaError_t e = allow_smem(chain_kernel<C, En, TW>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long lanes = static_cast<long long>(N) * C::L;
  const int blocks = static_cast<int>((lanes + kLaneThreads - 1) / kLaneThreads);
  chain_kernel<C, En, TW><<<blocks, kLaneThreads, smem, stream>>>(
      params, d, hmc, x, xo, acc, trace, N, K, key);
  return static_cast<int>(cudaGetLastError());
}

// Every energy spec on the lane groups (Phi4 on the sites only) and on the
// site-parallel configuration, with TW operands.
template <class TW>
static int chain_entry(const float* params, Dims d, int kind, int hmc,
                       const float* x, float* xo, float* acc, float* trace,
                       float* scratch, int N, int K, unsigned long long seed,
                       void* stream) {
  if (N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint2 key = make_uint2(static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                               static_cast<uint32_t>(seed >> 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (site_chain(d, kind)) {
    return with_energy(d, kind, [&](auto e) {
      return launch_site_chain<decltype(e), TW>(params, d, hmc, x, xo, acc,
                                                trace, scratch, N, K, key, s);
    });
  }
  return dispatch<ScgChainLanes>(d, kind, [&](auto c, auto e) {
    if constexpr (std::is_same_v<decltype(e), Phi4>)
      return static_cast<int>(cudaErrorInvalidValue);  // site_chain's
    else
      return launch_chain<decltype(c), decltype(e), TW>(
          params, d, hmc, x, xo, acc, trace, N, K, key, s);
  });
}

}  // namespace l2hmc

#ifndef L2HMC_BF16_UNIT
// Plain C entry points (loaded with ctypes). Device pointers to float32:
// params (the packed block, with nc floats of the energy spec's constants;
// kind as in l2hmc_trajectory), x and xo as (D, N), acc as (N,), trace as
// (K, D, N) or null, scratch as (ceil(N / C) C, D) with C the chains a
// block of l2hmc_chain_site_chains (the site-parallel configuration's
// accepted states; null elsewhere). Returns a cudaError_t as int; 0 means
// accepted.
extern "C" int l2hmc_chain(const float* params, int D, int H, int H2, int T,
                           int kind, int nc, int hmc, const float* x,
                           float* xo, float* acc, float* trace, float* scratch,
                           int N, int K, unsigned long long seed,
                           void* stream) {
  return l2hmc::chain_entry<float>(params, l2hmc::Dims{D, H, H2, T, nc}, kind,
                                   hmc, x, xo, acc, trace, scratch, N, K, seed,
                                   stream);
}

// Lanes a chain at these widths (the instantiation l2hmc_chain launches for
// every spec but Phi4), or 0 where no lane group serves them.
extern "C" int l2hmc_chain_lanes(int D, int H, int H2) {
  using namespace l2hmc;
  switch (pick_lanes(Dims{D, H, H2, 1})) {
    case 1:
      return ScgChainLanes::L;
    case 2:
      return WideLanes::L;
    default:
      return 0;
  }
}

// The site-parallel configuration's geometry at these widths, as
// l2hmc_chain launches it: chains a block, threads a block, bytes of
// dynamic shared memory a block (on the energy spec kind with nc floats of
// constants); 0 where the widths are past its caps.
static bool site_widths(int D, int H, int H2) {
  using namespace l2hmc;
  return D > 0 && D <= kSiteMaxDim && H <= kSiteMaxHidden && H2 <= kSiteMaxHidden;
}
extern "C" int l2hmc_chain_site_chains(int D, int H, int H2) {
  return site_widths(D, H, H2) ? l2hmc::kSiteChains : 0;
}
extern "C" int l2hmc_chain_site_threads(int D, int H, int H2) {
  return site_widths(D, H, H2) ? l2hmc::kSiteThreads : 0;
}
extern "C" int l2hmc_chain_site_smem_bytes(int D, int H, int H2, int kind, int nc) {
  using namespace l2hmc;
  if (!site_widths(D, H, H2)) return 0;
  const Dims d{D, H, H2, 1, nc};
  return site_smem_floats(D, site_hm(d), site_pre_floats(d, kind)) *
         static_cast<int>(sizeof(float));
}
#endif
