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
// Past 64 wide (states up to 4096, the 64 x 64 phi^4 lattice, or hidden
// widths up to 128) a lane group cannot hold the state nor a block the
// weights: site_traj_kernel runs those widths on the chain kernel's
// site-parallel configuration (l2hmc_sites.cuh), a tile of 4 chains a block
// of 256 threads, x', v and g in shared memory (the chain kernel's budget,
// 212.4 KB at D = 4096 and hidden 128), the weights read through the L2,
// the launch's one direction in every chain, and the log-det reduced by
// fixed-order warp trees. Every spec runs there, as in the chain kernel
// (Funnel's and Gmm's gradients after their per-chain prelude).
//
// Operands: TW, float here; trajectory_bf16.cu compiles this file again for
// TW = __nv_bfloat16 (the JAX kernel's cd = bfloat16) in a translation unit
// of its own, with its own entry point, l2hmc_trajectory_bf16, so that the
// two builds run side by side; the site-parallel form has both.
#include "l2hmc_lanes.cuh"
#include "l2hmc_sites.cuh"

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

// One trajectory on sites: a tile of kSiteChains chains a block, every
// chain in the launch's direction; past N a copy of the last chain, no
// writes.
template <class En, int HM, class TW>
__global__ void __launch_bounds__(kSiteThreads) site_traj_kernel(
    const float* __restrict__ params, Dims d, int reverse, int hmc,
    const float* __restrict__ xin, const float* __restrict__ vin,
    float* __restrict__ xo, float* __restrict__ vo, float* __restrict__ ld,
    int N) {
  constexpr int C = kSiteChains;
  extern __shared__ float smem[];
  const Block B = block_at(params, d);
  const SiteSmem<HM> s = site_smem<HM>(smem, d.D);
  const size_t sN = static_cast<size_t>(N);
  int n[C];
  bool live[C], rev[C];
  float l[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int chain = blockIdx.x * C + c;
    live[c] = chain < N;
    n[c] = live[c] ? chain : N - 1;
    rev[c] = reverse != 0;
    l[c] = 0.f;
  }
  // (D, N) in device memory: (site, chain) pairs chain-fastest
  for (int p = threadIdx.x; p < C * d.D; p += kSiteThreads) {
    const int c = p % C, i = p / C;
    s.xp[c * d.D + i] = xin[i * sN + n[c]];
    s.v[c * d.D + i] = vin[i * sN + n[c]];
  }
  __syncthreads();
  site_grad<En>(B, d, s.xp, s.g, scratch_of(s));
  for (int t = 0; t < d.T; ++t) {
    int step[C];
#pragma unroll
    for (int c = 0; c < C; ++c) step[c] = reverse ? d.T - 1 - t : t;
    site_traj_step<En, HM, TW>(B, d, hmc != 0, rev, step, s, l);
  }
  block_sums(l, s.sred, s.tot);
  for (int p = threadIdx.x; p < C * d.D; p += kSiteThreads) {
    const int c = p % C, i = p / C;
    if (live[c]) {
      xo[i * sN + n[c]] = s.xp[c * d.D + i];
      vo[i * sN + n[c]] = s.v[c * d.D + i];
    }
  }
  if (threadIdx.x < C && live[threadIdx.x]) ld[n[threadIdx.x]] = s.tot[threadIdx.x];
}

template <class En, int HM, class TW>
static int launch_site_traj_hm(const float* params, Dims d, int reverse, int hmc,
                               const float* x, const float* v, float* xo,
                               float* vo, float* ld, int N, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(site_smem_floats(d.D, HM, site_pre_floats(d, En::kKind))) *
      sizeof(float);
  cudaError_t e = allow_smem(site_traj_kernel<En, HM, TW>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + kSiteChains - 1) / kSiteChains;
  site_traj_kernel<En, HM, TW><<<blocks, kSiteThreads, smem, stream>>>(
      params, d, reverse, hmc, x, v, xo, vo, ld, N);
  return static_cast<int>(cudaGetLastError());
}

// Every energy spec on both lane configurations and, past them, on the
// site-parallel configuration, with TW operands.
template <class TW>
static int trajectory_entry(const float* params, Dims d, int kind, int reverse,
                            int hmc, const float* x, const float* v, float* xo,
                            float* vo, float* ld, int N, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick_lanes(d) == 3) {
    return with_energy(d, kind, [&](auto e) {
      using En = decltype(e);
      if (site_hm(d) == WideLanes::HM)
        return launch_site_traj_hm<En, WideLanes::HM, TW>(params, d, reverse, hmc, x, v,
                                                          xo, vo, ld, N, s);
      return launch_site_traj_hm<En, kSiteMaxHidden, TW>(params, d, reverse, hmc, x, v,
                                                         xo, vo, ld, N, s);
    });
  }
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
// (Gauss 0, RoughWell 1, Gmm 2, Funnel 3, Phi4 4). Returns a cudaError_t as
// int; 0 means the launch was accepted.
extern "C" int l2hmc_trajectory(const float* params, int D, int H, int H2,
                                int T, int kind, int nc, int reverse, int hmc,
                                const float* x, const float* v, float* xo,
                                float* vo, float* ld, int N, void* stream) {
  return l2hmc::trajectory_entry<float>(params, l2hmc::Dims{D, H, H2, T, nc},
                                       kind, reverse, hmc, x, v, xo, vo, ld, N,
                                       stream);
}

// The site-parallel form's geometry at these widths, as l2hmc_trajectory
// launches it: chains a block, threads a block, bytes of dynamic shared
// memory a block (on the energy spec kind with nc floats of constants); 0
// where the widths are not past 64 or past its caps.
static bool traj_on_sites(int D, int H, int H2) {
  return l2hmc::pick_lanes(l2hmc::Dims{D, H, H2, 1}) == 3;
}
extern "C" int l2hmc_trajectory_site_chains(int D, int H, int H2) {
  return traj_on_sites(D, H, H2) ? l2hmc::kSiteChains : 0;
}
extern "C" int l2hmc_trajectory_site_threads(int D, int H, int H2) {
  return traj_on_sites(D, H, H2) ? l2hmc::kSiteThreads : 0;
}
extern "C" int l2hmc_trajectory_site_smem_bytes(int D, int H, int H2, int kind, int nc) {
  using namespace l2hmc;
  if (!traj_on_sites(D, H, H2)) return 0;
  const Dims d{D, H, H2, 1, nc};
  return site_smem_floats(D, site_hm(d), site_pre_floats(d, kind)) *
         static_cast<int>(sizeof(float));
}
#endif
