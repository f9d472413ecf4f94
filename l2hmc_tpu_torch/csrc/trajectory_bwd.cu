// Vector-Jacobian product of the fused T-step L2HMC trajectory, a lane
// group per chain, and a fixed-order sum of the weight and eps cotangents
// over chains.
//
// Replaces the Pallas kernel _make_bwd_kernel / DifferentiableFusedDynamics
// (l2hmc_tpu/ops/fused_dynamics.py:801, pallas_call at :1024), whose body
// traces jax.vjp of one substep at a time (_trajectory_vjp :251). There is
// no trace-time AD here: the substep's VJP is derived by hand
// (lane_traj_step_vjp in l2hmc_lanes.cuh; its plain version is _step_vjp in
// ops/fused_dynamics.py).
//
// Bound on the card: operations, about three forward trajectories' worth
// per chain (the forward recompute of the boundary states, the per-substep
// recompute with each S/T/Q application run again inside its VJP, and the
// reverse sweep); it reads x, v, dX, dV, dld and writes dx, dv and the
// P = 2 * (13-array net size) + D summed cotangents once, a few tens of
// bytes per chain.
//
// Design. One thread per chain left the SCG instantiation (D = 2, H = 10)
// a serial chain of ~58 k dependent operations, with its hidden-layer
// arrays in local memory and every weight cotangent added into a global
// scratch inside the substep loop, on 16 of the card's 132 SMs at 1024
// chains: 1.4 ms, flat from 1024 to 8192 chains. Here a group of L lanes
// runs one chain, each lane on its share of the hidden units
// (l2hmc_lanes.cuh): SCG takes L = 16 (1024 chains make 128 blocks of 128
// threads), widths up to 64 L = 32 with two units a lane. Each lane keeps
// its share of the chain's weight cotangents in registers across all T
// substeps and writes it once, at the end, into its chain's row of an
// (N, P) scratch (te's column of a step once, after that step's substep);
// no global memory is read, modified and written inside the substep loop.
// The weights are read from shared memory, loaded once per block.
//
// The TPU kernel sums the weight cotangents over chain tiles by revisiting
// one output block across grid steps, which relies on the grid running in
// order; Hopper blocks run in no order. Here a second kernel sums each
// cotangent over the N chains in a fixed order (sum_chains_kernel), so the
// result is the same from run to run. The per-step boundary states (x, v)
// of the recompute go to a (T + 1, 2, D, N) scratch, written by lane 0 of
// each group. The wrapper allocates both scratches; the kernel allocates
// nothing.
//
// Past 64 wide (states up to 4096, the 64 x 64 phi^4 lattice, or hidden
// widths up to 128) site_traj_bwd_kernel runs the VJP on the site-parallel
// configuration (l2hmc_sites.cuh: site_substep_vjp), a tile of 4 chains a
// block of 256 threads, for the Gauss and Phi4 specs. Its forward sweep
// (site_traj_step, the trajectory kernel's substep) writes the tile's
// boundary states to a (T, 2, C, D) scratch of its own; the reverse sweep
// recomputes each substep's intermediates into shared memory (past D = 1024
// into a (10, C, D) global scratch of the block's own) and applies the
// substep's VJP. The weight and eps cotangents go to the block's row of
// a (ceil(N / C), P) scratch by read-modify-writes of their one owning
// thread each, in a fixed order, and sum_chains_kernel sums the rows. The
// rows take ~88 MB at 1024 chains of the 16 x 16 lattice (hidden 32, T =
// 10), ~350 MB at the 32 x 32 and ~1.4 GB at the 64 x 64; a row a chain,
// the lane form's layout, would take four times that.
//
// State layout (D, N): element i of chain n at i * N + n. N need not divide
// the block.
#include "l2hmc_lanes.cuh"
#include "l2hmc_sites.cuh"

namespace l2hmc {

constexpr int kSumRows = 32;      // cotangent rows per block of the sum
constexpr int kSumWarps = 32;     // warps splitting the chains of a row

template <class C, class En>
__global__ void __launch_bounds__(kLaneThreads) trajectory_bwd_kernel(
    const float* __restrict__ params, Dims din, int reverse, int hmc,
    const float* __restrict__ xin, const float* __restrict__ vin,
    const float* __restrict__ dXin, const float* __restrict__ dVin,
    const float* __restrict__ dld, float* __restrict__ dxo,
    float* __restrict__ dvo, float* __restrict__ G, float* __restrict__ bnd,
    int N) {
  extern __shared__ float smem[];
  const Block B = load_block(params, smem, din);
  const Dims d = lane_dims<C>(din);
  const int chain = (blockIdx.x * kLaneThreads + threadIdx.x) / C::L;
  const bool live = chain < N;  // past N: a copy of the last chain, no writes
  const int n = live ? chain : N - 1;
  const int lane = lane_of<C>();
  const size_t sN = static_cast<size_t>(N);
  const int nf = net_floats(d);
  const int P = 2 * nf + d.D;
  float* g = G + static_cast<size_t>(n) * P;  // this chain's cotangent row
  const NetRows rx = net_rows(0, d), rv = net_rows(nf, d);
  float* bn = bnd + n;  // boundary k: x at row 2kD + i, v at row (2k+1)D + i
  const bool writer = live && lane == 0;

  float x[C::DM], v[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    x[i] = xin[i * sN + n];
    v[i] = vin[i * sN + n];
    if (writer) {
      bn[i * sN] = x[i];
      bn[(d.D + i) * sN] = v[i];
    }
  }
  for (int k = 0; k < d.T; ++k) {
    const int step = reverse ? d.T - 1 - k : k;
    lane_traj_step<C, En>(B, d, hmc != 0, reverse != 0, step, x, v, lane);
    const size_t row = static_cast<size_t>(2 * (k + 1) * d.D);
    if (writer) {
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        bn[(row + i) * sN] = x[i];
        bn[(row + d.D + i) * sN] = v[i];
      }
    }
  }
  __syncwarp();  // the group reads what its lane 0 wrote

  float dx[C::DM], dv[C::DM], de[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dx[i] = dXin[i * sN + n];
    dv[i] = dVin[i * sN + n];
    de[i] = 0.f;
  }
  NetAcc<C> gx, gv;
  gx.zero();
  gv.zero();
  const float dl = dld[n];
  for (int k = d.T - 1; k >= 0; --k) {
    const int step = reverse ? d.T - 1 - k : k;
    const size_t row = static_cast<size_t>(2 * k * d.D);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      x[i] = bn[(row + i) * sN];
      v[i] = bn[(row + d.D + i) * sN];
    }
    lane_traj_step_vjp<C, En>(B, gx, gv, d, hmc != 0, reverse != 0, step, x, v,
                          dx, dv, dl, de, lane);
    if (live) {
      flush_te<C>(gx, rx, g, d, step, lane);
      flush_te<C>(gv, rv, g, d, step, lane);
    }
  }
  if (!live) return;
  store_net<C>(gx, rx, g, d, lane);
  store_net<C>(gv, rv, g, d, lane);
  if (writer) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dxo[i * sN + n] = dx[i];
      dvo[i * sN + n] = dv[i];
      g[2 * nf + i] = de[i];
    }
  }
}

// out[r] = sum over n of G[n * P + r] in a fixed order: a block takes
// kSumRows consecutive rows; lane l of warp w sums row r0 + l over chains
// w, w + kSumWarps, ... in turn, and lane l of warp 0 adds the warps'
// partials in warp order.
__global__ void __launch_bounds__(kSumRows * kSumWarps)
    sum_chains_kernel(const float* __restrict__ G, int N, int P,
                      float* __restrict__ out) {
  __shared__ float part[kSumWarps][kSumRows];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kSumRows + l;
  float acc = 0.f;
  if (r < P) {
#pragma unroll 8
    for (int n = w; n < N; n += kSumWarps)
      acc += G[static_cast<size_t>(n) * P + r];
  }
  part[w][l] = acc;
  __syncthreads();
  if (w == 0 && r < P) {
    float s = 0.f;
    for (int q = 0; q < kSumWarps; ++q) s += part[q][l];
    out[r] = s;
  }
}

// The VJP on sites. G: (gridDim.x, P) rows, bnd: (gridDim.x, T, 2, C, D),
// arr: (gridDim.x, 10, C, D) past kSiteVjpSmemDim (else unused).
template <class En, int HM>
__global__ void __launch_bounds__(kSiteThreads) site_traj_bwd_kernel(
    const float* __restrict__ params, Dims d, int reverse, int hmc,
    const float* __restrict__ xin, const float* __restrict__ vin,
    const float* __restrict__ dXin, const float* __restrict__ dVin,
    const float* __restrict__ dld, float* __restrict__ dxo,
    float* __restrict__ dvo, float* __restrict__ G, float* __restrict__ bnd,
    float* arr, int N) {
  constexpr int C = kSiteChains;
  extern __shared__ float smem[];
  const Block B = block_at(params, d);
  const size_t sN = static_cast<size_t>(N);
  const int nf = net_floats(d), P = 2 * nf + d.D, CD = C * d.D;
  const SiteVjpSmem<HM> s = site_vjp_smem<HM>(
      smem, arr + static_cast<size_t>(blockIdx.x) * kSiteVjpArrays * CD, d.D);
  float* const row = G + static_cast<size_t>(blockIdx.x) * P;
  float* const bn = bnd + static_cast<size_t>(blockIdx.x) * d.T * 2 * CD;
  int n[C];
  bool live[C], rev[C];
  float ld[C], dl[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int chain = blockIdx.x * C + c;
    live[c] = chain < N;
    n[c] = live[c] ? chain : N - 1;  // past N: a copy of the last chain
    rev[c] = reverse != 0;
    ld[c] = 0.f;
    dl[c] = live[c] ? dld[n[c]] : 0.f;  // zero cotangents: exact zeros
  }
  for (int p = threadIdx.x; p < P; p += kSiteThreads) row[p] = 0.f;
  for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
    const int c = p % C, i = p / C, o = c * d.D + i;
    s.x[o] = xin[i * sN + n[c]];
    s.v[o] = vin[i * sN + n[c]];
    s.dx[o] = live[c] ? dXin[i * sN + n[c]] : 0.f;
    s.dv[o] = live[c] ? dVin[i * sN + n[c]] : 0.f;
  }
  __syncthreads();

  // the forward sweep: each substep's input to the boundary scratch
  // (the block sums of the chain kernel's SiteSmem are not used here)
  const SiteSmem<HM> f{s.x, s.v, s.g1, s.red, s.h, s.h2, nullptr, nullptr};
  site_grad<En>(B, d, s.x, s.g1);
  for (int t = 0; t < d.T; ++t) {
    float* const bk = bn + static_cast<size_t>(2 * t) * CD;
    for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
      bk[p] = s.x[p];
      bk[CD + p] = s.v[p];
    }
    __syncthreads();
    int step[C];
#pragma unroll
    for (int c = 0; c < C; ++c) step[c] = reverse ? d.T - 1 - t : t;
    site_traj_step<En, HM, float>(B, d, hmc != 0, rev, step, f, ld);
  }

  // the reverse sweep
  for (int t = d.T - 1; t >= 0; --t) {
    const float* const bk = bn + static_cast<size_t>(2 * t) * CD;
    for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
      s.x[p] = bk[p];
      s.v[p] = bk[CD + p];
    }
    __syncthreads();
    site_substep_vjp<En, HM>(B, d, hmc != 0, reverse != 0, reverse ? d.T - 1 - t : t, s,
                             dl, row, nf);
  }
  for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
    const int c = p % C, i = p / C;
    if (live[c]) {
      dxo[i * sN + n[c]] = s.dx[c * d.D + i];
      dvo[i * sN + n[c]] = s.dv[c * d.D + i];
    }
  }
}

template <class En, int HM>
static int launch_site_traj_bwd(const float* params, Dims d, int reverse, int hmc,
                                const float* x, const float* v, const float* dX,
                                const float* dV, const float* dld, float* dx,
                                float* dv, float* grads, float* scratch, int N,
                                cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(site_vjp_smem_floats(d.D, HM)) * sizeof(float);
  cudaError_t e = allow_smem(site_traj_bwd_kernel<En, HM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int P = 2 * net_floats(d) + d.D;
  const int blocks = (N + kSiteChains - 1) / kSiteChains;
  float* G = scratch;
  float* bnd = G + static_cast<size_t>(P) * blocks;
  float* arr = bnd + static_cast<size_t>(blocks) * d.T * 2 * kSiteChains * d.D;
  site_traj_bwd_kernel<En, HM><<<blocks, kSiteThreads, smem, stream>>>(
      params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, G, bnd, arr, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_chains_kernel<<<(P + kSumRows - 1) / kSumRows, kSumRows * kSumWarps, 0,
                      stream>>>(G, blocks, P, grads);
  return static_cast<int>(cudaGetLastError());
}

template <class C, class En>
static int launch_trajectory_bwd(
    const float* params, Dims d, int reverse, int hmc, const float* x,
    const float* v, const float* dX, const float* dV, const float* dld,
    float* dx, float* dv, float* grads, float* scratch, int N,
    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_floats(d)) * sizeof(float);
  cudaError_t e = allow_smem(trajectory_bwd_kernel<C, En>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int P = 2 * net_floats(d) + d.D;
  float* G = scratch;
  float* bnd = scratch + static_cast<size_t>(P) * N;
  const long long lanes = static_cast<long long>(N) * C::L;
  const int blocks = static_cast<int>((lanes + kLaneThreads - 1) / kLaneThreads);
  trajectory_bwd_kernel<C, En><<<blocks, kLaneThreads, smem, stream>>>(
      params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, G, bnd, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_chains_kernel<<<(P + kSumRows - 1) / kSumRows, kSumRows * kSumWarps, 0,
                      stream>>>(G, N, P, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// float32: params (the packed block, with nc floats of the energy spec's
// constants; kind as in l2hmc_trajectory); x, v, dX, dV, dx, dv as (D, N); dld as
// (N,); grads as (P,) with P = 2 * net_floats + D, in the order xnet's 13
// arrays | vnet's 13 arrays | eps; scratch of P * N + 2 * (T + 1) * D * N
// floats on the lane groups, and past 64 wide, on the sites, of
// B (P + 2 T C D) with C = l2hmc_trajectory_bwd_site_chains and
// B = ceil(N / C) (the blocks' rows and boundary states), and past D = 1024
// B 10 C D more (the blocks' intermediates). Returns a cudaError_t as int;
// 0 means both launches were accepted.
extern "C" int l2hmc_trajectory_bwd(const float* params, int D, int H, int H2,
                                    int T, int kind, int nc, int reverse,
                                    int hmc, const float* x, const float* v,
                                    const float* dX, const float* dV,
                                    const float* dld, float* dx, float* dv,
                                    float* grads, float* scratch, int N,
                                    void* stream) {
  using namespace l2hmc;
  const Dims d{D, H, H2, T, nc};
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick_lanes(d) == 3) {
    if (d.D > kSiteVjpMaxDim) return static_cast<int>(cudaErrorInvalidValue);
    return with_site_energy(d, kind, [&](auto e) {
      using En = decltype(e);
      if (site_hm(d) == WideLanes::HM)
        return launch_site_traj_bwd<En, WideLanes::HM>(params, d, reverse, hmc, x, v, dX,
                                                       dV, dld, dx, dv, grads, scratch, N, s);
      return launch_site_traj_bwd<En, kSiteMaxHidden>(params, d, reverse, hmc, x, v, dX, dV,
                                                      dld, dx, dv, grads, scratch, N, s);
    });
  }
  return dispatch<ScgLanes>(d, kind, [&](auto c, auto e) {
    return launch_trajectory_bwd<decltype(c), decltype(e)>(
        params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, grads, scratch, N,
        s);
  });
}

// The site-parallel form's geometry at these widths, as
// l2hmc_trajectory_bwd launches it: chains a block, threads a block, bytes
// of dynamic shared memory a block (the intermediates' (10, C, D) global
// scratch past D = 1024 not counted); 0 where the widths are not past 64 or
// past its caps.
static bool bwd_on_sites(int D, int H, int H2) {
  using namespace l2hmc;
  return pick_lanes(Dims{D, H, H2, 1}) == 3 && D <= kSiteVjpMaxDim;
}
extern "C" int l2hmc_trajectory_bwd_site_chains(int D, int H, int H2) {
  return bwd_on_sites(D, H, H2) ? l2hmc::kSiteChains : 0;
}
extern "C" int l2hmc_trajectory_bwd_site_threads(int D, int H, int H2) {
  return bwd_on_sites(D, H, H2) ? l2hmc::kSiteThreads : 0;
}
extern "C" int l2hmc_trajectory_bwd_site_smem_bytes(int D, int H, int H2) {
  using namespace l2hmc;
  if (!bwd_on_sites(D, H, H2)) return 0;
  return site_vjp_smem_floats(D, site_hm(Dims{D, H, H2, 1})) * static_cast<int>(sizeof(float));
}
