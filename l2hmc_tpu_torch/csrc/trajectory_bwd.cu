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
// State layout (D, N): element i of chain n at i * N + n. N need not divide
// the block.
#include "l2hmc_lanes.cuh"

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
// floats. Returns a cudaError_t as int; 0 means both launches were accepted.
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
  return dispatch<ScgLanes>(d, kind, [&](auto c, auto e) {
    return launch_trajectory_bwd<decltype(c), decltype(e)>(
        params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, grads, scratch, N,
        s);
  });
}
