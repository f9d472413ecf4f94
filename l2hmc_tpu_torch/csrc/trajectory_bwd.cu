// Vector-Jacobian product of the fused T-step L2HMC trajectory, one thread
// per chain, and a fixed-order sum of the weight and eps cotangents over
// chains.
//
// Replaces the Pallas kernel _make_bwd_kernel / DifferentiableFusedDynamics
// (l2hmc_tpu/ops/fused_dynamics.py:801, pallas_call at :1024), whose body
// traces jax.vjp of one substep at a time (_trajectory_vjp :251). There is
// no trace-time AD here: the substep's VJP is derived by hand
// (traj_step_vjp in l2hmc_common.cuh; its plain version is _step_vjp in
// ops/fused_dynamics.py).
//
// Bound on the card: operations, about three forward trajectories' worth
// per chain (the forward recompute of the boundary states, the per-substep
// recompute with each S/T/Q application run again inside its VJP, and the
// reverse sweep); it reads x, v, dX, dV, dld and writes dx, dv and the
// P = 2 * (13-array net size) + D summed cotangents once, a few tens of
// bytes per chain. The design keeps the chain's state and activations in
// registers or thread-local memory and the weights in shared memory.
//
// The TPU kernel sums the weight cotangents over chain tiles by revisiting
// one output block across grid steps, which relies on the grid running in
// order; Hopper blocks run in no order. Here each thread adds its chain's
// contributions over all T substeps into its own column of a (P, N) float32
// scratch (neighbouring threads on neighbouring addresses, no atomics), and
// a second kernel sums each row over the N chains in a fixed order, so the
// result is the same from run to run. The per-step boundary states (x, v)
// of the recompute go to a (T + 1, 2, D, N) scratch of the same kind. The
// wrapper allocates both scratches; the kernel allocates nothing.
//
// State layout (D, N): element i of chain n at i * N + n. N need not divide
// the block.
#include "l2hmc_common.cuh"

namespace l2hmc {

constexpr int kSumThreads = 256;

template <class C>
__global__ void trajectory_bwd_kernel(
    const float* __restrict__ params, Dims d, int reverse, int hmc,
    const float* __restrict__ xin, const float* __restrict__ vin,
    const float* __restrict__ dXin, const float* __restrict__ dVin,
    const float* __restrict__ dld, float* __restrict__ dxo,
    float* __restrict__ dvo, float* __restrict__ G, float* __restrict__ bnd,
    int N) {
  extern __shared__ float smem[];
  const Block B = load_block(params, smem, d);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t sN = static_cast<size_t>(N);
  const int nf = net_floats(d);
  const int P = 2 * nf + d.D;
  float* g = G + n;
  for (int r = 0; r < P; ++r) g[r * sN] = 0.f;
  const GradRows gx = grad_rows(g, sN, d);
  const GradRows gv = grad_rows(g + nf * sN, sN, d);
  float* bn = bnd + n;  // boundary k: x at row 2kD + i, v at row (2k+1)D + i

  float x[C::DM], v[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    x[i] = xin[i * sN + n];
    v[i] = vin[i * sN + n];
    bn[i * sN] = x[i];
    bn[(d.D + i) * sN] = v[i];
  }
  for (int k = 0; k < d.T; ++k) {
    const int step = reverse ? d.T - 1 - k : k;
    traj_step<C>(B, d, hmc != 0, reverse != 0, step, x, v);
    const size_t row = static_cast<size_t>(2 * (k + 1) * d.D);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      bn[(row + i) * sN] = x[i];
      bn[(row + d.D + i) * sN] = v[i];
    }
  }

  float dx[C::DM], dv[C::DM], de[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dx[i] = dXin[i * sN + n];
    dv[i] = dVin[i * sN + n];
    de[i] = 0.f;
  }
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
    traj_step_vjp<C>(B, gx, gv, d, hmc != 0, reverse != 0, step, x, v, dx, dv,
                     dl, de);
  }
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dxo[i * sN + n] = dx[i];
    dvo[i * sN + n] = dv[i];
    g[(2 * nf + i) * sN] = de[i];
  }
}

// out[r] = sum over n of G[r * N + n], one block per row, in a fixed order.
__global__ void sum_rows_kernel(const float* __restrict__ G, int N,
                                float* __restrict__ out) {
  __shared__ float s[kSumThreads];
  const float* row = G + static_cast<size_t>(blockIdx.x) * N;
  float acc = 0.f;
  for (int n = threadIdx.x; n < N; n += kSumThreads) acc += row[n];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

template <class C>
static cudaError_t launch_trajectory_bwd(
    const float* params, Dims d, int reverse, int hmc, const float* x,
    const float* v, const float* dX, const float* dV, const float* dld,
    float* dx, float* dv, float* grads, float* scratch, int N,
    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_floats(d)) * sizeof(float);
  cudaError_t e = allow_smem(trajectory_bwd_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int P = 2 * net_floats(d) + d.D;
  float* G = scratch;
  float* bnd = scratch + static_cast<size_t>(P) * N;
  const int blocks = (N + kThreads - 1) / kThreads;
  trajectory_bwd_kernel<C><<<blocks, kThreads, smem, stream>>>(
      params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, G, bnd, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_rows_kernel<<<P, kSumThreads, 0, stream>>>(G, N, grads);
  return cudaGetLastError();
}

}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// float32: params (the packed block); x, v, dX, dV, dx, dv as (D, N); dld as
// (N,); grads as (P,) with P = 2 * net_floats + D, in the order xnet's 13
// arrays | vnet's 13 arrays | eps; scratch of P * N + 2 * (T + 1) * D * N
// floats. Returns a cudaError_t as int; 0 means both launches were accepted.
extern "C" int l2hmc_trajectory_bwd(const float* params, int D, int H, int H2,
                                    int T, int reverse, int hmc,
                                    const float* x, const float* v,
                                    const float* dX, const float* dV,
                                    const float* dld, float* dx, float* dv,
                                    float* grads, float* scratch, int N,
                                    void* stream) {
  using namespace l2hmc;
  const Dims d{D, H, H2, T};
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_cfg(d)) {
    case 1:
      return launch_trajectory_bwd<SmallBwd>(params, d, reverse, hmc, x, v, dX,
                                          dV, dld, dx, dv, grads, scratch, N, s);
    case 2:
      return launch_trajectory_bwd<Wide>(params, d, reverse, hmc, x, v, dX,
                                         dV, dld, dx, dv, grads, scratch, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
