// Shared device code of the L2HMC kernels: the parameter block layout, its
// load into shared memory, and the in-kernel Gaussian energy, its gradient
// and the kinetic energy. Counterpart of l2hmc_tpu/ops/fused_dynamics.py's
// QuadraticGaussianEnergy. The kernels (trajectory.cu, trajectory_bwd.cu,
// chain.cu) run a chain on a lane group (l2hmc_lanes.cuh), whose S/T/Q net
// and substep have their plain versions in ops/fused_dynamics.py
// (_apply_stq, _trajectory_step).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace l2hmc {

struct Dims {
  int D, H, H2, T;  // state dim, S/T/Q hidden widths, leapfrog steps
};

// Parameter block, float32, packed on the host by
// l2hmc_tpu_torch/ops/fused_dynamics.py (_kernel_block):
//   eps (D) | masks (D x T) | prec (D x D) | mu (D) | xnet | vnet
// and each net (the 13 arrays of _extract_net, row-major):
//   w1 (D x H) w2 (D x H) wh (H x H2) bh (H2) ws (H2 x D) bs (D) ls (D)
//   wt (H2 x D) bt (D) wq (H2 x D) bq (D) lq (D) te (H x T)
__host__ __device__ inline int net_floats(Dims d) {
  return 2 * d.D * d.H + d.H * d.H2 + d.H2 + 3 * d.H2 * d.D + 5 * d.D +
         d.H * d.T;
}
__host__ __device__ inline int block_floats(Dims d) {
  return 2 * d.D + d.D * d.T + d.D * d.D + 2 * net_floats(d);
}

struct Net {
  const float *w1, *w2, *wh, *bh, *ws, *bs, *ls, *wt, *bt, *wq, *bq, *lq, *te;
};

struct Block {
  const float *eps, *masks, *prec, *mu;
  Net xnet, vnet;
};

__device__ inline const float* take(const float*& p, int n) {
  const float* r = p;
  p += n;
  return r;
}

__device__ inline Net net_at(const float*& p, Dims d) {
  Net n;
  n.w1 = take(p, d.D * d.H);
  n.w2 = take(p, d.D * d.H);
  n.wh = take(p, d.H * d.H2);
  n.bh = take(p, d.H2);
  n.ws = take(p, d.H2 * d.D);
  n.bs = take(p, d.D);
  n.ls = take(p, d.D);
  n.wt = take(p, d.H2 * d.D);
  n.bt = take(p, d.D);
  n.wq = take(p, d.H2 * d.D);
  n.bq = take(p, d.D);
  n.lq = take(p, d.D);
  n.te = take(p, d.H * d.T);
  return n;
}

// Copies the parameter block into dynamic shared memory. Every thread of
// the block must call it (it synchronises), before any thread returns.
__device__ inline Block load_block(const float* __restrict__ g, float* s,
                                   Dims d) {
  const int n = block_floats(d);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = g[i];
  __syncthreads();
  const float* p = s;
  Block b;
  b.eps = take(p, d.D);
  b.masks = take(p, d.D * d.T);
  b.prec = take(p, d.D * d.D);
  b.mu = take(p, d.D);
  b.xnet = net_at(p, d);
  b.vnet = net_at(p, d);
  return b;
}

// grad = P (x - mu)
template <class C>
__device__ inline void gauss_grad(const Block& B, Dims d, const float* x,
                                  float* g) {
  float dx[C::DM];
#pragma unroll (C::UD)
  for (int j = 0; j < C::DM; ++j) {
    if (j >= d.D) break;
    dx[j] = x[j] - B.mu[j];
  }
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    float acc = 0.f;
#pragma unroll (C::UD)
    for (int j = 0; j < C::DM; ++j) {
      if (j >= d.D) break;
      acc = fmaf(B.prec[i * d.D + j], dx[j], acc);
    }
    g[i] = acc;
  }
}

// 0.5 (x - mu)^T P (x - mu)
template <class C>
__device__ inline float gauss_energy(const Block& B, Dims d, const float* x) {
  float dx[C::DM];
#pragma unroll (C::UD)
  for (int j = 0; j < C::DM; ++j) {
    if (j >= d.D) break;
    dx[j] = x[j] - B.mu[j];
  }
  float e = 0.f;
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    float acc = 0.f;
#pragma unroll (C::UD)
    for (int j = 0; j < C::DM; ++j) {
      if (j >= d.D) break;
      acc = fmaf(B.prec[i * d.D + j], dx[j], acc);
    }
    e = fmaf(dx[i], acc, e);
  }
  return 0.5f * e;
}

template <class C>
__device__ inline float kinetic(Dims d, const float* v) {
  float k = 0.f;
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    k = fmaf(v[i], v[i], k);
  }
  return 0.5f * k;
}

// Opts a kernel in to more than 48 KB of dynamic shared memory when needed.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace l2hmc
