// Shared device code of the L2HMC kernels: the parameter block layout, the
// S/T/Q net, the in-kernel Gaussian energy and the augmented leapfrog
// substep. Counterpart of l2hmc_tpu/ops/fused_dynamics.py's _apply_stq,
// _trajectory_step, _trajectory and QuadraticGaussianEnergy.
//
// Here one thread runs one chain: the chain kernel (chain.cu) runs
// trajectory<C> on Cfg's instantiations, and they stay only as long as it
// does. The chain's state and net activations live in per-thread arrays of
// compile-time size (registers for the small SCG instantiation, local
// memory for the wide one); the weights are read from shared memory, loaded
// once per block. The trajectory kernel and its backward kernel run a chain
// on a lane group (l2hmc_lanes.cuh), on the parameter block, the Gaussian
// energy and the substep's expressions defined here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace l2hmc {

constexpr int kThreads = 64;  // threads (= chains) per block

struct Dims {
  int D, H, H2, T;  // state dim, S/T/Q hidden widths, leapfrog steps
};

// Compile-time caps of one instantiation. UNR = 1 unrolls every loop over
// the caps, so the per-thread arrays stay in registers (small caps only).
template <int DM_, int HM_, int UNR_>
struct Cfg {
  static const int DM = DM_;
  static const int HM = HM_;
  static const int UD = UNR_ ? DM_ : 1;
  static const int UH = UNR_ ? HM_ : 1;
};
typedef Cfg<2, 16, 1> Small;   // SCG: D = 2, H = H2 = 10
typedef Cfg<64, 64, 0> Wide;   // e.g. the 50-d ill-conditioned Gaussian

// Parameter block, float32, packed on the host by
// l2hmc_tpu_torch/ops/fused_dynamics.py (_pack_block):
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

// S/T/Q net on one chain: h = relu(w1^T a + w2^T b + te[:, step]),
// h2 = relu(wh^T h + bh), S = exp(ls) tanh(ws^T h2 + bs), T = wt^T h2 + bt,
// Q = exp(lq) tanh(wq^T h2 + bq). Zero nets in HMC mode.
template <class C>
__device__ inline void apply_stq(bool hmc, const Net& w, Dims d, int step,
                                 const float* a, const float* b, float* s,
                                 float* t, float* q) {
  if (hmc) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      s[i] = 0.f;
      t[i] = 0.f;
      q[i] = 0.f;
    }
    return;
  }
  float h[C::HM];
#pragma unroll (C::UH)
  for (int j = 0; j < C::HM; ++j) {
    if (j >= d.H) break;
    float acc = 0.f;
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      acc = fmaf(w.w1[i * d.H + j], a[i], acc);
    }
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      acc = fmaf(w.w2[i * d.H + j], b[i], acc);
    }
    h[j] = fmaxf(acc + w.te[j * d.T + step], 0.f);
  }
  float h2[C::HM];
#pragma unroll (C::UH)
  for (int k = 0; k < C::HM; ++k) {
    if (k >= d.H2) break;
    float acc = 0.f;
#pragma unroll (C::UH)
    for (int j = 0; j < C::HM; ++j) {
      if (j >= d.H) break;
      acc = fmaf(w.wh[j * d.H2 + k], h[j], acc);
    }
    h2[k] = fmaxf(acc + w.bh[k], 0.f);
  }
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    float as = 0.f, at = 0.f, aq = 0.f;
#pragma unroll (C::UH)
    for (int k = 0; k < C::HM; ++k) {
      if (k >= d.H2) break;
      as = fmaf(w.ws[k * d.D + i], h2[k], as);
      at = fmaf(w.wt[k * d.D + i], h2[k], at);
      aq = fmaf(w.wq[k * d.D + i], h2[k], aq);
    }
    s[i] = expf(w.ls[i]) * tanhf(as + w.bs[i]);
    t[i] = at + w.bt[i];
    q[i] = expf(w.lq[i]) * tanhf(aq + w.bq[i]);
  }
}

// One augmented leapfrog substep in place on (x, v); returns the logdet
// increment. Forward: utils/dynamics.py:115-157 of the reference; reverse:
// its exact inverse (:159-201).
template <class C>
__device__ inline float traj_step(const Block& B, Dims d, bool hmc,
                                  bool reverse, int step, float* x, float* v) {
  float m[C::DM], g[C::DM], s[C::DM], t[C::DM], q[C::DM], vh[C::DM],
      y[C::DM], in[C::DM];
  float ld = 0.f;
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    m[i] = B.masks[i * d.T + step];
  }
  if (!reverse) {
    gauss_grad<C>(B, d, x, g);
    apply_stq<C>(hmc, B.vnet, d, step, x, g, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      const float sv1 = 0.5f * e * s[i];
      vh[i] = v[i] * expf(sv1) + 0.5f * e * (-expf(e * q[i]) * g[i] + t[i]);
      ld += sv1;
      in[i] = m[i] * x[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float sx1 = e * s[i];
      y[i] = m[i] * x[i] +
             mb * (x[i] * expf(sx1) + e * (expf(e * q[i]) * vh[i] + t[i]));
      ld += mb * sx1;
      in[i] = mb * y[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float sx2 = e * s[i];
      x[i] = mb * y[i] +
             m[i] * (y[i] * expf(sx2) + e * (expf(e * q[i]) * vh[i] + t[i]));
      ld += m[i] * sx2;
    }
    gauss_grad<C>(B, d, x, g);
    apply_stq<C>(hmc, B.vnet, d, step, x, g, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      const float sv2 = 0.5f * e * s[i];
      v[i] = vh[i] * expf(sv2) + 0.5f * e * (-expf(e * q[i]) * g[i] + t[i]);
      ld += sv2;
    }
  } else {
    gauss_grad<C>(B, d, x, g);
    apply_stq<C>(hmc, B.vnet, d, step, x, g, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      const float sv2 = -0.5f * e * s[i];
      vh[i] = (v[i] - 0.5f * e * (-expf(e * q[i]) * g[i] + t[i])) * expf(sv2);
      ld += sv2;
      in[i] = (1.f - m[i]) * x[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float sx2 = -e * s[i];
      y[i] = mb * x[i] +
             m[i] * expf(sx2) * (x[i] - e * (expf(e * q[i]) * vh[i] + t[i]));
      ld += m[i] * sx2;
      in[i] = m[i] * y[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float sx1 = -e * s[i];
      x[i] = m[i] * y[i] +
             mb * expf(sx1) * (y[i] - e * (expf(e * q[i]) * vh[i] + t[i]));
      ld += mb * sx1;
    }
    gauss_grad<C>(B, d, x, g);
    apply_stq<C>(hmc, B.vnet, d, step, x, g, s, t, q);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      const float sv1 = -0.5f * e * s[i];
      v[i] = expf(sv1) * (vh[i] - 0.5f * e * (-expf(e * q[i]) * g[i] + t[i]));
      ld += sv1;
    }
  }
  return ld;
}

// T substeps, forward in step order or reverse in reverse order.
template <class C>
__device__ inline float trajectory(const Block& B, Dims d, bool hmc,
                                   bool reverse, float* x, float* v) {
  float ld = 0.f;
  for (int k = 0; k < d.T; ++k) {
    const int step = reverse ? d.T - 1 - k : k;
    ld += traj_step<C>(B, d, hmc, reverse, step, x, v);
  }
  return ld;
}

// Which instantiation serves these widths: 1 = Small, 2 = Wide, 0 = none.
inline int pick_cfg(Dims d) {
  if (d.D <= Small::DM && d.H <= Small::HM && d.H2 <= Small::HM) return 1;
  if (d.D <= Wide::DM && d.H <= Wide::HM && d.H2 <= Wide::HM) return 2;
  return 0;
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
