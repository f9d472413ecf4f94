// Shared device code of the L2HMC kernels: the parameter block layout, the
// S/T/Q net, the in-kernel Gaussian energy and the augmented leapfrog
// substep. Counterpart of l2hmc_tpu/ops/fused_dynamics.py's _apply_stq,
// _trajectory_step, _trajectory and QuadraticGaussianEnergy.
//
// One thread runs one chain. The chain's state and net activations live in
// per-thread arrays of compile-time size (registers for the small SCG
// instantiation, local memory for the wide one); the weights are read from
// shared memory, loaded once per block.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace l2hmc {

constexpr int kThreads = 64;  // threads (= chains) per block

struct Dims {
  int D, H, H2, T;  // state dim, S/T/Q hidden widths, leapfrog steps
};

// Compile-time caps of one instantiation. UNR = 1 unrolls every loop over
// the caps, so the per-thread arrays stay in registers (small caps only);
// UNRH, by default UNR, says the same of the loops over the hidden widths.
template <int DM_, int HM_, int UNR_, int UNRH_ = UNR_>
struct Cfg {
  static const int DM = DM_;
  static const int HM = HM_;
  static const int UD = UNR_ ? DM_ : 1;
  static const int UH = UNRH_ ? HM_ : 1;
};
typedef Cfg<2, 16, 1> Small;   // SCG: D = 2, H = H2 = 10
typedef Cfg<64, 64, 0> Wide;   // e.g. the 50-d ill-conditioned Gaussian
// The backward kernel's SCG instantiation: its substep VJP holds eight net
// applications, and unrolled over the hidden widths as well it becomes too
// large a program for the compiler, so only the loops over D are unrolled.
typedef Cfg<2, 16, 1, 0> SmallBwd;

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

// -- vector-Jacobian products (the training path's backward kernel) ---------
//
// Counterpart of the hand-derived plain version, _stq_vjp / _step_vjp in
// l2hmc_tpu_torch/ops/fused_dynamics.py. The forward functions above are
// not changed; each VJP recomputes what it needs with the same expressions.

// One net's weight-cotangent rows in the (P, N) gradient scratch, at one
// chain's column: row r of element k is p[(off + k) * N]. The row order is
// the parameter block's (net_at).
struct GradRows {
  float* p;
  size_t N;
  int w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te;
  __device__ void add(int row, float val) const {
    p[static_cast<size_t>(row) * N] += val;
  }
};

__device__ inline GradRows grad_rows(float* p, size_t N, Dims d) {
  GradRows g;
  g.p = p;
  g.N = N;
  int o = 0;
  g.w1 = o; o += d.D * d.H;
  g.w2 = o; o += d.D * d.H;
  g.wh = o; o += d.H * d.H2;
  g.bh = o; o += d.H2;
  g.ws = o; o += d.H2 * d.D;
  g.bs = o; o += d.D;
  g.ls = o; o += d.D;
  g.wt = o; o += d.H2 * d.D;
  g.bt = o; o += d.D;
  g.wq = o; o += d.H2 * d.D;
  g.bq = o; o += d.D;
  g.lq = o; o += d.D;
  g.te = o;
  return g;
}

// dx += P^T dg (the VJP of gauss_grad).
template <class C>
__device__ inline void gauss_grad_vjp(const Block& B, Dims d, const float* dg,
                                      float* dx) {
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    float acc = 0.f;
#pragma unroll (C::UD)
    for (int j = 0; j < C::DM; ++j) {
      if (j >= d.D) break;
      acc = fmaf(B.prec[j * d.D + i], dg[j], acc);
    }
    dx[i] += acc;
  }
}

// VJP of apply_stq at inputs (a, b) for output cotangents (ds, dt, dq):
// recomputes h and h2, adds this chain's weight cotangents to its gradient
// rows and writes (da, db). relu'(0) = 0. Zero in HMC mode.
template <class C>
__device__ inline void apply_stq_vjp(bool hmc, const Net& w, const GradRows& g,
                                     Dims d, int step, const float* a,
                                     const float* b, const float* ds,
                                     const float* dt, const float* dq,
                                     float* da, float* db) {
  if (hmc) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      da[i] = 0.f;
      db[i] = 0.f;
    }
    return;
  }
  float h[C::HM], h2[C::HM], dz[C::HM];
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
    dz[k] = 0.f;
  }
  // heads: S = exp(ls) tanh(us), T = ut, Q = exp(lq) tanh(uq)
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    float as = 0.f, aq = 0.f;
#pragma unroll (C::UH)
    for (int k = 0; k < C::HM; ++k) {
      if (k >= d.H2) break;
      as = fmaf(w.ws[k * d.D + i], h2[k], as);
      aq = fmaf(w.wq[k * d.D + i], h2[k], aq);
    }
    const float ts = tanhf(as + w.bs[i]), tq = tanhf(aq + w.bq[i]);
    const float dse = ds[i] * expf(w.ls[i]), dqe = dq[i] * expf(w.lq[i]);
    const float dus = dse * (1.f - ts * ts), duq = dqe * (1.f - tq * tq);
    const float dti = dt[i];
    g.add(g.ls + i, dse * ts);
    g.add(g.lq + i, dqe * tq);
    g.add(g.bs + i, dus);
    g.add(g.bt + i, dti);
    g.add(g.bq + i, duq);
#pragma unroll (C::UH)
    for (int k = 0; k < C::HM; ++k) {
      if (k >= d.H2) break;
      const int r = k * d.D + i;
      g.add(g.ws + r, h2[k] * dus);
      g.add(g.wt + r, h2[k] * dti);
      g.add(g.wq + r, h2[k] * duq);
      dz[k] = fmaf(w.ws[r], dus, fmaf(w.wt[r], dti, fmaf(w.wq[r], duq, dz[k])));
    }
  }
  // hidden: dz2 = dh2 * [h2 > 0]; h2 is reused below for dz1
#pragma unroll (C::UH)
  for (int k = 0; k < C::HM; ++k) {
    if (k >= d.H2) break;
    dz[k] = h2[k] > 0.f ? dz[k] : 0.f;
    g.add(g.bh + k, dz[k]);
  }
#pragma unroll (C::UH)
  for (int j = 0; j < C::HM; ++j) {
    if (j >= d.H) break;
    float acc = 0.f;
#pragma unroll (C::UH)
    for (int k = 0; k < C::HM; ++k) {
      if (k >= d.H2) break;
      acc = fmaf(w.wh[j * d.H2 + k], dz[k], acc);
      g.add(g.wh + j * d.H2 + k, h[j] * dz[k]);
    }
    h2[j] = h[j] > 0.f ? acc : 0.f;  // dz1
    g.add(g.te + j * d.T + step, h2[j]);
  }
  // embeds
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    float acc_a = 0.f, acc_b = 0.f;
#pragma unroll (C::UH)
    for (int j = 0; j < C::HM; ++j) {
      if (j >= d.H) break;
      const int r = i * d.H + j;
      acc_a = fmaf(w.w1[r], h2[j], acc_a);
      acc_b = fmaf(w.w2[r], h2[j], acc_b);
      g.add(g.w1 + r, a[i] * h2[j]);
      g.add(g.w2 + r, b[i] * h2[j]);
    }
    da[i] = acc_a;
    db[i] = acc_b;
  }
}

// VJP of traj_step at the substep's input (x, v). On entry dx, dv hold the
// cotangents of the substep's output (x', v') and dld that of its logdet
// increment; on return they hold the cotangents of (x, v). The chain's eps
// cotangent is added to de, the weight cotangents to gx (xnet) and gv
// (vnet). The substep is recomputed first with traj_step's expressions;
// the backward formulas are those of _step_vjp.
template <class C>
__device__ inline void traj_step_vjp(const Block& B, const GradRows& gx,
                                     const GradRows& gv, Dims d, bool hmc,
                                     bool reverse, int step, const float* x,
                                     const float* v, float* dx, float* dv,
                                     float dld, float* de) {
  float m[C::DM], g1[C::DM], s1[C::DM], t1[C::DM], q1[C::DM], vh[C::DM],
      in2[C::DM], s2[C::DM], t2[C::DM], q2[C::DM], y[C::DM], in3[C::DM],
      s3[C::DM], t3[C::DM], q3[C::DM], xo[C::DM], g2[C::DM], s4[C::DM],
      t4[C::DM], q4[C::DM];
  float dxo[C::DM], dvo[C::DM], dvh[C::DM], dy[C::DM], ds[C::DM], dt[C::DM],
      dq[C::DM], dg[C::DM], da[C::DM], db[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    m[i] = B.masks[i * d.T + step];
    dxo[i] = dx[i];
    dvo[i] = dv[i];
  }
  if (!reverse) {
    // recompute (traj_step, forward branch)
    gauss_grad<C>(B, d, x, g1);
    apply_stq<C>(hmc, B.vnet, d, step, x, g1, s1, t1, q1);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      vh[i] = v[i] * expf(0.5f * e * s1[i]) +
              0.5f * e * (-expf(e * q1[i]) * g1[i] + t1[i]);
      in2[i] = m[i] * x[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in2, s2, t2, q2);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      y[i] = m[i] * x[i] +
             mb * (x[i] * expf(e * s2[i]) + e * (expf(e * q2[i]) * vh[i] + t2[i]));
      in3[i] = mb * y[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in3, s3, t3, q3);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      xo[i] = mb * y[i] +
              m[i] * (y[i] * expf(e * s3[i]) + e * (expf(e * q3[i]) * vh[i] + t3[i]));
    }
    gauss_grad<C>(B, d, xo, g2);
    apply_stq<C>(hmc, B.vnet, d, step, xo, g2, s4, t4, q4);

    // v' = vh E4 + e/2 (-Q4 g2 + t4)
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], h = 0.5f * e;
      const float E = expf(h * s4[i]), Q = expf(e * q4[i]);
      dvh[i] = dvo[i] * E;
      const float dsv = dvo[i] * vh[i] * E + dld;
      const float dQ = -dvo[i] * h * g2[i];
      de[i] += 0.5f * dvo[i] * (-Q * g2[i] + t4[i]) + dQ * Q * q4[i] +
               0.5f * dsv * s4[i];
      ds[i] = dsv * h;
      dt[i] = dvo[i] * h;
      dq[i] = dQ * Q * e;
      dg[i] = -dvo[i] * h * Q;
    }
    apply_stq_vjp<C>(hmc, B.vnet, gv, d, step, xo, g2, ds, dt, dq, da, db);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dxo[i] += da[i];
      dg[i] += db[i];
    }
    gauss_grad_vjp<C>(B, d, dg, dxo);
    // x' = mb y + m (y E3 + e (Q3 vh + t3))
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float E = expf(e * s3[i]), Q = expf(e * q3[i]);
      dy[i] = dxo[i] * (mb + m[i] * E);
      const float dsx = dxo[i] * m[i] * y[i] * E + dld * m[i];
      dt[i] = dxo[i] * m[i] * e;
      const float dQ = dt[i] * vh[i];
      dvh[i] += dt[i] * Q;
      de[i] += dxo[i] * m[i] * (Q * vh[i] + t3[i]) + dQ * Q * q3[i] + dsx * s3[i];
      ds[i] = dsx * e;
      dq[i] = dQ * Q * e;
    }
    apply_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in3, ds, dt, dq, da, db);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dvh[i] += da[i];
      dy[i] += db[i] * (1.f - m[i]);
    }
    // y = m x + mb (x E2 + e (Q2 vh + t2)); dxo now accumulates dx
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float E = expf(e * s2[i]), Q = expf(e * q2[i]);
      dxo[i] = dy[i] * (m[i] + mb * E);
      const float dsx = dy[i] * mb * x[i] * E + dld * mb;
      dt[i] = dy[i] * mb * e;
      const float dQ = dt[i] * vh[i];
      dvh[i] += dt[i] * Q;
      de[i] += dy[i] * mb * (Q * vh[i] + t2[i]) + dQ * Q * q2[i] + dsx * s2[i];
      ds[i] = dsx * e;
      dq[i] = dQ * Q * e;
    }
    apply_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in2, ds, dt, dq, da, db);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dvh[i] += da[i];
      dxo[i] += db[i] * m[i];
    }
    // vh = v E1 + e/2 (-Q1 g1 + t1)
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], h = 0.5f * e;
      const float E = expf(h * s1[i]), Q = expf(e * q1[i]);
      dv[i] = dvh[i] * E;
      const float dsv = dvh[i] * v[i] * E + dld;
      const float dQ = -dvh[i] * h * g1[i];
      de[i] += 0.5f * dvh[i] * (-Q * g1[i] + t1[i]) + dQ * Q * q1[i] +
               0.5f * dsv * s1[i];
      ds[i] = dsv * h;
      dt[i] = dvh[i] * h;
      dq[i] = dQ * Q * e;
      dg[i] = -dvh[i] * h * Q;
    }
    apply_stq_vjp<C>(hmc, B.vnet, gv, d, step, x, g1, ds, dt, dq, da, db);
  } else {
    // recompute (traj_step, reverse branch)
    gauss_grad<C>(B, d, x, g1);
    apply_stq<C>(hmc, B.vnet, d, step, x, g1, s1, t1, q1);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      vh[i] = (v[i] - 0.5f * e * (-expf(e * q1[i]) * g1[i] + t1[i])) *
              expf(-0.5f * e * s1[i]);
      in2[i] = (1.f - m[i]) * x[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in2, s2, t2, q2);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      y[i] = mb * x[i] + m[i] * expf(-e * s2[i]) *
                             (x[i] - e * (expf(e * q2[i]) * vh[i] + t2[i]));
      in3[i] = m[i] * y[i];
    }
    apply_stq<C>(hmc, B.xnet, d, step, vh, in3, s3, t3, q3);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      xo[i] = m[i] * y[i] + mb * expf(-e * s3[i]) *
                                (y[i] - e * (expf(e * q3[i]) * vh[i] + t3[i]));
    }
    gauss_grad<C>(B, d, xo, g2);
    apply_stq<C>(hmc, B.vnet, d, step, xo, g2, s4, t4, q4);

    // v' = E4 (vh - e/2 (-Q4 g2 + t4))
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], h = 0.5f * e;
      const float E = expf(-h * s4[i]), Q = expf(e * q4[i]);
      const float A = vh[i] - h * (-Q * g2[i] + t4[i]);
      dvh[i] = dvo[i] * E;
      const float dsv = dvo[i] * A * E + dld;
      const float dQ = dvh[i] * h * g2[i];
      de[i] += 0.5f * dvh[i] * (Q * g2[i] - t4[i]) + dQ * Q * q4[i] -
               0.5f * dsv * s4[i];
      ds[i] = -h * dsv;
      dt[i] = -dvh[i] * h;
      dq[i] = dQ * Q * e;
      dg[i] = dvh[i] * h * Q;
    }
    apply_stq_vjp<C>(hmc, B.vnet, gv, d, step, xo, g2, ds, dt, dq, da, db);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dxo[i] += da[i];
      dg[i] += db[i];
    }
    gauss_grad_vjp<C>(B, d, dg, dxo);
    // x' = m y + mb E3 (y - e (Q3 vh + t3))
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float E = expf(-e * s3[i]), Q = expf(e * q3[i]);
      const float Bv = y[i] - e * (Q * vh[i] + t3[i]);
      const float dB = dxo[i] * mb * E;
      dy[i] = dxo[i] * m[i] + dB;
      const float dsx = dB * Bv + dld * mb;
      dt[i] = -dB * e;
      const float dQ = dt[i] * vh[i];
      dvh[i] += dt[i] * Q;
      de[i] += -dB * (Q * vh[i] + t3[i]) + dQ * Q * q3[i] - dsx * s3[i];
      ds[i] = -e * dsx;
      dq[i] = dQ * Q * e;
    }
    apply_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in3, ds, dt, dq, da, db);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dvh[i] += da[i];
      dy[i] += db[i] * m[i];
    }
    // y = mb x + m E2 (x - e (Q2 vh + t2)); dxo now accumulates dx
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float E = expf(-e * s2[i]), Q = expf(e * q2[i]);
      const float Bv = x[i] - e * (Q * vh[i] + t2[i]);
      const float dB = dy[i] * m[i] * E;
      dxo[i] = dy[i] * mb + dB;
      const float dsx = dB * Bv + dld * m[i];
      dt[i] = -dB * e;
      const float dQ = dt[i] * vh[i];
      dvh[i] += dt[i] * Q;
      de[i] += -dB * (Q * vh[i] + t2[i]) + dQ * Q * q2[i] - dsx * s2[i];
      ds[i] = -e * dsx;
      dq[i] = dQ * Q * e;
    }
    apply_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in2, ds, dt, dq, da, db);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dvh[i] += da[i];
      dxo[i] += db[i] * (1.f - m[i]);
    }
    // vh = (v - e/2 (-Q1 g1 + t1)) E1
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], h = 0.5f * e;
      const float E = expf(-h * s1[i]), Q = expf(e * q1[i]);
      const float A = v[i] - h * (-Q * g1[i] + t1[i]);
      dv[i] = dvh[i] * E;
      const float dsv = dvh[i] * A * E + dld;
      const float dQ = dv[i] * h * g1[i];
      de[i] += 0.5f * dv[i] * (Q * g1[i] - t1[i]) + dQ * Q * q1[i] -
               0.5f * dsv * s1[i];
      ds[i] = -h * dsv;
      dt[i] = -dv[i] * h;
      dq[i] = dQ * Q * e;
      dg[i] = dv[i] * h * Q;
    }
    apply_stq_vjp<C>(hmc, B.vnet, gv, d, step, x, g1, ds, dt, dq, da, db);
  }
  // x, g1 -> the vnet's first application and the first energy gradient
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dxo[i] += da[i];
    dg[i] += db[i];
  }
  gauss_grad_vjp<C>(B, d, dg, dxo);
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dx[i] = dxo[i];
  }
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
