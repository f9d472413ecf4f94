// Shared device code of the L2HMC kernels: the parameter block layout, its
// load into shared memory, the in-kernel energy specs (each target's energy,
// its gradient and the gradient's vector-Jacobian product) and the kinetic
// energy. Counterpart of l2hmc_tpu/ops/fused_dynamics.py's energy specs
// (QuadraticGaussianEnergy :391, RoughWellEnergy :422, GmmEnergy :446,
// FunnelEnergy :501, Phi4Energy :548). The kernels (trajectory.cu,
// trajectory_bwd.cu, chain.cu) run a chain on a lane group
// (l2hmc_lanes.cuh), or, past 64 wide, a tile of chains on a block
// (l2hmc_sites.cuh); their S/T/Q net and substep have their
// plain versions in ops/fused_dynamics.py (_apply_stq, _trajectory_step),
// and they take the energy spec as a template parameter En.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace l2hmc {

struct Dims {
  int D, H, H2, T;  // state dim, S/T/Q hidden widths, leapfrog steps
  int NC;           // floats of the energy spec's constants
};

// Parameter block, float32, packed on the host by
// l2hmc_tpu_torch/ops/fused_dynamics.py (KernelInputs.block):
//   eps (D) | masks (D x T) | consts (NC) | xnet | vnet
// where consts are the energy spec's arrays and scalars (the layout each
// spec below states), and each net is the 13 arrays of _extract_net,
// row-major:
//   w1 (D x H) w2 (D x H) wh (H x H2) bh (H2) ws (H2 x D) bs (D) ls (D)
//   wt (H2 x D) bt (D) wq (H2 x D) bq (D) lq (D) te (H x T)
__host__ __device__ inline int net_floats(Dims d) {
  return 2 * d.D * d.H + d.H * d.H2 + d.H2 + 3 * d.H2 * d.D + 5 * d.D +
         d.H * d.T;
}
__host__ __device__ inline int block_floats(Dims d) {
  return d.D + d.D * d.T + d.NC + 2 * net_floats(d);
}

struct Net {
  const float *w1, *w2, *wh, *bh, *ws, *bs, *ls, *wt, *bt, *wq, *bq, *lq, *te;
};

struct Block {
  const float *eps, *masks, *c;  // c: the energy spec's constants
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

// The arrays of a parameter block at p, where it lies.
__device__ inline Block block_at(const float* p, Dims d) {
  Block b;
  b.eps = take(p, d.D);
  b.masks = take(p, d.D * d.T);
  b.c = take(p, d.NC);
  b.xnet = net_at(p, d);
  b.vnet = net_at(p, d);
  return b;
}

// Copies the parameter block into dynamic shared memory. Every thread of
// the block must call it (it synchronises), before any thread returns.
__device__ inline Block load_block(const float* __restrict__ g, float* s,
                                   Dims d) {
  const int n = block_floats(d);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = g[i];
  __syncthreads();
  return block_at(s, d);
}

// -- energy specs ---------------------------------------------------------------
//
// Each spec is a struct with its kind (the number the host passes, the
// Python spec's KIND), a check that NC constants fit it, and three device
// functions on one chain's D-vector, templated on the lane configuration C
// (its DM and unroll UD; every lane of a group runs them on its own copy of
// the state):
//   grad(B, d, x, g)            g = grad E(x)
//   energy(B, d, x)             E(x)
//   grad_vjp(B, d, x, dg, dx)   dx += J(x)^T dg, J the Jacobian of grad E
// The arithmetic is the JAX closures' (l2hmc_tpu/ops/fused_dynamics.py
// :391-597) and their plain versions' (the specs' build and build_grad_vjp
// in ops/fused_dynamics.py), sums over i in index order. For the
// site-parallel configuration (l2hmc_sites.cuh), whose kernels keep one
// chain's D-vector x in shared memory and spread its sites over a block's
// threads, every spec also gives one site i of it, from the constants c and
// pre, the chain's prelude (below; unused where the spec has none):
//   grad_at(c, d, x, i, pre)            (grad E(x))_i
//   energy_at(c, d, x, i)               site i's term of E(x)
//   grad_vjp_at(c, d, x, dg, i, pre)    (J(x)^T dg)_i
// A spec whose site needs more than its neighbours (Funnel: the neck's sum of
// squares; Gmm: each component's quadratic form) has kPrelude: per chain,
// before the gradient, the energy or the VJP, the block sums pre_passes(d)
// times one or (with dg) two sums over the sites i of pre_part (pass k's
// first sums go to pre[k], its second to pre[pre_passes(d) + k]), then
// pre_finish turns them into the pre_floats(d) scalars the site functions
// read; its energy is then a whole chain's, chain_energy(d, pre), not a sum
// of energy_at.

// 0.5 (x - mu)^T P (x - mu). Constants: P (D x D, row-major) | mu (D).
struct Gauss {
  static constexpr int kKind = 0;
  __host__ __device__ static bool fits(Dims d) {
    return d.NC == d.D * d.D + d.D;
  }

  // grad = P (x - mu)
  template <class C>
  __device__ static void grad(const Block& B, Dims d, const float* x,
                              float* g) {
    const float* mu = B.c + d.D * d.D;
    float dx[C::DM];
#pragma unroll (C::UD)
    for (int j = 0; j < C::DM; ++j) {
      if (j >= d.D) break;
      dx[j] = x[j] - mu[j];
    }
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      float acc = 0.f;
#pragma unroll (C::UD)
      for (int j = 0; j < C::DM; ++j) {
        if (j >= d.D) break;
        acc = fmaf(B.c[i * d.D + j], dx[j], acc);
      }
      g[i] = acc;
    }
  }

  template <class C>
  __device__ static float energy(const Block& B, Dims d, const float* x) {
    const float* mu = B.c + d.D * d.D;
    float dx[C::DM];
#pragma unroll (C::UD)
    for (int j = 0; j < C::DM; ++j) {
      if (j >= d.D) break;
      dx[j] = x[j] - mu[j];
    }
    float e = 0.f;
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      float acc = 0.f;
#pragma unroll (C::UD)
      for (int j = 0; j < C::DM; ++j) {
        if (j >= d.D) break;
        acc = fmaf(B.c[i * d.D + j], dx[j], acc);
      }
      e = fmaf(dx[i], acc, e);
    }
    return 0.5f * e;
  }

  static constexpr bool kPrelude = false;
  __device__ static float grad_at(const float* c, Dims d, const float* x,
                                 int i, const float* = nullptr) {
    const int D = d.D;
    const float* mu = c + D * D;
    float acc = 0.f;
    for (int j = 0; j < D; ++j) acc = fmaf(c[i * D + j], x[j] - mu[j], acc);
    return acc;
  }
  // 0.5 (x_i - mu_i) (P (x - mu))_i
  __device__ static float energy_at(const float* c, Dims d, const float* x,
                                   int i) {
    return 0.5f * ((x[i] - c[d.D * d.D + i]) * grad_at(c, d, x, i));
  }
  // (P^T dg)_i
  __device__ static float grad_vjp_at(const float* c, Dims d, const float*,
                                     const float* dg, int i,
                                     const float* = nullptr) {
    const int D = d.D;
    float acc = 0.f;
    for (int j = 0; j < D; ++j) acc = fmaf(c[j * D + i], dg[j], acc);
    return acc;
  }

  // dx += P^T dg
  template <class C>
  __device__ static void grad_vjp(const Block& B, Dims d, const float*,
                                  const float* dg, float* dx) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      float acc = 0.f;
#pragma unroll (C::UD)
      for (int j = 0; j < C::DM; ++j) {
        if (j >= d.D) break;
        acc = fmaf(B.c[j * d.D + i], dg[j], acc);
      }
      dx[i] += acc;
    }
  }
};

// 0.5 |x|^2 + eps sum cos(x / freq), the rough well (freq = eps in easy
// mode, eps^2 in hard). Constants: eps | 1/freq | eps/freq | eps/freq^2,
// each rounded to float32 once on the host, as the JAX closures' Python
// floats are. sinf/cosf with their full range reduction: the hard well's
// x/freq reaches hundreds (no --use_fast_math).
struct RoughWell {
  static constexpr int kKind = 1;
  __host__ __device__ static bool fits(Dims d) { return d.NC == 4; }

  template <class C>
  __device__ static void grad(const Block& B, Dims d, const float* x,
                              float* g) {
    const float r = B.c[1], a = B.c[2];
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      g[i] = x[i] - a * sinf(x[i] * r);
    }
  }

  template <class C>
  __device__ static float energy(const Block& B, Dims d, const float* x) {
    const float eps = B.c[0], r = B.c[1];
    float e = 0.f;
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      e += 0.5f * (x[i] * x[i]) + eps * cosf(x[i] * r);
    }
    return e;
  }

  // dx += (1 - (eps/freq^2) cos(x/freq)) dg
  template <class C>
  __device__ static void grad_vjp(const Block& B, Dims d, const float* x,
                                  const float* dg, float* dx) {
    const float r = B.c[1], b = B.c[3];
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dx[i] += (1.f - b * cosf(x[i] * r)) * dg[i];
    }
  }

  // elementwise: a site reads only its own value
  static constexpr bool kPrelude = false;
  __device__ static float grad_at(const float* c, Dims, const float* x, int i,
                                 const float* = nullptr) {
    return x[i] - c[2] * sinf(x[i] * c[1]);
  }
  __device__ static float energy_at(const float* c, Dims, const float* x,
                                   int i) {
    return 0.5f * (x[i] * x[i]) + c[0] * cosf(x[i] * c[1]);
  }
  __device__ static float grad_vjp_at(const float* c, Dims, const float* x,
                                     const float* dg, int i,
                                     const float* = nullptr) {
    return (1.f - c[3] * cosf(x[i] * c[1])) * dg[i];
  }
};

// -logsumexp_k [c_k - 0.5 (x - mu_k)^T P_k (x - mu_k)], a Gaussian mixture
// (ring, mog2). Constants: mus (D x K, mu_k in column k) | P (K*D x D, P_k
// in rows kD..kD+D-1) | c (K); K = NC / (D + D^2 + 1). The K components
// run as a loop at run time, in two passes (the log-weights' max, then the
// weighted sums), recomputing P_k (x - mu_k) in the second: O(D) registers
// whatever K.
struct Gmm {
  static constexpr int kKind = 2;
  __host__ __device__ static int comps(Dims d) {
    return d.NC / (d.D + d.D * d.D + 1);
  }
  __host__ __device__ static bool fits(Dims d) {
    return d.NC > 0 && d.NC % (d.D + d.D * d.D + 1) == 0;
  }

  // dk = x - mu_k, p = P_k dk; returns the log-weight c_k - 0.5 dk.p
  template <class C>
  __device__ static float comp(const Block& B, Dims d, int K, int k,
                               const float* x, float* dk, float* p) {
    const float* prec = B.c + d.D * K + k * d.D * d.D;
#pragma unroll (C::UD)
    for (int j = 0; j < C::DM; ++j) {
      if (j >= d.D) break;
      dk[j] = x[j] - B.c[j * K + k];
    }
    float quad = 0.f;
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      float acc = 0.f;
#pragma unroll (C::UD)
      for (int j = 0; j < C::DM; ++j) {
        if (j >= d.D) break;
        acc = fmaf(prec[i * d.D + j], dk[j], acc);
      }
      p[i] = acc;
      quad = fmaf(dk[i], acc, quad);
    }
    return B.c[d.D * K + K * d.D * d.D + k] - 0.5f * quad;
  }

  template <class C>
  __device__ static float max_log_weight(const Block& B, Dims d, int K,
                                         const float* x) {
    float dk[C::DM], p[C::DM];
    float m = comp<C>(B, d, K, 0, x, dk, p);
    for (int k = 1; k < K; ++k) m = fmaxf(m, comp<C>(B, d, K, k, x, dk, p));
    return m;
  }

  // grad = sum_k w_k P_k (x - mu_k) / sum_k w_k, w_k = exp(lw_k - max)
  template <class C>
  __device__ static void grad(const Block& B, Dims d, const float* x,
                              float* g) {
    const int K = comps(d);
    const float m = max_log_weight<C>(B, d, K, x);
    float dk[C::DM], p[C::DM];
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      g[i] = 0.f;
    }
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = expf(comp<C>(B, d, K, k, x, dk, p) - m);
      s += w;
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        g[i] += w * p[i];
      }
    }
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      g[i] = g[i] / s;
    }
  }

  template <class C>
  __device__ static float energy(const Block& B, Dims d, const float* x) {
    const int K = comps(d);
    const float m = max_log_weight<C>(B, d, K, x);
    float dk[C::DM], p[C::DM];
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += expf(comp<C>(B, d, K, k, x, dk, p) - m);
    return -(m + logf(s));
  }

  // With w~_k the softmax weights, p_k = P_k dk, q_k = 0.5 (P_k + P_k^T) dk
  // and g = sum w~_k p_k:
  //   dx += sum_k w~_k [P_k^T dg - (p_k.dg) q_k] + (g.dg) sum_k w~_k q_k,
  // accumulated with the unnormalised w_k and divided by their sum at the
  // end.
  template <class C>
  __device__ static void grad_vjp(const Block& B, Dims d, const float* x,
                                  const float* dg, float* dx) {
    const int K = comps(d);
    const float m = max_log_weight<C>(B, d, K, x);
    float dk[C::DM], p[C::DM], a[C::DM], gs[C::DM], qs[C::DM];
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      a[i] = 0.f;
      gs[i] = 0.f;
      qs[i] = 0.f;
    }
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = expf(comp<C>(B, d, K, k, x, dk, p) - m);
      const float* prec = B.c + d.D * K + k * d.D * d.D;
      s += w;
      float pd = 0.f;
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        pd = fmaf(p[i], dg[i], pd);
      }
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        float ptd = 0.f, ptk = 0.f;  // (P_k^T dg)_i, (P_k^T dk)_i
#pragma unroll (C::UD)
        for (int j = 0; j < C::DM; ++j) {
          if (j >= d.D) break;
          ptd = fmaf(prec[j * d.D + i], dg[j], ptd);
          ptk = fmaf(prec[j * d.D + i], dk[j], ptk);
        }
        const float q = 0.5f * (p[i] + ptk);
        a[i] += w * (ptd - pd * q);
        gs[i] += w * p[i];
        qs[i] += w * q;
      }
    }
    float gd = 0.f;
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      gd = fmaf(gs[i] / s, dg[i], gd);
    }
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dx[i] += a[i] / s + gd * (qs[i] / s);
    }
  }

  // On sites. Pass k of the prelude sums dk.(P_k dk) and, with dg, p_k.dg;
  // pre_finish leaves per chain the unnormalised weights w_k = exp(lw_k -
  // max) in pre[0, K), the sums p_k.dg in pre[K, 2K), s = sum_k w_k in
  // pre[2K], and in pre[2K + 1] the energy -(max + log s) or, with dg,
  // g.dg = sum_k w_k (p_k.dg) / s. A site recomputes its element of P_k dk
  // from x in every pass and in the gradient, as the lane form's second
  // pass does: O(K D) a site and no store of P_k dk, which would take K C D
  // floats of shared memory (256 KB at D = 4096, K = 4, past what a block
  // may use beside x', v and g).
  static constexpr bool kPrelude = true;
  __host__ __device__ static int pre_passes(Dims d) { return comps(d); }
  __host__ __device__ static int pre_floats(Dims d) { return 2 * comps(d) + 2; }

  // (P_k (x - mu_k))_i
  __device__ static float row_at(const float* c, Dims d, int K, int k,
                                 const float* x, int i) {
    const int D = d.D;
    const float* prec = c + D * K + k * D * D;
    float acc = 0.f;
    for (int j = 0; j < D; ++j) acc = fmaf(prec[i * D + j], x[j] - c[j * K + k], acc);
    return acc;
  }
  __device__ static void pre_part(const float* c, Dims d, int k, const float* x,
                                  const float* dg, int i, float& a, float& b) {
    const int K = comps(d);
    const float p = row_at(c, d, K, k, x, i);
    a = fmaf(x[i] - c[i * K + k], p, a);
    if (dg != nullptr) b = fmaf(p, dg[i], b);
  }
  __device__ static void pre_finish(const float* c, Dims d, const float*,
                                    float* pre, bool vjp) {
    const int K = comps(d);
    const float* lc = c + d.D * K + K * d.D * d.D;
    float m = lc[0] - 0.5f * pre[0];
    for (int k = 1; k < K; ++k) m = fmaxf(m, lc[k] - 0.5f * pre[k]);
    float s = 0.f, gd = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = expf(lc[k] - 0.5f * pre[k] - m);
      pre[k] = w;
      s += w;
      if (vjp) gd = fmaf(w, pre[K + k], gd);
    }
    pre[2 * K] = s;
    pre[2 * K + 1] = vjp ? gd / s : -(m + logf(s));
  }
  __device__ static float chain_energy(Dims d, const float* pre) {
    return pre[2 * comps(d) + 1];
  }
  // sum_k w_k (P_k dk)_i / s
  __device__ static float grad_at(const float* c, Dims d, const float* x,
                                 int i, const float* pre) {
    const int K = comps(d);
    float g = 0.f;
    for (int k = 0; k < K; ++k) g += pre[k] * row_at(c, d, K, k, x, i);
    return g / pre[2 * K];
  }
  // sum_k w~_k [(P_k^T dg)_i - (p_k.dg) q_k,i] + (g.dg) sum_k w~_k q_k,i
  __device__ static float grad_vjp_at(const float* c, Dims d, const float* x,
                                     const float* dg, int i, const float* pre) {
    const int K = comps(d), D = d.D;
    float a = 0.f, qs = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* prec = c + D * K + k * D * D;
      float ptd = 0.f, ptk = 0.f;  // (P_k^T dg)_i, (P_k^T dk)_i
      for (int j = 0; j < D; ++j) {
        ptd = fmaf(prec[j * D + i], dg[j], ptd);
        ptk = fmaf(prec[j * D + i], x[j] - c[j * K + k], ptk);
      }
      const float q = 0.5f * (row_at(c, d, K, k, x, i) + ptk);
      a += pre[k] * (ptd - pre[K + k] * q);
      qs += pre[k] * q;
    }
    const float s = pre[2 * K];
    return a / s + pre[2 * K + 1] * (qs / s);
  }
};

// The Gaussian funnel with its clipped energy: v = x_0, w = clip(v, -c, c),
// S = sum_{i>=1} x_i^2,
//   E = 0.5 (v^2 / sigma^2 + S e^-w + n (log 2 pi + w)),  n = D - 1.
// Constants: 1/sigma^2 | c | n. The clip makes the v-gradient piecewise:
// d/dv through e^-w and w is zero outside (-c, c).
struct Funnel {
  static constexpr int kKind = 3;
  __host__ __device__ static bool fits(Dims d) { return d.NC == 3 && d.D >= 2; }

  template <class C>
  __device__ static float sum_sq(Dims d, const float* x) {
    float s = 0.f;
#pragma unroll (C::UD)
    for (int i = 1; i < C::DM; ++i) {
      if (i >= d.D) break;
      s += x[i] * x[i];
    }
    return s;
  }

  __device__ static float clip(float v, float c) {
    return fminf(fmaxf(v, -c), c);
  }

  template <class C>
  __device__ static void grad(const Block& B, Dims d, const float* x,
                              float* g) {
    const float is2 = B.c[0], c = B.c[1], n = B.c[2];
    const float v = x[0];
    const float inv_s = expf(-clip(v, c));
    const float in = (v > -c && v < c) ? 1.f : 0.f;
    const float S = sum_sq<C>(d, x);
#pragma unroll (C::UD)
    for (int i = 1; i < C::DM; ++i) {
      if (i >= d.D) break;
      g[i] = x[i] * inv_s;
    }
    g[0] = v * is2 + 0.5f * in * (n - S * inv_s);
  }

  template <class C>
  __device__ static float energy(const Block& B, Dims d, const float* x) {
    const float is2 = B.c[0], c = B.c[1], n = B.c[2];
    const float v = x[0];
    const float w = clip(v, c);
    const float S = sum_sq<C>(d, x);
    return 0.5f * (v * v * is2 + S * expf(-w) + n * (1.8378770664093453f + w));
  }

  // w' = in, the strict inside mask:
  //   dx_0 += dg_0 (1/sigma^2 + 0.5 in S e^-w) - in e^-w sum_{i>=1} x_i dg_i
  //   dx_i += e^-w dg_i - in x_i e^-w dg_0
  template <class C>
  __device__ static void grad_vjp(const Block& B, Dims d, const float* x,
                                  const float* dg, float* dx) {
    const float is2 = B.c[0], c = B.c[1];
    const float v = x[0];
    const float inv_s = expf(-clip(v, c));
    const float in = (v > -c && v < c) ? 1.f : 0.f;
    const float S = sum_sq<C>(d, x);
    float xd = 0.f;
#pragma unroll (C::UD)
    for (int i = 1; i < C::DM; ++i) {
      if (i >= d.D) break;
      xd += x[i] * dg[i];
      dx[i] += inv_s * dg[i] - in * x[i] * inv_s * dg[0];
    }
    dx[0] += dg[0] * (is2 + 0.5f * in * S * inv_s) - in * inv_s * xd;
  }

  // On sites. The prelude's one pass sums the neck's x_i^2 (S, pre[0]) and,
  // with dg, its x_i dg_i (pre[1]); without dg pre_finish puts the chain's
  // energy in pre[1]. Every site reads v = x_0 from the chain's array.
  static constexpr bool kPrelude = true;
  __host__ __device__ static int pre_passes(Dims) { return 1; }
  __host__ __device__ static int pre_floats(Dims) { return 2; }
  __device__ static void pre_part(const float*, Dims, int, const float* x,
                                  const float* dg, int i, float& a, float& b) {
    if (i == 0) return;
    a += x[i] * x[i];
    if (dg != nullptr) b += x[i] * dg[i];
  }
  __device__ static void pre_finish(const float* c, Dims, const float* x,
                                    float* pre, bool vjp) {
    if (vjp) return;
    const float v = x[0], w = clip(v, c[1]);
    pre[1] = 0.5f * (v * v * c[0] + pre[0] * expf(-w) + c[2] * (1.8378770664093453f + w));
  }
  __device__ static float chain_energy(Dims, const float* pre) { return pre[1]; }
  __device__ static float grad_at(const float* c, Dims, const float* x, int i,
                                 const float* pre) {
    const float v = x[0], inv_s = expf(-clip(v, c[1]));
    if (i > 0) return x[i] * inv_s;
    const float in = (v > -c[1] && v < c[1]) ? 1.f : 0.f;
    return v * c[0] + 0.5f * in * (c[2] - pre[0] * inv_s);
  }
  __device__ static float grad_vjp_at(const float* c, Dims, const float* x,
                                     const float* dg, int i, const float* pre) {
    const float v = x[0], inv_s = expf(-clip(v, c[1]));
    const float in = (v > -c[1] && v < c[1]) ? 1.f : 0.f;
    if (i > 0) return inv_s * dg[i] - in * x[i] * inv_s * dg[0];
    return dg[0] * (c[0] + 0.5f * in * pre[0] * inv_s) - in * inv_s * pre[1];
  }
};

// The 2-D phi^4 lattice action on the flattened L x L state, D = L L, site
// r L + c, as a 5-point stencil with JAX's neighbours: down and up are flat
// shifts by -+L (periodic in r for free), right and left flat shifts by
// -+1 whose row-end sites wrap within their row (right of c = L-1 is
// x[i - (L-1)], left of c = 0 is x[i + (L-1)]).
//   E = sum_i 0.5 [(right - x)^2 + (down - x)^2] + 0.5 m2 x^2 + lam x^4
//   grad = 4 x - (right + left + down + up) + m2 x + 4 lam x^3
// Constants: m2 | lam | L. The Hessian is symmetric, so the gradient's VJP
// is (4 + m2 + 12 lam x^2) dg - (the sum of dg over the four neighbours).
// The lane groups replicate the state in every lane, so the neighbours are
// a lane's own values (local memory on WideLanes, the only configuration
// that serves a square D up to 64).
struct Phi4 {
  static constexpr int kKind = 4;
  __host__ __device__ static bool fits(Dims d) {
    int L = 1;
    while (L * L < d.D) ++L;
    return d.NC == 3 && L * L == d.D;
  }

  // site i's right, left, down and up neighbours
  __device__ static void nbrs(int L, int D, int i, int& r, int& l, int& dn,
                              int& up) {
    const int c = i % L;
    r = c == L - 1 ? i - (L - 1) : i + 1;
    l = c == 0 ? i + (L - 1) : i - 1;
    dn = i + L >= D ? i + L - D : i + L;
    up = i < L ? i - L + D : i - L;
  }

  static constexpr bool kPrelude = false;
  __device__ static float grad_at(const float* c, Dims d, const float* x,
                                 int i, const float* = nullptr) {
    int r, l, dn, up;
    nbrs(static_cast<int>(c[2]), d.D, i, r, l, dn, up);
    const float xi = x[i];
    const float lap = 4.f * xi - x[r] - x[l] - x[dn] - x[up];
    return lap + c[0] * xi + (4.f * c[1]) * xi * xi * xi;
  }

  __device__ static float energy_at(const float* c, Dims d, const float* x,
                                   int i) {
    int r, l, dn, up;
    nbrs(static_cast<int>(c[2]), d.D, i, r, l, dn, up);
    const float xi = x[i], a = x[r] - xi, b = x[dn] - xi, x2 = xi * xi;
    return 0.5f * (a * a + b * b) + ((0.5f * c[0]) * x2 + c[1] * (x2 * x2));
  }

  // (4 + m2 + 12 lam x_i^2) dg_i - (the sum of dg over site i's neighbours)
  __device__ static float grad_vjp_at(const float* c, Dims d, const float* x,
                                     const float* dg, int i,
                                     const float* = nullptr) {
    int r, l, dn, up;
    nbrs(static_cast<int>(c[2]), d.D, i, r, l, dn, up);
    const float xi = x[i];
    return (4.f + c[0] + (12.f * c[1]) * xi * xi) * dg[i] -
           (dg[r] + dg[l] + dg[dn] + dg[up]);
  }

  template <class C>
  __device__ static void grad(const Block& B, Dims d, const float* x,
                              float* g) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      g[i] = grad_at(B.c, d, x, i);
    }
  }

  template <class C>
  __device__ static float energy(const Block& B, Dims d, const float* x) {
    float e = 0.f;
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      e += energy_at(B.c, d, x, i);
    }
    return e;
  }

  // dx += (4 + m2 + 12 lam x^2) dg - (right + left + down + up of dg)
  template <class C>
  __device__ static void grad_vjp(const Block& B, Dims d, const float* x,
                                  const float* dg, float* dx) {
    const int L = static_cast<int>(B.c[2]);
    const float m2 = B.c[0], lam12 = 12.f * B.c[1];
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      int r, l, dn, up;
      nbrs(L, d.D, i, r, l, dn, up);
      dx[i] += (4.f + m2 + lam12 * x[i] * x[i]) * dg[i] -
               (dg[r] + dg[l] + dg[dn] + dg[up]);
    }
  }
};

// Calls f(En{}) with the spec of `kind`; cudaErrorInvalidValue for an unknown
// kind or constants that do not fit it.
template <class F>
inline int with_energy(Dims d, int kind, F&& f) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case Gauss::kKind:
      return Gauss::fits(d) ? f(Gauss{}) : bad;
    case RoughWell::kKind:
      return RoughWell::fits(d) ? f(RoughWell{}) : bad;
    case Gmm::kKind:
      return Gmm::fits(d) ? f(Gmm{}) : bad;
    case Funnel::kKind:
      return Funnel::fits(d) ? f(Funnel{}) : bad;
    case Phi4::kKind:
      return Phi4::fits(d) ? f(Phi4{}) : bad;
    default:
      return bad;
  }
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
