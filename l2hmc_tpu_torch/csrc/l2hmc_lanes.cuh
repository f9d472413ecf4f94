// Lane groups: L lanes of a warp run one chain together, spread over the
// S/T/Q nets' hidden units and head outputs (the trajectory kernel,
// trajectory.cu, its backward kernel, trajectory_bwd.cu, and the chain
// kernel, chain.cu).
//
// Lane l of a group owns the hidden units j = l, l + L, ..., j < H (first
// layer) and k = l, l + L, ..., k < H2 (second layer), and the head outputs
// o = l, l + L, ... of the 3 D outputs (S, T, Q of each latent i, o = head
// D + i). It computes its own units' activations and its own outputs'
// pre-activations; a sum over the units of a layer gathers the group's
// values one by one with __shfl_sync and adds them in index order, so every
// sum, and with it every ReLU gate, is taken in the same order whatever L
// (the plain version is _apply_stq in ops/fused_dynamics.py). The owners
// broadcast the heads' outputs, so the D-wide state and its cotangents are
// replicated in every lane of the group. The VJP reuses the pre-activations
// of the substep's recompute (StqSave) instead of computing them again. In
// the VJP each lane accumulates, across all substeps, the chain's
// cotangents of its own slices of the weights in registers: w1 and w2
// columns j, wh rows j, bh and rows k of ws, wt and wq, and the biases (and
// log-scales) of its own head outputs. te's cotangent is the one exception:
// a substep touches only its own step's column, each step is visited once,
// so each lane writes its column once at the end of the substep.
//
// Operands. The forward functions (lane_hidden, lane_stq, lane_traj_step)
// take the products' operand type TW: float, or __nv_bfloat16 for the
// bfloat16 instantiations of the trajectory and chain kernels
// (trajectory_bf16.cu, chain_bf16.cu; the JAX kernels' cd). Their weights
// arrive rounded to bfloat16 in the float32 block (KernelInputs.block), and
// each activation is rounded where it becomes a product's operand (rnd<TW>,
// operand.cuh): the inputs a, b as the first layer reads them, the hidden
// units h and h2 as they are written; the sums, the biases, te and every
// elementwise step stay float32. The VJP (trajectory_bwd.cu) is float32
// only, as the JAX package's backward kernel is.
#pragma once
#include <type_traits>

#include "l2hmc_common.cuh"
#include "operand.cuh"

namespace l2hmc {

constexpr int kLaneThreads = 128;  // threads per block of the lane kernels: 128 / L chains

// One instantiation: D up to DM, L lanes a chain, U hidden units a lane
// (H, H2 <= L U); UNR = 1 unrolls every loop over D and over the units (the
// arrays stay in registers), 0 leaves them rolled (local memory). EH > 0
// fixes the widths at compile time, D = DM and H = H2 = EH: every loop
// then has a known trip count and every index a known offset, where widths
// known only at run time leave each unrolled loop an exit test and each
// shuffle a reconvergence point.
template <int DM_, int L_, int U_, int UNR_, int EH_ = 0>
struct LaneCfg {
  static const int DM = DM_;
  static const int L = L_;
  static const int U = U_;
  static const int HM = L_ * U_;
  static const int OS = (3 * DM_ + L_ - 1) / L_;  // head outputs a lane owns
  static const int UD = UNR_ ? DM_ : 1;
  static const int UH = UNR_ ? L_ * U_ : 1;
  static const int EH = EH_;
};
typedef LaneCfg<2, 16, 1, 1, 10> ScgLanes;  // SCG: D = 2, H = H2 = 10
typedef LaneCfg<64, 32, 2, 0> WideLanes;    // any D, H, H2 <= 64

// The widest state and hidden widths of the chain kernel's site-parallel
// configuration (l2hmc_sites.cuh): the 64 x 64 phi^4 lattice, and the
// suite's ill-conditioned Gaussian at hidden 100.
constexpr int kSiteMaxDim = 4096;
constexpr int kSiteMaxHidden = 128;

// Which configuration serves these widths: 1 = ScgLanes, 2 = WideLanes,
// 3 = the chain kernel's site-parallel configuration (a state or a hidden
// width past WideLanes'; the trajectory kernels take none there), 0 = none.
inline int pick_lanes(Dims d) {
  if (d.D == ScgLanes::DM && d.H == ScgLanes::EH && d.H2 == ScgLanes::EH)
    return 1;
  if (d.D <= WideLanes::DM && d.H <= WideLanes::HM && d.H2 <= WideLanes::HM)
    return 2;
  if (d.D <= kSiteMaxDim && d.H <= kSiteMaxHidden && d.H2 <= kSiteMaxHidden)
    return 3;
  return 0;
}

// Calls f(C{}, En{}) with the lane configuration that serves d (Scg where
// pick_lanes gives 1, WideLanes where it gives 2) and the energy spec of
// `kind`: every spec is instantiated on both configurations, except Phi4 on
// the SCG widths (D = 2 is no square lattice; Phi4::fits refuses it).
// Returns cudaErrorInvalidValue where no lane configuration serves them.
template <class Scg, class F>
inline int dispatch(Dims d, int kind, F&& f) {
  switch (pick_lanes(d)) {
    case 1:
      return with_energy(d, kind, [&](auto e) {
        if constexpr (std::is_same_v<decltype(e), Phi4>)
          return static_cast<int>(cudaErrorInvalidValue);
        else
          return f(Scg{}, e);
      });
    case 2:
      return with_energy(d, kind, [&](auto e) { return f(WideLanes{}, e); });
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The widths as the instantiation sees them: compile-time constants where
// it fixes them.
template <class C>
__device__ __forceinline__ Dims lane_dims(Dims d) {
  if (C::EH > 0) {
    d.D = C::DM;
    d.H = C::EH;
    d.H2 = C::EH;
  }
  return d;
}

// This thread's lane in its group. Every lane of a warp runs to the end (a
// group past the last chain works on a copy of it and writes nothing), so
// the shuffles take the whole warp. That needs the groups of a warp to take
// the same branches: the trajectory kernels give every chain of a launch
// one direction, and the chain kernel, whose chains each draw their own,
// runs one chain a warp (L = 32).
template <class C>
__device__ __forceinline__ int lane_of() {
  return (threadIdx.x & 31) % C::L;
}

// Element j of the group's values, held by lane j % L in its slot j / L,
// in every lane of the group. Every lane of the group calls it with the
// same j.
template <class C, int S>
__device__ inline float gather(int lane, const float (&a)[S], int j) {
  float v = a[0];
#pragma unroll
  for (int u = 1; u < S; ++u)
    if (j / C::L == u) v = a[u];
  return __shfl_sync(0xffffffffu, v, j % C::L, C::L);
}

// The S/T/Q net's two hidden layers on this lane's units: h[u] of unit
// lane + u L of the first, h2[u] of the second (0 past H, H2), each as the
// next product reads it (rounded to TW). A lane past the last unit runs the
// last unit's arithmetic and drops it, so the group runs one instruction
// stream, without branches.
template <class C, class TW = float>
__device__ inline void lane_hidden(const Net& w, Dims d, int step,
                                   const float* a, const float* b,
                                   int lane, float (&h)[C::U],
                                   float (&h2)[C::U]) {
#pragma unroll
  for (int u = 0; u < C::U; ++u) {
    const int j = lane + u * C::L, jj = min(j, d.H - 1);
    float acc = 0.f;
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      acc = fmaf(w.w1[i * d.H + jj], rnd<TW>(a[i]), acc);
    }
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      acc = fmaf(w.w2[i * d.H + jj], rnd<TW>(b[i]), acc);
    }
    h[u] = j < d.H ? rnd<TW>(fmaxf(acc + w.te[jj * d.T + step], 0.f)) : 0.f;
  }
  float acc2[C::U];
#pragma unroll
  for (int u = 0; u < C::U; ++u) acc2[u] = 0.f;
#pragma unroll (C::UH)
  for (int j = 0; j < C::HM; ++j) {
    if (j >= d.H) break;
    const float hj = gather<C, C::U>(lane, h, j);
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      const int kk = min(lane + u * C::L, d.H2 - 1);
      acc2[u] = fmaf(w.wh[j * d.H2 + kk], hj, acc2[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < C::U; ++u) {
    const int k = lane + u * C::L, kk = min(k, d.H2 - 1);
    h2[u] = k < d.H2 ? rnd<TW>(fmaxf(acc2[u] + w.bh[kk], 0.f)) : 0.f;
  }
}

// What a net application keeps for its VJP: this lane's hidden units and
// its head outputs' pre-activations (without their biases).
template <class C>
struct StqSave {
  float h[C::U], h2[C::U], pre[C::OS];
};

// This lane's head outputs o = head D + i (a lane past the last output
// takes the last): head and i of each slot.
template <class C>
struct Owned {
  int head[C::OS], i[C::OS];
  bool own[C::OS];
};

template <class C>
__device__ inline Owned<C> owned(Dims d, int lane) {
  Owned<C> ow;
#pragma unroll
  for (int u = 0; u < C::OS; ++u) {
    const int o = lane + u * C::L, oo = min(o, 3 * d.D - 1);
    ow.head[u] = oo / d.D;
    ow.i[u] = oo - ow.head[u] * d.D;
    ow.own[u] = o < 3 * d.D;
  }
  return ow;
}

// A head's weight column base (stride D), bias and log-scale (S and Q).
__device__ inline const float* head_w(const Net& w, int head) {
  return head == 0 ? w.ws : head == 1 ? w.wt : w.wq;
}
__device__ inline const float* head_b(const Net& w, int head) {
  return head == 0 ? w.bs : head == 1 ? w.bt : w.bq;
}
__device__ inline float head_ls(const Net& w, int head, int i) {
  return head == 0 ? w.ls[i] : w.lq[i];
}

// The S/T/Q net on a lane group (plain version: _apply_stq in
// ops/fused_dynamics.py), each sum over units in index order; s, t, q in
// every lane, what the VJP needs in sv. Zero nets in HMC mode. TW: the
// products' operands (lane_hidden).
template <class C, class TW = float>
__device__ inline void lane_stq(bool hmc, const Net& w, Dims d, int step,
                                const float* a, const float* b, float* s,
                                float* t, float* q, StqSave<C>& sv,
                                int lane) {
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
  lane_hidden<C, TW>(w, d, step, a, b, lane, sv.h, sv.h2);
  const Owned<C> ow = owned<C>(d, lane);
  const float* col[C::OS];
#pragma unroll
  for (int u = 0; u < C::OS; ++u) {
    sv.pre[u] = 0.f;
    col[u] = head_w(w, ow.head[u]) + ow.i[u];
  }
#pragma unroll (C::UH)
  for (int k = 0; k < C::HM; ++k) {
    if (k >= d.H2) break;
    const float hk = gather<C, C::U>(lane, sv.h2, k);
#pragma unroll
    for (int u = 0; u < C::OS; ++u)
      sv.pre[u] = fmaf(col[u][k * d.D], hk, sv.pre[u]);
  }
  float out[C::OS];
#pragma unroll
  for (int u = 0; u < C::OS; ++u) {
    const int head = ow.head[u], i = ow.i[u];
    const float z = sv.pre[u] + head_b(w, head)[i];
    const float sc = expf(head_ls(w, head, i)) * tanhf(z);
    out[u] = head == 1 ? z : sc;
  }
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    s[i] = gather<C, C::OS>(lane, out, i);
    t[i] = gather<C, C::OS>(lane, out, d.D + i);
    q[i] = gather<C, C::OS>(lane, out, 2 * d.D + i);
  }
}

// One augmented leapfrog substep in place on (x, v) on a lane group, with
// _trajectory_step's expressions (ops/fused_dynamics.py) and the energy
// spec En's gradient, the nets' products on TW operands; returns the logdet
// increment, the same in every lane.
template <class C, class En, class TW = float>
__device__ inline float lane_traj_step(const Block& B, Dims d, bool hmc,
                                       bool reverse, int step, float* x,
                                       float* v, int lane) {
  float m[C::DM], g[C::DM], s[C::DM], t[C::DM], q[C::DM], vh[C::DM],
      y[C::DM], in[C::DM];
  StqSave<C> sv;  // unused here
  float ld = 0.f;
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    m[i] = B.masks[i * d.T + step];
  }
  if (!reverse) {
    En::template grad<C>(B, d, x, g);
    lane_stq<C, TW>(hmc, B.vnet, d, step, x, g, s, t, q, sv, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      const float sv1 = 0.5f * e * s[i];
      vh[i] = v[i] * expf(sv1) + 0.5f * e * (-expf(e * q[i]) * g[i] + t[i]);
      ld += sv1;
      in[i] = m[i] * x[i];
    }
    lane_stq<C, TW>(hmc, B.xnet, d, step, vh, in, s, t, q, sv, lane);
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
    lane_stq<C, TW>(hmc, B.xnet, d, step, vh, in, s, t, q, sv, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float sx2 = e * s[i];
      x[i] = mb * y[i] +
             m[i] * (y[i] * expf(sx2) + e * (expf(e * q[i]) * vh[i] + t[i]));
      ld += m[i] * sx2;
    }
    En::template grad<C>(B, d, x, g);
    lane_stq<C, TW>(hmc, B.vnet, d, step, x, g, s, t, q, sv, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      const float sv2 = 0.5f * e * s[i];
      v[i] = vh[i] * expf(sv2) + 0.5f * e * (-expf(e * q[i]) * g[i] + t[i]);
      ld += sv2;
    }
  } else {
    En::template grad<C>(B, d, x, g);
    lane_stq<C, TW>(hmc, B.vnet, d, step, x, g, s, t, q, sv, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      const float sv2 = -0.5f * e * s[i];
      vh[i] = (v[i] - 0.5f * e * (-expf(e * q[i]) * g[i] + t[i])) * expf(sv2);
      ld += sv2;
      in[i] = (1.f - m[i]) * x[i];
    }
    lane_stq<C, TW>(hmc, B.xnet, d, step, vh, in, s, t, q, sv, lane);
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
    lane_stq<C, TW>(hmc, B.xnet, d, step, vh, in, s, t, q, sv, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      const float sx1 = -e * s[i];
      x[i] = m[i] * y[i] +
             mb * expf(sx1) * (y[i] - e * (expf(e * q[i]) * vh[i] + t[i]));
      ld += mb * sx1;
    }
    En::template grad<C>(B, d, x, g);
    lane_stq<C, TW>(hmc, B.vnet, d, step, x, g, s, t, q, sv, lane);
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

// -- vector-Jacobian products -------------------------------------------------
//
// Counterpart of the hand-derived plain version, _stq_vjp / _step_vjp in
// l2hmc_tpu_torch/ops/fused_dynamics.py.

// One net's cotangent rows in a chain's row of the (N, P) gradient scratch
// (the order of net_at): row of element k is off + k.
struct NetRows {
  int w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te;
};

__host__ __device__ inline NetRows net_rows(int off, Dims d) {
  NetRows r;
  int o = off;
  r.w1 = o; o += d.D * d.H;
  r.w2 = o; o += d.D * d.H;
  r.wh = o; o += d.H * d.H2;
  r.bh = o; o += d.H2;
  r.ws = o; o += d.H2 * d.D;
  r.bs = o; o += d.D;
  r.ls = o; o += d.D;
  r.wt = o; o += d.H2 * d.D;
  r.bt = o; o += d.D;
  r.wq = o; o += d.H2 * d.D;
  r.bq = o; o += d.D;
  r.lq = o; o += d.D;
  r.te = o;
  return r;
}

// A lane's share of one net's cotangents for one chain: the columns of w1
// and w2 and the rows of wh of its first-layer units, bh and the rows of
// ws, wt and wq of its second-layer units, the bias (hb) and log-scale (hl,
// S and Q only) of its own head outputs, and te's column of the current
// substep's step.
template <class C>
struct NetAcc {
  float w1[C::U][C::DM], w2[C::U][C::DM], wh[C::U][C::HM];
  float bh[C::U], ws[C::U][C::DM], wt[C::U][C::DM], wq[C::U][C::DM];
  float hb[C::OS], hl[C::OS];
  float te[C::U];

  __device__ void zero() {
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      bh[u] = 0.f;
      te[u] = 0.f;
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        w1[u][i] = 0.f;
        w2[u][i] = 0.f;
        ws[u][i] = 0.f;
        wt[u][i] = 0.f;
        wq[u][i] = 0.f;
      }
#pragma unroll (C::UH)
      for (int k = 0; k < C::HM; ++k) wh[u][k] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < C::OS; ++u) {
      hb[u] = 0.f;
      hl[u] = 0.f;
    }
  }
};

// VJP of lane_stq at inputs (a, b) for output cotangents (ds, dt, dq),
// from the application's saved hidden units and pre-activations sv: adds
// the chain's weight cotangents to this lane's share and writes (da, db) in
// every lane, each sum over units in index order (plain version: _stq_vjp
// in ops/fused_dynamics.py). relu'(0) = 0. Zero in HMC mode.
template <class C>
__device__ inline void lane_stq_vjp(bool hmc, const Net& w, NetAcc<C>& gw,
                                    Dims d, int step, const float* a,
                                    const float* b, const StqSave<C>& sv,
                                    const float* ds, const float* dt,
                                    const float* dq, float* da, float* db,
                                    int lane) {
  if (hmc) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      da[i] = 0.f;
      db[i] = 0.f;
    }
    return;
  }
  // heads: S = exp(ls) tanh(us), T = ut, Q = exp(lq) tanh(uq); each owner
  // takes its output's cotangent through the head, the group shares them
  const Owned<C> ow = owned<C>(d, lane);
  float du[C::OS];
#pragma unroll
  for (int u = 0; u < C::OS; ++u) {
    const int head = ow.head[u], i = ow.i[u];
    const float th = tanhf(sv.pre[u] + head_b(w, head)[i]);
    const float de = (head == 0 ? ds[i] : dq[i]) * expf(head_ls(w, head, i));
    du[u] = head == 1 ? dt[i] : de * (1.f - th * th);
    if (ow.own[u]) {
      if (head != 1) gw.hl[u] += de * th;
      gw.hb[u] += du[u];
    }
  }
  float dz[C::U];
#pragma unroll
  for (int u = 0; u < C::U; ++u) dz[u] = 0.f;
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    const float dus = gather<C, C::OS>(lane, du, i);
    const float dti = gather<C, C::OS>(lane, du, d.D + i);
    const float duq = gather<C, C::OS>(lane, du, 2 * d.D + i);
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      const int k = lane + u * C::L;
      if (k < d.H2) {
        const int r = k * d.D + i;
        gw.ws[u][i] += sv.h2[u] * dus;
        gw.wt[u][i] += sv.h2[u] * dti;
        gw.wq[u][i] += sv.h2[u] * duq;
        dz[u] = fmaf(w.ws[r], dus, fmaf(w.wt[r], dti, fmaf(w.wq[r], duq, dz[u])));
      }
    }
  }
  // hidden: dz2 = dh2 * [h2 > 0]
#pragma unroll
  for (int u = 0; u < C::U; ++u) {
    const int k = lane + u * C::L;
    dz[u] = (k < d.H2 && sv.h2[u] > 0.f) ? dz[u] : 0.f;
    gw.bh[u] += dz[u];
  }
  float acc[C::U];
#pragma unroll
  for (int u = 0; u < C::U; ++u) acc[u] = 0.f;
#pragma unroll (C::UH)
  for (int k = 0; k < C::HM; ++k) {
    if (k >= d.H2) break;
    const float dk = gather<C, C::U>(lane, dz, k);
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      const int j = lane + u * C::L;
      if (j < d.H) {
        acc[u] = fmaf(w.wh[j * d.H2 + k], dk, acc[u]);
        gw.wh[u][k] += sv.h[u] * dk;
      }
    }
  }
  float dz1[C::U];
#pragma unroll
  for (int u = 0; u < C::U; ++u) {
    dz1[u] = sv.h[u] > 0.f ? acc[u] : 0.f;  // h is 0 past H
    gw.te[u] += dz1[u];
  }
  // embeds
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    da[i] = 0.f;
    db[i] = 0.f;
  }
#pragma unroll (C::UH)
  for (int j = 0; j < C::HM; ++j) {
    if (j >= d.H) break;
    const float dj = gather<C, C::U>(lane, dz1, j);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      da[i] = fmaf(w.w1[i * d.H + j], dj, da[i]);
      db[i] = fmaf(w.w2[i * d.H + j], dj, db[i]);
    }
  }
#pragma unroll
  for (int u = 0; u < C::U; ++u) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      gw.w1[u][i] += a[i] * dz1[u];
      gw.w2[u][i] += b[i] * dz1[u];
    }
  }
}

// Writes te's column `step` of this lane's first-layer units into the
// chain's gradient row g and clears it for the next substep.
template <class C>
__device__ inline void flush_te(NetAcc<C>& a, const NetRows& r, float* g,
                                Dims d, int step, int lane) {
#pragma unroll
  for (int u = 0; u < C::U; ++u) {
    const int j = lane + u * C::L;
    if (j < d.H) g[r.te + j * d.T + step] = a.te[u];
    a.te[u] = 0.f;
  }
}

// Writes this lane's share of one net's cotangents into the chain's
// gradient row g, once, at the end (te is written per substep).
template <class C>
__device__ inline void store_net(const NetAcc<C>& a, const NetRows& r,
                                 float* g, Dims d, int lane) {
#pragma unroll
  for (int u = 0; u < C::U; ++u) {
    const int j = lane + u * C::L;
    if (j < d.H) {
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        g[r.w1 + i * d.H + j] = a.w1[u][i];
        g[r.w2 + i * d.H + j] = a.w2[u][i];
      }
#pragma unroll (C::UH)
      for (int k = 0; k < C::HM; ++k) {
        if (k >= d.H2) break;
        g[r.wh + j * d.H2 + k] = a.wh[u][k];
      }
    }
    if (j < d.H2) {  // j as a second-layer unit
      g[r.bh + j] = a.bh[u];
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        g[r.ws + j * d.D + i] = a.ws[u][i];
        g[r.wt + j * d.D + i] = a.wt[u][i];
        g[r.wq + j * d.D + i] = a.wq[u][i];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < C::OS; ++u) {
    const int o = lane + u * C::L;
    if (o < 3 * d.D) {
      const int head = o / d.D, i = o - head * d.D;
      if (head == 0) {
        g[r.bs + i] = a.hb[u];
        g[r.ls + i] = a.hl[u];
      } else if (head == 1) {
        g[r.bt + i] = a.hb[u];
      } else {
        g[r.bq + i] = a.hb[u];
        g[r.lq + i] = a.hl[u];
      }
    }
  }
}

// VJP of lane_traj_step at the substep's input (x, v), on a lane group. On
// entry dx, dv hold the cotangents of the substep's output (x', v') and dld
// that of its logdet increment; on return they hold the cotangents of
// (x, v), in every lane. The chain's eps cotangent is added to de, the
// weight cotangents to this lane's shares gx (xnet) and gv (vnet). The
// substep is recomputed first with lane_traj_step's expressions; the
// backward formulas are those of _step_vjp. En's gradient VJP is taken at
// the point of each gradient: the substep's output xo and its input x.
template <class C, class En>
__device__ inline void lane_traj_step_vjp(const Block& B, NetAcc<C>& gx,
                                          NetAcc<C>& gv, Dims d, bool hmc,
                                          bool reverse, int step,
                                          const float* x, const float* v,
                                          float* dx, float* dv, float dld,
                                          float* de, int lane) {
  float m[C::DM], g1[C::DM], s1[C::DM], t1[C::DM], q1[C::DM], vh[C::DM],
      in2[C::DM], s2[C::DM], t2[C::DM], q2[C::DM], y[C::DM], in3[C::DM],
      s3[C::DM], t3[C::DM], q3[C::DM], xo[C::DM], g2[C::DM], s4[C::DM],
      t4[C::DM], q4[C::DM];
  float dxo[C::DM], dvo[C::DM], dvh[C::DM], dy[C::DM], ds[C::DM], dt[C::DM],
      dq[C::DM], dg[C::DM], da[C::DM], db[C::DM];
  StqSave<C> sv1, sv2, sv3, sv4;  // the four applications' recompute
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    m[i] = B.masks[i * d.T + step];
    dxo[i] = dx[i];
    dvo[i] = dv[i];
  }
  if (!reverse) {
    // recompute (lane_traj_step, forward branch)
    En::template grad<C>(B, d, x, g1);
    lane_stq<C>(hmc, B.vnet, d, step, x, g1, s1, t1, q1, sv1, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      vh[i] = v[i] * expf(0.5f * e * s1[i]) +
              0.5f * e * (-expf(e * q1[i]) * g1[i] + t1[i]);
      in2[i] = m[i] * x[i];
    }
    lane_stq<C>(hmc, B.xnet, d, step, vh, in2, s2, t2, q2, sv2, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      y[i] = m[i] * x[i] +
             mb * (x[i] * expf(e * s2[i]) + e * (expf(e * q2[i]) * vh[i] + t2[i]));
      in3[i] = mb * y[i];
    }
    lane_stq<C>(hmc, B.xnet, d, step, vh, in3, s3, t3, q3, sv3, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      xo[i] = mb * y[i] +
              m[i] * (y[i] * expf(e * s3[i]) + e * (expf(e * q3[i]) * vh[i] + t3[i]));
    }
    En::template grad<C>(B, d, xo, g2);
    lane_stq<C>(hmc, B.vnet, d, step, xo, g2, s4, t4, q4, sv4, lane);

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
    lane_stq_vjp<C>(hmc, B.vnet, gv, d, step, xo, g2, sv4, ds, dt, dq,
                    da, db, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dxo[i] += da[i];
      dg[i] += db[i];
    }
    En::template grad_vjp<C>(B, d, xo, dg, dxo);
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
    lane_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in3, sv3, ds, dt, dq,
                    da, db, lane);
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
    lane_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in2, sv2, ds, dt, dq,
                    da, db, lane);
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
    lane_stq_vjp<C>(hmc, B.vnet, gv, d, step, x, g1, sv1, ds, dt, dq,
                    da, db, lane);
  } else {
    // recompute (lane_traj_step, reverse branch)
    En::template grad<C>(B, d, x, g1);
    lane_stq<C>(hmc, B.vnet, d, step, x, g1, s1, t1, q1, sv1, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i];
      vh[i] = (v[i] - 0.5f * e * (-expf(e * q1[i]) * g1[i] + t1[i])) *
              expf(-0.5f * e * s1[i]);
      in2[i] = (1.f - m[i]) * x[i];
    }
    lane_stq<C>(hmc, B.xnet, d, step, vh, in2, s2, t2, q2, sv2, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      y[i] = mb * x[i] + m[i] * expf(-e * s2[i]) *
                             (x[i] - e * (expf(e * q2[i]) * vh[i] + t2[i]));
      in3[i] = m[i] * y[i];
    }
    lane_stq<C>(hmc, B.xnet, d, step, vh, in3, s3, t3, q3, sv3, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      const float e = B.eps[i], mb = 1.f - m[i];
      xo[i] = m[i] * y[i] + mb * expf(-e * s3[i]) *
                                (y[i] - e * (expf(e * q3[i]) * vh[i] + t3[i]));
    }
    En::template grad<C>(B, d, xo, g2);
    lane_stq<C>(hmc, B.vnet, d, step, xo, g2, s4, t4, q4, sv4, lane);

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
    lane_stq_vjp<C>(hmc, B.vnet, gv, d, step, xo, g2, sv4, ds, dt, dq,
                    da, db, lane);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dxo[i] += da[i];
      dg[i] += db[i];
    }
    En::template grad_vjp<C>(B, d, xo, dg, dxo);
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
    lane_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in3, sv3, ds, dt, dq,
                    da, db, lane);
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
    lane_stq_vjp<C>(hmc, B.xnet, gx, d, step, vh, in2, sv2, ds, dt, dq,
                    da, db, lane);
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
    lane_stq_vjp<C>(hmc, B.vnet, gv, d, step, x, g1, sv1, ds, dt, dq,
                    da, db, lane);
  }
  // x, g1 -> the vnet's first application and the first energy gradient
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dxo[i] += da[i];
    dg[i] += db[i];
  }
  En::template grad_vjp<C>(B, d, x, dg, dxo);
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dx[i] = dxo[i];
  }
}

}  // namespace l2hmc
