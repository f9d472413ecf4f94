// The site-parallel configuration of the L2HMC kernels, for states or S/T/Q
// nets wider than a lane group holds: D <= kSiteMaxDim (4096, the 64 x 64
// phi^4 lattice) and hidden widths H, H2 <= kSiteMaxHidden (128, the suite's
// ill-conditioned Gaussian at hidden 100), past WideLanes' D, H, H2 <= 64,
// for every energy spec (Gauss, RoughWell, Gmm, Funnel, Phi4). The chain
// kernel (chain.cu) runs the phi^4 lattice here at every width
// (site_chain); the trajectory kernel (trajectory.cu) and its backward
// kernel (trajectory_bwd.cu) run here past 64. All three run the same
// substep (site_traj_step, below).
//
// Replaces, with chain.cu, the Pallas kernel _make_chain_kernel /
// FusedChainSampler (l2hmc_tpu/ops/fused_dynamics.py:1103, pallas_call at
// :1350) at the phi^4 eval's widths (D = 256, 1024 and 4096) and at hidden
// widths past 64, on every spec (RoughWellEnergy :422, GmmEnergy :446,
// FunnelEnergy :501 and the rest); with trajectory.cu and trajectory_bwd.cu,
// _make_kernel / FusedDynamics (:645, pallas_call at :718) and _make_bwd_kernel /
// DifferentiableFusedDynamics (:801, pallas_call at :1024) at the same
// widths, whose (D, tile) blocks in VMEM take any width. At dim >= 2048 the
// JAX sampler builds the chain kernel with
// loop_traj (fused_chain_sampler :1391), the trajectory as a fori_loop over
// T (_trajectory :212-249) instead of T unrolled copies, which overflowed
// the TPU's scoped VMEM. This configuration is its counterpart: its
// trajectory loop runs T at run time at every width, so no switch is needed.
//
// Why not the lane groups. They replicate the D-wide state and its
// trajectory's temporaries in every lane (WideLanes already spills its
// D = 64 arrays to local memory), and stage the whole parameter block in
// shared memory: two dense S/T/Q nets at D = 256, H = 32 are ~342 KB, at
// D = 4096, H = 64 ~10.6 MB, past the 227 KB a block may use.
//
// Design. A block of kSiteThreads threads runs a tile of kSiteChains (4)
// chains for all K MH steps (a trajectory kernel: for its T substeps). The
// proposal x', the momentum and the
// gradient (or net input) of each chain lie in shared memory, and the
// threads stride over its sites: the stencil reads its neighbours there.
// The weights are read from global memory through the L2 (and L1) at every
// use: the block is not staged. A net application is
//   - the first layer, a fixed-order block reduction over the D sites:
//     lanes over the hidden units (j = lane + 32 u, u < HM / 32), warps over
//     the sites (i = warp, warp + 8, ...); each lane sums its sites in index
//     order, for the tile's chains at once (one weight load serves them
//     all), then one thread a (chain, unit) sums the warps' partials in warp
//     order and adds the time column of its chain's step;
//   - the second layer, one thread a (chain, unit);
//   - the heads: each thread forms S, T, Q of its own sites from the H2
//     activations in shared memory, for the tile's chains at once, and
//     applies the substep's update to them there (so S, T, Q are never
//     stored).
// HM, the hidden units the buffers hold, is a template parameter: 64 (two
// first-layer units a lane) or 128 (four). So is TW, the products' operand
// type (float, or __nv_bfloat16 in chain_bf16.cu): the weights arrive
// rounded in the block, the first layer rounds its inputs as it reads them
// and the hidden layers are stored rounded (rnd<TW>, as in
// l2hmc_lanes.cuh); the sums and everything else stay float32.
//
// The widest tile. Four arrays of 4 chains at D = 4096 are 256 KB, past
// shared memory. One chain a block would fit, but a weight load would then
// serve one chain, and the L2 weight reads already set this kernel's time
// (at D = 256 and 1024 it runs 20-35x its bound, latency-bound on them), so
// a tile keeps 4 chains. Of the two shapes that keep it, a cluster of two
// blocks a tile (half the sites each, the first layer's sums and the
// stencil's rows at the split exchanged through distributed shared memory)
// or one block a tile with some arrays in global memory, this is the
// second, with the array that the trajectory never reads moved out: the
// accepted state x is read at an MH step's start (copied into x') and
// written at its end (the accept), never inside the trajectory, so it lies
// in a global scratch the wrapper allocates ((blocks x C, D) floats, 16 KB a
// chain, L2-resident: 4 MB at 256 chains of D = 4096). x', v and g stay in
// shared memory, so every substep runs out of it as at D <= 1024: 192 KB
// at D = 4096, 212.4 KB with the buffers of hidden 128, within the 227 KB a
// block may use. The cluster form would halve each block's weight reads and
// fill twice the SMs at 256 chains, at the cost of a cluster barrier in
// every first layer and every gradient; it is later work, with TMA-staged
// or bf16 wgmma weights over a chain tile. The trajectory kernel has no
// accepted state: its x', v and g are the same three arrays.
//
// The energy, the kinetic energy and the log-det are per-thread partial
// sums, reduced by a warp tree (lane 0's order) and then over warps in
// order: no atomics, and a launch repeats bit for bit. These sums cannot
// equal the plain version's torch.sum bit for bit; the comparisons state
// their tolerance.
//
// The energy specs. A site of Gauss, RoughWell or Phi4 needs only the
// chain's state in shared memory (Gauss a row of P, Phi4 its neighbours).
// Funnel's and Gmm's need per-chain sums first (the neck's sum of squares;
// each component's quadratic form, from which the mixture's weights): their
// prelude (site_prelude) takes those sums over the sites by the same fixed-
// order block sums, once before each gradient, each Hamiltonian and each
// gradient VJP, and leaves (C, P) scalars in shared memory (P =
// site_pre_floats: 2 for Funnel, 2K + 2 for a K-component Gmm) that every
// site reads. Their energy is then a chain's, not a sum over sites: the
// mixture's -logsumexp is not one.
//
// A substep's four applications run vnet, xnet, xnet, vnet in both
// directions; only the masks' roles, the update formulas and the step
// index differ, so the chains of a tile, each with its own direction, run
// the same sequence of phases and branch only inside a chain's update.
//
// Random numbers as in the lane kernels: Philox4x32-10, counter (global
// chain, MH step, slot, 0), slot 1 + j the normals 2j and 2j + 1 (2048
// slots at D = 4096); direction and accept are selects; the uniform is
// unsigned (philox.cuh). A tile's chains past N run as copies of the last
// chain, on scratch of their own, and write nothing.
//
// Bound on the card: operations, and the weights' bytes from the L2. Per
// MH step a tile reads each net's first-layer and head weights 2 T times
// (~180 KB an application at D = 256, H = 32; ~5.3 MB at D = 4096,
// H = 64); chip_smoke.py reckons those bytes.
#pragma once
#include "l2hmc_lanes.cuh"
#include "philox.cuh"

namespace l2hmc {

constexpr int kSiteChains = 4;     // chains a block
constexpr int kSiteThreads = 256;  // threads a block
constexpr int kSiteWarps = kSiteThreads / 32;

// The hidden units the buffers hold at these widths: 64 where both hidden
// widths fit it, else 128.
inline int site_hm(Dims d) {
  return d.H <= WideLanes::HM && d.H2 <= WideLanes::HM ? WideLanes::HM
                                                       : kSiteMaxHidden;
}

// Floats of the prelude a chain of spec `kind` keeps (site_prelude): 0 for
// a spec without one.
__host__ __device__ inline int site_pre_floats(Dims d, int kind) {
  return kind == Gmm::kKind      ? Gmm::pre_floats(d)
         : kind == Funnel::kKind ? Funnel::pre_floats(d)
                                 : 0;
}

// Floats of dynamic shared memory a block uses at state width D with
// buffers of HM hidden units and P prelude floats a chain: at D = 4096,
// 49,152 for x', v, g and 2,668 (HM = 64) or 5,228 (HM = 128) for the rest,
// 207,280 and 217,520 bytes of the 232,448 a block may use, and 4 C P more.
__host__ __device__ inline int site_smem_floats(int D, int HM, int P) {
  const int C = kSiteChains;
  return 3 * C * D + kSiteWarps * C * HM + 2 * C * HM + kSiteWarps * 3 * C +
         3 * C + C * P;
}

template <int HM>
struct SiteSmem {
  float *xp, *v, *g;  // (C, D) each: proposal, momentum, gradient
  float *red;         // (warps, C, HM): the first layer's partial sums
  float *h, *h2;      // (C, HM): the two hidden layers
  float *sred, *tot;  // (warps, 3C), (3C): the chains' sums
  float *pre;         // (C, P): the spec's prelude
};

// What a prelude uses: block_sums' partials and results (at least (warps,
// 2C) and 2C floats) and the (C, P) prelude.
struct SiteScratch {
  float *sred, *tot, *pre;
};

template <int HM>
__device__ inline SiteScratch scratch_of(const SiteSmem<HM>& s) {
  return SiteScratch{s.sred, s.tot, s.pre};
}

template <int HM>
__device__ inline SiteSmem<HM> site_smem(float* p, int D) {
  const int C = kSiteChains;
  SiteSmem<HM> s;
  s.xp = p;
  s.v = s.xp + C * D;
  s.g = s.v + C * D;
  s.red = s.g + C * D;
  s.h = s.red + kSiteWarps * C * HM;
  s.h2 = s.h + C * HM;
  s.sred = s.h2 + C * HM;
  s.tot = s.sred + kSiteWarps * 3 * C;
  s.pre = s.tot + 3 * C;
  return s;
}

// Block-wide sums of each thread's V values into tot, in a fixed order: a
// warp's lanes by a butterfly (lane 0's result), then the warps in order
// (sred: (warps, V) partials). Every thread calls it; it synchronises.
template <int V>
__device__ inline void block_sums(float (&v)[V], float* sred, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float a = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) sred[warp * V + k] = a;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float t = 0.f;
    for (int w = 0; w < kSiteWarps; ++w) t += sred[w * V + threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
}

// The prelude of spec En for the tile's states x ((C, D)) and, in the VJP,
// the cotangents dg ((C, D), else null): pre_passes block sums of the
// sites' pre_part, each through block_sums, then pre_finish by one thread a
// chain, into sc.pre. Nothing for a spec without one. Every thread calls
// it; it synchronises.
template <class En>
__device__ inline void site_prelude(const Block& B, Dims d, const float* x,
                                    const float* dg, const SiteScratch& sc) {
  if constexpr (En::kPrelude) {
    constexpr int C = kSiteChains;
    const int K = En::pre_passes(d), P = En::pre_floats(d);
    for (int k = 0; k < K; ++k) {
      float part[2 * C];
#pragma unroll
      for (int q = 0; q < 2 * C; ++q) part[q] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* dgc = dg == nullptr ? nullptr : dg + c * d.D;
        for (int i = threadIdx.x; i < d.D; i += kSiteThreads)
          En::pre_part(B.c, d, k, x + c * d.D, dgc, i, part[c], part[C + c]);
      }
      block_sums(part, sc.sred, sc.tot);
      if (threadIdx.x < C) {
        sc.pre[threadIdx.x * P + k] = sc.tot[threadIdx.x];
        if (dg != nullptr) sc.pre[threadIdx.x * P + K + k] = sc.tot[C + threadIdx.x];
      }
    }
    __syncthreads();
    if (threadIdx.x < C)
      En::pre_finish(B.c, d, x + threadIdx.x * d.D, sc.pre + threadIdx.x * P, dg != nullptr);
    __syncthreads();
  }
}

// The state arrays a net application reads and writes ((C, D) each, in
// shared memory): the chain kernel and the trajectory kernel update x', v and
// g in place; the VJP's recompute keeps each substep's intermediates apart.
struct SiteIO {
  const float* x;  // x' as the application reads it
  float* xo;       // where an xnet application's x update goes
  const float* v;  // v, or v_h for an xnet application
  float* vo;       // where a vnet application's v update goes
  const float* g;  // the gradient a vnet application reads
  float* gn;       // where the next xnet application's masked input goes
};

// The two hidden layers of net w at inputs a, b ((C, D) in shared memory)
// for the tile's chains, chain c at its own step: h and h2 ((C, HM) each),
// each layer stored as the next product reads it (rounded to TW); red holds
// the first layer's partial sums.
template <class TW, int HM>
__device__ inline void site_hidden(const Net& w, Dims d, const float* a,
                                   const float* b,
                                   const int (&step)[kSiteChains], float* red,
                                   float* h, float* h2) {
  constexpr int C = kSiteChains, U = HM / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[C][U];
  int jj[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    jj[u] = min(lane + 32 * u, d.H - 1);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c][u] = 0.f;
  }
  for (int i = warp; i < d.D; i += kSiteWarps) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u > 0 && d.H <= 32 * u) break;  // the same in every lane
      const float w1 = w.w1[i * d.H + jj[u]], w2 = w.w2[i * d.H + jj[u]];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c][u] = fmaf(w1, rnd<TW>(a[c * d.D + i]), acc[c][u]);
        acc[c][u] = fmaf(w2, rnd<TW>(b[c * d.D + i]), acc[c][u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lane + 32 * u;
    if (j < d.H) {
#pragma unroll
      for (int c = 0; c < C; ++c) red[(warp * C + c) * HM + j] = acc[c][u];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < C * d.H; p += kSiteThreads) {
    const int c = p / d.H, j = p - c * d.H;
    float t = 0.f;
    for (int wv = 0; wv < kSiteWarps; ++wv) t += red[(wv * C + c) * HM + j];
    h[c * HM + j] = rnd<TW>(fmaxf(t + w.te[j * d.T + step[c]], 0.f));
  }
  __syncthreads();
  for (int p = threadIdx.x; p < C * d.H2; p += kSiteThreads) {
    const int c = p / d.H2, k = p - c * d.H2;
    float t = 0.f;
    for (int j = 0; j < d.H; ++j) t = fmaf(w.wh[j * d.H2 + k], h[c * HM + j], t);
    h2[c * HM + k] = rnd<TW>(fmaxf(t + w.bh[k], 0.f));
  }
  __syncthreads();
}

// The heads of net w at site i for the tile's chains, from the second
// hidden layer h2: S, T, Q and the tanh of S's and Q's pre-activations (the
// VJP's), zero in HMC mode.
template <int HM>
__device__ inline void site_head_values(const Net& w, Dims d, bool hmc, int i,
                                        const float* h2,
                                        float (&sv)[kSiteChains],
                                        float (&tv)[kSiteChains],
                                        float (&qv)[kSiteChains],
                                        float (&ths)[kSiteChains],
                                        float (&thq)[kSiteChains]) {
  constexpr int C = kSiteChains;
  float as[C], at[C], aq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) as[c] = at[c] = aq[c] = 0.f;
  if (!hmc) {
    for (int k = 0; k < d.H2; ++k) {
      const float ws = w.ws[k * d.D + i], wt = w.wt[k * d.D + i],
                  wq = w.wq[k * d.D + i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float hk = h2[c * HM + k];
        as[c] = fmaf(ws, hk, as[c]);
        at[c] = fmaf(wt, hk, at[c]);
        aq[c] = fmaf(wq, hk, aq[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sv[c] = tv[c] = qv[c] = ths[c] = thq[c] = 0.f;
    if (!hmc) {
      ths[c] = tanhf(as[c] + w.bs[i]);
      thq[c] = tanhf(aq[c] + w.bq[i]);
      sv[c] = expf(w.ls[i]) * ths[c];
      tv[c] = at[c] + w.bt[i];
      qv[c] = expf(w.lq[i]) * thq[c];
    }
  }
}

// The heads of net w on this thread's sites, for the tile's chains, and the
// update of application APP of the substep (_trajectory_step's expressions,
// ops/fused_dynamics.py) on the arrays of io:
//   1  vnet at (x', g): vo <- the v half-step;  gn <- the first xnet's input
//   2  xnet at (v, gn): xo <- y;                 gn <- the second xnet's input
//   3  xnet at (v, gn): xo <- the new x
//   4  vnet at (x', g): vo <- the second v half-step
// where the first xnet's input is m x (forward) or (1 - m) x (reverse) and
// the second's the other half of y. The log-det increments go to ld.
template <int APP, int HM>
__device__ inline void site_heads(const Block& B, const Net& w, Dims d,
                                  bool hmc, const bool (&rev)[kSiteChains],
                                  const int (&step)[kSiteChains],
                                  const float* h2, const SiteIO& io,
                                  float (&ld)[kSiteChains]) {
  constexpr int C = kSiteChains;
  for (int i = threadIdx.x; i < d.D; i += kSiteThreads) {
    float sv[C], tv[C], qv[C], ths[C], thq[C];
    site_head_values<HM>(w, d, hmc, i, h2, sv, tv, qv, ths, thq);
    const float e = B.eps[i], h = 0.5f * e;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float m = B.masks[i * d.T + step[c]], mb = 1.f - m;
      const float Q = expf(e * qv[c]);
      const int o = c * d.D + i;
      if (APP == 1 || APP == 4) {
        const float g = io.g[o], vi = io.v[o];
        float vn, inc;
        if (!rev[c]) {
          inc = h * sv[c];
          vn = vi * expf(inc) + h * (-Q * g + tv[c]);
        } else {
          inc = -h * sv[c];
          vn = (vi - h * (-Q * g + tv[c])) * expf(inc);
        }
        ld[c] += inc;
        io.vo[o] = vn;
        if (APP == 1) io.gn[o] = (rev[c] ? mb : m) * io.x[o];
      } else {
        // APP 2 keeps the half kA = m (forward) or 1 - m (reverse) of x and
        // moves the other; APP 3 keeps the other half of y
        const float keep = (APP == 2) == !rev[c] ? m : mb;
        const float move = 1.f - keep;
        const float xi = io.x[o], vh = io.v[o];
        float xn, inc;
        if (!rev[c]) {
          inc = e * sv[c];
          xn = keep * xi + move * (xi * expf(inc) + e * (Q * vh + tv[c]));
        } else {
          inc = -e * sv[c];
          xn = keep * xi + move * expf(inc) * (xi - e * (Q * vh + tv[c]));
        }
        ld[c] += move * inc;
        io.xo[o] = xn;
        if (APP == 2) io.gn[o] = move * xn;
      }
    }
  }
  __syncthreads();
}

// g <- grad E(x) for the tile's chains ((C, D) each), after the prelude.
template <class En>
__device__ inline void site_grad(const Block& B, Dims d, const float* x, float* g,
                                 const SiteScratch& sc) {
  site_prelude<En>(B, d, x, nullptr, sc);
  const int P = site_pre_floats(d, En::kKind);
  for (int c = 0; c < kSiteChains; ++c)
    for (int i = threadIdx.x; i < d.D; i += kSiteThreads)
      g[c * d.D + i] = En::grad_at(B.c, d, x + c * d.D, i, sc.pre + c * P);
  __syncthreads();
}

// dx += J(x)^T dg for the tile's chains ((C, D) each), J the Jacobian of
// grad E, after the prelude at (x, dg).
template <class En>
__device__ inline void site_grad_vjp(const Block& B, Dims d, const float* x, const float* dg,
                                     float* dx, const SiteScratch& sc) {
  site_prelude<En>(B, d, x, dg, sc);
  const int P = site_pre_floats(d, En::kKind);
  for (int c = 0; c < kSiteChains; ++c)
    for (int i = threadIdx.x; i < d.D; i += kSiteThreads)
      dx[c * d.D + i] += En::grad_vjp_at(B.c, d, x + c * d.D, dg + c * d.D, i, sc.pre + c * P);
  __syncthreads();
}

// One augmented leapfrog substep in place on (x', v) in s for the tile's
// chains, each at its own direction and step (the chain kernel's chains
// draw theirs; the trajectory kernels give a launch one). On entry s.g holds
// grad E(x'), on return that of the new x'. A substep's four applications
// run vnet, xnet, xnet, vnet in both directions; the gradient at its end is
// the next substep's first, so it is computed once. ld gets the log-det
// increments of this thread's sites.
template <class En, int HM, class TW>
__device__ inline void site_traj_step(const Block& B, Dims d, bool hmc,
                                      const bool (&rev)[kSiteChains],
                                      const int (&step)[kSiteChains],
                                      const SiteSmem<HM>& s,
                                      float (&ld)[kSiteChains]) {
  const SiteIO io{s.xp, s.xp, s.v, s.v, s.g, s.g};
  if (!hmc) site_hidden<TW, HM>(B.vnet, d, s.xp, s.g, step, s.red, s.h, s.h2);
  site_heads<1, HM>(B, B.vnet, d, hmc, rev, step, s.h2, io, ld);
  if (!hmc) site_hidden<TW, HM>(B.xnet, d, s.v, s.g, step, s.red, s.h, s.h2);
  site_heads<2, HM>(B, B.xnet, d, hmc, rev, step, s.h2, io, ld);
  if (!hmc) site_hidden<TW, HM>(B.xnet, d, s.v, s.g, step, s.red, s.h, s.h2);
  site_heads<3, HM>(B, B.xnet, d, hmc, rev, step, s.h2, io, ld);
  site_grad<En>(B, d, s.xp, s.g, scratch_of(s));
  if (!hmc) site_hidden<TW, HM>(B.vnet, d, s.xp, s.g, step, s.red, s.h, s.h2);
  site_heads<4, HM>(B, B.vnet, d, hmc, rev, step, s.h2, io, ld);
}

// This thread's partial sums of E(x') and of v . v for each chain into
// part[c], part[C + c], and ld into part[2C + c]; a spec with a prelude puts
// each chain's whole energy in thread 0's part. Every thread calls it; it
// synchronises where the spec has a prelude.
template <class En, int HM>
__device__ inline void site_hamiltonian_parts(const Block& B, Dims d,
                                              const SiteSmem<HM>& s,
                                              const float (&ld)[kSiteChains],
                                              float (&part)[3 * kSiteChains]) {
  constexpr int C = kSiteChains;
  site_prelude<En>(B, d, s.xp, nullptr, scratch_of(s));
  const int P = site_pre_floats(d, En::kKind);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float en = 0.f, kin = 0.f;
    for (int i = threadIdx.x; i < d.D; i += kSiteThreads) {
      const float vi = s.v[c * d.D + i];
      if constexpr (!En::kPrelude) en += En::energy_at(B.c, d, s.xp + c * d.D, i);
      kin = fmaf(vi, vi, kin);
    }
    if constexpr (En::kPrelude)
      en = threadIdx.x == 0 ? En::chain_energy(d, s.pre + c * P) : 0.f;
    part[c] = en;
    part[C + c] = kin;
    part[2 * C + c] = ld[c];
  }
}

// xs: the accepted states, (gridDim.x C, D) floats of global scratch.
template <class En, int HM, class TW>
__global__ void __launch_bounds__(kSiteThreads) site_chain_kernel(
    const float* __restrict__ params, Dims d, int hmc,
    const float* __restrict__ xin, float* __restrict__ xo,
    float* __restrict__ acc_out, float* __restrict__ trace,
    float* __restrict__ xs, int N, int K, uint2 key) {
  constexpr int C = kSiteChains;
  extern __shared__ float smem[];
  const Block B = block_at(params, d);
  const SiteSmem<HM> s = site_smem<HM>(smem, d.D);
  float* const x = xs + static_cast<size_t>(blockIdx.x) * C * d.D;  // (C, D)
  const size_t sN = static_cast<size_t>(N);
  int n[C];
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int chain = blockIdx.x * C + c;
    live[c] = chain < N;
    n[c] = live[c] ? chain : N - 1;  // past N: a copy of the last chain
  }
  // device memory holds (D, N): the tile's chains are adjacent there, so
  // the threads take (site, chain) pairs chain-fastest
  for (int p = threadIdx.x; p < C * d.D; p += kSiteThreads) {
    const int c = p % C, i = p / C;
    x[c * d.D + i] = xin[i * sN + n[c]];
  }
  float accepted[C];
#pragma unroll
  for (int c = 0; c < C; ++c) accepted[c] = 0.f;
  __syncthreads();
  const int pairs = (d.D + 1) / 2;

  for (int k = 0; k < K; ++k) {
    bool rev[C];
    float u_acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint4 r0 = philox4x32_10(
          make_uint4(static_cast<uint32_t>(n[c]), static_cast<uint32_t>(k), 0u, 0u),
          key);
      rev[c] = !(uniform24(r0.x) < 0.5f);
      u_acc[c] = uniform24(r0.y);
      float* v = s.v + c * d.D;
      for (int j = threadIdx.x; j < pairs; j += kSiteThreads) {
        const uint4 r = philox4x32_10(
            make_uint4(static_cast<uint32_t>(n[c]), static_cast<uint32_t>(k),
                       static_cast<uint32_t>(1 + j), 0u),
            key);
        v[2 * j] = box_muller(r.x, r.y);
        if (2 * j + 1 < d.D) v[2 * j + 1] = box_muller(r.z, r.w);
      }
      for (int i = threadIdx.x; i < d.D; i += kSiteThreads)
        s.xp[c * d.D + i] = x[c * d.D + i];
    }
    __syncthreads();

    // H(x, v) of each chain, on x' = x
    float part[3 * C], ld[C];
#pragma unroll
    for (int c = 0; c < C; ++c) ld[c] = 0.f;
    site_hamiltonian_parts<En>(B, d, s, ld, part);
    block_sums(part, s.sred, s.tot);
    float h0[C];
#pragma unroll
    for (int c = 0; c < C; ++c) h0[c] = s.tot[c] + 0.5f * s.tot[C + c];

    site_grad<En>(B, d, s.xp, s.g, scratch_of(s));
    for (int t = 0; t < d.T; ++t) {
      int step[C];
#pragma unroll
      for (int c = 0; c < C; ++c) step[c] = rev[c] ? d.T - 1 - t : t;
      site_traj_step<En, HM, TW>(B, d, hmc != 0, rev, step, s, ld);
    }

    // H(x', v') and the log-det, then the accept: the same in every thread
    site_hamiltonian_parts<En>(B, d, s, ld, part);
    block_sums(part, s.sred, s.tot);
    bool acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float h1 = s.tot[c] + 0.5f * s.tot[C + c];
      // exp(min(a, 0)) with NaN kept NaN, then the NaN guard maps it to 0
      const float a = h0[c] - h1 + s.tot[2 * C + c];
      float px = expf(a > 0.f ? 0.f : a);
      if (!isfinite(px)) px = 0.f;
      acc[c] = px - u_acc[c] >= 0.f;
      if (acc[c]) accepted[c] += 1.f;
    }
    for (int p = threadIdx.x; p < C * d.D; p += kSiteThreads) {
      const int c = p % C, i = p / C, o = c * d.D + i;
      if (acc[c]) x[o] = s.xp[o];
      if (trace != nullptr && live[c])
        trace[(static_cast<size_t>(k) * d.D + i) * sN + n[c]] = x[o];
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < C * d.D; p += kSiteThreads) {
    const int c = p % C, i = p / C;
    if (live[c]) xo[i * sN + n[c]] = x[c * d.D + i];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c]) acc_out[n[c]] = accepted[c] * (1.0f / static_cast<float>(K));
  }
}

// -- the trajectory kernels on sites ------------------------------------------
//
// The trajectory kernel (trajectory.cu) past 64 wide runs the chain kernel's
// substep (site_traj_step) on a tile, the whole launch in one direction, in
// the same shared memory; its backward kernel (trajectory_bwd.cu) runs the
// hand-derived VJP of one substep below (site_substep_vjp), the counterpart
// of lane_traj_step_vjp (l2hmc_lanes.cuh) and of the plain _step_vjp
// (ops/fused_dynamics.py).
//
// The VJP's state. The recompute of a substep keeps its intermediates in
// ten (C, D) arrays: x and v (the substep's input, read back from the
// boundary scratch the forward sweep wrote), g1 = grad E(x), v_h, y, x_o (the
// substep's output), g2 = grad E(x_o), and the cotangents dx, dv and dg; and
// the four net applications' hidden layers (C, HM) each in shared memory.
// The arrays lie in shared memory up to D = kSiteVjpSmemDim (1024, the
// 32 x 32 lattice: 160 KB, 196 KB in all at HM = 128). Past it four chains'
// arrays do not fit a block (640 KB at D = 4096), and they lie in a global
// scratch of the block's own, read and written through the L1 and the L2
// by the same phases (every phase is bracketed by barriers, which order a
// block's global accesses as its shared ones); kSiteVjpMaxDim (4096) is the
// chain kernel's cap.
//
// Weight cotangents. Two nets' 13 arrays are ~340 k floats at D = 1024,
// H = H2 = 32: no thread holds its share in registers. Each block owns one
// row of a (blocks, P) scratch in global memory and adds each substep's
// cotangents, summed over the tile's chains in chain order, into it by
// read-modify-write; every element has exactly one owning thread (the
// thread of its site i for the per-site arrays and the heads' weights
// (k, i), lane j of the warp of site i for w1 and w2's (i, j), thread p for
// wh's element p, thread k or j for bh and te), so no atomics are needed and
// the order of every sum is fixed: a launch repeats bit for bit. The rows are
// then summed in row order (sum_chains_kernel). The heads' input
// cotangent (dz2, a sum over the D sites for each hidden unit) is taken per
// thread over its sites, one unit at a time, by a warp butterfly (lane 0's
// result) and then over warps in order; the first layer's input cotangents
// (da, db, sums over H units for each site) by a warp a site, lanes over the
// units, and a butterfly. A tile's chains past N run with zero cotangents,
// so they add exact zeros.

constexpr int kSiteVjpMaxDim = kSiteMaxDim;
constexpr int kSiteVjpSmemDim = 1024;
constexpr int kSiteVjpArrays = 10;

// Whether the backward kernel keeps its (C, D) arrays in shared memory.
__host__ __device__ inline bool site_vjp_arrays_in_smem(int D) {
  return D <= kSiteVjpSmemDim;
}

// Floats of dynamic shared memory the backward kernel's block uses with P
// prelude floats a chain: at D = 1024, 45,568 (HM = 64) or 50,176
// (HM = 128), 182,272 and 200,704 bytes; past it 4,608 or 9,216 floats (the
// buffers alone); and C P more.
__host__ __device__ inline int site_vjp_smem_floats(int D, int HM, int P) {
  const int C = kSiteChains;
  const int arrays = site_vjp_arrays_in_smem(D) ? kSiteVjpArrays * C * D : 0;
  return arrays + kSiteWarps * C * HM + 10 * C * HM + C * P;
}

template <int HM>
struct SiteVjpSmem {
  float *x, *v, *g1, *vh, *y, *xo, *g2, *dx, *dv, *dg;  // (C, D) each
  float* red;        // (warps, C, HM): partial sums over sites
  float *h, *h2;     // (4, C, HM) each: the applications' hidden layers
  float *dz1, *dz2;  // (C, HM): a net's hidden-layer cotangents
  // the prelude's block sums run in red, free wherever a prelude runs (in a
  // gradient, and before the gradient VJP, after the first layer's VJP has
  // read red's partials); its (C, P) scalars follow dz2
  SiteScratch sc;
};

// The layout at shared memory p, the (C, D) arrays at glob (the block's
// global scratch) where they do not fit p.
template <int HM>
__device__ inline SiteVjpSmem<HM> site_vjp_smem(float* p, float* glob, int D) {
  const int C = kSiteChains, n = C * D;
  SiteVjpSmem<HM> s;
  float* q = site_vjp_arrays_in_smem(D) ? p : glob;
  float** arrays[] = {&s.x, &s.v, &s.g1, &s.vh, &s.y, &s.xo, &s.g2, &s.dx, &s.dv, &s.dg};
  for (float** a : arrays) {
    *a = q;
    q += n;
  }
  s.red = site_vjp_arrays_in_smem(D) ? q : p;
  s.h = s.red + kSiteWarps * C * HM;
  s.h2 = s.h + 4 * C * HM;
  s.dz1 = s.h2 + 4 * C * HM;
  s.dz2 = s.dz1 + C * HM;
  s.sc = SiteScratch{s.red, s.red + kSiteWarps * 2 * C, s.dz2 + C * HM};
  return s;
}

// The sum of a over a warp's lanes in a fixed order (lane 0's result).
__device__ inline float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// VJP of application APP (run as 4, 3, 2, 1) of the substep whose recompute
// lies in s, the launch's direction rev, for the tile's chains: on entry the
// arrays hold the cotangents of the application's outputs, on return those
// of its inputs (the comments give the forward direction's names; the
// reverse direction's expressions are lane_traj_step_vjp's). dl: each
// chain's log-det cotangent. The weight cotangents and the eps cotangent are
// added into the block's row (net at row offset 0 for the xnet, nf for the
// vnet, eps at 2 nf).
template <int APP, class En, int HM>
__device__ inline void site_app_vjp(const Block& B, Dims d, bool hmc, bool rev,
                                    int step, const SiteVjpSmem<HM>& s,
                                    const float (&dl)[kSiteChains], float* row,
                                    int nf) {
  constexpr int C = kSiteChains, U = HM / 32;
  constexpr bool VNET = APP == 1 || APP == 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Net& w = VNET ? B.vnet : B.xnet;
  const NetRows r = net_rows(VNET ? nf : 0, d);
  const float* h = s.h + (APP - 1) * C * HM;
  const float* h2 = s.h2 + (APP - 1) * C * HM;
  // the application's inputs (a, b): b masked for the xnet (its mask's half
  // m or 1 - m, bm below); da goes to A, db times the mask to Bd
  const float* a = APP == 4 ? s.xo : APP == 1 ? s.x : s.vh;
  const float* b = APP == 4 ? s.g2 : APP == 1 ? s.g1 : APP == 3 ? s.y : s.x;
  float* A = VNET ? s.dx : s.dv;
  float* Bd = VNET ? s.dg : s.dx;
  // APP 2's b is the half of x APP 1 gave it, APP 3's the other half of y
  const bool b_is_m = (APP == 2) == !rev;

  // the elementwise backward of the update and of the heads, site by site;
  // the heads' weight cotangents and their input cotangent's partial sums
  const int groups = (d.D + kSiteThreads - 1) / kSiteThreads;
  for (int gi = 0; gi < groups; ++gi) {
    const int i = threadIdx.x + gi * kSiteThreads;
    const bool on = i < d.D;
    float dus[C], dut[C], duq[C];
    if (on) {
      float sv[C], tv[C], qv[C], ths[C], thq[C];
      site_head_values<HM>(w, d, hmc, i, h2, sv, tv, qv, ths, thq);
      const float e = B.eps[i], hh = 0.5f * e;
      const float m = B.masks[i * d.T + step], mb = 1.f - m;
      float de = 0.f, hbs = 0.f, hls = 0.f, hbt = 0.f, hbq = 0.f, hlq = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = c * d.D + i;
        float ds, dt, dq;
        if (APP == 4 || APP == 1) {
          // v' = v E + e/2 (-Q g + t), v = v_h (APP 4) or v (APP 1)
          const float vin = APP == 4 ? s.vh[o] : s.v[o];
          const float g = APP == 4 ? s.g2[o] : s.g1[o];
          const float dvo = s.dv[o];
          float dvi, dQ, dsv;
          if (!rev) {
            const float E = expf(hh * sv[c]), Q = expf(e * qv[c]);
            dvi = dvo * E;
            dsv = dvo * vin * E + dl[c];
            dQ = -dvo * hh * g;
            de += 0.5f * dvo * (-Q * g + tv[c]) + dQ * Q * qv[c] + 0.5f * dsv * sv[c];
            ds = dsv * hh;
            dt = dvo * hh;
            dq = dQ * Q * e;
            s.dg[o] = -dvo * hh * Q;
          } else {
            const float E = expf(-hh * sv[c]), Q = expf(e * qv[c]);
            const float Av = vin - hh * (-Q * g + tv[c]);
            dvi = dvo * E;
            dsv = dvo * Av * E + dl[c];
            dQ = dvi * hh * g;
            de += 0.5f * dvi * (Q * g - tv[c]) + dQ * Q * qv[c] - 0.5f * dsv * sv[c];
            ds = -hh * dsv;
            dt = -dvi * hh;
            dq = dQ * Q * e;
            s.dg[o] = dvi * hh * Q;
          }
          s.dv[o] = dvi;
        } else {
          // APP 3: x_o = (1 - m) y + m (y E + e (Q v_h + t)); APP 2: y from x
          // with the masks' roles swapped. dx holds the output's cotangent.
          const float keep = (APP == 2) == !rev ? m : mb, move = 1.f - keep;
          const float xin = APP == 3 ? s.y[o] : s.x[o];
          const float vh = s.vh[o], dxo = s.dx[o], Q = expf(e * qv[c]);
          float dsx, dQ;
          if (!rev) {
            const float E = expf(e * sv[c]);
            s.dx[o] = dxo * (keep + move * E);
            dsx = dxo * move * xin * E + dl[c] * move;
            dt = dxo * move * e;
            dQ = dt * vh;
            s.dv[o] += dt * Q;
            de += dxo * move * (Q * vh + tv[c]) + dQ * Q * qv[c] + dsx * sv[c];
            ds = dsx * e;
          } else {
            const float E = expf(-e * sv[c]);
            const float Bv = xin - e * (Q * vh + tv[c]);
            const float dB = dxo * move * E;
            s.dx[o] = dxo * keep + dB;
            dsx = dB * Bv + dl[c] * move;
            dt = -dB * e;
            dQ = dt * vh;
            s.dv[o] += dt * Q;
            de += -dB * (Q * vh + tv[c]) + dQ * Q * qv[c] - dsx * sv[c];
            ds = -e * dsx;
          }
          dq = dQ * Q * e;
        }
        // the heads: S = exp(ls) tanh(us), T = ut, Q = exp(lq) tanh(uq)
        const float es = ds * expf(w.ls[i]), eq = dq * expf(w.lq[i]);
        dus[c] = es * (1.f - ths[c] * ths[c]);
        dut[c] = dt;
        duq[c] = eq * (1.f - thq[c] * thq[c]);
        hls += es * ths[c];
        hlq += eq * thq[c];
        hbs += dus[c];
        hbt += dt;
        hbq += duq[c];
      }
      row[2 * nf + i] += de;
      if (!hmc) {
        row[r.bs + i] += hbs;
        row[r.ls + i] += hls;
        row[r.bt + i] += hbt;
        row[r.bq + i] += hbq;
        row[r.lq + i] += hlq;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) dus[c] = dut[c] = duq[c] = 0.f;
    }
    if (hmc) continue;
    // dz2 (before the ReLU gate) = sum over sites of the heads' weights times
    // their input cotangents: this warp's part, unit by unit
    for (int k = 0; k < d.H2; ++k) {
      float ws = 0.f, wt = 0.f, wq = 0.f;
      if (on) {
        ws = w.ws[k * d.D + i];
        wt = w.wt[k * d.D + i];
        wq = w.wq[k * d.D + i];
        float gs = 0.f, gt = 0.f, gq = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float hk = h2[c * HM + k];
          gs = fmaf(hk, dus[c], gs);
          gt = fmaf(hk, dut[c], gt);
          gq = fmaf(hk, duq[c], gq);
        }
        row[r.ws + k * d.D + i] += gs;
        row[r.wt + k * d.D + i] += gt;
        row[r.wq + k * d.D + i] += gq;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = warp_sum(fmaf(ws, dus[c], fmaf(wt, dut[c], wq * duq[c])));
        if (lane == 0) {
          float* q = s.red + (warp * C + c) * HM + k;
          *q = gi == 0 ? p : *q + p;
        }
      }
    }
  }
  __syncthreads();
  if (!hmc) {
    // dz2 = its warps' partials in warp order, gated by the second ReLU
    for (int p = threadIdx.x; p < C * d.H2; p += kSiteThreads) {
      const int c = p / d.H2, k = p - c * d.H2;
      float t = 0.f;
      for (int wv = 0; wv < kSiteWarps; ++wv) t += s.red[(wv * C + c) * HM + k];
      s.dz2[c * HM + k] = h2[c * HM + k] > 0.f ? t : 0.f;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < d.H2; k += kSiteThreads) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) t += s.dz2[c * HM + k];
      row[r.bh + k] += t;
    }
    for (int p = threadIdx.x; p < d.H * d.H2; p += kSiteThreads) {
      const int j = p / d.H2, k = p - j * d.H2;
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) t = fmaf(h[c * HM + j], s.dz2[c * HM + k], t);
      row[r.wh + p] += t;
    }
    for (int p = threadIdx.x; p < C * d.H; p += kSiteThreads) {
      const int c = p / d.H, j = p - c * d.H;
      float t = 0.f;
      for (int k = 0; k < d.H2; ++k) t = fmaf(w.wh[j * d.H2 + k], s.dz2[c * HM + k], t);
      s.dz1[c * HM + j] = h[c * HM + j] > 0.f ? t : 0.f;  // h is 0 where the ReLU cut
    }
    __syncthreads();
    for (int j = threadIdx.x; j < d.H; j += kSiteThreads) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) t += s.dz1[c * HM + j];
      row[r.te + j * d.T + step] += t;
    }
    // the first layer: a warp a site, lanes over the units
    float dz[C][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + 32 * u;
#pragma unroll
      for (int c = 0; c < C; ++c) dz[c][u] = j < d.H ? s.dz1[c * HM + j] : 0.f;
    }
    for (int i = warp; i < d.D; i += kSiteWarps) {
      float bm = 1.f;
      if (!VNET) {
        const float m = B.masks[i * d.T + step];
        bm = b_is_m ? m : 1.f - m;
      }
      float pa[C], pb[C], av[C], bv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        pa[c] = pb[c] = 0.f;
        av[c] = a[c * d.D + i];
        bv[c] = bm * b[c * d.D + i];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u > 0 && d.H <= 32 * u) break;  // the same in every lane
        const int j = lane + 32 * u, jj = min(j, d.H - 1);
        const float w1 = w.w1[i * d.H + jj], w2 = w.w2[i * d.H + jj];
        float g1 = 0.f, g2 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          pa[c] = fmaf(w1, dz[c][u], pa[c]);
          pb[c] = fmaf(w2, dz[c][u], pb[c]);
          g1 = fmaf(av[c], dz[c][u], g1);
          g2 = fmaf(bv[c], dz[c][u], g2);
        }
        if (j < d.H) {
          row[r.w1 + i * d.H + j] += g1;
          row[r.w2 + i * d.H + j] += g2;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float sa = warp_sum(pa[c]), sb = warp_sum(pb[c]);
        if (lane == 0) {
          A[c * d.D + i] += sa;
          Bd[c * d.D + i] += bm * sb;
        }
      }
    }
    __syncthreads();
  }
  if (VNET) site_grad_vjp<En>(B, d, a, s.dg, s.dx, s.sc);  // through the energy gradient
}

// VJP of one substep (step, direction rev) at the input (s.x, s.v) for the
// tile's chains: on entry s.dx, s.dv hold the cotangents of its output and
// dl the log-det's; on return s.dx, s.dv those of its input, and the
// weight and eps cotangents are added into row. The substep is recomputed
// first with the forward phases (site_hidden, site_heads), its
// intermediates kept apart.
template <class En, int HM>
__device__ inline void site_substep_vjp(const Block& B, Dims d, bool hmc, bool rev,
                                        int step, const SiteVjpSmem<HM>& s,
                                        const float (&dl)[kSiteChains], float* row,
                                        int nf) {
  constexpr int C = kSiteChains;
  int steps[C];
  bool revs[C];
  float ld[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    steps[c] = step;
    revs[c] = rev;
    ld[c] = 0.f;
  }
  auto hid = [&](int app) { return s.h + app * C * HM; };
  auto hid2 = [&](int app) { return s.h2 + app * C * HM; };
  site_grad<En>(B, d, s.x, s.g1, s.sc);
  if (!hmc) site_hidden<float, HM>(B.vnet, d, s.x, s.g1, steps, s.red, hid(0), hid2(0));
  site_heads<1, HM>(B, B.vnet, d, hmc, revs, steps, hid2(0),
                    SiteIO{s.x, nullptr, s.v, s.vh, s.g1, s.dg}, ld);
  if (!hmc) site_hidden<float, HM>(B.xnet, d, s.vh, s.dg, steps, s.red, hid(1), hid2(1));
  site_heads<2, HM>(B, B.xnet, d, hmc, revs, steps, hid2(1),
                    SiteIO{s.x, s.y, s.vh, nullptr, nullptr, s.dg}, ld);
  if (!hmc) site_hidden<float, HM>(B.xnet, d, s.vh, s.dg, steps, s.red, hid(2), hid2(2));
  site_heads<3, HM>(B, B.xnet, d, hmc, revs, steps, hid2(2),
                    SiteIO{s.y, s.xo, s.vh, nullptr, nullptr, nullptr}, ld);
  site_grad<En>(B, d, s.xo, s.g2, s.sc);
  if (!hmc) site_hidden<float, HM>(B.vnet, d, s.xo, s.g2, steps, s.red, hid(3), hid2(3));
  site_app_vjp<4, En, HM>(B, d, hmc, rev, step, s, dl, row, nf);
  site_app_vjp<3, En, HM>(B, d, hmc, rev, step, s, dl, row, nf);
  site_app_vjp<2, En, HM>(B, d, hmc, rev, step, s, dl, row, nf);
  site_app_vjp<1, En, HM>(B, d, hmc, rev, step, s, dl, row, nf);
}

// Whether the chain kernel runs these widths and spec on the site-parallel
// configuration: past WideLanes' widths, and phi^4 wherever a configuration
// serves its widths. At L = 8 (D = 64) the lane form, the stencil on every
// lane's copy of the lattice in local memory, ran 512 chains x 1000 traced
// MH steps in 3746 ms on an H100; chip_smoke.py times this form there.
inline bool site_chain(Dims d, int kind) {
  const int p = pick_lanes(d);
  return p == 3 || (p == 2 && kind == Phi4::kKind);
}

template <class En, int HM, class TW>
static int launch_site_chain_hm(const float* params, Dims d, int hmc,
                                const float* x, float* xo, float* acc,
                                float* trace, float* xs, int N, int K,
                                uint2 key, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(site_smem_floats(d.D, HM, site_pre_floats(d, En::kKind))) *
      sizeof(float);
  cudaError_t e = allow_smem(site_chain_kernel<En, HM, TW>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + kSiteChains - 1) / kSiteChains;
  site_chain_kernel<En, HM, TW><<<blocks, kSiteThreads, smem, stream>>>(
      params, d, hmc, x, xo, acc, trace, xs, N, K, key);
  return static_cast<int>(cudaGetLastError());
}

template <class En, class TW>
static int launch_site_chain(const float* params, Dims d, int hmc,
                             const float* x, float* xo, float* acc,
                             float* trace, float* xs, int N, int K, uint2 key,
                             cudaStream_t stream) {
  if (xs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (site_hm(d) == WideLanes::HM)
    return launch_site_chain_hm<En, WideLanes::HM, TW>(params, d, hmc, x, xo, acc,
                                                   trace, xs, N, K, key, stream);
  return launch_site_chain_hm<En, kSiteMaxHidden, TW>(params, d, hmc, x, xo, acc,
                                                  trace, xs, N, K, key, stream);
}

}  // namespace l2hmc
