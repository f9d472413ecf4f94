// The chain kernel's site-parallel configuration on thread-block clusters:
// K whole Metropolis-Hastings steps of the direction-randomised L2HMC sampler
// for states or S/T/Q nets wider than a lane group holds (D <= kSiteMaxDim,
// 4096, the 64 x 64 phi^4 lattice; hidden widths <= kSiteMaxHidden, 128),
// and the phi^4 lattice at every width, on every energy spec (Gauss,
// RoughWell, Gmm, Funnel, Phi4). chain.cu launches it where site_chain
// (l2hmc_sites.cuh) says so, in float32 and, in chain_bf16.cu, with bfloat16
// operands.
//
// Replaces the Pallas kernel _make_chain_kernel / FusedChainSampler
// (l2hmc_tpu/ops/fused_dynamics.py:1103, pallas_call at :1350) at these
// widths, including its loop_traj form (fused_chain_sampler :1391, dim >=
// 2048): the trajectory loops over T at run time at every width.
//
// Bound on the card: operations (the nets' products, 2 T of each net an MH
// step and chain), and the weights' bytes from the L2. The TPU kernel tiles
// 128-256 chains, so each weight it reads serves them all. A block of 4
// chains (the form this replaces) read the weights from the L2 at every use,
// each load serving 4 chains: at the 64 x 64 lattice's recipe (hidden 64,
// T = 24, 256 chains) ~3.3e13 bytes a launch at ~1.27 TB/s, a latency limit,
// on 64 of the card's 132 SMs.
//
// Design. A cluster of G CTAs (kClThreads threads each, G <= 8) runs a tile
// of C chains for all K MH steps, C = 16, 8 or 4 (a launch-time width; the
// registers hold 16); the D sites split into G contiguous ranges of `chunk`
// sites (whole lattice rows for phi^4, an even count otherwise, so a pair
// of normals never straddles two ranges). Each CTA holds x', v and g of its
// range for the C chains in shared memory, site-major ([site][chain], a
// site's chains in float4s), and the accepted x beside them where it fits,
// else in the wrapper's scratch. A host rule (cl_plan) picks C and G from
// the widths, the chain count and how many clusters of each size the card
// holds at once (cudaOccupancyMaxActiveClusters: an H100's GPCs hold 30
// clusters of 4 and 15 of 8, not 33 and 16, so 16 tiles on clusters of 8
// would take a second wave): staged plans that run in one wave where some
// do, else 16-chain tiles on the G with the fewest waves x chunk, within
// 232,448 bytes a CTA. A net application is
//   - the first layer: each CTA sums its own sites for the C chains and all
//     H units (lanes over units, warps over sites; one weight load serves
//     the C chains, the next sites' loads in flight), the warps' partials in
//     warp order, then the G ranks' partial (C, H) rows in rank order
//     through distributed shared memory after one cluster barrier (the
//     partial rows are double-buffered, so one barrier an application
//     suffices);
//   - the second layer in every CTA (it is (C, H) x (H, H2), a few percent
//     of the work), a thread a unit and 4 chains;
//   - the heads S, T, Q and the substep's update on the CTA's own sites, a
//     thread a site and 4 chains (one float4 of the state; where a range
//     has few sites, lanes share a site's units and reduce-scatter them).
// The four applications of a substep run vnet, xnet, xnet, vnet, as
// site_traj_step does, as a loop over one copy of their code: the kernel's
// time at the small ranges went with its code's size (two unrolled copies
// of each phase ran 10-30% slower on an H100). Weights: where the CTA's
// slice of both nets (its rows of w1 and w2, its columns of ws, wt and wq,
// its per-site biases and scales) fits beside the state it is staged into
// shared memory once a launch by cp.async, else the heads' part where that
// fits, else the first layer's rows; wh, bh, te, eps and the masks stay in
// global memory (small, L1-resident). The rest streams from the L2 (the
// 64 x 64 lattice: both nets ~10.6 MB at hidden 64), each load serving the
// tile's chains.
//
// The specs across the cluster. RoughWell is elementwise. Phi4 reads its
// up and down neighbours' x' on the rows next to a range from the
// neighbouring ranks' shared memory (periodic at the ends), after a cluster
// barrier; so does its energy. Gauss and Gmm read the whole x (a row of P),
// the other ranks' sites through distributed shared memory: the host rule
// runs them at G = 1 wherever the state fits a CTA (past it they read
// remotely, correct but slow). The funnel's and the mixture's preludes, the
// Hamiltonian, the kinetic energy and the log-det are fixed-order sums: a
// warp's lanes of a chain by a butterfly, the warps in order, then the ranks
// in rank order (each CTA sums the same G partials in the same order, so
// every CTA holds the same totals); no atomics, and a launch repeats bit for
// bit. Every CTA decides a chain's accept alike.
//
// Random numbers as in the other chain kernels: Philox4x32-10, counter
// (global chain, MH step, slot, 0), slot 0 the direction and the accept
// uniform, slot 1 + j the normals 2j and 2j + 1, drawn by the CTA whose
// range holds site 2j: the draws do not depend on C or G. Direction and
// accept are selects. A tile's chains past N run as copies of the last
// chain and write nothing. The accepted states' trace is (K, D, N).
//
// HM (64 or 128, the first layer's units a lane holds) and TW (float, or
// __nv_bfloat16 in chain_bf16.cu: the weights arrive rounded, the first
// layer rounds its inputs as it reads them and the hidden layers are stored
// rounded) are template parameters; G, the ranges and the staging are
// launch-time values, so there is one kernel per (spec, HM, TW).
#pragma once
#include <cooperative_groups.h>

#include <type_traits>

#include "cluster_launch.cuh"
#include "l2hmc_sites.cuh"
#include "philox.cuh"

namespace l2hmc {

namespace cg = cooperative_groups;

constexpr int kClChains = 16;                    // the widest tile: chains a CTA holds
constexpr int kClThreads = 256;                  // threads a CTA
constexpr int kClWarps = kClThreads / 32;
constexpr int kClQuads = kClChains / 4;          // float4s of a site's chains at the widest
constexpr int kClTargetCtas = 132;               // the card's SMs
constexpr int kClMaxG = 8;                       // the widest (portable) cluster
// bytes of static shared memory the kernel takes (its two nets' ClNet),
// which the dynamic shared memory a CTA may use leaves out
constexpr int kClStaticSmem = 224;
constexpr int kClDynFloats =
    static_cast<int>((kClusterMaxSmem - kClStaticSmem) / sizeof(float));

// The launch's geometry: `chains` a tile (16, 8 or 4), G CTAs a cluster,
// `chunk` sites a range, which parts of both nets' slices are staged in
// shared memory (kStageRows | kStageHeads), whether the accepted states lie
// there, and the floats of dynamic shared memory a CTA.
struct ClPlan {
  int chains, G, chunk, staged, x_smem, smem_floats;
};
constexpr int kStageRows = 1;   // the first layer's rows of w1 and w2
constexpr int kStageHeads = 2;  // the heads' columns and the per-site arrays

// Sites a range is a multiple of: whole lattice rows for phi^4 (two rows
// where L is odd), else 2 (a pair of normals never straddles two ranges).
__host__ __device__ inline int cl_unit(int D, int kind) {
  if (kind != Phi4::kKind) return 2;
  int L = 1;
  while (L * L < D) ++L;
  return L % 2 == 0 ? L : 2 * L;
}

__host__ __device__ inline int cl_chunk(int D, int G, int unit) {
  const int per = (D + G - 1) / G;
  return (per + unit - 1) / unit * unit;
}

// Floats of one net's staged slice, of the parts in `staged`: w1, w2 rows
// (chunk x H each); ws, wt, wq columns (H2 x chunk each) and bs, ls, bt, bq,
// lq (chunk each).
__host__ __device__ inline int cl_net_staged_floats(Dims d, int chunk, int staged) {
  return ((staged & kStageRows) ? 2 * chunk * d.H : 0) +
         ((staged & kStageHeads) ? 3 * d.H2 * chunk + 5 * chunk : 0);
}

// Floats of dynamic shared memory a CTA uses with a tile of C chains: x', v,
// g (and x) as (chunk, C); the first layer's warp partials (warps, C, H) and
// its two partial rows (2, C, H); h (H, C), h2 (H2, C); the sums' warp
// partials (warps, 3, 4), their two cluster rows (2, 3, 16) and totals
// (3, 16); the chains' accept uniforms, accepts and directions (3, 16); the
// prelude (16, P); the staged slices of both nets.
__host__ __device__ inline int cl_smem_floats(Dims d, int P, int C, int chunk, bool x_smem,
                                              int staged) {
  int f = (x_smem ? 4 : 3) * chunk * C;
  f += kClWarps * C * d.H + 2 * C * d.H + d.H * C + d.H2 * C;
  f += kClWarps * 3 * 4 + 2 * 3 * kClChains + 3 * kClChains + 3 * kClChains + kClChains * P;
  return f + 2 * cl_net_staged_floats(d, chunk, staged);
}

// Whether x', v, g and the buffers of a range of `chunk` sites fit a CTA.
__host__ __device__ inline bool cl_state_fits(Dims d, int P, int C, int chunk) {
  return cl_smem_floats(d, P, C, chunk, false, 0) <= kClDynFloats;
}

// The launch at C chains a tile and a cluster of G_raw CTAs: the ranges of
// `chunk` sites, G the ranks that hold sites, the nets' slices staged where
// they fit beside the state (both parts, else the heads', the larger, else
// the first layer's rows), the accepted states in shared memory where they
// fit beside that.
__host__ __device__ inline ClPlan cl_candidate(Dims d, int P, int C, int G_raw, int unit) {
  const int cap = kClDynFloats;
  ClPlan p;
  p.chains = C;
  p.chunk = cl_chunk(d.D, G_raw, unit);
  p.G = (d.D + p.chunk - 1) / p.chunk;
  p.staged = 0;
  const int order[3] = {kStageRows | kStageHeads, kStageHeads, kStageRows};
  for (int k = 0; k < 3 && p.staged == 0; ++k)
    if (cl_smem_floats(d, P, C, p.chunk, false, order[k]) <= cap) p.staged = order[k];
  p.x_smem = cl_smem_floats(d, P, C, p.chunk, true, p.staged) <= cap;
  p.smem_floats = cl_smem_floats(d, P, C, p.chunk, p.x_smem, p.staged);
  return p;
}

// The host rule. at_once[G] (G = 1 .. kClMaxG) is how many clusters of G
// CTAs the card holds at once (cudaOccupancyMaxActiveClusters; null: the
// ideal kClTargetCtas / G).
//   - Where some tile width (16, 8, 4 chains) and G up to kClMaxG run the
//     tiles in one wave with both nets' slices staged beside the state: the
//     one of those with the most CTAs (the most SMs at work), of equals the
//     smallest G (a cluster's exchange costs more than its split saves),
//     then the widest tile.
//   - Else Gauss and Gmm, which read the whole state: one CTA a tile, the
//     widest width whose tiles are at least 3/4 of the CTAs the card holds
//     at once, else the narrowest that fits.
//   - Else tiles of 16 chains (each weight read serves 16) on clusters of
//     the G up to kClMaxG whose ranges all hold sites and whose state fits,
//     the one that runs the tiles in the fewest waves of the most sites a
//     CTA holds (waves x chunk, the smallest such G): a launch fills the SMs
//     the card can give its clusters without a second wave where one is
//     avoidable.
//   - Nothing fits only past the caps (at dim 4096 and hidden 128 the state
//     of 16 chains fits at G = 8): then G = kClMaxG, which the launcher
//     refuses.
// G counts only the ranks that hold sites: a G whose ranges leave a rank
// empty is not a candidate.
__host__ __device__ inline ClPlan cl_plan(Dims d, int kind, int N, const int* at_once) {
  const int P = site_pre_floats(d, kind);
  const int unit = cl_unit(d.D, kind);
  const bool whole = kind == Gauss::kKind || kind == Gmm::kKind;
  auto held = [&](int G) { return at_once != nullptr ? at_once[G] : kClTargetCtas / G; };
  ClPlan best = cl_candidate(d, P, kClChains, 1, unit);
  int best_ctas = 0;
  for (int G = 1; G <= (whole ? 1 : kClMaxG); ++G) {
    for (int C = kClChains; C >= 4; C /= 2) {
      const ClPlan p = cl_candidate(d, P, C, G, unit);
      const int tiles = (N + C - 1) / C;
      if (p.G != G || !cl_state_fits(d, P, C, p.chunk) ||
          p.staged != (kStageRows | kStageHeads) || tiles > held(G))
        continue;
      if (tiles * G > best_ctas) {
        best = p;
        best_ctas = tiles * G;
      }
    }
  }
  if (best_ctas > 0) return best;
  if (whole) {
    for (int C = kClChains; C >= 4; C /= 2) {
      const ClPlan p = cl_candidate(d, P, C, 1, unit);
      if (4 * ((N + C - 1) / C) >= 3 * held(1) && cl_state_fits(d, P, C, p.chunk)) return p;
    }
    for (int C = 4; C <= kClChains; C *= 2) {
      const ClPlan p = cl_candidate(d, P, C, 1, unit);
      if (cl_state_fits(d, P, C, p.chunk)) return p;
    }
  } else {
    const int tiles = (N + kClChains - 1) / kClChains;
    long long best_cost = -1;
    for (int G = 1; G <= kClMaxG; ++G) {
      const ClPlan p = cl_candidate(d, P, kClChains, G, unit);
      if (p.G != G || !cl_state_fits(d, P, kClChains, p.chunk) || held(G) < 1) continue;
      const long long cost = static_cast<long long>((tiles + held(G) - 1) / held(G)) * p.chunk;
      if (best_cost < 0 || cost < best_cost) {
        best = p;
        best_cost = cost;
      }
    }
    if (best_cost >= 0) return best;
  }
  return cl_candidate(d, P, kClChains, kClMaxG, unit);
}

// -- the CTA's place and memory ---------------------------------------------------

struct ClCtx {
  int G, rank, chunk, lo, n, D;  // n: the sites of this CTA's range, from lo
  int cs, nq, qsh;               // chains a tile, its quads (cs / 4), log2 nq
};

struct ClSmem {
  float *xp, *v, *g, *x;         // (chunk, C): proposal, momentum, gradient, accepted
  float *red, *part, *h, *h2;    // first layer's partials; hidden layers (units, C)
  float *sred, *csum, *tot;      // the sums' partials, cluster rows, totals
  float *u, *acc;                // (C): accept uniforms, accepts
  int* rev;                      // (C): directions
  float *pre, *w;                // (16, P) prelude; the staged slices
};

__device__ inline ClSmem cl_smem(float* p, Dims d, const ClPlan& pl, int P) {
  constexpr int C16 = kClChains;
  const int C = pl.chains;
  ClSmem s;
  const int n = pl.chunk * C;
  s.xp = p; p += n;
  s.v = p; p += n;
  s.g = p; p += n;
  s.x = nullptr;
  if (pl.x_smem) { s.x = p; p += n; }
  s.red = p; p += kClWarps * C * d.H;
  s.part = p; p += 2 * C * d.H;
  s.h = p; p += d.H * C;
  s.h2 = p; p += d.H2 * C;
  s.sred = p; p += kClWarps * 3 * 4;
  s.csum = p; p += 2 * 3 * C16;
  s.tot = p; p += 3 * C16;
  s.u = p; p += C16;
  s.acc = p; p += C16;
  s.rev = reinterpret_cast<int*>(p); p += C16;
  s.pre = p; p += C16 * P;
  s.w = p;
  return s;
}

__device__ __forceinline__ void cl_sync(const ClCtx& X) {
  if (X.G == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

__device__ __forceinline__ const float* cl_rank_ptr(const float* p, const ClCtx& X, int r) {
  return r == X.rank ? p : cg::this_cluster().map_shared_rank(const_cast<float*>(p), r);
}

// Entry idx of the array at p summed over the cluster's ranks in rank order
// (the G loads issued together).
__device__ __forceinline__ float cl_rank_sum(const float* p, const ClCtx& X, int idx) {
  float v[kClMaxG];
#pragma unroll
  for (int r = 0; r < kClMaxG; ++r)
    if (r < X.G) v[r] = cl_rank_ptr(p, X, r)[idx];
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < kClMaxG; ++r)
    if (r < X.G) t += v[r];
  return t;
}

// A thread's place in the per-site phases: chains 4q .. 4q + 3 (q = warp %
// nq, one float4 of a site's state) at sites slot, slot + cl_pass, ...; a
// warp's 32 lanes take 32 consecutive sites, so its loads of a per-site
// weight row are whole 128-byte lines.
__device__ __forceinline__ int cl_quad(const ClCtx& X) { return (threadIdx.x >> 5) & (X.nq - 1); }
__device__ __forceinline__ int cl_slot(const ClCtx& X) {
  return (threadIdx.x & 31) + 32 * (threadIdx.x >> (5 + X.qsh));
}
__device__ __forceinline__ int cl_pass(const ClCtx& X) { return kClThreads >> X.qsh; }

__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ void st4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

// One (chunk, cs) state array of the tile across the cluster: chains 4q ..
// 4q + 3 at site j, from this CTA's range or from the rank that holds it.
struct ClView {
  const float* p;
  ClCtx X;
  __device__ void at4(int j, int q, float (&o)[4]) const {
    const int jl = j - X.lo;
    if (jl >= 0 && jl < X.n) {
      ld4(p + jl * X.cs + 4 * q, o);
      return;
    }
    const int r = j / X.chunk;
    const float* rp = cl_rank_ptr(p, X, r) + (j - r * X.chunk) * X.cs + 4 * q;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) o[cc] = rp[cc];
  }
  __device__ float at(int j, int c) const {
    const int r = j / X.chunk;
    return cl_rank_ptr(p, X, r)[(j - r * X.chunk) * X.cs + c];
  }
  // f(j, x_j) for every site j = 0 .. D - 1 in order
  template <class F>
  __device__ void each(int q, F&& f) const {
    for (int r = 0; r < X.G; ++r) {
      const int lo = min(r * X.chunk, X.D), hi = min(lo + X.chunk, X.D);
      const float* rp = cl_rank_ptr(p, X, r) + 4 * q;
      for (int j = lo; j < hi; ++j) {
        float o[4];
        if (r == X.rank) {
          ld4(rp + (j - lo) * X.cs, o);
        } else {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) o[cc] = rp[(j - lo) * X.cs + cc];
        }
        f(j, o);
      }
    }
  }
};

// -- the energy specs on a cluster's ranges -----------------------------------------
//
// Each spec's site functions (l2hmc_common.cuh's grad_at, energy_at,
// pre_part, pre_finish) for chains 4q .. 4q + 3 of the tile at global site i,
// on a ClView of x'; pre4 points at chain 4q's prelude, P floats a chain.
// kRemote: whether a site reads other sites, so that reading x' across the
// cluster needs a barrier first.
template <class En>
struct ClSpec;

template <>
struct ClSpec<Gauss> {
  static constexpr bool kRemote = true;
  __device__ static void grad(const Block& B, Dims d, const ClView& X, int i, int q,
                              const float*, int, float (&g)[4]) {
    const float* c = B.c;
    const float* mu = c + d.D * d.D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) g[cc] = 0.f;
    X.each(q, [&](int j, const float (&xj)[4]) {
      const float pij = c[i * d.D + j], mj = mu[j];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) g[cc] = fmaf(pij, xj[cc] - mj, g[cc]);
    });
  }
  __device__ static void energy(const Block& B, Dims d, const ClView& X, int i, int q,
                                float (&e)[4]) {
    float g[4], xi[4];
    grad(B, d, X, i, q, nullptr, 0, g);
    X.at4(i, q, xi);
    const float mi = B.c[d.D * d.D + i];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) e[cc] = 0.5f * ((xi[cc] - mi) * g[cc]);
  }
};

template <>
struct ClSpec<RoughWell> {
  static constexpr bool kRemote = false;
  __device__ static void grad(const Block& B, Dims, const ClView& X, int i, int q,
                              const float*, int, float (&g)[4]) {
    float xi[4];
    X.at4(i, q, xi);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) g[cc] = xi[cc] - B.c[2] * sinf(xi[cc] * B.c[1]);
  }
  __device__ static void energy(const Block& B, Dims, const ClView& X, int i, int q,
                                float (&e)[4]) {
    float xi[4];
    X.at4(i, q, xi);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      e[cc] = 0.5f * (xi[cc] * xi[cc]) + B.c[0] * cosf(xi[cc] * B.c[1]);
  }
};

template <>
struct ClSpec<Gmm> {
  static constexpr bool kRemote = true;
  // (P_k (x - mu_k))_i
  __device__ static void row(const Block& B, Dims d, const ClView& X, int k, int i, int q,
                             float (&o)[4]) {
    const int K = Gmm::comps(d), D = d.D;
    const float* c = B.c;
    const float* prec = c + D * K + k * D * D;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) o[cc] = 0.f;
    X.each(q, [&](int j, const float (&xj)[4]) {
      const float pij = prec[i * D + j], mj = c[j * K + k];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) o[cc] = fmaf(pij, xj[cc] - mj, o[cc]);
    });
  }
  __device__ static void pre_part(const Block& B, Dims d, const ClView& X, int k, int i,
                                  int q, float (&a)[4]) {
    const int K = Gmm::comps(d);
    float p[4], xi[4];
    row(B, d, X, k, i, q, p);
    X.at4(i, q, xi);
    const float mk = B.c[i * K + k];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) a[cc] = fmaf(xi[cc] - mk, p[cc], a[cc]);
  }
  __device__ static void pre_finish(const Block& B, Dims d, const ClView&, int, float* pre) {
    Gmm::pre_finish(B.c, d, nullptr, pre, false);
  }
  __device__ static void grad(const Block& B, Dims d, const ClView& X, int i, int q,
                              const float* pre4, int P, float (&g)[4]) {
    const int K = Gmm::comps(d);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) g[cc] = 0.f;
    for (int k = 0; k < K; ++k) {
      float r[4];
      row(B, d, X, k, i, q, r);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) g[cc] += pre4[cc * P + k] * r[cc];
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) g[cc] = g[cc] / pre4[cc * P + 2 * K];
  }
};

template <>
struct ClSpec<Funnel> {
  static constexpr bool kRemote = true;  // every site reads v = x_0
  __device__ static void pre_part(const Block&, Dims, const ClView& X, int, int i, int q,
                                  float (&a)[4]) {
    if (i == 0) return;
    float xi[4];
    X.at4(i, q, xi);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) a[cc] += xi[cc] * xi[cc];
  }
  __device__ static void pre_finish(const Block& B, Dims, const ClView& X, int c, float* pre) {
    const float* k = B.c;
    const float v = X.at(0, c), w = Funnel::clip(v, k[1]);
    pre[1] = 0.5f * (v * v * k[0] + pre[0] * expf(-w) + k[2] * (1.8378770664093453f + w));
  }
  __device__ static void grad(const Block& B, Dims, const ClView& X, int i, int q,
                              const float* pre4, int P, float (&g)[4]) {
    const float* k = B.c;
    float v4[4], xi[4];
    X.at4(0, q, v4);
    X.at4(i, q, xi);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float v = v4[cc], inv_s = expf(-Funnel::clip(v, k[1]));
      if (i > 0) {
        g[cc] = xi[cc] * inv_s;
      } else {
        const float in = (v > -k[1] && v < k[1]) ? 1.f : 0.f;
        g[cc] = v * k[0] + 0.5f * in * (k[2] - pre4[cc * P] * inv_s);
      }
    }
  }
};

template <>
struct ClSpec<Phi4> {
  static constexpr bool kRemote = true;  // the rows next to a range
  __device__ static void grad(const Block& B, Dims d, const ClView& X, int i, int q,
                              const float*, int, float (&g)[4]) {
    const float* c = B.c;
    int r, l, dn, up;
    Phi4::nbrs(static_cast<int>(c[2]), d.D, i, r, l, dn, up);
    float xi[4], xr[4], xl[4], xd[4], xu[4];
    X.at4(i, q, xi);
    X.at4(r, q, xr);
    X.at4(l, q, xl);
    X.at4(dn, q, xd);
    X.at4(up, q, xu);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float x = xi[cc];
      const float lap = 4.f * x - xr[cc] - xl[cc] - xd[cc] - xu[cc];
      g[cc] = lap + c[0] * x + (4.f * c[1]) * x * x * x;
    }
  }
  __device__ static void energy(const Block& B, Dims d, const ClView& X, int i, int q,
                                float (&e)[4]) {
    const float* c = B.c;
    int r, l, dn, up;
    Phi4::nbrs(static_cast<int>(c[2]), d.D, i, r, l, dn, up);
    float xi[4], xr[4], xd[4];
    X.at4(i, q, xi);
    X.at4(r, q, xr);
    X.at4(dn, q, xd);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float x = xi[cc], a = xr[cc] - x, b = xd[cc] - x, x2 = x * x;
      e[cc] = 0.5f * (a * a + b * b) + ((0.5f * c[0]) * x2 + c[1] * (x2 * x2));
    }
  }
};

// -- sums over the cluster ------------------------------------------------------------

// The cluster's sums of each thread's V values for its chains 4q .. 4q + 3
// (q = cl_quad) into s.tot[16 v + c]: over a warp's lanes by a butterfly,
// over the warps of a chain's quad in order, then over the ranks in order.
// Every thread calls it; it synchronises the cluster. cbuf alternates the
// two cluster rows, so that the row a CTA writes is one every rank has read.
template <int V>
__device__ inline void cl_sums(const float (&v)[V][4], const ClSmem& s, const ClCtx& X,
                               int& cbuf) {
  constexpr int C = kClChains;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float a = v[k][cc];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) s.sred[(warp * V + k) * 4 + cc] = a;
    }
  }
  __syncthreads();
  float* const row = s.csum + cbuf * 3 * C;
  if (threadIdx.x < V * C) {
    const int k = threadIdx.x / C, c = threadIdx.x % C;
    float t = 0.f;
    if (c < X.cs)
      for (int w = c >> 2; w < kClWarps; w += X.nq) t += s.sred[(w * V + k) * 4 + (c & 3)];
    row[threadIdx.x] = t;
  }
  cl_sync(X);
  if (threadIdx.x < V * C) s.tot[threadIdx.x] = cl_rank_sum(row, X, threadIdx.x);
  __syncthreads();
  cbuf ^= 1;
}

// The prelude of spec En at x' for the tile's chains: pre_passes sums over
// the cluster's sites, then pre_finish by one thread a chain, into s.pre.
// Nothing for a spec without one. Every thread calls it; it synchronises.
template <class En>
__device__ inline void cl_prelude(const Block& B, Dims d, const ClCtx& X, const ClSmem& s,
                                  int& cbuf) {
  if constexpr (En::kPrelude) {
    const int K = En::pre_passes(d), P = En::pre_floats(d), q = cl_quad(X);
    const ClView V{s.xp, X};
    for (int k = 0; k < K; ++k) {
      float part[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      for (int i = cl_slot(X); i < X.n; i += cl_pass(X))
        ClSpec<En>::pre_part(B, d, V, k, X.lo + i, q, part[0]);
      cl_sums<1>(part, s, X, cbuf);
      if (threadIdx.x < X.cs) s.pre[threadIdx.x * P + k] = s.tot[threadIdx.x];
    }
    __syncthreads();
    if (threadIdx.x < X.cs)
      ClSpec<En>::pre_finish(B, d, V, threadIdx.x, s.pre + threadIdx.x * P);
    __syncthreads();
  }
}

// g <- grad E(x') for the tile's chains on this CTA's sites.
template <class En>
__device__ inline void cl_grad(const Block& B, Dims d, bool hmc, const ClCtx& X,
                               const ClSmem& s, int& cbuf) {
  constexpr bool R = ClSpec<En>::kRemote;
  if (R && X.G > 1) cl_sync(X);  // every rank's x' written
  cl_prelude<En>(B, d, X, s, cbuf);
  const int q = cl_quad(X), P = site_pre_floats(d, En::kKind);
  const ClView V{s.xp, X};
  for (int i = cl_slot(X); i < X.n; i += cl_pass(X)) {
    float g[4];
    ClSpec<En>::grad(B, d, V, X.lo + i, q, s.pre + 4 * q * P, P, g);
    st4(s.g + i * X.cs + 4 * q, g);
  }
  __syncthreads();
  // without the first layer's barrier before the next write of x' (HMC
  // mode), the other ranks must have read this one's x' first
  if (R && hmc && X.G > 1) cl_sync(X);
}

// E(x') (or, with a prelude, 0: the chain's energy comes from s.pre), v . v
// and the log-det of the tile's chains, summed over the cluster into
// s.tot[c], s.tot[16 + c], s.tot[32 + c].
template <class En>
__device__ inline void cl_hamiltonian(const Block& B, Dims d, const ClCtx& X, const ClSmem& s,
                                      const float (&ld)[4], int& cbuf) {
  if (ClSpec<En>::kRemote && X.G > 1) cl_sync(X);
  cl_prelude<En>(B, d, X, s, cbuf);
  const int q = cl_quad(X);
  const ClView V{s.xp, X};
  float part[3][4];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    part[0][cc] = part[1][cc] = 0.f;
    part[2][cc] = ld[cc];
  }
  for (int i = cl_slot(X); i < X.n; i += cl_pass(X)) {
    float vi[4];
    ld4(s.v + i * X.cs + 4 * q, vi);
    if constexpr (!En::kPrelude) {
      float e[4];
      ClSpec<En>::energy(B, d, V, X.lo + i, q, e);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) part[0][cc] += e[cc];
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) part[1][cc] = fmaf(vi[cc], vi[cc], part[1][cc]);
  }
  cl_sums<3>(part, s, X, cbuf);
}

// -- the nets ------------------------------------------------------------------------

// A net's weights as this CTA reads them: the first layer's rows and the
// heads' columns of its own sites (staged in shared memory, or in global
// memory at the range's offset), site index local; wh, bh, te global.
struct ClNet {
  const float *w1, *w2;      // [i][H]
  const float *ws, *wt, *wq; // [k][ld]
  const float *bs, *ls, *bt, *bq, *lq;
  const float *wh, *bh, *te;
  int ld;
};
static_assert(2 * sizeof(ClNet) == kClStaticSmem, "the kernel's static shared memory");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src));
}

// The CTA's slice of net g, its parts in `staged` staged at p
// (cl_net_staged_floats), the others read in global memory: the copies are
// issued here, and the caller waits for them.
__device__ inline ClNet cl_net(const Net& g, Dims d, const ClCtx& X, float* p, int staged) {
  ClNet w;
  w.wh = g.wh;
  w.bh = g.bh;
  w.te = g.te;
  const int lo = X.lo, H = d.H, H2 = d.H2, ch = X.chunk, n = X.n;
  if (staged & kStageRows) {
    float* w1 = p;
    float* w2 = w1 + ch * H;
    for (int e = threadIdx.x; e < n * H; e += kClThreads) {
      cp_async4(w1 + e, g.w1 + lo * H + e);
      cp_async4(w2 + e, g.w2 + lo * H + e);
    }
    w.w1 = w1;
    w.w2 = w2;
    p += 2 * ch * H;
  } else {
    w.w1 = g.w1 + lo * H;
    w.w2 = g.w2 + lo * H;
  }
  if (staged & kStageHeads) {
    float* hs = p;                 // ws | wt | wq, [k][chunk] each
    float* ps = hs + 3 * H2 * ch;  // bs | ls | bt | bq | lq, [chunk] each
    const float* heads[3] = {g.ws, g.wt, g.wq};
    for (int e = threadIdx.x; e < H2 * n; e += kClThreads) {
      const int k = e / n, i = e - k * n;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        cp_async4(hs + (a * H2 + k) * ch + i, heads[a] + k * d.D + lo + i);
    }
    const float* sites[5] = {g.bs, g.ls, g.bt, g.bq, g.lq};
    for (int e = threadIdx.x; e < n; e += kClThreads) {
#pragma unroll
      for (int a = 0; a < 5; ++a) cp_async4(ps + a * ch + e, sites[a] + lo + e);
    }
    w.ws = hs;
    w.wt = hs + H2 * ch;
    w.wq = hs + 2 * H2 * ch;
    w.bs = ps;
    w.ls = ps + ch;
    w.bt = ps + 2 * ch;
    w.bq = ps + 3 * ch;
    w.lq = ps + 4 * ch;
    w.ld = ch;
  } else {
    w.ws = g.ws + lo;
    w.wt = g.wt + lo;
    w.wq = g.wq + lo;
    w.bs = g.bs + lo;
    w.ls = g.ls + lo;
    w.bt = g.bt + lo;
    w.bq = g.bq + lo;
    w.lq = g.lq + lo;
    w.ld = d.D;
  }
  return w;
}

// The sums of a[0 .. 4) over the S lanes that share a site (lanes per =
// 32 / S apart), scattered: lane ks = lane / per keeps the sums of entries
// ks (4 / S) .. (ks + 1) (4 / S) - 1 in a[0 .. 4 / S), by halving
// exchanges (xor 16, then 8), a fixed order.
__device__ __forceinline__ void cl_scatter4(float (&a)[4], int lane, int per) {
  if (per <= 16) {
    const bool up = lane & 16;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float keep = up ? a[t + 2] : a[t], send = up ? a[t] : a[t + 2];
      a[t] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  if (per <= 8) {
    const bool up = lane & 8;
    const float keep = up ? a[1] : a[0], send = up ? a[0] : a[1];
    a[0] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
}

// The two hidden layers of net w at inputs a, b ((chunk, cs) each, this
// CTA's sites) for the tile's chains, chain c at step t of its direction:
// the first layer summed over the cluster's sites, h (H, cs) and h2 (H2, cs)
// in every CTA, each layer stored as the next product reads it (rounded to
// TW).
template <class TW, int HM>
__device__ inline void cl_hidden(const ClNet& w, Dims d, const ClCtx& X, const float* a,
                                 const float* b, int t, const ClSmem& s, int& pbuf) {
  constexpr int C16 = kClChains, U = HM / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, H = d.H, C = X.cs;
  float acc[C16][U];
  int jj[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    jj[u] = min(lane + 32 * u, H - 1);
#pragma unroll
    for (int c = 0; c < C16; ++c) acc[c][u] = 0.f;
  }
  if constexpr (HM == WideLanes::HM) {
    // a ring of the next kPre sites' rows in flight over the current site's
    // FMAs (64 units: the ring's 4 x 2 x 2 registers fit beside the sums)
    constexpr int kPre = 4;
    float wr[kPre][2][U];
    auto load = [&](int i, float (&p)[2][U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u > 0 && H <= 32 * u) break;  // the same in every lane
        p[0][u] = w.w1[i * H + jj[u]];
        p[1][u] = w.w2[i * H + jj[u]];
      }
    };
#pragma unroll
    for (int p = 0; p < kPre; ++p)
      if (warp + p * kClWarps < X.n) load(warp + p * kClWarps, wr[p]);
    for (int base = warp; base < X.n; base += kPre * kClWarps) {
#pragma unroll
      for (int p = 0; p < kPre; ++p) {
        const int i = base + p * kClWarps;
        if (i >= X.n) break;
#pragma unroll
        for (int qq = 0; qq < kClQuads; ++qq) {
          if (qq >= X.nq) break;  // the same in every thread
          float a4[4], b4[4];
          ld4(a + i * C + 4 * qq, a4);
          ld4(b + i * C + 4 * qq, b4);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            a4[cc] = rnd<TW>(a4[cc]);
            b4[cc] = rnd<TW>(b4[cc]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (u > 0 && H <= 32 * u) break;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              float& r = acc[4 * qq + cc][u];
              r = fmaf(wr[p][0][u], a4[cc], r);
              r = fmaf(wr[p][1][u], b4[cc], r);
            }
          }
        }
        if (i + kPre * kClWarps < X.n) load(i + kPre * kClWarps, wr[p]);
      }
    }
  } else {
    float w1c[U], w2c[U], w1n[U], w2n[U];
    auto load = [&](int i, float (&p1)[U], float (&p2)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u > 0 && H <= 32 * u) break;  // the same in every lane
        p1[u] = w.w1[i * H + jj[u]];
        p2[u] = w.w2[i * H + jj[u]];
      }
    };
    if (warp < X.n) load(warp, w1c, w2c);
    if (warp + kClWarps < X.n) load(warp + kClWarps, w1n, w2n);
    for (int i = warp; i < X.n; i += kClWarps) {
      // two sites' weights in flight over the FMAs (128 units: a deeper
      // ring spills)
      float w1f[U], w2f[U];
      if (i + 2 * kClWarps < X.n) load(i + 2 * kClWarps, w1f, w2f);
#pragma unroll
      for (int qq = 0; qq < kClQuads; ++qq) {
        if (qq >= X.nq) break;  // the same in every thread
        float a4[4], b4[4];
        ld4(a + i * C + 4 * qq, a4);
        ld4(b + i * C + 4 * qq, b4);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          a4[cc] = rnd<TW>(a4[cc]);
          b4[cc] = rnd<TW>(b4[cc]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u > 0 && H <= 32 * u) break;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float& r = acc[4 * qq + cc][u];
            r = fmaf(w1c[u], a4[cc], r);
            r = fmaf(w2c[u], b4[cc], r);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        w1c[u] = w1n[u];
        w2c[u] = w2n[u];
        w1n[u] = w1f[u];
        w2n[u] = w2f[u];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lane + 32 * u;
    if (j < H) {
#pragma unroll
      for (int c = 0; c < C16; ++c)
        if (c < C) s.red[(warp * C + c) * H + j] = acc[c][u];
    }
  }
  __syncthreads();
  if (X.G == 1) {
    // the warps' partials in warp order, the time column, the ReLU
    for (int p = threadIdx.x; p < C * H; p += kClThreads) {
      const int c = p / H, j = p - c * H;
      const int step = s.rev[c] ? d.T - 1 - t : t;
      float v = 0.f;
      for (int wv = 0; wv < kClWarps; ++wv) v += s.red[wv * C * H + p];
      s.h[j * C + c] = rnd<TW>(fmaxf(v + w.te[j * d.T + step], 0.f));
    }
  } else {
    // this CTA's partial row: its warps in order; then the ranks' rows in
    // rank order, the time column, the ReLU
    float* const part = s.part + pbuf * C * H;
    for (int p = threadIdx.x; p < C * H; p += kClThreads) {
      float v = 0.f;
      for (int wv = 0; wv < kClWarps; ++wv) v += s.red[wv * C * H + p];
      part[p] = v;
    }
    cl_sync(X);
    for (int p = threadIdx.x; p < C * H; p += kClThreads) {
      const int c = p / H, j = p - c * H;
      const int step = s.rev[c] ? d.T - 1 - t : t;
      const float v = cl_rank_sum(part, X, p);
      s.h[j * C + c] = rnd<TW>(fmaxf(v + w.te[j * d.T + step], 0.f));
    }
    pbuf ^= 1;
  }
  __syncthreads();
  // the second layer: a thread a unit k and 4 chains (its warp's quad), the
  // sum over j split among S lanes where H2 is narrow
  int S = 1;
  while (S < 4 && (kClThreads >> (X.qsh + 1)) / S >= d.H2) S *= 2;
  const int per = 32 / S, js = lane / per, qq = warp & (X.nq - 1);
  const int kslot = lane % per + per * (warp >> X.qsh), pass = per * (kClWarps >> X.qsh);
  const int rounds = (d.H2 + pass - 1) / pass;
  for (int r = 0; r < rounds; ++r) {
    const int k = kslot + r * pass;
    const bool on = k < d.H2;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (on) {
#pragma unroll 4
      for (int j = js; j < H; j += S) {
        const float wv = w.wh[j * d.H2 + k];
        float h4[4];
        ld4(s.h + j * C + 4 * qq, h4);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) o[cc] = fmaf(wv, h4[cc], o[cc]);
      }
    }
    cl_scatter4(o, lane, per);  // this lane's chains 4 qq + js M + m, m < M = 4 / S
    if (on) {
      const float bk = w.bh[k];
      const int M = 4 / S;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (m < M) s.h2[k * C + 4 * qq + js * M + m] = rnd<TW>(fmaxf(o[m] + bk, 0.f));
    }
  }
  __syncthreads();
}

// The state arrays an application reads and writes ((chunk, cs) each), as
// SiteIO.
struct ClIO {
  const float* x;
  float* xo;
  const float* v;
  float* vo;
  const float* g;
  float* gn;
};

// The heads of net w on this CTA's sites for the tile's chains, and the
// update of application APP of the substep (site_heads' expressions): a
// thread a site and chains 4q .. 4q + 3 (cl_quad), a warp 32 / S
// consecutive sites. Where a range has few sites, S lanes share a site: each
// sums every S-th unit k, their sums are added by a reduce-scatter
// (cl_scatter4), and lane ks updates chains 4q + ks M .. 4q + ks M + M - 1,
// M = 4 / S. The log-det increments go into ld. The application is a
// run-time value (the same in every thread), so that the substep's four
// applications run one copy of the code.
__device__ inline void cl_heads(int app, const Block& B, const ClNet& w, Dims d, bool hmc,
                                const ClCtx& X, int t, const ClSmem& s, const ClIO& io,
                                float (&ld)[4]) {
  const int lane = threadIdx.x & 31, q = cl_quad(X), C = X.cs;
  int S = 1;
  while (S < 4 && (kClThreads >> (X.qsh + 1)) / S >= X.n) S *= 2;
  const int per = 32 / S, ks = lane / per, M = 4 / S;
  const int slot = lane % per + per * (threadIdx.x >> (5 + X.qsh));
  const int pass = per * (kClWarps >> X.qsh), rounds = (X.n + pass - 1) / pass;
  for (int r = 0; r < rounds; ++r) {
    const int i = slot + r * pass;
    const bool on = i < X.n;
    float as[4] = {0.f, 0.f, 0.f, 0.f}, at[4] = {0.f, 0.f, 0.f, 0.f},
          aq[4] = {0.f, 0.f, 0.f, 0.f};
    if (!hmc) {
      if (on) {
#pragma unroll 8
        for (int k = ks; k < d.H2; k += S) {
          const float ws = w.ws[k * w.ld + i], wt = w.wt[k * w.ld + i],
                      wq = w.wq[k * w.ld + i];
          float hk[4];
          ld4(s.h2 + k * C + 4 * q, hk);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            as[cc] = fmaf(ws, hk[cc], as[cc]);
            at[cc] = fmaf(wt, hk[cc], at[cc]);
            aq[cc] = fmaf(wq, hk[cc], aq[cc]);
          }
        }
      }
      cl_scatter4(as, lane, per);
      cl_scatter4(at, lane, per);
      cl_scatter4(aq, lane, per);
    }
    if (!on) continue;
    float es = 0.f, eq = 0.f, bs = 0.f, bt = 0.f, bq = 0.f;
    if (!hmc) {
      es = expf(w.ls[i]);
      eq = expf(w.lq[i]);
      bs = w.bs[i];
      bt = w.bt[i];
      bq = w.bq[i];
    }
    const int gi = X.lo + i;
    const float e = B.eps[gi], h = 0.5f * e;
    float inc_m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= M) break;  // the same in every lane
      const int cc = ks * M + m, c = 4 * q + cc;
      const bool rev = s.rev[c] != 0;
      const int step = rev ? d.T - 1 - t : t;
      float sv = 0.f, tv = 0.f, qv = 0.f;
      if (!hmc) {
        sv = es * tanhf(as[m] + bs);
        tv = at[m] + bt;
        qv = eq * tanhf(aq[m] + bq);
      }
      const float mk = B.masks[gi * d.T + step], mb = 1.f - mk;
      const float Q = expf(e * qv);
      const int o = i * C + c;
      if (app == 1 || app == 4) {
        const float g = io.g[o], vi = io.v[o];
        float vn, inc;
        if (!rev) {
          inc = h * sv;
          vn = vi * expf(inc) + h * (-Q * g + tv);
        } else {
          inc = -h * sv;
          vn = (vi - h * (-Q * g + tv)) * expf(inc);
        }
        inc_m[m] = inc;
        io.vo[o] = vn;
        if (app == 1) io.gn[o] = (rev ? mb : mk) * io.x[o];
      } else {
        const float keep = (app == 2) == !rev ? mk : mb;
        const float move = 1.f - keep;
        const float xi = io.x[o], vh = io.v[o];
        float xn, inc;
        if (!rev) {
          inc = e * sv;
          xn = keep * xi + move * (xi * expf(inc) + e * (Q * vh + tv));
        } else {
          inc = -e * sv;
          xn = keep * xi + move * expf(inc) * (xi - e * (Q * vh + tv));
        }
        inc_m[m] = move * inc;
        io.xo[o] = xn;
        if (app == 2) io.gn[o] = move * xn;
      }
    }
    // into this thread's log-det sums (fixed registers, no local memory)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (m < M && cc == ks * M + m) ld[cc] += inc_m[m];
    }
  }
  __syncthreads();
}

// One augmented leapfrog substep (site_traj_step's four applications and
// gradient) in place on the tile's (x', v) over the cluster; on entry s.g
// holds grad E(x') on this CTA's sites, on return that of the new x'. The
// applications run vnet, xnet, xnet, vnet as a loop over one copy of the
// code; nets[0] is the xnet's slice, nets[1] the vnet's (in shared memory).
template <class En, int HM, class TW>
__device__ inline void cl_traj_step(const Block& B, const ClNet* nets, Dims d, bool hmc,
                                    const ClCtx& X, int t, const ClSmem& s, float (&ld)[4],
                                    int& pbuf, int& cbuf) {
  const ClIO io{s.xp, s.xp, s.v, s.v, s.g, s.g};
#pragma unroll 1
  for (int app = 1; app <= 4; ++app) {
    const bool vnet = app == 1 || app == 4;
    if (app == 4) cl_grad<En>(B, d, hmc, X, s, cbuf);
    const ClNet& w = nets[vnet ? 1 : 0];
    if (!hmc) cl_hidden<TW, HM>(w, d, X, vnet ? s.xp : s.v, s.g, t, s, pbuf);
    cl_heads(app, B, w, d, hmc, X, t, s, io, ld);
  }
}

// A tile's chain energy after cl_hamiltonian: the site sums, or the
// prelude's whole-chain energy.
template <class En>
__device__ inline float cl_energy(Dims d, const ClSmem& s, int c) {
  if constexpr (En::kPrelude)
    return En::chain_energy(d, s.pre + c * site_pre_floats(d, En::kKind));
  else
    return s.tot[c];
}

// xs: the accepted states' scratch, (gridDim.x chunk chains) floats, where
// the plan keeps them out of shared memory (else unused).
template <class En, int HM, class TW>
__global__ void __launch_bounds__(kClThreads, 1) site_cluster_chain_kernel(
    const float* __restrict__ params, Dims d, int hmc, ClPlan plan,
    const float* __restrict__ xin, float* __restrict__ xo, float* __restrict__ acc_out,
    float* __restrict__ trace, float* __restrict__ xs, int N, int K, uint2 key) {
  constexpr int C16 = kClChains;  // the stride of the sums' totals
  const int C = plan.chains;
  extern __shared__ float4 smem4[];
  const Block B = block_at(params, d);
  ClCtx X;
  X.G = plan.G;
  X.rank = plan.G == 1 ? 0 : static_cast<int>(cg::this_cluster().block_rank());
  X.chunk = plan.chunk;
  X.D = d.D;
  X.lo = min(X.rank * X.chunk, d.D);
  X.n = min(X.lo + X.chunk, d.D) - X.lo;
  X.cs = C;
  X.nq = C / 4;
  X.qsh = X.nq == 1 ? 0 : X.nq == 2 ? 1 : 2;
  const int P = site_pre_floats(d, En::kKind);
  const ClSmem s = cl_smem(reinterpret_cast<float*>(smem4), d, plan, P);
  float* const x =
      plan.x_smem ? s.x : xs + static_cast<size_t>(blockIdx.x) * X.chunk * C;
  __shared__ ClNet nets[2];  // the xnet's and the vnet's slices
  {
    const ClNet xn = cl_net(B.xnet, d, X, s.w, plan.staged);
    const ClNet vn = cl_net(B.vnet, d, X, s.w + cl_net_staged_floats(d, X.chunk, plan.staged),
                            plan.staged);
    if (threadIdx.x == 0) {
      nets[0] = xn;
      nets[1] = vn;
    }
  }
  if (plan.staged) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  const int tile = blockIdx.x / X.G;
  const size_t sN = static_cast<size_t>(N);
  auto chain_of = [&](int c) { return min(tile * C + c, N - 1); };  // past N: the last
  auto live = [&](int c) { return tile * C + c < N; };
  const int own = X.n * C;
  // device memory holds (D, N): the tile's chains are adjacent there, so the
  // threads take (site, chain) pairs chain-fastest
  for (int p = threadIdx.x; p < own; p += kClThreads) {
    const int c = p % C, i = p / C;
    x[p] = xin[(X.lo + i) * sN + chain_of(c)];
  }
  float accepted = 0.f, h0 = 0.f;  // threads c < C: chain c's
  const bool hmcb = hmc != 0;
  int pbuf = 0, cbuf = 0;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    if (threadIdx.x < C) {
      const uint4 r0 = philox4x32_10(
          make_uint4(static_cast<uint32_t>(chain_of(threadIdx.x)), static_cast<uint32_t>(k),
                     0u, 0u),
          key);
      s.rev[threadIdx.x] = !(uniform24(r0.x) < 0.5f);
      s.u[threadIdx.x] = uniform24(r0.y);
    }
    // the normals of the pairs whose first site is this CTA's (lo is even)
    const int j0 = X.lo / 2, pairs = (X.n + 1) / 2;
    for (int p = threadIdx.x; p < pairs * C; p += kClThreads) {
      const int c = p % C, j = j0 + p / C;
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(chain_of(c)), static_cast<uint32_t>(k),
                     static_cast<uint32_t>(1 + j), 0u),
          key);
      s.v[(2 * j - X.lo) * C + c] = box_muller(r.x, r.y);
      if (2 * j + 1 < X.lo + X.n) s.v[(2 * j + 1 - X.lo) * C + c] = box_muller(r.z, r.w);
    }
    for (int p = threadIdx.x; p < own; p += kClThreads) s.xp[p] = x[p];
    __syncthreads();

    // H(x, v) of each chain, on x' = x
    float ld[4] = {0.f, 0.f, 0.f, 0.f};
    cl_hamiltonian<En>(B, d, X, s, ld, cbuf);
    if (threadIdx.x < C)
      h0 = cl_energy<En>(d, s, threadIdx.x) + 0.5f * s.tot[C16 + threadIdx.x];

    cl_grad<En>(B, d, hmcb, X, s, cbuf);
    for (int t = 0; t < d.T; ++t)
      cl_traj_step<En, HM, TW>(B, nets, d, hmcb, X, t, s, ld, pbuf, cbuf);

    // H(x', v') and the log-det, then the accept: alike in every CTA
    cl_hamiltonian<En>(B, d, X, s, ld, cbuf);
    if (threadIdx.x < C) {
      const int c = threadIdx.x;
      const float h1 = cl_energy<En>(d, s, c) + 0.5f * s.tot[C16 + c];
      // exp(min(a, 0)) with NaN kept NaN, then the NaN guard maps it to 0
      const float a = h0 - h1 + s.tot[2 * C16 + c];
      float px = expf(a > 0.f ? 0.f : a);
      if (!isfinite(px)) px = 0.f;
      const bool acc = px - s.u[c] >= 0.f;
      s.acc[c] = acc ? 1.f : 0.f;
      if (acc) accepted += 1.f;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < own; p += kClThreads) {
      const int c = p % C, i = p / C;
      if (s.acc[c] != 0.f) x[p] = s.xp[p];
      if (trace != nullptr && live(c))
        trace[(static_cast<size_t>(k) * d.D + X.lo + i) * sN + chain_of(c)] = x[p];
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < own; p += kClThreads) {
    const int c = p % C, i = p / C;
    if (live(c)) xo[(X.lo + i) * sN + chain_of(c)] = x[p];
  }
  if (X.rank == 0 && threadIdx.x < C && live(threadIdx.x))
    acc_out[chain_of(threadIdx.x)] = accepted * (1.0f / static_cast<float>(K));
  // no CTA leaves while another may still read its shared memory
  if (X.G > 1) cg::this_cluster().sync();
}

// How many clusters of G CTAs the card holds at once for `kernel` with the
// most shared memory a candidate launch at G takes (of the tile widths),
// into at_once[G] for G = 1 .. kClMaxG (0 where no candidate has G ranks
// whose state fits); a negative CUDA error code if a query fails.
template <class Kernel>
static int cl_capacities(Kernel kernel, Dims d, int kind, int* at_once) {
  const int P = site_pre_floats(d, kind), unit = cl_unit(d.D, kind);
  at_once[0] = 0;
  for (int G = 1; G <= kClMaxG; ++G) {
    int floats = 0;  // the most any tile width's launch at G takes
    for (int C = kClChains; C >= 4; C /= 2) {
      const ClPlan p = cl_candidate(d, P, C, G, unit);
      if (p.G == G && cl_state_fits(d, P, C, p.chunk) && p.smem_floats > floats)
        floats = p.smem_floats;
    }
    at_once[G] = 0;
    if (floats == 0) continue;
    const int n = max_clusters(kernel, G, kClThreads, static_cast<size_t>(floats) * sizeof(float));
    if (n < 0) return n;
    at_once[G] = n;
  }
  return 0;
}

// The launch's plan on this card (cl_plan at the card's capacities), and
// how many of its clusters the card holds at once; a CUDA error code, 0 on
// success.
template <class En, int HM, class TW>
static int cl_plan_on_card(Dims d, int N, ClPlan* plan, int* clusters) {
  auto* kernel = &site_cluster_chain_kernel<En, HM, TW>;
  int at_once[kClMaxG + 1];
  const int e = cl_capacities(kernel, d, En::kKind, at_once);
  if (e < 0) return -e;
  *plan = cl_plan(d, En::kKind, N, at_once);
  const int n = max_clusters(kernel, plan->G, kClThreads,
                             static_cast<size_t>(plan->smem_floats) * sizeof(float));
  if (n < 0) return -n;
  *clusters = n;
  return 0;
}

template <class En, int HM, class TW>
static int launch_cluster_chain_hm(const float* params, Dims d, int hmc, const float* x,
                                   float* xo, float* acc, float* trace, float* xs, int N,
                                   int K, uint2 key, cudaStream_t stream) {
  ClPlan p;
  int at_once = 0;
  const int e = cl_plan_on_card<En, HM, TW>(d, N, &p, &at_once);
  if (e != 0) return e;
  if (!cl_state_fits(d, site_pre_floats(d, En::kKind), p.chains, p.chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (at_once < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // no fallback
  if (!p.x_smem && xs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + p.chains - 1) / p.chains;
  return static_cast<int>(launch_clusters(&site_cluster_chain_kernel<En, HM, TW>, p.G, tiles,
                                          kClThreads,
                                          static_cast<size_t>(p.smem_floats) * sizeof(float),
                                          stream, params, d, hmc, p, x, xo, acc, trace, xs, N,
                                          K, key));
}

// The launch of chain.cu's site-parallel configuration: every spec, HM from
// the widths, the plan the host rule takes on this card; xs may be null
// where the plan keeps the accepted states in shared memory.
template <class En, class TW>
static int launch_cluster_chain(const float* params, Dims d, int hmc, const float* x,
                                float* xo, float* acc, float* trace, float* xs, int N, int K,
                                uint2 key, cudaStream_t stream) {
  if (site_hm(d) == WideLanes::HM)
    return launch_cluster_chain_hm<En, WideLanes::HM, TW>(params, d, hmc, x, xo, acc, trace,
                                                          xs, N, K, key, stream);
  return launch_cluster_chain_hm<En, kSiteMaxHidden, TW>(params, d, hmc, x, xo, acc, trace, xs,
                                                         N, K, key, stream);
}

// The plan chain.cu's float32 launch takes at these widths and N chains on
// this card, and how many of its clusters the card holds at once; a CUDA
// error code, 0 on success.
template <class En>
static int cluster_chain_plan(Dims d, int N, ClPlan* plan, int* clusters) {
  if (site_hm(d) == WideLanes::HM)
    return cl_plan_on_card<En, WideLanes::HM, float>(d, N, plan, clusters);
  return cl_plan_on_card<En, kSiteMaxHidden, float>(d, N, plan, clusters);
}

// The clusters of each size the card holds at once for that launch's kernel
// (cl_capacities).
template <class En>
static int cluster_chain_capacities(Dims d, int* at_once) {
  const int e = site_hm(d) == WideLanes::HM
                    ? cl_capacities(&site_cluster_chain_kernel<En, WideLanes::HM, float>, d,
                                    En::kKind, at_once)
                    : cl_capacities(&site_cluster_chain_kernel<En, kSiteMaxHidden, float>, d,
                                    En::kKind, at_once);
  return e < 0 ? -e : 0;
}

}  // namespace l2hmc
