// The chain kernel's site-parallel configuration (chain.cu), for states or
// S/T/Q nets wider than a lane group holds: D <= kSiteMaxDim (4096, the
// 64 x 64 phi^4 lattice) and hidden widths H, H2 <= kSiteMaxHidden (128,
// the suite's ill-conditioned Gaussian at hidden 100), past WideLanes'
// D, H, H2 <= 64; and the phi^4 lattice at every width up to that
// (site_chain).
//
// Replaces, with chain.cu, the Pallas kernel _make_chain_kernel /
// FusedChainSampler (l2hmc_tpu/ops/fused_dynamics.py:1103, pallas_call at
// :1350) at the phi^4 eval's widths (D = 256, 1024 and 4096) and at hidden
// widths past 64. At dim >= 2048 the JAX sampler builds that kernel with
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
// chains for all K MH steps. The proposal x', the momentum and the
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
// or bf16 wgmma weights over a chain tile.
//
// The energy, the kinetic energy and the log-det are per-thread partial
// sums, reduced by a warp tree (lane 0's order) and then over warps in
// order: no atomics, and a launch repeats bit for bit. These sums cannot
// equal the plain version's torch.sum bit for bit; the comparisons state
// their tolerance.
//
// A substep's four applications run vnet, xnet, xnet, vnet in both
// directions; only the masks' roles, the update formulas and the step
// index differ, so the chains of a tile, each with its own direction, run
// the same sequence of phases and branch only inside a chain's update. The
// gradient at the substep's end is the next substep's first, so it is
// computed once.
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

// Floats of dynamic shared memory a block uses at state width D with
// buffers of HM hidden units: at D = 4096, 49,152 for x', v, g and 2,668
// (HM = 64) or 5,228 (HM = 128) for the rest, 207,280 and 217,520 bytes of
// the 232,448 a block may use.
__host__ __device__ inline int site_smem_floats(int D, int HM) {
  const int C = kSiteChains;
  return 3 * C * D + kSiteWarps * C * HM + 2 * C * HM + kSiteWarps * 3 * C +
         3 * C;
}

template <int HM>
struct SiteSmem {
  float *xp, *v, *g;  // (C, D) each: proposal, momentum, gradient
  float *red;         // (warps, C, HM): the first layer's partial sums
  float *h, *h2;      // (C, HM): the two hidden layers
  float *sred, *tot;  // (warps, 3C), (3C): the chains' sums
};

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
  return s;
}

// Block-wide sums of each thread's V values into s.tot, in a fixed order: a
// warp's lanes by a butterfly (lane 0's result), then the warps in order.
// Every thread calls it; it synchronises.
template <int V, int HM>
__device__ inline void site_sums(float (&v)[V], const SiteSmem<HM>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float a = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) s.sred[warp * V + k] = a;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float t = 0.f;
    for (int w = 0; w < kSiteWarps; ++w) t += s.sred[w * V + threadIdx.x];
    s.tot[threadIdx.x] = t;
  }
  __syncthreads();
}

// The two hidden layers of net w at inputs a, b ((C, D) in shared memory)
// for the tile's chains, chain c at its own step: h2 into s.h2, each layer
// stored as the next product reads it (rounded to TW).
template <class TW, int HM>
__device__ inline void site_hidden(const Net& w, Dims d, const float* a,
                                   const float* b,
                                   const int (&step)[kSiteChains],
                                   const SiteSmem<HM>& s) {
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
      for (int c = 0; c < C; ++c) s.red[(warp * C + c) * HM + j] = acc[c][u];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < C * d.H; p += kSiteThreads) {
    const int c = p / d.H, j = p - c * d.H;
    float t = 0.f;
    for (int wv = 0; wv < kSiteWarps; ++wv) t += s.red[(wv * C + c) * HM + j];
    s.h[c * HM + j] = rnd<TW>(fmaxf(t + w.te[j * d.T + step[c]], 0.f));
  }
  __syncthreads();
  for (int p = threadIdx.x; p < C * d.H2; p += kSiteThreads) {
    const int c = p / d.H2, k = p - c * d.H2;
    float t = 0.f;
    for (int j = 0; j < d.H; ++j) t = fmaf(w.wh[j * d.H2 + k], s.h[c * HM + j], t);
    s.h2[c * HM + k] = rnd<TW>(fmaxf(t + w.bh[k], 0.f));
  }
  __syncthreads();
}

// The heads of net w on this thread's sites, for the tile's chains, and the
// update of application APP of the substep (_trajectory_step's expressions,
// ops/fused_dynamics.py), in place in shared memory:
//   1  vnet at (x', g): v <- v half-step;  g <- the first xnet's input
//   2  xnet at (v, g):  x' <- y;            g <- the second xnet's input
//   3  xnet at (v, g):  x' <- the new x
//   4  vnet at (x', g): v <- the second v half-step
// where the first xnet's input is m x (forward) or (1 - m) x (reverse) and
// the second's the other half of y. The log-det increments go to ld.
template <int APP, int HM>
__device__ inline void site_heads(const Block& B, const Net& w, Dims d,
                                  bool hmc, const bool (&rev)[kSiteChains],
                                  const int (&step)[kSiteChains],
                                  const SiteSmem<HM>& s,
                                  float (&ld)[kSiteChains]) {
  constexpr int C = kSiteChains;
  for (int i = threadIdx.x; i < d.D; i += kSiteThreads) {
    float as[C], at[C], aq[C];
#pragma unroll
    for (int c = 0; c < C; ++c) as[c] = at[c] = aq[c] = 0.f;
    if (!hmc) {
      for (int k = 0; k < d.H2; ++k) {
        const float ws = w.ws[k * d.D + i], wt = w.wt[k * d.D + i],
                    wq = w.wq[k * d.D + i];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float hk = s.h2[c * HM + k];
          as[c] = fmaf(ws, hk, as[c]);
          at[c] = fmaf(wt, hk, at[c]);
          aq[c] = fmaf(wq, hk, aq[c]);
        }
      }
    }
    const float e = B.eps[i], h = 0.5f * e;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float sv = 0.f, tv = 0.f, qv = 0.f;
      if (!hmc) {
        sv = expf(w.ls[i]) * tanhf(as[c] + w.bs[i]);
        tv = at[c] + w.bt[i];
        qv = expf(w.lq[i]) * tanhf(aq[c] + w.bq[i]);
      }
      const float m = B.masks[i * d.T + step[c]], mb = 1.f - m;
      const float Q = expf(e * qv);
      const int o = c * d.D + i;
      if (APP == 1 || APP == 4) {
        const float g = s.g[o], vi = s.v[o];
        float vn, inc;
        if (!rev[c]) {
          inc = h * sv;
          vn = vi * expf(inc) + h * (-Q * g + tv);
        } else {
          inc = -h * sv;
          vn = (vi - h * (-Q * g + tv)) * expf(inc);
        }
        ld[c] += inc;
        s.v[o] = vn;
        if (APP == 1) s.g[o] = (rev[c] ? mb : m) * s.xp[o];
      } else {
        // APP 2 keeps the half kA = m (forward) or 1 - m (reverse) of x and
        // moves the other; APP 3 keeps the other half of y
        const float keep = (APP == 2) == !rev[c] ? m : mb;
        const float move = 1.f - keep;
        const float xi = s.xp[o], vh = s.v[o];
        float xn, inc;
        if (!rev[c]) {
          inc = e * sv;
          xn = keep * xi + move * (xi * expf(inc) + e * (Q * vh + tv));
        } else {
          inc = -e * sv;
          xn = keep * xi + move * expf(inc) * (xi - e * (Q * vh + tv));
        }
        ld[c] += move * inc;
        s.xp[o] = xn;
        if (APP == 2) s.g[o] = move * xn;
      }
    }
  }
  __syncthreads();
}

// g <- grad E(x') for the tile's chains.
template <class En, int HM>
__device__ inline void site_grad(const Block& B, Dims d, const SiteSmem<HM>& s) {
  for (int c = 0; c < kSiteChains; ++c)
    for (int i = threadIdx.x; i < d.D; i += kSiteThreads)
      s.g[c * d.D + i] = En::grad_at(B.c, d.D, s.xp + c * d.D, i);
  __syncthreads();
}

// This thread's partial sums of E(x') and of v . v for each chain into
// part[c], part[C + c], and ld into part[2C + c].
template <class En, int HM>
__device__ inline void site_hamiltonian_parts(const Block& B, Dims d,
                                              const SiteSmem<HM>& s,
                                              const float (&ld)[kSiteChains],
                                              float (&part)[3 * kSiteChains]) {
  constexpr int C = kSiteChains;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float en = 0.f, kin = 0.f;
    for (int i = threadIdx.x; i < d.D; i += kSiteThreads) {
      const float vi = s.v[c * d.D + i];
      en += En::energy_at(B.c, d.D, s.xp + c * d.D, i);
      kin = fmaf(vi, vi, kin);
    }
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
    site_sums(part, s);
    float h0[C];
#pragma unroll
    for (int c = 0; c < C; ++c) h0[c] = s.tot[c] + 0.5f * s.tot[C + c];

    site_grad<En>(B, d, s);
    for (int t = 0; t < d.T; ++t) {
      int step[C];
#pragma unroll
      for (int c = 0; c < C; ++c) step[c] = rev[c] ? d.T - 1 - t : t;
      if (!hmc) site_hidden<TW>(B.vnet, d, s.xp, s.g, step, s);
      site_heads<1>(B, B.vnet, d, hmc, rev, step, s, ld);
      if (!hmc) site_hidden<TW>(B.xnet, d, s.v, s.g, step, s);
      site_heads<2>(B, B.xnet, d, hmc, rev, step, s, ld);
      if (!hmc) site_hidden<TW>(B.xnet, d, s.v, s.g, step, s);
      site_heads<3>(B, B.xnet, d, hmc, rev, step, s, ld);
      site_grad<En>(B, d, s);
      if (!hmc) site_hidden<TW>(B.vnet, d, s.xp, s.g, step, s);
      site_heads<4>(B, B.vnet, d, hmc, rev, step, s, ld);
    }

    // H(x', v') and the log-det, then the accept: the same in every thread
    site_hamiltonian_parts<En>(B, d, s, ld, part);
    site_sums(part, s);
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

// Whether the chain kernel runs these widths and spec on the site-parallel
// configuration: past WideLanes' widths, and phi^4 wherever a configuration
// serves its widths. At L = 8 (D = 64) the lane form, the stencil on every
// lane's copy of the lattice in local memory, ran 512 chains x 1000 traced
// MH steps in 3746 ms on an H100; chip_smoke.py times this form there.
inline bool site_chain(Dims d, int kind) {
  const int p = pick_lanes(d);
  return p == 3 || (p == 2 && kind == Phi4::kKind);
}

// Calls f(En{}) with the spec of `kind` among those the site-parallel
// configuration takes (Gauss, Phi4); cudaErrorInvalidValue for
// another kind or constants that do not fit it.
template <class F>
inline int with_site_energy(Dims d, int kind, F&& f) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case Gauss::kKind:
      return Gauss::fits(d) ? f(Gauss{}) : bad;
    case Phi4::kKind:
      return Phi4::fits(d) ? f(Phi4{}) : bad;
    default:
      return bad;
  }
}

template <class En, int HM, class TW>
static int launch_site_chain_hm(const float* params, Dims d, int hmc,
                                const float* x, float* xo, float* acc,
                                float* trace, float* xs, int N, int K,
                                uint2 key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(site_smem_floats(d.D, HM)) * sizeof(float);
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
