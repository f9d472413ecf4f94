// K Metropolis-Hastings steps of the L2HMC sampler on the VAE posterior
// U(z | x) = BCE(decoder(z), x) + 0.5 |z|^2 in one launch: momentum draw,
// direction pick, T augmented leapfrog steps with the decoder gradient and
// the aux-conditioned S/T/Q nets computed in the kernel, decoder energy,
// accept; optionally the post-step state of every recorded step as a
// (K, D, N) trace, and 1..max op compositions per recorded step from a
// host-made sequence nb (K,).
//
// Replaces the Pallas kernel _make_vae_chain_kernel / FusedVaeSampler
// (l2hmc_tpu/ops/fused_dynamics.py:1399, pallas_call at :2051).
//
// Bound on the card: operations. One MH op of one chain is T decoder
// gradients (six products at width 1024, 7.6 MFLOP each) and 4 T net
// applications; device memory sees the start state, the pixels and the
// embedding once and, with a trace, D * 4 bytes per chain and step. The
// weights are read from the L2 once per product and block. What the design
// does about it (see vae_common.cuh for the block-wide product): a tile of
// C chains per block with C = 4 or 8, so that the few hundred chains of the
// evaluation protocol spread over 50 or more SMs while each weight read
// still feeds C multiply-adds.
//
// Differences from the TPU kernel, by design:
//  - Random numbers are Philox4x32-10 keyed by the 64-bit seed, counter
//    (global chain, recorded step, slot, inner op): the draws do not depend
//    on C, and ops/philox.py reproduces them bit for bit.
//  - Only the direction the uniform picks runs, chain by chain: the chains
//    of a tile share every product, and the direction enters only through
//    the step index (time embedding, mask) and the elementwise update.
//    Direction and accept are selects, so a non-finite unchosen or rejected
//    value cannot leak into the state.
//  - nb is the same for every chain of a step, so the kernel runs nb ops
//    and skips the dead ones; the TPU kernel runs max ops and masks.
//  - The gradient at the end of one leapfrog step is the gradient at the
//    start of the next (the same point), and the energy comes out of the
//    gradient's forward sweep, so one MH op costs T decoder sweeps where
//    the TPU kernel makes 2 T gradients and two energies. On acceptance the
//    proposal's last gradient and energy become the next op's first.
//  - The trace goes straight to device memory.
#include "vae_common.cuh"

namespace l2hmc {
namespace vae {

struct ChainArgs {
  Dims d;
  Decoder dec;
  Net xnet, vnet;
  const float* eps;    // (D)
  const float* masks;  // (D, T)
  const float* xraw;   // (P, N)
  const float* emb;    // (H, N)
  const float* zin;    // (D, N)
  const int* nb;       // (K) ops per recorded step, or null for 1
  float* zo;           // (D, N)
  float* acc;          // (N)
  float* trace;        // (K, D, N) or null
  int N, K;
  uint2 key;
};

template <int C>
__host__ __device__ inline int chain_floats(const Dims& d) {
  // Work, ten [D][C] arrays, six [C] arrays (two of them int)
  return work_floats<C>(d) + C * (10 * d.D + 6);
}

template <int C>
__global__ void __launch_bounds__(kThreads) vae_chain_kernel(ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  const Dims d = a.d;
  const int DC = d.D * C;
  const Work<C> work = carve_work<C>(p, d);
  float* z = p; p += DC;     // state
  float* v = p; p += DC;     // momentum
  float* g = p; p += DC;     // gradient at z
  float* zs = p; p += DC;    // state at the start of the op
  float* gs = p; p += DC;    // gradient at zs
  float* S = p; p += DC;
  float* Tt = p; p += DC;
  float* Q = p; p += DC;
  float* bin = p; p += DC;   // the x-net's masked second input
  float* ldp = p; p += DC;   // log-det contributions, summed at the accept
  float* e_cur = p; p += C;  // decoder energy at z
  float* e_start = p; p += C;
  float* u_dir = p; p += C;
  float* u_acc = p; p += C;
  int* step = reinterpret_cast<int*>(p); p += C;
  int* flag = reinterpret_cast<int*>(p); p += C;  // forward, then accepted

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * C;

  for (int e = tid; e < DC; e += kThreads) {
    const int i = e / C, n = n0 + e - i * C;
    z[e] = n < a.N ? a.zin[static_cast<size_t>(i) * a.N + n] : 0.f;
  }
  __syncthreads();
  decoder_grad<C>(d, a.dec, a.xraw, a.N, n0, z, gs, e_start, work);

  // v' = v exp(eps S / 2) + eps / 2 (-exp(eps Q) g + T), or its inverse;
  // also stages the x-net's second input for the position update after it
  auto momentum_update = [&]() {
    for (int e = tid; e < DC; e += kThreads) {
      const int i = e / C, c = e - i * C;
      const float ep = a.eps[i];
      const float drift = 0.5f * ep * (-expf(ep * Q[e]) * g[e] + Tt[e]);
      const float sv = 0.5f * ep * S[e];
      const float m = a.masks[i * d.T + step[c]];
      if (flag[c]) {
        v[e] = v[e] * expf(sv) + drift;
        ldp[e] += sv;
        bin[e] = m * z[e];
      } else {
        v[e] = (v[e] - drift) * expf(-sv);
        ldp[e] -= sv;
        bin[e] = (1.f - m) * z[e];
      }
    }
  };
  // the masked position update; the first of a step keeps the mask's
  // entries (forward) or its complement (reverse), the second the others
  auto position_update = [&](bool first) {
    for (int e = tid; e < DC; e += kThreads) {
      const int i = e / C, c = e - i * C;
      const float ep = a.eps[i];
      const float m = a.masks[i * d.T + step[c]];
      const bool fwd = flag[c] != 0;
      const float keep = (fwd == first) ? m : 1.f - m;
      const float upd = 1.f - keep;
      const float drift = ep * (expf(ep * Q[e]) * v[e] + Tt[e]);
      const float sx = ep * S[e];
      float zn;
      if (fwd) {
        zn = keep * z[e] + upd * (z[e] * expf(sx) + drift);
        ldp[e] += upd * sx;
      } else {
        zn = keep * z[e] + upd * expf(-sx) * (z[e] - drift);
        ldp[e] -= upd * sx;
      }
      z[e] = zn;
      bin[e] = upd * zn;  // the second update keeps what this one changed
    }
  };

  float accepted = 0.f;  // of chain n0 + tid, for tid < C
  int ops = 0;
  for (int k = 0; k < a.K; ++k) {
    const int nops = a.nb != nullptr ? a.nb[k] : 1;
    for (int j = 0; j < nops; ++j) {
      ++ops;
      draw<C>(d.D, n0, k, j, a.key, v, u_dir, u_acc);
      for (int e = tid; e < DC; e += kThreads) {
        zs[e] = z[e];
        g[e] = gs[e];
        ldp[e] = 0.f;
      }
      __syncthreads();
      float h0 = 0.f;
      if (tid < C) {
        flag[tid] = u_dir[tid] < 0.5f;
        e_cur[tid] = e_start[tid];
        h0 = e_start[tid] + half_sq<C>(v, d.D);
      }
      for (int it = 0; it < d.T; ++it) {
        if (tid < C) step[tid] = flag[tid] ? it : d.T - 1 - it;
        __syncthreads();
        apply_net<C>(d, a.vnet, a.emb, a.N, n0, step, z, g, S, Tt, Q, work);
        momentum_update();
        __syncthreads();
        apply_net<C>(d, a.xnet, a.emb, a.N, n0, step, v, bin, S, Tt, Q, work);
        position_update(true);
        __syncthreads();
        apply_net<C>(d, a.xnet, a.emb, a.N, n0, step, v, bin, S, Tt, Q, work);
        position_update(false);
        __syncthreads();
        decoder_grad<C>(d, a.dec, a.xraw, a.N, n0, z, g, e_cur, work);
        apply_net<C>(d, a.vnet, a.emb, a.N, n0, step, z, g, S, Tt, Q, work);
        momentum_update();
        __syncthreads();
      }
      if (tid < C) {
        float lj = 0.f;
        for (int i = 0; i < d.D; ++i) lj += ldp[i * C + tid];
        const float h1 = e_cur[tid] + half_sq<C>(v, d.D);
        const float px = accept_prob(h0 - h1 + lj);
        const int acc = px - u_acc[tid] >= 0.f;
        flag[tid] = acc;
        if (acc) {
          accepted += 1.f;
          e_start[tid] = e_cur[tid];
        }
      }
      __syncthreads();
      for (int e = tid; e < DC; e += kThreads) {
        const int c = e % C;
        if (flag[c]) {
          gs[e] = g[e];
        } else {
          z[e] = zs[e];
        }
      }
      __syncthreads();
    }
    if (a.trace != nullptr) {
      for (int e = tid; e < DC; e += kThreads) {
        const int i = e / C, n = n0 + e - i * C;
        if (n < a.N)
          a.trace[(static_cast<size_t>(k) * d.D + i) * a.N + n] = z[e];
      }
    }
  }
  for (int e = tid; e < DC; e += kThreads) {
    const int i = e / C, n = n0 + e - i * C;
    if (n < a.N) a.zo[static_cast<size_t>(i) * a.N + n] = z[e];
  }
  if (tid < C && n0 + tid < a.N)
    a.acc[n0 + tid] = accepted / static_cast<float>(ops);
}

template <int C>
static cudaError_t launch_chain(const ChainArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chain_floats<C>(a.d)) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(vae_chain_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.N + C - 1) / C;
  vae_chain_kernel<C><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace vae
}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Device pointers: params is the
// packed float32 block [eps (D), masks (D, T), decoder, xnet, vnet] in the
// order of carve_decoder / carve_net; xraw (P, N), emb (H, N), z and zo
// (D, N), acc (N), trace (K, D, N) or null, all float32; nb (K) int32 or
// null. C is the chain tile, 4 or 8. Returns a cudaError_t as int.
extern "C" int l2hmc_vae_chain(const float* params, int D, int H, int H2,
                               int T, int E, int P, const float* xraw,
                               const float* emb, const float* z,
                               const int* nb, float* zo, float* acc,
                               float* trace, int N, int K, int C,
                               unsigned long long seed, void* stream) {
  using namespace l2hmc::vae;
  if (N <= 0 || K <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a;
  a.d = Dims{D, H, H2, T, E, P};
  const float* p = params;
  a.eps = take(p, D);
  a.masks = take(p, static_cast<size_t>(D) * T);
  a.dec = carve_decoder(p, a.d);
  a.xnet = carve_net(p, a.d);
  a.vnet = carve_net(p, a.d);
  a.xraw = xraw;
  a.emb = emb;
  a.zin = z;
  a.nb = nb;
  a.zo = zo;
  a.acc = acc;
  a.trace = trace;
  a.N = N;
  a.K = K;
  a.key = make_uint2(static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                     static_cast<uint32_t>(seed >> 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4:
      return launch_chain<4>(a, s);
    case 8:
      return launch_chain<8>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
