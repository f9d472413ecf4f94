// A whole annealed-importance-sampling chain for the VAE decoder in one
// launch: per anneal step the weight update w += dbeta (E0 - E1)(z) before
// the transition, a fresh momentum, L plain leapfrog steps at the
// interpolated energy (1 - beta) E0 + beta E1 with E0 = 0.5 |z|^2 and
// E1 = BCE(decoder(z), x) + 0.5 |z|^2, and an MH accept. Outputs log w and
// the mean acceptance probability per chain.
//
// Replaces the Pallas kernel _make_vae_ais_kernel / FusedVaeAis
// (l2hmc_tpu/ops/fused_dynamics.py:2083, pallas_call at :2268).
//
// Bound on the card: operations (L decoder gradients of 7.6 MFLOP per chain
// and anneal step; device memory sees z0 and the pixels once). The
// block-wide product and the chain tile C are those of vae_common.cuh.
//
// Differences from the TPU kernel, by design: Philox4x32-10 draws with
// counter (global chain, anneal step, slot, 0), reproduced by
// ops/philox.py; the accept is a select; the gradient at the end of one
// leapfrog step serves as the first of the next, the energies come out of
// the gradients' forward sweeps, and an accepted proposal hands its last
// gradient and energy to the next anneal step, so a step costs L decoder
// sweeps where the TPU kernel makes 2 L gradients and three energies.
#include "vae_common.cuh"

namespace l2hmc {
namespace vae {

struct AisArgs {
  Dims d;  // H, H2, T unused (0)
  Decoder dec;
  const float* beta;  // (K)
  const float* xraw;  // (P, N)
  const float* zin;   // (D, N)
  float* logw;        // (N)
  float* acc;         // (N)
  float eps, beta_diff;
  int N, K, L;
  uint2 key;
};

template <int C>
__host__ __device__ inline int ais_floats(const Dims& d) {
  // Work, five [D][C] arrays, five [C] arrays (one of them int)
  return work_floats<C>(d) + C * (5 * d.D + 5);
}

template <int C>
__global__ void __launch_bounds__(kThreads) vae_ais_kernel(AisArgs a) {
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  const Dims d = a.d;
  const int DC = d.D * C;
  const Work<C> work = carve_work<C>(p, d);
  float* z = p; p += DC;
  float* v = p; p += DC;
  float* g = p; p += DC;     // gradient of E1 at z
  float* zs = p; p += DC;    // state at the start of the anneal step
  float* gs = p; p += DC;    // gradient of E1 at zs
  float* e_cur = p; p += C;  // E1 at z
  float* e_start = p; p += C;
  float* u_dir = p; p += C;  // drawn with the accept uniform, unused
  float* u_acc = p; p += C;
  int* flag = reinterpret_cast<int*>(p); p += C;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * C;
  const float eps = a.eps;

  for (int e = tid; e < DC; e += kThreads) {
    const int i = e / C, n = n0 + e - i * C;
    z[e] = n < a.N ? a.zin[static_cast<size_t>(i) * a.N + n] : 0.f;
  }
  __syncthreads();
  decoder_grad<C>(d, a.dec, a.xraw, a.N, n0, z, gs, e_start, work);

  float w = 0.f, acc_sum = 0.f;  // of chain n0 + tid, for tid < C
  for (int k = 0; k < a.K; ++k) {
    const float b = a.beta[k];
    draw<C>(d.D, n0, k, 0, a.key, v, u_dir, u_acc);
    for (int e = tid; e < DC; e += kThreads) {
      zs[e] = z[e];
      g[e] = gs[e];
    }
    __syncthreads();
    float h0 = 0.f;
    if (tid < C) {
      const float e0 = half_sq<C>(z, d.D);
      const float e1 = e_start[tid];
      w += a.beta_diff * (e0 - e1);
      h0 = (1.f - b) * e0 + b * e1 + half_sq<C>(v, d.D);
      e_cur[tid] = e1;
    }
    __syncthreads();  // h0 has read z and v before the leapfrog moves them
    for (int l = 0; l < a.L; ++l) {
      for (int e = tid; e < DC; e += kThreads) {
        const float ga = (1.f - b) * z[e] + b * g[e];
        v[e] -= 0.5f * eps * ga;
        z[e] += eps * v[e];
      }
      __syncthreads();
      decoder_grad<C>(d, a.dec, a.xraw, a.N, n0, z, g, e_cur, work);
      for (int e = tid; e < DC; e += kThreads) {
        const float ga = (1.f - b) * z[e] + b * g[e];
        v[e] -= 0.5f * eps * ga;
      }
    }
    __syncthreads();
    if (tid < C) {
      const float h1 = (1.f - b) * half_sq<C>(z, d.D) + b * e_cur[tid] +
                       half_sq<C>(v, d.D);
      const float px = accept_prob(h0 - h1);
      acc_sum += px;
      const int acc = px - u_acc[tid] >= 0.f;
      flag[tid] = acc;
      if (acc) e_start[tid] = e_cur[tid];
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
  if (tid < C && n0 + tid < a.N) {
    a.logw[n0 + tid] = w;
    a.acc[n0 + tid] = acc_sum / static_cast<float>(a.K);
  }
}

template <int C>
static cudaError_t launch_ais(const AisArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ais_floats<C>(a.d)) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(vae_ais_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.N + C - 1) / C;
  vae_ais_kernel<C><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace vae
}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Device pointers to float32:
// params, the packed decoder in the order of carve_decoder; beta (K);
// xraw (P, N); z (D, N); logw and acc (N). eps is the leapfrog step size,
// beta_diff the weight update's factor, L the leapfrog steps per anneal
// step, C the chain tile (4 or 8). Returns a cudaError_t as int.
extern "C" int l2hmc_vae_ais(const float* params, int D, int E, int P,
                             const float* beta, const float* xraw,
                             const float* z, float* logw, float* acc,
                             float eps, float beta_diff, int N, int K, int L,
                             int C, unsigned long long seed, void* stream) {
  using namespace l2hmc::vae;
  if (N <= 0 || K <= 0 || L <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  AisArgs a;
  a.d = Dims{D, 0, 0, 0, E, P};
  const float* p = params;
  a.dec = carve_decoder(p, a.d);
  a.beta = beta;
  a.xraw = xraw;
  a.zin = z;
  a.logw = logw;
  a.acc = acc;
  a.eps = eps;
  a.beta_diff = beta_diff;
  a.N = N;
  a.K = K;
  a.L = L;
  a.key = make_uint2(static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                     static_cast<uint32_t>(seed >> 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4:
      return launch_ais<4>(a, s);
    case 8:
      return launch_ais<8>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
