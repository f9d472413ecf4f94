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
// Bound on the card: operations, L decoder gradients of 7.6 MFLOP per
// chain and anneal step (114.19 ms at the protocol's 1000 chains x 100
// anneal steps x 10 leapfrogs on an H100 80GB HBM3 at 700 W, by
// chip_smoke.py's count); device memory sees z0 and the pixels once.
//
// Design (vae_stream.cuh): clusters of kG CTAs, each CTA with its own tile
// of kC chains and their activations in its own shared memory; the decoder
// streams through a ring in every CTA, one multicast bulk copy from the L2
// per chunk and cluster. The L2 serves clusters x (K L + 1) sweeps x 15.2
// MB per launch: 32 x 1001 x 15.2 MB = 0.49 TB at 1000 chains, against
// 125 x 1001 x 15.2 MB = 1.9 TB when every block of 8 chains streamed the
// weights itself through __ldg (a block-wide product, since removed). The
// row-split cluster tile of the training kernels
// (vae_cluster.cuh) was not taken: it shares a tile of 40 chains among 8
// CTAs and exchanges partial rows through a global scratch; 1000 chains
// would make 25 clusters of 8, and the card holds 15 at once, so a launch
// would run in two waves at about the per-SM rate this kernel had.
//
// Differences from the TPU kernel, by design: Philox4x32-10 draws with
// counter (global chain, anneal step, slot, 0), reproduced by
// ops/philox.py, so the bits do not depend on the tiling; the accept is a
// select, so every CTA of a cluster makes the same K L + 1 sweeps; the
// gradient at the end of one leapfrog step serves as the first of the
// next, the energies come out of the gradients' forward sweeps, and an
// accepted proposal hands its last gradient and energy to the next anneal
// step, so a step costs L decoder sweeps where the TPU kernel makes 2 L
// gradients and three energies. Sums over pixels are taken in a fixed
// order (no atomics), so a launch repeats itself bit for bit.
//
// bfloat16 operands (compute_dtype="bfloat16"): the instantiation with TW =
// __nv_bfloat16 streams the decoder's matrices in bfloat16 (half the L2
// bytes: 0.48 TB at the protocol's 1000 chains) and rounds each product's
// activations (vae_stream.cuh); energies, the weights' update and the
// accept stay float32.
#include "vae_stream.cuh"

namespace l2hmc {
namespace vae {

using stream::kC;

template <class TW>
struct AisArgs {
  Dims d;  // H, H2, T unused (0)
  Decoder<TW> dec;
  stream::Sweep<TW> sweep;
  const float* beta;  // (K)
  const float* xraw;  // (P, N)
  const float* zin;   // (D, N)
  float* logw;        // (N)
  float* acc;         // (N)
  float eps, beta_diff;
  int N, K, L;
  uint2 key;
};

// Shared memory of one CTA: the ring, then Work (the decoder's two hidden
// layers, its output cotangent and the sum's partials), five [D][kC] arrays
// and five [kC] arrays (one of them int).
inline size_t ais_smem_bytes(const Dims& d) {
  return stream::ring_bytes() +
         sizeof(float) * (work_floats<kC>(d) + kC * (5 * d.D + 5));
}

template <class TW>
__global__ void __launch_bounds__(stream::kBlock, 1)
    vae_ais_kernel(const __grid_constant__ AisArgs<TW> a) {
  using stream::csync;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sp = smem;
  stream::Ring ring = stream::carve_ring(sp);
  float* p = reinterpret_cast<float*>(sp);
  const Dims d = a.d;
  const int DC = d.D * kC;
  const Work<kC> work = carve_work<kC>(p, d);
  float* z = p; p += DC;
  float* v = p; p += DC;
  float* g = p; p += DC;     // gradient of E1 at z
  float* zs = p; p += DC;    // state at the start of the anneal step
  float* gs = p; p += DC;    // gradient of E1 at zs
  float* e_cur = p; p += kC;  // E1 at z
  float* e_start = p; p += kC;
  float* u_dir = p; p += kC;  // drawn with the accept uniform, unused
  float* u_acc = p; p += kC;
  int* flag = reinterpret_cast<int*>(p); p += kC;

  if (threadIdx.x == 0) stream::init_ring(ring);
  stream::cluster_sync();

  const int tid = threadIdx.x;
  if (tid >= stream::kConsumers) {
    if (tid == stream::kConsumers)
      stream::produce(a.sweep, 1 + a.K * a.L, ring,
                      stream::cluster_rank() == 0);
    stream::cluster_sync();
    return;
  }

  const int n0 = blockIdx.x * kC;
  const float eps = a.eps;
  for (int e = tid; e < DC; e += stream::kConsumers) {
    const int i = e / kC, n = n0 + e - i * kC;
    z[e] = n < a.N ? a.zin[static_cast<size_t>(i) * a.N + n] : 0.f;
  }
  csync();
  stream::decoder_grad(ring, d, a.dec, a.sweep, a.xraw, a.N, n0, z, gs,
                       e_start, work);

  float w = 0.f, acc_sum = 0.f;  // of chain n0 + tid, for tid < kC
  for (int k = 0; k < a.K; ++k) {
    const float b = a.beta[k];
    draw<kC>(d.D, n0, k, 0, a.key, v, u_dir, u_acc);
    for (int e = tid; e < DC; e += stream::kConsumers) {
      zs[e] = z[e];
      g[e] = gs[e];
    }
    csync();
    float h0 = 0.f;
    if (tid < kC) {
      const float e0 = half_sq<kC>(z, d.D);
      const float e1 = e_start[tid];
      w += a.beta_diff * (e0 - e1);
      h0 = (1.f - b) * e0 + b * e1 + half_sq<kC>(v, d.D);
      e_cur[tid] = e1;
    }
    csync();  // h0 has read z and v before the leapfrog moves them
    for (int l = 0; l < a.L; ++l) {
      for (int e = tid; e < DC; e += stream::kConsumers) {
        const float ga = (1.f - b) * z[e] + b * g[e];
        v[e] -= 0.5f * eps * ga;
        z[e] += eps * v[e];
      }
      csync();
      stream::decoder_grad(ring, d, a.dec, a.sweep, a.xraw, a.N, n0, z, g,
                           e_cur, work);
      for (int e = tid; e < DC; e += stream::kConsumers) {
        const float ga = (1.f - b) * z[e] + b * g[e];
        v[e] -= 0.5f * eps * ga;
      }
    }
    csync();
    if (tid < kC) {
      const float h1 = (1.f - b) * half_sq<kC>(z, d.D) + b * e_cur[tid] +
                       half_sq<kC>(v, d.D);
      const float px = accept_prob(h0 - h1);
      acc_sum += px;
      const int acc = px - u_acc[tid] >= 0.f;
      flag[tid] = acc;
      if (acc) e_start[tid] = e_cur[tid];
    }
    csync();
    for (int e = tid; e < DC; e += stream::kConsumers) {
      const int c = e % kC;
      if (flag[c]) {
        gs[e] = g[e];
      } else {
        z[e] = zs[e];
      }
    }
    csync();
  }
  if (tid < kC && n0 + tid < a.N) {
    a.logw[n0 + tid] = w;
    a.acc[n0 + tid] = acc_sum / static_cast<float>(a.K);
  }
  stream::cluster_sync();
}

// The launch's CTAs: one per kC chains, rounded up to whole clusters.
inline int ais_ctas(int N) {
  const int ctas = (N + kC - 1) / kC;
  return (ctas + stream::kG - 1) / stream::kG * stream::kG;
}

// 0 if the kernel takes these widths: every product's rows fit a slot and
// a CTA's shared memory fits.
template <class TW>
inline bool ais_fits(const Dims& d) {
  const int widths[3] = {d.D, d.E, d.P};
  for (int M : widths)
    if (M <= 0 || stream::chunk_rows<TW>(M) == 0) return false;
  return ais_smem_bytes(d) <= kMaxSmem;
}

template <class TW>
int launch_ais(const unsigned char* params, const Dims& d, const float* beta,
               const float* xraw, const float* z, float* logw, float* acc,
               float eps, float beta_diff, int N, int K, int L,
               unsigned long long seed, cudaStream_t stream) {
  if (!ais_fits<TW>(d)) return static_cast<int>(cudaErrorInvalidValue);
  AisArgs<TW> a;
  a.d = d;
  const unsigned char* p = params;
  a.dec = carve_decoder<TW>(p, a.d);
  a.sweep = stream::make_sweep(a.dec, a.d);
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
  return static_cast<int>(l2hmc::launch_clusters(
      vae_ais_kernel<TW>, stream::kG, ais_ctas(N) / stream::kG, stream::kBlock,
      ais_smem_bytes(a.d), stream, a));
}

}  // namespace vae
}  // namespace l2hmc

// Plain C entry points (loaded with ctypes).
//
// l2hmc_vae_ais: device pointers: params, the packed decoder in the order of
// carve_decoder (the weight matrices float32, or bfloat16 when bf16 is set,
// the biases float32), each array padded to whole 16 bytes and the block
// 16-byte aligned; beta (K); xraw (P, N); z (D, N); logw and acc (N), all
// float32. eps is the leapfrog step size, beta_diff the weight update's
// factor, L the leapfrog steps per anneal step, bf16 picks the
// instantiation with bfloat16 operands. Returns a cudaError_t as int (a
// refused cluster launch included).
extern "C" int l2hmc_vae_ais(const void* params, int D, int E, int P,
                             const float* beta, const float* xraw,
                             const float* z, float* logw, float* acc,
                             float eps, float beta_diff, int N, int K, int L,
                             unsigned long long seed, int bf16, void* stream) {
  using namespace l2hmc::vae;
  const Dims d{D, 0, 0, 0, E, P};
  if (N <= 0 || K <= 0 || L <= 0 || reinterpret_cast<uintptr_t>(params) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned char* p = static_cast<const unsigned char*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_ais<__nv_bfloat16>(p, d, beta, xraw, z, logw, acc, eps, beta_diff,
                                          N, K, L, seed, s)
              : launch_ais<float>(p, d, beta, xraw, z, logw, acc, eps, beta_diff, N, K,
                                  L, seed, s);
}

// What the host allocates and checks for N chains at widths (D, E, P):
// out[0] chains per CTA, out[1] CTAs per cluster, out[2] shared-memory
// bytes per CTA, out[3] ring slots, out[4] floats per slot, out[5] CTAs of
// the launch. Returns a cudaError_t as int (invalid if the widths do not
// fit).
extern "C" int l2hmc_vae_ais_sizes(int D, int E, int P, int N,
                                   long long* out) {
  using namespace l2hmc::vae;
  const Dims d{D, 0, 0, 0, E, P};
  out[0] = kC;
  out[1] = stream::kG;
  out[2] = static_cast<long long>(ais_smem_bytes(d));
  out[3] = stream::kSlots;
  out[4] = stream::kSlotFloats;
  out[5] = ais_ctas(N);
  return ais_fits<float>(d) ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters the card holds at once at widths (D, E, P) (CUDA's
// occupancy query; a negative CUDA error code if it fails).
extern "C" int l2hmc_vae_ais_clusters(int D, int E, int P) {
  using namespace l2hmc::vae;
  const Dims d{D, 0, 0, 0, E, P};
  return l2hmc::max_clusters(vae_ais_kernel<float>, stream::kG, stream::kBlock,
                             ais_smem_bytes(d));
}
