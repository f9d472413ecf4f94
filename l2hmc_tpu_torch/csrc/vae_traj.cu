// One T-step augmented leapfrog trajectory on the VAE posterior
// U(z | x) = BCE(decoder(z), x) + 0.5 |z|^2, forward or reverse, in one
// launch: (z, v) -> (Z, V, logdet), with the decoder gradient and the
// aux-conditioned S/T/Q nets computed in the kernel. The primal of the
// fused VAE training path; its vector-Jacobian product is vae_traj_bwd.cu.
//
// Replaces the Pallas kernel _make_vae_traj_kernel /
// DifferentiableFusedVae._get_fwd_callable
// (l2hmc_tpu/ops/fused_dynamics.py:1622, pallas_call at :1840).
//
// Bound on the card: operations. One chain's trajectory is T + 1 decoder
// gradients (six products at width 1024, 7.6 MFLOP each) and 4 T net
// applications; device memory sees z, v, the pixels and the embedding once
// and Z, V, logdet once. The weights are read from the L2 once per product
// and block. What the design does about it (see vae_common.cuh for the
// block-wide product and the leapfrog step, which vae_chain.cu shares): a
// tile of C = 4 or 8 chains per block, so that a training batch of 512
// chains spreads over 128 SMs while each weight read feeds C multiply-adds.
//
// Differences from the TPU kernel, by design: the gradient at the end of
// one leapfrog step is the gradient at the start of the next (the same
// point), so a trajectory costs T + 1 decoder sweeps where the TPU kernel
// makes 2 T; the number of chains need not divide the tile (the last block
// is masked).
#include "vae_common.cuh"

namespace l2hmc {
namespace vae {

struct TrajArgs {
  Dims d;
  Decoder dec;
  Net xnet, vnet;
  const float* eps;    // (D)
  const float* masks;  // (D, T)
  const float* xraw;   // (P, N)
  const float* emb;    // (H, N)
  const float* zin;    // (D, N)
  const float* vin;    // (D, N)
  float* zo;           // (D, N)
  float* vo;           // (D, N)
  float* ld;           // (N)
  int N, reverse;
};

template <int C>
__host__ __device__ inline int traj_floats(const Dims& d) {
  // Work, eight [D][C] arrays, three [C] arrays (two of them int)
  return work_floats<C>(d) + C * (8 * d.D + 3);
}

template <int C>
__global__ void __launch_bounds__(kThreads) vae_traj_kernel(TrajArgs a) {
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  const Dims d = a.d;
  const int DC = d.D * C;
  const Work<C> work = carve_work<C>(p, d);
  Traj<C> t;
  t.z = p; p += DC;
  t.v = p; p += DC;
  t.g = p; p += DC;
  t.S = p; p += DC;
  t.Tt = p; p += DC;
  t.Q = p; p += DC;
  t.bin = p; p += DC;
  t.ldp = p; p += DC;
  t.energy = p; p += C;
  t.step = reinterpret_cast<int*>(p); p += C;
  t.flag = reinterpret_cast<int*>(p); p += C;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * C;

  load_tile<C>(a.zin, d.D, a.N, n0, t.z);
  load_tile<C>(a.vin, d.D, a.N, n0, t.v);
  for (int e = tid; e < DC; e += kThreads) t.ldp[e] = 0.f;
  if (tid < C) t.flag[tid] = a.reverse == 0;
  __syncthreads();
  decoder_grad<C>(d, a.dec, a.xraw, a.N, n0, t.z, t.g, t.energy, work);
  for (int it = 0; it < d.T; ++it)
    leapfrog_step<C>(d, a.dec, a.xnet, a.vnet, a.eps, a.masks, a.xraw, a.emb,
                     a.N, n0, it, t, work, [](int) {});
  store_tile<C>(t.z, d.D, a.N, n0, a.zo);
  store_tile<C>(t.v, d.D, a.N, n0, a.vo);
  if (tid < C && n0 + tid < a.N) {
    float lj = 0.f;
    for (int i = 0; i < d.D; ++i) lj += t.ldp[i * C + tid];
    a.ld[n0 + tid] = lj;
  }
}

template <int C>
static cudaError_t launch_traj(const TrajArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(traj_floats<C>(a.d)) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(vae_traj_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.N + C - 1) / C;
  vae_traj_kernel<C><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace vae
}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Device pointers: params is the
// packed float32 block [eps (D), masks (D, T), decoder, xnet, vnet] in the
// order of carve_decoder / carve_net; xraw (P, N), emb (H, N), z, v, zo and
// vo (D, N), ld (N), all float32. reverse picks the inverse map. C is the
// chain tile, 4 or 8. Returns a cudaError_t as int.
extern "C" int l2hmc_vae_traj(const float* params, int D, int H, int H2,
                              int T, int E, int P, const float* xraw,
                              const float* emb, const float* z,
                              const float* v, float* zo, float* vo, float* ld,
                              int N, int reverse, int C, void* stream) {
  using namespace l2hmc::vae;
  if (N <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TrajArgs a;
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
  a.vin = v;
  a.zo = zo;
  a.vo = vo;
  a.ld = ld;
  a.N = N;
  a.reverse = reverse;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4:
      return launch_traj<4>(a, s);
    case 8:
      return launch_traj<8>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
