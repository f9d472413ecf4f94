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
// Bound on the card: operations (T + 1 decoder gradients of six products at
// width 1024, 7.6 MFLOP a chain, and 4 T net applications); device memory
// sees z, v, the pixels and the embedding once and Z, V, logdet once. What
// held the per-block design back was the weight stream: every block of 4
// chains read the whole decoder from the L2 for each product, ~11.7 GB of
// decoder per launch at 512 chains, and each weight fed 4 multiply-adds.
//
// Design (vae_cluster.cuh): a cluster of G CTAs shares a tile of Ct chains
// and splits every product's output rows, so each weight is read from the L2
// once per cluster; a CTA stages its slice of every weight matrix through a
// ring of 16-byte asynchronous copies and each staged weight feeds Ct
// multiply-adds from a thread's 8 x Ct / 8 register tile. L2 bytes per
// launch, the decoder (15.2 MB per gradient: each matrix forward and
// transposed) plus the nets (0.36 MB per application), for N chains in
// ceil(N / Ct) clusters:
//   ceil(N / Ct) x ((T + 1) x 15.2 MB + 4 T x 0.36 MB)
// At the training batch (N = 512, T = 5) with Ct = 40, G = 8: 13 clusters,
// 1.19 GB of decoder and 0.09 GB of nets (the per-block design: 11.7 and 0.9
// GB); the nets' bytes stay under the decoder's for every T. The working set,
// reckoned: 8.35 MB of weights and 13 x 0.52 MB = 6.7 MB of activation
// copies, under the 50 MB L2 (no profiler runs on the card's machine to show
// what stays there). What bounds it now, by the rates reached (PERF.md), is
// the CTA's issue of shared loads and multiply-adds on 104 of 132 SMs: one
// configuration (kCt, kG in vae_cluster.cuh), 13 clusters at 512 chains.
//
// bfloat16 operands (compute_dtype="bfloat16"): the instantiation with TW =
// __nv_bfloat16 reads the weights as bfloat16, half the L2 bytes, and
// rounds each product's activations (vae_cluster.cuh); it still multiplies
// and adds in float32 on the CUDA cores, so its bound is the float32 one,
// and the tensor cores' 989 TFLOP/s are the target of a later wgmma design.
//
// Differences from the TPU kernel, by design: the gradient at the end of
// one leapfrog step is the gradient at the start of the next (the same
// point), so a trajectory costs T + 1 decoder sweeps where the TPU kernel
// makes 2 T; the number of chains need not divide the tile (the last
// cluster's extra chains read zeros and are not stored).
#include "vae_cluster.cuh"

namespace l2hmc {
namespace vaec {

template <class TW>
struct TrajArgs {
  Dims d;
  Weights<TW> w;
  const float* xraw;  // (P, N)
  const float* emb;   // (H, N)
  const float* zin;   // (D, N)
  const float* vin;   // (D, N)
  float* zo;          // (D, N)
  float* vo;          // (D, N)
  float* ld;          // (N)
  float* act;         // (clusters, act_floats): the activations' global copies
  int N, reverse;
};

// Shared-memory floats of one CTA (fused_vae.traj_smem_floats mirrors it):
// h1, h2 [Eg][Ct], ha [Hg][Ct], hb [H2g][Ct], eight [Dg][Ct] state arrays,
// the log-det partial [Ct], and the product's ring.
template <int Ct, int G>
__host__ __device__ inline int traj_floats(const Dims& d) {
  return Ct * (2 * slice_rows4(d.E, G) + slice_rows(d.H, G) +
               slice_rows(d.H2, G) + 8 * slice_rows(d.D, G) + 1) +
         ring_floats<Ct>();
}

template <int Ct, int G, class TW>
__global__ void __launch_bounds__(kThreads, 1) vae_traj_kernel(TrajArgs<TW> a) {
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  const Dims d = a.d;
  const Part q = make_part(d, G, Ct);
  const int DC = q.Dg * Ct;
  Work s;
  s.stage = p; p += ring_floats<Ct>();
  s.h1 = p; p += q.Eg * Ct;
  s.h2 = p; p += q.Eg * Ct;
  s.ha = p; p += q.Hg * Ct;
  s.hb = p; p += q.H2g * Ct;
  State t;
  t.z = p; p += DC;
  t.v = p; p += DC;
  t.g = p; p += DC;
  t.S = p; p += DC;
  t.Tt = p; p += DC;
  t.Q = p; p += DC;
  t.bin = p; p += DC;
  t.ldp = p; p += DC;
  float* const part = p;  // [Ct] this CTA's log-det terms summed over its rows
  carve_act(s, a.act + static_cast<size_t>(blockIdx.x / G) * act_floats(d, Ct), d, Ct);
  s.keep = s.stq = nullptr;

  const int tid = threadIdx.x;
  const int i0 = q.r * q.Dg;
  const uint64_t fw = a.reverse == 0 ? ~0ull : 0ull;  // every chain's direction
  load_rows<Ct>(a.zin, i0, q.Dn, a.N, q.n0, t.z);
  load_rows<Ct>(a.vin, i0, q.Dn, a.N, q.n0, t.v);
  for (int e = tid; e < DC; e += kThreads) t.ldp[e] = 0.f;
  csync();
  decoder_grad<Ct>(d, q, a.w.dec, a.xraw, a.N, t.z, t.g, s);
  for (int it = 0; it < d.T; ++it)
    leapfrog_step<Ct>(d, q, a.w, a.xraw, a.emb, a.N, it, fw, t, s, [](int) {});
  store_rows<Ct>(t.z, i0, q.Dn, a.N, q.n0, a.zo);
  store_rows<Ct>(t.v, i0, q.Dn, a.N, q.n0, a.vo);
  if (tid < Ct) {
    float lj = 0.f;
    for (int i = 0; i < q.Dn; ++i) lj += t.ldp[i * Ct + tid];
    part[tid] = lj;
  }
  csync();
  // the sum over the cluster's ranks, in rank order
  if (q.r == 0 && tid < Ct && q.n0 + tid < a.N) {
    float lj = 0.f;
    for (int r = 0; r < G; ++r) lj += cg::this_cluster().map_shared_rank(part, r)[tid];
    a.ld[q.n0 + tid] = lj;
  }
  csync();  // no CTA leaves while rank 0 reads its shared memory
}

template <class TW>
int launch_traj(const void* const* ptrs, const Dims& d, const float* xraw,
                const float* emb, const float* z, const float* v, float* zo,
                float* vo, float* ld, float* act, int N, int reverse,
                cudaStream_t stream) {
  TrajArgs<TW> a;
  a.d = d;
  a.w = carve_weights<TW>(ptrs);
  a.xraw = xraw;
  a.emb = emb;
  a.zin = z;
  a.vin = v;
  a.zo = zo;
  a.vo = vo;
  a.ld = ld;
  a.act = act;
  a.N = N;
  a.reverse = reverse;
  const size_t smem = static_cast<size_t>(traj_floats<kCt, kG>(a.d)) * sizeof(float);
  return l2hmc::launch_clusters(vae_traj_kernel<kCt, kG, TW>, kG,
                                (N + kCt - 1) / kCt, kThreads, smem, stream, a);
}

}  // namespace vaec
}  // namespace l2hmc

// Plain C entry points (loaded with ctypes). ptrs is a host array of
// kPtrs device pointers (carve_weights' order: eps (D), masks (D, T), the
// decoder's W1, b1, W2, b2, W3, b3 with W (in, out), then each net's 13
// arrays as _extract_net gives them), all float32 but for the weight
// matrices, which are bfloat16 when bf16 is set; xraw (P, N), emb (H, N),
// z, v, zo and vo (D, N), ld (N); act a scratch of l2hmc_vae_traj_sizes'
// floats. reverse picks the inverse map, bf16 the instantiation with
// bfloat16 operands. Returns a cudaError_t as int.
extern "C" int l2hmc_vae_traj(const void* const* ptrs, int D, int H, int H2,
                              int T, int E, int P, const float* xraw,
                              const float* emb, const float* z,
                              const float* v, float* zo, float* vo, float* ld,
                              float* act, int N, int reverse, int bf16,
                              void* stream) {
  using namespace l2hmc::vaec;
  if (N <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{D, H, H2, T, E, P};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_traj<__nv_bfloat16>(ptrs, d, xraw, emb, z, v, zo, vo, ld, act,
                                           N, reverse, s)
              : launch_traj<float>(ptrs, d, xraw, emb, z, v, zo, vo, ld, act, N,
                                   reverse, s);
}

// What the host allocates for N chains at these widths: out[0] = Ct,
// out[1] = G, out[2] = shared-memory bytes per CTA, out[3] = floats of act
// (one act_floats slice per cluster of Ct chains).
extern "C" int l2hmc_vae_traj_sizes(int D, int H, int H2, int T, int E, int P,
                                    int N, long long* out) {
  using namespace l2hmc::vaec;
  const Dims d{D, H, H2, T, E, P};
  out[0] = kCt;
  out[1] = kG;
  out[2] = static_cast<long long>(traj_floats<kCt, kG>(d)) * sizeof(float);
  out[3] = static_cast<long long>((N + kCt - 1) / kCt) * act_floats(d, kCt);
  return 0;
}

// How many clusters the card holds at once at these widths; a negative
// cudaError_t if the query fails.
extern "C" int l2hmc_vae_traj_clusters(int D, int H, int H2, int T, int E,
                                       int P) {
  using namespace l2hmc::vaec;
  const Dims d{D, H, H2, T, E, P};
  const size_t smem = static_cast<size_t>(traj_floats<kCt, kG>(d)) * sizeof(float);
  return l2hmc::max_clusters(vae_traj_kernel<kCt, kG, float>, kG, kThreads, smem);
}
