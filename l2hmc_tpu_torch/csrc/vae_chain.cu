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
// embedding once and, with a trace, D * 4 bytes per chain and step.
//
// What held the per-block design back: every block of C = 4 chains (the
// evaluation protocol's 200 chains made 50 blocks, on 50 of the 132 SMs)
// streamed every weight from the L2 itself, one 4-byte load feeding C
// multiply-adds, about 83 MB per block and MH op: too few SMs, and too
// little work per load to hide its latency.
//
// Design (vae_cluster.cuh): a cluster of kChainG CTAs shares a tile of
// kChainCt chains and splits every product's output rows and the latent,
// as the training kernels do; each CTA stages its slice of every weight
// matrix through the ring of 16-byte asynchronous copies, and each staged
// weight feeds kChainCt multiply-adds from a thread's register tile. At 200
// chains that is 13 clusters, 104 CTAs in one wave. L2 bytes per launch,
// the decoder (15.2 MB per sweep: each matrix forward and transposed) plus
// the nets (0.36 MB per application), for N chains and `ops` MH ops:
//   ceil(N / Ct) x (ops x (T x 15.2 MB + 4 T x 0.36 MB) + 15.2 MB)
// (the last term the start state's sweep): at 200 chains and the
// protocol's 4045 ops, 13 x 4045 x 83.2 MB = 4.4 TB, against 50 x 4045 x
// 83.2 MB = 16.8 TB of the per-block design.
//
// What the sampler adds to the training kernels' machinery:
//  - A direction per chain (a bit of a mask): the uniform picks it, and it enters
//    only through the time-embedding and mask columns and the form of the
//    elementwise updates, so the chains of a tile share every product.
//  - The energy: the decoder sweep forms each CTA's share of U (its pixel
//    rows' BCE terms, its latent rows' 0.5 z^2), and the kinetic energy and
//    log-det are taken per CTA too; at the accept every CTA adds the ranks'
//    shares in rank order, so all CTAs of a cluster take the same decision
//    without a word more between them, and a launch repeats bit for bit (no
//    atomics).
//  - nb[k] ops per recorded step, the same for every chain, so every CTA of
//    a cluster makes the same products and meets the same barriers; accept
//    and direction are selects.
//  - No net activations are kept: one slot of the cluster's scratch,
//    reused.
//
// bfloat16 operands (compute_dtype="bfloat16"): the instantiation with TW =
// __nv_bfloat16 reads the weights as bfloat16 and rounds each product's
// activations (vae_cluster.cuh); energies, Hamiltonians and the accept stay
// float32, as in the TPU kernel's bf16 recipe.
//
// Differences from the TPU kernel, by design:
//  - Random numbers are Philox4x32-10 keyed by the 64-bit seed, counter
//    (global chain, recorded step, slot, inner op): the draws do not depend
//    on the tiling, and ops/philox.py reproduces them bit for bit.
//  - Only the direction the uniform picks runs, chain by chain; a
//    non-finite unchosen or rejected value cannot leak into the state.
//  - nb is the same for every chain of a step, so the kernel runs nb ops
//    and skips the dead ones; the TPU kernel runs max ops and masks.
//  - The gradient at the end of one leapfrog step is the gradient at the
//    start of the next (the same point), and the energy comes out of the
//    gradient's forward sweep, so one MH op costs T decoder sweeps where
//    the TPU kernel makes 2 T gradients and two energies. On acceptance the
//    proposal's last gradient and energy become the next op's first.
//  - The trace goes straight to device memory, each latent row from the
//    CTA that owns it.
#include "philox.cuh"
#include "vae_cluster.cuh"
#include "vae_common.cuh"

namespace l2hmc {
namespace vaec {

// The sampler's cluster configuration: kChainCt chains shared by a cluster
// of kChainG CTAs (fused_vae.CHAIN_CLUSTER mirrors it).
constexpr int kChainCt = 16, kChainG = 8;
// [Ct] arrays of a CTA: four partial sums read by the other ranks (kinetic
// energy at the start, U at the proposal, kinetic energy at the end,
// log-det), the energy at the op's start, the accept uniform, and the
// direction and the decision (int)
constexpr int kChainVecs = 8;

template <class TW>
struct ChainArgs {
  Dims d;
  Weights<TW> w;
  const float* xraw;  // (P, N)
  const float* emb;   // (H, N)
  const float* zin;   // (D, N)
  const int* nb;      // (K) ops per recorded step, or null for 1
  float* zo;          // (D, N)
  float* acc;         // (N)
  float* trace;       // (K, D, N) or null
  float* act;         // (clusters, act_floats): the activations' global copies
  int N, K;
  uint2 key;
};

// Shared-memory floats of one CTA (fused_vae.chain_smem_floats mirrors
// it): h1, h2 [Eg][Ct], ha [Hg][Ct], hb [H2g][Ct], ten [Dg][Ct] state
// arrays, kChainVecs [Ct] arrays and the product's ring.
template <int Ct, int G>
__host__ __device__ inline int chain_floats(const Dims& d) {
  return Ct * (2 * slice_rows4(d.E, G) + slice_rows(d.H, G) +
               slice_rows(d.H2, G) + 10 * slice_rows(d.D, G) + kChainVecs) +
         ring_floats<Ct>();
}

// The op's draws for this CTA's latent rows: v [Dg][Ct] standard normals,
// and per chain the accept uniform and the direction (1: forward). Philox
// counter (global chain, step, slot, op): slot 0 holds the direction
// uniform (word 0) and the accept uniform (word 1), slot 1 + i / 2 the
// normals of latent rows i (words 0, 1) and i + 1 (words 2, 3), as
// vae_common.cuh's draw and ops/philox.py lay them out. The caller
// synchronises.
template <int Ct>
__device__ __forceinline__ void draw_rows(const Part& q, int step, int op,
                                          uint2 key, float* v, float* u_acc,
                                          int* fwd) {
  const int i0 = q.r * q.Dg;
  for (int e = threadIdx.x; e < q.Dn * Ct; e += kThreads) {
    const int r = e / Ct, c = e - r * Ct, i = i0 + r;
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q.n0 + c), static_cast<uint32_t>(step),
                   static_cast<uint32_t>(1 + i / 2), static_cast<uint32_t>(op)),
        key);
    v[e] = (i & 1) ? box_muller(w.z, w.w) : box_muller(w.x, w.y);
  }
  if (threadIdx.x < Ct) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q.n0 + threadIdx.x),
                   static_cast<uint32_t>(step), 0u, static_cast<uint32_t>(op)),
        key);
    fwd[threadIdx.x] = uniform24(w.x) < 0.5f;
    u_acc[threadIdx.x] = uniform24(w.y);
  }
}

// sum over this CTA's latent rows of a [Dg][Ct] array's column c (squared
// and halved with sq)
template <int Ct>
__device__ __forceinline__ float rows_sum(const float* a, int rows, int c,
                                          bool sq) {
  float s = 0.f;
  for (int j = 0; j < rows; ++j) {
    const float x = a[j * Ct + c];
    s = sq ? fmaf(x, x, s) : s + x;
  }
  return sq ? 0.5f * s : s;
}

template <int Ct, int G, class TW>
__global__ void __launch_bounds__(kThreads, 1) vae_chain_kernel(ChainArgs<TW> a) {
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
  float* const zs = p; p += DC;  // the state at the op's start
  float* const gs = p; p += DC;  // the gradient at zs
  float* const part = p; p += 4 * Ct;  // [4][Ct] this CTA's shares, see kChainVecs
  float* const e_start = p; p += Ct;   // U at zs, whole (the same in every CTA)
  float* const u_acc = p; p += Ct;
  int* const fwd = reinterpret_cast<int*>(p); p += Ct;
  int* const take = reinterpret_cast<int*>(p);  // 1: the proposal was accepted
  float* const k0p = part;
  float* const e1p = part + Ct;
  float* const k1p = part + 2 * Ct;
  float* const ljp = part + 3 * Ct;
  carve_act(s, a.act + static_cast<size_t>(blockIdx.x / G) * act_floats(d, Ct), d, Ct);
  s.keep = s.stq = nullptr;

  const int tid = threadIdx.x;
  const int i0 = q.r * q.Dg;
  load_rows<Ct>(a.zin, i0, q.Dn, a.N, q.n0, t.z);
  csync();
  decoder_grad<Ct>(d, q, a.w.dec, a.xraw, a.N, t.z, gs, s, e1p);
  // every rank's share is visible; it is next written in the first op's
  // last sweep, after the cluster barriers of its net applications
  if (tid < Ct) e_start[tid] = rank_sum(e1p, G, tid);

  float accepted = 0.f;  // of chain n0 + tid, for tid < Ct
  int ops = 0;
  for (int k = 0; k < a.K; ++k) {
    const int nops = a.nb != nullptr ? a.nb[k] : 1;
    for (int j = 0; j < nops; ++j) {
      ++ops;
      draw_rows<Ct>(q, k, j, a.key, t.v, u_acc, fwd);
      for (int e = tid; e < DC; e += kThreads) {
        zs[e] = t.z[e];
        t.g[e] = gs[e];
        t.ldp[e] = 0.f;
      }
      __syncthreads();
      uint64_t fw = 0;  // bit c: chain c runs forward
      for (int c = 0; c < Ct; ++c) fw |= static_cast<uint64_t>(fwd[c]) << c;
      if (tid < Ct) k0p[tid] = rows_sum<Ct>(t.v, q.Dn, tid, true);
      for (int it = 0; it + 1 < d.T; ++it)
        leapfrog_step<Ct>(d, q, a.w, a.xraw, a.emb, a.N, it, fw, t, s, [](int) {});
      // the last sweep forms the proposal's energy too
      leapfrog_step<Ct>(d, q, a.w, a.xraw, a.emb, a.N, d.T - 1, fw, t, s, [](int) {},
                        e1p);
      if (tid < Ct) {
        k1p[tid] = rows_sum<Ct>(t.v, q.Dn, tid, true);
        ljp[tid] = rows_sum<Ct>(t.ldp, q.Dn, tid, false);
      }
      csync();
      if (tid < Ct) {
        const float h0 = e_start[tid] + rank_sum(k0p, G, tid);
        const float e1 = rank_sum(e1p, G, tid);
        const float h1 = e1 + rank_sum(k1p, G, tid);
        const float px = vae::accept_prob(h0 - h1 + rank_sum(ljp, G, tid));
        const int ok = px - u_acc[tid] >= 0.f;
        take[tid] = ok;
        if (ok) {
          accepted += 1.f;
          e_start[tid] = e1;
        }
      }
      csync();  // every rank has read the shares before the next op writes them
      for (int e = tid; e < DC; e += kThreads) {
        if (take[e % Ct]) {
          gs[e] = t.g[e];
        } else {
          t.z[e] = zs[e];
        }
      }
      __syncthreads();
    }
    if (a.trace != nullptr)
      store_rows<Ct>(t.z, i0, q.Dn, a.N, q.n0,
                     a.trace + static_cast<size_t>(k) * d.D * a.N);
  }
  store_rows<Ct>(t.z, i0, q.Dn, a.N, q.n0, a.zo);
  if (q.r == 0 && tid < Ct && q.n0 + tid < a.N)
    a.acc[q.n0 + tid] = accepted / static_cast<float>(ops);
  // the last read of another CTA's shared memory was the last accept's,
  // before its cluster barrier: a CTA may leave now
}

template <class TW>
int launch_chain(const void* const* ptrs, const Dims& d, const float* xraw,
                 const float* emb, const float* z, const int* nb, float* zo,
                 float* acc, float* trace, float* act, int N, int K,
                 unsigned long long seed, cudaStream_t stream) {
  ChainArgs<TW> a;
  a.d = d;
  a.w = carve_weights<TW>(ptrs);
  a.xraw = xraw;
  a.emb = emb;
  a.zin = z;
  a.nb = nb;
  a.zo = zo;
  a.acc = acc;
  a.trace = trace;
  a.act = act;
  a.N = N;
  a.K = K;
  a.key = make_uint2(static_cast<uint32_t>(seed & 0xFFFFFFFFull),
                     static_cast<uint32_t>(seed >> 32));
  const size_t smem =
      static_cast<size_t>(chain_floats<kChainCt, kChainG>(a.d)) * sizeof(float);
  return l2hmc::launch_clusters(vae_chain_kernel<kChainCt, kChainG, TW>, kChainG,
                                (N + kChainCt - 1) / kChainCt, kThreads, smem,
                                stream, a);
}

}  // namespace vaec
}  // namespace l2hmc

// Plain C entry points (loaded with ctypes). ptrs is a host array of
// kPtrs device pointers (carve_weights' order: eps (D), masks (D, T), the
// decoder's W1, b1, W2, b2, W3, b3 with W (in, out), then each net's 13
// arrays as _extract_net gives them), float32 but for the weight matrices,
// which are bfloat16 when bf16 is set; xraw (P, N), emb (H, N), z and zo
// (D, N), acc (N), trace (K, D, N) or null, all float32; nb (K) int32 or
// null; act a scratch of l2hmc_vae_chain_sizes' floats; bf16 picks the
// instantiation with bfloat16 operands. Returns a cudaError_t as int.
extern "C" int l2hmc_vae_chain(const void* const* ptrs, int D, int H, int H2,
                               int T, int E, int P, const float* xraw,
                               const float* emb, const float* z,
                               const int* nb, float* zo, float* acc,
                               float* trace, float* act, int N, int K,
                               unsigned long long seed, int bf16, void* stream) {
  using namespace l2hmc::vaec;
  if (N <= 0 || K <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{D, H, H2, T, E, P};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_chain<__nv_bfloat16>(ptrs, d, xraw, emb, z, nb, zo, acc, trace,
                                            act, N, K, seed, s)
              : launch_chain<float>(ptrs, d, xraw, emb, z, nb, zo, acc, trace, act, N,
                                    K, seed, s);
}

// What the host allocates for N chains at these widths: out[0] = Ct,
// out[1] = G, out[2] = shared-memory bytes per CTA, out[3] = floats of act
// (one act_floats slice per cluster of Ct chains), out[4] = CTAs of the
// launch.
extern "C" int l2hmc_vae_chain_sizes(int D, int H, int H2, int T, int E, int P,
                                     int N, long long* out) {
  using namespace l2hmc::vaec;
  const Dims d{D, H, H2, T, E, P};
  const long long clusters = (N + kChainCt - 1) / kChainCt;
  out[0] = kChainCt;
  out[1] = kChainG;
  out[2] = static_cast<long long>(chain_floats<kChainCt, kChainG>(d)) * sizeof(float);
  out[3] = clusters * act_floats(d, kChainCt);
  out[4] = clusters * kChainG;
  return 0;
}

// How many clusters the card holds at once at these widths; a negative
// cudaError_t if the query fails.
extern "C" int l2hmc_vae_chain_clusters(int D, int H, int H2, int T, int E,
                                        int P) {
  using namespace l2hmc::vaec;
  const Dims d{D, H, H2, T, E, P};
  const size_t smem =
      static_cast<size_t>(chain_floats<kChainCt, kChainG>(d)) * sizeof(float);
  return l2hmc::max_clusters(vae_chain_kernel<kChainCt, kChainG, float>, kChainG,
                             kThreads, smem);
}
