// The thread-block-cluster machinery of the VAE training kernels
// (vae_traj.cu, vae_traj_bwd.cu) and the posterior sampler (vae_chain.cu):
// the cluster's split of every product's rows, the product over a chain
// tile shared by the cluster, the S/T/Q net, the decoder gradient (with the
// energy's value where the sampler asks for it) and one augmented leapfrog
// step.
//
// Design. Every chain of a tile makes the same products: each decoder
// product over a tile of Ct chains is a small GEMM (M = 1024 or 784
// outputs, N = Ct chains, K = 50, 1024 or 784). A chain's direction enters
// only through the time-embedding and mask columns it reads and the form of
// its elementwise updates (one direction per launch in the training
// kernels, one per chain in the sampler: a bit mask either way). A
// cluster of G CTAs shares one tile of Ct chains and splits every product's
// output rows: CTA r of the cluster owns rows [r * Mg, (r + 1) * Mg) of each
// activation with Mg = ceil(M / G), and keeps its rows of every [rows][Ct]
// array (activations, the latent state, the net outputs, the cotangents) in
// its own shared memory, and a whole copy of each activation in the
// cluster's global scratch, read back through the L2. A product reads its right-hand side
// from that copy (the first of a net or a sweep through distributed shared
// memory, map_shared_rank) and its slice of the weights from global memory
// (the L2), both staged in KC-row chunks by asynchronous copies through a
// ring in shared memory (all chunks at once when they fit), so each staged
// weight feeds Ct multiply-adds; a thread computes an 8 x Ct / 8 register
// tile over its group's share of each chunk's rows (Tile). The weights are
// read in the params tree's own layout: W (in, out) for the forward
// products, the same W with its rows as outputs for the transposed products
// of the gradient sweep (staged [row][k]), 16 bytes at a time. Sums
// over rows that lie in several CTAs (the log-det over the latent) are taken
// per CTA and then over the ranks in rank order; there are no atomics, so a
// launch repeats itself bit for bit. Every product ends with a cluster
// barrier before its output is read by another CTA, and a CTA leaves the
// kernel only after a last barrier, so no CTA reads the shared memory of one
// that has exited.
//
// Operands. Every kernel here has two instantiations, by the type TW of
// the products' weights: float, or __nv_bfloat16 (the JAX package's
// compute_dtype="bfloat16", its _dot_in). In the second the host hands the
// weight matrices over in bfloat16, a product stages them as they are and
// widens each to float where it multiplies (__bfloat162float), and every
// activation that a product reads is rounded to bfloat16 where it is
// written for that product (rnd<TW>), so each product multiplies two
// bfloat16 values exactly and sums in float32, as JAX's does. Biases, eps,
// the state, energies and log-det stay float32, and so does every local
// copy an epilogue reads back (a softplus layer for its sigmoid).
//
// vae_common.cuh keeps the per-CTA layout of the AIS kernel (vae_ais.cu).
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_launch.cuh"
#include "operand.cuh"

namespace l2hmc {
namespace vaec {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int KC = 32;  // reduction rows per staged chunk
constexpr size_t kMaxSmem = 232448;  // bytes one CTA may use on Hopper
// The cluster configuration of both training kernels: kCt chains shared by
// a cluster of kG CTAs. The card holds 15 such clusters at once, so the
// training batch of 512 chains runs in one wave of 13 clusters on 104 SMs.
constexpr int kCt = 40, kG = 8;

// latent dim, S/T/Q hidden widths, leapfrog steps, decoder hidden, pixels
struct Dims {
  int D, H, H2, T, E, P;
};

// The decoder in the params tree's layout: W (in, out) row-major, b (out).
template <class TW>
struct Decoder {
  const TW* W1;
  const float* b1;
  const TW* W2;
  const float* b2;
  const TW* W3;
  const float* b3;
};

// One S/T/Q net as _extract_net gives it: w1, w2 (D, H), wh (H, H2), bh
// (H2), ws (H2, D), bs, ls (D), wt (H2, D), bt (D), wq (H2, D), bq, lq (D),
// te (H, T) with the embed biases folded in. The six matrices are TW.
template <class TW>
struct Net {
  const TW *w1, *w2, *wh;
  const float* bh;
  const TW* ws;
  const float *bs, *ls;
  const TW* wt;
  const float* bt;
  const TW* wq;
  const float *bq, *lq, *te;
};

constexpr int kPtrs = 2 + 6 + 2 * 13;  // eps, masks, decoder, xnet, vnet

template <class TW>
struct Weights {
  const float* eps;    // (D)
  const float* masks;  // (D, T)
  Decoder<TW> dec;
  Net<TW> xnet, vnet;
};

// From the host's array of kPtrs device pointers, in the order above: the
// matrices TW, the rest float.
template <class TW>
inline Weights<TW> carve_weights(const void* const* p) {
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto m = [&](int i) { return static_cast<const TW*>(p[i]); };
  Weights<TW> w;
  w.eps = f(0);
  w.masks = f(1);
  w.dec = Decoder<TW>{m(2), f(3), m(4), f(5), m(6), f(7)};
  Net<TW>* nets[2] = {&w.xnet, &w.vnet};
  for (int n = 0; n < 2; ++n) {
    const int q = 8 + 13 * n;
    *nets[n] = Net<TW>{m(q), m(q + 1), m(q + 2), f(q + 3), m(q + 4), f(q + 5), f(q + 6),
                       m(q + 7), f(q + 8), m(q + 9), f(q + 10), f(q + 11), f(q + 12)};
  }
  return w;
}

// rows per CTA of M rows split over a cluster of G
__host__ __device__ inline int slice_rows(int M, int G) { return (M + G - 1) / G; }

// the same rounded up to a multiple of 4: the decoder's splits, so that a
// CTA's rows of W (in, out) start on a 16-byte boundary
__host__ __device__ inline int slice_rows4(int M, int G) {
  return (slice_rows(M, G) + 3) / 4 * 4;
}

// rows of a split into slices of s that rank r holds (0 for a rank past the
// end)
__host__ __device__ inline int held_rows(int M, int s, int r) {
  const int n = M - r * s;
  return n < 0 ? 0 : (n > s ? s : n);
}

// This CTA's place: its rank, its cluster's first chain, and per split the
// rows of a slice (*g) and the rows it holds (*n).
struct Part {
  int r, n0;
  int Dg, Eg, Pg, Hg, H2g;
  int Dn, En, Pn, Hn, H2n;
};

__device__ inline Part make_part(const Dims& d, int G, int Ct) {
  Part q;
  q.r = static_cast<int>(cg::this_cluster().block_rank());
  q.n0 = (blockIdx.x / G) * Ct;
  q.Dg = slice_rows(d.D, G);
  q.Eg = slice_rows4(d.E, G);
  q.Pg = slice_rows4(d.P, G);
  q.Hg = slice_rows(d.H, G);
  q.H2g = slice_rows(d.H2, G);
  q.Dn = held_rows(d.D, q.Dg, q.r);
  q.En = held_rows(d.E, q.Eg, q.r);
  q.Pn = held_rows(d.P, q.Pg, q.r);
  q.Hn = held_rows(d.H, q.Hg, q.r);
  q.H2n = held_rows(d.H2, q.H2g, q.r);
  return q;
}

// Whether the decoder's products may stage their weights four at a time
// (16 bytes of float, 8 of bfloat16): both widths multiples of 4 and the
// matrices aligned to four weights.
template <class TW>
__device__ inline bool decoder_vec(const Dims& d, const Decoder<TW>& w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w.W1) |
                      reinterpret_cast<uintptr_t>(w.W2) |
                      reinterpret_cast<uintptr_t>(w.W3);
  return d.E % 4 == 0 && d.P % 4 == 0 && (a & (4 * sizeof(TW) - 1)) == 0;
}

__device__ __forceinline__ void csync() { cg::this_cluster().sync(); }

// sum over the cluster's ranks of a [Ct] array's entry c, in rank order
__device__ __forceinline__ float rank_sum(const float* p, int G, int c) {
  float s = 0.f;
  for (int r = 0; r < G; ++r)
    s += cg::this_cluster().map_shared_rank(const_cast<float*>(p), r)[c];
  return s;
}

// The direction of the tile's chains: bit c of fw is set when chain c runs
// forward (the training kernels set all bits or none, the sampler one per
// chain). At leapfrog step `it` chain c reads the time-embedding and mask
// column step_of(d, it, fw, c) and takes the forward or the inverse form of
// the updates.
__device__ __forceinline__ bool fwd_of(uint64_t fw, int c) { return (fw >> c) & 1; }

__device__ __forceinline__ int step_of(const Dims& d, int it, uint64_t fw, int c) {
  return fwd_of(fw, c) ? it : d.T - 1 - it;
}

// Element (k, c) of a row-split array whose slices are [sl][ld] at p in
// every CTA of the cluster: global row k lives in rank k / sl (taken in
// float: (k + 1/2) / sl lies at least 1/2 / sl from an integer, far beyond
// the approximate division's error for k < 2^20).
__device__ __forceinline__ float dget(const float* p, int sl, int ld, int k,
                                      int c) {
  const int r = static_cast<int>(__fdividef(k + 0.5f, static_cast<float>(sl)));
  const float* q = cg::this_cluster().map_shared_rank(const_cast<float*>(p), r);
  return q[(k - r * sl) * ld + c];
}

// Copies all M rows of a row-split array into dst [M][ld] (local), each
// value as a product's operand of type TW reads it. The caller
// synchronises.
template <class TW = float>
__device__ __forceinline__ void gather(const float* p, int sl, int M, int ld,
                                       float* dst) {
#pragma unroll 4
  for (int e = threadIdx.x; e < M * ld; e += kThreads) {
    const int k = e / ld;
    dst[e] = rnd<TW>(dget(p, sl, ld, k, e - k * ld));
  }
}

// The register tile of a product with CT columns and MT rows per pass. The
// CTA's threads form KG groups that share out the KC reduction rows of every
// chunk (KH each); in a group of GT threads, 8 column groups of RC = CT / 8
// columns by NRG row groups of RM = 8 rows. Products over a decoder layer's
// rows take MT = kWide (2 groups of 128 threads), those over a few rows (the
// nets, the latent) MT = kNarrow (8 groups of 32), so that a chunk of a small
// product costs a quarter of a wide one. Either way a thread's 8 x RC
// accumulators take 8 weights and RC inputs per row of k. The groups' partial
// sums meet in shared memory at the end of a pass (finish_pass).
constexpr int kWide = 128;
constexpr int kNarrow = 32;
constexpr int kStages = 3;  // weight chunks in flight

template <int CT, int MT>
struct Tile {
  static constexpr int KG = MT == kWide ? 2 : 8;  // groups over the reduction rows
  static constexpr int GT = kThreads / KG;        // threads per group
  static constexpr int KH = KC / KG;              // a group's rows of a chunk
  static constexpr int NCG = 8;                   // column groups
  static constexpr int NRG = GT / NCG;            // row groups
  static constexpr int RC = CT / NCG;             // columns per thread
  static constexpr int RM = MT / NRG;             // rows per thread
  // k rows per weight load of a transposed chunk: 4 while the accumulators
  // leave room for RM float4s, else 2
  static constexpr int KW = RM * RC >= 64 ? 2 : 4;
  static_assert(RC >= 1 && RC * NCG == CT, "tile columns");
  static_assert(RM == 8 && RM * NRG == MT && KH % KW == 0, "tile rows");
  static_assert(KC * MT % kThreads == 0 && KC * CT % kThreads == 0, "staging");
  // the pass row of a thread's row r: a forward chunk gives a thread RM
  // neighbouring rows (read as two float4s), a transposed one every NRG-th
  // row (so that the row groups of a warp read different banks)
  __device__ static constexpr int row(bool wt, int tm, int r) {
    return wt ? tm + NRG * r : tm * RM + r;
  }
};

// A staged weight chunk: [KC][MT + 4] for a forward product (outputs
// fastest, as W (in, out) holds them), [MT][KC + 4] for a transposed one
// (the reduction fastest, as W holds it); both rows are 16-byte aligned.
template <int MT>
__host__ __device__ constexpr int wslot_floats() {
  return KC * (MT + 4) > MT * (KC + 4) ? KC * (MT + 4) : MT * (KC + 4);
}

// Floats of a product's ring: kStages wide weight slots and kStages input
// chunks. A product whose chunks all fit in it stages them at once.
template <int CT>
__host__ __device__ constexpr int ring_floats() {
  return kStages * (wslot_floats<kWide>() + KC * CT);
}

template <int R>
__device__ __forceinline__ void lds(const float* p, float (&a)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      a[4 * q] = t.x;
      a[4 * q + 1] = t.y;
      a[4 * q + 2] = t.z;
      a[4 * q + 3] = t.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(p)[q];
      a[2 * q] = t.x;
      a[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = p[q];
  }
}

// R bfloat16 weights from shared memory, widened to float: 8 bytes at a
// time when R is a multiple of 4 (p 8-byte aligned), 4 when of 2.
template <int R>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&a)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const uint2 t = reinterpret_cast<const uint2*>(p)[q];
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
      a[4 * q] = lo.x;
      a[4 * q + 1] = lo.y;
      a[4 * q + 2] = hi.x;
      a[4 * q + 3] = hi.y;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const float2 t = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[q]);
      a[2 * q] = t.x;
      a[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = __bfloat162float(p[q]);
  }
}

// 4-byte asynchronous copy global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 16-byte asynchronous copy global -> shared through the L2 only (weights,
// and data that other CTAs of the cluster wrote), zero-filled when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// 8-byte asynchronous copy global -> shared (four bfloat16 weights),
// zero-filled when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copy of n floats (a multiple of 4, both ends 16-byte aligned)
// of global memory written by the cluster's CTAs to dst, through the L2
// only; the caller commits and waits.
__device__ __forceinline__ void copy_rows(const float* src, int n, float* dst) {
  for (int e = threadIdx.x; e < n / 4; e += kThreads)
    cp_async16(dst + 4 * e, src + 4 * e, true);
}

// The same copy, waited for. The caller synchronises.
__device__ __forceinline__ void load_all(const float* src, int n, float* dst) {
  copy_rows(src, n, dst);
  cp_async_commit();
  cp_async_wait<0>();
}

// Issues the copies of weight chunk k0 .. k0 + KC - 1 for rows m0 .. m0 + MT
// - 1 into the slot W (zeros outside K x M). With vec, lw(k, j) .. lw(k, j +
// 3) (forward) or lw(k, j) .. lw(k + 3, j) (transposed) are consecutive and
// aligned to four weights for j (k) a multiple of 4, and M (K) is a
// multiple of 4: one copy moves four weights (16 bytes of float, 8 of
// bfloat16). A bfloat16 weight alone is 2 bytes, under the 4 of the
// smallest cp.async, so without vec bfloat16 weights are staged through
// registers (the nets' small products); the slot is free when they are
// stored, and read after the barrier that follows the wait.
template <int MT, bool WT, class TW, class LW>
__device__ __forceinline__ void stage_w(TW* W, int k0, int m0, int K,
                                        int M, bool vec, LW lw,
                                        const TW* dummy) {
  constexpr bool kF32 = std::is_same<TW, float>::value;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int NV = KC * MT / 4;
    static_assert(NV % kThreads == 0, "four-weight staging");
#pragma unroll
    for (int e = 0; e < NV / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int kk = WT ? 4 * (idx % (KC / 4)) : idx / (MT / 4);
      const int jj = WT ? idx / (KC / 4) : 4 * (idx % (MT / 4));
      const int k = k0 + kk, j = m0 + jj;
      const bool ok = k < K && j < M;
      TW* dst = WT ? W + jj * (KC + 4) + kk : W + kk * (MT + 4) + jj;
      if constexpr (kF32) {
        cp_async16(dst, ok ? lw(k, j) : dummy, ok);
      } else {
        cp_async8(dst, ok ? lw(k, j) : dummy, ok);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < KC * MT / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int kk = WT ? idx % KC : idx / MT;
      const int jj = WT ? idx / KC : idx % MT;
      const int k = k0 + kk, j = m0 + jj;
      const bool ok = k < K && j < M;
      TW* dst = WT ? W + jj * (KC + 4) + kk : W + kk * (MT + 4) + jj;
      if constexpr (kF32) {
        cp_async4(dst, ok ? lw(k, j) : dummy, ok);
      } else {
        *dst = ok ? *lw(k, j) : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// acc[r][c] += sum over this thread's group's KH rows k of the chunk of
// W(k, row r) A(k, column c) for its RM rows and RC columns, in the order of
// k.
template <int CT, int MT, bool WT, class TW>
__device__ __forceinline__ void chunk_fma(
    const TW* W, const float* A,
    float (&acc)[Tile<CT, MT>::RM][Tile<CT, MT>::RC]) {
  using P = Tile<CT, MT>;
  const int kg = threadIdx.x / P::GT, lt = threadIdx.x % P::GT;
  const int tc = lt % P::NCG, tm = lt / P::NCG;
  const int k0 = kg * P::KH;
  const float* a0 = A + tc * P::RC;
  if constexpr (!WT) {
    const TW* w0 = W + tm * P::RM;
#pragma unroll 4
    for (int kk = k0; kk < k0 + P::KH; ++kk) {
      float w[P::RM], a[P::RC];
      lds<P::RM>(w0 + kk * (MT + 4), w);
      lds<P::RC>(a0 + kk * CT, a);
#pragma unroll
      for (int r = 0; r < P::RM; ++r)
#pragma unroll
        for (int c = 0; c < P::RC; ++c) acc[r][c] = fmaf(w[r], a[c], acc[r][c]);
    }
  } else {
    constexpr int KW = P::KW;
    const TW* w0 = W + tm * (KC + 4);
#pragma unroll 2
    for (int kq = k0; kq < k0 + P::KH; kq += KW) {
      float wq[P::RM][KW];
#pragma unroll
      for (int r = 0; r < P::RM; ++r) lds<KW>(w0 + r * P::NRG * (KC + 4) + kq, wq[r]);
#pragma unroll
      for (int i = 0; i < KW; ++i) {
        float a[P::RC];
        lds<P::RC>(a0 + (kq + i) * CT, a);
#pragma unroll
        for (int r = 0; r < P::RM; ++r)
#pragma unroll
          for (int c = 0; c < P::RC; ++c) acc[r][c] = fmaf(wq[r][i], a[c], acc[r][c]);
      }
    }
  }
}

// The end of a pass: every thread writes its group's partial sums to X (the
// free ring, [KG][MT][CT + 1], the row padded against bank conflicts); then the CTA's threads share out the pass's MT x
// 8 (row, column group) pairs, sum the groups' partials in group order and
// hand each row's RC sums to epi(j, c0, sums). Every thread of the CTA calls
// it.
template <int CT, int MT, bool WT, class Epi>
__device__ __forceinline__ void finish_pass(
    const float (&acc)[Tile<CT, MT>::RM][Tile<CT, MT>::RC], float* X, int m0,
    int M, Epi epi) {
  using P = Tile<CT, MT>;
  constexpr int XS = CT + 1;
  static_assert(P::KG * MT * XS <= ring_floats<CT>(), "exchange");
  const int kg = threadIdx.x / P::GT, lt = threadIdx.x % P::GT;
  const int tc = lt % P::NCG, tm = lt / P::NCG;
  float* const mine = X + kg * MT * XS + tc * P::RC;
#pragma unroll
  for (int r = 0; r < P::RM; ++r)
#pragma unroll
    for (int c = 0; c < P::RC; ++c) mine[P::row(WT, tm, r) * XS + c] = acc[r][c];
  __syncthreads();
  for (int pr = threadIdx.x; pr < MT * P::NCG; pr += kThreads) {
    const int jj = pr / P::NCG, c0 = (pr % P::NCG) * P::RC;
    const float* x = X + jj * XS + c0;
    float f[P::RC];
#pragma unroll
    for (int c = 0; c < P::RC; ++c) f[c] = x[c];
#pragma unroll
    for (int g = 1; g < P::KG; ++g)
#pragma unroll
      for (int c = 0; c < P::RC; ++c) f[c] += x[g * MT * XS + c];
    if (m0 + jj < M) epi(m0 + jj, c0, f);
  }
  __syncthreads();  // X (the ring) is free again
}

// out[j][c] = sum_k W(k, j) A(k, c) for this CTA's output rows j < M and the
// CT columns, handed to epi(j, c0, acc) for the RC columns c0 .. c0 + RC - 1
// of each row a thread computes. lw(k, j) is the address of W(k, j) in
// global memory, a float or a bfloat16 (vec: see stage_w; a slot holds
// either in its first bytes); WT says that W's memory has k fastest for a
// fixed j (a transposed product). stage_a(t, dst) issues or makes the
// copy of input chunk t (rows t KC .. t KC + KC - 1 of A, [KC][CT], zeros
// past K) into dst; with async_a it issues cp.async copies, else it stores
// through registers. If every chunk of a pass fits in the ring (stage,
// ring_floats<CT>() floats, 16-byte aligned), all are staged at once and
// waited for once; else they stream through kStages slots, kStages - 1
// chunks ahead (the input chunks of a register-staged A one chunk ahead).
// Every thread of the CTA calls it; the caller synchronises before the
// outputs are read.
template <int CT, int MT, bool WT, bool async_a, class LW, class SA, class Epi>
__device__ __forceinline__ void product_core(int K, int M, float* stage,
                                             bool vec, LW lw, SA stage_a,
                                             Epi epi) {
  using P = Tile<CT, MT>;
  using TW = std::remove_cv_t<std::remove_pointer_t<decltype(lw(0, 0))>>;
  constexpr int WS = wslot_floats<MT>();
  constexpr int AS = KC * CT;
  constexpr int kAll = ring_floats<CT>() / (WS + AS);  // chunks that fit at once
  const int nk = (K + KC - 1) / KC;
  if (M <= 0) return;
  const TW* const dummy = lw(0, 0);
  // weight slot t of the ring
  auto slot = [&](int t, int ws) { return reinterpret_cast<TW*>(stage + t * ws); };
  for (int m0 = 0; m0 < M; m0 += MT) {
    float acc[P::RM][P::RC];
#pragma unroll
    for (int r = 0; r < P::RM; ++r)
#pragma unroll
      for (int c = 0; c < P::RC; ++c) acc[r][c] = 0.f;
    if (nk <= kAll) {
      float* const A0 = stage + nk * WS;
      for (int t = 0; t < nk; ++t) {
        stage_w<MT, WT>(slot(t, WS), t * KC, m0, K, M, vec, lw, dummy);
        stage_a(t, A0 + t * AS);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int t = 0; t < nk; ++t)
        chunk_fma<CT, MT, WT>(slot(t, WS), A0 + t * AS, acc);
    } else {
      constexpr int WSR = wslot_floats<kWide>();
      float* const A0 = stage + kStages * WSR;
      auto issue = [&](int t) {
        if (t < nk) {
          stage_w<MT, WT>(slot(t % kStages, WSR), t * KC, m0, K, M, vec, lw, dummy);
          if (async_a) stage_a(t, A0 + (t % kStages) * AS);
        }
        cp_async_commit();
      };
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) issue(t);
      if (!async_a) stage_a(0, A0);
      for (int t = 0; t < nk; ++t) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk t landed; chunk t - 1's slots are free
        issue(t + kStages - 1);
        if (!async_a && t + 1 < nk) stage_a(t + 1, A0 + ((t + 1) % kStages) * AS);
        chunk_fma<CT, MT, WT>(slot(t % kStages, WSR), A0 + (t % kStages) * AS, acc);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every chunk consumed: the ring takes the partial sums
    finish_pass<CT, MT, WT>(acc, stage, m0, M, epi);
  }
}

// The product with A read element by element through la(k, c) (from the
// cluster's shared memory).
template <int CT, int MT, bool WT, class LW, class LA, class Epi>
__device__ __forceinline__ void product(int K, int M, float* stage, bool vec,
                                        LW lw, LA la, Epi epi) {
  product_core<CT, MT, WT, false>(
      K, M, stage, vec, lw,
      [&](int t, float* dst) {
        const int k0 = t * KC;
#pragma unroll 4
        for (int e = threadIdx.x; e < KC * CT; e += kThreads) {
          const int kk = e / CT, k = k0 + kk;
          dst[e] = k < K ? la(k, e - kk * CT) : 0.f;
        }
      },
      epi);
}

// The product with A a [K][CT] array in global memory (an activation that
// the cluster's CTAs wrote there, read through the L2), copied to shared
// memory asynchronously beside the weights.
template <int CT, int MT, bool WT, class LW, class Epi>
__device__ __forceinline__ void product_g(int K, int M, float* stage, bool vec,
                                          LW lw, const float* __restrict__ Ag,
                                          Epi epi) {
  product_core<CT, MT, WT, true>(
      K, M, stage, vec, lw,
      [&](int t, float* dst) {
        const int k0 = t * KC;
        const int nv = (K - k0 < KC ? K - k0 : KC) * (CT / 4);
        const float* src = Ag + static_cast<size_t>(k0) * CT;
        for (int u = threadIdx.x; u < KC * CT / 4; u += kThreads)
          cp_async16(dst + 4 * u, u < nv ? src + 4 * u : Ag, u < nv);
      },
      epi);
}

__device__ __forceinline__ float softplus(float p) {
  return fmaxf(p, 0.f) + log1pf(expf(-fabsf(p)));
}

// sigmoid(p) from h = softplus(p): 1 - exp(-h)
__device__ __forceinline__ float sigmoid_of_softplus(float h) {
  return -expm1f(-h);
}

// The activations of a CTA's rows: decoder hidden layers h1, h2 [Eg][Ct],
// the net's hidden layers ha [Hg][Ct], hb [H2g][Ct]; stage, the product's
// ring. Each has a whole copy in the cluster's global scratch (*g: [E][Ct],
// [E][Ct], [H][Ct], [H2][Ct]), beside d3g [P][Ct] = sigmoid(logits) - x,
// which the next product reads. With keep (the backward kernel's pass
// forward), each net application writes its hidden layers' copies and its
// outputs to a slot of its own there instead (app_work), for the way back to
// read; stq is that slot's outputs S, T, Q [3][D][Ct].
struct Work {
  float *h1, *h2, *ha, *hb, *stage;
  float *h1g, *h2g, *d3g, *hag, *hbg;
  float *keep, *stq;
};

// floats of one net application's slot of a keep scratch: the two hidden
// layers and the three outputs of the cluster's chains
__host__ __device__ inline int keep_floats(const Dims& d, int Ct) {
  return Ct * (d.H + d.H2 + 3 * d.D);
}

// The Work of net application `app` (4 per leapfrog step, in the order the
// step makes them) of a launch.
__device__ inline Work app_work(const Work& s, const Dims& d, int Ct, int app) {
  Work x = s;
  if (s.keep) {
    x.hag = s.keep + static_cast<size_t>(app) * keep_floats(d, Ct);
    x.hbg = x.hag + d.H * Ct;
    x.stq = x.hbg + d.H2 * Ct;
  }
  return x;
}

// floats of a cluster's global scratch of activations (Work's *g arrays)
__host__ __device__ inline int act_floats(const Dims& d, int Ct) {
  return Ct * (2 * d.E + d.P + d.H + d.H2);
}

// Work's *g arrays in a cluster's act_floats
__device__ inline void carve_act(Work& s, float* p, const Dims& d, int Ct) {
  s.h1g = p; p += d.E * Ct;
  s.h2g = p; p += d.E * Ct;
  s.d3g = p; p += d.P * Ct;
  s.hag = p; p += d.H * Ct;
  s.hbg = p;
}

// The leapfrog state of a CTA's latent rows: [Dg][Ct] arrays.
struct State {
  float *z, *v, *g;   // position, momentum, energy gradient at z
  float *S, *Tt, *Q;  // the last net application's outputs
  float* bin;         // the x-net's masked second input
  float* ldp;         // log-det terms
};

// The gradient of U(z | x) = BCE(decoder(z), x) + 0.5 |z|^2 for the
// cluster's Ct chains (chains >= N read x = 0): z and g are row-split [Dg][Ct]
// arrays. One forward sweep keeps the two softplus layers, from which the
// sweep back recovers sigmoid(p) = 1 - exp(-softplus(p)); it overwrites them
// in place. With an `energy` [Ct] array (the sampler), this CTA's share of
// U's value goes there: the BCE terms of its pixel rows and 0.5 z^2 of its
// latent rows, each summed in a fixed order; the caller adds the ranks'
// shares in rank order. The training kernels pass none and U is not formed.
// The global copies, which only the next product reads, hold each value as
// that product's operand (rnd<TW>); h1, h2 keep theirs. Ends with a cluster
// barrier.
template <int CT, class TW, class En = std::nullptr_t>
__device__ __noinline__ void decoder_grad(const Dims& d, const Part& q, const Decoder<TW>& w,
                             const float* __restrict__ xraw, int N,
                             const float* z, float* g, const Work& s,
                             En energy = nullptr) {
  constexpr bool kEnergy = !std::is_same<En, std::nullptr_t>::value;
  constexpr int RC = Tile<CT, kNarrow>::RC;
  const int e0 = q.r * q.Eg, p0 = q.r * q.Pg, i0 = q.r * q.Dg;
  float* const h1 = s.h1;
  float* const h2 = s.h2;
  float* const h1g = s.h1g + e0 * CT;  // this CTA's rows of the global copies
  float* const h2g = s.h2g + e0 * CT;
  float* const d3g = s.d3g + p0 * CT;
  const bool vec = decoder_vec(d, w);
  product<CT, kWide, false>(
      d.D, q.En, s.stage, vec,
      [&](int k, int j) { return w.W1 + static_cast<size_t>(k) * d.E + e0 + j; },
      [&](int k, int c) { return rnd<TW>(dget(z, q.Dg, CT, k, c)); },
      [&](int j, int c0, const float (&acc)[RC]) {
        const float b = w.b1[e0 + j];
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          const float h = softplus(acc[u] + b);
          h1[j * CT + c0 + u] = h;
          h1g[j * CT + c0 + u] = rnd<TW>(h);
        }
      });
  csync();
  product_g<CT, kWide, false>(
      d.E, q.En, s.stage, vec,
      [&](int k, int j) { return w.W2 + static_cast<size_t>(k) * d.E + e0 + j; },
      s.h1g,
      [&](int j, int c0, const float (&acc)[RC]) {
        const float b = w.b2[e0 + j];
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          const float h = softplus(acc[u] + b);
          h2[j * CT + c0 + u] = h;
          h2g[j * CT + c0 + u] = rnd<TW>(h);
        }
      });
  csync();
  // with kEnergy, a thread's BCE terms: its epilogues all take the column
  // group threadIdx.x % NCG (finish_pass hands out pairs kThreads apart)
  float part[RC];
#pragma unroll
  for (int u = 0; u < RC; ++u) part[u] = 0.f;
  product_g<CT, kWide, false>(
      d.E, q.Pn, s.stage, vec,
      [&](int k, int j) { return w.W3 + static_cast<size_t>(k) * d.P + p0 + j; },
      s.h2g,
      [&](int j, int c0, const float (&acc)[RC]) {
        const float b = w.b3[p0 + j];
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          const int n = q.n0 + c0 + u;
          const float x = n < N ? xraw[static_cast<size_t>(p0 + j) * N + n] : 0.f;
          if constexpr (kEnergy) {
            const float l = acc[u] + b;
            d3g[j * CT + c0 + u] = rnd<TW>(1.f / (1.f + expf(-l)) - x);
            part[u] += fmaxf(l, 0.f) - l * x + log1pf(expf(-fabsf(l)));
          } else {
            d3g[j * CT + c0 + u] = rnd<TW>(1.f / (1.f + expf(-(acc[u] + b))) - x);
          }
        }
      });
  if constexpr (kEnergy) {
    // the threads' terms summed per chain in thread order through the free
    // ring, then this CTA's latent rows of 0.5 |z|^2
    constexpr int NCG = Tile<CT, kWide>::NCG;
    static_assert(kThreads % NCG == 0, "a thread keeps one column group");
    float* const red = s.stage;
#pragma unroll
    for (int u = 0; u < RC; ++u) red[threadIdx.x * RC + u] = part[u];
    __syncthreads();
    if (threadIdx.x < CT) {
      const int c = threadIdx.x, cg0 = c / RC, u = c - cg0 * RC;
      float e = 0.f;
      for (int t = cg0; t < kThreads; t += NCG) e += red[t * RC + u];
      float zz = 0.f;
      for (int j = 0; j < q.Dn; ++j) zz = fmaf(z[j * CT + c], z[j * CT + c], zz);
      energy[c] = e + 0.5f * zz;
    }
  }
  csync();
  product_g<CT, kWide, true>(
      d.P, q.En, s.stage, vec,
      [&](int k, int j) { return w.W3 + static_cast<size_t>(e0 + j) * d.P + k; },
      s.d3g,
      [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          float* h = h2 + j * CT + c0 + u;
          *h = acc[u] * sigmoid_of_softplus(*h);
          h2g[j * CT + c0 + u] = rnd<TW>(*h);
        }
      });
  csync();
  product_g<CT, kWide, true>(
      d.E, q.En, s.stage, vec,
      [&](int k, int j) { return w.W2 + static_cast<size_t>(e0 + j) * d.E + k; },
      s.h2g,
      [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          float* h = h1 + j * CT + c0 + u;
          *h = acc[u] * sigmoid_of_softplus(*h);
          h1g[j * CT + c0 + u] = rnd<TW>(*h);
        }
      });
  csync();
  product_g<CT, kNarrow, true>(
      d.E, q.Dn, s.stage, vec,
      [&](int k, int j) { return w.W1 + static_cast<size_t>(i0 + j) * d.E + k; },
      s.h1g,
      [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
        for (int u = 0; u < RC; ++u) g[j * CT + c0 + u] = acc[u] + z[j * CT + c0 + u];
      });
  csync();
}

// The S/T/Q net on the row-split [Dg][Ct] inputs a, b, each chain c at its
// step step_of(d, it, fw, c): S, T, Q [Dg][Ct] (this CTA's
// latent rows). emb is the (H, N) aux embedding in global memory. The
// hidden layers' global copies hold the next product's operands (rnd<TW>).
// Synchronised within the CTA on return; S, T, Q are read only by their own
// CTA.
template <int CT, class TW>
__device__ __noinline__ void apply_net(const Dims& d, const Part& q, const Net<TW>& w,
                          const float* __restrict__ emb, int N, int it, uint64_t fw,
                          const float* a, const float* b, float* S, float* T, float* Q,
                          const Work& s) {
  constexpr int RC = Tile<CT, kNarrow>::RC;
  const int h0 = q.r * q.Hg, g0 = q.r * q.H2g, i0 = q.r * q.Dg;
  float* const ha = s.ha;
  float* const hb = s.hb;
  float* const hag = s.hag + h0 * CT;  // this CTA's rows of the global copies
  float* const hbg = s.hbg + g0 * CT;
  product<CT, kNarrow, false>(
      2 * d.D, q.Hn, s.stage, false,
      [&](int k, int j) {
        return k < d.D ? w.w1 + k * d.H + h0 + j
                       : w.w2 + (k - d.D) * d.H + h0 + j;
      },
      [&](int k, int c) {
        return rnd<TW>(k < d.D ? dget(a, q.Dg, CT, k, c) : dget(b, q.Dg, CT, k - d.D, c));
      },
      [&](int j, int c0, const float (&acc)[RC]) {
        // the time-embedding column of each chain, read before the stores
        float t[RC];
#pragma unroll
        for (int u = 0; u < RC; ++u) t[u] = w.te[(h0 + j) * d.T + step_of(d, it, fw, c0 + u)];
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          const int n = q.n0 + c0 + u;
          const float e = n < N ? emb[static_cast<size_t>(h0 + j) * N + n] : 0.f;
          const float h = fmaxf(acc[u] + t[u] + e, 0.f);
          ha[j * CT + c0 + u] = h;
          hag[j * CT + c0 + u] = rnd<TW>(h);
        }
      });
  csync();
  product_g<CT, kNarrow, false>(
      d.H, q.H2n, s.stage, false,
      [&](int k, int j) { return w.wh + k * d.H2 + g0 + j; },
      s.hag,
      [&](int j, int c0, const float (&acc)[RC]) {
        const float bias = w.bh[g0 + j];
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          const float h = fmaxf(acc[u] + bias, 0.f);
          hb[j * CT + c0 + u] = h;
          hbg[j * CT + c0 + u] = rnd<TW>(h);
        }
      });
  csync();
  // the three heads on this CTA's latent rows: local row j = head * Dn + il
  const int Dn = q.Dn;
  product_g<CT, kNarrow, false>(
      d.H2, 3 * Dn, s.stage, false,
      [&](int k, int j) {
        const int head = j / Dn;
        const TW* W = head == 0 ? w.ws : (head == 1 ? w.wt : w.wq);
        return W + k * d.D + i0 + j - head * Dn;
      },
      s.hbg,
      [&](int j, int c0, const float (&acc)[RC]) {
        const int head = j / Dn;
        const int il = j - head * Dn, i = i0 + il;
        float* out = head == 0 ? S : (head == 1 ? T : Q);
        out += il * CT + c0;
        if (head == 1) {
          const float bias = w.bt[i];
#pragma unroll
          for (int u = 0; u < RC; ++u) out[u] = acc[u] + bias;
        } else {
          const float sc = expf(head == 0 ? w.ls[i] : w.lq[i]);
          const float bias = head == 0 ? w.bs[i] : w.bq[i];
#pragma unroll
          for (int u = 0; u < RC; ++u) out[u] = sc * tanhf(acc[u] + bias);
        }
        if (s.stq) {
          float* kept = s.stq + (head * d.D + i) * CT + c0;
#pragma unroll
          for (int u = 0; u < RC; ++u) kept[u] = out[u];
        }
      });
  __syncthreads();
}

// v' = v exp(eps S / 2) + eps / 2 (-exp(eps Q) g + T), or its inverse, on
// this CTA's rows, each chain in its own direction; also stages the x-net's
// second input. The caller synchronises.
template <int CT>
__device__ __forceinline__ void momentum_update(const Dims& d, const Part& q,
                                                const float* __restrict__ eps,
                                                const float* __restrict__ masks,
                                                int it, uint64_t fw, const State& t) {
  const int i0 = q.r * q.Dg;
  for (int e = threadIdx.x; e < q.Dn * CT; e += kThreads) {
    const int r = e / CT, c = e - r * CT, i = i0 + r;
    const float ep = eps[i];
    const float drift = 0.5f * ep * (-expf(ep * t.Q[e]) * t.g[e] + t.Tt[e]);
    const float sv = 0.5f * ep * t.S[e];
    const float m = masks[i * d.T + step_of(d, it, fw, c)];
    if (fwd_of(fw, c)) {
      t.v[e] = t.v[e] * expf(sv) + drift;
      t.ldp[e] += sv;
      t.bin[e] = m * t.z[e];
    } else {
      t.v[e] = (t.v[e] - drift) * expf(-sv);
      t.ldp[e] -= sv;
      t.bin[e] = (1.f - m) * t.z[e];
    }
  }
}

// The masked position update on this CTA's rows; the first of a step keeps
// the mask's entries (forward) or its complement (reverse), the second the
// others. The caller synchronises.
template <int CT>
__device__ __forceinline__ void position_update(const Dims& d, const Part& q,
                                                const float* __restrict__ eps,
                                                const float* __restrict__ masks,
                                                int it, uint64_t fw, const State& t,
                                                bool first) {
  const int i0 = q.r * q.Dg;
  for (int e = threadIdx.x; e < q.Dn * CT; e += kThreads) {
    const int r = e / CT, c = e - r * CT, i = i0 + r;
    const bool fwd = fwd_of(fw, c);
    const float ep = eps[i];
    const float m = masks[i * d.T + step_of(d, it, fw, c)];
    const float keep = (fwd == first) ? m : 1.f - m;
    const float upd = 1.f - keep;
    const float drift = ep * (expf(ep * t.Q[e]) * t.v[e] + t.Tt[e]);
    const float sx = ep * t.S[e];
    float zn;
    if (fwd) {
      zn = keep * t.z[e] + upd * (t.z[e] * expf(sx) + drift);
      t.ldp[e] += upd * sx;
    } else {
      zn = keep * t.z[e] + upd * expf(-sx) * (t.z[e] - drift);
      t.ldp[e] -= upd * sx;
    }
    t.z[e] = zn;
    t.bin[e] = upd * zn;  // the second update keeps what this one changed
  }
}

// Leapfrog step `it` of a trajectory, each chain in its direction (bit c of
// fw): half momentum update, the two masked position updates, the decoder
// gradient at the new position (and the energy's share there, as
// decoder_grad), half momentum update. t.g holds the gradient at t.z on
// entry and on return. tap(0) runs when t.v holds the half-updated
// momentum, tap(1) when t.z holds the position between the two updates.
// Ends with a cluster barrier.
template <int CT, class TW, class Tap, class En = std::nullptr_t>
__device__ __noinline__ void leapfrog_step(const Dims& d, const Part& q, const Weights<TW>& w,
                              const float* __restrict__ xraw,
                              const float* __restrict__ emb, int N, int it,
                              uint64_t fw, const State& t, const Work& s, Tap tap,
                              En energy = nullptr) {
  static_assert(CT <= 64, "one bit of fw per chain");
  apply_net<CT>(d, q, w.vnet, emb, N, it, fw, t.z, t.g, t.S, t.Tt, t.Q,
                app_work(s, d, CT, 4 * it));
  momentum_update<CT>(d, q, w.eps, w.masks, it, fw, t);
  __syncthreads();
  tap(0);
  csync();
  apply_net<CT>(d, q, w.xnet, emb, N, it, fw, t.v, t.bin, t.S, t.Tt, t.Q,
                app_work(s, d, CT, 4 * it + 1));
  position_update<CT>(d, q, w.eps, w.masks, it, fw, t, true);
  __syncthreads();
  tap(1);
  csync();
  apply_net<CT>(d, q, w.xnet, emb, N, it, fw, t.v, t.bin, t.S, t.Tt, t.Q,
                app_work(s, d, CT, 4 * it + 2));
  position_update<CT>(d, q, w.eps, w.masks, it, fw, t, false);
  csync();
  decoder_grad<CT>(d, q, w.dec, xraw, N, t.z, t.g, s, energy);
  apply_net<CT>(d, q, w.vnet, emb, N, it, fw, t.z, t.g, t.S, t.Tt, t.Q,
                app_work(s, d, CT, 4 * it + 3));
  momentum_update<CT>(d, q, w.eps, w.masks, it, fw, t);
  csync();
}

// Loads this CTA's rows [row0, row0 + rows) of a (., N) array's chains n0 ..
// n0 + CT - 1 into a [.][CT] array (0 for chains >= N). The caller
// synchronises.
template <int CT>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int row0, int rows, int N, int n0,
                                          float* dst) {
  for (int e = threadIdx.x; e < rows * CT; e += kThreads) {
    const int i = e / CT, n = n0 + e - i * CT;
    dst[e] = n < N ? src[static_cast<size_t>(row0 + i) * N + n] : 0.f;
  }
}

// Stores a [.][CT] array's first rows into rows row0 .. of a (., N) array.
template <int CT>
__device__ __forceinline__ void store_rows(const float* src, int row0,
                                           int rows, int N, int n0,
                                           float* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * CT; e += kThreads) {
    const int i = e / CT, n = n0 + e - i * CT;
    if (n < N) dst[static_cast<size_t>(row0 + i) * N + n] = src[e];
  }
}

}  // namespace vaec
}  // namespace l2hmc
