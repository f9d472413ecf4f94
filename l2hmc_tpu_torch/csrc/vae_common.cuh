// Shared pieces of the two VAE kernels (vae_chain.cu, vae_ais.cu): the
// block-wide matrix product, the decoder energy with its analytic
// gradient, and the aux-conditioned S/T/Q net.
//
// Design. The SCG kernels give one thread one chain; here the latent is 50
// wide, the nets 200 and the decoder 1024, so one block of kThreads threads
// works together on a tile of C chains (C = 4 or 8, a template parameter
// chosen by the caller from the chain count). All activations of the tile
// live in shared memory as [rows][C] arrays, so one float4 read gives one
// row of a product's right-hand side for four chains. The weights (7.5 MB
// of decoder, 0.7 MB of nets) fit in no shared memory; they stay in global
// memory, where the 50 MB L2 holds them, and are streamed once per
// product: thread t owns output rows t, t + kThreads, ... and for each k
// reads W[k][row] (neighbouring threads read neighbouring addresses) and
// broadcasts activation row k from shared memory. That needs every weight
// matrix "k-major" (reduction index slowest), so the host passes the
// decoder in both layouts: (in, out) for the forward products and
// (out, in) for the transposed ones of the gradient sweep.
//
// Nothing crosses blocks: chains are independent, so a kernel loops over
// all its MH or anneal steps inside the block and needs no grid sync.
// Sums over rows (BCE over pixels) are reduced warp by warp and then over
// the warps in a fixed order, so a launch repeats itself bit for bit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace l2hmc {
namespace vae {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // output rows per thread and pass in the wide products
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on Hopper

// latent dim, S/T/Q hidden widths, leapfrog steps, decoder hidden, pixels
struct Dims {
  int D, H, H2, T, E, P;
};

// Decoder weights: W* are (in, out) row-major, W*t their transposes.
struct Decoder {
  const float *W1, *b1, *W2, *b2, *W3, *b3, *W1t, *W2t, *W3t;
};

// One S/T/Q net: embeds w1, w2 (D, H); hidden wh (H, H2), bh; the three
// heads packed as wo (H2, 3 D) = [ws | wt | wq] with bs, ls, bt, bq, lq
// (D each); te (H, T), the time embedding with the embed biases folded in.
struct Net {
  const float *w1, *w2, *wh, *bh, *wo, *bs, *ls, *bt, *bq, *lq, *te;
};

inline const float* take(const float*& p, size_t n) {
  const float* q = p;
  p += n;
  return q;
}

// The decoder's slice of the packed parameter block, in the order
// ops/fused_vae.py packs it.
inline Decoder carve_decoder(const float*& p, const Dims& d) {
  Decoder w;
  const size_t D = d.D, E = d.E, P = d.P;
  w.W1 = take(p, D * E);
  w.b1 = take(p, E);
  w.W2 = take(p, E * E);
  w.b2 = take(p, E);
  w.W3 = take(p, E * P);
  w.b3 = take(p, P);
  w.W1t = take(p, E * D);
  w.W2t = take(p, E * E);
  w.W3t = take(p, P * E);
  return w;
}

inline Net carve_net(const float*& p, const Dims& d) {
  Net w;
  const size_t D = d.D, H = d.H, H2 = d.H2, T = d.T;
  w.w1 = take(p, D * H);
  w.w2 = take(p, D * H);
  w.wh = take(p, H * H2);
  w.bh = take(p, H2);
  w.wo = take(p, H2 * 3 * D);
  w.bs = take(p, D);
  w.ls = take(p, D);
  w.bt = take(p, D);
  w.bq = take(p, D);
  w.lq = take(p, D);
  w.te = take(p, H * T);
  return w;
}

template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

// -- device ------------------------------------------------------------------

template <int C>
__device__ __forceinline__ void load_row(const float* p, float (&a)[C]) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p)[q];
    a[4 * q] = t.x;
    a[4 * q + 1] = t.y;
    a[4 * q + 2] = t.z;
    a[4 * q + 3] = t.w;
  }
}

// acc[r][c] += sum_k W[k * M + m[r]] * in[k * C + c]
template <int C, int R>
__device__ __forceinline__ void accumulate(const float* __restrict__ W, int M,
                                           int K, const float* in,
                                           const int (&m)[R],
                                           float (&acc)[R][C]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[C];
    load_row<C>(in + k * C, a);
    const float* row = W + static_cast<size_t>(k) * M;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w = m[r] < M ? __ldg(row + m[r]) : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(w, a[c], acc[r][c]);
    }
  }
}

// out[m][c] = sum_k W1[k][m] in1[k][c] (+ sum_k W2[k][m] in2[k][c] when
// K2 > 0) for m < M, handed row by row to epi(m, acc). in1 and in2 are
// [K][C] arrays in shared memory, 16-byte aligned; W1 and W2 are k-major
// in global memory. The caller synchronises before the outputs are read.
template <int C, int R, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ W1, int K1,
                                        const float* in1,
                                        const float* __restrict__ W2, int K2,
                                        const float* in2, int M, Epi epi) {
  for (int m0 = threadIdx.x; m0 < M; m0 += R * kThreads) {
    int m[R];
    float acc[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = m0 + r * kThreads;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
    }
    accumulate<C, R>(W1, M, K1, in1, m, acc);
    if (K2 > 0) accumulate<C, R>(W2, M, K2, in2, m, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (m[r] < M) epi(m[r], acc[r]);
  }
}

// Sums part[c] over the block in a fixed order into out[c] (shared
// memory); every thread calls it. red holds kWarps * C floats.
template <int C>
__device__ __forceinline__ void block_sum(float (&part)[C], float* red,
                                          float* out) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) red[(threadIdx.x >> 5) * C + c] = part[c];
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * C + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float softplus(float p) {
  return fmaxf(p, 0.f) + log1pf(expf(-fabsf(p)));
}

// sigmoid(p) from h = softplus(p): 1 - exp(-h)
__device__ __forceinline__ float sigmoid_of_softplus(float h) {
  return -expm1f(-h);
}

// The per-block activations the decoder and the nets work in.
template <int C>
struct Work {
  float *h1, *h2;  // [E][C] decoder hidden layers, reused by the sweep back
  float* d3;       // [P][C] sigmoid(logits) - x
  float *ha, *hb;  // [H][C], [H2][C] net hidden layers
  float* red;      // [kWarps][C]
};

template <int C>
__host__ __device__ inline int work_floats(const Dims& d) {
  return C * (2 * d.E + d.P + d.H + d.H2 + kWarps);
}

template <int C>
__device__ inline Work<C> carve_work(float*& p, const Dims& d) {
  Work<C> w;
  w.h1 = p; p += d.E * C;
  w.h2 = p; p += d.E * C;
  w.d3 = p; p += d.P * C;
  w.ha = p; p += d.H * C;
  w.hb = p; p += d.H2 * C;
  w.red = p; p += kWarps * C;
  return w;
}

// Value and gradient of U(z | x) = BCE(decoder(z), x) + 0.5 |z|^2 for the
// block's C chains (chain c is global chain n0 + c; chains >= N read x = 0).
// z and g are [D][C], energy [C], all in shared memory. One forward sweep
// keeps the two softplus layers, from which the sweep back recovers
// sigmoid(p) = 1 - exp(-softplus(p)); it overwrites them in place.
// Synchronised on return.
template <int C>
__device__ void decoder_grad(const Dims& d, const Decoder& w,
                             const float* __restrict__ xraw, int N, int n0,
                             const float* z, float* g, float* energy,
                             const Work<C>& s) {
  float* h1 = s.h1;
  float* h2 = s.h2;
  float* d3 = s.d3;
  product<C, kRows>(w.W1, d.D, z, nullptr, 0, nullptr, d.E,
                    [&](int m, const float (&acc)[C]) {
                      const float b = w.b1[m];
#pragma unroll
                      for (int c = 0; c < C; ++c)
                        h1[m * C + c] = softplus(acc[c] + b);
                    });
  __syncthreads();
  product<C, kRows>(w.W2, d.E, h1, nullptr, 0, nullptr, d.E,
                    [&](int m, const float (&acc)[C]) {
                      const float b = w.b2[m];
#pragma unroll
                      for (int c = 0; c < C; ++c)
                        h2[m * C + c] = softplus(acc[c] + b);
                    });
  __syncthreads();
  float part[C];
#pragma unroll
  for (int c = 0; c < C; ++c) part[c] = 0.f;
  product<C, kRows>(
      w.W3, d.E, h2, nullptr, 0, nullptr, d.P,
      [&](int m, const float (&acc)[C]) {
        const float b = w.b3[m];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int n = n0 + c;
          const float x = n < N ? xraw[static_cast<size_t>(m) * N + n] : 0.f;
          const float l = acc[c] + b;
          d3[m * C + c] = 1.f / (1.f + expf(-l)) - x;
          part[c] += fmaxf(l, 0.f) - l * x + log1pf(expf(-fabsf(l)));
        }
      });
  block_sum<C>(part, s.red, energy);
  product<C, kRows>(w.W3t, d.P, d3, nullptr, 0, nullptr, d.E,
                    [&](int m, const float (&acc)[C]) {
#pragma unroll
                      for (int c = 0; c < C; ++c)
                        h2[m * C + c] =
                            acc[c] * sigmoid_of_softplus(h2[m * C + c]);
                    });
  __syncthreads();
  product<C, kRows>(w.W2t, d.E, h2, nullptr, 0, nullptr, d.E,
                    [&](int m, const float (&acc)[C]) {
#pragma unroll
                      for (int c = 0; c < C; ++c)
                        h1[m * C + c] =
                            acc[c] * sigmoid_of_softplus(h1[m * C + c]);
                    });
  __syncthreads();
  product<C, 1>(w.W1t, d.E, h1, nullptr, 0, nullptr, d.D,
                [&](int m, const float (&acc)[C]) {
#pragma unroll
                  for (int c = 0; c < C; ++c)
                    g[m * C + c] = acc[c] + z[m * C + c];
                });
  if (threadIdx.x < C) {
    float q = 0.f;
    for (int i = 0; i < d.D; ++i) {
      const float zi = z[i * C + threadIdx.x];
      q = fmaf(zi, zi, q);
    }
    energy[threadIdx.x] += 0.5f * q;
  }
  __syncthreads();
}

// 0.5 sum_i a[i][c]^2 for chain c = threadIdx.x
template <int C>
__device__ __forceinline__ float half_sq(const float* a, int D) {
  float q = 0.f;
  for (int i = 0; i < D; ++i) {
    const float ai = a[i * C + threadIdx.x];
    q = fmaf(ai, ai, q);
  }
  return 0.5f * q;
}

// The S/T/Q net on [D][C] inputs a, b: S, T, Q [D][C]. step[c] is chain
// c's leapfrog step (the time-embedding column), emb the (H, N) aux
// embedding in global memory. Synchronised on return.
template <int C>
__device__ void apply_net(const Dims& d, const Net& w,
                          const float* __restrict__ emb, int N, int n0,
                          const int* step, const float* a, const float* b,
                          float* S, float* T, float* Q, const Work<C>& s) {
  float* ha = s.ha;
  float* hb = s.hb;
  product<C, 1>(w.w1, d.D, a, w.w2, d.D, b, d.H,
                [&](int m, const float (&acc)[C]) {
#pragma unroll
                  for (int c = 0; c < C; ++c) {
                    const int n = n0 + c;
                    const float e =
                        n < N ? emb[static_cast<size_t>(m) * N + n] : 0.f;
                    ha[m * C + c] =
                        fmaxf(acc[c] + w.te[m * d.T + step[c]] + e, 0.f);
                  }
                });
  __syncthreads();
  product<C, 1>(w.wh, d.H, ha, nullptr, 0, nullptr, d.H2,
                [&](int m, const float (&acc)[C]) {
                  const float bias = w.bh[m];
#pragma unroll
                  for (int c = 0; c < C; ++c)
                    hb[m * C + c] = fmaxf(acc[c] + bias, 0.f);
                });
  __syncthreads();
  product<C, 1>(w.wo, d.H2, hb, nullptr, 0, nullptr, 3 * d.D,
                [&](int m, const float (&acc)[C]) {
                  const int head = m / d.D;
                  const int i = m - head * d.D;
                  if (head == 0) {
                    const float sc = expf(w.ls[i]), bias = w.bs[i];
#pragma unroll
                    for (int c = 0; c < C; ++c)
                      S[i * C + c] = sc * tanhf(acc[c] + bias);
                  } else if (head == 1) {
                    const float bias = w.bt[i];
#pragma unroll
                    for (int c = 0; c < C; ++c) T[i * C + c] = acc[c] + bias;
                  } else {
                    const float sc = expf(w.lq[i]), bias = w.bq[i];
#pragma unroll
                    for (int c = 0; c < C; ++c)
                      Q[i * C + c] = sc * tanhf(acc[c] + bias);
                  }
                });
  __syncthreads();
}

// Fills v [D][C] with standard normals and gives chain c's two uniforms:
// Philox counter (global chain, step, slot, op) under key; slot 0 holds the
// direction uniform (word 0) and the accept uniform (word 1), slot 1 + j
// the normals 2j and 2j + 1. The caller synchronises.
template <int C>
__device__ __forceinline__ void draw(int D, int n0, int step, int op,
                                     uint2 key, float* v, float* u_dir,
                                     float* u_acc) {
  const int pairs = (D + 1) / 2;
  for (int e = threadIdx.x; e < pairs * C; e += kThreads) {
    const int j = e / C, c = e - j * C;
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(n0 + c), static_cast<uint32_t>(step),
                   static_cast<uint32_t>(1 + j), static_cast<uint32_t>(op)),
        key);
    v[(2 * j) * C + c] = box_muller(r.x, r.y);
    if (2 * j + 1 < D) v[(2 * j + 1) * C + c] = box_muller(r.z, r.w);
  }
  if (threadIdx.x < C) {
    const uint4 r0 = philox4x32_10(
        make_uint4(static_cast<uint32_t>(n0 + threadIdx.x),
                   static_cast<uint32_t>(step), 0u, static_cast<uint32_t>(op)),
        key);
    u_dir[threadIdx.x] = uniform24(r0.x);
    u_acc[threadIdx.x] = uniform24(r0.y);
  }
}

// exp(min(a, 0)) with NaN mapped to 0 (a plain fminf would hide the NaN)
__device__ __forceinline__ float accept_prob(float a) {
  const float px = expf(a > 0.f ? 0.f : a);
  return isfinite(px) ? px : 0.f;
}

}  // namespace vae
}  // namespace l2hmc
