// Shared pieces of the AIS kernel (vae_ais.cu and its weight stream,
// vae_stream.cuh): the decoder's packed layout, the per-CTA activations of a
// tile of C chains, the draws and the accept; vae_chain.cu takes the draws'
// layout and the accept from here too.
//
// Layout. A CTA keeps all activations of its tile of C chains in shared
// memory as [rows][C] arrays, so one float4 read gives one row of a
// product's right-hand side for four chains. The weights (7.5 MB of decoder)
// fit in no shared memory; they stay in global memory, where the 50 MB L2
// holds them, and are streamed through the cluster's ring
// (vae_stream.cuh). The stream reads every matrix "k-major" (reduction
// index slowest), so the host packs the decoder in both layouts: (in, out)
// for the forward products and (out, in) for the transposed ones of the
// gradient sweep.
//
// Nothing crosses clusters: chains are independent, so a kernel loops over
// all its anneal steps inside the launch and needs no grid sync.
//
// The weight matrices are of type TW: float, or __nv_bfloat16 for the
// bfloat16 operands of the JAX package's compute_dtype; the biases are
// float either way.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "operand.cuh"

namespace l2hmc {
namespace vae {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // bytes one CTA may use on Hopper

// latent dim, S/T/Q hidden widths, leapfrog steps, decoder hidden, pixels
struct Dims {
  int D, H, H2, T, E, P;
};

// Decoder weights: W* are (in, out) row-major, W*t their transposes.
template <class TW>
struct Decoder {
  const TW* W1;
  const float* b1;
  const TW* W2;
  const float* b2;
  const TW* W3;
  const float* b3;
  const TW *W1t, *W2t, *W3t;
};

// An array of n elements of type A from the packed block at p, which
// advances past it and its padding to whole 16 bytes.
template <class A>
inline const A* take16(const unsigned char*& p, size_t n) {
  const A* q = reinterpret_cast<const A*>(p);
  p += (n * sizeof(A) + 15) / 16 * 16;
  return q;
}

// The decoder's slice of the packed parameter block, in the order
// ops/fused_vae.py packs it (_pack_decoder): each array padded to whole 16
// bytes, so that each starts on 16 bytes of a 16-byte aligned block (the
// AIS kernel's bulk copies need it).
template <class TW>
inline Decoder<TW> carve_decoder(const unsigned char*& p, const Dims& d) {
  Decoder<TW> w;
  const size_t D = d.D, E = d.E, P = d.P;
  w.W1 = take16<TW>(p, D * E);
  w.b1 = take16<float>(p, E);
  w.W2 = take16<TW>(p, E * E);
  w.b2 = take16<float>(p, E);
  w.W3 = take16<TW>(p, E * P);
  w.b3 = take16<float>(p, P);
  w.W1t = take16<TW>(p, E * D);
  w.W2t = take16<TW>(p, E * E);
  w.W3t = take16<TW>(p, P * E);
  return w;
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

__device__ __forceinline__ float softplus(float p) {
  return fmaxf(p, 0.f) + log1pf(expf(-fabsf(p)));
}

// sigmoid(p) from h = softplus(p): 1 - exp(-h)
__device__ __forceinline__ float sigmoid_of_softplus(float h) {
  return -expm1f(-h);
}

// The per-CTA activations the decoder works in.
template <int C>
struct Work {
  float *h1, *h2;  // [E][C] decoder hidden layers, reused by the sweep back
  float* d3;       // [P][C] sigmoid(logits) - x
  float* red;      // [kWarps][C]
};

template <int C>
__host__ __device__ inline int work_floats(const Dims& d) {
  return C * (2 * d.E + d.P + kWarps);
}

template <int C>
__device__ inline Work<C> carve_work(float*& p, const Dims& d) {
  Work<C> w;
  w.h1 = p; p += d.E * C;
  w.h2 = p; p += d.E * C;
  w.d3 = p; p += d.P * C;
  w.red = p; p += kWarps * C;
  return w;
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
