// The decoder's weight stream shared by a thread-block cluster, and the
// decoder energy and gradient built on it (the AIS kernel, vae_ais.cu).
//
// Why. A block-wide product (the sampler's first design, since replaced)
// had every block read every weight itself, 4 bytes a thread through
// __ldg, for its tile of 8 chains:
// one load feeds 8 multiply-adds. At the AIS protocol's 1000 chains 125
// blocks each read the decoder's 15.2 MB (both layouts) per sweep, 1.9 TB
// from the L2 per launch of 1001 sweeps, ~3.1 TB/s: the stream, not the
// arithmetic, set the time (a tile of 8 took only a tenth longer than one
// of 4). At 8 chains per SM the f32 peak would need ~16.7 TB/s from the L2,
// so no design in which every SM fetches its own copy can get near it.
//
// Design. A cluster of kG CTAs, each with its own tile of kC chains and all
// of that tile's activations in its own shared memory as [rows][kC] arrays,
// as in vae_common.cuh: no activation crosses CTAs. What the cluster shares
// is the weight stream. Each product's k-major matrix is one contiguous run
// of K rows of M floats, so kc consecutive rows are one contiguous range;
// the producer thread of the cluster's rank 0 copies each such chunk from
// the L2 once with cp.async.bulk ... .multicast::cluster into the same slot
// of a ring in every CTA of the cluster (kSlots slots). Each slot has a
// "full" mbarrier in every CTA (armed by that CTA's own producer thread
// with the chunk's bytes, completed by the copy) and an "empty" mbarrier
// in rank 0, on which every consumer warp of the cluster arrives through
// the cluster-shared address once it is done with the slot; rank 0 refills
// the slot only then. The consumers issue no global load for a weight:
// thread t owns output rows 4 g .. 4 g + 3 of a product (one 16-byte shared
// load of the chunk per k) for all kC chains (kC / 4 16-byte broadcasts), 4
// kC multiply-adds per k. A product whose M is too narrow to occupy the
// block (W1t, M = D) splits its rows over S slices of threads and sums the
// slices in slice order through a free activation array.
//
// Every CTA of a cluster makes the same sweeps in the same order (the
// callers' accept and reject are selects), so all consume every chunk;
// CTAs past the chain count take part in the stream and write nothing. The
// cluster meets at a barrier after the mbarriers are initialised and again
// before any CTA exits, so no copy or remote arrive reaches an exited CTA.
//
// Alignment: cp.async.bulk needs 16-byte addresses and sizes. The host pads
// every array of the packed decoder to whole 16 bytes (ops/fused_vae.py,
// _pack_decoder), chunk_rows keeps kc M weights whole 16 bytes, and the
// last chunk of a product rounds its bytes up into the array's pad. The
// host mirrors this plan in ops/fused_vae.py (ais_chunk_plan), where the CPU
// tests hold it to these rules.
//
// bfloat16 operands (TW = __nv_bfloat16, the JAX package's
// compute_dtype="bfloat16"): the stream carries the decoder's matrices in
// bfloat16, half the bytes of a sweep, and a slot of the same 64 KB holds
// twice the rows; the consumers widen each weight to float and round each
// activation they read to bfloat16 (rnd), so each product multiplies two
// bfloat16 values exactly and sums in float32.
#pragma once
#include "cluster_launch.cuh"
#include "vae_common.cuh"

namespace l2hmc {
namespace vae {
namespace stream {

// One configuration. Clusters of 2: the card holds 66 of these CTAs' pairs
// at once, so the AIS protocol's 1000 chains (126 CTAs) run in one wave,
// which clusters of 4 do not. A ring of 2 chunks of 64 KB: each chunk costs
// its consumers a wait and a release, which outweighed a deeper ring of
// smaller chunks.
constexpr int kC = 8;                   // chains per CTA
constexpr int kG = 2;                   // CTAs per cluster
constexpr int kConsumers = kThreads;    // threads of the products (256)
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBlock = kConsumers + 32;  // plus the producer warp
constexpr int kSlots = 2;               // ring depth
constexpr int kSlotFloats = 16384;      // a chunk's floats at most (64 KB)
constexpr int kSlotPad = 4;  // floats past a chunk the last row group reads
constexpr int kSlotStride = kSlotFloats + kSlotPad;
constexpr int kProducts = 6;  // per decoder sweep

// One product: out[m][c] = sum_k W[k][m] in[k][c], W k-major (K rows of M
// weights of type TW, contiguous, 16-byte aligned), streamed in chunks of
// kc rows.
template <class TW>
struct Prod {
  const TW* W;
  int K, M, kc;
};

// The six products of a decoder sweep in the order decoder_grad runs them.
template <class TW>
struct Sweep {
  Prod<TW> p[kProducts];
};

// Rows per chunk: as many as a slot's bytes hold, with kc M weights whole
// 16 bytes so that every chunk starts on 16 bytes; 0 if M is too wide for
// a slot.
template <class TW>
__host__ __device__ inline int chunk_rows(int M) {
  constexpr int per = 16 / sizeof(TW);  // weights in 16 bytes
  int g = per;                          // gcd(M, per), per a power of 2
  while (M % g != 0) g /= 2;
  const int step = per / g;
  return (kSlotFloats * 4 / static_cast<int>(sizeof(TW)) / M) / step * step;
}

// Bytes of a chunk of `rows` rows, rounded up to 16 (into the array's pad).
template <class TW>
__host__ __device__ inline uint32_t chunk_bytes(int rows, int M) {
  const uint32_t b = static_cast<uint32_t>(rows) * static_cast<uint32_t>(M) *
                     static_cast<uint32_t>(sizeof(TW));
  return (b + 15u) & ~15u;
}

template <class TW>
inline Sweep<TW> make_sweep(const Decoder<TW>& w, const Dims& d) {
  const int in[kProducts] = {d.D, d.E, d.E, d.P, d.E, d.E};
  const int out[kProducts] = {d.E, d.E, d.P, d.E, d.E, d.D};
  const TW* W[kProducts] = {w.W1, w.W2, w.W3, w.W3t, w.W2t, w.W1t};
  Sweep<TW> s;
  for (int q = 0; q < kProducts; ++q)
    s.p[q] = Prod<TW>{W[q], in[q], out[q], chunk_rows<TW>(out[q])};
  return s;
}

// Shared memory of the ring: the full and empty mbarriers, then the slots.
__host__ __device__ inline size_t ring_bytes() {
  return 16 * kSlots + sizeof(float) * kSlots * kSlotStride;
}

// -- PTX ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Arrive on the mbarrier at CTA-local address `bar` of cluster rank `rank`
// (release at CTA scope, as a consumer's release of a slot needs: the
// slot's reads are done; a cluster-scope release costs a fence per chunk).
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// One bulk copy of `bytes` from global memory into the slot at CTA-local
// address `dst` of every CTA in `mask`, completing on each one's mbarrier
// at CTA-local address `bar`.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Barrier of every thread of the cluster (threads of a warp may arrive
// apart), ordering the shared memory of all its CTAs.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Barrier of the consumer threads alone (the producer warp runs apart).
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// -- the ring ----------------------------------------------------------------

struct Ring {
  uint32_t full, empty;  // CTA-local addresses of full[0], empty[0]
  uint32_t data;         // CTA-local address of slot 0
  const float* slots;    // the same, as a pointer
  uint32_t it;           // chunks consumed so far (consumers)
};

// Carves the ring from the start of dynamic shared memory and advances p.
__device__ inline Ring carve_ring(unsigned char*& p) {
  Ring r;
  r.full = smem_addr(p);
  r.empty = r.full + 8 * kSlots;
  p += 16 * kSlots;
  r.slots = reinterpret_cast<const float*>(p);
  r.data = smem_addr(p);
  p += sizeof(float) * kSlots * kSlotStride;
  r.it = 0;
  return r;
}

// Thread 0 of each CTA; the cluster synchronises before the ring is used.
__device__ inline void init_ring(const Ring& r) {
  for (int s = 0; s < kSlots; ++s) {
    mbar_init(r.full + 8 * s, 1);
    mbar_init(r.empty + 8 * s, kG * kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer thread of a CTA, for `sweeps` sweeps: every CTA arms its
// own full barrier of each chunk with the chunk's bytes once the slot's
// previous chunk has landed there; rank 0 (leader) also waits until every
// consumer warp of the cluster has released the slot and then issues the
// one multicast copy.
template <class TW>
__device__ inline void produce(const Sweep<TW>& sw, int sweeps, const Ring& r,
                               bool leader) {
  uint32_t it = 0;
  for (int s = 0; s < sweeps; ++s) {
    for (int q = 0; q < kProducts; ++q) {
      const Prod<TW> pr = sw.p[q];
      for (int k0 = 0; k0 < pr.K; k0 += pr.kc, ++it) {
        const uint32_t slot = it % kSlots, use = it / kSlots;
        const uint32_t full = r.full + 8 * slot;
        const uint32_t bytes = chunk_bytes<TW>(min(pr.kc, pr.K - k0), pr.M);
        if (leader) {
          if (use > 0) mbar_wait(r.empty + 8 * slot, (use - 1) & 1);
          mbar_expect_tx(full, bytes);
          bulk_multicast(r.data + slot * kSlotStride * sizeof(float),
                         pr.W + static_cast<size_t>(k0) * pr.M, bytes, full,
                         static_cast<uint16_t>((1u << kG) - 1));
        } else {
          if (use > 0) mbar_wait(full, (use - 1) & 1);
          mbar_expect_tx(full, bytes);
        }
      }
    }
  }
}

// The four weights w[0..3] at q, widened to float: V at a time (4 when M
// is a multiple of 4, so every row group starts on four weights' bytes;
// else 2 or 1).
template <int V>
__device__ __forceinline__ void load4(const float* q, float (&wv)[4]) {
  if (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(q);
    wv[0] = t.x;
    wv[1] = t.y;
    wv[2] = t.z;
    wv[3] = t.w;
  } else if (V == 2) {
    const float2 t0 = reinterpret_cast<const float2*>(q)[0];
    const float2 t1 = reinterpret_cast<const float2*>(q)[1];
    wv[0] = t0.x;
    wv[1] = t0.y;
    wv[2] = t1.x;
    wv[3] = t1.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = q[i];
  }
}

template <int V>
__device__ __forceinline__ void load4(const __nv_bfloat16* q, float (&wv)[4]) {
  if (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(q);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    wv[0] = lo.x;
    wv[1] = lo.y;
    wv[2] = hi.x;
    wv[3] = hi.y;
  } else if (V == 2) {
    const float2 t0 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(q)[0]);
    const float2 t1 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(q)[1]);
    wv[0] = t0.x;
    wv[1] = t0.y;
    wv[2] = t1.x;
    wv[3] = t1.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = __bfloat162float(q[i]);
  }
}

// acc[i][c] += sum over the chunk's rows r = r0, r0 + S, ... of
// w[r][4 g + i] in[r][c], each in[r][c] as an operand of type TW reads it.
template <int V, class TW>
__device__ __forceinline__ void chunk_fma(const TW* w, int M, int rows,
                                          int r0, int S, const float* in,
                                          int g, float (&acc)[4][kC]) {
#pragma unroll 4
  for (int r = r0; r < rows; r += S) {
    float wv[4];
    load4<V>(w + r * M + 4 * g, wv);
    float a[kC];
    load_row<kC>(in + r * kC, a);
#pragma unroll
    for (int c = 0; c < kC; ++c) a[c] = rnd<TW>(a[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(wv[i], a[c], acc[i][c]);
    }
  }
}

// out[m][c] = sum_k W[k][m] in[k][c] for m < M over the streamed chunks,
// handed row by row to epi(m, acc) by the threads that own the rows. in is
// a [K][kC] array in shared memory. With `split` (a free shared array of
// split_floats floats) a narrow product spreads its rows over S slices of
// threads and sums the slices in slice order. Every consumer thread calls
// it; the caller synchronises before the outputs are read.
template <class TW, class Epi>
__device__ __forceinline__ void product(Ring& r, const Prod<TW>& pr,
                                        const float* in, float* split,
                                        int split_floats, Epi epi) {
  const int t = threadIdx.x;
  const int MG = (pr.M + 3) >> 2;
  int S = 1;
  if (split != nullptr)
    S = max(1, min(kConsumers / MG, split_floats / (MG * 4 * kC)));
  const int g = t % MG, s = t / MG;
  const int V = (pr.M % 4 == 0) ? 4 : (pr.M % 2 == 0) ? 2 : 1;
  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < pr.K; k0 += pr.kc, ++r.it) {
    const uint32_t slot = r.it % kSlots;
    mbar_wait(r.full + 8 * slot, (r.it / kSlots) & 1);
    if (s < S) {
      const TW* w = reinterpret_cast<const TW*>(r.slots + slot * kSlotStride);
      const int rows = min(pr.kc, pr.K - k0);
      const float* a = in + k0 * kC;
      if (V == 4)
        chunk_fma<4>(w, pr.M, rows, s, S, a, g, acc);
      else if (V == 2)
        chunk_fma<2>(w, pr.M, rows, s, S, a, g, acc);
      else
        chunk_fma<1>(w, pr.M, rows, s, S, a, g, acc);
    }
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive_at(r.empty + 8 * slot, 0);
  }
  if (S > 1) {
    if (s > 0 && s < S) {
      float* dst = split + ((s * MG + g) * 4) * kC;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < kC; ++c) dst[i * kC + c] = acc[i][c];
      }
    }
    csync();
    if (s == 0) {
      for (int s2 = 1; s2 < S; ++s2) {
        const float* src = split + ((s2 * MG + g) * 4) * kC;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[i][c] += src[i * kC + c];
        }
      }
    }
  }
  if (s == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * g + i < pr.M) epi(4 * g + i, acc[i]);
  }
}

// Sums part[c] over the consumer threads in a fixed order into out[c]
// (shared memory); every consumer thread calls it. red holds
// kConsumerWarps * kC floats.
__device__ __forceinline__ void consumer_sum(float (&part)[kC], float* red,
                                             float* out) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kC; ++c) red[(threadIdx.x >> 5) * kC + c] = part[c];
  }
  csync();
  if (threadIdx.x < kC) {
    float s = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) s += red[w * kC + threadIdx.x];
    out[threadIdx.x] = s;
  }
  csync();
}

// vae_common.cuh's decoder_grad on the cluster's weight stream: value and
// gradient of U(z | x) = BCE(decoder(z), x) + 0.5 |z|^2 for the CTA's kC
// chains (chain c is global chain n0 + c; chains >= N read x = 0). z and g
// are [D][kC], energy [kC], in shared memory. The sweep back overwrites the
// two softplus layers in place; the last product (W1t, M = D) sums its
// slices through s.h2, free by then. Every consumer thread calls it;
// synchronised on return.
template <class TW>
__device__ inline void decoder_grad(Ring& r, const Dims& d, const Decoder<TW>& w,
                                    const Sweep<TW>& sw,
                                    const float* __restrict__ xraw, int N,
                                    int n0, const float* z, float* g,
                                    float* energy, const Work<kC>& s) {
  constexpr int C = kC;
  float* h1 = s.h1;
  float* h2 = s.h2;
  float* d3 = s.d3;
  product(r, sw.p[0], z, nullptr, 0, [&](int m, const float (&acc)[C]) {
    const float b = w.b1[m];
#pragma unroll
    for (int c = 0; c < C; ++c) h1[m * C + c] = softplus(acc[c] + b);
  });
  csync();
  product(r, sw.p[1], h1, nullptr, 0, [&](int m, const float (&acc)[C]) {
    const float b = w.b2[m];
#pragma unroll
    for (int c = 0; c < C; ++c) h2[m * C + c] = softplus(acc[c] + b);
  });
  csync();
  float part[C];
#pragma unroll
  for (int c = 0; c < C; ++c) part[c] = 0.f;
  product(r, sw.p[2], h2, nullptr, 0, [&](int m, const float (&acc)[C]) {
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
  consumer_sum(part, s.red, energy);
  product(r, sw.p[3], d3, nullptr, 0, [&](int m, const float (&acc)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      h2[m * C + c] = acc[c] * sigmoid_of_softplus(h2[m * C + c]);
  });
  csync();
  product(r, sw.p[4], h2, nullptr, 0, [&](int m, const float (&acc)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      h1[m * C + c] = acc[c] * sigmoid_of_softplus(h1[m * C + c]);
  });
  csync();
  product(r, sw.p[5], h1, h2, d.E * C, [&](int m, const float (&acc)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) g[m * C + c] = acc[c] + z[m * C + c];
  });
  csync();
  if (threadIdx.x < C) {
    float q = 0.f;
    for (int i = 0; i < d.D; ++i) {
      const float zi = z[i * C + threadIdx.x];
      q = fmaf(zi, zi, q);
    }
    energy[threadIdx.x] += 0.5f * q;
  }
  csync();
}

}  // namespace stream
}  // namespace vae
}  // namespace l2hmc
