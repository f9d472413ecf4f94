// Vector-Jacobian product of the T-step trajectory of vae_traj.cu on the VAE
// posterior: cotangents dZ, dV (D, N), dld (N) -> the cotangents of both
// S/T/Q nets' weights and of eps, summed over chains, of the aux embedding
// (H, N) and of z, v (D, N). The decoder and the pixels get none (the
// sampler loss stops their gradient), but the decoder's Hessian-vector
// products, through which the gradient of the energy gradient flows, are
// computed here.
//
// Replaces the Pallas kernel _make_vae_bwd_kernel /
// DifferentiableFusedVae._get_bwd_callable
// (l2hmc_tpu/ops/fused_dynamics.py:1649, pallas_call at :1896), whose body
// traces jax.vjp of one substep at a time (_trajectory_vjp :251). There is
// no trace-time AD here: the substep's VJP is derived by hand (its plain
// version is _step_vjp in ops/fused_dynamics.py with build_grad_vjp of
// ops/fused_vae.py).
//
// Bound on the card: operations. Per chain: the pass forward (T + 1
// decoder sweeps, 4 T net applications), T + 1 sweeps that carry a tangent
// beside the primal (the Hessian-vector products), and per net application
// the transposed products and the outer products of the weight cotangents.
// The per-block design paid the weight stream of vae_traj.cu twice and
// read-modify-wrote a (blocks, 182950) cotangent scratch of 94 MB, larger
// than the L2, 20 times a launch.
//
// Design (vae_cluster.cuh for the cluster, the product and the leapfrog
// step):
//  - A cluster of G CTAs shares a tile of Ct chains and splits every
//    product's output rows; every [D][Ct] state and cotangent array is split
//    by latent rows, so the substep's elementwise VJP is local to a CTA. The
//    pass forward runs the trajectory and writes every leapfrog step's
//    boundary (z, v, gradient) and its two inner states to a device scratch
//    (so T has no compile-time cap), and each net application's hidden
//    layers and outputs to the cluster's global scratch; the way back walks the
//    steps back and reads them there instead of applying the nets again.
//  - Hessian-vector products. The Hessian is symmetric, so the cotangent u
//    of a gradient call gives H u as a tangent: the sweep runs on [.][2 Ct]
//    arrays, primal and tangent columns of a chain side by side (2 c, 2 c +
//    1), so one staged weight feeds 2 Ct columns and a thread's register
//    tile (8 x 2 Ct / 8) holds both columns of its chains; the epilogues
//    apply softplus' = sigmoid and softplus'' = sigmoid (1 - sigmoid) from
//    the primal column. Each boundary point's two cotangents are added
//    before its one sweep, so a launch makes T + 1 of them.
//  - Weight cotangents summed over chains. Each CTA owns the slice of each
//    net's weight cotangent whose output rows it computes and adds, per net
//    application, the outer products over its cluster's Ct chains (a K = Ct
//    sum per entry) into its cluster's slice of a (clusters, 2 nf + D)
//    scratch: 13 x 0.73 MB = 9.5 MB at 512 chains and Ct = 40 (the per-block
//    design: 94 MB). A second kernel sums the clusters' slices in cluster
//    order. No atomics: a launch repeats itself bit for bit.
//  - L2 bytes per launch: twice vae_traj.cu's weights (the pass forward,
//    then the sweeps with a tangent and the nets' transposed products),
//    2.37 GB of decoder and 0.19 GB of nets at 512 chains and Ct = 40 (the
//    per-block design: ~25 GB), plus 20 read-modify-writes of the 9.5 MB
//    cotangent scratch and the 23 MB of kept net activations written once
//    and read once. The working set, reckoned: 8.35 MB of weights, the 9.5
//    MB scratch, 13 x 2.82 MB = 36.6 MB of activation copies (the kept net
//    activations among them) and 2.9 MB of boundary states, 57 MB against
//    the 50 MB L2, so part of it goes to device memory; how much is not
//    measured (no profiler runs on the card's machine). What bounds it, as
//    vae_traj.cu: the CTAs' issue of shared loads and multiply-adds.
//
// bfloat16 operands (compute_dtype="bfloat16"; TW = __nv_bfloat16): the
// pass forward rounds as vae_traj.cu does, and the way back follows JAX's
// VJP of a lowered product (ops/operands.py). The cotangent of an
// activation through a product is rounded to bfloat16 (its input, a
// cotangent, is not): the tangent columns of the sweeps with a tangent,
// dz2 (the three heads' cotangents each rounded apart, then added, as JAX
// adds three products'), dz1, da and db. The weights' cotangents stay
// float32 (ROADMAP C), over the lowered activations, which the kept slots
// hold and which the gathers round.
//
// State layout (D, N): element i of chain n at i * N + n. N need not divide
// the tile: chains >= N read zeros, carry zero cotangents and add nothing.
#include "vae_cluster.cuh"

namespace l2hmc {
namespace vaec {

// One net's cotangents, in the order of the packed gradient: w1, w2 (D, H),
// wh (H, H2), bh (H2), wo (H2, 3 D) = [ws | wt | wq], bs, ls, bt, bq, lq
// (D), te (H, T).
struct NetGrad {
  float *w1, *w2, *wh, *bh, *wo, *bs, *ls, *bt, *bq, *lq, *te;
};

__host__ __device__ inline int net_floats(const Dims& d) {
  return 2 * d.D * d.H + d.H * d.H2 + d.H2 + 3 * d.D * d.H2 + 5 * d.D +
         d.H * d.T;
}

__device__ inline NetGrad carve_grad(float*& p, const Dims& d) {
  NetGrad g;
  g.w1 = p; p += d.D * d.H;
  g.w2 = p; p += d.D * d.H;
  g.wh = p; p += d.H * d.H2;
  g.bh = p; p += d.H2;
  g.wo = p; p += d.H2 * 3 * d.D;
  g.bs = p; p += d.D;
  g.ls = p; p += d.D;
  g.bt = p; p += d.D;
  g.bq = p; p += d.D;
  g.lq = p; p += d.D;
  g.te = p; p += d.H * d.T;
  return g;
}

template <class TW>
struct BwdArgs {
  Dims d;
  Weights<TW> w;
  const float* xraw;  // (P, N)
  const float* emb;   // (H, N)
  const float* zin;   // (D, N)
  const float* vin;   // (D, N)
  const float* dZ;    // (D, N)
  const float* dV;    // (D, N)
  const float* dld;   // (N)
  float* dz;          // (D, N)
  float* dv;          // (D, N)
  float* demb;        // (H, N)
  float* partial;     // (clusters, 2 net_floats + D)
  float* bnd;         // (5 T + 3, D, N)
  float* act;         // (clusters, bwd_act_floats): the activations' global copies
  int N, reverse;
};

constexpr int kStateArrays = 22;  // [Dg][Ct] arrays, beside zu and gh [Dg][2 Ct]

// The region that the sweeps with a tangent and the other activations
// share: h1, h2 [Eg][2 Ct]; or h1, h2 [Eg][Ct], ha [Hg][Ct], hb [H2g][Ct]
// and the net VJP's dz1 [Hg][Ct + 1], dz2 [H2g][Ct + 1], du [3 Dg][Ct + 1];
// rounded up to 4 floats, so that the arrays after it stay 16-byte aligned
// for cp.async.
template <int Ct, int G>
__host__ __device__ inline int region_floats(const Dims& d) {
  const int Eg = slice_rows4(d.E, G);
  const int Hg = slice_rows(d.H, G), H2g = slice_rows(d.H2, G);
  const int Dg = slice_rows(d.D, G);
  const int dual = 2 * Ct * 2 * Eg;
  const int work = Ct * (2 * Eg + Hg + H2g) + (Ct + 1) * (Hg + H2g + 3 * Dg);
  return ((dual > work ? dual : work) + 3) / 4 * 4;
}

// Floats of a cluster's global scratch of activations: the sweeps' h1, h2
// [E][2 Ct], d3 [P][2 Ct] (whose first halves hold the primal sweeps' [.][Ct]
// arrays), ha [H][Ct], hb [H2][Ct], du [3 D][Ct], dz1 [H][Ct], dz2 [H2][Ct],
// then the 4 T net applications' kept slots (keep_floats each).
__host__ __device__ inline int bwd_act_floats(const Dims& d, int Ct) {
  return 2 * Ct * (2 * d.E + d.P) + Ct * (2 * d.H + 2 * d.H2 + 3 * d.D) +
         4 * d.T * keep_floats(d, Ct);
}

// The ring of the widest product, or a whole [max(H, H2, D)][Ct] operand of
// an outer product, whichever is larger.
template <int Ct, int G>
__host__ __device__ inline int stage_floats(const Dims& d) {
  int rows = d.H > d.H2 ? d.H : d.H2;
  rows = rows > d.D ? rows : d.D;
  const int ring = ring_floats<2 * Ct>();
  return ring > rows * Ct ? ring : rows * Ct;
}

// Shared-memory floats of one CTA (fused_vae.bwd_smem_floats mirrors it).
template <int Ct, int G>
__host__ __device__ inline int bwd_floats(const Dims& d) {
  const int Dg = slice_rows(d.D, G), Hg = slice_rows(d.H, G);
  return stage_floats<Ct, G>(d) + region_floats<Ct, G>(d) +
         Ct * (kStateArrays * Dg + 4 * Dg + Hg + 1);
}

// G[k * ldg + col(j)] += sum_c left[k][c] right(j)[c] for k < K and this
// CTA's j < M: left [K][C] in shared memory (16-byte aligned), right(j) a
// row of C floats; each thread keeps its right row in registers over KB
// rows of left, whose KB entries of G it reads at once before adding.
template <int C, class Right, class Col>
__device__ __forceinline__ void outer_add(float* __restrict__ G, int ldg,
                                          const float* left, int K, int M,
                                          Right right, Col col) {
  constexpr int KB = 8;
  const int nkb = (K + KB - 1) / KB;
  for (int idx = threadIdx.x; idx < M * nkb; idx += kThreads) {
    const int kb = idx / M, j = idx - kb * M;
    const float* rp = right(j);
    float rr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) rr[c] = rp[c];
    const int k0 = kb * KB;
    float* gp = G + col(j) + static_cast<size_t>(k0) * ldg;
    float gv[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u)
      gv[u] = k0 + u < K ? gp[static_cast<size_t>(u) * ldg] : 0.f;
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (k0 + u < K) {
        const float4* lp = reinterpret_cast<const float4*>(left + (k0 + u) * C);
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 l = lp[q];
          s = fmaf(l.x, rr[4 * q], s);
          s = fmaf(l.y, rr[4 * q + 1], s);
          s = fmaf(l.z, rr[4 * q + 2], s);
          s = fmaf(l.w, rr[4 * q + 3], s);
        }
        gp[static_cast<size_t>(u) * ldg] = gv[u] + s;
      }
    }
  }
}

// The dual region's arrays
// The sweeps' arrays: this CTA's rows h1, h2 [Eg][2 Ct], and the whole
// global copies h1g, h2g [E][2 Ct], d3g [P][2 Ct].
struct Dual {
  float *h1, *h2, *h1g, *h2g, *d3g;
};

// Gradient and Hessian-vector product of U(z | x) for the cluster's Ct
// chains: zu is a row-split [Dg][2 Ct] array with z in the even columns and
// the vector u in the odd ones; gh gets the gradient and H u in the same
// layout. The global copies hold the primal columns as the next product's
// operands (rnd<TW>) and the tangent columns, cotangents, as they are; each
// product's tangent column is a rounded activation cotangent. Ends with a
// cluster barrier.
template <int Ct, class TW>
__device__ __noinline__ void decoder_hvp(const Dims& d, const Part& q, const Decoder<TW>& w,
                            const float* __restrict__ xraw, int N,
                            const float* zu, float* gh, const Dual& x,
                            float* stage) {
  constexpr int CC = 2 * Ct;
  constexpr int RC = Tile<CC, kWide>::RC;
  const int e0 = q.r * q.Eg, p0 = q.r * q.Pg, i0 = q.r * q.Dg;
  float* const h1 = x.h1;
  float* const h2 = x.h2;
  float* const h1g = x.h1g + e0 * CC;  // this CTA's rows of the global copies
  float* const h2g = x.h2g + e0 * CC;
  float* const d3g = x.d3g + p0 * CC;
  const bool vec = decoder_vec(d, w);
  product<CC, kWide, false>(
      d.D, q.En, stage, vec,
      [&](int k, int j) { return w.W1 + static_cast<size_t>(k) * d.E + e0 + j; },
      [&](int k, int c) {
        const float x = dget(zu, q.Dg, CC, k, c);
        return c & 1 ? x : rnd<TW>(x);
      },
      [&](int j, int c0, const float (&acc)[RC]) {
        const float b = w.b1[e0 + j];
#pragma unroll
        for (int u = 0; u < RC; u += 2) {
          const float h = softplus(acc[u] + b);
          const float t = sigmoid_of_softplus(h) * rnd<TW>(acc[u + 1]);
          h1[j * CC + c0 + u] = h;
          h1g[j * CC + c0 + u] = rnd<TW>(h);
          h1[j * CC + c0 + u + 1] = h1g[j * CC + c0 + u + 1] = t;
        }
      });
  csync();
  product_g<CC, kWide, false>(
      d.E, q.En, stage, vec,
      [&](int k, int j) { return w.W2 + static_cast<size_t>(k) * d.E + e0 + j; },
      x.h1g,
      [&](int j, int c0, const float (&acc)[RC]) {
        const float b = w.b2[e0 + j];
#pragma unroll
        for (int u = 0; u < RC; u += 2) {
          const float h = softplus(acc[u] + b);
          const float t = sigmoid_of_softplus(h) * rnd<TW>(acc[u + 1]);
          h2[j * CC + c0 + u] = h;
          h2g[j * CC + c0 + u] = rnd<TW>(h);
          h2[j * CC + c0 + u + 1] = h2g[j * CC + c0 + u + 1] = t;
        }
      });
  csync();
  product_g<CC, kWide, false>(
      d.E, q.Pn, stage, vec,
      [&](int k, int j) { return w.W3 + static_cast<size_t>(k) * d.P + p0 + j; },
      x.h2g,
      [&](int j, int c0, const float (&acc)[RC]) {
        const float b = w.b3[p0 + j];
#pragma unroll
        for (int u = 0; u < RC; u += 2) {
          const int n = q.n0 + (c0 + u) / 2;
          const float xv = n < N ? xraw[static_cast<size_t>(p0 + j) * N + n] : 0.f;
          const float sg = 1.f / (1.f + expf(-(acc[u] + b)));
          d3g[j * CC + c0 + u] = rnd<TW>(sg - xv);
          d3g[j * CC + c0 + u + 1] = sg * (1.f - sg) * rnd<TW>(acc[u + 1]);
        }
      });
  csync();
  product_g<CC, kWide, true>(
      d.P, q.En, stage, vec,
      [&](int k, int j) { return w.W3 + static_cast<size_t>(e0 + j) * d.P + k; },
      x.d3g,
      [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
        for (int u = 0; u < RC; u += 2) {
          float* h = h2 + j * CC + c0 + u;
          const float sg = sigmoid_of_softplus(h[0]);
          const float t = h[1];
          h[0] = acc[u] * sg;
          h2g[j * CC + c0 + u] = rnd<TW>(h[0]);
          h[1] = h2g[j * CC + c0 + u + 1] =
              rnd<TW>(acc[u + 1]) * sg + acc[u] * (1.f - sg) * t;
        }
      });
  csync();
  product_g<CC, kWide, true>(
      d.E, q.En, stage, vec,
      [&](int k, int j) { return w.W2 + static_cast<size_t>(e0 + j) * d.E + k; },
      x.h2g,
      [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
        for (int u = 0; u < RC; u += 2) {
          float* h = h1 + j * CC + c0 + u;
          const float sg = sigmoid_of_softplus(h[0]);
          const float t = h[1];
          h[0] = acc[u] * sg;
          h1g[j * CC + c0 + u] = rnd<TW>(h[0]);
          h[1] = h1g[j * CC + c0 + u + 1] =
              rnd<TW>(acc[u + 1]) * sg + acc[u] * (1.f - sg) * t;
        }
      });
  csync();
  product_g<CC, kNarrow, true>(
      d.E, q.Dn, stage, vec,
      [&](int k, int j) { return w.W1 + static_cast<size_t>(i0 + j) * d.E + k; },
      x.h1g,
      [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
        for (int u = 0; u < RC; ++u) {
          const float a = u & 1 ? rnd<TW>(acc[u]) : acc[u];  // c0 is even
          gh[j * CC + c0 + u] = a + zu[j * CC + c0 + u];
        }
      });
  csync();
}

// The net VJP's own arrays (row stride Ct + 1): dz1 [Hg], dz2 [H2g], the
// cotangents of the two hidden pre-activations; du [3][Dg], those of the
// three heads' pre-activations on this CTA's latent rows; and their whole
// global copies dz1g [H][Ct], dz2g [H2][Ct], dug [3 D][Ct] (row head D + i).
struct VjpWork {
  float *dz1, *dz2, *du, *dz1g, *dz2g, *dug;
};

// VJP of apply_net at the row-split inputs a, b for the cotangents ds, dt,
// dq of its outputs on this CTA's rows, given what apply_net made of the
// same inputs (s.ha, s.hb its hidden layers on this CTA's rows, s.hag,
// s.hbg their whole copies, S and Q its outputs): adds
// this CTA's slice of the weights' cotangents into Gr, the hidden
// pre-activation's into demb [Hg][Ct], and gives da, db [Dg][Ct]. With
// bfloat16 operands dz2, dz1, da and db are rounded activation cotangents,
// dz2 the sum of the three heads' apart. Ends with a cluster barrier.
template <int Ct, class TW>
__device__ __noinline__ void net_vjp(const Dims& d, const Part& q, const Net<TW>& w,
                        const NetGrad& Gr, int step, const float* a,
                        const float* b, const float* S, const float* Q,
                        const float* ds, const float* dt, const float* dq,
                        float* da, float* db, float* demb, const Work& s,
                        const VjpWork& x) {
  constexpr int L = Ct + 1;
  constexpr int RC = Tile<Ct, kNarrow>::RC;
  const int i0 = q.r * q.Dg, h0 = q.r * q.Hg, g0 = q.r * q.H2g;
  const int Dn = q.Dn, Dg = q.Dg;
  const float* ha = s.ha;
  const float* hb = s.hb;
  float* const stage = s.stage;
  float* const du = x.du;
  float* const dz1 = x.dz1;
  float* const dz2 = x.dz2;
  // the heads' pre-activation cotangents on this CTA's rows, one entry per
  // thread; then per row the sums over chains of its bias's and log-scale's
  // cotangents, in chain order
  for (int e = threadIdx.x; e < 3 * Dn * Ct; e += kThreads) {
    const int row = e / Ct, c = e - row * Ct;
    const int head = row / Dn;
    const int il = row - head * Dn, i = i0 + il;
    float u;
    if (head == 1) {
      u = dt[il * Ct + c];
    } else {
      const float l = head == 0 ? w.ls[i] : w.lq[i];
      const float sc = expf(l), inv = expf(-l);
      const float th = (head == 0 ? S : Q)[il * Ct + c] * inv;  // the head's tanh
      u = (head == 0 ? ds : dq)[il * Ct + c] * sc * (1.f - th * th);
    }
    du[(head * Dg + il) * L + c] = x.dug[(head * d.D + i) * Ct + c] = u;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * Dn; e += kThreads) {
    const int head = e / Dn;
    const int il = e - head * Dn, i = i0 + il;
    const float* u_row = du + (head * Dg + il) * L;
    float sum_b = 0.f, sum_l = 0.f;
    for (int c = 0; c < Ct; ++c) sum_b += u_row[c];
    if (head == 1) {
      Gr.bt[i] += sum_b;
    } else {
      const float* out = (head == 0 ? S : Q) + il * Ct;
      const float* dout = (head == 0 ? ds : dq) + il * Ct;
      for (int c = 0; c < Ct; ++c) sum_l += dout[c] * out[c];
      if (head == 0) {
        Gr.bs[i] += sum_b;
        Gr.ls[i] += sum_l;
      } else {
        Gr.bq[i] += sum_b;
        Gr.lq[i] += sum_l;
      }
    }
  }
  load_all(s.hbg, d.H2 * Ct, stage);
  csync();  // du complete in every CTA, hb loaded
  outer_add<Ct>(
      Gr.wo, 3 * d.D, stage, d.H2, 3 * Dn,
      [&](int j) { return du + ((j / Dn) * Dg + j % Dn) * L; },
      [&](int j) { return (j / Dn) * d.D + i0 + j % Dn; });
  __syncthreads();
  // dz2 = (wo du) * [hb > 0] on this CTA's H2 rows; k = head * D + i
  if constexpr (std::is_same<TW, float>::value) {
    product_g<Ct, kNarrow, true>(
        3 * d.D, q.H2n, stage, false,
        [&](int k, int j) {
          const int head = k / d.D;
          const TW* W = head == 0 ? w.ws : (head == 1 ? w.wt : w.wq);
          return W + (g0 + j) * d.D + k - head * d.D;
        },
        x.dug,
        [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
          for (int u = 0; u < RC; ++u)
            dz2[j * L + c0 + u] = x.dz2g[(g0 + j) * Ct + c0 + u] =
                hb[j * Ct + c0 + u] > 0.f ? acc[u] : 0.f;
        });
  } else {
    // one product a head, each rounded, added in head order
    for (int head = 0; head < 3; ++head) {
      const TW* W = head == 0 ? w.ws : (head == 1 ? w.wt : w.wq);
      product_g<Ct, kNarrow, true>(
          d.D, q.H2n, stage, false,
          [&](int k, int j) { return W + (g0 + j) * d.D + k; },
          x.dug + static_cast<size_t>(head) * d.D * Ct,
          [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
            for (int u = 0; u < RC; ++u) {
              float* o = dz2 + j * L + c0 + u;
              const float sum = (head == 0 ? 0.f : *o) + rnd<TW>(acc[u]);
              *o = sum;
              if (head == 2)
                *o = x.dz2g[(g0 + j) * Ct + c0 + u] = hb[j * Ct + c0 + u] > 0.f ? sum : 0.f;
            }
          });
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < q.H2n; m += kThreads) {
    float sum = 0.f;
    for (int c = 0; c < Ct; ++c) sum += dz2[m * L + c];
    Gr.bh[g0 + m] += sum;
  }
  load_all(s.hag, d.H * Ct, stage);
  csync();  // dz2 complete, ha loaded
  outer_add<Ct>(
      Gr.wh, d.H2, stage, d.H, q.H2n, [&](int j) { return dz2 + j * L; },
      [&](int j) { return g0 + j; });
  __syncthreads();
  // dz1 = (wh dz2) * [ha > 0] on this CTA's H rows
  product_g<Ct, kNarrow, true>(
      d.H2, q.Hn, stage, false,
      [&](int k, int j) { return w.wh + (h0 + j) * d.H2 + k; },
      x.dz2g,
      [&](int j, int c0, const float (&acc)[RC]) {
#pragma unroll
        for (int u = 0; u < RC; ++u)
          dz1[j * L + c0 + u] = x.dz1g[(h0 + j) * Ct + c0 + u] =
              ha[j * Ct + c0 + u] > 0.f ? rnd<TW>(acc[u]) : 0.f;
      });
  __syncthreads();
  for (int e = threadIdx.x; e < q.Hn * Ct; e += kThreads) {
    const int m = e / Ct;
    demb[e] += dz1[m * L + e - m * Ct];
  }
  for (int m = threadIdx.x; m < q.Hn; m += kThreads) {
    float sum = 0.f;
    for (int c = 0; c < Ct; ++c) sum += dz1[m * L + c];
    Gr.te[(h0 + m) * d.T + step] += sum;
  }
  gather<TW>(a, Dg, d.D, Ct, stage);
  csync();  // dz1 complete, a gathered
  outer_add<Ct>(
      Gr.w1, d.H, stage, d.D, q.Hn, [&](int j) { return dz1 + j * L; },
      [&](int j) { return h0 + j; });
  __syncthreads();
  gather<TW>(b, Dg, d.D, Ct, stage);
  __syncthreads();
  outer_add<Ct>(
      Gr.w2, d.H, stage, d.D, q.Hn, [&](int j) { return dz1 + j * L; },
      [&](int j) { return h0 + j; });
  __syncthreads();
  // da, db on this CTA's latent rows: local row j < Dn of w1, else of w2
  product_g<Ct, kNarrow, true>(
      d.H, 2 * Dn, stage, false,
      [&](int k, int j) {
        return j < Dn ? w.w1 + (i0 + j) * d.H + k
                      : w.w2 + (i0 + j - Dn) * d.H + k;
      },
      x.dz1g,
      [&](int j, int c0, const float (&acc)[RC]) {
        float* out = j < Dn ? da + j * Ct : db + (j - Dn) * Ct;
#pragma unroll
        for (int u = 0; u < RC; ++u) out[c0 + u] = rnd<TW>(acc[u]);
      });
  csync();
}

template <int Ct, int G, class TW>
__global__ void __launch_bounds__(kThreads, 1) vae_traj_bwd_kernel(BwdArgs<TW> a) {
  constexpr int CC = 2 * Ct;
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  const Dims d = a.d;
  const Part q = make_part(d, G, Ct);
  const int DC = q.Dg * Ct;
  const int tid = threadIdx.x;
  const int i0 = q.r * q.Dg, h0 = q.r * q.Hg, g0 = q.r * q.H2g;
  const int n0 = q.n0, N = a.N;
  const bool rev = a.reverse != 0;

  Work s;
  s.stage = p; p += stage_floats<Ct, G>(d);
  float* const region = p;
  p += region_floats<Ct, G>(d);
  float* r = region;
  s.h1 = r; r += q.Eg * Ct;
  s.h2 = r; r += q.Eg * Ct;
  s.ha = r; r += q.Hg * Ct;
  s.hb = r; r += q.H2g * Ct;
  VjpWork xw;
  xw.dz1 = r; r += q.Hg * (Ct + 1);
  xw.dz2 = r; r += q.H2g * (Ct + 1);
  xw.du = r;
  Dual dual;
  dual.h1 = region;
  dual.h2 = dual.h1 + CC * q.Eg;
  // the cluster's global copies: the sweeps' arrays, whose first halves
  // hold the primal sweeps' arrays, then the nets'
  float* g = a.act + static_cast<size_t>(blockIdx.x / G) * bwd_act_floats(d, Ct);
  dual.h1g = s.h1g = g; g += CC * d.E;
  dual.h2g = s.h2g = g; g += CC * d.E;
  dual.d3g = s.d3g = g; g += CC * d.P;
  s.hag = g; g += Ct * d.H;
  s.hbg = g; g += Ct * d.H2;
  xw.dug = g; g += Ct * 3 * d.D;
  xw.dz1g = g; g += Ct * d.H;
  xw.dz2g = g; g += Ct * d.H2;
  s.keep = g;  // the pass forward's net applications, for the way back
  s.stq = nullptr;

  State t;
  t.z = p; p += DC;    // z of the pass forward; x_k of the step going back
  t.v = p; p += DC;    // v_k
  t.g = p; p += DC;    // gradient at x_k
  t.S = p; p += DC;
  t.Tt = p; p += DC;
  t.Q = p; p += DC;
  t.bin = p; p += DC;
  t.ldp = p; p += DC;  // going back: the pending cotangent of the gradient
  float* vh = p; p += DC;   // the step's half-updated momentum
  float* y = p; p += DC;    // its position between the two updates
  float* xo = p; p += DC;   // x_{k+1}
  float* g2 = p; p += DC;   // gradient at x_{k+1}
  float* dx = p; p += DC;   // cotangent of the position
  float* dv = p; p += DC;   // of the momentum
  float* dvh = p; p += DC;
  float* dy = p; p += DC;
  float* de = p; p += DC;   // of eps, per chain
  float* ds = p; p += DC;   // of the net outputs
  float* dt = p; p += DC;
  float* dq = p; p += DC;
  float* da = p; p += DC;   // of the net inputs
  float* db = p; p += DC;
  float* zu = p; p += 2 * DC;  // [Dg][2 Ct]: position | vector, interleaved
  float* gh = p; p += 2 * DC;  // [Dg][2 Ct]: gradient | Hessian-vector product
  float* demb = p; p += q.Hg * Ct;
  float* dl = p; p += Ct;
  float* const pend = t.ldp;
  // with bfloat16 operands the cotangent of the gradient at x_{k+1} that
  // step k's last net and momentum update give (t.bin, free at app 3)
  // takes a sweep of its own (below)
  constexpr bool kF32 = std::is_same<TW, float>::value;
  float* const pend_last = kF32 ? pend : t.bin;

  // this cluster's slice of the cotangent scratch, zeroed a share per CTA
  const int nf = net_floats(d);
  const int n_grads = 2 * nf + d.D;
  float* Gp = a.partial + static_cast<size_t>(blockIdx.x / G) * n_grads;
  {
    const int share = (n_grads + G - 1) / G;
    const int r0 = q.r * share, r1 = min(n_grads, r0 + share);
    for (int e = r0 + tid; e < r1; e += kThreads) Gp[e] = 0.f;
  }
  float* gq = Gp;
  const NetGrad gxn = carve_grad(gq, d);
  const NetGrad gvn = carve_grad(gq, d);
  float* const geps = gq;

  const size_t slab = static_cast<size_t>(d.D) * N;
  // scratch slots: x_k, v_k, g_k at 3 k .. 3 k + 2 (k = 0 .. T), then the
  // inner states of step k at 3 (T + 1) + 2 k, + 1
  auto slot = [&](int sl) { return a.bnd + sl * slab; };
  const int inner0 = 3 * (d.T + 1);
  const int Dn = q.Dn;
  auto store = [&](const float* src, int sl) { store_rows<Ct>(src, i0, Dn, N, n0, slot(sl)); };
  auto load = [&](int sl, float* dst) { load_rows<Ct>(slot(sl), i0, Dn, N, n0, dst); };

  // -- the trajectory, with its boundary and inner states written out -------
  load_rows<Ct>(a.zin, i0, Dn, N, n0, t.z);
  load_rows<Ct>(a.vin, i0, Dn, N, n0, t.v);
  for (int e = tid; e < DC; e += kThreads) t.ldp[e] = 0.f;
  csync();
  decoder_grad<Ct>(d, q, a.w.dec, a.xraw, N, t.z, t.g, s);
  store(t.z, 0);
  store(t.v, 1);
  store(t.g, 2);
  for (int it = 0; it < d.T; ++it) {
    leapfrog_step<Ct>(d, q, a.w, a.xraw, a.emb, N, it, rev ? 0ull : ~0ull, t, s,
                      [&](int which) {
                        store(which == 0 ? t.v : t.z, inner0 + 2 * it + which);
                      });
    store(t.z, 3 * (it + 1));
    store(t.v, 3 * (it + 1) + 1);
    store(t.g, 3 * (it + 1) + 2);
  }
  __syncthreads();

  // -- the way back --------------------------------------------------------------
  load_rows<Ct>(a.dZ, i0, Dn, N, n0, dx);
  load_rows<Ct>(a.dV, i0, Dn, N, n0, dv);
  for (int e = tid; e < DC; e += kThreads) {
    de[e] = 0.f;
    pend[e] = 0.f;
  }
  for (int e = tid; e < q.Hg * Ct; e += kThreads) demb[e] = 0.f;
  if (tid < Ct) dl[tid] = n0 + tid < N ? a.dld[n0 + tid] : 0.f;

  for (int k = d.T - 1; k >= 0; --k) {
    const int st = rev ? d.T - 1 - k : k;
    load(3 * k, t.z);
    load(3 * k + 1, t.v);
    load(3 * k + 2, t.g);
    load(3 * (k + 1), xo);
    load(3 * (k + 1) + 2, g2);
    load(inner0 + 2 * k, vh);
    load(inner0 + 2 * k + 1, y);
    csync();

    // the step's four net applications, last first: 3 the v-net at the new
    // position, 2 and 1 the x-net of the second and first position update,
    // 0 the v-net at the old position
    for (int app = 3; app >= 0; --app) {
      const bool vnet = app == 0 || app == 3;
      const float* in_a = app == 3 ? xo : (app == 0 ? t.z : vh);
      const float* in_b = app == 3 ? g2 : (app == 0 ? t.g : t.bin);
      if (!vnet) {
        // the x-net's second input: the entries its update keeps
        const float* src = app == 2 ? y : t.z;
        for (int e = tid; e < Dn * Ct; e += kThreads) {
          const int i = i0 + e / Ct;
          const float m = a.w.masks[i * d.T + st];
          const float keep = (app == 2) == rev ? m : 1.f - m;
          t.bin[e] = keep * src[e];
        }
        csync();
      }
      // the application's hidden layers and outputs, as the pass forward
      // made them: this CTA's rows into shared memory
      const Work sw = app_work(s, d, Ct, 4 * k + app);
      copy_rows(sw.hag + h0 * Ct, q.Hn * Ct, s.ha);
      copy_rows(sw.hbg + g0 * Ct, q.H2n * Ct, s.hb);
      copy_rows(sw.stq + i0 * Ct, Dn * Ct, t.S);
      copy_rows(sw.stq + (d.D + i0) * Ct, Dn * Ct, t.Tt);
      copy_rows(sw.stq + (2 * d.D + i0) * Ct, Dn * Ct, t.Q);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int e = tid; e < Dn * Ct; e += kThreads) {
        const int il = e / Ct, c = e - il * Ct;
        const int i = i0 + il;
        const float ep = a.w.eps[i];
        const float hf = 0.5f * ep;
        const float m = a.w.masks[i * d.T + st];
        const float mb = 1.f - m;
        const float sv_ = t.S[e], tt = t.Tt[e], qv = t.Q[e];
        const float Qe = expf(ep * qv);
        const float dlc = dl[c];
        if (app == 3) {
          // v' = vh E + hf (-Qe g2 + tt), or v' = E (vh - hf (-Qe g2 + tt))
          const float dvo = dv[e];
          if (!rev) {
            const float E = expf(hf * sv_);
            const float dsv = dvo * vh[e] * E + dlc;
            const float dQ = -dvo * hf * g2[e];
            dvh[e] = dvo * E;
            de[e] += 0.5f * dvo * (-Qe * g2[e] + tt) + dQ * Qe * qv +
                     0.5f * dsv * sv_;
            ds[e] = dsv * hf;
            dt[e] = dvo * hf;
            dq[e] = dQ * Qe * ep;
            pend_last[e] = (kF32 ? pend_last[e] : 0.f) - dvo * hf * Qe;
          } else {
            const float E = expf(-hf * sv_);
            const float A = vh[e] - hf * (-Qe * g2[e] + tt);
            const float dvhv = dvo * E;
            const float dsv = dvo * A * E + dlc;
            const float dQ = dvhv * hf * g2[e];
            dvh[e] = dvhv;
            de[e] += 0.5f * dvhv * (Qe * g2[e] - tt) + dQ * Qe * qv -
                     0.5f * dsv * sv_;
            ds[e] = -hf * dsv;
            dt[e] = -dvhv * hf;
            dq[e] = dQ * Qe * ep;
            pend_last[e] = (kF32 ? pend_last[e] : 0.f) + dvhv * hf * Qe;
          }
        } else if (app == 2) {
          // x' from y: the second position update; the Hessian-vector
          // product at x' joins its cotangent here
          const float dxo = dx[e] + gh[il * CC + 2 * c + 1];
          if (!rev) {
            const float E = expf(ep * sv_);
            const float dsx = dxo * m * y[e] * E + dlc * m;
            const float dtt = dxo * m * ep;
            const float dQ = dtt * vh[e];
            dy[e] = dxo * (mb + m * E);
            dvh[e] += dtt * Qe;
            de[e] += dxo * m * (Qe * vh[e] + tt) + dQ * Qe * qv + dsx * sv_;
            ds[e] = dsx * ep;
            dt[e] = dtt;
            dq[e] = dQ * Qe * ep;
          } else {
            const float E = expf(-ep * sv_);
            const float B = y[e] - ep * (Qe * vh[e] + tt);
            const float dB = dxo * mb * E;
            const float dsx = dB * B + dlc * mb;
            const float dtt = -dB * ep;
            const float dQ = dtt * vh[e];
            dy[e] = dxo * m + dB;
            dvh[e] += dtt * Qe;
            de[e] += -dB * (Qe * vh[e] + tt) + dQ * Qe * qv - dsx * sv_;
            ds[e] = -ep * dsx;
            dt[e] = dtt;
            dq[e] = dQ * Qe * ep;
          }
        } else if (app == 1) {
          // y from x: the first position update; da, db are those of the
          // second update's net
          const float xv = t.z[e];
          if (!rev) {
            const float dyv = dy[e] + db[e] * mb;
            float dvhv = dvh[e] + da[e];
            const float E = expf(ep * sv_);
            const float dsx = dyv * mb * xv * E + dlc * mb;
            const float dtt = dyv * mb * ep;
            const float dQ = dtt * vh[e];
            dx[e] = dyv * (m + mb * E);
            dvhv += dtt * Qe;
            de[e] += dyv * mb * (Qe * vh[e] + tt) + dQ * Qe * qv + dsx * sv_;
            ds[e] = dsx * ep;
            dt[e] = dtt;
            dq[e] = dQ * Qe * ep;
            dvh[e] = dvhv;
          } else {
            const float dyv = dy[e] + db[e] * m;
            float dvhv = dvh[e] + da[e];
            const float E = expf(-ep * sv_);
            const float B = xv - ep * (Qe * vh[e] + tt);
            const float dB = dyv * m * E;
            const float dsx = dB * B + dlc * m;
            const float dtt = -dB * ep;
            const float dQ = dtt * vh[e];
            dx[e] = dyv * mb + dB;
            dvhv += dtt * Qe;
            de[e] += -dB * (Qe * vh[e] + tt) + dQ * Qe * qv - dsx * sv_;
            ds[e] = -ep * dsx;
            dt[e] = dtt;
            dq[e] = dQ * Qe * ep;
            dvh[e] = dvhv;
          }
        } else {
          // vh from v: the first momentum update; da, db are those of the
          // first position update's net
          const float g1 = t.g[e];
          const float dvhv = dvh[e] + da[e];
          if (!rev) {
            dx[e] += db[e] * m;
            const float E = expf(hf * sv_);
            const float dsv = dvhv * t.v[e] * E + dlc;
            const float dQ = -dvhv * hf * g1;
            dv[e] = dvhv * E;
            de[e] += 0.5f * dvhv * (-Qe * g1 + tt) + dQ * Qe * qv +
                     0.5f * dsv * sv_;
            ds[e] = dsv * hf;
            dt[e] = dvhv * hf;
            dq[e] = dQ * Qe * ep;
            pend[e] = -dvhv * hf * Qe;
          } else {
            dx[e] += db[e] * mb;
            const float E = expf(-hf * sv_);
            const float A = t.v[e] - hf * (-Qe * g1 + tt);
            const float dvn = dvhv * E;
            const float dsv = dvhv * A * E + dlc;
            const float dQ = dvn * hf * g1;
            dv[e] = dvn;
            de[e] += 0.5f * dvn * (Qe * g1 - tt) + dQ * Qe * qv -
                     0.5f * dsv * sv_;
            ds[e] = -hf * dsv;
            dt[e] = -dvn * hf;
            dq[e] = dQ * Qe * ep;
            pend[e] = dvn * hf * Qe;
          }
        }
      }
      __syncthreads();
      net_vjp<Ct>(d, q, vnet ? a.w.vnet : a.w.xnet, vnet ? gvn : gxn, st,
                      in_a, in_b, t.S, t.Q, ds, dt, dq, da, db, demb, sw, xw);
      if (app == 3) {
        // in float32 one sweep for both cotangents of the gradient at
        // x_{k+1}: this step's (through its last net and momentum update)
        // and the next step's, which waited in pend. With bfloat16 operands
        // the sweep's rounded tangent products are not linear in the
        // cotangent, so each of the two gradient calls that the trajectory
        // makes at x_{k+1} (its plain version's, and JAX's) gets its own
        // sweep, this step's first
        for (int e = tid; e < Dn * Ct; e += kThreads) {
          const int il = e / Ct, c = e - il * Ct;
          dx[e] += da[e];
          zu[il * CC + 2 * c] = xo[e];
          zu[il * CC + 2 * c + 1] = pend_last[e] + db[e];
        }
        csync();
        decoder_hvp<Ct>(d, q, a.w.dec, a.xraw, N, zu, gh, dual, s.stage);
        if (!kF32 && k + 1 < d.T) {
          for (int e = tid; e < Dn * Ct; e += kThreads) {
            const int il = e / Ct, c = e - il * Ct;
            dx[e] += gh[il * CC + 2 * c + 1];
            zu[il * CC + 2 * c + 1] = pend[e];
          }
          csync();
          decoder_hvp<Ct>(d, q, a.w.dec, a.xraw, N, zu, gh, dual, s.stage);
        }
      } else if (app == 0) {
        for (int e = tid; e < Dn * Ct; e += kThreads) {
          dx[e] += da[e];
          pend[e] += db[e];
        }
        __syncthreads();
      }
    }
  }

  // the start point's gradient call still waits
  for (int e = tid; e < Dn * Ct; e += kThreads) {
    const int il = e / Ct, c = e - il * Ct;
    zu[il * CC + 2 * c] = t.z[e];
    zu[il * CC + 2 * c + 1] = pend[e];
  }
  csync();
  decoder_hvp<Ct>(d, q, a.w.dec, a.xraw, N, zu, gh, dual, s.stage);
  for (int e = tid; e < Dn * Ct; e += kThreads) {
    const int il = e / Ct, c = e - il * Ct;
    dx[e] += gh[il * CC + 2 * c + 1];
  }
  __syncthreads();
  store_rows<Ct>(dx, i0, Dn, N, n0, a.dz);
  store_rows<Ct>(dv, i0, Dn, N, n0, a.dv);
  store_rows<Ct>(demb, h0, q.Hn, N, n0, a.demb);
  for (int il = tid; il < Dn; il += kThreads) {
    float sum = 0.f;
    for (int c = 0; c < Ct; ++c) sum += de[il * Ct + c];
    geps[i0 + il] = sum;
  }
  csync();  // no CTA leaves while another reads its shared memory
}

// out[r] = sum over clusters b of partial[b][r], in cluster order.
__global__ void sum_clusters_kernel(const float* __restrict__ partial,
                                    int clusters, int n_grads,
                                    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_grads) return;
  float s = 0.f;
  for (int b = 0; b < clusters; ++b)
    s += partial[static_cast<size_t>(b) * n_grads + r];
  out[r] = s;
}

template <class TW>
int launch_bwd(const void* const* ptrs, const Dims& d, const float* xraw,
               const float* emb, const float* z, const float* v,
               const float* dZ, const float* dV, const float* dld, float* dz,
               float* dv, float* demb, float* grads, float* partial, float* bnd,
               float* act, int N, int reverse, cudaStream_t s) {
  BwdArgs<TW> a;
  a.d = d;
  a.w = carve_weights<TW>(ptrs);
  a.xraw = xraw;
  a.emb = emb;
  a.zin = z;
  a.vin = v;
  a.dZ = dZ;
  a.dV = dV;
  a.dld = dld;
  a.dz = dz;
  a.dv = dv;
  a.demb = demb;
  a.partial = partial;
  a.bnd = bnd;
  a.act = act;
  a.N = N;
  a.reverse = reverse;
  const size_t smem = static_cast<size_t>(bwd_floats<kCt, kG>(a.d)) * sizeof(float);
  const int clusters = (N + kCt - 1) / kCt;
  cudaError_t e = l2hmc::launch_clusters(vae_traj_bwd_kernel<kCt, kG, TW>, kG,
                                         clusters, kThreads, smem, s, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_grads = 2 * net_floats(a.d) + d.D;
  sum_clusters_kernel<<<(n_grads + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, clusters, n_grads, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vaec
}  // namespace l2hmc

// Plain C entry points (loaded with ctypes). ptrs is a host array of
// kPtrs device pointers in carve_weights' order (as for l2hmc_vae_traj:
// float32, the weight matrices bfloat16 when bf16 is set); xraw (P, N), emb
// and demb (H, N); z, v, dZ, dV, dz, dv (D, N); dld (N); grads (n_grads)
// with n_grads = 2 * net_floats + D in the order xnet | vnet | eps, each net
// as carve_grad; partial, bnd and act scratches of
// l2hmc_vae_traj_bwd_sizes' floats; bf16 picks the instantiation with
// bfloat16 operands. Returns a cudaError_t as int; 0 means both launches
// were accepted.
extern "C" int l2hmc_vae_traj_bwd(
    const void* const* ptrs, int D, int H, int H2, int T, int E, int P,
    const float* xraw, const float* emb, const float* z, const float* v,
    const float* dZ, const float* dV, const float* dld, float* dz, float* dv,
    float* demb, float* grads, float* partial, float* bnd, float* act, int N,
    int reverse, int bf16, void* stream) {
  using namespace l2hmc::vaec;
  if (N <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{D, H, H2, T, E, P};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(ptrs, d, xraw, emb, z, v, dZ, dV, dld, dz, dv,
                                          demb, grads, partial, bnd, act, N, reverse, s)
              : launch_bwd<float>(ptrs, d, xraw, emb, z, v, dZ, dV, dld, dz, dv, demb,
                                  grads, partial, bnd, act, N, reverse, s);
}

// What the host allocates for N chains at these widths: out[0] = Ct,
// out[1] = G, out[2] = shared-memory bytes per CTA, out[3] = floats of act
// (one bwd_act_floats slice per cluster of Ct chains), out[4] = floats of
// partial (one slice of the n_grads cotangents per cluster), out[5] =
// floats of bnd ((5 T + 3) (D, N) states).
extern "C" int l2hmc_vae_traj_bwd_sizes(int D, int H, int H2, int T, int E,
                                        int P, int N, long long* out) {
  using namespace l2hmc::vaec;
  const Dims d{D, H, H2, T, E, P};
  const long long clusters = (N + kCt - 1) / kCt;
  out[0] = kCt;
  out[1] = kG;
  out[2] = static_cast<long long>(bwd_floats<kCt, kG>(d)) * sizeof(float);
  out[3] = clusters * bwd_act_floats(d, kCt);
  out[4] = clusters * (2 * net_floats(d) + D);
  out[5] = static_cast<long long>(5 * T + 3) * D * N;
  return 0;
}

// How many clusters the card holds at once at these widths.
extern "C" int l2hmc_vae_traj_bwd_clusters(int D, int H, int H2, int T, int E,
                                           int P) {
  using namespace l2hmc::vaec;
  const Dims d{D, H, H2, T, E, P};
  const size_t smem = static_cast<size_t>(bwd_floats<kCt, kG>(d)) * sizeof(float);
  return l2hmc::max_clusters(vae_traj_bwd_kernel<kCt, kG, float>, kG, kThreads, smem);
}
