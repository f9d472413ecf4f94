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
// Bound on the card: operations. Per chain: the forward recompute (T + 1
// decoder sweeps, 4 T net applications), T + 1 sweeps that carry a tangent
// beside the primal (the Hessian-vector products), and per net application
// a recompute, the transposed products and the outer products of the weight
// cotangents.
//
// Design.
//  - One block of kThreads threads per tile of C chains, as vae_traj.cu; a
//    first pass runs the trajectory and writes every leapfrog step's
//    boundary (z, v, gradient) and its two inner states to a device scratch
//    (so T has no compile-time cap), a second pass walks the steps back.
//  - Hessian-vector products. The Hessian is symmetric, so the cotangent u
//    of a gradient call gives H u as a tangent: the sweep runs on [.][2 C]
//    arrays, primal columns beside tangent columns, so one read of a weight
//    row feeds both, and the epilogues apply softplus' = sigmoid and
//    softplus'' = sigmoid (1 - sigmoid) from the primal column. Each
//    boundary point is the end of one step and the start of the next; its
//    two cotangents do not depend on each other and are added before the one
//    sweep, so a launch makes T + 1 of them.
//  - Weight cotangents summed over chains. The TPU kernel revisits one
//    output block across grid steps, which relies on the grid running in
//    order. Here every block adds its tile's outer products, over all 4 T
//    net applications, into its own slice of a (blocks, G) scratch (entry
//    idx always by thread idx mod kThreads: no atomics), and a second kernel
//    sums the slices in block order, so a launch repeats itself bit for bit.
//  - The nets' activations share the shared memory of the decoder sweeps,
//    which are never live at the same time.
//
// State layout (D, N): element i of chain n at i * N + n. N need not divide
// the tile: chains >= N read zeros, carry zero cotangents and add nothing.
#include "vae_common.cuh"

namespace l2hmc {
namespace vae {

// Transposes of one net's matrices, for the products of the VJP:
// w1t, w2t (H, D), wht (H2, H), wot (3 D, H2).
struct NetT {
  const float *w1t, *w2t, *wht, *wot;
};

inline NetT carve_net_t(const float*& p, const Dims& d) {
  NetT w;
  const size_t D = d.D, H = d.H, H2 = d.H2;
  w.w1t = take(p, H * D);
  w.w2t = take(p, H * D);
  w.wht = take(p, H2 * H);
  w.wot = take(p, 3 * D * H2);
  return w;
}

// One net's cotangents, in the order of carve_net.
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

struct BwdArgs {
  Dims d;
  Decoder dec;
  Net xnet, vnet;
  NetT xnet_t, vnet_t;
  const float* eps;    // (D)
  const float* masks;  // (D, T)
  const float* xraw;   // (P, N)
  const float* emb;    // (H, N)
  const float* zin;    // (D, N)
  const float* vin;    // (D, N)
  const float* dZ;     // (D, N)
  const float* dV;     // (D, N)
  const float* dld;    // (N)
  float* dz;           // (D, N)
  float* dv;           // (D, N)
  float* demb;         // (H, N)
  float* partial;      // (blocks, 2 net_floats + D)
  float* bnd;          // (5 T + 3, D, N)
  int N, reverse;
};

constexpr int kDArrays = 26;  // [D][C] arrays of the kernel

// floats of the region the decoder sweeps and the nets share
template <int C>
__host__ __device__ inline int region_floats(const Dims& d) {
  const int dual = 2 * C * (2 * d.E + d.P);
  const int nets = work_floats<C>(d) + C * (d.H + d.H2 + 3 * d.D);
  return dual > nets ? dual : nets;
}

template <int C>
__host__ __device__ inline int bwd_floats(const Dims& d) {
  return region_floats<C>(d) + C * (kDArrays * d.D + d.H + 4);
}

// sum_c p[c] q[c] over one row of two [.][C] arrays
template <int C>
__device__ __forceinline__ float dot_c(const float* p, const float* q) {
  float a[C], b[C];
  load_row<C>(p, a);
  load_row<C>(q, b);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

template <int C>
__device__ __forceinline__ float sum_c(const float* p) {
  float a[C];
  load_row<C>(p, a);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s += a[c];
  return s;
}

// G[k][j] += sum_c left[k][c] right[j][c] for k < K, j < M; entry idx is
// always touched by thread idx mod kThreads.
template <int C>
__device__ __forceinline__ void outer_add(float* __restrict__ G,
                                          const float* left, int K,
                                          const float* right, int M) {
  const int total = K * M;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int k = idx / M, j = idx - k * M;
    G[idx] += dot_c<C>(left + k * C, right + j * C);
  }
}

// Value, gradient and Hessian-vector product of U(z | x) for the block's C
// chains: zu is [D][2 C] with z in columns 0 .. C - 1 and the vector u in
// columns C .. 2 C - 1; gh gets the gradient and H u in the same layout.
// h1, h2 are [E][2 C], d3 [P][2 C]. Synchronised on return.
template <int C>
__device__ void decoder_hvp(const Dims& d, const Decoder& w,
                            const float* __restrict__ xraw, int N, int n0,
                            const float* zu, float* gh, float* h1, float* h2,
                            float* d3) {
  constexpr int CC = 2 * C;
  constexpr int R = C == 4 ? kRows : 2;
  product<CC, R>(w.W1, d.D, zu, nullptr, 0, nullptr, d.E,
                 [&](int m, const float (&acc)[CC]) {
                   const float b = w.b1[m];
#pragma unroll
                   for (int c = 0; c < C; ++c) {
                     const float h = softplus(acc[c] + b);
                     h1[m * CC + c] = h;
                     h1[m * CC + C + c] = sigmoid_of_softplus(h) * acc[C + c];
                   }
                 });
  __syncthreads();
  product<CC, R>(w.W2, d.E, h1, nullptr, 0, nullptr, d.E,
                 [&](int m, const float (&acc)[CC]) {
                   const float b = w.b2[m];
#pragma unroll
                   for (int c = 0; c < C; ++c) {
                     const float h = softplus(acc[c] + b);
                     h2[m * CC + c] = h;
                     h2[m * CC + C + c] = sigmoid_of_softplus(h) * acc[C + c];
                   }
                 });
  __syncthreads();
  product<CC, R>(w.W3, d.E, h2, nullptr, 0, nullptr, d.P,
                 [&](int m, const float (&acc)[CC]) {
                   const float b = w.b3[m];
#pragma unroll
                   for (int c = 0; c < C; ++c) {
                     const int n = n0 + c;
                     const float x =
                         n < N ? xraw[static_cast<size_t>(m) * N + n] : 0.f;
                     const float sg = 1.f / (1.f + expf(-(acc[c] + b)));
                     d3[m * CC + c] = sg - x;
                     d3[m * CC + C + c] = sg * (1.f - sg) * acc[C + c];
                   }
                 });
  __syncthreads();
  product<CC, R>(w.W3t, d.P, d3, nullptr, 0, nullptr, d.E,
                 [&](int m, const float (&acc)[CC]) {
#pragma unroll
                   for (int c = 0; c < C; ++c) {
                     const float sg = sigmoid_of_softplus(h2[m * CC + c]);
                     const float t = h2[m * CC + C + c];
                     h2[m * CC + c] = acc[c] * sg;
                     h2[m * CC + C + c] =
                         acc[C + c] * sg + acc[c] * (1.f - sg) * t;
                   }
                 });
  __syncthreads();
  product<CC, R>(w.W2t, d.E, h2, nullptr, 0, nullptr, d.E,
                 [&](int m, const float (&acc)[CC]) {
#pragma unroll
                   for (int c = 0; c < C; ++c) {
                     const float sg = sigmoid_of_softplus(h1[m * CC + c]);
                     const float t = h1[m * CC + C + c];
                     h1[m * CC + c] = acc[c] * sg;
                     h1[m * CC + C + c] =
                         acc[C + c] * sg + acc[c] * (1.f - sg) * t;
                   }
                 });
  __syncthreads();
  product<CC, 1>(w.W1t, d.E, h1, nullptr, 0, nullptr, d.D,
                 [&](int m, const float (&acc)[CC]) {
#pragma unroll
                   for (int c = 0; c < CC; ++c)
                     gh[m * CC + c] = acc[c] + zu[m * CC + c];
                 });
  __syncthreads();
}

// The nets' extra activations of the VJP: dz1 [H][C], dz2 [H2][C], the
// cotangents of the two hidden pre-activations; du [3 D][C], those of the
// three heads' pre-activations.
struct VjpWork {
  float *dz1, *dz2, *du;
};

// VJP of apply_net at inputs a, b for the cotangents ds, dt, dq of its
// outputs, right after apply_net has run on the same inputs (s.ha, s.hb
// hold its hidden layers, S and Q its outputs): adds the weights'
// cotangents of the tile into G, the hidden pre-activation's into demb
// [H][C], and gives da, db [D][C]. step is the tile's leapfrog step.
// Synchronised on return.
template <int C>
__device__ void net_vjp(const Dims& d, const Net& w, const NetT& wt,
                        const NetGrad& G, int step, const float* a,
                        const float* b, const float* S, const float* Q,
                        const float* ds, const float* dt, const float* dq,
                        float* da, float* db, float* demb, const Work<C>& s,
                        const VjpWork& x) {
  const float* ha = s.ha;
  const float* hb = s.hb;
  for (int j = threadIdx.x; j < 3 * d.D; j += kThreads) {
    const int head = j / d.D;
    const int i = j - head * d.D;
    float sum_b = 0.f, sum_l = 0.f;
    if (head == 1) {
      for (int c = 0; c < C; ++c) {
        const float u = dt[i * C + c];
        x.du[j * C + c] = u;
        sum_b += u;
      }
      G.bt[i] += sum_b;
    } else {
      const float* out = head == 0 ? S : Q;
      const float* dout = head == 0 ? ds : dq;
      const float l = head == 0 ? w.ls[i] : w.lq[i];
      const float sc = expf(l), inv = expf(-l);
      for (int c = 0; c < C; ++c) {
        const float o = out[i * C + c];
        const float th = o * inv;  // the head's tanh
        const float g = dout[i * C + c];
        const float u = g * sc * (1.f - th * th);
        x.du[j * C + c] = u;
        sum_b += u;
        sum_l += g * o;
      }
      if (head == 0) {
        G.bs[i] += sum_b;
        G.ls[i] += sum_l;
      } else {
        G.bq[i] += sum_b;
        G.lq[i] += sum_l;
      }
    }
  }
  __syncthreads();
  outer_add<C>(G.wo, hb, d.H2, x.du, 3 * d.D);
  product<C, 1>(wt.wot, 3 * d.D, x.du, nullptr, 0, nullptr, d.H2,
                [&](int m, const float (&acc)[C]) {
#pragma unroll
                  for (int c = 0; c < C; ++c)
                    x.dz2[m * C + c] = hb[m * C + c] > 0.f ? acc[c] : 0.f;
                });
  __syncthreads();
  for (int m = threadIdx.x; m < d.H2; m += kThreads)
    G.bh[m] += sum_c<C>(x.dz2 + m * C);
  outer_add<C>(G.wh, ha, d.H, x.dz2, d.H2);
  product<C, 1>(wt.wht, d.H2, x.dz2, nullptr, 0, nullptr, d.H,
                [&](int m, const float (&acc)[C]) {
#pragma unroll
                  for (int c = 0; c < C; ++c)
                    x.dz1[m * C + c] = ha[m * C + c] > 0.f ? acc[c] : 0.f;
                });
  __syncthreads();
  for (int m = threadIdx.x; m < d.H; m += kThreads) {
    G.te[m * d.T + step] += sum_c<C>(x.dz1 + m * C);
#pragma unroll
    for (int c = 0; c < C; ++c) demb[m * C + c] += x.dz1[m * C + c];
  }
  outer_add<C>(G.w1, a, d.D, x.dz1, d.H);
  outer_add<C>(G.w2, b, d.D, x.dz1, d.H);
  product<C, 1>(wt.w1t, d.H, x.dz1, nullptr, 0, nullptr, d.D,
                [&](int m, const float (&acc)[C]) {
#pragma unroll
                  for (int c = 0; c < C; ++c) da[m * C + c] = acc[c];
                });
  product<C, 1>(wt.w2t, d.H, x.dz1, nullptr, 0, nullptr, d.D,
                [&](int m, const float (&acc)[C]) {
#pragma unroll
                  for (int c = 0; c < C; ++c) db[m * C + c] = acc[c];
                });
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(kThreads) vae_traj_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  const Dims d = a.d;
  const int DC = d.D * C;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * C;
  const bool rev = a.reverse != 0;

  // the shared region: the forward pass's Work and the nets' VJP arrays, or
  // the [.][2 C] arrays of a sweep with a tangent
  float* region = p;
  p += region_floats<C>(d);
  float* q = region;
  const Work<C> work = carve_work<C>(q, d);
  VjpWork xw;
  xw.dz1 = q; q += d.H * C;
  xw.dz2 = q; q += d.H2 * C;
  xw.du = q;
  float* const h1d = region;
  float* const h2d = h1d + 2 * C * d.E;
  float* const d3d = h2d + 2 * C * d.E;

  Traj<C> t;
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
  float* zu = p; p += 2 * DC;  // [D][2 C]: position | vector
  float* gh = p; p += 2 * DC;  // [D][2 C]: gradient | Hessian-vector product
  float* demb = p; p += d.H * C;
  float* dl = p; p += C;
  t.energy = p; p += C;
  t.step = reinterpret_cast<int*>(p); p += C;
  t.flag = reinterpret_cast<int*>(p); p += C;
  float* const pend = t.ldp;

  const int nf = net_floats(d);
  const int n_grads = 2 * nf + d.D;
  float* Gp = a.partial + static_cast<size_t>(blockIdx.x) * n_grads;
  for (int r = tid; r < n_grads; r += kThreads) Gp[r] = 0.f;
  float* gq = Gp;
  const NetGrad gxn = carve_grad(gq, d);
  const NetGrad gvn = carve_grad(gq, d);
  float* const geps = gq;

  const size_t slab = static_cast<size_t>(d.D) * a.N;
  // scratch slots: x_k, v_k, g_k at 3 k .. 3 k + 2 (k = 0 .. T), then the
  // inner states of step k at 3 (T + 1) + 2 k, + 1
  auto slot = [&](int s) { return a.bnd + s * slab; };
  const int inner0 = 3 * (d.T + 1);

  // -- the trajectory, with its boundary and inner states written out -------
  load_tile<C>(a.zin, d.D, a.N, n0, t.z);
  load_tile<C>(a.vin, d.D, a.N, n0, t.v);
  for (int e = tid; e < DC; e += kThreads) t.ldp[e] = 0.f;
  if (tid < C) t.flag[tid] = !rev;
  __syncthreads();
  decoder_grad<C>(d, a.dec, a.xraw, a.N, n0, t.z, t.g, t.energy, work);
  store_tile<C>(t.z, d.D, a.N, n0, slot(0));
  store_tile<C>(t.v, d.D, a.N, n0, slot(1));
  store_tile<C>(t.g, d.D, a.N, n0, slot(2));
  for (int it = 0; it < d.T; ++it) {
    leapfrog_step<C>(d, a.dec, a.xnet, a.vnet, a.eps, a.masks, a.xraw, a.emb,
                     a.N, n0, it, t, work, [&](int which) {
                       store_tile<C>(which == 0 ? t.v : t.z, d.D, a.N, n0,
                                     slot(inner0 + 2 * it + which));
                     });
    store_tile<C>(t.z, d.D, a.N, n0, slot(3 * (it + 1)));
    store_tile<C>(t.v, d.D, a.N, n0, slot(3 * (it + 1) + 1));
    store_tile<C>(t.g, d.D, a.N, n0, slot(3 * (it + 1) + 2));
  }
  __syncthreads();

  // -- the way back --------------------------------------------------------------
  load_tile<C>(a.dZ, d.D, a.N, n0, dx);
  load_tile<C>(a.dV, d.D, a.N, n0, dv);
  for (int e = tid; e < DC; e += kThreads) {
    de[e] = 0.f;
    pend[e] = 0.f;
  }
  for (int e = tid; e < d.H * C; e += kThreads) demb[e] = 0.f;
  if (tid < C) dl[tid] = n0 + tid < a.N ? a.dld[n0 + tid] : 0.f;

  for (int k = d.T - 1; k >= 0; --k) {
    const int st = rev ? d.T - 1 - k : k;
    if (tid < C) t.step[tid] = st;
    load_tile<C>(slot(3 * k), d.D, a.N, n0, t.z);
    load_tile<C>(slot(3 * k + 1), d.D, a.N, n0, t.v);
    load_tile<C>(slot(3 * k + 2), d.D, a.N, n0, t.g);
    load_tile<C>(slot(3 * (k + 1)), d.D, a.N, n0, xo);
    load_tile<C>(slot(3 * (k + 1) + 2), d.D, a.N, n0, g2);
    load_tile<C>(slot(inner0 + 2 * k), d.D, a.N, n0, vh);
    load_tile<C>(slot(inner0 + 2 * k + 1), d.D, a.N, n0, y);
    __syncthreads();

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
        for (int e = tid; e < DC; e += kThreads) {
          const int i = e / C;
          const float m = a.masks[i * d.T + st];
          const float keep = (app == 2) == rev ? m : 1.f - m;
          t.bin[e] = keep * src[e];
        }
        __syncthreads();
      }
      apply_net<C>(d, vnet ? a.vnet : a.xnet, a.emb, a.N, n0, t.step, in_a,
                   in_b, t.S, t.Tt, t.Q, work);
      for (int e = tid; e < DC; e += kThreads) {
        const int i = e / C, c = e - i * C;
        const float ep = a.eps[i];
        const float hf = 0.5f * ep;
        const float m = a.masks[i * d.T + st];
        const float mb = 1.f - m;
        const float s = t.S[e], tt = t.Tt[e], qv = t.Q[e];
        const float Qe = expf(ep * qv);
        const float dlc = dl[c];
        if (app == 3) {
          // v' = vh E + hf (-Qe g2 + tt), or v' = E (vh - hf (-Qe g2 + tt))
          const float dvo = dv[e];
          if (!rev) {
            const float E = expf(hf * s);
            const float dsv = dvo * vh[e] * E + dlc;
            const float dQ = -dvo * hf * g2[e];
            dvh[e] = dvo * E;
            de[e] += 0.5f * dvo * (-Qe * g2[e] + tt) + dQ * Qe * qv +
                     0.5f * dsv * s;
            ds[e] = dsv * hf;
            dt[e] = dvo * hf;
            dq[e] = dQ * Qe * ep;
            pend[e] += -dvo * hf * Qe;
          } else {
            const float E = expf(-hf * s);
            const float A = vh[e] - hf * (-Qe * g2[e] + tt);
            const float dvhv = dvo * E;
            const float dsv = dvo * A * E + dlc;
            const float dQ = dvhv * hf * g2[e];
            dvh[e] = dvhv;
            de[e] += 0.5f * dvhv * (Qe * g2[e] - tt) + dQ * Qe * qv -
                     0.5f * dsv * s;
            ds[e] = -hf * dsv;
            dt[e] = -dvhv * hf;
            dq[e] = dQ * Qe * ep;
            pend[e] += dvhv * hf * Qe;
          }
        } else if (app == 2) {
          // x' from y: the second position update; the Hessian-vector
          // product at x' joins its cotangent here
          const float dxo = dx[e] + gh[i * 2 * C + C + c];
          if (!rev) {
            const float E = expf(ep * s);
            const float dsx = dxo * m * y[e] * E + dlc * m;
            const float dtt = dxo * m * ep;
            const float dQ = dtt * vh[e];
            dy[e] = dxo * (mb + m * E);
            dvh[e] += dtt * Qe;
            de[e] += dxo * m * (Qe * vh[e] + tt) + dQ * Qe * qv + dsx * s;
            ds[e] = dsx * ep;
            dt[e] = dtt;
            dq[e] = dQ * Qe * ep;
          } else {
            const float E = expf(-ep * s);
            const float B = y[e] - ep * (Qe * vh[e] + tt);
            const float dB = dxo * mb * E;
            const float dsx = dB * B + dlc * mb;
            const float dtt = -dB * ep;
            const float dQ = dtt * vh[e];
            dy[e] = dxo * m + dB;
            dvh[e] += dtt * Qe;
            de[e] += -dB * (Qe * vh[e] + tt) + dQ * Qe * qv - dsx * s;
            ds[e] = -ep * dsx;
            dt[e] = dtt;
            dq[e] = dQ * Qe * ep;
          }
        } else if (app == 1) {
          // y from x: the first position update; da, db are those of the
          // second update's net
          const float x = t.z[e];
          if (!rev) {
            const float dyv = dy[e] + db[e] * mb;
            float dvhv = dvh[e] + da[e];
            const float E = expf(ep * s);
            const float dsx = dyv * mb * x * E + dlc * mb;
            const float dtt = dyv * mb * ep;
            const float dQ = dtt * vh[e];
            dx[e] = dyv * (m + mb * E);
            dvhv += dtt * Qe;
            de[e] += dyv * mb * (Qe * vh[e] + tt) + dQ * Qe * qv + dsx * s;
            ds[e] = dsx * ep;
            dt[e] = dtt;
            dq[e] = dQ * Qe * ep;
            dvh[e] = dvhv;
          } else {
            const float dyv = dy[e] + db[e] * m;
            float dvhv = dvh[e] + da[e];
            const float E = expf(-ep * s);
            const float B = x - ep * (Qe * vh[e] + tt);
            const float dB = dyv * m * E;
            const float dsx = dB * B + dlc * m;
            const float dtt = -dB * ep;
            const float dQ = dtt * vh[e];
            dx[e] = dyv * mb + dB;
            dvhv += dtt * Qe;
            de[e] += -dB * (Qe * vh[e] + tt) + dQ * Qe * qv - dsx * s;
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
            const float E = expf(hf * s);
            const float dsv = dvhv * t.v[e] * E + dlc;
            const float dQ = -dvhv * hf * g1;
            dv[e] = dvhv * E;
            de[e] += 0.5f * dvhv * (-Qe * g1 + tt) + dQ * Qe * qv +
                     0.5f * dsv * s;
            ds[e] = dsv * hf;
            dt[e] = dvhv * hf;
            dq[e] = dQ * Qe * ep;
            pend[e] = -dvhv * hf * Qe;
          } else {
            dx[e] += db[e] * mb;
            const float E = expf(-hf * s);
            const float A = t.v[e] - hf * (-Qe * g1 + tt);
            const float dvn = dvhv * E;
            const float dsv = dvhv * A * E + dlc;
            const float dQ = dvn * hf * g1;
            dv[e] = dvn;
            de[e] += 0.5f * dvn * (Qe * g1 - tt) + dQ * Qe * qv -
                     0.5f * dsv * s;
            ds[e] = -hf * dsv;
            dt[e] = -dvn * hf;
            dq[e] = dQ * Qe * ep;
            pend[e] = dvn * hf * Qe;
          }
        }
      }
      __syncthreads();
      net_vjp<C>(d, vnet ? a.vnet : a.xnet, vnet ? a.vnet_t : a.xnet_t,
                 vnet ? gvn : gxn, st, in_a, in_b, t.S, t.Q, ds, dt, dq, da,
                 db, demb, work, xw);
      if (app == 3) {
        // one sweep for both cotangents of the gradient at x_{k+1}: this
        // step's (through its last net and momentum update) and the next
        // step's, which waited in pend
        for (int e = tid; e < DC; e += kThreads) {
          const int i = e / C, c = e - i * C;
          dx[e] += da[e];
          zu[i * 2 * C + c] = xo[e];
          zu[i * 2 * C + C + c] = pend[e] + db[e];
        }
        __syncthreads();
        decoder_hvp<C>(d, a.dec, a.xraw, a.N, n0, zu, gh, h1d, h2d, d3d);
      } else if (app == 0) {
        for (int e = tid; e < DC; e += kThreads) {
          dx[e] += da[e];
          pend[e] += db[e];
        }
        __syncthreads();
      }
    }
  }

  // the start point's gradient call still waits
  for (int e = tid; e < DC; e += kThreads) {
    const int i = e / C, c = e - i * C;
    zu[i * 2 * C + c] = t.z[e];
    zu[i * 2 * C + C + c] = pend[e];
  }
  __syncthreads();
  decoder_hvp<C>(d, a.dec, a.xraw, a.N, n0, zu, gh, h1d, h2d, d3d);
  for (int e = tid; e < DC; e += kThreads) {
    const int i = e / C, c = e - i * C;
    dx[e] += gh[i * 2 * C + C + c];
  }
  __syncthreads();
  store_tile<C>(dx, d.D, a.N, n0, a.dz);
  store_tile<C>(dv, d.D, a.N, n0, a.dv);
  store_tile<C>(demb, d.H, a.N, n0, a.demb);
  for (int i = tid; i < d.D; i += kThreads) geps[i] = sum_c<C>(de + i * C);
}

// out[r] = sum over blocks b of partial[b][r], in block order.
__global__ void sum_blocks_kernel(const float* __restrict__ partial,
                                  int blocks, int n_grads,
                                  float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_grads) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b)
    s += partial[static_cast<size_t>(b) * n_grads + r];
  out[r] = s;
}

template <int C>
static cudaError_t launch_bwd(const BwdArgs& a, float* grads,
                              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bwd_floats<C>(a.d)) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(vae_traj_bwd_kernel<C>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.N + C - 1) / C;
  vae_traj_bwd_kernel<C><<<blocks, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_grads = 2 * net_floats(a.d) + a.d.D;
  sum_blocks_kernel<<<(n_grads + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(a.partial, blocks, n_grads, grads);
  return cudaGetLastError();
}

}  // namespace vae
}  // namespace l2hmc

// Plain C entry point (loaded with ctypes). Device pointers to float32:
// params is the packed block [eps (D), masks (D, T), decoder, xnet, vnet]
// in the order of carve_decoder / carve_net, then each net's transposes in
// the order of carve_net_t; xraw (P, N), emb and demb (H, N); z, v, dZ, dV,
// dz, dv (D, N); dld (N); grads (G) with G = 2 * net_floats + D in the order
// xnet (as carve_net) | vnet | eps; partial (blocks, G) with blocks =
// ceil(N / C); bnd ((5 T + 3) * D * N). C is the chain tile, 4 or 8.
// Returns a cudaError_t as int; 0 means both launches were accepted.
extern "C" int l2hmc_vae_traj_bwd(
    const float* params, int D, int H, int H2, int T, int E, int P,
    const float* xraw, const float* emb, const float* z, const float* v,
    const float* dZ, const float* dV, const float* dld, float* dz, float* dv,
    float* demb, float* grads, float* partial, float* bnd, int N, int reverse,
    int C, void* stream) {
  using namespace l2hmc::vae;
  if (N <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.d = Dims{D, H, H2, T, E, P};
  const float* p = params;
  a.eps = take(p, D);
  a.masks = take(p, static_cast<size_t>(D) * T);
  a.dec = carve_decoder(p, a.d);
  a.xnet = carve_net(p, a.d);
  a.vnet = carve_net(p, a.d);
  a.xnet_t = carve_net_t(p, a.d);
  a.vnet_t = carve_net_t(p, a.d);
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
  a.N = N;
  a.reverse = reverse;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4:
      return launch_bwd<4>(a, grads, s);
    case 8:
      return launch_bwd<8>(a, grads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
