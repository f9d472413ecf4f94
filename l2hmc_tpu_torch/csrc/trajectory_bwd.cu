// Vector-Jacobian product of the fused T-step L2HMC trajectory, a lane
// group per chain, and a fixed-order sum of the weight and eps cotangents
// over chains.
//
// Replaces the Pallas kernel _make_bwd_kernel / DifferentiableFusedDynamics
// (l2hmc_tpu/ops/fused_dynamics.py:801, pallas_call at :1024), whose body
// traces jax.vjp of one substep at a time (_trajectory_vjp :251). There is
// no trace-time AD here: the substep's VJP is derived by hand
// (lane_traj_step_vjp in l2hmc_lanes.cuh; its plain version is _step_vjp in
// ops/fused_dynamics.py).
//
// Bound on the card: operations, about three forward trajectories' worth
// per chain (the forward recompute of the boundary states, the per-substep
// recompute with each S/T/Q application run again inside its VJP, and the
// reverse sweep); it reads x, v, dX, dV, dld and writes dx, dv and the
// P = 2 * (13-array net size) + D summed cotangents once, a few tens of
// bytes per chain.
//
// Design. One thread per chain left the SCG instantiation (D = 2, H = 10)
// a serial chain of ~58 k dependent operations, with its hidden-layer
// arrays in local memory and every weight cotangent added into a global
// scratch inside the substep loop, on 16 of the card's 132 SMs at 1024
// chains: 1.4 ms, flat from 1024 to 8192 chains. Here a group of L lanes
// runs one chain, each lane on its share of the hidden units
// (l2hmc_lanes.cuh): SCG takes L = 16 (1024 chains make 128 blocks of 128
// threads), widths up to 64 L = 32 with two units a lane. Each lane keeps
// its share of the chain's weight cotangents in registers across all T
// substeps and writes it once, at the end, into its chain's row of an
// (N, P) scratch (te's column of a step once, after that step's substep);
// no global memory is read, modified and written inside the substep loop.
// The weights are read from shared memory, loaded once per block.
//
// The TPU kernel sums the weight cotangents over chain tiles by revisiting
// one output block across grid steps, which relies on the grid running in
// order; Hopper blocks run in no order. Here a second kernel sums each
// cotangent over the N chains in a fixed order (sum_chains_kernel), so the
// result is the same from run to run. The per-step boundary states (x, v)
// of the recompute go to a (T + 1, 2, D, N) scratch, written by lane 0 of
// each group. The wrapper allocates both scratches; the kernel allocates
// nothing.
//
// Past 64 wide (states up to 4096, the 64 x 64 phi^4 lattice, or hidden
// widths up to 128) site_traj_bwd_kernel runs the VJP on the site-parallel
// configuration (l2hmc_sites.cuh: site_substep_vjp), a tile of 4 chains a
// block of 256 threads, for every spec: this source instantiates it for the
// Gauss and Phi4 specs and trajectory_bwd_specs.cu, which compiles this file
// again, for RoughWell, Gmm and Funnel (below). Its forward sweep
// (site_traj_step, the trajectory kernel's substep) writes the tile's
// boundary states to a (T, 2, C, D) scratch of its own; the reverse sweep
// recomputes each substep's intermediates into shared memory (past D = 1024
// into a (10, C, D) global scratch of the block's own) and applies the
// substep's VJP.
//
// Its weight cotangents are sums over K = blocks x T x 2 applications x C
// chains of outer products (w1: a dz1^T, ...). The TPU kernel forms each
// grid step's as one product over its chain tile and adds it into the
// output block (_accumulate, l2hmc_tpu/ops/fused_dynamics.py:867). Adding
// each application's rank-4 update into a row of global memory inside the
// substep loop instead, the first form of this kernel, moved ~3.6 GB of
// read-modify-writes through the L2 a launch at L = 16 (1024 chains, hidden
// 32, T = 10), with 224-255 registers a thread and one block an SM: 9.1 ms
// on an H100 80GB HBM3 at 700 W (apps/kernel_times.py; 3.1 ms this way).
// Here the loop writes each application's factors once (a, b, dus, dut,
// duq, h, dz1, h2, dz2; 231 MB at L = 16) into a K-major factor scratch, and
// the block keeps only a compact row of the per-site, bh, te and eps
// cotangents (~3.5% of the old row). With the row accumulators gone a
// thread capped at 128 registers spills little, so two blocks share an SM
// and 1024 chains run as one wave (site_traj_bwd_kernel); and the shuffles
// of the input cotangents' sums are cut (l2hmc_sites.cuh). After the launch site_reduce_kernel forms the twelve
// products (six a net) as float32 sums over K, register-tiled on the CUDA
// cores: a block takes a 64 x 64 tile of one product over one of a fixed
// number of equal parts of K, its operand tiles staged through shared
// memory by cp.async; site_reduce_sum_kernel then adds the parts and the
// blocks' compact rows in a fixed order into the gradient vector. No
// atomics, so a launch repeats bit for bit. No TF32 either: the reference
// pins float32 contractions (l2hmc_tpu/config.py), so the products stay on
// the CUDA cores (67 TFLOP/s), where the ~3.4 GFLOP and 231 MB at L = 16
// bound the reduction at ~0.07 ms. Where a launch's factors would pass
// kSiteFactorCap floats (4 GiB: the 64 x 64 lattice at hidden 64, T = 24 and
// 1024 chains takes ~8 GB) the launcher runs its blocks in parts of equal
// block counts, in order, each part's VJP then its products (SiteBwdPlan);
// the parts' sums are added with the rest in the fixed order.
//
// State layout (D, N): element i of chain n at i * N + n. N need not divide
// the block.
#include "l2hmc_lanes.cuh"
#include "l2hmc_sites.cuh"

namespace l2hmc {

constexpr int kSumRows = 32;      // cotangent rows per block of the sum
constexpr int kSumWarps = 32;     // warps splitting the chains of a row

template <class C, class En>
__global__ void __launch_bounds__(kLaneThreads) trajectory_bwd_kernel(
    const float* __restrict__ params, Dims din, int reverse, int hmc,
    const float* __restrict__ xin, const float* __restrict__ vin,
    const float* __restrict__ dXin, const float* __restrict__ dVin,
    const float* __restrict__ dld, float* __restrict__ dxo,
    float* __restrict__ dvo, float* __restrict__ G, float* __restrict__ bnd,
    int N) {
  extern __shared__ float smem[];
  const Block B = load_block(params, smem, din);
  const Dims d = lane_dims<C>(din);
  const int chain = (blockIdx.x * kLaneThreads + threadIdx.x) / C::L;
  const bool live = chain < N;  // past N: a copy of the last chain, no writes
  const int n = live ? chain : N - 1;
  const int lane = lane_of<C>();
  const size_t sN = static_cast<size_t>(N);
  const int nf = net_floats(d);
  const int P = 2 * nf + d.D;
  float* g = G + static_cast<size_t>(n) * P;  // this chain's cotangent row
  const NetRows rx = net_rows(0, d), rv = net_rows(nf, d);
  float* bn = bnd + n;  // boundary k: x at row 2kD + i, v at row (2k+1)D + i
  const bool writer = live && lane == 0;

  float x[C::DM], v[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    x[i] = xin[i * sN + n];
    v[i] = vin[i * sN + n];
    if (writer) {
      bn[i * sN] = x[i];
      bn[(d.D + i) * sN] = v[i];
    }
  }
  for (int k = 0; k < d.T; ++k) {
    const int step = reverse ? d.T - 1 - k : k;
    lane_traj_step<C, En>(B, d, hmc != 0, reverse != 0, step, x, v, lane);
    const size_t row = static_cast<size_t>(2 * (k + 1) * d.D);
    if (writer) {
#pragma unroll (C::UD)
      for (int i = 0; i < C::DM; ++i) {
        if (i >= d.D) break;
        bn[(row + i) * sN] = x[i];
        bn[(row + d.D + i) * sN] = v[i];
      }
    }
  }
  __syncwarp();  // the group reads what its lane 0 wrote

  float dx[C::DM], dv[C::DM], de[C::DM];
#pragma unroll (C::UD)
  for (int i = 0; i < C::DM; ++i) {
    if (i >= d.D) break;
    dx[i] = dXin[i * sN + n];
    dv[i] = dVin[i * sN + n];
    de[i] = 0.f;
  }
  NetAcc<C> gx, gv;
  gx.zero();
  gv.zero();
  const float dl = dld[n];
  for (int k = d.T - 1; k >= 0; --k) {
    const int step = reverse ? d.T - 1 - k : k;
    const size_t row = static_cast<size_t>(2 * k * d.D);
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      x[i] = bn[(row + i) * sN];
      v[i] = bn[(row + d.D + i) * sN];
    }
    lane_traj_step_vjp<C, En>(B, gx, gv, d, hmc != 0, reverse != 0, step, x, v,
                          dx, dv, dl, de, lane);
    if (live) {
      flush_te<C>(gx, rx, g, d, step, lane);
      flush_te<C>(gv, rv, g, d, step, lane);
    }
  }
  if (!live) return;
  store_net<C>(gx, rx, g, d, lane);
  store_net<C>(gv, rv, g, d, lane);
  if (writer) {
#pragma unroll (C::UD)
    for (int i = 0; i < C::DM; ++i) {
      if (i >= d.D) break;
      dxo[i * sN + n] = dx[i];
      dvo[i * sN + n] = dv[i];
      g[2 * nf + i] = de[i];
    }
  }
}

// out[r] = sum over n of G[n * P + r] in a fixed order: a block takes
// kSumRows consecutive rows; lane l of warp w sums row r0 + l over chains
// w, w + kSumWarps, ... in turn, and lane l of warp 0 adds the warps'
// partials in warp order.
__global__ void __launch_bounds__(kSumRows * kSumWarps)
    sum_chains_kernel(const float* __restrict__ G, int N, int P,
                      float* __restrict__ out) {
  __shared__ float part[kSumWarps][kSumRows];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kSumRows + l;
  float acc = 0.f;
  if (r < P) {
#pragma unroll 8
    for (int n = w; n < N; n += kSumWarps)
      acc += G[static_cast<size_t>(n) * P + r];
  }
  part[w][l] = acc;
  __syncthreads();
  if (w == 0 && r < P) {
    float s = 0.f;
    for (int q = 0; q < kSumWarps; ++q) s += part[q][l];
    out[r] = s;
  }
}

// -- the reduction of the site VJP's factors ---------------------------------

constexpr int kRedTile = 64;      // a block's outputs: kRedTile x kRedTile
constexpr int kRedK = 16;         // rows of K a stage
constexpr int kRedThreads = 256;  // threads a block, 4 x 4 outputs each
constexpr int kRedTargetBlocks = 1056;  // 8 blocks on each of the 132 SMs
constexpr int kRedMaxSplits = 64;
constexpr int kRedProducts = 12;  // w1, w2, wh, ws, wt, wq of both nets

// out (M x N, at offset `out` of the reduction's output) = X^T Y, with X
// (K x M, row stride ldx) and Y (K x N, ldy) factor arrays.
struct ReduceProduct {
  const float *x, *y;
  int M, N, ldx, ldy, out;
};

struct ReducePlan {
  ReduceProduct p[kRedProducts];
  int first_tile[kRedProducts + 1];  // each product's first output tile
  int K, ksplit, wc;  // rows summed, rows a split, floats of the output
};

inline int red_tiles(int m, int n) {
  return ((m + kRedTile - 1) / kRedTile) * ((n + kRedTile - 1) / kRedTile);
}

// The parts K is cut into: enough blocks to fill the card (kRedTargetBlocks
// over the products' tiles), at most kRedMaxSplits, and at least 4 stages of
// K each. A function of the widths and K alone, so a launch's sums run in
// the same order every time.
inline int reduce_splits(Dims d, int K) {
  const int tiles = 2 * (2 * red_tiles(d.D, d.H) + red_tiles(d.H, d.H2) +
                         3 * red_tiles(d.H2, d.D));
  const int chunks = (K + kRedK - 1) / kRedK;
  int s = (kRedTargetBlocks + tiles - 1) / tiles;
  s = s < kRedMaxSplits ? s : kRedMaxSplits;
  s = s < chunks / 4 ? s : chunks / 4;
  return s > 1 ? s : 1;
}

// The twelve products over the first Kused rows of the factor scratch fac
// (K rows a net), cut into `splits` parts.
inline ReducePlan reduce_plan(const float* fac, Dims d, size_t K, int Kused, int splits) {
  ReducePlan r;
  int o = 0, t = 0;
  const int ldD = pad4(d.D), ldH = pad4(d.H), ldH2 = pad4(d.H2);
  for (int net = 0; net < 2; ++net) {
    auto f = [&](int arr) { return factor_row(const_cast<float*>(fac), d, K, net, arr, 0); };
    const ReduceProduct q[6] = {{f(kFa), f(kFz1), d.D, d.H, ldD, ldH, 0},
                                {f(kFb), f(kFz1), d.D, d.H, ldD, ldH, 0},
                                {f(kFh), f(kFz2), d.H, d.H2, ldH, ldH2, 0},
                                {f(kFh2), f(kFus), d.H2, d.D, ldH2, ldD, 0},
                                {f(kFh2), f(kFut), d.H2, d.D, ldH2, ldD, 0},
                                {f(kFh2), f(kFuq), d.H2, d.D, ldH2, ldD, 0}};
    for (int j = 0; j < 6; ++j) {
      ReduceProduct pr = q[j];
      pr.out = o;
      o += pr.M * pr.N;
      r.p[6 * net + j] = pr;
      r.first_tile[6 * net + j] = t;
      t += red_tiles(pr.M, pr.N);
    }
  }
  r.first_tile[kRedProducts] = t;
  r.K = Kused;
  r.wc = o;
  const int chunks = (Kused + kRedK - 1) / kRedK;
  r.ksplit = (chunks + splits - 1) / splits * kRedK;
  return r;
}

// A 16-byte copy into shared memory of the first `bytes` bytes at src, the
// rest zero-filled (cp.async.cg: through the L2 only).
__device__ inline void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (split s, tile t of product p), s-major: partial[s][out + m N + n] =
// sum over the rows k of split s, in increasing k, of X[k][m] Y[k][n], for
// the tile's 64 x 64 outputs. Thread (ty, tx) keeps a 4 x 4 tile of sums in
// registers; the stages' 16 x 64 tiles of X and Y come through shared
// memory, the next one's copies in flight while this one is summed; the
// tile's ragged edges are zero-filled. Float32 FMAs only (no TF32).
__global__ void __launch_bounds__(kRedThreads) site_reduce_kernel(const ReducePlan plan,
                                                                  float* __restrict__ partial) {
  __shared__ __align__(16) float xs[2][kRedK][kRedTile];
  __shared__ __align__(16) float ys[2][kRedK][kRedTile];
  const int tiles = plan.first_tile[kRedProducts];
  const int split = blockIdx.x / tiles;
  int t = blockIdx.x - split * tiles;
  ReduceProduct pr = plan.p[0];
  int first = 0;
#pragma unroll
  for (int q = 1; q < kRedProducts; ++q) {
    if (t >= plan.first_tile[q]) {
      pr = plan.p[q];
      first = plan.first_tile[q];
    }
  }
  t -= first;
  const int tn = (pr.N + kRedTile - 1) / kRedTile;
  const int m0 = (t / tn) * kRedTile, n0 = (t - (t / tn) * tn) * kRedTile;
  const int k0 = split * plan.ksplit;
  const int k1 = min(plan.K, k0 + plan.ksplit);
  const int chunks = k1 > k0 ? (k1 - k0 + kRedK - 1) / kRedK : 0;
  // this thread's copies: row lr of a stage, columns lc .. lc + 3
  const int lr = threadIdx.x >> 4, lc = (threadIdx.x & 15) * 4;
  const int bx = 4 * max(0, min(4, pr.M - m0 - lc)), by = 4 * max(0, min(4, pr.N - n0 - lc));
  auto load = [&](int chunk, int st) {
    const int k = k0 + chunk * kRedK + lr;
    const bool in = k < k1;
    const size_t kr = static_cast<size_t>(in ? k : 0);
    cp_async16(&xs[st][lr][lc], in && bx ? pr.x + kr * pr.ldx + m0 + lc : pr.x, in ? bx : 0);
    cp_async16(&ys[st][lr][lc], in && by ? pr.y + kr * pr.ldy + n0 + lc : pr.y, in ? by : 0);
  };
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (chunks > 0) load(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage c has landed
    __syncthreads();
    const int st = c & 1;
#pragma unroll
    for (int kk = 0; kk < kRedK; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[st][kk][ty * 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&ys[st][kk][tx * 4]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w}, ya[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
    }
    __syncthreads();  // before the next copies overwrite this stage
  }
  cp_async_wait<0>();
  float* const o = partial + static_cast<size_t>(split) * plan.wc + pr.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= pr.M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < pr.N) o[m * pr.N + n] = acc[i][j];
    }
  }
}

// out[at(r)] for r < wc + q: the sum of the partial rows (splits of them, wc
// floats each) for r < wc, of the blocks' compact rows (blocks of them, q
// floats each) at r - wc past it, in a fixed order (sum_chains_kernel's:
// lane l of warp w sums rows w, w + kSumWarps, ... of element r0 + l, then
// lane l of warp 0 adds the warps' partials in warp order). at(r) is r
// (map 0) or its index in the gradient vector (map 1, site_grad_index).
__global__ void __launch_bounds__(kSumRows * kSumWarps) site_reduce_sum_kernel(
    const float* __restrict__ partial, int splits, int wc, const float* __restrict__ small,
    int blocks, int q, Dims d, int map, float* __restrict__ out) {
  __shared__ float part[kSumWarps][kSumRows];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kSumRows + l;
  float acc = 0.f;
  if (r < wc) {
    for (int n = w; n < splits; n += kSumWarps) acc += partial[static_cast<size_t>(n) * wc + r];
  } else if (r < wc + q) {
    for (int n = w; n < blocks; n += kSumWarps)
      acc += small[static_cast<size_t>(n) * q + (r - wc)];
  }
  part[w][l] = acc;
  __syncthreads();
  if (w == 0 && r < wc + q) {
    float s = 0.f;
    for (int k = 0; k < kSumWarps; ++k) s += part[k][l];
    out[map ? site_grad_index(r, d) : r] = s;
  }
}

// The twelve products of the factor scratch fac (K rows a net, the first
// Kused summed) into `splits` partial rows at partial.
static int launch_site_reduce(const float* fac, Dims d, size_t K, int Kused, int splits,
                              float* partial, cudaStream_t stream) {
  const ReducePlan plan = reduce_plan(fac, d, K, Kused, splits);
  site_reduce_kernel<<<plan.first_tile[kRedProducts] * splits, kRedThreads, 0, stream>>>(
      plan, partial);
  return static_cast<int>(cudaGetLastError());
}

static int launch_site_reduce_sum(const float* partial, int splits, const float* small,
                                  int blocks, Dims d, int map, float* out,
                                  cudaStream_t stream) {
  const int wc = 2 * reduce_net_floats(d), q = small == nullptr ? 0 : small_row_floats(d);
  site_reduce_sum_kernel<<<(wc + q + kSumRows - 1) / kSumRows, kSumRows * kSumWarps, 0,
                           stream>>>(partial, splits, wc, small, blocks, q, d, map, out);
  return static_cast<int>(cudaGetLastError());
}

// -- the VJP on sites ----------------------------------------------------------

constexpr size_t kSiteFactorCap = size_t(1) << 30;  // floats of factors a part

// A site VJP launch at these widths and N chains: its blocks, run in parts
// of part_blocks blocks (all but the last) whose factors stay within
// kSiteFactorCap floats, K factor rows a net in a part, the reduction's
// splits a part, and its scratch's regions in floats, each a multiple of 4:
// the blocks' compact rows (rows), and for a part its blocks' boundary
// states (bnd), intermediates past kSiteVjpSmemDim (arr) and factors (fac),
// and the partial sums of every part (partial).
struct SiteBwdPlan {
  int blocks, parts, part_blocks, K, splits;
  size_t rows, bnd, arr, fac, partial;
};

inline size_t pad4z(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

inline SiteBwdPlan site_bwd_plan(Dims d, int N) {
  constexpr int C = kSiteChains;
  SiteBwdPlan p;
  p.blocks = (N + C - 1) / C;
  const size_t block_fac = 2 * static_cast<size_t>(d.T) * 2 * C * factor_row_floats(d);
  const size_t parts = (block_fac * p.blocks + kSiteFactorCap - 1) / kSiteFactorCap;
  p.parts = parts > 1 ? static_cast<int>(parts) : 1;
  p.part_blocks = (p.blocks + p.parts - 1) / p.parts;
  p.parts = (p.blocks + p.part_blocks - 1) / p.part_blocks;
  p.K = p.part_blocks * d.T * 2 * C;
  p.splits = reduce_splits(d, p.K);
  p.rows = pad4z(static_cast<size_t>(p.blocks) * small_row_floats(d));
  p.bnd = pad4z(static_cast<size_t>(p.part_blocks) * d.T * 2 * C * d.D);
  p.arr = site_vjp_arrays_in_smem(d.D)
              ? 0
              : pad4z(static_cast<size_t>(p.part_blocks) * kSiteVjpArrays * C * d.D);
  p.fac = block_fac * p.part_blocks;
  p.partial = static_cast<size_t>(p.splits) * p.parts * 2 * reduce_net_floats(d);
  return p;
}

// The VJP on sites, on a part of the launch's blocks (the global block
// block0 + blockIdx.x). rows: (blocks, small_row_floats) compact rows of
// the whole launch; bnd: (part blocks, T, 2, C, D); arr: (part blocks, 10,
// C, D) past kSiteVjpSmemDim (else unused); fac: the part's factors, K rows
// a net (site_substep_vjp).
//
// Two blocks an SM: a thread is capped at 128 registers, where ptxas spills
// 164-592 bytes (it takes 195-255 uncapped). That wins where a launch has
// more blocks than SMs (1024 chains of the 16 x 16 lattice: 256 blocks, one
// wave); at 64 or 128 blocks each block has an SM to itself either way and
// the cap only costs. A second build of every site instantiation with one
// block an SM, picked by the launch's blocks, would take that back (PERF.md
// gives both forms' times), but the 15 site instantiations took the build
// from ~120 to ~230 s beside chip_smoke's first phases, so there is one form.
template <class En, int HM>
__global__ void __launch_bounds__(kSiteThreads, 2) site_traj_bwd_kernel(
    const float* __restrict__ params, Dims d, int reverse, int hmc,
    const float* __restrict__ xin, const float* __restrict__ vin,
    const float* __restrict__ dXin, const float* __restrict__ dVin,
    const float* __restrict__ dld, float* __restrict__ dxo,
    float* __restrict__ dvo, float* __restrict__ rows, float* __restrict__ bnd,
    float* arr, float* __restrict__ fac, int K, int block0, int N) {
  constexpr int C = kSiteChains;
  extern __shared__ float smem[];
  const Block B = block_at(params, d);
  const size_t sN = static_cast<size_t>(N);
  const int Q = small_row_floats(d), CD = C * d.D;
  const int bl = blockIdx.x, gb = block0 + bl;
  const SiteVjpSmem<HM> s = site_vjp_smem<HM>(
      smem, arr + static_cast<size_t>(bl) * kSiteVjpArrays * CD, d.D);
  float* const row = rows + static_cast<size_t>(gb) * Q;
  float* const bn = bnd + static_cast<size_t>(bl) * d.T * 2 * CD;
  int n[C];
  bool live[C], rev[C];
  float ld[C], dl[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int chain = gb * C + c;
    live[c] = chain < N;
    n[c] = live[c] ? chain : N - 1;  // past N: a copy of the last chain
    rev[c] = reverse != 0;
    ld[c] = 0.f;
    dl[c] = live[c] ? dld[n[c]] : 0.f;  // zero cotangents: exact zeros
  }
  for (int p = threadIdx.x; p < Q; p += kSiteThreads) row[p] = 0.f;
  for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
    const int c = p % C, i = p / C, o = c * d.D + i;
    s.x[o] = xin[i * sN + n[c]];
    s.v[o] = vin[i * sN + n[c]];
    s.dx[o] = live[c] ? dXin[i * sN + n[c]] : 0.f;
    s.dv[o] = live[c] ? dVin[i * sN + n[c]] : 0.f;
  }
  __syncthreads();

  // the forward sweep: each substep's input to the boundary scratch (of
  // the chain kernel's SiteSmem block sums, only the prelude's, in s.sc)
  const SiteSmem<HM> f{s.x, s.v, s.g1, s.red, s.h, s.h2, s.sc.sred, s.sc.tot, s.sc.pre};
  site_grad<En>(B, d, s.x, s.g1, s.sc);
  for (int t = 0; t < d.T; ++t) {
    float* const bk = bn + static_cast<size_t>(2 * t) * CD;
    for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
      bk[p] = s.x[p];
      bk[CD + p] = s.v[p];
    }
    __syncthreads();
    int step[C];
#pragma unroll
    for (int c = 0; c < C; ++c) step[c] = reverse ? d.T - 1 - t : t;
    site_traj_step<En, HM, float>(B, d, hmc != 0, rev, step, f, ld);
  }

  // the reverse sweep; substep t's factors at rows ((bl T + t) 2 + a) C + c
  for (int t = d.T - 1; t >= 0; --t) {
    const float* const bk = bn + static_cast<size_t>(2 * t) * CD;
    for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
      s.x[p] = bk[p];
      s.v[p] = bk[CD + p];
    }
    __syncthreads();
    site_substep_vjp<En, HM>(B, d, hmc != 0, reverse != 0, reverse ? d.T - 1 - t : t, s,
                             dl, row, fac, static_cast<size_t>(K),
                             (static_cast<size_t>(bl) * d.T + t) * 2 * C);
  }
  for (int p = threadIdx.x; p < CD; p += kSiteThreads) {
    const int c = p % C, i = p / C;
    if (live[c]) {
      dxo[i * sN + n[c]] = s.dx[c * d.D + i];
      dvo[i * sN + n[c]] = s.dv[c * d.D + i];
    }
  }
}

// Each part's VJP then its products, in part order; then the fixed-order
// sum of the partial rows and the compact rows into grads. In HMC mode no
// factors are written and the weights' sums are over no rows: zeros.
template <class En, int HM>
static int launch_site_traj_bwd(const float* params, Dims d, int reverse, int hmc,
                                const float* x, const float* v, const float* dX,
                                const float* dV, const float* dld, float* dx,
                                float* dv, float* grads, float* scratch, int N,
                                cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(site_vjp_smem_floats(d.D, HM, site_pre_floats(d, En::kKind))) *
      sizeof(float);
  cudaError_t e = allow_smem(site_traj_bwd_kernel<En, HM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const SiteBwdPlan p = site_bwd_plan(d, N);
  float* const rows = scratch;
  float* const bnd = rows + p.rows;
  float* const arr = bnd + p.bnd;
  float* const fac = arr + p.arr;
  float* const partial = fac + p.fac;
  const size_t wc = 2 * static_cast<size_t>(reduce_net_floats(d));
  for (int q = 0; q < p.parts; ++q) {
    const int b0 = q * p.part_blocks;
    const int nb = p.blocks - b0 < p.part_blocks ? p.blocks - b0 : p.part_blocks;
    site_traj_bwd_kernel<En, HM><<<nb, kSiteThreads, smem, stream>>>(
        params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, rows, bnd, arr, fac, p.K, b0, N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!hmc) {
      const int err = launch_site_reduce(fac, d, p.K, nb * d.T * 2 * kSiteChains, p.splits,
                                         partial + q * p.splits * wc, stream);
      if (err != 0) return err;
    }
  }
  return launch_site_reduce_sum(partial, hmc ? 0 : p.parts * p.splits, rows, p.blocks, d, 1,
                                grads, stream);
}

template <class C, class En>
static int launch_trajectory_bwd(
    const float* params, Dims d, int reverse, int hmc, const float* x,
    const float* v, const float* dX, const float* dV, const float* dld,
    float* dx, float* dv, float* grads, float* scratch, int N,
    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_floats(d)) * sizeof(float);
  cudaError_t e = allow_smem(trajectory_bwd_kernel<C, En>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int P = 2 * net_floats(d) + d.D;
  float* G = scratch;
  float* bnd = scratch + static_cast<size_t>(P) * N;
  const long long lanes = static_cast<long long>(N) * C::L;
  const int blocks = static_cast<int>((lanes + kLaneThreads - 1) / kLaneThreads);
  trajectory_bwd_kernel<C, En><<<blocks, kLaneThreads, smem, stream>>>(
      params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, G, bnd, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_chains_kernel<<<(P + kSumRows - 1) / kSumRows, kSumRows * kSumWarps, 0,
                      stream>>>(G, N, P, grads);
  return static_cast<int>(cudaGetLastError());
}

// The specs whose site kernels this translation unit instantiates: Gauss
// and Phi4 here, RoughWell, Gmm and Funnel in trajectory_bwd_specs.cu
// (L2HMC_BWD_SPECS_UNIT). Each site instantiation took nvcc ~20 s, and ten
// in one source (five specs, two widths) made it the build's longest by
// ~150 s; in two sources they build beside each other. The kernels are the
// same templates either way; the host picks the library by the spec.
template <class En>
constexpr bool kUnitSite =
#ifdef L2HMC_BWD_SPECS_UNIT
    !(std::is_same_v<En, Gauss> || std::is_same_v<En, Phi4>);
#else
    std::is_same_v<En, Gauss> || std::is_same_v<En, Phi4>;
#endif

// The VJP on sites for this unit's specs; cudaErrorInvalidValue for another.
static int trajectory_bwd_sites(const float* params, Dims d, int kind, int reverse, int hmc,
                                const float* x, const float* v, const float* dX,
                                const float* dV, const float* dld, float* dx, float* dv,
                                float* grads, float* scratch, int N, cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (d.D > kSiteVjpMaxDim) return bad;
  return with_energy(d, kind, [&](auto e) {
    using En = decltype(e);
    if constexpr (!kUnitSite<En>) {
      return bad;
    } else {
      if (site_hm(d) == WideLanes::HM)
        return launch_site_traj_bwd<En, WideLanes::HM>(params, d, reverse, hmc, x, v, dX, dV,
                                                       dld, dx, dv, grads, scratch, N, s);
      return launch_site_traj_bwd<En, kSiteMaxHidden>(params, d, reverse, hmc, x, v, dX, dV,
                                                      dld, dx, dv, grads, scratch, N, s);
    }
  });
}

}  // namespace l2hmc

#ifndef L2HMC_BWD_SPECS_UNIT
// Plain C entry point (loaded with ctypes). Pointers are device pointers to
// float32: params (the packed block, with nc floats of the energy spec's
// constants; kind as in l2hmc_trajectory); x, v, dX, dV, dx, dv as (D, N); dld as
// (N,); grads as (P,) with P = 2 * net_floats + D, in the order xnet's 13
// arrays | vnet's 13 arrays | eps; scratch of P * N + 2 * (T + 1) * D * N
// floats on the lane groups, and past 64 wide, on the sites, of
// l2hmc_trajectory_bwd_site_plan's rows + bnd + arr + fac + partial (the
// blocks' compact rows; a part's boundary states, intermediates past
// D = 1024 and factors; the reduction's partial sums). On sites it takes the
// Gauss and Phi4 specs; l2hmc_trajectory_bwd_specs (trajectory_bwd_specs.cu)
// the others. Returns a cudaError_t as int; 0 means every launch was
// accepted.
extern "C" int l2hmc_trajectory_bwd(const float* params, int D, int H, int H2,
                                    int T, int kind, int nc, int reverse,
                                    int hmc, const float* x, const float* v,
                                    const float* dX, const float* dV,
                                    const float* dld, float* dx, float* dv,
                                    float* grads, float* scratch, int N,
                                    void* stream) {
  using namespace l2hmc;
  const Dims d{D, H, H2, T, nc};
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pick_lanes(d) == 3)
    return trajectory_bwd_sites(params, d, kind, reverse, hmc, x, v, dX, dV, dld, dx, dv,
                                grads, scratch, N, s);
  return dispatch<ScgLanes>(d, kind, [&](auto c, auto e) {
    return launch_trajectory_bwd<decltype(c), decltype(e)>(
        params, d, reverse, hmc, x, v, dX, dV, dld, dx, dv, grads, scratch, N,
        s);
  });
}

// The site-parallel form's geometry at these widths, as
// l2hmc_trajectory_bwd launches it: chains a block, threads a block, bytes
// of dynamic shared memory a block (on the energy spec kind with nc floats
// of constants; the intermediates' (10, C, D) global scratch past D = 1024
// not counted); 0 where the widths are not past 64 or past its caps.
static bool bwd_on_sites(int D, int H, int H2) {
  using namespace l2hmc;
  return pick_lanes(Dims{D, H, H2, 1}) == 3 && D <= kSiteVjpMaxDim;
}
extern "C" int l2hmc_trajectory_bwd_site_chains(int D, int H, int H2) {
  return bwd_on_sites(D, H, H2) ? l2hmc::kSiteChains : 0;
}
extern "C" int l2hmc_trajectory_bwd_site_threads(int D, int H, int H2) {
  return bwd_on_sites(D, H, H2) ? l2hmc::kSiteThreads : 0;
}
extern "C" int l2hmc_trajectory_bwd_site_smem_bytes(int D, int H, int H2, int kind, int nc) {
  using namespace l2hmc;
  if (!bwd_on_sites(D, H, H2)) return 0;
  const Dims d{D, H, H2, 1, nc};
  return site_vjp_smem_floats(D, site_hm(d), site_pre_floats(d, kind)) *
         static_cast<int>(sizeof(float));
}

// The site VJP's plan at these widths, T and N chains (SiteBwdPlan), into
// out[10]: blocks, parts, blocks a part, factor rows a net in a part, the
// reduction's splits a part, then the scratch's regions in floats: rows,
// bnd, arr, fac, partial. Returns 0, or 1 (out untouched) where the widths
// are not on sites or past the caps.
extern "C" int l2hmc_trajectory_bwd_site_plan(int D, int H, int H2, int T, int N,
                                              long long* out) {
  using namespace l2hmc;
  if (!bwd_on_sites(D, H, H2) || N <= 0) return 1;
  const SiteBwdPlan p = site_bwd_plan(Dims{D, H, H2, T, 0}, N);
  const long long v[10] = {p.blocks, p.parts, p.part_blocks, p.K, p.splits,
                           static_cast<long long>(p.rows), static_cast<long long>(p.bnd),
                           static_cast<long long>(p.arr), static_cast<long long>(p.fac),
                           static_cast<long long>(p.partial)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The reduction alone (site_reduce_kernel, then site_reduce_sum_kernel over
// its partial rows): factors as the site VJP lays out a part of K rows a net
// (factor_row, l2hmc_sites.cuh; 16-byte aligned), out the twelve products'
// 2 reduce_net_floats floats (per net w1 | w2 | wh | ws | wt | wq),
// partial reduce_splits(d, K) times that. Returns a cudaError_t as int.
extern "C" int l2hmc_site_reduce(const float* fac, int D, int H, int H2, int K, float* out,
                                 float* partial, void* stream) {
  using namespace l2hmc;
  const Dims d{D, H, H2, 1, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = reduce_splits(d, K);
  if (K > 0) {
    const int e = launch_site_reduce(fac, d, K, K, splits, partial, s);
    if (e != 0) return e;
  }
  return launch_site_reduce_sum(partial, K > 0 ? splits : 0, nullptr, 0, d, 0, out, s);
}
#endif
