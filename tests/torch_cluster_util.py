"""A plain emulation, on the CPU, of the chain kernel's cluster form
(``csrc/l2hmc_site_cluster.cuh``): the D sites of a tile split into G
contiguous ranges (``fd._cl_chunk``: whole lattice rows for phi^4, an even
count otherwise), each range's first-layer partial sums, prelude sums and
Hamiltonian sums taken apart and added in rank order, the phi^4 stencil on a
range with one halo row from each neighbouring range (periodic at the ends),
the funnel's v = x_0 from rank 0, and a chain's direction picked by its draw
(only the chosen trajectory runs). It runs whole (D, N) states at once: a
tile's chains are independent, so its partition of the chains changes no
number here, and chains past N in a partial tile would only repeat the last.
The tests hold it against ``fd.chain_plain`` and the JAX chain kernel."""

import torch

from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops.philox import chain_draws


def ranges(D: int, G: int, kind: int) -> list[tuple[int, int]]:
    """The ranks' site ranges [lo, hi) for a cluster of (at most) G CTAs:
    the kernel's chunk, and only the ranks that hold sites."""
    chunk = fd._cl_chunk(D, G, fd._cl_unit(D, kind))
    return [(lo, min(lo + chunk, D)) for lo in range(0, D, chunk)]


def rank_sum(parts):
    """The ranks' partials added in rank order, as every CTA adds them."""
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


class _Spec:
    """The energy spec's gradient and energy on the ranges: per-site terms
    on each rank's sites, the sums over sites taken a rank at a time."""

    def __init__(self, inp: fd.KernelInputs, rg):
        self.inp, self.rg, self.kind = inp, rg, inp.kind
        self.c = inp.consts[0].reshape(-1) if inp.consts else None

    def _phi4_ext(self, locs, r):
        """Rank r's rows with the row above from rank r - 1 and the row below
        from rank r + 1 (periodic): the halo the stencil reads."""
        L = int(self.c[2])
        G = len(locs)
        return torch.cat([locs[(r - 1) % G][-L:], locs[r], locs[(r + 1) % G][:L]])

    def _phi4_nbrs(self, ext, lo, n):
        L = int(self.c[2])
        i = torch.arange(n)
        col = (lo + i) % L
        e = L + i
        right = torch.where((col == L - 1)[:, None], ext[e - (L - 1)], ext[e + 1])
        left = torch.where((col == 0)[:, None], ext[e + L - 1], ext[e - 1])
        return right, left, ext[e + L], ext[e - L]

    def _funnel_pre(self, x):
        parts = [torch.sum(torch.square(x[max(lo, 1):hi]), dim=0, keepdim=True)
                 for lo, hi in self.rg]
        return rank_sum(parts), x[0:1]  # the neck's sum; v = x_0, rank 0's first site

    def grad(self, x):
        k, c = self.kind, self.c
        if k == fd.Phi4Energy.KIND:
            locs = [x[lo:hi] for lo, hi in self.rg]
            out = []
            for r, (lo, hi) in enumerate(self.rg):
                xi = locs[r]
                right, left, down, up = self._phi4_nbrs(self._phi4_ext(locs, r), lo, hi - lo)
                lap = 4.0 * xi - right - left - down - up
                out.append(lap + c[0] * xi + (4.0 * c[1]) * xi * xi * xi)
            return torch.cat(out)
        if k == fd.FunnelEnergy.KIND:
            S, v = self._funnel_pre(x)
            inv_s = torch.exp(-torch.clamp(v, -c[1], c[1]))
            inside = ((v > -c[1]) & (v < c[1])).to(x.dtype)
            g = [x[lo:hi] * inv_s for lo, hi in self.rg]
            g[0] = torch.cat([v * c[0] + 0.5 * inside * (c[2] - S * inv_s), g[0][1:]])
            return torch.cat(g)
        if k == fd.RoughWellEnergy.KIND:
            return torch.cat([x[lo:hi] - c[2] * torch.sin(x[lo:hi] * c[1]) for lo, hi in self.rg])
        return self.inp.grad_energy(x)  # Gauss, Gmm: the whole state (G = 1)

    def energy(self, x):
        k, c = self.kind, self.c
        if k == fd.Phi4Energy.KIND:
            locs = [x[lo:hi] for lo, hi in self.rg]
            parts = []
            for r, (lo, hi) in enumerate(self.rg):
                xi = locs[r]
                right, _, down, _ = self._phi4_nbrs(self._phi4_ext(locs, r), lo, hi - lo)
                x2 = xi * xi
                e = 0.5 * ((right - xi) ** 2 + (down - xi) ** 2) + ((0.5 * c[0]) * x2 + c[1] * x2 * x2)
                parts.append(torch.sum(e, dim=0, keepdim=True))
            return rank_sum(parts)
        if k == fd.FunnelEnergy.KIND:
            S, v = self._funnel_pre(x)
            w = torch.clamp(v, -c[1], c[1])
            return 0.5 * (v * v * c[0] + S * torch.exp(-w) + c[2] * (1.8378770664093453 + w))
        if k == fd.RoughWellEnergy.KIND:
            return rank_sum([torch.sum(0.5 * x[lo:hi] ** 2 + c[0] * torch.cos(x[lo:hi] * c[1]),
                                       dim=0, keepdim=True) for lo, hi in self.rg])
        return self.inp.energy(x)


def _nets(inp, w, a, b, step, rg):
    """S, T, Q of net w at (a, b), chain n at its own step[n]: the first
    layer's partial sums a range at a time, added in rank order."""
    if inp.hmc:
        z = torch.zeros_like(a)
        return z, z, z
    w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te = w
    parts = [w1[lo:hi].T @ a[lo:hi] + w2[lo:hi].T @ b[lo:hi] for lo, hi in rg]
    h = torch.relu(rank_sum(parts) + te[:, step])
    h2 = torch.relu(wh.T @ h + bh)
    s = torch.cat([torch.exp(ls[lo:hi]) * torch.tanh(ws[:, lo:hi].T @ h2 + bs[lo:hi])
                   for lo, hi in rg])
    t = torch.cat([wt[:, lo:hi].T @ h2 + bt[lo:hi] for lo, hi in rg])
    q = torch.cat([torch.exp(lq[lo:hi]) * torch.tanh(wq[:, lo:hi].T @ h2 + bq[lo:hi])
                   for lo, hi in rg])
    return s, t, q


def _substep(inp, spec, rg, rev, t, x, v, g, ld):
    """One substep, the kernel's four applications and gradient (cl_heads'
    expressions), each chain in its own direction."""
    T = inp.dims[3]
    step = torch.where(rev, T - 1 - t, t)
    e = inp.eps
    h = 0.5 * e
    m = inp.masks[:, step]
    mb = 1.0 - m

    def vnet(app, v, g, x):
        s, tv, q = _nets(inp, inp.vnet_w, x, g, step, rg)
        Q = torch.exp(e * q)
        inc = torch.where(rev, -h * s, h * s)
        vn = torch.where(rev, (v - h * (-Q * g + tv)) * torch.exp(inc),
                         v * torch.exp(inc) + h * (-Q * g + tv))
        return vn, inc

    def xnet(app, v, gn, x):
        s, tv, q = _nets(inp, inp.xnet_w, v, gn, step, rg)
        Q = torch.exp(e * q)
        keep = torch.where(rev == (app == 3), m, mb)  # app 2: m forward; app 3: m reverse
        move = 1.0 - keep
        inc = torch.where(rev, -e * s, e * s)
        xn = torch.where(rev, keep * x + move * torch.exp(inc) * (x - e * (Q * v + tv)),
                         keep * x + move * (x * torch.exp(inc) + e * (Q * v + tv)))
        return xn, move * inc, move * xn

    v, inc = vnet(1, v, g, x)
    ld = ld + inc
    gn = torch.where(rev, mb, m) * x
    x, inc, gn = xnet(2, v, gn, x)
    ld = ld + inc
    x, inc, _ = xnet(3, v, gn, x)
    ld = ld + inc
    g = spec.grad(x)
    v, inc = vnet(4, v, g, x)
    return x, v, g, ld + inc


def cluster_chain(inp: fd.KernelInputs, x, seed: int, n_mh_steps: int, G: int,
                  collect_trace: bool = False, draws=None):
    """The emulation of the cluster chain kernel at G CTAs a cluster on
    (D, N) state: (x (D, N), acceptance (1, N), trace (K, D, N) or None),
    on ``fd.chain_plain``'s draws."""
    D, N = x.shape
    T = inp.dims[3]
    rg = ranges(D, G, inp.kind)
    spec = _Spec(inp, rg)
    if draws is None:
        def draws(step):
            return chain_draws(seed, N, D, step, x.device)

    def hamiltonian(x, v):
        kin = rank_sum([torch.sum(v[lo:hi] * v[lo:hi], dim=0, keepdim=True) for lo, hi in rg])
        return spec.energy(x) + 0.5 * kin

    accepted = torch.zeros_like(x[:1])
    trace = torch.empty((n_mh_steps, D, N), dtype=x.dtype) if collect_trace else None
    for k in range(n_mh_steps):
        v, u_dir, u_acc = draws(k)
        rev = ~(u_dir < 0.5)
        h0 = hamiltonian(x, v)
        xp, ld = x, torch.zeros_like(x)
        g = spec.grad(xp)
        for t in range(T):
            xp, v, g, ld = _substep(inp, spec, rg, rev, t, xp, v, g, ld)
        a = h0 - hamiltonian(xp, v) + rank_sum([torch.sum(ld[lo:hi], dim=0, keepdim=True)
                                               for lo, hi in rg])
        px = torch.exp(torch.clamp(a, max=0.0))
        px = torch.where(torch.isfinite(px), px, torch.zeros_like(px))
        acc = px - u_acc[None, :] >= 0.0
        x = torch.where(acc, xp, x)
        accepted = accepted + acc.to(x.dtype)
        if trace is not None:
            trace[k] = x
    return x, accepted * (1.0 / n_mh_steps), trace
