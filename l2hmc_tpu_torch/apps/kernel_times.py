"""Times the port's CUDA kernels at their protocol shapes, and compares
source trees on one card.

    python -P l2hmc_tpu_torch/apps/kernel_times.py
    python -P l2hmc_tpu_torch/apps/kernel_times.py --trees PARENT CHANGE [...] [--sites]

Alone, it times the ``l2hmc_tpu_torch`` package that Python imports and
prints one JSON line: the SCG trajectory and backward kernels' launches
through their C entry points, the SCG chain kernel (1024 chains x 2000
traced steps and 8192 x 500 untraced, each in L2HMC and in HMC mode at eps
0.15), the fused SCG training step (1024 chains), the VAE training
kernels at the training batch (512 chains), the AIS kernel (1000 chains x
100 anneal steps x 10 leapfrogs) and the VAE sampler (200 chains x 200
recorded steps of 1-3 ops), all at the reference widths with seeded
weights, each VAE kernel also with bfloat16 operands (rows 4b-7b, keys
ending ``_bf16``; null for a tree without them); and the chain kernel's site-parallel configuration at its rows'
shapes (3e-3g: the phi^4 lattice at L = 8, 16, 32, 1000 traced steps; 3h:
L = 64 at the A_control shape and at the shipped recipe's, 1000 traced
steps; 3i: icg at hidden 100, 2000 traced steps; a tree whose caps refuse
a row gives null); the trajectory and chain kernels with bfloat16 operands
at rows 1, 3, 3f and 3h's shapes (keys ending ``_bf16``; null for a tree
without them); the trajectory and backward kernels past 64 wide, on sites,
through their wrappers (rows 1f/2f: the lattice at L = 16, 1024 chains;
1g/2g: L = 32, 256; 1h/2h: icg at hidden 100, 2048; 1i: L = 64 at the
A_control shape, 256; 1f_bf16; null where a tree's caps refuse them), rows
1j-3l on sites (the rough well and the funnel at D = 100, the ring at hidden
100; null for a tree that refuses them) and the fused training step at L = 16
(1024 chains, hidden 32, T = 10); kernel
times by CUDA events, the training steps by the host clock.

With ``--trees``, each directory must hold an ``l2hmc_tpu_torch`` package
(a checkout, or an unpacked ``git archive``). Every tree's kernels are built
first, at once; then each tree is timed in a process of its own with that
tree's package, in the order given and then reversed (A B C C B A), so that
a drift of the card over the call falls on every tree alike. Prints each
run's line and a summary of every tree's times. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _cuda_ms(fn, reps, warmup=True):
    """Mean ms of ``fn()`` over ``reps`` runs by CUDA events, after one
    warm-up run (without it where ``fn``'s kernel has run before)."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _gen(seed):
    import torch

    return torch.Generator().manual_seed(seed)


def _has_bf16_scg() -> bool:
    """Whether the timed tree has the trajectory and chain kernels'
    bfloat16 instantiations."""
    from l2hmc_tpu_torch.ops import _cuda

    return "chain_bf16" in _cuda.SIGNATURES


def scg_times(dev) -> dict:
    import dataclasses

    import torch

    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, train

    cfg = ScgConfig(n_chains=1024)
    dyn, target = build_dynamics(cfg)
    params = dyn.init_params(_gen(0), eps=cfg.eps, device=dev)
    inp = fd.prepare(dyn, fd.energy_spec_for_target(target), params, dev)
    D, H, H2, T = inp.dims
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for n in (1024, 2048, 8192):
        x = target.sample(_gen(1), n, device=dev).T.contiguous()
        v = torch.randn(x.shape, generator=_gen(2)).to(dev)
        block = inp.block()
        xo, vo = torch.empty_like(x), torch.empty_like(v)
        ld = torch.empty((1, n), dtype=torch.float32, device=dev)
        lib = _cuda.library("trajectory")
        out[f"trajectory_launch_{n}"] = _cuda_ms(lambda: _cuda.check(lib.l2hmc_trajectory(
            block.data_ptr(), D, H, H2, T, *inp.energy_args, 0, 0, x.data_ptr(), v.data_ptr(),
            xo.data_ptr(), vo.data_ptr(), ld.data_ptr(), n, stream), "trajectory"), 200)
        if n == 2048:
            blib = _cuda.library("trajectory_bf16") if _has_bf16_scg() else None
            bblock = dataclasses.replace(inp, cd=torch.bfloat16).block()
            out["trajectory_launch_2048_bf16"] = None if blib is None else _cuda_ms(
                lambda: _cuda.check(blib.l2hmc_trajectory_bf16(
                    bblock.data_ptr(), D, H, H2, T, *inp.energy_args, 0, 0, x.data_ptr(),
                    v.data_ptr(), xo.data_ptr(), vo.data_ptr(), ld.data_ptr(), n, stream),
                    "trajectory_bf16"), 200)
        if n == 1024:
            dX, dV = (torch.randn(x.shape, generator=_gen(3 + i)).to(dev) for i in range(2))
            dld = torch.ones((1, n), device=dev)
            n_grads = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
            grads = torch.empty(n_grads, dtype=torch.float32, device=dev)
            scratch = torch.empty(n_grads * n + 2 * (T + 1) * D * n, dtype=torch.float32,
                                  device=dev)
            blib = _cuda.library("trajectory_bwd")
            out["trajectory_bwd_launch_1024"] = _cuda_ms(
                lambda: _cuda.check(blib.l2hmc_trajectory_bwd(
                    block.data_ptr(), D, H, H2, T, *inp.energy_args, 0, 0, x.data_ptr(),
                    v.data_ptr(), dX.data_ptr(), dV.data_ptr(), dld.data_ptr(), xo.data_ptr(),
                    vo.data_ptr(), grads.data_ptr(), scratch.data_ptr(), n, stream),
                    "trajectory_bwd"), 200)
    hmc_dyn, _ = build_dynamics(ScgConfig(hmc=True), target)
    inp_hmc = fd.prepare(hmc_dyn, fd.energy_spec_for_target(target),
                         hmc_dyn.init_params(_gen(0), eps=0.15, device=dev), dev)
    x0 = target.sample(_gen(4), 1024, device=dev).T.contiguous()
    x1 = target.sample(_gen(5), 8192, device=dev).T.contiguous()
    out["chain_1024x2000"] = _cuda_ms(lambda: fd.chain(inp, x0, 2, 2000, True), 3)
    inp_bf = dataclasses.replace(inp, cd=torch.bfloat16)
    out["chain_1024x2000_bf16"] = (_cuda_ms(lambda: fd.chain(inp_bf, x0, 2, 2000, True), 3)
                                   if _has_bf16_scg() else None)
    out["chain_hmc_1024x2000"] = _cuda_ms(lambda: fd.chain(inp_hmc, x0, 3, 2000, True), 3)
    out["chain_8192x500"] = _cuda_ms(lambda: fd.chain(inp, x1, 2, 500, False), 3)
    out["chain_hmc_8192x500"] = _cuda_ms(lambda: fd.chain(inp_hmc, x1, 3, 500, False), 3)
    steps = 300
    train(ScgConfig(n_chains=1024, n_steps=20, seed=0, fused_train=True), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    train(ScgConfig(n_chains=1024, n_steps=steps, seed=0, fused_train=True), device=dev)
    torch.cuda.synchronize()
    out["fused_scg_step"] = 1e3 * (time.perf_counter() - t) / steps
    return out


def vae_times(dev) -> dict:
    import numpy as np
    import torch

    from l2hmc_tpu_torch.apps import eval_sampler, eval_vae, vae
    from l2hmc_tpu_torch.ops import fused_vae as fv

    model = vae.VaeModel.build(vae.VaeConfig())
    params = model.init_params(_gen(0), device=dev)
    dyn = model.dynamics
    D = dyn.dim

    def batch(n, cd):
        rng = np.random.default_rng(n)
        x = torch.as_tensor((rng.random((n, 784)) < 0.3).astype(np.float32), device=dev)
        with torch.no_grad():
            emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x)
        xr = x.T.contiguous()
        g = _gen(n)
        z, v, dZ, dV = (torch.randn((D, n), generator=g).to(dev) for _ in range(4))
        dld = torch.randn((1, n), generator=g).to(dev)
        kw = {} if cd is None else {"compute_dtype": cd}
        inp = fv.prepare_vae(dyn, params["smp"], params["dec"], xr, emb.T.contiguous(), **kw)
        return inp, xr, z, v, dZ, dV, dld

    out = {}
    acfg = eval_vae.EvalVaeConfig()
    scfg = eval_sampler.EvalSamplerConfig()
    dec = fv.decoder_arrays(params["dec"])
    nb = fv.composition_counts(_gen(1), 200, scfg.max_composition)
    out["vae_chain_200x200_ops"] = int(nb.sum())
    for cd, suffix in ((None, ""), ("bfloat16", "_bf16")):
        keys = [f"{k}{suffix}" for k in ("vae_traj_512", "vae_traj_bwd_512", "vae_ais_1000",
                                         "vae_chain_200x200")]
        akw = {} if cd is None else {"compute_dtype": cd}
        try:
            with torch.no_grad():
                inp, xr, z, v, dZ, dV, dld = batch(512, cd)
                out[keys[0]] = _cuda_ms(lambda: fv.vae_trajectory(inp, xr, z, v, False), 20)
                out[keys[1]] = _cuda_ms(
                    lambda: fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld, False), 20)
                _, xa, za, *_ = batch(acfg.chains_per_datapoint * acfg.num_splits, cd)
                out[keys[2]] = _cuda_ms(
                    lambda: fv.vae_ais(dec, xa, za, seed=3, anneal_steps=acfg.anneal_steps,
                                       step_size=acfg.step_size, leapfrogs=acfg.leapfrogs,
                                       **akw), 2)
                inp, xr, z, *_ = batch(scfg.n_chains, cd)
                out[keys[3]] = _cuda_ms(
                    lambda: fv.vae_chain(inp, xr, z, seed=13, n_mh_steps=200,
                                         collect_trace=True, nb=nb), 1)
        except (TypeError, NotImplementedError):  # a tree without bfloat16 operands
            if cd is None:
                raise
            out.update(dict.fromkeys(keys))
    return out


def site_times(dev) -> dict:
    import dataclasses

    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import phi4, suite
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics
    from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten

    def a_control():
        # the JAX package's 64 x 64 A_control shape: hidden 32, T = 10, eps
        # 0.03, 256 chains, the parity cases' lifted weights
        t = targets.Phi4Lattice(L=64)
        dyn, _ = build_dynamics(ScgConfig(dim=t.dim, hidden=32, T=10), t)
        params = dyn.init_params(_gen(0), eps=0.03, device=dev)
        for net in ("xnet", "vnet"):
            params[net] = tree_unflatten(params[net], [a + 0.003 for a in
                                                       tree_leaves(params[net])])
        inp = fd.prepare(dyn, fd.energy_spec_for_target(t), params, dev)
        return inp, t.sample(_gen(1), 256, device=dev).T.contiguous()

    def case(mod, name):
        return lambda: mod.parity_inputs(name, mod.PARITY_CASES[name].n_chains, dev, seed=32)

    out = {}
    for label, make, steps in (("3e", case(phi4, "phi4_L8"), 1000),
                               ("3f", case(phi4, "phi4_L16"), 1000),
                               ("3g", case(phi4, "phi4_L32"), 1000),
                               ("3h", a_control, 1000),
                               ("3h_recipe", case(phi4, "phi4_L64"), 1000),
                               ("3i", case(suite, "icg"), 2000)):
        key = f"chain_{label}"
        try:
            inp, x = make()
            fd.chain(inp, x, 2, 2, True)
        except (KeyError, ValueError):  # a tree without the case, or past its caps
            out[key] = None
            continue
        out[key] = _cuda_ms(lambda: fd.chain(inp, x, 2, steps, True), 1, warmup=False)
        if label in ("3f", "3h"):
            ib = dataclasses.replace(inp, cd=torch.bfloat16)
            out[f"{key}_bf16"] = (_cuda_ms(lambda: fd.chain(ib, x, 2, steps, True), 1)
                                  if _has_bf16_scg() else None)
        del inp, x
        torch.cuda.empty_cache()
    return out


def site_traj_times(dev) -> dict:
    """Rows 1f-1i, 2f-2h and 1f_bf16: each launch through its wrapper, one
    direction, and the fused L = 16 training step at steady state."""
    import dataclasses

    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import phi4, suite
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, train

    out = {}
    for label, mod, name, n in (("f", phi4, "phi4_L16", 1024), ("g", phi4, "phi4_L32", 256),
                                ("h", suite, "icg", 2048), ("i", phi4, "phi4_L64", 256)):
        inp, x = mod.parity_inputs(name, n, dev, seed=32)
        if label == "i":  # A_control's shape: hidden 32, T = 10 (the parity case: 64, 24)
            t = targets.Phi4Lattice(L=64)
            dyn, _ = build_dynamics(ScgConfig(dim=t.dim, hidden=32, T=10), t)
            inp = fd.prepare(dyn, fd.energy_spec_for_target(t),
                             dyn.init_params(_gen(0), eps=0.03, device=dev), dev)
        x = x.contiguous()
        g = _gen(7)
        v, dX, dV = (torch.randn(x.shape, generator=g).to(dev) for _ in range(3))
        dld = torch.ones((1, n), device=dev)
        for key, fn, reps in (
                (f"trajectory_1{label}", lambda: fd.trajectory(inp, x, v, False), 20),
                (f"trajectory_bwd_2{label}",
                 lambda: fd.trajectory_vjp(inp, x, v, dX, dV, dld, False), 5)):
            if label == "i" and "bwd" in key:
                continue
            try:
                out[key] = _cuda_ms(fn, reps)
            except ValueError:  # a tree whose caps refuse the widths
                out[key] = None
        if label == "f":
            ib = dataclasses.replace(inp, cd=torch.bfloat16)
            try:
                out["trajectory_1f_bf16"] = _cuda_ms(lambda: fd.trajectory(ib, x, v, False), 20)
            except ValueError:
                out["trajectory_1f_bf16"] = None
        del inp, x
        torch.cuda.empty_cache()
    t = targets.Phi4Lattice(L=16, m2=-1.0, lam=0.5)
    cfg = ScgConfig(dim=t.dim, n_chains=1024, T=10, hidden=32, seed=0, fused_train=True)
    try:
        times = []
        for steps in (20, 80):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(dataclasses.replace(cfg, n_steps=steps), t, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["fused_phi4_L16_step"] = 1e3 * (times[1] - times[0]) / 60
    except ValueError:
        out["fused_phi4_L16_step"] = None
    return out


def spec_site_times(dev) -> dict:
    """Rows 1j-3l: the rough well at D = 100, the ring at hidden 100 and the
    funnel at D = 100 on sites (``suite.WIDE_CASES`` at their chain
    counts), kernels 1 and 2 through their wrappers, one direction, and the
    chain kernel over 2000 traced steps; null for a tree without the cases
    or whose kernels refuse them."""
    import torch

    from l2hmc_tpu_torch.apps import suite
    from l2hmc_tpu_torch.ops import fused_dynamics as fd

    out = {}
    for label, name in (("j", "rough_well_D100"), ("k", "ring_h100"), ("l", "funnel_D100")):
        keys = (f"trajectory_1{label}", f"trajectory_bwd_2{label}", f"chain_3{label}")
        try:
            inp, x = suite.parity_inputs(name, suite.WIDE_CASES[name].n_chains, dev, seed=32)
            x = x.contiguous()
            n = x.shape[1]
            g = _gen(7)
            v, dX, dV = (torch.randn(x.shape, generator=g).to(dev) for _ in range(3))
            dld = torch.ones((1, n), device=dev)
            for key, fn, reps in (
                    (keys[0], lambda: fd.trajectory(inp, x, v, False), 20),
                    (keys[1], lambda: fd.trajectory_vjp(inp, x, v, dX, dV, dld, False), 5),
                    (keys[2], lambda: fd.chain(inp, x, 2, 2000, True), 1)):
                out[key] = _cuda_ms(fn, reps)
        except (AttributeError, KeyError, ValueError):  # no such case, or refused
            out.update({k: None for k in keys if k not in out})
        torch.cuda.empty_cache()
    return out


def one(sites_only: bool = False) -> dict:
    import torch

    from l2hmc_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    _cuda.wait_build()  # nothing compiles while the kernels are timed
    out = {"package": os.path.dirname(os.path.dirname(os.path.abspath(_cuda.__file__))),
           "build_dir": _cuda.build_info.get("dir")}
    if not sites_only:
        out.update(scg_times(dev))
        out.update(vae_times(dev))
    out.update(site_times(dev))
    out.update(site_traj_times(dev))
    out.update(spec_site_times(dev))
    return out


def compare(trees: list[str], sites_only: bool = False) -> dict:
    """Builds every tree's kernels at once, then times the trees in the
    order given and reversed, each in a process of its own."""
    def run(tree, *args):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        return subprocess.Popen([sys.executable, "-P", os.path.abspath(__file__), *args],
                                env=env, stdout=subprocess.PIPE, text=True)

    builds = [run(t, "--build") for t in trees]
    for t, p in zip(trees, builds):
        if p.wait() != 0:
            raise RuntimeError(f"build failed in {t}")
    runs = {t: [] for t in trees}
    for t in trees + trees[::-1]:
        p = run(t, *(["--sites"] if sites_only else []))
        line = p.communicate()[0].strip().splitlines()[-1]
        if p.returncode != 0:
            raise RuntimeError(f"timing failed in {t}")
        print(f"# {t}: {line}", flush=True)
        runs[t].append(json.loads(line))
    keys = [k for k, v in runs[trees[-1]][0].items() if isinstance(v, float)]
    return {t: {k: [r.get(k) for r in rs] for k in keys} for t, rs in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="directories holding l2hmc_tpu_torch")
    ap.add_argument("--build", action="store_true", help="only build the kernels")
    ap.add_argument("--sites", action="store_true",
                    help="only the site-parallel kernels' rows (3e-3i, 1f-1i, 2f-2h, 1j-3l)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    if args.trees:
        print(json.dumps({"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(),
            "order": args.trees + args.trees[::-1],
            "ms": compare(args.trees, args.sites)}))
        return 0
    if args.build:
        from l2hmc_tpu_torch.ops import _cuda

        _cuda.wait_build()
        return 0
    print(json.dumps(one(args.sites)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
