"""The port's sampling slice as a whole vs the JAX package:
build_dynamics -> params_from_jax -> sample_chain -> evaluate_ess (CPU)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu.train import evaluate_ess as jax_evaluate_ess
from l2hmc_tpu.train import sample_chain as jax_sample_chain
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.train import (
    ScgConfig,
    build_dynamics,
    evaluate_ess,
    evaluate_trained,
    hmc_sample_chain,
    sample_chain,
)

ROOT = Path(__file__).resolve().parent.parent


def _jax_chain_on_draws(jd, jp, x, v, u_dir, u_acc):
    """JAX forward/backward/p_accept/metropolis composed per step on the
    given draws (jax.random cannot be fed numbers)."""

    @jax.jit
    def step(x, v, u_dir, u_acc):
        fwd = (u_dir < 0.5).astype(x.dtype)
        xf, vf, ljf = jd.forward(jp, x, v)
        xb, vb, ljb = jd.backward(jp, x, v)
        m = fwd[:, None]
        xp, vp = m * xf + (1 - m) * xb, m * vf + (1 - m) * vb
        lj = fwd * ljf + (1 - fwd) * ljb
        px = jd.p_accept(jp, x, v, xp, vp, lj)
        return jnp.where((px - u_acc >= 0.0)[:, None], xp, x)

    trace = []
    for k in range(v.shape[0]):
        x = step(x, v[k], u_dir[k], u_acc[k])
        trace.append(x)
    return jnp.stack(trace)


def test_sample_chain_matches_jax_on_same_draws():
    """20 MH steps on injected draws: traces agree to 2e-4 (float32, 20
    chained trajectories) and their ESS to 1e-4."""
    n, K = 64, 20
    cfg = dict(n_chains=n, T=4)
    jd, jt = jax_build_dynamics(JaxScgConfig(**cfg))
    td, _ = build_dynamics(ScgConfig(**cfg))
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    x0 = (rng.standard_normal((n, 2)) @ np.linalg.cholesky(jt.sigma).T).astype(np.float32)
    v = rng.standard_normal((K, n, 2)).astype(np.float32)
    u_dir = rng.uniform(size=(K, n)).astype(np.float32)
    u_acc = rng.uniform(size=(K, n)).astype(np.float32)

    ref = _jax_chain_on_draws(jd, jp, *map(jnp.asarray, (x0, v, u_dir, u_acc)))
    _, trace = sample_chain(
        td, tp, torch.tensor(x0), K, None,
        draws=tuple(map(torch.tensor, (v, u_dir, u_acc))),
    )
    np.testing.assert_allclose(trace.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        evaluate_ess(trace, jt.sigma), jax_evaluate_ess(ref, jt.sigma), rtol=1e-4
    )


def test_own_generator_statistics_match_jax():
    """Each package on its own random stream, same params and start: mean
    acceptance within 0.03 (standard error ~0.003 over 25600 accepts) and
    the chains keep the target's spread (trace of the covariance within 25%;
    the long axis mixes slowly, so chains barely move from their exact
    start)."""
    n, K = 256, 100
    jd, jt = jax_build_dynamics(JaxScgConfig(n_chains=n))
    td, tt = build_dynamics(ScgConfig(n_chains=n))
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x0 = tt.sample(torch.Generator().manual_seed(1), n, device="cpu")

    _, jacc = jax_sample_chain(jd, jp, jnp.asarray(x0.numpy()), K,
                               jax.random.key(2), collect=False)
    _, tacc = sample_chain(td, tp, x0, K, torch.Generator().manual_seed(2),
                           collect=False)
    assert abs(float(tacc.mean()) - float(jnp.mean(jacc))) < 0.03
    _, trace = sample_chain(td, tp, x0, K, torch.Generator().manual_seed(3))
    flat = trace.reshape(-1, 2).numpy().astype(np.float64)
    ratio = np.trace(np.cov(flat.T)) / np.trace(tt.sigma)
    assert 0.75 < ratio < 1.25


def test_hmc_chain_and_evaluate_trained_run():
    td, tt = build_dynamics(ScgConfig(n_chains=32, T=3))
    tp = td.init_params(torch.Generator().manual_seed(0), device="cpu")
    x0 = tt.sample(torch.Generator().manual_seed(1), 32, device="cpu")
    xf, trace = hmc_sample_chain(tt, 0.15, 3, x0, 10, torch.Generator().manual_seed(2))
    assert trace.shape == (10, 32, 2) and torch.isfinite(trace).all()
    out = evaluate_trained(ScgConfig(n_chains=32, T=3), tp, eval_steps=30, device="cpu")
    assert np.isfinite(out["ess_ratio"]) and 0 < out["ess_l2hmc"] <= 1.0


def test_icg_sample_chain_matches_jax_on_same_draws():
    """The 8-d ill-conditioned Gaussian with input_scale and eps_dim, 5
    steps on injected draws; tol 2e-4."""
    n, K, d = 32, 5, 8
    cfg = dict(dim=d, n_chains=n, T=3, eps_dim=True, net_input_whiten=True)
    jt = jtargets.ill_conditioned_gaussian(d)
    jd, _ = jax_build_dynamics(JaxScgConfig(**cfg), jt)
    from l2hmc_tpu_torch.targets import ill_conditioned_gaussian

    td, _ = build_dynamics(ScgConfig(**cfg), ill_conditioned_gaussian(d))
    eps = (0.1 * np.sqrt(np.diag(jt.sigma))).astype(np.float32)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    x0 = (rng.standard_normal((n, d)) * np.sqrt(np.diag(jt.sigma))).astype(np.float32)
    v = rng.standard_normal((K, n, d)).astype(np.float32)
    u_dir = rng.uniform(size=(K, n)).astype(np.float32)
    u_acc = rng.uniform(size=(K, n)).astype(np.float32)
    ref = _jax_chain_on_draws(jd, jp, *map(jnp.asarray, (x0, v, u_dir, u_acc)))
    _, trace = sample_chain(td, tp, torch.tensor(x0), K, None,
                            draws=tuple(map(torch.tensor, (v, u_dir, u_acc))))
    np.testing.assert_allclose(trace.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_port_imports_no_jax():
    """Importing the port (every module) and chip_smoke.py loads neither JAX
    nor the JAX package, and no port file names a JAX-package module."""
    code = (
        "import sys, importlib, pkgutil, l2hmc_tpu_torch\n"
        "for m in pkgutil.walk_packages(l2hmc_tpu_torch.__path__, 'l2hmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'l2hmc_tpu' or m.startswith('l2hmc_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "l2hmc_tpu_torch").rglob("*.py"))]
    for f in files:
        text = f.read_text()
        assert "l2hmc_tpu." not in text, f
        assert "import jax" not in text and "from jax" not in text, f
