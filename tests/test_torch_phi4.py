"""The phi^4 app (``apps.phi4``) on the CPU: its observables against the JAX
package's, a small run through ``run`` and ``main`` (dense and conv nets,
with a parallel-tempered eval), the pure check that decides its fused eval,
and the chain wrapper at the lattice's widths taking its plain version for
CPU tensors."""

import json

import numpy as np
import pytest
import torch

from l2hmc_tpu.apps import phi4 as jphi4
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.apps import phi4
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

# the JAX runner's result keys (l2hmc_tpu/apps/phi4.py:167-185, 223-230)
JAX_KEYS = {"L", "m2", "lam", "n_chains", "tunneling_rate_l2hmc", "tunneling_rate_hmc",
            "ess_m_l2hmc", "ess_m_hmc", "susceptibility_l2hmc", "final_accept", "train_time_s"}
PT_KEYS = {"pt_rungs", "pt_t_max", "tunneling_rate_pt_l2hmc", "tunneling_rate_pt_hmc",
           "ess_m_pt_l2hmc", "ess_m_pt_hmc"}


def _ar_trace(T=300, N=16, rho=0.9, seed=0):
    """An AR(1) magnetization-like (T, N) series in float32, some chains
    crossing zero."""
    rng = np.random.default_rng(seed)
    m = np.zeros((T, N))
    for t in range(1, T):
        m[t] = rho * m[t - 1] + rng.standard_normal(N)
    return (0.1 * m).astype(np.float32)


def test_tunneling_rate_and_magnetization_ess_match_jax():
    m = np.array([[1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])  # (T=3, N=2): 2 flips in 4
    assert phi4.tunneling_rate(m) == 0.5
    tr = _ar_trace()
    assert phi4.tunneling_rate(tr) == jphi4.tunneling_rate(tr) > 0
    np.testing.assert_allclose(phi4.magnetization_ess(tr), jphi4.magnetization_ess(tr),
                               rtol=1e-5)


def test_run_small_on_the_cpu_with_tempering():
    """``run`` end to end at L = 4 (the JAX test's smoke size) with a
    parallel-tempered eval: the JAX runner's keys, finite values; on the CPU
    the eval takes the plain ``sample_chain`` and says why."""
    fd.reset_launch_counts()
    r, state = phi4.run(L=4, n_chains=16, n_steps=30, leapfrogs=3, hidden=8, eval_steps=30,
                        pt_rungs=3, pt_t_max=4.0, pt_eval_steps=12, device="cpu",
                        return_state=True)
    assert JAX_KEYS | PT_KEYS <= set(r)
    assert r["fused_eval"] == "the fused eval runs on a CUDA device"
    assert r["pt_eval_steps"] == 12
    assert all(np.isfinite(r[k]) for k in ("ess_m_l2hmc", "ess_m_hmc", "tunneling_rate_l2hmc",
                                           "ess_m_pt_l2hmc", "ess_m_pt_hmc"))
    assert 0.0 <= r["final_accept"] <= 1.0
    assert state.x.shape == (16, 16)
    assert fd.LAUNCHES["chain"] == 0


def test_main_with_conv_nets_on_the_cpu(capsys):
    """The command line with the JAX runner's flags and ``--device cpu``:
    conv nets train, and their eval goes plain by the pure refusal."""
    r = phi4.main(["--device", "cpu", "--L", "4", "--n_chains", "8", "--n_steps", "4",
                   "--leapfrogs", "2", "--eval_steps", "10", "--eps", "0.05", "--hmc_eps", "0.05",
                   "--net_type", "conv", "--conv_channels", "4"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == r
    assert "dense S/T/Q nets, not conv" in r["fused_eval"]
    assert np.isfinite(r["ess_m_l2hmc"])


def test_kernel_refusals_at_the_lattice_widths():
    """The pure check names the kernel and the caps: the chain kernel serves
    the dense nets at L = 16, 32 and 64 and hidden 100, refuses L = 128 and
    hidden 129; the trajectory kernels stop at dim 4096 and hidden 128;
    conv nets are refused with their reason; a mixture or a rough well past
    64 is served, as the lattice is."""
    def dyn(L, hidden=32):
        t = targets.Phi4Lattice(L=L)
        return build_dynamics(ScgConfig(dim=t.dim, hidden=hidden), t)[0], t

    for L in (8, 16, 32, 64):
        assert fd.kernel_refusal(*dyn(L), 32) is None
    d16, t16 = dyn(16)
    assert fd._caps_refusal("trajectory", 16384, 32) == (
        "trajectory kernel caps exceeded: dim 16384, hidden 32 (caps dim 4096, hidden 128)")
    assert "trajectory_bwd kernel caps" in fd._caps_refusal("trajectory_bwd", 16384, 32)
    assert fd._caps_refusal("trajectory", 256, 32) is None
    assert fd._caps_refusal("trajectory_bwd", 4096, 100) is None
    assert "trajectory kernel caps exceeded: dim 64, hidden 129" in fd._caps_refusal(
        "trajectory", 64, 129)
    assert fd.kernel_refusal(*dyn(128), 32) == (
        "chain kernel caps exceeded: dim 16384, hidden 32 (caps dim 4096, hidden 128)")
    assert fd.kernel_refusal(*dyn(16, 100), 100) is None
    assert fd.kernel_refusal(*dyn(16, 129), 129) == (
        "chain kernel caps exceeded: dim 256, hidden 129 (caps dim 4096, hidden 128)")
    assert "not conv" in fd.kernel_refusal(d16, t16, 32, net_type="conv")
    ring = targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4)
    assert fd.kernel_refusal(d16, ring, 32) is None
    rdyn = build_dynamics(ScgConfig(dim=2, hidden=100), ring)[0]
    assert fd.kernel_refusal(rdyn, ring, 100) is None
    rough = targets.RoughWell(dim=100, eps=0.1, easy=True)
    rdyn = build_dynamics(ScgConfig(dim=100, hidden=32), rough)[0]
    assert fd.kernel_refusal(rdyn, rough, 32) is None
    assert fd.kernel_refusal(rdyn, rough, 129) == (
        "chain kernel caps exceeded: dim 100, hidden 129 (caps dim 4096, hidden 128)")


@pytest.mark.parametrize("case", list(phi4.PARITY_CASES))
def test_parity_cases_are_not_hollow(case):
    """The card's parity cases give finite trajectories and an acceptance
    well inside (0, 1) on the plain chain."""
    inp, x = phi4.parity_inputs(case, 32, "cpu")
    _, acc, _ = fd.chain_plain(inp, x, seed=3, n_mh_steps=3)
    assert 0.05 < float(acc.mean()) < 0.95


def test_chain_wrapper_takes_the_plain_version_for_cpu_tensors_at_L16():
    """At D = 256 the wrapper on CPU tensors is the plain chain bit for bit
    and launches nothing; the sampler returns the (K, N, D) trace."""
    inp, x = phi4.parity_inputs("phi4_L16", 8, "cpu")
    fd.reset_launch_counts()
    got = fd.chain(inp, x, 5, 2, collect_trace=True)
    ref = fd.chain_plain(inp, x, 5, 2, collect_trace=True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fd.LAUNCHES["chain"] == 0
    t = targets.Phi4Lattice(L=16, m2=-1.0, lam=0.5)
    d, _ = build_dynamics(ScgConfig(dim=t.dim, hidden=32), t)
    p = d.init_params(torch.Generator().manual_seed(0), device="cpu")
    xo, acc, trace = fd.fused_chain_sampler(d, t).run(p, x.T.contiguous(), seed=1, n_mh_steps=2,
                                                      collect_trace=True)
    assert xo.shape == (8, 256) and acc.shape == (8,) and trace.shape == (2, 8, 256)
    torch.testing.assert_close(trace[-1], xo, rtol=0, atol=0)
