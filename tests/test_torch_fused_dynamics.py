"""The fused kernels' host prep and plain versions vs the JAX package's
Pallas kernels (interpret mode on the CPU), and the Philox generator the
chain kernel shares with its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops.philox import box_muller, chain_draws, philox4x32_10
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

N = 256
TOL = 2e-4  # the JAX package's own fused-vs-XLA tolerance


def _setup(mode="plain", perturb=True):
    """The setup of tests/test_fused_dynamics.py: SCG, T=4, 256 chains,
    weights lifted by 0.03 so S/T/Q are not ~0."""
    kw = dict(n_chains=N, T=4, hmc=mode == "hmc", eps_dim=mode == "eps_dim")
    jd, jt = jax_build_dynamics(JaxScgConfig(**kw))
    td, tt = build_dynamics(ScgConfig(**kw))
    eps = np.array([0.08, 0.12], np.float32) if mode == "eps_dim" else 0.1
    jp = jd.init_params(jax.random.key(0), eps=eps)
    if perturb:
        for net in ("xnet", "vnet"):
            jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 2)).astype(np.float32)
    v = rng.standard_normal((N, 2)).astype(np.float32)
    return jd, jt, jp, td, tt, tp, x, v


def test_extract_net_matches_jax():
    jd, _, jp, td, _, tp, _, _ = _setup()
    for net in ("xnet", "vnet"):
        ref = jfd._extract_net(jp[net], jd.times)
        got = fd._extract_net(tp[net], td.times)
        assert len(got) == fd._NET_ARRAYS
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_input_scale_fold_matches_jax():
    from l2hmc_tpu import targets as jtargets

    cfg = dict(dim=6, n_chains=N, T=4, net_input_whiten=True)
    jd, _ = jax_build_dynamics(JaxScgConfig(**cfg), jtargets.ill_conditioned_gaussian(6))
    td, _ = build_dynamics(ScgConfig(**cfg), targets.ill_conditioned_gaussian(6))
    jp = jd.init_params(jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for jw, tw in zip(jfd._kernel_nets(jd, jp), fd._kernel_nets(td, tp, "cpu")):
        for g, r in zip(tw, jw):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["plain", "hmc", "eps_dim"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plain_trajectory_matches_jax_kernel(mode, direction):
    """Plain version of the trajectory kernel vs the Pallas kernel in
    interpret mode, tol 2e-4."""
    jd, jt, jp, td, tt, tp, x, v = _setup(mode)
    jfused = jfd.fused_for_target(jd, jt, tile=128, interpret=True)
    Xr, Vr, ldr = getattr(jfused, direction)(jp, jnp.asarray(x), jnp.asarray(v))
    fused = fd.fused_for_target(td, tt)
    fd.reset_launch_counts()
    Xf, Vf, ldf = getattr(fused, direction)(tp, torch.tensor(x), torch.tensor(v))
    assert fd.LAUNCHES["trajectory"] == 0  # CPU tensors take the plain version
    for g, r in ((Xf, Xr), (Vf, Vr), (ldf, ldr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL, atol=TOL)


def test_plain_trajectory_inverts():
    _, _, _, td, tt, tp, x, v = _setup()
    fused = fd.fused_for_target(td, tt)
    X, V, ld = fused.forward(tp, torch.tensor(x), torch.tensor(v))
    x2, v2, ld_b = fused.backward(tp, X, V)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((ld + ld_b).numpy(), 0.0, atol=1e-5)


def _zero_bit_draws(n, d):
    """The draws a Philox stream of zero words gives: v = sqrt(-2 ln 1e-7)
    in every dimension, direction uniform 0 (forward), accept uniform 0
    (always accept) — what the Pallas interpreter's zero PRNG bits give the
    JAX chain kernel."""
    zero = torch.zeros((d, n), dtype=torch.int64)
    u = torch.zeros(n)
    return lambda step: (box_muller(zero, zero), u, u)


@pytest.mark.parametrize("mode", ["plain", "hmc", "eps_dim"])
def test_plain_chain_matches_jax_kernel_on_zero_bits(mode):
    """Plain chain sampler on the zero-bits schedule vs the JAX chain kernel
    under force_tpu_interpret_mode, with its trace; tol 2e-4."""
    jd, jt, jp, td, tt, tp, x, _ = _setup(mode, perturb=False)
    n_steps = 5
    sampler = jfd.fused_chain_sampler(jd, jt, tile=128)
    with pltpu.force_tpu_interpret_mode():
        x1, acc = sampler.run(jp, jnp.asarray(x), seed=7, n_mh_steps=n_steps)
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    xo, acc_t, trace = fd.chain_plain(
        inp, torch.tensor(x).T.contiguous(), seed=7, n_mh_steps=n_steps,
        collect_trace=True, draws=_zero_bit_draws(N, 2),
    )
    np.testing.assert_array_equal(acc_t[0].numpy(), np.asarray(acc))
    np.testing.assert_allclose(xo.T.numpy(), np.asarray(x1), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(trace[-1].numpy(), xo.numpy())


def test_chain_wrapper_plain_on_cpu_with_trace():
    _, _, _, td, tt, tp, x, _ = _setup()
    sampler = fd.fused_chain_sampler(td, tt)
    fd.reset_launch_counts()
    x1, acc, trace = sampler.run(tp, torch.tensor(x), seed=3, n_mh_steps=6,
                                 collect_trace=True)
    x1b, accb = sampler.run(tp, torch.tensor(x), seed=3, n_mh_steps=6)
    assert {"trajectory", "trajectory_bwd", "chain"} <= set(fd.LAUNCHES)
    assert not any(fd.LAUNCHES.values())
    assert trace.shape == (6, N, 2)
    torch.testing.assert_close(trace[-1], x1, rtol=0, atol=0)
    torch.testing.assert_close(x1b, x1, rtol=0, atol=0)
    torch.testing.assert_close(accb, acc, rtol=0, atol=0)
    assert 0.0 < float(acc.mean()) < 1.0


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    m = 0xFFFFFFFF
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((m, m, m, m), (m, m), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = tuple(int(w) for w in philox4x32_10(ctr, key))
        assert got == want


def test_chain_draws_layout_and_law():
    """Slot 0 carries the direction and accept uniforms, slots 1.. the
    normals in pairs; the draws do not depend on how many chains run."""
    v, u_dir, u_acc = chain_draws(seed=5, n=4096, d=3, step=2, device="cpu")
    assert v.shape == (3, 4096) and u_dir.shape == (4096,)
    v_small, u_small, _ = chain_draws(seed=5, n=16, d=3, step=2, device="cpu")
    torch.testing.assert_close(v[:, :16], v_small, rtol=0, atol=0)
    torch.testing.assert_close(u_dir[:16], u_small, rtol=0, atol=0)
    assert abs(float(v.mean())) < 0.05 and abs(float(v.std()) - 1.0) < 0.03
    assert 0.0 <= float(u_acc.min()) and float(u_acc.max()) < 1.0
    assert abs(float(u_dir.mean()) - 0.5) < 0.02


@pytest.mark.parametrize("d,op", [(1, 0), (2, 0), (5, 2), (257, 0)])
def test_chain_draws_equal_the_per_slot_words(d, op):
    """``chain_draws`` forms every slot's normals in one Philox call; they
    equal the per-slot form (slot 1 + j gives rows 2j and 2j + 1), bit for
    bit."""
    n, step, seed = 37, 7, 12345678901
    v, u_dir, u_acc = chain_draws(seed, n, d, step, "cpu", op=op)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    chains = torch.arange(n, dtype=torch.int64)
    rows = []
    for j in range((d + 1) // 2):
        r = philox4x32_10((chains, step, 1 + j, op), key)
        rows.append(box_muller(r[0], r[1]))
        if 2 * j + 1 < d:
            rows.append(box_muller(r[2], r[3]))
    torch.testing.assert_close(v, torch.stack(rows), rtol=0, atol=0)
    r0 = philox4x32_10((chains, step, 0, op), key)
    torch.testing.assert_close(u_dir, (r0[0] >> 8).to(torch.float32) / (1 << 24), rtol=0, atol=0)
    torch.testing.assert_close(u_acc, (r0[1] >> 8).to(torch.float32) / (1 << 24), rtol=0, atol=0)


def test_packed_block_layout():
    """The packed block has the length csrc/l2hmc_common.cuh computes."""
    _, _, _, td, tt, tp, _, _ = _setup()
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    D, H, H2, T = inp.dims
    net = 2 * D * H + H * H2 + H2 + 3 * H2 * D + 5 * D + H * T
    assert inp.block().numel() == 2 * D + D * T + D * D + 2 * net
    assert (D, H, H2, T) == (2, 10, 10, 4)


def test_wrapper_input_checks():
    _, _, _, td, tt, tp, x, v = _setup()
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    xt = torch.tensor(x)
    with pytest.raises(ValueError, match="dim=2"):
        fd.trajectory(inp, xt, xt, reverse=False)  # (N, D), not (D, N)
    with pytest.raises(TypeError):
        fd.trajectory(inp, xt.T.double().contiguous(), xt.T.double().contiguous(), False)
    with pytest.raises(ValueError, match="contiguous"):
        fd.chain(inp, xt.T, seed=0, n_mh_steps=1)


def test_non_gaussian_target_not_ported():
    """A target with no energy spec raises the JAX package's ValueError."""
    class Opaque:
        dim = 2

    with pytest.raises(ValueError, match="no fused energy spec"):
        fd.energy_spec_for_target(Opaque())


@pytest.mark.parametrize("differentiable", [False, True], ids=["fused", "differentiable"])
def test_fused_dynamics_take_propose_with_no_aux_and_refuse_one(differentiable):
    """``mcmc.propose`` hands its ``aux`` (None for a spec'd target) to the
    dynamics it is given; the fused stand-ins take None and refuse anything
    else, and the proposal equals the plain ``Dynamics`` one on the same
    draws to the fused-vs-plain tolerance."""
    from l2hmc_tpu_torch import mcmc

    _, _, _, td, tt, tp, x, v = _setup()
    fused = fd.differentiable_fused(td, tt) if differentiable else fd.fused_for_target(td, tt)
    xt, vt = torch.tensor(x), torch.tensor(v)
    u = torch.tensor(np.random.default_rng(2).random(N).astype(np.float32))
    if differentiable:  # the class with the surface ``propose`` reads
        with torch.no_grad():
            got = mcmc.propose(None, fused, tp, xt, init_v=vt, dir_u=u)
            ref = mcmc.propose(None, td, tp, xt, init_v=vt, dir_u=u)
        torch.testing.assert_close(got.x_prop, ref.x_prop, rtol=0, atol=TOL)
        torch.testing.assert_close(got.p_accept, ref.p_accept, rtol=0, atol=TOL)
    else:
        X, V, ld = fused.forward(tp, xt, vt, aux=None)
        ref = td.forward(tp, xt, vt)
        torch.testing.assert_close(X, ref[0], rtol=0, atol=TOL)
    for call in (fused.forward, fused.backward):
        with pytest.raises(ValueError, match="aux"):
            call(tp, xt, vt, aux={"raw": xt})
