"""The VAE kernels' plain versions vs the JAX package's Pallas kernels
(interpret mode on the CPU, where the random bits are all zero: momentum
sqrt(-2 ln 1e-7) per element, direction forward, accept always), the
wrappers on CPU tensors, and the Philox draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_vae_util import C0, build_pair, inputs

from l2hmc_tpu.ops import FusedVaeAis as JaxFusedVaeAis
from l2hmc_tpu.ops import FusedVaeSampler as JaxFusedVaeSampler
from l2hmc_tpu_torch import mcmc
from l2hmc_tpu_torch.apps import vae as tvae
from l2hmc_tpu_torch.evals.ais import ais_estimate, standard_normal_energy, standard_normal_grad
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops import fused_vae as fv
from l2hmc_tpu_torch.ops.philox import chain_draws

TOL = 2e-4  # the JAX package's own fused-vs-XLA tolerance


def _zero_bit_draws(n, d):
    def draws(step, op=0):
        return torch.full((d, n), C0), torch.zeros(n), torch.zeros(n)
    return draws


def _torch_inputs(tm, tp, x_raw):
    xr = torch.tensor(x_raw)
    emb = tm.aux_encoder.apply(tp["smp"]["aux_enc"], xr)
    return xr, emb


@pytest.mark.parametrize("max_comp", [0, 3], ids=["single", "composed"])
def test_plain_sampler_matches_jax_kernel(max_comp):
    """Plain version of the sampler kernel vs the Pallas kernel on the
    zero-bits schedule, with the trace, without and with op compositions
    (the nb sequence is the JAX run's own, injected), tol 2e-4."""
    jm, jp, tm, tp = build_pair(latent_dim=10, leapfrogs=2)
    n, K = 128, 4
    x_raw, z0 = inputs(n, 10)
    jemb = jm.aux_encoder.apply(jp["smp"]["aux_enc"], jnp.asarray(x_raw))
    comp_key = jax.random.key(3)
    with pltpu.force_tpu_interpret_mode():
        zr, accr, trr = JaxFusedVaeSampler(jm.dynamics, tile=64).run(
            jp["smp"], jp["dec"], jnp.asarray(x_raw), jemb, jnp.asarray(z0), seed=5,
            n_mh_steps=K, collect_trace=True, max_composition=max_comp,
            comp_key=comp_key if max_comp else None,
        )
    nb = None
    if max_comp:
        nb = np.asarray(jax.random.randint(comp_key, (K,), 1, max_comp))
        assert len(set(nb.tolist())) > 1  # both op counts are hit
    xr, emb = _torch_inputs(tm, tp, x_raw)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-5, atol=1e-5)
    inp = fv.prepare_vae(tm.dynamics, tp["smp"], tp["dec"], xr.T.contiguous(),
                         emb.T.contiguous())
    z, acc, trace = fv.vae_chain_plain(
        inp, torch.tensor(z0).T.contiguous(), seed=5, n_mh_steps=K, collect_trace=True,
        nb=nb, draws=_zero_bit_draws(n, 10),
    )
    np.testing.assert_array_equal(acc.numpy()[0], np.asarray(accr))
    np.testing.assert_allclose(trace.permute(0, 2, 1).numpy(), np.asarray(trr),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(z.T.numpy(), np.asarray(zr), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(trace[-1].numpy(), z.numpy())
    assert float(np.abs(np.asarray(zr) - z0).max()) > 0.1  # the chain moved


@pytest.mark.parametrize("anneal_steps", [5, 1])
def test_plain_ais_matches_jax_kernel(anneal_steps):
    """Plain version of the AIS kernel vs the Pallas kernel on the zero-bits
    schedule (anneal_steps == 1 has its own beta_diff), tol 2e-4."""
    jm, jp, tm, tp = build_pair(latent_dim=6, leapfrogs=2, enc_hidden=16,
                                sampler_size1=8, sampler_size2=8)
    n, T_lf, eps = 64, 3, 0.07
    x_raw, z0 = inputs(n, 6)
    with pltpu.force_tpu_interpret_mode():
        wr, accr = JaxFusedVaeAis(latent_dim=6, tile=32).run(
            jp["dec"], jnp.asarray(x_raw), jnp.asarray(z0), seed=5,
            anneal_steps=anneal_steps, step_size=eps, leapfrogs=T_lf,
        )
    w, acc = fv.vae_ais_plain(
        fv.decoder_arrays(tp["dec"]), torch.tensor(x_raw).T.contiguous(),
        torch.tensor(z0).T.contiguous(), seed=5, anneal_steps=anneal_steps,
        step_size=eps, leapfrogs=T_lf,
        draws=lambda step: (torch.full((6, n), C0), torch.zeros(n)),
    )
    np.testing.assert_allclose(w.numpy()[0], np.asarray(wr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(acc.numpy()[0], np.asarray(accr), rtol=TOL, atol=TOL)
    assert float(np.abs(np.asarray(wr)).max()) > 1.0


def test_plain_sampler_matches_propose_on_same_draws():
    """One MH op of the plain sampler equals ``mcmc.propose`` on the same
    momenta, direction and accept uniforms (both directions and both accept
    outcomes occur), to 1e-5: two routes through the port's own code."""
    _, _, tm, tp = build_pair()
    n, d = 96, 8
    x_raw, z0 = inputs(n, d)
    xr, emb = _torch_inputs(tm, tp, x_raw)
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.standard_normal((n, d)).astype(np.float32))
    u_dir = torch.tensor(rng.random(n).astype(np.float32))
    u_acc = torch.tensor(rng.random(n).astype(np.float32))
    aux = {"raw": xr, "emb": emb, "dec": tp["dec"]}
    out = mcmc.propose(None, tm.dynamics, tp["smp"], torch.tensor(z0), init_v=v,
                       dir_u=u_dir, accept_u=u_acc, aux=aux, do_mh_step=True)
    inp = fv.prepare_vae(tm.dynamics, tp["smp"], tp["dec"], xr.T.contiguous(),
                         emb.T.contiguous())
    z, acc, _ = fv.vae_chain_plain(
        inp, torch.tensor(z0).T.contiguous(), seed=0, n_mh_steps=1,
        draws=lambda step, op: (v.T.contiguous(), u_dir, u_acc),
    )
    torch.testing.assert_close(z.T, out.x_next, rtol=1e-5, atol=1e-5)
    accepted = (out.p_accept - u_acc >= 0).float()
    torch.testing.assert_close(acc[0], accepted, rtol=0, atol=0)
    assert 0 < accepted.sum() < n and 0 < (u_dir < 0.5).sum() < n


def test_plain_ais_matches_ais_estimate_on_same_draws():
    """``vae_ais_plain`` and ``evals.ais_estimate`` (no refresh) are the
    same chain on the same draws: one group per chain makes the estimate
    the sum of log weights. rtol 1e-4 on the sum, 1e-5 on acceptance."""
    _, _, tm, tp = build_pair()
    n, d, K, L, eps = 24, 8, 6, 4, 0.05
    x_raw, z0 = inputs(n, d)
    rng = np.random.default_rng(5)
    vs = [torch.tensor(rng.standard_normal((n, d)).astype(np.float32)) for _ in range(K)]
    us = [torch.tensor(rng.random(n).astype(np.float32)) for _ in range(K)]
    w, acc = fv.vae_ais_plain(
        fv.decoder_arrays(tp["dec"]), torch.tensor(x_raw).T.contiguous(),
        torch.tensor(z0).T.contiguous(), seed=0, anneal_steps=K, step_size=eps,
        leapfrogs=L, draws=lambda i: (vs[i].T.contiguous(), us[i]),
    )
    energy, grad = tm.dynamics.energy, tm.dynamics.grad_energy
    aux = {"raw": torch.tensor(x_raw), "dec": tp["dec"]}
    est, acc_ref = ais_estimate(
        None, standard_normal_energy, energy, K, torch.tensor(z0), aux=aux,
        step_size=eps, leapfrogs=L, num_splits=n, init_grad=standard_normal_grad,
        final_grad=grad, draws=lambda i: (vs[i], us[i]),
    )
    torch.testing.assert_close(w.sum(), est, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(acc.mean(), acc_ref, rtol=1e-5, atol=1e-5)


def test_wrappers_take_plain_versions_on_cpu():
    """CPU tensors go through the plain versions: no launch is counted, the
    trace's last row is the final state, composition needs its counts."""
    _, _, tm, tp = build_pair()
    n, d = 40, 8
    x_raw, z0 = inputs(n, d)
    xr, emb = _torch_inputs(tm, tp, x_raw)
    sampler = fv.FusedVaeSampler(tm.dynamics)
    fd.reset_launch_counts()
    z, acc, trace = sampler.run(tp["smp"], tp["dec"], xr, emb, torch.tensor(z0), seed=3,
                                n_mh_steps=3, collect_trace=True, max_composition=4,
                                comp_key=[1, 3, 2])
    z2, acc2 = sampler.run(tp["smp"], tp["dec"], xr, emb, torch.tensor(z0), seed=3,
                           n_mh_steps=3, max_composition=4, comp_key=[1, 3, 2])
    assert trace.shape == (3, n, d) and z.shape == (n, d) and acc.shape == (n,)
    torch.testing.assert_close(trace[-1], z, rtol=0, atol=0)
    torch.testing.assert_close(z2, z, rtol=0, atol=0)
    assert ((acc >= 0) & (acc <= 1)).all() and torch.isfinite(z).all()
    w, a = fv.FusedVaeAis(latent_dim=d).run(tp["dec"], xr, torch.tensor(z0), seed=3,
                                             anneal_steps=4, step_size=0.05, leapfrogs=2)
    assert w.shape == (n,) and a.shape == (n,) and torch.isfinite(w).all()
    assert ((a > 0) & (a <= 1)).all()
    assert not any(fd.LAUNCHES.values())
    nb = fv.composition_counts(torch.Generator().manual_seed(0), 200, 4)
    assert set(nb.tolist()) == {1, 2, 3}
    with pytest.raises(ValueError, match="comp_key"):
        sampler.run(tp["smp"], tp["dec"], xr, emb, torch.tensor(z0), seed=3,
                    n_mh_steps=3, max_composition=4)
    with pytest.raises(ValueError, match="op counts"):
        sampler.run(tp["smp"], tp["dec"], xr, emb, torch.tensor(z0), seed=3,
                    n_mh_steps=3, max_composition=4, comp_key=[1, 4, 2])


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, _, tm, tp = build_pair()
    x_raw, z0 = inputs(16, 8)
    xr, emb = _torch_inputs(tm, tp, x_raw)
    # bfloat16 operands run (tests/test_torch_bf16_vae.py holds them to
    # JAX); an operand dtype the kernels have no instantiation for raises
    zb, accb = fv.FusedVaeSampler(tm.dynamics, compute_dtype="bfloat16").run(
        tp["smp"], tp["dec"], xr, emb, torch.tensor(z0), seed=0, n_mh_steps=1)
    wb, _ = fv.FusedVaeAis(latent_dim=8, compute_dtype="bfloat16").run(
        tp["dec"], xr, torch.tensor(z0), seed=0, anneal_steps=2, step_size=0.1)
    assert bool(torch.isfinite(zb).all() and torch.isfinite(wb).all())
    for cls, kw in ((fv.FusedVaeSampler, {"dynamics": tm.dynamics}),
                    (fv.FusedVaeAis, {"latent_dim": 8})):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            cls(**kw, compute_dtype="float16")
    with pytest.raises(TypeError, match="float32"):
        fv.FusedVaeSampler(tm.dynamics).run(tp["smp"], tp["dec"], xr, emb,
                                            torch.tensor(z0).double(), seed=0, n_mh_steps=1)
    with pytest.raises(ValueError, match="shape"):
        fv.FusedVaeAis(latent_dim=8).run(tp["dec"], xr[:8], torch.tensor(z0), seed=0,
                                         anneal_steps=2, step_size=0.1)
    hmc = tvae.VaeModel.build(tvae.VaeConfig(latent_dim=8, enc_hidden=32, hmc=True))
    with pytest.raises(ValueError, match="hmc"):
        fv.FusedVaeSampler(hmc.dynamics).run(tp["smp"], tp["dec"], xr, emb,
                                             torch.tensor(z0), seed=0, n_mh_steps=1)
    inp = fv.prepare_vae(tm.dynamics, tp["smp"], tp["dec"], xr.T.contiguous(),
                         emb.T.contiguous())
    zT = torch.tensor(z0).T.contiguous()
    for nb in ([1, 0, 2], [1, 2]):
        with pytest.raises(ValueError, match="op count"):
            fv.vae_chain(inp, xr.T.contiguous(), zT, seed=0, n_mh_steps=3, nb=nb)
    # one cluster configuration for every chain count: ceil(N / Ct) clusters
    # of G CTAs, the last one ragged
    ct, g = fv.CHAIN_CLUSTER
    assert [fv._slice(n, ct) * g for n in (9, 16, 200, 203)] == [8, 8, 104, 104]


def test_philox_draws_independent_of_chain_count_and_distinct_per_op():
    """Chain n's draws depend on (seed, n, step, op) only, so they are the
    same whatever the tile or the chain count; each inner op of a composed
    step has its own."""
    a = chain_draws(11, 16, 9, step=2, device="cpu", op=1)
    b = chain_draws(11, 8, 9, step=2, device="cpu", op=1)
    for x, y in zip(a, b):
        torch.testing.assert_close(x[..., :8], y, rtol=0, atol=0)
    c = chain_draws(11, 16, 9, step=2, device="cpu", op=0)
    d = chain_draws(11, 16, 9, step=2, device="cpu")
    for x, y, z in zip(a, c, d):
        assert not torch.equal(x, y)
        torch.testing.assert_close(y, z, rtol=0, atol=0)
    assert a[0].shape == (9, 16) and 0 <= float(a[1].min()) and float(a[1].max()) < 1
