"""The fused VAE training path of the port on the CPU, where its wrappers
take the kernels' plain versions: the plain trajectory against the JAX
``Dynamics.forward/backward`` with ``aux``, the hand-written VJP against
autograd in float64, ``DifferentiableFusedVae``'s gradients against
``jax.grad`` of the JAX package's XLA path and of its Pallas kernels in
interpret mode, and fused against plain training."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_vae_util import SMALL, build_pair, inputs

from l2hmc_tpu.ops import DifferentiableFusedVae as JaxDifferentiableFusedVae
from l2hmc_tpu_torch.apps import data as tdata
from l2hmc_tpu_torch.apps import vae as tvae
from l2hmc_tpu_torch.ops import DifferentiableFusedVae
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops import fused_vae as fv
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten

N, D = 64, SMALL["latent_dim"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are tiny: one intra-op thread is the fastest, and the
    test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n=N, seed=1):
    jm, jp, tm, tp = build_pair()
    x_raw, z0 = inputs(n, D, seed)
    v0 = np.random.default_rng(seed + 100).standard_normal((n, D)).astype(np.float32)
    return jm, jp, tm, tp, x_raw, z0, v0


def _kernel_inputs(tm, tp, x_raw):
    xr = torch.tensor(x_raw)
    emb = tm.aux_encoder.apply(tp["smp"]["aux_enc"], xr)
    return fv.prepare_vae(tm.dynamics, tp["smp"], tp["dec"], xr.T.contiguous(),
                          emb.T.contiguous())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_plain_trajectory_matches_jax_dynamics(reverse):
    """``vae_trajectory_plain`` and the wrapper on CPU tensors against the
    JAX ``Dynamics.forward/backward`` with ``aux`` on the same numpy inputs:
    2e-4, the JAX package's own fused-vs-XLA tolerance (float32
    trajectories of 3 leapfrog steps, decoder sums in other orders)."""
    jm, jp, tm, tp, x_raw, z0, v0 = _setup()
    with jax.enable_x64(False):
        jemb = jm.aux_encoder.apply(jp["smp"]["aux_enc"], jnp.asarray(x_raw))
        jaux = {"raw": jnp.asarray(x_raw), "emb": jemb, "dec": jp["dec"]}
        fn = jm.dynamics.backward if reverse else jm.dynamics.forward
        ref = fn(jp["smp"], jnp.asarray(z0), jnp.asarray(v0), aux=jaux)
    inp = _kernel_inputs(tm, tp, x_raw)
    zT, vT = torch.tensor(z0).T.contiguous(), torch.tensor(v0).T.contiguous()
    Z, V, ld = fv.vae_trajectory_plain(inp, zT, vT, reverse)
    for got, want in ((Z.T, ref[0]), (V.T, ref[1]), (ld[0], ref[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    before = dict(fd.LAUNCHES)
    again = fv.vae_trajectory(inp, torch.tensor(x_raw).T.contiguous(), zT, vT, reverse)
    for a, b in zip(again, (Z, V, ld)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fd.LAUNCHES == before  # a CPU tensor launches no kernel
    assert float((Z - zT).abs().max()) > 0.1  # the chains moved


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_plain_vjp_matches_autograd_in_float64(reverse):
    """``vae_trajectory_vjp_plain`` (the hand-derived substep VJP with the
    decoder's Hessian-vector product) against autograd of
    ``vae_trajectory_plain`` in float64, where the energy gradient is taken
    by autograd too: every cotangent (both nets' 13 arrays, eps, emb, z, v)
    to 1e-9 of its largest entry. The decoder is scaled down so that no
    softplus argument passes 20, where torch switches to the identity."""
    _, _, tm, tp, x_raw, z0, v0 = _setup(n=7)
    inp = _kernel_inputs(tm, tp, x_raw)
    f64 = lambda t: t.detach().double()  # noqa: E731
    gen = torch.Generator().manual_seed(3)
    dec = [0.3 * f64(a) for a in inp.consts]
    xr = f64(torch.tensor(x_raw).T)
    energy, grad_energy = fv._vae_decoder_closures(dec, xr)
    inp64 = dataclasses.replace(
        inp, eps=f64(inp.eps), masks=f64(inp.masks), consts=dec,
        xnet_w=[f64(a) + 0.05 * torch.randn(a.shape, generator=gen, dtype=torch.float64)
                for a in inp.xnet_w],
        vnet_w=[f64(a) + 0.05 * torch.randn(a.shape, generator=gen, dtype=torch.float64)
                for a in inp.vnet_w],
        energy=energy, grad_energy=grad_energy, grad_vjp=fv.build_grad_vjp(dec, xr),
        emb=f64(inp.emb))
    z, v = f64(torch.tensor(z0).T), f64(torch.tensor(v0).T)
    dZ, dV = (torch.randn(z.shape, generator=gen, dtype=torch.float64) for _ in range(2))
    dld = torch.randn((1, z.shape[1]), generator=gen, dtype=torch.float64)

    def grad_by_autograd(y):
        if not y.requires_grad:
            y = y.requires_grad_(True)
        return torch.autograd.grad(energy(y).sum(), y, create_graph=True)[0]

    leaves = [t.clone().requires_grad_(True)
              for t in (inp64.eps, inp64.emb, z, v, *inp64.xnet_w, *inp64.vnet_w)]
    traced = dataclasses.replace(inp64, eps=leaves[0], emb=leaves[1], xnet_w=leaves[4:17],
                                 vnet_w=leaves[17:], grad_energy=grad_by_autograd)
    Z, V, ld = fv.vae_trajectory_plain(traced, leaves[2], leaves[3], reverse)
    want = torch.autograd.grad((Z * dZ).sum() + (V * dV).sum() + (ld * dld).sum(), leaves)
    gx, gv, deps, demb, dz, dv = fv.vae_trajectory_vjp_plain(inp64, z, v, dZ, dV, dld, reverse)
    for got, ref in zip((deps, demb, dz, dv, *gx, *gv), want):
        scale = float(ref.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-9 * scale)


def _loss(tm_or_jm, xp):
    """The loss of the JAX package's gradient-parity test
    (tests/test_fused_dynamics.py, test_differentiable_fused_vae_grad_parity)
    in either framework (``xp`` is ``jnp`` or ``torch``)."""
    def loss(d, smp, dec, x_raw, z0, v0):
        emb = tm_or_jm.aux_encoder.apply(smp["aux_enc"], x_raw)
        aux = {"raw": x_raw, "emb": emb, "dec": dec}
        Z, V, ld = d.forward(smp, z0, v0, aux=aux)
        Zb, Vb, ldb = d.backward(smp, z0, v0, aux=aux)
        return (xp.mean(Z * Zb) + xp.mean(V + Vb) + xp.mean(ld - 2.0 * ldb)
                + xp.mean(d.p_accept(smp, z0, v0, Z, V, ld, aux=aux)))
    return loss


def _torch_grads(tm, tp, dyn, x_raw, z0, v0):
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(tp)]
    p = tree_unflatten(tp, leaves)
    z, v = torch.tensor(z0, requires_grad=True), torch.tensor(v0, requires_grad=True)
    value = _loss(tm, torch)(dyn, p["smp"], p["dec"], torch.tensor(x_raw), z, v)
    grads = torch.autograd.grad(value, leaves + [z, v], allow_unused=True)
    tree = tree_unflatten(tp, list(grads[:-2]))
    return float(value.detach()), tree, grads[-2], grads[-1]


@pytest.fixture(scope="module")
def grad_case():
    jm, jp, tm, tp, x_raw, z0, v0 = _setup()
    with jax.enable_x64(False):
        args = (jnp.asarray(x_raw), jnp.asarray(z0), jnp.asarray(v0))
        ref_value, ref = jax.value_and_grad(_loss(jm, jnp), argnums=(1, 4, 5))(
            jm.dynamics, jp["smp"], jp["dec"], *args)
    return jm, jp, tm, tp, x_raw, z0, v0, float(ref_value), ref


def _assert_grads(got_smp, got_z, got_v, ref, share):
    ref_smp, ref_z, ref_v = ref
    flat_ref = jax.tree_util.tree_leaves(ref_smp)
    flat_got = tree_leaves(got_smp)
    assert len(flat_ref) == len(flat_got)
    nonzero = 0
    for a, b in zip(flat_got + [got_z, got_v], flat_ref + [ref_z, ref_v]):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-6
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=share * scale)
        nonzero += int(float(np.abs(b).max()) > 0)
    assert nonzero > 10  # aux_enc, both nets, alpha, z and v all get a gradient


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_gradients_match_jax_grad_of_the_xla_path(grad_case, fused):
    """Gradients of the JAX parity test's loss (a forward and a backward
    trajectory and ``p_accept``) with respect to the sampler's params (both
    nets, alpha, the aux encoder through ``emb``) and to z and v, through
    ``DifferentiableFusedVae`` (on the CPU its hand-written VJP) and through
    the plain ``Dynamics`` (autograd, second order through the analytic
    energy gradient), against ``jax.grad`` of the JAX package's XLA path:
    the value to 1e-4 and each leaf to 3e-3 of its largest entry, the JAX
    test's own bars. The decoder's cotangent on the fused path is exactly
    zero."""
    _, _, tm, tp, x_raw, z0, v0, ref_value, ref = grad_case
    dyn = DifferentiableFusedVae(tm.dynamics) if fused else tm.dynamics
    value, grads, gz, gv = _torch_grads(tm, tp, dyn, x_raw, z0, v0)
    assert abs(value - ref_value) < 1e-4
    _assert_grads(grads["smp"], gz, gv, ref, 3e-3)
    assert all(g is None for g in tree_leaves(grads["enc"]))
    if fused:
        # the fused boundary detaches the decoder; p_accept's energy still sees it
        traj_only = _loss_without_p_accept(tm, tp, dyn, x_raw, z0, v0)
        assert all(g is None or not bool(g.any()) for g in traj_only)


def _loss_without_p_accept(tm, tp, dyn, x_raw, z0, v0):
    """Decoder gradients of the trajectories alone."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(tp)]
    p = tree_unflatten(tp, leaves)
    x = torch.tensor(x_raw)
    aux = {"raw": x, "emb": tm.aux_encoder.apply(p["smp"]["aux_enc"], x), "dec": p["dec"]}
    Z, V, ld = dyn.forward(p["smp"], torch.tensor(z0), torch.tensor(v0), aux=aux)
    Zb, Vb, ldb = dyn.backward(p["smp"], torch.tensor(z0), torch.tensor(v0), aux=aux)
    value = torch.mean(Z * Zb) + torch.mean(V + Vb) + torch.mean(ld - 2.0 * ldb)
    return torch.autograd.grad(value, tree_leaves(p["dec"]), allow_unused=True)


def test_gradients_match_the_jax_kernels_in_interpret_mode(grad_case):
    """The same gradients against the JAX package's own fused path, its two
    Pallas kernels run in interpret mode: 3e-3 of each leaf's largest entry."""
    jm, jp, tm, tp, x_raw, z0, v0, _, _ = grad_case
    with jax.enable_x64(False):
        jfd = JaxDifferentiableFusedVae(jm.dynamics, tile=32, interpret=True)
        ref = jax.grad(_loss(jm, jnp), argnums=(1, 4, 5))(
            jfd, jp["smp"], jp["dec"], jnp.asarray(x_raw), jnp.asarray(z0), jnp.asarray(v0))
    _, grads, gz, gv = _torch_grads(tm, tp, DifferentiableFusedVae(tm.dynamics), x_raw, z0, v0)
    _assert_grads(grads["smp"], gz, gv, ref, 3e-3)


def test_relu_margin_marks_the_chain_whose_vjp_is_discontinuous():
    """``relu_margins`` is, per chain, the smallest hidden pre-activation of
    the plain trajectory over the chain's largest of that layer. Moving one
    chain's embedding so that one unit of the first net application sits
    1e-4 of that layer's largest entry in the chain above or below zero brings that chain's
    margin under 2e-4 and leaves the others' as they were; across the kink
    that chain's cotangents change by whole terms (the unit's embedding
    cotangent is non-zero above and exactly zero below), and the other
    chains' do not change (1e-6 of each leaf's largest entry)."""
    _, _, tm, tp, x_raw, z0, v0 = _setup(n=9)
    inp = _kernel_inputs(tm, tp, x_raw)
    z, v = torch.tensor(z0).T.contiguous(), torch.tensor(v0).T.contiguous()
    gen = torch.Generator().manual_seed(4)
    dZ, dV = (torch.randn(z.shape, generator=gen) for _ in range(2))
    dld = torch.randn((1, z.shape[1]), generator=gen)
    base = fd.relu_margins(inp, z, v, False)
    assert base.shape == (9,) and bool((base > 0).all()) and bool((base < 1).all())

    seen: list = []
    fd._trajectory_step(inp, False, 0, z, v, seen)
    h = seen[0].detach()  # the first application's first layer, (H, N)
    unit, chain = 2, 3
    gap = 1e-4 * float(h[:, chain].abs().max())
    others = torch.arange(9) != chain
    demb = {}
    for sign in (1.0, -1.0):
        emb = inp.emb.detach().clone()
        emb[unit, chain] += sign * gap - h[unit, chain]
        moved = dataclasses.replace(inp, emb=emb)
        margin = fd.relu_margins(moved, z, v, False)
        assert float(margin[chain]) < 2e-4
        torch.testing.assert_close(margin[others], base[others], rtol=0, atol=0)
        demb[sign] = fv.vae_trajectory_vjp_plain(moved, z, v, dZ, dV, dld, False)[3]
    # T = 3 applications of the v-net's first step read this unit; only the
    # first is moved across zero
    assert float(demb[1.0][unit, chain]) != float(demb[-1.0][unit, chain])
    scale = float(demb[1.0].abs().max())
    assert float((demb[1.0] - demb[-1.0])[:, chain].abs().max()) > 1e-3 * scale
    torch.testing.assert_close(demb[1.0][:, others], demb[-1.0][:, others], rtol=0,
                               atol=1e-6 * scale)


def test_fused_dynamics_surface():
    _, _, tm, tp, x_raw, z0, v0 = _setup(n=5)
    dyn = DifferentiableFusedVae(tm.dynamics)
    assert dyn.hmc is False and dyn.energy is tm.dynamics.energy
    assert float(dyn.eps(tp["smp"])) == pytest.approx(0.1, rel=1e-6)
    bf16 = DifferentiableFusedVae(tm.dynamics, compute_dtype="bfloat16")
    assert bf16.hmc is False and bf16.energy is tm.dynamics.energy
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        DifferentiableFusedVae(tm.dynamics, compute_dtype="float16")
    hmc = tvae.VaeModel.build(tvae.VaeConfig(**SMALL, hmc=True))
    with pytest.raises(ValueError, match="hmc=False"):
        DifferentiableFusedVae(hmc.dynamics)
    inp = _kernel_inputs(tm, tp, x_raw)
    zT = torch.tensor(z0).T.contiguous()
    with pytest.raises(ValueError, match="shape"):
        fv.vae_trajectory(inp, torch.tensor(x_raw).T.contiguous(), zT, zT[:, :3].contiguous(),
                          False)
    with pytest.raises(TypeError, match="float32"):
        fv.vae_trajectory(inp, torch.tensor(x_raw).T.contiguous(), zT.double(), zT, False)


def test_fused_train_matches_plain_training():
    """20 steps with ``fused_train=True`` reproduce the plain autograd path's
    ELBO, sampler-loss and log-probability histories (same seed, generator
    and batches) within rtol 2e-3, atol 1e-2, the JAX package's bar for
    fused against XLA training; and eps trains."""
    ds = tdata.synthetic_mnist(n_train=64, n_test=16)
    hists, eps = {}, {}
    for fused in (False, True):
        cfg = tvae.VaeConfig(**SMALL, epochs=10, batch_size=32, mh_steps=2, seed=3,
                             fused_train=fused)
        model = tvae.VaeModel.build(cfg)
        state = tvae.init_state(model, 2, device="cpu")
        step = tvae.make_train_step(model, 2)
        rng = np.random.default_rng(0)
        rows = []
        for _ in range(cfg.epochs):
            x = tdata.binarize_and_shuffle(rng, ds.train)
            for t in range(2):
                state, m = step(state, torch.tensor(x[32 * t: 32 * (t + 1)]))
                rows.append([float(m[k]) for k in ("elbo", "sampler_loss", "log_prob")])
        hists[fused] = np.asarray(rows)
        eps[fused] = float(torch.exp(state.params["smp"]["alpha"]))
    assert hists[True].shape == (20, 3) and np.isfinite(hists[True]).all()
    np.testing.assert_allclose(hists[True], hists[False], rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(eps[True], eps[False], rtol=1e-3)
    assert abs(eps[True] - 0.1) > 2e-5
    assert hists[True][-1, 0] < hists[True][0, 0]  # the ELBO falls
