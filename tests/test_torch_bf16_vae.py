"""bfloat16 operands with float32 accumulation in the VAE kernels' plain
versions on the CPU (``compute_dtype="bfloat16"``), against the JAX
package's bf16 Pallas kernels in interpret mode on the same numpy inputs and
converted params: the training trajectory and its gradients
(``DifferentiableFusedVae``), the sampler on the zero-bit draws and AIS.

The bars against JAX are those of its own ``tests/test_precision.py``
(2e-2 on trajectories, 5e-2 on the sampler): bf16 rounding sites differ
slightly between two programs, and a value that lands within float32
rounding of a bf16 tie rounds to neighbours 2^-8 apart. Between the port's
own routes the bars are float32's (or float64's where autograd is the
reference), because both round at the same sites."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_vae_util import C0, SMALL, build_pair, inputs

from l2hmc_tpu.ops import DifferentiableFusedVae as JaxDifferentiableFusedVae
from l2hmc_tpu.ops import FusedVaeAis as JaxFusedVaeAis
from l2hmc_tpu.ops import FusedVaeSampler as JaxFusedVaeSampler
from l2hmc_tpu_torch.apps import data as tdata
from l2hmc_tpu_torch.apps import vae as tvae
from l2hmc_tpu_torch.ops import DifferentiableFusedVae, FusedVaeAis, FusedVaeSampler
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops import fused_vae as fv
from l2hmc_tpu_torch.ops import operands
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten

N, D = 32, SMALL["latent_dim"]
BF16_TOL = 2e-2  # JAX tests/test_precision.py:93-94: parity at bf16 resolution
SAMPLER_TOL = 5e-2  # JAX tests/test_precision.py:131
# Tighter bars, set from this file's readings, each of a leaf's or an
# output's largest entry: the trajectory (2.5e-4 at most, one flipped
# rounding in V backward; the float32 trajectory reads 1.8e-3-3.2e-3) and
# the gradient leaves that JAX does not round per tile, all but the
# products' weights (1.4e-3 at most, on v; the float32 VJP reads 3.0e-2 and
# 4.4e-2 on z and v). Each is checked against its float32 control too.
TRAJ_TIGHT = 1e-3
GRAD_TIGHT = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n=N, seed=1):
    jm, jp, tm, tp = build_pair()
    x_raw, z0 = inputs(n, D, seed)
    v0 = np.random.default_rng(seed + 100).standard_normal((n, D)).astype(np.float32)
    return jm, jp, tm, tp, x_raw, z0, v0


def _kernel_inputs(tm, tp, x_raw, cd="bfloat16"):
    xr = torch.tensor(x_raw)
    emb = tm.aux_encoder.apply(tp["smp"]["aux_enc"], xr)
    return fv.prepare_vae(tm.dynamics, tp["smp"], tp["dec"], xr.T.contiguous(),
                          emb.T.contiguous(), compute_dtype=cd)


def _jaux(jm, jp, x_raw):
    jemb = jm.aux_encoder.apply(jp["smp"]["aux_enc"], jnp.asarray(x_raw))
    return {"raw": jnp.asarray(x_raw), "emb": jemb, "dec": jp["dec"]}


def test_lower_and_its_products_round_where_jax_does():
    """``lower`` is round-to-nearest-even to bfloat16 and back; ``dot``
    multiplies lowered operands and sums in the working dtype (not in
    bfloat16); its autograd rounds the activation's cotangent and not the
    weight's; ``dot_ct`` is that activation cotangent. With ``cd`` None all
    are the float32 operations themselves."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -9])
    assert operands.lower(x, torch.bfloat16).tolist() == [1.0, 1.0, 1.0 + 2 ** -6, 1.0]
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal((5, 300)), dtype=torch.float64, requires_grad=True)
    a = torch.tensor(rng.standard_normal((300, 3)), dtype=torch.float64, requires_grad=True)
    wl, al = (operands.lower(t.detach(), torch.bfloat16) for t in (w, a))
    y = operands.dot(w, a, torch.bfloat16)
    assert y.dtype == torch.float64
    torch.testing.assert_close(y, wl @ al, rtol=0, atol=0)
    assert not torch.equal(y, operands.lower(y, torch.bfloat16))  # the sum is not rounded
    g = torch.tensor(rng.standard_normal((5, 3)))
    gw, ga = torch.autograd.grad(y, (w, a), g)
    torch.testing.assert_close(gw, g @ al.T, rtol=0, atol=0)
    torch.testing.assert_close(ga, operands.lower(wl.T @ g, torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(operands.dot_ct(w.T.detach(), g, torch.bfloat16), ga,
                               rtol=0, atol=0)
    assert operands.lower(x, None) is x
    torch.testing.assert_close(operands.dot(w, a, None), w @ a, rtol=0, atol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_plain_bf16_trajectory_matches_jax_bf16_kernel(reverse):
    """``vae_trajectory_plain`` with bf16 operands against the JAX package's
    bf16 ``DifferentiableFusedVae`` (its Pallas kernel in interpret mode)
    on the same inputs and converted params: Z, V and logdet within 2e-2,
    and within 1e-3 of each output's largest entry, a bar the port's
    float32 result misses (the operands were really lowered)."""
    jm, jp, tm, tp, x_raw, z0, v0 = _setup()
    with jax.enable_x64(False):
        jfd = JaxDifferentiableFusedVae(jm.dynamics, tile=N, interpret=True,
                                        compute_dtype="bfloat16")
        fn = jfd.backward if reverse else jfd.forward
        ref = fn(jp["smp"], jnp.asarray(z0), jnp.asarray(v0), aux=_jaux(jm, jp, x_raw))
    zT, vT = torch.tensor(z0).T.contiguous(), torch.tensor(v0).T.contiguous()
    got = fv.vae_trajectory_plain(_kernel_inputs(tm, tp, x_raw), zT, vT, reverse)
    f32 = fv.vae_trajectory_plain(_kernel_inputs(tm, tp, x_raw, None), zT, vT, reverse)
    gap_jax = gap_f32 = 0.0
    for a, b, want in zip(got, f32, ref):
        want = np.asarray(want)
        a, b = (t.detach().T.reshape(want.shape).numpy() for t in (a, b))
        np.testing.assert_allclose(a, want, rtol=0, atol=BF16_TOL)
        scale = float(np.abs(want).max())
        gap_jax = max(gap_jax, float(np.abs(a - want).max()) / scale)
        gap_f32 = max(gap_f32, float(np.abs(b - want).max()) / scale)
    assert gap_jax <= TRAJ_TIGHT < gap_f32
    assert float((got[0] - zT).abs().max()) > 0.1  # the chains moved


def test_bf16_trajectory_is_exactly_invertible():
    """The load-bearing property (JAX ``test_bf16_dynamics_exact_invertibility``):
    the backward map recomputes the same bf16 net values, so forward then
    backward returns to the start within 1e-5 and the logdets cancel within
    1e-5."""
    _, _, tm, tp, x_raw, z0, v0 = _setup()
    inp = _kernel_inputs(tm, tp, x_raw)
    zT, vT = torch.tensor(z0).T.contiguous(), torch.tensor(v0).T.contiguous()
    Z, V, ld = fv.vae_trajectory_plain(inp, zT, vT, False)
    z2, v2, ld2 = fv.vae_trajectory_plain(inp, Z, V, True)
    torch.testing.assert_close(z2, zT, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v2, vT, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ld + ld2, torch.zeros_like(ld), rtol=0, atol=1e-5)
    assert float((Z - zT).abs().max()) > 0.1


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_plain_bf16_vjp_matches_autograd_in_float64(reverse):
    """``vae_trajectory_vjp_plain`` with bf16 operands (activation
    cotangents rounded through ``dot_ct``, weight cotangents over lowered
    activations) against autograd of the bf16 ``vae_trajectory_plain``
    through ``operands.dot`` in float64, where the rounding to bfloat16 and
    back leaves float64 sums that almost never cross a rounding boundary:
    every cotangent (both nets' 13 arrays, eps, emb, z, v) within 1e-6 of
    its largest entry."""
    _, _, tm, tp, x_raw, z0, v0 = _setup(n=7)
    inp = _kernel_inputs(tm, tp, x_raw)
    f64 = lambda t: t.detach().double()  # noqa: E731
    gen = torch.Generator().manual_seed(3)
    dec = [0.3 * f64(a) for a in inp.consts]
    xr = f64(torch.tensor(x_raw).T)
    cd = torch.bfloat16
    energy, grad_energy = fv._vae_decoder_closures(dec, xr, cd)
    inp64 = dataclasses.replace(
        inp, eps=f64(inp.eps), masks=f64(inp.masks), consts=dec,
        xnet_w=[f64(a) + 0.05 * torch.randn(a.shape, generator=gen, dtype=torch.float64)
                for a in inp.xnet_w],
        vnet_w=[f64(a) + 0.05 * torch.randn(a.shape, generator=gen, dtype=torch.float64)
                for a in inp.vnet_w],
        energy=energy, grad_energy=grad_energy, grad_vjp=fv.build_grad_vjp(dec, xr, cd),
        emb=f64(inp.emb))
    z, v = f64(torch.tensor(z0).T), f64(torch.tensor(v0).T)
    dZ, dV = (torch.randn(z.shape, generator=gen, dtype=torch.float64) for _ in range(2))
    dld = torch.randn((1, z.shape[1]), generator=gen, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True)
              for t in (inp64.eps, inp64.emb, z, v, *inp64.xnet_w, *inp64.vnet_w)]
    traced = dataclasses.replace(inp64, eps=leaves[0], emb=leaves[1], xnet_w=leaves[4:17],
                                 vnet_w=leaves[17:])
    Z, V, ld = fv.vae_trajectory_plain(traced, leaves[2], leaves[3], reverse)
    want = torch.autograd.grad((Z * dZ).sum() + (V * dV).sum() + (ld * dld).sum(), leaves)
    gx, gv, deps, demb, dz, dv = fv.vae_trajectory_vjp_plain(inp64, z, v, dZ, dV, dld, reverse)
    f32 = fv.vae_trajectory_vjp_plain(dataclasses.replace(
        inp64, cd=None, grad_energy=fv._vae_decoder_closures(dec, xr)[1],
        grad_vjp=fv.build_grad_vjp(dec, xr)), z, v, dZ, dV, dld, reverse)
    lowered = 0.0
    for got, ref, plain in zip((deps, demb, dz, dv, *gx, *gv), want,
                               (f32[2], f32[3], f32[4], f32[5], *f32[0], *f32[1])):
        scale = float(ref.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * scale)
        lowered = max(lowered, float((got - plain).abs().max()) / scale)
    assert lowered > 1e-4  # bf16 operands, not float32's


def _loss(m, xp):
    """The JAX package's gradient-parity loss (tests/test_fused_dynamics.py)
    in either framework."""
    def loss(d, smp, dec, x_raw, z0, v0):
        emb = m.aux_encoder.apply(smp["aux_enc"], x_raw)
        aux = {"raw": x_raw, "emb": emb, "dec": dec}
        Z, V, ld = d.forward(smp, z0, v0, aux=aux)
        Zb, Vb, ldb = d.backward(smp, z0, v0, aux=aux)
        return (xp.mean(Z * Zb) + xp.mean(V + Vb) + xp.mean(ld - 2.0 * ldb)
                + xp.mean(d.p_accept(smp, z0, v0, Z, V, ld, aux=aux)))
    return loss


def test_bf16_gradients_match_the_jax_bf16_kernels_in_interpret_mode():
    """Gradients of the parity loss through the port's bf16
    ``DifferentiableFusedVae`` (on the CPU its hand-written bf16 VJP)
    against ``jax.grad`` through the JAX package's bf16 Pallas kernels in
    interpret mode, tile = batch (so that JAX rounds each weight cotangent
    once per product and substep): each leaf of the sampler's params and z,
    v within 2e-2 of the leaf's largest entry (the float32 bar of
    test_torch_fused_vae_train.py is 3e-3; measured here ~2e-3, from the
    weight cotangents that JAX rounds to bfloat16 and the port keeps in
    float32). The leaves JAX does not round per tile (all but the products'
    weights) within 5e-3 of their largest entry; the port's float32
    gradients miss that bar on z and v, whose cotangents bf16 rounds."""
    jm, jp, tm, tp, x_raw, z0, v0 = _setup()
    with jax.enable_x64(False):
        jfd = JaxDifferentiableFusedVae(jm.dynamics, tile=N, interpret=True,
                                        compute_dtype="bfloat16")
        ref_smp, ref_z, ref_v = jax.grad(_loss(jm, jnp), argnums=(1, 4, 5))(
            jfd, jp["smp"], jp["dec"], jnp.asarray(x_raw), jnp.asarray(z0), jnp.asarray(v0))

    def port_grads(cd):
        leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(tp)]
        p = tree_unflatten(tp, leaves)
        z, v = torch.tensor(z0, requires_grad=True), torch.tensor(v0, requires_grad=True)
        dyn = DifferentiableFusedVae(tm.dynamics, compute_dtype=cd)
        value = _loss(tm, torch)(dyn, p["smp"], p["dec"], torch.tensor(x_raw), z, v)
        grads = torch.autograd.grad(value, leaves + [z, v], allow_unused=True)
        return tree_leaves(tree_unflatten(tp, list(grads[:-2]))["smp"]) + list(grads[-2:])

    got, got32 = port_grads("bfloat16"), port_grads(None)
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(ref_smp)] + ["z", "v"]
    flat_ref = jax.tree_util.tree_leaves(ref_smp) + [ref_z, ref_v]
    assert len(got) == len(flat_ref)
    nonzero = tight = 0
    for path, a, a32, b in zip(paths, got, got32, flat_ref):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-6
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=BF16_TOL * scale)
        nonzero += int(float(np.abs(b).max()) > 0)
        if not path.endswith("['w']"):  # not a product's weight
            tight += 1
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_TIGHT * scale)
        if path in ("z", "v"):
            assert float(np.abs(a32.numpy() - b).max()) > GRAD_TIGHT * scale
    assert nonzero > 10 and tight > 10


def _zero_bit_draws(n, d):
    def draws(step, op=0):
        return torch.full((d, n), C0), torch.zeros(n), torch.zeros(n)
    return draws


def test_plain_bf16_sampler_matches_jax_bf16_kernel():
    """The bf16 plain sampler against the JAX package's bf16
    ``FusedVaeSampler`` on the zero-bit draws (momentum C0 everywhere,
    forward, accept always), with the trace: every recorded state within
    5e-2 (JAX's own bar for its bf16 sampler against float32; measured
    ~1e-6) and the same acceptance; ``FusedVaeSampler(compute_dtype="bfloat16")`` on CPU
    tensors runs the same plain version."""
    jm, jp, tm, tp = build_pair(latent_dim=6, leapfrogs=2, enc_hidden=16,
                                sampler_size1=8, sampler_size2=8)
    n, K = 16, 3
    x_raw, z0 = inputs(n, 6)
    jemb = jm.aux_encoder.apply(jp["smp"]["aux_enc"], jnp.asarray(x_raw))
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        zr, accr, trr = JaxFusedVaeSampler(jm.dynamics, tile=n, compute_dtype="bfloat16").run(
            jp["smp"], jp["dec"], jnp.asarray(x_raw), jemb, jnp.asarray(z0), seed=5,
            n_mh_steps=K, collect_trace=True)
    xr = torch.tensor(x_raw)
    emb = tm.aux_encoder.apply(tp["smp"]["aux_enc"], xr)
    inp = fv.prepare_vae(tm.dynamics, tp["smp"], tp["dec"], xr.T.contiguous(),
                         emb.T.contiguous(), compute_dtype="bfloat16")
    z, acc, trace = fv.vae_chain_plain(inp, torch.tensor(z0).T.contiguous(), seed=5,
                                       n_mh_steps=K, collect_trace=True,
                                       draws=_zero_bit_draws(n, 6))
    np.testing.assert_array_equal(acc.numpy()[0], np.asarray(accr))
    np.testing.assert_allclose(trace.permute(0, 2, 1).numpy(), np.asarray(trr),
                               rtol=0, atol=SAMPLER_TOL)
    assert float(np.abs(np.asarray(zr) - z0).max()) > 0.1
    zs, accs = FusedVaeSampler(tm.dynamics, compute_dtype="bfloat16").run(
        tp["smp"], tp["dec"], xr, emb, torch.tensor(z0), seed=5, n_mh_steps=2)
    assert zs.shape == (n, 6) and bool(torch.isfinite(zs).all())
    assert not any(fd.LAUNCHES.values())


def test_plain_bf16_ais_matches_jax_bf16_kernel():
    """The bf16 plain AIS against the JAX package's bf16 ``FusedVaeAis`` on
    the zero-bit draws: log w within 2e-2 of its largest magnitude (values
    near 1e3 summed over 5 anneal steps, each step's energies from
    bf16-operand logits; measured ~1e-7 of it) and acceptance within 2e-2;
    the port's bf16 log w differs from its float32 one."""
    jm, jp, tm, tp = build_pair(latent_dim=6, leapfrogs=2, enc_hidden=16,
                                sampler_size1=8, sampler_size2=8)
    n, K, L, eps = 16, 5, 3, 0.07
    x_raw, z0 = inputs(n, 6)
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        wr, accr = JaxFusedVaeAis(latent_dim=6, tile=n, compute_dtype="bfloat16").run(
            jp["dec"], jnp.asarray(x_raw), jnp.asarray(z0), seed=5, anneal_steps=K,
            step_size=eps, leapfrogs=L)
    args = (fv.decoder_arrays(tp["dec"]), torch.tensor(x_raw).T.contiguous(),
            torch.tensor(z0).T.contiguous())
    kw = dict(seed=5, anneal_steps=K, step_size=eps, leapfrogs=L,
              draws=lambda step: (torch.full((6, n), C0), torch.zeros(n)))
    w, acc = fv.vae_ais_plain(*args, **kw, compute_dtype="bfloat16")
    w32, _ = fv.vae_ais_plain(*args, **kw)
    scale = float(np.abs(np.asarray(wr)).max())
    assert scale > 1.0
    np.testing.assert_allclose(w.numpy()[0], np.asarray(wr), rtol=0, atol=BF16_TOL * scale)
    np.testing.assert_allclose(acc.numpy()[0], np.asarray(accr), rtol=0, atol=BF16_TOL)
    assert float((w - w32).abs().max()) > 1e-4
    wa, _ = FusedVaeAis(latent_dim=6, compute_dtype="bfloat16").run(
        tp["dec"], torch.tensor(x_raw), torch.tensor(z0), seed=5, anneal_steps=K,
        step_size=eps, leapfrogs=L)
    assert wa.shape == (n,) and bool(torch.isfinite(wa).all())


def _train_history(**kw):
    ds = tdata.synthetic_mnist(n_train=64, n_test=16)
    cfg = tvae.VaeConfig(**SMALL, epochs=3, batch_size=32, mh_steps=2, seed=3, **kw)
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
    return np.asarray(rows)


def test_bf16_fused_training_tracks_float32():
    """Six steps of ``fused_train=True, fused_compute_dtype="bfloat16"``
    (on the CPU the plain bf16 trajectories and their hand-written VJP):
    finite metrics, and each step's ELBO within 2% of the float32 fused run
    from the same seed and batches."""
    bf16 = _train_history(fused_train=True, fused_compute_dtype="bfloat16")
    f32 = _train_history(fused_train=True)
    assert bf16.shape == (6, 3) and np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16[:, 0], f32[:, 0], rtol=2e-2)
    assert not np.array_equal(bf16, f32)


@pytest.mark.parametrize("kw", [{}, {"hmc": True, "fused_train": True}],
                         ids=["plain", "hmc"])
def test_bf16_is_read_only_with_fused_train_and_nets(kw):
    """As in the JAX package (``make_train_step`` reads
    ``fused_compute_dtype`` only with ``fused_train`` and not ``hmc``), the
    plain autograd route and HMC mode ignore the dtype: their histories
    equal the float32 ones bit for bit."""
    np.testing.assert_array_equal(_train_history(**kw, fused_compute_dtype="bfloat16"),
                                  _train_history(**kw))
