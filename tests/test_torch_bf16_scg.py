"""bfloat16 operands (``compute_dtype="bfloat16"``) on the SCG and lattice
route against the JAX package on the CPU: the plain dense and conv nets,
forward and ``jax.grad``; the bf16 ``Dynamics`` and its exact inverse;
kernels 1 and 3's plain versions with ``KernelInputs.cd`` against the JAX
Pallas kernels' bf16 forms in interpret mode; a bf16 training step from
converted params; fused bf16 training; and ``differentiable_fused`` in bf16
(forward bf16, backward the float32 VJP) against JAX's custom VJP.

Each route is held against its own JAX twin (the kernels' rounding program
folds the time embedding and the input scale before it rounds; the nets'
rounds the time features and the scaled input). Every tight bar below is
one the float32 version misses on the same inputs (asserted beside it).
The figures quoted are this file's readings on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.nets import core as jcore
from l2hmc_tpu.nets import lattice as jlattice
from l2hmc_tpu.nets import stq as jstq
from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.nets import core, lattice, stq
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops.philox import box_muller
from l2hmc_tpu_torch.train import (
    ScgConfig,
    StepDraws,
    TrainState,
    build_dynamics,
    make_optimizer,
    make_train_step,
    train,
)
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten

BF = "bfloat16"


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rounded(a):
    """``a`` rounded to bfloat16 in JAX, as a float32 array."""
    return a.astype(jnp.bfloat16).astype(jnp.float32)


def _max_err(got, ref):
    """Largest absolute difference over paired leaves (tensors / arrays)."""
    return max(float(np.abs(np.asarray(g, np.float64) - np.asarray(r, np.float64)).max())
               for g, r in zip(got, ref))


def _torch_grads(apply, params, inputs, cot):
    """Output and the gradients of sum(output * cot) w.r.t. the params'
    leaves and the inputs, through the port's autograd."""
    leaves = [l.clone().requires_grad_(True) for l in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = apply(p, *xs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cot))
    grads = torch.autograd.grad(loss, leaves + xs)
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _jax_grads(apply, params, inputs, cot):
    """The same through ``jax.grad``: leaves in ``tree_leaves`` order (the
    port's tree has the JAX tree's structure leaf for leaf)."""
    def loss(p, *xs):
        out = apply(p, *xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    out = apply(params, *inputs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    g = jax.grad(loss, argnums=tuple(range(1 + len(inputs))))(params, *inputs)
    return ([np.asarray(o) for o in outs],
            [np.asarray(a) for a in jax.tree_util.tree_leaves(g[0])] + [np.asarray(a)
                                                                       for a in g[1:]])


# -- the plain nets -------------------------------------------------------------------


def test_linear_bf16_matches_jax():
    """``nets.core.linear`` in bf16 against the JAX layer: output and
    ``jax.grad`` w.r.t. w, b and x within 1e-5 (read: 0 for the output, w
    and x, whose cotangents JAX rounds per product, as the port's autograd
    does; 9.5e-7 for b, a float32 sum); the float32 layer misses both by
    9.6e-3 and 4.8e-2."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    p = {"w": (0.5 * rng.standard_normal((8, 5))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(5)).astype(np.float32)}
    cot = [rng.standard_normal((64, 5)).astype(np.float32)]
    jm = jcore.linear(8, 5, compute_dtype=BF)
    jout, jg = _jax_grads(jm.apply, jax.tree_util.tree_map(jnp.asarray, p), [jnp.asarray(x)],
                          cot)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    for cd, holds in ((BF, True), (None, False)):
        out, g = _torch_grads(core.linear(8, 5, compute_dtype=cd).apply, tp, [x], cot)
        assert (_max_err(out, jout) <= 1e-5 and _max_err(g, jg) <= 1e-5) == holds, cd
    assert tp["w"].dtype == torch.float32  # params stay float32


def _stq_inputs(dim, n, seed):
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal((n, dim)).astype(np.float32) for _ in range(2))
    t = np.stack([np.cos(np.linspace(0, 3, n)), np.sin(np.linspace(0, 3, n))], 1)
    cot = [rng.standard_normal((n, dim)).astype(np.float32) for _ in range(3)]
    return [a, b, t.astype(np.float32)], cot


def test_stq_net_bf16_matches_jax():
    """The S/T/Q net (dim 3, hidden 16) in bf16, weights lifted by 0.05 so
    the heads are not ~0: S, T, Q and the gradients of a random projection
    w.r.t. every weight and both inputs within 1e-5 of the largest entry
    (read: 1.4e-7 and 2.5e-7); the float32 net misses both (3.6e-3 and
    0.14)."""
    jm = jstq.stq_net(3, 16, 2.0, compute_dtype=BF)
    jp = jax.tree_util.tree_map(lambda a: a + 0.05, jm.init(jax.random.key(0)))
    inputs, cot = _stq_inputs(3, 96, 1)

    def japply(p, a, b, t):
        return jm.apply(p, (a, b, t, None))

    jout, jg = _jax_grads(japply, jp, [jnp.asarray(v) for v in inputs], cot)
    tp = params_from_jax(_np(jp), device="cpu")
    out_scale = max(float(np.abs(o).max()) for o in jout)
    g_scale = max(float(np.abs(g).max()) for g in jg)
    for cd, holds in ((BF, True), (None, False)):
        tm = stq.stq_net(3, 16, 2.0, compute_dtype=cd)
        out, g = _torch_grads(lambda p, a, b, t: tm.apply(p, (a, b, t, None)), tp, inputs, cot)
        ok = (_max_err(out, jout) <= 1e-5 * out_scale and _max_err(g, jg) <= 1e-5 * g_scale)
        assert ok == holds, cd


def test_conv2d_bf16_matches_jax_on_rounded_operands():
    """``nets.lattice.conv2d`` in bf16 rounds the input and the kernel and
    sums in float32, as JAX's ``precision=DEFAULT`` does on a TPU. The JAX
    CPU conv is float32, so JAX gets operands rounded by hand: output and
    gradients (w, b, x; JAX's VJP of the hand rounding rounds the
    cotangents as the port's autograd does): the output within 1e-5 of its
    largest entry (read 0), each gradient within 1e-3 of its largest (read
    1.3e-4: one x cotangent of 288 a bfloat16 step apart, its float32 sum
    taken in another order); the unrounded JAX conv (what the CPU computes)
    is missed by more than 1e-3, and so is the float32 port."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6, 6, 2)).astype(np.float32)
    p = {"w": (0.5 * rng.standard_normal((3, 3, 2, 3))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(3)).astype(np.float32)}
    cot = [rng.standard_normal((4, 6, 6, 3)).astype(np.float32)]
    jm = jlattice.conv2d(2, 3, compute_dtype=BF)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    hand, hand_g = _jax_grads(lambda q, xx: jm.apply({"w": _rounded(q["w"]), "b": q["b"]},
                                                     _rounded(xx)), jp, [jnp.asarray(x)], cot)
    unrounded, _ = _jax_grads(jm.apply, jp, [jnp.asarray(x)], cot)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    out, g = _torch_grads(lattice.conv2d(2, 3, compute_dtype=BF).apply, tp, [x], cot)
    scale = float(np.abs(hand[0]).max())
    assert _max_err(out, hand) <= 1e-5 * scale
    assert all(float(np.abs(a - b).max()) <= 1e-3 * float(np.abs(b).max())
               for a, b in zip(g, hand_g))
    assert _max_err(out, unrounded) > 1e-3 * scale
    out32, _ = _torch_grads(lattice.conv2d(2, 3).apply, tp, [x], cot)
    assert _max_err(out32, hand) > 1e-3 * scale


@pytest.fixture
def rounded_jax_conv(monkeypatch):
    """The JAX package's ``conv2d`` fed operands rounded by hand (input and
    kernel, ``x.astype(bf16).astype(f32)``) where its ``compute_dtype`` is
    bfloat16, as in ``test_conv2d_bf16_matches_jax_on_rounded_operands``: a
    TPU's one-pass bf16 product on the CPU, whose DEFAULT precision is
    float32. Returns the unpatched factory."""
    conv2d = jlattice.conv2d

    def rounded(*args, compute_dtype=None, **kw):
        m = conv2d(*args, compute_dtype=compute_dtype, **kw)
        if compute_dtype is None:
            return m
        return jcore.Module(m.init, lambda p, x: m.apply(
            {"w": _rounded(p["w"]), "b": p["b"]}, _rounded(x)))

    monkeypatch.setattr(jlattice, "conv2d", rounded)
    return conv2d


def test_lattice_stq_net_bf16_matches_jax(rounded_jax_conv, monkeypatch):
    """The conv S/T/Q net (L = 4, 8 channels, depth 2) in bf16 against the
    JAX net built on hand-rounded convolutions (``rounded_jax_conv``); the
    time embedding stays float32 in both. Outputs within 1e-5 of their
    largest entry (read 9.7e-8), gradients within 1e-3 of each leaf's
    largest (read 1.6e-4: a float32 sum in another order puts a cotangent a
    bfloat16 step away); the float32 port misses them (1.6e-3, 3.1e-2), and
    the bf16 port misses the unrounded JAX net (the CPU's float32
    convolutions) by more than 1e-3 (1.6e-3)."""
    L, dim, n = 4, 16, 24
    jm = jlattice.lattice_stq_net(L, 8, 2.0, depth=2, compute_dtype=BF)
    jp = jax.tree_util.tree_map(lambda a: a + 0.02, jm.init(jax.random.key(3)))
    inputs, cot = _stq_inputs(dim, n, 4)

    def japply(p, a, b, t):
        return jm.apply(p, (a, b, t, None))

    jout, jg = _jax_grads(japply, jp, [jnp.asarray(v) for v in inputs], cot)
    tp = params_from_jax(_np(jp), device="cpu")
    out_scale = max(float(np.abs(o).max()) for o in jout)
    outs = {}
    for cd, holds in ((BF, True), (None, False)):
        tm = lattice.lattice_stq_net(L, 8, 2.0, depth=2, compute_dtype=cd)
        outs[cd], g = _torch_grads(lambda p, a, b, t: tm.apply(p, (a, b, t, None)), tp, inputs,
                                   cot)
        ok = _max_err(outs[cd], jout) <= 1e-5 * out_scale and all(
            float(np.abs(a - b).max()) <= 1e-3 * float(np.abs(b).max()) for a, b in zip(g, jg))
        assert ok == holds, cd
    monkeypatch.setattr(jlattice, "conv2d", rounded_jax_conv)
    junrounded = jlattice.lattice_stq_net(L, 8, 2.0, depth=2, compute_dtype=BF)
    jout32, _ = _jax_grads(lambda p, a, b, t: junrounded.apply(p, (a, b, t, None)), jp,
                           [jnp.asarray(v) for v in inputs], cot)
    assert _max_err(outs[BF], jout32) > 1e-3 * out_scale


def test_bf16_dynamics_matches_jax_and_inverts():
    """``ScgConfig(compute_dtype="bfloat16")``'s dynamics (T = 5, 64 chains)
    against the JAX package's from converted params, both directions, within
    1e-4 (read 3.8e-6; the float32 dynamics miss it), and exactly
    invertible as JAX's test holds it (tests/test_precision.py:44-71):
    forward then backward back to x, v and logdets cancelling, at 1e-5.
    Read: 2.3e-7 of the outputs' scale in bf16, 1.5e-3 for float32."""
    cfg = dict(n_chains=64, T=5, compute_dtype=BF)
    jd, _ = jax_build_dynamics(JaxScgConfig(**cfg))
    td, _ = build_dynamics(ScgConfig(**cfg))
    td32, _ = build_dynamics(ScgConfig(n_chains=64, T=5))
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    tp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(5)
    x, v = (rng.standard_normal((64, 2)).astype(np.float32) for _ in range(2))
    for way in ("forward", "backward"):
        ref = getattr(jd, way)(jp, jnp.asarray(x), jnp.asarray(v))
        assert _max_err(getattr(td, way)(tp, torch.tensor(x), torch.tensor(v)), ref) <= 1e-4
        assert _max_err(getattr(td32, way)(tp, torch.tensor(x), torch.tensor(v)), ref) > 1e-4
    X, V, ld = td.forward(tp, torch.tensor(x), torch.tensor(v))
    x2, v2, ld2 = td.backward(tp, X, V)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v2.numpy(), v, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((ld + ld2).numpy(), 0.0, atol=1e-5)


# -- kernels 1 and 3: the plain versions against the JAX kernels ----------------------

N = 128
# name -> (JAX target, port target, dims, hidden, T, eps): SCG (the lane
# groups' ScgLanes widths), the easy rough well and a 4 x 4 phi^4 lattice
SPECS = {
    "scg": (jtargets.scg_gaussian, targets.scg_gaussian, 2, 10, 4, 0.1),
    "rough_well_easy": (lambda: jtargets.RoughWell(dim=10, eps=0.1, easy=True),
                        lambda: targets.RoughWell(dim=10, eps=0.1, easy=True), 10, 20, 3, 0.05),
    "phi4": (lambda: jtargets.Phi4Lattice(L=4, m2=-1.0, lam=0.5),
             lambda: targets.Phi4Lattice(L=4, m2=-1.0, lam=0.5), 16, 8, 3, 0.1),
}


def _spec_setup(name, lift=0.03):
    make_j, make_t, dim, hidden, T, eps = SPECS[name]
    jt, tt = make_j(), make_t()
    kw = dict(dim=dim, n_chains=N, T=T, hidden=hidden)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + lift, jp[net])
    jp = _np(jp)
    rng = np.random.default_rng(1)
    x, v = (rng.standard_normal((N, dim)).astype(np.float32) for _ in range(2))
    return jt, tt, jd, td, jp, params_from_jax(jp, device="cpu"), x, v


@pytest.mark.parametrize("name", list(SPECS))
def test_plain_trajectory_bf16_matches_jax_kernel(name):
    """``FusedDynamics(compute_dtype="bfloat16")``'s plain version (CPU
    tensors) against the JAX trajectory kernel with ``compute_dtype``
    bfloat16 in interpret mode, both directions: within 3e-4 of each
    output's largest entry (read: 1.3e-7 to 2.4e-7, and 9.7e-5 on the rough
    well forward, where one hidden unit rounds a bfloat16 step apart); the
    float32 version misses it (1.0e-3 to 3.3e-3)."""
    jt, tt, jd, td, jp, tp, x, v = _spec_setup(name)
    jfused = dataclasses.replace(jfd.fused_for_target(jd, jt, tile=N, interpret=True),
                                 compute_dtype=BF)
    for way in ("forward", "backward"):
        ref = getattr(jfused, way)(jp, jnp.asarray(x), jnp.asarray(v))
        scale = [float(np.abs(np.asarray(r)).max()) for r in ref]
        for cd, holds in ((BF, True), (None, False)):
            fd.reset_launch_counts()
            got = getattr(fd.fused_for_target(td, tt, compute_dtype=cd), way)(
                tp, torch.tensor(x), torch.tensor(v))
            assert not any(fd.LAUNCHES.values())  # CPU tensors take the plain version
            ok = all(float(np.abs(g.numpy() - np.asarray(r)).max()) <= 3e-4 * s
                     for g, r, s in zip(got, ref, scale))
            assert ok == holds, (way, cd)


def _zero_bit_draws(n, d):
    """The draws of the Pallas interpreter's zero PRNG bits (as
    tests/test_torch_fused_dynamics.py's): v = sqrt(-2 ln 1e-7) in every
    dimension, direction forward, accept always."""
    zero = torch.zeros((d, n), dtype=torch.int64)
    u = torch.zeros(n)
    return lambda step: (box_muller(zero, zero), u, u)


@pytest.mark.parametrize("name", ["scg", "phi4"])
def test_plain_chain_bf16_matches_jax_kernel_on_zero_bits(name):
    """``chain_plain`` with ``KernelInputs.cd`` bfloat16 (``prepare(...,
    compute_dtype=...)``) on the zero-bit schedule against the JAX chain
    kernel built with ``compute_dtype`` bfloat16, under
    ``force_tpu_interpret_mode``, 4 steps with the nets lifted by 0.01: the
    states within 1e-4 in RMS (read: 4.8e-7 on SCG, 1.5e-5 on phi^4, where
    a chain's state sums 16 sites into each hidden unit and a bfloat16
    rounding can land one step apart) and within 1e-3 of their largest entry
    (read 1.6e-4); the float32 version misses the RMS bar (1.8e-3, 4.7e-4)."""
    jt, tt, jd, td, jp, tp, x, _ = _spec_setup(name, lift=0.01)
    n_steps = 4
    sampler = dataclasses.replace(jfd.fused_chain_sampler(jd, jt, tile=N), compute_dtype=BF)
    with pltpu.force_tpu_interpret_mode():
        x1, acc = sampler.run(jp, jnp.asarray(x), seed=7, n_mh_steps=n_steps)
    scale = float(np.abs(np.asarray(x1)).max())
    spec = fd.energy_spec_for_target(tt)
    for cd, holds in ((BF, True), (None, False)):
        inp = fd.prepare(td, spec, tp, "cpu", compute_dtype=cd)
        assert inp.cd == (torch.bfloat16 if cd else None)
        xo, acc_t, _ = fd.chain_plain(inp, torch.tensor(x).T.contiguous(), seed=7,
                                      n_mh_steps=n_steps, draws=_zero_bit_draws(N, tt.dim))
        np.testing.assert_array_equal(acc_t[0].numpy(), np.asarray(acc))
        d = xo.T.numpy() - np.asarray(x1)
        rms, err = float(np.sqrt(np.mean(d ** 2))), float(np.abs(d).max())
        assert (rms <= 1e-4 and err <= 1e-3 * scale) == holds, (cd, rms, err)


def test_kernel_inputs_block_rounds_the_products_weights():
    """With ``cd`` the packed block holds the six product weights of each
    net rounded to bfloat16 (after ``_net_scales``' fold) and every other
    array as it is: te, the biases, log-scales, eps, masks, constants."""
    _, tt, _, td, _, tp, _, _ = _spec_setup("rough_well_easy")
    spec = fd.energy_spec_for_target(tt)
    inp32 = fd.prepare(td, spec, tp, "cpu")
    b32, b16 = inp32.block(), fd.prepare(td, spec, tp, "cpu", compute_dtype=BF).block()
    head = inp32.eps.numel() + inp32.masks.numel() + sum(c.numel() for c in inp32.consts)
    assert torch.equal(b16[:head], b32[:head])
    off = head
    for j, w in enumerate([*inp32.xnet_w, *inp32.vnet_w]):
        i = j % fd._NET_ARRAYS
        seg32, seg16 = b32[off:off + w.numel()], b16[off:off + w.numel()]
        if i in fd._PRODUCT_WEIGHTS:
            assert torch.equal(seg16, seg32.to(torch.bfloat16).float())
            assert not torch.equal(seg16, seg32)
        else:
            assert torch.equal(seg16, seg32)
        off += w.numel()
    assert off == b32.numel()


# -- training ------------------------------------------------------------------------


def test_bf16_train_step_matches_jax_on_same_draws():
    """One ``ScgConfig(compute_dtype="bfloat16")`` training step on injected
    draws against the JAX step from the same converted params (the JAX step
    composed from its parts, tests/test_torch_train.py's ``_jax_step``):
    the loss to 1e-5 relative (read 6.0e-7), the post-MH chains to 1e-5
    (1.5e-7), the first Adam moment per leaf to 5e-3 of the leaf's largest
    entry (9.6e-4: a cotangent rounded per product to bfloat16 lands one
    bfloat16 step apart where a float32 sum in another order crosses a
    rounding boundary); the float32 step misses all three (7.7e-5, 4.1e-4,
    2.1e-2)."""
    from test_torch_train import _jax_step

    n, dim = 64, 2
    jcfg = JaxScgConfig(n_chains=n, T=3, seed=0, compute_dtype=BF)
    jd, _ = jax_build_dynamics(jcfg, jtargets.scg_gaussian())
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jp)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    d = {k: rng.standard_normal((n, dim)).astype(np.float32) for k in ("v_x", "z", "v_z")}
    d.update({k: rng.uniform(size=n).astype(np.float32) for k in ("dir_x", "acc_x", "dir_z")})
    alpha0 = np.log(np.float32(0.1))
    jloss, _, _, jx_next, jadam = _jax_step(jcfg, jd, None, jp, jnp.asarray(x),
                                            {k: jnp.asarray(v) for k, v in d.items()}, alpha0)
    jmu = [np.asarray(a).reshape(-1) for a in jax.tree_util.tree_leaves(jadam.mu)]
    offsets = np.cumsum([0] + [a.size for a in jmu])

    tp = params_from_jax(_np(jp), device="cpu")
    for cd, holds in ((BF, True), ("float32", False)):
        cfg = ScgConfig(n_chains=n, T=3, seed=0, compute_dtype=cd)
        td, _ = build_dynamics(cfg)
        opt, _ = make_optimizer(cfg)
        step = make_train_step(cfg, td, opt, alpha0=alpha0)
        state = TrainState(tp, opt.init(tp), torch.tensor(x), torch.Generator(), 0)
        new, metrics = step(state, StepDraws(**{k: torch.tensor(v) for k, v in d.items()}))
        tmu = new.opt_state.mu.numpy()
        mu_ok = all(float(np.abs(tmu[offsets[i]:offsets[i + 1]] - jm).max())
                    <= 5e-3 * float(np.abs(jm).max()) for i, jm in enumerate(jmu))
        loss_ok = abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
        x_ok = float(np.abs(new.x.numpy() - np.asarray(jx_next)).max()) <= 1e-5
        assert (mu_ok, loss_ok, x_ok) == (holds,) * 3, cd


def test_fused_bf16_training_is_fused_f32_training():
    """``ScgConfig.compute_dtype`` reaches the plain nets and no kernel (the
    JAX trainer builds ``differentiable_fused`` with no dtype): fused bf16
    training equals fused float32 training bit for bit, while plain bf16
    training differs from plain float32."""
    runs = {}
    for fused in (True, False):
        for cd in (BF, "float32"):
            cfg = ScgConfig(n_chains=32, T=3, n_steps=5, fused_train=fused, compute_dtype=cd)
            runs[fused, cd] = train(cfg, device="cpu")
    (s1, h1), (s2, h2) = runs[True, BF], runs[True, "float32"]
    assert all(np.array_equal(h1[k], h2[k]) for k in h1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert not np.array_equal(runs[False, BF][1]["loss"], runs[False, "float32"][1]["loss"])


def test_differentiable_fused_bf16_matches_jax():
    """``differentiable_fused(compute_dtype="bfloat16")``: the forward
    through kernel 1's bf16 form, the backward the float32 VJP at the
    unrounded weights, as JAX's custom VJP (its backward kernel takes no
    dtype). Outputs and the gradients of a random projection w.r.t. the
    params and x, v against the JAX package's in interpret mode: outputs
    within 1e-4 of their largest entry (read 2.2e-7), gradients within 1e-5
    of each leaf's largest entry (read 4.8e-7, the float32 route's too: the
    VJP reads the unrounded inputs, not the forward's outputs); the float32
    route misses the outputs' bar (1.5e-3)."""
    jt, tt, jd, td, jp, tp, x, v = _spec_setup("scg")
    rng = np.random.default_rng(9)
    cot = [rng.standard_normal(s).astype(np.float32) for s in ((N, 2), (N, 2), (N,))]
    jdf = jfd.differentiable_fused(jd, jt, tile=N, interpret=True, compute_dtype=BF)

    def japply(p, xx, vv):
        return jdf.forward(p, xx, vv)

    jout, jg = _jax_grads(japply, jax.tree_util.tree_map(jnp.asarray, jp),
                          [jnp.asarray(x), jnp.asarray(v)], cot)
    grads = {}
    for cd, holds in ((BF, True), (None, False)):
        tdf = fd.differentiable_fused(td, tt, compute_dtype=cd)
        out, grads[cd] = _torch_grads(lambda p, xx, vv: tdf.forward(p, xx, vv), tp, [x, v], cot)
        out_ok = all(float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(b).max())
                     for a, b in zip(out, jout))
        assert out_ok == holds, cd
        for a, b in zip(grads[cd], jg):
            assert float(np.abs(a - b).max()) <= 1e-5 * max(float(np.abs(b).max()), 1e-12)
    # the same VJP at the same inputs: bit for bit
    assert all(np.array_equal(a, b) for a, b in zip(grads[BF], grads[None]))


def test_backward_kernel_refuses_bf16_operands():
    """Kernel 2 has no bf16 form (nor has the JAX package's, which takes no
    ``cd``): ``trajectory_vjp`` refuses inputs with ``cd`` set, on the CPU as
    on the card, while the plain bf16 VJP (the VAE route's) stays open."""
    _, tt, _, td, _, tp, x, v = _spec_setup("scg")
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu", compute_dtype=BF)
    xt, vt = torch.tensor(x).T.contiguous(), torch.tensor(v).T.contiguous()
    with pytest.raises(ValueError, match="float32 operands only"):
        fd.trajectory_vjp(inp, xt, vt, xt, vt, torch.ones((1, N)), False)
    fd.trajectory_vjp(dataclasses.replace(inp, cd=None), xt, vt, xt, vt, torch.ones((1, N)),
                      False)
