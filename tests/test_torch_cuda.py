"""The CUDA kernels vs their plain versions on the card. Marked
``requires_cuda``; they skip where there is no CUDA device (run them with
``pytest -m requires_cuda`` on a machine with an H100 and nvcc)."""

import pytest
import torch

from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics
from l2hmc_tpu_torch.train.optim import tree_leaves

pytestmark = pytest.mark.requires_cuda

TOL = 5e-4  # bench.py's compiled-parity gate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(cuda, hmc=False, dim=2, n=333):
    tgt = targets.scg_gaussian() if dim == 2 else targets.ill_conditioned_gaussian(dim)
    cfg = ScgConfig(dim=dim, T=5, hmc=hmc, net_input_whiten=dim > 2 and not hmc)
    dyn, _ = build_dynamics(cfg, tgt)
    params = dyn.init_params(torch.Generator().manual_seed(0), device=cuda)
    if not hmc:
        for net in ("xnet", "vnet"):
            params[net] = _add(params[net], 0.03)
    inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt), params, cuda)
    x = tgt.sample(torch.Generator().manual_seed(1), n, device=cuda).T.contiguous()
    return inp, x


def _add(tree, c):
    if isinstance(tree, dict):
        return {k: _add(v, c) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_add(v, c) for v in tree)
    return tree + c


@pytest.mark.parametrize("hmc,dim", [(False, 2), (True, 2), (False, 50)])
@pytest.mark.parametrize("reverse", [False, True])
def test_trajectory_kernel_matches_plain(cuda, hmc, dim, reverse):
    inp, x = _inputs(cuda, hmc, dim)
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    before = fd.LAUNCHES["trajectory"]
    got = fd.trajectory(inp, x, v, reverse)
    assert fd.LAUNCHES["trajectory"] == before + 1
    ref = fd.trajectory_plain(inp, x, v, reverse)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=TOL)


def test_chain_kernel_matches_plain_on_same_bits(cuda):
    """Same Philox bits; a flipped accept is possible only at |px - u| of a
    few ulp, so all decisions agree at this size and states within 1e-3."""
    inp, x = _inputs(cuda)
    xk, acck, trk = fd.chain(inp, x, seed=4, n_mh_steps=8, collect_trace=True)
    xp, accp, trp = fd.chain_plain(inp, x, seed=4, n_mh_steps=8, collect_trace=True)
    torch.testing.assert_close(acck, accp, rtol=0, atol=0)
    torch.testing.assert_close(trk, trp, rtol=0, atol=1e-3)
    torch.testing.assert_close(trk[-1], xk, rtol=0, atol=0)


@pytest.mark.parametrize("hmc,dim,n", [(False, 2, 333), (True, 2, 333), (False, 50, 256),
                                       (False, 2, 200)], ids=["scg", "hmc", "wide", "ragged"])
@pytest.mark.parametrize("reverse", [False, True])
def test_trajectory_bwd_kernel_matches_plain(cuda, hmc, dim, n, reverse):
    """Per leaf, max |kernel - plain| <= 5e-4 of the leaf's largest entry:
    the weight and eps cotangents are sums over chains taken in another
    order, and the wide case (every weight lifted by 0.03, whitened input)
    reaches 1.5e-4 on an H100. One chain dropped from a sum over these N
    is about 1/N of the leaf, several times the limit. The kernel's
    fixed-order sum makes it repeat itself exactly."""
    inp, x = _inputs(cuda, hmc, dim, n)
    g = torch.Generator().manual_seed(3)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, x.shape[1]), generator=g).to(cuda)
    before = fd.LAUNCHES["trajectory_bwd"]
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    assert fd.LAUNCHES["trajectory_bwd"] == before + 1
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * float(b.abs().max()) + 1e-30)
    again = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_through_function_launches_kernel(cuda):
    """loss.backward() through DifferentiableFusedDynamics launches the
    backward kernel once per trajectory and fills every params gradient."""
    tgt = targets.scg_gaussian()
    dyn, _ = build_dynamics(ScgConfig(T=4), tgt)
    params = dyn.init_params(torch.Generator().manual_seed(0), device=cuda)
    params = {**params, "xnet": _add(params["xnet"], 0.03), "vnet": _add(params["vnet"], 0.03)}
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    dfd = fd.differentiable_fused(dyn, tgt)
    x = tgt.sample(torch.Generator().manual_seed(1), 256, device=cuda)
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    fd.reset_launch_counts()
    X, V, ld = dfd.forward(params, x, v)
    Xb, _, ldb = dfd.backward(params, x, v)
    loss = (X * Xb).mean() + V.mean() + (ld - 2.0 * ldb).mean()
    loss.backward()
    assert fd.LAUNCHES["trajectory"] == 2 and fd.LAUNCHES["trajectory_bwd"] == 2
    for leaf in leaves:
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    assert float(params["alpha"].grad.abs()) > 0


def test_kernel_rejects_bad_input(cuda):
    inp, x = _inputs(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fd.chain(inp, x.T.contiguous().T, seed=0, n_mh_steps=1)
    with pytest.raises(ValueError, match="kernel inputs on"):
        fd.trajectory(inp, x.cpu(), x.cpu(), False)


# -- the VAE kernels ------------------------------------------------------------


def _scale_heads(net, c):
    """The S, T and Q heads' weights of a ``stq_net`` params tree times c."""
    (s_lin, s_st), t_lin, (q_lin, q_st) = net[5]

    def scaled(lin):
        return {"w": lin["w"] * c, "b": lin["b"]}

    return (*net[:5], ((scaled(s_lin), s_st), scaled(t_lin), (scaled(q_lin), q_st)))


def _vae_setup(cuda, full: bool, n: int):
    """A seeded VAE at the full or the small width with a {0, 1} batch, its
    embedding and a start state on the card. The decoder's last layer
    (init factor 0.01) is scaled by 10 so that logits are O(1). At the full
    width the embedding already drives S, T, Q to ~0.2 and the heads are
    halved; at the small width every net weight is lifted by 0.02."""
    from l2hmc_tpu_torch.apps import vae

    cfg = vae.VaeConfig() if full else vae.VaeConfig(
        latent_dim=8, leapfrogs=3, enc_hidden=32, sampler_size1=16, sampler_size2=16)
    model = vae.VaeModel.build(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device=cuda)
    smp = dict(params["smp"])
    for net in ("xnet", "vnet"):
        smp[net] = _scale_heads(smp[net], 0.5) if full else _add(smp[net], 0.02)
    dec = list(params["dec"])
    dec[4] = {"w": dec[4]["w"] * 10.0, "b": dec[4]["b"] + 0.1}
    params = {**params, "smp": smp, "dec": tuple(dec)}
    g = torch.Generator().manual_seed(1)
    x_raw = (torch.rand((n, 784), generator=g) < 0.3).float().to(cuda)
    z0 = torch.randn((n, cfg.latent_dim), generator=g).to(cuda)
    emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x_raw)
    return model, params, x_raw, emb, z0


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("composed", [False, True], ids=["single", "composed"])
@pytest.mark.parametrize("full,n", [(True, 203), (False, 77)], ids=["full", "small"])
def test_vae_chain_kernel_matches_plain_on_same_bits(cuda, full, n, composed, tile):
    """Same Philox bits, ragged chain count, 3 recorded steps. A flipped
    accept needs |px - u| within the float32 gap of the two Hamiltonians
    (~1e-4 of energies of a few hundred), so at most 2 of these decisions
    may flip; chains with no flip agree to 2e-3 (sums of 1024 terms in
    another order, through up to 9 trajectories)."""
    from l2hmc_tpu_torch.ops import fused_vae as fv

    model, params, x_raw, emb, z0 = _vae_setup(cuda, full, n)
    xr = x_raw.T.contiguous()
    inp = fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, emb.T.contiguous())
    nb = [2, 1, 3] if composed else None
    zT = z0.T.contiguous()
    before = fd.LAUNCHES["vae_chain"]
    zk, acck, trk = fv.vae_chain(inp, xr, zT, seed=4, n_mh_steps=3, collect_trace=True,
                                 nb=nb, tile=tile)
    assert fd.LAUNCHES["vae_chain"] == before + 1
    zp, accp, trp = fv.vae_chain_plain(inp, zT, seed=4, n_mh_steps=3, collect_trace=True, nb=nb)
    torch.testing.assert_close(trk[-1], zk, rtol=0, atol=0)
    assert torch.isfinite(trk).all()
    ops = 6 if composed else 3
    flipped = (acck - accp).abs()[0] * ops > 0.5
    assert int(flipped.sum()) <= 2
    torch.testing.assert_close(trk[:, :, ~flipped], trp[:, :, ~flipped], rtol=0, atol=2e-3)
    assert 0.0 < float(acck.mean()) < 1.0 or not full
    assert float((zk - zT).abs().max()) > 0.05  # the chains moved


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("anneal_steps", [1, 20])
@pytest.mark.parametrize("full,n", [(True, 203), (False, 77)], ids=["full", "small"])
def test_vae_ais_kernel_matches_plain_on_same_bits(cuda, full, n, anneal_steps, tile):
    """Same Philox bits. A flipped accept sends a chain down another path
    and moves its log w by O(1); chains within 0.05 count as unflipped, at
    most 2 may flip, and on the others log w (values of 700-1300) agrees to
    5e-3 and the mean acceptance probability to 5e-3 (a Hamiltonian
    difference of energies near 1e3 carries ~1e-3 of float32 rounding)."""
    from l2hmc_tpu_torch.ops import fused_vae as fv

    model, params, x_raw, _, z0 = _vae_setup(cuda, full, n)
    dec = fv.decoder_arrays(params["dec"])
    xr, zT = x_raw.T.contiguous(), z0.T.contiguous()
    before = fd.LAUNCHES["vae_ais"]
    wk, acck = fv.vae_ais(dec, xr, zT, seed=6, anneal_steps=anneal_steps, step_size=0.05,
                          leapfrogs=10, tile=tile)
    assert fd.LAUNCHES["vae_ais"] == before + 1
    wp, accp = fv.vae_ais_plain(dec, xr, zT, seed=6, anneal_steps=anneal_steps,
                                step_size=0.05, leapfrogs=10)
    assert torch.isfinite(wk).all()
    clean = (wk - wp).abs()[0] < 0.05
    assert int((~clean).sum()) <= 2
    torch.testing.assert_close(wk[:, clean], wp[:, clean], rtol=0, atol=5e-3)
    torch.testing.assert_close(acck[:, clean], accp[:, clean], rtol=0, atol=5e-3)
    assert float(acck.min()) > 0.0 and float(acck.max()) <= 1.0


def test_vae_wrappers_reject_bad_input(cuda):
    from l2hmc_tpu_torch.ops import fused_vae as fv

    model, params, x_raw, emb, z0 = _vae_setup(cuda, False, 16)
    xr = x_raw.T.contiguous()
    inp = fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, emb.T.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fv.vae_chain(inp, xr, z0.T, seed=0, n_mh_steps=1)
    with pytest.raises(ValueError, match="expected"):
        fv.vae_chain(inp, xr, z0.T.contiguous().cpu(), seed=0, n_mh_steps=1)
    with pytest.raises(ValueError, match="tile"):
        fv.vae_chain(inp, xr, z0.T.contiguous(), seed=0, n_mh_steps=1, tile=16)
