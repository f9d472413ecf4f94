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
