"""Global configuration: the float32 policy and the device rule.

PyTorch counterpart of ``l2hmc_tpu/config.py``. MCMC acceptance rides
O(1e-3) Hamiltonian differences, and the strongly-correlated Gaussian's
precision matrix ([[5.005, 4.995], ...]) is near-singular at reduced
precision, so every contraction runs in true float32. On an NVIDIA card
PyTorch would otherwise route float32 convolutions (and, where a user flips
the matmul flag, matmuls) through TF32, which keeps about three decimal
digits. Importing this module turns both off. bfloat16 enters only as an
opt-in operand dtype of matrix products that accumulate in float32
(``Precision``, ``resolve_compute_dtype``), as in the JAX package.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without a card and without that request they raise (``resolve_device``).
"""

from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype policy for mixed precision (the JAX package's
    ``config.Precision``). Params, accumulation (logdet, energy,
    Hamiltonian, loss) and chain state stay float32; ``compute_dtype``
    bfloat16 lowers only the operands of the nets' and the decoder's matrix
    products, which then accumulate in float32. The augmented leapfrog stays
    invertible: forward and backward recompute the same nets on the same
    inputs, so they see the same S/T/Q values whatever the operands, except
    where a state carried back with float32 rounding lands on the other
    side of a bfloat16 rounding boundary (a few chains in a hundred at the
    VAE's full width). Consumers that take bfloat16: the plain dense and conv
    nets (``nets.core.linear``, ``nets.lattice.conv2d``, through
    ``stq_net``, ``lattice_stq_net`` and ``ScgConfig.compute_dtype``), the
    classes of kernels 1 and 3 (``ops.fused_dynamics``: ``FusedDynamics``,
    ``FusedChainSampler`` and their factories; ``differentiable_fused``,
    whose backward is the float32 VJP, as in the JAX package) and the VAE
    kernels' classes (``ops.fused_vae``, ``VaeConfig.fused_compute_dtype``).
    As in the JAX package, the training and eval entry points hand no
    operand dtype to a kernel: ``ScgConfig.compute_dtype`` reaches the plain
    nets only."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32


DEFAULT_PRECISION = Precision()
BF16_PRECISION = Precision(compute_dtype=torch.bfloat16)


def resolve_compute_dtype(spec) -> "torch.dtype | None":
    """'float32'/'bfloat16'/None/torch dtype/``Precision`` -> the matrix
    products' operand dtype (None = float32 passthrough). The string form
    keeps dataclass configs JSON-serializable."""
    if spec is None:
        return None
    if isinstance(spec, Precision):
        spec = spec.compute_dtype
    dt = _DTYPES.get(spec) if isinstance(spec, str) else spec
    if dt not in _DTYPES.values():
        raise ValueError(f"compute dtype {spec!r}: float32 or bfloat16")
    return None if dt == torch.float32 else dt


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller passes
    another. Raises when CUDA is asked for (explicitly or by default) and no
    card is present, so a run never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev
