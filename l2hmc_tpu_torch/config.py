"""Global configuration: the float32 policy and the device rule.

PyTorch counterpart of ``l2hmc_tpu/config.py``. MCMC acceptance rides
O(1e-3) Hamiltonian differences, and the strongly-correlated Gaussian's
precision matrix ([[5.005, 4.995], ...]) is near-singular at reduced
precision, so every contraction runs in true float32. On an NVIDIA card
PyTorch would otherwise route float32 convolutions (and, where a user flips
the matmul flag, matmuls) through TF32, which keeps about three decimal
digits. Importing this module turns both off.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without a card and without that request they raise (``resolve_device``).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_compute_dtype(spec) -> "torch.dtype | None":
    """'float32'/'bfloat16'/None/torch dtype -> matmul operand dtype
    (None = float32 passthrough). Only float32 is implemented by the port's
    nets and kernels so far; anything else raises."""
    if spec is None:
        return None
    dt = _DTYPES[spec] if isinstance(spec, str) else spec
    if dt != torch.float32:
        raise NotImplementedError(
            f"compute dtype {dt} is not ported yet; only float32 is supported"
        )
    return None


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
