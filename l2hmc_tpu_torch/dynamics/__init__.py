"""L2HMC dynamics (counterpart of ``l2hmc_tpu/dynamics``)."""

from l2hmc_tpu_torch.dynamics.core import Dynamics, make_masks, time_encoding

__all__ = ["Dynamics", "make_masks", "time_encoding"]
