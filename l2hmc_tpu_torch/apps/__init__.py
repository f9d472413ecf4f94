"""Applications (counterpart of ``l2hmc_tpu/apps``): the VAE's model half,
its data loader, and the two evaluation protocols that serve a trained VAE
(posterior-sampler quality, decoder log-likelihood by AIS)."""

from l2hmc_tpu_torch.apps import data, eval_sampler, eval_vae, vae

__all__ = ["data", "eval_sampler", "eval_vae", "vae"]
