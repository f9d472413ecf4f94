"""Applications (counterpart of ``l2hmc_tpu/apps``): the VAE with its L2HMC
posterior sampler (model and training), its plain baseline, the data
loader, the two evaluation protocols that serve a trained VAE
(posterior-sampler quality, decoder log-likelihood by AIS), and the command
line ``python -m l2hmc_tpu_torch.apps.vae_main``."""

from l2hmc_tpu_torch.apps import baseline_vae, data, eval_sampler, eval_vae, vae

__all__ = ["baseline_vae", "data", "eval_sampler", "eval_vae", "vae"]
