"""The phi^4 protocol's tempered HMC eval on the CPU, the JAX package
against the port, each on its own random numbers: rung 0's tunnelling rate
from each, and the port's rung acceptance and swap rates.

    JAX_PLATFORMS=cpu python tests/torch_pt_rates.py --n 32 --steps 1000 --seeds 0 1

L = 16, m^2 = -4, lam = 0.5, 24 rungs to t_max 8, n chains a rung started
from the lattice's hot start, 10 leapfrogs at eps 0.1 (``apps.phi4.run``'s
``pt_hmc_sample_chain`` call at 768 chains). Prints one JSON line a seed.
Not a test: at the protocol's shape each seed takes ~1 min.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from l2hmc_tpu import targets as jtargets  # noqa: E402
from l2hmc_tpu.mcmc import tempering as jtemp  # noqa: E402
from l2hmc_tpu_torch import targets  # noqa: E402
from l2hmc_tpu_torch.apps.phi4 import tunneling_rate  # noqa: E402
from l2hmc_tpu_torch.mcmc import pt_hmc_sample_chain  # noqa: E402


def one(seed: int, n: int, steps: int, K: int = 24, t_max: float = 8.0) -> dict:
    jt = jtargets.Phi4Lattice(L=16, m2=-4.0, lam=0.5)
    tt = targets.Phi4Lattice(L=16, m2=-4.0, lam=0.5)
    x0 = np.repeat(np.asarray(jt.sample(jax.random.key(seed), n), np.float32)[None], K, axis=0)
    temps = jtemp.geometric_temps(t_max, K)
    _, trj = jtemp.pt_hmc_sample_chain(jt, 0.1, 10, jnp.asarray(x0), temps, steps,
                                       jax.random.key(seed + 5))
    st = {}
    _, trt = pt_hmc_sample_chain(tt, 0.1, 10, torch.tensor(x0), torch.tensor(np.asarray(temps)),
                                 steps, torch.Generator().manual_seed(seed + 5), stats=st)
    return {
        "seed": seed, "n_a_rung": n, "steps": steps,
        "tunneling_rate_pt_hmc_jax": tunneling_rate(np.asarray(jnp.mean(trj, axis=2))),
        "tunneling_rate_pt_hmc_port": tunneling_rate(trt.mean(dim=2).numpy()),
        "rung_accept_port": st["rung_accept"].tolist(),
        "swap_rate_port": st["swap_rate"].tolist(),
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    a = p.parse_args()
    for seed in a.seeds:
        print(json.dumps(one(seed, a.n, a.steps)), flush=True)


if __name__ == "__main__":
    main()
