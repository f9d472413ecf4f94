"""Counter-based Philox4x32-10 in plain PyTorch, and the chain sampler's draws.

The whole-chain CUDA kernel (``csrc/chain.cu``) draws its momenta, direction
and accept uniforms from Philox4x32-10 (Salmon et al., SC'11; the Random123
constants) keyed by the 64-bit seed, with counter
(global chain index, MH step, slot, inner op), the inner op being 0 except
in the VAE sampler's composed steps (``csrc/vae_chain.cu``). This module computes the same words
with integer tensor ops, so the kernel's plain version sees the same random
bits as the kernel on any device.

The 32-bit words are held in int64 tensors; the 32x32 -> 64-bit products are
split in 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product a * b (b < 2**32)."""
    p_lo = b * (a & 0xFFFF)  # < 2**48
    p_hi = b * (a >> 16)  # < 2**48
    r = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (r >> 32), r & _MASK


def philox4x32_10(counter, key):
    """Philox4x32-10 of broadcastable int64 counter words ``counter`` (four
    tensors, each < 2**32) under ``key`` (two ints). Returns four int64
    tensors of 32-bit words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform24(w: torch.Tensor) -> torch.Tensor:
    """U[0, 1) float32 from the top 24 bits of a 32-bit word."""
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


def box_muller(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Standard normal from two words, u1 clamped at 1e-7."""
    u1 = torch.clamp(uniform24(w1), min=1e-7)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * uniform24(w2))


def seed_key(seed: int) -> tuple[int, int]:
    """Philox key words of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def chain_draws(seed: int, n: int, d: int, step: int, device, op: int = 0):
    """The chain kernels' draws for MH ``step`` (and inner op ``op`` of a
    composed step): momenta (d, n) and the direction and accept uniforms
    (n,), on ``device``."""
    key = seed_key(seed)
    chains = torch.arange(n, dtype=torch.int64, device=device)
    r0 = philox4x32_10((chains, step, 0, op), key)
    # slot 1 + j gives rows 2j and 2j + 1, all j at once
    slots = 1 + torch.arange((d + 1) // 2, dtype=torch.int64, device=device)[:, None]
    r = philox4x32_10((chains[None, :], step, slots, op), key)
    rows = torch.stack([box_muller(r[0], r[1]), box_muller(r[2], r[3])], dim=1)
    return rows.reshape(-1, n)[:d], uniform24(r0[0]), uniform24(r0[1])
