"""The host side of the cluster-tiled VAE kernels (the training trajectory,
its VJP and the posterior sampler) on the CPU: the cluster configurations
and the shared memory a CTA needs as the sources define them, the decoder's
split, the reckoned weight traffic and the copy-free weight pointers. The
kernels themselves, and the sizes the sources report for the host to
allocate, run only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.apps import vae
from l2hmc_tpu_torch.ops import fused_vae as fv
from l2hmc_tpu_torch.ops.fused_dynamics import _MAX_SMEM

CSRC = Path(fv.__file__).resolve().parent.parent / "csrc"
# the reference model (VaeConfig()): latent, net widths, leapfrogs, decoder
# hidden, pixels
REF = dict(D=50, H=200, H2=200, T=5, E=1024, P=784)
SMEM_DIMS = ("D", "H", "H2", "E", "P")
# (D, H, E) of the widths the card tests run, and two that divide nothing
WIDTHS = [(8, 16, 32), (50, 200, 1024), (128, 16, 32), (3, 5, 7)]


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"\b{name}\s*=\s*(\d+)", text).group(1))


def test_host_mirror_constants_match_the_sources():
    """The host's copies of the sources' constants: the cluster
    configuration, the rows per staged chunk, the backward kernel's state
    arrays."""
    assert fv.CLUSTER == (_constant("vae_cluster.cuh", "kCt"),
                          _constant("vae_cluster.cuh", "kG"))
    assert fv._KC == _constant("vae_cluster.cuh", "KC")
    assert fv._BWD_STATE_ARRAYS == _constant("vae_traj_bwd.cu", "kStateArrays")


def test_sampler_constants_match_the_source():
    """The sampler's cluster configuration and [Ct] arrays, as
    csrc/vae_chain.cu defines them."""
    assert fv.CHAIN_CLUSTER == (_constant("vae_chain.cu", "kChainCt"),
                                _constant("vae_chain.cu", "kChainG"))
    assert fv._CHAIN_VECS == _constant("vae_chain.cu", "kChainVecs")


@pytest.mark.parametrize("width", [REF, dict(D=128, H=16, H2=16, T=3, E=32, P=784)],
                         ids=["reference", "latent128"])
@pytest.mark.parametrize("kernel", ["traj", "bwd", "chain"])
def test_smem_per_cta_fits_at_the_reference_width(kernel, width):
    """The three kernels' shared memory per CTA, reckoned as the kernels
    carve it, fits the 232,448 bytes a CTA may use at the reference width,
    and at the card tests' latent of 128 (nets 16/16, decoder 32)."""
    fn = {"traj": fv.traj_smem_floats, "bwd": fv.bwd_smem_floats,
          "chain": fv.chain_smem_floats}[kernel]
    ct, g = fv.CHAIN_CLUSTER if kernel == "chain" else fv.CLUSTER
    floats = fn(ct, g, *(width[k] for k in SMEM_DIMS))
    assert 4 * floats <= _MAX_SMEM
    assert floats > ct * (width["E"] // g)  # at least a decoder layer's slice


def test_smem_reckoning_by_hand():
    """The reckoning at Ct = 40, G = 8, term by term: slices of 7 latent,
    128 hidden and 25 net rows; rings of three weight slots (a 128-row chunk
    staged 32 x 132 forward or 128 x 36 transposed: 4608 floats) and three
    32 x Ct input chunks."""
    dims = {k: REF[k] for k in SMEM_DIMS}
    assert fv.CLUSTER == (40, 8)
    ring40, ring80 = 3 * (128 * 36 + 32 * 40), 3 * (128 * 36 + 32 * 80)
    traj = 40 * (2 * 128 + 25 + 25 + 8 * 7 + 1) + ring40
    assert fv.traj_smem_floats(40, 8, **dims) == traj
    region = 2 * 40 * 2 * 128
    bwd = ring80 + region + 40 * (22 * 7 + 4 * 7 + 25 + 1)
    assert fv.bwd_smem_floats(40, 8, **dims) == bwd
    assert 4 * bwd == 201216


@pytest.mark.parametrize("D,H,E", WIDTHS, ids=[f"D{d}H{h}E{e}" for d, h, e in WIDTHS])
def test_bwd_smem_keeps_16_byte_alignment_at_the_small_width(D, H, E):
    """At the tests' small width (latent 8, decoder 32, nets 16/16) the net
    VJP's [rows][Ct + 1] arrays make the shared region an odd count of
    floats; it is rounded up to 4, so the state arrays after it, which take
    16-byte copies, stay aligned: the whole carve is a multiple of 4 floats
    at every width."""
    ct, g = fv.CLUSTER
    floats = fv.bwd_smem_floats(ct, g, D, H, H, E, 784)
    assert floats % 4 == 0
    # the carve after the ring and the region: 26 [Dg][Ct] arrays, demb
    # [Hg][Ct] and dl [Ct], all multiples of Ct (a multiple of 8)
    tail = ct * (26 * fv._slice(D, g) + fv._slice(H, g) + 1)
    assert (floats - tail) % 4 == 0


def test_chain_smem_reckoning_by_hand():
    """The sampler's carve at Ct = 16, G = 8, term by term: slices of 128
    decoder, 25 net and 7 latent rows, ten latent state arrays, eight [Ct]
    arrays, and a ring of three weight slots and three 32 x 16 input
    chunks; 86,016 bytes a CTA at the reference width."""
    dims = {k: REF[k] for k in SMEM_DIMS}
    assert fv.CHAIN_CLUSTER == (16, 8)
    ring = 3 * (128 * 36 + 32 * 16)
    floats = 16 * (2 * 128 + 25 + 25 + 10 * 7 + 8) + ring
    assert fv.chain_smem_floats(16, 8, **dims) == floats
    assert 4 * floats == 86016


def test_decoder_split_starts_rows_on_16_bytes():
    """The decoder's rows are split in multiples of 4 per CTA (784 pixels
    over 8 CTAs: seven of 100 and one of 84), so each CTA's slice of W (in,
    out) starts on a 16-byte boundary; the other splits stay ceil(M / G)."""
    assert fv._slice4(784, 8) == 100 and 784 - 7 * 100 == 84
    assert fv._slice4(1024, 8) == 128 and fv._slice4(32, 8) == 4
    assert fv._slice(50, 8) == 7 and fv._slice(200, 8) == 25
    for m in range(1, 2049):
        for g in (4, 8, 16):
            s = fv._slice4(m, g)
            assert s % 4 == 0 and s * g >= m and s - fv._slice(m, g) < 4


def test_smem_check_raises_past_the_limit():
    """A tile of 64 chains on clusters of 8 would not fit the backward
    kernel's sweeps with a tangent."""
    with pytest.raises(ValueError, match="shared memory"):
        fv._check_smem(fv.bwd_smem_floats(64, 8, **{k: REF[k] for k in SMEM_DIMS}))


def test_weight_l2_bytes():
    """At the training batch with Ct = 40: 13 clusters x 6 decoder
    gradients x 15.2 MB ~ 1.19 GB of decoder, ten times less than tiles of
    4; the nets' bytes stay under the decoder's for every T."""
    dims = [REF[k] for k in ("D", "H", "H2", "T", "E", "P")]
    ct = fv.CLUSTER[0]
    dec, net = fv.weight_l2_bytes(ct, 512, *dims)
    assert dec == 13 * 6 * 8 * (50 * 1024 + 1024 * 1024 + 1024 * 784)
    assert 1.18e9 < dec < 1.20e9
    for T in range(1, 11):
        d2, n2 = fv.weight_l2_bytes(ct, 512, REF["D"], REF["H"], REF["H2"], T, REF["E"],
                                    REF["P"])
        assert n2 < d2


def test_weight_pointers_copy_nothing_of_the_decoder_or_the_nets():
    """The training kernels get the decoder in the params tree's (in, out)
    layout and the nets as _extract_net gives them: the pointers are those
    tensors' own storage."""
    cfg = vae.VaeConfig(latent_dim=8, leapfrogs=3, enc_hidden=32, sampler_size1=16,
                        sampler_size2=16)
    model = vae.VaeModel.build(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.as_tensor((np.random.default_rng(0).random((5, 784)) < 0.3).astype(np.float32))
    emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x)
    inp = fv.prepare_vae(model.dynamics, params["smp"], params["dec"], x.T.contiguous(),
                         emb.T.contiguous())
    ptrs, keep = fv._weight_ptrs(inp, torch.device("cpu"))
    assert len(ptrs) == 2 + 6 + 2 * 13
    lin1, _, lin2, _, lin3 = params["dec"]
    for slot, lin in zip((2, 4, 6), (lin1, lin2, lin3)):
        assert ptrs[slot] == lin["w"].data_ptr()
        assert ptrs[slot + 1] == lin["b"].data_ptr()
    for k, w in enumerate([*inp.xnet_w, *inp.vnet_w]):
        assert ptrs[8 + k] == w.data_ptr()
    assert all(a.is_contiguous() and a.dtype == torch.float32 for a in keep)
