"""The AIS kernel's weight stream on the CPU: the host's mirror of the
chunk plan of ``csrc/vae_stream.cuh`` (``fused_vae.ais_chunk_plan``) and the
packed decoder it streams from. Each chunk is one ``cp.async.bulk`` copy,
which needs 16-byte aligned addresses and a size that is a multiple of 16
bytes; the ring and a CTA's activations must fit one CTA's shared memory.
The card tests hold the source's own figures (``l2hmc_vae_ais_sizes``) to
this mirror."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch.ops import fused_vae as fv

CSRC = Path(fv.__file__).resolve().parent.parent / "csrc"
# (D, E, P): the reference model, the card tests' small width, and an odd
# latent and hidden width whose arrays need the packed block's padding
WIDTHS = [(50, 1024, 784), (8, 32, 784), (5, 30, 784)]
IDS = ["reference", "small", "odd"]
MAX_SMEM = 232448  # bytes one CTA may use on Hopper


@pytest.mark.parametrize("dims", WIDTHS, ids=IDS)
def test_ais_chunk_plan_copies_are_aligned_and_cover_each_product(dims):
    """Every bulk copy starts on 16 bytes of the (16-byte aligned) block,
    moves a multiple of 16 bytes, fits a ring slot and stays inside its
    matrix's padded extent; each product's chunks cover its K rows exactly
    once, in order; the last row group of a chunk reads inside the slot."""
    plan = fv.ais_chunk_plan(*dims)
    D, E, P = dims
    assert [(p["K"], p["M"]) for p in plan] == [(D, E), (E, E), (E, P), (P, E), (E, E), (E, D)]
    slot_bytes = 4 * fv._AIS_SLOT_FLOATS
    for prod in plan:
        K, M, kc = prod["K"], prod["M"], prod["kc"]
        assert kc > 0 and (kc * M) % 4 == 0
        assert prod["offset"] % 4 == 0
        rows_seen = []
        for k0, rows, off, nbytes in prod["chunks"]:
            assert off % 16 == 0 and nbytes % 16 == 0 and 0 < nbytes <= slot_bytes
            assert rows * M * 4 <= nbytes < rows * M * 4 + 16
            assert off + nbytes <= 4 * (prod["offset"] + prod["extent"])
            assert off == 4 * (prod["offset"] + k0 * M)
            # row groups of 4 floats: the last one of the last row
            assert (rows - 1) * M + 4 * (-(-M // 4)) <= fv._AIS_SLOT_FLOATS + fv._AIS_SLOT_PAD
            rows_seen += range(k0, k0 + rows)
        assert rows_seen == list(range(K))


@pytest.mark.parametrize("dims", WIDTHS, ids=IDS)
def test_ais_ring_and_activations_fit_shared_memory(dims):
    """The ring (slots and mbarriers) plus the decoder activations and
    chain state of kC chains fit the 232,448 bytes a CTA may use, and the
    ring leaves every activation array on 16 bytes."""
    D, E, P = dims
    C, _ = fv.AIS_TILE
    ring = 16 * fv._AIS_SLOTS + 4 * fv._AIS_SLOTS * (fv._AIS_SLOT_FLOATS + fv._AIS_SLOT_PAD)
    assert ring % 16 == 0 and (4 * C) % 16 == 0
    smem = fv.ais_smem_bytes(D, E, P)
    assert smem == ring + 4 * C * (2 * E + P + 8 + 5 * D + 5)
    assert smem <= MAX_SMEM
    # the split of the last product (W1t, M = D) sums through h2, [E][C]
    mg = -(-D // 4)
    slices = max(1, min(256 // mg, (E * C) // (mg * 4 * C)))
    assert slices * mg * 4 * C <= E * C


@pytest.mark.parametrize("dims", WIDTHS, ids=IDS)
def test_packed_decoder_holds_each_matrix_at_its_planned_offset(dims):
    """``_pack_decoder`` pads every array to 4 floats with zeros, and the
    plan's offsets find each product's k-major matrix in the packed block:
    W (in, out) forward, A = W.T (out, in) for the sweep back."""
    D, E, P = dims
    rng = np.random.default_rng(0)
    dec = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
           for s in ((E, D), (E, 1), (E, E), (E, 1), (P, E), (P, 1))]
    A1, _, A2, _, A3, _ = dec
    parts = fv._pack_decoder(dec)
    block = fv._byte_block(parts).view(torch.float32)
    assert all(p.dtype == torch.float32 and p.numel() % 4 == 0 for p in parts)
    assert block.numel() == sum(p.numel() for p in parts)
    want = {"W1": A1.T, "W2": A2.T, "W3": A3.T, "W3t": A3, "W2t": A2, "W1t": A1}
    for prod in fv.ais_chunk_plan(D, E, P):
        K, M, off = prod["K"], prod["M"], prod["offset"]
        got = block[off:off + K * M].view(K, M)
        torch.testing.assert_close(got, want[prod["name"]], rtol=0, atol=0)
        assert float(block[off + K * M:off + prod["extent"]].abs().sum()) == 0.0


def _constant(name: str) -> int:
    text = (CSRC / "vae_stream.cuh").read_text()
    return int(re.search(rf"\b{name}\s*=\s*(\d+)", text).group(1))


def test_host_mirror_constants_match_the_source():
    """The host's copies of the stream's constants: chains per CTA, CTAs
    per cluster, ring slots, floats per slot and the floats a row group
    may read past a chunk."""
    assert fv.AIS_TILE == (_constant("kC"), _constant("kG"))
    assert (fv._AIS_SLOTS, fv._AIS_SLOT_FLOATS, fv._AIS_SLOT_PAD) == (
        _constant("kSlots"), _constant("kSlotFloats"), _constant("kSlotPad"))


def test_ais_l2_bytes_at_the_protocol():
    """At the protocol's 1000 chains (125 CTAs of 8, rounded up to 63
    clusters of 2) each cluster streams the decoder in both layouts once
    per sweep, K L + 1 = 1001 sweeps: about 0.96 TB, half of what 125
    blocks streaming their own copies read."""
    D, E, P = WIDTHS[0]
    sweep = 4 * 2 * (D * E + E * E + E * P)  # 15.2 MB
    assert fv.AIS_TILE == (8, 2)
    got = fv.ais_l2_bytes(D, E, P, 1000, 100, 10)
    assert got == 63 * 1001 * sweep
    assert got == pytest.approx(0.96e12, rel=0.01)


@pytest.mark.parametrize("dims", WIDTHS, ids=IDS)
def test_bf16_chunk_plan_keeps_the_bulk_copy_rules(dims):
    """With the decoder's matrices in bfloat16 (the kernel's bf16
    instantiation) a slot's 64 KB hold as many rows as fit, at least twice
    float32's, where whole rows are 16 bytes; every copy still starts on 16
    bytes, moves a multiple of 16 and fits a slot, each product's chunks
    cover its rows once, the last row group (4 weights, 8 bytes) reads
    inside the slot's pad, and a sweep streams half float32's bytes."""
    plan16, plan32 = fv.ais_chunk_plan(*dims, item=2), fv.ais_chunk_plan(*dims)
    slot_bytes = 4 * fv._AIS_SLOT_FLOATS
    for prod, prod32 in zip(plan16, plan32):
        K, M, kc = prod["K"], prod["M"], prod["kc"]
        assert kc > 0 and (2 * kc * M) % 16 == 0 and 2 * kc * M <= slot_bytes
        if M % 8 == 0:
            assert kc == slot_bytes // (2 * M) >= 2 * prod32["kc"]
        rows_seen = []
        for k0, rows, off, nbytes in prod["chunks"]:
            assert off % 16 == 0 and nbytes % 16 == 0 and 0 < nbytes <= slot_bytes
            assert rows * M * 2 <= nbytes < rows * M * 2 + 16
            assert off + nbytes <= 2 * (prod["offset"] + prod["extent"])
            assert off == 2 * (prod["offset"] + k0 * M)
            assert 2 * ((rows - 1) * M + 4 * (-(-M // 4))) <= 4 * (
                fv._AIS_SLOT_FLOATS + fv._AIS_SLOT_PAD)
            rows_seen += range(k0, k0 + rows)
        assert rows_seen == list(range(K))
    D, E, P = dims
    assert fv.ais_l2_bytes(D, E, P, 1000, 100, 10, item=2) == pytest.approx(
        fv.ais_l2_bytes(D, E, P, 1000, 100, 10) / 2, rel=1e-3)


@pytest.mark.parametrize("dims", WIDTHS, ids=IDS)
def test_bf16_packed_decoder_holds_each_matrix_at_its_planned_offset(dims):
    """``_pack_decoder(dec, torch.bfloat16)`` casts the six matrices and
    keeps the biases float32, each padded with zeros to whole 16 bytes; in
    the byte block the plan's offsets (in bfloat16 weights) find each
    product's k-major matrix, rounded to bfloat16, and the biases sit where
    the kernel's carve takes them."""
    D, E, P = dims
    rng = np.random.default_rng(0)
    dec = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
           for s in ((E, D), (E, 1), (E, E), (E, 1), (P, E), (P, 1))]
    A1, B1, A2, B2, A3, B3 = dec
    parts = fv._pack_decoder(dec, torch.bfloat16)
    assert [p.dtype for p in parts] == [torch.bfloat16, torch.float32] * 3 + [torch.bfloat16] * 3
    assert all((p.numel() * p.element_size()) % 16 == 0 for p in parts)
    block = fv._byte_block(parts)
    as16 = block.view(torch.bfloat16)
    want = {"W1": A1.T, "W2": A2.T, "W3": A3.T, "W3t": A3, "W2t": A2, "W1t": A1}
    for prod in fv.ais_chunk_plan(D, E, P, item=2):
        K, M, off = prod["K"], prod["M"], prod["offset"]
        got = as16[off:off + K * M].view(K, M)
        torch.testing.assert_close(got, want[prod["name"]].to(torch.bfloat16), rtol=0, atol=0)
        assert float(as16[off + K * M:off + prod["extent"]].float().abs().sum()) == 0.0
    b1_at = parts[0].numel() * 2
    torch.testing.assert_close(block[b1_at:b1_at + 4 * E].view(torch.float32), B1[:, 0],
                               rtol=0, atol=0)
