"""The index arithmetic of kernel I (``csrc/chain_probe.cu``) on the CPU.

Kernel I runs its products on ``wgmma`` with the activation kept in
registers and the weights landing in shared memory by TMA with the 128-byte
swizzle.  A numpy model of its three maps, as ``csrc/wgmma.cuh`` states
them, is held here:

  * the accumulator fragment of m64n256 and the register A fragment of a
    k16 step: both cover the 64-row tile once, and the accumulator's
    columns [16 k, 16 k + 16), taken in pairs, are k-step k's A fragment;
  * the byte address at which a TMA box writes W's element (k, n), against
    the address the MN-major B descriptor (start, LBO, SBO, 128-byte
    swizzle) reads for it: the same, and one-to-one over a stage;
  * two chained products (x . W0, then h . W) computed from nothing but
    those maps, a swizzled byte image of the ring and the registers,
    against the plain chain (``chain_plain``'s first two layers).
"""
import numpy as np
import pytest
import torch

from nerf_pl_tpu_torch.scripts import kernel_probe as kp

# the kernel's constants
KS, BOX_COLS, N = 64, 64, 256
BOX_BYTES = KS * BOX_COLS * 2
STAGE_BYTES = KS * N * 2
LBO, SBO = BOX_BYTES, 1024  # the descriptor's offsets (chain_probe.cu)


def acc_coord(t, i):
    """m64nN accumulator: thread t (0..127) of the warpgroup, register i."""
    w, g, q = t // 32, (t % 32) // 4, t % 4
    j, e = i // 4, i % 4
    return 16 * w + g + 8 * (e // 2), 8 * j + 2 * q + e % 2


def a_coord(t, k, r, h):
    """Register A fragment of k-step k: register r, half h (0 = low)."""
    w, g, q = t // 32, (t % 32) // 4, t % 4
    return 16 * w + g + 8 * (r % 2), 16 * k + 8 * (r // 2) + 2 * q + h


def tma_byte(k, n):
    """Where the stage's four 64 x 64 boxes put W's row k (0..63 of the
    stage), column n: box n // 64, row k at 128 bytes, its 16-byte units
    XORed with k % 8 (the swizzle of a 1024-aligned box)."""
    b, c = n // BOX_COLS, n % BOX_COLS
    return b * BOX_BYTES + k * 128 + (((c // 8) ^ (k % 8)) * 16) + (c % 8) * 2


def desc_byte(kk, kr, n, lbo=LBO, sbo=SBO):
    """The byte that wgmma reads for B's (kr, n) at k-step kk: the MN-major
    canonical layout ((8, 8, m), (8, k)) : ((1, 8, LBO), (64, SBO)) from the
    descriptor's start, then the 128-byte swizzle of the address."""
    n0, n1, n2 = n % 8, (n // 8) % 8, n // 64
    k0, k1 = kr % 8, kr // 8
    pre = kk * 2048 + n2 * lbo + k1 * sbo + k0 * 128 + n1 * 16 + n0 * 2
    return pre ^ (((pre >> 7) & 7) << 4)


def test_accumulator_is_the_next_a_fragment():
    t = np.arange(128)[:, None]
    i = np.arange(128)[None, :]
    rows, cols = acc_coord(t, i)
    cover = np.zeros((64, 256), np.int32)
    np.add.at(cover, (rows, cols), 1)
    assert (cover == 1).all()  # a bijection onto the tile
    t, k, r, h = np.meshgrid(np.arange(128), np.arange(16), np.arange(4),
                             np.arange(2), indexing="ij")
    ar, ac = a_coord(t, k, r, h)
    cover = np.zeros((64, 256), np.int32)
    np.add.at(cover, (ar, ac), 1)
    assert (cover == 1).all()
    dr, dc = acc_coord(t, 8 * k + 2 * r + h)
    assert (ar == dr).all() and (ac == dc).all()


def test_descriptor_reads_what_tma_wrote():
    kk, kr, n = np.meshgrid(np.arange(KS // 16), np.arange(16),
                            np.arange(N), indexing="ij")
    read = desc_byte(kk, kr, n)
    written = tma_byte(16 * kk + kr, n)
    assert (read == written).all()
    # one-to-one over the stage's 2-byte elements
    assert np.unique(written).size == KS * N
    assert written.min() == 0 and written.max() == STAGE_BYTES - 2
    # the other assignment of the two offsets reads other bytes
    assert not (desc_byte(kk, kr, n, lbo=SBO, sbo=LBO) == written).all()


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _product(frag, w, stages):
    """acc[t, i] of one product, from the maps alone: A placed from the
    register fragments frag[t, k, r, h] (a_coord), B read through the
    descriptor model from a byte image of each stage as TMA leaves it, the
    sums (float64) handed back through the accumulator map."""
    bits = torch.from_numpy(np.ascontiguousarray(w)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    t, k, r, h = np.meshgrid(np.arange(128), np.arange(4 * stages),
                             np.arange(4), np.arange(2), indexing="ij")
    a = np.full((64, 64 * stages), np.nan)
    a[a_coord(t, k, r, h)] = frag
    b = np.full((64 * stages, N), np.nan)
    kk, kr, n = np.meshgrid(np.arange(KS // 16), np.arange(16),
                            np.arange(N), indexing="ij")
    for s in range(stages):
        ring = np.zeros(STAGE_BYTES // 2, np.uint16)
        ring[tma_byte(np.arange(KS)[:, None], np.arange(N)[None, :]) // 2] = \
            bits[s * KS:(s + 1) * KS]
        b16 = ring[desc_byte(kk, kr, n) // 2]
        b[s * KS + 16 * kk + kr, n] = torch.from_numpy(
            b16.view(np.int16)).view(torch.bfloat16).float().numpy()
    assert np.isfinite(a).all() and np.isfinite(b).all()
    dense = a @ b
    t, i = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    return dense[acc_coord(t, i)]


@pytest.mark.parametrize("fancy", [False, True], ids=["pure", "fancy"])
def test_two_products_from_the_maps_match_the_plain_chain(fancy):
    x, w0, w = kp.probe_inputs(64, "cpu", seed=3)
    xb = _bf16(x.numpy())
    # x's rows into the first product's fragments, as the kernel loads them
    t, k, r, h = np.meshgrid(np.arange(128), np.arange(8), np.arange(4),
                             np.arange(2), indexing="ij")
    rr, cc = a_coord(t, k, r, h)
    frag = xb[rr, cc]
    acc = _product(frag, w0.float().numpy(), stages=2).astype(np.float32)
    h1 = np.maximum(acc, 0.0) if fancy else acc
    # the epilogue: pairs of accumulators become the next A fragments
    t, k, r, h = np.meshgrid(np.arange(128), np.arange(16), np.arange(4),
                             np.arange(2), indexing="ij")
    frag = _bf16(h1)[t, 8 * k + 2 * r + h]
    acc = _product(frag, w.float().numpy(), stages=4).astype(np.float32)
    h2 = np.maximum(acc + np.float32(0.1), 0.0) if fancy else _bf16(acc)
    got = np.zeros((64, 256), np.float32)
    tt, ii = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    got[acc_coord(tt, ii)] = h2[tt, ii]
    # the plain chain's first two layers
    ref = _bf16(x.numpy()) @ _bf16(w0.float().numpy())
    ref = np.maximum(ref, 0.0) if fancy else _bf16(ref)
    ref = _bf16(ref) @ _bf16(w.float().numpy())
    ref = np.maximum(ref + np.float32(0.1), 0.0) if fancy else _bf16(ref)
    # f32 sums in another order than float64's: one bf16 step at most
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-3)
    assert np.mean(np.abs(got - ref)) <= 1e-3 * np.abs(ref).max()
