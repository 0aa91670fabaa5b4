"""The fp16 forward tile's rounding-tie rule (``near_tie_f16`` in
``csrc/fused_mlp_common.cuh``) and the fp16 kernels' interface.

fp16 runs the same tensor-core tile as bf16: 16-term sums, each started
from zero, added in f32, where the scalar loops and the plain version sum
each output one term at a time in k order.  The tile marks every output
whose nearer fp16 rounding boundary lies within ``TIE_ULPS`` f32 ulps of it
or within a floor (``TIE_FLOOR`` times the largest |output| of the warp's
block), and recomputes it in k order.  fp16's boundaries are denser than
bf16's (a normal value's step is 2^13 f32 ulps, not 2^16; subnormals step
by 2^-24), so more outputs are marked and a warp lists up to ``FIXW_F16``.
Here, on the CPU, seeded numpy weights at the reference widths and a few
tiles of points go through every tensor-core product in both orders, and
every output whose fp16 rounding differs must be one the rule marks.  No
kernel runs here.
"""
import functools
import re

import numpy as np
import pytest
import torch

from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp as fm
from test_torch_port_forward_tile import (HEADER, TP, WARPS_M, WARPS_N,
                                          _chunked, _header_constant,
                                          _header_ulps, _k_order)
from test_torch_port_models import np_nerf

POINTS = 640  # ten tiles


def _header_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text())
    assert m, f"{name} not found in {HEADER.name}"
    return int(m.group(1))


def _f16(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).astype(np.float16).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _products16() -> dict:
    """Every tensor-core product of the tile, in fp16: ``name -> (input
    rows (P, K) rounded to fp16, fp16 weight (K, N), f32 bias, ReLU?)``;
    the inputs from the plain forward's fp16 stash."""
    model = nerf_from_numpy(np_nerf(62), device="cpu")
    rng = np.random.RandomState(63)
    x = np.zeros((8, POINTS), np.float32)
    x[:3] = rng.uniform(-1.5, 1.5, (3, POINTS))
    d = rng.normal(size=(3, POINTS))
    x[3:6] = d / np.linalg.norm(d, axis=0)
    xt = torch.from_numpy(x)
    _, stash = fm.fused_nerf_stash_fwd_plain(model, xt, False, torch.float16)
    st = stash.float().numpy()
    xe, de = (_f16(t.numpy()) for t in fm._raw_embed(xt, False))
    w = fm.W
    acts = [xe] + [st[:, i * w:(i + 1) * w] for i in range(fm.D)]
    dense = fm.dense_layers(model)
    out = {f"layer {i}": (np.concatenate([xe, acts[i]], 1) if i == fm.SKIP
                          else acts[i], dense[i], True) for i in range(fm.D)}
    out["fin"] = (acts[fm.D], dense[fm.D + 1], False)
    fin = st[:, fm.STASH_FIN:fm.STASH_D]
    out["dir head"] = (np.concatenate([fin, de], 1), dense[fm.D + 2], True)
    return {k: (a, _f16(m.w.detach().numpy()),
                m.b.detach().numpy().astype(np.float32), relu)
            for k, (a, m, relu) in out.items()}


def _marks16(x, relu, ulps, floor_rel):
    """The fp16 rule on the pre-ReLU outputs x (P, N): the floor is
    floor_rel times max |x| over each warp's block of TP / 2 points and N /
    4 columns; an output is marked where the nearer boundary of its fp16
    rounding interval (the midpoints to its rounded value's neighbours,
    65,520 above 65,504, -2^-25 below 0) lies within ``ulps`` f32 ulps of
    x or within the floor; under the ReLU a negative x only where |x| <
    floor."""
    P, N = x.shape
    blocks = np.abs(x).reshape(P // (TP // WARPS_M), TP // WARPS_M, WARPS_N,
                               N // WARPS_N).max(axis=(1, 3))
    floor = np.repeat(np.repeat(blocks, TP // WARPS_M, 0), N // WARPS_N,
                      1).astype(np.float32) * np.float32(floor_rel)
    a = np.abs(x).astype(np.float32)
    hb = a.astype(np.float16).view(np.uint16).astype(np.int32)
    r = hb.astype(np.uint16).view(np.float16).astype(np.float32)
    nxt = np.minimum(hb + 1, 0x7C00).astype(np.uint16).view(
        np.float16).astype(np.float32)
    prv = np.maximum(hb - 1, 0).astype(np.uint16).view(
        np.float16).astype(np.float32)
    hi = np.where(hb == 0x7BFF, np.float32(65520), 0.5 * (r + nxt))
    lo = np.where(hb == 0, -hi, 0.5 * (r + prv))
    gap = np.minimum(hi - a, a - lo)
    margin = (a.view(np.int32) & 0x7F800000).view(np.float32) * np.float32(
        ulps / 2.0 ** 23)
    near = gap < np.maximum(margin, floor)
    if relu:
        near = np.where(x < 0, a < floor, near)
    return near


def test_fp16_header_constants():
    """The fp16 rule keeps bf16's margins (they bound the gap between the
    two f32 sum orders, which the format does not change) and lists up to
    FIXW_F16 marks a warp: twice a 256-column product's mean of 2 TIE_ULPS
    / 2^13 of 2,048 outputs; the dtype codes match the wrappers'."""
    fixw16 = _header_int("FIXW_F16")
    assert fixw16 == 320 and _header_int("FIXW") == 64
    assert 2 * 2048 * 2 * _header_ulps() // 2 ** 13 <= fixw16
    assert _header_constant("TIE_FLOOR") == 2.0 ** -20
    enum = re.search(r"enum DType : int \{ DTYPE_F32 = (\d), DTYPE_BF16 = "
                     r"(\d), DTYPE_F16 = (\d) \};", HEADER.read_text())
    assert enum and tuple(map(int, enum.groups())) == (
        fm.DTYPE_CODES[torch.float32], fm.DTYPE_CODES[torch.bfloat16],
        fm.DTYPE_CODES[torch.float16])


@pytest.mark.parametrize("name", [f"layer {i}" for i in range(8)]
                         + ["fin", "dir head"])
def test_fp16_tie_rule_covers_the_tensor_core_order(name):
    a, w, b, relu = _products16()[name]
    ulps = _header_ulps()
    floor_rel = _header_constant("TIE_FLOOR")
    ref = (_k_order(a, w) + b).astype(np.float32)
    for chunk_sum in ("exact", "f32"):
        x = (_chunked(a, w, chunk_sum) + b).astype(np.float32)
        ref_out, out = ((np.maximum(ref, 0), np.maximum(x, 0)) if relu
                        else (ref, x))
        differ = _f16(ref_out) != _f16(out)
        marked = _marks16(x, relu, ulps, floor_rel)
        assert marked.any()
        missed = np.argwhere(differ & ~marked)
        assert missed.size == 0, (
            f"{name} ({chunk_sum}): {len(missed)} outputs round differently "
            f"in the two orders and are not marked, e.g. {missed[:4]}")
        # no warp's block overflows the FIXW_F16 marks it lists a product
        P, N = x.shape
        per_warp = marked.reshape(P // (TP // WARPS_M), TP // WARPS_M,
                                  WARPS_N, N // WARPS_N).sum(axis=(1, 3))
        assert per_warp.max() <= _header_int("FIXW_F16"), per_warp.max()


def test_fp16_kernel_interface():
    """float16 takes bf16's tensor-core routes in the backward's job table;
    the wrappers take float32, bfloat16 and float16 and refuse others; the
    launch counter's grids follow the backward's point chunks."""
    for so in (False, True):
        jobs16 = fm.wgrad_jobs(so, torch.float16)
        assert jobs16 == fm.wgrad_jobs(so, torch.bfloat16)
        assert {j[-1] for j in jobs16} == {fm.ROUTE_TC, fm.ROUTE_NARROW}
        assert {j[-1] for j in fm.wgrad_jobs(so, torch.float32)} == {
            fm.ROUTE_SCALAR}
    assert [fm._check_dtype(t) for t in (torch.float32, torch.bfloat16,
                                         torch.float16)] == [0, 1, 2]
    with pytest.raises(TypeError, match="float16"):
        fm._check_dtype(torch.float64)
    raw = torch.zeros((fm.RAW_COLS, 1))
    assert [fm._bwd_grids(raw.expand(-1, n), False) for n in (
        262_144, 262_145, 786_432)] == [1, 2, 3]
    model = nerf_from_numpy(np_nerf(64), device="cpu")
    wbuf, _ = fm.pack_weights(model, torch.float16)
    assert wbuf.dtype == torch.float16
    # a CPU tensor is refused by every kernel's wrapper, in fp16 too
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_nerf_stash_fwd_cuda(model, torch.zeros((8, 64)), False,
                                     torch.float16)
