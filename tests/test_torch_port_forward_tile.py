"""The bf16 forward tile's rounding-tie rule (``csrc/fused_mlp_common.cuh``).

Kernels C, D and G, and the recompute of F and H, run each bf16 product
of the fused MLP on the tensor cores: 16-term sums, each started from zero,
added in f32.  The scalar loops they replace, and the rule the tile keeps,
sum each output in f32 one term at a time in k order.  The tile marks every
output within ``TIE_ULPS`` f32 ulps (at least ``TIE_MARGIN`` relative) or a
floor (``TIE_FLOOR`` times the largest |output| of the warp's 32-point
block of columns) of a bf16 rounding tie, and every output below 256
floors, and recomputes it in k order.  Here, on the CPU, seeded numpy
weights at the reference widths (through ``nerf_from_numpy``) and a few
hundred embedded points go through every tensor-core product of the tile in
both orders, and every output whose bf16 rounding differs between them must
be one the rule marks.  No kernel runs here.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp as fm
from test_torch_port_models import np_nerf

HEADER = (Path(fm.__file__).resolve().parent.parent / "csrc"
          / "fused_mlp_common.cuh")
TP, WARPS_M, WARPS_N, FIXW = 64, 2, 4, 64  # Ref's tile and warp grid
POINTS = 320  # five tiles


def _header_constant(name: str) -> float:
    m = re.search(rf"constexpr float {name} = 1\.0f / (\d+)\.0f;",
                  HEADER.read_text())
    assert m, f"{name} not found in {HEADER.name}"
    return 1.0 / float(m.group(1))


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _products() -> dict:
    """Every tensor-core product of the tile (trunk layers 0-7, fin, the dir
    head): ``name -> (input rows (P, K) rounded to bf16, bf16 weight (K,
    N), f32 bias, ReLU?)``; the inputs from the plain forward's stash."""
    model = nerf_from_numpy(np_nerf(60), device="cpu")
    rng = np.random.RandomState(61)
    x = np.zeros((8, POINTS), np.float32)
    x[:3] = rng.uniform(-1.5, 1.5, (3, POINTS))
    d = rng.normal(size=(3, POINTS))
    x[3:6] = d / np.linalg.norm(d, axis=0)
    xt = torch.from_numpy(x)
    _, stash = fm.fused_nerf_stash_fwd_plain(model, xt, False, torch.bfloat16)
    st = stash.float().numpy()
    xe, de = (t.numpy() for t in fm._raw_embed(xt, False))
    xe, de = _bf16(xe), _bf16(de)
    w = fm.W
    acts = [xe] + [st[:, i * w:(i + 1) * w] for i in range(fm.D)]
    dense = fm.dense_layers(model)
    out = {}
    for i in range(fm.D):
        a = np.concatenate([xe, acts[i]], 1) if i == fm.SKIP else acts[i]
        out[f"layer {i}"] = (a, dense[i], True)
    out["fin"] = (acts[fm.D], dense[fm.D + 1], False)
    fin = st[:, fm.STASH_FIN:fm.STASH_D]
    out["dir head"] = (np.concatenate([fin, de], 1), dense[fm.D + 2], True)
    return {k: (a, _bf16(m.w.detach().numpy()),
                m.b.detach().numpy().astype(np.float32), relu)
            for k, (a, m, relu) in out.items()}


def _k_order(a, w):
    """One f32 sum a output, one term at a time in k order (each product
    of two bf16 values is exact in f32)."""
    s = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(a.shape[1]):
        s = (s + a[:, k:k + 1] * w[k]).astype(np.float32)
    return s


def _chunked(a, w, chunk_sum):
    """16-term chunks, each started from zero, then added in f32: each
    chunk exact and rounded to f32 once (``exact``), or summed in f32 in k
    order (``f32``)."""
    s = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        ak, wk = a[:, k0:k0 + 16], w[k0:k0 + 16]
        if chunk_sum == "exact":
            t = (ak.astype(np.float64) @ wk.astype(np.float64)).astype(
                np.float32)
        else:
            t = _k_order(ak, wk)
        s = (s + t).astype(np.float32)
    return s


def _marks(x, relu, ulps, floor_rel):
    """The tile's rule on the pre-ReLU outputs x (P, N): the floor is
    floor_rel times max |x| over each warp's block of TP / 2 points and N /
    4 columns; an output is marked where the tie of its own bf16 interval
    lies within ``ulps`` f32 ulps of x or within the floor, or where |x| <
    256 floors (bf16 steps finer than twice the floor); under the ReLU a
    negative x only where |x| < floor."""
    P, N = x.shape
    blocks = np.abs(x).reshape(P // (TP // WARPS_M), TP // WARPS_M, WARPS_N,
                               N // WARPS_N).max(axis=(1, 3))
    floor = np.repeat(np.repeat(blocks, TP // WARPS_M, 0), N // WARPS_N,
                      1).astype(np.float32) * np.float32(floor_rel)
    u = x.view(np.uint32)
    low = (u & np.uint32(0xFFFF)).astype(np.int64)
    tie = ((u & np.uint32(0xFFFF0000)) | np.uint32(0x8000)).view(np.float32)
    a = np.abs(x)
    near = ((np.abs(low - 0x8000) < ulps) | (a < 256 * floor)
            | (np.abs(x - tie) < floor))
    if relu:
        near = np.where(x < 0, a < floor, near)
    return near


def _header_ulps() -> int:
    m = re.search(r"constexpr unsigned TIE_ULPS = (\d+);", HEADER.read_text())
    assert m, f"TIE_ULPS not found in {HEADER.name}"
    return int(m.group(1))


def test_header_constants():
    # TIE_ULPS ulps of x are at least TIE_MARGIN |x| (an ulp is at least
    # 2^-24 |x|)
    assert _header_ulps() * 2.0 ** -24 == _header_constant("TIE_MARGIN")
    assert _header_constant("TIE_MARGIN") == 2.0 ** -16
    assert _header_constant("TIE_FLOOR") == 2.0 ** -20
    assert f"constexpr int FIXW = {FIXW};" in HEADER.read_text()


@pytest.mark.parametrize("chunk_sum", ["exact", "f32"])
@pytest.mark.parametrize("name", [f"layer {i}" for i in range(8)]
                         + ["fin", "dir head"])
def test_tie_rule_covers_the_tensor_core_order(name, chunk_sum):
    a, w, b, relu = _products()[name]
    ulps = _header_ulps()
    floor_rel = _header_constant("TIE_FLOOR")
    ref = (_k_order(a, w) + b).astype(np.float32)
    x = (_chunked(a, w, chunk_sum) + b).astype(np.float32)
    if relu:
        ref_out, out = np.maximum(ref, 0), np.maximum(x, 0)
    else:
        ref_out, out = ref, x
    differ = _bf16(ref_out) != _bf16(out)
    marked = _marks(x, relu, ulps, floor_rel)
    assert differ.sum() <= marked.sum()
    missed = np.argwhere(differ & ~marked)
    assert missed.size == 0, (
        f"{name}: {len(missed)} outputs round differently in the two orders "
        f"and are not marked, e.g. (point, column) {missed[:4].tolist()}")
    # no warp's block overflows the FIXW marks it lists a product
    P, N = x.shape
    per_warp = marked.reshape(P // (TP // WARPS_M), TP // WARPS_M, WARPS_N,
                              N // WARPS_N).sum(axis=(1, 3))
    assert per_warp.max() <= FIXW, per_warp.max()
