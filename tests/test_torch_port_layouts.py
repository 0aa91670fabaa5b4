"""The index arithmetic of the redesigned kernels A, B and E on the CPU.

Kernels A and B (``csrc/searchsorted.cu``) bisect each row instead of
counting it: that is exact on non-decreasing rows.  The CDF rows that both
packages' ``sample_pdf`` hand to ``searchsorted`` are checked to be
non-decreasing, with float plateaus, and the kernels' halving loop (mirrored
here in numpy) is held bit for bit against the plain count,
``torch.searchsorted`` and the Pallas kernel in interpret mode; B's two reads
of the row at the rank against the masked max and min of
``searchsorted_interp_plain``, ``searchsorted_interp_jnp`` and the Pallas
kernel.

Kernel E's weight-grad pass runs a job table that the wrapper builds
(``fused_mlp.wgrad_jobs``) over the stash and the G buffer: each job is
held against the packed weight layout and the JAX package's parameter
shapes, and the table applied to the plain version's stash and G buffer
reproduces the plain backward's weight grads.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.ops import sampling as jsamp
from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp, sampling
from nerf_pl_tpu_torch.ops import searchsorted as ss

from test_torch_port_models import np_nerf

jss = importlib.import_module("nerf_pl_tpu.ops.searchsorted")


# ------------------------------------------------------------- kernel A
def _bisect_like_kernel(rows, vals, side):
    """``rank_kernel``'s loop: from the smallest power of two ``top`` with
    2 top - 1 >= M, halving steps that move ``base`` up to ``probe`` when
    ``probe <= M`` and row[probe - 1] compares true."""
    M = rows.shape[1]
    top = 1
    while 2 * top - 1 < M:
        top *= 2
    base = np.zeros(vals.shape, np.int64)
    half = top
    while half:
        probe = base + half
        c = np.take_along_axis(rows, np.minimum(probe, M) - 1, axis=1)
        hit = vals >= c if side == "right" else vals > c
        base = np.where((probe <= M) & hit, probe, base)
        half //= 2
    return base.astype(np.int32)


def _plateau_weights(rng, B, n):
    """Weights where a heavy bin (1e3) stands before a near-empty one
    (1e-30): past the heavy bins the small increments vanish in the float
    cumulative sum, so the CDF rows hold exact plateaus."""
    w = rng.uniform(size=(B, n)).astype(np.float32)
    w[:, ::4] = 1e3
    w[:, 1::4] = 1e-30
    w[::3] = 0.0  # empty rays: the CDF comes from eps alone
    return w


def _captured_cdfs(monkeypatch, B, M, seed):
    """The CDF rows that the port's and the JAX package's ``sample_pdf``
    (random mode, injected draws) pass to ``searchsorted``."""
    rng = np.random.RandomState(seed)
    w = _plateau_weights(rng, B, M - 1)
    rays = np.concatenate([rng.normal(size=(B, 6)), np.full((B, 1), 2.0),
                           np.full((B, 1), 6.0)], 1).astype(np.float32)
    u = rng.uniform(size=(B, 16)).astype(np.float32)
    jit = rng.uniform(size=(B, 16)).astype(np.float32)
    got = {}

    def capture(name, real):
        def fn(seq, vals, side="right"):
            got[name] = np.array(seq)
            return real(seq, vals, side=side)
        return fn

    monkeypatch.setattr(sampling, "searchsorted",
                        capture("port", sampling.searchsorted))
    monkeypatch.setattr(jsamp, "searchsorted",
                        capture("jax", jsamp.searchsorted))
    sampling.sample_pdf(torch.from_numpy(rays), torch.from_numpy(w), 16,
                        u=torch.from_numpy(u), jitter=torch.from_numpy(jit))
    jsamp.sample_pdf(jnp.asarray(rays), jnp.asarray(w), 16, u=jnp.asarray(u),
                     jitter=jnp.asarray(jit))
    return got["port"], got["jax"]


def _queries(rng, rows, K):
    """Draws in [0, 1), exactly 0 and 1, and exact row entries (on the
    plateaus too)."""
    B, M = rows.shape
    vals = rng.uniform(size=(B, K)).astype(np.float32)
    vals[:, 0], vals[:, 1] = 0.0, 1.0
    cols = rng.randint(0, M, (B, K // 2))
    vals[:, 2:2 + K // 2] = np.take_along_axis(rows, cols, axis=1)
    return vals


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("M", [1, 2, 63, 64])
def test_rank_bisection_is_exact_on_cdf_rows(M, side, monkeypatch):
    rng = np.random.RandomState(M)
    B = 24
    if M == 1:  # no sampler makes a one-entry row: single values
        rows_sets = [rng.uniform(size=(B, 1)).astype(np.float32)]
        rows_sets[0][:4] = 0.0
    else:
        port, jax_rows = _captured_cdfs(monkeypatch, B, M, seed=10 + M)
        # the same rows up to the order of the float32 cumulative sums
        np.testing.assert_allclose(port, jax_rows, rtol=0, atol=1e-6)
        rows_sets = [port, jax_rows]
    for rows in rows_sets:
        assert rows.shape == (B, M)
        # the kernel's contract: every row non-decreasing
        assert (np.diff(rows, axis=1) >= 0).all()
        if M >= 63:  # the plateau weights leave exact ties in the rows
            assert (np.diff(rows, axis=1) == 0).sum() > B
        vals = _queries(rng, rows, 40)
        plain = ss.searchsorted_plain(torch.from_numpy(rows),
                                      torch.from_numpy(vals), side).numpy()
        lib = torch.searchsorted(torch.from_numpy(rows),
                                 torch.from_numpy(vals),
                                 right=(side == "right")).numpy()
        pal = np.asarray(jss.searchsorted_pallas(
            jnp.asarray(rows), jnp.asarray(vals), side=side, block_b=8,
            interpret=True))
        np.testing.assert_array_equal(plain, lib)
        np.testing.assert_array_equal(plain, pal)
        np.testing.assert_array_equal(plain,
                                      _bisect_like_kernel(rows, vals, side))


def _interp_like_kernel(rows, vals):
    """``rank_kernel``'s INTERP epilogue: the rank by bisection, then lo and
    hi read off the row at the rank."""
    M = rows.shape[1]
    rank = _bisect_like_kernel(rows, vals, "right").astype(np.int64)
    j = np.minimum(rank, M - 1)
    lo = np.where(j > 0, np.take_along_axis(rows, np.maximum(j - 1, 0), 1),
                  np.float32(0.0))
    hi = np.take_along_axis(rows, np.minimum(np.maximum(rank, 1), M - 1), 1)
    return rank.astype(np.int32), lo.astype(np.float32), hi


@pytest.mark.parametrize("M", [2, 63, 127])
def test_interp_bisection_reads_the_plain_endpoints(M, monkeypatch):
    rng = np.random.RandomState(100 + M)
    B = 24
    port, jax_rows = _captured_cdfs(monkeypatch, B, M, seed=20 + M)
    for rows in (port, jax_rows):
        # B's contract: non-decreasing and non-negative rows
        assert (np.diff(rows, axis=1) >= 0).all() and (rows >= 0).all()
        if M >= 63:
            assert (np.diff(rows, axis=1) == 0).sum() > B
        vals = _queries(rng, rows, 40)
        vals[:, 3] = 1.5  # past the row's end
        vals[:, 4] = np.nan  # no hit: rank 0, lo 0, hi row[1]
        vals[:, 5] = rows[:, -1]  # at the last entry
        mine = _interp_like_kernel(rows, vals)
        plain = ss.searchsorted_interp_plain(torch.from_numpy(rows),
                                             torch.from_numpy(vals))
        jnp_out = jss.searchsorted_interp_jnp(jnp.asarray(rows),
                                              jnp.asarray(vals))
        pal = jss.searchsorted_interp_pallas(jnp.asarray(rows),
                                             jnp.asarray(vals), block_b=8,
                                             interpret=True)
        for got, p, j, k in zip(mine, plain, jnp_out, pal):
            np.testing.assert_array_equal(got, p.numpy())
            np.testing.assert_array_equal(got, np.asarray(j))
            np.testing.assert_array_equal(got, np.asarray(k))
        # the reads land where the reductions would: the same bits
        for got, p in zip(mine[1:], plain[1:]):
            assert got.view(np.uint32).tolist() == \
                p.numpy().view(np.uint32).tolist()


@pytest.mark.parametrize("offset,K,width", [
    (0, 128, 4), (1, 128, 1), (2, 128, 1), (3, 128, 1), (4, 128, 4),
    (0, 6, 1), (0, 1, 1)])
def test_rank_vector_width_follows_the_alignment(offset, K, width):
    # kernel A moves 4 queries as one 16-byte vector only where every row of
    # values starts on 16 bytes; a contiguous view at another offset (here
    # `offset` floats into a fresh allocation) takes one query a thread
    base = torch.zeros(8 * K + 8)
    values = base[offset:offset + 8 * K].view(8, K)
    assert values.is_contiguous() and base.data_ptr() % 16 == 0
    assert ss.rank_vector_width(values.data_ptr(), K) == width


# ------------------------------------------------------------- kernel E
def _dense_shapes(tree):
    """The JAX parameter tree's kernel shapes in the packing order
    (``dense_layers``: W_0..W_7, sigma, xyz_final, dir_layer, rgb)."""
    layers = list(tree["xyz_layers"]) + [tree[k] for k in (
        "sigma", "xyz_final", "dir_layer", "rgb")]
    return [layer["w"].shape for layer in layers]


def test_block_offsets_match_the_packed_weights():
    tree = np_nerf(30)
    shapes = _dense_shapes(tree)
    sizes = [a * b for a, b in shapes]
    off = fused_mlp.block_offsets()
    assert off == [sum(sizes[:i]) for i in range(len(sizes))]
    assert off[-1] + sizes[-1] == 593_408  # N_WEIGHTS of the kernels
    # the bf16 sweep streams each block in 16-byte vectors: 8 elements
    assert all(o % 8 == 0 for o in off[1:])
    model = nerf_from_numpy(tree, device="cpu")
    wbuf, _ = fused_mlp.pack_weights(model, torch.float32)
    for o, shape, m in zip(off, shapes, fused_mlp.dense_layers(model)):
        block = wbuf[o:o + shape[0] * shape[1]].view(shape)
        assert torch.equal(block, m.w.detach())


def test_bwd_operands_and_g_layout():
    # G buffer columns: each block on 8 elements, rows of 16-byte multiples
    starts = fused_mlp.G_LAYOUT[:-1]
    assert list(starts) == sorted(starts)
    assert all(c % 8 == 0 for c in fused_mlp.G_LAYOUT)
    assert fused_mlp.G_LAYOUT[0] == fused_mlp.D * fused_mlp.W
    assert fused_mlp.G_COLS * 2 % 16 == 0
    for so in (False, True):
        assert fused_mlp.stash_cols(so) * 2 % 16 == 0
    # the scalar (f32) sweep's operands: the transposes of the h rows
    model = nerf_from_numpy(np_nerf(31), device="cpu")
    wt = fused_mlp.pack_weights_t(model, torch.float32)
    W, WH = fused_mlp.W, fused_mlp.WH
    blocks = torch.split(wt, [W * W] * 8 + [WH * W])
    rows = [model.xyz_layers[i].w[-W:] for i in range(1, 8)]
    rows += [model.xyz_final.w, model.dir_layer.w[:W]]
    for block, w in zip(blocks, rows):
        assert torch.equal(block.view(w.shape[1], W), w.detach().T)


@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_wgrad_jobs_cover_the_packed_weights(dtype, sigma_only):
    tree = np_nerf(32)
    shapes = _dense_shapes(tree)
    off = fused_mlp.block_offsets()
    jobs = fused_mlp.wgrad_jobs(sigma_only, dtype)
    assert all(len(j) == len(fused_mlp.WGRAD_JOB_FIELDS) for j in jobs)
    assert len(jobs) == (10 if sigma_only else 14)
    covered = np.zeros(593_408, np.int32)
    sc = fused_mlp.stash_cols(sigma_only)
    for a_in_g, a_col, K, g_col, N, out, route in jobs:
        covered[out:out + K * N] += 1
        # the a_in and g_pre columns lie in their rows
        assert 0 <= a_col and a_col + K <= (fused_mlp.G_COLS if a_in_g
                                            else sc)
        assert 0 <= g_col and g_col + N <= fused_mlp.G_COLS
        # the output block is a row range of one packed layer
        layer = max(i for i, o in enumerate(off) if o <= out)
        fan_in, fan_out = shapes[layer]
        assert N == fan_out and (out - off[layer]) % N == 0
        assert (out - off[layer]) // N + K <= fan_in
        # the route: in bf16 the tensor cores for 128 or more columns, on
        # 16-byte aligned columns, and the narrow kernel (N <= 4, K <= 256)
        # for the heads; in f32 the scalar kernel
        if dtype == torch.float32:
            assert route == fused_mlp.ROUTE_SCALAR
        elif N >= 128:
            assert route == fused_mlp.ROUTE_TC
            assert a_col % 8 == 0 and g_col % 8 == 0
        else:
            # one 16-byte a_in vector a lane, one 8-byte g_pre read a point
            assert route == fused_mlp.ROUTE_NARROW and N <= 4 and K <= 256
            assert K % 8 == 0 and a_col % 8 == 0 and g_col % 4 == 0
    assert covered.max() == 1
    n_live = off[8] + 256 if sigma_only else 593_408  # the trunk and sigma
    assert covered[:n_live].all() and not covered[n_live:].any()


@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_wgrad_jobs_reproduce_the_plain_weight_grads(dtype, sigma_only):
    """The job table applied to the plain version's stash and G buffer
    (the columns that the kernels never write hold NaN) gives the plain
    backward's weight grads."""
    rng = np.random.RandomState(33)
    model = nerf_from_numpy(np_nerf(34), device="cpu")
    P = 150
    x = np.zeros((8, P), np.float32)
    x[:3] = rng.uniform(-1.5, 1.5, (3, P))
    d = rng.normal(size=(3, P))
    x[3:6] = d / np.linalg.norm(d, axis=0)
    x = torch.from_numpy(x)
    g = torch.from_numpy(rng.normal(size=(8, P)).astype(np.float32))
    with torch.no_grad():
        _, stash = fused_mlp.fused_nerf_stash_fwd_plain(model, x, sigma_only,
                                                        dtype)
        gbuf = torch.full((P, fused_mlp.G_COLS), float("nan"))
        xe, de = fused_mlp._raw_embed(x, sigma_only)
        dw, _, _ = fused_mlp._bwd_plain(model, xe, de, g, sigma_only, dtype,
                                        stash, gbuf=gbuf)
        a_rows = {0: stash.float(), 1: gbuf}
        mine = torch.zeros_like(dw)
        for a_in_g, a_col, K, g_col, N, out, _ in fused_mlp.wgrad_jobs(
                sigma_only, dtype):
            a = a_rows[a_in_g][:, a_col:a_col + K]
            gp = gbuf[:, g_col:g_col + N]
            assert torch.isfinite(a).all() and torch.isfinite(gp).all()
            mine[out:out + K * N] = (a.T @ gp).reshape(-1)
    np.testing.assert_allclose(mine.numpy(), dw.numpy(), rtol=1e-5,
                               atol=1e-6 * float(dw.abs().max()))
