"""The port's ops (``nerf_pl_tpu_torch.ops``) against the JAX package on the
CPU: compositing, rays, sampling, both searchsorted kernels' plain versions
and the fused MLP's plain version, the last three also against the Pallas
kernels run in interpret mode.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.ops import compositing as jcomp
from nerf_pl_tpu.ops import fused_mlp as jfused
from nerf_pl_tpu.ops import ray_utils as jrays
from nerf_pl_tpu.ops import sampling as jsamp
from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy
from nerf_pl_tpu_torch.ops import compositing, fused_mlp, ray_utils, sampling
from nerf_pl_tpu_torch.ops import searchsorted as ss

from test_torch_port_models import np_nerf

# the JAX ops package re-exports the function under the module's name
jss = importlib.import_module("nerf_pl_tpu.ops.searchsorted")


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- compositing
@pytest.mark.parametrize("white_back", [False, True])
def test_compositing_matches_jax(white_back):
    rng = np.random.RandomState(0)
    n, s = 32, 24
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    sig = rng.normal(0, 3, (n, s)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)  # not normalised
    noise = rng.normal(size=(n, s)).astype(np.float32)
    rgbs = rng.uniform(size=(n, s, 3)).astype(np.float32)
    wj = jcomp.compute_weights(jnp.asarray(sig), jnp.asarray(z), jnp.asarray(dirs),
                               1.0, noise=jnp.asarray(noise))
    wt = compositing.compute_weights(t(sig), t(z), t(dirs), 1.0, noise=t(noise))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6, rtol=0)
    # noise_std=0 and no injected noise: no generator is needed
    w0 = compositing.compute_weights(t(sig), t(z), t(dirs), 0.0)
    wj0 = jcomp.compute_weights(jnp.asarray(sig), jnp.asarray(z), jnp.asarray(dirs), 0.0)
    np.testing.assert_allclose(w0.numpy(), np.asarray(wj0), atol=1e-6, rtol=0)
    cj = jcomp.composite(wj, jnp.asarray(z), jnp.asarray(rgbs), white_back)
    ct = compositing.composite(wt, t(z), t(rgbs), white_back)
    assert set(ct) == set(cj) == {"rgb", "depth", "opacity", "disp"}
    for k in cj:
        # f32 reductions over 24 samples in another order
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- rays
def test_rays_match_jax():
    d_ref = jrays.get_ray_directions(6, 5, 7.5)
    d = ray_utils.get_ray_directions(6, 5, 7.5, device="cpu")
    np.testing.assert_array_equal(d.numpy(), d_ref)
    c2w = np.random.RandomState(1).normal(size=(3, 4)).astype(np.float32)
    o_ref, dd_ref = jrays.get_rays(d_ref, c2w)
    o, dd = ray_utils.get_rays(d, t(c2w))
    np.testing.assert_array_equal(o.numpy(), o_ref)
    np.testing.assert_allclose(dd.numpy(), dd_ref, atol=1e-6, rtol=0)


# ---------------------------------------------------------------- sampling
@pytest.mark.parametrize("use_disp", [False, True])
def test_stratified_and_perturbed_z_match_jax(use_disp):
    rng = np.random.RandomState(2)
    near = rng.uniform(1, 2, (8, 1)).astype(np.float32)
    far = near + rng.uniform(1, 4, (8, 1)).astype(np.float32)
    zj = jsamp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16, use_disp)
    zt = sampling.stratified_z_vals(t(near), t(far), 16, use_disp)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-6, rtol=1e-6)
    rand = rng.uniform(size=(8, 16)).astype(np.float32)
    pj = jsamp.perturb_z_vals(zj, 1.0, rand=jnp.asarray(rand))
    pt = sampling.perturb_z_vals(zt, 1.0, rand=t(rand))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=1e-6)


def test_unit_steps_are_the_bits_of_jnp_linspace():
    """The [0, 1] steps of the stratified depths and of det sampling equal
    ``jnp.linspace``'s bits (``torch.linspace`` rounds some the other way),
    so the shadow loader's depths over [1, 200] equal JAX's to the bit: at
    |x| ~ 100 one ulp of a sample moves the 2^9-frequency encoding by ~4e-3
    rad."""
    for n in list(range(0, 40)) + [42, 48, 56, 62, 64, 83, 96, 128, 192, 256]:
        np.testing.assert_array_equal(
            sampling.unit_steps(n).numpy(),
            np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)), str(n))
    near = np.ones((4, 1), np.float32)
    far = np.full((4, 1), 200.0, np.float32)
    for n in (8, 64, 128):
        np.testing.assert_array_equal(
            sampling.stratified_z_vals(t(near), t(far), n).numpy(),
            np.asarray(jsamp.stratified_z_vals(jnp.asarray(near),
                                               jnp.asarray(far), n)))


def _pdf_inputs(seed, n=24, s=14, k=16):
    rng = np.random.RandomState(seed)
    rays = np.concatenate([rng.normal(size=(n, 6)), np.full((n, 1), 2.0),
                           np.full((n, 1), 6.0)], 1).astype(np.float32)
    w = rng.exponential(size=(n, s)).astype(np.float32)
    w[:3] = 0.0  # empty rays: the CDF comes from eps alone
    return rays, w, rng.uniform(size=(n, k)).astype(np.float32), \
        rng.uniform(size=(n, k)).astype(np.float32)


@pytest.mark.parametrize("mode", ["det", "injected_u_jitter", "det_with_jitter"])
def test_sample_pdf_matches_jax(mode):
    rays, w, u, jit = _pdf_inputs(3)
    u[:, -1] = 1.0  # past the last CDF entry: both ends are clamped
    kw_j, kw_t = {}, {}
    if mode != "det":
        kw_j["jitter"], kw_t["jitter"] = jnp.asarray(jit), t(jit)
    if mode == "injected_u_jitter":
        kw_j["u"], kw_t["u"] = jnp.asarray(u), t(u)
    det = mode != "injected_u_jitter"
    ref = np.asarray(jsamp.sample_pdf(jnp.asarray(rays), jnp.asarray(w), 16, det=det, **kw_j))
    out = sampling.sample_pdf(t(rays), t(w), 16, det=det, **kw_t).numpy()
    assert out.shape == (24, 16)
    assert (out >= 2.0 - 1e-5).all() and (out <= 6.0 + 1e-5).all()
    # the same f32 cumsum/divide; a u within an ulp of a CDF entry could
    # move by one bin, which this seed does not hit
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_sample_pdf_random_needs_a_generator():
    rays, w, u, _ = _pdf_inputs(4)
    with pytest.raises(ValueError, match="generator"):
        sampling.sample_pdf(t(rays), t(w), 16, det=False, u=t(u))
    g = torch.Generator().manual_seed(0)
    z = sampling.sample_pdf(t(rays), t(w), 16, det=False, generator=g)
    assert z.shape == (24, 16) and torch.isfinite(z).all()


# ------------------------------------------------------------ searchsorted
def _sorted_rows(seed, B=40, M=17, K=33):
    """CDF-like rows with ties, and queries that hit row values exactly,
    0.0 and 1.0."""
    rng = np.random.RandomState(seed)
    w = rng.exponential(size=(B, M - 1)).astype(np.float32)
    w[::4, 3:6] = 0.0  # repeated CDF values (ties)
    cdf = np.cumsum(w / w.sum(-1, keepdims=True), -1).astype(np.float32)
    rows = np.concatenate([np.zeros((B, 1), np.float32), cdf], 1)
    rows[:, -1] = 1.0
    vals = rng.uniform(size=(B, K)).astype(np.float32)
    vals[:, 0], vals[:, 1], vals[:, 2] = 0.0, 1.0, 1.5
    vals[:, 3:8] = rows[:, 2:7]  # exactly on row values, ties included
    return rows, vals


@pytest.mark.parametrize("side", ["right", "left"])
def test_searchsorted_plain_matches_jnp_and_pallas(side):
    rows, vals = _sorted_rows(5)
    out = ss.searchsorted(t(rows), t(vals), side)
    assert out.dtype == torch.int32
    ref = np.asarray(jss.searchsorted_jnp(jnp.asarray(rows), jnp.asarray(vals), side))
    pal = np.asarray(jss.searchsorted_pallas(jnp.asarray(rows), jnp.asarray(vals),
                                             side=side, block_b=8, interpret=True))
    # integer ranks from the same compares: exact
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), pal)
    lib = torch.searchsorted(t(rows), t(vals), right=(side == "right"))
    np.testing.assert_array_equal(out.numpy(), lib.numpy())


def test_searchsorted_interp_plain_matches_jnp_and_pallas():
    rows, vals = _sorted_rows(6)
    r, lo, hi = ss.searchsorted_interp(t(rows), t(vals))
    jr = [np.asarray(a) for a in jss.searchsorted_interp_jnp(jnp.asarray(rows), jnp.asarray(vals))]
    pr = [np.asarray(a) for a in jss.searchsorted_interp_pallas(
        jnp.asarray(rows), jnp.asarray(vals), block_b=8, interpret=True)]
    # compares, selects, min and max only: bit-exact
    for mine, a, b in zip((r, lo, hi), jr, pr):
        np.testing.assert_array_equal(mine.numpy(), a)
        np.testing.assert_array_equal(mine.numpy(), b)
    # lo defaults to 0 and hi to the row's last entry
    assert (lo.numpy()[:, 0] == 0.0).all()
    assert (hi.numpy()[:, 1] == rows[:, -1]).all()


def test_searchsorted_dispatch_follows_device():
    rows, vals = _sorted_rows(7)
    before = (ss.searchsorted_cuda.launches, ss.searchsorted_interp_cuda.launches)
    rows_t = t(rows).requires_grad_(True)
    out = ss.searchsorted(rows_t, t(vals))
    ss.searchsorted_interp(rows_t, t(vals))
    assert not out.requires_grad
    # the plain version ran: no launch was counted
    assert (ss.searchsorted_cuda.launches, ss.searchsorted_interp_cuda.launches) == before
    # the kernels' wrappers take only CUDA tensors
    with pytest.raises(ValueError, match="CUDA"):
        ss.searchsorted_cuda(t(rows), t(vals))
    with pytest.raises(ValueError, match="CUDA"):
        ss.searchsorted_interp_cuda(t(rows), t(vals))
    with pytest.raises(ValueError, match="side"):
        ss.searchsorted(t(rows), t(vals), side="middle")


# --------------------------------------------------------------- fused MLP
def _raw_t(seed, P):
    rng = np.random.RandomState(seed)
    x = np.zeros((8, P), np.float32)
    x[:3] = rng.uniform(-1.5, 1.5, (3, P))
    d = rng.normal(size=(3, P))
    x[3:6] = d / np.linalg.norm(d, axis=0)
    return x


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_raw_t_plain_matches_pallas_interpret(sigma_only, dtype):
    tree = np_nerf(8)  # the full reference architecture
    model = nerf_from_numpy(tree, device="cpu")
    assert fused_mlp.supports_fused(model)
    P = 300  # ragged: not a multiple of any block
    x = _raw_t(9, P)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = np.asarray(jfused.fused_nerf_apply_raw_t(
        tree, jnp.asarray(x), sigma_only=sigma_only, compute_dtype=jdt,
        block=(128, 128), interpret=True, stash_blocks=None))
    launches = fused_mlp.fused_nerf_apply_raw_t_cuda.launches
    with torch.no_grad():
        out = fused_mlp.fused_nerf_apply_raw_t(model, t(x), sigma_only, tdt).numpy()
    assert fused_mlp.fused_nerf_apply_raw_t_cuda.launches == launches
    assert out.shape == ref.shape == (8, P)
    live = 1 if sigma_only else 4
    np.testing.assert_array_equal(out[live:], 0.0)
    # f32: the Pallas kernel computes cos(t) as sin(t + pi/2), which moves an
    # embedding channel by up to ~1e-4 at 2^9-scaled arguments.  bf16: that
    # difference can also flip a channel's bf16 rounding (2^-8 relative)
    atol = 1e-4 if dtype == "float32" else 5e-3
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def test_fused_support_and_guards():
    narrow = nerf_from_numpy(np_nerf(10, D=6, W=32), device="cpu")
    assert not fused_mlp.supports_fused(narrow)
    model = nerf_from_numpy(np_nerf(11), device="cpu")
    x = t(_raw_t(12, 64))
    # every kernel's wrapper takes only CUDA tensors, trainable or not
    for fn in (fused_mlp.fused_nerf_apply_raw_t_cuda,
               fused_mlp.fused_nerf_stash_fwd_cuda,
               fused_mlp.fused_nerf_bwd_remat_cuda):
        args = (x,) if fn is not fused_mlp.fused_nerf_bwd_remat_cuda else (x, x)
        with pytest.raises(ValueError, match="CUDA"):
            fn(model, *args)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_nerf_bwd_stash_cuda(model, x, x, torch.zeros(64, 2432))
    model.requires_grad_(False)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_nerf_apply_raw_t_cuda(model, x)


def test_fused_pack_order_and_cache():
    model = nerf_from_numpy(np_nerf(13), device="cpu")
    w, b = fused_mlp.pack_weights(model, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert w.numel() == 593_408 and b.numel() == 8 * 256 + 1 + 256 + 128 + 3
    # W_0 first, then the trunk, sigma, xyz_final, dir_layer, rgb last
    np.testing.assert_array_equal(
        w[:63 * 256].float().numpy(),
        model.xyz_layers[0].w.detach().to(torch.bfloat16).float().numpy().ravel())
    np.testing.assert_array_equal(w[-384:].float().numpy(),
                                  model.rgb.w.detach().to(torch.bfloat16).float().numpy().ravel())
    assert fused_mlp.pack_weights(model, torch.bfloat16)[0] is w
    with torch.no_grad():
        model.rgb.w.add_(1.0)  # an in-place change invalidates the pack
    assert fused_mlp.pack_weights(model, torch.bfloat16)[0] is not w
