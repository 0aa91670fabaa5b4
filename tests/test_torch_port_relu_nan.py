"""The fused kernels' ReLU and its backward mask at a NaN or an Inf,
against the JAX package on the CPU.  ``jnp.maximum(v, 0)`` keeps a NaN, so a
NaN weight or input stays NaN in the outputs.  The backward's ``g * (h >
0)`` is compiled by XLA into a select (it rewrites a product by a converted
predicate), so an Inf or NaN cotangent under a zero mask gives 0, as
``jax.nn.relu``'s and torch's relu backward do.  The port's plain versions
(what the CUDA kernels are held to on the card) must put their NaN and Inf
where JAX's Pallas kernels, run in interpret mode, put them: the forward of
C' (and of C, point by point), the grads of the stash (D'/E') and remat
(F') routes, G's forward, H's grads with dx, and the probe's chain I.
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_pl_tpu.ops import fused_mlp as jfused
from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp
from nerf_pl_tpu_torch.scripts import kernel_probe

from test_torch_port_models import np_nerf
from test_torch_port_ops import _raw_t
from test_torch_port_wide import _embedded

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = 96
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _poisoned(case):
    """``(param tree, raw rays (8, P))`` with a NaN where ``case`` says:
    ``dir_bias`` one bias of the dir head (rgb NaN everywhere, sigma
    finite), ``trunk_weight`` one weight of trunk layer 6 (every output
    NaN), ``points`` the xyz of three rays (their columns NaN)."""
    tree = np_nerf(8)
    x = _raw_t(9, P)
    if case == "dir_bias":
        tree["dir_layer"]["b"][5] = np.nan
    elif case == "trunk_weight":
        tree["xyz_layers"][6]["w"][3, 11] = np.nan
    else:
        x[0, [4, 50, 95]] = np.nan
    return tree, x


def _same_nonfinite(out, ref, atol, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref), err_msg=what)
    np.testing.assert_array_equal(np.isposinf(out), np.isposinf(ref),
                                  err_msg=what)
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref),
                                  err_msg=what)
    fin = np.isfinite(ref)
    scale = max(np.abs(ref[fin]).max(initial=0.0), 1e-30)
    assert np.abs(out[fin] - ref[fin]).max(initial=0.0) <= atol * scale, what


def _row_major(x):
    """(8, P) raw rays -> the row-major path's xyz (P, 3) and dirs (P, 3)."""
    return x[:3].T.copy(), x[3:6].T.copy()


@pytest.mark.parametrize("case", ["dir_bias", "trunk_weight", "points"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_keeps_nan_as_jax(dtype, case):
    """Kernel C''s plain version on rows (the mesh tool's and the row-major
    renderer's path) against JAX's row-major kernel: the same NaN at the
    same outputs."""
    tree, x = _poisoned(case)
    xyz, dirs = _row_major(x)
    jdt, tdt = DTYPES[dtype]
    ref = np.asarray(jfused.fused_nerf_apply_raw(
        tree, jnp.asarray(xyz), jnp.asarray(dirs), compute_dtype=jdt,
        block=(32, 32), interpret=True, stash_blocks=None))
    with torch.no_grad():
        out = fused_mlp.fused_nerf_apply_raw(
            nerf_from_numpy(tree, device="cpu"), torch.from_numpy(xyz),
            torch.from_numpy(dirs), tdt).numpy()
    assert np.isnan(ref).any()
    if case == "dir_bias":  # rgb poisoned, sigma not
        assert np.isnan(ref[:, :3]).all() and np.isfinite(ref[:, 3]).all()
    if case == "points":  # only those rays
        assert np.isnan(ref).any(1).sum() == 3
    # the finite values as the NaN-free forward test holds them
    # (test_torch_port_ops: the TPU kernel's cos(t) = sin(t + pi/2))
    _same_nonfinite(out, ref, 1e-4 if dtype == "float32" else 5e-3, case)


@pytest.mark.parametrize("case", ["dir_bias", "trunk_weight", "points"])
def test_channel_major_forward_keeps_nan_per_point(case):
    """Kernel C on (8, P): JAX's channel-major kernel transposes its tiles
    with a product by the identity (``_t8``), which spreads a NaN over all
    eight channels of its point (NaN x 0); the port writes each channel as
    computed.  So the two agree point by point (a point's live outputs hold
    a NaN in one iff in the other) and, channel by channel, the port's NaN
    are the row-major kernel's."""
    tree, x = _poisoned(case)
    ref = np.asarray(jfused.fused_nerf_apply_raw_t(
        tree, jnp.asarray(x), sigma_only=False, compute_dtype=jnp.float32,
        block=(32, 32), interpret=True, stash_blocks=None))
    with torch.no_grad():
        model = nerf_from_numpy(tree, device="cpu")
        out = fused_mlp.fused_nerf_apply_raw_t(
            model, torch.from_numpy(x), False, torch.float32).numpy()
        rows = fused_mlp.fused_nerf_apply_raw(
            model, *map(torch.from_numpy, _row_major(x)),
            torch.float32).numpy()
    np.testing.assert_array_equal(np.isnan(out[:4]).any(0),
                                  np.isnan(ref).any(0))
    np.testing.assert_array_equal(np.isnan(out[:4]), np.isnan(rows.T))
    np.testing.assert_array_equal(out[4:], 0.0)


def _grads_both(tree, x, g, stash, sigma_only=False):
    """Grads of ``sum(out * g)`` through the row-major path in f32: JAX's
    (its Pallas kernels in interpret mode) and the port's plain versions.
    ``g`` is (P, 4), or (P, 1) sigma-only."""
    xyz, dirs = _row_major(x)
    dirs = None if sigma_only else dirs

    def f(p):
        out = jfused.fused_nerf_apply_raw(
            p, jnp.asarray(xyz), None if dirs is None else jnp.asarray(dirs),
            compute_dtype=jnp.float32, block=(32, 32), interpret=True,
            stash_blocks=stash)
        return jnp.sum(out[:, :g.shape[1]] * jnp.asarray(g))

    ref = jax.grad(f)(jax.tree_util.tree_map(jnp.asarray, tree))
    model = nerf_from_numpy(tree, device="cpu")
    out = fused_mlp.fused_nerf_apply_raw(
        model, torch.from_numpy(xyz),
        None if dirs is None else torch.from_numpy(dirs), torch.float32,
        stash_blocks=stash)
    out.backward(torch.from_numpy(g))
    return model, ref


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
@pytest.mark.parametrize("stash", [(64, 32), None], ids=["stash_E", "remat_F"])
def test_backward_mask_selects_as_jax(stash, sigma_only):
    """An Inf cotangent at two rays: where a ReLU mask is 0 the grad is 0
    (a product Inf x 0 would have made it NaN); where the two rays' Infs meet
    with opposite signs, NaN.  Every grad tensor's NaN and Inf positions must
    be JAX's."""
    tree = np_nerf(8)
    x = _raw_t(9, P)
    g = np.random.RandomState(3).normal(
        size=(P, 1 if sigma_only else 4)).astype(np.float32)
    g[7, 0 if sigma_only else 1] = np.inf
    g[60, 0 if sigma_only else 3] = -np.inf
    model, ref = _grads_both(tree, x, g, stash, sigma_only)
    for name, p in model.named_parameters():
        _same_nonfinite(p.grad.numpy(), _leaf(ref, name), 1e-5, name)
    # the case reaches a zero mask: layer 7's bias grad has finite entries
    # beside its Inf and NaN ones
    b7 = _leaf(ref, "xyz_layers.7.b")
    assert np.isfinite(b7).any() and not np.isfinite(b7).all()


def test_backward_nan_weight_as_jax():
    """A NaN weight in trunk layer 3: the forward is NaN from layer 3 on;
    the grads' NaN positions are JAX's."""
    tree = np_nerf(8)
    tree["xyz_layers"][3]["w"][2, 9] = np.nan
    x = _raw_t(9, P)
    g = np.random.RandomState(4).normal(size=(P, 4)).astype(np.float32)
    model, ref = _grads_both(tree, x, g, (64, 32))
    for name, p in model.named_parameters():
        _same_nonfinite(p.grad.numpy(), _leaf(ref, name), 1e-5, name)


@pytest.mark.parametrize("case", ["weight", "grad"])
def test_wide_forward_and_dx_backward_as_jax(case):
    """Kernel G's forward and kernel H's grads and dx (``fused_nerf_apply``
    at W = 256): a NaN weight in the dir head, or an Inf cotangent."""
    tree = np_nerf(21)
    x = _embedded(22, P, cols=90)
    g = np.random.RandomState(23).normal(size=(P, 4)).astype(np.float32)
    if case == "weight":
        tree["dir_layer"]["w"][40, 3] = np.nan
    else:
        g[5, 0] = np.inf

    def f(p, xx):
        out = jfused.fused_nerf_apply(p, xx, sigma_only=False,
                                      compute_dtype=jnp.float32, block=32,
                                      interpret=True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref_out), (ref_g, ref_dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    model = nerf_from_numpy(tree, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fused_mlp.fused_nerf_apply(model, xt, False, torch.float32)
    out.backward(torch.from_numpy(g))
    # f32: the forward as test_torch_port_wide holds it, the grads to the
    # order of the f32 sums
    _same_nonfinite(out.detach().numpy(), np.asarray(ref_out), 1e-4, "out")
    _same_nonfinite(xt.grad.numpy(), np.asarray(ref_dx), 1e-4, "dx")
    for name, p in model.named_parameters():
        _same_nonfinite(p.grad.numpy(), _leaf(ref_g, name), 1e-4, name)


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_probe_nan", ROOT / "scripts" / "kernel_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chain_keeps_nan_as_jax():
    """Kernel I's fancy chain (``relu`` after each product): a NaN in two
    rows of x stays in those rows, as ``jnp.maximum`` keeps it."""
    rows = 64
    x, w0, w = kernel_probe.probe_inputs(rows, "cpu", seed=5)
    x[[3, 40], 7] = float("nan")
    kernel = functools.partial(_jax_probe()._chain_kernel, fancy=True)
    ref = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()),
                        jnp.asarray(w0.float().numpy(), jnp.bfloat16),
                        jnp.asarray(w.float().numpy(), jnp.bfloat16)))
    out = kernel_probe.chain_plain(x, w0, w, True).numpy()
    assert np.isnan(ref[[3, 40]]).all() and np.isfinite(np.delete(ref, [3, 40], 0)).all()
    # bf16 products: the chain test's limit (test_torch_port_wide)
    _same_nonfinite(out, ref, 2e-2, "chain")
