"""Slice 4 against the JAX package on the CPU: the fused MLP on pre-embedded
rows (the plain version of kernel G) at every width the wide kernel takes,
the renderer's ``fused_wide_infer`` branch, ``fused_nerf_apply``'s grads
(the plain version of kernel H) against ``jax.grad`` of the Pallas
``custom_vjp``, the probe's chain (the plain version of kernel I) against
``_chain_kernel``, and ``render_image``'s layout default.  The Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
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

import nerf_pl_tpu.ops.rendering as jrend
from nerf_pl_tpu.ops import fused_mlp as jfused
from nerf_pl_tpu.ops.rendering import render_rays as jax_render_rays
from nerf_pl_tpu_torch.models.embedding import posenc
from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp
from nerf_pl_tpu_torch.ops.rendering import render_rays
from nerf_pl_tpu_torch.scripts import kernel_probe
from nerf_pl_tpu_torch.tools.render import render_image

from test_torch_port_models import np_nerf
from test_torch_port_render import CASES, N_I, N_S, _overrides, _rays, _scene
from test_torch_port_train import _assert_grads

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _embedded(seed, P, cols=90):
    """(P, cols) pre-embedded rows [xyz_emb | dir_emb] from a numpy seed."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (P, 3)).astype(np.float32)
    d = rng.normal(size=(P, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    x = torch.cat([posenc(torch.from_numpy(xyz), 10),
                   posenc(torch.from_numpy(d), 4)], 1)
    return x[:, :cols].contiguous().numpy()


def _launches():
    return {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}


# ------------------------------------------------------------- kernel G
# every (width, dtype) that kernel G is built for
WIDE_CASES = [(128, "bfloat16"), (384, "bfloat16"), (512, "bfloat16"),
              (640, "bfloat16"), (128, "float32"), (256, "float32"),
              (384, "float32")]


@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
@pytest.mark.parametrize("width,dtype", WIDE_CASES)
def test_fused_apply_plain_matches_pallas_interpret(width, dtype, sigma_only):
    tree = np_nerf(70 + width // 128, W=width)
    P = 300  # ragged against the Pallas block and both CUDA tiles
    x = _embedded(71, P, cols=63 if sigma_only else 90)
    jdt, tdt = DTYPES[dtype]
    ref = np.asarray(jfused.fused_nerf_apply(
        tree, jnp.asarray(x), sigma_only=sigma_only, compute_dtype=jdt,
        block=64, interpret=True))
    model = nerf_from_numpy(tree, device="cpu")
    assert fused_mlp.supports_fused_apply(model, tdt)
    launches = _launches()
    with torch.no_grad():
        out = fused_mlp.fused_nerf_apply(model, torch.from_numpy(x),
                                         sigma_only, tdt).numpy()
    assert launches == _launches()  # a CPU tensor takes the plain version
    assert out.shape == ref.shape == (P, 1 if sigma_only else 4)
    # the same rounding points; only the order of the f32 sums differs.
    # f32: 6.0e-8 at most on the CPU over these cases.  bf16: a different
    # order can round a layer's input to the neighbouring bf16 (2^-8
    # relative), which moves an output by up to ~4e-3 (test_torch_port_ops);
    # 5.3e-5 at most here
    atol = 1e-5 if dtype == "float32" else 5e-3
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def test_fused_apply_guards_and_dx_operands():
    narrow = nerf_from_numpy(np_nerf(72, W=64), device="cpu")
    x = torch.from_numpy(_embedded(73, 8))
    assert not fused_mlp.supports_fused_apply(narrow)
    with pytest.raises(ValueError, match="supports_fused_wide"):
        fused_mlp.fused_nerf_apply(narrow, x)
    model = nerf_from_numpy(np_nerf(74), device="cpu")
    with pytest.raises(ValueError, match="embedded"):
        fused_mlp.fused_nerf_apply(model, x[:, :27])
    # the wrappers of G and H take only CUDA tensors
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_nerf_apply_cuda(model, x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_nerf_bwd_dx_cuda(model, x, torch.zeros((8, 8)))
    # W = 640 fits the TPU budget in bf16 only, as in JAX
    w640 = nerf_from_numpy(np_nerf(75, W=640), device="cpu")
    assert fused_mlp.supports_fused_apply(w640, torch.bfloat16)
    assert not fused_mlp.supports_fused_apply(w640, torch.float32)
    # kernel H's dx operands: the transposes, zero-padded to 64 columns
    wx = fused_mlp.pack_weights_dx(model, torch.float32)
    assert wx.numel() == 128 * 64 + 2 * 256 * 64
    blocks = torch.split(wx, [128 * 64, 256 * 64, 256 * 64])
    for block, w in zip(blocks, (model.dir_layer.w[256:].T,
                                 model.xyz_layers[4].w[:63].T,
                                 model.xyz_layers[0].w.T)):
        block = block.view(-1, 64)
        assert torch.equal(block[:, :w.shape[1]], w.detach())
        assert not block[:, w.shape[1]:].any()


# -------------------------------------------------------- the wide render
@pytest.mark.parametrize("case", ["rgb_test_time", "sigma"])
@pytest.mark.parametrize("width,dtype", [(512, "bfloat16"), (384, "float32")])
def test_wide_render_matches_jax(width, dtype, case, monkeypatch):
    """``render_rays(use_fused=True, fused_wide_infer=True)`` at a wide
    width: the port embeds and calls ``fused_nerf_apply`` (kernel G's plain
    version here) for both passes, JAX its Pallas kernel in interpret mode."""
    import nerf_pl_tpu_torch.ops.rendering as trend

    monkeypatch.setattr(jrend, "fused_nerf_apply", functools.partial(
        jfused.fused_nerf_apply, interpret=True))
    calls = []
    real = trend.fused_nerf_apply

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(trend, "fused_nerf_apply", spy)
    jdt, tdt = DTYPES[dtype]
    pc, pf = _scene(76, 77, W=width)
    rays, ov = _rays(78, n=6), _overrides(79, n=6)
    kw = dict(CASES[case], N_samples=N_S, N_importance=N_I, white_back=True,
              use_fused=True, fused_wide_infer=True)
    ref = jax_render_rays(pc, pf, jnp.asarray(rays), None, compute_dtype=jdt,
                          overrides={k: jnp.asarray(v) for k, v in ov.items()},
                          **kw)
    mc, mf = nerf_from_numpy(pc, device="cpu"), nerf_from_numpy(pf, device="cpu")
    with torch.no_grad():
        out = render_rays(mc, mf, torch.from_numpy(rays), None,
                          compute_dtype=tdt,
                          overrides={k: torch.from_numpy(v) for k, v in ov.items()},
                          **kw)
    sigma_coarse = case == "sigma" or kw["test_time"]
    assert calls == [(6 * N_S, 63 if sigma_coarse else 90),
                     (6 * (N_S + N_I), 63 if case == "sigma" else 90)]
    assert set(out) == set(ref)
    # f32: the embeddings' sin/cos on the two packages differ by an ulp,
    # which the 2^9-frequency channels and the scaled sigma head carry
    # (2.1e-5 at most on the CPU; as test_fused_wide_infer_gate_matches_jax).
    # bf16: a rounding flip in a layer's input moves a sigma of the scaled
    # head, and the compositing and the sampler carry that (5.2e-4 at most
    # on the CPU)
    atol = 1e-4 if dtype == "float32" else 1e-2
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, rtol=0, err_msg=k)


# ------------------------------------------------------------- kernel H
@pytest.mark.parametrize("cols", [90, 63])
@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_apply_grads_match_jax(dtype, sigma_only, cols):
    """The grads of every parameter and of x through ``fused_nerf_apply``
    (G then H, plain here) against ``jax.grad`` of JAX's ``custom_vjp`` (the
    Pallas forward and ``_bwd_kernel`` with ``want_dx``, interpret mode)."""
    tree = np_nerf(80)
    P = 200  # ragged against the block
    x = _embedded(81, P, cols)
    g = np.random.RandomState(82).normal(
        size=(P, 1 if sigma_only else 4)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]

    def f(p, xx):
        out = jfused.fused_nerf_apply(p, xx, sigma_only=sigma_only,
                                      compute_dtype=jdt, block=64,
                                      interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    ref_p, ref_x = jax.grad(f, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    model = nerf_from_numpy(tree, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    launches = _launches()
    out = fused_mlp.fused_nerf_apply(model, xt, sigma_only, tdt)
    (out * torch.from_numpy(g)).sum().backward()
    assert launches == _launches()
    ref_x = np.asarray(ref_x, np.float32)
    assert xt.grad.shape == ref_x.shape == (P, cols)
    dx, scale = xt.grad.numpy(), np.abs(ref_x).max()
    if sigma_only or cols == 63:
        assert not dx[:, 63:].any()  # no dir_emb reaches the output
    if dtype == "float32":
        # only the order of the f32 sums differs (6.7e-7 max, 1.1e-7 mean of
        # max|ref| at worst on the CPU)
        tol = (2e-5, 2e-6)
    else:
        # bf16: a different sum order can round an activation or a g_pre to
        # the neighbouring bf16 or flip a ReLU mask at a near-zero
        # pre-activation, and the backward carries that down the layers, as
        # test_fused_grads_match_jax allows the raw kernels (5.9e-3 max,
        # 1.3e-4 mean of max|ref| at worst on the CPU)
        tol = (5e-2, 3e-3)
    _assert_grads(model, ref_p, *tol)
    assert np.abs(dx - ref_x).max() <= tol[0] * scale
    assert np.abs(dx - ref_x).mean() <= tol[1] * scale


def test_fused_apply_grad_raises_past_the_reference_width():
    """Only W = 256 has a backward, in JAX (``_bwd_core`` slices at 256) and
    here; the wide forward runs without grad."""
    model = nerf_from_numpy(np_nerf(83, W=512), device="cpu")
    x = torch.from_numpy(_embedded(84, 16))
    with pytest.raises(ValueError, match="W = 256"):
        fused_mlp.fused_nerf_apply(model, x)  # trainable parameters
    model.requires_grad_(False)
    with pytest.raises(ValueError, match="W = 256"):
        fused_mlp.fused_nerf_apply(model, x.clone().requires_grad_(True))
    out = fused_mlp.fused_nerf_apply(model, x)
    assert out.shape == (16, 4) and out.grad_fn is None


# ------------------------------------------------------------- kernel I
def _jax_probe():
    """The JAX package's ``scripts/kernel_probe.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_probe", ROOT / "scripts" / "kernel_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fancy", [False, True], ids=["pure", "fancy"])
def test_chain_plain_matches_pallas_interpret(fancy):
    P = 256
    x, w0, w = kernel_probe.probe_inputs(P, "cpu", seed=5)
    kernel = functools.partial(_jax_probe()._chain_kernel, fancy=fancy)
    ref = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((P, 128), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()),
                        jnp.asarray(w0.float().numpy(), jnp.bfloat16),
                        jnp.asarray(w.float().numpy(), jnp.bfloat16)))
    out = kernel_probe.chain_plain(x, w0, w, fancy).numpy()
    assert out.shape == ref.shape
    # every product of bf16 operands summed in f32 in both; only the order
    # of the sums differs, which can round a product to the neighbouring
    # bf16 (2^-8 relative) and carry it down the chain (on the CPU: equal in
    # pure mode, 1.4e-3 max and 2.3e-6 mean of max|ref| in fancy mode)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 2e-2 * scale
    assert np.abs(out - ref).mean() <= 3e-4 * scale
    with pytest.raises(ValueError, match="CUDA"):
        kernel_probe.chain_cuda(x, w0, w, fancy)


def test_probe_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_probe.main() == 1
    assert "CUDA is not available" in capsys.readouterr().err


# ------------------------------------------------------- render_image
def test_render_image_takes_channel_major_io_with_use_fused(monkeypatch):
    """As JAX's ``render_image`` (tools/render.py:86-87), ``use_fused``
    alone defaults ``fused_channel_io`` to True: kernel C's route (its plain
    version here), not C''s; an explicit False still takes C'."""
    import nerf_pl_tpu_torch.ops.rendering as trend

    calls = {"channel": 0, "row": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(trend, "fused_nerf_apply_raw_t",
                        counted("channel", trend.fused_nerf_apply_raw_t))
    monkeypatch.setattr(trend, "fused_nerf_apply_raw",
                        counted("row", trend.fused_nerf_apply_raw))
    models = {"coarse": nerf_from_numpy(np_nerf(85), device="cpu"),
              "fine": nerf_from_numpy(np_nerf(86), device="cpu")}
    rays = torch.from_numpy(_rays(87, n=4))
    kw = dict(N_samples=4, N_importance=4, perturb=0.0, noise_std=0.0,
              use_fused=True)
    out = render_image(models, rays, None, chunk=2, **kw)
    assert calls == {"channel": 4, "row": 0}  # 2 chunks x coarse + fine
    assert out["rgb_fine"].shape == (4, 3)
    calls.update(channel=0)
    render_image(models, rays, None, chunk=2, fused_channel_io=False, **kw)
    assert calls == {"channel": 0, "row": 4}
