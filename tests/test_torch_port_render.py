"""The slice as a whole against the JAX package on the CPU: ``render_rays``,
``RenderService.render_batch`` on a checkpoint written by the JAX package,
checkpoint files read in both directions, and ``load_models``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_pl_tpu.ops.rendering as jrend
from nerf_pl_tpu.ops import fused_mlp as jfused
from nerf_pl_tpu.ops.rendering import render_rays as jax_render_rays
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy, nerf_to_numpy
from nerf_pl_tpu_torch.ops import fused_mlp
from nerf_pl_tpu_torch.ops.rendering import render_rays
from nerf_pl_tpu_torch.tools.evaluate import load_models
from nerf_pl_tpu_torch.training import checkpoints as ckpt

from test_torch_port_models import np_nerf

N_RAYS, N_S, N_I = 12, 8, 8


def _rays(seed, n=N_RAYS):
    rng = np.random.RandomState(seed)
    o = rng.normal(0, 0.3, (n, 3)) + np.array([0.0, 0.0, 4.0])
    d = rng.normal(0, 0.3, (n, 3)) + np.array([0.0, 0.0, -1.0])
    nf = np.ones((n, 1))
    return np.concatenate([o, d, 2.0 * nf, 6.0 * nf], 1).astype(np.float32)


def _overrides(seed, n=N_RAYS):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return {"perturb_rand": f(n, N_S), "noise_coarse": rng.normal(size=(n, N_S)).astype(np.float32),
            "u": f(n, N_I), "jitter": f(n, N_I),
            "noise_fine": rng.normal(size=(n, N_S + N_I)).astype(np.float32)}


CASES = {
    "rgb": dict(mode="rgb", test_time=False, perturb=1.0, noise_std=1.0),
    "rgb_test_time": dict(mode="rgb", test_time=True, perturb=0.0, noise_std=0.0),
    "rgb_test_time_injected": dict(mode="rgb", test_time=True, perturb=1.0, noise_std=1.0),
    "sigma": dict(mode="sigma", test_time=False, perturb=1.0, noise_std=1.0),
    "rgb_disp_det": dict(mode="rgb_disp", test_time=False, perturb=0.0, noise_std=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("use_fused", [False, True])
def test_render_rays_matches_jax(case, use_fused):
    kw = dict(CASES[case], N_samples=N_S, N_importance=N_I, white_back=True)
    pc, pf = np_nerf(20), np_nerf(21)
    for tree in (pc, pf):  # a partly opaque random scene
        tree["sigma"]["w"] *= 40.0
    rays = _rays(22)
    ov = _overrides(23)
    ref = jax_render_rays(pc, pf, jnp.asarray(rays), None,
                          overrides={k: jnp.asarray(v) for k, v in ov.items()}, **kw)
    mc, mf = nerf_from_numpy(pc, device="cpu"), nerf_from_numpy(pf, device="cpu")
    with torch.no_grad():
        # use_fused on a CPU tensor takes the fused branch's plain version
        out = render_rays(mc, mf, torch.from_numpy(rays), None, use_fused=use_fused,
                          fused_channel_io=True,
                          overrides={k: torch.from_numpy(v) for k, v in ov.items()}, **kw)
    assert set(out) == set(ref)
    if case.startswith("rgb_test_time"):
        assert "rgb_coarse" not in out and "opacity_coarse" in out
    for k in ref:
        # f32 at full width: only the order of f32 sums differs; the sampler
        # is continuous in the CDF, so that stays at rounding level
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_render_rays_guards():
    m = nerf_from_numpy(np_nerf(24, D=2, W=16, skips=()), device="cpu")
    rays = torch.from_numpy(_rays(25))
    with pytest.raises(ValueError, match="requires either deterministic"):
        render_rays(m, m, rays, None, perturb=1.0, N_importance=4)
    with pytest.raises(ValueError, match="unknown mode"):
        render_rays(m, m, rays, None, mode="depth", noise_std=0.0)
    # a narrow model with use_fused renders through posenc + NeRF, as in
    # JAX, in either IO layout and with fused_wide_infer (the wide kernel
    # takes only lane-aligned widths)
    for channel_io, wide in ((True, False), (False, False), (True, True)):
        with torch.no_grad():
            out = render_rays(m, m, rays, torch.Generator().manual_seed(0),
                              N_samples=4, N_importance=4, perturb=1.0,
                              use_fused=True, fused_channel_io=channel_io,
                              fused_wide_infer=wide)
        assert torch.isfinite(out["rgb_fine"]).all()


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """JAX's renderer with its fused MLP kernels in interpret mode (Pallas
    needs a TPU otherwise), at the caller's compute dtype and small blocks."""
    raw, raw_t = jfused.fused_nerf_apply_raw, jfused.fused_nerf_apply_raw_t

    def interp_raw(params, xyz, dirs=None, compute_dtype=jnp.bfloat16, **kw):
        return raw(params, xyz, dirs, compute_dtype=compute_dtype,
                   block=(64, 32), interpret=True, stash_blocks=(96, 48))

    def interp_raw_t(params, x_t, sigma_only=False, compute_dtype=jnp.bfloat16,
                     **kw):
        return raw_t(params, x_t, sigma_only=sigma_only,
                     compute_dtype=compute_dtype, block=(64, 32),
                     interpret=True, stash_blocks=(96, 48))

    monkeypatch.setattr(jrend, "fused_nerf_apply_raw", interp_raw)
    monkeypatch.setattr(jrend, "fused_nerf_apply_raw_t", interp_raw_t)


def _scene(seed_c, seed_f, **nerf_kw):
    pc, pf = np_nerf(seed_c, **nerf_kw), np_nerf(seed_f, **nerf_kw)
    for tree in (pc, pf):  # a partly opaque random scene
        tree["sigma"]["w"] *= 40.0
    return pc, pf


# f32 end to end; the Pallas kernel computes cos(t) as sin(t + pi/2), which
# moves a 2^9-frequency channel by up to ~1e-4 (test_torch_port_ops), and
# the importance sampler carries that into the fine samples (1.6e-5 at most
# on the CPU)
ROW_MAJOR_TOL = 1e-4


@pytest.mark.parametrize("case", ["rgb_test_time", "sigma", "rgb_disp_det"])
def test_render_rays_row_major_matches_jax(case, jax_fused_interpret):
    """Eval settings: ``use_fused=True, fused_channel_io=False`` takes the
    row-major fused MLP (kernel C' plain here, the Pallas kernel in JAX)."""
    kw = dict(CASES[case], N_samples=N_S, N_importance=N_I, white_back=True,
              use_fused=True, fused_channel_io=False)
    pc, pf = _scene(50, 51)
    rays = _rays(52)
    ov = _overrides(53)
    ref = jax_render_rays(pc, pf, jnp.asarray(rays), None,
                          overrides={k: jnp.asarray(v) for k, v in ov.items()}, **kw)
    mc, mf = nerf_from_numpy(pc, device="cpu"), nerf_from_numpy(pf, device="cpu")
    launches = {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    with torch.no_grad():
        out = render_rays(mc, mf, torch.from_numpy(rays), None,
                          overrides={k: torch.from_numpy(v) for k, v in ov.items()}, **kw)
    assert launches == {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ROW_MAJOR_TOL, rtol=0, err_msg=k)


def test_render_rays_row_major_grads_match_jax(jax_fused_interpret):
    """Training settings (perturb and noise injected): the loss and every
    parameter grad through the row-major stash route (D' and E' plain here,
    the Pallas kernels in JAX)."""
    from nerf_pl_tpu.training.losses import loss_dict as jloss_dict
    from nerf_pl_tpu_torch.training.losses import mse_loss

    kw = dict(CASES["rgb"], N_samples=N_S, N_importance=N_I, white_back=True,
              use_fused=True, fused_channel_io=False)
    pc, pf = _scene(54, 55)
    rays, ov = _rays(56), _overrides(57)
    rgbs = np.random.RandomState(58).uniform(size=(N_RAYS, 3)).astype(np.float32)

    def loss_fn(p):
        res = jax_render_rays(p["coarse"], p["fine"], jnp.asarray(rays), None,
                              overrides={k: jnp.asarray(v) for k, v in ov.items()},
                              **kw)
        return jloss_dict["mse"](res, jnp.asarray(rgbs))

    params = jax.tree_util.tree_map(jnp.asarray, {"coarse": pc, "fine": pf})
    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    models = {"coarse": nerf_from_numpy(pc, device="cpu"),
              "fine": nerf_from_numpy(pf, device="cpu")}
    out = render_rays(models["coarse"], models["fine"], torch.from_numpy(rays), None,
                      overrides={k: torch.from_numpy(v) for k, v in ov.items()}, **kw)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4)
    for name, model in models.items():
        for pname, p in model.named_parameters():
            tree = grads_j[name]
            for k in pname.split("."):
                tree = tree[int(k)] if k.isdigit() else tree[k]
            want = np.asarray(tree, np.float32)
            got = p.grad.numpy()
            assert got.shape == want.shape, pname
            scale = max(np.abs(want).max(), 1e-30)
            # f32; the kernels' sin(t + pi/2) (above), carried through the
            # backward: 3.7e-5 of max|grad| at worst on the CPU
            assert np.abs(got - want).max() <= 3e-4 * scale, (name, pname)


@pytest.mark.parametrize("width", [16, 256, 512])
@pytest.mark.parametrize("channel_io", [True, False], ids=["channel", "row"])
def test_fused_wide_infer_gate_matches_jax(width, channel_io, jax_fused_interpret,
                                           monkeypatch):
    """``fused_wide_infer=True`` takes the wide fused forward exactly where
    JAX does: W = 512 in bf16 (kernel G's plain version here, JAX's Pallas
    kernel in interpret mode), and renders as JAX renders.  Elsewhere the
    port renders as JAX does: W = 256 through the reference fused MLP, W = 16
    and W = 512 in f32 (too many weight bytes for the wide kernel) through
    posenc + NeRF."""
    monkeypatch.setattr(jrend, "fused_nerf_apply", functools.partial(
        jfused.fused_nerf_apply, interpret=True))
    pc, pf = _scene(60, 61, W=width)
    rays = _rays(62, n=4)
    kw = dict(N_samples=N_S, N_importance=N_I, white_back=True, perturb=0.0,
              noise_std=0.0, test_time=True, use_fused=True,
              fused_channel_io=channel_io, fused_wide_infer=True)
    mc, mf = nerf_from_numpy(pc, device="cpu"), nerf_from_numpy(pf, device="cpu")
    assert fused_mlp.supports_fused_wide(mc) == (width == 512)
    assert fused_mlp.supports_fused_wide(mc, torch.bfloat16) == \
        jfused.supports_fused_wide(pc, jnp.bfloat16)
    assert fused_mlp.supports_fused_wide(mc, torch.float32) == \
        jfused.supports_fused_wide(pc, jnp.float32) is False
    if width == 512:
        ref = jax_render_rays(pc, pf, jnp.asarray(rays), None,
                              compute_dtype=jnp.bfloat16, **kw)
        with torch.no_grad():
            out = render_rays(mc, mf, torch.from_numpy(rays), None,
                              compute_dtype=torch.bfloat16, **kw)
        # bf16 through the wide kernel in both: the same rounding points,
        # another order of the f32 sums (test_torch_port_wide states why)
        for k in ref:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=2e-2, rtol=0, err_msg=k)
    ref = jax_render_rays(pc, pf, jnp.asarray(rays), None, **kw)
    with torch.no_grad():
        out = render_rays(mc, mf, torch.from_numpy(rays), None, **kw)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ROW_MAJOR_TOL, rtol=0, err_msg=k)


# ------------------------------------------------------------ checkpoints
def _jax_state():
    return {
        "params": {"coarse": np_nerf(30), "fine": np_nerf(31)},
        "opt_state": [{"mu": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "count": np.int32(7)}, (np.float64(0.5), -3)],
        "step": 123456, "epoch": 2, "lr": 5e-4, "flag": True, "none": None,
        "name": "x" * 40, "big": -(1 << 40),
        "bf16": jnp.arange(5, dtype=jnp.bfloat16) / 4,
    }


def test_port_reads_jax_checkpoint(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    state = _jax_state()
    jckpt.save_checkpoint(path, state)
    mine = ckpt.load_checkpoint(path)
    ref = jckpt.load_checkpoint(path)
    assert sorted(mine) == sorted(ref)
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                               if getattr(a, "dtype", None) == jnp.bfloat16 else a, ref))
    assert [p for p, _ in flat_m] == [p for p, _ in flat_r]
    for (p, a), (_, b) in zip(flat_m, flat_r):
        assert type(a) is type(b) or isinstance(a, np.ndarray), p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
    assert mine["opt_state"]["0"]["count"].dtype == np.int32
    sd = ckpt.extract_model_state_dict(path, "fine", prefixes_to_ignore=("rgb",))
    assert sd.keys() == jckpt.extract_model_state_dict(path, "fine", ("rgb",)).keys()
    model = nerf_from_numpy(np_nerf(0), device="cpu")
    ckpt.load_ckpt_into(model, path, "coarse")
    np.testing.assert_array_equal(nerf_to_numpy(model)["xyz_layers"][4]["w"],
                                  state["params"]["coarse"]["xyz_layers"][4]["w"])


def test_jax_reads_port_checkpoint(tmp_path):
    path = str(tmp_path / "port.ckpt")
    models = {"coarse": nerf_from_numpy(np_nerf(32), device="cpu"),
              "fine": nerf_from_numpy(np_nerf(33), device="cpu")}
    ckpt.save_checkpoint(path, {
        "params": models, "step": 9, "epoch": 1, "lr": 1e-3,
        "extra": [np.float32(2.5), torch.arange(4, dtype=torch.bfloat16), "s", None]})
    ref = jckpt.load_checkpoint(path)
    assert ref["step"] == 9 and ref["epoch"] == 1 and ref["lr"] == 1e-3
    assert ref["extra"]["0"] == np.float32(2.5) and ref["extra"]["2"] == "s"
    assert ref["extra"]["1"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(ref["extra"]["1"], np.float32), [0, 1, 2, 3])
    for name in ("coarse", "fine"):
        tree = jckpt.load_ckpt_into(
            jax.tree_util.tree_map(jnp.zeros_like, np_nerf(0)), path, name)
        want = nerf_to_numpy(models[name])
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)
    # and the port reads its own file back
    assert ckpt.load_checkpoint(path)["extra"]["3"] is None


def test_codec_round_trip_and_errors():
    obj = {"a": [1, -1, -33, 200, 70000, 1 << 33, -(1 << 20)], "b": b"\x00" * 300,
           "c": "é" * 20, "d": {str(i): i for i in range(20)}, "e": 1.25,
           "f": np.zeros((3, 70000), np.float16)}
    back = ckpt.unpackb(ckpt.packb(obj))
    assert back["a"] == obj["a"] and back["b"] == obj["b"] and back["c"] == obj["c"]
    assert back["d"] == obj["d"] and back["e"] == 1.25
    assert back["f"].dtype == np.float16 and back["f"].shape == (3, 70000)
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(ckpt.packb(1) + b"\x00")
    with pytest.raises(TypeError):
        ckpt.packb({"x": object()})


def test_load_models_width_and_missing_fine(tmp_path):
    path = str(tmp_path / "coarse_only.ckpt")
    jckpt.save_checkpoint(path, {"params": {"coarse": np_nerf(34, W=128)}})
    models = load_models(path, device="cpu")
    assert set(models) == {"coarse"}
    assert models["coarse"].width == 128
    assert not any(p.requires_grad for p in models["coarse"].parameters())


# --------------------------------------------------------- render service
def test_render_service_matches_jax(tmp_path):
    from nerf_pl_tpu.tools.serve import RenderService as JaxRenderService
    from nerf_pl_tpu_torch.tools.serve import RenderService

    path = str(tmp_path / "m.ckpt")
    params = {"coarse": np_nerf(40), "fine": np_nerf(41)}
    for tree in params.values():  # a partly opaque random scene
        tree["sigma"]["w"] *= 40.0
    jckpt.save_checkpoint(path, {"params": params})
    kw = dict(img_wh=8, n_samples=4, n_importance=4, max_batch=2,
              compute_dtype="float32")
    ref_svc = JaxRenderService(path, **kw)
    svc = RenderService(path, device="cpu", **kw)
    cams = [svc._c2w_for(eye, (0.0, 0.0, 0.0)) for eye in ([4, 1, 0], [0.5, 1, 3.5])]
    ref = ref_svc.render_batch(cams, 8)
    out = svc.render_batch(cams, 8)
    assert svc.batch_tiers == {2: 1}
    assert len(out) == 2 and out[0].shape == (8, 8, 3)
    for a, b in zip(out, ref):
        # f32, full width: rounding-level differences only
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert np.abs(out[0] - out[1]).max() > 1e-2  # two different views
    assert out[0].min() < 0.9  # not a blank white image
