"""The training step against the JAX package on the CPU: the fused MLP's autograd
function (the plain versions of kernels D, E and F) against ``jax.grad`` of
the Pallas kernels in interpret mode, the model's gradients, ``remat_fine``,
Adam and the step-LR schedule, the gradient clip, and ``Config``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.models.nerf import nerf_apply
from nerf_pl_tpu.ops import fused_mlp as jfused
from nerf_pl_tpu.ops.rendering import render_rays as jax_render_rays
from nerf_pl_tpu.training import optim as joptim
from nerf_pl_tpu.training.losses import loss_dict as jloss_dict
from nerf_pl_tpu_torch import config
from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy, nerf_to_numpy
from nerf_pl_tpu_torch.ops import fused_mlp
from nerf_pl_tpu_torch.ops.rendering import render_rays
from nerf_pl_tpu_torch.training import optim
from nerf_pl_tpu_torch.training.losses import mse_loss

from test_torch_port_models import np_nerf
from test_torch_port_ops import _raw_t
from test_torch_port_render import _overrides, _rays, N_I, N_RAYS, N_S


def _leaf(tree, name):
    """The JAX tree's leaf for a torch parameter name (``xyz_layers.4.w``)."""
    for k in name.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return np.asarray(tree, np.float32)


def _assert_grads(model, ref_tree, tol_max, tol_mean):
    for name, p in model.named_parameters():
        ref = _leaf(ref_tree, name)
        got = p.grad.numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape, name
        scale = np.abs(ref).max()
        d = np.abs(got - ref)
        assert d.max() <= tol_max * scale, (name, d.max() / scale)
        assert d.mean() <= tol_mean * scale, (name, d.mean() / scale)


# ------------------------------------------------------------ fused MLP grads
def _fused_call(layout, x, sigma_only):
    """``(JAX call on params, port call on a model, cotangent picker)`` for
    one IO layout: channel-major ``fused_nerf_apply_raw_t`` on (8, P), or
    row-major ``fused_nerf_apply_raw`` on raw xyz and dirs (None when
    sigma-only), whose output is (P, 4) or (P, 1)."""
    cols = 1 if sigma_only else 4
    if layout == "channel":
        return ((lambda p, dt, stash: jfused.fused_nerf_apply_raw_t(
                    p, jnp.asarray(x), sigma_only=sigma_only, compute_dtype=dt,
                    block=(64, 32), interpret=True, stash_blocks=stash)),
                (lambda m, dt, stash: fused_mlp.fused_nerf_apply_raw_t(
                    m, torch.from_numpy(x), sigma_only, dt, stash_blocks=stash)),
                lambda g: g)
    xyz, dirs = x[:3].T.copy(), None if sigma_only else x[3:6].T.copy()
    return ((lambda p, dt, stash: jfused.fused_nerf_apply_raw(
                p, jnp.asarray(xyz), None if dirs is None else jnp.asarray(dirs),
                compute_dtype=dt, block=(64, 32), interpret=True,
                stash_blocks=stash)),
            (lambda m, dt, stash: fused_mlp.fused_nerf_apply_raw(
                m, torch.from_numpy(xyz),
                None if dirs is None else torch.from_numpy(dirs), dt,
                stash_blocks=stash)),
            lambda g: np.ascontiguousarray(g[:cols].T))


@pytest.mark.parametrize("layout", ["channel", "row"])
@pytest.mark.parametrize("stash", [(96, 48), None], ids=["stash", "remat"])
@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_grads_match_jax(dtype, sigma_only, stash, layout):
    tree = np_nerf(8)
    P = 200  # ragged against every block
    x = _raw_t(9, P)
    jcall, tcall, pick = _fused_call(layout, x, sigma_only)
    g = pick(np.random.RandomState(3).normal(size=(8, P)).astype(np.float32))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def f(p):
        return jnp.sum(jcall(p, jdt, stash) * jnp.asarray(g))

    ref = jax.grad(f)(jax.tree_util.tree_map(jnp.asarray, tree))
    model = nerf_from_numpy(tree, device="cpu")
    launches = {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    out = tcall(model, tdt, stash)
    assert out.shape == g.shape
    (out * torch.from_numpy(g)).sum().backward()
    # a CPU tensor takes the plain versions: no kernel was launched
    assert launches == {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    if dtype == "float32":
        # only the order of the f32 sums differs (3.3e-6 on the CPU)
        _assert_grads(model, ref, 1e-5, 1e-6)
    else:
        # bf16: a different sum order or the TPU kernel's cos(t) =
        # sin(t + pi/2) can round an activation or a g_pre to the
        # neighbouring bf16 (2^-8) or flip a ReLU mask at a near-zero
        # pre-activation, and the backward carries that down the layers
        # (2.9e-2 max, 1.6e-3 mean, per tensor, on the CPU)
        _assert_grads(model, ref, 5e-2, 3e-3)


@pytest.mark.parametrize("stash", ["auto", None], ids=["stash", "remat"])
@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
def test_row_major_equals_channel_major(sigma_only, stash):
    """The row-major path (C', D', E', F' plain) on the same points as the
    channel-major one: the same outputs and grads, bit for bit."""
    tree = np_nerf(17)
    P = 130
    x = _raw_t(18, P)
    g = np.random.RandomState(19).normal(size=(8, P)).astype(np.float32)
    g[1 if sigma_only else 4:] = 0.0  # the channels the row-major output drops
    outs, grads = [], []
    for layout in ("channel", "row"):
        model = nerf_from_numpy(tree, device="cpu")
        _, tcall, pick = _fused_call(layout, x, sigma_only)
        out = tcall(model, torch.bfloat16, stash)
        (out * torch.from_numpy(pick(g))).sum().backward()
        o = out.detach().numpy()
        outs.append(o[:1 if sigma_only else 4].T if layout == "channel" else o)
        grads.append([p.grad.clone() for p in model.parameters()])
    np.testing.assert_array_equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # the plain versions themselves: C', D', E', F' on the transposes
    model = nerf_from_numpy(tree, device="cpu")
    xt = torch.from_numpy(x)
    xr = xt.T.contiguous()
    assert torch.equal(fused_mlp.fused_nerf_apply_raw_plain(model, xr, sigma_only),
                       fused_mlp.fused_nerf_apply_raw_t_plain(model, xt, sigma_only).T)
    out_r, st_r = fused_mlp.fused_nerf_raw_stash_fwd_plain(model, xr, sigma_only)
    out_c, st_c = fused_mlp.fused_nerf_stash_fwd_plain(model, xt, sigma_only)
    assert torch.equal(out_r, out_c.T) and torch.equal(st_r, st_c)
    gt = torch.from_numpy(g)
    for st in (st_c, None):
        a = fused_mlp.fused_nerf_raw_bwd_plain(model, xr, gt.T.contiguous(),
                                               sigma_only, stash=st)
        b = fused_mlp.fused_nerf_bwd_plain(model, xt, gt, sigma_only, stash=st)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_weight_grads_rounded_bias_grads_not():
    """The wrapper rounds weight grads to the compute dtype, as JAX casts each
    packed grad to its packed dtype; bias grads stay f32."""
    model = nerf_from_numpy(np_nerf(10), device="cpu")
    x = torch.from_numpy(_raw_t(11, 96))
    fused_mlp.fused_nerf_apply_raw_t(model, x, False, torch.bfloat16).sum().backward()
    for name, p in model.named_parameters():
        rounded = p.grad.to(torch.bfloat16).float()
        if name.endswith(".w"):
            assert torch.equal(p.grad, rounded), name
    assert not all(torch.equal(p.grad, p.grad.to(torch.bfloat16).float())
                   for n, p in model.named_parameters() if n.endswith(".b"))


@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
def test_bf16_backward_rounds_where_stated(sigma_only):
    """The plain bf16 backward, which the kernels are held against on the
    card, rounds g_pre and the product operands: the same backward in f32 on
    the same bf16 stash (what a kernel that skipped the rounding computes)
    moves the first layer's bias grad by far more than the 2e-5 x max mean
    that chip_smoke.py allows the kernels."""
    model = nerf_from_numpy(np_nerf(14), device="cpu")
    P = 256
    x = torch.from_numpy(_raw_t(15, P))
    g = torch.from_numpy(
        np.random.RandomState(16).normal(size=(8, P)).astype(np.float32))
    _, stash = fused_mlp.fused_nerf_stash_fwd_plain(model, x, sigma_only,
                                                    torch.bfloat16)
    _, db = fused_mlp.fused_nerf_bwd_plain(model, x, g, sigma_only,
                                           torch.bfloat16, stash=stash)
    _, db32 = fused_mlp.fused_nerf_bwd_plain(model, x, g, sigma_only,
                                             torch.float32, stash=stash)
    b0, b0_32 = db[:256], db32[:256]  # xyz_layers.0.b
    assert float((b0 - b0_32).abs().mean() / b0.abs().max()) > 2e-4


def test_route_selection_follows_stash_blocks(monkeypatch):
    model = nerf_from_numpy(np_nerf(12), device="cpu")
    x = torch.from_numpy(_raw_t(13, 64))
    seen = []
    real = fused_mlp.fused_nerf_bwd_plain

    def spy(model, x_rawT, g, sigma_only=False, compute_dtype=None, stash=None):
        seen.append(stash is not None)
        return real(model, x_rawT, g, sigma_only, compute_dtype, stash)

    monkeypatch.setattr(fused_mlp, "fused_nerf_bwd_plain", spy)
    for blocks in ("auto", None, (768, 768)):
        fused_mlp.fused_nerf_apply_raw_t(model, x, stash_blocks=blocks).sum().backward()
    xyz = x[:3].T.contiguous()
    fused_mlp.fused_nerf_apply_raw(model, xyz, stash_blocks="auto").sum().backward()
    fused_mlp.fused_nerf_apply_raw(model, xyz, stash_blocks=None).sum().backward()
    monkeypatch.setattr(fused_mlp, "STASH_MAX_POINTS", 63)  # P = 64 is past it
    fused_mlp.fused_nerf_apply_raw_t(model, x).sum().backward()
    fused_mlp.fused_nerf_apply_raw(model, xyz).sum().backward()
    assert seen == [True, False, True, True, False, False, False]
    # without trainable parameters the forward needs no stash and no Function
    model.requires_grad_(False)
    out = fused_mlp.fused_nerf_apply_raw_t(model, x)
    assert out.grad_fn is None


def test_stash_plain_layout():
    model = nerf_from_numpy(np_nerf(14), device="cpu")
    x = torch.from_numpy(_raw_t(15, 50))
    for sigma_only, cols in ((False, 2432), (True, 2048)):
        out, stash = fused_mlp.fused_nerf_stash_fwd_plain(model, x, sigma_only,
                                                          torch.bfloat16)
        assert stash.shape == (50, cols) and stash.dtype == torch.bfloat16
        assert torch.equal(out, fused_mlp.fused_nerf_apply_raw_t_plain(
            model, x, sigma_only, torch.bfloat16))
        assert (stash[:, :2048].float() >= 0).all()  # post-ReLU trunk


# -------------------------------------------------------------- model grads
def test_nerf_grads_match_jax_grad_of_nerf_apply():
    tree = np_nerf(16, D=6, W=32, skips=(4,))
    rng = np.random.RandomState(17)
    x = rng.uniform(-1, 1, (64, 90)).astype(np.float32)
    w = rng.normal(size=(64, 4)).astype(np.float32)
    ref = jax.grad(lambda p: jnp.sum(nerf_apply(p, jnp.asarray(x)) * w))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = nerf_from_numpy(tree, device="cpu")
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    # f32: the order of the f32 sums only
    _assert_grads(model, ref, 1e-5, 1e-6)


# --------------------------------------------------------------- remat_fine
def test_remat_fine_gives_the_same_grads():
    grads = []
    rays = torch.from_numpy(_rays(18))
    ov = {k: torch.from_numpy(v) for k, v in _overrides(19).items()}
    for remat in (False, True):
        mc = nerf_from_numpy(np_nerf(20), device="cpu")
        mf = nerf_from_numpy(np_nerf(21), device="cpu")
        out = render_rays(mc, mf, rays, None, N_samples=N_S, N_importance=N_I,
                          perturb=1.0, noise_std=1.0, white_back=True,
                          use_fused=True, fused_channel_io=True,
                          remat_fine=remat, overrides=ov)
        mse_loss(out, torch.full((N_RAYS, 3), 0.5)).backward()
        grads.append([p.grad.clone() for m in (mc, mf) for p in m.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------- five Adam steps vs JAX
def test_five_adam_steps_match_jax():
    pc, pf = np_nerf(22), np_nerf(23)
    for tree in (pc, pf):
        tree["sigma"]["w"] *= 10.0
    steps_per_epoch, lr = 2, 1e-3
    sched_j = joptim.make_lr_schedule(lr, "steplr", steps_per_epoch, 4,
                                      decay_step=(1, 2), decay_gamma=0.5)
    opt_j = joptim.get_optimizer("adam", sched_j)
    params_j = jax.tree_util.tree_map(jnp.asarray, {"coarse": pc, "fine": pf})
    state_j = opt_j.init(params_j)
    kw = dict(N_samples=N_S, N_importance=N_I, perturb=1.0, noise_std=1.0,
              white_back=True)

    def jstep(params, state, rays, rgbs, ov):
        def loss_fn(p):
            res = jax_render_rays(p["coarse"], p["fine"], rays, None,
                                  overrides=ov, **kw)
            return jloss_dict["mse"](res, rgbs)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, state = opt_j.update(grads, state, params)
        return jax.tree_util.tree_map(lambda a, b: a + b, params, upd), state, loss

    models = {"coarse": nerf_from_numpy(pc, device="cpu"),
              "fine": nerf_from_numpy(pf, device="cpu")}
    sched = optim.make_lr_schedule(lr, "steplr", steps_per_epoch, 4,
                                   decay_step=(1, 2), decay_gamma=0.5)
    opt = optim.get_optimizer("adam", sched, optim.named_params(models))
    for step in range(5):
        rays = _rays(100 + step)
        rgbs = np.random.RandomState(200 + step).uniform(size=(N_RAYS, 3)).astype(np.float32)
        ov = _overrides(300 + step)
        params_j, state_j, loss_j = jstep(params_j, state_j, jnp.asarray(rays),
                                          jnp.asarray(rgbs),
                                          {k: jnp.asarray(v) for k, v in ov.items()})
        out = render_rays(models["coarse"], models["fine"], torch.from_numpy(rays),
                          None, use_fused=True, fused_channel_io=True,
                          overrides={k: torch.from_numpy(v) for k, v in ov.items()},
                          **kw)
        loss = mse_loss(out, torch.from_numpy(rgbs))
        opt.zero_grad()
        loss.backward()
        opt.step()
        # f32 end to end: the order of the sums only
        np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
        assert abs(sched(step) - float(sched_j(step))) <= 1e-12
    assert opt.count == 5 and int(state_j[0].count) == 5
    got = np.concatenate([a.ravel() for name in ("coarse", "fine") for a in
                          jax.tree_util.tree_leaves(nerf_to_numpy(models[name]))])
    want = np.concatenate([np.asarray(b).ravel() for name in ("coarse", "fine")
                           for b in jax.tree_util.tree_leaves(params_j[name])])
    # Adam moves each weight by up to lr per step whatever the grad's size,
    # so where a grad is itself at rounding level the two trajectories can
    # part by a fraction of lr (on the CPU: one weight 1.6e-4, 0.07% of them
    # past 2e-6); everywhere else they agree to 2e-6.  (JAX runs eagerly
    # here: under jit XLA:CPU sums the renderer in another order, which is
    # as far from its own eager result.)
    d = np.abs(got - want)
    assert d.max() <= 0.25 * lr, d.max()
    assert (d <= 2e-6).mean() >= 0.999, (d <= 2e-6).mean()


def test_adam_state_tree_is_optax_layout():
    models = {"coarse": nerf_from_numpy(np_nerf(24, D=2, W=16, skips=()), device="cpu")}
    opt = optim.get_optimizer("adam", optim.make_lr_schedule(1e-3, "steplr", 1, 1),
                              optim.named_params(models))
    for p in models["coarse"].parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    tree = opt.state_tree()
    assert sorted(tree) == ["0", "1"]
    assert tree["0"]["count"] == 1 and tree["1"]["count"] == 1
    assert tree["0"]["count"].dtype == np.int32
    ref = joptim.get_optimizer("adam", joptim.make_lr_schedule(1e-3, "steplr", 1, 1)).init(
        {"coarse": np_nerf(24, D=2, W=16, skips=())})
    j_mu = jax.tree_util.tree_structure(ref[0].mu)
    assert jax.tree_util.tree_structure(
        {"coarse": {k: ([v[str(i)] for i in range(len(v))] if k == "xyz_layers" else v)
                    for k, v in tree["0"]["mu"]["coarse"].items()}}) == j_mu
    again = optim.get_optimizer("adam", optim.make_lr_schedule(1e-3, "steplr", 1, 1),
                                optim.named_params(models))
    again.load_state_tree(tree)
    assert again.count == 1 and all(torch.equal(again.mu[k], opt.mu[k]) for k in opt.mu)


def _adam_step_before(opt):
    """``Adam.step`` as it was before its scalars moved in one non-blocking
    copy (a scalar copied to each parameter's device per parameter): the
    frozen reference of the update's bits."""
    b1, b2 = opt.b1, opt.b2
    count = opt.count + 1
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
    lr = -opt.schedule(opt.sched_count)
    with torch.no_grad():
        for k, g in opt._grads().items():
            p = opt.params[k]
            if opt.weight_decay > 0:
                g = g + opt.weight_decay * p
            mu, nu = opt.mu[k], opt.nu[k]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            mu_hat = mu / c1.to(mu.device, mu.dtype)
            nu_hat = nu / c2.to(nu.device, nu.dtype)
            update = mu_hat / (torch.sqrt(nu_hat) + opt.eps)
            p.add_(torch.tensor(lr, dtype=p.dtype, device=p.device) * update)
    opt.count = count
    opt.sched_count += 1


@pytest.mark.parametrize("grad_clip", [0.0, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["nowd", "wd"])
def test_adam_step_is_bit_equal_to_the_step_before(weight_decay, grad_clip):
    # 6 steps at 2 steps an epoch, the rate halved at epochs 1 and 2: two
    # step-LR boundaries; one parameter without a grad at every third step
    tree = np_nerf(26, D=2, W=16, skips=())
    opts = []
    for _ in range(2):
        models = {"coarse": nerf_from_numpy(tree, device="cpu")}
        sched = optim.make_lr_schedule(1e-2, "steplr", 2, 3,
                                       decay_step=(1, 2), decay_gamma=0.5)
        opts.append(optim.get_optimizer(
            "adam", sched, optim.named_params(models),
            weight_decay=weight_decay, grad_clip=grad_clip))
    new, old = opts
    rng = np.random.RandomState(27)
    for step in range(6):
        grads = {k: rng.normal(scale=0.1, size=tuple(p.shape)).astype(
            np.float32) for k, p in new.params.items()}
        for opt in opts:
            for k, p in opt.params.items():
                none = step % 3 == 2 and k.endswith("rgb/b")
                p.grad = None if none else torch.from_numpy(grads[k].copy())
        new.step()
        _adam_step_before(old)
        assert (new.count, new.sched_count) == (old.count, old.sched_count)
        for k in new.params:
            assert torch.equal(new.params[k], old.params[k]), (step, k)
            assert torch.equal(new.mu[k], old.mu[k]), (step, k)
            assert torch.equal(new.nu[k], old.nu[k]), (step, k)
    assert new.count == 6 and new.schedule(5) == float(np.float32(2.5e-3))


# ------------------------------------------------------------ gradient clip
def test_grad_clip_matches_jax_and_keeps_dtypes():
    tree = np_nerf(25, D=2, W=16, skips=())
    rng = np.random.RandomState(26)
    grads = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
    sched = joptim.make_lr_schedule(1e-2, "steplr", 1, 1)
    jopt = joptim.get_optimizer("adam", sched, grad_clip=0.5)
    upd, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                         jopt.init(tree), tree)
    model = nerf_from_numpy(tree, device="cpu")
    opt = optim.get_optimizer("adam", optim.make_lr_schedule(1e-2, "steplr", 1, 1),
                              optim.named_params({"m": model}), grad_clip=0.5)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(_leaf(grads, name).copy())
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _leaf(tree, name) + _leaf(upd, name), atol=1e-7)
    # each leaf keeps its dtype (the JAX wrapper promotes to f32)
    bf = {"a": torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16)),
          "b": torch.nn.Parameter(torch.ones(2))}
    bf["a"].grad = torch.full((3,), 4.0, dtype=torch.bfloat16)
    bf["b"].grad = torch.full((2,), 4.0)
    clipped = optim.Adam(bf, lambda s: 1e-3, grad_clip=1.0)._grads()
    assert clipped["a"].dtype == torch.bfloat16 and clipped["b"].dtype == torch.float32
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in clipped.values()))
    assert abs(float(norm) - 1.0) < 1e-2


def test_unported_optimizers_and_schedules_raise():
    """Once refused as not ported: every optimiser, schedule and warm-up of
    the JAX package now builds (their numbers are held against optax in
    tests/test_torch_port_optim.py); only names JAX does not know raise."""
    sched = optim.make_lr_schedule(1e-3, "steplr", 1, 1)
    params = {"w": torch.nn.Parameter(torch.ones(2))}
    for name, cls in (("sgd", optim.SGD), ("adam", optim.Adam),
                      ("adamw", optim.Adam), ("radam", optim.RAdam),
                      ("ranger", optim.Ranger)):
        opt = optim.get_optimizer(name, sched, params)
        assert type(opt) is cls
        assert getattr(opt, "decoupled", name == "sgd") == (name != "adam")
    with pytest.raises(ValueError, match="not recognized"):
        optim.get_optimizer("lamb", sched, params)
    for name in ("cosine", "poly"):
        s = optim.make_lr_schedule(1e-3, name, 1, 4)
        assert s(0) == pytest.approx(1e-3) and 0 < s(3) < s(0)
    warm = optim.make_lr_schedule(1e-3, "steplr", 1, 4, warmup_epochs=2,
                                  warmup_multiplier=2.0)
    assert [warm(e) for e in range(4)] == pytest.approx([1e-3, 1.5e-3, 2e-3,
                                                         2e-3])
    with pytest.raises(ValueError, match="not recognized"):
        optim.make_lr_schedule(1e-3, "exponential", 1, 1)


# -------------------------------------------------------------------- Config
def test_config_fields_and_cli_match_jax():
    mine = [(f.name, f.type, f.default) for f in dataclasses.fields(config.Config)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.Config)]
    assert mine == ref
    argv = ["--root_dir", "/x", "--img_wh", "64", "64", "--N_importance", "64",
            "--decay_step", "2", "4", "8", "--compute_dtype", "bfloat16",
            "--white_back", "true", "--remat_fine", "--grad_clip", "1.5",
            "--use_fused_mlp", "false", "--num_gpus", "0", "1"]
    assert dataclasses.asdict(config.get_opts(argv)) == \
        dataclasses.asdict(jconfig.get_opts(argv))
