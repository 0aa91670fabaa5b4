"""The port's optimisers and schedules against the JAX package's optax chains
on the CPU: every optimiser x weight decay x ``--grad_clip`` for 14 steps
(past ranger's two lookahead syncs, at steps 6 and 12, and radam's switch to
the rectified update at step 6), every schedule x warm-up step by step, the
optax state layout against ``flax.serialization.to_state_dict``, and full
trainer checkpoints resumed both ways.

Tolerances, and why:
  * Every chain is held against the JAX chain's ``update`` under ``jit``,
    as the JAX trainer runs it, to ``TOL_MOMENT`` of the rate (worst reading
    on this CPU 1.34e-5, adam): XLA contracts a product and a sum into one
    fused multiply-add (the moments' ``(1 - b) g + b m``, sgd's trace), and
    forms ``decay ** count`` (and radam's ``ro`` from it) by its own float32
    ``pow``, an ulp from torch's at some counts (160 of the first 20,000 for
    0.9).  Adam's ``m / sqrt(v)`` magnifies such an ulp where ``m`` is a
    difference of nearly equal terms.
  * sgd without ``--grad_clip`` is also bit-equal to the JAX chain run op by
    op (no contraction): its chain is products and sums in the same order.
  * ``--grad_clip``'s global norm sums the same squares in another order
    (each leaf's reduction, and the leaves in another order), so its scale
    can differ by an ulp; held within ``TOL_MOMENT`` too.
  * The schedules: ``steplr`` and the warm-up ramp are bit-equal; ``cosine``
    and ``poly`` go through float32 ``cos`` and ``pow``, which XLA and numpy
    approximate differently, so they agree to ``TOL_SCHED`` relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu.training import optim as joptim
from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.models.nerf import nerf_from_numpy
from nerf_pl_tpu_torch.training import checkpoints
from nerf_pl_tpu_torch.training import optim
from nerf_pl_tpu_torch.training.trainer import NeRFSystem

from test_torch_port_models import np_nerf

TOL_MOMENT = 5e-5  # of the rate: roundings magnified by m / sqrt(v)
TOL_SCHED = 4e-7  # relative: an ulp of float32 cos or pow
STEPS, PER_EPOCH, LR = 14, 5, 1e-2
OPTIMIZERS = ["sgd", "sgd0", "adam", "adamw", "radam", "ranger"]


def _flat(tree, prefix=""):
    """A nested dict/list tree -> ``{"a/b/0/w": leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _tiny(seed):
    return {"m": np_nerf(seed, D=2, W=16, skips=())}


def _pair(name, wd, clip, tree, sched_kw=None):
    """(JAX chain, its state, params) and the port's optimiser on a model
    holding the same weights."""
    kind, momentum = ("sgd", 0.0) if name == "sgd0" else (name, 0.9)
    sk = sched_kw or dict(decay_step=(1,), decay_gamma=0.5)
    jsched = joptim.make_lr_schedule(LR, "steplr", PER_EPOCH, 3, **sk)
    jopt = joptim.get_optimizer(kind, jsched, momentum, wd, grad_clip=clip)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    models = {k: nerf_from_numpy(v, device="cpu") for k, v in tree.items()}
    sched = optim.make_lr_schedule(LR, "steplr", PER_EPOCH, 3, **sk)
    opt = optim.get_optimizer(kind, sched, optim.named_params(models),
                              momentum, wd, grad_clip=clip)
    return jopt, jopt.init(params), params, opt


def _grads(rng, opt):
    return {k: rng.normal(scale=0.1, size=tuple(p.shape)).astype(np.float32)
            for k, p in opt.params.items()}


def _jax_tree(flat, like):
    """``{"m/xyz_layers/0/w": array}`` in ``like``'s structure."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    names = list(_flat(like))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[n]) for n in names])


def _apply(params, updates):
    return jax.tree_util.tree_map(lambda p, u: p + u, params, updates)


def _step_both(jopt, jstate, params, opt, grads, jit=True):
    update = jax.jit(jopt.update) if jit else jopt.update
    upd, jstate = update(_jax_tree(grads, params), jstate, params)
    params = _apply(params, upd)
    for k, p in opt.params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    opt.step()
    return jstate, params


def _gap(params, opt):
    want = _flat(jax.tree_util.tree_map(np.asarray, params))
    return max(float(np.abs(opt.params[k].detach().numpy() - v).max())
               for k, v in want.items())


@pytest.mark.parametrize("clip", [0.0, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["nowd", "wd"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_trajectory_matches_jax(name, wd, clip):
    jopt, jstate, params, opt = _pair(name, wd, clip, _tiny(40))
    rng = np.random.RandomState(41)
    for step in range(STEPS):
        jstate, params = _step_both(jopt, jstate, params, opt, _grads(rng, opt))
        assert _gap(params, opt) <= TOL_MOMENT * LR, (step, _gap(params, opt))
    if name.startswith("sgd") and not clip:
        jopt, jstate, params, opt = _pair(name, wd, clip, _tiny(40))
        rng = np.random.RandomState(41)
        for step in range(STEPS):
            jstate, params = _step_both(jopt, jstate, params, opt,
                                        _grads(rng, opt), jit=False)
            assert _gap(params, opt) == 0.0, step
    if name == "ranger":
        assert opt.la_count == STEPS and int(jstate.count) == STEPS
        slow = _flat(jax.tree_util.tree_map(np.asarray, jstate.slow))
        for k, v in slow.items():
            np.testing.assert_allclose(opt.slow[k].numpy(), v, rtol=0,
                                       atol=TOL_MOMENT * LR)


def test_radam_switches_to_the_rectified_step_where_optax_does():
    opt = optim.get_optimizer("radam", lambda s: 1e-3,
                              optim.named_params({"m": nerf_from_numpy(
                                  np_nerf(42, D=2, W=16, skips=()), "cpu")}))
    switched = []
    for count in range(1, 9):
        opt.count = count - 1
        opt._scalars()
        switched.append(opt._rectified)
    # ro = 1999 - 2 t b2^t / (1 - b2^t) first passes 5 at t = 6
    assert switched == [False] * 5 + [True] * 3


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("kind", ["steplr", "cosine", "poly"])
@pytest.mark.parametrize("optimizer", ["adam", "radam"])
def test_schedules_match_jax(kind, warmup, optimizer):
    kw = dict(decay_step=(2, 4), decay_gamma=0.5, poly_exp=0.9,
              warmup_multiplier=2.0, warmup_epochs=warmup, optimizer=optimizer)
    jsched = jax.jit(joptim.make_lr_schedule(5e-4, kind, 3, 8, **kw))
    sched = optim.make_lr_schedule(5e-4, kind, 3, 8, **kw)
    for step in range(8 * 3):
        want = float(jsched(jnp.int32(step)))
        got = sched(step)
        assert type(got) is float
        if kind == "steplr" or (warmup and optimizer == "adam"
                                and step // 3 <= warmup):
            assert got == want, (step, got, want)
        else:
            assert abs(got - want) <= TOL_SCHED * abs(want), (step, got, want)
    with pytest.raises(ValueError, match="not recognized"):
        optim.make_lr_schedule(1e-3, "exp", 1, 1)


def _empty_paths(tree, prefix=""):
    """The paths of the empty dicts (``EmptyState``) in a state dict."""
    if not isinstance(tree, dict):
        return []
    if not tree:
        return [prefix]
    return [p for k, v in tree.items() for p in _empty_paths(v, f"{prefix}/{k}")]


def _shapes(tree):
    return {k: tuple(np.shape(np.asarray(v))) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["nowd", "wd"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_state_tree_is_optax_layout(name, wd):
    jopt, jstate, params, opt = _pair(name, wd, 0.0, _tiny(43))
    rng = np.random.RandomState(44)
    for _ in range(7):  # past a lookahead sync
        jstate, params = _step_both(jopt, jstate, params, opt, _grads(rng, opt))
    ref = serialization.to_state_dict(jstate)
    tree = opt.state_tree()
    assert _shapes(tree) == _shapes(ref)
    # the empty slots (EmptyState) are empty dicts in both
    empty = _empty_paths(ref)
    assert empty == _empty_paths(tree) and len(empty) == (wd > 0), empty
    for k, v in _flat(ref).items():
        mine = np.asarray(_flat(tree)[k])
        if np.asarray(v).dtype == np.int32:
            assert mine.dtype == np.int32 and mine == v, k
        else:
            np.testing.assert_allclose(mine, v, rtol=0, atol=TOL_MOMENT)
    # and back: a fresh optimiser takes the tree and steps as the original
    kind, momentum = _kind(name)
    again = optim.get_optimizer(kind, opt.schedule, {
        k: torch.nn.Parameter(p.detach().clone()) for k, p in opt.params.items()},
        momentum=momentum, weight_decay=wd)
    again.load_state_tree(tree)
    g = _grads(rng, opt)
    for o in (opt, again):
        for k, p in o.params.items():
            p.grad = torch.from_numpy(g[k].copy())
        o.step()
    for k in opt.params:
        assert torch.equal(opt.params[k], again.params[k]), k
    with pytest.raises(ValueError, match="optimizer state"):
        again.load_state_tree({"0": {}, "9": {}})


def _kind(name):
    return ("sgd", 0.0) if name == "sgd0" else (name, 0.9)


# ----------------------------------------------- checkpoints, both ways
def _argv(root, tmp, name, extra=()):
    kind, momentum = _kind(name)
    return ["--root_dir", str(root), "--dataset_name", "blender",
            "--img_wh", "16", "16", "--N_samples", "8", "--N_importance", "8",
            "--batch_size", "64", "--num_epochs", "2", "--lr", "5e-3",
            "--blender_near", "1", "--blender_far", "12",
            "--optimizer", kind, "--momentum", str(momentum),
            "--weight_decay", "1e-3", "--arch_width", "32", "--exp_name", "t",
            "--log_dir", str(tmp / "logs"), "--ckpt_dir", str(tmp / "ckpts"),
            *extra]


def _trainer_chain(name, steps_per_epoch):
    kind, momentum = _kind(name)
    sched = joptim.make_lr_schedule(5e-3, "steplr", steps_per_epoch, 2)
    return joptim.get_optimizer(kind, sched, momentum, 1e-3)


@pytest.mark.parametrize("name", ["ranger", "sgd"])
def test_full_state_resumes_both_ways(blender_root, tmp_path, name):
    # JAX -> port: a JAX trainer checkpoint after 7 steps (past a sync)
    params = {"coarse": np_nerf(45, W=32), "fine": np_nerf(46, W=32)}
    system = NeRFSystem(get_opts(_argv(blender_root, tmp_path / "a", name)),
                        device="cpu")
    jopt = _trainer_chain(name, system.steps_per_epoch)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.RandomState(47)
    names = list(system.optimizer.params)
    for _ in range(7):
        g = {k: rng.normal(scale=0.1, size=tuple(system.optimizer.params[k].shape))
             .astype(np.float32) for k in names}
        upd, jstate = jax.jit(jopt.update)(_jax_tree(g, jparams), jstate, jparams)
        jparams = _apply(jparams, upd)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, {"params": jparams, "opt_state": jstate,
                                 "epoch": 0})
    resumed = NeRFSystem(get_opts(_argv(blender_root, tmp_path / "b", name,
                                        ("--ckpt_path", path))), device="cpu")
    assert resumed.epoch0 == 1
    # the next step on both
    g = {k: rng.normal(scale=0.1, size=tuple(resumed.optimizer.params[k].shape))
         .astype(np.float32) for k in names}
    upd, jstate = jax.jit(jopt.update)(_jax_tree(g, jparams), jstate, jparams)
    jparams = _apply(jparams, upd)
    for k, p in resumed.optimizer.params.items():
        p.grad = torch.from_numpy(g[k].copy())
    resumed.optimizer.step()
    tol = TOL_MOMENT * 5e-3
    assert _gap(jparams, resumed.optimizer) <= tol

    # port -> JAX: the port's checkpoint, restored into the JAX chain's state
    out = resumed.save_ckpt(1, None, filename="last.ckpt")
    target = {"params": jax.tree_util.tree_map(jnp.asarray, params),
              "opt_state": jopt.init(jax.tree_util.tree_map(jnp.asarray, params)),
              "epoch": 0}
    state = jckpt.load_checkpoint(out, target)
    assert int(state["epoch"]) == 1
    g = {k: rng.normal(scale=0.1, size=tuple(resumed.optimizer.params[k].shape))
         .astype(np.float32) for k in names}
    upd, _ = jax.jit(jopt.update)(_jax_tree(g, state["params"]),
                                  state["opt_state"], state["params"])
    after = _apply(state["params"], upd)
    for k, p in resumed.optimizer.params.items():
        p.grad = torch.from_numpy(g[k].copy())
    resumed.optimizer.step()
    # the port's bits went into the file, so both take the same step
    assert _gap(after, resumed.optimizer) <= tol
    resumed.logger.close()
    system.logger.close()
    raw = checkpoints.load_checkpoint(out)
    key = "inner" if name == "ranger" else "0"
    assert key in raw["opt_state"]
