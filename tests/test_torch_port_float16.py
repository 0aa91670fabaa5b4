"""``--compute_dtype float16`` against the JAX package on the CPU: the
rounding, the fused MLP's forward (kernels C, C', D, D' plain) and backward
(E, E', F, F' plain) against the Pallas kernels in interpret mode, a
cotangent in fp16's subnormal range, a render step's grads and two Adam
steps of the vanilla trainer, and the trainers' dtype gate.  The kernels
themselves run only on the card (``chip_smoke.py`` phase 15).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from nerf_pl_tpu_torch.training.trainer import common_unsupported

from test_torch_port_models import np_nerf
from test_torch_port_ops import _raw_t
from test_torch_port_render import _rays
from test_torch_port_train import _fused_call, _leaf

F16 = torch.float16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side of these tests runs small products: one torch thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f16_bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float16).view(np.uint16)


def test_float16_rounding_matches_jax():
    """The port rounds to fp16 by ``.to(torch.float16)``, JAX by
    ``astype(float16)``: the same bits at the ties of normal values (to
    even), in the subnormal range (steps of 2^-24, ties to even, 0 below
    2^-25) and at the top (65,504; 65,520 and up give inf)."""
    tiny = 2.0 ** -24
    v = np.array([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11),
                  0.5 * tiny, 0.5 * tiny * (1 + 2 ** -10), 1.5 * tiny,
                  2.5 * tiny, 1e-6, -3e-7, 2.0 ** -14 - 0.5 * tiny,
                  6.1e-5, 65504.0, 65519.99, 65520.0, 1e5, -1e5,
                  np.inf, 1e-40, 0.0, -0.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.float16))
    got = torch.from_numpy(v).to(F16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    assert got[3] == 0 and got[4] == np.float16(tiny) and got[5] == 2 * tiny
    assert np.isinf(got[13]) and got[12] == 65504.0


P, P_PAD, BLOCK = 200, 256, 128  # ragged against the kernels' tiles


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """JAX's kernel D (``_raw_t_stash_fwd_call``, interpret mode, rgb) at
    fp16 on 200 points padded to 256: (tree, x, packed params, padded x,
    out (8, 200), stash (256, 2432), its embedding (xe, de) in the original
    channel order).  Its h1..h8 are the sigma-only stash too, and its row 3
    the sigma-only output.  The Pallas calls are made directly, so JAX's
    grads come from the backward kernel without tracing ``jax.grad``."""
    tree = np_nerf(8)
    x = _raw_t(9, P)
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, P_PAD - P))))
    packed = jfused.pack_params_raw(tree, jnp.float16)
    out, st = jfused._raw_t_stash_fwd_call(packed, xp, False, BLOCK, True)
    emb = np.asarray(jfused._embed_tile_t(jnp.asarray(x)))
    perm = jfused._RAW_PERM
    return (tree, x, packed, xp, np.asarray(out)[:, :P], st,
            emb[:, perm[:63]], emb[:, perm[63:90]])


def _jax_stash():
    tree, x, _, _, out, st, xe, de = _jax_forward()
    return tree, x, out, np.asarray(st.astype(jnp.float32))[:P], xe, de


def _f16_tie_gap(v: np.ndarray) -> np.ndarray:
    """|v|'s distance to the nearer boundary of its fp16 rounding interval
    (the kernels' near_tie_f16)."""
    a = np.abs(v).astype(np.float32)
    hb = a.astype(np.float16).view(np.uint16).astype(np.int32)
    r = hb.astype(np.uint16).view(np.float16).astype(np.float32)
    nxt = np.minimum(hb + 1, 0x7C00).astype(np.uint16).view(
        np.float16).astype(np.float32)
    prv = np.maximum(hb - 1, 0).astype(np.uint16).view(
        np.float16).astype(np.float32)
    hi = np.where(hb == 0x7BFF, 65520.0, 0.5 * (r + nxt))
    lo = np.where(hb == 0, -hi, 0.5 * (r + prv))
    return np.minimum(hi - a, a - lo)


@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb", "sigma"])
def test_float16_forward_matches_jax(sigma_only):
    """C and C' (the plain versions) against JAX's fused forward at fp16,
    and D's stash layer by layer: each of the port's layers, fed JAX's own
    rounded input from JAX's stash (and JAX's embedding, whose cos is
    sin(t + pi/2)), gives JAX's rounded output bit for bit, except where
    the f32 sum lies so close to an fp16 rounding boundary that the two
    frameworks' sum orders (torch's and XLA's) round it apart: each such
    value is one fp16 step from JAX's and within the kernels' tie margin
    (TIE_ULPS = 256 f32 ulps of it, or TIE_FLOOR = 2^-20 of the layer's
    largest |output|, where its terms cancel).  D' is D on the transposes,
    bit for bit."""
    tree, x, out_j, st_j, xe, de = _jax_stash()
    if sigma_only:
        # D's stash and out of the rgb call: sigma-only stops after h8
        out_j = np.concatenate([out_j[3:4], np.zeros_like(out_j[1:])])
        st_j = st_j[:, :fused_mlp.STASH_COLS_SIGMA]
    model = nerf_from_numpy(tree, device="cpu")
    xt = torch.from_numpy(x)
    out = fused_mlp.fused_nerf_apply_raw_t(model, xt, sigma_only, F16)
    out = out.detach()
    out_r = fused_mlp.fused_nerf_apply_raw_plain(model, xt.T.contiguous(),
                                                 sigma_only, F16)
    assert torch.equal(out_r, out.T)
    # the encodings' cos differs (sin(t + pi/2) in JAX, cosf in the port):
    # up to ~1e-4 on a 2^9-scaled channel, which the 8-layer trunk carries
    # to the outputs (1.1e-5 here, 3.9e-4 at other seeds on the CPU; bf16's
    # hold is 5e-3)
    np.testing.assert_allclose(out.numpy(), out_j, atol=2e-3, rtol=0)
    _, st = fused_mlp.fused_nerf_stash_fwd_plain(model, xt, sigma_only, F16)
    _, st_r = fused_mlp.fused_nerf_raw_stash_fwd_plain(
        model, xt.T.contiguous(), sigma_only, F16)
    assert st.dtype == F16 and torch.equal(st, st_r)

    w = fused_mlp.W
    h_j = [xe] + [st_j[:, i * w:(i + 1) * w] for i in range(fused_mlp.D)]
    inputs = [(model.xyz_layers[i], np.concatenate([xe, h_j[i]], 1)
               if i == fused_mlp.SKIP else h_j[i], h_j[i + 1], True)
              for i in range(fused_mlp.D)]
    if not sigma_only:
        fin_j = st_j[:, fused_mlp.STASH_FIN:fused_mlp.STASH_D]
        inputs += [(model.xyz_final, h_j[fused_mlp.D], fin_j, False),
                   (model.dir_layer, np.concatenate([fin_j, de], 1),
                    st_j[:, fused_mlp.STASH_D:], True)]
    apart = 0
    for layer, a_in, want, relu in inputs:
        with torch.no_grad():
            pre = layer(torch.from_numpy(np.ascontiguousarray(a_in)),
                        F16).numpy()
        floor = np.abs(pre).max() * 2.0 ** -20
        got = np.maximum(pre, 0) if relu else pre
        diff = _f16_bits(got) != _f16_bits(want)
        apart += int(diff.sum())
        if diff.any():
            steps = np.abs(_f16_bits(got)[diff].astype(np.int32)
                           - _f16_bits(want)[diff].astype(np.int32))
            assert steps.max() == 1, steps.max()
            ulps = np.abs(pre[diff]).view(np.int32) & 0x7F800000
            margin = np.maximum(ulps.view(np.float32) * (256 / 2.0 ** 23),
                                floor)
            assert (_f16_tie_gap(pre[diff]) <= margin).all()
    # a few ties in 200 points x 2,432 values (35 rgb, 34 sigma-only on the
    # CPU: 7e-5 and 8e-5 of them)
    assert apart <= 100, apart


# (layout, stash blocks or None for the remat route, sigma-only): E and E'
# on the stash route in rgb, F and F' on the remat route sigma-only, each
# against JAX's grads of its route (JAX's channel-major call: its row-major
# kernels run the same _bwd_core on the same embedding)
GRAD_CASES = [("channel", (96, 48), False), ("row", (96, 48), False),
              ("channel", None, True), ("row", None, True)]


@functools.lru_cache(maxsize=None)
def _jax_grads(stash, sigma_only, scale=1.0):
    """JAX's parameter grads for the cotangent g (8, 200) of the fused
    MLP's output at fp16: its backward kernel (``_raw_t_bwd_call``,
    interpret mode) on D's stash or by recomputation, each packed grad cast
    to its packed dtype as ``_fused_raw_t_bwd_rule`` casts it, then through
    the transpose of ``pack_params_raw`` (its unpermuting and casts), as
    ``jax.grad`` of ``fused_nerf_apply_raw_t`` takes them."""
    tree, x, packed, xp, _, st, _, _ = _jax_forward()
    g = np.random.RandomState(3).normal(size=(8, P)).astype(
        np.float32) * np.float32(scale)
    g[1 if sigma_only else 4:] = 0.0  # what the row-major output drops
    gp = jnp.asarray(np.pad(g, ((0, 0), (0, P_PAD - P))))
    outs = jfused._raw_t_bwd_call(packed, xp, gp, sigma_only, BLOCK, True,
                                  stash=st if stash else None)
    gpacked = {k: v.astype(packed[k].dtype)
               for k, v in zip(jfused._PKEYS, outs[1:])}
    _, vjp = jax.vjp(lambda p: jfused.pack_params_raw(p, jnp.float16),
                     jax.tree_util.tree_map(jnp.asarray, tree))
    return tree, x, g, vjp(gpacked)[0]


def _port_grads(tree, x, g, layout, stash, sigma_only, dtype):
    _, tcall, pick = _fused_call(layout, x, sigma_only)
    model = nerf_from_numpy(tree, device="cpu")
    launches = {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    (tcall(model, dtype, stash) * torch.from_numpy(pick(g))).sum().backward()
    assert launches == {k: fn.launches for k, fn in fused_mlp.KERNELS.items()}
    return model


def _worst(model, ref) -> tuple:
    mx = mean = 0.0
    for name, p in model.named_parameters():
        want = _leaf(ref, name)
        assert p.grad.dtype == torch.float32 and p.grad.shape == want.shape
        scale = max(np.abs(want).max(), 1e-30)
        d = np.abs(p.grad.numpy() - want)
        mx, mean = max(mx, d.max() / scale), max(mean, d.mean() / scale)
    return mx, mean


# Per tensor, relative to its largest |grad|: the two sides' sum orders and
# encodings (JAX's cos is sin(t + pi/2)) round an activation or a g_pre to
# the neighbouring fp16 value, or flip a ReLU mask at a near-zero
# pre-activation, and the backward carries that down the layers (2.9e-2
# max, 9.1e-4 mean on the CPU over the eight layout x route x mode cases).
# bf16's hold is (5e-2, 3e-3); the same backward rounded at bf16 where fp16
# is stated reads 0.20-0.24 max, 2.6e-2 mean against JAX's fp16.
TOL_F16_GRADS = (4e-2, 1.5e-3)


@pytest.mark.parametrize("layout,stash,sigma_only", GRAD_CASES)
def test_float16_fused_grads_match_jax(layout, stash, sigma_only):
    tree, x, g, ref = _jax_grads(stash, sigma_only)
    mx, mean = _worst(_port_grads(tree, x, g, layout, stash, sigma_only, F16),
                      ref)
    assert mx <= TOL_F16_GRADS[0] and mean <= TOL_F16_GRADS[1], (mx, mean)
    # the control: the port's backward rounded at bf16 must fail the limits
    c_mx, c_mean = _worst(_port_grads(tree, x, g, layout, stash, sigma_only,
                                      torch.bfloat16), ref)
    assert c_mx > TOL_F16_GRADS[0] and c_mean > TOL_F16_GRADS[1], (c_mx,
                                                                   c_mean)


def test_float16_subnormal_cotangent_matches_jax():
    """A cotangent of ~1e-5 (below fp16's normal range from 2^-14 = 6.1e-5)
    rounds to subnormals at the top of the sweep, and further down to
    zeros: the port rounds at the same places as JAX, so the weight grads
    that come out exactly 0 are JAX's (0.1% apart: where the two sum
    orders round a value to the neighbouring subnormal), and the others
    JAX's to fp16's subnormal step, 2^-24: a weight grad (rounded to fp16)
    within one step, a bias grad (an f32 sum of the unrounded g_pre) within
    two (on the CPU: 1.0 and 1.5 steps).  Relative to a tensor's largest
    value such a step is large where every value is a few steps (0.5 on the
    CPU), so the float16 limits do not apply."""
    args = ("channel", (96, 48), False)
    tree, x, g, ref = _jax_grads(*args[1:], scale=1e-5)
    assert (np.abs(g[:4]) < 2.0 ** -14).mean() > 0.99
    model = _port_grads(tree, x, g, *args, F16)
    zeros = sum(int((p.grad == 0).sum()) for p in model.parameters())
    zeros_j = sum(int((_leaf(ref, n) == 0).sum())
                  for n, _ in model.named_parameters())
    f32 = _port_grads(tree, x, g, *args, torch.float32)
    zeros_f32 = sum(int((p.grad == 0).sum()) for p in f32.parameters())
    # underflow: fp16 zeroes grads that f32 keeps
    assert zeros_j > zeros_f32 + 1000, (zeros_j, zeros_f32)
    assert abs(zeros - zeros_j) <= 1e-3 * zeros_j, (zeros, zeros_j)
    step = 2.0 ** -24
    for name, p in model.named_parameters():
        d = np.abs(p.grad.numpy() - _leaf(ref, name)).max()
        assert d <= (step if name.endswith(".w") else 2 * step), (name, d)


N_STEP_RAYS, STEP_LR = 64, 1e-3


def _step_inputs(step: int):
    rng = np.random.RandomState(40 + step)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    ov = {"perturb_rand": f(N_STEP_RAYS, 8),
          "noise_coarse": rng.normal(size=(N_STEP_RAYS, 8)).astype(np.float32),
          "u": f(N_STEP_RAYS, 8), "jitter": f(N_STEP_RAYS, 8),
          "noise_fine": rng.normal(size=(N_STEP_RAYS, 16)).astype(np.float32)}
    return _rays(2 + step, N_STEP_RAYS), f(N_STEP_RAYS, 3), ov


STEP_KW = dict(N_samples=8, N_importance=8, perturb=1.0, noise_std=1.0,
               white_back=True)


@functools.lru_cache(maxsize=None)
def _jax_adam_steps():
    """Two Adam steps of JAX's render + MSE at fp16 (np_nerf seeds 0 and 1,
    64 rays, 8 + 8 samples, perturb and noise injected): each step's loss
    and grads, and the parameters after them.  Jitted (eagerly each grad
    takes ~10-30 s here); XLA then sums in its own order, as the port
    does in another."""
    opt = joptim.get_optimizer("adam", lambda s: STEP_LR)
    params = jax.tree_util.tree_map(jnp.asarray, {"coarse": np_nerf(0),
                                                  "fine": np_nerf(1)})
    state = opt.init(params)

    @jax.jit
    def step(p, s, rays, rgbs, ov):
        def loss_fn(q):
            res = jax_render_rays(q["coarse"], q["fine"], rays, None,
                                  overrides=ov, compute_dtype=jnp.float16,
                                  **STEP_KW)
            return jloss_dict["mse"](res, rgbs)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, s = opt.update(grads, s, p)
        return jax.tree_util.tree_map(lambda a, b: a + b, p, upd), s, loss, \
            grads

    losses, grads = [], []
    for i in range(2):
        rays, rgbs, ov = _step_inputs(i)
        params, state, loss, g = step(
            params, state, jnp.asarray(rays), jnp.asarray(rgbs),
            {k: jnp.asarray(v) for k, v in ov.items()})
        losses.append(float(loss))
        grads.append(g)
    return losses, grads, params


def _port_adam_steps(dtype, steps=2):
    models = {"coarse": nerf_from_numpy(np_nerf(0), device="cpu"),
              "fine": nerf_from_numpy(np_nerf(1), device="cpu")}
    opt = optim.get_optimizer("adam", lambda s: STEP_LR,
                              optim.named_params(models))
    losses, zeros = [], []
    for i in range(steps):
        rays, rgbs, ov = _step_inputs(i)
        out = render_rays(models["coarse"], models["fine"],
                          torch.from_numpy(rays), None, use_fused=True,
                          fused_channel_io=True, compute_dtype=dtype,
                          overrides={k: torch.from_numpy(v)
                                     for k, v in ov.items()}, **STEP_KW)
        loss = mse_loss(out, torch.from_numpy(rgbs))
        opt.zero_grad()
        loss.backward()
        zeros.append(sum(int((p.grad == 0).sum()) for m in models.values()
                         for p in m.parameters()))
        opt.step()
        losses.append(float(loss.detach()))
    return losses, zeros, models


def test_float16_render_step_zero_grads_match_jax():
    """The render step's grads at fp16 (the fused MLP's plain D and E):
    as many exactly-0 grads as JAX's (its small cotangents underflow when
    rounded to fp16: about twice f32's), within 1%, and not within 1% of
    the port's own f32 count."""
    _, grads_j, _ = _jax_adam_steps()
    zeros_j = sum(int((np.asarray(a) == 0).sum())
                  for a in jax.tree_util.tree_leaves(grads_j[0]))
    _, (zeros, _), _ = _port_adam_steps(F16)
    _, (zeros_f32,), _ = _port_adam_steps(torch.float32, steps=1)
    assert abs(zeros - zeros_j) <= 0.01 * zeros_j, (zeros, zeros_j)
    assert abs(zeros - zeros_f32) > 0.01 * zeros_f32, (zeros, zeros_f32)


def test_float16_two_adam_steps_match_jax():
    """Two Adam steps of the vanilla trainer's step at fp16 against JAX's:
    the losses within 1e-4, and the parameters.  Adam moves each weight by
    up to about lr a step whatever its grad's size, so a weight whose grad
    is 0 on one side (underflow) and not on the other, or of the other sign
    (a grad at rounding level, where fp16's flips and XLA's sum order under
    jit part the two), parts by up to 2 lr a step: none may part by more
    than 4 lr, and at most 6% by more than lr / 2 (on the CPU 4.1%, at most
    3.76 lr).  The same steps rounded at bf16 part 10.2% of the weights by
    more than lr / 2 and must fail that."""
    losses_j, _, params_j = _jax_adam_steps()
    losses, _, models = _port_adam_steps(F16)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    got = np.concatenate([a.ravel() for name in ("coarse", "fine") for a in
                          jax.tree_util.tree_leaves(
                              nerf_to_numpy(models[name]))])
    want = np.concatenate([np.asarray(b).ravel() for name in ("coarse", "fine")
                           for b in jax.tree_util.tree_leaves(params_j[name])])
    d = np.abs(got - want)
    assert d.max() <= 4 * STEP_LR, d.max()
    assert (d > 0.5 * STEP_LR).mean() <= 0.06, (d > 0.5 * STEP_LR).mean()
    _, _, bf16 = _port_adam_steps(torch.bfloat16)
    got_bf = np.concatenate([a.ravel() for name in ("coarse", "fine") for a in
                             jax.tree_util.tree_leaves(
                                 nerf_to_numpy(bf16[name]))])
    assert (np.abs(got_bf - want) > 0.5 * STEP_LR).mean() > 0.06


def test_float16_is_a_compute_dtype_of_every_trainer():
    """``common_unsupported`` (every trainer's gate) takes float16 as JAX's
    ``jnp.dtype`` does, and still refuses a name the kernels are not built
    for."""
    for name in ("float32", "bfloat16", "float16"):
        cfg = config.get_opts(["--compute_dtype", name])
        assert not any(common_unsupported(cfg).values()), name
    cfg = config.get_opts(["--compute_dtype", "float64"])
    assert common_unsupported(cfg) == {"--compute_dtype float64": True}
