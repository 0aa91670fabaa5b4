"""The port's camera and shadow-mapping math against the JAX package's, on
the CPU: the same numpy inputs through both, outputs and input grads, in
float64 and float32.

Tolerances: the camera functions are numpy in both packages (1e-6).  The
shadow functions hold each output and each grad relative to its largest
magnitude, 1e-10 in float64 and 1e-5 in float32: only the order of the
3-term products and the norms' sums differs between ``einsum`` and
``matmul``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.models import camera as jcam
from nerf_pl_tpu.ops import shadow_mapping as jsm
from nerf_pl_tpu_torch.models import camera as tcam
from nerf_pl_tpu_torch.ops import shadow_mapping as tsm

DTYPES = [np.float64, np.float32]
TOL = {np.float64: 1e-10, np.float32: 1e-5}
RES = (8, 8)


# ------------------------------------------------------------------ camera
def test_camera_functions_match_jax():
    rng = np.random.RandomState(0)
    for hfov, res in ((45.8, (64, 64)), (30.0, (16, 12))):
        np.testing.assert_allclose(tcam.intrinsic_matrix(hfov, res),
                                   jcam.intrinsic_matrix(hfov, res), atol=1e-6)
    M = jcam.intrinsic_matrix(40.0, (8, 8))
    for _ in range(3):
        eye = rng.uniform(-5, 5, 3).astype(np.float32)
        c2w = tcam.c2w_from_lookat(eye, np.zeros(3, np.float32))[:3]
        np.testing.assert_allclose(
            tcam.c2w_from_lookat(eye, np.zeros(3, np.float32)),
            jcam.c2w_from_lookat(eye, np.zeros(3, np.float32)), atol=1e-6)
        for a, b in zip(tcam.pose_from_blender_matrix(M, c2w),
                        jcam.pose_from_blender_matrix(M, c2w)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    # batched on a leading axis, as the per-ray shadow path uses it
    mats = rng.normal(size=(5, 3, 3)).astype(np.float32) + 3 * np.eye(3)
    eyes = rng.normal(size=(5, 3)).astype(np.float32)
    to_m = rng.normal(size=(3, 3)).astype(np.float32) + 3 * np.eye(3)
    to_e = rng.normal(size=3).astype(np.float32)
    for a, b in zip(tcam.transformation_between(mats, eyes, to_m, to_e),
                    jcam.transformation_between(mats, eyes, to_m, to_e)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    tc, jc = tcam.Camera.create(40.0, (8, 8)), jcam.Camera.create(40.0, (8, 8))
    tl, jl = tcam.Camera.create(30.0, (8, 8)), jcam.Camera.create(30.0, (8, 8))
    c2w = tcam.c2w_from_lookat(np.array([3.0, 2.0, 4.0], np.float32),
                               np.zeros(3, np.float32))[:3]
    l2w = tcam.c2w_from_lookat(np.array([4.5, 7.5, 3.0], np.float32),
                               np.zeros(3, np.float32))[:3]
    for cam, light in ((tc, tl), (jc, jl)):
        cam.set_pose_using_blender_matrix(c2w)
        light.set_pose_using_blender_matrix(l2w)
    for a, b in zip(tc.get_transformation_to(tl), jc.get_transformation_to(jl)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for get in ("get_a", "get_b", "get_c"):
        np.testing.assert_allclose(getattr(tc, get)(), getattr(jc, get)(),
                                   atol=1e-6)
    with pytest.raises(ValueError):
        tc.set_pose_using_blender_matrix(c2w, transform_coords=True)


# ------------------------------------------------------------- a harness
def _both(jfn, tfn, args, grad_at, dtype, seed=0):
    """Run ``jfn`` on jnp arrays and ``tfn`` on torch tensors made from the
    same numpy ``args`` (floats cast to ``dtype``); returns (outputs, grads)
    of each, the grads of ``sum(out * cot)`` with respect to ``args[i]`` for
    ``i`` in ``grad_at`` (``cot`` a seeded normal draw)."""
    cast = [a.astype(dtype) if isinstance(a, np.ndarray) and a.dtype.kind == "f"
            else a for a in args]
    with jax.enable_x64(dtype == np.float64):
        jfn = jax.jit(jfn)  # one compile beats eager dispatch of the graph
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in cast]
        out_j = np.asarray(jfn(*jargs))
        cot = np.random.RandomState(seed).normal(size=out_j.shape).astype(dtype)

        def loss(*g):
            full = list(jargs)
            for i, v in zip(grad_at, g):
                full[i] = v
            return jnp.sum(jfn(*full) * cot)

        grads_j = jax.grad(loss, argnums=tuple(range(len(grad_at))))(
            *[jargs[i] for i in grad_at])
    targs = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
             else a for a in cast]
    for i in grad_at:
        targs[i].requires_grad_(True)
    out_t = tfn(*targs)
    (out_t * torch.from_numpy(cot)).sum().backward()
    # an input the output does not reach has no grad in torch, zeros in JAX
    grads_t = [np.zeros(cast[i].shape, dtype) if targs[i].grad is None
               else targs[i].grad.numpy() for i in grad_at]
    return (out_j, out_t.detach().numpy()), [(np.asarray(a), b) for a, b in
                                             zip(grads_j, grads_t)]


def _close(ref, got, tol, what=""):
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    assert np.isfinite(got).all() == np.isfinite(ref).all(), what
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - ref).max() / scale
    assert err <= tol, (what, err)


def _check(jfn, tfn, args, grad_at, dtype, seed=0):
    outs, grads = _both(jfn, tfn, args, grad_at, dtype, seed)
    _close(*outs, TOL[dtype], "out")
    for i, (a, b) in zip(grad_at, grads):
        _close(a, b, TOL[dtype], f"grad {i}")


def _scene(n, n_poses, seed):
    """Per-ray camera matrices and eyes for ``n_poses`` cameras looking at
    the origin, a light PPC above them, pixel rows and depths."""
    rng = np.random.RandomState(seed)
    M = tcam.intrinsic_matrix(40.0, RES)
    cams, eyes = [], []
    for p in range(n_poses):
        th = 2 * np.pi * p / n_poses + 0.3
        eye = np.array([4 * np.sin(th), 1.5, 4 * np.cos(th)], np.float32)
        c, e = tcam.pose_from_blender_matrix(
            M, tcam.c2w_from_lookat(eye, np.zeros(3, np.float32))[:3])
        cams.append(c)
        eyes.append(e)
    light_m, light_eye = tcam.pose_from_blender_matrix(
        tcam.intrinsic_matrix(45.0, RES),
        tcam.c2w_from_lookat(np.array([3.0, 6.0, 2.0], np.float32),
                             np.zeros(3, np.float32))[:3])
    pose_idx = np.sort(rng.randint(0, n_poses, n)).astype(np.int32)
    pix = np.stack([rng.randint(0, RES[0], n) + 0.5,
                    rng.randint(0, RES[1], n) + 0.5, np.ones(n)], 1)
    yy, xx = np.meshgrid(np.arange(RES[1]), np.arange(RES[0]), indexing="ij")
    light_pix = np.stack([xx.reshape(-1) + 0.5, yy.reshape(-1) + 0.5,
                          np.ones(RES[0] * RES[1])], 1)
    return dict(cam_ms=np.stack(cams), cam_eyes=np.stack(eyes),
                cam_m=np.stack(cams)[pose_idx], cam_eye=np.stack(eyes)[pose_idx],
                light_m=light_m, light_eye=light_eye, pose_idx=pose_idx,
                pix=pix.astype(np.float32), light_pix=light_pix.astype(np.float32),
                cam_depth=rng.uniform(2.5, 6.0, n), cam_depth_f=rng.uniform(2.5, 6.0, n),
                light_depth=rng.uniform(3.0, 9.0, RES[0] * RES[1]),
                light_depth_f=rng.uniform(3.0, 9.0, RES[0] * RES[1]))


# ------------------------------------------------------- the functions
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_normalize_min_max_and_normed_w(dtype):
    s = _scene(40, 3, 1)
    x = np.random.RandomState(2).normal(size=50)
    x[[3, 9]] = x.min() - 1.0  # a tie at the min
    _check(jsm.normalize_min_max, tsm.normalize_min_max, [x], [0], dtype)
    pd = np.concatenate([s["pix"], s["cam_depth"][:, None]], 1)
    for m in (s["cam_m"], s["cam_m"][0]):  # per ray and one shared matrix
        _check(jsm.get_normed_w, tsm.get_normed_w, [m, pd], [0, 1], dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_project_and_gather(dtype):
    s = _scene(60, 3, 3)
    R, Q = tcam.transformation_between(s["cam_m"], s["cam_eye"], s["light_m"],
                                       s["light_eye"])
    w_cam = np.random.RandomState(4).uniform(0.05, 0.2, 60)
    _check(jsm.project_pixels, tsm.project_pixels,
           [s["pix"], w_cam, R, Q], [1, 2, 3], dtype)
    _check(jsm.project_pixels, tsm.project_pixels,
           [s["pix"], w_cam, R[0], Q[0]], [1, 2, 3], dtype)

    def jg(K, wl):
        a, b = jsm.gather_projected_depths(RES, K, wl)
        return jnp.stack([a, b], 1)

    def tg(K, wl):
        a, b = tsm.gather_projected_depths(RES, K, wl)
        return torch.stack([a, b], 1)

    K = np.stack([np.random.RandomState(5).uniform(-2, 10, 60),
                  np.random.RandomState(6).uniform(-2, 10, 60),
                  np.random.RandomState(7).normal(size=60)], 1)
    K[:4, :2] = [[7.0, 0.0], [0.999, 3.5], [-0.5, 8.5], [6.99, 6.01]]  # edges
    _check(jg, tg, [K, s["light_depth"]], [0, 1], dtype)


def test_projective_divide_guard_matches_jax():
    """wl exactly 0 (the carried-over finiteness case), within +-1e-8 of 0
    and beyond it, both signs: outputs and grads equal JAX's, all finite."""
    pixels = np.array([[0.5, 0.5, 1.0], [3.0, 2.0, 1.0], [1.5, 4.5, 1.0],
                       [2.5, 2.5, 1.0], [6.5, 1.5, 1.0]], np.float32)
    R = np.eye(3, dtype=np.float32)
    Q = np.array([0.0, 0.0, -1.0], np.float32)
    # wl = w_cam - 1: 0, -0.3, +4e-9, -5e-9, +2e-8
    w_cam = np.array([1.0, 0.7, 1.0 + 4e-9, 1.0 - 5e-9, 1.0 + 2e-8])
    light_depth = np.linspace(0.1, 1.0, 64)

    def jf(w, ld):
        K = jsm.project_pixels(jnp.asarray(pixels, w.dtype), w,
                               jnp.asarray(R, w.dtype), jnp.asarray(Q, w.dtype))
        wl, wlb = jsm.gather_projected_depths((8, 8), K, ld)
        return jsm.generate_shadow_map(wl, wlb, mode="shadow_method_2")

    def tf(w, ld):
        K = tsm.project_pixels(torch.from_numpy(pixels).to(w.dtype), w,
                               torch.from_numpy(R).to(w.dtype),
                               torch.from_numpy(Q).to(w.dtype))
        wl, wlb = tsm.gather_projected_depths((8, 8), K, ld)
        return tsm.generate_shadow_map(wl, wlb, mode="shadow_method_2")

    outs, grads = _both(jf, tf, [w_cam, light_depth], [0, 1], np.float64)
    _close(*outs, TOL[np.float64])
    for a, b in grads:
        assert np.isfinite(b).all()
        _close(a, b, TOL[np.float64])
    # the K rows themselves, past the guard (ul = u / 1e-8)
    _check(lambda w: jsm.project_pixels(jnp.asarray(pixels, w.dtype), w,
                                        jnp.asarray(R, w.dtype),
                                        jnp.asarray(Q, w.dtype)),
           lambda w: tsm.project_pixels(torch.from_numpy(pixels).to(w.dtype), w,
                                        torch.from_numpy(R).to(w.dtype),
                                        torch.from_numpy(Q).to(w.dtype)),
           [w_cam], [0], np.float64)
    # float32 at wl = 0 exactly (w_cam = 1.0): finite forward and grad
    w32 = torch.tensor([1.0, 0.7, 1.0, 2.0, 0.5], requires_grad=True)
    tf(w32, torch.from_numpy(light_depth.astype(np.float32))).sum().backward()
    assert torch.isfinite(w32.grad).all()


def _ties(n_poses, seed):
    """wl and w_light with diff tied at 0 (the segment minimum: empty rays
    are at depth 0 on both views), and ties at each segment's maximum; every
    value a multiple of 1/64, so the ties are exact in float32 too."""
    rng = np.random.RandomState(seed)
    n = 8 * n_poses
    pose_idx = np.repeat(np.arange(n_poses), 8).astype(np.int32)
    w_light = rng.randint(8, 64, n) / 64.0
    diff = rng.randint(1, 32, n) / 64.0
    for p in range(n_poses):
        diff[8 * p:8 * p + 3] = 0.0  # three rays tied at 0
        diff[8 * p + 5:8 * p + 7] = 0.75  # two tied at the max
    return diff + w_light, w_light, pose_idx


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["shadow_method_1", "shadow_method_2"])
def test_generate_shadow_map_with_ties(mode, dtype):
    for n_poses in (1, 3):
        wl, w_light, pose_idx = _ties(n_poses, 8)
        for kw in (dict(), dict(sigmoid=True)):
            if kw and mode == "shadow_method_1":
                continue
            _check(lambda a, b, i: jsm.generate_shadow_map(
                       a, b, mode=mode, pose_idx=i, num_poses=n_poses, **kw),
                   lambda a, b, i: tsm.generate_shadow_map(
                       a, b, mode=mode, pose_idx=i, num_poses=n_poses, **kw),
                   [wl, w_light, pose_idx], [0, 1], dtype)
    with pytest.raises(ValueError):
        tsm.generate_shadow_map(torch.zeros(2), torch.zeros(2), mode="x")


def test_segment_ties_need_an_infinite_start():
    """Control: a per-segment minimum that starts from 0 (the
    ``scatter_reduce`` default start) gives the start value a share of the
    gradient at ties at 0, so the rays' grads disagree with JAX's; the
    port's start from +inf agrees."""
    wl, w_light, pose_idx = _ties(3, 9)
    diff = wl - w_light
    idx = torch.from_numpy(pose_idx).long()
    with jax.enable_x64(True):
        ref = np.asarray(jax.grad(lambda d: jnp.sum(
            jax.ops.segment_min(d, jnp.asarray(pose_idx), num_segments=3)[
                jnp.asarray(pose_idx)] * jnp.arange(24.0)))(jnp.asarray(diff)))

    def grad(start_zero):
        d = torch.from_numpy(diff).requires_grad_(True)
        if start_zero:
            mn = torch.zeros(3, dtype=d.dtype).scatter_reduce(
                0, idx, d, "amin", include_self=False)
        else:
            mn = tsm._segment_extreme(d, idx, 3, "amin")
        (mn[idx] * torch.arange(24.0, dtype=d.dtype)).sum().backward()
        return d.grad.numpy()

    np.testing.assert_allclose(grad(False), ref, rtol=1e-12)
    assert not np.allclose(grad(True), ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("n_poses", [1, 4], ids=["one_pose", "multi_pose"])
def test_run_shadow_mapping_and_projections(n_poses, dtype):
    s = _scene(96, n_poses, 10 + n_poses)
    pd = np.concatenate([s["pix"], s["cam_depth"][:, None]], 1)
    pdl = np.concatenate([s["light_pix"], s["light_depth"][:, None]], 1)
    for mode, grad_at in (("shadow_method_1", [0, 1, 2, 3, 4, 5]),
                          # the light's eye shifts every wl alike, which
                          # method 2's min-max removes: its grad is rounding
                          ("shadow_method_2", [0, 1, 2, 4, 5])):
        _check(lambda *a: jsm.run_shadow_mapping(
                   RES, *a[:4], a[4], jsm.get_normed_w(a[2], a[5]), mode=mode,
                   pose_idx=a[6], num_poses=n_poses),
               lambda *a: tsm.run_shadow_mapping(
                   RES, *a[:4], a[4], tsm.get_normed_w(a[2], a[5]), mode=mode,
                   pose_idx=a[6], num_poses=n_poses),
               [s["cam_m"], s["cam_eye"], s["light_m"], s["light_eye"], pd, pdl,
                s["pose_idx"]], grad_at, dtype)
    _check(jsm.get_projections, tsm.get_projections,
           [s["cam_m"], s["cam_eye"], s["light_m"], s["light_eye"], pd],
           [0, 1, 2, 3, 4], dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("fine,light_fine", [(True, True), (True, False),
                                             (False, False)])
def test_efficient_sm(fine, light_fine, dtype):
    n_poses = 3
    s = _scene(120, n_poses, 20)
    s["cam_depth"][:5] = 0.0  # empty rays: depth 0 on both views
    s["light_depth"][:7] = 0.0

    def run(sm, xp, cd, cdf, ld, ldf, cam_m, cam_eye, light_m, light_eye, pix,
            lpix, pidx):
        cam = {"depth_coarse": cd, "depth_fine": cdf, "opacity_coarse": cd}
        light = {"depth_coarse": ld, "depth_fine": ldf}
        out = sm.efficient_sm(pix, lpix, cam, light, cam_m, cam_eye, light_m,
                              light_eye, RES, fine_sampling=fine,
                              light_has_fine=light_fine,
                              shadow_method="shadow_method_2", pose_idx=pidx,
                              num_poses=n_poses)
        assert out["opacity_coarse"] is cd
        keys = ["rgb_coarse"] + (["rgb_fine"] if fine else [])
        assert ("rgb_fine" in out) == fine
        return xp.concatenate([out[k] for k in keys], 1) if xp is jnp else \
            torch.cat([out[k] for k in keys], 1)

    _check(lambda *a: run(jsm, jnp, *a), lambda *a: run(tsm, torch, *a),
           [s["cam_depth"], s["cam_depth_f"], s["light_depth"], s["light_depth_f"],
            s["cam_m"], s["cam_eye"], s["light_m"], s["light_eye"], s["pix"],
            s["light_pix"], s["pose_idx"]], [0, 1, 2, 3], dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 3])
def test_shadow_mapping_images(batch, dtype):
    s = _scene(4, batch, 30)
    rng = np.random.RandomState(31)
    hw = RES[0] * RES[1]
    depths = [rng.uniform(2.5, 7.0, batch * hw) for _ in range(4)]
    depths[0][:9] = 0.0

    def run(sm, xp, cd, cdf, ld, ldf, cms, ceyes, lm, le):
        out = sm.shadow_mapping_images(
            {"depth_coarse": cd, "depth_fine": cdf},
            {"depth_coarse": ld, "depth_fine": ldf}, cms, ceyes, lm, le, RES,
            batch, fine_sampling=True)
        return (jnp.concatenate if xp is jnp else torch.cat)(
            [out["rgb_coarse"], out["rgb_fine"]], 1)

    _check(lambda *a: run(jsm, jnp, *a), lambda *a: run(tsm, torch, *a),
           depths + [s["cam_ms"], s["cam_eyes"], s["light_m"], s["light_eye"]],
           [0, 1, 2, 3], dtype)
