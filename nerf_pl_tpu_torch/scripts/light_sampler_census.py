"""Where LightSampler's float32 step grads part between the card and the
CPU.

    python -m nerf_pl_tpu_torch.scripts.light_sampler_census

Run from the root of a checkout on a machine with a card: it reuses
``chip_smoke.py``'s helpers (``trainer_grads_card_vs_cpu``, its 16x16
shadow scene, phase 8's draws).  One ``LightSamplerSystem`` step of 256
camera and 256 light rays on the card and on the CPU, from the same seed
and injected draws, three ways: as trained (``efficient_sm_64.sh``'s flags,
what ``chip_smoke.py`` holds to ``TOL_STEP_GRADS``), without the batch-wide
min-max of the shadow map (``--shadow_method shadow_method_1``: a clip at
0), and coarse only (no fine samples, hence no CDF bins).  For each it
prints the grads' largest difference relative to each tensor's largest
magnitude, and the census of what could make the grads jump between the
devices: the light pixels the projection picks, the rays at the shadow
map's min and max, the sign of every raw sigma the renders' ReLU sees, the
fine samples' CDF bins, and the light-space depths' amplification of
rounding (|K_z| over the range of the depth difference).  Nothing is held:
it prints readings.

``cancellation`` measures what the sums over points lose in float32: the
same step in float64 on the CPU through posenc + NeRF, recording each
layer's inputs ``x`` and output cotangents ``g`` at every call, gives each
grad entry's per-point terms ``x_p g_p``; their sum ``S`` (the float64
grad) and the sum of their magnitudes ``T`` give the entry's cancellation
ratio ``T / |S|``.  A sum of n float32 terms is off by about
``eps * sqrt(n) * T`` (at most ``eps * n * T``), so an entry's relative
difference between two float32 orders is about ``eps * sqrt(n) * T / |S|``:
``cancellation`` holds the card's difference from the CPU, entry by entry,
against that estimate.  ``python -m ...light_sampler_census`` prints it
after the three readings; ``chip_smoke.py`` prints it on its LightSampler
line.
"""
from __future__ import annotations

import functools
import os
import sys
import tempfile

import numpy as np
import torch

cs = None  # chip_smoke, from the checkout's root (main imports it)


def light_sampler_run(s, ov, n: int) -> dict:
    """LightSampler's step on ``n`` rays, after the light pixels its
    projection picks (a floor: the card's and the CPU's can differ where a
    projection sits within rounding of a pixel's edge), the rays at the
    shadow map's min and max, and the census of ReLU signs and fine-sample
    bins of its renders."""
    from nerf_pl_tpu_torch.ops import rendering, sampling
    from nerf_pl_tpu_torch.ops.rendering import render_rays
    from nerf_pl_tpu_torch.ops.shadow_mapping import get_normed_w
    from nerf_pl_tpu_torch.training.shadow_systems import ls_project

    # the step's two renders again, recording each pass's raw sigmas
    # (the ReLU in compute_weights) and the fine samples' CDF bins (the
    # ranks kernel A returns): where the card and the CPU fall on
    # opposite sides of a ReLU zero or a bin edge, the grads jump
    seen = {}

    def record(tag, fn, key):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(tag, []).append(key(a, out))
            return out
        return wrapped

    cw, ss = rendering.compute_weights, sampling.searchsorted
    pidx = s.pose_idx[:n]
    models = (s.models["coarse"], s.models.get("fine"))
    try:
        rendering.compute_weights = record(
            "sigma > 0", cw, lambda a, out: (a[0] > 0).flatten())
        sampling.searchsorted = record(
            "fine sample bins", ss, lambda a, out: out.flatten())
        with torch.no_grad():
            cam = render_rays(*models, s.rays[:n], None,
                              overrides=ov["cam"], **s.rkw)
            fine = s.cfg.N_importance > 0
            K, ul, vl, lrays = ls_project(
                cam, s.pixels[:n], s.cam_ms[pidx], s.cam_eyes[pidx],
                s.light_m, s.light_eye, *s.light_geom, (16, 16), fine)
            light = render_rays(*models, lrays, None,
                                overrides=ov["light"], **s.rkw_light)
    finally:
        rendering.compute_weights, sampling.searchsorted = cw, ss
    depth = light["depth_fine" if s.light_n > 0 else "depth_coarse"]
    lpix = torch.stack([ul + 0.5, vl + 0.5, torch.ones_like(ul)], 1)
    diff = K[:, 2] - get_normed_w(
        s.light_m, torch.cat([lpix, depth[:, None]], 1))[:, 3]
    s.train_step(s.rays[:n], s.rgbs[:n], s.pixels[:n], pidx, overrides=ov)
    # the map is the depth difference K_z - w_light over its range: a
    # difference of two light-space depths, so their rounding is amplified
    # by |K_z| / (max - min of the difference)
    lo, hi = float(diff.min()), float(diff.max())
    kz = float(K[:, 2].abs().max())
    cs.log(f"[light_sampler census {s.device.type}] light-space depth |K_z| up "
        f"to {kz:.6g}, depth difference from {lo:.6g} to {hi:.6g}: "
        f"amplification {kz / max(hi - lo, 1e-30):.4g}")
    # the batch-wide min-max normalisation sends the shadow map's grad
    # through the rays at its least and largest depth difference
    return {"light pixels (ul, vl)": torch.stack([ul, vl]).cpu(),
            "depth difference K_z - w_light": diff.cpu(),
            "min-max rays (argmin, argmax)":
                torch.stack([diff.argmin(), diff.argmax()]).cpu(),
            **{f"{k} (camera and light passes)": torch.cat(v).cpu()
               for k, v in seen.items()}}


EPS32 = float(np.finfo(np.float32).eps)


def f64_terms(system, n: int, ov: dict) -> dict:
    """The LightSampler step's loss on ``n`` rays in float64 on the CPU
    (posenc + NeRF, the system's weights and ``ov``'s draws), backward;
    per grad entry (``"<model>/<param>"``): ``S`` the float64 grad, ``T`` the
    sum of its per-point terms' magnitudes, ``n`` the number of terms."""
    from nerf_pl_tpu_torch.models.nerf import Dense
    from nerf_pl_tpu_torch.ops.rendering import render_rays
    from nerf_pl_tpu_torch.training.shadow_systems import (ls_composite,
                                                           ls_project)

    s = system
    d64 = lambda t: t.detach().double()  # noqa: E731
    models = {k: m.double() for k, m in s.models.items()}
    acc = {}  # Dense -> [sum |x|^T |g|, sum |g|, points]

    def forward(self, x, compute_dtype=None):
        y = x.double() @ self.w + self.b
        if y.requires_grad:
            xa = x.detach().abs()

            def hook(g, self=self, xa=xa):
                ga = g.detach().abs().reshape(-1, g.shape[-1])
                a = acc.setdefault(self, [0.0, 0.0, 0])
                a[0] = a[0] + xa.reshape(-1, xa.shape[-1]).T @ ga
                a[1] = a[1] + ga.sum(0)
                a[2] += ga.shape[0]
            y.register_hook(hook)
        return y

    real = Dense.forward
    Dense.forward = forward
    try:
        rkw = dict(s.rkw, use_fused=False, compute_dtype=torch.float64)
        rkw_l = dict(s.rkw_light, use_fused=False, compute_dtype=torch.float64)
        ovd = {k: {kk: d64(v) for kk, v in o.items()} for k, o in ov.items()}
        pidx = s.pose_idx[:n]
        cam = render_rays(models["coarse"], models.get("fine"), d64(s.rays[:n]),
                          None, overrides=ovd["cam"], **rkw)
        l2w, focal, near, far = s.light_geom
        K, ul, vl, lrays = ls_project(
            cam, d64(s.pixels[:n]), d64(s.cam_ms[pidx]), d64(s.cam_eyes[pidx]),
            d64(s.light_m), d64(s.light_eye), d64(l2w), d64(focal), near, far,
            tuple(s.cfg.img_wh), s.cfg.N_importance > 0)
        light = render_rays(models["coarse"], models.get("fine"), lrays, None,
                            overrides=ovd["light"], **rkw_l)
        depth = light["depth_fine" if s.light_n > 0 else "depth_coarse"]
        sm = ls_composite(K, ul, vl, depth, d64(s.light_m), s.cfg.shadow_method)
        for m in models.values():
            m.zero_grad(set_to_none=True)
        torch.mean((sm - d64(s.rgbs[:n])) ** 2).backward()
    finally:
        Dense.forward = real
    out = {}
    for name, m in models.items():
        for mod_name, mod in m.named_modules():
            if not isinstance(mod, Dense):
                continue
            a = acc.get(mod)
            for leaf, p in (("w", mod.w), ("b", mod.b)):
                key = f"{name}/{mod_name}.{leaf}"
                S = (torch.zeros_like(p) if p.grad is None
                     else p.grad.detach().clone())
                if a is None:
                    out[key] = dict(S=S, T=torch.zeros_like(p), n=0)
                else:
                    out[key] = dict(S=S, T=a[0] if leaf == "w" else a[1],
                                    n=a[2])
    return out


def cancellation(card: dict, cpu: dict, terms: dict, share: float = 0.1) -> dict:
    """Entry by entry, the card's float32 grad against the CPU's, beside the
    cancellation ratio ``T / |S|`` and the float32 estimate ``eps sqrt(n)
    T / |S|`` of a sum's relative rounding.  The entries that carry the
    reading: those of the tensor with the largest reading (difference over
    the tensor's largest |grad|) whose difference is at least ``share`` of
    that tensor's largest.  Returns the readings and their quantiles."""
    worst, worst_key = -1.0, None
    for k, t in terms.items():
        ref = cpu[k].double()
        scale = float(ref.abs().max())
        if scale == 0:
            continue
        rel = float((card[k].double() - ref).abs().max()) / scale
        if rel > worst:
            worst, worst_key = rel, k
    k = worst_key
    t = terms[k]
    diff = (card[k].double() - cpu[k].double()).abs()
    S, T, n = t["S"].abs(), t["T"], max(t["n"], 1)
    carry = diff >= share * float(diff.max())
    ratio = (T / S.clamp_min(1e-300))[carry]
    est = EPS32 * np.sqrt(n) * ratio  # relative to |S|, per entry
    seen = (diff / S.clamp_min(1e-300))[carry]
    q = lambda v: {f"q{int(100 * p)}": float(torch.quantile(v, p))  # noqa: E731
                   for p in (0.5, 0.9, 1.0)}
    ratio_all = (T / S.clamp_min(1e-300)).flatten()
    return dict(tensor=k, reading=worst, points=n, entries=int(carry.sum()),
                carry_index=carry.nonzero().tolist(),
                ratio=q(ratio), ratio_all_entries=q(ratio_all),
                seen_rel=q(seen), estimate_rel=q(est),
                seen_over_estimate=q(seen / est.clamp_min(1e-300)),
                within_worst_case=bool((seen <= EPS32 * n * ratio).all()))


def recorded_step(system, n: int, ov: dict) -> tuple:
    """The LightSampler step on ``n`` rays with ``ov``'s draws, recording
    every fused forward's activation stash (its ReLU masks) and every
    backward's cotangent ``g`` at the MLP's outputs, in call order.
    Returns (the grads on the host by ``"<model>/<param>"``, the records)."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    recs = {"stash": [], "g": []}
    names = ("fused_nerf_stash_fwd_cuda", "fused_nerf_stash_fwd_plain",
             "fused_nerf_bwd_stash_cuda", "fused_nerf_bwd_plain")
    real = {k: getattr(fm, k) for k in names}

    def fwd(fn):
        def wrapped(model, x, *a, **k):
            out, stash = fn(model, x, *a, **k)
            recs["stash"].append((stash > 0).cpu())
            return out, stash
        return wrapped

    def bwd(fn):
        def wrapped(model, x, g, *a, **k):
            recs["g"].append(g.detach().double().cpu())
            return fn(model, x, g, *a, **k)
        return wrapped

    try:
        for k in names:
            wrapped = (fwd if "fwd" in k else bwd)(real[k])
            # a kernel's wrapper counts its launches (and the grids of its
            # body) on the name it is called by
            for count in ("launches", "grids"):
                if hasattr(real[k], count):
                    setattr(wrapped, count, getattr(real[k], count))
            setattr(fm, k, wrapped)
        s = system
        s.train_step(s.rays[:n], s.rgbs[:n], s.pixels[:n], s.pose_idx[:n],
                     overrides=ov)
    finally:
        for k, fn in real.items():
            for count in ("launches", "grids"):
                if hasattr(fn, count):
                    setattr(fn, count, getattr(getattr(fm, k), count))
            setattr(fm, k, fn)
    grads = {f"{name}/{k}": (p.grad if p.grad is not None
                             else torch.zeros_like(p)).detach().cpu()
             for name, m in s.models.items() for k, p in m.named_parameters()}
    return grads, recs


def compare_records(card: dict, cpu: dict) -> dict:
    """ReLU masks that differ between the card's and the CPU's forward
    passes (by pass and by trunk layer), and the cotangents' largest
    difference relative to each pass's largest |g|."""
    flips, units = [], {}
    for a, b in zip(card["stash"], cpu["stash"]):
        d = a != b
        cols = d.shape[1]
        flips.append([int(d[:, i * 256:(i + 1) * 256].sum())
                      for i in range(cols // 256)])
        for i in range(cols // 256):  # trunk layer i's units that flipped
            hit = d[:, i * 256:(i + 1) * 256].any(0).nonzero().flatten()
            units.setdefault(i, set()).update(hit.tolist())
    g_rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
             for a, b in zip(card["g"], cpu["g"])]
    return dict(mask_flips_by_pass=flips,
                flipped_units={i: sorted(u) for i, u in units.items()},
                mask_flips=sum(sum(f) for f in flips),
                masks=sum(int(a.numel()) for a in cpu["stash"]),
                g_rel_by_pass=g_rel)


def cancellation_census(tmp: str, step_draws, flags: list,
                        n: int = 256) -> dict:
    """chip_smoke's LightSampler card-vs-CPU step (``flags``, 16x16 scene
    under ``tmp/shadow_small``, phase 8's draws from ``step_draws``): the
    grads on both devices with their ReLU masks and cotangents, the float64
    terms on the CPU, and ``cancellation``'s readings."""
    from nerf_pl_tpu_torch.config import get_opts
    from nerf_pl_tpu_torch.training.shadow_systems import LightSamplerSystem

    gen = torch.Generator().manual_seed(8)
    S = 64
    for n_importance in (S, 32, S, S):  # the draws phase 8 takes before
        step_draws(gen, n, n_importance)
    draws = {"cam": step_draws(gen, n, S), "light": step_draws(gen, n, 32)}

    def build(device, tag):
        cfg = get_opts(["--root_dir", os.path.join(tmp, "shadow_small"),
                        *flags, "--batch_size", str(n), "--img_wh", "16",
                        "16", "--exp_name", f"census_{tag}",
                        "--log_dir", os.path.join(tmp, "logs"),
                        "--ckpt_dir", os.path.join(tmp, "ckpts")])
        return LightSamplerSystem(cfg, device=device)

    grads, recs = {}, {}
    for device in ("cuda", "cpu"):
        system = build(device, device)
        grads[device], recs[device] = recorded_step(
            system, n, {k: {kk: v.to(device) for kk, v in d.items()}
                        for k, d in draws.items()})
        system.logger.close()
    system = build("cpu", "f64")
    terms = f64_terms(system, n, draws)
    system.logger.close()
    out = dict(cancellation(grads["cuda"], grads["cpu"], terms),
               **compare_records(recs["cuda"], recs["cpu"]))
    # a trunk weight's entry [i, u] sums in_i * g_u over the points where
    # unit u of that layer is on: a mask that differs at (p, u) adds or
    # drops a whole term of column u
    name = out["tensor"].split("/")[-1]
    if name.startswith("xyz_layers.") and name.endswith(".w"):
        layer = int(name.split(".")[1])
        flipped = set(out["flipped_units"].get(layer, ()))
        out["carry_in_flipped_units"] = sum(
            idx[-1] in flipped for idx in out["carry_index"])
    out.pop("flipped_units")
    return out


def main() -> int:
    global cs
    if not torch.cuda.is_available():
        print("light_sampler_census: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from nerf_pl_tpu_torch.data.synthetic import generate_scene

    cs.setup()
    n, S, L = 256, cs.SHADOW_SAMPLES, cs.SHADOW_LIGHT_N
    with tempfile.TemporaryDirectory() as tmp:
        generate_scene(os.path.join(tmp, "shadow_small"), img_wh=16,
                       n_train=2, n_val=1, n_test=0)
        # phase 8's draws: the same generator, after the RGBSM and
        # ShadowMapping steps' draws
        gen = torch.Generator().manual_seed(8)
        for n_importance in (S, L, S, S):
            cs.step_draws(gen, n, n_importance)
        draws = {"cam": cs.step_draws(gen, n, S),
                 "light": cs.step_draws(gen, n, L)}
        readings = {tag: cs.trainer_grads_card_vs_cpu(
            tmp, f"light_sampler {tag}", "LightSamplerSystem",
            cs.LS_FLAGS + ["--batch_size", str(n), *extra], draws,
            functools.partial(light_sampler_run, n=n),
            tol=(np.inf, np.inf))
            for tag, extra in (
                ("as trained", []),
                ("shadow_method_1", ["--shadow_method", "shadow_method_1"]),
                ("coarse only", ["--N_importance", "0",
                                 "--Light_N_importance", "0"]))}
        census = cancellation_census(tmp, cs.step_draws, cs.LS_FLAGS, n)
    cs.log("[light_sampler census] f32 step grads card vs cpu, largest "
           "difference relative to each tensor's largest magnitude: "
           + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
    cs.log(f"[light_sampler census] cancellation: {census}")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
