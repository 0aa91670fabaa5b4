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
"""
from __future__ import annotations

import functools
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402 - the checkout's root


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


def main() -> int:
    if not torch.cuda.is_available():
        print("light_sampler_census: CUDA is not available", file=sys.stderr)
        return 1
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
    cs.log("[light_sampler census] f32 step grads card vs cpu, largest "
           "difference relative to each tensor's largest magnitude: "
           + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
