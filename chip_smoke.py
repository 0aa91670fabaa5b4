"""Drive the PyTorch/CUDA port (``nerf_pl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. Set-up: require CUDA, print the card's name and power limit, build every
   kernel of ``nerf_pl_tpu_torch/csrc`` with nvcc (one process per source,
   all started together).
2. Each kernel against its plain PyTorch version on the card, at the
   render server's shapes (a 32,000-ray chunk: 64 coarse points and 192
   fine points per ray, 63 CDF entries and 128 draws per ray): max abs
   error against a stated tolerance, kernel time, plain time, the bound
   (the least time the card could take for the same work) and, where one
   PyTorch call computes the same function, that call's time.  Kernels A
   and B (both bisections) bit for bit against their plain versions (A
   also against ``torch.searchsorted``, both sides) at B = 32,000 and at
   the training step's B = 4,096: on CDF rows with plateaus, and B also on
   the serve path's rows and ``linspace`` draws; A timed in turns with
   ``torch.searchsorted`` (library, kernel, kernel, library), B with its
   plain version, both also by device time alone.
3. The render server end to end at full width: a seeded checkpoint, then
   ``build_server`` at 200x200, 64+128 samples, ``--max_batch 4``; 4
   concurrent POSTs and 1 GET over HTTP.  The kernels' launch counters are
   zeroed just before the requests and read just after; one 4-view batch
   is then profiled (device time by kernel, idle share).  Then the random
   sampler path (``render_rays`` with ``perturb=1``), which runs kernel A.
   Last, 256 rays of one view rendered in float32 on the card and on the
   CPU, compared.
4. The training step: kernels D (stash forward), E (stash backward) and F
   (remat backward) against their plain versions in bf16 and f32, rgb and
   sigma-only, at a P that spans two of the backward's point chunks, the
   second ragged, and E against F; E run twice on the same inputs, bit
   for bit (the backward is deterministic); a control that the bf16
   limits must fail, and controls of D's forward hold (``FORWARD_CONTROLS``)
   that TOL_C must fail; the sigma head's weight grad of each route against
   its float64 sum, and each kernel's worst bf16 mean reading with its
   tensor; their times at the training shapes (4,096 rays x 192 and x 64
   points, bf16) beside the plain versions, the bounds and a chain of bf16
   ``torch.matmul`` calls as a yardstick, and at those shapes the same
   checks against the plain versions.  The row-major twins C', D', E' and
   F' (the ``--fused_channel_io false`` path) run beside each of these on
   the same points: against the plain versions, bit for bit against C, D,
   E and F, and timed; C' and C also at one eval chunk in float32.  Then
   ``python -m nerf_pl_tpu_torch.train`` at full width in bf16 for 2 epochs
   on a scene this script writes (8 views of 100x100, batch 4,096, 64+128
   samples): losses finite and falling, launch counts of A, C, D and E in
   the fit (zeroed just before it, read just after) and per step; the
   step's index fetch and ``Adam.step`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (no call that makes the host
   wait), and the synchronising calls of one whole step counted under
   ``"warn"``; one step under the profiler; F through
   ``stash_blocks=None``.
5. Evaluation: ``python -m nerf_pl_tpu_torch.eval`` on the fit's checkpoint,
   the scene's two 800x800 test views at 400x400 (the LANCZOS resize),
   64+128 samples, once with ``--fused_channel_io false`` (C' and B launch,
   C does not) and once with ``true`` (C, not C'); the renders agree, the
   PNGs, PFM depth maps and GIF read back; PSNR, s per view, rays/s.  Then
   a 1-epoch fit with ``--fused_channel_io false`` (D' and E' every step,
   C' in validation; its epoch-0 loss against the channel-major fit's) and
   F' through ``fused_nerf_apply_raw(..., stash_blocks=None)``.  Last, one
   float32 step's grads on the card against the CPU, 5 card steps of
   ``Adam.step`` bit for bit against the step as it was before its scalars
   moved in one non-blocking copy, and ``nerf_pl_tpu_torch.bench``'s
   number.
6. The wide path and the probe: kernel G (the fused MLP on pre-embedded
   rows) against its plain version at every width it is built for (bf16 at
   W = 128-640, f32 at 128-384), rgb and sigma-only, at a ragged P; kernel I
   (the probe's chain, on wgmma fed by TMA: its SASS must hold HGMMA and
   UTMALDG) against its plain version at 786,432 rows and two ragged P,
   its time in turns with cuBLAS's; kernel H (G's backward with dx) against its plain
   version at W = 256 over two backward chunks, dx and every grad per
   tensor, its time beside F, and ``fused_nerf_apply``'s autograd route
   (G and H launched once each); G's time at W = 512 beside its bound, the
   plain version, posenc + ``NeRF.forward`` and the bf16 matmul chain;
   ``render_image`` of one 200x200 view of a W = 512 checkpoint through G
   (``fused_wide_infer=True``: 2 launches a chunk) and through posenc + NeRF
   (no G), compared, and 256 rays of a W = 384 checkpoint in float32 on the
   card against the CPU; last, ``python -m
   nerf_pl_tpu_torch.scripts.kernel_probe`` as a subprocess.
7. The flagship shadow trainer: ``python -m
   nerf_pl_tpu_torch.train_efficient_sm`` at ``launchers/efficient_sm_64.sh``'s
   flags (full width, sigma-only, 64+64 samples, batch 1,024,
   ``--grad_on_light``, Light_N 32, float32) on a synthetic shadow scene this
   script writes (20 train views of 64x64: 80 steps an epoch; 1 val view)
   for 2 epochs, then 1 epoch in bf16 and 2 epochs through the no-grad
   light cache (``--sample_light_depth_every 4`` at lr 5e-4: kernel C, the
   loss must fall); losses finite, camera rays/s per epoch, launches in each
   fit and in one step (D 4, E 4, A 2 with ``--grad_on_light``), one step's
   synchronising calls and profile, and one float32 step's grads on the card
   against the CPU (``TOL_STEP_GRADS``) on a 16x16 scene.
8. The other shadow trainers on phase 7's scene, at full width, float32
   unless named: ``train_rgb_sm_juntos`` at ``launchers/recipes.sh``'s
   ``rgb_sm_sigma_64`` (batch 4,096, ``--grad_on_light``, Light_N 32) for 2
   epochs and 1 in bf16, and at ``launchers/rgb_sm_joint.sh``'s flags cut
   to 64x64 for 2 epochs through the light cache (kernel C; the loss must
   fall); ``train_shadow_mapping`` (one whole image a step),
   ``train_light_sampler`` and ``train_shadows`` for 2 epochs each;
   ``train_efficient_sm`` for 1 epoch on a 64x64 ``pyredner2`` scene this
   script writes.  Losses finite, camera rays/s per epoch, launches in each
   fit; for one step of each new system its launches (exact:
   ``TRAINER_STEP_LAUNCHES``), synchronising calls, profile with f32 D and
   E beside their bounds, and one float32 step's grads on the card against
   the CPU (``TOL_STEP_GRADS``) on phase 7's 16x16 scene.
9. LLFF: ``python -m nerf_pl_tpu_torch.train --dataset_name llff`` at
   ``launchers/llff_fern.sh``'s flags (full width, f32, 64 + 64 samples,
   batch 1,024, adam, steplr 10 20 x 0.5) for 1 epoch (558 steps) on a
   forward-facing synthetic scene this script writes at the recipe's
   504x378 (3 train views and the closest-to-centre val): NDC rays, losses
   finite, train rays/s, launches in the fit and in one step (exact: D 2,
   E 2, A 1), the batch fetch and the optimizer step under
   ``set_sync_debug_mode("error")``, one step profiled with f32 D and E
   beside their bounds; ``python -m nerf_pl_tpu_torch.eval --dataset_name
   llff`` on its checkpoint, ``--split test_train`` at 504x378 (PSNR of the
   written PNGs against the scene's images) and ``--split test`` at
   168x126 (the 120-pose spiral, a 120-frame GIF), through C and B; one
   f32 step's grads card vs CPU; a 2-epoch ``--spheric_poses`` fit on a
   ring scene with ranger, poly and ``--profile`` (its trace must name D
   and E), then ``--debug_nans`` stopping a NaN fit; sgd, adamw, radam,
   ranger, and cosine and poly behind a warm-up, on the card against the
   same steps on the CPU, each card step under the sync debug mode; an
   embedded JPEG decoded to Pillow's hash and loaded as an LLFF val image;
   the PNG reader's host time on an 800x800 RGBA image.
10. The tools: ``python -m nerf_pl_tpu_torch.extract_color_mesh`` (its
   ``main``, in this process, so the launch counters can be read) at its
   defaults on phase 4's full-width fit, cut to a smooth scene whose 256^3
   surface keeps at least 10^5 vertices (``dense_checkpoint``), and phase
   4's scene: a 256^3 grid (exactly ceil(256^3 / 32768) = 512 C' launches,
   float32 sigma-only) and the colour fusion over the 8 views (C' once a
   view per chunk of vertices, B never), wall seconds by stage, grid
   points/s; ``keep_largest_cluster`` timed on the host at ~10^6 vertices;
   then ``--use_vertex_normal --N_importance 64`` at 128^3 (C' and B a
   chunk) and ``--vol_path --vol_only``; the tool on the card against the CPU at
   48^3 on 2 views (sigma grids, values crossing the threshold, triangles,
   vertices, colours); a Lightning checkpoint of the reference's layout
   through ``python -m nerf_pl_tpu_torch.import_torch_ckpt --full_state``,
   a 1-epoch resume of ``python -m nerf_pl_tpu_torch.train`` from it and
   ``--export --full_state`` loaded into a fresh ``torch.optim.Adam`` (the
   moments bit for bit).  The ReLU repair: C, C', D (stash too), G and I
   with a NaN bias or NaN points, and E, F and H with an Inf cotangent,
   against their plain versions (NaN and Inf positions equal).  adamw's
   update replayed op by op on the card and the CPU (the first op that
   gives other bits).  Every fit of phases 4 and 7-10 leaves each
   checkpoint it lists on disk and loading when ``fit`` returns (the
   trainers' background writer); D's bf16 stash is held to 0 differing
   values (phase 4).
11. Distribution and streaming (see its block comment).
12. The image readers: phase 9's LLFF scene as progressive JPEGs (view 1
   arithmetic-coded) and as baseline JPEGs of the same coefficients, phase
   4's Blender scene as 16-bit RGBA PNGs with one palette + tRNS Adam7
   view, phase 7's shadow scene with palette shadow maps, each written with
   ``tests/image_writers.py`` (this machine has no PIL) and its loads held
   bit for bit against the baseline files'; then ``python -m
   nerf_pl_tpu_torch.train`` at phase 9's flags for 1 epoch and the
   ``test_train`` eval, at phase 4's flags for 1 epoch, and ``python -m
   nerf_pl_tpu_torch.train_efficient_sm --grad_on_light`` for 1 epoch on
   them, with the launches of each fit and of one step (exact: D 2 / E 2 /
   A 1 for LLFF and Blender, D 4 / E 4 / A 2 for efficient_sm); last, a
   4032x3024 q95 4:2:0 baseline and progressive JPEG decoded on the host
   (the whole decode, its stages, the plain Python entropy loop).
13. The other containers: phase 9's LLFF scene as lossy WebP views (the
   fixtures of ``tests/data/webp/``, encoded by Pillow from the same
   synthetic scene, each decode held to the SHA-256 of Pillow's decode
   recorded beside them), phase 4's Blender scene as 16-bit RGBA TIFFs
   (LZW + predictor 2, train view 0 tiled; each value ``v * 257``), phase
   7's shadow scene with its maps as BMP, PPM and GIF under their
   ``sm_*.png`` names; the lossless loads held bit for bit against the
   PNG scenes'; the same three fits as phase 12, each with one step's
   exact launches, the LLFF ``test_train`` eval, and the ``efficient_sm``
   epoch-0 loss equal to phase 7's; last, a 4032x3024 lossless WebP and an
   LZW TIFF decoded on the host by stage, and the lossy VP8 decode rate.
14. The repo's other entry points, each through its port: the scene CLI
   (``scripts.make_synthetic_scene``, three formats); ``python -m
   nerf_pl_tpu_torch.examples.orbit_render`` (its ``main``) on phase 4's
   fit, 24 rgb poses and 8 sigma poses at 200x200, exactly 4 C and 2 B
   launches a pose, its PNGs and GIF read back, pose 0 of it and of the
   serve phase's seeded checkpoint held against the plain versions of C and
   B on the card; ``scripts.validate_mesh`` on an
   analytic sphere (PASS, 0) and a scaled one (FAIL, 1);
   ``examples.inspect_shadow_scene`` on phase 7's scene (consistent);
   ``scripts.profile_step`` (10 traced bench steps; its table must name D,
   E and A); ``scripts.width_bench`` at W = 256 and 512 (5 steps each, no
   error row); ``scripts.bench_searchsorted`` (four rank sets equal, then
   timed); ``scripts.sustained_rate`` on phase 4's ``metrics.jsonl``; the
   ``efficient_sm_64.sh`` launcher and ``recipes.sh rgb_sm_sigma_64`` for 1
   epoch on phase 7's scene; ``scripts/acceptance_real_data.sh`` with
   ``SMOKE=1``.
15. One JSON line of kernel numbers (E's and F's rows carry the SHA-256 of
   their f32 grads at a fixed seeded input, run twice, ``f32_sha256``), the
   card's line, then the result line ``{"ok": true, "device": {...}}``
   last.

Peak rates used for the bounds (NVIDIA H100 SXM data sheet, dense): 989
TFLOP/s bf16 tensor, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s device memory.
"""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# serving shapes: 4 views of 200x200 = 160,000 rays in chunks of 32,000
CHUNK_RAYS = 32_000
N_SAMPLES, N_IMPORTANCE = 64, 128
# multiply-adds per point of the reference NeRF (8x256, skip at 4, heads)
MACS_RGB, MACS_SIGMA = 593_408, 491_264
# the training step (bench.py): 4,096 rays, 64 coarse + 128 fine samples
TRAIN_BATCH = 4096

# Kernel C against its plain version, outputs of order 1.  f32: only the
# order of the f32 sums differs.  bf16: a different sum order can round a
# layer's input to the neighbouring bf16 value (2^-8 relative), which moves
# an output by up to ~4e-3 (seen on the CPU against a float64 sum); the
# tolerance allows a few such flips on one point, the mean catches a
# systematic fault.
TOL_C = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_C_MEAN = 1e-3
# The float32 render on the card against the CPU: the rays are built on
# each device, so they differ in the last bit, and the 2^9-frequency
# encoding with the scaled sigma head amplifies that.  Moving the camera by
# one ulp moves the CPU render by up to 4e-3 with this checkpoint (measured
# on the CPU), so 1e-2 passes rounding and fails a wrong channel, weight or
# sample.
TOL_F32_RENDER = 1e-2
TOL_F32_RENDER_MEAN = 1e-3
# Kernels D, E and F against their plain versions, per tensor, relative to
# the tensor's largest magnitude (max and mean of |kernel - plain|).  f32:
# sums in another order only; an H100 (80GB HBM3, 700 W) read at most
# 5.2e-6 (max) and 1.0e-6 (mean).  bf16: a different sum order can round a
# layer's g_pre to the neighbouring bf16 and the backward carries that down
# the layers; the weight grads are themselves rounded to bf16, where one
# flip at a tensor's largest value moves it by at most 2^-7 = 7.8e-3.  The
# same H100 read at most 2.7e-3 (max) and 1.0e-6 (mean) at the shapes held
# here.  The control (``check_control``: the backward in f32 where bf16 is
# stated, as a kernel that skipped the bf16 rounding would compute) read a
# worst mean of 1.6e-3 to 2.2e-3 and failed the limits in 17 to 22 of the
# 24 tensors; the mean limit sits 20x above the sound reading.
TOL_TRAIN = {torch.bfloat16: (1e-2, 2e-5), torch.float32: (1e-4, 1e-5)}
# E against F: the stash and F's recompute come from the same forward code,
# so the two should agree to the last bit; JAX's own test of the stash
# against the remat backward (tests/test_fused_mlp.py:209) allows rtol 1e-5
# and atol 1e-6, which is kept here relative to each tensor.
TOL_E_VS_F = 1e-5
# Kernel D's stash against the plain version's, bf16 and float32: the bf16
# tile's tie repair recomputes every output near a rounding tie in the plain
# version's order, and in float32 the scalar loop's FMA order is the plain
# version's, so the two are bit-equal (an H100 80GB HBM3 at 700 W read 0
# differing values in both); the count of values that differ is
# held to 0, and every forward control's stash (FORWARD_CONTROLS and the
# plain forward in float32) must exceed it.
TOL_STASH_DIFF = 0
# The eval's float32 renders through C' and through C.  The kernels are held
# bit-equal above, but the renderer reads their outputs as views of another
# memory order ((8, P) rows permuted, or (P, 8) rows strided), and PyTorch's
# reductions over the samples then add in another order: the renders agree
# to float32 rounding, not to the bit.  1e-5 on values of order 1 (depth in
# scene units: 1e-5 relative to the far bound); the 8-bit PNGs may differ by
# one level where a value sits on a level's edge.
TOL_EVAL_LAYOUTS = 1e-5
# The row-major fit's epoch-0 loss against the channel-major fit's: the same
# seed, data and bit-equal kernels, but the sums above run in another order,
# and 19 bf16 steps carry a rounding difference on (a weight near a bf16
# rounding edge is rounded the other way when the kernels pack it).  The CPU
# test of the same comparison over 6 steps
# (test_cli_trains_with_row_major_fused_io) reads 1.4e-5.
TOL_FIT_LAYOUTS = 1e-3  # relative


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of the kernels ``fn()`` launches, from
    ``torch.profiler`` over ``iters`` runs: the launches' own time, without
    the host's gaps between them (which CUDA events over back-to-back calls
    include when the host is the slower side)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, op_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def setup():
    from nerf_pl_tpu_torch.ops import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = native.build()
    log(f"[build] {sorted(seconds)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, one process per source)")
    for name in seconds:
        report = native.library_path(name).with_suffix(".so.log")
        if not report.exists():
            continue
        entry, spill = "?", ""
        for line in report.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                # drop the mangled namespace: the kernel's name and template
                # arguments are what tell the entries apart
                starts = [entry.find(k) for k in ("fused_nerf", "rank",
                                                  "reduce", "chain_kernel")
                          if k in entry]
                entry = entry[min(starts):] if starts else entry
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = line.split(":", 1)[-1].strip()
                log(f"[ptxas {name}] {entry[:70]}: {regs}; {spill}")
                spill = ""


# ---------------------------------------------------------------- phase 2
def random_raw_t(gen, P: int, device) -> torch.Tensor:
    """(8, P) rows [xyz | unit dir | 0 0], xyz in the [-1.5, 1.5] cube."""
    x = torch.zeros((8, P), dtype=torch.float32)
    x[:3] = torch.rand((3, P), generator=gen) * 3.0 - 1.5
    d = torch.randn((3, P), generator=gen)
    x[3:6] = d / d.norm(dim=0, keepdim=True)
    return x.to(device)


def check_fused_mlp(model, gen, dev) -> dict:
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    P = (1 << 18) + 77  # ragged tail: not a multiple of the 64-point tile
    x = random_raw_t(gen, P, dev)
    xr = x.T.contiguous()  # the same points, row-major
    worst = worst_rm = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for sigma_only in (True, False):
            out = fm.fused_nerf_apply_raw_t_cuda(model, x, sigma_only, dtype)
            ref = fm.fused_nerf_apply_raw_t_plain(model, x, sigma_only, dtype)
            out_rm = fm.fused_nerf_apply_raw_cuda(model, xr, sigma_only, dtype)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            mode = "sigma-only" if sigma_only else "rgb"
            for kernel, got, want in (("C", out, ref), ("C'", out_rm, ref.T)):
                err = max_abs(got, want)
                rel = err / max(float(want.abs().max()), 1e-30)
                mean = float((got - want).abs().mean())
                log(f"[{kernel} {name} {mode}] P={P} max_abs_err={err:.3e} "
                    f"rel={rel:.3e} mean_abs_err={mean:.3e} "
                    f"tol={TOL_C[dtype]:.0e} (mean tol {TOL_C_MEAN:.0e})")
                if (not torch.isfinite(got).all() or not err <= TOL_C[dtype]
                        or not mean <= TOL_C_MEAN):
                    raise AssertionError(f"kernel {kernel} {name} {mode} "
                                         f"disagrees with its plain version")
                if dtype == torch.bfloat16 and kernel == "C":
                    worst = max(worst, err)
                elif dtype == torch.bfloat16:
                    worst_rm = max(worst_rm, err)
            require_twins(f"C' vs C {name} {mode}", [out_rm], [out.T])

    rows = {}
    for sigma_only, S, macs in ((True, N_SAMPLES, MACS_SIGMA),
                                (False, N_SAMPLES + N_IMPORTANCE, MACS_RGB)):
        Pc = CHUNK_RAYS * S
        xc = random_raw_t(gen, Pc, dev)
        ms = cuda_ms(lambda: fm.fused_nerf_apply_raw_t_cuda(
            model, xc, sigma_only, torch.bfloat16), iters=3)
        plain_ms = cuda_ms(lambda: fm.fused_nerf_apply_raw_t_plain(
            model, xc, sigma_only, torch.bfloat16), iters=2)
        b, by = bound_ms(Pc * 64, 2 * macs * Pc, BF16_TENSOR_FLOPS)
        sin_ms = Pc * (63 - 3 + (0 if sigma_only else 24)) / F32_FLOPS * 1e3
        mode = "sigma-only" if sigma_only else "rgb"
        del xc
        torch.cuda.empty_cache()
        chain_ms = None
        if not sigma_only:  # the chain computes the rgb heads
            chain_ms, _ = matmul_chain_ms(model, Pc, dev, backward=False)
            torch.cuda.empty_cache()
        log(f"[C time bf16 {mode}] P={Pc} kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b:.3f} ms ({by}); sinf/cosf "
            f">= {sin_ms:.3f} ms at one op each on the f32 units"
            + ("" if chain_ms is None else
               f"; bf16 matmul chain forward {chain_ms:.3f} ms"))
        rows[mode] = dict(P=Pc, ms=ms, plain_ms=plain_ms, bound_ms=b,
                          bound_by=by, matmul_chain_fwd_ms=chain_ms)
    return dict(err=worst, err_rm=worst_rm, rows=rows)


def plateau_cdf(gen, B: int, M: int) -> torch.Tensor:
    """(B, M) CDF rows as ``sample_pdf`` builds them (weights + 1e-5,
    normalised, a cumulative sum after a zero), from weights where a heavy
    bin (1e3) stands before a near-empty one (1e-30): past the heavy bins
    the small increments vanish in the float sum, so the rows hold exact
    plateaus (ties), as trained scenes' CDFs do."""
    w = torch.rand((B, M - 1), generator=gen)
    w[:, ::4] = 1e3
    w[:, 1::4] = 1e-30
    w = w + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    return torch.cat([torch.zeros((B, 1)), cdf], -1).contiguous()


def check_rank(gen, dev, B: int) -> dict:
    """Kernel A on plateau rows (M = 63, K = 128) against its plain version
    and ``torch.searchsorted``, both sides, bit for bit; draws at 0, at 1
    and on row entries; then A and ``torch.searchsorted`` timed in turns."""
    from nerf_pl_tpu_torch.ops import searchsorted as ss

    M, K = N_SAMPLES - 1, N_IMPORTANCE
    cdf = plateau_cdf(gen, B, M)
    u = torch.rand((B, K), generator=gen)
    u[:, 0] = 0.0  # ties with row[0]
    u[:, -1] = 1.0  # at / past the row's end
    cols = torch.randint(0, M, (B, K // 4), generator=gen)
    u[:, 1:1 + K // 4] = torch.gather(cdf, 1, cols)  # exact ties, plateaus
    plateaus = int((cdf[:, 1:] == cdf[:, :-1]).sum())
    cdf, u = cdf.to(dev), u.contiguous().to(dev)
    for side in ("right", "left"):
        a = ss.searchsorted_cuda(cdf, u, side)
        ap = ss.searchsorted_plain(cdf, u, side)
        lib = torch.searchsorted(cdf, u, right=(side == "right"))
        torch.cuda.synchronize()
        same = torch.equal(a, ap) and torch.equal(a.long(), lib)
        log(f"[A {side} B={B}] M={M} K={K}, {plateaus} plateau steps in the "
            f"rows: bit-equal to its plain version and torch.searchsorted: "
            f"{same} (tol 0)")
        if not same:
            raise AssertionError(f"kernel A ({side}, B={B}) disagrees")
    # in turns: library, kernel, kernel, library
    lib1 = cuda_ms(lambda: torch.searchsorted(cdf, u, right=True), iters=20)
    k1 = cuda_ms(lambda: ss.searchsorted_cuda(cdf, u), iters=20)
    k2 = cuda_ms(lambda: ss.searchsorted_cuda(cdf, u), iters=20)
    lib2 = cuda_ms(lambda: torch.searchsorted(cdf, u, right=True), iters=20)
    plain = cuda_ms(lambda: ss.searchsorted_plain(cdf, u), iters=5)
    # the launches' device time alone (the profiler), library then kernel
    lib_dev = device_ms(lambda: torch.searchsorted(cdf, u, right=True), 20)
    k_dev = device_ms(lambda: ss.searchsorted_cuda(cdf, u), 20)
    steps = M.bit_length()  # ceil(log2(M + 1)) halving steps a query
    bound, by = bound_ms(4 * B * M + 4 * B * K + 4 * B * K,
                         2 * B * K * steps, F32_FLOPS)
    log(f"[A time B={B}] CUDA events over back-to-back calls: "
        f"torch.searchsorted {lib1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, "
        f"torch.searchsorted {lib2:.4f} ms; device time alone (profiler): "
        f"kernel {k_dev:.4f}, torch.searchsorted {lib_dev:.4f} ms; plain "
        f"{plain:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(err=0.0, ms=(k1 + k2) / 2, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=(lib1 + lib2) / 2,
                turns=[lib1, k1, k2, lib2], device_ms=k_dev,
                library_device_ms=lib_dev, plateau_steps=plateaus)


def check_interp(gen, dev, B: int) -> dict:
    """Kernel B (the bisection and two reads of the row) bit for bit
    against its plain version (the masked max and min) on plateau rows
    with draws at 0, at 1 and on row entries, and on the serve path's rows
    (``sample_pdf``'s CDF of positive weights) with its ``linspace`` draws;
    then B timed in turns with the plain version, and its device time."""
    from nerf_pl_tpu_torch.ops import searchsorted as ss

    M, K = N_SAMPLES - 1, N_IMPORTANCE
    plateau = plateau_cdf(gen, B, M)
    u = torch.rand((B, K), generator=gen)
    u[:, 0] = 0.0  # ties with row[0]
    u[:, -1] = 1.0  # at / past the row's end
    cols = torch.randint(0, M, (B, K // 4), generator=gen)
    u[:, 1:1 + K // 4] = torch.gather(plateau, 1, cols)  # exact ties
    w = torch.rand((B, M - 1), generator=gen) + 1e-5
    serve = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    serve = torch.cat([torch.zeros((B, 1)), serve], -1).contiguous()
    lin = torch.linspace(0.0, 1.0, K).expand(B, K).contiguous()
    for kind, cdf, vals in (("plateau", plateau, u), ("serve", serve, lin)):
        cdf, vals = cdf.to(dev), vals.contiguous().to(dev)
        r, lo, hi = ss.searchsorted_interp_cuda(cdf, vals)
        rp, lop, hip = ss.searchsorted_interp_plain(cdf, vals)
        torch.cuda.synchronize()
        same = (torch.equal(r, rp) and torch.equal(lo, lop)
                and torch.equal(hi, hip))
        log(f"[B {kind} B={B}] M={M} K={K}: ranks, lo and hi bit-equal to "
            f"the plain version: {same} (tol 0: compares and reads only)")
        if not same:
            raise AssertionError(f"kernel B ({kind}, B={B}) disagrees with "
                                 "its plain version")
    # the serve rows, timed: plain, kernel, kernel, plain
    p1 = cuda_ms(lambda: ss.searchsorted_interp_plain(cdf, vals), iters=5)
    k1 = cuda_ms(lambda: ss.searchsorted_interp_cuda(cdf, vals), iters=20)
    k2 = cuda_ms(lambda: ss.searchsorted_interp_cuda(cdf, vals), iters=20)
    p2 = cuda_ms(lambda: ss.searchsorted_interp_plain(cdf, vals), iters=5)
    k_dev = device_ms(lambda: ss.searchsorted_interp_cuda(cdf, vals), 20)
    steps = M.bit_length()  # ceil(log2(M + 1)) halving steps a query
    # bytes: the rows and draws read once, ranks, lo and hi written once
    bound, by = bound_ms(4 * B * M + 4 * B * K + 12 * B * K,
                         2 * B * K * steps, F32_FLOPS)
    log(f"[B time B={B}] CUDA events over back-to-back calls: plain "
        f"{p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, plain {p2:.4f} ms; "
        f"device time alone (profiler) {k_dev:.4f} ms; bound {bound:.4f} "
        f"ms ({by})")
    return dict(err=0.0, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                bound_ms=bound, bound_by=by, turns=[p1, k1, k2, p2],
                device_ms=k_dev)


def check_searchsorted(gen, dev) -> dict:
    return dict(B=check_interp(gen, dev, CHUNK_RAYS),
                B_train=check_interp(gen, dev, TRAIN_BATCH),
                A=check_rank(gen, dev, CHUNK_RAYS),
                A_train=check_rank(gen, dev, TRAIN_BATCH))


def rel_errs(out, ref, rows: int = 1 << 16) -> tuple:
    """(max, mean) of |out - ref| over max |ref|, in float64 blocks of
    ``rows`` rows (a training-shape stash is 1.9e9 values)."""
    mx = tot = scale = 0.0
    for a, b in zip(out.split(rows), ref.split(rows)):
        b = b.double()
        d = (a.double() - b).abs()
        mx, tot = max(mx, float(d.max())), tot + float(d.sum())
        scale = max(scale, float(b.abs().max()))
    scale = max(scale, 1e-30)
    return mx / scale, tot / max(out.numel(), 1) / scale


def stash_differ(a: torch.Tensor, b: torch.Tensor, rows: int = 1 << 16) -> int:
    """How many values of two stashes differ (bit for bit but +-0 equal),
    counted in blocks of ``rows`` rows."""
    return sum(int((x != y).sum()) for x, y in zip(a.split(rows),
                                                   b.split(rows)))


def grad_names(model) -> list:
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    return [f"{n}.{leaf}" for n, m in zip(
        [f"xyz_layers.{i}" for i in range(8)]
        + ["sigma", "xyz_final", "dir_layer", "rgb"],
        fm.dense_layers(model)) for leaf in ("w", "b")]


def grad_readings(mine: list, ref: list, names: list) -> list:
    """Per tensor ``(name, rel max, rel mean, abs max)`` of mine - ref,
    relative to the reference tensor's largest magnitude."""
    rows = []
    for a, b, name in zip(mine, ref, names):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} grad not finite")
        rows.append((name, *rel_errs(a, b), max_abs(a, b)))
    return rows


def summarize(rows: list) -> dict:
    wmax = max(rows, key=lambda r: r[1])
    wmean = max(rows, key=lambda r: r[2])
    return dict(max_rel=wmax[1], max_name=wmax[0], mean_rel=wmean[2],
                mean_name=wmean[0], max_abs=max(r[3] for r in rows))


def check_grads(label: str, mine: list, ref: list, names: list, tol) -> dict:
    """Every parameter grad within ``tol = (max, mean)`` of its reference;
    the worst readings over the tensors."""
    rows = grad_readings(mine, ref, names)
    s = summarize(rows)
    log(f"[{label}] {len(rows)} grads: worst rel max {s['max_rel']:.3e} "
        f"({s['max_name']}), worst rel mean {s['mean_rel']:.3e} "
        f"({s['mean_name']}); tol {tol[0]:.0e} max, {tol[1]:.0e} mean; "
        f"largest abs err {s['max_abs']:.3e}")
    for name, mx, mean, _ in rows:
        if not (mx <= tol[0] and mean <= tol[1]):
            raise AssertionError(f"{label}: {name} grad off by {mx:.3e} "
                                 f"(mean {mean:.3e}), tol {tol}")
    return s


def check_control(label: str, model, x, g, stash, sigma_only, ref: list,
                  names: list) -> dict:
    """The control of the bf16 limits: the plain backward computed in f32
    where bf16 is stated (g_pre, the dgrad and wgrad operands and the
    weights left unrounded), reading the same bf16 stash, its weight grads
    then rounded to bf16 as the wrapper rounds them.  A kernel that skipped
    the bf16 rounding would read so; the limits must fail it."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    bf = torch.bfloat16
    ctl = fm.unpack_grads(model, *fm.fused_nerf_bwd_plain(
        model, x, g, sigma_only, torch.float32, stash=stash), bf)
    rows = grad_readings(ctl, ref, names)
    s = summarize(rows)
    tol = TOL_TRAIN[bf]
    caught = [r[0] for r in rows if not (r[1] <= tol[0] and r[2] <= tol[1])]
    log(f"[control {label}] f32 backward on the bf16 stash against the bf16 "
        f"plain: worst rel max {s['max_rel']:.3e} ({s['max_name']}), worst "
        f"rel mean {s['mean_rel']:.3e} ({s['mean_name']}); {len(caught)} of "
        f"{len(rows)} tensors outside the bf16 limits {tol}")
    if not caught:
        raise AssertionError(f"control {label}: the bf16 limits do not catch "
                             "a backward that skips the bf16 rounding")
    return s


def require_twins(label: str, row_major: list, channel_major: list) -> None:
    """A row-major kernel's results against its channel-major twin's on the
    same points: the layout flag changes only the loads and stores, so the
    arithmetic, and every bit of the results, must be the same."""
    same = all(torch.equal(a, b) for a, b in zip(row_major, channel_major))
    log(f"[{label}] bit-equal: {same}")
    if not same:
        worst = max(max_abs(a, b) for a, b in zip(row_major, channel_major))
        raise AssertionError(f"{label}: the row-major kernel departs from its "
                             f"channel-major twin by {worst:.3e}")


# The control of TOL_C's hold on kernels D and D' (bf16): the plain forward
# with one of these faults, against the kernel's outputs and stash.  A
# tile that lost a product's ragged last 16-row step (layer 0's rows 48-62)
# or a layer's bias would read so, and TOL_C must fail both.  The readings
# of two faults TOL_C is too wide to fail reliably (a forward that skips
# every bf16 rounding, and one that loses the skip layer's ragged step: on
# an H100 they read out max_abs_err of about 9e-3 and 2e-2 against the
# 2e-2 limit) are printed beside them.
FORWARD_CONTROLS = (
    ("layer 0's ragged last step dropped", True,
     lambda m: m.xyz_layers[0].w[48:].zero_()),
    ("layer 3's bias dropped", True, lambda m: m.xyz_layers[3].b.zero_()),
    ("the skip layer's ragged last step dropped", False,
     lambda m: m.xyz_layers[4].w[304:].zero_()),
)


def check_forward_control(label: str, model, x, sigma_only, out, stash,
                          tol) -> dict:
    """Kernel D's outputs and stash against the plain forward with each of
    FORWARD_CONTROLS' faults, and against the plain forward in float32
    where bf16 is stated; TOL_C (``tol``) must fail every fault marked so.
    Returns the least readings of the faults that must fail."""
    import copy

    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    least = None
    cases = [(name, must, fault) for name, must, fault in FORWARD_CONTROLS]
    cases.append(("plain in float32", False, None))
    for name, must_fail, fault in cases:
        if fault is None:
            o_c, s_c = fm.fused_nerf_stash_fwd_plain(model, x, sigma_only,
                                                     torch.float32)
        else:
            faulty = copy.deepcopy(model)
            with torch.no_grad():
                fault(faulty)
            o_c, s_c = fm.fused_nerf_stash_fwd_plain(faulty, x, sigma_only,
                                                     torch.bfloat16)
        r = (max_abs(out, o_c), *rel_errs(stash, s_c))  # TOL_C's readings
        n_diff = stash_differ(stash, s_c)
        del o_c, s_c
        caught = not (r[0] <= tol and r[1] <= tol and r[2] <= TOL_C_MEAN)
        log(f"[forward control {label}: {name}] out max_abs_err {r[0]:.3e}, "
            f"stash rel max {r[1]:.3e} mean {r[2]:.3e} (TOL_C {tol:.0e}, "
            f"{TOL_C_MEAN:.0e}): "
            + ("caught" if caught else "not caught")
            + (" (must be caught)" if must_fail else " (printed only)")
            + f"; {n_diff} stash values differ (the count's limit "
            f"{TOL_STASH_DIFF} must fail it)")
        if n_diff <= TOL_STASH_DIFF:
            raise AssertionError(f"forward control {label} '{name}': its "
                                 "stash passes the stash count's limit")
        if must_fail and not caught:
            raise AssertionError(f"forward control {label} '{name}' passes "
                                 "TOL_C, so the limits cannot fail a wrong "
                                 "forward tile")
        if must_fail:
            least = r if least is None else tuple(map(min, least, r))
    return dict(out_max_abs=least[0], stash_rel_max=least[1],
                stash_rel_mean=least[2])


def sigma_grad_orders(label: str, model, g, sigma_only, dw, stash) -> dict:
    """The sigma head's weight grad (256 values, sum over the P points of
    round(h8) x round(g_sigma)) of the packed f32 grads ``dw`` ({route:
    tensor}), each against the float64 sum of the same bf16 operands (h8
    from ``stash``: {route: the stash that route's h8 comes from}): the
    relative error of each route's f32 sum order, and how many of the 256
    values round to another bf16 than the exact sum's."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    off, w = fm.block_offsets()[fm.D], fm.W
    gs = g[0 if sigma_only else 3].to(torch.bfloat16).double()
    res = {}
    for route, d in dw.items():
        h8 = stash[route][:, (fm.D - 1) * w:fm.D * w].double()
        exact = h8.T @ gs
        got = d[off:off + w].double()
        scale = float(exact.abs().max())
        flips = int((d[off:off + w].to(torch.bfloat16)
                     != exact.float().to(torch.bfloat16)).sum())
        res[route] = dict(rel_max=float((got - exact).abs().max()) / scale,
                          rel_mean=float((got - exact).abs().mean()) / scale,
                          bf16_flips=flips)
    log(f"[sigma head wgrad orders {label}] vs the float64 sum of the same "
        f"bf16 operands: " + "; ".join(
            f"{k} f32 rel max {v['rel_max']:.3e} mean {v['rel_mean']:.3e}, "
            f"{v['bf16_flips']} of {w} round to another bf16"
            for k, v in res.items()))
    return res


def hold_train(label: str, model, x, g, dtype, sigma_only: bool) -> dict:
    """Kernels D, E and F against their plain versions on the same inputs,
    E against F, and in bf16 the control of the limits; then D', E' and F'
    on the same points row-major, against the plain versions and bit for
    bit against D, E and F.  A miss raises."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    names = grad_names(model)
    xr, gr = x.T.contiguous(), g.T.contiguous()
    out, stash = fm.fused_nerf_stash_fwd_cuda(model, x, sigma_only, dtype)
    out_p, stash_p = fm.fused_nerf_stash_fwd_plain(model, x, sigma_only, dtype)
    out_r, stash_r = fm.fused_nerf_raw_stash_fwd_cuda(model, xr, sigma_only,
                                                      dtype)
    torch.cuda.synchronize()
    errs = {}
    for kernel, o, st, o_p in (("D", out, stash, out_p),
                               ("D'", out_r, stash_r, out_p.T)):
        e_out = max_abs(o, o_p)
        s_max, s_mean = rel_errs(st, stash_p)
        n_diff = stash_differ(st, stash_p)
        log(f"[{kernel} {label}] out max_abs_err={e_out:.3e} (tol "
            f"{TOL_C[dtype]:.0e}); stash {tuple(st.shape)} rel max "
            f"{s_max:.3e} mean {s_mean:.3e} (tol {TOL_C[dtype]:.0e}, "
            f"{TOL_C_MEAN:.0e}); {n_diff} of {st.numel()} stash values "
            f"differ from the plain version's (limit {TOL_STASH_DIFF})")
        if not (torch.isfinite(o).all() and e_out <= TOL_C[dtype]
                and s_max <= TOL_C[dtype] and s_mean <= TOL_C_MEAN):
            raise AssertionError(f"kernel {kernel} {label} disagrees")
        if n_diff > TOL_STASH_DIFF:
            raise AssertionError(f"kernel {kernel} {label}: {n_diff} stash "
                                 "values differ from the plain version's")
        errs[kernel] = e_out
    require_twins(f"D' vs D {label}", [out_r, stash_r], [out.T, stash])
    if dtype == torch.bfloat16:
        errs["control"] = check_forward_control(label, model, x, sigma_only,
                                                out, stash, TOL_C[dtype])
    del out, out_p, out_r

    def grads(dw_db):
        return fm.unpack_grads(model, *dw_db, dtype)

    tol = TOL_TRAIN[dtype]
    e_raw = fm.fused_nerf_bwd_stash_cuda(model, x, g, stash, sigma_only,
                                         dtype)
    e_k = grads(e_raw)
    # deterministic: fixed-order sums, no atomics
    again = grads(fm.fused_nerf_bwd_stash_cuda(model, x, g, stash, sigma_only,
                                               dtype))
    same = all(torch.equal(a, b) for a, b in zip(again, e_k))
    log(f"[E run twice {label}] bit-equal: {same}")
    if not same:
        raise AssertionError(f"kernel E {label} differs from run to run")
    del again
    e_p_raw = fm.fused_nerf_bwd_plain(model, x, g, sigma_only, dtype,
                                      stash=stash)
    e_p = grads(e_p_raw)
    e = check_grads(f"E {label}", e_k, e_p, names, tol)
    f_raw = fm.fused_nerf_bwd_remat_cuda(model, x, g, sigma_only, dtype)
    f_k = grads(f_raw)
    f_p_raw = fm.fused_nerf_bwd_plain(model, x, g, sigma_only, dtype)
    f_p = grads(f_p_raw)
    f = check_grads(f"F {label}", f_k, f_p, names, tol)
    orders = None
    if dtype == torch.bfloat16:  # where the bf16 mean readings come from
        orders = sigma_grad_orders(
            label, model, g, sigma_only,
            {"E": e_raw[0], "E plain": e_p_raw[0], "F": f_raw[0],
             "F plain": f_p_raw[0]},
            {"E": stash, "E plain": stash, "F": stash, "F plain": stash_p})
    del stash_p, e_raw, e_p_raw, f_raw, f_p_raw
    # the same point chunks, so the same order of the f32 sums
    ef = check_grads(f"E vs F {label}", e_k, f_k, names,
                     (TOL_E_VS_F, TOL_E_VS_F))
    log(f"[E vs F {label}] bitwise equal: "
        f"{all(torch.equal(a, b) for a, b in zip(e_k, f_k))}")
    e_r = grads(fm.fused_nerf_raw_bwd_stash_cuda(model, xr, gr, stash_r,
                                                 sigma_only, dtype))
    f_r = grads(fm.fused_nerf_raw_bwd_remat_cuda(model, xr, gr, sigma_only,
                                                 dtype))
    res = dict(D=errs["D"], E=e, F=f, E_vs_F=ef["max_rel"],
               forward_control=errs.get("control"), sigma_orders=orders,
               label=label, **{
        "D'": errs["D'"],
        "E'": check_grads(f"E' {label}", e_r, e_p, names, tol),
        "F'": check_grads(f"F' {label}", f_r, f_p, names, tol)})
    require_twins(f"E' vs E {label}", e_r, e_k)
    require_twins(f"F' vs F {label}", f_r, f_k)
    if dtype == torch.bfloat16:
        res["control"] = check_control(label, model, x, g, stash, sigma_only,
                                       e_p, names)
    del stash, stash_r
    torch.cuda.empty_cache()
    return res


def merge_holds(holds: list) -> dict:
    """The worst bf16 readings over ``holds`` (the kernels line's errors),
    each kernel's worst mean reading with its tensor and hold, E against F
    over all, and the controls' least readings."""
    bf = [h for h in holds if "control" in h]
    means = {}
    for k in ("E", "F", "E'", "F'"):
        h = max(bf, key=lambda h: h[k]["mean_rel"])
        means[k] = dict(mean_rel=h[k]["mean_rel"], tensor=h[k]["mean_name"],
                        hold=h["label"])
        log(f"[bf16 mean {k}] worst rel mean {h[k]['mean_rel']:.3e} on "
            f"{h[k]['mean_name']} ({h['label']}; tol "
            f"{TOL_TRAIN[torch.bfloat16][1]:.0e})")
    ctl = [h["forward_control"] for h in bf]
    return dict(
        means=means,
        forward_control={k: min(c[k] for c in ctl) for k in ctl[0]},
        D=max(h["D"] for h in bf),
        E=max(h["E"]["max_abs"] for h in bf),
        F=max(h["F"]["max_abs"] for h in bf),
        E_rel=max(h["E"]["max_rel"] for h in bf),
        F_rel=max(h["F"]["max_rel"] for h in bf),
        mean_rel=max(max(h["E"]["mean_rel"], h["F"]["mean_rel"]) for h in bf),
        **{"D'": max(h["D'"] for h in bf),
           "E'": max(h["E'"]["max_abs"] for h in bf),
           "F'": max(h["F'"]["max_abs"] for h in bf),
           "E'_rel": max(h["E'"]["max_rel"] for h in bf),
           "F'_rel": max(h["F'"]["max_rel"] for h in bf),
           "mean_rel'": max(max(h["E'"]["mean_rel"], h["F'"]["mean_rel"])
                            for h in bf)},
        E_vs_F=max(h["E_vs_F"] for h in holds),
        control_max_rel=min(h["control"]["max_rel"] for h in bf),
        control_mean_rel=min(h["control"]["mean_rel"] for h in bf))


def check_train_kernels(model, gen, dev) -> list:
    """Kernels D, E and F against their plain versions in bf16 and f32, rgb
    and sigma-only, at a P that spans two of the backward's point chunks,
    the second ragged (not a multiple of the 64-point tile)."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    P = fm.BWD_CHUNK + (1 << 16) + 77
    x = random_raw_t(gen, P, dev)
    g = torch.randn((8, P), generator=gen).to(dev)
    holds = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for sigma_only in (True, False):
            mode = "sigma-only" if sigma_only else "rgb"
            holds.append(hold_train(f"{dname} {mode} P={P}", model, x, g,
                                    dtype, sigma_only))
    return holds


# The f32 backward's bits, pinned on the card: kernels E and F in f32 at a
# fixed seeded input (the smoke checkpoint's weights, F32_DIGEST_P points
# spanning two of the backward's chunks, the second ragged), each run twice;
# the SHA-256 of their grads' bytes is printed and recorded in PERF.md, so a
# later change to the f32 path can be compared against it.
F32_DIGEST_P, F32_DIGEST_SEED = (1 << 18) + (1 << 12) + 77, 20240614


def f32_backward_digests(model, dev) -> dict:
    """E and F in f32 (rgb) twice each on the same seeded input: their
    grads' SHA-256, which must repeat; E against F bit for bit is logged."""
    import hashlib

    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(F32_DIGEST_SEED)
    x = random_raw_t(gen, F32_DIGEST_P, dev)
    g = torch.randn((8, F32_DIGEST_P), generator=gen).to(dev)
    _, stash = fm.fused_nerf_stash_fwd_cuda(model, x, False, torch.float32)

    def digest(raw) -> str:
        h = hashlib.sha256()
        for t in raw[:2]:  # dw, db: the kernels' f32 outputs
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    runs = {"E": [], "F": []}
    for _ in range(2):
        runs["E"].append(digest(fm.fused_nerf_bwd_stash_cuda(
            model, x, g, stash, False, torch.float32)))
        runs["F"].append(digest(fm.fused_nerf_bwd_remat_cuda(
            model, x, g, False, torch.float32)))
    torch.cuda.synchronize()
    for k, (a, b) in runs.items():
        log(f"[f32 digest] {k} (rgb, P={F32_DIGEST_P}, seed "
            f"{F32_DIGEST_SEED}): sha256 {a}, again {b}")
        if a != b:
            raise AssertionError(f"f32 kernel {k} differs from run to run")
    log(f"[f32 digest] E and F bit-equal: {runs['E'][0] == runs['F'][0]}")
    del stash
    torch.cuda.empty_cache()
    return {k: v[0] for k, v in runs.items()}


def matmul_chain_ms(model, P: int, dev, backward: bool = True) -> tuple:
    """A yardstick, not a port: the same MLP as a chain of bf16
    ``torch.matmul`` calls (cuBLAS), forward, and the backward's dgrad and
    wgrad products (None unless ``backward``), at P points with random
    embedded inputs."""
    bf = torch.bfloat16
    ws = [m.w.detach().to(bf) for m in model.xyz_layers]
    wsig, wfin, wdir, wrgb = (m.w.detach().to(bf) for m in (
        model.sigma, model.xyz_final, model.dir_layer, model.rgb))
    xe = torch.randn((P, 63), device=dev, dtype=bf)
    de = torch.randn((P, 27), device=dev, dtype=bf)

    def fwd():  # keeps each product's input only for the backward
        h, acts = xe, []
        for i, w in enumerate(ws):
            a = torch.cat([xe, h], -1) if i == 4 else h
            if backward:
                acts.append(a)
            h = torch.relu(torch.matmul(a, w))
        torch.matmul(h, wsig)
        fin = torch.matmul(h, wfin)
        din = torch.cat([fin, de], -1)
        d = torch.relu(torch.matmul(din, wdir))
        torch.sigmoid(torch.matmul(d, wrgb))
        return acts + [h, h, din, d]

    if not backward:
        return cuda_ms(fwd, iters=3), None
    ins = fwd()
    outs = [w for w in ws] + [wsig, wfin, wdir, wrgb]
    gs = [torch.randn((P, w.shape[1]), device=dev, dtype=bf) for w in outs]

    def bwd():
        for a, w, g in zip(ins, outs, gs):
            torch.matmul(a.T, g)  # wgrad
            torch.matmul(g, w.T)  # dgrad
    return cuda_ms(fwd, iters=3), cuda_ms(bwd, iters=3)


def time_train_kernels(model, gen, dev) -> tuple:
    """C, D, E and F and their row-major twins C', D', E' and F' at the
    training step's shapes (bf16, rgb): kernel and plain times by CUDA
    events (each twin timed right after its channel-major kernel), the
    bound, and the bf16 matmul chain; then each held against its plain
    version at that shape (the fine pass spans three of the backward's
    point chunks)."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    bf = torch.bfloat16
    rows, holds = {}, []
    for name, S in (("fine", N_SAMPLES + N_IMPORTANCE), ("coarse", N_SAMPLES)):
        P = TRAIN_BATCH * S
        x = random_raw_t(gen, P, dev)
        g = torch.randn((8, P), generator=gen).to(dev)
        xr, gr = x.T.contiguous(), g.T.contiguous()
        # in turns: the chain's forward before the kernels and after them
        chain_pre, _ = matmul_chain_ms(model, P, dev, backward=False)
        torch.cuda.empty_cache()
        c_ms = cuda_ms(lambda: fm.fused_nerf_apply_raw_t_cuda(model, x, False,
                                                              bf), iters=3)
        cr_ms = cuda_ms(lambda: fm.fused_nerf_apply_raw_cuda(model, xr, False,
                                                             bf), iters=3)
        d_ms = cuda_ms(lambda: fm.fused_nerf_stash_fwd_cuda(model, x, False, bf),
                       iters=3)
        dr_ms = cuda_ms(lambda: fm.fused_nerf_raw_stash_fwd_cuda(
            model, xr, False, bf), iters=3)
        _, stash = fm.fused_nerf_stash_fwd_cuda(model, x, False, bf)
        e_ms = cuda_ms(lambda: fm.fused_nerf_bwd_stash_cuda(
            model, x, g, stash, False, bf), iters=3)
        er_ms = cuda_ms(lambda: fm.fused_nerf_raw_bwd_stash_cuda(
            model, xr, gr, stash, False, bf), iters=3)
        f_ms = cuda_ms(lambda: fm.fused_nerf_bwd_remat_cuda(
            model, x, g, False, bf), iters=2)
        fr_ms = cuda_ms(lambda: fm.fused_nerf_raw_bwd_remat_cuda(
            model, xr, gr, False, bf), iters=2)
        c_plain = cuda_ms(lambda: fm.fused_nerf_apply_raw_plain(
            model, xr, False, bf), iters=1)
        d_plain = cuda_ms(lambda: fm.fused_nerf_stash_fwd_plain(
            model, x, False, bf), iters=1)
        dr_plain = cuda_ms(lambda: fm.fused_nerf_raw_stash_fwd_plain(
            model, xr, False, bf), iters=1)
        e_plain = cuda_ms(lambda: fm.fused_nerf_bwd_plain(
            model, x, g, False, bf, stash=stash), iters=1)
        er_plain = cuda_ms(lambda: fm.fused_nerf_raw_bwd_plain(
            model, xr, gr, False, bf, stash=stash), iters=1)
        f_plain = cuda_ms(lambda: fm.fused_nerf_bwd_plain(
            model, x, g, False, bf), iters=1)
        fr_plain = cuda_ms(lambda: fm.fused_nerf_raw_bwd_plain(
            model, xr, gr, False, bf), iters=1)
        del stash, xr, gr
        torch.cuda.empty_cache()
        chain_fwd, chain_bwd = matmul_chain_ms(model, P, dev)
        stash_b = P * 2 * 2432
        io_b = P * 4 * 8
        bc = bound_ms(2 * io_b, 2 * MACS_RGB * P, BF16_TENSOR_FLOPS)
        bd = bound_ms(stash_b + 2 * io_b, 2 * MACS_RGB * P, BF16_TENSOR_FLOPS)
        be = bound_ms(stash_b + 2 * io_b + 4 * 593_408,
                      4 * MACS_RGB * P, BF16_TENSOR_FLOPS)
        bfb = bound_ms(2 * io_b + 4 * 593_408, 6 * MACS_RGB * P,
                       BF16_TENSOR_FLOPS)
        rows[name] = dict(P=P, D=dict(ms=d_ms, plain_ms=d_plain, bound=bd),
                          E=dict(ms=e_ms, plain_ms=e_plain, bound=be),
                          F=dict(ms=f_ms, plain_ms=f_plain, bound=bfb),
                          C_ms=c_ms, chain_fwd_ms=chain_fwd,
                          chain_fwd_turns_ms=[chain_pre, chain_fwd],
                          chain_bwd_ms=chain_bwd, **{
                              "C'": dict(ms=cr_ms, plain_ms=c_plain, bound=bc),
                              "D'": dict(ms=dr_ms, plain_ms=dr_plain, bound=bd),
                              "E'": dict(ms=er_ms, plain_ms=er_plain, bound=be),
                              "F'": dict(ms=fr_ms, plain_ms=fr_plain,
                                         bound=bfb)})
        for k in ("D", "D'", "E", "E'", "F", "F'", "C'"):
            r = rows[name][k]
            log(f"[{k} time bf16 rgb {name}] P={P} kernel {r['ms']:.3f} ms, "
                f"plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
                f"({r['bound'][1]})")
        log(f"[C time bf16 rgb {name}] P={P} kernel {c_ms:.3f} ms (no stash)")
        log(f"[matmul chain bf16 {name}] P={P} forward {chain_pre:.3f} ms "
            f"(before the kernels), {chain_fwd:.3f} ms (after), "
            f"backward (dgrad + wgrad) {chain_bwd:.3f} ms (torch.matmul, "
            f"a yardstick, not one call)")
        holds.append(hold_train(f"bfloat16 rgb {name} P={P}", model, x, g,
                                bf, False))
        del x, g
        torch.cuda.empty_cache()
    return rows, holds


# ---------------------------------------------------------------- phase 3
def write_checkpoint(path: str) -> None:
    """Seeded full-width coarse and fine models.  The sigma head is scaled
    up so the random scene is partly opaque and the importance sampler's
    CDF is far from uniform."""
    from nerf_pl_tpu_torch.models.nerf import init_nerf
    from nerf_pl_tpu_torch.training.checkpoints import save_checkpoint

    models = {}
    for seed, name in enumerate(("coarse", "fine")):
        m = init_nerf(torch.Generator().manual_seed(seed), device="cpu")
        with torch.no_grad():
            m.sigma.w.mul_(40.0)
        models[name] = m
    save_checkpoint(path, {"params": models, "step": 0, "epoch": 0})


def counters():
    from nerf_pl_tpu_torch.ops import fused_mlp as fm
    from nerf_pl_tpu_torch.ops import searchsorted as ss
    from nerf_pl_tpu_torch.scripts import kernel_probe as kp

    return {"B": ss.searchsorted_interp_cuda, "A": ss.searchsorted_cuda,
            **fm.KERNELS, "I": kp.chain_cuda}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def http(url: str, body: dict | None = None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        payload = r.read()
        return r.status, r.headers["Content-Type"], payload, \
            time.perf_counter() - t0


def png_size(png: bytes):
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        raise AssertionError("not a PNG")
    return int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")


def serve_end_to_end(ckpt: str) -> dict:
    from nerf_pl_tpu_torch.tools.serve import build_server, get_opts

    wh = 200
    args = get_opts([
        "--ckpt_path", ckpt, "--port", "0", "--img_wh", str(wh),
        "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE),
        "--max_batch", "4", "--max_wait_ms", "50", "--device", "cuda"])
    t0 = time.perf_counter()
    srv = build_server(args)  # warm(): every tier rendered once
    log(f"[serve] build_server + warm {time.perf_counter() - t0:.1f} s "
        f"(tiers {srv.service._dispatcher_for(wh).tiers}, "
        f"compute dtype {srv.service.rkw['compute_dtype']})")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        results, errors = [None] * 5, []

        def post(i):
            try:
                results[i] = http(f"{url}/render", {
                    "eye": [4.0 * np.sin(i), 0.5, 4.0 * np.cos(i)],
                    "format": "npy"})
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        def get():
            try:
                results[4] = http(f"{url}/render?theta=0.3&radius=4")
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        threads.append(threading.Thread(target=get))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if errors:
            raise errors[0]
        for status, ctype, payload, _ in results[:4]:
            img = np.load(io.BytesIO(payload))
            if status != 200 or img.shape != (wh, wh, 3):
                raise AssertionError(f"POST: {status} {img.shape}")
            if not np.isfinite(img).all():
                raise AssertionError("POST image not finite")
        status, ctype, png, _ = results[4]
        if status != 200 or ctype != "image/png" or png_size(png) != (wh, wh):
            raise AssertionError(f"GET: {status} {ctype}")
        _, _, body, _ = http(f"{url}/healthz")
        health = json.loads(body)
        if health["status"] != "ok" or health["renders"] != 5:
            raise AssertionError(f"healthz: {health}")
        lat = [r[3] for r in results]
        rays = 5 * wh * wh
        log(f"[serve] 4 POST + 1 GET at {wh}x{wh}: {wall:.3f} s wall, "
            f"{rays / wall:.1f} rays/s, {1e3 * np.mean(lat):.1f} ms mean "
            f"per request (max {1e3 * max(lat):.1f}); healthz {health}")
        log(f"[serve] launches during the requests: {counts}")
        for k in ("B", "C"):
            if counts[k] < 1:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     "serve path")
        one_view = np.mean(lat)
        profile_batch(srv.service, wh)
    finally:
        srv.shutdown()
        srv.server_close()
    return dict(counts=counts, rays_per_s=rays / wall, ms=1e3 * one_view,
                health=health)


def profile_device(label: str, fn, top: int = 8) -> dict:
    """Device time by kernel and the device's busy share over one call of
    ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0.0)
              for e in kernels}
    busy_ms = sum(dev_us.values()) / 1e3
    if busy_ms <= 0:
        log(f"[profile] {label}: {wall_ms:.1f} ms wall; device time not "
            "measured (the profiler saw no device events)")
        return dict(wall_ms=wall_ms, busy_ms=None)
    log(f"[profile] {label}: {wall_ms:.1f} ms wall, {busy_ms:.1f} ms device "
        f"busy ({100 * busy_ms / wall_ms:.1f}%), idle share "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    for name, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%"
            f"  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                by_kernel={k: us / 1e3 for k, us in dev_us.items()})


def profile_batch(service, wh: int) -> None:
    """One 4-view batch render under the profiler."""
    c2w = service._c2w_for([4.0, 0.5, 0.0], (0.0, 0.0, 0.0))
    profile_device(f"4-view batch at {wh}x{wh}",
                   lambda: service.render_batch([c2w] * 4, wh))


def random_sampler_path(ckpt: str) -> dict:
    """``render_rays`` with ``perturb=1`` and sigma noise: the stochastic
    importance sampler runs kernel A."""
    from nerf_pl_tpu_torch.ops.rendering import render_rays
    from nerf_pl_tpu_torch.tools.evaluate import load_models

    device = "cuda"
    models = load_models(ckpt, device)
    gen = torch.Generator(device=device).manual_seed(0)
    n = 4096
    o = torch.zeros((n, 3), device=device)
    o[:, 2] = 4.0
    d = torch.randn((n, 3), device=device, generator=gen) * 0.2
    d[:, 2] = -1.0
    d = d / d.norm(dim=-1, keepdim=True)
    nf = torch.ones((n, 1), device=device)
    rays = torch.cat([o, d, 2.0 * nf, 6.0 * nf], -1)
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        out = render_rays(
            models["coarse"], models["fine"], rays, gen,
            N_samples=N_SAMPLES, N_importance=N_IMPORTANCE, perturb=1.0,
            noise_std=1.0, white_back=True, use_fused=True,
            fused_channel_io=True, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    counts = read_counts()
    if not torch.isfinite(out["rgb_fine"]).all():
        raise AssertionError("random-sampler render not finite")
    log(f"[render_rays perturb=1] {n} rays, launches {counts}")
    if counts["A"] < 1 or counts["C"] < 1:
        raise AssertionError("kernel A or C was not launched")
    return counts


def f32_card_vs_cpu(ckpt: str) -> float:
    """256 rays of one view (16x16) through the server's render path in
    float32: fused kernel C and kernel B on the card, plain on the CPU."""
    from nerf_pl_tpu_torch.tools.serve import RenderService

    imgs = {}
    for device in ("cuda", "cpu"):
        svc = RenderService(ckpt, img_wh=16, n_samples=N_SAMPLES,
                            n_importance=N_IMPORTANCE, max_batch=1,
                            compute_dtype="float32", device=device)
        c2w = svc._c2w_for([2.5, 1.0, 3.0], (0.0, 0.0, 0.0))
        imgs[device] = svc.render_batch([c2w], 16)[0]
    diff = np.abs(imgs["cuda"] - imgs["cpu"])
    err, mean = float(diff.max()), float(diff.mean())
    log(f"[f32 card vs cpu] 256 rays, max_abs_err={err:.3e} "
        f"tol={TOL_F32_RENDER:.0e}, mean_abs_err={mean:.3e} "
        f"tol={TOL_F32_RENDER_MEAN:.0e}; image mean {imgs['cpu'].mean():.4f},"
        f" min {imgs['cpu'].min():.4f}")
    if (not np.isfinite(imgs["cuda"]).all() or not err <= TOL_F32_RENDER
            or not mean <= TOL_F32_RENDER_MEAN):
        raise AssertionError(f"card f32 render disagrees with the CPU: {err}")
    return err


# ---------------------------------------------------------------- phase 4
TRAIN_WH, TRAIN_VIEWS = 100, 8
# the evaluation: test views written at the Blender scenes' 800x800 and
# rendered at 400x400, as the reference's documented eval, so the loader's
# LANCZOS resize runs
EVAL_VIEWS, EVAL_WRITTEN_WH, EVAL_WH = 2, 800, 400
# one eval chunk (the --chunk default) and its points per pass
EVAL_CHUNK = 32 * 1024
# One float32 training step's grads on the card against the CPU, per tensor
# relative to its largest magnitude.  Same weights, rays and injected random
# draws on both; the card runs kernels A, D and E, the CPU their plain
# versions.  f32 sums in another order, and sinf/cosf that may differ by an
# ulp at the encoding's 2^9-scaled arguments (which moves the float32 render
# by up to 5e-4, PERF.md), so the grads agree to rounding, not to the bit.
TOL_STEP_GRADS = (2e-2, 2e-3)


def write_scene(root: str, n_train: int = TRAIN_VIEWS, n_val: int = 1,
                wh: int = TRAIN_WH, n_test: int = EVAL_VIEWS,
                test_wh: int = EVAL_WRITTEN_WH) -> None:
    """A Blender-format scene written with the port's PNG writer: a shaded
    disc on a transparent background, seen from a circle of cameras.  The
    test split is written at ``test_wh``, as the Blender scenes' 800x800."""
    from nerf_pl_tpu_torch.data.png import write_png

    rng = np.random.RandomState(0)
    for split, n, wh in (("train", n_train, wh), ("val", n_val, wh),
                         ("test", n_test, test_wh)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            theta = 2 * np.pi * (i + (0 if split == "train" else 0.5)) / n
            if split == "test":
                theta += 0.25
            c, sn = np.cos(theta), np.sin(theta)
            eye = np.array([4 * sn, 0.5, 4 * c], np.float32)
            fwd = eye / np.linalg.norm(eye)
            right = np.cross([0, 1, 0], fwd)
            right /= np.linalg.norm(right)
            m = np.eye(4, dtype=np.float32)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = (
                right, np.cross(fwd, right), fwd, eye)
            yy, xx = np.mgrid[0:wh, 0:wh].astype(np.float32) / wh - 0.5
            r = np.sqrt(xx ** 2 + yy ** 2)
            img = np.zeros((wh, wh, 4), np.float32)
            img[..., 0] = 0.5 + 0.5 * c
            img[..., 1] = 0.3 + 0.5 * np.clip(0.35 - r, 0, 1)
            img[..., 2] = 0.5 + 0.5 * sn
            img[..., 3] = (r < 0.35).astype(np.float32)
            img += rng.rand(wh, wh, 4) * 0.05
            name = f"{split}/r_{i}"
            write_png(os.path.join(root, f"{name}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": f"./{name}",
                           "transform_matrix": m.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)


def train_end_to_end(tmp: str) -> dict:
    """``python -m nerf_pl_tpu_torch.train`` at full width in bf16 for 2
    epochs; then launches per step, one step under the profiler, and F
    through ``stash_blocks=None``."""
    from nerf_pl_tpu_torch import train as train_cli
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    root = os.path.join(tmp, "scene")
    write_scene(root)
    argv = ["--root_dir", root, "--dataset_name", "blender",
            "--img_wh", str(TRAIN_WH), str(TRAIN_WH),
            "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE),
            "--batch_size", str(TRAIN_BATCH), "--num_epochs", "2",
            "--lr", "5e-4", "--white_back", "true",
            "--compute_dtype", "bfloat16", "--exp_name", "smoke",
            "--log_dir", os.path.join(tmp, "logs"),
            "--ckpt_dir", os.path.join(tmp, "ckpts"), "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    system = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(tmp, "logs", "smoke", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    losses = [r["train/loss"] for r in epochs]
    vals = [r["val/loss"] for r in recs if "val/loss" in r]
    rate = epochs[-1]["train/rays_per_s"]
    log(f"[train] {TRAIN_VIEWS} views at {TRAIN_WH}x{TRAIN_WH}, batch "
        f"{TRAIN_BATCH}, {N_SAMPLES}+{N_IMPORTANCE} samples, bf16, "
        f"{system.steps_per_epoch} steps/epoch: loss per epoch {losses}, "
        f"val loss {vals}; epoch-1 {rate:.1f} train rays/s; fit "
        f"{wall:.1f} s wall; launches in the fit {counts}")
    if len(losses) != 2 or not all(np.isfinite(losses + vals)):
        raise AssertionError(f"training losses not finite: {losses} {vals}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    for k in ("A", "C", "D", "E"):
        if counts[k] < 1:
            raise AssertionError(f"kernel {k} was not launched by the fit")
    ckpts = sorted(os.listdir(os.path.join(tmp, "ckpts", "smoke")))
    if ckpts != ["epoch=0.ckpt", "epoch=1.ckpt"]:
        raise AssertionError(f"checkpoints: {ckpts}")
    require_checkpoints(os.path.join(tmp, "ckpts", "smoke"), "train")

    rays, rgbs = system.rays[:TRAIN_BATCH], system.rgbs[:TRAIN_BATCH]
    torch.cuda.synchronize()
    reset_counts()
    system.train_step(rays, rgbs)
    torch.cuda.synchronize()
    per_step = read_counts()
    log(f"[train] launches in one training step: {per_step}")
    syncs = step_syncs(system)
    prof = profile_device("one training step (bf16, 4096 rays)",
                          lambda: system.train_step(rays, rgbs), top=12)

    # kernel F: the remat route of the same fused MLP, forward and backward
    model = system.models["fine"]
    x = random_raw_t(torch.Generator().manual_seed(5),
                     TRAIN_BATCH * (N_SAMPLES + N_IMPORTANCE), "cuda")
    torch.cuda.synchronize()
    reset_counts()
    out = fm.fused_nerf_apply_raw_t(model, x, False, torch.bfloat16,
                                    stash_blocks=None)
    out[:4].square().mean().backward()
    torch.cuda.synchronize()
    remat = read_counts()
    model.zero_grad(set_to_none=True)
    log(f"[train] stash_blocks=None forward + backward: launches {remat}")
    if remat["F"] != 1 or remat["C"] != 1 or remat["D"] or remat["E"]:
        raise AssertionError(f"the remat route did not take C and F: {remat}")
    return dict(counts=counts, per_step=per_step, remat=remat, losses=losses,
                rays_per_s=rate, profile=prof, syncs=syncs)


def step_syncs(system, batch: int = TRAIN_BATCH,
               tag: str = "train") -> dict:
    """The training step's synchronising calls.  The step's index fetch (a
    slice of the epoch's permutation on the card, then the ray and colour
    gathers) and ``Adam.step`` run under ``set_sync_debug_mode("error")``,
    which raises at any call that makes the host wait for the card; then a
    whole step (fetch, render, loss, backward, Adam) under ``"warn"``, whose
    warnings are counted by the call that made them.  ``batch`` rays a step."""
    from nerf_pl_tpu_torch.training.optim import host_to_device

    perm = host_to_device(torch.randperm(
        system.rays.shape[0], generator=torch.Generator().manual_seed(0)),
        system.device)
    torch.cuda.synchronize()

    def fetch():
        idx = perm[:batch]
        return system.rays[idx], system.rgbs[idx]

    torch.cuda.set_sync_debug_mode("error")
    try:
        fetch()
        system.optimizer.step()  # the grads of the step before
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[{tag}] the index fetch and Adam.step ran under "
        "set_sync_debug_mode('error'): no synchronising call")
    calls = sync_calls(lambda: system.train_step(*fetch()))
    n = sum(calls.values())
    log(f"[{tag}] one whole step under set_sync_debug_mode('warn'): {n} "
        f"synchronising calls, by line: {calls}")
    return dict(count=n, calls=calls)


def sync_calls(fn) -> dict:
    """The synchronising calls ``fn()`` makes, counted by the Python line
    that made each, from the warnings of ``set_sync_debug_mode("warn")``."""
    import warnings
    from collections import Counter

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    calls = Counter()
    root = os.path.dirname(os.path.abspath(__file__))
    for w in caught:
        msg = str(w.message)
        if "synchroniz" in msg and "prototype" not in msg:
            calls[f"{os.path.relpath(w.filename, root)}:{w.lineno}"] += 1
    return dict(calls)


def adam_step_before(opt) -> None:
    """``Adam.step`` as it was before its scalars moved to the card in one
    non-blocking copy (a blocking scalar copy per parameter): the frozen
    reference of the update's bits."""
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


def adam_card_vs_before() -> None:
    """5 card steps of ``Adam.step`` against ``adam_step_before`` on the
    reference NeRF's coarse and fine parameters, with the same random grads,
    across a step-LR boundary, bare and with weight decay and grad clip:
    parameters and both moments bit for bit."""
    from nerf_pl_tpu_torch.models.nerf import init_nerf
    from nerf_pl_tpu_torch.training import optim

    for wd, clip in ((0.0, 0.0), (1e-2, 0.05)):
        opts = []
        for _ in range(2):
            gen = torch.Generator().manual_seed(11)
            models = {k: init_nerf(gen, device="cuda")
                      for k in ("coarse", "fine")}
            sched = optim.make_lr_schedule(5e-4, "steplr", 2, 3,
                                           decay_step=(1,), decay_gamma=0.5)
            opts.append(optim.get_optimizer(
                "adam", sched, optim.named_params(models), weight_decay=wd,
                grad_clip=clip))
        new, old = opts
        gen = torch.Generator(device="cuda").manual_seed(12)
        for _ in range(5):
            for k, p in new.params.items():
                g = torch.randn(p.shape, generator=gen, device="cuda") * 0.1
                p.grad, old.params[k].grad = g, g.clone()
            new.step()
            adam_step_before(old)
        torch.cuda.synchronize()
        same = all(torch.equal(new.params[k], old.params[k])
                   and torch.equal(new.mu[k], old.mu[k])
                   and torch.equal(new.nu[k], old.nu[k]) for k in new.params)
        same = same and (new.count, new.sched_count) == (old.count,
                                                         old.sched_count)
        log(f"[adam] 5 card steps (weight decay {wd}, grad clip {clip}, "
            f"step-LR boundary at step 2) against the step before: params, "
            f"mu and nu bit-equal: {same}")
        if not same:
            raise AssertionError("Adam.step departs from the step before")


def time_eval_chunk(model, gen, dev) -> dict:
    """C and C' at one eval chunk in float32, the eval's compute dtype:
    32,768 rays x 192 points (the fine pass, rgb) and x 64 (the coarse pass,
    sigma-only).  Kernel times by CUDA events (C' right after C), C''s
    plain time and its error against it, the bound at the float32 rate
    (outside the tensor cores), and the bf16 matmul chain's forward."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    f32 = torch.float32
    rows = {}
    for mode, S, macs in (("rgb", N_SAMPLES + N_IMPORTANCE, MACS_RGB),
                          ("sigma-only", N_SAMPLES, MACS_SIGMA)):
        sigma_only = mode == "sigma-only"
        P = EVAL_CHUNK * S
        xr = random_raw_t(gen, P, dev).T.contiguous()
        x = xr.T.contiguous()
        c_ms = cuda_ms(lambda: fm.fused_nerf_apply_raw_t_cuda(
            model, x, sigma_only, f32), iters=2)
        cr_ms = cuda_ms(lambda: fm.fused_nerf_apply_raw_cuda(
            model, xr, sigma_only, f32), iters=2)
        out_r = fm.fused_nerf_apply_raw_cuda(model, xr, sigma_only, f32)
        require_twins(f"C' vs C f32 {mode} eval chunk P={P}", [out_r],
                      [fm.fused_nerf_apply_raw_t_cuda(model, x, sigma_only,
                                                      f32).T])
        del x
        plain_ms = cuda_ms(lambda: fm.fused_nerf_apply_raw_plain(
            model, xr, sigma_only, f32), iters=1)
        ref = fm.fused_nerf_apply_raw_plain(model, xr, sigma_only, f32)
        err = max_abs(out_r, ref)
        log(f"[C' f32 {mode} eval chunk] P={P} max_abs_err={err:.3e} "
            f"tol={TOL_C[f32]:.0e}")
        if not (torch.isfinite(out_r).all() and err <= TOL_C[f32]):
            raise AssertionError(f"kernel C' f32 {mode} disagrees at the "
                                 "eval chunk")
        del out_r, ref, xr
        torch.cuda.empty_cache()
        chain_ms, _ = matmul_chain_ms(model, P, dev, backward=False)
        torch.cuda.empty_cache()
        b, by = bound_ms(P * 64, 2 * macs * P, F32_FLOPS)
        log(f"[C' time f32 {mode} eval chunk] P={P} kernel {cr_ms:.3f} ms "
            f"(C {c_ms:.3f} ms), plain {plain_ms:.3f} ms, bound {b:.3f} ms "
            f"({by}, {2 * macs * P:.3e} FLOP at the f32 rate); bf16 matmul "
            f"chain forward {chain_ms:.3f} ms")
        rows[mode] = dict(P=P, ms=cr_ms, C_ms=c_ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by, err=err,
                          matmul_chain_fwd_ms=chain_ms)
    return rows


def gif_frames(path: str) -> tuple:
    """``(frames, delays in 1/100 s, loops)`` from a GIF's block structure."""
    data = open(path, "rb").read()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path} is not a GIF89a")
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)
    frames, delays, loops = 0, [], False

    def skip_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension
            if data[pos + 1] == 0xF9:
                delays.append(int.from_bytes(data[pos + 4:pos + 6], "little"))
            loops |= data[pos + 3:pos + 14] == b"NETSCAPE2.0"
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:  # image
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_blocks(pos + 1)
            frames += 1
        else:
            raise AssertionError(f"{path}: unknown GIF block {data[pos]:#x}")
    return frames, delays, loops


def eval_end_to_end(tmp: str, ckpt: str) -> dict:
    """``python -m nerf_pl_tpu_torch.eval`` on the fit's checkpoint: the
    scene's 800x800 test views at 400x400, 64 + 128 samples, the default
    chunk, once with ``--fused_channel_io false`` (kernel C') and once with
    ``true`` (kernel C).  Launch counts per run, the two runs' images and
    depths against each other, the files read back."""
    from nerf_pl_tpu_torch import eval as eval_cli
    from nerf_pl_tpu_torch.data.depth_utils import read_pfm
    from nerf_pl_tpu_torch.data.png import read_png

    runs = {}
    for channel_io in ("false", "true"):
        out_dir = os.path.join(tmp, f"eval_channel_io_{channel_io}")
        argv = ["--root_dir", os.path.join(tmp, "scene"), "--ckpt_path", ckpt,
                "--img_wh", str(EVAL_WH), str(EVAL_WH),
                "--N_samples", str(N_SAMPLES),
                "--N_importance", str(N_IMPORTANCE), "--white_back", "true",
                "--fused_channel_io", channel_io, "--save_depth",
                "--scene_name", "smoke", "--out_dir", out_dir,
                "--device", "cuda"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        psnr = eval_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        d = os.path.join(out_dir, "blender", "smoke")
        names = sorted(os.listdir(d))
        want = sorted([f"{i:03d}.png" for i in range(EVAL_VIEWS)]
                      + [f"depth_{i:03d}.pfm" for i in range(EVAL_VIEWS)]
                      + ["smoke.gif"])
        if names != want:
            raise AssertionError(f"eval wrote {names}, not {want}")
        imgs, depths = [], []
        for i in range(EVAL_VIEWS):
            img, mode = read_png(os.path.join(d, f"{i:03d}.png"))
            depth, _ = read_pfm(os.path.join(d, f"depth_{i:03d}.pfm"))
            if img.shape != (EVAL_WH, EVAL_WH, 3) or mode != "RGB":
                raise AssertionError(f"PNG {i}: {img.shape} {mode}")
            if depth.shape != (EVAL_WH, EVAL_WH) or not np.isfinite(depth).all():
                raise AssertionError(f"depth {i}: {depth.shape}")
            imgs.append(img)
            depths.append(depth)
        frames, delays, _ = gif_frames(os.path.join(d, "smoke.gif"))
        if frames != EVAL_VIEWS or delays != [3] * EVAL_VIEWS:
            raise AssertionError(f"GIF: {frames} frames, delays {delays}")
        rays = EVAL_VIEWS * EVAL_WH * EVAL_WH
        label = "row-major (C')" if channel_io == "false" else \
            "channel-major (C)"
        log(f"[eval {label}] {EVAL_VIEWS} views of {EVAL_WRITTEN_WH}^2 at "
            f"{EVAL_WH}x{EVAL_WH}, {N_SAMPLES}+{N_IMPORTANCE} samples, f32: "
            f"mean PSNR {psnr:.4f} dB, {wall:.3f} s wall, "
            f"{wall / EVAL_VIEWS:.3f} s per view, {rays / wall:.1f} rays/s; "
            f"launches {counts}")
        runs[channel_io] = dict(psnr=psnr, wall=wall, s_per_view=wall /
                                EVAL_VIEWS, rays_per_s=rays / wall,
                                counts=counts, imgs=imgs, depths=depths)
    rm, cm = runs["false"], runs["true"]
    if rm["counts"]["C'"] < 1 or rm["counts"]["B"] < 1 or rm["counts"]["C"]:
        raise AssertionError(f"the row-major eval did not take C' and B "
                             f"alone: {rm['counts']}")
    if cm["counts"]["C"] < 1 or cm["counts"]["C'"]:
        raise AssertionError(f"the channel-major eval did not take C alone: "
                             f"{cm['counts']}")
    png_diff = [np.abs(a.astype(int) - b.astype(int))
                for a, b in zip(rm["imgs"], cm["imgs"])]
    png_levels = max(int(d.max()) for d in png_diff)
    png_count = sum(int((d > 0).sum()) for d in png_diff)
    depth_err = max(float(np.abs(a - b).max())
                    for a, b in zip(rm["depths"], cm["depths"]))
    rgb_err = float_render_layouts(ckpt, os.path.join(tmp, "scene"))
    log(f"[eval] row-major vs channel-major: PNGs differ in {png_count} "
        f"values by at most {png_levels} level; depth max_abs_err "
        f"{depth_err:.3e}, float rgb of view 0 max_abs_err {rgb_err:.3e} "
        f"(tol {TOL_EVAL_LAYOUTS:.0e}); PSNR {rm['psnr']:.6f} vs "
        f"{cm['psnr']:.6f}")
    if not (png_levels <= 1 and depth_err <= TOL_EVAL_LAYOUTS
            and rgb_err <= TOL_EVAL_LAYOUTS):
        raise AssertionError("the two layouts' renders disagree")
    for r in runs.values():
        del r["imgs"], r["depths"]
    return dict(row_major=rm, channel_major=cm, depth_err=depth_err,
                rgb_err=rgb_err, png_values_differing=png_count)


def float_render_layouts(ckpt: str, root: str) -> float:
    """The eval's render of test view 0 (the same call the eval tool makes)
    in both layouts: max |rgb_fine difference| in float32."""
    from nerf_pl_tpu_torch.data.blender import BlenderDataset
    from nerf_pl_tpu_torch.tools.evaluate import load_models
    from nerf_pl_tpu_torch.tools.render import render_image

    models = load_models(ckpt, "cuda")
    ds = BlenderDataset(root, "test", img_wh=(EVAL_WH, EVAL_WH),
                        white_back=True)
    rays = torch.from_numpy(ds[0]["rays"]).cuda()
    rgb = [render_image(models, rays, None, chunk=EVAL_CHUNK,
                        N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                        perturb=0.0, noise_std=0.0, white_back=True,
                        test_time=True, use_fused=True,
                        fused_channel_io=io)["rgb_fine"]
           for io in (False, True)]
    return max_abs(rgb[0], rgb[1])


def train_row_major(tmp: str, base_losses: list) -> dict:
    """``python -m nerf_pl_tpu_torch.train --fused_channel_io false`` for one
    epoch at full width in bf16, on the same scene and seed as the
    channel-major fit: launches of D' and E' in the fit and per step, C' in
    validation; the epoch-0 loss against the channel-major fit's; then F'
    through ``fused_nerf_apply_raw(..., stash_blocks=None)``."""
    from nerf_pl_tpu_torch import train as train_cli
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    argv = ["--root_dir", os.path.join(tmp, "scene"),
            "--dataset_name", "blender",
            "--img_wh", str(TRAIN_WH), str(TRAIN_WH),
            "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE),
            "--batch_size", str(TRAIN_BATCH), "--num_epochs", "1",
            "--lr", "5e-4", "--white_back", "true",
            "--compute_dtype", "bfloat16", "--fused_channel_io", "false",
            "--exp_name", "smoke_rm", "--log_dir", os.path.join(tmp, "logs"),
            "--ckpt_dir", os.path.join(tmp, "ckpts"), "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    system = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(tmp, "logs", "smoke_rm", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    loss = epochs[0]["train/loss"]
    steps = system.steps_per_epoch
    log(f"[train row-major] 1 epoch, {steps} steps, bf16: loss {loss!r} "
        f"(channel-major fit's epoch 0: {base_losses[0]!r}); "
        f"{epochs[0]['train/rays_per_s']:.1f} train rays/s; fit {wall:.1f} s "
        f"wall; launches in the fit {counts}")
    if not np.isfinite(loss):
        raise AssertionError(f"row-major fit loss not finite: {loss}")
    rel = abs(loss - base_losses[0]) / abs(base_losses[0])
    log(f"[train row-major] epoch-0 loss against the channel-major fit's: "
        f"identical {loss == base_losses[0]}, relative difference {rel:.3e} "
        f"(tol {TOL_FIT_LAYOUTS:.0e})")
    if not rel <= TOL_FIT_LAYOUTS:
        raise AssertionError("the row-major fit's epoch-0 loss departs from "
                             "the channel-major fit's")
    if (counts["D'"] < 2 * steps or counts["E'"] < 2 * steps
            or counts["C'"] < 1 or counts["D"] or counts["E"] or counts["C"]):
        raise AssertionError(f"the row-major fit did not take D', E' and C' "
                             f"alone: {counts}")
    rays, rgbs = system.rays[:TRAIN_BATCH], system.rgbs[:TRAIN_BATCH]
    torch.cuda.synchronize()
    reset_counts()
    system.train_step(rays, rgbs)
    torch.cuda.synchronize()
    per_step = read_counts()
    log(f"[train row-major] launches in one training step: {per_step}")
    if per_step["D'"] != 2 or per_step["E'"] != 2:
        raise AssertionError(f"a row-major step launched {per_step}")

    # kernel F': the remat route of the row-major fused MLP
    model = system.models["fine"]
    xr = random_raw_t(torch.Generator().manual_seed(6),
                      TRAIN_BATCH * (N_SAMPLES + N_IMPORTANCE), "cuda").T
    torch.cuda.synchronize()
    reset_counts()
    out = fm.fused_nerf_apply_raw(model, xr[:, :3], xr[:, 3:6],
                                  torch.bfloat16, stash_blocks=None)
    out.square().mean().backward()
    torch.cuda.synchronize()
    remat = read_counts()
    model.zero_grad(set_to_none=True)
    log(f"[train row-major] fused_nerf_apply_raw(stash_blocks=None) forward "
        f"+ backward at {xr.shape[0]} points: launches {remat}")
    if remat["F'"] != 1 or remat["C'"] != 1 or remat["D'"] or remat["E'"]:
        raise AssertionError(f"the row-major remat route did not take C' and "
                             f"F': {remat}")
    return dict(counts=counts, per_step=per_step, remat=remat, loss=loss,
                loss_rel_diff=rel, rays_per_s=epochs[0]["train/rays_per_s"])


def step_grads_card_vs_cpu() -> float:
    """One float32 training step's grads (render -> MSE -> backward through
    the fused MLP) on the card and on the CPU, at 256 rays."""
    from nerf_pl_tpu_torch.graft_entry import flagship_models, make_rays
    from nerf_pl_tpu_torch.ops.rendering import render_rays
    from nerf_pl_tpu_torch.training.losses import mse_loss

    n = 256
    gen = torch.Generator().manual_seed(3)
    rays = make_rays(gen, n, device="cpu")
    rgbs = torch.rand((n, 3), generator=gen)
    ov = {"perturb_rand": torch.rand((n, N_SAMPLES), generator=gen),
          "noise_coarse": torch.randn((n, N_SAMPLES), generator=gen),
          "u": torch.rand((n, N_IMPORTANCE), generator=gen),
          "jitter": torch.rand((n, N_IMPORTANCE), generator=gen),
          "noise_fine": torch.randn((n, N_SAMPLES + N_IMPORTANCE),
                                    generator=gen)}
    grads = {}
    for device in ("cuda", "cpu"):
        models = flagship_models(0, device)
        out = render_rays(models["coarse"], models["fine"], rays.to(device),
                          None, N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                          perturb=1.0, noise_std=1.0, white_back=True,
                          compute_dtype=torch.float32, use_fused=True,
                          fused_channel_io=True,
                          overrides={k: v.to(device) for k, v in ov.items()})
        mse_loss(out, rgbs.to(device)).backward()
        grads[device] = {f"{name}/{k}": p.grad.cpu()
                         for name, m in models.items()
                         for k, p in m.named_parameters()}
    names = sorted(grads["cpu"])
    return check_grads("f32 step grads card vs cpu (256 rays)",
                       [grads["cuda"][k] for k in names],
                       [grads["cpu"][k] for k in names], names,
                       TOL_STEP_GRADS)["max_rel"]


def bench_number() -> dict:
    from nerf_pl_tpu_torch.bench import bench

    rate = bench(iters=10, compute_dtype=torch.bfloat16)
    log(f"[bench] python -m nerf_pl_tpu_torch.bench workload, 10 steps: "
        f"{rate:.1f} train rays/s (bf16)")
    return dict(rays_per_s=rate)


# ---------------------------------------------------------------- phase 6
# Kernels G (the pre-embedded forward at any width), H (its backward with
# dx) and I (the probe's chain).
WIDE_WIDTHS = ((128, (torch.bfloat16, torch.float32)),
               (256, (torch.bfloat16, torch.float32)),
               (384, (torch.bfloat16, torch.float32)),
               (512, (torch.bfloat16,)), (640, (torch.bfloat16,)))
WIDE_P = 100_003  # ragged against both tiles (32 and 64 points)
# Kernel G against its plain version, per live output column (rgb and
# sigma, or sigma alone), relative to that column's standard deviation over
# the points: (max, mean) of |kernel - plain| / std.  The models are drawn
# with weights of variance 2 / fan_in (``spread_model``), so activations keep
# their scale down the trunk and every output moves with the input.  Both
# sides round the same operands and sum in f32 in different orders, and in
# bf16 a sum's last bit can flip a rounded operand downstream.  Each case
# prints what sum order alone does (the plain version with float64 sums
# against float32, ``plain_f64``); the limits were set 4x (bf16) and 6-10x
# (float32) above the worst such reading of a CPU calibration at W =
# 128-640.  Each case also runs controls that must fail: the plain version
# in float32 against the bf16 kernel, one trunk layer's weights x 1.01, and
# (rgb) the dir head's last 64 columns x 1.01.
TOL_G = {torch.bfloat16: (2e-1, 2e-3), torch.float32: (1e-4, 1e-5)}
WIDE_W, WIDE_RENDER_WH, WIDE_CHUNK = 512, 200, 8192
# The W = 512 view rendered in bf16 through G and through posenc + NeRF:
# both round every layer's operands to bf16 and sum in f32, so only the
# order of the sums differs.  On the CPU, the posenc + NeRF route with
# float64 sums against float32 moved rgb by at most 5.4e-5 (mean 3.1e-6) on
# 2,304 rays of the same checkpoint; 1e-2 leaves room for a rounding flip in
# a rare ray and fails a wrong weight, channel or sample by far.
TOL_WIDE_RENDER = (1e-2, 1e-4)
# Kernel I against its plain version, relative to max |plain|: the tensor
# cores sum in another order than torch's f32 product, and the pure chain
# rounds every product to bf16, so a flip propagates through 8 layers.  On
# the CPU, float64 sums against float32 moved the pure chain by 5.5e-3 of
# max|ref| (mean 1.2e-5) and the fancy one by 3.6e-3 (mean 4.0e-6) at 32,768
# rows.
TOL_CHAIN = (3e-2, 3e-4)
PROBE_TIMEOUT_S = 300


def mlp_macs(width: int) -> int:
    """Multiply-adds an rgb point of the reference topology at trunk width
    W: the trunk (skip at 4), sigma, fin, the W/2 dir head and rgb."""
    return (63 * width + 6 * width * width + (width + 63) * width + width
            + width * width + (width + 27) * (width // 2) + (width // 2) * 3)


def random_embedded(gen, P: int, device, cols: int = 90) -> torch.Tensor:
    """(P, cols) pre-embedded rows [xyz_emb | dir_emb] of random points in
    the [-1.5, 1.5] cube and unit directions."""
    from nerf_pl_tpu_torch.models.embedding import posenc

    x = random_raw_t(gen, P, "cpu")
    emb = torch.cat([posenc(x[:3].T, 10), posenc(x[3:6].T, 4)], -1)
    return emb[:, :cols].contiguous().to(device)


def wide_model(width: int, device, seed: int = 7):
    from nerf_pl_tpu_torch.models.nerf import init_nerf

    return init_nerf(torch.Generator().manual_seed(seed), W=width,
                     device=device).requires_grad_(False)


def spread_model(width: int, device, seed: int = 7):
    """``wide_model`` with every weight x sqrt(6): variance 2 / fan_in in
    place of nn.Linear's 1 / (3 fan_in)."""
    model = wide_model(width, device, seed)
    for name, p in model.named_parameters():
        if name.endswith(".w"):
            p.mul_(6 ** 0.5)
    return model


def plain_f64(model, x: torch.Tensor, sigma_only: bool,
              dtype) -> torch.Tensor:
    """Kernel G's plain version with float64 sums: each layer's input and
    weight rounded to ``dtype`` as there, the rest in float64.  Returns the
    live columns, ``(P, 1)`` sigma or ``(P, 4)`` [rgb | sigma]."""
    def dense(layer, h):
        return (h.to(dtype).double() @ layer.w.to(dtype).double()
                + layer.b.double())

    xe = x[:, :63].double()
    h = xe
    for i, layer in enumerate(model.xyz_layers):
        if i in model.skips:
            h = torch.cat([xe, h], -1)
        h = torch.relu(dense(layer, h))
    sigma = dense(model.sigma, h)
    if sigma_only:
        return sigma
    fin = dense(model.xyz_final, h)
    d = torch.relu(dense(model.dir_layer,
                         torch.cat([fin, x[:, 63:90].double()], -1)))
    return torch.cat([torch.sigmoid(dense(model.rgb, d)), sigma], -1)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max, mean) over the columns of ``ref`` of |out - ref| / std(ref)."""
    err = (out[:, :ref.shape[1]].double() - ref.double()).abs()
    std = ref.double().std(dim=0)
    return (float((err.amax(dim=0) / std).max()),
            float((err.mean(dim=0) / std).max()))


def check_wide_forward(gen, dev) -> dict:
    """Kernel G against its plain version at every width it is built for,
    rgb and sigma-only, at a ragged P, under ``TOL_G``, with controls that
    the limits must fail."""
    import copy

    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_rel = {torch.bfloat16: (0.0, 0.0), torch.float32: (0.0, 0.0)}
    x90 = random_embedded(gen, WIDE_P, dev)
    x63 = x90[:, :63].contiguous()
    for width, dtypes in WIDE_WIDTHS:
        model = spread_model(width, dev)
        layer5 = copy.deepcopy(model)
        layer5.xyz_layers[5].w.mul_(1.01)
        head = copy.deepcopy(model)
        head.dir_layer.w[:, width // 2 - 64:].mul_(1.01)
        for dtype in dtypes:
            tol_max, tol_mean = TOL_G[dtype]
            for sigma_only, x in ((True, x63), (False, x90)):
                live = 1 if sigma_only else 4
                out = fm.fused_nerf_apply_cuda(model, x, sigma_only, dtype)
                ref = fm.fused_nerf_apply_plain(model, x, sigma_only, dtype)
                torch.cuda.synchronize()
                rel = rel_err(out, ref[:, :live])
                order = rel_err(ref, plain_f64(model, x, sigma_only, dtype))
                controls = {"layer 5 x 1.01": fm.fused_nerf_apply_plain(
                    layer5, x, sigma_only, dtype)}
                if not sigma_only:
                    controls["dir head's last 64 columns x 1.01"] = \
                        fm.fused_nerf_apply_plain(head, x, sigma_only, dtype)
                if dtype == torch.bfloat16:
                    controls["plain in float32"] = fm.fused_nerf_apply_plain(
                        model, x, sigma_only, torch.float32)
                name = str(dtype).replace("torch.", "")
                mode = "sigma-only" if sigma_only else "rgb"
                log(f"[G W={width} {name} {mode}] P={WIDE_P} x "
                    f"{tuple(x.shape)} |err|/std max {rel[0]:.3e} mean "
                    f"{rel[1]:.3e} (tol {tol_max:.0e}, {tol_mean:.0e}); "
                    f"float64 sums vs float32 in the plain version "
                    f"{order[0]:.3e} / {order[1]:.3e}; max_abs_err "
                    f"{max_abs(out, ref):.3e}, column std "
                    + " ".join(f"{float(s):.3f}"
                               for s in ref[:, :live].std(dim=0)))
                if (not torch.isfinite(out).all()
                        or not torch.equal(out[:, live:], ref[:, live:])
                        or not rel[0] <= tol_max or not rel[1] <= tol_mean):
                    raise AssertionError(f"kernel G W={width} {name} {mode} "
                                         "disagrees with its plain version")
                for label, c in controls.items():
                    c_rel = rel_err(out, c[:, :live])
                    log(f"[G W={width} {name} {mode} control: {label}] "
                        f"|err|/std max {c_rel[0]:.3e} mean {c_rel[1]:.3e}")
                    if c_rel[0] <= tol_max and c_rel[1] <= tol_mean:
                        raise AssertionError(
                            f"kernel G W={width} {name} {mode}: the control "
                            f"'{label}' passes the limits, so they cannot "
                            "fail a wrong kernel")
                worst[dtype] = max(worst[dtype], max_abs(out, ref))
                worst_rel[dtype] = tuple(map(max, worst_rel[dtype], rel))
        del model, layer5, head
    return dict(err=worst[torch.bfloat16], err_f32=worst[torch.float32],
                rel=worst_rel[torch.bfloat16], rel_f32=worst_rel[torch.float32])


def time_wide_forward(gen, dev) -> dict:
    """Kernel G at W = 512 in bf16 (rgb) at the training step's fine pass
    (786,432 points) and at one serve chunk (32,000 rays x 192): kernel time,
    the bound, and at 786,432 points the plain version, the bf16 matmul
    chain and the posenc + NeRF route (bf16 operands, f32 products)."""
    from nerf_pl_tpu_torch.models.embedding import posenc
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    bf = torch.bfloat16
    model = wide_model(WIDE_W, dev)
    macs = mlp_macs(WIDE_W)
    rows = {}
    for name, P in (("train", TRAIN_BATCH * (N_SAMPLES + N_IMPORTANCE)),
                    ("serve", CHUNK_RAYS * (N_SAMPLES + N_IMPORTANCE))):
        xr = random_raw_t(gen, P, dev)
        x = torch.cat([posenc(xr[:3].T, 10), posenc(xr[3:6].T, 4)],
                      -1).contiguous()
        ms = cuda_ms(lambda: fm.fused_nerf_apply_cuda(model, x, False, bf),
                     iters=3 if name == "train" else 2)
        b, by = bound_ms(P * (90 * 4 + 8 * 4), 2 * macs * P, BF16_TENSOR_FLOPS)
        row = dict(P=P, ms=ms, bound_ms=b, bound_by=by)
        if name == "train":
            row["plain_ms"] = cuda_ms(lambda: fm.fused_nerf_apply_plain(
                model, x, False, bf), iters=1)
            del x
            torch.cuda.empty_cache()

            def posenc_nerf():
                emb = torch.cat([posenc(xr[:3].T, 10), posenc(xr[3:6].T, 4)],
                                -1)
                return model(emb, compute_dtype=bf)
            with torch.no_grad():
                row["posenc_nerf_ms"] = cuda_ms(posenc_nerf, iters=2)
            row["matmul_chain_fwd_ms"], _ = matmul_chain_ms(model, P, dev,
                                                            backward=False)
        log(f"[G time W={WIDE_W} bf16 rgb {name}] P={P} kernel {ms:.3f} ms, "
            f"bound {b:.3f} ms ({by}, {2 * macs * P:.3e} FLOP)"
            + ("" if name != "train" else
               f", plain {row['plain_ms']:.3f} ms, posenc + NeRF.forward "
               f"(bf16 operands, f32 products) {row['posenc_nerf_ms']:.3f} "
               f"ms, bf16 matmul chain forward "
               f"{row['matmul_chain_fwd_ms']:.3f} ms"))
        rows[name] = row
        del xr
        torch.cuda.empty_cache()
    return rows


def view_rays(wh: int, device, eye=(2.5, 1.0, 3.0)) -> torch.Tensor:
    """One wh x wh view of the origin (the Blender camera angle), rays
    [o, d, near 2, far 6]."""
    from nerf_pl_tpu_torch.models.camera import c2w_from_lookat
    from nerf_pl_tpu_torch.ops.ray_utils import get_ray_directions, get_rays

    c2w = torch.from_numpy(c2w_from_lookat(
        np.asarray(eye, np.float32), np.zeros(3, np.float32))[:3, :4])
    focal = 0.5 * wh / np.tan(0.5 * 0.6911)
    o, d = get_rays(get_ray_directions(wh, wh, focal, device="cpu"), c2w)
    nf = torch.ones((o.shape[0], 1))
    return torch.cat([o, d, 2.0 * nf, 6.0 * nf], -1).to(device)


def write_wide_checkpoint(path: str, width: int, seed: int) -> None:
    """Seeded coarse and fine models at ``width`` (seeds ``seed`` and
    ``seed + 1``), the sigma head scaled as ``write_checkpoint`` scales it,
    written with the port's codec."""
    from nerf_pl_tpu_torch.models.nerf import init_nerf
    from nerf_pl_tpu_torch.training.checkpoints import save_checkpoint

    models = {}
    for k, name in enumerate(("coarse", "fine")):
        m = init_nerf(torch.Generator().manual_seed(seed + k), W=width,
                      device="cpu")
        with torch.no_grad():
            m.sigma.w.mul_(40.0)
        models[name] = m
    save_checkpoint(path, {"params": models, "step": 0, "epoch": 0})


def require_content(label: str, out: dict) -> None:
    """A render of a random checkpoint holds something besides the white
    background, so comparing two of them can fail."""
    rgb, opacity = out["rgb_fine"], out["opacity_fine"]
    log(f"[{label}] rgb mean {float(rgb.mean()):.4f} min "
        f"{float(rgb.min()):.4f}, opacity mean {float(opacity.mean()):.4f}")
    if not float(rgb.min()) < 0.9:
        raise AssertionError(f"{label}: the render is blank")


def wide_render(tmp: str) -> dict:
    """The wide path end to end: ``render_image`` of one 200x200 view of a
    W = 512 checkpoint (``load_models`` reads the width) at 64 + 128 samples
    in bf16, through kernel G (``use_fused=True, fused_wide_infer=True``:
    2 launches a chunk) and through posenc + NeRF (``fused_wide_infer=False``:
    none), compared; then 256 rays of a W = 384 checkpoint in float32 through
    G on the card and the plain version on the CPU."""
    from nerf_pl_tpu_torch.tools.evaluate import load_models
    from nerf_pl_tpu_torch.tools.render import render_image

    ckpt = os.path.join(tmp, "wide512.ckpt")
    write_wide_checkpoint(ckpt, WIDE_W, seed=0)
    models = load_models(ckpt, "cuda")
    if models["fine"].width != WIDE_W:
        raise AssertionError(f"load_models read W={models['fine'].width}")
    rays = view_rays(WIDE_RENDER_WH, "cuda")
    kw = dict(chunk=WIDE_CHUNK, N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
              perturb=0.0, noise_std=0.0, white_back=True, test_time=True,
              use_fused=True, compute_dtype=torch.bfloat16)
    runs = {}
    for wide in (True, False):
        render_image(models, rays[:WIDE_CHUNK], None,
                     **kw, fused_wide_infer=wide)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = render_image(models, rays, None, **kw, fused_wide_infer=wide)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        rgb = out["rgb_fine"]
        if not torch.isfinite(rgb).all() or rgb.shape != (rays.shape[0], 3):
            raise AssertionError(f"wide render: {tuple(rgb.shape)}, finite "
                                 f"{bool(torch.isfinite(rgb).all())}")
        require_content(f"W={WIDE_W} view", out)
        runs[wide] = dict(rgb=rgb, wall=wall, counts=counts,
                          rays_per_s=rays.shape[0] / wall)
        label = "G (fused_wide_infer=True)" if wide else \
            "posenc + NeRF (fused_wide_infer=False)"
        log(f"[wide render {label}] W={WIDE_W} {WIDE_RENDER_WH}^2, "
            f"{N_SAMPLES}+{N_IMPORTANCE} samples, bf16, chunk {WIDE_CHUNK}: "
            f"{wall:.3f} s, {rays.shape[0] / wall:.1f} rays/s; launches "
            f"{counts}")
    n_chunks = -(-rays.shape[0] // WIDE_CHUNK)
    if runs[True]["counts"]["G"] != 2 * n_chunks:
        raise AssertionError(f"the wide render launched G "
                             f"{runs[True]['counts']['G']} times, not 2 per "
                             f"chunk ({n_chunks} chunks)")
    if runs[False]["counts"]["G"]:
        raise AssertionError("fused_wide_infer=False launched kernel G")
    d = (runs[True]["rgb"] - runs[False]["rgb"]).abs()
    err, mean = float(d.max()), float(d.mean())
    log(f"[wide render] G vs posenc + NeRF, rgb_fine: max_abs_err {err:.3e} "
        f"mean {mean:.3e} (tol {TOL_WIDE_RENDER[0]:.0e}, "
        f"{TOL_WIDE_RENDER[1]:.0e}); image mean "
        f"{float(runs[True]['rgb'].mean()):.4f}")
    if not (err <= TOL_WIDE_RENDER[0] and mean <= TOL_WIDE_RENDER[1]):
        raise AssertionError("the wide render through G departs from posenc "
                             "+ NeRF")

    ckpt384 = os.path.join(tmp, "wide384.ckpt")
    write_wide_checkpoint(ckpt384, 384, seed=8)
    imgs, f32_counts = {}, None
    for device in ("cuda", "cpu"):
        m384 = load_models(ckpt384, device)
        reset_counts()
        out = render_image(m384, view_rays(16, device), None,
                           **dict(kw, compute_dtype=torch.float32),
                           fused_wide_infer=True)
        imgs[device] = out["rgb_fine"].cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            f32_counts = read_counts()
        require_content(f"W=384 view on {device}", out)
    d = (imgs["cuda"] - imgs["cpu"]).abs()
    err384, mean384 = float(d.max()), float(d.mean())
    log(f"[wide render W=384 f32 card vs cpu] 256 rays, max_abs_err "
        f"{err384:.3e} tol={TOL_F32_RENDER:.0e}, mean {mean384:.3e} "
        f"tol={TOL_F32_RENDER_MEAN:.0e}; card launches {f32_counts}")
    if f32_counts["G"] < 2:
        raise AssertionError("the W=384 f32 render did not take kernel G")
    if not (torch.isfinite(imgs["cuda"]).all() and err384 <= TOL_F32_RENDER
            and mean384 <= TOL_F32_RENDER_MEAN):
        raise AssertionError("the W=384 f32 render disagrees with the CPU")
    res = {k: dict(wall=v["wall"], rays_per_s=v["rays_per_s"],
                   counts=v["counts"]) for k, v in runs.items()}
    return dict(wide=res[True], posenc_nerf=res[False], err=err, mean=mean,
                err_f32_384=err384, chunks=n_chunks)


def check_wide_backward(model, gen, dev) -> dict:
    """Kernel H against its plain version at W = 256 (the checkpoint's fine
    model), bf16 and f32, rgb on (P, 90) rows and sigma-only on (P, 63), at
    a P that spans two of the backward's point chunks: dx and every weight
    and bias grad, per tensor, under TOL_TRAIN.  Then its time at 786,432
    points beside F, and the autograd route of ``fused_nerf_apply``."""
    from nerf_pl_tpu_torch.ops import fused_mlp as fm

    P = fm.BWD_CHUNK + (1 << 16) + 77
    names = ["dx"] + grad_names(model)
    x90 = random_embedded(gen, P, dev)
    x63 = x90[:, :63].contiguous()
    g = torch.randn((P, 8), generator=gen).to(dev)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for sigma_only, x in ((False, x90), (True, x63)):
            mode = "sigma-only" if sigma_only else "rgb"
            gg = g.clone()
            gg[:, 1 if sigma_only else 4:] = 0.0  # what fused_nerf_apply drops
            dx, dw, db = fm.fused_nerf_bwd_dx_cuda(model, x, gg, sigma_only,
                                                   dtype)
            rdx, rw, rb = fm.fused_nerf_bwd_dx_plain(model, x, gg, sigma_only,
                                                     dtype)
            torch.cuda.synchronize()
            s = check_grads(f"H {dname} {mode} P={P} x {tuple(x.shape)}",
                            [dx] + fm.unpack_grads(model, dw, db, dtype),
                            [rdx] + fm.unpack_grads(model, rw, rb, dtype),
                            names, TOL_TRAIN[dtype])
            if dtype == torch.bfloat16:
                if s["mean_rel"] >= worst.get("mean_rel", 0.0):
                    worst["mean_name"] = f"{s['mean_name']} ({mode})"
                for k in ("max_rel", "mean_rel", "max_abs"):
                    worst[k] = max(worst.get(k, 0.0), s[k])
            del dx, dw, db, rdx, rw, rb
    del x90, x63, g
    torch.cuda.empty_cache()

    bf = torch.bfloat16
    Pt = TRAIN_BATCH * (N_SAMPLES + N_IMPORTANCE)
    xr = random_raw_t(gen, Pt, dev)
    x = random_embedded(gen, Pt, dev)
    g8 = torch.randn((Pt, 8), generator=gen).to(dev)
    g8[:, 4:] = 0.0
    h_ms = cuda_ms(lambda: fm.fused_nerf_bwd_dx_cuda(model, x, g8, False, bf),
                   iters=2)
    f_ms = cuda_ms(lambda: fm.fused_nerf_bwd_remat_cuda(
        model, xr, g8.T.contiguous(), False, bf), iters=2)
    h_plain = cuda_ms(lambda: fm.fused_nerf_bwd_dx_plain(model, x, g8, False,
                                                         bf), iters=1)
    flop = 2 * (3 * MACS_RGB + 35_712) * Pt
    b, by = bound_ms(Pt * (90 * 4 * 2 + 8 * 4) + 4 * 593_408, flop,
                     BF16_TENSOR_FLOPS)
    chain_fwd, chain_bwd = matmul_chain_ms(model, Pt, dev)
    log(f"[H time bf16 rgb] P={Pt} kernel {h_ms:.3f} ms (F {f_ms:.3f} ms), "
        f"plain {h_plain:.3f} ms, bound {b:.3f} ms ({by}, {flop:.3e} FLOP); "
        f"bf16 matmul chain backward {chain_bwd:.3f} ms")
    del xr, g8
    torch.cuda.empty_cache()

    # the autograd route: fused_nerf_apply with x requiring grad
    xg = x[:TRAIN_BATCH * N_SAMPLES].clone().requires_grad_(True)
    torch.cuda.synchronize()
    reset_counts()
    with torch.enable_grad():
        out = fm.fused_nerf_apply(model, xg, False, bf)
        out.square().mean().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[fused_nerf_apply autograd W=256] {xg.shape[0]} points, forward + "
        f"backward: launches {counts}; dx finite "
        f"{bool(torch.isfinite(xg.grad).all())}")
    if counts["G"] != 1 or counts["H"] != 1:
        raise AssertionError(f"fused_nerf_apply's autograd did not take G and "
                             f"H: {counts}")
    if xg.grad is None or not torch.isfinite(xg.grad).all():
        raise AssertionError("fused_nerf_apply gave no finite dx")
    del x, xg
    torch.cuda.empty_cache()
    log(f"[bf16 mean H] worst rel mean {worst['mean_rel']:.3e} on "
        f"{worst['mean_name']} (tol {TOL_TRAIN[bf][1]:.0e})")
    return dict(err=worst["max_abs"], max_rel=worst["max_rel"],
                mean_rel=worst["mean_rel"], mean_name=worst["mean_name"],
                P=Pt, ms=h_ms, F_ms=f_ms,
                plain_ms=h_plain, bound_ms=b, bound_by=by,
                matmul_chain_bwd_ms=chain_bwd, counts=counts)


def chain_sass() -> dict:
    """Kernel I's built library read back with ``cuobjdump -sass``: the
    counts of warpgroup products (HGMMA) and TMA tile loads (UTMALDG),
    which its design needs; none of either fails."""
    from nerf_pl_tpu_torch.ops import native

    cuobjdump = os.path.join(os.path.dirname(native.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(native.library_path("chain_probe"))],
        check=True, capture_output=True, text=True, timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"[I sass] cuobjdump -sass of chain_probe: {counts}")
    if not all(counts.values()):
        raise AssertionError(f"kernel I was not built on wgmma and TMA: "
                             f"{counts}")
    return counts


def check_chain(dev) -> dict:
    """Kernel I against its plain version, pure and fancy, at 786,432 rows
    and at two ragged P (past the last full tile, and under one tile): the
    error relative to max |plain|; its SASS (wgmma and TMA); the kernel's
    time and TFLOP/s in turns with the same eight products as bf16
    torch.matmul calls (cuBLAS: library, kernel, kernel, library), and the
    plain version's."""
    from nerf_pl_tpu_torch.scripts import kernel_probe as kp

    sass = chain_sass()
    P = TRAIN_BATCH * (N_SAMPLES + N_IMPORTANCE)
    errs = {}
    for rows in (P, P + 37, 37):
        x, w0, w = kp.probe_inputs(rows, dev)
        for fancy in (False, True):
            mode = "fancy" if fancy else "pure"
            out = kp.chain_cuda(x, w0, w, fancy)
            ref = kp.chain_plain(x, w0, w, fancy)
            torch.cuda.synchronize()
            rel, mean = rel_errs(out, ref)
            log(f"[I {mode} P={rows}] rel max err {rel:.3e} rel mean "
                f"{mean:.3e} (tol {TOL_CHAIN[0]:.0e}, {TOL_CHAIN[1]:.0e})")
            if not (torch.isfinite(out).all() and rel <= TOL_CHAIN[0]
                    and mean <= TOL_CHAIN[1]):
                raise AssertionError(f"kernel I ({mode}, P={rows}) disagrees "
                                     "with its plain version")
            errs[(mode, rows)] = (rel, mean, max_abs(out, ref))
        del x, w0, w, out, ref
    x, w0, w = kp.probe_inputs(P, dev)
    flop = P * kp.CHAIN_FLOP_PER_ROW
    b, by = bound_ms(P * (128 * 4 * 2), flop, BF16_TENSOR_FLOPS)
    lib1 = cuda_ms(lambda: kp.chain_matmul(x, w0, w), iters=10)
    k1 = cuda_ms(lambda: kp.chain_cuda(x, w0, w), iters=10)
    k2 = cuda_ms(lambda: kp.chain_cuda(x, w0, w), iters=10)
    lib2 = cuda_ms(lambda: kp.chain_matmul(x, w0, w), iters=10)
    ms, lib_ms = (k1 + k2) / 2, (lib1 + lib2) / 2
    fancy_ms = cuda_ms(lambda: kp.chain_cuda(x, w0, w, True), iters=10)
    plain = cuda_ms(lambda: kp.chain_plain(x, w0, w), iters=2)
    plain_fancy = cuda_ms(lambda: kp.chain_plain(x, w0, w, True), iters=2)
    log(f"[I time P={P}] pure: cuBLAS chain (8 bf16 torch.matmul calls) "
        f"{lib1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, cuBLAS chain "
        f"{lib2:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, cuBLAS "
        f"{flop / lib_ms / 1e9:.1f}); fancy {fancy_ms:.4f} ms; plain "
        f"{plain:.4f} / {plain_fancy:.4f} ms; bound {b:.4f} ms ({by})")
    rows = {}
    for mode, k_ms, p_ms in (("pure", ms, plain),
                             ("fancy", fancy_ms, plain_fancy)):
        rel, mean, mabs = errs[(mode, P)]
        rows[mode] = dict(ms=k_ms, plain_ms=p_ms, rel=rel, mean_rel=mean,
                          max_abs=max(errs[(mode, r)][2] for r in
                                      (P, P + 37, 37)),
                          tflops=flop / k_ms / 1e9)
    return dict(P=P, rows=rows, library_ms=lib_ms, turns=[lib1, k1, k2, lib2],
                bound_ms=b, bound_by=by, sass=sass,
                ragged_rel={f"{m} P={r}": errs[(m, r)][:2]
                            for (m, r) in errs if r != P})


def run_probe() -> dict:
    """``python -m nerf_pl_tpu_torch.scripts.kernel_probe`` as a
    subprocess; its lines are printed and its launch counts read from its
    last line."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "nerf_pl_tpu_torch.scripts.kernel_probe"],
        capture_output=True, text=True, timeout=PROBE_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in res.stdout.splitlines():
        log(f"[probe] {line}")
    if res.returncode != 0:
        raise AssertionError(f"kernel_probe failed ({res.returncode}): "
                             f"{res.stderr[-2000:]}")
    launches = json.loads(res.stdout.strip().splitlines()[-1])["launches"]
    for k in ("I", "G", "C'", "F'", "D'", "E'"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"the probe did not launch kernel {k}")
    log(f"[probe] {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 7
# The flagship shadow trainer at launchers/efficient_sm_64.sh's flags: the
# reference NeRF at full width, sigma-only, 64x64 views, 64 + 64 samples,
# batch 1,024, the light view re-rendered with grad every step with 32 fine
# samples, float32.  The synthetic shadow scene at 64x64: 20 train views
# (81,920 rays, 80 steps an epoch) and 1 val view.
SHADOW_WH, SHADOW_VIEWS, SHADOW_BATCH, SHADOW_LIGHT_N = 64, 20, 1024, 32
SHADOW_SAMPLES = 64  # --N_samples and --N_importance
SHADOW_FLAGS = ["--dataset_name", "efficient_sm", "--img_wh", "64", "64",
                "--N_samples", str(SHADOW_SAMPLES),
                "--N_importance", str(SHADOW_SAMPLES), "--noise_std",
                "0", "--batch_size", str(SHADOW_BATCH), "--optimizer", "adam",
                "--lr", "1e-5", "--Light_N_importance", str(SHADOW_LIGHT_N),
                "--shadow_method", "shadow_method_2"]
# one grad_on_light step: camera and light, each a coarse and a fine pass
# through D and E, and one importance sampling (A) each
SHADOW_STEP_LAUNCHES = {"A": 2, "B": 0, "C": 0, "D": 4, "E": 4}


def trainer_fit(tmp: str, cli: str, root: str, name: str, flags: list,
                epochs: int, tag: str) -> dict:
    """``python -m nerf_pl_tpu_torch.<cli>`` on the card with ``flags``;
    launches in the fit, the epochs' losses (finite) and other train
    metrics, and camera rays/s (the camera rays of the epoch's steps over
    its wall time)."""
    import importlib

    module = importlib.import_module(f"nerf_pl_tpu_torch.{cli}")
    argv = ["--root_dir", root, *flags, "--num_epochs", str(epochs),
            "--exp_name", name, "--log_dir", os.path.join(tmp, "logs"),
            "--ckpt_dir", os.path.join(tmp, "ckpts"), "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    system = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(tmp, "logs", name, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs_ = [r for r in recs if "train/loss" in r]
    losses = [r["train/loss"] for r in epochs_]
    rates = [r["train/rays_per_s"] for r in epochs_]
    vals = [r["val/loss"] for r in recs if "val/loss" in r]
    others = {k: [r[k] for r in epochs_] for k in sorted(epochs_[0])
              if k.startswith("train/") and k not in
              ("train/loss", "train/rays_per_s")} if epochs_ else {}
    log(f"[{tag}] {name} ({' '.join(flags)}): {system.steps_per_epoch} "
        f"steps/epoch, loss per epoch {losses}, {others}, val loss {vals}; "
        f"camera rays/s per epoch {[round(r, 1) for r in rates]}; fit "
        f"{wall:.1f} s wall; launches in the fit {counts}")
    if len(losses) != epochs or not all(np.isfinite(losses + vals)):
        raise AssertionError(f"{tag} fit {name}: losses not finite: "
                             f"{losses} {vals}")
    n_ckpt = require_checkpoints(os.path.join(tmp, "ckpts", name), tag)
    log(f"[{tag}] {name}: {n_ckpt} checkpoint(s) on disk and loading when "
        "fit returned (written by the background writer)")
    return dict(system=system, counts=counts, losses=losses,
                rays_per_s=rates, vals=vals, wall_s=wall, checkpoints=n_ckpt)


def shadow_fit(tmp: str, root: str, name: str, extra: list,
               epochs: int) -> dict:
    """``python -m nerf_pl_tpu_torch.train_efficient_sm`` with
    ``SHADOW_FLAGS`` and ``extra``."""
    return trainer_fit(tmp, "train_efficient_sm", root, name,
                       SHADOW_FLAGS + extra, epochs, "shadow")


def step_draws(gen, rows: int, n_importance: int) -> dict:
    return {"perturb_rand": torch.rand((rows, SHADOW_SAMPLES), generator=gen),
            "u": torch.rand((rows, n_importance), generator=gen),
            "jitter": torch.rand((rows, n_importance), generator=gen)}


def trainer_grads_card_vs_cpu(tmp: str, tag: str, cls_name: str,
                              flags: list, draws: dict, run,
                              tol: tuple = TOL_STEP_GRADS) -> float:
    """One float32 step's grads on the card and on the CPU: the same
    weights (the seed), batch and injected draws, on phase 7's 16x16 scene
    (2 train views, written by ``shadow_step_grads_card_vs_cpu``) so the
    CPU's step is short.  ``run(system, overrides)``
    takes the step and may return tensors whose entries that differ between
    the two devices are counted and logged."""
    from nerf_pl_tpu_torch.config import get_opts
    from nerf_pl_tpu_torch.training import shadow_systems

    root = os.path.join(tmp, "shadow_small")
    grads, extra = {}, {}
    for device in ("cuda", "cpu"):
        cfg = get_opts(["--root_dir", root, *flags, "--img_wh", "16", "16",
                        "--exp_name", f"grads_{tag}_{device}",
                        "--log_dir", os.path.join(tmp, "logs"),
                        "--ckpt_dir", os.path.join(tmp, "ckpts")])
        system = getattr(shadow_systems, cls_name)(cfg, device=device)
        out = run(system, {key: {k: v.to(device) for k, v in d.items()}
                           for key, d in draws.items()})
        extra[device] = out if isinstance(out, dict) else {}
        grads[device] = {f"{name}/{k}": (p.grad if p.grad is not None else
                                         torch.zeros_like(p)).cpu()
                         for name, m in system.models.items()
                         for k, p in m.named_parameters()}
        system.logger.close()
    for k, v in extra["cpu"].items():
        a = extra["cuda"][k].cpu()
        differ = int((a != v).sum())
        gap = (f", max |diff| {float((a - v).abs().max()):.3e}"
               if v.is_floating_point() else "")
        log(f"[{tag}] {k}: {differ} of {v.numel()} differ between the card "
            f"and the CPU{gap}")
    names = sorted(grads["cpu"])
    return check_grads(f"f32 {tag} step grads card vs cpu (16x16 scene)",
                       [grads["cuda"][k] for k in names],
                       [grads["cpu"][k] for k in names], names,
                       tol)["max_rel"]


def shadow_step_grads_card_vs_cpu(tmp: str) -> float:
    """One float32 grad_on_light step's grads on the card and on the CPU, on
    a 16x16 scene (256 camera rays, 256 light rays) this writes."""
    from nerf_pl_tpu_torch.data.synthetic import generate_scene

    generate_scene(os.path.join(tmp, "shadow_small"), img_wh=16, n_train=2,
                   n_val=1, n_test=0)
    n, L = 256, SHADOW_LIGHT_N
    gen = torch.Generator().manual_seed(4)
    return trainer_grads_card_vs_cpu(
        tmp, "shadow", "EfficientSMSystem",
        SHADOW_FLAGS + ["--batch_size", str(n), "--grad_on_light"],
        {"cam": step_draws(gen, n, SHADOW_SAMPLES),
         "light": step_draws(gen, n, L)},
        lambda s, ov: s.train_step(*(t[:n] for t in (s.rays, s.rgbs, s.pixels,
                                                     s.pose_idx)),
                                   s.empty_light_cache(), L, overrides=ov))


def f32_step_kernels(tag: str, prof: dict, passes: list,
                     bwd_passes: list | None = None) -> dict:
    """Kernels D and E in float32 over one step's fused-MLP passes
    (``passes``: (points, rgb) of each forward; ``bwd_passes`` those
    differentiated, all by default), device time from the profile beside
    the bound: D writes the stash (2,432 f32 values an rgb point, 2,048
    sigma-only), E reads it; 2 FLOP a multiply-add forward, 4 backward
    (dgrad and wgrad)."""
    rows = {}
    for key, names, flop, runs in (
            ("D", ("fused_nerf_fwd_kernel",), 2, passes),
            ("E", ("fused_nerf_dgrad_kernel", "fused_nerf_wgrad_kernel",
                   "reduce_rows_kernel"), 4, bwd_passes or passes)):
        P = sum(n for n, _ in runs)
        io = sum(n * (8 * 4 + (16 if rgb else 4) + (2432 if rgb else 2048) * 4)
                 for n, rgb in runs)
        macs = sum(n * (MACS_RGB if rgb else MACS_SIGMA) for n, rgb in runs)
        ms = sum(v for k, v in (prof.get("by_kernel") or {}).items()
                 if any(n in k for n in names))
        b, by = bound_ms(io, flop * macs, F32_FLOPS)
        rows[key] = dict(P=P, device_ms=ms, bound_ms=b, bound_by=by)
        log(f"[{tag}] kernel {key} in float32, one step's {len(runs)} "
            f"launches over {P:,} points: {ms:.3f} ms of device time, bound "
            f"{b:.3f} ms ({by})")
    return rows


def shadow_f32_kernels(prof: dict, system) -> dict:
    """D and E over one grad_on_light step: the camera batch's coarse and
    fine passes and the whole light view's, all sigma-only."""
    S, hw = SHADOW_SAMPLES, system.light_rays.shape[0]
    return f32_step_kernels("shadow", prof, [
        (SHADOW_BATCH * S, False), (SHADOW_BATCH * 2 * S, False),
        (hw * S, False), (hw * (S + SHADOW_LIGHT_N), False)])


def shadow_end_to_end(tmp: str) -> dict:
    """The shadow trainer: a 2-epoch float32 fit at the launcher's flags, a
    1-epoch bf16 fit, a 2-epoch fit through the no-grad light cache (kernel
    C; ``--sample_light_depth_every 4`` at lr 5e-4, whose loss must fall
    from epoch to epoch); one step's launches, synchronising calls and
    profile; one f32 step's grads on the card against the CPU."""
    from nerf_pl_tpu_torch.data.synthetic import generate_scene

    t0 = time.perf_counter()
    root = os.path.join(tmp, "shadow_scene")
    generate_scene(root, img_wh=SHADOW_WH, n_train=SHADOW_VIEWS, n_val=1,
                   n_test=0)
    log(f"[shadow] scene: {SHADOW_VIEWS} train views + 1 val of "
        f"{SHADOW_WH}x{SHADOW_WH}, written in {time.perf_counter() - t0:.1f} s")
    fit = shadow_fit(tmp, root, "sm_f32", ["--grad_on_light"], 2)
    system = fit["system"]
    if system.steps_per_epoch != SHADOW_VIEWS * SHADOW_WH ** 2 // SHADOW_BATCH:
        raise AssertionError(f"steps per epoch {system.steps_per_epoch}")
    for k in ("A", "C", "D", "E"):
        if fit["counts"][k] < 1:
            raise AssertionError(f"kernel {k} was not launched by the fit")

    batch = tuple(t[:SHADOW_BATCH] for t in (system.rays, system.rgbs,
                                             system.pixels, system.pose_idx))
    cache = system.empty_light_cache()

    def step():
        return system.train_step(*batch, cache, SHADOW_LIGHT_N)

    torch.cuda.synchronize()
    reset_counts()
    step()
    torch.cuda.synchronize()
    per_step = read_counts()
    log(f"[shadow] launches in one grad_on_light step: {per_step}")
    if any(per_step[k] != v for k, v in SHADOW_STEP_LAUNCHES.items()):
        raise AssertionError(f"one shadow step launched {per_step}, expected "
                             f"{SHADOW_STEP_LAUNCHES}")
    calls = sync_calls(step)
    log(f"[shadow] one step under set_sync_debug_mode('warn'): "
        f"{sum(calls.values())} synchronising calls, by line: {calls}")
    prof = profile_device("one shadow step (f32, grad_on_light, 1,024 "
                          "camera rays + 4,096 light rays)", step, top=12)
    f32_step = shadow_f32_kernels(prof, system)
    del system, fit["system"]

    bf16 = shadow_fit(tmp, root, "sm_bf16",
                      ["--grad_on_light", "--compute_dtype", "bfloat16"], 1)
    del bf16["system"]
    cached = shadow_fit(tmp, root, "sm_cache",
                        ["--sample_light_depth_every", "4", "--lr", "5e-4"], 2)
    if not cached["losses"][1] < cached["losses"][0]:
        raise AssertionError(f"cache fit loss did not fall: {cached['losses']}")
    # a refresh at every 4th step (20 an epoch of 80 steps), a coarse and a
    # fine pass each; validation adds more
    passes = 2 * 2 * -(-cached["system"].steps_per_epoch // 4)
    if cached["counts"]["C"] < passes:
        raise AssertionError(f"the light cache took C {cached['counts']['C']}"
                             f" times, expected >= {passes}")
    del cached["system"]
    grads_err = shadow_step_grads_card_vs_cpu(tmp)
    seconds = time.perf_counter() - t0
    log(f"[shadow] phase 7: {seconds:.1f} s")
    return dict(counts=fit["counts"], per_step=per_step, syncs=calls,
                profile=prof, f32_step=f32_step, fit=fit, bf16=bf16,
                cache=cached,
                grads_err=grads_err, seconds=seconds)


# ---------------------------------------------------------------- phase 8
# The other four shadow trainers, at full width on phase 7's 64x64 scene (20
# train views, 1 val view), float32 unless named.  The joint RGB + shadow
# trainer at launchers/recipes.sh's rgb_sm_sigma_64 as written (batch 4,096:
# 20 steps an epoch of 786,432 rgb camera points and 655,360 sigma light
# points), and at launchers/rgb_sm_joint.sh's flags cut to 64x64 (no
# --grad_on_light: the light cache through kernel C, refreshed every step).
RGBSM_FLAGS = ["--dataset_name", "rgb_sm", "--N_importance", "64",
               "--N_samples", "64", "--img_wh", "64", "64", "--noise_std", "0",
               "--batch_size", "4096", "--optimizer", "adam", "--lr", "1e-5",
               "--num_sanity_val_steps", "1", "--Light_N_importance", "32",
               "--shadow_method", "shadow_method_2", "--grad_on_light"]
RGBSM_CACHE_FLAGS = ["--dataset_name", "rgb_sm", "--img_wh", "64", "64",
                     "--N_samples", "64", "--N_importance", "64",
                     "--batch_size", "1024", "--optimizer", "adam",
                     "--lr", "5e-4", "--rgb_weight", "1.0", "--sm_weight",
                     "1.0", "--blur", "2"]
# the image-space trainer at launchers/efficient_sm_64.sh's flags, one whole
# image a step (4,096 camera + 4,096 light rays, 1,572,864 sigma points)
SMAP_FLAGS = SHADOW_FLAGS + ["--dataset_name", "shadows", "--batch_size", "1"]
# the sampled-light trainer at efficient_sm_64.sh's flags: 1,024 camera rays
# and the 1,024 light rays through their projections a step
LS_FLAGS = SHADOW_FLAGS
# the vanilla RGB step on the shadows loader's rays
SHADOWS_FLAGS = ["--dataset_name", "shadows", "--img_wh", "64", "64",
                 "--N_samples", "64", "--N_importance", "64",
                 "--batch_size", "1024", "--lr", "5e-4"]
# launches in one step of each: a coarse and a fine pass of each
# differentiated render through D and E, one importance sampling (A) each.
# The sampled-light step reads only the fine depths of its two renders, and
# the coarse passes feed only the detached importance sampling: autograd
# never reaches their backward (the JAX step's coarse grads are 0 too,
# tests/test_torch_port_light_sampler.py), so E runs twice.
TRAINER_STEP_LAUNCHES = {
    "rgb_sm": {"A": 2, "B": 0, "C": 0, "D": 4, "E": 4},
    "shadow_mapping": {"A": 2, "B": 0, "C": 0, "D": 4, "E": 4},
    "light_sampler": {"A": 2, "B": 0, "C": 0, "D": 4, "E": 2},
    "shadows": {"A": 1, "B": 0, "C": 0, "D": 2, "E": 2},
}


def trainer_step(tag: str, step, passes: list, label: str,
                 bwd_passes: list | None = None) -> dict:
    """One step's launches (held to ``TRAINER_STEP_LAUNCHES``), its
    synchronising calls, its profile and f32 D and E beside their bounds."""
    torch.cuda.synchronize()
    reset_counts()
    step()
    torch.cuda.synchronize()
    per_step = read_counts()
    log(f"[{tag}] launches in one step: {per_step}")
    expected = TRAINER_STEP_LAUNCHES[tag]
    if any(per_step[k] != v for k, v in expected.items()):
        raise AssertionError(f"one {tag} step launched {per_step}, expected "
                             f"{expected}")
    calls = sync_calls(step)
    log(f"[{tag}] one step under set_sync_debug_mode('warn'): "
        f"{sum(calls.values())} synchronising calls, by line: {calls}")
    prof = profile_device(label, step, top=12)
    return dict(per_step=per_step, syncs=calls, profile=prof,
                f32_step=f32_step_kernels(tag, prof, passes, bwd_passes))


def trainers_end_to_end(tmp: str) -> dict:
    """The joint RGB + shadow trainer (2 epochs f32, 1 bf16 at the recipe's
    flags; 2 through the light cache, whose loss must fall), the
    image-space, the sampled-light and the RGB-on-shadow-data trainers (2
    epochs each), and ``EfficientSMSystem`` on a 64x64 ``pyredner2`` scene
    (1 epoch); for each new system one step's launches, synchronising calls
    and profile, and one float32 step's grads on the card against the CPU."""
    from nerf_pl_tpu_torch.data.synthetic import generate_pyredner_scene

    t0 = time.perf_counter()
    root = os.path.join(tmp, "shadow_scene")  # written by phase 7
    S, L = SHADOW_SAMPLES, SHADOW_LIGHT_N
    gen = torch.Generator().manual_seed(8)
    fits, steps, grads = {}, {}, {}

    # the joint RGB + shadow trainer
    fit = trainer_fit(tmp, "train_rgb_sm_juntos", root, "rgbsm_f32",
                      RGBSM_FLAGS, 2, "rgb_sm")
    system = fit["system"]
    B = 4096
    batch = tuple(getattr(system, k)[:B] for k in system.train_bufs)
    cache = system.empty_light_cache()
    hw = system.light_rays.shape[0]
    steps["rgb_sm"] = trainer_step(
        "rgb_sm", lambda: system.train_step(*batch, cache, L),
        [(B * S, True), (B * 2 * S, True), (hw * S, False),
         (hw * (S + L), False)],
        "one rgb_sm step (f32, grad_on_light, 4,096 camera rays in rgb_disp "
        "+ 4,096 light rays)")
    fits["rgb_sm"] = fit
    del system, batch, fit["system"]
    fits["rgb_sm_bf16"] = trainer_fit(
        tmp, "train_rgb_sm_juntos", root, "rgbsm_bf16",
        RGBSM_FLAGS + ["--compute_dtype", "bfloat16"], 1, "rgb_sm")
    del fits["rgb_sm_bf16"]["system"]
    cached = trainer_fit(tmp, "train_rgb_sm_juntos", root, "rgbsm_cache",
                         RGBSM_CACHE_FLAGS, 2, "rgb_sm")
    if not cached["losses"][1] < cached["losses"][0]:
        raise AssertionError(f"rgb_sm cache fit loss did not fall: "
                             f"{cached['losses']}")
    # a light refresh every step (sample_light_depth_every 1, no fine pass)
    if cached["counts"]["C"] < cached["system"].steps_per_epoch * 2:
        raise AssertionError(f"the rgb_sm light cache took C "
                             f"{cached['counts']['C']} times")
    del cached["system"]
    fits["rgb_sm_cache"] = cached

    # the image-space trainer
    fit = trainer_fit(tmp, "train_shadow_mapping", root, "smap_f32",
                      SMAP_FLAGS, 2, "shadow_mapping")
    system = fit["system"]
    idx = torch.zeros(1, dtype=torch.int64, device=system.device)
    hw = system.light_rays.shape[0]
    steps["shadow_mapping"] = trainer_step(
        "shadow_mapping", lambda: system.train_step(
            system.rays[idx], system.rgbs[idx], system.cam_ms[idx],
            system.cam_eyes[idx]),
        [(hw * S, False), (hw * 2 * S, False)] * 2,
        "one shadow_mapping step (f32, one 64x64 image + the light view)")
    fits["shadow_mapping"] = fit
    del system, fit["system"]

    # the sampled-light trainer
    fit = trainer_fit(tmp, "train_light_sampler", root, "ls_f32", LS_FLAGS, 2,
                      "light_sampler")
    system = fit["system"]
    B = SHADOW_BATCH
    batch = tuple(t[:B] for t in (system.rays, system.rgbs, system.pixels,
                                  system.pose_idx))
    steps["light_sampler"] = trainer_step(
        "light_sampler", lambda: system.train_step(*batch),
        [(B * S, False), (B * 2 * S, False), (B * S, False),
         (B * (S + L), False)],
        "one light_sampler step (f32, 1,024 camera + 1,024 light rays)",
        bwd_passes=[(B * 2 * S, False), (B * (S + L), False)])
    fits["light_sampler"] = fit
    del system, batch, fit["system"]

    # the RGB trainer on the shadows loader
    fit = trainer_fit(tmp, "train_shadows", root, "shadows_f32",
                      SHADOWS_FLAGS, 2, "shadows")
    system = fit["system"]
    rays, rgbs = system.rays[:SHADOW_BATCH], system.rgbs[:SHADOW_BATCH]
    steps["shadows"] = trainer_step(
        "shadows", lambda: system.train_step(rays, rgbs),
        [(SHADOW_BATCH * S, True), (SHADOW_BATCH * 2 * S, True)],
        "one shadows step (f32, 1,024 rays in rgb)")
    fits["shadows"] = fit
    del system, rays, rgbs, fit["system"]

    # EfficientSMSystem on the pyredner2 layout of the same scene
    proot = os.path.join(tmp, "pyredner_scene")
    generate_pyredner_scene(proot, img_wh=SHADOW_WH, n_train=SHADOW_VIEWS,
                            n_val=1, n_test=0)
    fits["pyredner2"] = trainer_fit(
        tmp, "train_efficient_sm", proot, "sm_pyredner2",
        SHADOW_FLAGS + ["--dataset_name", "pyredner2", "--grad_on_light"], 1,
        "pyredner2")
    del fits["pyredner2"]["system"]

    # one f32 step of each on the card against the CPU (16x16: 256 rays a
    # view, 256 light rays)
    n = 256
    grads["rgb_sm"] = trainer_grads_card_vs_cpu(
        tmp, "rgb_sm", "RGBSMSystem", RGBSM_FLAGS + ["--batch_size", str(n)],
        {"cam": step_draws(gen, n, S), "light": step_draws(gen, n, L)},
        lambda s, ov: s.train_step(*(getattr(s, k)[:n] for k in s.train_bufs),
                                   s.empty_light_cache(), L, overrides=ov))
    grads["shadow_mapping"] = trainer_grads_card_vs_cpu(
        tmp, "shadow_mapping", "ShadowMappingSystem", SMAP_FLAGS,
        {"cam": step_draws(gen, n, S), "light": step_draws(gen, n, S)},
        lambda s, ov: s.train_step(s.rays[:1], s.rgbs[:1], s.cam_ms[:1],
                                   s.cam_eyes[:1], overrides=ov))
    def light_sampler_run(s, ov):
        """The step, after the light pixels its projection picks (a floor:
        the card's and the CPU's can differ where a projection sits within
        rounding of a pixel's edge)."""
        from nerf_pl_tpu_torch.ops.rendering import render_rays
        from nerf_pl_tpu_torch.training.shadow_systems import ls_project

        pidx = s.pose_idx[:n]
        with torch.no_grad():
            cam = render_rays(s.models["coarse"], s.models["fine"],
                              s.rays[:n], None, overrides=ov["cam"], **s.rkw)
            _, ul, vl, _ = ls_project(
                cam, s.pixels[:n], s.cam_ms[pidx], s.cam_eyes[pidx],
                s.light_m, s.light_eye, *s.light_geom, (16, 16), True)
        s.train_step(s.rays[:n], s.rgbs[:n], s.pixels[:n], pidx, overrides=ov)
        return {"light pixels (ul, vl)": torch.stack([ul, vl]).cpu()}

    grads["light_sampler"] = trainer_grads_card_vs_cpu(
        tmp, "light_sampler", "LightSamplerSystem",
        LS_FLAGS + ["--batch_size", str(n)],
        {"cam": step_draws(gen, n, S), "light": step_draws(gen, n, L)},
        light_sampler_run)
    # noise 0 here (the fit draws it): a rounding-level difference can put
    # a point's sigma + noise on either side of the ReLU's 0, where the grad
    # jumps (tests/test_torch_port_shadows.py measured 3.4e-2 between JAX
    # and the port on the CPU for one set of draws)
    grads["shadows"] = trainer_grads_card_vs_cpu(
        tmp, "shadows", "ShadowsSystem",
        SHADOWS_FLAGS + ["--batch_size", str(n), "--noise_std", "0"],
        {"cam": step_draws(gen, n, S)},
        lambda s, ov: s.train_step(s.rays[:n], s.rgbs[:n], ov["cam"]))
    seconds = time.perf_counter() - t0
    log(f"[trainers] phase 8: {seconds:.1f} s")
    return dict(fits=fits, steps=steps, grads=grads, seconds=seconds)


# ---------------------------------------------------------------- phase 9
# LLFF forward-facing training and evaluation at launchers/llff_fern.sh's
# flags (full-width NeRF, f32, 64 + 64 samples, batch 1,024, adam, steplr
# 10 20 x 0.5) on a forward-facing synthetic scene at the recipe's
# --img_wh 504 378: 4 views, 3 train and the closest-to-centre val (cut from
# fern's 20 views and 30 epochs to 1 epoch: 558 steps).
LLFF_WH, LLFF_VIEWS, LLFF_BATCH, LLFF_SAMPLES = (504, 378), 4, 1024, 64
LLFF_FLAGS = ["--dataset_name", "llff", "--img_wh", "504", "378",
              "--N_samples", "64", "--N_importance", "64",
              "--batch_size", "1024", "--optimizer", "adam", "--lr", "5e-4",
              "--lr_scheduler", "steplr", "--decay_step", "10", "20",
              "--decay_gamma", "0.5"]
# the eval of the spiral at a third of the size (the same 4:3 aspect)
LLFF_TEST_WH = (168, 126)
# one step: a coarse and a fine pass through D and E, one importance
# sampling (A)
LLFF_STEP_LAUNCHES = {"A": 1, "B": 0, "C": 0, "D": 2, "E": 2}
# the ring scene of the spheric fit: 4 views of 84x63 (3 train: 15 steps)
LLFF_RING_WH = (84, 63)
# The optimisers and schedules on the card against the same steps on the
# CPU, per parameter relative to the rate: float32 products, sums,
# divisions and square roots round the same on both (each torch op apart,
# no contraction across them), so the trajectories may be bit-equal; the
# limit is the one the CPU tests hold the port to against optax
# (tests/test_torch_port_optim.py), in case a card kernel orders a sum
# otherwise.
TOL_OPTIM_CARD = 5e-5
# A small baseline JPEG written by Pillow (61x45, 4:2:0, quality 90, a
# restart interval of 4 MCUs), and the sha256 of Pillow's
# Image.open(p).convert("RGB") bytes of it: the card's machine has no PIL.
LLFF_JPEG_SHA256 = \
    "cb1ba2fd5a59674516a0a3bd7cb48e12f96d09a4d892a0ddcaf689663678c483"
LLFF_JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
    "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsN"
    "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/wAAR"
    "CAAtAD0DASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA"
    "AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK"
    "FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE"
    "hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/90ABAAE/9oADAMBAAIRAxEAPwD3rw38VrCVUaadTGwJYR/eVuQO"
    "Oo/DuceldFqPxRtpLVwZFJbncJM4OAO49R1Oa+JPDWuanCInEk5MQI2sep6EYPBwD0+taWqe"
    "INSaMgTlZHG0bXYFhwR2x1I68/Nznqfq8TwrhMFKylax+rZZwRQngU+Y998UfFix8wedtDKx"
    "xmXAZfXb9Qenf9fMLn4s2Zu2ZpI1xlSxfDE8dOPxxkk+leB+L/EOqBdy+bJ2/eIW3Z+bOT2G"
    "fTuOleX3HiDUob+RGaa4IyTuXiQHqcZ6Yz+A56V4GKyynVi1Geh/PvEvA1D607S3f9f1+R94"
    "aD8VrWOUhCp2j7q8ll3cE54z7fz4r03Q/ixbm2KO48yOILsJ2kgjoME5x0Iz3r88/C+uX9ze"
    "BZGkZFdeNzc9wQM8HHrg8/Q163o2o6oEjCozl1CMQhB2gkYyevGM9+Off8+rcEU8XVV5Xufr"
    "3BXBVCNJRvqfXer/ABJhuotkdwsb7mGJSpZuOnTr3x6EetcHqPxIsLibEiibZwPLyccDryOe"
    "3fpXguoapqsULHJAjYRqkbkDA5JGRn1HHv6ivPdX1/VGlwp+zlXdfk6EZ45/z1r9g4e8P6GH"
    "p8yfkePxrwTQ5lZn/9Dv9G+CYS3O6JAQmCydcgEggdsHPU8d+9WtR+DYlilBgG3G8gooHGSS"
    "Mnnj8SBXaaT4+sYoZQfKcZwVj44xz0zkdvqa09U8f2PktMSVkOQcjg8AdSTk8+3avy/PeKcz"
    "qVnGN/8Agn1mVZnnCy9N3vY+bPEXwRSWNcworIThsYc9c9AMcHP4+2a4A/BUMSFRI1O08Y2n"
    "6Z4xk/r9Cfo7xH4/s7iVEaVt4y4ckdh6ZIHTtz17iuKPjHTIpxKCPMRyMbQm8A7gCScZ6np2"
    "+td2TVs4xtpTTP514rznNli7RT/r+tDA8K/AuATIqQku2Tl1BU9CATzjk54BOQc8cV6xofwO"
    "jhgJ8o71wRwN6r1I9cAA/Tn8JPCvjfToJkk3oV+WQuMBfp6HgAcDr+FeraT48sUskUuu5lKs"
    "HG3ooC59x6ccj0r9BSzDDR5pdP8AgH6NwTnOcShFWZ5LrvwOEMJSRI5fLB+b+LgAbe3qcnPT"
    "vyK821f4KQi5zJCshI4JHzAds474I/yK+lNe+IVjINs00G1s/KCuB1zkjoTwfbg8da8l8T/E"
    "bTLm8V3jUvzuRECMpz3GOh7fjTXE2ZUI8qf+QuLMzzadSMZRf9fcvxP/0fLfD3j+9kiVY2dw"
    "6qVBIbcMdhjIPOc+vHStm98aX7L+488yrwcDJA28bTjuB3Hp0xXVeHvA2n3KRArt/dsxwOCP"
    "vYIzg9xn6enPRXHw702OygcqrBgoVdn3c4Pr/te3618jTq4SvilKcN2f0bgM0y1YD+H0/Q+f"
    "fEPjfUEd2jWfLr87Zbch54wOcHOSPQ9B348+O9SJiCidnz8jM+WXjvzjOOoz6Gve9T8B6ddg"
    "zFdm523oq4BIIGeMemecmuNn8B2f22KMyucyYLBFBO4Z9PU/5wMf0nw5Ry6hRUvZ6rX7j+Yu"
    "Lszy94x/u+vb+vwMjw94+vWdt8iRiTKjsCAPbpn5fTgc16Tpfjy+WEL5oXecqF7fMO47c+n8"
    "P4VS0XwJY+d95jujMgyo+UAfd/l+Vd5Y+A9PEW8ZDSKXbCgDgjAA/H+XpXg8T55gcLBxULei"
    "6n6twNjculTX7v8Ar+up514n+Id9duQ0hDAjLBwwbGR0xwcnocZ+leWa98RNRS/eNmndgcl1"
    "UPnOPUnA9PX2GBX0TrPgDT7sujgbFcgALz9evpj8vy8w1z4ZaezwAuHUKSDJCrNyfWvyOlm+"
    "GrVLuNkvI6eNcfl6slST12t6H//Z"
)


def llff_jpeg(tmp: str) -> dict:
    """The embedded JPEG through ``data/jpeg.py`` (its bytes' hash against
    Pillow's), then through ``LLFFDataset(split="val")`` as a one-image
    scene with a ``poses_bounds.npy`` written here; the host time of one
    decode."""
    import base64
    import hashlib

    from nerf_pl_tpu_torch.data import jpeg
    from nerf_pl_tpu_torch.data.jpeg import read_jpeg
    from nerf_pl_tpu_torch.data.llff import LLFFDataset

    root = os.path.join(tmp, "jpeg_scene")
    os.makedirs(os.path.join(root, "images"))
    path = os.path.join(root, "images", "000.jpg")
    with open(path, "wb") as f:
        f.write(base64.b64decode(LLFF_JPEG_B64))
    t0 = time.perf_counter()
    jpeg._native()  # the C++ stages' g++ build, timed apart from the decode
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, mode = read_jpeg(path)
    ms = 1e3 * (time.perf_counter() - t0)
    digest = hashlib.sha256(img.tobytes()).hexdigest()
    h, w = img.shape[:2]
    pose = np.concatenate([np.eye(3)[:, [1, 0, 2]] * [-1, 1, 1],
                           [[0.0], [0.0], [4.0]], [[h], [w], [50.0]]], 1)
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([pose.reshape(-1), [2.0, 6.0]])[None])
    val = LLFFDataset(root, split="val", img_wh=(w, h))[0]
    same = np.array_equal(np.round(val["rgbs"] * 255).astype(np.uint8),
                          img.reshape(-1, 3))
    log(f"[llff] JPEG {w}x{h} {mode} (4:2:0, restart interval): sha256 "
        f"{digest}, Pillow's {LLFF_JPEG_SHA256}: "
        f"{'equal' if digest == LLFF_JPEG_SHA256 else 'DIFFERENT'}; decode "
        f"{ms:.1f} ms on the host (the C++ stages built first, in "
        f"{build_s:.2f} s); the LLFF val loader's colours "
        f"{'equal' if same else 'DIFFER'}")
    if digest != LLFF_JPEG_SHA256 or mode != "RGB" or not same:
        raise AssertionError("the JPEG reader departs from Pillow's decode")
    return dict(ms=ms, digest=digest)


def png_unfilter_before(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """The PNG reader's unfiltering as it was before the wavefront (a Python
    loop over each byte of the Average and Paeth rows): the frozen
    reference of its time and bits."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = line.copy()
            for x in range(bpp, stride, bpp):
                cur[x:x + bpp] = (cur[x:x + bpp] + cur[x - bpp:x]) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur_l, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur_l[x] = (cur_l[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int32)
        out[y] = cur
        prev = cur
    return out


def png_reader_ms(tmp: str) -> dict:
    """The PNG reader on an 800x800 RGBA image written with rows of every
    filter type: the host time of one read (the wavefront unfiltering), and
    of the same file's unfiltering as it was before, in turns (before,
    now, now, before); both give the image's bits."""
    import struct
    import zlib

    from nerf_pl_tpu_torch.data import png

    rng = np.random.RandomState(12)
    h = w = 800
    img = rng.randint(0, 256, (h, w, 4)).astype(np.int32)
    rows = []
    for y in range(h):
        ft = y % 5
        up = img[y - 1].reshape(-1) if y else np.zeros(w * 4, np.int32)
        cur = img[y].reshape(-1)
        left = np.concatenate([np.zeros(4, np.int32), cur[:-4]])
        ul = np.concatenate([np.zeros(4, np.int32), up[:-4]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0 * left, left, up, (left + up) >> 1, paeth][ft]
        rows.append(bytes([ft]) + ((cur - pred) & 255).astype(np.uint8)
                    .tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path = os.path.join(tmp, "filters_800.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))
    times = {"now": [], "before": []}
    ok = True
    wavefront = png._unfilter
    for turn in ("before", "now", "now", "before"):
        # the same reader, with its unfiltering as it is or as it was
        png._unfilter = wavefront if turn == "now" else png_unfilter_before
        try:
            t0 = time.perf_counter()
            out, mode = png.read_png(path)
            times[turn].append(1e3 * (time.perf_counter() - t0))
        finally:
            png._unfilter = wavefront
        ok &= mode == "RGBA" and np.array_equal(out, img.astype(np.uint8))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"[llff] PNG reader, 800x800 RGBA, every filter type, on the host: "
        f"{ms['now']:.1f} ms now (wavefront), {ms['before']:.1f} ms as "
        f"before (a loop over each byte), in turns; pixels "
        f"{'equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError("the PNG reader misread its own filters")
    return dict(ms=ms["now"], before_ms=ms["before"])


def llff_eval(tmp: str, root: str, ckpt: str, split: str, wh,
              tag: str = "") -> dict:
    """``python -m nerf_pl_tpu_torch.eval --dataset_name llff`` on the card:
    launches, files, wall time; for ``test_train`` the PSNR of the written
    PNGs against the scene's images (the tool prints none: its loader gives
    those poses no ground truth)."""
    import glob

    from nerf_pl_tpu_torch import eval as eval_cli
    from nerf_pl_tpu_torch.data.llff import read_image
    from nerf_pl_tpu_torch.data.png import read_png

    out = os.path.join(tmp, f"llff_eval_{split}{tag}")
    argv = ["--root_dir", root, "--dataset_name", "llff", "--ckpt_path", ckpt,
            "--img_wh", str(wh[0]), str(wh[1]), "--N_samples", "64",
            "--N_importance", "64", "--split", split, "--save_depth",
            "--scene_name", split, "--out_dir", out, "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    psnr = eval_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    d = os.path.join(out, "llff", split)
    n = 120 if split == "test" else LLFF_VIEWS
    frames, delays, _ = gif_frames(os.path.join(d, f"{split}.gif"))
    pngs = sorted(x for x in os.listdir(d) if x.endswith(".png"))
    pfms = sorted(x for x in os.listdir(d) if x.endswith(".pfm"))
    if psnr is not None or frames != n or len(pngs) != n or len(pfms) != n:
        raise AssertionError(f"llff eval {split}: psnr {psnr}, {frames} GIF "
                             f"frames, {len(pngs)} PNGs, {len(pfms)} PFMs")
    if counts["C"] < 1 or counts["B"] < 1 or counts["D"] or counts["A"]:
        raise AssertionError(f"llff eval {split} did not take C and B: "
                             f"{counts}")
    psnrs = []
    if split == "test_train":
        views = sorted(glob.glob(os.path.join(root, "images", "*")))
        for name, view in zip(pngs, views):
            img, _ = read_png(os.path.join(d, name))
            gt = read_image(view)
            mse = np.mean((img / 255.0 - gt / 255.0) ** 2)
            psnrs.append(float(-10 * np.log10(max(mse, 1e-12))))
    rays = n * wh[0] * wh[1]
    log(f"[llff eval {split}] {n} views at {wh[0]}x{wh[1]}, 64+64 samples, "
        f"f32: {wall:.2f} s wall, {wall / n:.3f} s per view, "
        f"{rays / wall:.1f} rays/s; GIF {frames} frames; launches {counts}"
        + (f"; PSNR of the PNGs against the scene's images {psnrs}"
           if psnrs else ""))
    return dict(wall_s=wall, s_per_view=wall / n, rays_per_s=rays / wall,
                counts=counts, psnrs=psnrs)


def optimizers_card_vs_cpu() -> dict:
    """sgd, adamw, radam and ranger for 13 steps (and adam with cosine and
    sgd with poly, each behind a one-epoch warm-up, for 3 epochs of 5
    steps) on the reference NeRF's coarse and fine parameters on the card,
    each step under ``set_sync_debug_mode("error")``, against the same steps
    on the CPU with the same grads (weight decay 1e-2 where the optimiser
    takes it)."""
    from nerf_pl_tpu_torch.models.nerf import init_nerf
    from nerf_pl_tpu_torch.training import optim

    cases = [("sgd", "steplr", 0, 13), ("adamw", "steplr", 0, 13),
             ("radam", "steplr", 0, 13), ("ranger", "steplr", 0, 13),
             ("adam", "cosine", 1, 15), ("sgd", "poly", 1, 15)]
    out = {}
    lr = 5e-4
    for name, sched_kind, warmup, steps in cases:
        opts = {}
        for device in ("cuda", "cpu"):
            gen = torch.Generator().manual_seed(13)
            models = {k: init_nerf(gen, device=device)
                      for k in ("coarse", "fine")}
            sched = optim.make_lr_schedule(
                lr, sched_kind, 5, 3, decay_step=(1,), decay_gamma=0.5,
                warmup_epochs=warmup, warmup_multiplier=2.0, optimizer=name)
            opts[device] = optim.get_optimizer(
                name, sched, optim.named_params(models), weight_decay=1e-2)
        gen = torch.Generator().manual_seed(14)
        for _ in range(steps):
            for k, p in opts["cpu"].params.items():
                g = torch.randn(p.shape, generator=gen) * 0.1
                p.grad = g
                opts["cuda"].params[k].grad = g.cuda()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                opts["cuda"].step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            opts["cpu"].step()
        torch.cuda.synchronize()
        worst, differ, total = 0.0, 0, 0
        for k, p in opts["cpu"].params.items():
            q = opts["cuda"].params[k].detach().cpu()
            worst = max(worst, float((q - p.detach()).abs().max()) / lr)
            differ += int((q != p.detach()).sum())
            total += p.numel()
        tag = f"{name} {sched_kind}" + (" + warm-up" if warmup else "")
        log(f"[optim] {tag}, {steps} steps (weight decay 1e-2), each card "
            f"step under set_sync_debug_mode('error'): params card vs cpu "
            f"max |diff| / lr {worst:.3e} (tol {TOL_OPTIM_CARD:.0e}), "
            f"{differ} of {total} values differ")
        if not worst <= TOL_OPTIM_CARD:
            raise AssertionError(f"{tag}: the card's steps depart from the "
                                 f"CPU's by {worst:.3e} of the rate")
        out[tag] = dict(max_rel_lr=worst, differ=differ)
    return out


def llff_grads_card_vs_cpu(tmp: str) -> float:
    """One float32 LLFF step's grads (NDC rays, 64 + 64 samples, full
    width) on the card and on the CPU: the same weights (the seed), batch of
    256 rays and injected draws, noise 0 (a rounding-level difference can
    put a point's sigma + noise on either side of the ReLU's 0), on a 16x12
    scene written here."""
    from nerf_pl_tpu_torch.config import get_opts
    from nerf_pl_tpu_torch.data.synthetic import generate_llff_scene
    from nerf_pl_tpu_torch.training.trainer import NeRFSystem

    root = generate_llff_scene(os.path.join(tmp, "llff_small"),
                               img_wh=(16, 12), n_views=3)
    n, S = 256, LLFF_SAMPLES
    gen = torch.Generator().manual_seed(15)
    draws = step_draws(gen, n, S)
    grads = {}
    for device in ("cuda", "cpu"):
        cfg = get_opts(["--root_dir", root, *LLFF_FLAGS, "--img_wh", "16",
                        "12", "--batch_size", str(n), "--noise_std", "0",
                        "--exp_name", f"llff_grads_{device}",
                        "--log_dir", os.path.join(tmp, "logs"),
                        "--ckpt_dir", os.path.join(tmp, "ckpts")])
        system = NeRFSystem(cfg, device=device)
        system.train_step(system.rays[:n], system.rgbs[:n],
                          {k: v.to(device) for k, v in draws.items()})
        grads[device] = {f"{name}/{k}": p.grad.cpu()
                         for name, m in system.models.items()
                         for k, p in m.named_parameters()}
        system.logger.close()
    names = sorted(grads["cpu"])
    return check_grads("f32 llff step grads card vs cpu (16x12 scene)",
                       [grads["cuda"][k] for k in names],
                       [grads["cpu"][k] for k in names], names,
                       TOL_STEP_GRADS)["max_rel"]


def llff_profile_and_nans(tmp: str, root: str) -> dict:
    """The ring scene's fit with ``--profile`` (a trace of its first epoch,
    whose CUDA events must name kernels D and E), then ``--debug_nans`` on
    the card: a NaN weight stops the fit at its first step."""
    from nerf_pl_tpu_torch.config import get_opts
    from nerf_pl_tpu_torch.training.trainer import NeRFSystem

    traces = sorted(os.listdir(os.path.join(tmp, "logs", "llff_ring",
                                            "trace")))
    if len(traces) != 1 or not traces[0].endswith(".pt.trace.json"):
        raise AssertionError(f"--profile wrote {traces}")
    path = os.path.join(tmp, "logs", "llff_ring", "trace", traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {"D": "fused_nerf_fwd_kernel", "E": "fused_nerf_dgrad_kernel"}
    seen = {k: sum(v in e.get("name", "") for e in kernels)
            for k, v in names.items()}
    log(f"[llff] --profile trace {traces[0]}: {os.path.getsize(path):,} "
        f"bytes, {len(events):,} events, {len(kernels):,} CUDA kernel events; "
        f"kernel events of D {seen['D']}, E {seen['E']}")
    if not (seen["D"] and seen["E"]):
        raise AssertionError("the --profile trace names no D or E kernel")
    cfg = get_opts(["--root_dir", root, *LLFF_FLAGS, "--spheric_poses",
                    "--img_wh", str(LLFF_RING_WH[0]), str(LLFF_RING_WH[1]),
                    "--num_epochs", "1", "--debug_nans",
                    "--num_sanity_val_steps", "0", "--exp_name", "llff_nans",
                    "--log_dir", os.path.join(tmp, "logs"),
                    "--ckpt_dir", os.path.join(tmp, "ckpts")])
    system = NeRFSystem(cfg, device="cuda")
    with torch.no_grad():
        system.models["coarse"].xyz_layers[0].w[0, 0] = float("nan")
    try:
        system.fit()
    except FloatingPointError as e:
        log(f"[llff] --debug_nans on the card: {e}")
        return dict(trace_kernel_events=seen, nan_error=str(e))
    raise AssertionError("--debug_nans let a NaN weight train")


def llff_end_to_end(tmp: str) -> dict:
    """Phase 9: the LLFF fit at the recipe's flags, one step's launches,
    synchronising calls and profile, the eval of the training poses and of
    the spiral, one f32 step's grads card vs CPU, a spheric fit with
    ``--profile`` and ``--debug_nans``, the optimisers and schedules against
    the CPU, the JPEG and PNG readers."""
    from nerf_pl_tpu_torch.data.synthetic import generate_llff_scene

    t0 = time.perf_counter()
    root = os.path.join(tmp, "llff_scene")
    generate_llff_scene(root, img_wh=LLFF_WH, n_views=LLFF_VIEWS)
    log(f"[llff] forward-facing scene: {LLFF_VIEWS} views of "
        f"{LLFF_WH[0]}x{LLFF_WH[1]}, written in "
        f"{time.perf_counter() - t0:.1f} s")
    fit = trainer_fit(tmp, "train", root, "llff", LLFF_FLAGS, 1, "llff")
    system = fit["system"]
    want = (LLFF_VIEWS - 1) * LLFF_WH[0] * LLFF_WH[1] // LLFF_BATCH
    if system.steps_per_epoch != want:
        raise AssertionError(f"llff steps per epoch {system.steps_per_epoch}"
                             f", expected {want}")
    for k in ("A", "C", "D", "E"):
        if fit["counts"][k] < 1:
            raise AssertionError(f"kernel {k} was not launched by the fit")
    if not (system.rays[:, 6] == 0).all() or not (system.rays[:, 7] == 1).all():
        raise AssertionError("the forward-facing rays are not NDC (0, 1)")
    rays, rgbs = system.rays[:LLFF_BATCH], system.rgbs[:LLFF_BATCH]

    def step():
        return system.train_step(rays, rgbs)

    torch.cuda.synchronize()
    reset_counts()
    step()
    torch.cuda.synchronize()
    per_step = read_counts()
    log(f"[llff] launches in one step: {per_step}")
    if any(per_step[k] != v for k, v in LLFF_STEP_LAUNCHES.items()):
        raise AssertionError(f"one llff step launched {per_step}, expected "
                             f"{LLFF_STEP_LAUNCHES}")
    syncs = step_syncs(system, LLFF_BATCH, "llff")
    prof = profile_device("one llff step (f32, 1,024 rays, 64 + 64 samples)",
                          step, top=12)
    S = LLFF_SAMPLES
    f32_step = f32_step_kernels("llff", prof, [(LLFF_BATCH * S, True),
                                               (LLFF_BATCH * 2 * S, True)])
    del system, rays, rgbs, fit["system"]
    ckpt = os.path.join(tmp, "ckpts", "llff", "epoch=0.ckpt")
    ev_train = llff_eval(tmp, root, ckpt, "test_train", LLFF_WH)
    ev_test = llff_eval(tmp, root, ckpt, "test", LLFF_TEST_WH)
    grads_err = llff_grads_card_vs_cpu(tmp)

    ring = os.path.join(tmp, "llff_ring_scene")
    generate_llff_scene(ring, img_wh=LLFF_RING_WH, n_views=LLFF_VIEWS,
                        spheric=True)
    spheric = trainer_fit(tmp, "train", ring, "llff_ring", LLFF_FLAGS + [
        "--spheric_poses", "--img_wh", str(LLFF_RING_WH[0]),
        str(LLFF_RING_WH[1]), "--optimizer", "ranger", "--lr_scheduler",
        "poly", "--profile"], 2, "llff")
    near_far = spheric["system"].rays[0, 6:].tolist()
    log(f"[llff] spheric rays near/far {near_far}")
    if near_far[0] <= 0 or not near_far[1] > near_far[0]:
        raise AssertionError(f"spheric near/far {near_far}")
    del spheric["system"]
    nans = llff_profile_and_nans(tmp, ring)
    optims = optimizers_card_vs_cpu()
    jpg = llff_jpeg(tmp)
    pngr = png_reader_ms(tmp)
    seconds = time.perf_counter() - t0
    log(f"[llff] phase 9: {seconds:.1f} s")
    return dict(fit=fit, steps=want, per_step=per_step, syncs=syncs,
                profile=prof, f32_step=f32_step, eval_test_train=ev_train,
                eval_test=ev_test, grads_err=grads_err, spheric=spheric,
                nans=nans, optims=optims, jpeg=jpg, png=pngr,
                seconds=seconds)


# ---------------------------------------------------------------- phase 10
# The tools on the card.  The mesh tool at its defaults (--N_grid 256,
# --chunk 32768, --N_samples 64) on phase 4's full-width fit and scene: the
# sigma grid is ceil(256^3 / 32768) = 512 launches of C' (float32,
# sigma-only), the fusion one C' launch a view per chunk of vertices (the
# occlusion render, coarse-only rgb, float32); B only on the
# --use_vertex_normal path (each chunk: C' sigma-only, B, C' rgb).
MESH_N_GRID, MESH_CHUNK, MESH_SAMPLES = 256, 32 * 1024, 64
MESH_NORMAL_N_GRID, MESH_NORMAL_IMPORTANCE = 128, 64
# The 256^3 surface at the size a scene meshes to (10^5-10^6 vertices).
# Phase 4's 2-epoch fit is near its random start: its sigma's 2^9 octave
# varies at the 256^3 grid's spacing, so a surface of it breaks into
# fragments (on the CPU, a 64^3 grid of such a model at its 90th percentile
# gave 243,438 vertices of which the largest cluster kept 123,176, and the
# count grows with the grid's volume, not its area), where a scene's surface
# is smooth at that spacing.  So the two layers that read the encoded xyz
# (layer 0 and the skip layer) keep only the columns of the
# MESH_OCTAVES lowest octaves (x and frequencies 1, 2, 4): a smooth scene at
# full width, through the same kernels.  Each model's sigma bias is then
# lowered by a quantile of its raw sigma over the 256^3 grid, the highest of
# MESH_QUANTILES whose largest cluster (the host stages run on the grid
# first) holds MESH_MIN_VERTICES with a fifth to spare, as the tool's own
# grid, through the lowered bias, may round other values; the threshold is
# MESH_DENSE_THR of the lowered grid's largest sigma.  A surface estimated
# above MESH_MAX_VERTICES (3 vertices an axis crossing, as marching
# tetrahedra gave on smooth random fields) is not tried: host memory and
# time.
MESH_OCTAVES = 3
MESH_QUANTILES = (0.99, 0.98, 0.95, 0.9, 0.8, 0.7, 0.6, 0.5)
MESH_MIN_VERTICES, MESH_MAX_VERTICES = 100_000, 4_000_000
MESH_DENSE_THR = 1e-2
# The clustering on the host at 10^6 vertices: the iso-surface of a smooth
# random field (white noise on a 128^3 grid, low-passed by a Gaussian of
# 0.05 cycles a sample) at its median, one large cluster, and at its 90th
# percentile, many small ones.
CLUSTER_N_GRID, CLUSTER_CUTOFF, CLUSTER_QUANTILES = 128, 0.05, (0.5, 0.9)
# The card against the CPU at a size the CPU renders in seconds: a 48^3
# grid, 2 training views, 16 samples a ray.
MESH_CMP_N_GRID, MESH_CMP_VIEWS, MESH_CMP_SAMPLES = 48, 2, 16
# The sigma grids: C' in float32 against posenc + NeRF on the CPU, on the
# same input bits; only the order of the f32 sums and sinf/cosf within an
# ulp differ, so TOL_C's float32 limit (1e-4 on outputs of order 1) holds
# relative to the grid's largest sigma.
TOL_MESH_SIGMA = TOL_C[torch.float32]
# With no grid value on opposite sides of the threshold on the two devices,
# the surfaces cross the same edges: the triangles are equal and each vertex
# moves along its edge by (sigma difference) / (sigma step across the edge)
# of the edge.  The grids agree to ~1e-6 of their largest sigma, so 1e-2 of
# the grid spacing allows edges whose sigma step is 1e-4 of the largest
# sigma (nearly flat across the surface) and fails a vertex on the wrong
# edge or a wrong interpolation.
TOL_MESH_VERTEX = 1e-2  # of the grid spacing
# Colours: each a weighted mean of bilinear samples truncated to uint8: a
# value on a level's edge moves by one level.
TOL_MESH_COLOR = 1  # level
# Import -> resume -> export: the reference's Adam moments come back from
# the port's state bit for bit (a transpose and a copy each way).
TOOLS_REF_STEPS, TOOLS_REF_EPOCH = 3, 4


def mesh_argv(root: str, ckpt: str, out: str, n_grid: int, thr: float,
              extra=(), device: str = "cuda") -> list:
    return ["--root_dir", root, "--dataset_name", "blender",
            "--img_wh", str(TRAIN_WH), str(TRAIN_WH), "--ckpt_path", ckpt,
            "--N_grid", str(n_grid), "--chunk", str(MESH_CHUNK),
            "--sigma_threshold", repr(thr), "--out_path", out,
            "--blender_near", "2", "--blender_far", "6", "--device", device,
            *extra]


def run_mesh_tool(argv: list, tag: str) -> dict:
    """``python -m nerf_pl_tpu_torch.extract_color_mesh`` in this process
    (its ``main``, so the launch counters can be read): the counts zeroed
    just before and read just after, its wall time, and the stage times and
    counts of its ``[mesh]`` line."""
    import contextlib

    from nerf_pl_tpu_torch import extract_color_mesh

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = extract_color_mesh.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("[mesh] ")]
    if not line:
        raise AssertionError(f"{tag}: the mesh tool printed no [mesh] line")
    info = json.loads(line[-1][len("[mesh] "):])
    stages = ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in info.items()
                       if k.endswith("_s"))
    launched = {k: v for k, v in counts.items() if v}
    log(f"[tools] {tag}: {wall:.2f} s wall; stages {stages}; "
        f"{info.get('vertices', '-')} vertices, {info.get('faces', '-')} "
        f"faces; launches {launched}")
    return dict(out=out, wall_s=wall, counts=counts, info=info)


def density_checkpoint(src: str, out: str, n_grid: int = 64) -> str:
    """Phase 4's fit with each model's sigma bias lowered by its 99th
    percentile of raw sigma over the tool's default cube (a 64^3 grid), so
    about 1% of the cube holds density: a 2-epoch fit has no positive
    density there (the same lift tests/test_tools.py gives its model's
    sigma bias).  The weights stay the fit's, at full width."""
    from nerf_pl_tpu_torch.tools.evaluate import load_models
    from nerf_pl_tpu_torch.tools.extract_mesh import query_sigma_grid
    from nerf_pl_tpu_torch.training.checkpoints import (load_checkpoint,
                                                        save_checkpoint)

    state = load_checkpoint(src)
    g = np.linspace(-1, 1, n_grid).astype(np.float32)
    xyz = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)
    for name, model in load_models(src, "cuda").items():
        q = float(np.quantile(query_sigma_grid(model, xyz, MESH_CHUNK), 0.99))
        head = state["params"][name]["sigma"]
        head["b"] = np.asarray(head["b"], np.float32) - np.float32(q)
        log(f"[tools] {name} model: sigma bias lowered by its 99th "
            f"percentile of raw sigma over the cube, {q:.4g}")
    save_checkpoint(out, state)
    return out


def surface_threshold(fine, n_grid: int = 64) -> float:
    """Half the largest sigma on a coarse grid of the tool's default ranges
    (as tests/test_tools.py sets its threshold): voxels on both sides."""
    from nerf_pl_tpu_torch.tools.extract_mesh import query_sigma_grid

    g = np.linspace(-1, 1, n_grid).astype(np.float32)
    xyz = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)
    sigma = np.maximum(query_sigma_grid(fine, xyz, MESH_CHUNK), 0)
    if not sigma.max() > 0:
        raise AssertionError("the fit's model has no positive density")
    return 0.5 * float(sigma.max())


def tool_grid(n_grid: int) -> np.ndarray:
    """The mesh tool's (n_grid^3, 3) points over its default cube."""
    g = np.linspace(-1, 1, n_grid)
    return np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3).astype(np.float32)


def dense_checkpoint(src: str, out: str) -> tuple:
    """Phase 4's fit cut to the ``MESH_OCTAVES`` lowest octaves of its
    encoded xyz, with each model's sigma bias lowered by the quantile of
    its raw sigma over the 256^3 grid that ``MESH_QUANTILES`` picks (see
    there), and the threshold: (path, threshold, the ladder tried)."""
    from nerf_pl_tpu_torch.tools.evaluate import load_models
    from nerf_pl_tpu_torch.tools.extract_mesh import query_sigma_grid
    from nerf_pl_tpu_torch.tools.mesh_utils import (keep_largest_cluster,
                                                     marching_tetrahedra)
    from nerf_pl_tpu_torch.training.checkpoints import (load_checkpoint,
                                                        save_checkpoint)

    state = load_checkpoint(src)
    keep = 3 + 6 * MESH_OCTAVES  # posenc columns: x, then sin and cos a band
    for model in state["params"].values():
        # the layers that read the encoded xyz (the skip layer's in front)
        for layer in ("0", "4"):
            w = np.array(model["xyz_layers"][layer]["w"], np.float32)
            w[keep:63] = 0
            model["xyz_layers"][layer]["w"] = w
    save_checkpoint(out, state)
    n = MESH_N_GRID
    xyz = tool_grid(n)
    raw = {k: query_sigma_grid(m, xyz, MESH_CHUNK)
           for k, m in load_models(out, "cuda").items()}
    del xyz
    ladder, chosen = [], None
    for p in MESH_QUANTILES:
        q = np.float32(np.quantile(raw["fine"], p))
        lowered = np.maximum(raw["fine"] - q, 0).reshape(n, n, n)
        thr = MESH_DENSE_THR * float(lowered.max())
        inside = lowered > thr
        est = 3 * sum(int((inside.swapaxes(0, a)[1:] !=
                           inside.swapaxes(0, a)[:-1]).sum()) for a in range(3))
        row = dict(quantile=p, threshold=thr, estimate=est)
        ladder.append(row)
        if est > MESH_MAX_VERTICES:
            break
        if est < MESH_MIN_VERTICES:
            continue
        t0 = time.perf_counter()
        v, t = marching_tetrahedra(lowered, thr)
        kept = len(keep_largest_cluster(v, t)[0])
        row.update(surface=len(v), kept=kept,
                   host_s=time.perf_counter() - t0)
        if kept >= 1.2 * MESH_MIN_VERTICES:
            chosen = row
            break
    log(f"[tools] the dense surface's quantile ladder: {ladder}")
    if chosen is None:
        raise AssertionError("no quantile of MESH_QUANTILES gives a 256^3 "
                             f"surface of {MESH_MIN_VERTICES} vertices")
    for name, sigma in raw.items():
        q = float(np.quantile(sigma, chosen["quantile"]))
        head = state["params"][name]["sigma"]
        head["b"] = np.asarray(head["b"], np.float32) - np.float32(q)
        log(f"[tools] {name} model: sigma bias lowered by its "
            f"{chosen['quantile']:.0%} quantile of raw sigma over the "
            f"{n}^3 grid, {q:.4g}")
    save_checkpoint(out, state)
    return out, chosen["threshold"], ladder


def cluster_host_seconds() -> dict:
    """``keep_largest_cluster`` on the host at about 10^6 vertices (see
    ``CLUSTER_N_GRID``): seconds of the best of 3 calls, against the
    iso-surface's own seconds."""
    from nerf_pl_tpu_torch.tools.mesh_utils import (keep_largest_cluster,
                                                     marching_tetrahedra)

    n = CLUSTER_N_GRID
    rng = np.random.default_rng(0)
    k2 = (np.fft.fftfreq(n)[:, None, None] ** 2
          + np.fft.fftfreq(n)[None, :, None] ** 2
          + np.fft.rfftfreq(n)[None, None, :] ** 2)
    field = np.fft.irfftn(
        np.fft.rfftn(rng.standard_normal((n, n, n)))
        * np.exp(-k2 / (2 * CLUSTER_CUTOFF ** 2)), s=(n, n, n),
        axes=(0, 1, 2)).astype(np.float32)
    res = {}
    for p in CLUSTER_QUANTILES:
        t0 = time.perf_counter()
        v, t = marching_tetrahedra(
            np.maximum(field - np.float32(np.quantile(field, p)), 0), 1e-6)
        surface_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            kv, kt = keep_largest_cluster(v, t)
            times.append(time.perf_counter() - t0)
        if not (0 < len(kv) <= len(v) and kt.max() < len(kv)):
            raise AssertionError(f"keep_largest_cluster kept {len(kv)} of "
                                 f"{len(v)} vertices")
        res[p] = dict(vertices=len(v), faces=len(t), kept=len(kv),
                      seconds=min(times), surface_s=surface_s)
        log(f"[tools] keep_largest_cluster on the host, the {n}^3 field at "
            f"its {p:.0%} quantile: {len(v):,} vertices, {len(t):,} faces, "
            f"kept {len(kv):,}; {min(times):.3f} s (best of 3; "
            f"{[round(x, 3) for x in times]}), the iso-surface {surface_s:.3f} s")
    return res


def mesh_full_width(tmp: str, root: str, ckpt: str, dense: str,
                    dense_thr: float) -> dict:
    """The mesh tool at its defaults on phase 4's fit lowered to a dense
    surface (``dense_checkpoint``): the 256^3 grid (512 C' launches
    exactly), the fusion over the 8 training views of at least
    ``MESH_MIN_VERTICES`` vertices; then --use_vertex_normal at 128^3 (B
    launched) on ``ckpt``, then --vol_path."""
    from nerf_pl_tpu_torch.tools.evaluate import load_models
    from nerf_pl_tpu_torch.tools.mesh_utils import read_ply, read_vol

    thr = surface_threshold(load_models(ckpt, "cuda")["fine"])
    res = {"threshold": thr, "dense_threshold": dense_thr}
    grid_launches = -(-MESH_N_GRID ** 3 // MESH_CHUNK)
    m = run_mesh_tool(mesh_argv(root, dense, os.path.join(tmp, "mesh.ply"),
                                MESH_N_GRID, dense_thr,
                                ["--N_samples", str(MESH_SAMPLES)]),
                      f"mesh {MESH_N_GRID}^3 (fusion)")
    n_vert = m["info"]["vertices"]
    if not n_vert >= MESH_MIN_VERTICES:
        raise AssertionError(f"the {MESH_N_GRID}^3 mesh kept {n_vert} "
                             f"vertices, fewer than {MESH_MIN_VERTICES}")
    fusion = TRAIN_VIEWS * -(-n_vert // MESH_CHUNK)
    verts, tris, colors = read_ply(m["out"])
    if not (len(tris) > 0 and colors is not None and len(verts) == n_vert
            and np.isfinite(verts).all() and (np.abs(verts) <= 1 + 1e-5).all()):
        raise AssertionError("the mesh is empty, uncoloured or out of range")
    cp = m["counts"]["C'"]
    log(f"[tools] mesh: C' launches {cp} = {grid_launches} (grid) + "
        f"{fusion} (fusion: {TRAIN_VIEWS} views x ceil({n_vert} / "
        f"{MESH_CHUNK})); B {m['counts']['B']}; "
        f"{MESH_N_GRID ** 3 / m['info']['grid_s']:.4g} grid points/s")
    others = {k: v for k, v in m["counts"].items() if v and k != "C'"}
    if cp != grid_launches + fusion or others:
        raise AssertionError(f"mesh tool launches {m['counts']}: expected C' "
                             f"{grid_launches} + {fusion} and nothing else")
    res["fusion"] = dict(m, grid_launches=grid_launches,
                         points_per_s=MESH_N_GRID ** 3 / m["info"]["grid_s"])
    # where the grid stage's time goes: the same query under the profiler
    from nerf_pl_tpu_torch.tools.extract_mesh import query_sigma_grid

    xyz = tool_grid(MESH_N_GRID)
    fine = load_models(dense, "cuda")["fine"]
    res["grid_profile"] = profile_device(
        f"the {MESH_N_GRID}^3 sigma grid (query_sigma_grid, C' f32)",
        lambda: query_sigma_grid(fine, xyz, MESH_CHUNK), top=4)
    del fine, xyz
    n = run_mesh_tool(mesh_argv(
        root, ckpt, os.path.join(tmp, "mesh_normal.ply"), MESH_NORMAL_N_GRID,
        thr, ["--N_samples", str(MESH_SAMPLES), "--use_vertex_normal",
              "--N_importance", str(MESH_NORMAL_IMPORTANCE)]),
        f"mesh {MESH_NORMAL_N_GRID}^3 --use_vertex_normal")
    chunks = -(-n["info"]["vertices"] // MESH_CHUNK)
    g2 = -(-MESH_NORMAL_N_GRID ** 3 // MESH_CHUNK)
    if (n["counts"]["C'"] != g2 + 2 * chunks or n["counts"]["B"] != chunks
            or read_ply(n["out"])[2] is None):
        raise AssertionError(f"vertex-normal launches {n['counts']}: "
                             f"expected C' {g2} + 2 x {chunks}, B {chunks}")
    res["normal"] = n
    vol = os.path.join(tmp, "scene.vol")
    v = run_mesh_tool(mesh_argv(root, dense, os.path.join(tmp, "unused.ply"),
                                MESH_N_GRID, dense_thr,
                                ["--vol_path", vol, "--vol_only"]),
                      f"mesh {MESH_N_GRID}^3 --vol_path --vol_only")
    grid, ranges = read_vol(vol)
    if (grid.shape != (MESH_N_GRID,) * 3 or not grid.max() > 0
            or v["counts"]["C'"] != grid_launches
            or os.path.exists(os.path.join(tmp, "unused.ply"))):
        raise AssertionError(f".vol export: shape {grid.shape}, max "
                             f"{grid.max()}, launches {v['counts']}")
    log(f"[tools] .vol: {os.path.getsize(vol):,} bytes, sigma_max "
        f"{grid.max():.4g}, ranges {[list(map(float, r)) for r in ranges]}")
    res["vol"] = v
    return res


def mesh_card_vs_cpu(tmp: str, ckpt: str) -> dict:
    """The mesh tool on the card and on the CPU with the same flags and
    checkpoint on a 2-view copy of phase 4's scene at a 48^3 grid: the sigma
    grids, the grid values on opposite sides of the threshold, and the
    meshes."""
    from nerf_pl_tpu_torch.tools.evaluate import load_models
    from nerf_pl_tpu_torch.tools.extract_mesh import query_sigma_grid
    from nerf_pl_tpu_torch.tools.mesh_utils import read_ply

    root = os.path.join(tmp, "mesh_cmp_scene")
    write_scene(root, n_train=MESH_CMP_VIEWS, n_test=0)
    N = MESH_CMP_N_GRID
    g = np.linspace(-1, 1, N)
    xyz = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3).astype(np.float32)
    grids = {d: np.maximum(query_sigma_grid(load_models(ckpt, d)["fine"],
                                            xyz, MESH_CHUNK), 0)
             for d in ("cuda", "cpu")}
    scale = float(grids["cpu"].max())
    if not scale > 0:
        raise AssertionError("the checkpoint has no positive density")
    thr = 0.5 * scale
    err = float(np.abs(grids["cuda"] - grids["cpu"]).max()) / scale
    crossing = int(((grids["cuda"] > thr) != (grids["cpu"] > thr)).sum())
    log(f"[tools] sigma grid {N}^3 card (C' f32) vs cpu (posenc + NeRF): "
        f"max |diff| / max sigma {err:.3e} (tol {TOL_MESH_SIGMA:.0e}); "
        f"{crossing} of {N ** 3} values on opposite sides of the threshold "
        f"{thr:.4g}")
    if not err <= TOL_MESH_SIGMA:
        raise AssertionError("the card's sigma grid departs from the CPU's")
    meshes = {}
    for d in ("cuda", "cpu"):
        r = run_mesh_tool(mesh_argv(
            root, ckpt, os.path.join(tmp, f"cmp_{d}.ply"), N, thr,
            ["--N_samples", str(MESH_CMP_SAMPLES)], device=d),
            f"mesh {N}^3 on the {d}")
        meshes[d] = read_ply(r["out"]) + (r,)
    vc, tc, cc, _ = meshes["cuda"]
    vp, tp, cp, _ = meshes["cpu"]
    res = dict(sigma_rel=err, crossing=crossing, vertices=len(vp),
               faces=len(tp))
    if crossing:
        log(f"[tools] {crossing} grid values cross the threshold between the "
            f"devices: the surfaces may differ ({len(vc)} / {len(vp)} "
            "vertices); the mesh comparison is printed only")
        return res
    spacing = 2.0 / N  # world units a grid index (grid_vertices_to_world)
    dv = np.abs(vc - vp).max(axis=1) / spacing if len(vc) == len(vp) else None
    same_tris = len(tc) == len(tp) and np.array_equal(tc, tp)
    diff = (np.abs(cc.astype(int) - cp.astype(int))
            if same_tris and cc.shape == cp.shape else None)
    log(f"[tools] mesh card vs cpu: triangles equal {same_tris} ({len(tp)}); "
        + ("" if dv is None else
           f"vertices max |diff| {dv.max():.3e}, 99.9% {np.quantile(dv, 0.999):.3e} "
           f"of the spacing (tol {TOL_MESH_VERTEX:.0e}); ")
        + ("" if diff is None else
           f"colours max diff {diff.max()} level(s) (tol {TOL_MESH_COLOR}), "
           f"{int((diff > 0).sum())} of {diff.size} values differ"))
    if not same_tris or dv is None or not dv.max() <= TOL_MESH_VERTEX:
        raise AssertionError("the card's mesh departs from the CPU's")
    if not diff.max() <= TOL_MESH_COLOR:
        raise AssertionError("the card's mesh colours depart from the CPU's")
    res.update(vertex_max=float(dv.max()), color_max=int(diff.max()),
               color_differ=int((diff > 0).sum()))
    return res


class RefNeRF(torch.nn.Module):
    """The reference NeRF's attribute names and definition order
    (``xyz_encoding_{1..8}.0``, ``xyz_encoding_final``, ``dir_encoding.0``,
    ``sigma``, ``rgb.0``), at full width."""

    def __init__(self, D=8, W=256, in_xyz=63, in_dir=27, skips=(4,)):
        super().__init__()
        nn = torch.nn
        for i in range(D):
            fan_in = in_xyz if i == 0 else (W + in_xyz if i in skips else W)
            setattr(self, f"xyz_encoding_{i + 1}",
                    nn.Sequential(nn.Linear(fan_in, W), nn.ReLU(True)))
        self.xyz_encoding_final = nn.Linear(W, W)
        self.dir_encoding = nn.Sequential(nn.Linear(W + in_dir, W // 2),
                                          nn.ReLU(True))
        self.sigma = nn.Linear(W, 1)
        self.rgb = nn.Sequential(nn.Linear(W // 2, 3), nn.Sigmoid())


def port_key(model: str, torch_name: str) -> tuple:
    """A reference parameter name -> (the port's path, transposed)."""
    mod, leaf = torch_name.rsplit(".", 1)
    leaf = {"weight": "w", "bias": "b"}[leaf]
    if mod.startswith("xyz_encoding_") and mod != "xyz_encoding_final":
        i = int(mod.split("_")[2].split(".")[0]) - 1
        path = ("xyz_layers", str(i), leaf)
    else:
        path = ({"xyz_encoding_final": "xyz_final", "dir_encoding.0":
                 "dir_layer", "sigma": "sigma", "rgb.0": "rgb"}[mod], leaf)
    return (model,) + path, leaf == "w"


def import_resume_export(tmp: str, root: str) -> dict:
    """A Lightning checkpoint of the reference's layout (3 torch.optim.Adam
    steps on the card) through ``python -m nerf_pl_tpu_torch.import_torch_ckpt
    --full_state``, a 1-epoch resume of ``python -m nerf_pl_tpu_torch.train``
    on the card from it, and ``--export --full_state`` of the resumed
    checkpoint loaded into a fresh ``torch.optim.Adam``: its moments equal
    the port state's bit for bit."""
    from nerf_pl_tpu_torch.training.checkpoints import load_checkpoint

    torch.manual_seed(31)
    models = [RefNeRF().cuda(), RefNeRF().cuda()]
    params = [p for m in models for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=5e-4)
    gen = torch.Generator(device="cuda").manual_seed(32)
    for _ in range(TOOLS_REF_STEPS):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device="cuda") * 0.01
        opt.step()
    sd = {f"{name}.{k}": v for name, m in zip(("nerf_coarse", "nerf_fine"),
                                               models)
          for k, v in m.state_dict().items()}
    ref = os.path.join(tmp, "reference.ckpt")
    torch.save({"state_dict": sd, "optimizer_states": [opt.state_dict()],
                "lr_schedulers": [], "epoch": TOOLS_REF_EPOCH,
                "global_step": TOOLS_REF_STEPS + 1}, ref)
    imported = os.path.join(tmp, "imported.ckpt")

    def cli(module, *args):
        r = subprocess.run([sys.executable, "-m", f"nerf_pl_tpu_torch.{module}",
                            *args], capture_output=True, text=True,
                           timeout=300)
        log(f"[tools] python -m nerf_pl_tpu_torch.{module} {' '.join(args[-2:])}"
            f": rc {r.returncode}; {r.stdout.strip().splitlines()[-2:]}")
        if r.returncode:
            raise AssertionError(r.stderr[-2000:])

    cli("import_torch_ckpt", "--ckpt_path", ref, "--out_path", imported,
        "--full_state")
    raw = load_checkpoint(imported)
    if (int(raw["epoch"]) != TOOLS_REF_EPOCH - 1
            or int(raw["opt_state"]["0"]["count"]) != TOOLS_REF_STEPS):
        raise AssertionError("the imported epoch or Adam count is wrong")
    flags = ["--dataset_name", "blender", "--img_wh", str(TRAIN_WH),
             str(TRAIN_WH), "--N_samples", str(N_SAMPLES), "--N_importance",
             str(N_IMPORTANCE), "--batch_size", str(TRAIN_BATCH), "--lr",
             "5e-4", "--white_back", "true", "--compute_dtype", "bfloat16",
             "--ckpt_path", imported]
    from nerf_pl_tpu_torch import train as train_cli

    argv = ["--root_dir", root, *flags, "--num_epochs",
            str(TOOLS_REF_EPOCH + 1), "--exp_name", "resumed", "--log_dir",
            os.path.join(tmp, "logs"), "--ckpt_dir", os.path.join(tmp, "ckpts"),
            "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts()
    system = train_cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    steps = system.steps_per_epoch
    del system
    with open(os.path.join(tmp, "logs", "resumed", "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f)
                  if "train/loss" in r]
    ckpt_dir = os.path.join(tmp, "ckpts", "resumed")
    ckpts = sorted(os.listdir(ckpt_dir))
    require_checkpoints(ckpt_dir, "tools resume")
    if (len(losses) != 1 or not np.isfinite(losses[0])
            or ckpts != [f"epoch={TOOLS_REF_EPOCH}.ckpt"]):
        raise AssertionError(f"the resume did not run epoch "
                             f"{TOOLS_REF_EPOCH} alone with a finite loss: "
                             f"{losses} {ckpts}")
    resumed = os.path.join(tmp, "ckpts", "resumed", ckpts[0])
    state = load_checkpoint(resumed)
    adam = state["opt_state"]["0"]
    if int(adam["count"]) != TOOLS_REF_STEPS + steps:
        raise AssertionError(f"the Adam count went {int(adam['count'])}, not "
                             f"{TOOLS_REF_STEPS} + {steps}")
    exported = os.path.join(tmp, "exported.ckpt")
    cli("import_torch_ckpt", "--ckpt_path", resumed, "--out_path", exported,
        "--export", "--full_state")
    back = torch.load(exported, map_location="cpu", weights_only=True)
    fresh_models = [RefNeRF(), RefNeRF()]
    fresh = [p for m in fresh_models for p in m.parameters()]
    adam_t = torch.optim.Adam(fresh, lr=5e-4)
    adam_t.load_state_dict(back["optimizer_states"][0])
    differ = total = 0
    names = [(mn, k) for mn, m in zip(("coarse", "fine"), fresh_models)
             for k, _ in m.named_parameters()]
    for p, (mn, k) in zip(fresh, names):
        path, transposed = port_key(mn, k)
        for slot, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            node = adam[moment]
            for part in path:
                node = node[part]
            want = torch.from_numpy(np.asarray(node, np.float32))
            want = want.T if transposed else want
            got = adam_t.state[p][slot]
            differ += int((got != want).sum())
            total += want.numel()
        if int(adam_t.state[p]["step"]) != TOOLS_REF_STEPS + steps:
            raise AssertionError("the exported step count is wrong")
    log(f"[tools] import -> resume (epoch {TOOLS_REF_EPOCH}, {steps} steps, "
        f"loss {losses[0]:.5f}, launches {counts}) -> export: {differ} of {total} Adam "
        f"moment values differ from the port state's (tol 0); epoch "
        f"{back['epoch']}, global_step {back['global_step']}")
    if differ or back["epoch"] != TOOLS_REF_EPOCH + 1:
        raise AssertionError("the exported state departs from the port's")
    return dict(loss=losses[0], steps=steps, differ=differ, values=total,
                counts=counts)


def require_checkpoints(ckpt_dir: str, tag: str) -> int:
    """Every checkpoint a fit left (written by the trainers' background
    writer, which ``fit`` drains) is on disk and loads."""
    from nerf_pl_tpu_torch.training.checkpoints import load_checkpoint

    names = sorted(n for n in os.listdir(ckpt_dir) if n.endswith(".ckpt"))
    for n in names:
        state = load_checkpoint(os.path.join(ckpt_dir, n))
        if "params" not in state or "opt_state" not in state:
            raise AssertionError(f"{tag}: {n} lacks params or opt_state")
    if not names or any(n.endswith(".tmp") for n in os.listdir(ckpt_dir)):
        raise AssertionError(f"{tag}: checkpoints {os.listdir(ckpt_dir)}")
    return len(names)


# ---------------------------------------------------------------- the NaN hold
def nonfinite_hold(label: str, got: torch.Tensor, want: torch.Tensor,
                   tol: float, mean_tol: float | None = None) -> float:
    """``got`` against ``want``: NaN, +Inf and -Inf at the same positions;
    the finite values within ``tol`` absolute with a mean within
    ``mean_tol`` (TOL_C's form), or, without ``mean_tol``, within ``tol`` of
    the largest finite |want| (TOL_TRAIN's form).  Returns the reading."""
    g, w = got.double(), want.double()
    for what, f in (("NaN", torch.isnan), ("+Inf", torch.isposinf),
                    ("-Inf", torch.isneginf)):
        n = int((f(g) != f(w)).sum())
        if n:
            raise AssertionError(f"{label}: {n} {what} positions differ from "
                                 "the plain version's")
    fin = torch.isfinite(w)
    d = (g[fin] - w[fin]).abs()
    err = float(d.max()) if d.numel() else 0.0
    if mean_tol is None:  # relative to the tensor's largest finite value
        scale = float(w[fin].abs().max()) if d.numel() else 1.0
        err /= max(scale, 1e-30)
        ok = err <= tol
    else:
        ok = err <= tol and (float(d.mean()) if d.numel() else 0.0) <= mean_tol
    if not ok:
        raise AssertionError(f"{label}: finite values off by {err:.3e}")
    return err


def nan_holds(fine, dev) -> dict:
    """The ReLU repair on the card: each kernel against its plain version
    on inputs that carry a NaN or an Inf, the NaN and Inf positions equal
    and the finite values within the usual limits.  Forward C, C', D (its
    stash too), G and I with a NaN bias of the dir head (rgb NaN, sigma
    finite) and with NaN xyz at three points (those points NaN); backward
    E, F and H with an Inf cotangent at two points (a zero ReLU mask selects
    0, as JAX's compiled backward does)."""
    import copy

    from nerf_pl_tpu_torch.models.embedding import posenc
    from nerf_pl_tpu_torch.ops import fused_mlp as fm
    from nerf_pl_tpu_torch.scripts import kernel_probe as kp

    gen = torch.Generator().manual_seed(41)
    P = (1 << 16) + 77
    x = random_raw_t(gen, P, dev)
    poisoned = copy.deepcopy(fine)
    with torch.no_grad():
        poisoned.dir_layer.b[5] = float("nan")
    xn = x.clone()
    xn[0, [5, 4000, P - 1]] = float("nan")
    cases = (("NaN dir bias", poisoned, x), ("NaN points", fine, xn))
    readings = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).replace("torch.", "")
            tol = TOL_C[dtype]
            for name, m, xx in cases:
                xr = xx.T.contiguous()
                emb = torch.cat([posenc(xr[:, :3], 10), posenc(xr[:, 3:6], 4)],
                                -1).contiguous()
                c = fm.fused_nerf_apply_raw_t_cuda(m, xx, False, dtype)
                ref = fm.fused_nerf_apply_raw_t_plain(m, xx, False, dtype)
                if name == "NaN dir bias" and not (
                        torch.isnan(ref[:3]).all() and torch.isfinite(ref[3]).all()):
                    raise AssertionError("the NaN case does not poison rgb alone")
                readings[f"C {dn} {name}"] = nonfinite_hold(
                    f"C {dn} {name}", c, ref, tol, TOL_C_MEAN)
                cr = fm.fused_nerf_apply_raw_cuda(m, xr, False, dtype)
                readings[f"C' {dn} {name}"] = nonfinite_hold(
                    f"C' {dn} {name}", cr, ref.T, tol, TOL_C_MEAN)
                o, st = fm.fused_nerf_stash_fwd_cuda(m, xx, False, dtype)
                o_p, st_p = fm.fused_nerf_stash_fwd_plain(m, xx, False, dtype)
                readings[f"D {dn} {name}"] = nonfinite_hold(
                    f"D {dn} {name}", o, o_p, tol, TOL_C_MEAN)
                nonfinite_hold(f"D stash {dn} {name}", st.float(),
                               st_p.float(), tol, TOL_C_MEAN)
                del st, st_p
                gk = fm.fused_nerf_apply_cuda(m, emb, False, dtype)
                gp = fm.fused_nerf_apply_plain(m, emb, False, dtype)
                readings[f"G {dn} {name}"] = nonfinite_hold(
                    f"G {dn} {name}", gk, gp, tol, TOL_C_MEAN)
        xi, w0, w = kp.probe_inputs(P, dev, seed=5)
        xi[[3, 4000, P - 1], 7] = float("nan")
        ik = kp.chain_cuda(xi, w0, w, True)
        ip = kp.chain_plain(xi, w0, w, True)
        readings["I fancy"] = nonfinite_hold("I fancy", ik, ip, TOL_CHAIN[0])
        if not torch.isnan(ik[[3, 4000, P - 1]]).all():
            raise AssertionError("kernel I does not keep the NaN rows")
        # the backward: an Inf cotangent at two points
        bf = torch.bfloat16
        g = torch.randn((8, P), generator=gen).to(dev)
        g[1, 7], g[3, 60] = float("inf"), float("-inf")
        names = grad_names(fine)

        def hold(label, mine, ref):
            worst = 0.0
            for a, b, n in zip(fm.unpack_grads(fine, *mine, bf),
                               fm.unpack_grads(fine, *ref, bf), names):
                worst = max(worst, nonfinite_hold(f"{label} {n}", a, b,
                                                  TOL_TRAIN[bf][0]))
            return worst

        _, st = fm.fused_nerf_stash_fwd_cuda(fine, x, False, bf)
        readings["E"] = hold("E Inf g", fm.fused_nerf_bwd_stash_cuda(
            fine, x, g, st, False, bf), fm.fused_nerf_bwd_plain(
            fine, x, g, False, bf, stash=st))
        del st
        readings["F"] = hold("F Inf g", fm.fused_nerf_bwd_remat_cuda(
            fine, x, g, False, bf), fm.fused_nerf_bwd_plain(fine, x, g, False,
                                                            bf))
        xr = x.T.contiguous()
        emb = torch.cat([posenc(xr[:, :3], 10), posenc(xr[:, 3:6], 4)],
                        -1).contiguous()
        gh = g.T.contiguous()
        gh[:, 4:] = 0.0
        dx, dw, db = fm.fused_nerf_bwd_dx_cuda(fine, emb, gh, False, bf)
        rdx, rw, rb = fm.fused_nerf_bwd_dx_plain(fine, emb, gh, False, bf)
        readings["H"] = max(hold("H Inf g", (dw, db), (rw, rb)),
                            nonfinite_hold("H Inf g dx", dx, rdx,
                                           TOL_TRAIN[bf][0]))
        torch.cuda.synchronize()
    log("[nan] every kernel keeps the plain version's NaN and Inf positions; "
        "finite readings: " + ", ".join(f"{k} {v:.2e}"
                                        for k, v in readings.items()))
    return readings


# --------------------------------------------------- the optimisers' first op
def optimizer_first_difference() -> dict:
    """adamw's update (the port's ``Adam`` with decoupled weight decay)
    replayed op by op on the card and on the CPU over the 13 steps of
    ``optimizers_card_vs_cpu``: each op is run on both devices from the
    CPU's inputs, so a difference is the op's own; the count of values each
    op gives otherwise, held to 0 for every op but float32 ``torch.sqrt``,
    the one op whose card and CPU versions round otherwise (PERF.md §7)."""
    from nerf_pl_tpu_torch.models.nerf import init_nerf
    from nerf_pl_tpu_torch.training import optim

    gen = torch.Generator().manual_seed(13)
    models = {k: init_nerf(gen, device="cpu") for k in ("coarse", "fine")}
    opt = optim.get_optimizer(
        "adamw", optim.make_lr_schedule(5e-4, "steplr", 5, 3,
                                        decay_step=(1,), decay_gamma=0.5),
        optim.named_params(models), weight_decay=1e-2)
    b1, b2, eps, wd = opt.b1, opt.b2, opt.eps, opt.weight_decay
    ops = ("(1-b1)*g", "b1*mu", "mu'", "g*g", "(1-b2)*g2", "b2*nu", "nu'",
           "mu'/c1", "nu'/c2", "sqrt", "+eps", "mu_hat/den",
           "wd*p", "u+wd*p", "lr*u", "p+upd")
    differ = dict.fromkeys(ops, 0)
    first = None
    gen_g = torch.Generator().manual_seed(14)
    total = 0
    for step in range(13):
        lr = torch.tensor(-opt.schedule(opt.sched_count), dtype=torch.float32)
        host = torch.stack(opt._scalars() + [lr])
        card = host.cuda()
        for k, p in opt.params.items():
            g = torch.randn(p.shape, generator=gen_g) * 0.1
            p.grad = g
            mu, nu = opt.mu[k], opt.nu[k]
            total += p.numel()
            chain = [
                ("(1-b1)*g", lambda a, s: (1 - b1) * a["g"]),
                ("b1*mu", lambda a, s: b1 * a["mu"]),
                ("mu'", lambda a, s: a["(1-b1)*g"] + a["b1*mu"]),
                ("g*g", lambda a, s: a["g"] * a["g"]),
                ("(1-b2)*g2", lambda a, s: (1 - b2) * a["g*g"]),
                ("b2*nu", lambda a, s: b2 * a["nu"]),
                ("nu'", lambda a, s: a["(1-b2)*g2"] + a["b2*nu"]),
                ("mu'/c1", lambda a, s: a["mu'"] / s[0]),
                ("nu'/c2", lambda a, s: a["nu'"] / s[1]),
                ("sqrt", lambda a, s: torch.sqrt(a["nu'/c2"])),
                ("+eps", lambda a, s: a["sqrt"] + eps),
                ("mu_hat/den", lambda a, s: a["mu'/c1"] / a["+eps"]),
                ("wd*p", lambda a, s: wd * a["p"]),
                ("u+wd*p", lambda a, s: a["mu_hat/den"] + a["wd*p"]),
                ("lr*u", lambda a, s: s[-1] * a["u+wd*p"]),
                ("p+upd", lambda a, s: a["p"] + a["lr*u"]),
            ]
            a = {"g": g, "mu": mu.clone(), "nu": nu.clone(),
                 "p": p.detach().clone()}
            for name, fn in chain:
                on_cpu = fn(a, host)
                on_card = fn({k2: v.cuda() for k2, v in a.items()}, card).cpu()
                n = int((on_card != on_cpu).sum())
                differ[name] += n
                if n and first is None:
                    first = (step, k, name, n)
                a[name] = on_cpu
        opt.step()
    log(f"[optim first op] adamw replayed op by op on the card and the CPU "
        f"from the CPU's inputs, 13 steps, {total:,} values an op: values "
        f"each op gives otherwise on the card: {differ}; first: "
        + ("none" if first is None else
           f"step {first[0]}, {first[1]}, op {first[2]} ({first[3]} values)"))
    # every op but the square root gives the same bits on both devices
    off = {k: v for k, v in differ.items() if v and k != "sqrt"}
    if off:
        raise AssertionError(f"the optimiser's ops give other bits on the "
                             f"card: {off}")
    return dict(differ=differ, first=first)


# ---------------------------------------------------------------- phase 11
# Distribution and streaming.  The card machine has one GPU, so the
# collectives run three ways: one rank of an NCCL group of one (the
# gradient all-reduce and every collective issued, on the card); two gloo
# ranks sharing the one card with CUDA tensors (the mean of two ranks'
# grads and the gathered light cache); and the streamed fit in this
# process.  No two-card run is possible here.
# The sampled-light cancellation (Queue 3): the grads' sums over points
# compared with the sums of their terms' magnitudes (scripts/
# light_sampler_census.py) at chip_smoke's LightSampler step.
# RGBSM's f32 grads, two ranks against one process's mean loss (max and
# mean of |diff| over each tensor's largest): the light's sums run over
# halves and the cotangents meet in another order, so rounding only; an
# H100 80GB HBM3 at 700 W read 3.175e-6 and 7.053e-7, and the CPU test of
# the same comparison (test_torch_port_distributed.py) holds the vanilla
# step's 1e-5 and 1e-6
DIST_RGBSM_TOL = (1e-5, 1e-6)
# epochs timed in turns (A B B A, this many rounds) where phase 11 sets two
# ways of training the same rows side by side
TURN_ROUNDS = 2


def train_argv(tmp: str, name: str, extra=()) -> list:
    """Phase 4's training flags (``train_end_to_end``) under ``name``."""
    return ["--root_dir", os.path.join(tmp, "scene"), "--dataset_name",
            "blender", "--img_wh", str(TRAIN_WH), str(TRAIN_WH),
            "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE),
            "--batch_size", str(TRAIN_BATCH), "--num_epochs", "2",
            "--lr", "5e-4", "--white_back", "true",
            "--compute_dtype", "bfloat16", "--exp_name", name,
            "--log_dir", os.path.join(tmp, "logs"),
            "--ckpt_dir", os.path.join(tmp, "ckpts"), *extra]


def fit_rates(tmp: str, name: str) -> tuple:
    with open(os.path.join(tmp, "logs", name, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "train/loss" in r]
    return ([r["train/loss"] for r in epochs],
            [r["train/rays_per_s"] for r in epochs])


def vanilla_draws(seed: int, rows: int, device) -> dict:
    """The vanilla step's random draws (perturb, noise, importance) from a
    seed, for a step that two processes must repeat exactly."""
    g = torch.Generator().manual_seed(seed)
    n = N_SAMPLES + N_IMPORTANCE
    return {k: v.to(device) for k, v in {
        "perturb_rand": torch.rand((rows, N_SAMPLES), generator=g),
        "noise_coarse": torch.randn((rows, N_SAMPLES), generator=g),
        "u": torch.rand((rows, N_IMPORTANCE), generator=g),
        "jitter": torch.rand((rows, N_IMPORTANCE), generator=g),
        "noise_fine": torch.randn((rows, n), generator=g)}.items()}


def role_nccl1(spec: dict) -> None:
    """One rank of an NCCL group of one (the environment ``torchrun`` sets):
    phase 4's fit through the trainer, then one step's launches, collectives
    and synchronising calls."""
    import torch.distributed as dist

    from nerf_pl_tpu_torch.config import get_opts
    from nerf_pl_tpu_torch.parallel import mesh as pm
    from nerf_pl_tpu_torch.training.trainer import NeRFSystem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_opts(spec["argv"])
    torch.cuda.synchronize()
    reset_counts()
    pm.reset_counts()
    t0 = time.perf_counter()
    system = NeRFSystem(cfg, device="cuda")
    if not (system.mesh.distributed and system.mesh.size == 1
            and dist.get_backend() == "nccl"):
        raise AssertionError(f"not an NCCL group of one: {system.mesh}")
    system.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_counts, fit_coll = read_counts(), dict(pm.COUNTS)
    rays, rgbs = system.rays[:TRAIN_BATCH], system.rgbs[:TRAIN_BATCH]
    torch.cuda.synchronize()
    reset_counts()
    pm.reset_counts()
    system.train_step(rays, rgbs)
    torch.cuda.synchronize()
    per_step, step_coll = read_counts(), dict(pm.COUNTS)
    syncs = step_syncs(system, tag="dist nccl1")
    prof = profile_device("one step, NCCL group of one",
                          lambda: system.train_step(rays, rgbs), top=6)
    # the same system's epochs with and without its all-reduce, in turns
    reducer = system._reducer
    turns = {"group": [], "none": []}
    for t in ("group", "none", "none", "group") * TURN_ROUNDS:
        system._reducer = reducer if t == "group" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.train_epoch(2, 0)
        torch.cuda.synchronize()
        turns[t].append(system.steps_per_epoch * TRAIN_BATCH
                        / (time.perf_counter() - t0))
    system._reducer = reducer
    with open(spec["out"], "w") as f:
        json.dump(dict(fit_counts=fit_counts, fit_collectives=fit_coll,
                       per_step=per_step, step_collectives=step_coll,
                       syncs=syncs, profile=prof, wall_s=wall, turns=turns,
                       steps_per_epoch=system.steps_per_epoch), f)
    dist.destroy_process_group()


def role_gloo2(spec: dict) -> None:
    """One of two gloo ranks sharing ``cuda:0``: one vanilla step and one
    ``RGBSMSystem --grad_on_light`` step on this rank's rows with seeded
    draws; rank 0 also forms the same steps' mean in one process; then a
    1-epoch vanilla fit, and the ranks' parameters compared."""
    import hashlib

    import torch.distributed as dist

    from nerf_pl_tpu_torch.config import get_opts
    from nerf_pl_tpu_torch.ops.rendering import render_rays
    from nerf_pl_tpu_torch.parallel import mesh as pm
    from nerf_pl_tpu_torch.training.losses import loss_dict
    from nerf_pl_tpu_torch.training.shadow_systems import RGBSMSystem
    from nerf_pl_tpu_torch.training.trainer import NeRFSystem, init_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = int(os.environ["RANK"])
    dev = torch.device(spec.get("device", "cuda:0"))  # both ranks: one card
    pm.initialize_distributed(dev, backend="gloo")
    out = dict(rank=r)

    def grads_of(models):
        return {f"{k}/{n}": (torch.zeros_like(p) if p.grad is None
                             else p.grad.detach().clone())
                for k, m in models.items() for n, p in m.named_parameters()}

    # the vanilla step
    cfg = get_opts(spec["vanilla_argv"])
    system = NeRFSystem(cfg, device=dev)
    B = spec.get("batch", TRAIN_BATCH)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    reset_counts()
    pm.reset_counts()
    system.train_step(system.rays[:B], system.rgbs[:B],
                      overrides=vanilla_draws(100 + r, B, dev))
    sync()
    out["vanilla_step"] = dict(launches=read_counts(),
                               collectives=dict(pm.COUNTS))
    mine = grads_of(system.models)
    if r == 0:
        models = init_models(cfg, dev)  # the weights the step started from
        halves = []
        for h in range(2):
            ds = system.train_dataset
            rows = pm.shard_rays(ds.all_rays, pm.Mesh(2, h))[:B]
            cols = pm.shard_rays(ds.all_rgbs, pm.Mesh(2, h))[:B]
            res = render_rays(models["coarse"], models.get("fine"),
                              torch.from_numpy(rows).to(dev), None,
                              mode=system.mode,
                              overrides=vanilla_draws(100 + h, B, dev),
                              **system.rkw)
            for m in models.values():
                m.zero_grad(set_to_none=True)
            loss_dict[system.loss_name](res, torch.from_numpy(cols).to(dev)
                                        ).backward()
            halves.append(grads_of(models))
        differ = sum(int((mine[k] != (halves[0][k] + halves[1][k]) / 2).sum())
                     for k in mine)
        out["vanilla_differ"] = differ
        out["vanilla_values"] = sum(v.numel() for v in mine.values())

    # the joint RGB + shadow step through the gathered light cache
    sm = RGBSMSystem(get_opts(spec["rgb_sm_argv"]), device=dev)
    if not sm.shard_light:
        raise AssertionError("the light view is not split over the ranks")
    Bs = sm.cfg.batch_size
    gen = torch.Generator().manual_seed(200 + r)
    lgen = torch.Generator().manual_seed(300)  # the whole view, both ranks
    cam_ov = {k: v.to(dev) for k, v in step_draws(gen, Bs, 64).items()}
    light_ov = {k: v.to(dev) for k, v in step_draws(
        lgen, sm.light_rays.shape[0], 32).items()}
    batch = [getattr(sm, k)[:Bs] for k in sm.train_bufs]
    sync()
    reset_counts()
    pm.reset_counts()
    sm.train_step(*batch, None, 32,
                  overrides={"cam": cam_ov, "light": light_ov})
    sync()
    out["rgb_sm_step"] = dict(launches=read_counts(),
                              collectives=dict(pm.COUNTS))
    mine_sm = grads_of(sm.models)
    # rank 0 needs rank 1's batch and draws for the one-process mean
    allb = [pm.all_gather_rows(t.contiguous(), sm.mesh) for t in batch]
    if r == 0:
        models = init_models(sm.cfg, dev)
        sm.models, sm.shard_light = models, False
        saved_mesh, sm.mesh = sm.mesh, pm.Mesh(1, 0, dev)
        for m in models.values():
            m.zero_grad(set_to_none=True)
        for h in range(2):  # the mean loss's grad, one half's graph a time
            hb = [t[h * Bs:(h + 1) * Bs] for t in allb]
            rays, rgbs, sms, pixels, pidx = hb
            o, _ = sm._shadow_out(
                rays, pixels, pidx, None, 32,
                {"cam": {k: v.to(dev) for k, v in step_draws(
                    torch.Generator().manual_seed(200 + h), Bs, 64).items()},
                 "light": light_ov}, out_prefix="sm")
            (sm._loss(o, rgbs, sms)[0] / 2).backward()
            del o
        ref = grads_of(models)
        rows = grad_readings([mine_sm[k] for k in sorted(mine_sm)],
                             [ref[k] for k in sorted(ref)], sorted(ref))
        out["rgb_sm_readings"] = summarize(rows)
        sm.mesh = saved_mesh

    # a short fit: the ranks' parameters after it
    system.fit()
    h = hashlib.sha256()
    for k, m in sorted(system.models.items()):
        for n, p in m.named_parameters():
            h.update(p.detach().cpu().numpy().tobytes())
    digests = pm.process_allgather(np.frombuffer(h.digest(), np.uint8),
                                   system.mesh)
    out["fit_params_equal"] = bool((digests == digests[0]).all())
    out["fit_steps"] = system.steps_per_epoch
    with open(spec["out"].format(rank=r), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_role(role: str, spec: dict, env: dict, timeout: int = 600) -> None:
    path = spec["spec_path"]
    with open(path, "w") as f:
        json.dump(spec, f)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--role", role, path], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def wait_roles(procs: list, tag: str, timeout: int = 600) -> None:
    outs, bad = [], False
    for p in procs:
        try:
            o, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
            bad = True
        outs.append(o)
        bad |= p.returncode != 0
    for i, o in enumerate(outs):
        for line in o.splitlines():
            if line.startswith("[") and "Warning" not in line:
                log(f"[{tag} rank {i}] {line}")
    if bad:
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise AssertionError(f"{tag}: a rank failed:\n" + "\n\n".join(
            f"rc={p.returncode}\n{o[-6000:]}" for p, o in zip(procs, outs)))


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return env


def params_of(path: str) -> dict:
    from nerf_pl_tpu_torch.training.checkpoints import load_checkpoint

    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        else:
            flat[prefix] = np.asarray(node)

    walk(load_checkpoint(path)["params"], "")
    return flat


def dist_end_to_end(tmp: str, trained: dict) -> dict:
    """Phase 11: an NCCL group of one, two gloo ranks on the one card, and
    the streamed fit."""
    from nerf_pl_tpu_torch import train as train_cli
    from nerf_pl_tpu_torch.training.launch import free_port
    from nerf_pl_tpu_torch.training.trainer import NeRFSystem
    from nerf_pl_tpu_torch.config import get_opts

    import gc

    t_phase = time.perf_counter()
    # the ranks below are processes of their own on this card: hand them
    # the memory this process's allocator keeps cached from earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[dist] this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB on the card ({torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        "reserved) as the ranks start")
    # (1) one rank of an NCCL group of one, in a process of its own
    spec = dict(argv=train_argv(tmp, "smoke_nccl"),
                out=os.path.join(tmp, "nccl1.json"),
                spec_path=os.path.join(tmp, "nccl1_spec.json"))
    wait_roles([run_role("nccl1", spec, rank_env(0, 1, free_port()))],
               "dist nccl1")
    with open(spec["out"]) as f:
        nccl = json.load(f)
    steps = nccl["steps_per_epoch"]
    for k in ("A", "D", "E"):
        if nccl["per_step"][k] != trained["per_step"][k]:
            raise AssertionError(
                f"NCCL group of one: {k} {nccl['per_step'][k]} a step, the "
                f"train phase's {trained['per_step'][k]}")
    if nccl["step_collectives"]["allreduce_grads"] != 1:
        raise AssertionError(f"grad all-reduces in one step: "
                             f"{nccl['step_collectives']}")
    if nccl["fit_collectives"]["allreduce_grads"] != 2 * steps:
        raise AssertionError(f"grad all-reduces in the fit: "
                             f"{nccl['fit_collectives']} ({steps} steps/epoch)")
    if nccl["syncs"]["count"] > trained["syncs"]["count"]:
        raise AssertionError(f"synchronising calls a step: "
                             f"{nccl['syncs']} > {trained['syncs']['count']}")
    a = params_of(os.path.join(tmp, "ckpts", "smoke", "epoch=1.ckpt"))
    b = params_of(os.path.join(tmp, "ckpts", "smoke_nccl", "epoch=1.ckpt"))
    differ = sum(int((a[k] != b[k]).sum()) for k in a)
    if sorted(a) != sorted(b) or differ:
        raise AssertionError(f"NCCL group of one vs no group: {differ} "
                             "parameter values differ after the fit")
    losses, rates = fit_rates(tmp, "smoke_nccl")
    nccl["turn_medians"] = {k: float(np.median(v))
                            for k, v in nccl["turns"].items()}
    log(f"[dist] NCCL group of one: {rates[-1]:.1f} train rays/s (epoch 1) "
        f"beside the fit without a group's {trained['rays_per_s']:.1f}; "
        f"in turns over {len(nccl['turns']['group'])} epochs each (G N N G, "
        f"one process): with the all-reduce {nccl['turns']['group']}, "
        f"without {nccl['turns']['none']}, medians "
        f"{nccl['turn_medians']}; "
        f"launches a step {nccl['per_step']}; collectives a step "
        f"{nccl['step_collectives']}, in the fit {nccl['fit_collectives']}; "
        f"{nccl['syncs']['count']} synchronising calls a step; parameters "
        f"after the fit bit-equal to the fit without a group (0 of "
        f"{sum(v.size for v in a.values())} differ)")

    # (2) two gloo ranks sharing the card, with CUDA tensors
    port = free_port()
    spec = dict(vanilla_argv=train_argv(tmp, "smoke_gloo",
                                        ["--num_epochs", "1"]),
                rgb_sm_argv=["--root_dir", os.path.join(tmp, "shadow_scene"),
                             *RGBSM_FLAGS, "--num_epochs", "1",
                             "--exp_name", "gloo_rgb_sm",
                             "--log_dir", os.path.join(tmp, "logs"),
                             "--ckpt_dir", os.path.join(tmp, "ckpts")],
                out=os.path.join(tmp, "gloo2_{rank}.json"),
                spec_path=os.path.join(tmp, "gloo2_spec.json"))
    wait_roles([run_role("gloo2", spec, rank_env(r, 2, port))
                for r in range(2)], "dist gloo2")
    gloo = []
    for r in range(2):
        with open(spec["out"].format(rank=r)) as f:
            gloo.append(json.load(f))
    g0 = gloo[0]
    if g0["vanilla_differ"]:
        raise AssertionError(f"two ranks' mean grads vs (g0 + g1) / 2 in one "
                             f"process: {g0['vanilla_differ']} of "
                             f"{g0['vanilla_values']} values differ")
    rd = g0["rgb_sm_readings"]
    if rd["max_rel"] > DIST_RGBSM_TOL[0] or rd["mean_rel"] > DIST_RGBSM_TOL[1]:
        raise AssertionError(f"RGBSM two ranks vs one process: {rd} "
                             f"(limits {DIST_RGBSM_TOL})")
    for g in gloo:
        if not g["fit_params_equal"]:
            raise AssertionError("gloo ranks' parameters differ after the fit")
        st = g["rgb_sm_step"]
        for k, n in TRAINER_STEP_LAUNCHES["rgb_sm"].items():
            if st["launches"][k] != n:
                raise AssertionError(f"RGBSM rank step launches {st}")
        if (st["collectives"]["allreduce_grads"] != 1
                or st["collectives"]["all_gather_tiled"] != 4
                or g["vanilla_step"]["collectives"]["allreduce_grads"] != 1):
            raise AssertionError(f"collectives of the rank steps: {g}")
    log(f"[dist] two gloo ranks on one card (CUDA tensors): vanilla mean "
        f"grads bit-equal to (g0 + g1) / 2 in one process (0 of "
        f"{g0['vanilla_values']} differ); RGBSM --grad_on_light through the "
        f"gathered light cache vs the one-process mean loss: max rel "
        f"{rd['max_rel']:.3e} ({rd['max_name']}), mean rel "
        f"{rd['mean_rel']:.3e} ({rd['mean_name']}) (limits "
        f"{DIST_RGBSM_TOL}); launches a rank step: vanilla "
        f"{g0['vanilla_step']['launches']}, RGBSM "
        f"{g0['rgb_sm_step']['launches']}; collectives: vanilla "
        f"{g0['vanilla_step']['collectives']}, RGBSM "
        f"{g0['rgb_sm_step']['collectives']}; parameters equal on both ranks "
        f"after a {g0['fit_steps']}-step epoch")

    # (3) the streamed fit, in this process
    argv = train_argv(tmp, "smoke_stream", ["--data_device_resident", "false",
                                            "--stream_slab_steps", "16"])
    torch.cuda.synchronize()
    reset_counts()
    system = train_cli.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    counts = read_counts()
    losses, rates = fit_rates(tmp, "smoke_stream")
    steps = system.steps_per_epoch
    slabs = -(-steps // 16)
    if system.slab_copies != 2 * slabs or not all(np.isfinite(losses)) \
            or not losses[1] < losses[0]:
        raise AssertionError(f"streamed fit: {system.slab_copies} slab copies "
                             f"(want {2 * slabs}), losses {losses}")
    torch.cuda.synchronize()
    reset_counts()
    copies0 = system.slab_copies
    prof_s = profile_device(f"one streamed epoch ({steps} steps, {slabs} "
                            "slabs)", lambda: system.train_epoch(2, 0), top=6)
    torch.cuda.synchronize()
    epoch_counts = read_counts()
    copies = system.slab_copies - copies0
    per_step = {k: epoch_counts[k] / steps for k in ("A", "D", "E")}
    if copies != slabs or per_step != {k: trained["per_step"][k]
                                       for k in ("A", "D", "E")}:
        raise AssertionError(f"streamed epoch: {copies} copies, launches "
                             f"{epoch_counts}")
    resident = NeRFSystem(get_opts(train_argv(tmp, "smoke_resident")),
                          device="cuda")
    resident.train_epoch(0, 0)  # warm
    prof_r = profile_device(f"one resident epoch ({steps} steps)",
                            lambda: resident.train_epoch(1, 0), top=6)
    turns = {"resident": [], "stream": []}
    for t in ("resident", "stream", "stream", "resident") * TURN_ROUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (resident if t == "resident" else system).train_epoch(3, 0)
        torch.cuda.synchronize()
        turns[t].append(steps * TRAIN_BATCH / (time.perf_counter() - t0))
    turn_medians = {k: float(np.median(v)) for k, v in turns.items()}
    resident.logger.close()
    idle = {k: (None if p["busy_ms"] is None else
                1 - p["busy_ms"] / p["wall_ms"])
            for k, p in (("stream", prof_s), ("resident", prof_r))}
    log(f"[dist] streamed fit: {rates[-1]:.1f} train rays/s (epoch 1) beside "
        f"the resident fit's {trained['rays_per_s']:.1f}; {slabs} slab copies "
        f"an epoch (one pinned host-to-device copy each, {copies} counted); "
        f"launches a step {per_step}; device idle share of an epoch: "
        f"streamed {idle['stream']}, resident {idle['resident']}; train "
        f"rays/s in turns over {len(turns['stream'])} epochs each (R S S R, "
        f"one process): streamed {turns['stream']}, resident "
        f"{turns['resident']}, medians {turn_medians}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(nccl=nccl, gloo=gloo, stream=dict(
        counts=counts, rays_per_s=rates, per_step=per_step,
        epoch_counts=epoch_counts, slab_copies=copies, profile=prof_s,
        resident_profile=prof_r, idle=idle, turns=turns,
        turn_medians=turn_medians),
        nccl_rays_per_s=fit_rates(tmp, "smoke_nccl")[1],
        seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- phase 12
# The image readers.  The card's machine has no PIL and no encoder: the
# files are written with the tests' numpy writer (tests/image_writers.py),
# from the same 8-bit images as baseline files, and each load is held bit
# for bit against the baseline's (the same JPEG coefficients, the PNGs' high
# bytes).  The fern-size decode: one MCU row of 4032x16 at quality 95, 4:2:0,
# stacked 189 times as 189 restart intervals (a 4032x3024 file whose every
# entropy-coded byte the decoder reads).
FERN_W, FERN_STRIP, FERN_ROWS = 4032, 16, 189
# one vanilla Blender step: a coarse and a fine pass through D and E, one
# importance sampling (A), as an LLFF step
VANILLA_STEP_LAUNCHES = LLFF_STEP_LAUNCHES


def image_writers():
    """``tests/image_writers.py`` of this checkout (test support)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import image_writers as writers

    return writers


def one_step_launches(tag: str, step, want: dict) -> dict:
    torch.cuda.synchronize()
    reset_counts()
    step()
    torch.cuda.synchronize()
    got = read_counts()
    log(f"[readers] {tag}: launches in one step {got}")
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"one {tag} step launched {got}, expected {want}")
    return got


def same_rgbs(tag: str, a: np.ndarray, b: np.ndarray) -> None:
    if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"{tag}: the loads differ from the baseline "
                             "files'")


def readers_llff(tmp: str, W) -> dict:
    """Phase 9's scene as baseline JPEGs and as progressive ones of the same
    coefficients (view 1 arithmetic-coded): the loads bit-equal, then the
    LLFF fit and the ``test_train`` eval on the progressive scene."""
    import glob
    import shutil

    from nerf_pl_tpu_torch.data.image import convert, read_picture
    from nerf_pl_tpu_torch.data.llff import LLFFDataset

    src = os.path.join(tmp, "llff_scene")
    roots = {k: os.path.join(tmp, f"llff_{k}") for k in ("baseline", "prog")}
    t0 = time.perf_counter()
    sizes = {}
    for root in roots.values():
        os.makedirs(os.path.join(root, "images"))
        shutil.copy(os.path.join(src, "poses_bounds.npy"), root)
    views = sorted(glob.glob(os.path.join(src, "images", "*.png")))
    for i, view in enumerate(views):
        rgb = convert(read_picture(view), "RGB").astype(np.float64)
        frame = W.frame_from_planes(W.rgb_to_ycc(rgb), [(2, 2), (1, 1), (1, 1)],
                                    95)
        files = {"baseline": W.jpeg_bytes(frame),
                 "prog": W.jpeg_bytes(frame, progressive=True,
                                      coding="arith" if i == 1 else "huffman")}
        for k, data in files.items():
            with open(os.path.join(roots[k], "images", f"{i:03d}.jpg"),
                      "wb") as f:
                f.write(data)
            sizes.setdefault(k, []).append(len(data))
    write_s = time.perf_counter() - t0
    for split in ("train", "val"):
        a, b = (LLFFDataset(r, split=split, img_wh=LLFF_WH)
                for r in (roots["baseline"], roots["prog"]))
        if split == "train":
            same_rgbs("llff train", a.all_rgbs, b.all_rgbs)
        else:
            same_rgbs("llff val", a[0]["rgbs"], b[0]["rgbs"])
    log(f"[readers] llff: {len(views)} views of {LLFF_WH[0]}x{LLFF_WH[1]} "
        f"as baseline JPEGs {sizes['baseline']} bytes and progressive ones "
        f"(view 1 arithmetic-coded) {sizes['prog']} bytes, written in "
        f"{write_s:.1f} s; train and val loads bit-equal")
    fit = trainer_fit(tmp, "train", roots["prog"], "llff_prog", LLFF_FLAGS, 1,
                      "readers")
    system = fit["system"]
    rays, rgbs = system.rays[:LLFF_BATCH], system.rgbs[:LLFF_BATCH]
    per_step = one_step_launches(
        "llff (progressive JPEGs)", lambda: system.train_step(rays, rgbs),
        LLFF_STEP_LAUNCHES)
    del system, rays, rgbs, fit["system"]
    ckpt = os.path.join(tmp, "ckpts", "llff_prog", "epoch=0.ckpt")
    ev = llff_eval(tmp, roots["prog"], ckpt, "test_train", LLFF_WH, "_prog")
    return dict(fit=fit, per_step=per_step, eval=ev, bytes=sizes)


def readers_blender(tmp: str, W) -> dict:
    """Phase 4's scene with every train and val frame as a 16-bit RGBA PNG
    and train view 0 (its colours first cut to 4 levels a channel, in both
    copies) as a palette + tRNS Adam7 PNG: the loads bit-equal to the 8-bit
    copy's, then a 1-epoch fit at phase 4's flags."""
    import shutil

    from nerf_pl_tpu_torch.data.blender import BlenderDataset
    from nerf_pl_tpu_torch.data.png import read_png, write_png

    base, wide = (os.path.join(tmp, n) for n in ("scene_8bit", "scene_16bit"))
    shutil.copytree(os.path.join(tmp, "scene"), base)
    shutil.copytree(os.path.join(tmp, "scene"), wide)
    first = os.path.join("train", "r_0.png")
    img, _ = read_png(os.path.join(base, first))
    write_png(os.path.join(base, first), (img // 64) * 85)
    modes = {}
    for split, n in (("train", TRAIN_VIEWS), ("val", 1)):
        for i in range(n):
            name = os.path.join(split, f"r_{i}.png")
            img, _ = read_png(os.path.join(base, name))
            layout = "palette-adam7" if name == first else "rgba16"
            with open(os.path.join(wide, name), "wb") as f:
                f.write(W.layout_bytes(img, layout, seed=i))
            modes[layout] = modes.get(layout, 0) + 1
    kw = dict(img_wh=(TRAIN_WH, TRAIN_WH), near=2.0, far=6.0)
    for split in ("train", "val"):
        a, b = (BlenderDataset(r, split, **kw) for r in (base, wide))
        if split == "train":
            same_rgbs("blender train", a.all_rgbs, b.all_rgbs)
        else:
            same_rgbs("blender val", a[0]["rgbs"], b[0]["rgbs"])
    log(f"[readers] blender: frames rewritten as {modes}; train and val "
        "loads bit-equal to the 8-bit copy's")
    flags = ["--dataset_name", "blender", "--img_wh", str(TRAIN_WH),
             str(TRAIN_WH), "--N_samples", str(N_SAMPLES), "--N_importance",
             str(N_IMPORTANCE), "--batch_size", str(TRAIN_BATCH), "--lr",
             "5e-4", "--white_back", "true", "--compute_dtype", "bfloat16"]
    fit = trainer_fit(tmp, "train", wide, "blender16", flags, 1, "readers")
    system = fit["system"]
    rays, rgbs = system.rays[:TRAIN_BATCH], system.rgbs[:TRAIN_BATCH]
    per_step = one_step_launches(
        "blender (16-bit and palette PNGs)",
        lambda: system.train_step(rays, rgbs), VANILLA_STEP_LAUNCHES)
    del system, rays, rgbs, fit["system"]
    return dict(fit=fit, per_step=per_step, layouts=modes)


def readers_shadow(tmp: str, W) -> dict:
    """Phase 7's shadow scene with its shadow maps as palette PNGs: the
    loads bit-equal, then a 1-epoch ``--grad_on_light`` fit."""
    import glob
    import shutil

    from nerf_pl_tpu_torch.data.blender_efficient_sm import \
        BlenderEfficientShadows
    from nerf_pl_tpu_torch.data.png import read_png

    src = os.path.join(tmp, "shadow_scene")
    pal = os.path.join(tmp, "shadow_palette")
    shutil.copytree(src, pal)
    maps = sorted(glob.glob(os.path.join(pal, "sm_*.png")))
    for path in maps:
        img, _ = read_png(path)
        with open(path, "wb") as f:
            f.write(W.layout_bytes(img, "palette"))
    for split in ("train", "val"):
        a, b = (BlenderEfficientShadows(r, split, img_wh=(SHADOW_WH, SHADOW_WH))
                for r in (src, pal))
        if split == "train":
            same_rgbs("efficient_sm train", a.all_rgbs, b.all_rgbs)
        else:
            same_rgbs("efficient_sm val", a[0]["rgbs"], b[0]["rgbs"])
    log(f"[readers] efficient_sm: {len(maps)} shadow maps as palette PNGs; "
        "train and val loads bit-equal")
    fit = shadow_fit(tmp, pal, "sm_palette", ["--grad_on_light"], 1)
    system = fit["system"]
    batch = tuple(t[:SHADOW_BATCH] for t in (system.rays, system.rgbs,
                                             system.pixels, system.pose_idx))
    cache = system.empty_light_cache()
    per_step = one_step_launches(
        "efficient_sm (palette shadow maps)",
        lambda: system.train_step(*batch, cache, SHADOW_LIGHT_N),
        SHADOW_STEP_LAUNCHES)
    del system, batch, fit["system"]
    return dict(fit=fit, per_step=per_step)


def fern_size_decodes(W) -> dict:
    """A 4032x3024 q95 4:2:0 JPEG as a baseline and as a progressive file of
    the same coefficients, decoded on this machine's host: the whole decode
    and its stages, and for the baseline file the plain Python entropy loop
    (its coefficients equal the C++ stage's); the two decodes bit-equal."""
    from nerf_pl_tpu_torch.data import jpeg

    x = np.arange(FERN_W, dtype=np.float64)[None, :]
    y = np.arange(FERN_STRIP, dtype=np.float64)[:, None]
    rgb = np.stack([128 + 100 * np.sin(x / 37) + 0 * y,
                    128 + 100 * np.cos(y / 5) + 0 * x,
                    128 + 60 * np.sin((x + y) / 51)], -1)
    rgb += np.random.RandomState(0).normal(0, 6, rgb.shape)
    frame = W.frame_from_planes(W.rgb_to_ycc(np.clip(rgb, 0, 255)),
                                [(2, 2), (1, 1), (1, 1)], 95)
    jpeg._native()  # built before the clock starts
    out, pixels = {}, {}
    for kind, kw in (("baseline", {}), ("progressive", dict(progressive=True))):
        data = W.jpeg_bytes(frame, repeat=FERN_ROWS, **kw)
        stages = {}
        t0 = time.perf_counter()
        pixels[kind], mode = jpeg.decode(data, seconds=stages)
        whole = time.perf_counter() - t0
        if pixels[kind].shape != (FERN_STRIP * FERN_ROWS, FERN_W, 3):
            raise AssertionError(f"fern-size decode shape {pixels[kind].shape}")
        out[kind] = dict(bytes=len(data), s=whole, stages=stages)
        if kind == "baseline":
            native_frame = jpeg._decode(data)[0]
            t0 = time.perf_counter()
            plain_frame = jpeg._decode(data, plain=True)[0]
            out[kind]["plain_entropy_s"] = time.perf_counter() - t0
            if not all(np.array_equal(a, b) for a, b in
                       zip(native_frame.coef, plain_frame.coef)):
                raise AssertionError("the C++ entropy stage's coefficients "
                                     "differ from the plain loop's")
    if not np.array_equal(pixels["baseline"], pixels["progressive"]):
        raise AssertionError("the progressive file decodes otherwise than "
                             "the baseline file of its coefficients")
    b, p = out["baseline"], out["progressive"]
    log(f"[readers] {FERN_W}x{FERN_STRIP * FERN_ROWS} q95 4:2:0 JPEG on the "
        f"host ({gpu_line()}): baseline {b['bytes']:,} bytes, decode "
        f"{b['s']:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in
                                        b["stages"].items())
        + f"), the plain Python entropy loop {b['plain_entropy_s']:.2f} s "
        f"(coefficients equal); progressive {p['bytes']:,} bytes, decode "
        f"{p['s']:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in
                                        p["stages"].items())
        + "), pixels equal to the baseline file's")
    return out


def readers_end_to_end(tmp: str) -> dict:
    """Phase 12: the fits on the new layouts and the fern-size decodes."""
    t0 = time.perf_counter()
    W = image_writers()
    out = dict(llff=readers_llff(tmp, W), blender=readers_blender(tmp, W),
               shadow=readers_shadow(tmp, W), fern=fern_size_decodes(W))
    out["seconds"] = time.perf_counter() - t0
    log(f"[readers] phase 12: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 13
# The other containers.  The lossy WebP views are committed fixtures (this
# machine has no encoder): Pillow encoded them from the synthetic LLFF scene
# of phase 9 (tests/data/webp/make_webp_fixtures.py), and digests.json holds
# the SHA-256 of Pillow's decode of each.  The lossless layouts are written
# here by the tests' numpy writer from the PNG scenes' 8-bit images, so each
# load is held bit for bit against the PNG scene's.  The fern-size decodes:
# a 4032x3024 image (the 16-row strip of phase 12 tiled 189 times) as a
# lossless WebP (subtract-green, literals) and as an 8-bit RGB TIFF of
# 16-row LZW + predictor 2 strips.
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "webp")
LOSSY_DECODE_REPEATS = 5


def fixture_digests() -> dict:
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def sha256_of(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def formats_llff(tmp: str) -> dict:
    """Phase 9's scene with its views as the lossy WebP fixtures (each
    decode held to Pillow's recorded digest, and the VP8 decode rate), then
    the LLFF fit and its ``test_train`` eval."""
    import shutil

    from nerf_pl_tpu_torch.data import webp
    from nerf_pl_tpu_torch.data.image import read_picture

    digests = fixture_digests()
    root = os.path.join(tmp, "llff_webp")
    os.makedirs(os.path.join(root, "images"))
    shutil.copy(os.path.join(tmp, "llff_scene", "poses_bounds.npy"), root)
    webp._native()  # built before the clock starts
    pixels, seconds = 0, 0.0
    for name in sorted(k for k in digests if k.endswith(".webp")):
        path = os.path.join(FIXTURES, name)
        pic = read_picture(path)
        rec = digests[name]
        if (pic.mode != rec["mode"] or list(pic.pixels.shape) != rec["shape"]
                or sha256_of(pic.pixels) != rec["sha256"]):
            raise AssertionError(f"{name}: the decode differs from Pillow's "
                                 "recorded digest")
        if name.startswith("llff_"):
            shutil.copy(path, os.path.join(root, "images", name))
            with open(path, "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            for _ in range(LOSSY_DECODE_REPEATS):
                webp.decode(data)
            seconds += time.perf_counter() - t0
            pixels += LOSSY_DECODE_REPEATS * pic.pixels.shape[0] * \
                pic.pixels.shape[1]
    rate = pixels / seconds / 1e6
    log(f"[formats] {len(digests) - 1} WebP fixtures decoded to Pillow's "
        f"recorded digests; lossy VP8 on the host ({gpu_line()}): "
        f"{rate:.2f} megapixels/s over the 504x378 views")
    fit = trainer_fit(tmp, "train", root, "llff_webp", LLFF_FLAGS, 1,
                      "formats")
    system = fit["system"]
    rays, rgbs = system.rays[:LLFF_BATCH], system.rgbs[:LLFF_BATCH]
    per_step = one_step_launches(
        "llff (lossy WebP)", lambda: system.train_step(rays, rgbs),
        LLFF_STEP_LAUNCHES)
    del system, rays, rgbs, fit["system"]
    ckpt = os.path.join(tmp, "ckpts", "llff_webp", "epoch=0.ckpt")
    ev = llff_eval(tmp, root, ckpt, "test_train", LLFF_WH, "_webp")
    return dict(fit=fit, per_step=per_step, eval=ev, vp8_mpix_s=rate)


def formats_blender(tmp: str, W) -> dict:
    """Phase 4's scene with every train and val frame as a 16-bit RGBA TIFF
    (LZW + predictor 2 in 16-row strips; train view 0 in 32x32 tiles) under
    its ``.png`` name: the loads bit-equal to the PNG scene's, then a
    1-epoch fit at phase 4's flags."""
    import shutil

    from nerf_pl_tpu_torch.data.blender import BlenderDataset
    from nerf_pl_tpu_torch.data.png import read_png

    base = os.path.join(tmp, "scene")
    wide = os.path.join(tmp, "scene_tiff")
    shutil.copytree(base, wide)
    for split, n in (("train", TRAIN_VIEWS), ("val", 1)):
        for i in range(n):
            name = os.path.join(split, f"r_{i}.png")
            img, _ = read_png(os.path.join(base, name))
            tile = (32, 32) if (split, i) == ("train", 0) else None
            with open(os.path.join(wide, name), "wb") as f:
                f.write(W.tiff_bytes(img.astype(np.uint16) * 257, 2, 16,
                                     extra=(2,), compression=5, predictor=2,
                                     tile=tile, rows_per_strip=None if tile
                                     else 16))
    kw = dict(img_wh=(TRAIN_WH, TRAIN_WH), near=2.0, far=6.0)
    for split in ("train", "val"):
        a, b = (BlenderDataset(r, split, **kw) for r in (base, wide))
        if split == "train":
            same_rgbs("blender tiff train", a.all_rgbs, b.all_rgbs)
        else:
            same_rgbs("blender tiff val", a[0]["rgbs"], b[0]["rgbs"])
    log("[formats] blender: every frame a 16-bit RGBA LZW TIFF (view 0 "
        "tiled); train and val loads bit-equal to the PNG scene's")
    flags = ["--dataset_name", "blender", "--img_wh", str(TRAIN_WH),
             str(TRAIN_WH), "--N_samples", str(N_SAMPLES), "--N_importance",
             str(N_IMPORTANCE), "--batch_size", str(TRAIN_BATCH), "--lr",
             "5e-4", "--white_back", "true", "--compute_dtype", "bfloat16"]
    fit = trainer_fit(tmp, "train", wide, "blender_tiff", flags, 1, "formats")
    system = fit["system"]
    rays, rgbs = system.rays[:TRAIN_BATCH], system.rgbs[:TRAIN_BATCH]
    per_step = one_step_launches(
        "blender (16-bit TIFFs)", lambda: system.train_step(rays, rgbs),
        VANILLA_STEP_LAUNCHES)
    del system, rays, rgbs, fit["system"]
    return dict(fit=fit, per_step=per_step)


def formats_shadow(tmp: str, W, phase7_loss: float) -> dict:
    """Phase 7's shadow scene with its maps as BMP, PPM and GIF (in turn)
    under their ``sm_*.png`` names: the loads bit-equal, then a 1-epoch
    ``--grad_on_light`` fit whose epoch-0 loss must equal phase 7's."""
    import glob
    import shutil

    from nerf_pl_tpu_torch.data.blender_efficient_sm import \
        BlenderEfficientShadows
    from nerf_pl_tpu_torch.data.png import read_png

    src = os.path.join(tmp, "shadow_scene")
    root = os.path.join(tmp, "shadow_formats")
    shutil.copytree(src, root)
    kinds = {}
    for k, path in enumerate(sorted(glob.glob(os.path.join(root, "sm_*.png")))):
        img, _ = read_png(path)
        kind = ("bmp", "ppm", "gif")[k % 3]
        if kind == "bmp":
            data = W.bmp_bytes(img, 24)
        elif kind == "ppm":
            data = W.ppm_bytes(img, b"P6")
        else:
            idx, pal, _ = W.palette_of(img)
            data = W.gif_bytes(idx, pal)
        with open(path, "wb") as f:
            f.write(data)
        kinds[kind] = kinds.get(kind, 0) + 1
    for split in ("train", "val"):
        a, b = (BlenderEfficientShadows(r, split, img_wh=(SHADOW_WH, SHADOW_WH))
                for r in (src, root))
        if split == "train":
            same_rgbs("efficient_sm formats train", a.all_rgbs, b.all_rgbs)
        else:
            same_rgbs("efficient_sm formats val", a[0]["rgbs"], b[0]["rgbs"])
    log(f"[formats] efficient_sm: shadow maps as {kinds}; train and val "
        "loads bit-equal")
    fit = shadow_fit(tmp, root, "sm_formats", ["--grad_on_light"], 1)
    if fit["losses"][0] != phase7_loss:
        raise AssertionError(f"efficient_sm on BMP/PPM/GIF maps: epoch-0 loss "
                             f"{fit['losses'][0]!r}, phase 7's {phase7_loss!r}")
    log(f"[formats] efficient_sm epoch-0 loss {fit['losses'][0]!r}, equal to "
        "phase 7's on the PNG maps")
    system = fit["system"]
    batch = tuple(t[:SHADOW_BATCH] for t in (system.rays, system.rgbs,
                                             system.pixels, system.pose_idx))
    cache = system.empty_light_cache()
    per_step = one_step_launches(
        "efficient_sm (BMP, PPM, GIF maps)",
        lambda: system.train_step(*batch, cache, SHADOW_LIGHT_N),
        SHADOW_STEP_LAUNCHES)
    del system, batch, fit["system"]
    return dict(fit=fit, per_step=per_step, maps=kinds)


def fern_size_formats(W) -> dict:
    """A 4032x3024 image as a lossless WebP and as an LZW TIFF, each
    written here and decoded on this machine's host by stage; both decodes
    equal to the image."""
    from nerf_pl_tpu_torch.data import tiff, webp

    x = np.arange(FERN_W, dtype=np.float64)[None, :]
    y = np.arange(FERN_STRIP, dtype=np.float64)[:, None]
    rgb = np.stack([128 + 100 * np.sin(x / 37) + 0 * y,
                    128 + 100 * np.cos(y / 5) + 0 * x,
                    128 + 60 * np.sin((x + y) / 51)], -1)
    rgb += np.random.RandomState(0).normal(0, 6, rgb.shape)
    img = np.tile(np.clip(rgb, 0, 255).astype(np.uint8), (FERN_ROWS, 1, 1))
    webp._native()
    tiff._native()
    out = {}
    t0 = time.perf_counter()
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)],
                          -1)
    files = {"webp": W.webp_container(W.vp8l_bytes(
                 rgba, ("subtract_green",), alpha_hint=False), b"VP8L"),
             "tiff": W.tiff_bytes(img, 2, 8, compression=5, predictor=2,
                                  rows_per_strip=FERN_STRIP)}
    write_s = time.perf_counter() - t0
    for kind, data in files.items():
        stages = {}
        t0 = time.perf_counter()
        if kind == "webp":
            px, _ = webp.decode(data, seconds=stages)
        else:
            px = tiff.decode(data, seconds=stages)[0]
        whole = time.perf_counter() - t0
        if not np.array_equal(px, img):
            raise AssertionError(f"the fern-size {kind} decodes otherwise than "
                                 "its image")
        out[kind] = dict(bytes=len(data), s=whole, stages=stages)
        log(f"[formats] {FERN_W}x{FERN_STRIP * FERN_ROWS} {kind} on the host "
            f"({gpu_line()}): {len(data):,} bytes, decode {whole:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + "), pixels equal")
    out["write_s"] = write_s
    return out


def formats_end_to_end(tmp: str, phase7_loss: float) -> dict:
    """Phase 13: the fits on the other containers and the fern-size
    decodes."""
    t0 = time.perf_counter()
    W = image_writers()
    out = dict(llff=formats_llff(tmp), blender=formats_blender(tmp, W),
               shadow=formats_shadow(tmp, W, phase7_loss),
               fern=fern_size_formats(W))
    out["seconds"] = time.perf_counter() - t0
    log(f"[formats] phase 13: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 14
# The repo's other entry points, on the port.  The orbit render of phase 4's
# full-width fit at 200x200 (the script's defaults otherwise: radius 4,
# height 0.5, 64 + 64 samples, near 2, far 6, float32): 40,000 rays a pose
# in two chunks of at most 32,768, each a coarse and a fine pass through C
# (channel-major) and one importance sampling through B.
ORBIT_WH, ORBIT_POSES, ORBIT_SIGMA_POSES = 200, 24, 8
ORBIT_CHUNKS = -(-ORBIT_WH ** 2 // EVAL_CHUNK)
ORBIT_POSE_LAUNCHES = {"A": 0, "B": ORBIT_CHUNKS, "C": 2 * ORBIT_CHUNKS,
                       "C'": 0, "D": 0, "E": 0}
# One pose through the kernels against the same call with the plain
# versions of C and B on the card, held as phase 3 holds the card's float32
# render against the CPU's (TOL_F32_RENDER, TOL_F32_RENDER_MEAN), not to
# the eval layouts' 1e-5: those compare two kernels that give the same bits,
# while C sums its float32 products in another order than the plain
# version's matmul.  On the partly opaque seeded checkpoint the coarse pass
# then agrees to ~1e-7, and the fine samples, placed by the coarse weights,
# carry that through the 2^9-frequency encoding to ~2e-3 in depth and ~6e-4
# in opacity (an H100 80GB HBM3 at 700 W).  The 8-bit frames may then differ
# by as many levels as the limit spans.
ORBIT_PNG_LEVELS = int(np.ceil(255 * TOL_F32_RENDER))
# the launchers' fits, cut to one epoch on phase 7's 64x64 shadow scene
LAUNCHER_EPOCHS = "1"
ENTRY_TIMEOUT_S = 300


class plain_on_card:
    """Inside the block, a CUDA tensor takes the plain versions of kernels C
    and B (the renderer's routes on the card), for a hold against them."""

    def __enter__(self):
        from nerf_pl_tpu_torch.ops import fused_mlp as fm
        from nerf_pl_tpu_torch.ops import searchsorted as ss

        self.saved = [(fm, "fused_nerf_apply_raw_t_cuda",
                       fm.fused_nerf_apply_raw_t_cuda),
                      (ss, "searchsorted_interp_cuda",
                       ss.searchsorted_interp_cuda)]
        fm.fused_nerf_apply_raw_t_cuda = fm.fused_nerf_apply_raw_t_plain
        ss.searchsorted_interp_cuda = ss.searchsorted_interp_plain
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)
        return False


def python_on_path(tmp: str) -> dict:
    """The environment of a launcher's subprocess: ``python`` is this
    interpreter (the machine may name it ``python3`` only) and the checkout
    is importable."""
    bin_dir = os.path.join(tmp, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    shim = os.path.join(bin_dir, "python")
    if not os.path.exists(shim):
        # a script, not a symlink: a virtual environment is found from the
        # interpreter's own path
        with open(shim, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(shim, 0o755)
    repo = os.path.dirname(os.path.abspath(__file__))
    return {**os.environ, "PATH": f"{bin_dir}:{os.environ.get('PATH', '')}",
            "PYTHONPATH": repo + (os.pathsep + os.environ["PYTHONPATH"]
                                  if os.environ.get("PYTHONPATH") else "")}


def run_shell(tmp: str, tag: str, script: str, args: list,
              env: dict | None = None) -> subprocess.CompletedProcess:
    """``bash <script> args`` from the checkout's root; its output logged,
    a failure raised."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(["bash", os.path.join(repo, script), *args],
                         capture_output=True, text=True, cwd=repo,
                         timeout=ENTRY_TIMEOUT_S,
                         env={**python_on_path(tmp), **(env or {})})
    for line in res.stdout.splitlines()[-12:]:
        log(f"[{tag}] {line}")
    log(f"[{tag}] {script} {' '.join(args[:2])}: exit {res.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if res.returncode != 0:
        raise AssertionError(f"{script} failed ({res.returncode}): "
                             f"{res.stderr[-2000:]}")
    return res


def epoch_records(path: str) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


def entry_scenes(tmp: str) -> str:
    """``make_synthetic_scene`` in its three formats; the Blender scene's
    root (16x16, for the acceptance chain)."""
    from nerf_pl_tpu_torch.scripts import make_synthetic_scene

    root = os.path.join(tmp, "entry_scene")
    for fmt, extra in (("blender", []), ("llff", ["--spheric"]),
                       ("pyredner", [])):
        out = root if fmt == "blender" else f"{root}_{fmt}"
        make_synthetic_scene.main(["--out", out, "--img_wh", "16",
                                   "--n_train", "3", "--n_val", "1",
                                   "--n_test", "1", "--format", fmt, *extra,
                                   "--device", "cuda"])
        want = ("poses_bounds.npy" if fmt == "llff"
                else "transforms_train.json")
        if not os.path.exists(os.path.join(out, want)):
            raise AssertionError(f"the {fmt} scene has no {want}")
    return root


def orbit_end_to_end(tmp: str, ckpt: str, seeded: str) -> dict:
    """``python -m nerf_pl_tpu_torch.examples.orbit_render`` (its ``main``,
    in this process, so the launch counters can be read) on phase 4's fit:
    24 rgb poses and 8 sigma poses at 200x200; the files read back.  Pose 0
    held against the plain versions on the card, of that fit and of
    ``seeded`` (the serve phase's partly opaque seeded checkpoint: two
    epochs leave phase 4's fit all but transparent along the orbit, a white
    rgb image, and phase 10's dense cut of it too, so the hold needs a scene
    with content)."""
    from nerf_pl_tpu_torch.data.png import read_png
    from nerf_pl_tpu_torch.examples import orbit_render

    runs = {}
    for mode, poses in (("rgb", ORBIT_POSES), ("sigma", ORBIT_SIGMA_POSES)):
        out_dir = os.path.join(tmp, f"orbit_{mode}")
        argv = ["--ckpt_path", ckpt, "--img_wh", str(ORBIT_WH), str(ORBIT_WH),
                "--n_poses", str(poses), "--mode", mode, "--out_dir", out_dir,
                "--device", "cuda"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        frames = orbit_render.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {k: v * poses for k, v in ORBIT_POSE_LAUNCHES.items()}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"the {mode} orbit launched {counts}, "
                                 f"expected {want}")
        for i, frame in enumerate(frames):
            img, pmode = read_png(os.path.join(out_dir, f"orbit_{i:03d}.png"))
            if pmode != "RGB" or not np.array_equal(img, frame):
                raise AssertionError(f"{mode} orbit PNG {i} reads back wrong")
        n, delays, _ = gif_frames(os.path.join(out_dir, "orbit.gif"))
        if n != poses or delays != [int(1000 / orbit_render.GIF_FPS / 10)] * n:
            raise AssertionError(f"{mode} orbit GIF: {n} frames, {delays}")
        spread = float(np.std(np.stack(frames).astype(np.float32)))
        log(f"[entry] orbit {mode}: {poses} poses at {ORBIT_WH}x{ORBIT_WH}, "
            f"{wall:.3f} s wall, {wall / poses:.4f} s a pose (PNG writes "
            f"included), {poses * ORBIT_WH ** 2 / wall:.1f} rays/s; launches "
            f"{counts}; frames' std {spread:.2f} levels")
        runs[mode] = dict(wall_s=wall, s_per_pose=wall / poses,
                          counts=counts, poses=poses)

    holds = {}
    for tag, path in (("phase 4 fit", ckpt), ("seeded", seeded)):
        holds[tag] = orbit_plain_hold(tag, path)
    if holds["seeded"]["std"] < 1.0:
        raise AssertionError("the seeded scene's orbit pose is blank")
    return dict(runs=runs, holds=holds)


def orbit_plain_hold(tag: str, ckpt: str) -> dict:
    """Pose 0 of the rgb orbit through the kernels and through the plain
    versions of C and B on the card: the readings, held."""
    from nerf_pl_tpu_torch.examples import orbit_render
    from nerf_pl_tpu_torch.ops.ray_utils import get_ray_directions
    from nerf_pl_tpu_torch.tools.evaluate import load_models

    args = orbit_render.get_opts(["--ckpt_path", ckpt, "--img_wh",
                                  str(ORBIT_WH), str(ORBIT_WH)])
    models = load_models(ckpt, "cuda")
    focal = 0.5 * 800 / np.tan(0.5 * args.camera_angle_x) * ORBIT_WH / 800
    rays = orbit_render.orbit_rays(args, 0, get_ray_directions(
        ORBIT_WH, ORBIT_WH, focal, device="cuda"))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fused = orbit_render.render_pose(models, rays, args, use_fused=True)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    counts = read_counts()
    with plain_on_card():
        reset_counts()
        plain = orbit_render.render_pose(models, rays, args, use_fused=True)
        torch.cuda.synchronize()
        if any(read_counts().values()):
            raise AssertionError("the plain render launched a kernel")
    errs = {k: max_abs(fused[k], plain[k]) for k in fused}
    means = {k: float((fused[k] - plain[k]).abs().mean()) for k in fused}
    frame = orbit_render.frame_of(fused, args)
    levels = int(np.abs(frame.astype(int) - orbit_render.frame_of(
        plain, args).astype(int)).max())
    spread = float(frame.astype(np.float32).std())
    log(f"[entry] orbit pose 0 of the {tag} checkpoint through C and B "
        f"against their plain versions on the card: max_abs_err {errs} (tol "
        f"{TOL_F32_RENDER:.0e}), mean_abs_err {means} (tol "
        f"{TOL_F32_RENDER_MEAN:.0e}); PNG levels apart {levels} (at most "
        f"{ORBIT_PNG_LEVELS}); frame std {spread:.2f} levels, opacity mean "
        f"{float(fused['opacity_fine'].mean()):.4f}; rendered in "
        f"{render_s:.4f} s, launches {counts}")
    if not (max(errs.values()) <= TOL_F32_RENDER
            and max(means.values()) <= TOL_F32_RENDER_MEAN
            and levels <= ORBIT_PNG_LEVELS):
        raise AssertionError(f"the orbit's pose of the {tag} checkpoint "
                             f"disagrees with the plain versions: {errs}, "
                             f"{means}, {levels} levels")
    return dict(errs=errs, means=means, png_levels=levels, std=spread,
                render_s=render_s)


def mesh_checks(tmp: str) -> dict:
    """``validate_mesh`` on an analytic sphere PLY (PASS, exit 0) and on one
    scaled by 1.2 (FAIL, exit 1)."""
    from nerf_pl_tpu_torch.data.synthetic import SPHERE_C
    from nerf_pl_tpu_torch.scripts import validate_mesh
    from nerf_pl_tpu_torch.tools.mesh_utils import write_ply

    n = 48
    th, ph = np.meshgrid(np.linspace(0.05, np.pi - 0.05, n),
                         np.linspace(0, 2 * np.pi, 2 * n, endpoint=False),
                         indexing="ij")
    nrm = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                    np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    idx = np.arange(2 * n * n).reshape(n, 2 * n)
    nxt = np.roll(idx, -1, axis=1)
    tris = np.concatenate([
        np.stack([idx[:-1], nxt[:-1], idx[1:]], -1).reshape(-1, 3),
        np.stack([nxt[:-1], nxt[1:], idx[1:]], -1).reshape(-1, 3)])
    colors = (np.clip(0.5 + 0.5 * nrm, 0, 1) * 255).astype(np.uint8)
    codes = {}
    for tag, radius in (("sphere", 1.0), ("perturbed", 1.2)):
        path = os.path.join(tmp, f"{tag}.ply")
        write_ply(path, (SPHERE_C + radius * nrm).astype(np.float32), tris,
                  colors)
        codes[tag] = validate_mesh.main([path, "--device", "cuda"])
    log(f"[entry] validate_mesh exit codes {codes}")
    if codes != {"sphere": 0, "perturbed": 1}:
        raise AssertionError(f"validate_mesh: {codes}")
    return codes


def entry_points_end_to_end(tmp: str, ckpt: str, seeded: str) -> dict:
    """Phase 14: the scene CLI, the orbit render, the mesh check, the shadow
    inspection, the step profile, the width bench, the searchsorted bench,
    the sustained rate, two launchers and the acceptance chain."""
    from nerf_pl_tpu_torch.examples import inspect_shadow_scene
    from nerf_pl_tpu_torch.scripts import (bench_searchsorted, profile_step,
                                           sustained_rate, width_bench)

    t0 = time.perf_counter()
    scene = entry_scenes(tmp)
    out = dict(orbit=orbit_end_to_end(tmp, ckpt, seeded),
               mesh=mesh_checks(tmp))
    shadow_root = os.path.join(tmp, "shadow_scene")
    if inspect_shadow_scene.main(["--root_dir", shadow_root, "--img_wh",
                                  str(SHADOW_WH), str(SHADOW_WH),
                                  "--device", "cuda"]) is not True:
        raise AssertionError("the shadow scene's projection is inconsistent")

    torch.cuda.synchronize()
    reset_counts()
    prof = profile_step.main(["--iters", "10", "--trace_dir",
                              os.path.join(tmp, "profile_step"), "--out",
                              os.path.join(tmp, "profile_step.json"),
                              "--device", "cuda"])
    torch.cuda.synchronize()
    prof["launches"] = read_counts()
    named = prof["by_kernel_us_per_step"]
    for row in prof["top_ops"][:12]:
        log(f"[entry] profile_step {row['us_per_step']:10.1f} us/step "
            f"{row['pct']:5.1f}% x{row['count']:<4d} {row['kernel'] or '':6s} "
            f"{row['op'][:80]}")
    log(f"[entry] profile_step: {prof['step_ms_from_module_span']} ms a step "
        f"(the traced span), kernels {prof['op_lane_total_us_per_step']} us "
        f"a step, buckets {prof['buckets_us_per_step']}, by kernel {named}; "
        f"launches over the 11 steps {prof['launches']}")
    if not {"D", "E", "A"} <= set(named):
        raise AssertionError(f"the step's profile does not name D, E and A: "
                             f"{named}")

    widths = {}
    for w in (256, 512):
        torch.cuda.synchronize()
        reset_counts()
        (row,) = width_bench.main(["--widths", str(w), "--iters", "5",
                                   "--device", "cuda"])
        torch.cuda.synchronize()
        row["launches"] = read_counts()
        if "error" in row:
            raise AssertionError(f"width_bench at W = {w}: {row['error']}")
        log(f"[entry] width_bench W = {w}: {row['rays_per_s']} rays/s, "
            f"{row['model_tflops_fwd_bwd']} model TFLOP/s, launches over 6 "
            f"steps {row['launches']}")
        widths[w] = row
    if not (widths[256]["launches"]["D"] and widths[256]["launches"]["E"]
            and not widths[512]["launches"]["D"]):
        raise AssertionError("the width bench took the wrong routes")

    torch.cuda.synchronize()
    reset_counts()
    ranks = bench_searchsorted.main(["--device", "cuda"])
    ranks["launches"] = read_counts()
    rate = sustained_rate.main([os.path.join(tmp, "logs", "smoke",
                                             "metrics.jsonl"),
                                "--device", "cuda"])
    if rate["epochs"] != 2 or not rate["mean_rays_per_s"] > 0:
        raise AssertionError(f"sustained_rate: {rate}")

    logs, ckpts = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpts")
    fits = {}
    for tag, script, args in (
            ("efficient_sm_64", "nerf_pl_tpu_torch/launchers/efficient_sm_64.sh",
             []),
            ("rgb_sm_sigma_64", "nerf_pl_tpu_torch/launchers/recipes.sh",
             ["rgb_sm_sigma_64"])):
        run_shell(tmp, "entry", script,
                  [*args, "--num_epochs", LAUNCHER_EPOCHS, "--exp_name",
                   f"launch_{tag}", "--log_dir", logs, "--ckpt_dir", ckpts],
                  env={"DATA_DIR": shadow_root})
        recs = epoch_records(os.path.join(logs, f"launch_{tag}",
                                          "metrics.jsonl"))
        losses = [r["train/loss"] for r in recs]
        if len(losses) != 1 or not np.isfinite(losses).all():
            raise AssertionError(f"{tag}: losses {losses}")
        fits[tag] = dict(loss=losses[0], rays_per_s=recs[0]["train/rays_per_s"])
        log(f"[entry] {tag}: epoch-0 loss {losses[0]}, "
            f"{recs[0]['train/rays_per_s']:.1f} camera rays/s")
    res = run_shell(tmp, "entry", "nerf_pl_tpu_torch/scripts/"
                    "acceptance_real_data.sh",
                    [scene, os.path.join(tmp, "acceptance")],
                    env={"SMOKE": "1"})
    if "PASS" not in res.stdout or "Mean PSNR : " not in res.stdout:
        raise AssertionError("the acceptance chain printed no PSNR or PASS")
    out.update(profile=prof, widths=widths, ranks=ranks, rate=rate,
               fits=fits, seconds=time.perf_counter() - t0)
    log(f"[entry] phase 14: {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import nerf_pl_tpu_torch  # noqa: F401 - fails outside a checkout

    card = gpu_line()
    log(f"[card] {card}")
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()
    setup()

    from nerf_pl_tpu_torch.tools.evaluate import load_models

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "smoke.ckpt")
        write_checkpoint(ckpt)
        fine = load_models(ckpt, dev)["fine"]
        with torch.no_grad():
            c = check_fused_mlp(fine, gen, dev)
        s = check_searchsorted(gen, dev)
        served = serve_end_to_end(ckpt)
        sampler_counts = random_sampler_path(ckpt)
        f32_err = f32_card_vs_cpu(ckpt)
        with torch.no_grad():
            f32_digests = f32_backward_digests(fine, dev)
            holds = check_train_kernels(fine, gen, dev)
            tt, train_holds = time_train_kernels(fine, gen, dev)
            tk = merge_holds(holds + train_holds)
            te = time_eval_chunk(fine, gen, dev)
        del fine
        trained = train_end_to_end(tmp)
        evaluated = eval_end_to_end(
            tmp, os.path.join(tmp, "ckpts", "smoke", "epoch=1.ckpt"))
        trained_rm = train_row_major(tmp, trained["losses"])
        step_err = step_grads_card_vs_cpu()
        adam_card_vs_before()
        benched = bench_number()
        t_wide = time.perf_counter()
        fine = load_models(ckpt, dev)["fine"]
        with torch.no_grad():
            wg = check_wide_forward(gen, dev)
            wi = check_chain(dev)
            wh = check_wide_backward(fine, gen, dev)
            wt = time_wide_forward(gen, dev)
        del fine
        wr = wide_render(tmp)
        probe = run_probe()
        log(f"[wide] phase 6: {time.perf_counter() - t_wide:.1f} s")
        shadow = shadow_end_to_end(tmp)
        trainers = trainers_end_to_end(tmp)
        census = light_sampler_cancellation(tmp)
        llff = llff_end_to_end(tmp)
        t_tools = time.perf_counter()
        smoke_fit = density_checkpoint(
            os.path.join(tmp, "ckpts", "smoke", "epoch=1.ckpt"),
            os.path.join(tmp, "mesh_fit.ckpt"))
        scene = os.path.join(tmp, "scene")
        dense, dense_thr, _ = dense_checkpoint(
            os.path.join(tmp, "ckpts", "smoke", "epoch=1.ckpt"),
            os.path.join(tmp, "mesh_dense.ckpt"))
        tools = dict(mesh=mesh_full_width(tmp, scene, smoke_fit, dense,
                                          dense_thr),
                     cluster=cluster_host_seconds(),
                     mesh_cmp=mesh_card_vs_cpu(tmp, smoke_fit),
                     ckpt=import_resume_export(tmp, scene))
        fine = load_models(ckpt, dev)["fine"]
        nan = nan_holds(fine, dev)
        del fine
        optim_ops = optimizer_first_difference()
        tools_s = time.perf_counter() - t_tools
        log(f"[tools] phase 10: {tools_s:.1f} s")
        dist = dist_end_to_end(tmp, trained)
        readers = readers_end_to_end(tmp)
        formats = formats_end_to_end(tmp, shadow["fit"]["losses"][0])
        entries = entry_points_end_to_end(
            tmp, os.path.join(tmp, "ckpts", "smoke", "epoch=1.ckpt"), ckpt)

    fine_row, coarse_row = c["rows"]["rgb"], c["rows"]["sigma-only"]
    kernels = [
        dict(name="fused_nerf_fwd", route="cuda",
             source="nerf_pl_tpu_torch/csrc/fused_mlp.cu",
             replaces="nerf_pl_tpu/ops/fused_mlp.py:1015",
             launches=served["counts"]["C"], max_abs_err=c["err"],
             ms=fine_row["ms"], plain_ms=fine_row["plain_ms"],
             bound_ms=fine_row["bound_ms"], bound_by=fine_row["bound_by"],
             library_ms=None, shape=f"rgb bf16 P={fine_row['P']}",
             sigma_only=coarse_row,
             matmul_chain_fwd_ms=fine_row["matmul_chain_fwd_ms"],
             launches_train=dict(fit=trained["counts"]["C"],
                                 per_step=trained["per_step"]["C"]),
             train_shapes={k: dict(P=tt[k]["P"], ms=tt[k]["C_ms"],
                                   matmul_chain_fwd_ms=tt[k]["chain_fwd_ms"])
                           for k in ("fine", "coarse")}),
        dict(name="searchsorted_rank_interp", route="cuda",
             source="nerf_pl_tpu_torch/csrc/searchsorted.cu",
             replaces="nerf_pl_tpu/ops/searchsorted.py:122",
             launches=served["counts"]["B"], max_abs_err=s["B"]["err"],
             ms=s["B"]["ms"], plain_ms=s["B"]["plain_ms"],
             bound_ms=s["B"]["bound_ms"], bound_by=s["B"]["bound_by"],
             library_ms=None,
             shape=f"B={CHUNK_RAYS} M={N_SAMPLES - 1} K={N_IMPORTANCE}",
             turns_ms=s["B"]["turns"], device_ms=s["B"]["device_ms"],
             small_shape=dict(B=TRAIN_BATCH, **{k: s["B_train"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "turns", "device_ms")})),
        dict(name="searchsorted_rank", route="cuda",
             source="nerf_pl_tpu_torch/csrc/searchsorted.cu",
             replaces="nerf_pl_tpu/ops/searchsorted.py:45",
             launches=trained["counts"]["A"], max_abs_err=s["A"]["err"],
             ms=s["A"]["ms"], plain_ms=s["A"]["plain_ms"],
             bound_ms=s["A"]["bound_ms"], bound_by=s["A"]["bound_by"],
             library_ms=s["A"]["library_ms"],
             shape=f"B={CHUNK_RAYS} M={N_SAMPLES - 1} K={N_IMPORTANCE}",
             turns_ms=s["A"]["turns"],
             device_ms=s["A"]["device_ms"],
             library_device_ms=s["A"]["library_device_ms"],
             train_shape=dict(B=TRAIN_BATCH, **{k: s["A_train"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "library_ms", "turns",
                 "device_ms", "library_device_ms")}),
             path="training (the fit); not on the serve path",
             launches_by_path=dict(fit=trained["counts"]["A"],
                                   per_step=trained["per_step"]["A"],
                                   render_rays_perturb=sampler_counts["A"])),
    ]
    fine_t, coarse_t = tt["fine"], tt["coarse"]
    for key, name, src, line, err, launches in (
            ("D", "fused_nerf_stash_fwd", "fused_mlp.cu", 1032, tk["D"],
             trained["counts"]["D"]),
            ("E", "fused_nerf_bwd_stash", "fused_mlp_bwd.cu", 1052, tk["E"],
             trained["counts"]["E"]),
            ("F", "fused_nerf_bwd_remat", "fused_mlp_bwd.cu", 1067, tk["F"],
             trained["remat"]["F"])):
        row = fine_t[key]
        kernels.append(dict(
            name=name, route="cuda", source=f"nerf_pl_tpu_torch/csrc/{src}",
            replaces=f"nerf_pl_tpu/ops/fused_mlp.py:{line}",
            launches=launches, max_abs_err=err, ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound"][0],
            bound_by=row["bound"][1], library_ms=None,
            shape=f"rgb bf16 P={fine_t['P']}",
            coarse=dict(P=coarse_t["P"], ms=coarse_t[key]["ms"],
                        plain_ms=coarse_t[key]["plain_ms"],
                        bound_ms=coarse_t[key]["bound"][0]),
            launches_per_step=trained["per_step"][key],
            matmul_chain_ms=dict(fine=fine_t["chain_bwd_ms" if key != "D"
                                             else "chain_fwd_ms"],
                                 coarse=coarse_t["chain_bwd_ms" if key != "D"
                                                 else "chain_fwd_ms"])))
    kernels[-2]["max_rel_err"] = tk["E_rel"]
    kernels[-1]["max_rel_err"] = tk["F_rel"]
    kernels[-1]["e_vs_f_rel_err"] = tk["E_vs_F"]
    # the f32 backward's pinned bits (rgb, F32_DIGEST_P points, seeded)
    kernels[-2]["f32_sha256"] = f32_digests["E"]
    kernels[-1]["f32_sha256"] = f32_digests["F"]
    for row, key in ((kernels[-2], "E"), (kernels[-1], "F")):
        row["mean_rel_err"] = tk["means"][key]
        row["control_rel_err"] = dict(max=tk["control_max_rel"],
                                      mean=tk["control_mean_rel"])
    kernels[-3]["forward_control"] = tk["forward_control"]
    # the row-major twins (one source each with their channel-major kernels,
    # a compile-time layout flag; held bit-equal to them above)
    ev_rm, ev_cm = evaluated["row_major"], evaluated["channel_major"]
    erow = te["rgb"]
    kernels.append(dict(
        name="fused_nerf_fwd_row_major", route="cuda",
        source="nerf_pl_tpu_torch/csrc/fused_mlp.cu",
        replaces="nerf_pl_tpu/ops/fused_mlp.py:644",
        launches=ev_rm["counts"]["C'"], max_abs_err=c["err_rm"],
        ms=erow["ms"], plain_ms=erow["plain_ms"], bound_ms=erow["bound_ms"],
        bound_by=erow["bound_by"], library_ms=None,
        shape=f"rgb f32 P={erow['P']} (one eval chunk)",
        max_abs_err_eval_chunk_f32=erow["err"], twin_ms=erow["C_ms"],
        matmul_chain_fwd_ms=erow["matmul_chain_fwd_ms"],
        sigma_only=dict((k, te["sigma-only"][k]) for k in (
            "P", "ms", "C_ms", "plain_ms", "bound_ms", "matmul_chain_fwd_ms")),
        train_shapes={k: dict(P=tt[k]["P"], ms=tt[k]["C'"]["ms"],
                              twin_ms=tt[k]["C_ms"],
                              plain_ms=tt[k]["C'"]["plain_ms"],
                              bound_ms=tt[k]["C'"]["bound"][0],
                              matmul_chain_fwd_ms=tt[k]["chain_fwd_ms"])
                      for k in ("fine", "coarse")},
        launches_by_path=dict(eval_row_major=ev_rm["counts"]["C'"],
                              eval_channel_major=ev_cm["counts"]["C'"],
                              fit_row_major=trained_rm["counts"]["C'"],
                              per_step=trained_rm["per_step"]["C'"],
                              remat_drive=trained_rm["remat"]["C'"])))
    for key, name, src, line, launches in (
            ("D'", "fused_nerf_stash_fwd_row_major", "fused_mlp.cu", 707,
             trained_rm["counts"]["D'"]),
            ("E'", "fused_nerf_bwd_stash_row_major", "fused_mlp_bwd.cu", 727,
             trained_rm["counts"]["E'"]),
            ("F'", "fused_nerf_bwd_remat_row_major", "fused_mlp_bwd.cu", 660,
             trained_rm["remat"]["F'"])):
        row, twin = fine_t[key], fine_t[key[0]]
        chain = "chain_fwd_ms" if key == "D'" else "chain_bwd_ms"
        kernels.append(dict(
            name=name, route="cuda", source=f"nerf_pl_tpu_torch/csrc/{src}",
            replaces=f"nerf_pl_tpu/ops/fused_mlp.py:{line}",
            launches=launches, max_abs_err=tk[key], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound"][0],
            bound_by=row["bound"][1], library_ms=None,
            shape=f"rgb bf16 P={fine_t['P']}", twin_ms=twin["ms"],
            coarse=dict(P=coarse_t["P"], ms=coarse_t[key]["ms"],
                        twin_ms=coarse_t[key[0]]["ms"],
                        plain_ms=coarse_t[key]["plain_ms"],
                        bound_ms=coarse_t[key]["bound"][0]),
            launches_per_step=trained_rm["per_step"][key],
            matmul_chain_ms=dict(fine=fine_t[chain], coarse=coarse_t[chain])))
    for row, key in ((kernels[-2], "E'"), (kernels[-1], "F'")):
        row["max_rel_err"] = tk[f"{key}_rel"]
        row["mean_rel_err"] = tk["means"][key]
    # slice 4: the wide pre-embedded forward, its backward, the probe's chain
    gt, gs = wt["train"], wt["serve"]
    kernels.append(dict(
        name="fused_nerf_wide_fwd", route="cuda",
        source="nerf_pl_tpu_torch/csrc/fused_mlp_wide.cu",
        replaces="nerf_pl_tpu/ops/fused_mlp.py:184",
        launches=wr["wide"]["counts"]["G"], max_abs_err=wg["err"],
        ms=gt["ms"], plain_ms=gt["plain_ms"], bound_ms=gt["bound_ms"],
        bound_by=gt["bound_by"], library_ms=None,
        shape=f"W={WIDE_W} rgb bf16 P={gt['P']}",
        max_abs_err_f32=wg["err_f32"], rel_err_of_std=dict(
            bf16=wg["rel"], f32=wg["rel_f32"]),
        matmul_chain_fwd_ms=gt["matmul_chain_fwd_ms"],
        posenc_nerf_ms=gt["posenc_nerf_ms"],
        serve_chunk=dict(P=gs["P"], ms=gs["ms"], bound_ms=gs["bound_ms"]),
        launches_by_path=dict(wide_render=wr["wide"]["counts"]["G"],
                              posenc_nerf_render=wr["posenc_nerf"]["counts"]
                              ["G"], autograd=wh["counts"]["G"],
                              probe=probe["G"])))
    kernels.append(dict(
        name="fused_nerf_bwd_dx", route="cuda",
        source="nerf_pl_tpu_torch/csrc/fused_mlp_bwd.cu",
        replaces="nerf_pl_tpu/ops/fused_mlp.py:327",
        launches=wh["counts"]["H"], max_abs_err=wh["err"], ms=wh["ms"],
        plain_ms=wh["plain_ms"], bound_ms=wh["bound_ms"],
        bound_by=wh["bound_by"], library_ms=None,
        shape=f"W=256 rgb bf16 P={wh['P']}", max_rel_err=wh["max_rel"],
        mean_rel_err=dict(mean_rel=wh["mean_rel"], tensor=wh["mean_name"]),
        F_ms=wh["F_ms"],
        matmul_chain_bwd_ms=wh["matmul_chain_bwd_ms"],
        launches_by_path=dict(autograd=wh["counts"]["H"])))
    pure, fancy = wi["rows"]["pure"], wi["rows"]["fancy"]
    kernels.append(dict(
        name="chain_probe", route="cuda",
        source="nerf_pl_tpu_torch/csrc/chain_probe.cu",
        replaces="scripts/kernel_probe.py:58", launches=probe["I"],
        max_abs_err=max(pure["max_abs"], fancy["max_abs"]), ms=pure["ms"],
        plain_ms=pure["plain_ms"], bound_ms=wi["bound_ms"],
        bound_by=wi["bound_by"], library_ms=None,
        shape=f"pure bf16 P={wi['P']}", tflops=pure["tflops"],
        fancy=dict(ms=fancy["ms"], plain_ms=fancy["plain_ms"],
                   tflops=fancy["tflops"]),
        max_rel_err=max(pure["rel"], fancy["rel"]),
        matmul_chain_ms=wi["library_ms"], turns_ms=wi["turns"],
        ragged_rel_err=wi["ragged_rel"], sass=wi["sass"],
        launches_by_path=dict(probe=probe["I"])))
    log(f"[serve] {served['rays_per_s']:.1f} rays/s, "
        f"{served['ms']:.1f} ms per request; f32 card-vs-cpu err "
        f"{f32_err:.3e}")
    log(f"[train] {trained['rays_per_s']:.1f} train rays/s in the fit, "
        f"{benched['rays_per_s']:.1f} in the bench workload; synchronising "
        f"calls in one step {trained['syncs']['count']}; f32 step grads "
        f"card vs cpu rel err {step_err:.3e}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[eval] s per {EVAL_WH}^2 view: row-major "
        f"{ev_rm['s_per_view']:.3f} ({ev_rm['rays_per_s']:.1f} rays/s), "
        f"channel-major {ev_cm['s_per_view']:.3f} "
        f"({ev_cm['rays_per_s']:.1f} rays/s); PSNR {ev_rm['psnr']:.4f} dB; "
        f"row-major fit {trained_rm['rays_per_s']:.1f} train rays/s, epoch-0 "
        f"loss relative difference {trained_rm['loss_rel_diff']:.3e}")
    log(f"[wide] W={WIDE_W} {WIDE_RENDER_WH}^2 view: "
        f"{wr['wide']['rays_per_s']:.1f} rays/s through G, "
        f"{wr['posenc_nerf']['rays_per_s']:.1f} through posenc + NeRF; G "
        f"{gt['ms']:.3f} ms at {gt['P']} points; H {wh['ms']:.3f} ms (F "
        f"{wh['F_ms']:.3f}); I {pure['ms']:.4f} ms ({pure['tflops']:.1f} "
        f"TFLOP/s), cuBLAS chain {wi['library_ms']:.4f} ms")
    # the shadow trainer's launches (phase 7): the 2-epoch f32 fit, one step,
    # the bf16 fit and the no-grad light-cache fit
    for row in kernels:
        key = {"searchsorted_rank": "A", "fused_nerf_fwd": "C",
               "fused_nerf_stash_fwd": "D",
               "fused_nerf_bwd_stash": "E"}.get(row["name"])
        if key in ("D", "E"):
            row["shadow_f32_step"] = shadow["f32_step"][key]
        if key is not None:
            row["launches_shadow"] = dict(
                fit=shadow["counts"][key], per_step=shadow["per_step"][key],
                bf16_fit=shadow["bf16"]["counts"][key],
                cache_fit=shadow["cache"]["counts"][key])
    # the other shadow trainers' launches (phase 8): each fit and one step
    for row in kernels:
        key = {"searchsorted_rank_interp": "B", "searchsorted_rank": "A",
               "fused_nerf_fwd": "C", "fused_nerf_stash_fwd": "D",
               "fused_nerf_bwd_stash": "E"}.get(row["name"])
        if key is None:
            continue
        row["launches_shadow_trainers"] = dict(
            fits={k: f["counts"][key] for k, f in trainers["fits"].items()},
            per_step={k: st["per_step"][key]
                      for k, st in trainers["steps"].items()})
        if key in ("D", "E"):
            row["shadow_trainers_f32_step"] = {
                k: st["f32_step"][key] for k, st in trainers["steps"].items()}
    for tag, st in trainers["steps"].items():
        fit, prof = trainers["fits"][tag], st["profile"]
        log(f"[trainers] {tag}: {fit['rays_per_s'][-1]:.1f} camera rays/s "
            f"(last epoch); one step {prof['wall_ms']:.1f} ms wall, "
            f"{prof['busy_ms'] or 0:.1f} ms device busy; D "
            f"{st['f32_step']['D']['device_ms']:.3f} ms, E "
            f"{st['f32_step']['E']['device_ms']:.3f} ms (f32); synchronising "
            f"calls a step {sum(st['syncs'].values())}; f32 step grads card "
            f"vs cpu rel err {trainers['grads'][tag]:.3e}"
            + ("" if tag != "light_sampler" else
               f"; carried by {census['entries']} entries of "
               f"{census['tensor']}: cancellation ratio T/|S| "
               f"{census['ratio']}, difference over the float32 estimate "
               f"{census['seen_over_estimate']}, ReLU masks that differ "
               f"{census['mask_flips']} of {census['masks']}"))
    log(f"[trainers] rgb_sm bf16 "
        f"{trainers['fits']['rgb_sm_bf16']['rays_per_s'][-1]:.1f}, light "
        f"cache {trainers['fits']['rgb_sm_cache']['rays_per_s'][-1]:.1f} "
        f"(losses {trainers['fits']['rgb_sm_cache']['losses']}); pyredner2 "
        f"{trainers['fits']['pyredner2']['rays_per_s'][-1]:.1f} camera "
        f"rays/s; phase {trainers['seconds']:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    fit, prof = shadow["fit"], shadow["profile"]
    log(f"[shadow] f32 grad_on_light fit {fit['rays_per_s'][-1]:.1f} camera "
        f"rays/s (epoch 1), bf16 {shadow['bf16']['rays_per_s'][-1]:.1f}, "
        f"light cache (f32) {shadow['cache']['rays_per_s'][-1]:.1f}; one step "
        f"{prof['wall_ms']:.1f} ms wall, {prof['busy_ms'] or 0:.1f} ms device "
        f"busy; synchronising calls a step {sum(shadow['syncs'].values())}; "
        f"f32 step grads card vs cpu rel err {shadow['grads_err']:.3e}; "
        f"phase {shadow['seconds']:.1f} s")
    # the LLFF path's launches (phase 9): the fit, one step, the two evals
    # and the spheric fit
    for row in kernels:
        key = {"searchsorted_rank_interp": "B", "searchsorted_rank": "A",
               "fused_nerf_fwd": "C", "fused_nerf_stash_fwd": "D",
               "fused_nerf_bwd_stash": "E"}.get(row["name"])
        if key is None:
            continue
        row["launches_llff"] = dict(
            fit=llff["fit"]["counts"][key], per_step=llff["per_step"][key],
            eval_test_train=llff["eval_test_train"]["counts"][key],
            eval_test=llff["eval_test"]["counts"][key],
            spheric_fit=llff["spheric"]["counts"][key])
        if key in ("D", "E"):
            row["llff_f32_step"] = llff["f32_step"][key]
    fit, prof = llff["fit"], llff["profile"]
    log(f"[llff] fit {fit['rays_per_s'][-1]:.1f} train rays/s (epoch 0, "
        f"{llff['steps']} steps); "
        f"one step {prof['wall_ms']:.1f} ms wall, {prof['busy_ms'] or 0:.1f} "
        f"ms device busy; D {llff['f32_step']['D']['device_ms']:.3f} ms, E "
        f"{llff['f32_step']['E']['device_ms']:.3f} ms (f32); synchronising "
        f"calls a step {llff['syncs']['count']}; f32 step grads card vs cpu "
        f"rel err {llff['grads_err']:.3e}; eval test_train "
        f"{llff['eval_test_train']['s_per_view']:.3f} s a 504x378 view, "
        f"test {llff['eval_test']['s_per_view']:.3f} s a 168x126 view; "
        f"spheric fit {llff['spheric']['rays_per_s'][-1]:.1f} rays/s; JPEG "
        f"{llff['jpeg']['ms']:.1f} ms, PNG 800^2 {llff['png']['ms']:.1f} ms "
        f"on the host; phase {llff['seconds']:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    # the tools (phase 10): the mesh tool's launches, and every kernel's
    # reading in the NaN hold
    mesh = tools["mesh"]
    letters = {"fused_nerf_fwd": "C", "fused_nerf_fwd_row_major": "C'",
               "fused_nerf_stash_fwd": "D", "fused_nerf_bwd_stash": "E",
               "fused_nerf_bwd_remat": "F", "fused_nerf_wide_fwd": "G",
               "fused_nerf_bwd_dx": "H", "chain_probe": "I",
               "searchsorted_rank_interp": "B"}
    for row in kernels:
        key = letters.get(row["name"])
        if key in ("C'", "B"):
            row["launches_tools"] = dict(
                mesh_fusion=mesh["fusion"]["counts"][key],
                mesh_vertex_normal=mesh["normal"]["counts"][key],
                vol=mesh["vol"]["counts"][key])
        hold = {k: v for k, v in nan.items() if k.split()[0] == key}
        if hold:
            row["nan_hold"] = hold
    m = mesh["fusion"]
    cp = m["counts"]["C'"]
    log(f"[tools] mesh {MESH_N_GRID}^3: {m['wall_s']:.2f} s wall (grid "
        f"{m['info']['grid_s']:.3f}, surface {m['info']['surface_s']:.3f}, "
        f"clustering {m['info']['cluster_s']:.3f}, fusion "
        f"{m['info']['fusion_s']:.3f} s), {m['points_per_s']:.4g} grid "
        f"points/s, {m['info']['surface_vertices']} vertices on the surface, "
        f"{m['info']['vertices']} kept, {m['info']['faces']} faces, C' {cp} "
        f"launches; clustering on the host at ~10^6 vertices "
        + ", ".join(f"{r['vertices']:,} in {r['seconds']:.3f} s"
                    for r in tools["cluster"].values())
        + f"; vertex normal {mesh['normal']['wall_s']:.2f} s (B "
        f"{mesh['normal']['counts']['B']}); card vs cpu at "
        f"{MESH_CMP_N_GRID}^3 sigma {tools['mesh_cmp']['sigma_rel']:.3e}, "
        f"{tools['mesh_cmp']['crossing']} crossing; import -> resume -> "
        f"export {tools['ckpt']['differ']} of {tools['ckpt']['values']} "
        f"moments differ; optimiser first op {optim_ops['first']}; phase "
        f"{tools_s:.1f} s; total {time.perf_counter() - t_start:.1f} s")
    # phase 11: the launches of the NCCL group of one, the two gloo ranks'
    # steps and the streamed fit
    for row in kernels:
        key = {"searchsorted_rank": "A", "fused_nerf_fwd": "C",
               "fused_nerf_stash_fwd": "D",
               "fused_nerf_bwd_stash": "E"}.get(row["name"])
        if key is None:
            continue
        row["launches_dist"] = dict(
            nccl_world1_fit=dist["nccl"]["fit_counts"][key],
            nccl_world1_per_step=dist["nccl"]["per_step"][key],
            gloo2_vanilla_step=[g["vanilla_step"]["launches"][key]
                                for g in dist["gloo"]],
            gloo2_rgb_sm_step=[g["rgb_sm_step"]["launches"][key]
                               for g in dist["gloo"]],
            stream_fit=dist["stream"]["counts"][key],
            stream_epoch=dist["stream"]["epoch_counts"][key])
    log(f"[dist] phase 11: {dist['seconds']:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    # phase 12: the fits on the readers' new layouts and one step of each
    for row in kernels:
        key = {"searchsorted_rank_interp": "B", "searchsorted_rank": "A",
               "fused_nerf_fwd": "C", "fused_nerf_stash_fwd": "D",
               "fused_nerf_bwd_stash": "E"}.get(row["name"])
        if key is None:
            continue
        row["launches_readers"] = dict(
            llff_progressive_fit=readers["llff"]["fit"]["counts"][key],
            llff_progressive_per_step=readers["llff"]["per_step"][key],
            llff_progressive_eval=readers["llff"]["eval"]["counts"][key],
            blender_16bit_fit=readers["blender"]["fit"]["counts"][key],
            blender_16bit_per_step=readers["blender"]["per_step"][key],
            efficient_sm_palette_fit=readers["shadow"]["fit"]["counts"][key],
            efficient_sm_palette_per_step=readers["shadow"]["per_step"][key])
    # phase 13: the fits on the other containers and one step of each
    for row in kernels:
        key = {"searchsorted_rank_interp": "B", "searchsorted_rank": "A",
               "fused_nerf_fwd": "C", "fused_nerf_stash_fwd": "D",
               "fused_nerf_bwd_stash": "E"}.get(row["name"])
        if key is None:
            continue
        row["launches_formats"] = dict(
            llff_webp_fit=formats["llff"]["fit"]["counts"][key],
            llff_webp_per_step=formats["llff"]["per_step"][key],
            llff_webp_eval=formats["llff"]["eval"]["counts"][key],
            blender_tiff_fit=formats["blender"]["fit"]["counts"][key],
            blender_tiff_per_step=formats["blender"]["per_step"][key],
            efficient_sm_maps_fit=formats["shadow"]["fit"]["counts"][key],
            efficient_sm_maps_per_step=formats["shadow"]["per_step"][key])
    ffern = formats["fern"]
    log(f"[formats] phase 13: {formats['seconds']:.1f} s; LLFF on lossy WebP "
        f"{formats['llff']['fit']['rays_per_s'][-1]:.1f} train rays/s, "
        f"Blender on 16-bit TIFFs "
        f"{formats['blender']['fit']['rays_per_s'][-1]:.1f}, efficient_sm on "
        f"BMP/PPM/GIF maps {formats['shadow']['fit']['rays_per_s'][-1]:.1f} "
        f"camera rays/s; fern-size lossless WebP {ffern['webp']['s']:.3f} s, "
        f"LZW TIFF {ffern['tiff']['s']:.3f} s; lossy VP8 "
        f"{formats['llff']['vp8_mpix_s']:.2f} megapixels/s ({card})")
    # phase 14: the orbit render's launches (rgb and sigma), the traced
    # bench step's and the width bench's
    orbit = entries["orbit"]["runs"]
    for row in kernels:
        key = {"searchsorted_rank_interp": "B", "searchsorted_rank": "A",
               "fused_nerf_fwd": "C", "fused_nerf_stash_fwd": "D",
               "fused_nerf_bwd_stash": "E"}.get(row["name"])
        if key is None:
            continue
        row["launches_entry_points"] = dict(
            orbit_rgb=orbit["rgb"]["counts"][key],
            orbit_sigma=orbit["sigma"]["counts"][key],
            profile_step=entries["profile"]["launches"][key],
            width_bench={w: r["launches"][key]
                         for w, r in entries["widths"].items()},
            bench_searchsorted=entries["ranks"]["launches"][key])
    ranks = entries["ranks"]
    log(f"[entry] phase 14: {entries['seconds']:.1f} s; orbit "
        f"{orbit['rgb']['s_per_pose']:.4f} s a 200x200 rgb pose (C "
        f"{orbit['rgb']['counts']['C']}, B {orbit['rgb']['counts']['B']} over "
        f"{orbit['rgb']['poses']} poses), sigma "
        f"{orbit['sigma']['s_per_pose']:.4f} s; profile_step buckets "
        f"{entries['profile']['buckets_us_per_step']} us a step; width_bench "
        + ", ".join(f"W = {w} {r['rays_per_s']} rays/s "
                    f"{r['model_tflops_fwd_bwd']} TFLOP/s"
                    for w, r in entries["widths"].items())
        + f"; A {ranks['kernel A (searchsorted_cuda)']:.1f} us against "
        f"torch.searchsorted {ranks['torch.searchsorted (library)']:.1f} us "
        f"({card})")
    fern = readers["fern"]
    log(f"[readers] phase 12: {readers['seconds']:.1f} s; fern-size decode "
        f"{fern['baseline']['s']:.3f} s baseline, "
        f"{fern['progressive']['s']:.3f} s progressive, plain entropy loop "
        f"{fern['baseline']['plain_entropy_s']:.2f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def light_sampler_cancellation(tmp: str) -> dict:
    """Queue 3 item 1: LightSampler's f32 step on the card against the CPU
    (phase 8's step, flags and draws) with each grad entry's cancellation
    ratio over its per-point terms (float64, on the CPU), the ReLU masks
    and the cotangents of every pass
    (``scripts/light_sampler_census.py``)."""
    from nerf_pl_tpu_torch.scripts import light_sampler_census as census

    t0 = time.perf_counter()
    out = census.cancellation_census(tmp, step_draws, LS_FLAGS)
    log(f"[census] LightSampler f32 step, card vs cpu: reading "
        f"{out['reading']:.4e} on {out['tensor']} ({out['points']} points); "
        f"the {out['entries']} entries that carry it: cancellation ratio "
        f"T/|S| {out['ratio']}, their relative difference {out['seen_rel']}, "
        f"the float32 estimate eps*sqrt(n)*T/|S| {out['estimate_rel']}, "
        f"difference over estimate {out['seen_over_estimate']}, within "
        f"eps*n*T/|S|: {out['within_worst_case']}; ratio over every entry "
        f"of the tensor {out['ratio_all_entries']}; ReLU masks that differ "
        f"{out['mask_flips']} of {out['masks']} (by pass and layer "
        f"{out['mask_flips_by_pass']}); of the carrying entries "
        f"{out['carry_index']}, {out.get('carry_in_flipped_units')} lie in "
        f"a unit whose mask differs; cotangents' largest relative "
        f"difference by pass {out['g_rel_by_pass']}; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--role"]:
        with open(sys.argv[3]) as f:
            {"nccl1": role_nccl1, "gloo2": role_gloo2}[sys.argv[2]](json.load(f))
        sys.exit(0)
    sys.exit(main())
