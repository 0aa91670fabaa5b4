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
   PyTorch call computes the same function, that call's time.
3. The render server end to end at full width: a seeded checkpoint, then
   ``build_server`` at 200x200, 64+128 samples, ``--max_batch 4``; 4
   concurrent POSTs and 1 GET over HTTP.  The kernels' launch counters are
   zeroed just before the requests and read just after; one 4-view batch
   is then profiled (device time by kernel, idle share).  Then the random
   sampler path (``render_rays`` with ``perturb=1``), which runs kernel A.
   Last, 256 rays of one view rendered in float32 on the card and on the
   CPU, compared.
4. One JSON line of kernel numbers, then the result line
   ``{"ok": true, "device": {...}}`` last.

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
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[ptxas {name}] {line.strip()}")


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
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for sigma_only in (True, False):
            out = fm.fused_nerf_apply_raw_t_cuda(model, x, sigma_only, dtype)
            ref = fm.fused_nerf_apply_raw_t_plain(model, x, sigma_only, dtype)
            torch.cuda.synchronize()
            err = max_abs(out, ref)
            rel = err / max(float(ref.abs().max()), 1e-30)
            name = str(dtype).replace("torch.", "")
            mode = "sigma-only" if sigma_only else "rgb"
            mean = float((out - ref).abs().mean())
            log(f"[C {name} {mode}] P={P} max_abs_err={err:.3e} "
                f"rel={rel:.3e} mean_abs_err={mean:.3e} tol={TOL_C[dtype]:.0e}"
                f" (mean tol {TOL_C_MEAN:.0e})")
            if (not torch.isfinite(out).all() or not err <= TOL_C[dtype]
                    or not mean <= TOL_C_MEAN):
                raise AssertionError(f"kernel C {name} {mode} disagrees "
                                     f"with its plain version: {err}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)

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
        log(f"[C time bf16 {mode}] P={Pc} kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b:.3f} ms ({by}); sinf/cosf "
            f">= {sin_ms:.3f} ms at one op each on the f32 units")
        rows[mode] = dict(P=Pc, ms=ms, plain_ms=plain_ms, bound_ms=b,
                          bound_by=by)
        del xc
    torch.cuda.empty_cache()
    return dict(err=worst, rows=rows)


def check_searchsorted(gen, dev) -> dict:
    from nerf_pl_tpu_torch.ops import searchsorted as ss

    B, M, K = CHUNK_RAYS, N_SAMPLES - 1, N_IMPORTANCE
    w = torch.rand((B, M - 1), generator=gen) + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros((B, 1)), cdf], -1).contiguous().to(dev)
    u = torch.rand((B, K), generator=gen)
    u[:, 0] = 0.0  # ties with row[0]
    u[:, -1] = 1.0  # at / past the row's end
    u[:, 1] = cdf[:, 5].cpu()  # exact ties inside the row
    u = u.contiguous().to(dev)

    r, lo, hi = ss.searchsorted_interp_cuda(cdf, u)
    rp, lop, hip = ss.searchsorted_interp_plain(cdf, u)
    torch.cuda.synchronize()
    err_b = max(max_abs(r, rp), max_abs(lo, lop), max_abs(hi, hip))
    log(f"[B] B={B} M={M} K={K} max_abs_err={err_b:.3e} tol=0 (compares, "
        f"min and max only)")
    if err_b != 0.0:
        raise AssertionError(f"kernel B disagrees with its plain version")
    err_a = 0.0
    for side in ("right", "left"):
        a = ss.searchsorted_cuda(cdf, u, side)
        ap = ss.searchsorted_plain(cdf, u, side)
        lib = torch.searchsorted(cdf, u, right=(side == "right"))
        torch.cuda.synchronize()
        e = max_abs(a, ap)
        log(f"[A {side}] max_abs_err={e:.3e} tol=0; torch.searchsorted "
            f"agrees: {bool((lib == a).all())}")
        if e != 0.0:
            raise AssertionError(f"kernel A ({side}) disagrees")
        err_a = max(err_a, e)

    ms_b = cuda_ms(lambda: ss.searchsorted_interp_cuda(cdf, u), iters=20)
    plain_b = cuda_ms(lambda: ss.searchsorted_interp_plain(cdf, u), iters=5)
    bytes_b = 4 * B * M + 4 * B * K + 3 * 4 * B * K
    bound_b, by_b = bound_ms(bytes_b, 6 * B * K * M, F32_FLOPS)
    ms_a = cuda_ms(lambda: ss.searchsorted_cuda(cdf, u), iters=20)
    plain_a = cuda_ms(lambda: ss.searchsorted_plain(cdf, u), iters=5)
    lib_a = cuda_ms(lambda: torch.searchsorted(cdf, u, right=True), iters=20)
    bytes_a = 4 * B * M + 4 * B * K + 4 * B * K
    bound_a, by_a = bound_ms(bytes_a, 2 * B * K * M, F32_FLOPS)
    log(f"[B time] kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms, bound "
        f"{bound_b:.4f} ms ({by_b})")
    log(f"[A time] kernel {ms_a:.4f} ms, plain {plain_a:.4f} ms, "
        f"torch.searchsorted {lib_a:.4f} ms, bound {bound_a:.4f} ms ({by_a})")
    return dict(
        B=dict(err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=bound_b,
               bound_by=by_b),
        A=dict(err=err_a, ms=ms_a, plain_ms=plain_a, bound_ms=bound_a,
               bound_by=by_a, library_ms=lib_a),
    )


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

    return {"C": fm.fused_nerf_apply_raw_t_cuda,
            "B": ss.searchsorted_interp_cuda, "A": ss.searchsorted_cuda}


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


def profile_batch(service, wh: int) -> None:
    """Device time by kernel and the device's busy share over one 4-view
    batch render, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    c2w = service._c2w_for([4.0, 0.5, 0.0], (0.0, 0.0, 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service.render_batch([c2w] * 4, wh)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0.0)
              for e in kernels}
    busy_ms = sum(dev_us.values()) / 1e3
    if busy_ms <= 0:
        log(f"[profile] 4-view batch {wall_ms:.1f} ms wall; device time "
            "not measured (the profiler saw no device events)")
        return
    log(f"[profile] 4-view batch at {wh}x{wh}: {wall_ms:.1f} ms wall, "
        f"{busy_ms:.1f} ms device busy ({100 * busy_ms / wall_ms:.1f}%), "
        f"idle share {100 * (1 - busy_ms / wall_ms):.1f}%")
    for name, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}%"
            f"  {name[:90]}")


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

    fine_row, coarse_row = c["rows"]["rgb"], c["rows"]["sigma-only"]
    kernels = [
        dict(name="fused_nerf_fwd", route="cuda",
             source="nerf_pl_tpu_torch/csrc/fused_mlp.cu",
             replaces="nerf_pl_tpu/ops/fused_mlp.py:1015",
             launches=served["counts"]["C"], max_abs_err=c["err"],
             ms=fine_row["ms"], plain_ms=fine_row["plain_ms"],
             bound_ms=fine_row["bound_ms"], bound_by=fine_row["bound_by"],
             library_ms=None, shape=f"rgb bf16 P={fine_row['P']}",
             sigma_only=coarse_row),
        dict(name="searchsorted_rank_interp", route="cuda",
             source="nerf_pl_tpu_torch/csrc/searchsorted.cu",
             replaces="nerf_pl_tpu/ops/searchsorted.py:122",
             launches=served["counts"]["B"], max_abs_err=s["B"]["err"],
             ms=s["B"]["ms"], plain_ms=s["B"]["plain_ms"],
             bound_ms=s["B"]["bound_ms"], bound_by=s["B"]["bound_by"],
             library_ms=None,
             shape=f"B={CHUNK_RAYS} M={N_SAMPLES - 1} K={N_IMPORTANCE}"),
        dict(name="searchsorted_rank", route="cuda",
             source="nerf_pl_tpu_torch/csrc/searchsorted.cu",
             replaces="nerf_pl_tpu/ops/searchsorted.py:45",
             launches=sampler_counts["A"], max_abs_err=s["A"]["err"],
             ms=s["A"]["ms"], plain_ms=s["A"]["plain_ms"],
             bound_ms=s["A"]["bound_ms"], bound_by=s["A"]["bound_by"],
             library_ms=s["A"]["library_ms"],
             shape=f"B={CHUNK_RAYS} M={N_SAMPLES - 1} K={N_IMPORTANCE}",
             path="render_rays(perturb=1); not on the serve path"),
    ]
    log(f"[serve] {served['rays_per_s']:.1f} rays/s, "
        f"{served['ms']:.1f} ms per request; f32 card-vs-cpu err "
        f"{f32_err:.3e}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
