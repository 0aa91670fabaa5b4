"""The port's entry points beside the JAX package's scripts, on the CPU: the
scene writer, the orbit render, the shadow-scene inspection, the mesh check,
the sustained rate, the step profile's parser, the width bench's FLOP count
and the searchsorted bench's rank sets.  Each JAX script is run as its
users run it (``runpy.run_path`` with ``sys.argv`` set), JAX on the CPU;
the port's counterpart runs with ``--device cpu``.
"""
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_pl_tpu.ops.searchsorted import searchsorted_jnp
from nerf_pl_tpu.training import checkpoints as jckpt
from nerf_pl_tpu_torch.data.image import read_picture
from nerf_pl_tpu_torch.data.synthetic import (SPHERE_C, generate_pyredner_scene,
                                              generate_scene)
from nerf_pl_tpu_torch.examples import inspect_shadow_scene, orbit_render
from nerf_pl_tpu_torch.scripts import (bench_searchsorted, make_synthetic_scene,
                                       profile_step, sustained_rate,
                                       validate_mesh, width_bench)
from nerf_pl_tpu_torch.tools.mesh_utils import write_ply
from nerf_pl_tpu_torch.utils.profiling import profile_trace

from test_torch_port_models import np_nerf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")


def run_jax_script(rel_path, argv, monkeypatch):
    """Run the JAX package's script as ``python <rel_path> argv`` does; its
    exit code (0 when it returns)."""
    path = os.path.join(REPO, rel_path)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        return e.code
    return 0


def jax_module(rel_path):
    """The globals of a JAX script imported, not run."""
    return runpy.run_path(os.path.join(REPO, rel_path), run_name="jax_script")


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def json_close(a, b, tol):
    """Equal structure, numbers within ``tol``."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            json_close(a[k], b[k], tol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            json_close(x, y, tol)
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert abs(a - b) <= tol, (a, b)
    else:
        assert a == b


# ------------------------------------------------------------ the scene CLI
@pytest.mark.parametrize("fmt", [["blender"], ["llff"], ["llff", "--spheric"],
                                 ["pyredner"]],
                         ids=["blender", "llff", "llff_spheric", "pyredner"])
def test_make_synthetic_scene_matches_jax(fmt, tmp_path, monkeypatch, capsys):
    """The same files at 16 px: every image the same pixels read back by the
    port's reader and by PIL; ``transforms_*.json`` and ``poses_bounds.npy``
    within 1e-6 (the port's generator repeats the JAX one's float32 numpy
    arithmetic); the same printed line."""
    argv = ["--img_wh", "16", "--n_train", "3", "--n_val", "1", "--n_test",
            "1", "--format", *fmt]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    assert run_jax_script("scripts/make_synthetic_scene.py",
                          ["--out", jax_out, *argv], monkeypatch) == 0
    jax_line = capsys.readouterr().out
    make_synthetic_scene.main(["--out", port_out, *argv, "--device", "cpu"])
    assert capsys.readouterr().out == jax_line.replace(jax_out, port_out)

    names = files_under(jax_out)
    assert names == files_under(port_out) and names
    for name in names:
        a, b = os.path.join(jax_out, name), os.path.join(port_out, name)
        if name.endswith(".png"):
            pil = [np.asarray(Image.open(p)) for p in (a, b)]
            np.testing.assert_array_equal(pil[0], pil[1])
            np.testing.assert_array_equal(read_picture(b).pixels, pil[0])
        elif name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                json_close(json.load(fa), json.load(fb), 1e-6)
        elif name.endswith(".npy"):
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=0,
                                       atol=1e-6)
        else:
            raise AssertionError(f"unexpected file {name}")


def test_scene_cli_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthetic_scene.main(["--out", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()


# -------------------------------------------------------------- orbit render
@pytest.fixture(scope="module")
def w32_ckpt(tmp_path_factory):
    """A W = 32 coarse + fine checkpoint in the JAX trainer's file format,
    its sigma heads scaled so the random scene is partly opaque."""
    params = {"coarse": np_nerf(80, W=32), "fine": np_nerf(81, W=32)}
    for tree in params.values():
        tree["sigma"]["w"] *= 20.0
    path = str(tmp_path_factory.mktemp("orbit") / "epoch=0.ckpt")
    jckpt.save_checkpoint(path, {"params": params, "opt_state": [],
                                 "epoch": 0})
    return path


# The fine depth of this sharp random scene (sigma x 20): the fine samples
# sit where the coarse weights put them, and the 2^9-frequency encoding of
# a sample moves by ~1e-4 rad a float32 ulp of its position, so the depth
# follows the sums' order further than the other outputs do.  JAX against
# itself, with the rays' directions moved by one ulp, reads up to 1.6e-4 on
# these poses, the port against JAX on the same rays 8.7e-5; 1e-4 is the
# tolerance of the renderer's own parity test (test_torch_port_render.py).
ORBIT_DEPTH_FINE_TOL = 1e-4


@pytest.mark.parametrize("mode", ["rgb", "sigma"])
def test_orbit_render_matches_jax(mode, w32_ckpt, tmp_path, monkeypatch,
                                  capsys):
    """3 poses at 8x8 from one checkpoint.  The rays: origins equal,
    directions within one float32 ulp of 1 (the two ``get_rays`` sum the
    rotation in other orders).  ``render_image``'s float outputs on the same
    rays within 1e-5 of JAX's (float32 products summed in other orders),
    but the fine depth within ``ORBIT_DEPTH_FINE_TOL``.  Every PNG frame within 1 uint8 level
    of JAX's (truncation flips a level where a value sits at a level's
    edge), the GIF's frame count and size (no GIF bytes: the two quantisers
    differ), the same printed lines."""
    import jax.numpy as jnp

    from nerf_pl_tpu.tools import render as jrender

    port = []  # (rays, outputs) of each pose
    jax_rays, on_port_rays = [], []
    port_render, jax_render = orbit_render.render_image, jrender.render_image

    def port_capture(models, rays, *a, **k):
        out = port_render(models, rays, *a, **k)
        port.append((rays.numpy(), {key: v.numpy() for key, v in out.items()}))
        return out

    def jax_capture(params, rays, key, **k):
        i = len(jax_rays)
        jax_rays.append(np.asarray(rays))
        same = jax_render(params, jnp.asarray(port[i][0]), key, **k)
        on_port_rays.append({name: np.asarray(v) for name, v in same.items()})
        return jax_render(params, rays, key, **k)

    monkeypatch.setattr(orbit_render, "render_image", port_capture)
    monkeypatch.setattr(jrender, "render_image", jax_capture)
    argv = ["--ckpt_path", w32_ckpt, "--img_wh", "8", "8", "--n_poses", "3",
            "--N_samples", "8", "--N_importance", "8", "--mode", mode]
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    frames = orbit_render.main([*argv, "--out_dir", dirs["port"],
                                "--device", "cpu"])
    port_log = capsys.readouterr().out
    assert run_jax_script("examples/orbit_render.py",
                          [*argv, "--out_dir", dirs["jax"]], monkeypatch) == 0
    assert capsys.readouterr().out == port_log.replace(dirs["port"],
                                                       dirs["jax"])

    assert len(port) == len(jax_rays) == 3
    for (rays, out), jrays, jout in zip(port, jax_rays, on_port_rays):
        np.testing.assert_array_equal(rays[:, :3], jrays[:, :3])
        np.testing.assert_array_equal(rays[:, 6:], jrays[:, 6:])
        np.testing.assert_allclose(rays[:, 3:6], jrays[:, 3:6], rtol=0,
                                   atol=2.0 ** -23)
        assert set(out) == set(jout)
        for key in jout:
            tol = ORBIT_DEPTH_FINE_TOL if key == "depth_fine" else 1e-5
            np.testing.assert_allclose(out[key], jout[key], rtol=0,
                                       atol=tol, err_msg=key)
    names = [f"orbit_{i:03d}.png" for i in range(3)] + ["orbit.gif"]
    for side in dirs:
        assert sorted(os.listdir(dirs[side])) == sorted(names)
    for i in range(3):
        a, b = (np.asarray(Image.open(os.path.join(dirs[s], names[i])))
                for s in ("jax", "port"))
        assert a.shape == b.shape == (8, 8, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_array_equal(b, frames[i])
    assert np.stack(frames).std() > 1.0  # the scene is not blank
    gifs = [Image.open(os.path.join(dirs[s], "orbit.gif")) for s in dirs]
    assert [g.n_frames for g in gifs] == [3, 3]
    assert [g.size for g in gifs] == [(8, 8), (8, 8)]


# ------------------------------------------------------- shadow inspection
@pytest.fixture(scope="module")
def shadow_scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("shadow_scenes")
    return {"blender": generate_scene(str(root / "blender"), img_wh=16,
                                      n_train=3, n_val=1, n_test=1),
            "pyredner": generate_pyredner_scene(str(root / "pyredner"),
                                                img_wh=16, n_train=3,
                                                n_val=1, n_test=1)}


@pytest.mark.parametrize("dataset", ["efficient_sm", "rgb_sm", "shadows",
                                     "pyredner2"])
def test_inspect_shadow_scene_matches_jax(dataset, shadow_scenes, monkeypatch,
                                          capsys):
    """The same report on a 16x16 synthetic shadow scene: the same text, and
    every number it prints within 1e-5 (relative, and absolute near 0) of
    JAX's (float32 numpy on both sides; the projection in torch and in XLA
    rounds differently in the last bits)."""
    root = shadow_scenes["pyredner" if dataset == "pyredner2" else "blender"]
    argv = ["--root_dir", root, "--dataset_name", dataset,
            "--img_wh", "16", "16"]
    assert run_jax_script("examples/inspect_shadow_scene.py", argv,
                          monkeypatch) == 0
    jax_out = capsys.readouterr().out
    ok = inspect_shadow_scene.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert NUMBER.sub("#", out) == NUMBER.sub("#", jax_out)
    got = [float(x) for x in NUMBER.findall(out)]
    want = [float(x) for x in NUMBER.findall(jax_out)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if dataset == "shadows":  # the image-space loader keeps no poses
        assert ok is None and "consistent" not in out
    else:
        assert ok is True and "consistent: True" in out


# --------------------------------------------------------------- mesh check
def sphere_ply(path, radius=1.0, colored=True, n=24):
    """A UV sphere around ``SPHERE_C`` coloured ``0.5 + 0.5 * normal``."""
    th, ph = np.meshgrid(np.linspace(0.05, np.pi - 0.05, n),
                         np.linspace(0, 2 * np.pi, 2 * n, endpoint=False),
                         indexing="ij")
    nrm = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                    np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    verts = (SPHERE_C + radius * nrm).astype(np.float32)
    idx = np.arange(n * 2 * n).reshape(n, 2 * n)
    a, b = idx[:-1], np.roll(idx, -1, axis=1)[:-1]
    c, d = idx[1:], np.roll(idx, -1, axis=1)[1:]
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([b, d, c], -1).reshape(-1, 3)])
    colors = (np.clip(0.5 + 0.5 * nrm, 0, 1) * 255).astype(np.uint8)
    write_ply(path, verts, tris, colors if colored else None)
    return path


@pytest.mark.parametrize("radius,colored,code", [(1.0, True, 0),
                                                 (1.2, True, 1),
                                                 (1.0, False, 0)],
                         ids=["sphere", "perturbed", "uncoloured"])
def test_validate_mesh_matches_jax(radius, colored, code, tmp_path,
                                   monkeypatch, capsys):
    """The same report, the same PASS/FAIL and the same exit code."""
    ply = sphere_ply(str(tmp_path / "m.ply"), radius, colored)
    monkeypatch.chdir(REPO)  # the JAX script imports its package from "."
    assert run_jax_script("scripts/validate_mesh.py", [ply],
                          monkeypatch) == code
    jax_out = capsys.readouterr().out
    assert validate_mesh.main([ply, "--device", "cpu"]) == code
    assert capsys.readouterr().out == jax_out
    assert jax_out.rstrip().endswith("PASS" if code == 0 else "FAIL")


# ------------------------------------------------------------ sustained rate
@pytest.mark.parametrize("skips", [[], ["2"], ["0", "0"], ["4", "4"]])
def test_sustained_rate_matches_jax(skips, tmp_path, monkeypatch, capsys):
    """Equal dicts and the same JSON line from one ``metrics.jsonl`` as the
    trainers write it (a record per epoch with ``train/rays_per_s``, others
    between)."""
    rng = np.random.RandomState(3)
    path = tmp_path / "metrics.jsonl"
    t = 1.7e9
    with open(path, "w") as f:
        for epoch in range(6):
            t += rng.uniform(2, 4)
            f.write(json.dumps({"step": 10 * epoch, "time": t,
                                "val/loss": 0.1}) + "\n")
            f.write(json.dumps({"step": 10 * epoch, "time": t + 0.5,
                                "train/loss": 0.2,
                                "train/rays_per_s": rng.uniform(5e4, 7e4)})
                    + "\n")
    assert run_jax_script("scripts/sustained_rate.py", [str(path), *skips],
                          monkeypatch) == 0
    jax_out = capsys.readouterr().out
    got = sustained_rate.main([str(path), *skips, "--device", "cpu"])
    assert capsys.readouterr().out == jax_out
    assert got == json.loads(jax_out)


# -------------------------------------------------------------- profile_step
# demangled kernel names as CUPTI records them, one of each the port's
# sources define, with the letters PERF.md gives them
KERNEL_EVENTS = [
    ("void (anonymous namespace)::fused_nerf_fwd_kernel<__nv_bfloat16, false, "
     "true, false>(float const*, float*, __nv_bfloat16 const*, float const*, "
     "long long, __nv_bfloat16*)", "D", "fused_mlp"),
    ("void (anonymous namespace)::fused_nerf_fwd_kernel<float, true, false, "
     "true>(float const*, float*, float const*, float const*, long long, "
     "float*)", "C'", "fused_mlp"),
    ("void (anonymous namespace)::fused_nerf_dgrad_kernel<__nv_bfloat16, "
     "false, false, (nerf::Io)0>(float const*, float const*)", "E",
     "fused_mlp"),
    ("void (anonymous namespace)::fused_nerf_dgrad_kernel<__nv_bfloat16, "
     "false, true, (nerf::Io)2>(float const*, float const*)", "H",
     "fused_mlp"),
    ("void (anonymous namespace)::fused_nerf_wgrad_mma_kernel<264>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, long long)", "E/F/H",
     "fused_mlp"),
    ("void (anonymous namespace)::reduce_rows_kernel(float const*, int, long "
     "long, int, int, float*)", "E/F/H", "fused_mlp"),
    ("void (anonymous namespace)::fused_nerf_wide_kernel<nerf::Wide<512>, "
     "__nv_bfloat16, false>(float const*, int, float*)", "G", "fused_mlp"),
    ("void (anonymous namespace)::rank_kernel<true, 4, false>(float const*, "
     "float const*, int*, float*, float*, long long, int, int, int, int)",
     "A", "searchsorted"),
    ("void (anonymous namespace)::rank_kernel<true, 1, true>(float const*, "
     "float const*, int*, float*, float*, long long, int, int, int, int)",
     "B", "searchsorted"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int, at::native::CUDAFunctor_add"
     "<float>)", None, "other"),
]


def test_profile_step_parses_a_cpu_trace(tmp_path, capsys):
    """``--parse_only`` on the Chrome trace ``profile_trace`` writes on the
    CPU of one tiny training step (W = 32, 64 rays), with one kernel event
    of each kind appended as CUPTI would add them on the card: the JAX
    script's keys, the steps' span, the kernels' total, the buckets by the
    kernels' sources and each kernel's letter."""
    from nerf_pl_tpu_torch.models.nerf import init_nerf
    from nerf_pl_tpu_torch.ops.rendering import render_rays

    gen = torch.Generator().manual_seed(0)
    models = [init_nerf(gen, W=32, device="cpu") for _ in range(2)]
    rays = torch.cat([torch.zeros(64, 3), torch.nn.functional.normalize(
        torch.randn(64, 3, generator=gen), dim=-1), torch.full((64, 1), 2.0),
        torch.full((64, 1), 6.0)], 1)
    trace_dir = str(tmp_path / "trace")
    with profile_trace(trace_dir, "cpu"):
        with torch.profiler.record_function(profile_step.STEPS_SPAN):
            out = render_rays(*models, rays, gen, N_samples=8,
                              N_importance=8, perturb=1.0, noise_std=1.0,
                              use_fused=True)
            out["rgb_fine"].sum().backward()
    (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(path) as f:
        doc = json.load(f)
    span = [e for e in doc["traceEvents"]
            if e.get("cat") == "user_annotation"
            and e.get("name") == profile_step.STEPS_SPAN]
    assert len(span) == 1
    iters = 2
    for i, (name, _, _) in enumerate(KERNEL_EVENTS):
        doc["traceEvents"].append({"ph": "X", "cat": "kernel", "name": name,
                                   "pid": 0, "tid": 7, "ts": 1.0 + i,
                                   "dur": 10.0 * (i + 1)})
    with open(path, "w") as f:
        json.dump(doc, f)

    res = profile_step.main(["--parse_only", "--trace_dir", trace_dir,
                             "--iters", str(iters), "--out",
                             str(tmp_path / "p.json"), "--device", "cpu"])
    jax_keys = {"backend", "batch", "iters", "step_ms_from_module_span",
                "op_lane_total_us_per_step", "lanes", "buckets_us_per_step",
                "top_ops"}
    assert jax_keys <= set(res)
    with open(tmp_path / "p.json") as f:
        assert json.load(f) == res
    assert res["step_ms_from_module_span"] == round(
        span[0]["dur"] / iters / 1e3, 2)
    n = len(KERNEL_EVENTS)
    assert res["op_lane_total_us_per_step"] == 10.0 * n * (n + 1) / 2 / iters
    want = {}
    for i, (_, _, kind) in enumerate(KERNEL_EVENTS):
        want[kind] = want.get(kind, 0.0) + 10.0 * (i + 1) / iters
    assert res["buckets_us_per_step"] == want
    letters = {r["op"]: r["kernel"] for r in res["top_ops"]}
    assert letters == {name: letter for name, letter, _ in KERNEL_EVENTS}
    assert set(res["by_kernel_us_per_step"]) == {
        letter for _, letter, _ in KERNEL_EVENTS if letter}
    assert '"op_lane_total_us_per_step"' in capsys.readouterr().out


def test_profile_step_buckets_name_every_kernel_source():
    """The buckets read the ``__global__`` names of the port's sources."""
    assert profile_step.kernel_names("fused_mlp*.cu") == {
        "fused_nerf_fwd_kernel", "fused_nerf_dgrad_kernel",
        "fused_nerf_wgrad_kernel", "fused_nerf_wgrad_mma_kernel",
        "fused_nerf_wgrad_narrow_kernel", "reduce_rows_kernel",
        "fused_nerf_wide_kernel"}
    assert profile_step.kernel_names("searchsorted.cu") == {"rank_kernel"}


# --------------------------------------------------------------- width bench
@pytest.mark.parametrize("width", [128, 256, 512, 1024])
def test_width_bench_flops_match_jax(width):
    jax_fn = jax_module("scripts/width_bench.py")["mlp_flops_per_point"]
    assert width_bench.mlp_flops_per_point(width) == jax_fn(width)


def test_width_bench_keeps_an_error_row(monkeypatch, capsys):
    """A width that fails prints its error row and the others go on."""
    def bench_width(width, *a, **k):
        if width == 512:
            raise MemoryError("out of memory")
        return {"width": width, "rays_per_s": 1.0}

    monkeypatch.setattr(width_bench, "bench_width", bench_width)
    rows = width_bench.main(["--widths", "256", "512", "1024", "--device",
                             "cpu"])
    assert rows == [{"width": 256, "rays_per_s": 1.0},
                    {"width": 512, "batch": 4096,
                     "error": "MemoryError: out of memory"},
                    {"width": 1024, "rays_per_s": 1.0}]
    assert [json.loads(line) for line in
            capsys.readouterr().out.splitlines()] == rows


# --------------------------------------------------------- searchsorted bench
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bench_searchsorted_ranks_match_jax(seed):
    """On seeded CDF rows (some with plateaus: zero weights) and draws (some
    exactly on CDF entries), the port's kernel-A wrapper (its plain version
    here), ``torch.searchsorted``, the broadcast compare-sum and the
    stable-sort formulation give JAX's ``searchsorted_jnp`` ranks, and so
    does the JAX script's own sort formulation."""
    rng = np.random.RandomState(seed)
    B, M, K = 64, bench_searchsorted.M, bench_searchsorted.K
    w = rng.rand(B, M - 1).astype(np.float32) + 1e-3
    w[rng.rand(B, M - 1) < 0.2] = 0.0
    cdf = np.cumsum(w / w.sum(1, keepdims=True), axis=1, dtype=np.float32)
    cdf = np.concatenate([np.zeros((B, 1), np.float32), cdf], 1)
    u = rng.rand(B, K).astype(np.float32)
    hit = rng.rand(B, K) < 0.1
    u[hit] = cdf[np.nonzero(hit)[0], rng.randint(0, M, hit.sum())]
    want = np.asarray(searchsorted_jnp(cdf, u))
    jax_sort = jax_module("scripts/bench_searchsorted.py")["searchsorted_sort"]
    np.testing.assert_array_equal(np.asarray(jax_sort(cdf, u)), want)
    ranks = bench_searchsorted.rank_sets(torch.from_numpy(cdf),
                                         torch.from_numpy(u))
    assert len(ranks) == 4
    for name, r in ranks.items():
        assert r.dtype == torch.int32, name
        np.testing.assert_array_equal(r.numpy(), want, err_msg=name)


def test_bench_searchsorted_inputs_are_cdfs():
    """Kernel A takes non-decreasing rows only: the bench's rows are CDFs
    from 0 to 1."""
    x = bench_searchsorted.make_inputs("cpu")
    cdf = x["cdf"]
    assert cdf.shape == (bench_searchsorted.B, bench_searchsorted.M)
    assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
    assert bool((cdf[:, 0] == 0).all())
    assert float((cdf[:, -1] - 1).abs().max()) < 1e-5
