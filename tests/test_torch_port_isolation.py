"""The port stands alone: it imports torch, numpy and the standard library,
never JAX, flax, msgpack, PIL, imageio, scipy, zstandard or the JAX
package; its code and launchers read no file of the JAX package or
``native/`` and run none of the root scripts."""
import ast
import pathlib
import re
import subprocess
import sys

import nerf_pl_tpu_torch

PKG = pathlib.Path(nerf_pl_tpu_torch.__file__).resolve().parent
MODULES = sorted(
    ".".join(("nerf_pl_tpu_torch",) + p.relative_to(PKG).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "PIL", "imageio", "scipy",
             "zstandard", "nerf_pl_tpu")


def test_port_modules_import_without_jax_flax_msgpack_pil():
    assert "nerf_pl_tpu_torch.tools.serve" in MODULES
    assert "nerf_pl_tpu_torch.ops.native" in MODULES
    # the training slice, PNG reader included (the card's machine has no PIL)
    assert {"nerf_pl_tpu_torch.config", "nerf_pl_tpu_torch.train",
            "nerf_pl_tpu_torch.bench", "nerf_pl_tpu_torch.graft_entry",
            "nerf_pl_tpu_torch.data.png", "nerf_pl_tpu_torch.data.blender",
            "nerf_pl_tpu_torch.tools.render", "nerf_pl_tpu_torch.training.trainer",
            "nerf_pl_tpu_torch.training.optim", "nerf_pl_tpu_torch.training.losses",
            "nerf_pl_tpu_torch.training.metrics", "nerf_pl_tpu_torch.training.logging",
            "nerf_pl_tpu_torch.utils.visualization"} <= set(MODULES)
    # the evaluation slice: its own resize, PFM and GIF codecs (the card's
    # machine has neither PIL nor imageio)
    assert {"nerf_pl_tpu_torch.eval", "nerf_pl_tpu_torch.tools.evaluate",
            "nerf_pl_tpu_torch.data.resize", "nerf_pl_tpu_torch.data.depth_utils",
            "nerf_pl_tpu_torch.utils.gif"} <= set(MODULES)
    # slice 4: the probe of the fused MLP kernels, run on the card
    assert {"nerf_pl_tpu_torch.scripts",
            "nerf_pl_tpu_torch.scripts.kernel_probe"} <= set(MODULES)
    # the shadow trainer, its math, loader, blur and scene writer
    assert {"nerf_pl_tpu_torch.train_efficient_sm",
            "nerf_pl_tpu_torch.training.launch",
            "nerf_pl_tpu_torch.training.shadow_systems",
            "nerf_pl_tpu_torch.ops.shadow_mapping",
            "nerf_pl_tpu_torch.models.camera",
            "nerf_pl_tpu_torch.data.shadow_common",
            "nerf_pl_tpu_torch.data.blender_efficient_sm",
            "nerf_pl_tpu_torch.data.blur",
            "nerf_pl_tpu_torch.data.synthetic"} <= set(MODULES)
    # the other shadow trainers and their loaders
    assert {"nerf_pl_tpu_torch.train_rgb_sm_juntos",
            "nerf_pl_tpu_torch.train_shadows",
            "nerf_pl_tpu_torch.train_light_sampler",
            "nerf_pl_tpu_torch.train_shadow_mapping",
            "nerf_pl_tpu_torch.data.blender_rgb_shadows",
            "nerf_pl_tpu_torch.data.blender_shadows",
            "nerf_pl_tpu_torch.data.pyredner2"} <= set(MODULES)
    # the LLFF loader with its JPEG reader (the card's machine has no PIL),
    # and the profiling aids
    assert {"nerf_pl_tpu_torch.data.llff", "nerf_pl_tpu_torch.data.jpeg",
            "nerf_pl_tpu_torch.utils.profiling"} <= set(MODULES)
    # the JPEG 2000 reader: its container, codestream and plain stages
    assert {"nerf_pl_tpu_torch.data.jpeg2000",
            "nerf_pl_tpu_torch.data.j2k_codestream",
            "nerf_pl_tpu_torch.data.j2k_plain"} <= set(MODULES)
    # the tools: mesh extraction (its connected components in numpy, not
    # scipy), checkpoint import and export, the weights-only strip, and the
    # trainers' background writer
    assert {"nerf_pl_tpu_torch.extract_color_mesh",
            "nerf_pl_tpu_torch.import_torch_ckpt",
            "nerf_pl_tpu_torch.save_weights_only",
            "nerf_pl_tpu_torch.tools.extract_mesh",
            "nerf_pl_tpu_torch.tools.mesh_utils",
            "nerf_pl_tpu_torch.tools.import_torch_ckpt",
            "nerf_pl_tpu_torch.utils.io_async"} <= set(MODULES)
    # distribution and host streaming: torch.distributed, the frame shards
    # and the native ray store (its own copies of the JAX modules)
    assert {"nerf_pl_tpu_torch.parallel", "nerf_pl_tpu_torch.parallel.mesh",
            "nerf_pl_tpu_torch.data.sharding",
            "nerf_pl_tpu_torch.data.native"} <= set(MODULES)
    # the repo's other entry points: the scene, mesh-check, rate, profile,
    # width and searchsorted scripts, and the examples
    assert {"nerf_pl_tpu_torch.scripts.make_synthetic_scene",
            "nerf_pl_tpu_torch.scripts.validate_mesh",
            "nerf_pl_tpu_torch.scripts.sustained_rate",
            "nerf_pl_tpu_torch.scripts.profile_step",
            "nerf_pl_tpu_torch.scripts.width_bench",
            "nerf_pl_tpu_torch.scripts.bench_searchsorted",
            "nerf_pl_tpu_torch.examples",
            "nerf_pl_tpu_torch.examples.orbit_render",
            "nerf_pl_tpu_torch.examples.inspect_shadow_scene"} <= set(MODULES)
    # the TGA, ICO/CUR, QOI, SGI, PCX, PSD and DDS readers and the
    # bindings of their C++ stages
    assert {"nerf_pl_tpu_torch.data.tga", "nerf_pl_tpu_torch.data.ico",
            "nerf_pl_tpu_torch.data.qoi", "nerf_pl_tpu_torch.data.sgi",
            "nerf_pl_tpu_torch.data.pcx", "nerf_pl_tpu_torch.data.psd",
            "nerf_pl_tpu_torch.data.dds",
            "nerf_pl_tpu_torch.data.rle"} <= set(MODULES)
    # the rest of Image.ID: BLP, DCX, FITS, FLI, FTEX, GBR, ICNS, IM and IMT,
    # IPTC, MCIDAS, MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM and XVTHUMB, and
    # the raw decoder's unpackers
    assert {f"nerf_pl_tpu_torch.data.{m}" for m in (
        "blp", "dcx", "fits", "fli", "ftex", "gbr", "icns", "im", "iptc",
        "mcidas", "msp", "pcd", "pixar", "spider", "sun", "xbm", "xpm",
        "xvthumb", "unpack")} <= set(MODULES)
    # the rest of TIFF: the CCITT fax and zstd decoders
    assert {"nerf_pl_tpu_torch.data.ccitt",
            "nerf_pl_tpu_torch.data.zstd"} <= set(MODULES)
    # -I: no PYTHONPATH or user site, so nothing imported by a site hook
    # is counted against the port
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(PKG.parent)!r})\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_never_import_the_jax_package():
    # import statements and module-name strings (importlib, __import__);
    # zstandard too: the card's machine has no zstd package
    pattern = re.compile(
        r"^\s*(from|import)\s+(nerf_pl_tpu(?!_torch)|jax|flax|msgpack|PIL|imageio"
        r"|scipy|zstandard)\b"
        r"|[\"']nerf_pl_tpu(?!_torch)[\w.]*[\"']", re.M)
    sources = list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    hits = [f"{p}: {m.group(0).strip()}" for p in sources
            for m in pattern.finditer(p.read_text())]
    assert not hits, hits


# a path under the JAX package or native/, or a run of a root script
JAX_PATH = re.compile(r"(?<![\w.])(native|nerf_pl_tpu)(/|$)")
ROOT_SCRIPT = re.compile(
    r"(?<![\w/.])(train\w*|eval|extract_color_mesh)\.py\b")


def _code_strings(path):
    """The string constants of a module's code: docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def _shell_code(path):
    """A shell script's lines without their comments."""
    lines = []
    for line in path.read_text().splitlines():
        line = re.sub(r"(^|\s)#.*$", "", line)
        if line.strip():
            lines.append(line)
    return lines


def test_port_reads_no_jax_file_and_runs_no_root_script():
    hits = [f"{p}: {v!r}" for p in PKG.rglob("*.py") for v in _code_strings(p)
            if JAX_PATH.search(v) or ROOT_SCRIPT.search(v)]
    shells = sorted(PKG.rglob("*.sh"))
    assert {p.name for p in shells} >= {
        "lego_baseline.sh", "llff_fern.sh", "efficient_sm_64.sh",
        "rgb_sm_joint.sh", "pod_lego_800.sh", "recipes.sh",
        "acceptance_real_data.sh", "stream_slab_sweep.sh"}
    for p in shells:
        for line in _shell_code(p):
            if (JAX_PATH.search(line) or ROOT_SCRIPT.search(line)
                    or re.search(r"python\s+(?!-m\s+nerf_pl_tpu_torch\.|-\s)",
                                 line)):
                hits.append(f"{p}: {line.strip()}")
    assert not hits, hits


def test_ray_store_builds_the_ports_own_source():
    from nerf_pl_tpu_torch.data import native

    src = PKG / "csrc" / "raystore.cpp"
    assert src.is_file()
    assert native.SOURCE == src
    assert native.library_path().name.startswith("libraystore-")
