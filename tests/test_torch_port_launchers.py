"""The port's launchers and chains (``nerf_pl_tpu_torch/launchers/*.sh``,
``nerf_pl_tpu_torch/scripts/*.sh``) against the JAX package's: each runs
with a stand-in ``python`` first on its ``PATH`` that records its command
line, and each command of the port must be the JAX one's, flag for flag,
on the port's module in place of the JAX script (the chains add
``--device``), and must parse in the port to the configuration it parses
to in JAX, field for field.
"""
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import pytest

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.tools import evaluate as jevaluate
from nerf_pl_tpu.tools import extract_mesh as jextract
from nerf_pl_tpu_torch import config
from nerf_pl_tpu_torch.tools import evaluate, extract_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nerf_pl_tpu_torch")
LAUNCHERS = ["efficient_sm_64", "lego_baseline", "llff_fern", "pod_lego_800",
             "rgb_sm_joint"]

# The stand-in: records each command line (fields split by \x1f, records by
# \x1e); "python -" (a script on stdin) runs the real interpreter; "python
# -c" (the JAX pod launcher's process-index probe) exits 0, as on process 0;
# a trainer's command leaves the checkpoint its last epoch would write and
# an eval's prints a PSNR line, so the acceptance chain runs to its gate.
FAKE_PYTHON = r"""#!/bin/bash
case "$1" in
  -) exec "@REAL@" "$@" ;;
  -c) exit 0 ;;
esac
{ for a in "$@"; do printf '%s\037' "$a"; done; printf '\036'; } >> "$FAKE_PYTHON_LOG"
prev= ckpt_dir= exp= epochs=
for a in "$@"; do
  case "$prev" in
    --ckpt_dir) ckpt_dir=$a ;; --exp_name) exp=$a ;; --num_epochs) epochs=$a ;;
  esac
  prev=$a
done
if [ -n "$ckpt_dir" ] && [ -n "$epochs" ]; then
  mkdir -p "$ckpt_dir/$exp" && : > "$ckpt_dir/$exp/epoch=$((epochs - 1)).ckpt"
fi
case "$1 $2" in
  eval.py*|"-m nerf_pl_tpu_torch.eval") echo "Mean PSNR : 30.00" ;;
  *sustained_rate*) echo '{"epochs": 1}' ;;
esac
"""


@pytest.fixture(scope="module")
def fake_bin(tmp_path_factory):
    d = tmp_path_factory.mktemp("fake_bin")
    path = d / "python"
    path.write_text(FAKE_PYTHON.replace("@REAL@", sys.executable))
    path.chmod(0o755)
    return str(d)


def run_recorded(script, args, fake_bin, log, env=None):
    """Run ``script args`` with the stand-in ``python``; the commands it ran
    (each an argv without ``python``) and the completed process."""
    if os.path.exists(log):
        os.remove(log)
    full = {**os.environ, "PATH": f"{fake_bin}:{os.environ['PATH']}",
            "FAKE_PYTHON_LOG": log, "DATA_DIR": "/data/scene",
            "CKPT": "/data/run/last.ckpt", **(env or {})}
    res = subprocess.run(["bash", script, *args], capture_output=True,
                         text=True, env=full, timeout=60)
    calls = []
    if os.path.exists(log):
        with open(log, encoding="utf-8") as f:
            calls = [rec.split("\x1f")[:-1] for rec in f.read().split("\x1e")
                     if rec]
    return calls, res


# The JAX command's entry (``<script>.py``) and the port's (``-m <module>``)
def port_module(jax_entry):
    stem = os.path.splitext(os.path.basename(jax_entry))[0]
    prefix = "scripts." if jax_entry.startswith("scripts/") else ""
    return f"nerf_pl_tpu_torch.{prefix}{stem}"


PARSERS = {  # module -> (JAX parser, port parser)
    "train": (jconfig.get_opts, config.get_opts),
    "eval": (jevaluate.get_opts, evaluate.get_opts),
    "extract_color_mesh": (jextract.get_opts, extract_mesh.get_opts),
}


def fields(opts):
    d = (dataclasses.asdict(opts) if dataclasses.is_dataclass(opts)
         else dict(vars(opts)))
    d.pop("device", None)
    return d


def assert_same_commands(jax_calls, port_calls, device=None):
    """Each port command is the JAX one on the port's module (and, where
    the chain passes it, ``--device`` last), parsing to the same fields."""
    assert len(port_calls) == len(jax_calls) > 0
    for jcall, pcall in zip(jax_calls, port_calls):
        module = port_module(jcall[0])
        assert pcall[:2] == ["-m", module]
        flags = pcall[2:]
        if device is not None:
            assert flags[-2:] == ["--device", device], flags
            flags = flags[:-2]
        assert flags == jcall[1:]
        name = module.split(".")[-1]
        key = "train" if name.startswith("train") else name
        if key in PARSERS:
            jparse, pparse = PARSERS[key]
            assert fields(pparse(flags)) == fields(jparse(jcall[1:]))


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_matches_jax(name, fake_bin, tmp_path):
    """The same commands and configurations, extra flags passed last."""
    extra = ["--num_epochs", "3", "--exp_name", "mine"]
    log = str(tmp_path / "log")
    jax_calls, jres = run_recorded(os.path.join(REPO, "launchers",
                                                f"{name}.sh"), extra,
                                   fake_bin, log)
    port_calls, pres = run_recorded(os.path.join(PORT, "launchers",
                                                 f"{name}.sh"),
                                    [*extra, "--device", "cpu"], fake_bin,
                                    log)
    assert jres.returncode == pres.returncode == 0, jres.stderr + pres.stderr
    # the mesh command of the pod launcher takes no extra flags
    port_calls[0] = port_calls[0][:-2]
    assert_same_commands(jax_calls, port_calls)
    if name == "pod_lego_800":
        assert [c[1] for c in port_calls] == [
            "nerf_pl_tpu_torch.train", "nerf_pl_tpu_torch.extract_color_mesh"]
        assert "--multihost" in port_calls[0]


def test_pod_launcher_runs_the_mesh_tool_on_rank_0_only(fake_bin, tmp_path):
    log = str(tmp_path / "log")
    script = os.path.join(PORT, "launchers", "pod_lego_800.sh")
    for rank, n in (("0", 2), ("1", 1), ("3", 1)):
        calls, res = run_recorded(script, [], fake_bin, log,
                                  env={"RANK": rank, "WORLD_SIZE": "4"})
        assert res.returncode == 0, res.stderr
        assert len(calls) == n, (rank, calls)


def recipe_names(path):
    with open(path) as f:
        return [c for c in re.findall(r"^  (\S+)\)$", f.read(), re.M)
            if c != "*"]


RECIPES = recipe_names(os.path.join(REPO, "launchers", "recipes.sh"))


def test_recipes_are_every_jax_recipe():
    assert len(RECIPES) == 70
    assert recipe_names(os.path.join(PORT, "launchers", "recipes.sh")) == \
        RECIPES


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_matches_jax(recipe, fake_bin, tmp_path):
    log = str(tmp_path / "log")
    jax_calls, jres = run_recorded(os.path.join(REPO, "launchers",
                                                "recipes.sh"),
                                   [recipe, "--num_epochs", "1"], fake_bin,
                                   log)
    port_calls, pres = run_recorded(os.path.join(PORT, "launchers",
                                                 "recipes.sh"),
                                    [recipe, "--num_epochs", "1"], fake_bin,
                                    log)
    assert jres.returncode == pres.returncode == 0, jres.stderr + pres.stderr
    assert len(jax_calls) == 1
    assert_same_commands(jax_calls, port_calls)


def test_recipe_dispatcher_refuses_as_jax(fake_bin, tmp_path):
    """An unknown recipe exits 2 naming it; a missing DATA_DIR stops it."""
    log = str(tmp_path / "log")
    script = os.path.join(PORT, "launchers", "recipes.sh")
    calls, res = run_recorded(script, ["no_such_recipe"], fake_bin, log)
    assert res.returncode == 2 and "unknown recipe: no_such_recipe" in \
        res.stderr and not calls
    env = {k: v for k, v in os.environ.items() if k != "DATA_DIR"}
    res = subprocess.run(["bash", script, RECIPES[0]], capture_output=True,
                         text=True, timeout=60,
                         env={**env, "PATH": f"{fake_bin}:{env['PATH']}",
                              "FAKE_PYTHON_LOG": log})
    assert res.returncode != 0 and "DATA_DIR" in res.stderr


def test_acceptance_chain_matches_jax(fake_bin, tmp_path):
    """``SMOKE=1``: the same train and eval commands on the port's CLIs
    (``--device`` last), each to the same configuration, and the gate's
    PASS on the eval's PSNR line; FERN_DIR adds the fern pair."""
    from nerf_pl_tpu_torch.data.synthetic import generate_scene

    scene = generate_scene(str(tmp_path / "scene"), img_wh=8, n_train=1,
                           n_val=1, n_test=1)
    env = {"SMOKE": "1", "FERN_DIR": "/data/fern"}
    runs = {}
    for side, root in (("jax", REPO), ("port", PORT)):
        out = str(tmp_path / f"out_{side}")
        calls, res = run_recorded(
            os.path.join(root, "scripts", "acceptance_real_data.sh"),
            [scene, out], fake_bin, str(tmp_path / "log"),
            env={**env, "DEVICE": "cpu"})
        assert res.returncode == 0, res.stderr
        assert "PASS" in res.stdout
        runs[side] = [[a.replace(out, "OUT") for a in c] for c in calls]
    assert len(runs["jax"]) == 4
    assert_same_commands(runs["jax"], runs["port"], device="cpu")


def test_acceptance_chain_defaults_to_the_card(fake_bin, tmp_path):
    calls, res = run_recorded(
        os.path.join(PORT, "scripts", "acceptance_real_data.sh"),
        ["/no/such/scene"], fake_bin, str(tmp_path / "log"))
    assert res.returncode == 2 and "does not look like a blender scene" in \
        res.stderr and not calls


def test_stream_slab_sweep_matches_jax(fake_bin, tmp_path):
    """The same four streamed fits and sustained-rate reads (the JAX
    script's output root moved from /tmp into this test's directory)."""
    jax_dir = tmp_path / "jax" / "scripts"
    jax_dir.mkdir(parents=True)
    with open(os.path.join(REPO, "scripts", "stream_slab_sweep.sh")) as f:
        text = f.read().replace("/tmp/slab_sweep_", f"{tmp_path}/jax_slab_")
    (jax_dir / "stream_slab_sweep.sh").write_text(text)
    port_root = tmp_path / "port"
    shutil.copytree(os.path.join(PORT, "scripts"),
                    port_root / "nerf_pl_tpu_torch" / "scripts",
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    runs = {}
    for side, script in (
            ("jax", jax_dir / "stream_slab_sweep.sh"),
            ("port", port_root / "nerf_pl_tpu_torch" / "scripts"
             / "stream_slab_sweep.sh")):
        calls, res = run_recorded(str(script), ["/data/scene64", "3"],
                                  fake_bin, str(tmp_path / "log"),
                                  env={"DEVICE": "cpu"})
        assert res.returncode == 0, res.stderr
        assert res.stdout.count("slab=") == 4
        runs[side] = [[re.sub(r".*slab_(sweep_)?(\d+)", r"SLAB\2", a)
                       for a in c] for c in calls]
    assert len(runs["jax"]) == 8
    assert_same_commands(runs["jax"], runs["port"], device="cpu")
