"""``scripts/profile_step.py``'s hold of its trace against the launch
counters: a trace whose kernel events of some letter are fewer (or more)
than that kernel's launches over the traced steps makes the script raise,
naming the letter, since its per-step times would read wrong.  Synthetic
CUPTI events, parsed as the script parses a trace; no card here.  And
``utils/profiling.py::profile_trace``, which every trace of the port opens
with (the script's and the trainers' ``--profile``): its warm-up step stays
out of the trace, and every op after it, the first included, is in it.
"""
import glob
import json
import os

import pytest
import torch

from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.scripts import profile_step
from nerf_pl_tpu_torch.training.trainer import NeRFSystem
from nerf_pl_tpu_torch.utils.profiling import profile_trace

D_EVENT = ("void (anonymous namespace)::fused_nerf_fwd_kernel<__half, false, "
           "true, false>(float const*, float*, __half const*, float const*, "
           "long long, __half*)")
E_EVENT = ("void (anonymous namespace)::fused_nerf_dgrad_kernel<__half, "
           "false, false, (nerf::Io)0>(float const*, float const*)")
WGRAD_EVENT = ("void (anonymous namespace)::fused_nerf_wgrad_mma_kernel<"
               "__half, 2432>(__half const*, __half const*, long long)")
A_EVENT = ("void (anonymous namespace)::rank_kernel<true, 4, false>(float "
           "const*, float const*, int*, float*, float*, long long, int, int, "
           "int, int)")
# two steps of the bench step: D twice a step, E's dgrad once a point chunk
# (1 + 3), its wgrad likewise, A once
STEP = [D_EVENT, A_EVENT, D_EVENT, E_EVENT, E_EVENT, E_EVENT, E_EVENT] + \
    [WGRAD_EVENT] * 4
LAUNCHES = {"C": 0, "D": 4, "E": 8, "F": 0, "C'": 0, "D'": 0, "E'": 0,
            "F'": 0, "G": 0, "H": 0, "A": 2, "B": 0}


def _rows(events, tmp_path):
    trace = [{"ph": "X", "cat": "kernel", "name": n, "pid": 0, "tid": 7,
              "ts": float(i), "dur": 1.0} for i, n in enumerate(events)]
    d = tmp_path / "trace"
    os.makedirs(d, exist_ok=True)
    with open(d / "h_1.1.pt.trace.json", "w") as f:
        json.dump({"traceEvents": trace}, f)
    rows, _, _, _ = profile_step.summarize(
        profile_step.load_trace_events(str(d)), 2)
    return rows


@pytest.mark.parametrize("drop", [0, 2, 3], ids=["first D", "second D",
                                                 "an E chunk"])
def test_a_missing_launch_raises_naming_its_letter(drop, tmp_path):
    events = STEP + STEP
    missing = profile_step.kernel_letter(events[drop])
    rows = _rows(events[:drop] + events[drop + 1:], tmp_path)
    with pytest.raises(RuntimeError, match=rf"{missing} \d+ traced, "
                       rf"{LAUNCHES[missing]} launched"):
        profile_step.check_launches(rows, LAUNCHES)


def test_the_whole_trace_passes(tmp_path):
    rows = _rows(STEP + STEP, tmp_path)
    profile_step.check_launches(rows, LAUNCHES)
    # a launch the counters did not see (the trace holds one more) raises
    with pytest.raises(RuntimeError, match="A 3 traced, 2 launched"):
        profile_step.check_launches(_rows(STEP + STEP + [A_EVENT], tmp_path),
                                    LAUNCHES)


def test_launch_records_find_a_call_without_its_kernel():
    """``launch_records`` matches the trace's launch calls to its kernel
    events by correlation: a call whose kernel event is missing is named
    by its time in the traced span, and a kernel that reads as starting
    before its call shows as a negative queue."""
    span = {"ph": "X", "cat": "user_annotation",
            "name": profile_step.STEPS_SPAN, "ts": 1000.0, "dur": 9000.0}
    calls = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
              "ts": 1000.0 + 1000 * i, "dur": 5.0,
              "args": {"correlation": i}} for i in range(4)]
    kernels = [{"ph": "X", "cat": "kernel", "name": D_EVENT,
                "ts": 1010.0 + 1000 * i, "dur": 500.0,
                "args": {"correlation": i}} for i in (0, 2, 3)]
    kernels[-1]["ts"] = 3990.0  # 10 us before its call
    rec = profile_step.launch_records([span, *calls, *kernels])
    assert rec == {"launch_calls": 4, "kernel_events": 3,
                   "untraced_ms": [1.0], "kernels_without_call": 0,
                   "least_queue_us": -10.0, "first_kernel_ms": 0.01}


def test_counters_read_grids_and_launches():
    """The counters the script reads: the fused MLP's grid launches (E's
    dgrad once a point chunk) and the searchsorted wrappers' launches."""
    counts = profile_step.launch_counts()
    assert set(counts) == set(LAUNCHES)
    assert all(isinstance(v, int) for v in counts.values())


def _trace_events(d):
    (path,) = glob.glob(os.path.join(str(d), "**", "*.pt.trace.json"),
                        recursive=True)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_the_trace_opens_after_its_warm_up(tmp_path):
    with profile_trace(str(tmp_path), "cpu"):
        torch.ones(8).cumsum(0)  # the first op of the traced region
        with torch.profiler.record_function("test/span"):
            torch.ones(8) * 2
    names = [e["name"] for e in _trace_events(tmp_path)]
    assert names.index("aten::cumsum") < names.index("test/span")
    # the warm-up's throwaway op is left out
    assert "aten::zeros" not in names and "aten::add_" not in names


def test_the_trainers_profile_traces_every_step_of_the_first_epoch(
        blender_root, tmp_path):
    argv = ["--root_dir", str(blender_root), "--dataset_name", "blender",
            "--img_wh", "16", "16", "--N_samples", "8", "--N_importance", "8",
            "--batch_size", "256", "--num_epochs", "1", "--chunk", "256",
            "--arch_width", "32", "--num_sanity_val_steps", "0",
            "--exp_name", "p", "--log_dir", str(tmp_path / "logs"),
            "--ckpt_dir", str(tmp_path / "ckpts"), "--profile"]
    system = NeRFSystem(get_opts(argv), device="cpu")
    step = system.train_step

    def spanned(*args, **kw):
        with torch.profiler.record_function("test/step"):
            return step(*args, **kw)

    system.train_step = spanned
    system.fit()
    events = _trace_events(tmp_path / "logs" / "p" / "trace")
    spans = sorted(e["ts"] for e in events if e["name"] == "test/step")
    assert len(spans) == system.steps_per_epoch > 1  # the first epoch's
    # the first step's ops are in the trace, from its start
    assert any(e["ts"] >= spans[0] and e["name"].startswith("aten::")
               for e in events)
