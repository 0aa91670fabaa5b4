"""Trace the flagship training step and write a table of device time by
kernel (the counterpart of ``scripts/profile_step.py``).

Runs ``bench.py``'s step (batch 4,096, 64 + 128 samples, bf16, the fused
MLP kernels D and E, kernel A, Adam) for ``--iters`` steps under
``utils/profiling.py::profile_trace``, after one step that builds the
kernels outside the trace, then parses the Chrome trace that
``torch.profiler`` exports into the JAX script's JSON keys:

  * ``step_ms_from_module_span``: the wall span of the traced steps (the
    ``profile_step/steps`` annotation, closed by fetching the last loss)
    over the steps;
  * ``op_lane_total_us_per_step``: the sum of the device's kernel events
    (``cat: "kernel"``) over the steps;
  * ``buckets_us_per_step``: the fused-MLP kernels (every ``__global__`` of
    ``csrc/fused_mlp*.cu``), the searchsorted kernels (``csrc/searchsorted.cu``)
    and everything else;
  * ``top_ops``: the kernels by device time, each with the letter PERF.md
    gives it (C-I, A, B; the wgrad and reduction kernels of the backward
    are ``E/F/H``) where it is one of the port's;
  * ``by_kernel_us_per_step``: device time by those letters;
  * ``launches``: each letter's kernel launches over the traced steps, read
    from the wrappers' counters (``grids``: the backward's wrappers launch
    their dgrad kernel once a point chunk) before and after them.  The
    trace's count of each letter must equal its counter, or the script
    raises naming the letter: a launch missing from the trace would make
    its kernel's time a step read low.

    python -m nerf_pl_tpu_torch.scripts.profile_step --iters 10 \
        [--out results/profile_step.json] [--parse_only] [--device cuda|cpu]

The trace is taken on the card (``--device``, default ``cuda``; the script
refuses to run without a card unless given ``cpu``, whose trace holds no
kernel events).  ``--parse_only`` re-parses an existing ``--trace_dir``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from pathlib import Path

import torch

from .. import resolve_device
from ..bench import make_step
from ..utils.profiling import profile_trace

STEPS_SPAN = "profile_step/steps"
CSRC = Path(__file__).resolve().parents[1] / "csrc"
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def kernel_names(pattern: str) -> set:
    """The ``__global__`` functions of the sources ``csrc/<pattern>``."""
    return {m.group(1) for p in CSRC.glob(pattern)
            for m in _GLOBAL.finditer(p.read_text())}


def launch_counts() -> dict:
    """Each kernel's launches so far, by letter: the wrappers' ``grids``
    where they keep one (the fused MLP's), else their ``launches``."""
    from ..ops import fused_mlp, searchsorted

    fns = {**fused_mlp.KERNELS, "A": searchsorted.searchsorted_cuda,
           "B": searchsorted.searchsorted_interp_cuda}
    return {k: getattr(fn, "grids", fn.launches) for k, fn in fns.items()}


def run_traced(iters: int, batch: int, trace_dir: str, device) -> dict:
    """Trace ``iters`` steps; the launches of each kernel over them."""
    step = make_step(batch, torch.bfloat16, device)
    float(step())  # the kernels build and load outside the trace window
    with profile_trace(trace_dir, device):
        before = launch_counts()
        with torch.profiler.record_function(STEPS_SPAN):
            for _ in range(iters):
                loss = step()
            float(loss)  # the host fetch keeps every step inside the span
        after = launch_counts()
    return {k: after[k] - before[k] for k in after}


def check_launches(rows: list, launches: dict, records=None) -> None:
    """The trace's kernel events of each letter against the launch counters
    (``launches``, by letter); raises naming every letter that differs,
    with the trace's ``launch_records`` where given."""
    seen = {}
    for r in rows:
        if r["kernel"]:
            seen[r["kernel"]] = seen.get(r["kernel"], 0) + r["count"]
    bad = {k: (seen.get(k, 0), n) for k, n in launches.items()
           if seen.get(k, 0) != n}
    if bad:
        raise RuntimeError(
            "the trace's kernel events disagree with the launch counters: "
            + ", ".join(f"{k} {t} traced, {n} launched"
                        for k, (t, n) in sorted(bad.items()))
            + (f"; the trace's launch records {records}" if records else ""))


def launch_records(events: list) -> dict:
    """The trace's launch calls (its ``cuda_runtime`` and ``cuda_driver``
    events named ``*Launch*``) against its kernel events, matched by
    ``args.correlation``: how many of each; the calls with no kernel event
    (``untraced_ms``: each at its ms from the traced span's start); the
    kernel events with no call; the least time from a call to its kernel's
    start (``least_queue_us``: negative where the device's timestamps read
    early); and the first kernel event's ms from the span's start."""
    spans = [e["ts"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == STEPS_SPAN]
    t0 = min(spans) if spans else 0.0
    kernels = {e["args"]["correlation"]: e for e in events
               if is_device_lane(e) and "correlation" in e.get("args", {})}
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("ph") == "X"
             and e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "Launch" in e.get("name", "")
             and "correlation" in e.get("args", {})}
    queue = [kernels[c]["ts"] - e["ts"] for c, e in calls.items()
             if c in kernels]
    return {
        "launch_calls": len(calls),
        "kernel_events": len(kernels),
        "untraced_ms": sorted(round((e["ts"] - t0) / 1e3, 3)
                              for c, e in calls.items() if c not in kernels),
        "kernels_without_call": sum(c not in calls for c in kernels),
        "least_queue_us": round(min(queue), 1) if queue else None,
        "first_kernel_ms": (round((min(e["ts"] for e in kernels.values())
                                   - t0) / 1e3, 3) if kernels else None),
    }


def load_trace_events(trace_dir: str) -> list:
    """The events of the newest ``*.pt.trace.json`` under ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        doc = json.load(f)
    return doc.get("traceEvents", doc if isinstance(doc, list) else [])


def is_device_lane(event: dict) -> bool:
    """A kernel that ran on the device: CUPTI's events carry
    ``cat: "kernel"`` (host ops are ``cpu_op``, launches ``cuda_runtime``)."""
    return event.get("ph") == "X" and event.get("cat") == "kernel"


def _template_args(name: str, start: int) -> list:
    """The top-level template arguments of the ``<...>`` at ``start``."""
    depth, args, cur = 0, [], ""
    for ch in name[start:]:
        if ch == "<":
            depth += 1
            if depth == 1:
                continue
        elif ch == ">":
            depth -= 1
            if depth == 0:
                args.append(cur.strip())
                return args
        elif ch == "," and depth == 1:
            args.append(cur.strip())
            cur = ""
            continue
        cur += ch
    return args


def _flag(arg: str) -> bool:
    return arg == "true" or arg.rstrip(")").endswith("1")


def kernel_letter(name: str):
    """The letter PERF.md gives a kernel event of the port, from its
    demangled name and template arguments; None for any other kernel."""
    m = re.search(r"\b(fused_nerf_fwd_kernel|fused_nerf_dgrad_kernel|"
                  r"fused_nerf_wgrad\w*_kernel|reduce_rows_kernel|"
                  r"fused_nerf_wide_kernel|rank_kernel|chain_kernel)\b", name)
    if m is None:
        return None
    base = m.group(1)
    args = (_template_args(name, m.end()) if name[m.end():m.end() + 1] == "<"
            else [])
    if base == "fused_nerf_fwd_kernel" and len(args) == 4:
        # <T, SIGMA_ONLY, STASH, ROW_MAJOR>
        return ("D" if _flag(args[2]) else "C") + ("'" if _flag(args[3]) else "")
    if base == "fused_nerf_dgrad_kernel" and len(args) == 4:
        # <T, SIGMA_ONLY, REMAT, IN>; IN: 0 channel-major, 1 row, 2 embedded
        io = re.sub(r"\D", "", args[3].split(")")[-1]) or args[3]
        if io == "2":
            return "H"
        return ("F" if _flag(args[2]) else "E") + ("'" if io == "1" else "")
    if base == "rank_kernel" and len(args) == 3:
        # <RIGHT, VEC, INTERP>
        return "B" if _flag(args[2]) else "A"
    if base.startswith("fused_nerf_wgrad") or base == "reduce_rows_kernel":
        return "E/F/H"  # the backward's wgrad and reductions, any of the three
    return {"fused_nerf_wide_kernel": "G", "chain_kernel": "I"}.get(base)


def summarize(events: list, iters: int):
    """Per-kernel device time, the device's total, the traced steps' wall
    span (us) and the device lanes."""
    pid_names, tid_names = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e.get("pid")] = str(e.get("args", {}).get("name", ""))
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e.get("pid"), e.get("tid"))] = str(
                e.get("args", {}).get("name", ""))
    per_op, lanes, span_us = {}, set(), 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") == "user_annotation" and e.get("name") == STEPS_SPAN:
            span_us += float(e["dur"])
            continue
        if not is_device_lane(e):
            continue
        pid, tid = e.get("pid"), e.get("tid")
        lanes.add((pid_names.get(pid, str(pid)),
                   tid_names.get((pid, tid), str(tid))))
        rec = per_op.setdefault(e["name"], {"us": 0.0, "count": 0})
        rec["us"] += float(e["dur"])
        rec["count"] += 1
    total_us = sum(r["us"] for r in per_op.values())
    rows = [
        {
            "op": name,
            "kernel": kernel_letter(name),
            "total_us": round(rec["us"], 1),
            "count": rec["count"],
            "us_per_step": round(rec["us"] / max(iters, 1), 1),
            "pct": round(100.0 * rec["us"] / max(total_us, 1e-9), 2),
        }
        for name, rec in sorted(per_op.items(), key=lambda kv: -kv[1]["us"])
    ]
    return rows, total_us, span_us, sorted(lanes)


def bucket(rows: list) -> dict:
    """Device time of the fused-MLP kernels, the searchsorted kernels and
    everything else, by the ``__global__`` names of their sources."""
    mlp = kernel_names("fused_mlp*.cu")
    rank = kernel_names("searchsorted.cu")

    def kind(op):
        if any(re.search(rf"\b{k}\b", op) for k in rank):
            return "searchsorted"
        if any(re.search(rf"\b{k}\b", op) for k in mlp):
            return "fused_mlp"
        return "other"

    agg = {}
    for r in rows:
        agg[kind(r["op"])] = agg.get(kind(r["op"]), 0.0) + r["total_us"]
    return agg


def get_opts(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--trace_dir", default="results/profile_step_trace")
    ap.add_argument("--out", default="results/profile_step.json")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--parse_only", action="store_true",
                    help="re-parse an existing trace_dir without rerunning")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = get_opts(argv)
    device = resolve_device(args.device)
    launches = None
    if not args.parse_only:
        os.makedirs(args.trace_dir, exist_ok=True)
        launches = run_traced(args.iters, args.batch, args.trace_dir, device)
    iters = args.iters
    events = load_trace_events(args.trace_dir)
    rows, total_us, span_us, lanes = summarize(events, iters)
    by_kernel = {}
    for r in rows:
        if r["kernel"]:
            by_kernel[r["kernel"]] = round(
                by_kernel.get(r["kernel"], 0.0) + r["us_per_step"], 1)
    out = {
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "batch": args.batch,
        "iters": iters,
        "step_ms_from_module_span": round(span_us / max(iters, 1) / 1e3, 2),
        "op_lane_total_us_per_step": round(total_us / max(iters, 1), 1),
        "lanes": [" / ".join(lane) for lane in lanes],
        "buckets_us_per_step": {
            k: round(v / max(iters, 1), 1) for k, v in bucket(rows).items()
        },
        "by_kernel_us_per_step": by_kernel,
        "launches": launches,
        "launch_records": launch_records(events),
        "top_ops": rows[: args.top],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("backend", "step_ms_from_module_span",
                       "op_lane_total_us_per_step", "buckets_us_per_step",
                       "by_kernel_us_per_step")}))
    print(f"wrote {args.out} ({len(rows)} ops)")
    if launches is not None and device.type == "cuda":
        check_launches(rows, launches, out["launch_records"])
    return out


if __name__ == "__main__":
    main()
