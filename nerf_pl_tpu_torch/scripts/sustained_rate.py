"""Sustained-throughput report from a run's ``metrics.jsonl`` (the
counterpart of ``scripts/sustained_rate.py``).

The per-epoch ``train/rays_per_s`` that the trainers log at the end of each
epoch (``training/trainer.py``, written by ``training/logging.py``) is
aggregated over the epochs, leaving out the first ``skip_first`` (the
epoch that builds and loads the kernels) and the last ``skip_last``; the
cycle times come from the records' ``time`` over the same window.  Prints
one JSON line with the JAX script's keys.

    python -m nerf_pl_tpu_torch.scripts.sustained_rate \
        <log_dir>/<exp_name>/metrics.jsonl [skip_first [skip_last]] \
        [--device cuda|cpu]

The report is read on the host; ``--device`` (default ``cuda``) is the
port's own, and like every entry point of the port the script refuses to
run without a card unless given ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .. import resolve_device


def report(path: str, skip_first: int = 1, skip_last: int = 1) -> dict:
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    rates = [r["train/rays_per_s"] for r in recs if "train/rays_per_s" in r]
    times = [r["time"] for r in recs if "train/rays_per_s" in r]
    n = len(rates)
    if n == 0:
        sys.exit("no train/rays_per_s records (only the vanilla trainer "
                 "logs the finalize-to-finalize rate)")
    core = (rates[skip_first: n - skip_last] if n > skip_first + skip_last
            else rates)
    # the cycles of the same window as the rates: dts[i] is the cycle that
    # ends at times[i + 1]
    dts = np.diff(times)
    core_dts = (dts[max(0, skip_first - 1): len(dts) - skip_last]
                if len(dts) > skip_first + skip_last else dts)
    out = {
        "epochs": n,
        "mean_rays_per_s": round(float(np.mean(core)), 1),
        "median_rays_per_s": round(float(np.median(core)), 1),
        "p5_rays_per_s": round(float(np.percentile(core, 5)), 1),
        "mean_cycle_s": (round(float(np.mean(core_dts)), 3) if len(core_dts)
                         else None),
        "wall_s": round(times[-1] - times[0], 1) if n > 1 else None,
    }
    print(json.dumps(out))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("skips", nargs="*", type=int,
                    help="skip_first [skip_last] (default 1 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if len(args.skips) > 2:
        ap.error("at most two skips: skip_first skip_last")
    resolve_device(args.device)
    return report(args.path, *args.skips)


if __name__ == "__main__":
    main()
