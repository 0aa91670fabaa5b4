"""Train rays/s of this checkout against another checkout of the port, in
turns on one card.

    python -m nerf_pl_tpu_torch.scripts.fit_turns --other DIR [--order PCWDDWCP]

Each letter of ``--order`` is one fit, a process of its own started from
the root of its checkout: ``P`` the checkout at ``DIR`` (for example the
parent commit, unpacked with ``git archive``), ``C`` this one, ``W`` this
one with every background write run at once on the loop's thread
(``AsyncWriter.submit`` replaced in that process, as a trainer without
the writer would save), ``D`` this one with Adam's square root taken in
float64 and rounded once (``Adam._core`` replaced: the correctly rounded
root, which gives the card's and the CPU's steps the same bits).  Two
fits, both Adam, each through ``python -m
nerf_pl_tpu_torch.train``'s ``main`` on scenes this script writes once
with ``data/synthetic.py``:

  * ``vanilla``: full width, bf16, 64 + 128 samples, batch 4,096 on 8
    views of 100x100 (``chip_smoke.py``'s phase 4 fit), 5 epochs of 19
    steps; its rate is the mean of epochs 1-4 (epoch 0 compiles nothing
    but warms the allocator and the kernels' first launches);
  * ``llff``: ``launchers/llff_fern.sh``'s flags (full width, f32, 64 + 64
    samples, batch 1,024, adam, steplr) on 3 forward-facing views of
    504x378, 1 epoch of 558 steps (``chip_smoke.py``'s phase 9 fit).

The rate is the trainer's own ``train/rays_per_s`` (steps x batch over the
epoch's wall time; validation and the checkpoint's save, which follow the
timed steps, excluded), and ``fit_s`` the wall seconds of ``main`` (every
epoch, validation, saves and the final drain of the writer).  Both
checkouts' kernels are built first, in parallel.  Prints one JSON line a
fit and a summary line: per fit and variant the readings in order, their
mean, min and max.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FITS = {
    "vanilla": (["--dataset_name", "blender", "--img_wh", "100", "100",
                 "--N_samples", "64", "--N_importance", "128",
                 "--batch_size", "4096", "--lr", "5e-4", "--white_back",
                 "true", "--compute_dtype", "bfloat16", "--num_epochs", "5"],
                slice(1, None)),
    "llff": (["--dataset_name", "llff", "--img_wh", "504", "378",
              "--N_samples", "64", "--N_importance", "64",
              "--batch_size", "1024", "--optimizer", "adam", "--lr", "5e-4",
              "--lr_scheduler", "steplr", "--decay_step", "10", "20",
              "--decay_gamma", "0.5", "--num_epochs", "1"],
             slice(0, None)),
}
PATCH = {"P": "", "C": "",
         "W": "from nerf_pl_tpu_torch.utils import io_async; "
              "io_async.AsyncWriter.submit = lambda self, fn: fn(); ",
         "D": "from nerf_pl_tpu_torch.training import optim; "
              "optim.Adam._core = lambda self, mu_hat, nu_hat, sc: mu_hat / ("
              "torch.sqrt(nu_hat.double()).to(nu_hat.dtype) + self.eps); "}
FIT = ("import sys, time, torch; {patch}"
       "from nerf_pl_tpu_torch import train; t0 = time.perf_counter(); "
       "train.main(sys.argv[1:]); torch.cuda.synchronize(); "
       "print('[fit_s]', time.perf_counter() - t0)")
BUILD = "from nerf_pl_tpu_torch.ops import native; native.build()"


def write_scenes(tmp: str) -> dict:
    sys.path.insert(0, HERE)
    from nerf_pl_tpu_torch.data.synthetic import (generate_llff_scene,
                                                  generate_scene)

    roots = {k: os.path.join(tmp, k) for k in FITS}
    generate_scene(roots["vanilla"], img_wh=100, n_train=8, n_val=1,
                   n_test=0)
    generate_llff_scene(roots["llff"], img_wh=(504, 378), n_views=4)
    return roots


def fit(tree: str, patch: str, root: str, flags: list, tmp: str,
        name: str) -> tuple:
    argv = ["--root_dir", root, *flags, "--exp_name", name,
            "--log_dir", os.path.join(tmp, "logs"),
            "--ckpt_dir", os.path.join(tmp, "ckpts"), "--device", "cuda"]
    r = subprocess.run([sys.executable, "-c", FIT.format(patch=patch), *argv],
                       cwd=tree, capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"fit {name} in {tree}: rc {r.returncode}\n"
                           f"{r.stderr[-3000:]}")
    fit_s = float(r.stdout.split("[fit_s]")[-1].split()[0])
    with open(os.path.join(tmp, "logs", name, "metrics.jsonl")) as f:
        return [rec["train/rays_per_s"] for rec in map(json.loads, f)
                if "train/rays_per_s" in rec], fit_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the other checkout (variant P)")
    ap.add_argument("--order", default="PCWDDWCP")
    ap.add_argument("--fits", nargs="+", default=list(FITS))
    args = ap.parse_args(argv)
    trees = {"P": os.path.abspath(args.other), "C": HERE, "W": HERE,
             "D": HERE}
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t)
              for t in sorted(set(trees.values()))]
    if any(b.wait() for b in builds):
        raise RuntimeError("a checkout's kernels did not build")
    print(f"[turns] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        roots = write_scenes(tmp)
        for which in args.fits:
            flags, epochs = FITS[which]
            seen = {}
            for i, v in enumerate(args.order):
                per_epoch, fit_s = fit(trees[v], PATCH[v], roots[which],
                                       flags, tmp, f"{which}_{i}_{v}")
                rate = sum(per_epoch[epochs]) / len(per_epoch[epochs])
                seen.setdefault(v, []).append((rate, fit_s))
                print(json.dumps({"fit": which, "turn": i, "variant": v,
                                  "rays_per_s": rate, "fit_s": fit_s,
                                  "per_epoch": per_epoch}), flush=True)
            summary[which] = {
                v: {key: dict(values=x, mean=sum(x) / len(x), min=min(x),
                              max=max(x))
                    for key, x in zip(("rays_per_s", "fit_s"), zip(*runs))}
                for v, runs in seen.items()}
    print(json.dumps({"turns": summary,
                      "seconds": time.perf_counter() - t0}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
