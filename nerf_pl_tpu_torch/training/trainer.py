"""The vanilla-NeRF training system (``nerf_pl_tpu/training/trainer.py``;
reference ``train.py`` NeRFSystem), on one device.

  * The ray and colour buffers are moved to the device once; each epoch
    draws a permutation from a ``torch.Generator`` seeded by ``cfg.seed``
    and takes ``n // batch_size`` steps of render -> loss -> backward ->
    Adam.  The renderer's random draws come from a second generator on the
    device, seeded from ``cfg.seed`` too.
  * ``validation`` renders every val image whole (``tools.render``) with the
    train-time perturb and noise, as the reference's ``validation_step``.
  * Checkpoints in the JAX package's file format: ``epoch=N.ckpt`` for the
    top 5 by val loss, ``last.ckpt`` on epochs without validation, and
    full-state resume (params, optimizer state, epoch) from either trainer's
    files.  SIGTERM saves ``preempt.ckpt`` at the next step boundary, labelled
    e-1 when epoch e is incomplete, then lets the signal take its course.
  * The per-epoch print and the ``metrics.jsonl`` keys are the JAX trainer's.
  * ``--profile`` traces the first epoch with ``torch.profiler`` into
    ``<log_dir>/<exp_name>/trace`` (this trainer and ``ShadowsSystem``, as in
    JAX; the other shadow systems accept the flag and ignore it, as JAX's
    do); ``--debug_nans`` raises ``FloatingPointError`` at the first step
    whose loss, a parameter or its grad is not finite (every system).

Checkpoints, validation images and TensorBoard images are written by one
ordered background thread (``utils/io_async.py::AsyncWriter``), as the JAX
trainer writes them: the loop snapshots the weights and the optimiser state
on the device (both are updated in place by the next step) and the worker
copies the snapshot to the host and serialises it while the next steps run;
``fit`` drains the writer before it returns, so every checkpoint it lists is
on disk.  The JAX trainer's one-dispatch val program and epoch pipeline hid
a remote-TPU latency that a local card does not have.  Flags the port cannot
honour yet raise ``ValueError`` (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..data import dataset_dict
from ..models.nerf import init_nerf, nerf_param_tree
from ..ops.rendering import render_rays
from ..tools.render import render_image
from ..utils.io_async import AsyncWriter, snapshot
from ..utils.profiling import profile_trace, raise_if_not_finite
from ..utils.visualization import visualize_depth
from . import checkpoints
from .logging import RunLogger
from .losses import loss_dict
from .metrics import psnr as psnr_metric
from .optim import (get_optimizer, host_to_device, make_lr_schedule,
                    named_params)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def common_unsupported(cfg: Config) -> Dict[str, bool]:
    """The flags no trainer of the port honours yet, each with whether
    ``cfg`` sets it."""
    return {
        "--num_devices > 1": (cfg.num_devices or 1) > 1,
        "--multihost": cfg.multihost,
        "--per_host_data": cfg.per_host_data,
        "--data_device_resident false": not cfg.data_device_resident,
        "--global_reshuffle": cfg.global_reshuffle,
        f"--compute_dtype {cfg.compute_dtype}": cfg.compute_dtype not in _DTYPES,
    }


def raise_unsupported(flags: Dict[str, bool]) -> None:
    bad = [k for k, v in flags.items() if v]
    if bad:
        raise ValueError(f"not ported yet: {', '.join(bad)} (see ROADMAP.md)")


def init_models(cfg: Config, device) -> Dict[str, torch.nn.Module]:
    """Seeded coarse (and fine) models; torch's generator, so the weights
    differ from the JAX trainer's for the same seed."""
    width = getattr(cfg, "arch_width", 256) or 256
    gen = torch.Generator().manual_seed(cfg.seed)
    models = {"coarse": init_nerf(gen, W=width, device="cpu")}
    if cfg.N_importance > 0:
        models["fine"] = init_nerf(gen, W=width, device="cpu")
    return {k: m.to(device) for k, m in models.items()}


def render_kwargs_from_cfg(cfg: Config, white_back: bool, train: bool) -> dict:
    return dict(
        N_samples=cfg.N_samples,
        use_disp=cfg.use_disp,
        perturb=cfg.perturb if train else 0.0,
        noise_std=cfg.noise_std if train else 0.0,
        N_importance=cfg.N_importance,
        white_back=white_back,
        compute_dtype=_DTYPES[cfg.compute_dtype],
        use_fused=bool(cfg.use_fused_mlp),
        fused_channel_io=cfg.fused_channel_io,
        remat_fine=cfg.remat_fine if train else False,
    )


class NeRFSystem:
    """Vanilla NeRF trainer (reference ``train.py:27-148``)."""

    mode = "rgb"
    datasets = ("blender", "llff")
    loss_label = "loss"  # the epoch line's name for train/loss
    traces_first_epoch = True  # --profile (the JAX NeRFSystem's fit)

    @classmethod
    def check_supported(cls, cfg: Config) -> None:
        """Raise on the flags this trainer cannot honour yet."""
        if cfg.loss_type not in loss_dict:
            raise ValueError(f"--loss_type {cfg.loss_type!r} not recognized "
                             f"(one of {sorted(loss_dict)})")
        if cfg.loss_type == "sm":
            raise ValueError(
                "--loss_type sm scores the sm_coarse / sm_fine outputs of a "
                "shadow-mapping render, which this trainer's rgb render does "
                "not make (the JAX trainer stops at its first step with "
                "KeyError 'sm_coarse'; see ROADMAP.md, Queue 3)")
        raise_unsupported({
            **common_unsupported(cfg),
            f"--dataset_name {cfg.dataset_name}":
                cfg.dataset_name not in cls.datasets,
        })

    def __init__(self, cfg: Config, device=None):
        self.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_name = cfg.loss_type
        self.logger = RunLogger(cfg.log_dir, cfg.exp_name)
        self._writer = AsyncWriter()
        self.shuffle_gen = torch.Generator().manual_seed(cfg.seed)
        self.render_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self._prepare_data()
        self.rkw = render_kwargs_from_cfg(cfg, self.white_back, train=True)
        self._build_state()
        self.ckpt_root = os.path.join(cfg.ckpt_dir, cfg.exp_name)
        self._topk: list = []  # (val_loss, path)
        self._preempted = False
        self._epoch, self._step = self.epoch0, 0  # where the fit is

    # -- data ---------------------------------------------------------------
    def _prepare_data(self):
        cfg = self.cfg
        ds_cls = dataset_dict[cfg.dataset_name]
        kwargs = dict(root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh))
        if cfg.dataset_name == "llff":
            # one val image: one device (the JAX trainer passes its chip
            # count, reference train.py:79)
            kwargs.update(spheric_poses=cfg.spheric_poses, val_num=1)
        else:
            kwargs.update(near=cfg.blender_near, far=cfg.blender_far,
                          white_back=cfg.white_back,
                          black_and_white=cfg.black_and_white_test)
        self.train_dataset = ds_cls(split="train", **kwargs)
        self.val_dataset = ds_cls(split="val", **kwargs)
        self.white_back = self.train_dataset.white_back
        self.rays = torch.from_numpy(self.train_dataset.all_rays).to(self.device)
        self.rgbs = torch.from_numpy(self.train_dataset.all_rgbs).to(self.device)

    # -- state --------------------------------------------------------------
    def _build_state(self):
        cfg = self.cfg
        self.steps_per_epoch = self._count_steps()
        self.schedule = make_lr_schedule(
            cfg.lr, cfg.lr_scheduler, self.steps_per_epoch, cfg.num_epochs,
            cfg.decay_step, cfg.decay_gamma, cfg.poly_exp,
            cfg.warmup_multiplier, cfg.warmup_epochs, cfg.optimizer)
        self.models = init_models(cfg, self.device)
        if cfg.ckpt_path:
            for name, model in self.models.items():
                checkpoints.load_ckpt_into(
                    model, cfg.ckpt_path, model_name=name,
                    prefixes_to_ignore=cfg.prefixes_to_ignore)
        self.optimizer = get_optimizer(
            cfg.optimizer, self.schedule, named_params(self.models),
            cfg.momentum, cfg.weight_decay, grad_clip=cfg.grad_clip)
        self.epoch0 = 0
        if cfg.ckpt_path and cfg.ckpt_path.endswith(".ckpt"):
            # full-state resume when given a trainer checkpoint; weights-only
            # exports lack opt_state/epoch and keep the partial restore above
            raw = checkpoints.load_checkpoint(cfg.ckpt_path)
            if "opt_state" in raw and "epoch" in raw:
                for name, model in self.models.items():  # every leaf
                    checkpoints.load_ckpt_into(model, cfg.ckpt_path, name)
                self.optimizer.load_state_tree(raw["opt_state"])
                self.epoch0 = int(raw["epoch"]) + 1
            else:
                print(f"[resume] {cfg.ckpt_path} has no trainer state "
                      "(weights-only artifact): params restored, optimizer "
                      "fresh, starting at epoch 0", flush=True)

    def _count_steps(self) -> int:
        n = self.rays.shape[0]
        steps = n // self.cfg.batch_size
        if steps < 1:
            raise ValueError(
                f"batch_size {self.cfg.batch_size} exceeds the {n} training "
                "rays; the epoch would run zero steps")
        return steps

    @property
    def rays_per_step(self) -> int:
        """Camera rays trained a step (``train/rays_per_s`` counts these)."""
        return self.cfg.batch_size

    # -- one step -----------------------------------------------------------
    def train_step(self, rays: torch.Tensor, rgbs: torch.Tensor,
                   overrides: Optional[dict] = None):
        """render -> loss -> backward -> Adam; returns (loss, psnr) tensors.
        ``overrides``: the ``render_rays`` overrides of the random draws."""
        results = render_rays(self.models["coarse"], self.models.get("fine"),
                              rays, self.render_gen, mode=self.mode,
                              overrides=overrides, **self.rkw)
        loss = loss_dict[self.loss_name](results, rgbs)
        typ = "fine" if "rgb_fine" in results else "coarse"
        psnr = psnr_metric(results[f"rgb_{typ}"].detach(), rgbs)
        self._optimize(loss)
        return loss.detach(), psnr

    def _optimize(self, loss: torch.Tensor) -> None:
        """backward, then one optimizer step; under ``--debug_nans`` the
        step first checks its loss, parameters and grads (one synchronising
        call)."""
        self.optimizer.zero_grad()
        loss.backward()
        if self.cfg.debug_nans:
            raise_if_not_finite(loss, self.optimizer.params.values(),
                                self._epoch, self._step)
        self._step += 1
        self.optimizer.step()

    # -- validation ---------------------------------------------------------
    def validation(self, epoch: int,
                   max_images: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        n_img = len(self.val_dataset)
        if max_images is not None:
            n_img = min(n_img, max_images)
        losses, psnrs = [], []
        for i in range(n_img):
            sample = self.val_dataset[i]
            rays = torch.from_numpy(sample["rays"]).to(self.device)
            rgbs = torch.from_numpy(sample["rgbs"]).to(self.device)
            results = render_image(self.models, rays, self.render_gen,
                                   chunk=cfg.chunk, mode=self.mode, **self.rkw)
            typ = "fine" if "rgb_fine" in results else "coarse"
            losses.append(float(loss_dict[self.loss_name](results, rgbs)))
            psnrs.append(float(psnr_metric(results[f"rgb_{typ}"], rgbs)))
            if i == 0:
                self._dump_val_image(epoch, sample["rgbs"],
                                     results[f"rgb_{typ}"],
                                     results[f"depth_{typ}"])
        return {"val/loss": float(np.mean(losses)),
                "val/psnr": float(np.mean(psnrs))}

    def _dump_val_image(self, epoch: int, gt: np.ndarray, rgb, depth) -> None:
        """The first val image's GT / prediction / depth grid to TensorBoard,
        assembled on the writer thread from a snapshot of the render."""
        W, H = self.cfg.img_wh
        snap = snapshot((rgb, depth))
        step = epoch * self.steps_per_epoch

        def dump():
            img, dep = (t.float().numpy() for t in snap.fetch())
            self.logger.images(step, "val/GT_pred_depth", np.stack([
                gt.reshape(H, W, 3).transpose(2, 0, 1),
                img.reshape(H, W, 3).transpose(2, 0, 1),
                visualize_depth(dep.reshape(H, W))]))

        self._writer.submit(dump)

    # -- checkpointing ------------------------------------------------------
    def save_ckpt(self, epoch: int, val_loss: Optional[float],
                  filename: Optional[str] = None,
                  background: bool = False) -> str:
        """Write a resumable checkpoint.  ``val_loss=None`` (last.ckpt, the
        preemption save) is exempt from top-5 pruning.

        ``background`` (what the epoch loop asks) snapshots the weights and
        the optimiser state on the device and hands the host copy, the write
        and the top-5 pruning to the ordered writer thread, so checkpoints
        are pruned in the order they were submitted; without it (a direct
        call, the preemption save) the file is written before the call
        returns."""
        os.makedirs(self.ckpt_root, exist_ok=True)
        path = os.path.join(self.ckpt_root, filename or f"epoch={epoch}.ckpt")
        state = {
            "params": {k: nerf_param_tree(m) for k, m in self.models.items()},
            "opt_state": self.optimizer.state_tree(),
            "epoch": epoch,
        }
        snap = snapshot(state) if background else None

        def write():
            checkpoints.save_checkpoint(path, snap.fetch() if snap else state)
            if val_loss is None:
                return
            self._topk.append((val_loss, path))
            self._topk.sort(key=lambda t: t[0])
            while len(self._topk) > 5:
                _, worst = self._topk.pop()
                if os.path.exists(worst):
                    os.remove(worst)

        if background:
            self._writer.submit(write)
        else:
            write()
        return path

    # -- preemption ---------------------------------------------------------
    def _install_preemption_handler(self):
        """SIGTERM sets a flag; the loop saves at the next step boundary, so
        the saved state is never half an optimizer step."""
        self._prev_handler = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def _preempt_if_asked(self, epoch: int, complete: bool) -> None:
        if not self._preempted:
            return
        self._preempted = False
        # the writes already queued land first (in order); bounded, so a
        # write that cannot finish does not keep the state from being saved
        self._writer.drain(timeout=5.0)
        self.save_ckpt(epoch - (0 if complete else 1), None,
                       filename="preempt.ckpt")
        self.logger.close()
        prev = self._prev_handler
        signal.signal(signal.SIGTERM, prev if prev is not None
                      else signal.SIG_DFL)
        if callable(prev):
            prev(signal.SIGTERM, None)
        elif prev is not signal.SIG_IGN:
            signal.raise_signal(signal.SIGTERM)

    # -- main loop ----------------------------------------------------------
    def fit(self):
        cfg = self.cfg
        self._install_preemption_handler()
        try:
            if cfg.num_sanity_val_steps > 0:
                metrics = self.validation(self.epoch0,
                                          max_images=cfg.num_sanity_val_steps)
                print(f"[sanity] {metrics}", flush=True)
            global_step = self.epoch0 * self.steps_per_epoch
            for epoch in range(self.epoch0, cfg.num_epochs):
                self._epoch, self._step = epoch, 0
                t0 = time.time()
                with self._epoch_trace(epoch):
                    metrics = self.train_epoch(epoch, global_step)
                self._preempt_if_asked(epoch, complete=True)
                global_step += self.steps_per_epoch
                self._finish_epoch(epoch, global_step, metrics,
                                   time.time() - t0)
            self._writer.drain()  # every checkpoint on disk before returning
        finally:
            signal.signal(signal.SIGTERM, self._prev_handler
                          if self._prev_handler is not None else signal.SIG_DFL)
            self.logger.close()
        return self.models

    def _epoch_trace(self, epoch: int):
        """``--profile``: a ``torch.profiler`` trace of the first epoch."""
        if (self.cfg.profile and self.traces_first_epoch
                and epoch == self.epoch0):
            return profile_trace(os.path.join(self.logger.dir, "trace"),
                                 self.device)
        return contextlib.nullcontext()

    def train_epoch(self, epoch: int, global_step: int) -> Dict[str, np.ndarray]:
        """One epoch's steps over a fresh permutation; the per-step values
        by their ``metrics.jsonl`` keys."""
        B = self.cfg.batch_size
        perm = torch.randperm(self.rays.shape[0], generator=self.shuffle_gen)
        # one copy an epoch, queued behind the card's work; each step's
        # indices are then a slice on the device
        perm = host_to_device(perm, self.device)
        losses, psnrs = [], []
        for i in range(self.steps_per_epoch):
            self._preempt_if_asked(epoch, complete=False)
            idx = perm[i * B:(i + 1) * B]
            loss, psnr = self.train_step(self.rays[idx], self.rgbs[idx])
            losses.append(loss)
            psnrs.append(psnr)
        return {"train/loss": torch.stack(losses).float().cpu().numpy(),
                "train/psnr": torch.stack(psnrs).float().cpu().numpy()}

    def _epoch_note(self, epoch: int, means: Dict[str, float]) -> str:
        """Text the epoch line carries before its rate."""
        return ""

    def _save_epoch(self, epoch: int, val_loss: Optional[float]) -> None:
        """The end of an epoch's checkpoint: top 5 by val loss, else
        ``last.ckpt`` (resumability must not depend on the val cadence)."""
        if val_loss is None:
            self.save_ckpt(epoch, None, filename="last.ckpt", background=True)
        else:
            self.save_ckpt(epoch, val_loss, background=True)

    def _finish_epoch(self, epoch, global_step, metrics, dt):
        cfg = self.cfg
        rays_per_s = self.steps_per_epoch * self.rays_per_step / max(dt, 1e-9)
        means = {k: float(v.mean()) for k, v in metrics.items()}
        self.logger.scalars(global_step, {
            "lr": self.schedule(global_step), **means,
            "train/rays_per_s": rays_per_s,
        })
        msg = (f"epoch {epoch}: {self.loss_label} {means['train/loss']:.5f} "
               f"psnr {means['train/psnr']:.2f} ({self._epoch_note(epoch, means)}"
               f"{rays_per_s:,.0f} rays/s, {dt:.1f}s)")
        do_val = ((epoch + 1) % cfg.val_every_n_epochs == 0
                  or epoch == cfg.num_epochs - 1)
        if do_val:
            val_metrics = self.validation(epoch)
            self._preempt_if_asked(epoch, complete=True)
            self.logger.scalars(global_step, val_metrics)
            msg += (f" | val loss {val_metrics['val/loss']:.5f} "
                    f"psnr {val_metrics['val/psnr']:.2f}")
            self._save_epoch(epoch, val_metrics["val/loss"])
        else:
            self._save_epoch(epoch, None)
        print(msg, flush=True)
