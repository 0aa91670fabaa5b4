"""The vanilla-NeRF training system (``nerf_pl_tpu/training/trainer.py``;
reference ``train.py`` NeRFSystem), on one device or one rank per device.

  * The ray and colour buffers are moved to the device once; each epoch
    draws a permutation from a ``torch.Generator`` seeded by ``cfg.seed``
    and takes ``n // batch_size`` steps of render -> loss -> backward ->
    Adam.  The renderer's random draws come from a second generator on the
    device, seeded from ``cfg.seed`` too.
  * Data parallelism (``parallel/mesh.py``): over a process group each rank
    holds its contiguous block of the rays (``shard_rays``; with
    ``--per_host_data`` it loads only its frames), shuffles and trains its
    own ``batch_size`` rows a step, and the grads are averaged by one
    all-reduce after the backward, before ``--grad_clip`` and the update
    (JAX's ``pmean``).  Rank 0 draws what a single process draws; the other
    ranks draw from seeds of their own.  The epoch's losses and PSNRs are
    averaged over the ranks once an epoch.  ``--global_reshuffle``
    re-shards a fresh global permutation every epoch, the JAX trainer's.
    Validation renders each image over every rank (``tools.render``).
  * ``--data_device_resident false`` streams the rays from the native ray
    store (``data/native.py``): slabs of ``--stream_slab_steps`` global
    batches, one pinned copy to the device a slab, laid out over the ranks
    as JAX's ``P('rays')`` lays them; a worker thread fills the next slab
    while the card trains on the current one.
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
honour raise ``ValueError`` (ROADMAP.md).  In a process group only rank 0
writes logs and checkpoints, and every rank runs every collective.
"""
from __future__ import annotations

import contextlib
import os
import signal
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..data import dataset_dict
from ..models.nerf import init_nerf, nerf_param_tree
from ..ops.rendering import render_rays
from ..parallel import mesh as pmesh
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

# the --compute_dtype names every trainer takes (JAX's jnp.dtype(name) takes
# any; the fused kernels are built for these three)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# host streaming: optimizer steps a slab when --stream_slab_steps is 0
STREAM_SLAB_STEPS = 16
# steps between the all-reduce that carries a rank's SIGTERM flag and the
# step boundary at which every rank reads it (no host wait on a card)
PREEMPT_LAG = 2


def common_unsupported(cfg: Config) -> Dict[str, bool]:
    """The flags no trainer of the port honours, each with whether ``cfg``
    sets it: a ``--compute_dtype`` outside float32, bfloat16 and float16."""
    return {
        f"--compute_dtype {cfg.compute_dtype}": cfg.compute_dtype not in _DTYPES,
    }


def raise_unsupported(flags: Dict[str, bool]) -> None:
    bad = [k for k, v in flags.items() if v]
    if bad:
        raise ValueError(f"not supported: {', '.join(bad)} (see ROADMAP.md)")


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
        device = resolve_device(device)
        if cfg.multihost or pmesh.launched_by_torchrun():
            # one process per device; the group spans them all (the
            # reference's Lightning DDP, train.py:174)
            pmesh.initialize_distributed(device)
        self.mesh = pmesh.make_mesh(device, cfg.num_devices)
        self.device = self.mesh.device
        if self.device.type == "cuda":
            if self.device.index is not None:  # a rank's own card
                torch.cuda.set_device(self.device)
        elif self.mesh.size > 1 and "OMP_NUM_THREADS" not in os.environ:
            # ranks sharing the host's cores: spinning thread pools of the
            # full width each would oversubscribe them many times over
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // self.mesh.size))
        self.loss_name = cfg.loss_type
        self.logger = RunLogger(cfg.log_dir, cfg.exp_name,
                                primary=self.mesh.primary)
        self._writer = AsyncWriter()
        rank = self.mesh.rank
        self.shuffle_gen = torch.Generator().manual_seed(
            pmesh.rank_seed(cfg.seed, 0, rank))
        self.render_gen = torch.Generator(device=self.device).manual_seed(
            pmesh.rank_seed(cfg.seed, 1, rank))
        self.ray_store = None  # set by _prepare_data when streaming
        self.slab_copies = 0  # host-to-device copies of streamed slabs
        self._prepare_data()
        self.rkw = render_kwargs_from_cfg(cfg, self.white_back, train=True)
        self._build_state()
        self.ckpt_root = os.path.join(cfg.ckpt_dir, cfg.exp_name)
        self._topk: list = []  # (val_loss, path)
        self._preempted = False
        self._epoch, self._step = self.epoch0, 0  # where the fit is

    # -- data ---------------------------------------------------------------
    @property
    def per_host(self) -> bool:
        """Each rank loads only its own frames (``--per_host_data``)."""
        return self.cfg.per_host_data and self.mesh.size > 1

    def _prepare_data(self):
        cfg = self.cfg
        ds_cls = dataset_dict[cfg.dataset_name]
        kwargs = dict(root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh))
        if cfg.dataset_name == "llff":
            # val_num = the rank count, as the JAX trainer passes its chip
            # count (reference train.py:79 passes val_num=num_gpus)
            kwargs.update(spheric_poses=cfg.spheric_poses,
                          val_num=self.mesh.size)
        else:
            kwargs.update(near=cfg.blender_near, far=cfg.blender_far,
                          white_back=cfg.white_back,
                          black_and_white=cfg.black_and_white_test)
        train_kwargs = kwargs
        if self.per_host:
            if not cfg.data_device_resident:
                raise ValueError(
                    "--per_host_data requires device-resident buffers "
                    "(host-streaming is per-process already)")
            train_kwargs = dict(kwargs, frame_shard=(self.mesh.rank,
                                                     self.mesh.size))
        self.train_dataset = ds_cls(split="train", **train_kwargs)
        self.val_dataset = ds_cls(split="val", **kwargs)
        self.white_back = self.train_dataset.white_back
        ds = self.train_dataset
        if cfg.data_device_resident:
            self._set_train_buffers(ds.all_rays, ds.all_rgbs)
        else:
            from ..data.native import RayStore

            self.ray_store = RayStore([ds.all_rays, ds.all_rgbs], seed=cfg.seed)

    def _set_train_buffers(self, rays: np.ndarray, rgbs: np.ndarray) -> None:
        """This rank's rows of the training rays and colours on the device;
        the host buffers are kept only for ``--global_reshuffle`` (a
        per-image loader's are a fresh concatenation)."""
        if self.cfg.global_reshuffle:
            self._host_rays, self._host_rgbs = rays, rgbs
        self.rays, self.rgbs = (
            torch.from_numpy(np.ascontiguousarray(
                pmesh.shard_rays(a, self.mesh, local=self.per_host))
            ).to(self.device) for a in (rays, rgbs))

    def _reshuffle_buffers(self, epoch: int) -> None:
        """``--global_reshuffle``: re-shard a fresh global permutation of the
        rays (DistributedSampler semantics), drawn from ``(seed, epoch)`` so
        every rank draws the same one (the JAX trainer's
        ``_reshuffle_buffers``).  Under ``--per_host_data`` each rank
        permutes its own frames."""
        rng = np.random.RandomState(
            (self.cfg.seed * 1_000_003 + epoch + 1) % (2**32))
        rays, rgbs = self._host_rays, self._host_rgbs
        perm = rng.permutation(rays.shape[0])
        self._set_train_buffers(rays[perm], rgbs[perm])
        self._host_rays, self._host_rgbs = rays, rgbs

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
        if self.ray_store is not None:
            slab = int(cfg.stream_slab_steps or 0)
            if slab < 0:
                # a negative slab would make every streaming epoch a silent
                # zero-step no-op
                raise ValueError(
                    f"--stream_slab_steps must be positive (got {slab})")
            self.stream_slab_steps = slab or STREAM_SLAB_STEPS
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
        # every rank starts from rank 0's state, and averages its grads
        # with the others' every step (one all-reduce; its last slot
        # carries the SIGTERM flag)
        pmesh.replicate(list(self.optimizer.params.values())
                        + self.optimizer.state_tensors(), self.mesh)
        self._reducer = (pmesh.GradAllReduce(self.optimizer.params,
                                             self.mesh, n_extra=1)
                         if self.mesh.distributed else None)
        self._flags: deque = deque()  # (host flag, event) a reduced step

    def _count_steps(self) -> int:
        d = self.mesh.size
        n = (self.ray_store.n_rows if self.ray_store is not None
             else self.rays.shape[0] * d)
        steps = (n // d) // self.cfg.batch_size
        if steps < 1:
            raise ValueError(
                f"batch_size {self.cfg.batch_size} exceeds the {n // d} rays "
                f"per device ({n} rays over {d} devices) — the epoch would "
                "run zero steps; reduce --batch_size or --num_devices")
        return steps

    @property
    def rays_per_step(self) -> int:
        """Camera rays trained a step over every rank (``train/rays_per_s``
        counts these)."""
        return self.cfg.batch_size * self.mesh.size

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
        """backward, the grads' mean over the ranks, then one optimizer
        step; under ``--debug_nans`` the step first checks its loss,
        parameters and grads (one synchronising call)."""
        if self._reducer is not None:
            self._reducer.zero_grad()
        else:
            self.optimizer.zero_grad()
        loss.backward()
        if self._reducer is not None:
            summed = self._reducer([1.0 if self._preempted else 0.0])
            if self.mesh.size > 1:
                self._queue_flag(summed)
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
                                   chunk=cfg.chunk, mesh=self.mesh,
                                   mode=self.mode, **self.rkw)
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
        if not self.logger.primary:
            return
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
        returns.  Only rank 0 writes."""
        path = os.path.join(self.ckpt_root, filename or f"epoch={epoch}.ckpt")
        if not self.mesh.primary:
            return path
        os.makedirs(self.ckpt_root, exist_ok=True)
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

    def _queue_flag(self, summed: torch.Tensor) -> None:
        """Keep this step's all-reduced SIGTERM flag: copied to the host
        behind the step's work, read ``PREEMPT_LAG`` steps later."""
        if summed.device.type == "cuda":
            host = torch.empty(1, pin_memory=True)
            host.copy_(summed[:1], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = summed[:1].clone(), None
        self._flags.append((host, event))

    def _group_preempted(self, boundary: bool) -> bool:
        """Whether the run stops here.  The ranks must stop at the same
        step, or the first to stop leaves the others blocked in an
        all-reduce: at a step boundary every rank reads the flags summed by
        the all-reduce ``PREEMPT_LAG`` steps back; at the end of an epoch
        (``boundary`` False) every rank reads them all and all-reduces its
        flag once more."""
        if self.mesh.size == 1:
            return self._preempted
        stop = False
        while len(self._flags) >= (PREEMPT_LAG if boundary else 1):
            host, event = self._flags.popleft()
            if event is not None:
                event.synchronize()
            stop |= float(host[0]) > 0
        if not boundary:
            stop |= pmesh.allreduce_int(int(self._preempted), self.mesh,
                                         pmesh.dist.ReduceOp.MAX) > 0
        return stop

    def _preempt_if_asked(self, epoch: int, complete: bool) -> None:
        if not self._group_preempted(boundary=not complete):
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
                self._print(f"[sanity] {metrics}")
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

    def _print(self, msg: str) -> None:
        if self.mesh.primary:
            print(msg, flush=True)

    def epoch_values(self, values: Dict[str, list]) -> Dict[str, np.ndarray]:
        """Each key's per-step values, averaged over the ranks (one
        all-reduce an epoch: the mean of JAX's per-step ``pmean``)."""
        keys = list(values)
        stacked = torch.stack([torch.stack(values[k]).float() for k in keys])
        if self.mesh.size > 1:
            pmesh.dist.all_reduce(stacked)
            stacked = stacked / self.mesh.size
        host = stacked.cpu().numpy()
        return {k: host[i] for i, k in enumerate(keys)}

    def train_epoch(self, epoch: int, global_step: int) -> Dict[str, np.ndarray]:
        """One epoch's steps over a fresh permutation of this rank's rows;
        the per-step values by their ``metrics.jsonl`` keys."""
        if self.ray_store is not None:
            # the store draws a fresh global permutation every epoch:
            # --global_reshuffle is inherent there
            return self._train_epoch_streaming(epoch)
        if self.cfg.global_reshuffle:
            self._reshuffle_buffers(epoch)
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
        return self.epoch_values({"train/loss": losses, "train/psnr": psnrs})

    def _slab_span(self, k: int) -> tuple:
        """The global batches ``[j0, j1)`` of a slab of ``k`` that hold this
        rank's rows, and those rows' offsets ``[lo, hi)`` in them: JAX's
        ``P('rays')`` splits the slab's ``k B d`` rows into d contiguous
        blocks of ``k B`` and rank r takes block r (so with d > 1 a rank's
        steps come from whole global batches)."""
        B, d, r = self.cfg.batch_size, self.mesh.size, self.mesh.rank
        gb = B * d
        lo, hi = r * k * B, (r + 1) * k * B
        j0, j1 = lo // gb, -(-hi // gb)
        return j0, j1, lo - j0 * gb, hi - j0 * gb

    def _fill_slab(self, epoch: int, step: int, k: int,
                   buf: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the slab of ``k`` global batches from
        ``step`` (the store's ``fill_batch(epoch, step + j, B d)``), written
        into the host buffer ``buf``; returns them as a view of it."""
        gb = self.cfg.batch_size * self.mesh.size
        j0, j1, lo, hi = self._slab_span(k)
        out = buf.numpy()
        for j in range(j0, j1):
            rows = self.ray_store.fill_batch(
                epoch, step + j, gb, out=out[(j - j0) * gb:(j - j0 + 1) * gb])
            if len(rows) < gb:  # steps_per_epoch * B * d <= the store's rows
                raise RuntimeError(f"ray store: batch {step + j} of epoch "
                                   f"{epoch} is short ({len(rows)} < {gb})")
        return buf[lo:hi]

    def _train_epoch_streaming(self, epoch: int) -> Dict[str, np.ndarray]:
        """Host streaming (the JAX trainer's ``_run_streaming_epoch``): each
        slab of up to ``stream_slab_steps`` steps reaches the device in one
        non-blocking copy from pinned memory; every row of the store's epoch
        permutation is trained once.  Two host buffers take turns: a worker
        thread fills the next slab (the store's fill releases the GIL) while
        the card trains on this one, as JAX's async dispatch overlapped them;
        a buffer is refilled only after its copy to the device has ended."""
        B, K = self.cfg.batch_size, self.stream_slab_steps
        n_rays = self.ray_store.widths[0]
        on_card = self.device.type == "cuda"
        j0, j1, _, _ = self._slab_span(K)
        rows = (j1 - j0 + 1) * B * self.mesh.size  # any k <= K fits
        bufs = [torch.empty((rows, self.ray_store.row_width),
                            dtype=torch.float32, pin_memory=on_card)
                for _ in range(2)]
        copied = [None, None]  # the event after each buffer's last copy
        starts = list(range(0, self.steps_per_epoch, K))

        def fill(i: int) -> torch.Tensor:
            if copied[i % 2] is not None:
                copied[i % 2].synchronize()
            k = min(K, self.steps_per_epoch - starts[i])
            return self._fill_slab(epoch, starts[i], k, bufs[i % 2])

        losses, psnrs = [], []
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(fill, 0)
            for i, step in enumerate(starts):
                slab = pending.result().to(self.device, non_blocking=True)
                self.slab_copies += 1
                if on_card:
                    copied[i % 2] = torch.cuda.Event()
                    copied[i % 2].record()
                if i + 1 < len(starts):
                    pending = pool.submit(fill, i + 1)
                rays = slab[:, :n_rays].contiguous()
                rgbs = slab[:, n_rays:].contiguous()
                for j in range(slab.shape[0] // B):
                    self._preempt_if_asked(epoch, complete=False)
                    loss, psnr = self.train_step(rays[j * B:(j + 1) * B],
                                                 rgbs[j * B:(j + 1) * B])
                    losses.append(loss)
                    psnrs.append(psnr)
        return self.epoch_values({"train/loss": losses, "train/psnr": psnrs})

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
        self._print(msg)
