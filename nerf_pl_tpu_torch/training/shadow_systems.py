"""The flagship shadow trainer, ``EfficientSMSystem``
(``nerf_pl_tpu/training/shadow_systems.py``; reference
``train_efficient_sm.py``), on one device.

A step: a sigma-only coarse + fine render of the camera batch, the whole
light view's depth (re-rendered with gradients every step under
``--grad_on_light``, else a no-grad cache), ``efficient_sm`` compositing of
the shadow maps, MSE against the targets, backward, Adam.  The reference
computes an opacity loss but optimises the shadow maps only; the port logs
it, as the JAX package does.

Kept from the JAX package:
  * ``--grad_on_light`` sets ``sample_light_depth_every = 1``; otherwise the
    cache is zeroed at each epoch start and re-rendered (no grad) at the
    steps where ``global_step % sample_light_depth_every == 0`` and at an
    epoch's first step;
  * ``Light_N_importance = -1`` draws the light's importance samples per
    epoch from ``np.random.RandomState(seed + epoch)`` over {0, 8, 16, 32};
  * batches are contiguous slices of the buffers in dataset order (the
    reference's ``shuffle=False``);
  * the logged opacity loss scores the first ``min(batch, H*W)`` light
    opacities, and its fine term only when the light has a fine pass;
  * validation renders the light view once for all frames, with the
    train-time perturb and noise.

``--max_steps_per_dispatch`` bounded the length of one compiled TPU program;
the port launches each step on its own, so the flag is accepted and the
trajectory is the same with any value.  A SIGTERM saves at the next step
boundary, labelled e-1 in the middle of epoch e (the base trainer's
handler).  The other shadow trainers, their loaders and ``--per_host_data``
are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data import dataset_dict
from ..data.png import write_png
from ..ops.rendering import render_rays
from ..ops.shadow_mapping import efficient_sm, normalize_min_max
from ..tools.render import render_image
from ..utils.visualization import visualize_depth
from .losses import mse_loss, opacity_loss
from .metrics import psnr as psnr_metric
from .trainer import _DTYPES, NeRFSystem, common_unsupported, raise_unsupported

LIGHT_N_CHOICES = (0, 8, 16, 32)


def sigma_render_kwargs(cfg: Config, n_importance: int, train: bool = True) -> dict:
    """``render_rays`` keywords of a sigma-only render with ``n_importance``
    fine samples; ``--remat_fine`` holds for training renders only."""
    return dict(
        N_samples=cfg.N_samples,
        use_disp=cfg.use_disp,
        perturb=cfg.perturb,
        noise_std=cfg.noise_std,
        N_importance=n_importance,
        mode="sigma",
        compute_dtype=_DTYPES[cfg.compute_dtype],
        use_fused=bool(cfg.use_fused_mlp),
        fused_channel_io=cfg.fused_channel_io,
        remat_fine=cfg.remat_fine if train else False,
    )


def light_cache_render(models, light_rays, generator, rkw, overrides=None):
    """The whole light view's sigma render as the cache: depth and opacity,
    the fine slots holding the coarse values when there is no fine pass."""
    r = render_rays(models["coarse"], models.get("fine"), light_rays,
                    generator, overrides=overrides, **rkw)
    return {
        "depth_coarse": r["depth_coarse"],
        "depth_fine": r.get("depth_fine", r["depth_coarse"]),
        "opacity_coarse": r["opacity_coarse"],
        "opacity_fine": r.get("opacity_fine", r["opacity_coarse"]),
    }


def dump_val_images(logger, cfg, step: int, epoch: int, out, rgbs, typ: str):
    """The epoch's gt/rgb/depth/disp PNGs under ``<run>/imgs`` and the
    TensorBoard grid (reference ``train_efficient_sm.py:241-263``)."""
    W, H = cfg.img_wh
    d = os.path.join(logger.dir, "imgs")
    os.makedirs(d, exist_ok=True)

    def to8b(x):  # disp can be NaN on empty rays
        return (255 * np.clip(np.nan_to_num(np.asarray(x)), 0, 1)).astype(np.uint8)

    host = {k: v.detach().float().cpu() for k, v in out.items()}
    gt = rgbs.detach().float().cpu().numpy().reshape(H, W, 3)
    rgb = host[f"rgb_{typ}"].numpy().reshape(H, W, 3)
    write_png(os.path.join(d, f"gt_{epoch:03d}.png"), to8b(gt))
    write_png(os.path.join(d, f"rgb_{epoch:03d}.png"), to8b(rgb))
    depth = visualize_depth(host[f"depth_{typ}"].numpy().reshape(H, W))
    write_png(os.path.join(d, f"depth_{epoch:03d}.png"),
              to8b(depth.transpose(1, 2, 0)))
    if f"disp_map_{typ}" in host:
        disp = normalize_min_max(host[f"disp_map_{typ}"]).numpy().reshape(H, W)
        write_png(os.path.join(d, f"disp_{epoch:03d}.png"), to8b(disp))
    logger.images(step, "val/GT_pred_depth", np.stack(
        [gt.transpose(2, 0, 1), rgb.transpose(2, 0, 1), depth]))


class EfficientSMSystem(NeRFSystem):
    """Flagship shadow trainer (reference ``train_efficient_sm.py``)."""

    datasets = ("efficient_sm",)
    loss_label = "sm_loss"

    @classmethod
    def check_supported(cls, cfg: Config) -> None:
        """The common flags and the dataset; ``--loss_type`` is not read (the
        shadow loss is fixed, as in the JAX package)."""
        if cfg.global_reshuffle:
            raise ValueError(
                "--global_reshuffle is not supported by EfficientSMSystem: "
                "the reference trains this pipeline with shuffle=False "
                "(contiguous pose segments are a parity property)")
        raise_unsupported({
            **common_unsupported(cfg),
            f"--dataset_name {cfg.dataset_name}":
                cfg.dataset_name not in cls.datasets,
        })

    def __init__(self, cfg: Config, device=None):
        if cfg.grad_on_light:
            cfg.sample_light_depth_every = 1
        super().__init__(cfg, device)
        self.rkw = sigma_render_kwargs(cfg, cfg.N_importance)
        self._light_n = None

    # -- data ---------------------------------------------------------------
    def _prepare_data(self):
        cfg = self.cfg
        ds_cls = dataset_dict[cfg.dataset_name]
        kw = dict(root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh),
                  white_pix=cfg.white_pix, blur=cfg.blur)
        self.train_dataset = ds_cls(split="train", **kw)
        self.val_dataset = ds_cls(split="val", **kw)
        self.white_back = self.train_dataset.white_back
        ds, dev = self.train_dataset, self.device

        def put(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.rays, self.rgbs = put(ds.all_rays), put(ds.all_rgbs)
        self.pixels = put(ds.all_pixels)
        self.pose_idx = put(ds.pose_idx, torch.int64)
        self.cam_ms, self.cam_eyes = put(ds.cam_ms), put(ds.cam_eyes)
        self.num_poses = int(ds.cam_ms.shape[0])
        self.light_rays = put(ds.light.rays)
        self.light_pixels = put(ds.light.pixels)
        self.light_m = put(ds.light.camera)
        self.light_eye = put(ds.light.eye_pos)

    # -- the light ------------------------------------------------------------
    def resolve_light_n(self, epoch: int) -> int:
        cfg = self.cfg
        if cfg.Light_N_importance == -1:
            rng = np.random.RandomState(cfg.seed + epoch)
            return int(rng.choice(list(LIGHT_N_CHOICES)))
        return cfg.Light_N_importance

    def light_render(self, light_n: int, overrides=None):
        return light_cache_render(
            self.models, self.light_rays, self.render_gen,
            sigma_render_kwargs(self.cfg, light_n), overrides)

    def empty_light_cache(self) -> Dict[str, torch.Tensor]:
        hw = self.light_rays.shape[0]
        return {k: torch.zeros(hw, device=self.device) for k in
                ("depth_coarse", "depth_fine", "opacity_coarse", "opacity_fine")}

    # -- one step -------------------------------------------------------------
    def train_step(self, rays, rgbs, pixels, pose_idx, light_cache,
                   light_n: int, overrides: Optional[dict] = None):
        """render -> efficient_sm -> MSE -> backward -> Adam on one batch.
        With ``grad_on_light`` the light view is rendered here, with
        gradients; else ``light_cache`` is used as it is.  ``overrides``:
        ``{"cam": {...}, "light": {...}}``, each the ``render_rays``
        overrides of that render.  Returns (loss, psnr, opacity loss)."""
        cfg = self.cfg
        ov = overrides or {}
        cam_res = render_rays(self.models["coarse"], self.models.get("fine"),
                              rays, self.render_gen, overrides=ov.get("cam"),
                              **self.rkw)
        if cfg.grad_on_light:
            light_cache = self.light_render(light_n, ov.get("light"))
        fine = cfg.N_importance > 0
        out = efficient_sm(
            pixels, self.light_pixels, cam_res, light_cache,
            self.cam_ms[pose_idx], self.cam_eyes[pose_idx], self.light_m,
            self.light_eye, tuple(cfg.img_wh), fine_sampling=fine,
            light_has_fine=light_n > 0, shadow_method=cfg.shadow_method,
            pose_idx=pose_idx, num_poses=self.num_poses)
        loss = mse_loss(out, rgbs)
        with torch.no_grad():
            psnr = psnr_metric(out[f"rgb_{'fine' if fine else 'coarse'}"], rgbs)
            # logged only; batch > H*W would index past the light view
            b = min(rgbs.shape[0], light_cache["opacity_coarse"].shape[0])
            op_in = {"opacity_coarse": light_cache["opacity_coarse"][:b]}
            if light_n > 0:
                op_in["opacity_fine"] = light_cache["opacity_fine"][:b]
            op_loss = opacity_loss(op_in, rgbs[:b])
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return loss.detach(), psnr, op_loss

    def train_epoch(self, epoch: int, global_step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B = cfg.batch_size
        k = max(1, cfg.sample_light_depth_every)
        light_n = self._light_n = self.resolve_light_n(epoch)
        cache = self.empty_light_cache()
        losses, psnrs, op_losses = [], [], []
        for ei in range(self.steps_per_epoch):
            self._preempt_if_asked(epoch, complete=False)
            if not cfg.grad_on_light and ((global_step + ei) % k == 0 or ei == 0):
                with torch.no_grad():
                    cache = self.light_render(light_n)
            sl = slice(ei * B, (ei + 1) * B)
            loss, psnr, op = self.train_step(
                self.rays[sl], self.rgbs[sl], self.pixels[sl],
                self.pose_idx[sl], cache, light_n)
            losses.append(loss)
            psnrs.append(psnr)
            op_losses.append(op)
        stack = lambda xs: torch.stack(xs).float().cpu().numpy()  # noqa: E731
        return {"train/loss": stack(losses), "train/psnr": stack(psnrs),
                "train/train_opactiy": stack(op_losses)}

    def _epoch_note(self, epoch: int) -> str:
        return f"Light_N={self._light_n}, "

    # -- validation -----------------------------------------------------------
    def validation(self, epoch: int,
                   max_images: Optional[int] = None) -> Dict[str, float]:
        """Every val frame rendered whole, the light view once, composited
        per frame."""
        cfg = self.cfg
        rkw = sigma_render_kwargs(cfg, cfg.N_importance, train=False)
        fine = cfg.N_importance > 0
        n_img = len(self.val_dataset)
        if max_images is not None:
            n_img = min(n_img, max_images)
        dev = self.device
        losses, psnrs, light_depths = [], [], None
        for i in range(n_img):
            sample = self.val_dataset[i]
            t = {k: torch.from_numpy(np.asarray(sample[k])).to(dev)
                 for k in ("rays", "pixels", "rgbs", "light_rays",
                           "light_pixels")}
            cam_res = render_image(self.models, t["rays"], self.render_gen,
                                   chunk=cfg.chunk, **rkw)
            if light_depths is None:
                light_res = render_image(self.models, t["light_rays"],
                                         self.render_gen, chunk=cfg.chunk, **rkw)
                light_depths = {
                    "depth_coarse": light_res["depth_coarse"],
                    "depth_fine": light_res.get("depth_fine",
                                                light_res["depth_coarse"])}
            with torch.no_grad():
                out = efficient_sm(
                    t["pixels"], t["light_pixels"], cam_res, light_depths,
                    torch.from_numpy(sample["ppc"]["camera"]).to(dev),
                    torch.from_numpy(sample["ppc"]["eye_pos"]).to(dev),
                    torch.from_numpy(sample["light_ppc"]["camera"]).to(dev),
                    torch.from_numpy(sample["light_ppc"]["eye_pos"]).to(dev),
                    tuple(cfg.img_wh), fine_sampling=fine, light_has_fine=fine,
                    shadow_method=cfg.shadow_method)
                typ = "fine" if fine else "coarse"
                losses.append(float(mse_loss(out, t["rgbs"])))
                psnrs.append(float(psnr_metric(out[f"rgb_{typ}"], t["rgbs"])))
            if i == 0:
                dump_val_images(self.logger, cfg, epoch * self.steps_per_epoch,
                                epoch, out, t["rgbs"], typ)
        return {"val/loss": float(np.mean(losses)),
                "val/psnr": float(np.mean(psnrs))}
