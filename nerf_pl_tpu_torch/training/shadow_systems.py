"""The shadow-mapping trainers (``nerf_pl_tpu/training/shadow_systems.py``),
on one device or one rank per device.  Each mirrors a reference
``train_*.py``:

  * ``EfficientSMSystem`` (``train_efficient_sm.py``): a sigma-only coarse +
    fine render of the camera batch, the whole light view's depth
    (re-rendered with gradients every step under ``--grad_on_light``, else a
    no-grad cache), ``efficient_sm`` compositing of the shadow maps, MSE
    against the targets, backward, Adam.  The reference computes an opacity
    loss but optimises the shadow maps only; the port logs it, as the JAX
    package does.
  * ``RGBSMSystem`` (``train_rgb_sm_juntos.py``): the same step with the
    camera rendered in ``rgb_disp`` mode and the shadow maps written to
    ``sm_*``; loss ``rgb_weight * mse(rgb) + sm_weight * mse(sm)``.
  * ``LightSamplerSystem`` (``train_light_sampler.py``): each camera ray is
    projected into the light view and only those light pixels are rendered
    (their rays detached, the render differentiated).
  * ``ShadowMappingSystem`` (``train_shadow_mapping.py``): whole images of
    the camera and of the light view each step, composited per image.
  * ``ShadowsSystem`` (``train_shadows.py``): the vanilla RGB step on the
    shadow loaders' rays.

Kept from the JAX package:
  * ``--grad_on_light`` sets ``sample_light_depth_every = 1``; otherwise the
    cache is zeroed at each epoch start and re-rendered (no grad) at the
    steps where ``global_step % sample_light_depth_every == 0`` and at an
    epoch's first step;
  * ``Light_N_importance = -1`` draws the light's importance samples per
    epoch from ``np.random.RandomState(seed + epoch)`` over {0, 8, 16, 32};
  * the per-ray systems take contiguous slices of the buffers in dataset
    order (the reference's ``shuffle=False``); the image-space system steps
    images ``(s * B + k) % n``;
  * the logged opacity loss scores the first ``min(batch, H*W)`` light
    opacities, and its fine term only when the light has a fine pass;
  * validation renders the light view once for all frames, with the
    train-time perturb and noise (``RGBSMSystem`` with ``N_importance``
    fine samples, not ``Light_N_importance``); ``LightSamplerSystem``
    scores ``rgb_coarse`` only and projects from the fine depths when there
    are some;
  * ``ShadowMappingSystem`` writes ``epoch=N.ckpt`` every epoch, never
    pruned;
  * ``--debug_nans`` stops every system at its first non-finite step;
    ``--profile`` traces the first epoch of ``ShadowsSystem`` only (the
    vanilla trainer's fit; the other JAX systems do not read it).

``--max_steps_per_dispatch`` bounded the length of one compiled TPU program;
the port launches each step on its own, so the flag is accepted and the
trajectory is the same with any value.  A SIGTERM saves at the next step
boundary, labelled e-1 in the middle of epoch e (the base trainer's
handler).

Over a process group (``parallel/mesh.py``), as the JAX systems under their
mesh: each rank steps through its contiguous block of the per-ray buffers
and the grads are averaged after the backward; the whole light view is
rendered a slice a rank and gathered (``all_gather_tiled``, whose backward
carries ``--grad_on_light``'s gradients) when the rank count divides
``H*W``, else rendered whole on every rank; ``ShadowMappingSystem`` renders
a slice of each step's camera and light rays a rank and composites the
gathered depths on every rank; validation renders each image over every
rank.  ``--per_host_data`` loads each rank's frames (``efficient_sm`` and
``rgb_sm``; the rows are wrap-padded to the ranks' largest count) and is
rejected by the two whole-image systems, as in JAX.  ``--global_reshuffle``
is rejected but by ``ShadowsSystem``, and ``--data_device_resident false``
by all five (the JAX systems have no streaming path).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data import dataset_dict
from ..data.png import write_png
from ..data.sharding import equalize_rows
from ..parallel import mesh as pmesh
from ..ops.rendering import render_rays
from ..ops.shadow_mapping import (efficient_sm, generate_shadow_map,
                                  get_normed_w, get_projections,
                                  normalize_min_max, shadow_mapping_images)
from ..tools.render import render_image
from ..utils.io_async import snapshot
from ..utils.visualization import visualize_depth
from .losses import mse_loss, opacity_loss, sm_loss
from .metrics import psnr as psnr_metric
from .optim import host_to_device
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


def light_rays_from_uv(ul, vl, wh, l2w, light_focal, light_near, light_far):
    """(N, 8) light rays through the integer light pixels ``(ul, vl)``
    (reference ``train_light_sampler.py:168-181``).  ``light_focal`` is a
    0-dim tensor on the rays' device, so the divide is one in float32 there
    (a host scalar would be turned into a multiply by its inverse on a card)."""
    w, h = wh
    dirs = torch.stack([(ul - w / 2) / light_focal,
                        -(vl - h / 2) / light_focal,
                        -torch.ones_like(ul)], dim=-1)
    rays_d = dirs @ l2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = l2w[:, 3].expand_as(rays_d)
    nf = torch.ones_like(rays_o[:, :1])
    return torch.cat([rays_o, rays_d, light_near * nf, light_far * nf], dim=-1)


def ls_project(cam_res, pixels, cam_m, cam_eye, light_m, light_eye, l2w,
               light_focal, light_near, light_far, wh, fine):
    """Project camera pixels at their rendered depth (fine when ``fine``)
    into the light view; the light pixels ``(ul, vl)`` are the projections
    clamped to the view and floored.  Returns ``K (N, 3)``, ``ul``, ``vl``
    and the light rays through those pixels (no gradient through them)."""
    w, h = wh
    depth = cam_res["depth_fine"] if fine else cam_res["depth_coarse"]
    K = get_projections(cam_m, cam_eye, light_m, light_eye,
                        torch.cat([pixels, depth[:, None]], dim=1))
    with torch.no_grad():
        ul = torch.floor(torch.clamp(K[:, 0], 0.0, w - 1.0))
        vl = torch.floor(torch.clamp(K[:, 1], 0.0, h - 1.0))
        lrays = light_rays_from_uv(ul, vl, wh, l2w, light_focal, light_near,
                                   light_far)
    return K, ul, vl, lrays


def ls_composite(K, ul, vl, light_depth, light_m, mode):
    """The sampled light's shadow map: each camera pixel's light-space depth
    against the rendered depth of its light pixel (reference
    ``train_light_sampler.py:255-280``), min-max over the whole batch under
    ``shadow_method_2``."""
    lpix = torch.stack([ul + 0.5, vl + 0.5, torch.ones_like(ul)], dim=1)
    w_light = get_normed_w(light_m, torch.cat([lpix, light_depth[:, None]], dim=1))
    return generate_shadow_map(K[:, 2], w_light[:, 3], mode=mode)


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


def submit_val_images(system, epoch: int, out, rgbs, typ: str) -> None:
    """``dump_val_images`` on the system's writer thread, from a snapshot
    of the render (the JAX systems' ``_dump_val_images``); ``fit`` drains
    the writer before it returns.  Rank 0 only."""
    if not system.logger.primary:
        return
    snap = snapshot((out, rgbs))
    step = epoch * system.steps_per_epoch

    def dump():
        host_out, host_rgbs = snap.fetch()
        dump_val_images(system.logger, system.cfg, step, epoch, host_out,
                        host_rgbs, typ)

    system._writer.submit(dump)


def _reject_per_host_data(cfg: Config, trainer_name: str) -> None:
    """The whole-image systems load their dataset whole on every host in the
    JAX package too: the flag would be ignored there, so it raises."""
    if cfg.per_host_data:
        raise ValueError(
            f"--per_host_data is not supported by {trainer_name}; its "
            "whole-image dataset loads fully on every host")


def _reject_global_reshuffle(cfg: Config, trainer_name: str) -> None:
    """The reference trains the shadow pipelines with ``shuffle=False``:
    the contiguous batch order is a parity property."""
    if cfg.global_reshuffle:
        raise ValueError(
            f"--global_reshuffle is not supported by {trainer_name}: the "
            "reference trains this pipeline with shuffle=False (contiguous "
            "pose segments are a parity property)")


def _reject_streaming(cfg: Config, trainer_name: str) -> None:
    """The JAX shadow systems have no host-streaming path (they keep their
    buffers on the device whatever the flag says): refused here."""
    if not cfg.data_device_resident:
        raise ValueError(
            f"--data_device_resident false is not supported by "
            f"{trainer_name}: the shadow trainers keep their buffers on the "
            "device (see ROADMAP.md)")


def _put(a, device, dtype=None) -> torch.Tensor:
    """A host array on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


def _on(device, sample, keys):
    return {k: _put(sample[k], device) for k in keys}


class _ShadowSystemBase(NeRFSystem):
    """The per-ray shadow systems' loaders and buffers."""

    datasets = ("efficient_sm", "rgb_sm", "pyredner2")
    traces_first_epoch = False  # the JAX systems do not read --profile

    @classmethod
    def check_supported(cls, cfg: Config) -> None:
        """The common flags and the dataset; ``--loss_type`` is not read (the
        shadow losses are fixed, as in the JAX package)."""
        _reject_global_reshuffle(cfg, cls.__name__)
        _reject_streaming(cfg, cls.__name__)
        if cfg.per_host_data and cfg.dataset_name not in ("efficient_sm",
                                                          "rgb_sm"):
            raise ValueError("--per_host_data supports the efficient_sm and "
                             f"rgb_sm shadow loaders (got {cfg.dataset_name})")
        raise_unsupported({
            **common_unsupported(cfg),
            f"--dataset_name {cfg.dataset_name}":
                cfg.dataset_name not in cls.datasets,
        })

    def _dataset_kwargs(self) -> dict:
        cfg = self.cfg
        kw = dict(root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh))
        if cfg.dataset_name == "efficient_sm":
            kw.update(white_pix=cfg.white_pix, blur=cfg.blur)
        elif cfg.dataset_name == "rgb_sm":
            kw.update(max_images=cfg.max_images, blur=cfg.blur, seed=cfg.seed)
        elif cfg.dataset_name == "pyredner2":
            kw.update(coords_trans=cfg.coords_trans,
                      coords_trans2=cfg.coords_trans2, blur=cfg.blur)
        return kw

    def _prepare_data(self):
        cfg = self.cfg
        ds_cls = dataset_dict[cfg.dataset_name]
        kw = self._dataset_kwargs()
        mesh = self.mesh
        # each rank loads kept-frames[rank::size]; the pose tables stay
        # whole and pose_idx global
        train_kw = (dict(kw, frame_shard=(mesh.rank, mesh.size))
                    if self.per_host else kw)
        self.train_dataset = ds_cls(split="train", **train_kw)
        self.val_dataset = ds_cls(split="val", **kw)
        self.white_back = self.train_dataset.white_back
        ds, dev = self.train_dataset, self.device
        # by name; sms only where the loader has shadow targets beside rgbs
        bufs = {"rays": ds.all_rays, "rgbs": ds.all_rgbs,
                "pixels": ds.all_pixels, "pose_idx": ds.pose_idx}
        if hasattr(ds, "all_sm"):
            bufs["sms"] = ds.all_sm
        if self.per_host:
            # a content filter (white_pix) leaves the ranks different row
            # counts: wrap-pad each to the largest, so shard_rays' global
            # minimum drops nothing
            n_local = int(ds.all_rays.shape[0])
            target = int(pmesh.process_allgather(
                np.asarray([n_local], np.int64), mesh).max())
            bufs = dict(zip(bufs, equalize_rows(list(bufs.values()),
                                                n_local, target)))
        for name, arr in bufs.items():
            setattr(self, name, _put(pmesh.shard_rays(arr, mesh,
                                                      local=self.per_host),
                                     dev, torch.int64 if name == "pose_idx"
                                     else None))
        self.cam_ms, self.cam_eyes = _put(ds.cam_ms, dev), _put(ds.cam_eyes, dev)
        self.num_poses = int(ds.cam_ms.shape[0])
        self.light_rays = _put(ds.light.rays, dev)
        self.light_pixels = _put(ds.light.pixels, dev)
        self.light_m = _put(ds.light.camera, dev)
        self.light_eye = _put(ds.light.eye_pos, dev)
        # the light view renders a slice a rank when the ranks divide H*W
        # (shard_rays truncates otherwise, and every light pixel must
        # render), else whole on every rank
        self.shard_light = (mesh.size > 1
                            and self.light_rays.shape[0] % mesh.size == 0)


class EfficientSMSystem(_ShadowSystemBase):
    """Flagship shadow trainer (reference ``train_efficient_sm.py``)."""

    loss_label = "sm_loss"
    # the buffers a step slices, in train_step's order, and its outputs
    train_bufs = ("rays", "rgbs", "pixels", "pose_idx")
    metric_keys = ("train/loss", "train/psnr", "train/train_opactiy")

    def __init__(self, cfg: Config, device=None):
        if cfg.grad_on_light:
            cfg.sample_light_depth_every = 1
        super().__init__(cfg, device)
        self.rkw = self._camera_rkw()
        self._light_n = None

    def _camera_rkw(self) -> dict:
        return sigma_render_kwargs(self.cfg, self.cfg.N_importance)

    # -- the light ------------------------------------------------------------
    def resolve_light_n(self, epoch: int) -> int:
        cfg = self.cfg
        if cfg.Light_N_importance == -1:
            rng = np.random.RandomState(cfg.seed + epoch)
            return int(rng.choice(list(LIGHT_N_CHOICES)))
        return cfg.Light_N_importance

    def light_render(self, light_n: int, overrides=None):
        """The light cache; over a mesh that divides ``H*W`` each rank
        renders its slice of the light rays (and of ``overrides``, given
        for the whole view) and the slices are gathered."""
        rkw = sigma_render_kwargs(self.cfg, light_n)
        if not self.shard_light:
            return light_cache_render(self.models, self.light_rays,
                                      self.render_gen, rkw, overrides)
        mine = lambda t: pmesh.shard_rays(t, self.mesh)  # noqa: E731
        local = light_cache_render(
            self.models, mine(self.light_rays), self.render_gen, rkw,
            None if overrides is None else
            {k: mine(v) for k, v in overrides.items()})
        return {k: pmesh.all_gather_tiled(v, self.mesh)
                for k, v in local.items()}

    def empty_light_cache(self) -> Dict[str, torch.Tensor]:
        hw = self.light_rays.shape[0]
        return {k: torch.zeros(hw, device=self.device) for k in
                ("depth_coarse", "depth_fine", "opacity_coarse", "opacity_fine")}

    # -- one step -------------------------------------------------------------
    def _shadow_out(self, rays, pixels, pose_idx, light_cache, light_n: int,
                    overrides: Optional[dict], out_prefix: str = "rgb"):
        """The camera render and the shadow maps composited into
        ``{out_prefix}_*``; with ``grad_on_light`` the light view rendered
        here, with gradients.  Returns (outputs, the light cache used)."""
        cfg = self.cfg
        ov = overrides or {}
        cam_res = render_rays(self.models["coarse"], self.models.get("fine"),
                              rays, self.render_gen, overrides=ov.get("cam"),
                              **self.rkw)
        if cfg.grad_on_light:
            light_cache = self.light_render(light_n, ov.get("light"))
        out = efficient_sm(
            pixels, self.light_pixels, cam_res, light_cache,
            self.cam_ms[pose_idx], self.cam_eyes[pose_idx], self.light_m,
            self.light_eye, tuple(cfg.img_wh),
            fine_sampling=cfg.N_importance > 0, light_has_fine=light_n > 0,
            shadow_method=cfg.shadow_method, pose_idx=pose_idx,
            num_poses=self.num_poses, out_prefix=out_prefix)
        return out, light_cache

    def train_step(self, rays, rgbs, pixels, pose_idx, light_cache,
                   light_n: int, overrides: Optional[dict] = None):
        """render -> efficient_sm -> MSE -> backward -> Adam on one batch.
        With ``grad_on_light`` the light view is rendered here, with
        gradients; else ``light_cache`` is used as it is.  ``overrides``:
        ``{"cam": {...}, "light": {...}}``, each the ``render_rays``
        overrides of that render.  Returns (loss, psnr, opacity loss)."""
        out, light_cache = self._shadow_out(rays, pixels, pose_idx,
                                            light_cache, light_n, overrides)
        loss = mse_loss(out, rgbs)
        with torch.no_grad():
            typ = "fine" if self.cfg.N_importance > 0 else "coarse"
            psnr = psnr_metric(out[f"rgb_{typ}"], rgbs)
            # logged only; batch > H*W would index past the light view
            b = min(rgbs.shape[0], light_cache["opacity_coarse"].shape[0])
            op_in = {"opacity_coarse": light_cache["opacity_coarse"][:b]}
            if light_n > 0:
                op_in["opacity_fine"] = light_cache["opacity_fine"][:b]
            op_loss = opacity_loss(op_in, rgbs[:b])
        self._optimize(loss)
        return loss.detach(), psnr, op_loss

    def train_epoch(self, epoch: int, global_step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B = cfg.batch_size
        k = max(1, cfg.sample_light_depth_every)
        light_n = self._light_n = self.resolve_light_n(epoch)
        cache = self.empty_light_cache()
        values = [[] for _ in self.metric_keys]
        for ei in range(self.steps_per_epoch):
            self._preempt_if_asked(epoch, complete=False)
            if not cfg.grad_on_light and ((global_step + ei) % k == 0 or ei == 0):
                with torch.no_grad():
                    cache = self.light_render(light_n)
            sl = slice(ei * B, (ei + 1) * B)
            step = self.train_step(*(getattr(self, name)[sl]
                                     for name in self.train_bufs),
                                   cache, light_n)
            for acc, v in zip(values, step):
                acc.append(v)
        return self.epoch_values(dict(zip(self.metric_keys, values)))

    def _epoch_note(self, epoch: int, means: Dict[str, float]) -> str:
        return f"Light_N={self._light_n}, "

    # -- validation -----------------------------------------------------------
    def _val_frame(self, sample, rkw_cam: dict, rkw_light: dict, light_depths,
                   out_prefix: str = "rgb"):
        """One val frame rendered whole and composited; the light view is
        rendered once (``light_depths`` None) and reused.  Returns the
        outputs, the light depths and the frame's tensors."""
        cfg = self.cfg
        t = _on(self.device, sample, ("rays", "pixels", "rgbs", "light_rays",
                                      "light_pixels"))
        cam_res = render_image(self.models, t["rays"], self.render_gen,
                               chunk=cfg.chunk, mesh=self.mesh, **rkw_cam)
        if light_depths is None:
            light_res = render_image(self.models, t["light_rays"],
                                     self.render_gen, chunk=cfg.chunk,
                                     mesh=self.mesh, **rkw_light)
            light_depths = {
                "depth_coarse": light_res["depth_coarse"],
                "depth_fine": light_res.get("depth_fine",
                                            light_res["depth_coarse"])}
        fine = cfg.N_importance > 0
        cam, light = (_on(self.device, sample[k], ("camera", "eye_pos"))
                      for k in ("ppc", "light_ppc"))
        with torch.no_grad():
            out = efficient_sm(
                t["pixels"], t["light_pixels"], cam_res, light_depths,
                cam["camera"], cam["eye_pos"], light["camera"],
                light["eye_pos"], tuple(cfg.img_wh), fine_sampling=fine,
                light_has_fine=fine, shadow_method=cfg.shadow_method,
                out_prefix=out_prefix)
        return out, light_depths, t

    def validation(self, epoch: int,
                   max_images: Optional[int] = None) -> Dict[str, float]:
        """Every val frame rendered whole, the light view once, composited
        per frame."""
        cfg = self.cfg
        rkw = sigma_render_kwargs(cfg, cfg.N_importance, train=False)
        typ = "fine" if cfg.N_importance > 0 else "coarse"
        n_img = len(self.val_dataset)
        if max_images is not None:
            n_img = min(n_img, max_images)
        losses, psnrs, light_depths = [], [], None
        for i in range(n_img):
            out, light_depths, t = self._val_frame(
                self.val_dataset[i], rkw, rkw, light_depths)
            losses.append(float(mse_loss(out, t["rgbs"])))
            psnrs.append(float(psnr_metric(out[f"rgb_{typ}"], t["rgbs"])))
            if i == 0:
                submit_val_images(self, epoch, out, t["rgbs"], typ)
        return {"val/loss": float(np.mean(losses)),
                "val/psnr": float(np.mean(psnrs))}


class RGBSMSystem(EfficientSMSystem):
    """Joint RGB + shadow trainer (reference ``train_rgb_sm_juntos.py``):
    the camera keeps its RGB (``rgb_disp``), the shadow maps go to ``sm_*``
    and the loss is ``rgb_weight * mse(rgb) + sm_weight * mse(sm)``."""

    loss_label = "loss"
    train_bufs = ("rays", "rgbs", "sms", "pixels", "pose_idx")
    metric_keys = ("train/loss", "train/psnr", "train/sm_psnr")

    def _prepare_data(self):
        super()._prepare_data()
        if not hasattr(self, "sms"):
            raise KeyError(
                f"dataset {type(self.train_dataset).__name__} exposes no "
                "all_sm buffer: rgb_sm training needs shadow-map targets")

    def _camera_rkw(self) -> dict:
        # the JAX system's camera render takes no --remat_fine
        return dict(sigma_render_kwargs(self.cfg, self.cfg.N_importance),
                    mode="rgb_disp", white_back=self.white_back,
                    remat_fine=False)

    def _loss(self, out, rgbs, sms):
        typ = "fine" if self.cfg.N_importance > 0 else "coarse"
        loss = (self.cfg.rgb_weight * mse_loss(out, rgbs)
                + self.cfg.sm_weight * sm_loss(out, sms))
        with torch.no_grad():
            return (loss, psnr_metric(out[f"rgb_{typ}"], rgbs),
                    psnr_metric(out[f"sm_{typ}"], sms))

    def train_step(self, rays, rgbs, sms, pixels, pose_idx, light_cache,
                   light_n: int, overrides: Optional[dict] = None):
        """render (rgb_disp) -> efficient_sm into ``sm_*`` -> the weighted
        loss -> backward -> Adam.  Returns (loss, psnr, sm_psnr)."""
        out, _ = self._shadow_out(rays, pixels, pose_idx, light_cache,
                                  light_n, overrides, out_prefix="sm")
        loss, psnr, sm_psnr = self._loss(out, rgbs, sms)
        self._optimize(loss)
        return loss.detach(), psnr, sm_psnr

    def _epoch_note(self, epoch: int, means: Dict[str, float]) -> str:
        return (f"sm_psnr {means['train/sm_psnr']:.2f}, "
                f"{super()._epoch_note(epoch, means)}")

    def validation(self, epoch: int,
                   max_images: Optional[int] = None) -> Dict[str, float]:
        """As ``EfficientSMSystem``'s, the camera in ``rgb_disp`` and the
        light view with ``N_importance`` fine samples."""
        cfg = self.cfg
        rkw_light = sigma_render_kwargs(cfg, cfg.N_importance, train=False)
        typ = "fine" if cfg.N_importance > 0 else "coarse"
        n_img = len(self.val_dataset)
        if max_images is not None:
            n_img = min(n_img, max_images)
        rows, light_depths = [], None
        for i in range(n_img):
            sample = self.val_dataset[i]
            out, light_depths, t = self._val_frame(
                sample, self.rkw, rkw_light, light_depths, out_prefix="sm")
            sms = _put(sample["sm"], self.device)
            rows.append([float(v) for v in self._loss(out, t["rgbs"], sms)])
            if i == 0:
                submit_val_images(self, epoch, out, t["rgbs"], typ)
        loss, psnr, sm_psnr = np.mean(np.asarray(rows), axis=0)
        return {"val/loss": float(loss), "val/psnr": float(psnr),
                "val/sm_psnr": float(sm_psnr)}


class LightSamplerSystem(_ShadowSystemBase):
    """Sampled-light shadow trainer (reference ``train_light_sampler.py``):
    each step projects the camera batch into the light view and renders
    only those B light rays.  The shadow map is min-max normalised over the
    whole batch (no per-pose segments), and written to ``rgb_coarse`` only:
    the reference keeps the fine map under a key its loss never reads."""

    def __init__(self, cfg: Config, device=None):
        super().__init__(cfg, device)
        self.rkw = sigma_render_kwargs(cfg, cfg.N_importance)
        self.light_n = max(cfg.Light_N_importance, 0)
        self.rkw_light = sigma_render_kwargs(cfg, self.light_n)
        light = self.train_dataset.light
        self.light_geom = (
            _put(light.l2w, self.device),
            torch.tensor(light.focal, dtype=torch.float32, device=self.device),
            float(np.float32(light.near)), float(np.float32(light.far)))

    def train_step(self, rays, rgbs, pixels, pose_idx,
                   overrides: Optional[dict] = None):
        """camera render -> projection into the light -> the B light rays'
        render -> shadow map -> MSE -> backward -> Adam.  ``overrides`` as
        ``EfficientSMSystem.train_step``'s.  Returns (loss, psnr)."""
        cfg = self.cfg
        ov = overrides or {}
        models = (self.models["coarse"], self.models.get("fine"))
        cam_res = render_rays(*models, rays, self.render_gen,
                              overrides=ov.get("cam"), **self.rkw)
        K, ul, vl, lrays = ls_project(
            cam_res, pixels, self.cam_ms[pose_idx], self.cam_eyes[pose_idx],
            self.light_m, self.light_eye, *self.light_geom,
            tuple(cfg.img_wh), cfg.N_importance > 0)
        # the rays are detached; the light render is differentiated
        light_res = render_rays(*models, lrays, self.render_gen,
                                overrides=ov.get("light"), **self.rkw_light)
        depth = light_res["depth_fine" if self.light_n > 0 else "depth_coarse"]
        sm = ls_composite(K, ul, vl, depth, self.light_m, cfg.shadow_method)
        loss = torch.mean((sm - rgbs) ** 2)
        psnr = psnr_metric(sm.detach(), rgbs)
        self._optimize(loss)
        return loss.detach(), psnr

    def train_epoch(self, epoch: int, global_step: int) -> Dict[str, np.ndarray]:
        B = self.cfg.batch_size
        losses, psnrs = [], []
        for i in range(self.steps_per_epoch):
            self._preempt_if_asked(epoch, complete=False)
            sl = slice(i * B, (i + 1) * B)
            loss, psnr = self.train_step(self.rays[sl], self.rgbs[sl],
                                         self.pixels[sl], self.pose_idx[sl])
            losses.append(loss)
            psnrs.append(psnr)
        return self.epoch_values({"train/loss": losses, "train/psnr": psnrs})

    def validation(self, epoch: int,
                   max_images: Optional[int] = None) -> Dict[str, float]:
        """Each val frame: the camera image rendered whole, every pixel
        projected into the light view, the light rays through those pixels
        rendered, and the shadow map scored as ``rgb_coarse``."""
        cfg = self.cfg
        n_img = len(self.val_dataset)
        if max_images is not None:
            n_img = min(n_img, max_images)
        losses, psnrs = [], []
        for i in range(n_img):
            sample = self.val_dataset[i]
            t = _on(self.device, sample, ("rays", "pixels", "rgbs"))
            cam_res = render_image(self.models, t["rays"], self.render_gen,
                                   chunk=cfg.chunk, mesh=self.mesh,
                                   **self.rkw)
            with torch.no_grad():
                K, ul, vl, lrays = ls_project(
                    cam_res, t["pixels"],
                    _put(sample["ppc"]["camera"], self.device),
                    _put(sample["ppc"]["eye_pos"], self.device),
                    self.light_m, self.light_eye, *self.light_geom,
                    tuple(cfg.img_wh), cfg.N_importance > 0)
            light_res = render_image(self.models, lrays, self.render_gen,
                                     chunk=cfg.chunk, mesh=self.mesh,
                                     **self.rkw_light)
            depth = light_res["depth_fine" if self.light_n > 0
                              else "depth_coarse"]
            out = dict(cam_res)
            out["rgb_coarse"] = ls_composite(K, ul, vl, depth, self.light_m,
                                             cfg.shadow_method)
            losses.append(float(mse_loss(out, t["rgbs"])))
            psnrs.append(float(psnr_metric(out["rgb_coarse"], t["rgbs"])))
            if i == 0:
                submit_val_images(self, epoch, out, t["rgbs"], "coarse")
        return {"val/loss": float(np.mean(losses)),
                "val/psnr": float(np.mean(psnrs))}


class ShadowMappingSystem(NeRFSystem):
    """Image-space shadow trainer (reference ``train_shadow_mapping.py``):
    each step renders ``batch_size`` whole camera images and the whole
    light view, and composites them per image (``shadow_mapping_images``,
    min-max over each image).  ``--batch_size`` counts images; step ``s``
    takes images ``(s * B + k) % n``.  ``epoch=N.ckpt`` is written every
    epoch and never pruned."""

    datasets = ("shadows",)
    traces_first_epoch = False  # the JAX system does not read --profile

    @classmethod
    def check_supported(cls, cfg: Config) -> None:
        _reject_per_host_data(cfg, cls.__name__)
        _reject_global_reshuffle(cfg, cls.__name__)
        _reject_streaming(cfg, cls.__name__)
        raise_unsupported({
            **common_unsupported(cfg),
            f"--dataset_name {cfg.dataset_name}":
                cfg.dataset_name not in cls.datasets,
        })

    def __init__(self, cfg: Config, device=None):
        super().__init__(cfg, device)
        self.rkw = sigma_render_kwargs(cfg, cfg.N_importance)

    def _prepare_data(self):
        cfg = self.cfg
        w, h = cfg.img_wh
        d = self.mesh.size
        if (w * h) % d:
            # JAX shrinks an unset --num_devices to a count that divides
            # H*W; here the launcher fixes the world, so say which count
            nd = d
            while (w * h) % nd:
                nd -= 1
            raise ValueError(
                f"ShadowMappingSystem: {d} ranks do not divide H*W={w * h}; "
                f"start {nd} (the largest count that divides it)")
        ds_cls = dataset_dict[cfg.dataset_name]
        kw = dict(root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh))
        self.train_dataset = ds_cls(split="train", **kw)
        self.val_dataset = ds_cls(split="val", **kw)
        self.white_back = self.train_dataset.white_back
        items = [self.train_dataset[i] for i in range(len(self.train_dataset))]

        def stack(get):
            return _put(np.stack([get(it) for it in items]), self.device)

        self.rays = stack(lambda it: it["rays"])  # (n, HW, 8)
        self.rgbs = stack(lambda it: it["rgbs"])
        self.cam_ms = stack(lambda it: it["ppc"]["camera"])
        self.cam_eyes = stack(lambda it: it["ppc"]["eye_pos"])
        light = self.train_dataset.light
        self.light_rays = _put(light.rays, self.device)
        self.light_m = _put(light.camera, self.device)
        self.light_eye = _put(light.eye_pos, self.device)

    def _count_steps(self) -> int:
        return max(1, self.rays.shape[0] // max(1, self.cfg.batch_size))

    @property
    def rays_per_step(self) -> int:
        w, h = self.cfg.img_wh
        return max(1, self.cfg.batch_size) * w * h

    def train_step(self, rays, rgbs, cam_ms, cam_eyes,
                   overrides: Optional[dict] = None):
        """``rays (B, HW, 8)`` and the light view rendered whole, the light
        depths tiled over the B images, composited, MSE against ``rgbs (B,
        HW, 3)``, backward, Adam.  ``overrides`` as
        ``EfficientSMSystem.train_step``'s, for every ray.  Over a mesh each
        rank renders its slice of the camera and light rays, and the
        gathered depths are composited on every rank (min-max is over whole
        images): the gather's backward sums every rank's cotangent, and the
        grads' mean over the ranks is the one-process grad.  Returns
        (loss, psnr)."""
        cfg = self.cfg
        ov = overrides or {}
        Bi = cam_ms.shape[0]
        models = (self.models["coarse"], self.models.get("fine"))
        mine = lambda t: pmesh.shard_rays(t, self.mesh)  # noqa: E731
        mine_ov = lambda o: None if o is None else {  # noqa: E731
            k: mine(v) for k, v in o.items()}
        gather = lambda t: pmesh.all_gather_tiled(t, self.mesh)  # noqa: E731
        cam_res = render_rays(*models, mine(rays.reshape(-1, 8)),
                              self.render_gen, overrides=mine_ov(ov.get("cam")),
                              **self.rkw)
        light_res = render_rays(*models, mine(self.light_rays),
                                self.render_gen,
                                overrides=mine_ov(ov.get("light")), **self.rkw)
        light_tiled = {k: gather(v).repeat(Bi) for k, v in light_res.items()
                       if k.startswith("depth")}
        fine = cfg.N_importance > 0
        out = shadow_mapping_images(
            {k: gather(v) for k, v in cam_res.items() if k.startswith("depth")},
            light_tiled, cam_ms, cam_eyes, self.light_m, self.light_eye,
            tuple(cfg.img_wh), Bi, fine_sampling=fine,
            shadow_method=cfg.shadow_method)
        targets = rgbs.reshape(-1, 3)
        loss = mse_loss(out, targets)
        psnr = psnr_metric(out["rgb_fine" if fine else "rgb_coarse"].detach(),
                           targets)
        self._optimize(loss)
        return loss.detach(), psnr

    def train_epoch(self, epoch: int, global_step: int) -> Dict[str, np.ndarray]:
        n, Bi = self.rays.shape[0], max(1, self.cfg.batch_size)
        # every step's image indices, moved to the device once an epoch
        idx = torch.arange(self.steps_per_epoch * Bi) % n
        idx = host_to_device(idx.reshape(-1, Bi), self.device)
        losses, psnrs = [], []
        for s in range(self.steps_per_epoch):
            self._preempt_if_asked(epoch, complete=False)
            i = idx[s]
            loss, psnr = self.train_step(self.rays[i], self.rgbs[i],
                                         self.cam_ms[i], self.cam_eyes[i])
            losses.append(loss)
            psnrs.append(psnr)
        return self.epoch_values({"train/loss": losses, "train/psnr": psnrs})

    def _save_epoch(self, epoch: int, val_loss: Optional[float]) -> None:
        self.save_ckpt(epoch, None, background=True)

    def validation(self, epoch: int,
                   max_images: Optional[int] = None) -> Dict[str, float]:
        """Each val image and the light view (once) rendered whole and
        composited one image at a time."""
        cfg = self.cfg
        rkw = sigma_render_kwargs(cfg, cfg.N_importance, train=False)
        fine = cfg.N_importance > 0
        typ = "fine" if fine else "coarse"
        n_img = len(self.val_dataset)
        if max_images is not None:
            n_img = min(n_img, max_images)
        losses, psnrs, light_depths = [], [], None
        for i in range(n_img):
            sample = self.val_dataset[i]
            t = _on(self.device, sample, ("rays", "rgbs"))
            cam_res = render_image(self.models, t["rays"], self.render_gen,
                                   chunk=cfg.chunk, mesh=self.mesh, **rkw)
            if light_depths is None:
                light_res = render_image(self.models, self.light_rays,
                                         self.render_gen, chunk=cfg.chunk,
                                         mesh=self.mesh, **rkw)
                light_depths = {k: v for k, v in light_res.items()
                                if k.startswith("depth")}
            with torch.no_grad():
                out = shadow_mapping_images(
                    cam_res, light_depths,
                    _put(sample["ppc"]["camera"], self.device)[None],
                    _put(sample["ppc"]["eye_pos"], self.device)[None],
                    self.light_m, self.light_eye, tuple(cfg.img_wh), 1,
                    fine_sampling=fine, shadow_method=cfg.shadow_method)
            losses.append(float(mse_loss(out, t["rgbs"])))
            psnrs.append(float(psnr_metric(out[f"rgb_{typ}"], t["rgbs"])))
            if i == 0:
                submit_val_images(self, epoch, out, t["rgbs"], typ)
        return {"val/loss": float(np.mean(losses)),
                "val/psnr": float(np.mean(psnrs))}


class ShadowsSystem(NeRFSystem):
    """RGB NeRF training on shadow data (reference ``train_shadows.py``): the
    vanilla step on a shadow loader's rays, near and far the loader's own.
    A per-image dataset is flattened into one ray buffer.  The reference's
    Lightning ``auto_scale_batch_size`` is not reproduced (as in the JAX
    package)."""

    datasets = tuple(dataset_dict)

    @classmethod
    def check_supported(cls, cfg: Config) -> None:
        _reject_per_host_data(cfg, cls.__name__)
        _reject_streaming(cfg, cls.__name__)
        super().check_supported(cfg)

    def _prepare_data(self):
        cfg = self.cfg
        ds_cls = dataset_dict[cfg.dataset_name]
        kw = dict(root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh))
        self.train_dataset = ds_cls(split="train", **kw)
        self.val_dataset = ds_cls(split="val", **kw)
        self.white_back = self.train_dataset.white_back
        ds = self.train_dataset
        if hasattr(ds, "all_rays"):
            rays, rgbs = ds.all_rays, ds.all_rgbs
        else:
            items = [ds[i] for i in range(len(ds))]
            rays = np.concatenate([it["rays"] for it in items], 0)
            rgbs = np.concatenate([it["rgbs"] for it in items], 0)
        self._set_train_buffers(rays, rgbs)
