"""Worker processes for the port's distributed tests (not a pytest module;
it imports no JAX).

    python torch_dist_worker.py steps <spec.json>    # one rank of a group
    python torch_dist_worker.py launch <spec.json>   # the trainer launcher

``steps`` runs as one rank of a process group the parent describes in the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):
one vanilla ``NeRFSystem`` step and one ``RGBSMSystem --grad_on_light`` step
on this rank's rows with the parent's injected draws (the second twice:
on the loader's rays, and with its bounds cut to the scene), and
writes the averaged grads, the parameters after the update and the batch
to ``<out>/rank<r>.npz``.

``launch`` calls ``training.launch.launch`` (what ``python -m
nerf_pl_tpu_torch.train`` calls) with the spec's command line, on a
``Record*`` subclass of the trainer that writes, for each rank, its
parameters' digest, its row count, which files it wrote, and with
``PORT_TEST_RECORD_ROWS`` set the rays of every step, to
``<log_dir>/rank<r>.json`` (and ``.npz``).
"""
import hashlib
import json
import os
import sys

import numpy as np
import torch

from nerf_pl_tpu_torch.training import checkpoints as ckpt_mod
from nerf_pl_tpu_torch.training.shadow_systems import (EfficientSMSystem,
                                                       RGBSMSystem)
from nerf_pl_tpu_torch.training.trainer import NeRFSystem


def _named(system):
    return {f"{k}/{n}": p for k, m in system.models.items()
            for n, p in m.named_parameters()}


def digest(system) -> str:
    h = hashlib.sha256()
    for name, p in sorted(_named(system).items()):
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class _Record:
    """A trainer that records, per rank, what the distributed tests hold."""

    def __init__(self, cfg, device=None):
        self._writes = []
        real = ckpt_mod.save_checkpoint

        def counting(path, state):
            self._writes.append(os.path.basename(path))
            real(path, state)

        ckpt_mod.save_checkpoint = counting
        super().__init__(cfg, device)
        self._rows = []
        if os.environ.get("PORT_TEST_RECORD_ROWS"):
            step = self.train_step

            def recording(rays, *rest, **kw):
                self._rows.append(rays.detach().cpu().numpy().copy())
                return step(rays, *rest, **kw)

            self.train_step = recording

    def fit(self):
        wrote_logs = self.logger._jsonl is not None
        out = super().fit()
        r = self.mesh.rank
        rec = dict(rank=r, size=self.mesh.size, digest=digest(self),
                   rows=int(self.rays.shape[0]) if hasattr(self, "rays")
                   else None,
                   steps_per_epoch=self.steps_per_epoch,
                   wrote_logs=wrote_logs, checkpoint_writes=self._writes,
                   slab_copies=self.slab_copies)
        base = os.path.join(self.cfg.log_dir, f"rank{r}")
        with open(base + ".json", "w") as f:
            json.dump(rec, f)
        if self._rows:
            np.save(base + "_rows.npy", np.stack(self._rows))
        return out


class RecordNeRF(_Record, NeRFSystem):
    pass


class RecordEfficientSM(_Record, EfficientSMSystem):
    pass


def run_launch(spec: dict) -> None:
    from nerf_pl_tpu_torch.training.launch import launch

    cls = {"NeRFSystem": RecordNeRF,
           "EfficientSMSystem": RecordEfficientSM}[spec["system"]]
    launch(cls, argv=spec["argv"])


def _ov(inp, prefix):
    return {k[len(prefix):]: torch.from_numpy(inp[k]) for k in inp.files
            if k.startswith(prefix)}


def run_steps(spec: dict) -> None:
    from nerf_pl_tpu_torch.config import Config

    r = int(os.environ["RANK"])
    inp = np.load(spec["inputs"])
    out = {}
    system = NeRFSystem(Config(**spec["vanilla"]), device="cpu")
    loss, psnr = system.train_step(
        torch.from_numpy(inp[f"v_rays_{r}"]), torch.from_numpy(inp[f"v_rgbs_{r}"]),
        overrides=_ov(inp, f"v_ov_{r}_"))
    out["v_loss"] = float(loss)
    for name, p in _named(system).items():
        out[f"v_grad/{name}"] = p.grad.numpy()
        out[f"v_param/{name}"] = p.detach().numpy()
    system.logger.close()

    # "b": the loader's rays (near/far 1/200); "n": the same step with the
    # camera's and the light's near and far cut to the scene
    for tag, bounds in (("b", None), ("n", spec["near_far"])):
        sm = RGBSMSystem(Config(**spec["rgb_sm"]), device="cpu")
        if bounds is not None:
            sm.rays[:, 6:8] = torch.tensor(bounds[0])
            sm.light_rays[:, 6:8] = torch.tensor(bounds[1])
        lo, hi = spec["rgb_sm_rows"]
        batch = [getattr(sm, k)[lo:hi] for k in sm.train_bufs]
        for k, t in zip(sm.train_bufs, batch):
            out[f"{tag}_batch/{k}"] = t.numpy()
        loss, psnr, sm_psnr = sm.train_step(
            *batch, None, spec["rgb_sm"]["Light_N_importance"],
            overrides={"cam": _ov(inp, f"b_cam_{r}_"),
                       "light": _ov(inp, "b_light_")})
        out[f"{tag}_loss"] = float(loss)
        for name, p in _named(sm).items():
            out[f"{tag}_grad/{name}"] = (np.zeros(tuple(p.shape), np.float32)
                                         if p.grad is None else p.grad.numpy())
        sm.logger.close()
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    stage, spec_path = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    {"steps": run_steps, "launch": run_launch}[stage](spec)
