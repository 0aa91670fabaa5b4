"""Render server: load a checkpoint once, serve novel views over HTTP with
concurrent-request batching (``nerf_pl_tpu/tools/serve.py``).

Each allowed image size gets a ``BatchingDispatcher``: handler threads
enqueue a camera and block; a dispatcher thread drains the queue (the first
request at once, then stragglers until the queue is quiet for
``max_wait_ms``, capped at ``max_batch``), rounds the group up to the next
batch tier (1, 2, 4, ... max_batch; pad slots repeat the last camera),
renders the group as one batch of rays on the device, and hands each
request its image.

API:
  GET  /healthz               -> {"status": "ok", "renders": N,
                                  "batches": M, "batch_tiers": {...}}
  POST /render                body: {"eye": [x,y,z], "look_at": [x,y,z]?,
                                     "img_wh": int?, "format": "png"|"npy"}
                              -> image bytes (image/png) or raw float32 .npy
  GET  /render?theta=..&radius=..&height=..   orbit-parameterised GET

Start:
  python -m nerf_pl_tpu_torch.tools.serve --ckpt_path ckpts/exp/epoch=15.ckpt \
      --port 8000 --img_wh 64 --near 2 --far 6 --max_batch 8 --device cuda
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import resolve_device
from ..models.camera import c2w_from_lookat
from ..ops.ray_utils import get_ray_directions, rotate
from ..ops.rendering import render_rays
from .evaluate import load_models

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def serve_render(models: dict, dirs: torch.Tensor, c2ws: torch.Tensor,
                 near: float, far: float, chunk: int, rkw: dict,
                 img_key: str) -> torch.Tensor:
    """Batched view render with the rays built on the device.

    ``dirs (p, 3)`` camera-frame directions, ``c2ws (b, 3, 4)``.  Rays are
    ``dirs @ R^T`` normalised, with the camera origin and [near, far];
    padded to a multiple of ``chunk`` by repeating the last ray, rendered
    chunk by chunk.  Returns ``(b * p, 3)`` of ``img_key``."""
    b, p = c2ws.shape[0], dirs.shape[0]
    rays_d = rotate(dirs[None], c2ws[:, None, :, :3])  # (b, p, 3)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2ws[:, None, :, 3].expand(b, p, 3)
    nf = torch.ones((b, p, 1), dtype=rays_d.dtype, device=rays_d.device)
    rays = torch.cat([rays_o, rays_d, near * nf, far * nf], -1).reshape(b * p, 8)
    n = b * p
    pad = -(-n // chunk) * chunk - n
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, 8)])
    imgs = [
        render_rays(models.get("coarse"), models.get("fine"), rays_c, None,
                    **rkw)[img_key]
        for rays_c in rays.split(chunk)
    ]
    return torch.cat(imgs)[:n]


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, zlib, no filter)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


class _Pending:
    """One enqueued render request: camera in, image (or error) out."""

    __slots__ = ("payload", "out", "err", "done")

    def __init__(self, payload: np.ndarray):
        self.payload = payload
        self.out = None
        self.err: Exception | None = None
        self.done = threading.Event()


class BatchingDispatcher:
    """Coalesces concurrent same-size render requests into one batch.

    A group of k requests renders at the smallest tier >= k (the ladder
    1, 2, 4, ... up to ``max_batch``); tiers whose ``tier * wh^2`` rays
    exceed ``max_rays`` are dropped, never tier 1."""

    def __init__(self, service: "RenderService", wh: int, max_batch: int,
                 max_wait_ms: float, max_rays: int = 1 << 20):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.service = service
        self.wh = wh
        ladder = [t for t in (1, 2, 4, 8, 16, 32, 64) if t < max_batch]
        ladder.append(max_batch)
        self.tiers = [t for t in ladder if t == 1 or t * wh * wh <= max_rays]
        self.max_batch = self.tiers[-1]
        self.max_wait = max_wait_ms / 1000.0
        self.q: "queue.SimpleQueue[_Pending]" = queue.SimpleQueue()
        self._last_batch = 1  # adaptive: singles skip the straggler wait
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"dispatch-wh{wh}"
        )
        self._thread.start()

    def submit(self, payload: np.ndarray) -> np.ndarray:
        """Enqueue one request and block until its image is rendered."""
        item = _Pending(payload)
        self.q.put(item)
        item.done.wait()
        if item.err is not None:
            raise item.err
        return item.out

    def _collect(self) -> list:
        """The first request blocks; under sequential load (the last batch
        was a single and nothing waits) it goes out at once.  Otherwise
        stragglers join until the queue is quiet for ``max_wait`` (each
        arrival re-arms the window, capped at 4x) or the batch is full."""
        batch = [self.q.get()]
        if self._last_batch <= 1 and self.q.empty():
            self._last_batch = 1
            return batch
        hard_deadline = time.monotonic() + 4 * self.max_wait
        while len(batch) < self.max_batch:
            remaining = min(self.max_wait, hard_deadline - time.monotonic())
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        self._last_batch = len(batch)
        return batch

    def _loop(self):
        while True:
            batch = self._collect()
            try:
                imgs = self.service.render_batch(
                    [p.payload for p in batch], self.wh
                )
                for p, img in zip(batch, imgs):
                    p.out = img
            except Exception as e:  # noqa: BLE001 — fan the error out to
                for p in batch:     # every waiter; the loop must survive
                    p.err = e
            finally:
                for p in batch:
                    p.done.set()

    def tier_for(self, k: int) -> int:
        for t in self.tiers:
            if t >= k:
                return t
        return self.max_batch


class RenderService:
    """Owns the models and the render path; thread-safe."""

    def __init__(self, ckpt_path: str, img_wh: int = 64, n_samples: int = 64,
                 n_importance: int = 64, near: float = 2.0, far: float = 6.0,
                 camera_angle_x: float = 0.8, white_back: bool = True,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 compute_dtype: str = "auto",
                 max_rays_per_dispatch: int = 1 << 20, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.models = load_models(ckpt_path, self.device)
        if "fine" not in self.models and n_importance > 0:
            print("[serve] checkpoint has no fine model — serving coarse-only")
            n_importance = 0
        self.img_wh = img_wh
        self.near, self.far = near, far
        self.camera_angle_x = camera_angle_x
        self._img_key = "rgb_fine" if n_importance > 0 else "rgb_coarse"
        on_cuda = self.device.type == "cuda"
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if on_cuda else "float32"
        self.rkw = dict(
            N_samples=n_samples, N_importance=n_importance, perturb=0.0,
            noise_std=0.0, white_back=white_back, test_time=True,
            use_fused=on_cuda, fused_channel_io=on_cuda,
            compute_dtype=_DTYPES[compute_dtype],
        )
        self._lock = threading.Lock()
        self.renders = 0
        self.batches = 0
        self.batch_tiers: dict = {}  # tier -> times dispatched
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_rays_per_dispatch = max_rays_per_dispatch
        self.allowed_wh = {img_wh}
        self._dispatchers: dict = {}
        self._dirs: dict = {}  # wh -> direction grid on the device

    def _dirs_for(self, wh: int) -> torch.Tensor:
        d = self._dirs.get(wh)
        if d is None:
            focal = 0.5 * 800 / np.tan(0.5 * self.camera_angle_x) * wh / 800
            d = get_ray_directions(wh, wh, focal, self.device).reshape(-1, 3)
            self._dirs[wh] = d
        return d

    def _dispatcher_for(self, wh: int) -> BatchingDispatcher:
        d = self._dispatchers.get(wh)
        if d is None:
            with self._lock:
                d = self._dispatchers.get(wh)
                if d is None:
                    d = BatchingDispatcher(
                        self, wh, self.max_batch, self.max_wait_ms,
                        max_rays=self.max_rays_per_dispatch,
                    )
                    self._dispatchers[wh] = d
        return d

    def warm(self):
        """Render every (allowed size, batch tier) once before serving, so
        the kernels are built and loaded before the first request."""
        for wh in sorted(self.allowed_wh):
            disp = self._dispatcher_for(wh)
            c2w = self._c2w_for([0.0, 0.5, 4.0], (0.0, 0.0, 0.0))
            for tier in disp.tiers:
                self.render_batch([c2w] * tier, wh)
        self.renders = 0
        self.batches = 0
        self.batch_tiers = {}

    def _c2w_for(self, eye, look_at) -> np.ndarray:
        return c2w_from_lookat(
            np.asarray(eye, np.float32), np.asarray(look_at, np.float32)
        )[:3, :4].astype(np.float32)

    def render_batch(self, c2w_list, wh: int) -> list:
        """Render k same-size requests as one batch at the next tier (pad
        slots repeat the last camera) and split the images back out."""
        disp = self._dispatcher_for(wh)
        k = len(c2w_list)
        tier = disp.tier_for(k)
        c2ws = np.stack(list(c2w_list) + [c2w_list[-1]] * (tier - k))
        n = tier * wh * wh
        # chunk: as close to 32k as divides the batch evenly (no pad rays)
        chunk = -(-n // -(-n // (32 * 1024)))
        with self._lock:  # one device: batches of different sizes
            # inference mode is per thread: set here, in the caller's thread
            with torch.inference_mode():
                imgs = serve_render(
                    self.models, self._dirs_for(wh),
                    torch.from_numpy(c2ws).to(self.device), self.near,
                    self.far, chunk, self.rkw, self._img_key,
                )
                imgs = imgs.float().cpu().numpy()
            self.renders += k
            self.batches += 1
            self.batch_tiers[tier] = self.batch_tiers.get(tier, 0) + 1
        imgs = np.clip(imgs.reshape(tier, wh, wh, 3), 0, 1)
        return [imgs[i] for i in range(k)]

    def render(self, eye, look_at=(0.0, 0.0, 0.0), wh=None) -> np.ndarray:
        """One request: build the camera, enqueue it on its size's
        dispatcher, block for the image."""
        wh = wh or self.img_wh
        if wh not in self.allowed_wh:
            raise ValueError(
                f"img_wh {wh} not warmed at startup (allowed: "
                f"{sorted(self.allowed_wh)})"
            )
        return self._dispatcher_for(wh).submit(self._c2w_for(eye, look_at))


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_image(self, img: np.ndarray, fmt: str):
            if fmt == "npy":
                buf = io.BytesIO()
                np.save(buf, img.astype(np.float32))
                self._send(200, buf.getvalue(), "application/octet-stream")
                return
            png = encode_png((img * 255).astype(np.uint8))
            self._send(200, png, "image/png")

        def _render_and_send(self, eye, look_at, wh, fmt):
            try:
                img = service.render(eye, look_at, wh)
            except ValueError as e:
                self._send(400, str(e).encode(), "text/plain")
                return
            except Exception as e:  # noqa: BLE001
                self._send(500, str(e).encode(), "text/plain")
                return
            self._send_image(img, fmt)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                with service._lock:
                    tiers = dict(service.batch_tiers)
                body = json.dumps({
                    "status": "ok",
                    "renders": service.renders,
                    "batches": service.batches,
                    "batch_tiers": {str(k): v for k, v in sorted(tiers.items())},
                }).encode()
                self._send(200, body, "application/json")
                return
            if url.path == "/render":
                q = parse_qs(url.query)
                try:
                    theta = float(q.get("theta", ["0"])[0])
                    radius = float(q.get("radius", ["4.0"])[0])
                    height = float(q.get("height", ["0.5"])[0])
                    wh = int(q.get("img_wh", [service.img_wh])[0])
                except ValueError as e:
                    self._send(400, f"bad query param: {e}".encode(),
                               "text/plain")
                    return
                fmt = q.get("format", ["png"])[0]
                eye = [radius * np.sin(theta), height, radius * np.cos(theta)]
                self._render_and_send(eye, (0.0, 0.0, 0.0), wh, fmt)
                return
            self._send(404, b"not found", "text/plain")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/render":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                eye = req["eye"]
                look_at = req.get("look_at", [0.0, 0.0, 0.0])
                wh = int(req.get("img_wh", service.img_wh))
                fmt = req.get("format", "png")
            except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            self._render_and_send(eye, look_at, wh, fmt)

    return Handler


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def get_opts(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_path", required=True)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--img_wh", type=int, default=64)
    ap.add_argument("--extra_img_wh", type=int, nargs="*", default=None,
                    help="additional request sizes to warm and allow")
    ap.add_argument("--N_samples", type=int, default=64)
    ap.add_argument("--N_importance", type=int, default=64)
    ap.add_argument("--near", type=float, default=2.0)
    ap.add_argument("--far", type=float, default=6.0)
    ap.add_argument("--camera_angle_x", type=float, default=0.8)
    ap.add_argument("--white_back", type=lambda s: s.lower() == "true",
                    default=True)
    ap.add_argument("--max_batch", type=_positive_int, default=8,
                    help="max concurrent requests coalesced into one batch "
                         "(tiers 1,2,4,..,max_batch; must be >= 1)")
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="how long the dispatcher holds a batch open for "
                         "stragglers (sequential singles skip the wait)")
    ap.add_argument("--max_rays_per_dispatch", type=int, default=1 << 20,
                    help="cap on rays per batch: large image sizes drop "
                         "their larger tiers")
    ap.add_argument("--compute_dtype", default="auto",
                    choices=["auto", "bfloat16", "float32"],
                    help="auto = bfloat16 on cuda, float32 on cpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    return ap.parse_args(argv)


def build_server(args, warm: bool = True) -> ThreadingHTTPServer:
    service = RenderService(
        args.ckpt_path, args.img_wh, args.N_samples, args.N_importance,
        args.near, args.far, args.camera_angle_x, args.white_back,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        compute_dtype=args.compute_dtype,
        max_rays_per_dispatch=args.max_rays_per_dispatch, device=args.device,
    )
    service.allowed_wh.update(args.extra_img_wh or [])
    if warm:
        service.warm()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    server.service = service  # introspection (tests, ops tooling)
    return server


def main(argv=None):
    args = get_opts(argv)
    server = build_server(args)
    print(f"serving renders on http://{args.host}:{args.port} "
          f"({server.service.device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
