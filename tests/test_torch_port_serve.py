"""The port's render server (``nerf_pl_tpu_torch.tools.serve``) on the CPU:
real HTTP requests against a live server thread, the ``--max_batch`` guard
and the standard-library PNG encoder.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_pl_tpu_torch.models.nerf import init_nerf
from nerf_pl_tpu_torch.tools.serve import (BatchingDispatcher, RenderService,
                                           build_server, encode_png, get_opts)
from nerf_pl_tpu_torch.training.checkpoints import save_checkpoint


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("port_serve") / "m.ckpt")
    models = {name: init_nerf(torch.Generator().manual_seed(seed), device="cpu")
              for seed, name in enumerate(("coarse", "fine"))}
    save_checkpoint(path, {"params": models})
    return path


@pytest.fixture(scope="module")
def server(ckpt):
    args = get_opts(["--ckpt_path", ckpt, "--port", "0", "--img_wh", "8",
                     "--N_samples", "4", "--N_importance", "4", "--max_batch", "8",
                     "--max_wait_ms", "200", "--device", "cpu"])
    srv = build_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv.service
    srv.shutdown()
    srv.server_close()


def _post(url, body):
    req = urllib.request.Request(f"{url}/render", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    return urllib.request.urlopen(req, timeout=120)


def test_service_defaults_on_cpu(server):
    _, svc = server
    assert svc.device == torch.device("cpu")
    assert svc.rkw["compute_dtype"] == torch.float32  # auto on the CPU
    assert svc.rkw["use_fused"] is False
    assert svc.batches == 0 and svc.renders == 0  # warm() resets the counters


def test_healthz_get_png_and_post_npy(server):
    url, _ = server
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(f"{url}/render?theta=0.5&radius=4", timeout=120) as r:
        assert r.headers["Content-Type"] == "image/png"
        img = Image.open(io.BytesIO(r.read()))
        img.load()
    assert img.size == (8, 8) and img.mode == "RGB"
    with _post(url, {"eye": [4, 1, 0], "format": "npy"}) as r:
        arr = np.load(io.BytesIO(r.read()))
    assert arr.shape == (8, 8, 3) and arr.dtype == np.float32
    assert np.isfinite(arr).all() and (arr >= 0).all() and (arr <= 1).all()


def test_bad_requests(server):
    url, _ = server
    for call, code, text in (
            (lambda: _post(url, {}), 400, b"bad request"),
            (lambda: urllib.request.urlopen(f"{url}/nope", timeout=60), 404, b"not found"),
            (lambda: urllib.request.urlopen(f"{url}/render?theta=abc", timeout=60), 400,
             b"bad query param"),
            (lambda: urllib.request.urlopen(f"{url}/render?img_wh=33", timeout=60), 400,
             b"not warmed")):
        with pytest.raises(urllib.error.HTTPError) as e:
            call()
        assert e.value.code == code and text in e.value.read()


def test_concurrent_requests_coalesce_into_one_tier(server):
    url, svc = server
    r0, b0 = svc.renders, svc.batches
    results, errors = [], []
    svc._dispatcher_for(8)._last_batch = 2  # past the sequential fast path

    def one(i):
        try:
            with _post(url, {"eye": [4 * np.sin(i), 1, 4 * np.cos(i)],
                             "format": "npy"}) as r:
                results.append(np.load(io.BytesIO(r.read())))
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and len(results) == 4
    assert svc.renders - r0 == 4
    assert svc.batches - b0 == 1  # four requests inside the window: one tier
    assert svc.batch_tiers.get(4) == 1
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        assert json.loads(r.read())["batch_tiers"]["4"] == 1


def test_batched_render_matches_single(server):
    _, svc = server
    cams = [svc._c2w_for(eye, (0.0, 0.0, 0.0)) for eye in ([4, 1, 0], [0, 1, 4], [-3, 0.5, 2])]
    batched = svc.render_batch(cams, 8)  # 3 requests at tier 4: one pad slot
    for b, cam in zip(batched, cams):
        np.testing.assert_allclose(b, svc.render_batch([cam], 8)[0], atol=1e-6)


@pytest.mark.parametrize("max_batch", ["0", "-2"])
def test_max_batch_below_one_is_rejected(ckpt, max_batch):
    with pytest.raises(SystemExit):
        get_opts(["--ckpt_path", ckpt, "--max_batch", max_batch])
    with pytest.raises(ValueError, match="max_batch"):
        RenderService(ckpt, max_batch=int(max_batch), device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        BatchingDispatcher(object(), 8, int(max_batch), 1.0)


def test_tier_ladder_and_ray_cap():
    assert BatchingDispatcher(object(), 800, 16, 1.0).tiers == [1]
    assert BatchingDispatcher(object(), 400, 16, 1.0).tiers == [1, 2, 4]
    assert BatchingDispatcher(object(), 100, 12, 1.0).tiers == [1, 2, 4, 8, 12]
    assert BatchingDispatcher(object(), 8, 1, 1.0).tiers == [1]


def test_encode_png_decodes_with_pil():
    img = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    back = np.asarray(Image.open(io.BytesIO(encode_png(img))).convert("RGB"))
    np.testing.assert_array_equal(back, img)


def test_device_defaults_to_cuda(ckpt, monkeypatch):
    assert get_opts(["--ckpt_path", ckpt]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RenderService(ckpt)
