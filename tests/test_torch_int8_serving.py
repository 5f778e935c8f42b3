"""int8 quantization through the port's serving path, on the CPU at the
tiny width (no JAX needed): the engine and the replica's POST /detect
(`build_detector_app`) with SPOTTER_TPU_INT8 on (a checkpoint loaded under
int8 is in tests/test_torch_loader.py).

The floors are lowered (INT8_MIN_CH 8, INT8_ATTN_MIN_HD 4, INT8_MIN_BATCH
1) so the tiny models' layers quantize at every batch.
"""

import asyncio
import io

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.serving import app as tapp
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.utils import quant as tquant

RTDETR = "PekingU/rtdetr_v2_r101vd"


@pytest.fixture
def int8_on(monkeypatch):
    monkeypatch.setattr(tquant, "INT8", True)
    monkeypatch.setattr(tquant, "INT8_DENSE", True)
    monkeypatch.setattr(tquant, "INT8_ATTN", True)
    monkeypatch.setattr(tquant, "INT8_MIN_CH", 8)
    monkeypatch.setattr(tquant, "INT8_MIN_BATCH", 1)
    monkeypatch.setattr(tquant, "INT8_ATTN_MIN_HD", 4)


def _photos(n, seed=0):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (40 + 8 * i, 56, 3), dtype=np.uint8))
            for i in range(n)]


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_engine_detects_under_int8(monkeypatch, int8_on, policy):
    """The engine's forward quantizes (every product kind on RT-DETR) and
    answers each photo."""
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    built = registry.build_detector(RTDETR, tiny=True, seed=0)
    engine = InferenceEngine(built, device="cpu", batch_buckets=(1, 2, 4))
    tquant.reset_calls()
    dets = engine.detect(_photos(3))
    assert len(dets) == 3 and all(isinstance(d, list) for d in dets)
    assert all(tquant.CALLS[k] > 0 for k in ("conv", "dense", "qk", "av")), tquant.CALLS


def test_detect_over_http_under_int8(monkeypatch, int8_on):
    """The replica's app (build_detector_app) answers POST /detect with the
    reference schema while its forwards quantize."""
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "bfloat16")
    det = tapp.build_detector_app(RTDETR, tiny=True, device="cpu", batch_buckets=(1, 2, 4))
    blobs = {}
    for i, img in enumerate(_photos(2)):
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        blobs[f"p{i}.png"] = buf.getvalue()

    async def serve_image(request):
        return web.Response(body=blobs[request.match_info["name"]], content_type="image/png")

    async def run():
        static = web.Application()
        static.router.add_get("/img/{name}", serve_image)
        async with TestServer(static) as img_server:
            client = TestClient(TestServer(tstandalone.make_app(detector=det,
                                                                fatal_exit_cb=None)))
            await client.start_server()
            try:
                urls = [str(img_server.make_url(f"/img/{n}")) for n in blobs]
                tquant.reset_calls()
                resp = await client.post("/detect", json={"image_urls": urls})
                return resp.status, await resp.json(), dict(tquant.CALLS), urls
            finally:
                await client.close()

    status, body, calls, urls = asyncio.run(run())
    assert status == 200, body
    assert [r["url"] for r in body["images"]] == urls
    assert all("detections" in r for r in body["images"])
    assert calls["conv"] > 0 and calls["dense"] > 0
