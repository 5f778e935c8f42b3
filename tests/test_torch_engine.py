"""Preprocess, postprocess, engine and response assembly: the port against
the JAX package.

- `resize_uint8` (torch antialiased bilinear on CPU uint8) against the JAX
  package's PIL resize, within 1 LSB;
- `sigmoid_topk_postprocess` against JAX, including exact score ties
  (both must order ties by the lower index, `lax.top_k`'s contract);
- `InferenceEngine.detect` against the JAX `InferenceEngine.detect` on the
  same tiny weights (numpy seed, carried across by `convert.from_jax`) and
  the same images, given at the tiny spec's 64x64 so both resizes are the
  identity: same labels, boxes within 1e-3 px, scores within 1e-4 (fp32
  forwards that agree to ~1e-5 in logits, through a sigmoid and a box
  scale of 64);
- the response assembly against the JAX detector's text and detections.
"""

import asyncio
import dataclasses
from io import BytesIO
from unittest.mock import AsyncMock

import httpx
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from spotter_tpu.engine.batcher import MicroBatcher
from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.engine.metrics import Metrics
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu.ops import postprocess as jpost
from spotter_tpu.ops.preprocess import RTDETR_SPEC as J_RTDETR_SPEC
from spotter_tpu.ops.preprocess import PreprocessSpec as JSpec
from spotter_tpu.ops.preprocess import decode_resize_uint8
from spotter_tpu.serving.detector import AmenitiesDetector
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import registry, zoo
from spotter_tpu_torch.ops import postprocess as tpost
from spotter_tpu_torch.ops.preprocess import (
    RTDETR_SPEC,
    batch_images_uint8,
    device_rescale_normalize,
    resize_uint8,
)
from spotter_tpu_torch.serving.detector import assemble_response
from tests.torch_parity import random_flax_params


def _photo(h, w, seed):
    """A smooth synthetic photo plus noise (uint8 HWC)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 17.0 + np.arange(3)) * np.cos(yy[..., None] / 23.0)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", [(480, 640), (300, 400), (800, 600), (1080, 1440), (40, 30)])
def test_resize_uint8_matches_pil_within_one_lsb(hw):
    img = _photo(*hw, seed=hw[0])
    want, valid, orig = decode_resize_uint8(Image.fromarray(img), J_RTDETR_SPEC)
    got = resize_uint8(img, RTDETR_SPEC.size)
    assert got.dtype == np.uint8 and got.shape == want.shape == (640, 640, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batch_and_device_rescale_match_jax_host_float_path():
    """uint8 batch + on-device rescale == the JAX host float preprocess."""
    from spotter_tpu.ops.preprocess import preprocess_image

    imgs = [_photo(64, 64, 1), _photo(64, 64, 2)]
    spec = JSpec(mode="fixed", size=(64, 64))
    pixels, valid, sizes = batch_images_uint8(imgs, zoo.build_rtdetr("rtdetr", tiny=True).preprocess_spec)
    got = device_rescale_normalize(torch.from_numpy(pixels), RTDETR_SPEC).numpy()
    want = np.stack([preprocess_image(Image.fromarray(a), spec)[0] for a in imgs])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(valid, [[64, 64], [64, 64]])
    np.testing.assert_array_equal(sizes, [[64, 64], [64, 64]])


@pytest.mark.parametrize("ties", [False, True])
def test_sigmoid_topk_postprocess_matches_jax(ties):
    rng = np.random.default_rng(3)
    b, q, c, k = 2, 12, 5, 17
    logits = rng.standard_normal((b, q, c)).astype(np.float32)
    if ties:  # exact ties, straddling the k-th place and inside the top-k
        logits[:, ::2, :] = 0.75
        logits[0, 3, 1] = 2.0
    boxes = rng.uniform(0.1, 0.9, (b, q, 4)).astype(np.float32)
    sizes = np.asarray([[480, 640], [1080, 1440]], np.float32)
    want = jpost.sigmoid_topk_postprocess(logits, boxes, sizes, k=k)
    got = tpost.sigmoid_topk_postprocess(
        torch.from_numpy(logits), torch.from_numpy(boxes), torch.from_numpy(sizes), k=k
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-7)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)
    # thresholding on the host is the same function on both sides
    dets_t = tpost.to_detections(got[0][0].numpy(), got[1][0].numpy(), got[2][0].numpy(),
                                 {i: f"c{i}" for i in range(c)})
    dets_j = jpost.to_detections(want[0][0], want[1][0], want[2][0],
                                 {i: f"c{i}" for i in range(c)})
    assert [d["label"] for d in dets_t] == [d["label"] for d in dets_j]


@pytest.fixture(scope="module")
def tiny_engines():
    """(JAX engine, port engine) on the same tiny RT-DETR weights."""
    cfg = jzoo.tiny_rtdetr_config()
    jmodule = JRTDetr(cfg)
    params = random_flax_params(jmodule, np.zeros((1, 64, 64, 3), np.float32), seed=11)
    jbuilt = JBuilt(
        model_name="PekingU/rtdetr_v2_r101vd", module=jmodule, params=params,
        preprocess_spec=JSpec(mode="fixed", size=(64, 64)), postprocess="sigmoid_topk",
        id2label=cfg.id2label_dict, num_top_queries=min(300, cfg.num_queries),
    )
    jeng = JEngine(jbuilt, batch_buckets=(4,))
    tbuilt = registry.build_detector("PekingU/rtdetr_v2_r101vd", tiny=True, params=params)
    teng = InferenceEngine(tbuilt, device="cpu")
    return jeng, teng


def test_engine_detect_matches_jax(tiny_engines):
    jeng, teng = tiny_engines
    imgs = [_photo(64, 64, s) for s in (20, 21, 22)]
    want = jeng.detect([Image.fromarray(a) for a in imgs])
    got = teng.detect(imgs)
    assert len(got) == len(want) == 3
    assert sum(len(d) for d in got) > 0
    for g_img, w_img in zip(got, want):
        assert [d["label"] for d in g_img] == [d["label"] for d in w_img]
        np.testing.assert_allclose(
            [d["score"] for d in g_img], [d["score"] for d in w_img], atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in g_img]).reshape(-1, 4),
            np.asarray([d["box"] for d in w_img]).reshape(-1, 4), atol=1e-3,
        )


def test_engine_buckets_pad_and_chunk(tiny_engines):
    """9 images: one chunk of 8 and one of 1 padded to its bucket; each
    image's answer is the one it gets alone."""
    _, teng = tiny_engines
    assert [teng.bucket_for(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
    imgs = [_photo(64, 64, s) for s in range(30, 39)]
    batched = teng.detect(imgs)
    alone = [teng.detect([img])[0] for img in (imgs[0], imgs[8])]
    for g, w in zip((batched[0], batched[8]), alone):
        assert [d["label"] for d in g] == [d["label"] for d in w]
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w], atol=1e-5)
    teng.warmup()


def test_response_assembly_matches_jax_detector(tiny_engines):
    """Same raw detections through the JAX AmenitiesDetector (fake engine,
    mocked fetch) and the port's assembly: same text, same per-image
    amenity labels and boxes."""
    _, teng = tiny_engines
    imgs = [_photo(64, 64, s) for s in (40, 41)]
    raw = teng.detect(imgs)
    raw[1] = raw[1] + [{"label": "couch", "score": 0.9, "box": [1.0, 2.0, 30.0, 40.0]},
                       {"label": "remote", "score": 0.9, "box": [0.0, 0.0, 3.0, 3.0]}]
    urls = ["http://example.com/a.jpg", "http://example.com/b.jpg"]

    class FakeEngine:
        metrics = Metrics()
        batch_buckets = (1, 2, 4)

        def detect(self, images):
            return [raw[len(calls) - 1] for _ in images]

    calls = []
    buf = BytesIO()
    Image.fromarray(imgs[0]).save(buf, format="JPEG")

    async def fetch(url, **kwargs):
        calls.append(url)
        resp = AsyncMock()
        resp.content = buf.getvalue()
        resp.raise_for_status = lambda: None
        return resp

    engine = FakeEngine()
    client = AsyncMock(spec=httpx.AsyncClient)
    client.get.side_effect = fetch
    det = AmenitiesDetector(engine, MicroBatcher(engine, max_delay_ms=1.0), client)

    async def run():
        out = []
        for url in urls:  # one request per url keeps raw[i] paired with url i
            out.append(await det.detect({"image_urls": [url]}))
        return out

    jresps = asyncio.run(run())
    got = assemble_response(urls, raw)
    for img, jresp in zip(got["images"], jresps):
        (jimg,) = jresp.images
        assert img["url"] == jimg.url
        assert [(d["label"], d["box"]) for d in img["detections"]] == [
            (d.label, d.box) for d in jimg.detections
        ]
    jtext = asyncio.run(det.detect({"image_urls": []})).amenities_description
    assert jtext == assemble_response([], [])["amenities_description"]
    labels = sorted({d.label for r in jresps for d in r.images[0].detections})
    assert "sofa" in labels
    assert got["amenities_description"] == f"The property contains: {', '.join(labels)}."


def test_engine_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = zoo.build_rtdetr("PekingU/rtdetr_v2_r101vd", tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(built)
    with pytest.raises(RuntimeError, match="not available"):
        InferenceEngine(built, device="cuda")


def test_registry_resolves_model_names():
    assert registry.family_for("PekingU/rtdetr_v2_r101vd").name == "rtdetr"
    cfg = zoo.rtdetr_preset("PekingU/rtdetr_v2_r101vd")
    assert cfg.backbone.depths == (3, 4, 23, 3) and cfg.encoder_hidden_dim == 384
    assert cfg.id2label_dict[62] == "tv"
    with pytest.raises(ValueError):
        registry.family_for("facebook/unknown-model")
    with pytest.raises(ValueError):
        zoo.rtdetr_preset("PekingU/rtdetr_r9000")
