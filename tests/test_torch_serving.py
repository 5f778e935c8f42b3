"""The port's replica (`spotter_tpu_torch.serving.standalone.make_app`)
against the JAX package's (`spotter_tpu.serving.standalone.make_app`).

Both are built on the tiny RT-DETR with the same weights (flax params from
a numpy seed, carried across by `convert.from_jax`) and driven by aiohttp
test clients; the images come from a local aiohttp static route. They are
64x64 PNGs, the tiny spec's size, so both resizes are the identity and both
decodes are lossless. Held: the same `amenities_description`, the same
per-image labels in the same order, boxes within 1e-3 px (fp32 forwards
that agree to ~1e-5 in logits, through a box scale of 64: the tolerance of
tests/test_torch_engine.py), and the same per-image error string for a 404
URL. Also: `labeled_image_base64` decodes to the source size, `/drain` then
`/detect` answers 503, and concurrent requests get the detections that
sequential ones get.

The same holds for the tiny YOLOS (MODEL_NAME=hustvl/yolos-base), on 48x32
PNGs (its 32x48 spec) and the softmax postprocess; and the port's replica
brings the tiny YOLOS up by name on the CPU and answers /detect.

Then the port's serving parts alone: the engine fault classification
(CUDA fatal markers exit 85 and are never bisect-retried; out of memory
splits the chunk and retries), the HTTP status mapping, and the device
rule (cuda unless the caller asks for the CPU).
"""

import asyncio
import base64
import os
from io import BytesIO

import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu.models.yolos import YolosDetector as JYolos
from spotter_tpu.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from spotter_tpu.ops.preprocess import PreprocessSpec as JSpec
from spotter_tpu.serving import standalone as jstandalone
from spotter_tpu.serving.detector import AmenitiesDetector as JDetector
from spotter_tpu_torch.engine import errors
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.serving import app as tapp
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from tests.torch_parity import random_flax_params

MODEL = "PekingU/rtdetr_v2_r101vd"
BOX_ATOL = 1e-3  # px


def _photo(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 9.0 + np.arange(3)) * np.cos(yy[..., None] / 13.0)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    for i in range(6):
        Image.fromarray(_photo(100 + i)).save(root / f"p{i}.png")
    return root


@pytest.fixture(scope="module")
def weights():
    cfg = jzoo.tiny_rtdetr_config()
    module = JRTDetr(cfg)
    return cfg, module, random_flax_params(module, np.zeros((1, 64, 64, 3), np.float32), seed=21)


def _jax_detector(weights):
    cfg, module, params = weights
    built = JBuilt(
        model_name=MODEL, module=module, params=params,
        preprocess_spec=JSpec(mode="fixed", size=(64, 64)), postprocess="sigmoid_topk",
        id2label=cfg.id2label_dict, num_top_queries=min(300, cfg.num_queries),
    )
    return JDetector(JEngine(built, batch_buckets=(1, 2, 4)), cache=None)


def _port_detector(weights, max_delay_ms=20.0):
    _, _, params = weights
    built = registry.build_detector(MODEL, tiny=True, params=params)
    engine = InferenceEngine(built, batch_buckets=(1, 2, 4), device="cpu")
    return AmenitiesDetector(engine, MicroBatcher(engine, max_delay_ms=max_delay_ms))


async def _with_clients(image_dir, apps, body):
    """Run `body(image_url, clients)` with an image server and a test client
    per app."""
    static = web.Application()
    static.router.add_static("/img", str(image_dir))
    async with TestServer(static) as img_server:
        clients = [TestClient(TestServer(a)) for a in apps]
        for c in clients:
            await c.start_server()
        try:
            return await body(lambda name: str(img_server.make_url(f"/img/{name}")), clients)
        finally:
            for c in clients:
                await c.close()


@pytest.fixture(scope="module")
def both_responses(weights, image_dir):
    """Each side's /detect JSON for one request of 4 images and a 404,
    then for /drain followed by /detect."""
    os.environ.pop("SPOTTER_TPU_ADMIN_TOKEN", None)
    apps = [
        jstandalone.make_app(detector=_jax_detector(weights)),
        tstandalone.make_app(detector=_port_detector(weights)),
    ]

    async def body(url, clients):
        urls = [url(f"p{i}.png") for i in range(4)] + [url("missing.png")]
        out = []
        for c in clients:
            resp = await c.post("/detect", json={"image_urls": urls})
            assert resp.status == 200, await resp.text()
            detect = await resp.json()
            drain = await c.post("/drain")
            after = await c.post("/detect", json={"image_urls": urls[:1]})
            health = await c.get("/healthz")
            out.append((detect, drain.status, after.status, health.status))
        return out

    return asyncio.run(_with_clients(image_dir, apps, body))


def test_detect_json_matches_jax(both_responses):
    (jresp, *_), (tresp, *_) = both_responses
    assert tresp["amenities_description"] == jresp["amenities_description"]
    assert len(tresp["images"]) == len(jresp["images"]) == 5
    n_dets = 0
    for t_img, j_img in zip(tresp["images"][:4], jresp["images"][:4]):
        assert t_img["url"] == j_img["url"]
        assert [d["label"] for d in t_img["detections"]] == [d["label"] for d in j_img["detections"]]
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in t_img["detections"]]).reshape(-1, 4),
            np.asarray([d["box"] for d in j_img["detections"]]).reshape(-1, 4), atol=BOX_ATOL,
        )
        n_dets += len(t_img["detections"])
    assert n_dets > 0, "the tiny model kept no amenity: nothing was compared"
    assert set(tresp) == set(jresp) == {"amenities_description", "images"}


def test_404_error_string_matches_jax(both_responses):
    (jresp, *_), (tresp, *_) = both_responses
    t_err, j_err = tresp["images"][4], jresp["images"][4]
    assert set(t_err) == set(j_err) == {"url", "error"}
    assert t_err["error"] == j_err["error"]
    assert t_err["error"].startswith("HTTP Error: Client error '404 Not Found'")


def test_labeled_image_decodes_to_source_size(both_responses):
    for resp, *_ in both_responses:
        for img in resp["images"][:4]:
            decoded = Image.open(BytesIO(base64.b64decode(img["labeled_image_base64"])))
            assert decoded.format == "JPEG" and decoded.size == (64, 64)


def test_drain_then_detect_is_503_on_both(both_responses):
    for _, drain_status, detect_status, health_status in both_responses:
        assert (drain_status, detect_status, health_status) == (200, 503, 503)


def test_concurrent_requests_match_sequential(weights, image_dir):
    det = _port_detector(weights, max_delay_ms=250.0)  # a window wide enough to coalesce
    app = tstandalone.make_app(detector=det)

    async def body(url, clients):
        (client,) = clients
        reqs = [[url(f"p{i}.png"), url(f"p{i + 1}.png")] for i in range(4)]
        sequential = [await (await client.post("/detect", json={"image_urls": r})).json()
                      for r in reqs]
        batches_before = det.engine.metrics.snapshot()["batches_total"]
        resps = await asyncio.gather(*(client.post("/detect", json={"image_urls": r})
                                       for r in reqs))
        concurrent = [await r.json() for r in resps]
        batches = det.engine.metrics.snapshot()["batches_total"] - batches_before
        return sequential, concurrent, batches

    sequential, concurrent, batches = asyncio.run(_with_clients(image_dir, [app], body))
    assert batches < 8, "concurrent images were not batched together"
    for s_resp, c_resp in zip(sequential, concurrent):
        assert s_resp["amenities_description"] == c_resp["amenities_description"]
        for s_img, c_img in zip(s_resp["images"], c_resp["images"]):
            assert [d["label"] for d in s_img["detections"]] == [
                d["label"] for d in c_img["detections"]]
            np.testing.assert_allclose(
                np.asarray([d["box"] for d in s_img["detections"]]).reshape(-1, 4),
                np.asarray([d["box"] for d in c_img["detections"]]).reshape(-1, 4),
                atol=BOX_ATOL,
            )


def test_bad_requests_answer_400(weights):
    app = tstandalone.make_app(detector=_port_detector(weights))

    async def body(_, clients):
        (client,) = clients
        not_json = await client.post("/detect", data=b"{", headers={"Content-Type": "application/json"})
        bad_url = await client.post("/detect", json={"image_urls": ["data:image/png;base64,AA"]})
        queries = await client.post(
            "/detect", json={"image_urls": ["http://127.0.0.1/x.png"], "queries": ["a sofa"]}
        )
        return not_json.status, bad_url.status, queries.status

    assert asyncio.run(_with_clients(".", [app], body)) == (400, 400, 400)


# --- YOLOS ----------------------------------------------------------------

YOLOS = "hustvl/yolos-base"


@pytest.fixture(scope="module")
def yolos_image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolos_images")
    for i in range(4):
        Image.fromarray(_photo(200 + i, h=32, w=48)).save(root / f"p{i}.png")
    return root


@pytest.fixture(scope="module")
def yolos_weights():
    cfg = jzoo.tiny_yolos_config()
    module = JYolos(cfg)
    params = random_flax_params(module, np.zeros((1, 32, 48, 3), np.float32), seed=33)
    head = params["class_labels_classifier"]["layer2"]
    head["kernel"] = head["kernel"] * 10.0  # a peaked softmax: scores pass the 0.5 threshold
    return cfg, module, params


def test_yolos_detect_json_matches_jax(yolos_weights, yolos_image_dir):
    cfg, module, params = yolos_weights
    jbuilt = JBuilt(
        model_name=YOLOS, module=module, params=params,
        preprocess_spec=JSpec(mode="fixed", size=(32, 48), mean=IMAGENET_MEAN, std=IMAGENET_STD),
        postprocess="softmax", id2label=cfg.id2label_dict,
        num_top_queries=cfg.num_detection_tokens,
    )
    jdet = JDetector(JEngine(jbuilt, batch_buckets=(1, 2, 4)), cache=None)
    engine = InferenceEngine(registry.build_detector(YOLOS, tiny=True, params=params),
                             batch_buckets=(1, 2, 4), device="cpu")
    tdet = AmenitiesDetector(engine, MicroBatcher(engine, max_delay_ms=20.0))
    apps = [jstandalone.make_app(detector=jdet), tstandalone.make_app(detector=tdet)]

    async def body(url, clients):
        urls = [url(f"p{i}.png") for i in range(4)]
        out = []
        for c in clients:
            resp = await c.post("/detect", json={"image_urls": urls})
            assert resp.status == 200, await resp.text()
            out.append(await resp.json())
        return out

    jresp, tresp = asyncio.run(_with_clients(yolos_image_dir, apps, body))
    assert tresp["amenities_description"] == jresp["amenities_description"]
    n_dets = 0
    for t_img, j_img in zip(tresp["images"], jresp["images"], strict=True):
        assert t_img["url"] == j_img["url"]
        assert [d["label"] for d in t_img["detections"]] == [d["label"] for d in j_img["detections"]]
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in t_img["detections"]]).reshape(-1, 4),
            np.asarray([d["box"] for d in j_img["detections"]]).reshape(-1, 4), atol=BOX_ATOL,
        )
        decoded = Image.open(BytesIO(base64.b64decode(t_img["labeled_image_base64"])))
        assert decoded.size == (48, 32)
        n_dets += len(t_img["detections"])
    assert n_dets > 0, "the tiny YOLOS kept no amenity: nothing was compared"


def test_standalone_brings_up_tiny_yolos_by_name(monkeypatch, yolos_image_dir):
    """MODEL_NAME=hustvl/yolos-base SPOTTER_TPU_TINY=1 ... --device cpu: the
    replica's own bring-up builds the tiny YOLOS and answers /detect."""
    monkeypatch.setenv("SPOTTER_TPU_TINY", "1")
    monkeypatch.delenv("SPOTTER_TPU_ADMIN_TOKEN", raising=False)
    exits = []
    app = tstandalone.make_app(model_name=YOLOS, device="cpu", bringup_exit_cb=exits.append)

    async def body(url, clients):
        (client,) = clients
        for _ in range(600):
            if (await client.get("/startupz")).status == 200 or exits:
                break
            await asyncio.sleep(0.1)
        resp = await client.post("/detect", json={"image_urls": [url("p0.png"), url("p1.png")]})
        metrics = await (await client.get("/metrics")).json()
        return resp.status, await resp.json(), metrics

    status, resp, metrics = asyncio.run(_with_clients(yolos_image_dir, [app], body))
    assert exits == [] and status == 200
    assert [img["url"].rsplit("/", 1)[1] for img in resp["images"]] == ["p0.png", "p1.png"]
    assert all("detections" in img for img in resp["images"])
    assert metrics["replica"]["model"] == YOLOS


# --- engine fault classification ------------------------------------------

CUDA_FATAL_MESSAGES = (
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: unspecified launch failure",
    "CUDA error: uncorrectable ECC error encountered",
)


@pytest.mark.parametrize("message", CUDA_FATAL_MESSAGES)
def test_cuda_fatal_markers_classify_fatal(message):
    assert errors.classify_engine_exception(RuntimeError(message)) is errors.FatalEngineError
    typed = errors.as_typed(RuntimeError(message))
    assert isinstance(typed, errors.FatalEngineError)


def test_out_of_memory_classifies_transient():
    exc = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert errors.classify_engine_exception(exc) is errors.TransientEngineError
    assert errors.classify_engine_exception(RuntimeError("shape mismatch")) is None


class _FailingForward:
    """Wraps an engine's `_forward`, raising `message` on the calls listed."""

    def __init__(self, engine, message, fail_calls):
        self.engine, self.message, self.fail_calls = engine, message, set(fail_calls)
        self.real = engine._forward
        self.batch_sizes = []

    def __call__(self, pixels, sizes):
        self.batch_sizes.append(pixels.shape[0])
        if len(self.batch_sizes) in self.fail_calls:
            raise RuntimeError(self.message)
        return self.real(pixels, sizes)


def test_out_of_memory_splits_the_chunk_and_retries(weights):
    engine = _port_detector(weights).engine
    imgs = [_photo(s) for s in range(3)]
    want = engine.detect(imgs)
    fwd = engine._forward = _FailingForward(engine, "CUDA out of memory.", {1})
    got = engine.detect(imgs)
    assert fwd.batch_sizes == [4, 2, 1]  # the bucket of 3, then halves of 2 and 1
    assert [[d["label"] for d in g] for g in got] == [[d["label"] for d in w] for w in want]
    assert engine.metrics.snapshot()["batch_retries_total"] == 1
    engine._forward = _FailingForward(engine, "CUDA out of memory.", {1, 2})
    with pytest.raises(errors.TransientEngineError):
        engine.detect(imgs)


@pytest.mark.parametrize("message", CUDA_FATAL_MESSAGES)
def test_fatal_error_exits_85_without_bisect(weights, message):
    det = _port_detector(weights)
    engine = det.engine
    fwd = engine._forward = _FailingForward(engine, message, {1, 2, 3, 4, 5, 6})
    exits = []
    det.batcher.fatal_exit_cb = exits.append

    async def run():
        img = Image.fromarray(_photo(1))
        return await asyncio.gather(
            *(det.batcher.submit(img) for _ in range(3)), return_exceptions=True
        )

    outcomes = asyncio.run(run())
    assert all(isinstance(o, errors.FatalEngineError) for o in outcomes), outcomes
    assert exits == [errors.FATAL_ENGINE_EXIT_CODE] == [85]
    assert len(fwd.batch_sizes) == 1, "a fatal error was retried"
    snap = engine.metrics.snapshot()
    assert snap["fatal_engine_errors_total"] == 1 and snap["batch_retries_total"] == 0


def test_plain_error_is_bisected_to_the_poisoned_image(weights):
    det = _port_detector(weights)
    engine = det.engine
    real = engine.detect

    def detect(images, **kw):
        if any(getattr(im, "info", {}).get("poison") for im in images):
            raise ValueError("bad pixels")
        return real(images, **kw)

    engine.detect = detect

    async def run():
        imgs = [Image.fromarray(_photo(s)) for s in range(4)]
        imgs[2].info["poison"] = True
        return await asyncio.gather(*(det.batcher.submit(i) for i in imgs),
                                    return_exceptions=True)

    outcomes = asyncio.run(run())
    assert isinstance(outcomes[2], errors.PoisonImageError)
    assert all(isinstance(o, list) for i, o in enumerate(outcomes) if i != 2)


def test_build_detector_app_device_rule(monkeypatch):
    monkeypatch.delenv("MODEL_NAME", raising=False)
    with pytest.raises(ValueError, match="MODEL_NAME"):
        tapp.build_detector_app()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.build_detector_app(MODEL, tiny=True)
    det = tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1, 2))
    assert det.engine.device.type == "cpu" and det.engine.batch_buckets == (1, 2)
    assert tapp.parse_batch_buckets("1,4") == (1, 4)
    with pytest.raises(ValueError):
        tapp.parse_batch_buckets("4,1")
