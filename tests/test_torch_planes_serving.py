"""The replica planes as a whole: the port's replica
(`spotter_tpu_torch.serving.standalone.make_app`) against the JAX
package's, both with the result cache, tenancy and binary frames on.

Both replicas run the tiny RT-DETR with the same weights (flax params from
a numpy seed, carried across by `convert.from_jax`, as in
tests/test_torch_serving.py) at one bucket, behind a local static route
that counts its fetches. One request script goes to each: a miss, a hit,
a mixed request, a frame, a 404 twice (the negative verdict, then the
negative hit), a hobby tenant over its burst, and concurrent requests for
one new photo. Held: the same statuses, `X-Cache` and `X-Spotter-Negative`
values and presence of `Retry-After`; the same per-image labels, boxes
within 1e-3 px; frame-decoded bodies equal to the replica's own JSON and
holding the same detections across the packages; a 429 before any fetch;
one fetch and one forward for the concurrent requests.

Also: with the knobs unset the port's /detect carries no cache header and
its body is byte-identical to the cache-on replica's miss; a tenant's slot
is released when the client disconnects and when the handler fails, and a
503 before READY charges no tenant; the
golden probe still runs a forward with the cache full of its own bytes; a
stub replica of each package (SPOTTER_TPU_STUB_ENGINE=1) passes its gate
and answers alike; the Ray Serve adapter, held with a fake `ray` as
tests/test_ray_adapter.py holds the JAX package's.
"""

import asyncio
import importlib
import json
import sys
import threading

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from spotter_tpu.caching.result_cache import ResultCache as JCache
from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu.ops.preprocess import PreprocessSpec as JSpec
from spotter_tpu.serving import standalone as jstandalone
from spotter_tpu.serving import wire as jwire
from spotter_tpu.serving.detector import AmenitiesDetector as JDetector
from spotter_tpu.testing import faults as jfaults
from spotter_tpu_torch.caching.result_cache import ResultCache
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.serving import integrity
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.serving import wire
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from spotter_tpu_torch.testing import faults
from tests.test_ray_adapter import FAKE_MODULE_NAMES, FakeBound, _make_fake_modules
from tests.torch_parity import random_flax_params

MODEL = "PekingU/rtdetr_v2_r101vd"
BOX_ATOL = 1e-3  # px, the tolerance of tests/test_torch_serving.py
TENANTS = json.dumps({"default": {"rps": 1000, "burst": 1000},
                      "tenants": {"hobby": {"rps": 0.01, "burst": 2}}})
ACME = {"X-API-Key": "key-acme"}
HOBBY = {"X-API-Key": "key-hobby"}
FRAME = {"Accept": wire.FRAME_CONTENT_TYPE}
PLANE_ENVS = ("SPOTTER_TPU_TENANT_CONFIG", "SPOTTER_TPU_TENANT_KEYS",
              "SPOTTER_TPU_TENANT_RPS_DEFAULT", "SPOTTER_TPU_CACHE_MAX_MB",
              "SPOTTER_TPU_STUB_ENGINE", "SPOTTER_TPU_FAULTS", "SPOTTER_TPU_ADMIN_TOKEN")


def _photo(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 9.0 + np.arange(3)) * np.cos(yy[..., None] / 13.0)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for env in PLANE_ENVS:
        monkeypatch.delenv(env, raising=False)
    yield monkeypatch
    faults._active = None
    jfaults._active = None


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    for i in range(8):
        Image.fromarray(_photo(100 + i)).save(root / f"p{i}.png")
    Image.fromarray(np.asarray(integrity.probe_image(MODEL))).save(root / "probe.png")
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
    engine = JEngine(built, batch_buckets=(4,))
    return JDetector(engine, cache=JCache(max_bytes=1 << 22, metrics=engine.metrics))


def _port_detector(weights, cache=True):
    _, _, params = weights
    built = registry.build_detector(MODEL, tiny=True, params=params)
    engine = InferenceEngine(built, batch_buckets=(4,), device="cpu")
    return AmenitiesDetector(
        engine, MicroBatcher(engine, max_delay_ms=20.0),
        cache=ResultCache(max_bytes=1 << 22, metrics=engine.metrics) if cache else None)


def _tenant_env(monkeypatch, tmp_path):
    keys = tmp_path / "keys.json"
    keys.write_text(json.dumps({"key-acme": "acme", "key-hobby": "hobby"}))
    monkeypatch.setenv("SPOTTER_TPU_TENANT_CONFIG", TENANTS)
    monkeypatch.setenv("SPOTTER_TPU_TENANT_KEYS", str(keys))


async def _with_static(image_dir, body, slow_s: float = 0.0):
    """Run `body(url_of, fetches)` behind a static route that counts each
    path's fetches (and can delay them)."""
    fetches: dict = {}

    @web.middleware
    async def count(request, handler):
        fetches[request.path] = fetches.get(request.path, 0) + 1
        if slow_s:
            await asyncio.sleep(slow_s)
        return await handler(request)

    static = web.Application(middlewares=[count])
    static.router.add_static("/img", str(image_dir))
    async with TestServer(static) as server:
        return await body(lambda name: str(server.make_url(f"/img/{name}")), fetches)


def _dets(body):
    return [[(d["label"], d["box"]) for d in img.get("detections", [])] for img in body["images"]]


async def _script(client, url, fetches, engine_images):
    """The request script; one record per step."""
    out = []

    async def post(name, urls, headers=None):
        resp = await client.post("/detect", json={"image_urls": [url(u) for u in urls]},
                                 headers=headers or {})
        raw = await resp.read()
        out.append({
            "step": name, "status": resp.status,
            "x_cache": resp.headers.get(wire.X_CACHE_HEADER),
            "negative": resp.headers.get(wire.NEGATIVE_HEADER),
            "retry_after": "Retry-After" in resp.headers,
            "replica": resp.headers.get(wire.REPLICA_HEADER) is not None,
            "frame": resp.headers.get("Content-Type", "").startswith(wire.FRAME_CONTENT_TYPE),
            "raw": raw,
        })
        return out[-1]

    await post("miss", ["p0.png", "p1.png", "p2.png"], ACME)
    await post("hit", ["p0.png", "p1.png", "p2.png"], ACME)
    await post("mixed", ["p0.png", "p3.png"], ACME)
    await post("frame", ["p0.png", "p1.png"], {**ACME, **FRAME})
    await post("json_of_frame", ["p0.png", "p1.png"], ACME)
    await post("missing", ["gone.png"], ACME)
    await post("missing_again", ["gone.png"], ACME)
    for i in range(3):
        before = dict(fetches)
        rec = await post(f"hobby{i}", [f"p{4 + i}.png"], HOBBY)
        rec["fetched"] = fetches.get(f"/img/p{4 + i}.png", 0) - before.get(f"/img/p{4 + i}.png", 0)
    images_before, fetched_before = engine_images(), fetches.get("/img/p7.png", 0)
    recs = await asyncio.gather(*(client.post("/detect", json={"image_urls": [url("p7.png")]},
                                              headers=ACME) for _ in range(4)))
    out.append({"step": "concurrent", "status": sorted(r.status for r in recs),
                "x_cache": sorted(r.headers.get(wire.X_CACHE_HEADER) for r in recs),
                "bodies": [await r.read() for r in recs],
                "fetched": fetches.get("/img/p7.png", 0) - fetched_before,
                "forward_images": engine_images() - images_before})
    return out


@pytest.fixture(scope="module")
def scripted(weights, image_dir, tmp_path_factory):
    """Each package's records for the script, the port's replica metrics."""
    mp = pytest.MonkeyPatch()
    try:
        _tenant_env(mp, tmp_path_factory.mktemp("keys"))
        jdet, tdet = _jax_detector(weights), _port_detector(weights)
        apps = [jstandalone.make_app(detector=jdet), tstandalone.make_app(detector=tdet)]
        counters = [lambda: jdet.engine.metrics.snapshot()["images_total"],
                    lambda: tdet.engine.metrics.snapshot()["images_total"]]

        async def body(url, fetches):
            # one static server for both, so the URLs (in the verdicts) agree
            results = []
            for app, images in zip(apps, counters):
                async with TestClient(TestServer(app)) as client:
                    recs = await _script(client, url, fetches, images)
                    results.append((recs, await (await client.get("/metrics")).json()))
            return results

        return asyncio.run(_with_static(image_dir, body))
    finally:
        mp.undo()


def test_statuses_and_headers_match_jax(scripted):
    (jrecs, _), (trecs, _) = scripted
    keys = ("step", "status", "x_cache", "negative", "retry_after", "replica", "frame", "fetched")
    for j, t in zip(jrecs, trecs):
        assert {k: t.get(k) for k in keys} == {k: j.get(k) for k in keys}
    by = {r["step"]: r for r in trecs}
    assert [by[s]["x_cache"] for s in ("miss", "hit", "mixed", "frame", "missing_again")] == [
        "miss", "hit", "miss", "hit", "negative"]
    assert by["missing"]["x_cache"] is None and by["missing"]["negative"].startswith("u=")
    assert [by[f"hobby{i}"]["status"] for i in range(3)] == [200, 200, 429]


def test_detections_match_jax(scripted):
    (jrecs, _), (trecs, _) = scripted
    n = 0
    for j, t in zip(jrecs, trecs):
        if j["step"] in ("frame", "concurrent") or j["status"] != 200:
            continue
        jb, tb = json.loads(j["raw"]), json.loads(t["raw"])
        assert tb["amenities_description"] == jb["amenities_description"]
        for jd, td in zip(_dets(jb), _dets(tb)):
            assert [lab for lab, _ in td] == [lab for lab, _ in jd]
            np.testing.assert_allclose(np.asarray([b for _, b in td]).reshape(-1, 4),
                                       np.asarray([b for _, b in jd]).reshape(-1, 4),
                                       atol=BOX_ATOL)
            n += len(td)
        assert [i.get("error") for i in tb["images"]] == [i.get("error") for i in jb["images"]]
    assert n > 0, "the tiny model kept no amenity: nothing was compared"


def test_frames_decode_to_the_json_body(scripted):
    (jrecs, _), (trecs, _) = scripted
    frames = []
    for recs, mod in ((jrecs, jwire), (trecs, wire)):
        by = {r["step"]: r for r in recs}
        decoded = mod.decode_frame(by["frame"]["raw"])
        assert decoded == json.loads(by["json_of_frame"]["raw"])
        # the other package decodes it to the same body
        other = (wire if mod is jwire else jwire).decode_frame(by["frame"]["raw"])
        assert other == decoded
        frames.append(decoded)
        assert len(by["frame"]["raw"]) < len(by["json_of_frame"]["raw"])
    assert _dets(frames[0])[0] and [[lab for lab, _ in d] for d in _dets(frames[0])] == [
        [lab for lab, _ in d] for d in _dets(frames[1])]


def test_over_quota_429_comes_before_any_fetch_and_coalescing(scripted):
    for recs, snap in scripted:
        by = {r["step"]: r for r in recs}
        assert [by[f"hobby{i}"]["fetched"] for i in range(3)] == [1, 1, 0]
        conc = by["concurrent"]
        assert conc["status"] == [200] * 4 and conc["fetched"] == 1
        assert conc["forward_images"] == 1 and "coalesced" in conc["x_cache"]
        assert len(set(conc["bodies"])) == 1
        assert snap["tenants"]["hobby"]["sheds_rate_total"] == 1
        assert snap["coalesced_fetches_total"] == 3 and snap["coalesced_submits_total"] >= 1
    (_, jsnap), (_, tsnap) = scripted
    for key in ("cache_hits_total", "cache_misses_total", "cache_negative_hits_total",
                "coalesced_fetches_total", "coalesced_submits_total", "cache_entries",
                "wire_frame_responses_total", "wire_json_responses_total", "wire_requests_total"):
        assert tsnap[key] == jsnap[key], key


def test_knobs_unset_detect_is_byte_identical(weights, image_dir):
    plain, cached = _port_detector(weights, cache=False), _port_detector(weights)
    apps = [tstandalone.make_app(detector=plain), tstandalone.make_app(detector=cached)]
    assert apps[0]["tenancy"] is None and plain.cache is None

    async def body(url, fetches):
        out = []
        for app in apps:
            async with TestClient(TestServer(app)) as client:
                resp = await client.post("/detect", json={"image_urls": [url("p0.png"),
                                                                         url("p1.png")]})
                out.append((resp.headers.get(wire.X_CACHE_HEADER), await resp.read(),
                            (await (await client.get("/healthz")).json())["cache"]))
        return out

    (x0, raw0, cache0), (x1, raw1, cache1) = asyncio.run(_with_static(image_dir, body))
    assert x0 is None and x1 == "miss" and raw0 == raw1
    assert cache0 == {"enabled": False} and cache1["entries"] == 2


def test_tenant_slot_is_released_on_disconnect_and_on_a_handler_error(monkeypatch, tmp_path,
                                                                       weights, image_dir):
    _tenant_env(monkeypatch, tmp_path)
    det = _port_detector(weights)
    app = tstandalone.make_app(detector=det)
    plane = app["tenancy"]

    async def body(url, fetches):
        async with TestClient(TestServer(app)) as client:
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(client.post(
                    "/detect", json={"image_urls": [url("p6.png")]}, headers=ACME), 0.1)
            assert plane.inflight("acme") == 1  # held while the handler runs
            for _ in range(100):
                if plane.inflight("acme") == 0:
                    break
                await asyncio.sleep(0.02)
            released = plane.inflight("acme")

            def boom(*a, **kw):
                raise RuntimeError("injected check_admission bug")

            det.check_admission = boom
            statuses = [(await client.post("/detect", json={"image_urls": [url("p6.png")]},
                                           headers=ACME)).status for _ in range(2)]
            return released, statuses, plane.inflight("acme")

    released, statuses, after = asyncio.run(_with_static(image_dir, body, slow_s=0.5))
    assert released == 0 and statuses == [500, 500] and after == 0


def test_probe_runs_a_forward_with_the_cache_full_of_its_bytes(monkeypatch, image_dir):
    """Bring-up through make_app (the gate pins the probe), then a user
    /detect of the probe image's own bytes fills the cache; the loop's probe
    and a second gate each still run a forward."""
    monkeypatch.setenv("SPOTTER_TPU_TINY", "1")
    monkeypatch.setenv("SPOTTER_TPU_BATCH_BUCKETS", "1,2")
    monkeypatch.setenv("SPOTTER_TPU_CACHE_MAX_MB", "16")
    exits = []
    app = tstandalone.make_app(model_name=MODEL, device="cpu", bringup_exit_cb=exits.append,
                               integrity_exit_cb=exits.append)

    async def body(url, fetches):
        async with TestClient(TestServer(app)) as client:
            for _ in range(600):
                if (await (await client.get("/startupz")).json())["state"] in ("ready", "failed"):
                    break
                await asyncio.sleep(0.05)
            det, plane = app["detector"], app["integrity"]
            await plane.aclose()
            images = lambda: det.engine.metrics.snapshot()["images_total"]  # noqa: E731
            for expect in ("miss", "hit"):
                resp = await client.post("/detect", json={"image_urls": [url("probe.png")]})
                assert resp.status == 200 and resp.headers[wire.X_CACHE_HEADER] == expect
            before = images()
            assert await plane.probe.run(det.batcher) is None
            after_probe = images()
            assert await plane.verify("cold-start")
            return before, after_probe, images(), det.cache.stats()["entries"]

    before, after_probe, after_gate, entries = asyncio.run(_with_static(image_dir, body))
    assert not exits and entries == 1
    assert after_probe == before + 1 and after_gate == after_probe + 1 + 2


def test_stub_replicas_answer_alike_and_pass_their_gates(monkeypatch):
    monkeypatch.setenv("SPOTTER_TPU_STUB_ENGINE", "1")
    monkeypatch.setenv("SPOTTER_TPU_CACHE_MAX_MB", "8")
    urls = [f"http://cdn.example/listing/{i}.jpg" for i in range(5)]

    async def run(make_app, **kw):
        exits = []
        app = make_app(bringup_exit_cb=exits.append, integrity_exit_cb=exits.append, **kw)
        async with TestClient(TestServer(app)) as client:
            for _ in range(400):
                state = (await (await client.get("/startupz")).json())["state"]
                if state in ("ready", "failed"):
                    break
                await asyncio.sleep(0.02)
            bodies = []
            for _ in range(2):
                resp = await client.post("/detect", json={"image_urls": urls})
                bodies.append((resp.status, resp.headers.get(wire.X_CACHE_HEADER),
                               await resp.json()))
            return state, exits, bodies, type(app["detector"].engine).__name__

    jax = asyncio.run(run(jstandalone.make_app))
    port = asyncio.run(run(tstandalone.make_app, device="cpu"))
    assert port[0] == jax[0] == "ready" and port[1] == jax[1] == []
    assert port[2] == jax[2] and port[3] == "StubEngine"
    assert [b[1] for b in port[2]] == ["miss", "hit"]
    assert any(img["detections"] for img in port[2][0][2]["images"])


PORT_APP = "spotter_tpu_torch.serving.app"


def test_ray_adapter_with_a_fake_ray(monkeypatch):
    monkeypatch.setenv("MODEL_NAME", "PekingU/rtdetr_v2_r101vd")
    saved = {n: sys.modules.pop(n, None) for n in FAKE_MODULE_NAMES}
    sys.modules.update(_make_fake_modules())
    try:
        mod = importlib.reload(importlib.import_module(PORT_APP))
        assert isinstance(mod.deployment, FakeBound)
        assert mod.deployment.args == ("PekingU/rtdetr_v2_r101vd",)
        assert mod.deployment.cls.__name__ == "RayAmenitiesDetector"
        seen = {}

        class Inner:
            async def detect(self, payload):
                seen["payload"] = payload
                return "response"

        def build(model_name, **kwargs):
            seen.update(model_name=model_name, kwargs=kwargs)
            return Inner()

        monkeypatch.setattr(mod, "build_detector_app", build)
        instance = mod.deployment.cls(*mod.deployment.args)
        assert seen["kwargs"].get("warmup") is True

        class Request:
            async def json(self):
                return {"image_urls": ["http://cdn/a.jpg"]}

        assert asyncio.run(instance(Request())) == "response"
        assert seen["payload"] == {"image_urls": ["http://cdn/a.jpg"]}
        monkeypatch.delenv("MODEL_NAME")
        with pytest.raises(ValueError, match="MODEL_NAME"):
            importlib.reload(mod)
    finally:
        for name in FAKE_MODULE_NAMES:
            sys.modules.pop(name, None)
        sys.modules.update({k: v for k, v in saved.items() if v is not None})
        mod = importlib.reload(importlib.import_module(PORT_APP))
    assert mod.deployment is None


def test_debug_tenants_is_admin_gated(monkeypatch, tmp_path):
    _tenant_env(monkeypatch, tmp_path)
    monkeypatch.setenv("SPOTTER_TPU_ADMIN_TOKEN", "tok")
    monkeypatch.setenv("SPOTTER_TPU_STUB_ENGINE", "1")
    from spotter_tpu_torch.testing.stub_engine import build_stub_detector

    app = tstandalone.make_app(detector=build_stub_detector())

    async def run():
        async with TestClient(TestServer(app)) as client:
            denied = (await client.get("/debug/tenants")).status
            resp = await client.post("/detect", json={"image_urls": ["http://cdn/a.jpg"]},
                                     headers=ACME)
            table = await (await client.get("/debug/tenants",
                                            headers={"X-Admin-Token": "tok"})).json()
            prom = await (await client.get("/metrics?format=prometheus")).text()
            return denied, resp.status, table, prom

    denied, status, table, prom = asyncio.run(run())
    assert denied == 401 and status == 200
    assert table["tenants"]["acme"]["admits_total"] == 1
    assert 'spotter_tpu_tenants{tenant="acme",stat="admits_total"}' in prom


def test_a_503_before_ready_charges_no_tenant(monkeypatch, tmp_path):
    """The port answers /detect only once READY: a tenant's requests during
    bring-up get 503 and leave its bucket untouched (its full burst is
    there after READY)."""
    _tenant_env(monkeypatch, tmp_path)
    monkeypatch.setenv("SPOTTER_TPU_STUB_ENGINE", "1")
    gate = threading.Event()
    real = tstandalone._build_detector_blocking

    def held(*args):
        # bring-up runs in an executor thread: hold it until the test lets go
        gate.wait(30.0)
        return real(*args)

    monkeypatch.setattr(tstandalone, "_build_detector_blocking", held)
    app = tstandalone.make_app(model_name=None, device="cpu", bringup_exit_cb=lambda c: None,
                               integrity_exit_cb=lambda c: None)
    plane = app["tenancy"]

    async def run():
        async with TestClient(TestServer(app)) as client:
            async def post():
                return (await client.post("/detect", json={"image_urls": ["http://cdn/a.jpg"]},
                                          headers=HOBBY)).status

            early = [await post() for _ in range(3)]
            charged = plane.snapshot()["admits_total"]
            gate.set()
            for _ in range(400):
                if (await (await client.get("/startupz")).json())["state"] == "ready":
                    break
                await asyncio.sleep(0.02)
            return early, charged, [await post() for _ in range(3)]

    early, charged, after = asyncio.run(run())
    assert early == [503, 503, 503] and charged == 0
    assert after == [200, 200, 429]  # hobby's whole burst of 2, then its quota
