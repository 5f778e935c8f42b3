"""The port's fault injection (`spotter_tpu_torch.testing.faults`) against the
JAX package's (`spotter_tpu.testing.faults`), and its seams in the port's
serving path.

Pure-function parity on the same inputs: the plan parsed from the same
SPOTTER_TPU_FAULTS strings has the same fields; a bad string raises the same
text; `perturb_detections` gives the same garbage; the Bresenham shares of
`flaky` and `sdc` (with `only_replica` scoping) fire on the same calls; the
one-shot and consume-whole takes behave alike; the seams of the result
cache (`cache_error`), the wire (`corrupt_frame`), the stub engine
(`slow_replica`) and the tenancy drills (`tenant_flood`,
`tenant_retry_storm`) arm and act as JAX's. The faults whose seams the
port does not have (a dead shard, the fleet tier) raise the port's text,
after the JAX text for an unknown fault.

Then each seam on a tiny RT-DETR replica on the CPU: `engine_oom` splits the
chunk and retries (transient), `engine_error` fails its batch,
`poison_item` is bisected to its image, `fetch_error` and `malformed_image`
fail one URL, `slow_stage` lands in its span, `overload_spike` cuts the
limiter, `flaky` answers 500.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from spotter_tpu.testing import faults as jfaults
from spotter_tpu_torch import obs
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.obs import compare
from spotter_tpu_torch.serving import app as tapp
from spotter_tpu_torch.serving import detector as tdetector
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.serving.overload import AdaptiveLimiter
from spotter_tpu_torch.testing import faults

MODEL = "PekingU/rtdetr_v2_r101vd"
SPECS = [
    "fetch_error=2,engine_hang_s=30",
    "fetch_delay_s=0.25, malformed_image=-1",
    "engine_error=1,poison_item=1,engine_oom=3",
    "overload_spike=4,slow_stage=device:100;fetch:25",
    "flaky=25,only_replica=r-7",
    "sdc=33,corrupt_weights=2,corrupt_compile_cache=1",
    "  engine_oom=1 ,, ",
    "cache_error=2,corrupt_frame=1,slow_replica=12.5",
    "tenant_flood=abuser:8,tenant_retry_storm=3,only_replica=r-2",
]
BAD_SPECS = [
    "no_such_fault=1", "engine_oom=1, bogus=2", "=3", "engine_oom=x", "fetch_delay_s=soon",
    "slow_stage=device", "slow_stage=device:fast", "engine_oom=x,bogus=1",
    "tenant_flood=abuser", "tenant_flood=:3", "tenant_flood=a:x", "tenant_flood=a:0",
    "slow_replica=soon", "cache_error=1.5",
]
UNPORTED = ["shard_dead=0", "preempt_storm=3", "controller_crash=2", "journal_corrupt=1"]
# the seams this port had refused until their planes came in
ARMED = ["cache_error=1", "corrupt_frame=2", "slow_replica=50", "tenant_flood=abuser:8",
         "tenant_retry_storm=3", "engine_oom=1,cache_error=1"]


@pytest.fixture(autouse=True)
def no_active_plan(monkeypatch):
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    yield
    faults._active = None
    jfaults._active = None


def _fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(faults.FaultPlan)
            if not f.name.startswith("_") and f.name != "release"}


@pytest.mark.parametrize("spec", SPECS)
def test_plan_parses_as_the_jax_plan(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULTS_ENV, spec)
    assert _fields(faults.maybe_activate_from_env()) == _fields(jfaults.maybe_activate_from_env())
    assert faults.active() is not None


def test_port_fields_are_the_jax_fields_of_the_ported_seams():
    port = {f.name for f in dataclasses.fields(faults.FaultPlan)}
    jax = {f.name for f in dataclasses.fields(jfaults.FaultPlan)}
    assert port <= jax
    assert jax - port == set(faults.UNPORTED_FAULTS)
    assert set(faults.JAX_FAULTS) == {n for n in jax if not n.startswith("_")} - {"release"}


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_spec_raises_the_jax_text(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULTS_ENV, spec)
    with pytest.raises(ValueError) as want:
        jfaults.maybe_activate_from_env()
    with pytest.raises(ValueError) as got:
        faults.maybe_activate_from_env()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as at_bring_up:
        tapp.refuse_unported_planes()
    assert str(at_bring_up.value) == str(want.value)


@pytest.mark.parametrize("spec", UNPORTED)
def test_unported_fault_raises_after_the_jax_checks(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULTS_ENV, spec)
    jfaults.maybe_activate_from_env()  # the JAX package accepts it
    with pytest.raises(ValueError, match="is not ported; unset it") as info:
        faults.maybe_activate_from_env()
    key = [p.partition("=")[0] for p in spec.split(",") if p.partition("=")[0] in
           faults.UNPORTED_FAULTS][0]
    assert f"fault {key!r}" in str(info.value) and "ROADMAP Queue 1 item" in str(info.value)
    assert faults.active() is None
    with pytest.raises(ValueError, match="is not ported"):
        tstandalone.make_app(model_name=MODEL, device="cpu")


@pytest.mark.parametrize("spec", ARMED)
def test_newly_armed_fault_parses_as_jax_and_serves(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULTS_ENV, spec)
    assert _fields(faults.maybe_activate_from_env()) == _fields(jfaults.maybe_activate_from_env())
    tapp.refuse_unported_planes()
    tstandalone.make_app(model_name=MODEL, device="cpu")
    assert faults.active() is not None


def test_armed_seams_act_as_jax():
    data = bytes(range(40))
    for kw in ({"slow_replica": 40.0, "corrupt_frame": 2, "tenant_flood": "hobby:5",
                "tenant_retry_storm": 3, "cache_error": 2},
               {"slow_replica": 7.5, "corrupt_frame": 1, "only_replica": "r-1",
                "tenant_retry_storm": -1}):
        with faults.inject(**kw), jfaults.inject(**kw):
            for rid in ("r-1", "r-2", None):
                assert faults.replica_delay_s(rid) == jfaults.replica_delay_s(rid)
            assert faults.tenant_flood_spec() == jfaults.tenant_flood_spec()
            assert faults.tenant_retry_storm_n() == jfaults.tenant_retry_storm_n()
            for rid in ("r-1", "r-1", "r-2", "r-1"):
                assert faults.corrupt_frame_bytes(data, rid) == jfaults.corrupt_frame_bytes(data,
                                                                                           rid)
            got = []
            for side in (faults, jfaults):
                outcomes = []
                for _ in range(3):
                    try:
                        side.on_cache("get", "k")
                        outcomes.append(None)
                    except RuntimeError as exc:
                        outcomes.append(str(exc))
                got.append(outcomes)
            assert got[0] == got[1]
    assert faults.replica_delay_s() == 0.0 and faults.tenant_flood_spec() is None
    assert faults.corrupt_frame_bytes(data) == data


detection = st.fixed_dictionaries({
    "label": st.sampled_from(["tv", "bed", "oven", "sink"]),
    "score": st.floats(0.0, 1.0, allow_nan=False),
    "box": st.lists(st.floats(-50.0, 700.0, allow_nan=False), min_size=4, max_size=4),
})


@settings(max_examples=60, deadline=None)
@given(st.lists(detection, max_size=8))
def test_perturb_detections_as_jax(dets):
    assert faults.perturb_detections(dets) == jfaults.perturb_detections(dets)


@pytest.mark.parametrize("pct", [0, 1, 25, 33, 50, 100, 150])
@pytest.mark.parametrize("scope", ["", "r-1"])
def test_bresenham_shares_as_jax(pct, scope):
    """`flaky` and `sdc` fire on the same calls of the same sequence (and a
    replica outside `only_replica` never), 200 calls each."""
    dets = [{"label": "tv", "score": 0.9, "box": [1.0, 2.0, 3.0, 4.0]}]
    for rid in ("r-1", "r-2", None):
        with faults.inject(flaky=pct, sdc=pct, only_replica=scope), \
                jfaults.inject(flaky=pct, sdc=pct, only_replica=scope):
            port = [(faults.take_flaky(rid), faults.corrupt_detections(dets, rid) != dets)
                    for _ in range(200)]
            jax = [(jfaults.take_flaky(rid), jfaults.corrupt_detections(dets, rid) != dets)
                   for _ in range(200)]
        assert port == jax
        if scope and rid != scope:
            assert not any(f or s for f, s in port)


def test_takes_consume_as_jax():
    with faults.inject(corrupt_weights=3, corrupt_compile_cache=1, overload_spike=2), \
            jfaults.inject(corrupt_weights=3, corrupt_compile_cache=1, overload_spike=2):
        for take in ("take_corrupt_weights", "take_corrupt_compile_cache", "take_overload_spike"):
            assert ([getattr(faults, take)() for _ in range(3)]
                    == [getattr(jfaults, take)() for _ in range(3)])
    assert faults.take_corrupt_weights() == 0 and not faults.take_corrupt_compile_cache()


def test_stage_delay_as_jax():
    spec = "device:100;fetch:25; queue_wait:5 "
    with faults.inject(slow_stage=spec), jfaults.inject(slow_stage=spec):
        for stage in (*obs.STAGES, "nope"):
            assert faults.stage_delay_s(stage) == jfaults.stage_delay_s(stage)
    assert faults.stage_delay_s("device") == 0.0


def test_engine_oom_text_classifies_transient():
    from spotter_tpu_torch.engine.errors import TransientEngineError, classify_engine_exception

    with faults.inject(engine_oom=1):
        with pytest.raises(RuntimeError) as info:
            faults.on_engine_dispatch(8, [0])
        faults.on_engine_dispatch(8, [0])  # consumed
    assert classify_engine_exception(info.value) is TransientEngineError


# ---- the seams on a tiny replica --------------------------------------------


def _photo(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def detector():
    det = tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1, 2, 4))
    return det


def _batcher(det, **kw):
    return MicroBatcher(det.engine, max_delay_ms=20.0, limiter=None, brownout=None, **kw)


def test_engine_oom_splits_and_retries(detector):
    images = [_photo(i) for i in range(4)]
    want = detector.engine.detect(images)
    retries = detector.engine.metrics.snapshot()["batch_retries_total"]
    with faults.inject(engine_oom=1):
        got = detector.engine.detect(images)
    # the halves run in bucket 2, whose forward rounds apart from bucket 4's
    assert all(compare.detections_equivalent(g, w, score_tol=1e-4, box_tol=1e-3)
               for g, w in zip(got, want, strict=True))
    assert detector.engine.metrics.snapshot()["batch_retries_total"] == retries + 1


def test_engine_error_fails_its_batch_and_poison_is_bisected(detector):
    """As the JAX batcher: a plain engine error is bisect-retried."""
    async def run():
        batcher = _batcher(detector)
        try:
            # one failure is bisected away: both halves then serve
            with faults.inject(engine_error=1):
                out = await asyncio.gather(*(batcher.submit(_photo(i)) for i in range(2)))
            assert all(isinstance(o, list) for o in out)
            # a failure on every call fails the whole batch with its own error
            with faults.inject(engine_error=-1):
                out = await asyncio.gather(*(batcher.submit(_photo(i)) for i in range(2)),
                                           return_exceptions=True)
            assert all(isinstance(o, RuntimeError) and "injected engine failure" in str(o)
                       for o in out)
            images = [_photo(i) for i in range(4)]
            faults.poison_image(images[2])
            with faults.inject(poison_item=1):
                out = await asyncio.gather(*(batcher.submit(im) for im in images),
                                           return_exceptions=True)
            assert [isinstance(o, Exception) for o in out] == [False, False, True, False]
            assert "poison" in str(out[2])
        finally:
            await batcher.stop()

    asyncio.run(run())


def test_engine_hang_is_released(detector):
    async def run():
        batcher = _batcher(detector)
        try:
            with faults.inject(engine_hang_s=30.0) as plan:
                task = asyncio.ensure_future(batcher.submit(_photo(0)))
                await asyncio.sleep(0.2)
                assert not task.done()
                plan.release.set()
                assert isinstance(await asyncio.wait_for(task, 30.0), list)
        finally:
            await batcher.stop()

    asyncio.run(run())


async def _serve(det, body):
    """Run `body(client, image_url)` against the standalone app on `det` and a
    static route of one PNG."""
    import tempfile

    from aiohttp import web

    with tempfile.TemporaryDirectory() as root:
        _photo(9).save(f"{root}/p.png")
        images = web.Application()
        images.router.add_static("/img", root)
        img = TestServer(images)
        await img.start_server()
        client = TestClient(TestServer(tstandalone.make_app(detector=det, fatal_exit_cb=None)))
        await client.start_server()
        try:
            await body(client, str(img.make_url("/img/p.png")))
        finally:
            await client.close()
            await img.close()


def test_fetch_seams_fail_one_url(monkeypatch, detector):
    monkeypatch.setattr(tdetector, "FETCH_RETRY_WAIT_MIN_S", 0.0)
    monkeypatch.setattr(tdetector, "FETCH_RETRY_WAIT_MAX_S", 0.0)
    det = tdetector.AmenitiesDetector(detector.engine, _batcher(detector))

    async def body(client, url):
        with faults.inject(fetch_error=3):  # all three attempts of one URL
            (failed,) = (await (await client.post(
                "/detect", json={"image_urls": [url]})).json())["images"]
            (served,) = (await (await client.post(
                "/detect", json={"image_urls": [url]})).json())["images"]
        assert failed["error"].startswith("HTTP Error: injected fetch failure")
        assert "detections" in served
        with faults.inject(malformed_image=1):
            images = (await (await client.post(
                "/detect", json={"image_urls": [url]})).json())["images"]
        assert images[0]["error"].startswith("Processing Error:")
        resp = await client.post("/detect", json={"image_urls": [url]})
        assert "detections" in (await resp.json())["images"][0]

    asyncio.run(_serve(det, body))


def test_slow_stage_lands_in_its_span_and_flaky_answers_500(detector):
    det = tdetector.AmenitiesDetector(detector.engine, _batcher(detector))

    async def body(client, url):
        with faults.inject(slow_stage="device:120;queue_wait:60"):
            resp = await client.post("/detect", json={"image_urls": [url]},
                                     headers={"X-Request-ID": "slow-1"})
            assert resp.status == 200
        (trace,) = (await (await client.get(
            "/debug/traces", params={"request_id": "slow-1"})).json())["traces"]
        spans = {}
        for s in trace["spans"]:
            spans[s["name"]] = spans.get(s["name"], 0.0) + s["duration_ms"]
        assert spans["device"] >= 120.0 and spans["queue_wait"] >= 60.0
        with faults.inject(flaky=50):
            statuses = [(await client.post("/detect", json={"image_urls": [url]})).status
                        for _ in range(4)]
        assert statuses == [200, 500, 200, 500]

    asyncio.run(_serve(det, body))


def test_overload_spike_cuts_the_limiter():
    now = [0.0]
    limiter = AdaptiveLimiter(target_ms=50.0, floor=2, ceiling=64, interval_s=1.0,
                              clock=lambda: now[0])
    with faults.inject(overload_spike=2):
        for _ in range(3):
            now[0] += 1.0
            limiter.tick()
    assert limiter.decreases_total == 2 and limiter.last_p90_ms == 0.0
    assert limiter.limit < 64
