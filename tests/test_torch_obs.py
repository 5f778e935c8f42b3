"""The port's observability tier (`spotter_tpu_torch.obs`) against the JAX
package's (`spotter_tpu.obs`), and its HTTP surface on the port's replica.

Pure-function parity on the same inputs: the comparator's verdicts and
reason texts on hypothesis-drawn detection lists; trace ids from request ids
and the traceparent parse; the Prometheus rendering of the same snapshots
(one of them a real snapshot of the port's engine, with an integrity
snapshot and latency exemplars); the flight recorder's ring, slowest-K and
error pins over the same traces, and `dump_for_exit` by exit code (nothing
at 86, as in the JAX package); the JSON log line's trace id.

Then the replica (a tiny RT-DETR on the CPU, injected): X-Request-ID and
traceparent echoed and continued, Server-Timing, the trace's spans at
/debug/traces, /debug/perf, Prometheus /metrics, `/profile` (400 and 409 as
in the JAX package), and the admin token on every admin endpoint.
"""

import asyncio
import json
import logging
import os

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from spotter_tpu import obs as jobs
from spotter_tpu.obs import compare as jcompare
from spotter_tpu.obs import prom as jprom
from spotter_tpu_torch import obs
from spotter_tpu_torch.engine import profiler
from spotter_tpu_torch.obs import compare, prom
from spotter_tpu_torch.obs import logs as tlogs
from spotter_tpu_torch.obs import recorder as trecorder
from spotter_tpu_torch.serving import app as tapp
from spotter_tpu_torch.serving import standalone as tstandalone

MODEL = "PekingU/rtdetr_v2_r101vd"

detection = st.fixed_dictionaries({
    "label": st.sampled_from(["tv", "bed", "oven"]),
    "score": st.floats(0.0, 1.0, allow_nan=False),
    "box": st.one_of(
        st.lists(st.floats(-10.0, 100.0, allow_nan=False), min_size=4, max_size=4),
        st.none()),
})
nudge = st.tuples(st.floats(-0.08, 0.08), st.floats(-3.0, 3.0))


@settings(max_examples=150, deadline=None)
@given(st.lists(detection, max_size=6), st.lists(nudge, max_size=6), st.permutations(range(6)),
       st.booleans())
def test_comparator_as_jax(dets, nudges, order, drop):
    """`b` is `a` nudged within or past the tolerances, reordered, and maybe
    one short: every verdict and reason text as the JAX comparator's."""
    other = []
    for i, d in enumerate(dets):
        ds, db = nudges[i] if i < len(nudges) else (0.0, 0.0)
        box = None if d["box"] is None else [v + db for v in d["box"]]
        other.append({**d, "score": d["score"] + ds, "box": box})
    other = [other[i] for i in order if i < len(other)]
    if drop and other:
        other.pop()
    for a, b in ((dets, other), (other, dets), (dets, dets)):
        assert compare.detections_equivalent(a, b) == jcompare.detections_equivalent(a, b)
        assert compare.diff_detections(a, b) == jcompare.diff_detections(a, b)
        assert (compare.diff_detections(a, b, score_tol=0.01, box_tol=0.5)
                == jcompare.diff_detections(a, b, score_tol=0.01, box_tol=0.5))
    images = [{"detections": dets}, {"detections": other}]
    assert compare.images_equivalent(images, images[::-1]) == jcompare.images_equivalent(
        images, images[::-1])
    assert compare.norm_detections(images) == jcompare.norm_detections(images)


@pytest.mark.parametrize("value", [
    None, "", "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    " 00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00 ",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01", "01-abc-def-01", "garbage"])
def test_traceparent_parse_as_jax(value):
    assert obs.parse_traceparent(value) == jobs.parse_traceparent(value)


@pytest.mark.parametrize("rid", ["req-1", "x" * 200, "ünïcode", "chip-smoke-0"])
def test_trace_ids_as_jax(rid):
    assert obs.trace_id_for_request(rid) == jobs.trace_id_for_request(rid)
    tr = obs.begin_trace(request_id=rid)
    jt = jobs.begin_trace(request_id=rid)
    assert (tr.trace_id, tr.request_id) == (jt.trace_id, jt.request_id)
    assert obs.current_trace() is tr
    parent = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    tr = obs.begin_trace(request_id=rid, traceparent=parent)
    assert (tr.trace_id, tr.parent_span_id) == ("0af7651916cd43dd8448eb211c80319c",
                                                "b7ad6b7169203331")
    assert obs.traceparent_value(tr) == f"00-{tr.trace_id}-{tr.span_id}-01"
    assert obs.begin_trace(request_id=rid, enabled=False) is None
    obs.set_current_trace(None)


SNAPSHOTS = [
    {"images_total": 12, "errors_total": 0, "draining": False, "breaker_state": "closed",
     "latency_ms_p50": 12.5, "time_to_ready_s": None, "admit_sheds_total": {"slo": 1, "bulk": 3},
     "slack_at_dispatch_ms": {"p50": 4.0, "p90": 9.5, "p99": 20.0},
     "replica": {"replica_id": "r-1"}, "nested": {"a": {"b_total": 2, "c": 1.5}},
     "replicas": [{"url": "http://a", "healthy": True, "load": 0.25, "name": "x"}],
     "pool_size": {"spot": {"ready": 2, "starting": 1}}, "slo_burn_rate": {"fast": 0.1},
     "dp_degraded": {"from": 4, "to": 2}, "pools": {"spot": {"size": 3, "ok": True}},
     "latency_ms_histogram": {
         "buckets": [[5.0, 1], [10.0, 3], [None, 4]], "sum": 31.5, "count": 4,
         "exemplars": {"10": {"trace_id": "ab" * 16, "value": 7.5, "ts": 1.5}}}},
    {"integrity": {"verifications_total": 1, "last_error": None,
                   "probe": {"family": MODEL, "pinned": True, "pinned_buckets": [1, 2]}},
     "inf_gauge": float("inf"), "neg": -3},
]


@pytest.mark.parametrize("snap", SNAPSHOTS, ids=["synthetic", "integrity"])
def test_prometheus_render_as_jax(snap):
    assert prom.render(snap) == jprom.render(snap)


def test_prometheus_render_of_a_real_port_snapshot_as_jax():
    det = tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1, 2))
    tr = obs.Trace(obs.trace_id_for_request("exemplar"), "exemplar")
    obs.set_batch_traces([tr])
    det.engine.detect([np.zeros((64, 64, 3), np.uint8), np.full((64, 64, 3), 200, np.uint8)])
    obs.set_batch_traces([])
    snap = det.engine.metrics.snapshot()
    assert snap["latency_ms_histogram"]["count"] == 1
    assert tr.trace_id in json.dumps(snap["latency_ms_histogram"]["exemplars"])
    assert {s.name for s in tr.spans} == set(obs.ENGINE_STAGES)
    text = prom.render(snap)
    assert text == jprom.render(snap)
    assert f'trace_id="{tr.trace_id}"' in text and "spotter_tpu_images_total 2" in text


@pytest.mark.parametrize("fmt,accept", [(None, None), ("prometheus", None), (" PROMETHEUS ", None),
                                        ("json", "text/plain"), (None, "text/plain; q=1"),
                                        (None, "*/*")])
def test_wants_prometheus_as_jax(fmt, accept):
    assert prom.wants_prometheus(fmt, accept) == jprom.wants_prometheus(fmt, accept)


def _feed(mod, recorder):
    """The same 40 traces into `recorder`: durations from a seed, every
    fifth errored, every seventh shed."""
    rng = np.random.default_rng(3)
    for i in range(40):
        t = mod.Trace(mod.trace_id_for_request(f"r{i}"), f"r{i}")
        t.duration_ms = float(rng.uniform(1, 500))
        if i % 5 == 0:
            t.set_error("error", f"boom {i}")
        elif i % 7 == 0:
            t.set_error("shed", "HTTP 429")
        recorder.record(t)


def test_recorder_ring_slowest_and_errors_as_jax():
    port = obs.FlightRecorder(ring=16, slowest_k=5)
    jax = jobs.FlightRecorder(ring=16, slowest_k=5)
    _feed(obs, port)
    _feed(jobs, jax)
    ps, js = port.snapshot(), jax.snapshot()
    for key in ("enabled", "ring_size", "slowest_k", "recorded_total", "errors_total"):
        assert ps[key] == js[key]
    for key in ("ring", "slowest", "errors"):
        assert [t["request_id"] for t in ps[key]] == [t["request_id"] for t in js[key]]
        assert [t["status"] for t in ps[key]] == [t["status"] for t in js[key]]
    assert [t["request_id"] for t in port.slowest_traces(3)] == [
        t["request_id"] for t in jax.slowest_traces(3)]
    assert port.lookup("r35") and not port.lookup("r3")  # r3 left the ring, unpinned
    off = obs.FlightRecorder(ring=0)
    off.record(obs.Trace("a" * 32, "x"))
    assert not off.enabled and off.recorded_total == 0


@pytest.mark.parametrize("code", [82, 83, 84, 85, 86])
def test_dump_for_exit_by_code_as_jax(monkeypatch, tmp_path, code):
    assert obs.DUMP_EXIT_CODES == jobs.DUMP_EXIT_CODES == (83, 84, 85)
    paths = {}
    for name, mod in (("port", obs), ("jax", jobs)):
        monkeypatch.setenv(mod.TRACE_DUMP_DIR_ENV, str(tmp_path / name))
        mod.reset_recorder()
        assert mod.dump_for_exit(code) is None  # an empty recorder writes nothing
        mod.get_recorder().record(mod.Trace("c" * 32, "dumped"))
        paths[name] = mod.dump_for_exit(code)
        mod.reset_recorder()
    assert (paths["port"] is None) == (paths["jax"] is None) == (code == 86 or code == 82)
    if paths["port"] is not None:
        assert os.path.basename(paths["port"]) == os.path.basename(paths["jax"])
        dumped = json.loads(open(paths["port"]).read())
        assert dumped["recorded_total"] == 1 and dumped["ring"][0]["request_id"] == "dumped"


def test_json_log_line_carries_the_trace():
    record = logging.LogRecord("spotter", logging.INFO, __file__, 1, "hello %s", ("x",), None)
    tr = obs.begin_trace(request_id="log-1")
    try:
        entry = json.loads(tlogs.JsonFormatter().format(record))
    finally:
        obs.set_current_trace(None)
    assert entry["message"] == "hello x" and entry["level"] == "INFO"
    assert (entry["trace_id"], entry["request_id"]) == (tr.trace_id, "log-1")
    assert "trace_id" not in json.loads(tlogs.JsonFormatter().format(record))


# ---- the replica's HTTP surface -----------------------------------------------------


@pytest.fixture(scope="module")
def detector():
    return tapp.build_detector_app(MODEL, tiny=True, device="cpu", batch_buckets=(1, 2))


async def _serve(det, body):
    import tempfile

    from aiohttp import web

    with tempfile.TemporaryDirectory() as root:
        rng = np.random.default_rng(5)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(f"{root}/p.png")
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


def test_request_trace_endpoints_and_prometheus(monkeypatch, detector):
    monkeypatch.delenv("SPOTTER_TPU_ADMIN_TOKEN", raising=False)
    obs.reset_recorder()

    async def body(client, url):
        resp = await client.post("/detect", json={"image_urls": [url, url]},
                                 headers={"X-Request-ID": "trace-me"})
        assert resp.status == 200 and resp.headers["X-Request-ID"] == "trace-me"
        timing = dict(p.split(";dur=") for p in resp.headers["Server-Timing"].split(", "))
        assert {"fetch", "decode", "queue_wait", "h2d", "device", "postprocess"} <= set(timing)
        (trace,) = (await (await client.get(
            "/debug/traces", params={"request_id": "trace-me"})).json())["traces"]
        assert trace["trace_id"] == obs.trace_id_for_request("trace-me")
        assert resp.headers["traceparent"].startswith(f"00-{trace['trace_id']}-")
        assert {s["name"] for s in trace["spans"]} >= {"fetch", "decode", "queue_wait", "h2d",
                                                        "device", "postprocess"}
        assert (await client.get("/debug/traces", params={"trace_id": "nope"})).status == 404
        assert (await (await client.get("/debug/traces")).json())["recorded_total"] >= 1
        parent = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
        resp = await client.post("/detect", json={"image_urls": [url]},
                                 headers={"traceparent": parent})
        assert resp.headers["traceparent"].startswith("00-0af7651916cd43dd8448eb211c80319c-")
        minted = (await client.post("/detect", json={"bad": 1})).headers["X-Request-ID"]
        assert len(minted) == 32
        perf = await (await client.get("/debug/perf", params={"k": "2"})).json()
        assert len(perf["top_dispatches"]) == 2 and "slo_burn" in perf
        # every dispatch served a traced request: each carries the trace id
        # that joins /debug/traces
        assert all(len(d["trace_id"]) == 32 for d in perf["top_dispatches"])
        assert (await client.get("/debug/perf", params={"k": "x"})).status == 400
        text = await (await client.get("/metrics", params={"format": "prometheus"})).text()
        assert "# TYPE spotter_tpu_latency_ms_bucket histogram" in text
        assert 'spotter_tpu_latency_ms_bucket{le="+Inf"}' in text
        plain = await client.get("/metrics", headers={"Accept": "text/plain"})
        assert plain.headers["X-Prometheus-Version"] == "0.0.4"
        assert "images_total" in await (await client.get("/metrics")).json()

    asyncio.run(_serve(detector, body))


def test_profile_endpoint_as_jax(monkeypatch, tmp_path, detector):
    monkeypatch.delenv("SPOTTER_TPU_ADMIN_TOKEN", raising=False)
    monkeypatch.setenv("SPOTTER_TPU_PROFILE_DIR", str(tmp_path))

    async def body(client, url):
        for bad in ([1, 2], {"duration_s": "soon"}, {"duration_s": 0}, {"duration_s": "nan"}):
            assert (await client.post("/profile", json=bad)).status == 400
        ok = await client.post("/profile", json={"duration_s": 0.05})
        summary = await ok.json()
        assert ok.status == 200 and os.path.getsize(summary["trace"]) > 0
        assert profiler._capture_lock.acquire(blocking=False)
        try:
            busy = await client.post("/profile", json={"duration_s": 0.05})
            assert busy.status == 409 and "already running" in await busy.text()
        finally:
            profiler._capture_lock.release()
        assert len(os.listdir(tmp_path)) == 1  # failed requests leave no directory

    asyncio.run(_serve(detector, body))


def test_admin_endpoints_need_the_token(monkeypatch, detector):
    monkeypatch.setenv("SPOTTER_TPU_ADMIN_TOKEN", "sekrit")

    async def body(client, url):
        for method, path in (("get", "/debug/traces"), ("get", "/debug/perf"),
                             ("post", "/profile"), ("post", "/drain")):
            resp = await getattr(client, method)(path)
            assert resp.status == 401, path
            assert (await resp.json())["error"] == "admin endpoint requires X-Admin-Token"
        ok = await client.get("/debug/traces", headers={"X-Admin-Token": "sekrit"})
        assert ok.status == 200

    asyncio.run(_serve(detector, body))
    assert trecorder.get_recorder().enabled


def test_preemption_and_fatal_exits_dump_the_recorder(monkeypatch, tmp_path, detector):
    """Exit 83 (a preemption's drain) and exit 85 (a fatal engine error)
    write the flight recorder to SPOTTER_TPU_TRACE_DUMP_DIR first, the
    fatal batch's trace among it, pinned as fatal."""
    from spotter_tpu_torch.engine.batcher import MicroBatcher
    from spotter_tpu_torch.engine.errors import FatalEngineError
    from spotter_tpu_torch.serving import lifecycle

    monkeypatch.setenv(obs.TRACE_DUMP_DIR_ENV, str(tmp_path))
    obs.reset_recorder()
    obs.get_recorder().record(obs.Trace("d" * 32, "earlier"))
    exits = []

    async def run():
        flag = tmp_path / "maintenance"
        watcher = lifecycle.PreemptionWatcher(
            lambda: asyncio.sleep(0), poll_s=0.01, file_source=str(flag),
            url_source="", exit_cb=exits.append, install_sigterm=False)
        await watcher.start()
        flag.write_text("now")
        for _ in range(200):
            if exits:
                break
            await asyncio.sleep(0.01)
        await watcher.stop()
        batcher = MicroBatcher(detector.engine, fatal_exit_cb=exits.append)
        monkeypatch.setattr(detector.engine, "detect", lambda images, **kw: (_ for _ in ()).throw(
            FatalEngineError("device lost")))
        obs.begin_trace(request_id="killer")
        with pytest.raises(FatalEngineError):
            await batcher.submit(np.zeros((64, 64, 3), np.uint8))
        await batcher.stop()

    asyncio.run(run())
    obs.set_current_trace(None)
    assert exits == [lifecycle.PREEMPTED_EXIT_CODE, 85]
    dumps = sorted(p.name for p in tmp_path.glob("spotter-tpu-traces-*.json"))
    assert [d.rsplit("-", 1)[1] for d in dumps] == ["exit83.json", "exit85.json"]
    fatal = json.loads((tmp_path / dumps[1]).read_text())
    assert [t["status"] for t in fatal["errors"] if t["request_id"] == "killer"] == ["fatal"]
    obs.reset_recorder()
