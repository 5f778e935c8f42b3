"""The port's output-integrity plane (`spotter_tpu_torch.serving.integrity`)
against the JAX package's, and the repaired attestation.

- The kept-value fault, repaired: the port keeps values derived from the
  parameters as persistent tensors (`models/layers.py` `kept`: the folded BN
  pairs, the bf16 casts, ...), which a captured CUDA graph reads on every
  replay. One element of one of them perturbed after a forward must make
  `engine.attest()` report a mismatch naming it, both when it is first
  re-derived and against its pin; restoring it attests clean again. Under
  "float32" a folded BN pair, under "bfloat16" a bf16 cast. A kept value
  made by a forward just before a periodic attest is re-derived and pinned
  by it (on the card the attest waits for the engine's stream:
  tests/test_torch_engine_cuda.py).
- Pure-function parity: `_host_checksum` on arrays of every dtype the
  engines hold (and the port's on-device `_attest_sum` equal to it), and
  `probe_image`'s bytes for every family name.
- The self-pinned golden probe on a tiny RT-DETR whose weights are carried
  across by `convert/from_jax.py`, against the JAX `IntegrityPlane`'s
  self-pin on the same weights: equivalent under obs/compare.py's default
  tolerances and within 1e-4 in score and 1e-3 px in box (fp32 forwards that
  agree to ~1e-5 in logits, through a box scale of 64).
- The pins by bucket: a probe in a bucket is held to that bucket's pin, and
  the batcher reports the bucket it really ran in (an out-of-memory split
  runs in a smaller one); under "float32" every bucket's pin is held to
  bucket 1's, so a fault in one bucket only fails the gate; a bucket left
  unpinned fails the gate; `answer_class` by policy.
- The replica: bring-up passes loading -> warming -> verifying -> ready, with
  the probe pinned in every bucket; `corrupt_weights` exits 86 before any
  /detect answers 200; `corrupt_compile_cache` attests clean and then the
  probe exits 86 (at the gate, held to bucket 1's pin, when the ladder has
  a second bucket; else at the next periodic probe); the periodic loop
  exits 86 on `sdc`; SPOTTER_TPU_INTEGRITY=0 skips the gate.
"""

import asyncio

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from spotter_tpu.engine.batcher import MicroBatcher as JBatcher
from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.engine.engine import _host_checksum as j_host_checksum
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu.ops.preprocess import PreprocessSpec as JSpec
from spotter_tpu.serving import integrity as jintegrity
from spotter_tpu_torch.engine import engine as tengine
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.obs import compare
from spotter_tpu_torch.serving import integrity, lifecycle
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.testing import faults
from tests.torch_parity import random_flax_params

MODEL = "PekingU/rtdetr_v2_r101vd"
FAMILIES = (MODEL, "PekingU/rtdetr_v2_r50vd", "hustvl/yolos-base", "google/owlv2-base-patch16-ensemble",
            "google/owlvit-base-patch32", "SenseTime/deformable-detr", "facebook/detr-resnet-50",
            "microsoft/conditional-detr-resnet-50", "IDEA-Research/dab-detr-resnet-50", "stub")
SCORE_ATOL, BOX_ATOL = 1e-4, 1e-3  # the port's self-pin against the JAX one


def _photo(seed, h=64, w=64):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for knob in (faults.FAULTS_ENV, integrity.INTEGRITY_ENV, integrity.PROBE_INTERVAL_ENV,
                 integrity.ATTEST_INTERVAL_ENV, "SPOTTER_TPU_DTYPE"):
        monkeypatch.delenv(knob, raising=False)
    yield monkeypatch
    faults._active = None


# ---- the repaired fault: kept values are attested ----------------------------


def _kept_tensor(module: torch.nn.Module, name: str, dtype: torch.dtype):
    """(label, tensor) of the first value kept as `name` whose first tensor
    has `dtype`."""
    for path, m in module.named_modules():
        entry = vars(m).get(name)
        if entry is not None:
            value = entry[1]
            t = value[0] if isinstance(value, tuple) else value
            if t.dtype == dtype:
                return f"{path}.{name}", t
    raise AssertionError(f"no kept {name} of {dtype}")


@pytest.mark.parametrize("policy,name,dtype", [
    ("float32", "_folded", torch.float32), ("bfloat16", "_cast", torch.bfloat16)])
def test_attest_catches_a_perturbed_kept_value(clean, policy, name, dtype):
    clean.setenv("SPOTTER_TPU_DTYPE", policy)
    engine = InferenceEngine(registry.build_detector(MODEL, tiny=True, seed=3),
                             batch_buckets=(1,), device="cpu")
    engine.detect([_photo(0)])  # the forward makes the kept values
    label, t = _kept_tensor(engine.model, name, dtype)
    bits = t.view(torch.int32 if dtype == torch.float32 else torch.int16).view(-1)
    want = f"device:0:kept:{label}"
    for _ in range(2):  # first when re-derived, then against the pin
        with torch.no_grad():
            bits[:1] ^= 1
        result = engine.attest()
        assert not result["ok"] and want in result["mismatched"], result["mismatched"]
        with torch.no_grad():
            bits[:1] ^= 1
        result = engine.attest()
        assert result["ok"] and result["kept_checked"] > 0


def test_periodic_attest_pins_a_kept_value_made_just_before_it(clean):
    built = registry.build_detector(MODEL, tiny=True, seed=3)
    engine = InferenceEngine(built, batch_buckets=(1,), device="cpu")
    exits = []

    async def run():
        batcher = MicroBatcher(engine, max_delay_ms=5.0)
        plane = integrity.IntegrityPlane(engine, batcher, probe_interval_s=0,
                                         attest_interval_s=0.05, exit_cb=exits.append)
        try:
            assert await plane.verify("cold-start")
            await plane.start()
            before = plane.attestor.attests_total
            # a statistic's version moves: the next forward keeps a new fold
            bn = next(m for m in engine.model.modules() if hasattr(m, "running_var"))
            old = bn._folded
            with torch.no_grad():
                bn.running_var.add_(0)
            await batcher.submit(_photo(5))
            assert bn._folded is not old
            for _ in range(100):
                if plane.attestor.attests_total >= before + 2:
                    break
                await asyncio.sleep(0.02)
            await plane.aclose()
            return plane, bn
        finally:
            await batcher.stop()

    plane, bn = asyncio.run(run())
    assert not exits and plane.attestor.failures_total == 0, plane.last_error
    assert id(bn._folded) in engine._kept_pins


def test_attest_names_the_device_after_corrupt_weights_and_recovers(clean):
    engine = InferenceEngine(registry.build_detector(MODEL, tiny=True, seed=3),
                             batch_buckets=(1,), device="cpu")
    engine.detect([_photo(0)])
    assert engine.attest()["ok"]
    engine.corrupt_weights(1)
    assert engine.attest()["mismatched"] == ["device:0"]
    engine.reload_weights()
    assert engine.attest()["ok"]


# ---- pure-function parity -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8", "uint8", "int16",
                                   "int32", "int64", "bool"])
def test_host_checksum_as_jax_and_the_device_sum(dtype):
    rng = np.random.default_rng(7)
    for shape in ((0,), (5,), (3, 17), (2, 3, 4, 5)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1e3)
        t = {"bool": x > 0, "bfloat16": x.to(torch.bfloat16), "float16": x.to(torch.float16),
             "float32": x}.get(dtype)
        if t is None:
            t = x.to(getattr(torch, dtype))
        host = tengine._host_array(t)
        assert tengine._host_checksum(host) == j_host_checksum(host)
        assert tengine._attest_sum(t) == tengine._host_checksum(host)


@pytest.mark.parametrize("family", FAMILIES)
def test_probe_image_bytes_as_jax(family):
    assert integrity.probe_image(family).tobytes() == jintegrity.probe_image(family).tobytes()
    assert integrity.PROBE_REFERENCES == jintegrity.PROBE_REFERENCES


# ---- the self-pinned probe against the JAX plane's --------------------------------


@pytest.fixture(scope="module")
def jax_pin():
    """The JAX IntegrityPlane's gate on the tiny RT-DETR (seed-21 weights):
    (params, its self-pinned reference)."""
    cfg = jzoo.tiny_rtdetr_config()
    module = JRTDetr(cfg)
    params = random_flax_params(module, np.zeros((1, 64, 64, 3), np.float32), seed=21)
    built = JBuilt(
        model_name=MODEL, module=module, params=params,
        preprocess_spec=JSpec(mode="fixed", size=(64, 64)), postprocess="sigmoid_topk",
        id2label=cfg.id2label_dict, num_top_queries=min(300, cfg.num_queries),
    )
    engine = JEngine(built, batch_buckets=(1,))

    async def run():
        batcher = JBatcher(engine)
        plane = jintegrity.IntegrityPlane(engine, batcher, probe_interval_s=0,
                                          attest_interval_s=0, exit_cb=lambda code: None)
        try:
            assert await plane.verify("cold-start")
            return plane.probe.reference
        finally:
            await batcher.stop()

    return params, asyncio.run(run())


def _port_plane(params, buckets=(1,), **kw):
    built = registry.build_detector(MODEL, tiny=True, params=params)
    engine = InferenceEngine(built, batch_buckets=buckets, device="cpu")
    batcher = MicroBatcher(engine, max_delay_ms=20.0)
    return integrity.IntegrityPlane(engine, batcher, **kw), batcher


def test_self_pinned_probe_as_the_jax_plane(jax_pin):
    params, want = jax_pin

    async def run():
        plane, batcher = _port_plane(params, probe_interval_s=0, attest_interval_s=0,
                                     exit_cb=lambda code: None)
        try:
            assert await plane.verify("cold-start")
            return plane
        finally:
            await batcher.stop()

    plane = asyncio.run(run())
    got = plane.probe.reference
    assert want, "the tiny model's probe answer is empty: nothing is compared"
    assert compare.diff_detections(want, got) is None
    assert compare.detections_equivalent(want, got, score_tol=SCORE_ATOL, box_tol=BOX_ATOL)
    assert plane.probe.pins == {1: got}
    snap = plane.snapshot()
    assert snap["verifications_total"] == 1 and snap["probe"]["pinned_buckets"] == [1]
    assert snap["attest"]["attests_total"] == 1 and snap["attest"]["failures_total"] == 0


def test_probe_is_held_to_the_pin_of_its_bucket(jax_pin):
    params, _ = jax_pin

    async def run():
        plane, batcher = _port_plane(params, buckets=(1, 2, 4), probe_interval_s=0,
                                     attest_interval_s=0, exit_cb=lambda code: None)
        try:
            assert await plane.verify("cold-start")
            assert sorted(plane.probe.pins) == [1, 2, 4]
            info: dict = {}
            dets, _, _ = await asyncio.gather(
                batcher.submit(plane.probe.image, info=info), batcher.submit(_photo(1)),
                batcher.submit(_photo(2)))
            assert info["bucket"] == 4
            assert plane.probe._diff(plane.probe.pins[4], dets) is None
            # a wrong pin for that bucket is what the probe then reports
            plane.probe.pins[4] = faults.perturb_detections(dets)
            probe_runs = [plane.probe.run(batcher), batcher.submit(_photo(1)),
                          batcher.submit(_photo(2))]
            reason, *_ = await asyncio.gather(*probe_runs)
            assert reason is not None and "outside tol" in reason
            assert plane.probe.failures_total == 1
        finally:
            await batcher.stop()

    asyncio.run(run())


def test_probe_reports_the_bucket_of_an_out_of_memory_split(jax_pin):
    params, _ = jax_pin

    async def run():
        plane, batcher = _port_plane(params, buckets=(1, 2, 4), probe_interval_s=0,
                                     attest_interval_s=0, exit_cb=lambda code: None)
        try:
            assert await plane.verify("cold-start")
            info: dict = {}
            with faults.inject(engine_oom=1):  # the chunk of 4 splits in halves of 2
                dets, *_ = await asyncio.gather(
                    batcher.submit(plane.probe.image, info=info),
                    *(batcher.submit(_photo(k)) for k in (1, 2, 3)))
            assert batcher.engine.metrics.snapshot()["batch_retries_total"] == 1
            assert info["bucket"] == 2
            assert plane.probe._diff(plane.probe.pins[2], dets) is None
        finally:
            await batcher.stop()

    asyncio.run(run())


def test_float32_gate_holds_every_pin_to_bucket_1s(jax_pin):
    params, _ = jax_pin

    async def run(fault_bucket):
        plane, batcher = _port_plane(params, buckets=(1, 2, 4), probe_interval_s=0,
                                     attest_interval_s=0, exit_cb=lambda code: None)
        engine = batcher.engine
        finish = engine._finish

        def faulty(item):  # a fault in one bucket only (a bad capture, a kernel wrong at B)
            out = finish(item)
            return [faults.perturb_detections(d) for d in out] if (
                item[-2]["bucket"] == fault_bucket) else out

        engine._finish = faulty
        try:
            ok = await plane.verify("cold-start")
            return ok, plane
        finally:
            await batcher.stop()

    ok, plane = asyncio.run(run(None))
    assert ok and [plane.batcher.engine.answer_class(b) for b in (1, 2, 4)] == ["float32"] * 3
    for b in (2, 4):
        assert compare.diff_detections(plane.probe.pins[1], plane.probe.pins[b]) is None
    ok, plane = asyncio.run(run(4))
    assert not ok and "probe pin of bucket 4 disagrees with bucket 1's" in plane.last_error


@pytest.mark.parametrize("policy,int8,want", [
    ("float32", False, ["float32"] * 4), ("float32", True, ["float32"] * 3 + ["int8"]),
    ("bfloat16", False, [None] * 4), ("bfloat16", True, [None] * 4)])
def test_answer_class_by_policy(clean, policy, int8, want):
    from spotter_tpu_torch.utils import quant

    clean.setenv("SPOTTER_TPU_DTYPE", policy)
    clean.setattr(quant, "INT8", int8)
    clean.setattr(quant, "INT8_MIN_BATCH", 8)
    engine = InferenceEngine(registry.build_detector(MODEL, tiny=True, seed=3), device="cpu")
    assert [engine.answer_class(b) for b in engine.batch_buckets] == want


class _OneBucketBatcher:
    """Answers every submission with the same detections, always in bucket 1."""

    async def submit(self, image, cls=None, info=None):
        info["bucket"] = 1
        return [{"label": "cat", "score": 0.9, "box": [1.0, 2.0, 3.0, 4.0]}]


class _CleanEngine:
    batch_buckets = (1, 2)

    def attest(self):
        return {"ok": True}


def test_gate_fails_when_a_bucket_is_left_unpinned():
    plane = integrity.IntegrityPlane(_CleanEngine(), _OneBucketBatcher(), family="x",
                                     probe_interval_s=0, attest_interval_s=0,
                                     exit_cb=lambda code: None)
    assert not asyncio.run(plane.verify("cold-start"))
    assert plane.last_error == "cold-start: buckets [2] left unpinned"
    assert sorted(plane.probe.pins) == [1]


# ---- the replica -------------------------------------------------------------------


@pytest.fixture
def tiny_replica(clean):
    clean.setenv("SPOTTER_TPU_TINY", "1")
    clean.setenv("SPOTTER_TPU_BATCH_BUCKETS", "1,2")
    states = []
    real_mark, real_ready = lifecycle.StartupTracker.mark, lifecycle.StartupTracker.mark_ready
    clean.setattr(lifecycle.StartupTracker, "mark",
                  lambda self, state: states.append(state) or real_mark(self, state))
    clean.setattr(lifecycle.StartupTracker, "mark_ready",
                  lambda self, metrics=None: states.append("ready") or real_ready(self, metrics))
    return states


async def _drive(app, exits, until, detect_statuses=None, polls=600):
    """Start the bring-up app; poll (POSTing /detect when asked) until
    `until(app, exits)`; returns the client (the caller closes it)."""
    client = TestClient(TestServer(app))
    await client.start_server()
    for _ in range(polls):
        if detect_statuses is not None:
            resp = await client.post("/detect", json={"image_urls": ["http://127.0.0.1:9/x.png"]})
            detect_statuses.add(resp.status)
        if until(app, exits):
            break
        await asyncio.sleep(0.02)
    return client


def _make(exits):
    return tstandalone.make_app(model_name=MODEL, device="cpu", bringup_exit_cb=exits.append,
                                integrity_exit_cb=exits.append)


def test_bring_up_verifies_before_ready(tiny_replica):
    exits = []
    app = _make(exits)

    async def run():
        client = await _drive(app, exits, lambda a, e: a["startup"].ready or e)
        try:
            return await (await client.get("/metrics")).json()
        finally:
            await client.close()

    snap = asyncio.run(run())
    assert tiny_replica == ["warming", "verifying", "ready"] and not exits  # from "loading"
    integ = snap["integrity"]
    assert integ["verifications_total"] == 1 and integ["probe"]["pinned_buckets"] == [1, 2]


def test_corrupt_weights_exits_86_before_any_detect(tiny_replica, clean):
    clean.setenv(faults.FAULTS_ENV, "corrupt_weights=1")
    exits, statuses = [], set()
    app = _make(exits)

    async def run():
        client = await _drive(app, exits, lambda a, e: e, detect_statuses=statuses)
        try:
            resp = await client.get("/startupz")
            after = await client.post("/detect", json={"image_urls": []})
            return resp.status, await resp.json(), after.status
        finally:
            await client.close()

    status, body, after = asyncio.run(run())
    assert exits == [lifecycle.INTEGRITY_EXIT_CODE]
    assert "ready" not in tiny_replica and 200 not in statuses and after == 503
    assert status == 503 and body["state"] == "failed"
    assert "checksum mismatch on ['device:0']" in body["error"]


@pytest.mark.parametrize("buckets,caught_by", [
    ("1", "periodic-probe: "), ("1,2", "cold-start: probe pin of bucket 2 disagrees")])
def test_corrupt_compile_cache_attests_clean_then_the_probe_exits_86(
        tiny_replica, clean, buckets, caught_by):
    clean.setenv(faults.FAULTS_ENV, "corrupt_compile_cache=1")
    clean.setenv(integrity.PROBE_INTERVAL_ENV, "0.05")
    clean.setenv("SPOTTER_TPU_BATCH_BUCKETS", buckets)
    exits = []
    app = _make(exits)

    async def run():
        client = await _drive(app, exits, lambda a, e: e)
        await client.close()

    asyncio.run(run())
    plane = app["integrity"]
    # one bucket: the gate self-pins the perturbed answer (as the JAX plane
    # does) and the next periodic probe disagrees; two: bucket 2's pin
    # disagrees with bucket 1's at the gate
    assert exits == [lifecycle.INTEGRITY_EXIT_CODE]
    assert ("ready" in tiny_replica) == (buckets == "1")
    assert plane.attestor.failures_total == 0 and plane.probe.failures_total == 1
    assert plane.last_error.startswith(caught_by), plane.last_error


def test_periodic_loop_exits_86_on_sdc(jax_pin):
    params, _ = jax_pin
    exits = []

    async def run():
        plane, batcher = _port_plane(params, probe_interval_s=0.05, attest_interval_s=0.05,
                                     exit_cb=exits.append)
        try:
            assert await plane.verify("cold-start")
            await plane.start()
            await asyncio.sleep(0.3)
            assert not exits  # healthy: the loop keeps passing
            with faults.inject(sdc=100):
                answers = await batcher.submit(_photo(3))
                for _ in range(200):
                    if exits:
                        break
                    await asyncio.sleep(0.02)
            await plane.aclose()
            return plane, answers
        finally:
            await batcher.stop()

    plane, answers = asyncio.run(run())
    assert exits == [lifecycle.INTEGRITY_EXIT_CODE] and isinstance(answers, list)
    assert plane.last_error.startswith("periodic-probe: ")
    assert plane.verification_failures_total == 1 and plane.attestor.failures_total == 0


def test_integrity_off_skips_the_gate(tiny_replica, clean):
    clean.setenv(integrity.INTEGRITY_ENV, "0")
    exits = []
    app = _make(exits)

    async def run():
        client = await _drive(app, exits, lambda a, e: a["startup"].ready or e)
        try:
            return await (await client.get("/metrics")).json()
        finally:
            await client.close()

    snap = asyncio.run(run())
    assert tiny_replica == ["warming", "ready"] and not exits
    assert "integrity" not in snap and app.get("integrity") is None
