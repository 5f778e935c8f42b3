"""The port's result cache, single-flight and keyed coalescing
(`spotter_tpu_torch.caching`, `engine/batcher.py`) against the JAX
package's (`spotter_tpu.caching`).

Pure parity on the same inputs: every key (content, URL, affinity, query
set) equal to JAX's for the same bytes, threshold, URL and queries; a
seeded sequence of put / get / stale get / negative / attach / expire /
evict under a fake clock gives the same results, the same metric calls and
the same `stats()` as JAX's `ResultCache`.

Then the port's machinery with a fake engine (what is under test is the
cache and the coalescing, not the forward): `SingleFlight` shares one
flight, fans a failure out and survives a waiter's deadline; N keyed
submits make one engine call and each waiter gets its own copy; only a
`PoisonImageError` enters the negative cache, never a
`TransientEngineError`, a `FatalEngineError`, a shed or a deadline; and the
golden probe is never answered from the cache nor coalesced into a user's
in-flight forward, so each probe runs one.
"""

import asyncio
import time
from io import BytesIO

import numpy as np
import pytest
from PIL import Image

from spotter_tpu.caching import keys as jkeys
from spotter_tpu.caching import result_cache as jrc
from spotter_tpu_torch.caching import keys, result_cache
from spotter_tpu_torch.caching.singleflight import SingleFlight
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.errors import (
    FatalEngineError,
    PoisonImageError,
    TransientEngineError,
)
from spotter_tpu_torch.engine.metrics import Metrics
from spotter_tpu_torch.serving import detector as tdetector
from spotter_tpu_torch.serving import integrity
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from spotter_tpu_torch.serving.resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceededError,
    DrainingError,
)
from spotter_tpu_torch.testing import faults

DETS = [{"label": "tv", "score": 0.9, "box": [1.0, 2.0, 20.0, 30.0]}]


@pytest.fixture(autouse=True)
def _zero_retry_backoff(monkeypatch):
    monkeypatch.setattr(tdetector, "FETCH_RETRY_WAIT_MIN_S", 0.0)
    monkeypatch.setattr(tdetector, "FETCH_RETRY_WAIT_MAX_S", 0.0)


# ---- keys and the cache itself, against JAX -------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_keys_equal_jax(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(0, 4096)), dtype=np.uint8).tobytes()
    threshold = float(rng.uniform(0.0, 1.0))
    url = f"  http://cdn.example/{seed}/photo {rng.integers(1 << 30)}.jpg\t"
    queries = [f"q{int(v)}" for v in rng.integers(0, 50, int(rng.integers(1, 8)))]
    model = ("PekingU/rtdetr_v2_r101vd", "google/owlv2-base-patch16-ensemble")[seed % 2]
    for t in (threshold, 0.5, 0.505, 0.125):
        assert keys.content_key(model, data, t) == jkeys.content_key(model, data, t)
    assert keys.url_key(url) == jkeys.url_key(url) == "url|" + keys.affinity_key(url)
    assert keys.affinity_key(url) == jkeys.affinity_key(url)
    assert keys.normalize_url(url) == jkeys.normalize_url(url)
    assert keys.queries_key(model, queries) == jkeys.queries_key(model, queries)
    assert keys.queries_digest(queries[::-1]) == jkeys.queries_digest(queries)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _CallLog:
    """A metrics stand-in recording every call the cache makes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a: self.calls.append((name, a))


def _dets(rng, n):
    return [{"label": f"l{int(rng.integers(0, 5))}", "score": float(rng.uniform()),
             "box": [float(v) for v in rng.uniform(0, 600, 4)]} for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_cache_sequence_as_jax(seed):
    """Seeded operations on both caches (a budget small enough to evict, TTLs
    crossed by the fake clock): equal answers, calls and stats."""
    rng = np.random.default_rng(seed)
    sides = []
    for mod in (result_cache, jrc):
        clock, log = _Clock(), _CallLog()
        sides.append((mod.ResultCache(max_bytes=1500, ttl_s=5.0, negative_ttl_s=2.0,
                                      metrics=log, clock=clock, annotated=True), clock, log))
    exc = PoisonImageError("image poisoned its batch")
    names = [f"k{i}" for i in range(6)]
    for step in range(120):
        op = int(rng.integers(0, 8))
        key = names[int(rng.integers(0, len(names)))]
        dets = _dets(rng, int(rng.integers(0, 4)))
        jpeg = rng.integers(0, 256, int(rng.integers(10, 300)), dtype=np.uint8).tobytes()
        dt = float(rng.uniform(0.0, 2.0))
        outs = []
        for cache, clock, _ in sides:
            if op == 0:
                out = cache.put(key, dets)
            elif op == 1:
                out = cache.get(key)
            elif op == 2:
                out = cache.get_entry_full(key, stale_ok=True)
            elif op == 3:
                out = cache.put_negative(key, exc)
            elif op == 4:
                out = cache.get_negative(key)
            elif op == 5:
                out = cache.get_entry_full(key)
            elif op == 6:
                out = cache.attach_annotated(key, jpeg, dets)
            else:
                clock.t += dt
                out = None
            outs.append(out)
        assert outs[0] == outs[1], (step, op)
    (port, _, plog), (jax, _, jlog) = sides
    assert plog.calls == jlog.calls
    assert port.stats() == jax.stats()


def test_cache_from_env_as_jax(monkeypatch):
    for value in ("", "0", "-1", "0.5", "64"):
        monkeypatch.setenv(result_cache.CACHE_MAX_MB_ENV, value)
        monkeypatch.setenv(result_cache.CACHE_TTL_ENV, "7")
        port, jax = result_cache.ResultCache.from_env(), jrc.ResultCache.from_env()
        assert (port is None) == (jax is None), value
        if port is not None:
            assert port.stats() == jax.stats()
    assert result_cache.MAX_NEGATIVE_ENTRIES == jrc.MAX_NEGATIVE_ENTRIES


def test_cache_error_is_contained():
    """`cache_error=N`: the next N operations raise inside the cache, which
    answers a miss or skips the fill."""
    cache = result_cache.ResultCache(max_bytes=1 << 20)
    cache.put("k", DETS)
    with faults.inject(cache_error=2):
        assert cache.get("k") is None
        cache.put("k2", DETS)
        assert cache.get("k") == DETS
    assert cache.get("k2") is None


# ---- SingleFlight ----------------------------------------------------------


def test_singleflight_shares_one_flight():
    coalesced = []
    flight = SingleFlight(on_coalesced=lambda: coalesced.append(1))
    runs = []

    async def factory():
        runs.append(1)
        await asyncio.sleep(0.02)
        return "bytes"

    async def run():
        out = await asyncio.gather(*(flight.run("u", factory) for _ in range(6)))
        assert len(flight) == 0
        return out

    assert asyncio.run(run()) == ["bytes"] * 6
    assert len(runs) == 1 and len(coalesced) == 5


def test_singleflight_fans_a_failure_out_and_survives_a_waiter_deadline():
    flight = SingleFlight()
    err = RuntimeError("fetch failed")

    async def failing():
        await asyncio.sleep(0.02)
        raise err

    async def slow():
        await asyncio.sleep(0.05)
        return "ok"

    async def run():
        got = await asyncio.gather(*(flight.run("a", failing) for _ in range(3)),
                                   return_exceptions=True)
        assert all(g is err for g in got)
        keeper = asyncio.create_task(flight.run("b", slow))
        await asyncio.sleep(0)
        with pytest.raises(DeadlineExceededError):
            await flight.run("b", slow, deadline=Deadline.after(0.01))
        assert flight.in_flight("b")
        return await keeper

    assert asyncio.run(run()) == "ok"


# ---- keyed coalescing in the batcher ---------------------------------------


class FakeEngine:
    """Counts its calls and images; `fail` (an exception) fails every batch."""

    def __init__(self, service_s=0.0, fail=None):
        self.metrics = Metrics()
        self.batch_buckets = (1, 2, 4, 8)
        self.threshold = 0.5
        self.calls: list[int] = []
        self.service_s = service_s
        self.fail = fail

    def detect(self, images):
        self.calls.append(len(images))
        if self.service_s:
            time.sleep(self.service_s)
        if self.fail is not None:
            raise self.fail
        return [[dict(d) for d in DETS] for _ in images]

    def ran_buckets(self):
        return [8] * self.calls[-1]


def _img(fill=0):
    return Image.fromarray(np.full((8, 8, 3), fill, np.uint8))


def test_keyed_submits_make_one_engine_call_and_waiters_get_copies():
    engine = FakeEngine(service_s=0.02)
    cache = result_cache.ResultCache(max_bytes=1 << 20, metrics=engine.metrics)
    batcher = MicroBatcher(engine, max_delay_ms=1.0)
    batcher.result_cache = cache

    async def run():
        outs = await asyncio.gather(*(batcher.submit(_img(), key="k") for _ in range(6)))
        await batcher.stop()
        return outs

    outs = asyncio.run(run())
    assert engine.calls == [1]
    assert engine.metrics.snapshot()["coalesced_submits_total"] == 5
    assert all(o == DETS for o in outs)
    outs[0][0]["score"] = -1.0
    outs[0].append({"label": "bed"})
    assert outs[1] == DETS and cache.get("k") == DETS
    assert len({id(o) for o in outs}) == 6
    assert len({id(o[0]) for o in outs}) == 6


def _poison_engine():
    """Fails any batch holding a bright image, as a poison input does."""
    engine = FakeEngine()

    def detect(images):
        engine.calls.append(len(images))
        if any(np.asarray(im).mean() > 200 for im in images):
            raise RuntimeError("bright image poisoned its batch")
        return [[dict(d) for d in DETS] for _ in images]

    engine.detect = detect
    return engine


def test_only_poison_is_negative_cached():
    engine = _poison_engine()
    cache = result_cache.ResultCache(max_bytes=1 << 20, metrics=engine.metrics)
    batcher = MicroBatcher(engine, max_delay_ms=50.0,
                           breaker=CircuitBreaker(threshold=100, metrics=engine.metrics))
    batcher.result_cache = cache

    async def run():
        innocent = asyncio.create_task(batcher.submit(_img()))
        got = await asyncio.gather(*(batcher.submit(_img(255), key="poison") for _ in range(3)),
                                   return_exceptions=True)
        assert await innocent == DETS
        await batcher.stop()
        return got

    got = asyncio.run(run())
    assert all(isinstance(g, PoisonImageError) for g in got) and len({id(g) for g in got}) == 1
    assert isinstance(cache.get_negative("poison"), PoisonImageError)


@pytest.mark.parametrize("kind", ["transient", "fatal", "shed", "deadline"])
def test_engine_errors_sheds_and_deadlines_are_never_negative_cached(kind):
    fail = {"transient": TransientEngineError("out of memory after the split"),
            "fatal": FatalEngineError("device lost")}.get(kind)
    engine = FakeEngine(service_s=0.3 if kind == "deadline" else 0.0, fail=fail)
    cache = result_cache.ResultCache(max_bytes=1 << 20, metrics=engine.metrics)
    batcher = MicroBatcher(engine, max_delay_ms=50.0 if kind == "shed" else 1.0)
    batcher.result_cache = cache
    want = {"transient": TransientEngineError, "fatal": FatalEngineError,
            "shed": DrainingError, "deadline": DeadlineExceededError}[kind]

    async def run():
        if kind == "shed":
            tasks = [asyncio.create_task(batcher.submit(_img(), key="k")) for _ in range(2)]
            await asyncio.sleep(0.01)
            batcher._pump_task.cancel()  # the queued entry fails unrun
            got = await asyncio.gather(*tasks, return_exceptions=True)
        elif kind == "deadline":
            got = await asyncio.gather(
                batcher.submit(_img(), deadline=Deadline.after(0.05), key="k"),
                return_exceptions=True)
            await asyncio.sleep(0.4)  # the shared flight lands after the waiter left
        else:
            got = await asyncio.gather(*(batcher.submit(_img(), key="k") for _ in range(2)),
                                       return_exceptions=True)
        await batcher.stop()
        return got

    got = asyncio.run(run())
    assert got and all(isinstance(g, want) for g in got), got
    assert cache.get_negative("k") is None and cache.stats()["negative_entries"] == 0
    # a deadline leaves the flight running: its success is a positive entry
    assert cache.stats()["entries"] == (1 if kind == "deadline" else 0)


def _png(image) -> bytes:
    buf = BytesIO()
    image.save(buf, format="PNG")
    return buf.getvalue()


class _Client:
    """Duck-typed httpx client serving fixed bytes per URL, counting fetches."""

    def __init__(self, content: dict):
        self.content = content
        self.fetches: dict[str, int] = {}

    async def get(self, url):
        self.fetches[url] = self.fetches.get(url, 0) + 1
        body = self.content[url]

        class _Resp:
            content = body

            def raise_for_status(self):
                pass

        return _Resp()

    async def aclose(self):
        pass


def test_probe_is_never_served_from_the_cache_nor_coalesced():
    """The cache holds the probe image's own bytes (filled by a user /detect);
    every probe still runs a forward, alone or beside a user's in-flight
    submit of the same image."""
    engine = FakeEngine(service_s=0.05)
    cache = result_cache.ResultCache(max_bytes=1 << 20, metrics=engine.metrics)
    plane_probe = integrity.GoldenProbe("fake")
    url = "http://cdn/probe.png"
    det = AmenitiesDetector(engine, MicroBatcher(engine, max_delay_ms=1.0),
                            _Client({url: _png(plane_probe.image)}), cache=cache)

    async def run():
        await det.detect({"image_urls": [url]})
        assert engine.calls == [1] and cache.stats()["entries"] == 1
        hits = engine.metrics.snapshot()["cache_hits_total"]
        again = await det.detect({"image_urls": [url]})
        assert engine.calls == [1]  # the user's repeat is a hit
        assert engine.metrics.snapshot()["cache_hits_total"] == hits + 1
        plane_probe.pins = {8: [dict(d) for d in DETS]}
        assert await plane_probe.run(det.batcher) is None
        assert sum(engine.calls) == 2
        # a user's keyed submit of the probe image in flight: the probe
        # does not attach to it
        key = next(iter(cache._entries))
        user = asyncio.create_task(det.batcher.submit(plane_probe.image, key=key))
        await asyncio.sleep(0.002)
        assert det.batcher.in_flight(key)
        assert await plane_probe.run(det.batcher) is None
        await user
        assert engine.metrics.snapshot()["coalesced_submits_total"] == 0
        assert sum(engine.calls) == 4
        await det.aclose()
        return again

    assert asyncio.run(run()).images[0].detections[0].label == "TV"
