"""The engine's full form on the CPU, held against the JAX package's engine
on one module-scoped tiny RT-DETR (numpy-seeded flax params carried across
by `convert.from_jax`, the tiny spec's 64x64 photos so both resizes are the
identity):

- a pipelined `detect` of 19 photos over buckets (1, 2, 4, 8), three chunks
  in flight two at a time, equals the JAX `InferenceEngine.detect` on the
  same photos, in order (labels equal, scores within 1e-4, boxes within
  1e-3 px, the tolerance of tests/test_torch_engine.py), and equals the
  port's own serial calls exactly; its stage windows are the JAX engine's
  four, and the ledger counts its FLOPs;
- an out-of-memory error injected into the second chunk's forward is
  recovered in order (split in half, retried once);
- the decode pool's queue returns to 0 and its gauge is in the snapshot;
- `_host_checksum` and `_attest_sum` equal the JAX `_host_checksum` on the
  same numpy arrays of five dtypes; `attest()` passes, fails after
  `corrupt_weights(1)` naming `device:0`, and passes after
  `reload_weights()`; `weights_digest` reaches /metrics' identity block.
"""

import asyncio

import ml_dtypes
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from spotter_tpu.engine import engine as jengine_mod
from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu.ops.preprocess import PreprocessSpec as JSpec
from spotter_tpu_torch.engine import engine as tengine_mod
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from spotter_tpu_torch.serving.standalone import make_app
from tests.torch_parity import random_flax_params

MODEL = "PekingU/rtdetr_v2_r101vd"
BUCKETS = (1, 2, 4, 8)
N_PHOTOS = 19


def _photo(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64]
    base = 127 + 90 * np.sin(xx[..., None] / 7.0 + np.arange(3)) * np.cos(yy[..., None] / 9.0)
    return np.clip(base + rng.normal(0, 20, (64, 64, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def engines():
    """(JAX detections of the 19 photos, port engine, photos) on one tiny
    RT-DETR's weights."""
    cfg = jzoo.tiny_rtdetr_config()
    jmodule = JRTDetr(cfg)
    params = random_flax_params(jmodule, np.zeros((1, 64, 64, 3), np.float32), seed=17)
    jbuilt = JBuilt(
        model_name=MODEL, module=jmodule, params=params,
        preprocess_spec=JSpec(mode="fixed", size=(64, 64)), postprocess="sigmoid_topk",
        id2label=cfg.id2label_dict, num_top_queries=min(300, cfg.num_queries),
    )
    photos = [_photo(s) for s in range(100, 100 + N_PHOTOS)]
    want = JEngine(jbuilt, batch_buckets=BUCKETS).detect([Image.fromarray(p) for p in photos])
    teng = InferenceEngine(registry.build_detector(MODEL, tiny=True, params=params),
                           batch_buckets=BUCKETS, device="cpu")
    return want, teng, photos


def _assert_same(got, want, score_tol=1e-4, box_tol=1e-3):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [d["label"] for d in g] == [d["label"] for d in w]
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w],
                                   atol=score_tol)
        np.testing.assert_allclose(np.asarray([d["box"] for d in g]).reshape(-1, 4),
                                   np.asarray([d["box"] for d in w]).reshape(-1, 4), atol=box_tol)


def test_pipelined_detect_equals_the_jax_engine_in_order(engines):
    want, teng, photos = engines
    batches0 = teng.metrics.snapshot()["batches_total"]
    got = teng.detect(photos)
    assert sum(len(d) for d in got) > 0
    _assert_same(got, want)
    # the same photos one chunk at a time: exactly the pipelined answer
    serial = []
    for i in range(0, N_PHOTOS, 8):
        serial += teng.detect(photos[i:i + 8])
    assert got == serial
    snap = teng.metrics.snapshot()
    assert snap["batches_total"] - batches0 == 6
    for stage in ("decode", "h2d", "device", "postprocess"):
        assert snap[f"stage_{stage}_ms_p50"] >= 0.0
    assert snap["h2d_bytes_total"] > 0 and snap["h2d_bytes_per_image"] > 64 * 64 * 3
    flops = teng.metrics.perf.flops_for("u8:8x64x64")
    assert flops and flops == pytest.approx(2 * teng.metrics.perf.flops_for("u8:4x64x64"),
                                            rel=1e-6)
    assert snap["mfu_pct"] > 0 and snap["compiles_total"] == 0  # the CPU never captures


def test_oom_in_the_second_chunk_recovers_in_order(engines, monkeypatch):
    want, teng, photos = engines
    run = teng._run_forward
    calls = []

    def flaky(shape, inputs):
        calls.append(shape)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return run(shape, inputs)

    monkeypatch.setattr(teng, "_run_forward", flaky)
    retries0 = teng.metrics.snapshot()["batch_retries_total"]
    got = teng.detect(photos)
    _assert_same(got, want)
    # 8 | 8 fails -> 4 + 4 | 3 padded to 4
    assert calls == ["u8:8x64x64", "u8:8x64x64", "u8:4x64x64", "u8:4x64x64", "u8:4x64x64"]
    assert teng.metrics.snapshot()["batch_retries_total"] == retries0 + 1


def test_decode_pool_queue_returns_to_zero(engines):
    _, teng, photos = engines
    assert teng.decode_pool.workers >= 1
    teng.detect(photos[:5])
    assert teng.decode_pool.queue_depth() == 0
    assert teng.metrics.snapshot()["decode_pool_queue_depth"] == 0
    seen = []
    teng.decode_pool.map(lambda x: seen.append(teng.decode_pool.queue_depth()), [1, 2, 3])
    assert teng.decode_pool.queue_depth() == 0 and len(seen) == 3


def _arrays():
    rng = np.random.default_rng(5)
    return [
        rng.standard_normal((7, 5)).astype(np.float32),
        rng.standard_normal(33).astype(np.float32).astype(ml_dtypes.bfloat16),
        rng.integers(-128, 128, (4, 9), dtype=np.int8),
        rng.integers(-2**31, 2**31 - 1, 17, dtype=np.int32),
        rng.integers(0, 2, (3, 3)).astype(bool),
    ]


@pytest.mark.parametrize("i", range(5), ids=["float32", "bfloat16", "int8", "int32", "bool"])
def test_checksums_equal_the_jax_host_checksum(i):
    a = _arrays()[i]
    want = jengine_mod._host_checksum(a)
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        host = a.view(np.uint16)
    else:
        t, host = torch.from_numpy(a), a
    assert tengine_mod._host_checksum(host) == want
    assert tengine_mod._attest_sum(t) == want
    assert tengine_mod._host_checksum(tengine_mod._host_array(t)) == want


def test_attest_then_corrupt_then_reload(engines):
    _, teng, _ = engines
    ok = teng.attest()
    assert ok["ok"] and ok["checked"] == 1 and ok["observed"] == ok["expected"]
    assert list(ok["observed"]) == ["device:0"]
    teng.corrupt_weights(1)
    bad = teng.attest()
    assert not bad["ok"] and bad["mismatched"] == ["device:0"]
    teng.reload_weights()
    assert teng.attest() == ok


def test_weights_digest_reaches_the_identity_block(engines, monkeypatch):
    _, teng, _ = engines
    digest = teng.weights_digest()
    assert len(digest) == 12 and digest == teng.weights_digest()
    other = InferenceEngine(registry.build_detector("hustvl/yolos-base", tiny=True),
                            device="cpu", batch_buckets=(1,))
    assert other.weights_digest() != digest

    async def metrics_identity():
        det = AmenitiesDetector(teng, MicroBatcher(teng, max_delay_ms=1.0))
        async with TestClient(TestServer(make_app(detector=det, model_name=MODEL))) as client:
            body = await (await client.get("/metrics")).json()
        return body["replica"]

    monkeypatch.delenv("SPOTTER_TPU_WEIGHTS_DIGEST", raising=False)
    assert asyncio.run(metrics_identity())["weights_digest"] == digest
    monkeypatch.setenv("SPOTTER_TPU_WEIGHTS_DIGEST", "pinned-abc")
    teng.metrics.set_identity(weights_digest="pinned-abc")
    assert asyncio.run(metrics_identity())["weights_digest"] == "pinned-abc"


def test_flops_counting_forward_is_not_counted(monkeypatch):
    """A key's first forward counts its FLOPs in a forward of its own; that
    forward serves no chunk, so the quantized-call counts (and, on the card,
    the launch counts) grow by one forward only."""
    from spotter_tpu_torch.utils import quant

    for attr, value in (("INT8", True), ("INT8_MIN_CH", 8), ("INT8_MIN_BATCH", 1)):
        monkeypatch.setattr(quant, attr, value)
    built = registry.build_detector(MODEL, tiny=True, seed=2)
    quant.reset_calls()
    with torch.inference_mode():
        built.module.eval()(torch.zeros(1, 64, 64, 3))
    per_forward = dict(quant.CALLS)
    assert per_forward["conv"] > 0
    eng = InferenceEngine(built, batch_buckets=(4,), device="cpu")
    quant.reset_calls()
    eng.detect([_photo(s) for s in range(3)])
    assert dict(quant.CALLS) == per_forward
    assert eng.metrics.perf.flops_for("u8:1x64x64") > 0
