"""The engine's CUDA graphs on the card, on a tiny RT-DETR (the CPU never
captures, so these skip there):

- `warmup` captures one graph per bucket, each recorded in the capture
  ledger with source `warmup`; every replay is bit equal to the eager
  `_forward` on the same pixels, and adds its captured launch counts (the
  MSDA gather-sum once per decoder layer);
- `detect` replays: the launch counts equal decoder layers x forwards, and
  a multi-chunk `detect` equals its serial chunks exactly;
- a knob change (SPOTTER_TPU_MSDA_PREP xla -> kernel) gives a new capture
  (source `traffic`) behind its first forward, never a stale replay;
- `attest()` on the card names `device:0` after `corrupt_weights(1)`.

This file imports torch and the port only:

    python -m pytest -m cuda tests/test_torch_engine_cuda.py
"""

import numpy as np
import pytest
import torch

from spotter_tpu_torch.engine import graphs
from spotter_tpu_torch.engine.engine import InferenceEngine, graph_ledger_key
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.ops import msda

pytestmark = pytest.mark.cuda
MODEL = "PekingU/rtdetr_v2_r101vd"


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    msda.MSDA_PREP = "xla"
    eng = InferenceEngine(registry.build_detector(MODEL, tiny=True, seed=4), device="cuda")
    eng.warmup()
    return eng


def _photos(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (48 + 8 * i, 80, 3), dtype=np.uint8) for i in range(n)]


def test_warmup_captures_one_graph_per_bucket(engine):
    assert len(engine.graphs) == len(engine.batch_buckets)
    shapes = engine.metrics.snapshot()["compile_shapes"]
    assert [s["source"] for s in shapes] == ["warmup"] * len(engine.batch_buckets)
    layers = engine.model.config.decoder_layers
    assert all(g.counts == {"msda_gather_sum": layers} for g in engine.graphs.values())


@torch.inference_mode()
def test_each_replay_is_bit_equal_to_the_eager_forward(engine):
    h, w = engine.built.preprocess_spec.input_hw
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b in engine.batch_buckets:
        px = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen)
        sz = torch.full((b, 2), 480.0, device="cuda")
        eager = engine._forward(px, sz)
        before = msda.msda_gather_sum.launches
        graph = engine.graphs[graphs.graph_key(engine._shape_key(b, h, w))]
        replayed = [t.clone() for t in graph.replay((px, sz, None, None, None))]
        assert msda.msda_gather_sum.launches - before == engine.model.config.decoder_layers
        for e, r in zip(eager, replayed):
            assert torch.equal(e, r), b


def test_detect_replays_and_counts_every_launch(engine):
    photos = _photos(19)
    msda.msda_gather_sum.launches = 0
    got = engine.detect(photos)
    serial = engine.detect(photos[:8]) + engine.detect(photos[8:16]) + engine.detect(photos[16:])
    assert got == serial
    assert msda.msda_gather_sum.launches == engine.model.config.decoder_layers * 6
    assert sum(g.replays for g in engine.graphs.values()) >= 6


def test_knob_change_captures_anew(engine):
    photos = _photos(8, seed=3)
    msda.msda_loc_sum.launches = msda.msda_gather_sum.launches = 0
    try:
        msda.MSDA_PREP = "kernel"
        key = graphs.graph_key(engine._shape_key(8, *engine.built.preprocess_spec.input_hw))
        assert key not in engine.graphs
        engine.detect(photos)
        assert key in engine.graphs and engine.graphs[key].replays == 0
        for _ in range(2):
            engine.detect(photos)
        assert engine.graphs[key].replays == 2 and engine.graphs[key].counts == {
            "msda_loc_sum": engine.model.config.decoder_layers}
        assert msda.msda_loc_sum.launches == 3 * engine.model.config.decoder_layers
        assert msda.msda_gather_sum.launches == 0
        shapes = {s["shape"]: s for s in engine.metrics.snapshot()["compile_shapes"]}
        assert shapes[graph_ledger_key(key)]["source"] == "traffic"
    finally:
        msda.MSDA_PREP = "xla"


def test_attest_names_the_card(engine):
    assert engine.attest()["ok"]
    engine.corrupt_weights(1)
    bad = engine.attest()
    assert bad["mismatched"] == ["device:0"]
    engine.reload_weights()
    assert engine.attest()["ok"]


def test_a_new_key_in_fresh_worker_threads_captures_and_replays(engine):
    """The batcher calls `detect` from worker threads. A new key's capture
    runs right behind its eager forward in the same thread: cuDNN and cuBLAS
    keep their plans per thread, and a capture in a thread that had not run
    the forward failed under capture on the card (cuDNN's internal
    allocation). Each call here runs in a thread of its own."""
    from concurrent.futures import ThreadPoolExecutor

    photos = _photos(8, seed=5)
    try:
        msda.MSDA_PREP = "fused"
        key = graphs.graph_key(engine._shape_key(8, *engine.built.preprocess_spec.input_hw))
        results = []
        for _ in range(3):
            with ThreadPoolExecutor(max_workers=1) as pool:
                results.append(pool.submit(engine.detect, photos).result())
        assert results[0] == results[1] == results[2]
        assert engine.graphs[key].replays == 2
    finally:
        msda.MSDA_PREP = "xla"


FAMILY_CASES = [  # (MODEL_NAME, knobs on ops.msda, dtype policy, int8 switches)
    ("PekingU/rtdetr_v2_r101vd", {}, "float32", False),
    ("PekingU/rtdetr_v2_r101vd", {"MSDA_PREP": "fused"}, "bfloat16", True),
    ("hustvl/yolos-base", {}, "mixed", False),
    ("SenseTime/deformable-detr", {}, "float32", False),
    ("SenseTime/deformable-detr", {"MSDA_BACKEND": "pallas_sep"}, "float32", False),
    ("SenseTime/deformable-detr", {"MSDA_BACKEND": "pallas_gather"}, "float32", False),
    ("facebook/detr-resnet-50", {}, "float32", False),
    ("microsoft/conditional-detr-resnet-50", {}, "float32", False),
    ("IDEA-Research/dab-detr-resnet-50", {}, "float32", False),
    ("google/owlv2-base-patch16-ensemble", {}, "float32", False),
    ("google/owlvit-base-patch32", {}, "bfloat16", False),
]


@pytest.mark.parametrize("name,knobs,policy,int8", FAMILY_CASES,
                         ids=[f"{c[0].split('/')[1]}-{c[2]}-{i}" for i, c in
                              enumerate(FAMILY_CASES)])
def test_every_family_captures_and_replays(monkeypatch, name, knobs, policy, int8):
    """Each family (tiny) on the card: warmup captures every bucket, and a
    detect (and, for OWL, a detect against a request's query set, captured
    at its first use) replays bit equal to the first eager answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from spotter_tpu_torch.caching.text_cache import TextQueryResolver
    from spotter_tpu_torch.utils import quant

    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    for attr, value in knobs.items():
        monkeypatch.setattr(msda, attr, value)
    if int8:
        for attr, value in (("INT8", True), ("INT8_MIN_CH", 8), ("INT8_MIN_BATCH", 1)):
            monkeypatch.setattr(quant, attr, value)
    built = registry.build_detector(name, tiny=True, seed=1)
    eng = InferenceEngine(built, batch_buckets=(1, 4), device="cuda")
    eng.warmup()
    assert len(eng.graphs) == 2
    photos = _photos(5, seed=7)
    first = eng.detect(photos)
    assert eng.detect(photos) == first
    if built.text_encoder is not None:
        qs = TextQueryResolver(name, built.text_encoder).resolve(["couch", "dog", "tv"])
        before = len(eng.graphs)
        got = [eng.detect(photos[:3], qset=qs) for _ in range(2)]
        assert got[0] == got[1] and len(eng.graphs) == before + 1
