"""Ragged canvas packing: the port's scheduler, staging, engine, batcher,
metrics and golden probe (spotter_tpu_torch.engine.scheduler and the layers
that carry a pack's canvas) against the JAX package on the same inputs.

- The scheduler: the port's `plan` against JAX's on seeded pending lists
  (photo sizes, classes, fixed-`remaining()` deadlines, tenants under DRR,
  query groups): the same items in the same order, the same canvas and the
  same waste, exactly.
- Staging: `batch_images_uint8` at a canvas bit equal to JAX's.
- The engine: tiny DETR and tiny Deformable-DETR `detect(imgs, canvas_hw=c)`
  against JAX's at three canvases (the full 64x64 bucket, a stride-aligned
  64x32 and an unaligned 48x64), scores atol 1e-4 and boxes atol 1e-3 px
  (tests/test_torch_detr.py's engine tolerance: fp32 on both sides summed in
  other orders). The oracle is JAX at the same canvas, never the full
  bucket: a canvas changes a shortest-edge model's answer.
- The batcher and metrics: the same packs give JAX's `padding_waste_pct`,
  `ragged_packs_total` and Prometheus lines; the canvas survives the poison
  bisect and an out-of-memory split; an engine whose `detect` takes no
  canvas gets none.
- The golden probe under ragged packing, and the perf meta's `valid_px`.

The JAX engine compiles a program per (bucket, canvas), so the engines are
module-scoped with one bucket, and the file uses three canvases.
"""

import asyncio
import random
import types

import numpy as np
import pytest
import torch
from PIL import Image

from spotter_tpu.engine.batcher import MicroBatcher as JBatcher
from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.engine.metrics import Metrics as JMetrics
from spotter_tpu.engine.scheduler import QueueItem as JItem
from spotter_tpu.engine.scheduler import Scheduler as JScheduler
from spotter_tpu.engine.scheduler import ragged_step as jragged_step
from spotter_tpu.models import detr as jdetr
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.deformable_detr import DeformableDetrDetector as JDeformable
from spotter_tpu.obs import prom as jprom
from spotter_tpu.ops import preprocess as jpre
from spotter_tpu.serving import tenancy as jtenancy
from spotter_tpu_torch.engine import scheduler as tsched
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.engine.metrics import Metrics
from spotter_tpu_torch.engine.scheduler import PackPlan, QueueItem, Scheduler
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.obs import prom
from spotter_tpu_torch.ops import preprocess as tpre
from spotter_tpu_torch.serving import integrity, standalone, tenancy
from spotter_tpu_torch.testing import faults
from tests.torch_parity import random_flax_params

DETR, DDETR = "facebook/detr-resnet-50", "SenseTime/deformable-detr"
SCORE_ATOL, BOX_ATOL = 1e-4, 1e-3
# photos (h, w) -> their canvas: the full bucket, a stride-aligned one
# (resizes 64x28, 64x29, 64x26) and an unaligned one (48x64, 36x64, 27x64)
CANVASES = {
    "bucket": ([(48, 64), (64, 48), (30, 64)], (64, 64)),
    "aligned": ([(90, 40), (100, 45), (120, 48)], (64, 32)),
    "unaligned": ([(48, 64), (36, 64), (30, 70)], (48, 64)),
}
LISTING = [(768, 1024), (800, 1200), (1024, 768), (1000, 1000), (800, 1600), (480, 640),
           (1080, 1920), (600, 800), (1333, 500)]


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 9.0 + np.arange(3)) * np.cos(yy[..., None] / 13.0)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def _photos(case):
    return [_photo(40 + i, h, w) for i, (h, w) in enumerate(CANVASES[case][0])]


def _spec(mod, size=(800, 1333), pad_to=(1333, 1333)):
    return mod.PreprocessSpec(mode="shortest_edge", size=size, mean=mod.IMAGENET_MEAN,
                              std=mod.IMAGENET_STD, pad_to=pad_to)


# --- the scheduler against JAX's ---------------------------------------------


class _Img:
    """What the scheduler reads of a photo: its height and width."""

    def __init__(self, h, w):
        self.height, self.width = h, w


class _Left:
    """A deadline whose `remaining()` is fixed, the same on both sides."""

    def __init__(self, s):
        self.s = s

    def remaining(self):
        return self.s


FEATURES = ("plain", "classes", "deadlines", "tenants", "groups", "all")


def _pending(mod, seed, n, feature):
    rng = np.random.default_rng(seed)
    on = lambda f: feature in (f, "all")  # noqa: E731
    out = []
    for i in range(n):
        h, w = (LISTING[int(rng.integers(len(LISTING)))] if rng.uniform() < 0.7
                else (int(rng.integers(100, 2000)), int(rng.integers(100, 2000))))
        out.append(mod(
            image=_Img(h, w), fut=None, t_submit=float(i),
            cls=str(rng.choice(["slo", "bulk"])) if on("classes") else "slo",
            deadline=(_Left(float(rng.uniform(0.0, 0.4))) if on("deadlines") and rng.uniform() < 0.6
                      else None),
            tenant=str(rng.choice(["acme", "hobby", "t3"])) if on("tenants") else None,
            qset=(types.SimpleNamespace(key=str(rng.choice(["a", "b"])))
                  if on("groups") and rng.uniform() < 0.5 else None),
        ))
    return out


def _schedulers(spec_mode, ragged, step, urgent_ms, tenants):
    specs = {"shortest_edge": (_spec(tpre), _spec(jpre)),
             "fixed": (tpre.PreprocessSpec(mode="fixed", size=(640, 640)),
                       jpre.PreprocessSpec(mode="fixed", size=(640, 640))),
             "none": (None, None)}[spec_mode]
    planes = [None, None]
    if tenants:
        config = {"tenants": {"acme": {"weight": 3}, "t3": {"weight": 0.5}}}
        planes = [mod.TenantPlane(config=config, clock=lambda: 1000.0, rng=random.Random(0))
                  for mod in (tenancy, jtenancy)]
    return (Scheduler(spec=specs[0], ragged=ragged, step=step, urgent_ms=urgent_ms,
                      tenancy=planes[0]),
            JScheduler(spec=specs[1], ragged=ragged, step=step, urgent_ms=urgent_ms,
                       tenancy=planes[1]))


def _assert_plans_equal(sched, jsched, seed, feature, n=40):
    pending, jpending = _pending(QueueItem, seed, n, feature), _pending(JItem, seed, n, feature)
    rng = np.random.default_rng(seed + 100)
    plans = 0
    while pending:
        target = int(rng.integers(1, 9))
        plan = sched.plan(pending, target, now=0.0, buckets=(1, 2, 4, 8))
        jplan = jsched.plan(jpending, target, now=0.0, buckets=(1, 2, 4, 8))
        assert isinstance(plan, PackPlan)
        assert [it.t_submit for it in plan.items] == [it.t_submit for it in jplan.items]
        assert plan.canvas_hw == jplan.canvas_hw
        assert plan.padding_waste_pct == jplan.padding_waste_pct
        assert [it.t_submit for it in pending] == [it.t_submit for it in jpending]
        plans += 1
    assert not jpending and plans > 1


@pytest.mark.parametrize("step,urgent_ms", [(128, 100.0), (64, 100.0), (128, 0.0), (32, 1e9)])
@pytest.mark.parametrize("feature", FEATURES)
def test_ragged_plan_matches_jax(step, urgent_ms, feature):
    sched, jsched = _schedulers("shortest_edge", True, step, urgent_ms,
                                feature in ("tenants", "all"))
    _assert_plans_equal(sched, jsched, seed=step + int(urgent_ms) % 7, feature=feature)


@pytest.mark.parametrize("feature", FEATURES)
def test_fifo_plan_and_its_waste_match_jax(feature):
    sched, jsched = _schedulers("shortest_edge", False, 128, 100.0,
                                feature in ("tenants", "all"))
    _assert_plans_equal(sched, jsched, seed=3, feature=feature)


@pytest.mark.parametrize("spec_mode", ["fixed", "none"])
def test_ragged_plan_for_other_specs_matches_jax(spec_mode):
    """A fixed spec keeps its one canvas (slack order only); no spec (a
    stub) packs by the photos' own sizes."""
    sched, jsched = _schedulers(spec_mode, True, 128, 100.0, False)
    _assert_plans_equal(sched, jsched, seed=5, feature="all")


def test_knobs_and_from_env_match_jax(monkeypatch):
    monkeypatch.setenv("SPOTTER_TPU_RAGGED_STEP", "x")
    with pytest.raises(ValueError) as mine:
        tsched.ragged_step()
    with pytest.raises(ValueError) as theirs:
        jragged_step()
    assert str(mine.value) == str(theirs.value)
    monkeypatch.setenv("SPOTTER_TPU_RAGGED_STEP", "0")
    assert tsched.ragged_step() == jragged_step() == 1
    monkeypatch.setenv("SPOTTER_TPU_RAGGED_STEP", "96")
    monkeypatch.setenv("SPOTTER_TPU_RAGGED_URGENT_MS", "40")
    monkeypatch.setenv("SPOTTER_TPU_RAGGED", "1")
    for spec, capable in ((_spec(tpre), True), (tpre.PreprocessSpec(mode="fixed"), False)):
        engine = types.SimpleNamespace(built=types.SimpleNamespace(preprocess_spec=spec))
        sched = Scheduler.from_env(engine)
        assert (sched.ragged, sched.step, sched.urgent_ms, sched.canvas_capable) == (
            True, 96, 40.0, capable)
    assert Scheduler.from_env(object()).spec is None


def test_a_probe_packs_only_at_its_own_snapped_canvas():
    """The one rule the JAX plan lacks: a pack holding an `info` item (the
    golden probe) takes only photos that fit the probe's own snapped
    canvas, so the pack's canvas is that canvas; the rest stay pending and
    the plan without the probe is JAX's."""
    sched = Scheduler(spec=_spec(tpre), ragged=True, step=128)
    big = [QueueItem(image=_Img(*hw), fut=None, t_submit=float(i))
           for i, hw in enumerate([(1024, 768), (800, 1600), (600, 800), (32, 32)])]
    probe = QueueItem(image=_Img(32, 32), fut=None, t_submit=-1.0, info={})
    pending = [probe, *big]
    plan = sched.plan(pending, 8, now=0.0)
    assert plan.items == [probe, big[3]] and plan.canvas_hw == (896, 896)
    assert pending == big[:3]
    # a probe that is not the seed joins only a pack that fits its canvas
    late = QueueItem(image=_Img(32, 32), fut=None, t_submit=9.0, info={})
    pending = [big[2], late]
    plan = sched.plan(pending, 8, now=0.0)
    assert plan.canvas_hw == (896, 1152) and plan.items == [big[2]] and pending == [late]


# --- staging against JAX's --------------------------------------------------


@pytest.mark.parametrize("case", list(CANVASES))
def test_batch_images_uint8_at_a_canvas_matches_jax(case):
    photos, canvas = _photos(case), CANVASES[case][1]
    spec, jspec = _spec(tpre, (48, 64), (64, 64)), _spec(jpre, (48, 64), (64, 64))
    want = jpre.batch_images_uint8([Image.fromarray(p) for p in photos], jspec, canvas_hw=canvas)
    out = np.full((len(photos), *canvas, 3), 255, np.uint8)  # the pinned buffer's garbage
    got = tpre.batch_images_uint8(photos, spec, out=out, canvas_hw=canvas)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(out, want[0])


def test_a_canvas_too_small_raises_jax_text_and_fixed_specs_ignore_it():
    photo = _photo(1, 48, 64)
    with pytest.raises(ValueError) as mine:
        tpre.batch_images_uint8([photo], _spec(tpre, (48, 64), (64, 64)), canvas_hw=(48, 32))
    with pytest.raises(ValueError) as theirs:
        jpre.batch_images_uint8([Image.fromarray(photo)], _spec(jpre, (48, 64), (64, 64)),
                                canvas_hw=(48, 32))
    assert str(mine.value) == str(theirs.value) == "ragged canvas 48x32 cannot hold resized image 48x64"
    fixed = tpre.PreprocessSpec(mode="fixed", size=(40, 40))
    assert not tpre.ragged_canvas_supported(fixed)
    for a, b in zip(tpre.batch_images_uint8([photo], fixed, canvas_hw=(8, 8)),
                    tpre.batch_images_uint8([photo], fixed)):
        np.testing.assert_array_equal(a, b)


def test_batch_images_float_ignores_the_canvas_as_jax():
    photo = _photo(2, 30, 50)
    spec = tpre.PreprocessSpec(mode="pad_square", size=(32, 32), mean=tpre.IMAGENET_MEAN,
                               std=tpre.IMAGENET_STD)
    jspec = jpre.PreprocessSpec(mode="pad_square", size=(32, 32), mean=jpre.IMAGENET_MEAN,
                                std=jpre.IMAGENET_STD)
    px, sizes = tpre.batch_images_float([photo], spec, canvas_hw=(16, 16))
    jpx, _, jsizes = jpre.batch_images_host([Image.fromarray(photo)], jspec, canvas_hw=(16, 16))
    np.testing.assert_array_equal(px, jpx)
    np.testing.assert_array_equal(sizes, jsizes)


# --- the engine against JAX's -----------------------------------------------


def _pixels_and_mask(seed, hw=(64, 64)):
    h, w = hw
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (2, h, w, 3)).astype(np.float32)
    mask = np.ones((2, h, w), np.float32)
    mask[0, :, (5 * w) // 8:] = 0
    mask[1, (3 * h) // 4:, :] = 0
    return x * mask[..., None], mask


def _family(name):
    x, mask = _pixels_and_mask(10)
    if name == DETR:
        cfg = jzoo.tiny_detr_config()
        module = jdetr.DetrDetector(cfg)
        params = random_flax_params(module, x[:1], mask[:1], seed=11)
        head = params["class_labels_classifier"]
        head["bias"] = head["bias"].copy()
        head["bias"][[57, 62]] += [8.0, 7.0]
        post, top = "softmax", cfg.num_queries
    else:
        cfg = jzoo.tiny_deformable_detr_config()
        module = JDeformable(cfg)
        params = random_flax_params(module, x[:1], mask[:1], seed=11)
        head = params["class_head1"]
        head["bias"] = head["bias"].copy()
        head["bias"][[57, 62, 71]] += 4.0
        post, top = "sigmoid_topk", min(100, cfg.num_queries)
    jbuilt = JBuilt(model_name=name, module=module, params=params,
                    preprocess_spec=_spec(jpre, (48, 64), (64, 64)), postprocess=post,
                    id2label=cfg.id2label_dict, num_top_queries=top, needs_mask=True)
    jengine = JEngine(jbuilt, batch_buckets=(4,), threshold=0.0)
    engine = InferenceEngine(registry.build_detector(name, tiny=True, params=params),
                             batch_buckets=(4,), device="cpu", threshold=0.0)
    return params, jengine, engine


@pytest.fixture(scope="module")
def engines():
    return {name: _family(name) for name in (DETR, DDETR)}


def _assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert [d["label"] for d in g] == [d["label"] for d in w]
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w],
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(np.asarray([d["box"] for d in g]),
                                   np.asarray([d["box"] for d in w]), atol=BOX_ATOL)


def _assert_equal(got, want):
    assert got == want  # floats compared exactly: bit equal


@pytest.mark.parametrize("case", list(CANVASES))
@pytest.mark.parametrize("name", [DETR, DDETR], ids=["detr", "ddetr"])
def test_engine_detect_at_a_canvas_matches_jax(engines, name, case):
    _, jengine, engine = engines[name]
    photos, canvas = _photos(case), CANVASES[case][1]
    want = jengine.detect([Image.fromarray(p) for p in photos], canvas_hw=canvas)
    got = engine.detect(photos, canvas_hw=canvas)
    _assert_close(got, want)


@pytest.mark.parametrize("name", [DETR, DDETR], ids=["detr", "ddetr"])
def test_full_bucket_canvas_and_garbage_in_the_pad_are_bit_equal(engines, name, monkeypatch):
    """The full bucket as a canvas is the static bucket; and whatever a
    staging buffer held before (garbage here) never reaches the answer:
    every pad byte, pad row and valid extent is written."""
    _, _, engine = engines[name]
    photos = _photos("bucket")
    _assert_equal(engine.detect(photos, canvas_hw=(64, 64)), engine.detect(photos))
    photos = _photos("aligned")
    clean = engine.detect(photos, canvas_hw=(64, 32))
    host_buffer = engine._host_buffer

    def garbage(shape, dtype):
        buf = host_buffer(shape, dtype)
        buf.fill_(255 if dtype == torch.uint8 else 7)
        return buf

    monkeypatch.setattr(engine, "_host_buffer", garbage)
    _assert_equal(engine.detect(photos, canvas_hw=(64, 32)), clean)


@pytest.mark.parametrize("canvas", [None, (64, 32)], ids=["bucket", "canvas"])
def test_perf_meta_valid_px_matches_jax(engines, canvas):
    """The repair: `valid_px` sums each real row's resize clipped to the
    canvas (not every row's whole canvas), as JAX's `_perf_meta`."""
    _, jengine, engine = engines[DETR]
    photos = _photos("aligned")[:2]
    jmeta = jengine._stage_host([Image.fromarray(p) for p in photos], canvas)[4]
    meta = engine._stage_host(photos, canvas)[4]
    # the shape keys differ only in the pixel dtype: JAX stages float32 by
    # default, the port uint8
    assert (meta["valid_px"], meta["padded_px"], meta["shape"].split(":", 1)[1]) == (
        jmeta["valid_px"], jmeta["padded_px"], jmeta["shape"].split(":", 1)[1])
    assert meta["valid_px"] == 64 * 28 + 64 * 29


def test_an_out_of_memory_split_keeps_the_canvas(engines, monkeypatch):
    _, _, engine = engines[DETR]
    photos = _photos("aligned")
    want = engine.detect(photos, canvas_hw=(64, 32))
    seen = []
    stage = engine._stage_host
    monkeypatch.setattr(engine, "_stage_host",
                        lambda chunk, canvas_hw=None, qset=None: seen.append(
                            (len(chunk), canvas_hw)) or stage(chunk, canvas_hw, qset))
    with faults.inject(engine_oom=1):
        got = engine.detect(photos, canvas_hw=(64, 32))
    assert seen == [(3, (64, 32)), (2, (64, 32)), (1, (64, 32))]
    _assert_close(got, want)


# --- the batcher and its metrics --------------------------------------------


class _Engine:
    """An engine whose detect takes a canvas: records each call's."""

    batch_buckets = (1, 2, 4)

    def __init__(self, metrics, spec, poison=None):
        self.metrics = metrics
        self.built = types.SimpleNamespace(preprocess_spec=spec)
        self.calls = []
        self.poison = poison

    def detect(self, images, canvas_hw=None, qset=None):
        self.calls.append((len(images), canvas_hw))
        if any(img is self.poison for img in images):
            raise RuntimeError("bad pixels")
        return [[{"label": "tv", "score": 0.9, "box": [0.0, 0.0, 1.0, 1.0]}] for _ in images]


def _run_batcher(batcher, images, waves=1):
    async def run():
        try:
            for _ in range(waves):
                await asyncio.gather(*(batcher.submit(img) for img in images),
                                     return_exceptions=True)
        finally:
            await batcher.stop()

    asyncio.run(run())


def _prom_lines(text):
    return sorted(line for line in text.splitlines()
                  if "padding_waste" in line or "ragged_packs" in line)


@pytest.mark.parametrize("ragged", [False, True], ids=["fifo", "ragged"])
def test_pack_metrics_and_prometheus_match_jax(ragged):
    images = [_Img(*hw) for hw in LISTING[:7]]
    sides = []
    for batcher_cls, metrics_cls, mod, prom_mod, sched_cls in (
            (MicroBatcher, Metrics, tpre, prom, Scheduler),
            (JBatcher, JMetrics, jpre, jprom, JScheduler)):
        spec = _spec(mod)
        engine = _Engine(metrics_cls(), spec)
        batcher = batcher_cls(engine, max_delay_ms=50.0, limiter=None, brownout=None,
                              scheduler=sched_cls(spec=spec, ragged=ragged))
        _run_batcher(batcher, images, waves=2)
        snap = engine.metrics.snapshot()
        sides.append((engine.calls, snap["padding_waste_pct"], snap["ragged_packs_total"],
                      _prom_lines(prom_mod.render(snap))))
    assert sides[0] == sides[1]
    calls, waste, packs, lines = sides[0]
    assert waste > 0 and packs == (len(calls) if ragged else 0) and len(lines) == 4
    assert all((canvas is None) != ragged for _, canvas in calls)


def test_the_canvas_rides_through_the_poison_bisect():
    poison = _Img(480, 640)
    images = [_Img(480, 640), _Img(600, 800), poison, _Img(480, 640)]
    engine = _Engine(Metrics(), _spec(tpre), poison=poison)
    batcher = MicroBatcher(engine, max_delay_ms=50.0, limiter=None, brownout=None,
                           scheduler=Scheduler(spec=_spec(tpre), ragged=True))
    _run_batcher(batcher, images)
    assert engine.calls == [(4, (896, 1152)), (2, (896, 1152)), (2, (896, 1152)),
                            (1, (896, 1152)), (1, (896, 1152))]
    assert engine.metrics.snapshot()["poison_isolated_total"] == 1


def test_an_engine_without_a_canvas_argument_gets_none():
    """A stub's `detect(images)`: the slack order and the waste, no canvas."""
    calls = []

    class Stub:
        batch_buckets = (1, 2, 4)
        metrics = Metrics()

        def detect(self, images):
            calls.append(len(images))
            return [[] for _ in images]

    batcher = MicroBatcher(Stub(), max_delay_ms=50.0, limiter=None, brownout=None,
                           scheduler=Scheduler(ragged=True))
    _run_batcher(batcher, [_Img(*hw) for hw in LISTING[:3]])
    snap = Stub.metrics.snapshot()
    assert calls == [3] and snap["ragged_packs_total"] == 0
    assert snap["padding_waste_pct"] > 0


def test_standalone_ragged_flag_sets_the_env(monkeypatch):
    monkeypatch.setenv("SPOTTER_TPU_RAGGED", "0")
    ran = []
    monkeypatch.setattr(standalone, "make_app", lambda **kw: kw)
    monkeypatch.setattr(standalone.web, "run_app", lambda app, **kw: ran.append(app))
    standalone.main(["--ragged", "--no-warmup", "--device", "cpu"])
    assert ran and tsched.ragged_enabled()


# --- the golden probe under ragged packing ----------------------------------


def _probe_replica(params, step=16):
    engine = InferenceEngine(registry.build_detector(DETR, tiny=True, params=params),
                             batch_buckets=(1, 2, 4), device="cpu")
    batcher = MicroBatcher(engine, max_delay_ms=20.0, limiter=None, brownout=None,
                           scheduler=Scheduler(spec=engine.built.preprocess_spec, ragged=True,
                                               step=step))
    plane = integrity.IntegrityPlane(engine, batcher, family="detr", probe_interval_s=0,
                                     attest_interval_s=0, exit_cb=lambda code: None)
    return engine, batcher, plane


def test_probe_holds_under_mixed_sizes_and_catches_a_perturbed_weight(engines):
    """The probe (32x32, staged 48x48, its canvas 48x48 at step 16) shares
    packs with photos that fit that canvas and never with larger ones; it
    passes on a healthy replica serving mixed sizes, and fails once a weight
    is perturbed. A larger canvas would have moved its answer."""
    params = engines[DETR][0]

    async def run():
        engine, batcher, plane = _probe_replica(params)
        try:
            assert await plane.verify("cold-start")
            assert plane.probe.canvas == (48, 48) and sorted(plane.probe.pins) == [1, 2, 4]
            mixed = [_photo(60 + i, *hw) for i, hw in
                     enumerate([(64, 48), (40, 40), (48, 64), (30, 64), (36, 36)])]
            for _ in range(2):
                results = await asyncio.gather(
                    plane.probe.run(batcher), *(batcher.submit(p) for p in mixed))
                assert results[0] is None, plane.probe.last_error
            assert plane.probe.failures_total == 0
            assert engine.metrics.snapshot()["ragged_packs_total"] > 0
            probe = np.asarray(plane.probe.image)
            own, wide = (engine.detect([probe], canvas_hw=c)[0] for c in ((48, 48), (64, 64)))
            assert own != wide  # the canvas changes the answer
            with torch.no_grad():  # the couch logit's bias, which its detections ride on
                engine.model.class_labels_classifier.bias[57] -= 20.0
            reason = await plane.probe.run(batcher)
            assert reason is not None and plane.probe.failures_total == 1
        finally:
            await batcher.stop()

    asyncio.run(run())


def test_a_probe_at_another_canvas_fails():
    class Batcher:
        canvas = (48, 48)

        async def submit(self, image, cls=None, info=None):
            info["bucket"], info["canvas"] = 1, self.canvas
            return [{"label": "tv", "score": 0.9, "box": [1.0, 2.0, 3.0, 4.0]}]

    probe, batcher = integrity.GoldenProbe("x"), Batcher()
    assert asyncio.run(probe.pin(batcher, (1,))) is None and probe.canvas == (48, 48)
    assert asyncio.run(probe.run(batcher)) is None
    batcher.canvas = (64, 64)
    assert asyncio.run(probe.run(batcher)) == "probe ran at canvas (64, 64), its pins at (48, 48)"


def test_a_smaller_canvas_changes_the_backbone_where_the_image_spills_into_the_pad():
    """Why the canvas changes the answer (and why the JAX package's
    ragged-vs-bucket reference test fails): each convolution spreads the
    image's signal into the zero pad next to it, so the pad's features near
    the image are not zero even with every bias and BN shift zero (the tiny
    random init's); a smaller canvas cuts them off and the convolutions there
    see zero padding instead. The stem's output agrees on the canvas's
    columns; the first 3x3 block's does not, at a stride-aligned canvas."""
    import torch.nn.functional as F

    built = registry.build_detector(DETR, tiny=True, seed=3)
    bb, spec = built.module.eval().backbone, built.preprocess_spec
    assert all(not m.folded()[1].any() for m in bb.modules() if hasattr(m, "folded"))
    photo = _photo(70, 100, 42)  # resized 64x26

    def stem_and_block(canvas):
        px, valid, _ = tpre.batch_images_uint8([photo], spec, canvas_hw=canvas)
        x, _ = tpre.device_rescale_normalize_masked(torch.from_numpy(px),
                                                    torch.from_numpy(valid), spec)
        with torch.inference_mode():
            stem = F.max_pool2d(bb.stem0(x.permute(0, 3, 1, 2)), 3, 2, padding=1)
            return stem, bb.stage0_block0(stem)

    (stem_a, block_a), (stem_b, block_b) = stem_and_block((64, 64)), stem_and_block((64, 32))
    w = stem_b.shape[-1]
    assert torch.equal(stem_a[..., :w], stem_b) and not stem_a[..., w:].any()
    assert (block_a[..., :w] - block_b).abs().max() > 0.01


def test_the_jax_probe_fails_beside_larger_photos_where_the_ports_holds(engines):
    """The JAX plane under ragged packing (a fault in the reference): its
    probe, self-pinned alone at its own snapped canvas, then packed with a
    48x64 and a 64x48 photo (canvas 64x64), leaves compare's tolerance of its
    pin on a healthy replica, which would exit 86. The port's scheduler keeps
    the probe out of that pack, so the same traffic passes."""
    from spotter_tpu.engine.batcher import MicroBatcher as JMicroBatcher
    from spotter_tpu.serving import integrity as jintegrity

    params, jengine, engine = engines[DETR]
    others = [_photo(7, 48, 64), _photo(8, 64, 48)]

    async def run(probe, batcher, pin):
        try:
            assert await pin is None
            got = await asyncio.gather(probe.run(batcher),
                                       *(batcher.submit(Image.fromarray(p)) for p in others))
            return got[0]
        finally:
            await batcher.stop()

    jprobe = jintegrity.GoldenProbe("detr")
    jbatcher = JMicroBatcher(jengine, max_delay_ms=20.0, limiter=None, brownout=None,
                             scheduler=JScheduler(spec=jengine.built.preprocess_spec,
                                                  ragged=True, step=16))
    reason = asyncio.run(run(jprobe, jbatcher, jprobe.run(jbatcher)))  # the JAX probe self-pins
    assert reason is not None and "outside tol" in reason
    probe = integrity.GoldenProbe("detr")
    batcher = MicroBatcher(engine, max_delay_ms=20.0, limiter=None, brownout=None,
                           scheduler=Scheduler(spec=engine.built.preprocess_spec, ragged=True,
                                               step=16))
    assert asyncio.run(run(probe, batcher, probe.pin(batcher, engine.batch_buckets))) is None
    assert probe.canvas == (48, 48)
