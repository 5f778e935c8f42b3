"""DETR and Table-Transformer: the port (spotter_tpu_torch.models.detr and
its shortest-edge serving path) against the JAX package on the same weights.

Flax params are drawn from a numpy seed (tests/torch_parity.py) and carried
across with `convert.from_jax` (strict: no missing and no unexpected key);
both sides run the same NHWC pixels and pixel mask in fp32 on the CPU.

Tolerances are the Deformable-DETR ones (tests/test_torch_deformable_detr.py):
boxes atol 2e-4, logits atol 5e-4, both rtol 1e-3, fp32 on both sides
summed in other orders through the backbone, the masked attention and the
heads. The mask and sine tables are held exactly.
"""

import asyncio
import dataclasses
import os
from io import BytesIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.models import detr as jdetr
from spotter_tpu.models import registry as jregistry
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.ops import preprocess as jpre
from spotter_tpu.serving import standalone as jstandalone
from spotter_tpu.serving.detector import AmenitiesDetector as JDetector
from spotter_tpu_torch.convert.from_jax import load_from_jax, state_dict_from_jax
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import configs as tconfigs
from spotter_tpu_torch.models import detr as tdetr
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from tests.torch_parity import random_flax_params

MODEL = "facebook/detr-resnet-50"
BOX_ATOL, LOGIT_ATOL, RTOL = 2e-4, 5e-4, 1e-3


def _pixels_and_mask(seed, hw=(64, 64)):
    """Two images, each with its own padded region, pad pixels 0 as the
    DETR processor leaves them."""
    h, w = hw
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (2, h, w, 3)).astype(np.float32)
    mask = np.ones((2, h, w), np.float32)
    mask[0, :, (5 * w) // 8:] = 0
    mask[1, (3 * h) // 4:, :] = 0
    return x * mask[..., None], mask


def _configs(pre_norm):
    return (dataclasses.replace(jzoo.tiny_detr_config(), pre_norm=pre_norm),
            dataclasses.replace(tzoo.tiny_detr_config(), pre_norm=pre_norm))


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("pre_norm", [False, True], ids=["detr", "table_transformer"])
def test_tiny_detr_matches_jax(pre_norm, masked):
    jcfg, tcfg = _configs(pre_norm)
    jmodel = jdetr.DetrDetector(jcfg)
    x, mask = _pixels_and_mask(1)
    params = random_flax_params(jmodel, x[:1], mask[:1], seed=3)
    jargs = (x, mask) if masked else (x,)
    jout = jax.jit(jmodel.apply)({"params": params}, *jargs)
    model = load_from_jax(tdetr.DetrDetector(tcfg).eval(), params)
    assert hasattr(model, "encoder_layernorm") == pre_norm
    with torch.inference_mode():
        tout = model(*(torch.from_numpy(a) for a in jargs))
    assert set(tout) == set(jout) == {"logits", "pred_boxes"}
    assert tout["logits"].shape == (2, 9, 81)
    np.testing.assert_allclose(tout["pred_boxes"].numpy(), np.asarray(jout["pred_boxes"]),
                               atol=BOX_ATOL, rtol=RTOL)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=LOGIT_ATOL, rtol=RTOL)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_flax_params_load_strictly(pre_norm):
    """Every flax leaf has a port key and every port key a leaf, the root
    `query_pos` among them; the state-dict keys are flax's paths."""
    jcfg, tcfg = _configs(pre_norm)
    x, mask = _pixels_and_mask(2)
    params = random_flax_params(jdetr.DetrDetector(jcfg), x[:1], mask[:1], seed=5)
    model = tdetr.DetrDetector(tcfg)
    sd = state_dict_from_jax(params, model)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(sd["query_pos"].numpy(), params["query_pos"])


@pytest.mark.parametrize("temperature", [10000.0, (20.0, 20.0), (20.0, 300.0)])
def test_sine_position_from_mask_matches_jax(temperature):
    """The denominators are the JAX package's numpy float32 table bit for
    bit, and the angles they divide are equal too; XLA's CPU sin/cos and
    PyTorch's differ by one float32 ulp on a few of them, so the table is
    held to one ulp of 1 (2**-23)."""
    _, mask = _pixels_and_mask(3, (7, 11))
    for temp in (temperature if isinstance(temperature, tuple) else (temperature,)):
        want_t = temp ** (2.0 * (np.arange(16, dtype=np.float32) // 2) / 16)
        assert tdetr.dim_t(16, temp).dtype == np.float32
        np.testing.assert_array_equal(tdetr.dim_t(16, temp), want_t)
    want = np.asarray(jdetr.sine_position_from_mask(jnp.asarray(mask), 16, temperature))
    got = tdetr.sine_position_from_mask(torch.from_numpy(mask), 16, temperature).numpy()
    assert got.shape == (2, 7, 11, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-23)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 64), (2, 2)), ((1333, 1333), (42, 42)),
                                          ((45, 38), (13, 7)), ((10, 10), (10, 10)),
                                          ((7, 5), (9, 11))])
def test_nearest_downsample_mask_matches_jax_exactly(in_hw, out_hw):
    rng = np.random.default_rng(4)
    mask = (rng.uniform(size=(2, *in_hw)) > 0.3).astype(np.float32)
    want = np.asarray(jdetr.nearest_downsample_mask(jnp.asarray(mask), out_hw))
    got = tdetr.nearest_downsample_mask(torch.from_numpy(mask), out_hw).numpy()
    np.testing.assert_array_equal(got, want)


def test_additive_mask_is_float32_min_not_inf():
    m = tdetr.additive_mask(torch.tensor([[1.0, 0.0, 1.0]]))
    assert m.shape == (1, 1, 1, 3) and m.dtype == torch.float32
    assert m[0, 0, 0].tolist() == [0.0, torch.finfo(torch.float32).min, 0.0]


def test_the_masked_encoder_takes_the_materialised_path(monkeypatch):
    """The encoder's self-attention always has a mask, so even past the
    attention kernel's cutover with flash enabled it never calls the kernel
    (as the JAX package never reaches its Pallas kernel here). At 320x320
    the encoder has 100 tokens; the cutover is put there, above the
    decoder's 9 queries."""
    from spotter_tpu_torch.models import layers

    def kernel(*args):
        raise AssertionError("the attention kernel was called")

    monkeypatch.setattr(layers, "flash_attention_enabled", lambda x: True)
    monkeypatch.setattr(layers, "FLASH_ATTN_MIN_SEQ", 100)
    monkeypatch.setattr(layers, "flash_self_attention", kernel)
    for pre_norm in (False, True):
        cfg = dataclasses.replace(tzoo.tiny_detr_config(), pre_norm=pre_norm)
        model = tzoo.init_detr(tdetr.DetrDetector(cfg).eval())
        x, mask = _pixels_and_mask(5, (320, 320))
        with torch.inference_mode():
            out = model(torch.from_numpy(x))
            out_masked = model(torch.from_numpy(x), torch.from_numpy(mask))
        assert torch.isfinite(out["logits"]).all()
        assert torch.isfinite(out_masked["pred_boxes"]).all()


PRESETS = {  # name -> (queries, labels, pre_norm, depths, layer type, label 0 or 1)
    "facebook/detr-resnet-50": (100, 91, False, (3, 4, 6, 3), "bottleneck", "person"),
    "facebook/detr-resnet-101": (100, 91, False, (3, 4, 23, 3), "bottleneck", "person"),
    "microsoft/table-transformer-detection": (15, 2, True, (2, 2, 2, 2), "basic", "table"),
    "microsoft/table-transformer-structure-recognition":
        (125, 6, True, (2, 2, 2, 2), "basic", "table"),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_presets_and_registry(name, monkeypatch):
    monkeypatch.delenv("SPOTTER_TPU_DTYPE", raising=False)
    queries, labels, pre_norm, depths, layer_type, label = PRESETS[name]
    assert registry.family_for(name).name == "detr"
    assert jregistry.family_for(name).name == "detr"
    cfg = tzoo.detr_preset(name)
    assert (cfg.num_queries, cfg.num_labels, cfg.pre_norm) == (queries, labels, pre_norm)
    assert (cfg.backbone.depths, cfg.backbone.layer_type, cfg.backbone.style) == (
        depths, layer_type, "v1")
    assert cfg.d_model == 256 and cfg.encoder_layers == cfg.decoder_layers == 6
    assert len(cfg.id2label_dict) == labels
    assert label in (cfg.id2label_dict.get(0), cfg.id2label_dict.get(1))
    built = registry.build_detector(name, tiny=True)
    assert built.needs_mask and built.postprocess == "softmax" and built.num_top_queries == 9
    assert built.preprocess_spec == tzoo.TINY_DETR_SPEC


def test_table_transformer_structure_labels():
    cfg = tzoo.detr_preset("microsoft/table-transformer-structure-recognition")
    assert cfg.id2label_dict == {0: "table", 1: "table column", 2: "table row",
                                 3: "table column header", 4: "table projected row header",
                                 5: "table spanning cell"}
    assert tzoo.detr_preset("microsoft/table-transformer-detection").id2label_dict == {
        0: "table", 1: "table rotated"}


@pytest.mark.parametrize("name", ["facebook/detr-resnet-50-dc5", "facebook/detr-resnet-101-dc5"])
def test_dc5_names_raise_with_the_jax_text(name):
    from spotter_tpu.models.configs import check_no_dilation

    with pytest.raises(ValueError) as jerr:
        check_no_dilation(type("HF", (), {"dilation": True})())
    with pytest.raises(ValueError) as terr:
        registry.build_detector(name, tiny=False)
    assert str(terr.value) == str(jerr.value)


def test_timm_backbone_table_matches_jax():
    from spotter_tpu.models import configs as jconfigs

    for name in ("resnet18", "resnet34", "resnet50", "resnet101"):
        assert (dataclasses.asdict(tconfigs.timm_resnet_backbone(name))
                == dataclasses.asdict(jconfigs.timm_resnet_backbone(name)))
    with pytest.raises(ValueError, match="Unsupported timm backbone"):
        tconfigs.timm_resnet_backbone("resnet152")


def test_full_width_build_on_the_cpu(monkeypatch):
    monkeypatch.delenv("SPOTTER_TPU_DTYPE", raising=False)
    built = registry.build_detector("microsoft/table-transformer-detection", tiny=False)
    assert built.preprocess_spec.input_hw == (1333, 1333) and built.num_top_queries == 15
    assert next(built.module.parameters()).device.type == "cpu"
    # formerly a refusal: "mixed" builds, its backbone at bf16
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "mixed")
    model = registry.build_detector(MODEL, tiny=True).module
    assert model.backbone.stem0.dtype == torch.bfloat16  # (an fp32 master kernel)
    assert model.input_projection.weight.dtype == torch.float32


def test_seeded_init_is_deterministic_and_flax_keyed():
    cfg = tzoo.tiny_detr_config()
    a = tzoo.init_detr(tdetr.DetrDetector(cfg), seed=3).state_dict()
    b = tzoo.init_detr(tdetr.DetrDetector(cfg), seed=3).state_dict()
    c = tzoo.init_detr(tdetr.DetrDetector(cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query_pos"], c["query_pos"])
    assert abs(a["query_pos"].std().item() - 1.0) < 0.3  # normal(1.0)
    assert torch.count_nonzero(a["class_labels_classifier.bias"]) == 0
    w = a["encoder_layer0.fc1.weight"]  # (48, 32): fan_in 32
    assert abs(w.std().item() - 32**-0.5) < 0.03
    x, mask = _pixels_and_mask(6)
    params = random_flax_params(jdetr.DetrDetector(jzoo.tiny_detr_config()), x[:1], mask[:1])
    assert set(state_dict_from_jax(params, tdetr.DetrDetector(cfg))) == set(a)


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 9.0 + np.arange(3)) * np.cos(yy[..., None] / 13.0)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


# --- the engine and /detect against the JAX package's ----------------------

def _jspec():
    return jpre.PreprocessSpec(mode="shortest_edge", size=(48, 64), mean=jpre.IMAGENET_MEAN,
                               std=jpre.IMAGENET_STD, pad_to=(64, 64))


@pytest.fixture(scope="module")
def weights():
    cfg = jzoo.tiny_detr_config()
    module = jdetr.DetrDetector(cfg)
    x, mask = _pixels_and_mask(10)
    params = random_flax_params(module, x[:1], mask[:1], seed=11)
    # the class head favours two amenity classes (couch, then tv) over the
    # rest and "no object", so detections pass the 0.5 threshold and the filter
    head = params["class_labels_classifier"]
    head["bias"] = head["bias"].copy()
    head["bias"][57] += 8.0
    head["bias"][62] += 7.0
    return cfg, module, params


def _jbuilt(cfg, module, params):
    return JBuilt(model_name=MODEL, module=module, params=params, preprocess_spec=_jspec(),
                  postprocess="softmax", id2label=cfg.id2label_dict,
                  num_top_queries=cfg.num_queries, needs_mask=True)


def test_engine_detect_matches_jax_engine(weights):
    """Photos of both orientations and a padded batch row: the same labels,
    scores and boxes in each photo's own pixels."""
    cfg, module, params = weights
    jengine = JEngine(_jbuilt(cfg, module, params), batch_buckets=(1, 4), threshold=0.0)
    engine = InferenceEngine(registry.build_detector(MODEL, tiny=True, params=params),
                             batch_buckets=(1, 4), device="cpu", threshold=0.0)
    photos = [_photo(12, 48, 64), _photo(13, 64, 48), _photo(14, 48, 64)]
    want = jengine.detect([Image.fromarray(p) for p in photos])
    got = engine.detect(photos)
    for g, w in zip(got, want, strict=True):
        assert len(g) == len(w) == cfg.num_queries
        assert [d["label"] for d in g] == [d["label"] for d in w]
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w], atol=1e-4)
        np.testing.assert_allclose(np.asarray([d["box"] for d in g]),
                                   np.asarray([d["box"] for d in w]), atol=1e-3)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("detr_images")
    for i, (h, w) in enumerate([(48, 64), (64, 48), (48, 64), (64, 48)]):
        Image.fromarray(_photo(20 + i, h, w)).save(root / f"p{i}.png")
    return root


def test_detect_json_matches_jax(weights, image_dir):
    """The tiny family's /detect JSON against the JAX standalone's, on PNGs
    already at the spec's resize (both resizes the identity), staged into
    the 64x64 bucket."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    cfg, module, params = weights
    os.environ.pop("SPOTTER_TPU_ADMIN_TOKEN", None)
    jdet = JDetector(JEngine(_jbuilt(cfg, module, params), batch_buckets=(1, 2, 4)), cache=None)
    engine = InferenceEngine(registry.build_detector(MODEL, tiny=True, params=params),
                             batch_buckets=(1, 2, 4), device="cpu")
    tdet = AmenitiesDetector(engine, MicroBatcher(engine, max_delay_ms=20.0))
    apps = [jstandalone.make_app(detector=jdet), tstandalone.make_app(detector=tdet)]

    async def run():
        static = web.Application()
        static.router.add_static("/img", str(image_dir))
        async with TestServer(static) as img_server:
            urls = [str(img_server.make_url(f"/img/p{i}.png")) for i in range(4)]
            out = []
            for app in apps:
                async with TestClient(TestServer(app)) as client:
                    resp = await client.post("/detect", json={"image_urls": urls})
                    assert resp.status == 200, await resp.text()
                    out.append(await resp.json())
            return out

    jresp, tresp = asyncio.run(run())
    assert tresp["amenities_description"] == jresp["amenities_description"]
    n_dets = 0
    for t_img, j_img, shape in zip(tresp["images"], jresp["images"],
                                   [(64, 48), (48, 64)] * 2, strict=True):
        assert t_img["url"] == j_img["url"]
        assert [d["label"] for d in t_img["detections"]] == [d["label"] for d in j_img["detections"]]
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in t_img["detections"]]).reshape(-1, 4),
            np.asarray([d["box"] for d in j_img["detections"]]).reshape(-1, 4), atol=1e-3)
        decoded = Image.open(BytesIO(__import__("base64").b64decode(t_img["labeled_image_base64"])))
        assert decoded.size == shape
        n_dets += len(t_img["detections"])
    assert n_dets > 0, "the tiny model kept no amenity: nothing was compared"


def test_chip_smoke_detr_phases_rehearse_on_the_cpu(monkeypatch):
    """chip_smoke.py's three DETR-lineage phases, run on the CPU with the
    four models at the tiny width (the card run takes them at full width):
    parity of a model with its copy, the engine and /detect answering, and
    every kernel count still 0 after each path."""
    import chip_smoke
    from spotter_tpu_torch.tools import timing

    monkeypatch.setenv("SPOTTER_TPU_TINY", "1")
    build = registry.build_detector
    monkeypatch.setattr(registry, "build_detector",
                        lambda name, **kw: build(name, **{**kw, "tiny": True}))
    monkeypatch.setattr(timing, "cuda_time_ms",
                        lambda fn, iters, flush, warmup=3: timing.host_time_ms(fn, iters))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    log = []
    parity = chip_smoke.phase_detr_parity(log, 0, device="cpu")
    assert [r["model"] for r in parity] == list(chip_smoke.DETR_LINEAGE)
    assert all(r["logits_max_abs_err"] == 0.0 for r in parity)
    assert "aux_boxes_max_abs_err" in parity[-1]
    # one round of each request size (the card run takes 3, and 10 over HTTP)
    serve = chip_smoke.phase_detr_serve(log, 0, device="cpu", rounds=1, timing_iters=1)
    assert all(set(r["device_forward_ms"]) == {1, 8} for r in serve)
    assert all(r["forwards"] == 2 and r["latency_ms"][8]["n"] == 1 for r in serve)
    http = chip_smoke.phase_detr_http(log, 0, device="cpu", rounds=1)
    assert http["healthz"] == 200 and set(http["latency_ms"]) == {"detr:1", "detr:8"}
    assert all(v["n"] == 1 for v in http["latency_ms"].values())
    assert not any(chip_smoke.read_counts().values())


@pytest.mark.parametrize("name", ["facebook/detr-resnet-50", "microsoft/table-transformer-detection",
                                  "microsoft/conditional-detr-resnet-50",
                                  "IDEA-Research/dab-detr-resnet-50"])
def test_profile_forward_stages_cover_every_module(name):
    """tools/profile_forward.py splits a forward by top-level module: each
    of the lineage's modules (a table-transformer's closing encoder
    LayerNorm too) falls in one of backbone, encoder, decoder and heads."""
    from spotter_tpu_torch.tools import profile_forward

    model = registry.build_detector(name, tiny=False).module
    stages = {profile_forward.stage_of(name, child) for child, _ in model.named_children()}
    assert stages == {"backbone", "encoder", "decoder", "heads"}
