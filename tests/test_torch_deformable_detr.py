"""Deformable-DETR: the port (spotter_tpu_torch.models.deformable_detr and
the shortest-edge serving path) against the JAX package on the same weights.

Flax params are drawn from a numpy seed (tests/torch_parity.py) and carried
across with `convert.from_jax`; both sides run the same NHWC pixels and
pixel mask. JAX runs on the CPU with its "xla" MSDA backend; the port's
MSDA runs its plain path, which its wrappers take for CPU tensors.

Tolerances are the slice-1 forward ones (tests/test_torch_rtdetr.py):
boxes atol 2e-4, logits atol 5e-4, both rtol 1e-3, fp32 on both sides
summed in other orders through the backbone, the GroupNorms and the
deformable encoder and decoder. Sizes, staging and masks are held exactly.
"""

import asyncio
import dataclasses
import os
from io import BytesIO

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.configs import ResNetConfig as JResNetConfig
from spotter_tpu.models.deformable_detr import DeformableDetrDetector as JDeformable
from spotter_tpu.models.resnet import ResNetBackbone as JResNet
from spotter_tpu.ops import preprocess as jpre
from spotter_tpu.serving import standalone as jstandalone
from spotter_tpu.serving.detector import AmenitiesDetector as JDetector
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.configs import ResNetConfig
from spotter_tpu_torch.models.deformable_detr import DeformableDetrDetector
from spotter_tpu_torch.models.resnet import ResNetBackbone
from spotter_tpu_torch.ops import msda as tmsda
from spotter_tpu_torch.ops import preprocess as tpre
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from tests.torch_parity import random_flax_params

MODEL = "SenseTime/deformable-detr"
BOX_ATOL, LOGIT_ATOL, RTOL = 2e-4, 5e-4, 1e-3
# the four published presets' variants at the tiny width: two-stage keeps 9
# of the 85 proposals of a 64x64 bucket; single-scale taps the last stage
VARIANTS = {
    "plain": dict(with_box_refine=False),
    "box_refine": {},
    "two_stage": dict(two_stage=True, two_stage_num_proposals=9),
    "single_scale": dict(with_box_refine=False, num_feature_levels=1),
}


def _configs(variant):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jzoo.tiny_deformable_detr_config(), **kw)
    tcfg = dataclasses.replace(tzoo.tiny_deformable_detr_config(), **kw)
    if variant == "single_scale":
        jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(jcfg.backbone,
                                                                      out_indices=(4,)))
        tcfg = dataclasses.replace(tcfg, backbone=dataclasses.replace(tcfg.backbone,
                                                                      out_indices=(4,)))
    return jcfg, tcfg


def _pixels_and_mask(seed):
    """Two 64x64 images, each with its own padded region (a 64x40 and a
    48x64 valid extent), pad pixels 0 as the DETR processor leaves them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (2, 64, 64, 3)).astype(np.float32)
    mask = np.ones((2, 64, 64), np.float32)
    mask[0, :, 40:] = 0
    mask[1, 48:, :] = 0
    return x * mask[..., None], mask


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tiny_deformable_detr_matches_jax(variant):
    jcfg, tcfg = _configs(variant)
    jmodel = JDeformable(jcfg)
    x, mask = _pixels_and_mask(1)
    params = random_flax_params(jmodel, x[:1], mask[:1], seed=3)
    jout = jax.jit(jmodel.apply)({"params": params}, x, mask)
    model = load_from_jax(DeformableDetrDetector(tcfg).eval(), params)
    with torch.inference_mode():
        tout = model(torch.from_numpy(x), torch.from_numpy(mask))
    assert set(tout) == set(jout)
    for key in tout:
        atol = BOX_ATOL if "box" in key or "coord" in key else LOGIT_ATOL
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=atol,
                                   rtol=RTOL, err_msg=f"{variant}: {key}")


def test_tiny_deformable_detr_without_a_mask_matches_jax():
    """No pixel mask: every value token counts and the valid ratios are 1."""
    jcfg, tcfg = _configs("box_refine")
    jmodel = JDeformable(jcfg)
    x = np.random.default_rng(2).uniform(-2, 2, (2, 64, 48, 3)).astype(np.float32)
    params = random_flax_params(jmodel, x[:1], seed=4)
    jout = jax.jit(jmodel.apply)({"params": params}, x)
    model = load_from_jax(DeformableDetrDetector(tcfg).eval(), params)
    with torch.inference_mode():
        tout = model(torch.from_numpy(x))
    np.testing.assert_allclose(tout["pred_boxes"].numpy(), np.asarray(jout["pred_boxes"]),
                               atol=BOX_ATOL, rtol=RTOL)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=LOGIT_ATOL, rtol=RTOL)


@pytest.mark.parametrize("backend", ["pallas_sep", "pallas_gather"])
def test_tiny_deformable_detr_under_backend_matches_jax(monkeypatch, backend):
    """The port's new backends (their plain versions here) in the encoder's
    self-attention and the decoder's cross-attention, against the JAX
    package under "xla": every backend computes the same function."""
    jcfg, tcfg = _configs("box_refine")
    jmodel = JDeformable(jcfg)
    x, mask = _pixels_and_mask(5)
    params = random_flax_params(jmodel, x[:1], mask[:1], seed=6)
    jout = jax.jit(jmodel.apply)({"params": params}, x, mask)
    monkeypatch.setattr(tmsda, "MSDA_BACKEND", backend)
    model = load_from_jax(DeformableDetrDetector(tcfg).eval(), params)
    with torch.inference_mode():
        tout = model(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(tout["pred_boxes"].numpy(), np.asarray(jout["pred_boxes"]),
                               atol=BOX_ATOL, rtol=RTOL)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=LOGIT_ATOL, rtol=RTOL)


@pytest.mark.parametrize("layer_type,depths", [("basic", (1, 1, 1, 1)),
                                               ("bottleneck", (1, 2, 1, 1))])
def test_resnet_v1_matches_jax(layer_type, depths):
    """The classic ResNet: 7x7 stem, max pool, strided 1x1 projections."""
    hidden = (8, 12, 16, 24) if layer_type == "basic" else (16, 32, 48, 64)
    kw = dict(embedding_size=8, hidden_sizes=hidden, depths=depths, layer_type=layer_type,
              style="v1", out_indices=(1, 2, 3, 4))
    jmodel = JResNet(JResNetConfig(**kw))
    x = np.random.default_rng(7).uniform(-1, 1, (2, 45, 38, 3)).astype(np.float32)
    params = random_flax_params(jmodel, x[:1], seed=7)
    jfeats = jax.jit(jmodel.apply)({"params": params}, x)
    model = load_from_jax(ResNetBackbone(ResNetConfig(**kw)).eval(), params)
    assert not hasattr(model, "stem1")
    with torch.inference_mode():
        tfeats = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for t, j in zip(tfeats, jfeats, strict=True):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                   atol=1e-4, rtol=1e-4)


# shortest edge 800 under a long-side cap of 1333: the equality branch (a
# side already at 800, one pixel over the cap on the other), the cap
# boundary (800 / 1333 and its neighbours), extreme aspect ratios, and a grid
SIZES = [(800, 1333), (800, 1334), (666, 1334), (1334, 666), (1333, 800), (799, 1333),
         (800, 1332), (801, 1333), (600, 1000), (600, 1001), (600, 999), (1, 4000),
         (4000, 1), (480, 640), (1080, 1440), (1440, 1080), (800, 800), (10, 10)]
SIZES += [(h, w) for h in range(1, 3001, 113) for w in range(1, 3001, 97)]


def test_shortest_edge_size_matches_jax():
    for hw in SIZES:
        assert tpre.shortest_edge_size(hw, 800, 1333) == jpre.shortest_edge_size(hw, 800, 1333), hw
        assert tpre.shortest_edge_size(hw, 48, 64) == jpre.shortest_edge_size(hw, 48, 64), hw


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 9.0 + np.arange(3)) * np.cos(yy[..., None] / 13.0)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", [(48, 64), (64, 48), (30, 90), (120, 100)])
def test_uint8_staging_and_mask_match_jax(hw):
    """The host half stages each resized photo at the top left of the
    bucket, the device half normalizes and zeroes the pad to exactly 0 and
    builds the mask; against the JAX package's uint8 path, bit for bit (both
    resize with PIL's bilinear)."""
    spec = tzoo.TINY_DETR_SPEC
    jspec = jpre.PreprocessSpec(mode="shortest_edge", size=(48, 64), mean=jpre.IMAGENET_MEAN,
                                std=jpre.IMAGENET_STD, pad_to=(64, 64))
    photo = _photo(8, *hw)
    pixels, valid, sizes = tpre.batch_images_uint8([photo], spec)
    jpixels, jvalid, jsizes = jpre.batch_images_uint8([Image.fromarray(photo)], jspec)
    assert pixels.shape == (1, 64, 64, 3) and pixels.dtype == np.uint8
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(sizes, jsizes)
    np.testing.assert_array_equal(pixels, jpixels)
    rh, rw = valid[0]
    assert not pixels[0, rh:].any() and not pixels[0, :, rw:].any()

    x, mask = tpre.device_rescale_normalize_masked(
        torch.from_numpy(pixels), torch.from_numpy(valid), spec)
    jx, jmask = jpre.device_rescale_normalize(jpixels, jvalid, jspec)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.dtype == torch.float32 and mask.shape == (1, 64, 64)
    pad = mask.numpy() == 0
    assert (x.numpy()[pad] == 0).all(), "pad pixels must be exactly 0"
    # the same pixels: the normalizations differ only in fp32 rounding
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6)


def test_presets_registry_and_policy(monkeypatch):
    monkeypatch.delenv("SPOTTER_TPU_DTYPE", raising=False)
    want = {"SenseTime/deformable-detr": (False, False, 4, (2, 3, 4)),
            "SenseTime/deformable-detr-with-box-refine": (True, False, 4, (2, 3, 4)),
            "SenseTime/deformable-detr-with-box-refine-two-stage": (True, True, 4, (2, 3, 4)),
            "sensetime/deformable_detr-single-scale": (False, False, 1, (4,))}
    for name, (refine, two_stage, levels, taps) in want.items():
        cfg = tzoo.deformable_detr_preset(name)
        assert (cfg.with_box_refine, cfg.two_stage, cfg.num_feature_levels,
                cfg.backbone.out_indices) == (refine, two_stage, levels, taps), name
        assert cfg.d_model == 256 and cfg.num_queries == 300 and cfg.backbone.style == "v1"
        assert cfg.num_labels == 91 and cfg.id2label_dict[1] == "person"
        assert registry.family_for(name).name == "deformable_detr"
    with pytest.raises(ValueError, match="dc5"):
        tzoo.deformable_detr_preset("SenseTime/deformable-detr-single-scale-dc5")
    built = registry.build_detector("SenseTime/deformable-detr", tiny=True)
    assert built.needs_mask and built.postprocess == "sigmoid_topk"
    assert built.num_top_queries == 9 and built.preprocess_spec.input_hw == (64, 64)
    assert tpre.DETR_SPEC.input_hw == (1333, 1333)
    # formerly a refusal: "mixed" builds, its backbone at bf16
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "mixed")
    model = registry.build_detector("SenseTime/deformable-detr", tiny=True).module
    assert model.backbone.stem0.dtype == torch.bfloat16  # (an fp32 master kernel)
    assert model.encoder_layer0.fc1.weight.dtype == torch.float32


def test_seeded_init_is_deterministic_and_flax_shaped():
    cfg = tzoo.tiny_deformable_detr_config()
    a = tzoo.init_deformable_detr(DeformableDetrDetector(cfg), seed=3).state_dict()
    b = tzoo.init_deformable_detr(DeformableDetrDetector(cfg), seed=3).state_dict()
    c = tzoo.init_deformable_detr(DeformableDetrDetector(cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query_embeddings"], c["query_embeddings"])
    assert abs(a["query_embeddings"].std().item() - 1.0) < 0.2  # normal(1.0)
    assert abs(a["level_embed"].std().item() - 1.0) < 0.3
    assert torch.equal(a["input_proj0_norm.weight"], torch.ones(32))
    assert torch.count_nonzero(a["input_proj0_conv.bias"]) == 0
    w = a["encoder_layer0.fc1.weight"]  # (48, 32): fan_in 32
    assert abs(w.std().item() - 32**-0.5) < 0.03


# --- the engine and /detect against the JAX package's ----------------------

def _jspec():
    return jpre.PreprocessSpec(mode="shortest_edge", size=(48, 64), mean=jpre.IMAGENET_MEAN,
                               std=jpre.IMAGENET_STD, pad_to=(64, 64))


@pytest.fixture(scope="module")
def weights():
    cfg = jzoo.tiny_deformable_detr_config()
    module = JDeformable(cfg)
    x, mask = _pixels_and_mask(10)
    params = random_flax_params(module, x[:1], mask[:1], seed=11)
    # the last layer's head favours a few amenity classes (couch, tv, sink),
    # so some detections pass the 0.5 threshold and the amenity filter
    head = params["class_head1"]
    head["bias"] = head["bias"].copy()
    head["bias"][[57, 62, 71]] += 4.0
    return cfg, module, params


def test_engine_detect_matches_jax_engine(weights):
    """Photos of both orientations and a padded batch row: the same labels,
    scores and boxes in each photo's own pixels."""
    cfg, module, params = weights
    jbuilt = JBuilt(model_name=MODEL, module=module, params=params, preprocess_spec=_jspec(),
                    postprocess="sigmoid_topk", id2label=cfg.id2label_dict,
                    num_top_queries=min(100, cfg.num_queries), needs_mask=True)
    jengine = JEngine(jbuilt, batch_buckets=(1, 4), threshold=0.0)
    engine = InferenceEngine(registry.build_detector(MODEL, tiny=True, params=params),
                             batch_buckets=(1, 4), device="cpu", threshold=0.0)
    photos = [_photo(12, 48, 64), _photo(13, 64, 48), _photo(14, 48, 64)]
    want = jengine.detect([Image.fromarray(p) for p in photos])
    got = engine.detect(photos)
    for g, w in zip(got, want, strict=True):
        assert [d["label"] for d in g] == [d["label"] for d in w]
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w], atol=1e-4)
        np.testing.assert_allclose(np.asarray([d["box"] for d in g]),
                                   np.asarray([d["box"] for d in w]), atol=1e-3)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddetr_images")
    for i, (h, w) in enumerate([(48, 64), (64, 48), (48, 64), (64, 48)]):
        Image.fromarray(_photo(20 + i, h, w)).save(root / f"p{i}.png")
    return root


def test_detect_json_matches_jax(weights, image_dir):
    """The tiny family's /detect JSON against the JAX standalone's, on PNGs
    already at the spec's resize (48x64 and 64x48: both resizes are the
    identity and both decodes lossless), staged into the 64x64 bucket."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    cfg, module, params = weights
    os.environ.pop("SPOTTER_TPU_ADMIN_TOKEN", None)
    jbuilt = JBuilt(model_name=MODEL, module=module, params=params, preprocess_spec=_jspec(),
                    postprocess="sigmoid_topk", id2label=cfg.id2label_dict,
                    num_top_queries=min(100, cfg.num_queries), needs_mask=True)
    jdet = JDetector(JEngine(jbuilt, batch_buckets=(1, 2, 4)), cache=None)
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
