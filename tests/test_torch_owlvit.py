"""OWL-ViT / OWLv2: the port (spotter_tpu_torch.models.owlvit, its zoo entry,
the bicubic and pad-to-square preprocess, the engine with and without a
request's query set, and /detect with `queries`) against the JAX package on
the same weights, at the zoo's tiny config (OWLv2: the same config with
`objectness=True`).

Flax params are drawn from a numpy seed (tests/torch_parity.py) and carried
across with `convert.from_jax`; for the engine and /detect, the JAX zoo's own
tiny build is carried across. Both sides run on the CPU, so the port's class
head takes its plain version (the kernel runs only on CUDA tensors) unless
SPOTTER_TPU_OWL_FUSED=0 (then its unfused tail), and JAX's its unfused tail
unless its knob is 1 (then the Pallas kernel in interpret mode): under the
default `auto` the two sides differ by the order of the tail's rounding.

Tolerances, each for its reason:
- "float32": atol 1e-5 on logits, boxes and objectness, and on the towers'
  outputs and the query embeddings. fp32 on both sides, two layers deep,
  summed in other orders; the text tower's masked keys are -inf on both
  sides (causal NEG_INF plus padding NEG_INF overflows in fp32), so they
  carry exactly zero weight.
- "mixed" (bf16 vision tower, fp32 text tower and heads): the two
  frameworks round at nearly but not exactly the same places (the bias add
  inside the product here, after it in JAX), so the tower's output differs
  by 2-3 bf16 ulps (measured 0.043 at |x| <= 3.4). The class head's cosine
  of those features is then multiplied by elu(scale) + 1 (up to ~4 here):
  logits within 3 % of the largest |logit| (measured 1.8 %); boxes within
  0.01 (a sigmoid, slope <= 1/4, measured 0.006); objectness within 0.02
  (an MLP of the same features, measured 0.0098 at |objectness| <= 0.45).
- The preprocess: bicubic resize equal to PIL's (the port calls PIL), then
  the rescale within 1e-6; the pad-to-square warp equal to JAX's to float32
  rounding (the same numpy and scipy calls), within 1e-6.
- The engine and /detect: labels equal, scores within 1e-4, boxes within
  1e-3 px (tests/test_torch_engine.py's tolerances for fp32 forwards).
"""

import asyncio
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from spotter_tpu.caching.text_cache import TextQueryResolver as JResolver
from spotter_tpu.engine.batcher import MicroBatcher as JBatcher
from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.owlvit import OwlViTDetector as JOwl
from spotter_tpu.models.owlvit import owlvit_box_bias as j_box_bias
from spotter_tpu.ops import openvocab as jov
from spotter_tpu.ops import preprocess as jpre
from spotter_tpu.serving import standalone as jstandalone
from spotter_tpu.serving.detector import AmenitiesDetector as JDetector
from spotter_tpu.utils import precision as jprecision
from spotter_tpu_torch.caching.text_cache import TextQueryResolver
from spotter_tpu_torch.convert.from_jax import load_from_jax, state_dict_from_jax
from spotter_tpu_torch.engine import engine as tengine
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import BuiltDetector, InferenceEngine
from spotter_tpu_torch.models import owlvit as towl
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.configs import OwlViTConfig, OwlViTVisionConfig
from spotter_tpu_torch.ops import openvocab
from spotter_tpu_torch.ops import preprocess as tpre
from spotter_tpu_torch.serving import standalone as tstandalone
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from spotter_tpu_torch.utils import precision as tprecision
from tests.torch_parity import random_flax_params

OWLV2 = "google/owlv2-base-patch16-ensemble"
OWLVIT = "google/owlvit-base-patch32"
TOL = {
    "float32": dict(atol=1e-5, rtol=1e-5),
    "mixed": {"pred_boxes": dict(atol=0.01, rtol=0), "objectness": dict(atol=0.02, rtol=0)},
}
MIXED_LOGITS_RTOL_OF_MAX = 0.03
SCORE_ATOL, BOX_ATOL = 1e-4, 1e-3


def _cfg(objectness: bool, side: str = "jax"):
    zoo = jzoo if side == "jax" else tzoo
    return dataclasses.replace(zoo.tiny_owlvit_config(), objectness=objectness)


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    ids, mask = jzoo._tiny_tokenize(["a photo of a couch", "a photo of a dog",
                                     "a photo of a tv", "a photo of a bed"], 99, 8)
    ids[2, 3] = ids[2].max() + 1  # the end-of-text id, twice: the first one pools
    ids[2, 6] = ids[2, 3]
    ids[2, 7] = 0
    mask[2, 4:] = 0  # padding after it
    mask[3, 6:] = 0
    return x, ids, mask


def _params(objectness, seed=3):
    x, ids, mask = _inputs()
    jm = JOwl(_cfg(objectness))
    return random_flax_params(jm, x[:1], ids, mask, seed=seed, method=JOwl.detect_with_text)


def _models(policy, objectness, params):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPOTTER_TPU_DTYPE", policy)
        jm = JOwl(_cfg(objectness), dtype=jprecision.compute_dtype(),
                  vision_dtype=jprecision.backbone_dtype())
        tm = towl.OwlViTDetector(_cfg(objectness, "torch"), dtype=tprecision.compute_dtype(),
                                 vision_dtype=tprecision.backbone_dtype()).eval()
    return jm, load_from_jax(tm, params)


@pytest.fixture(scope="module")
def owl_params():
    return {obj: _params(obj) for obj in (False, True)}


@pytest.mark.parametrize("policy", ["float32", "mixed"])
@pytest.mark.parametrize("objectness", [False, True])
def test_detect_with_text_matches_jax(owl_params, policy, objectness):
    x, ids, mask = _inputs()
    jm, tm = _models(policy, objectness, owl_params[objectness])
    assert tm.vision.dtype == (torch.float32 if policy == "float32" else torch.bfloat16)
    assert tm.text.dtype == torch.float32
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=JOwl.detect_with_text))(
        owl_params[objectness], x, ids, mask)
    with torch.inference_mode():
        got = tm.detect_with_text(*map(torch.from_numpy, (x, ids, mask)))
    keys = {"logits", "pred_boxes"} | ({"objectness"} if objectness else set())
    assert set(got) == set(want) == keys
    for key in keys:
        assert got[key].dtype == torch.float32
        if policy == "float32":
            tol = TOL[policy]
        elif key == "logits":
            tol = dict(atol=MIXED_LOGITS_RTOL_OF_MAX * np.abs(want[key]).max(), rtol=0)
        else:
            tol = TOL[policy][key]
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **tol)
    assert got["logits"].shape == (2, 16, 4) and got["pred_boxes"].shape == (2, 16, 4)


@pytest.mark.parametrize("part", ["text", "encode_text", "vision"])
def test_towers_match_jax(owl_params, part):
    x, ids, mask = _inputs()
    params = owl_params[False]
    jm, tm = _models("float32", False, params)
    if part == "vision":
        want = jm.apply({"params": params}, x, method=lambda m, px: m.vision(px))
        with torch.inference_mode():
            got = tm.vision(torch.from_numpy(x))
        assert got.shape == (2, 17, 20)
    else:
        fn = (lambda m, i, a: m.text(i, a)) if part == "text" else JOwl.encode_text
        want = jm.apply({"params": params}, ids, mask, method=fn)
        with torch.inference_mode():
            args = (torch.from_numpy(ids), torch.from_numpy(mask))
            got = tm.text(*args) if part == "text" else tm.encode_text(*args)
        assert got.shape == (4, 16)
        if part == "encode_text":
            np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_text_tower_pools_the_first_end_of_text_and_masks_to_minus_inf(owl_params):
    """EOT pooling takes the first of equal maximal ids (jnp.argmax); the
    causal and padding NEG_INF add to -inf in fp32, so a padded key carries
    no weight: changing a padded token changes nothing before it."""
    x, ids, mask = _inputs()
    _, tm = _models("float32", False, owl_params[False])
    with torch.inference_mode():
        base = tm.text(torch.from_numpy(ids), torch.from_numpy(mask))
        other = ids.copy()
        other[2, 5] = 7  # a padded position after the first EOT (pooled at 3)
        moved = tm.text(torch.from_numpy(other), torch.from_numpy(mask))
    assert torch.equal(base[2], moved[2])
    assert float(np.float32(openvocab.NEG_INF) + np.float32(openvocab.NEG_INF)) == -np.inf


def test_every_owl_leaf_is_carried_across(owl_params):
    """Each flax leaf of the OWLv2 tree lands on one port tensor in the
    layout the rules give (the vision and text towers, text_projection
    without a bias, merge_layer_norm, the class, box and objectness heads;
    embedding tables and class_embedding as they are); none is left over."""
    params = owl_params[True]
    model = towl.OwlViTDetector(_cfg(True, "torch"))
    sd = state_dict_from_jax(params, model)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(sd) == len(model.state_dict())
    for path, leaf in flat:
        *parent, name = [p.key for p in path]
        leaf = np.asarray(leaf)
        if name == "kernel":
            key = ".".join(parent + ["weight"])
            want = leaf.T if leaf.ndim == 2 else leaf.transpose(3, 2, 0, 1)
        elif name == "scale":
            key, want = ".".join(parent + ["weight"]), leaf
        else:
            key, want = ".".join(parent + [name]), leaf
        np.testing.assert_array_equal(sd[key].numpy(), want)
    assert {"text.token_embedding", "text.position_embedding", "vision.class_embedding",
            "vision.position_embedding", "vision.patch_embedding.weight",
            "text_projection.weight", "merge_layer_norm.weight", "class_head.dense0.weight",
            "class_head.logit_scale.bias", "box_head.dense2.weight",
            "objectness_head.dense2.bias", "text.layer1.self_attn.q_proj.weight",
            "vision.pre_layernorm.bias", "vision.post_layernorm.weight"} <= set(sd)
    assert "text_projection.bias" not in sd and "vision.patch_embedding.bias" not in sd


@pytest.mark.parametrize("fused", ["0", "1"])
def test_fused_knob_on_the_whole_model(monkeypatch, owl_params, fused):
    """SPOTTER_TPU_OWL_FUSED=1 runs JAX's Pallas kernel in interpret mode and
    the port's plain version; =0 both unfused tails."""
    x, ids, mask = _inputs()
    monkeypatch.setattr(jov, "OWL_FUSED", fused)
    monkeypatch.setattr(openvocab, "OWL_FUSED", fused)
    jm, tm = _models("float32", True, owl_params[True])
    want = jm.apply({"params": owl_params[True]}, x, ids, mask, method=JOwl.detect_with_text)
    with torch.inference_mode():
        got = tm.detect_with_text(*map(torch.from_numpy, (x, ids, mask)))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               **TOL["float32"])


def test_box_bias_matches_jax_and_is_cached():
    np.testing.assert_array_equal(towl.owlvit_box_bias(3, 5), j_box_bias(3, 5))
    a = towl._box_bias_table(60, 60, torch.device("cpu"))
    assert a is towl._box_bias_table(60, 60, torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), j_box_bias(60, 60))


# --- preprocess -------------------------------------------------------------


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 7.0 + np.arange(3)) * np.cos(yy[..., None] / 5.0)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", [(120, 160), (900, 700)])
def test_bicubic_spec_matches_jax_preprocess(hw):
    spec = tpre.OWLVIT_SPEC
    assert (spec.size, spec.mean, spec.std, spec.resample) == (
        jpre.OWLVIT_SPEC.size, jpre.OWLVIT_SPEC.mean, jpre.OWLVIT_SPEC.std, "bicubic")
    img = _photo(1, *hw)
    pixels, _, sizes = tpre.batch_images_uint8([img], spec)
    want, _, orig = jpre.preprocess_image(Image.fromarray(img), jpre.OWLVIT_SPEC)
    np.testing.assert_array_equal(
        pixels[0], np.asarray(Image.fromarray(img).resize((768, 768), Image.BICUBIC)))
    got = tpre.device_rescale_normalize(torch.from_numpy(pixels), spec)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert tuple(sizes[0]) == orig == hw


@pytest.mark.parametrize("hw,size", [((50, 70), (960, 960)), ((90, 60), (32, 32)),
                                     ((64, 64), (48, 48))])
def test_pad_square_matches_jax_preprocess(hw, size):
    spec = dataclasses.replace(tpre.OWLV2_SPEC, size=size)
    jspec = dataclasses.replace(jpre.OWLV2_SPEC, size=size)
    assert (tpre.OWLV2_SPEC.mode, tpre.OWLV2_SPEC.size) == ("pad_square", (960, 960))
    imgs = [_photo(2, *hw), _photo(3, *hw[::-1])]
    pixels, sizes = tpre.batch_images_float(imgs, spec)
    for img, got, got_hw in zip(imgs, pixels, sizes):
        want, _, orig = jpre.preprocess_image(Image.fromarray(img), jspec)
        assert got.dtype == np.float32 and got.shape == (*size, 3)
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert tuple(got_hw) == orig == (max(hw), max(hw))
    assert not tpre.device_preprocess_supported(spec)
    with pytest.raises(ValueError, match="no uint8 path"):
        tpre.batch_images_uint8(imgs, spec)


# --- zoo and registry -------------------------------------------------------


def test_presets_and_registry():
    for name in (OWLV2, "google/owlv2-base-patch16", "google/owlv2-base-patch16-finetuned"):
        cfg = tzoo.owlvit_preset(name)
        assert cfg == OwlViTConfig(vision=OwlViTVisionConfig(image_size=960, patch_size=16),
                                   objectness=True)
        assert cfg.vision.grid ** 2 + 1 == 3601
    assert tzoo.owlvit_preset(OWLVIT) == OwlViTConfig()
    assert tzoo.owlvit_preset("google/owlvit-base-patch16").vision.patch_size == 16
    cfg = OwlViTConfig()
    assert (cfg.text.hidden_size, cfg.text.num_attention_heads, cfg.text.vocab_size,
            cfg.text.max_position_embeddings, cfg.projection_dim, cfg.vision.hidden_size,
            cfg.vision.intermediate_size) == (512, 8, 49408, 16, 512, 768, 3072)
    for name in (OWLV2, OWLVIT, "google/owlv2-large-patch14"):
        assert registry.family_for(name).name == "owlvit"
    with pytest.raises(ValueError, match="owlv2-large-patch14.*checkpoint directory"):
        tzoo.owlvit_preset("google/owlv2-large-patch14")


def test_full_width_build_needs_the_token_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("SPOTTER_TPU_CACHE", str(tmp_path))
    with pytest.raises(ValueError, match="no tokenization cache at .*owlv2-base-patch16"):
        registry.build_detector(OWLV2, tiny=False)


def test_init_owlvit_is_seeded_and_mirrors_flax():
    a = tzoo.build_owlvit(OWLVIT, tiny=True, seed=1).module
    b = tzoo.build_owlvit(OWLVIT, tiny=True, seed=1).module
    c = tzoo.build_owlvit(OWLVIT, tiny=True, seed=2).module
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    assert not torch.equal(a.text.token_embedding, c.text.token_embedding)
    tables = torch.cat([a.text.token_embedding.flatten(), a.vision.position_embedding.flatten()])
    assert abs(tables.std().item() - 0.02) < 0.002
    assert a.merge_layer_norm.weight.eq(1).all() and a.class_head.dense0.bias.eq(0).all()
    w = a.vision.layer0.fc1.weight
    assert abs(w.std().item() - 20**-0.5) < 0.03 and w.abs().max() <= 2 * 20**-0.5 / 0.8796


@pytest.mark.parametrize("policy,vision", [("float32", torch.float32),
                                           ("mixed", torch.bfloat16),
                                           ("bfloat16", torch.bfloat16)])
def test_build_follows_the_policy_and_the_vocabulary(monkeypatch, policy, vision):
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    monkeypatch.setenv("SPOTTER_TPU_TEXT_QUERIES", "sofa, lamp ,,bed")
    built = registry.build_detector(OWLV2, tiny=True)
    assert built.module.vision.dtype == vision
    assert built.module.text.dtype == tprecision.compute_dtype()
    assert built.id2label == {0: "sofa", 1: "lamp", 2: "bed"} and built.num_top_queries == 3
    assert built.postprocess == "sigmoid_max" and built.preprocess_spec.size == (32, 32)
    assert built.query_embeds.shape == (3, 16) and built.query_embeds.dtype == torch.float32
    np.testing.assert_allclose(built.text_encoder(["sofa", "lamp", "bed"]),
                               built.query_embeds.numpy(), atol=1e-6)
    out = InferenceEngine(built, device="cpu").detect([_photo(4, 40, 30)])
    assert len(out) == 1 and {d["label"] for d in out[0]} <= {"sofa", "lamp", "bed"}


def test_owl_refuses_int8(monkeypatch):
    """Formerly a refusal: SPOTTER_TPU_INT8 now builds OWLv2; alone it
    quantizes nothing there (no ConvNorm layer: the towers' projections
    wait for _INT8_DENSE), so the forward is the float one bit for bit, and
    "0" keeps the float path."""
    from tests.test_torch_int8 import assert_knob_serves

    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3))
                         .astype(np.float32))
    assert_knob_serves(monkeypatch, "SPOTTER_TPU_INT8",
                       lambda: registry.build_detector(OWLV2, tiny=True),
                       lambda b: b.module.eval()(x, b.query_embeds, None), quantizes=False)


# --- engine, query sets and /detect ---------------------------------------


@pytest.fixture(scope="module")
def owl_engines():
    """(JAX engine, port engine) on the JAX zoo's own tiny OWL-ViT, carried
    across, threshold 0 so every patch's answer is compared."""
    old = os.environ.get("SPOTTER_TPU_TINY")
    os.environ["SPOTTER_TPU_TINY"] = "1"
    try:
        jbuilt = jzoo._build_owlvit(OWLVIT)
    finally:
        if old is None:
            os.environ.pop("SPOTTER_TPU_TINY")
        else:
            os.environ["SPOTTER_TPU_TINY"] = old
    jeng = JEngine(jbuilt, batch_buckets=(1, 2, 4), threshold=0.0)
    tbuilt = registry.build_detector(OWLVIT, tiny=True, params=jbuilt.params)
    teng = InferenceEngine(tbuilt, batch_buckets=(1, 2, 4), threshold=0.0, device="cpu")
    return jbuilt, jeng, tbuilt, teng


def _same_detections(got, want):
    assert [len(d) for d in got] == [len(d) for d in want]
    for g_img, w_img in zip(got, want):
        assert [d["label"] for d in g_img] == [d["label"] for d in w_img]
        np.testing.assert_allclose([d["score"] for d in g_img], [d["score"] for d in w_img],
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(np.asarray([d["box"] for d in g_img]).reshape(-1, 4),
                                   np.asarray([d["box"] for d in w_img]).reshape(-1, 4),
                                   atol=BOX_ATOL)


def test_query_bank_matches_jax(owl_engines):
    jbuilt, _, tbuilt, _ = owl_engines
    np.testing.assert_allclose(tbuilt.query_embeds.numpy(),
                               np.asarray(jbuilt.apply_kwargs["query_embeds"]),
                               **TOL["float32"])
    assert tbuilt.id2label == jbuilt.id2label and len(tbuilt.id2label) == 22


def test_engine_detect_matches_jax(owl_engines):
    _, jeng, _, teng = owl_engines
    imgs = [_photo(s, 32, 32) for s in (20, 21, 22)]
    want = jeng.detect([Image.fromarray(a) for a in imgs])
    got = teng.detect(imgs)
    assert [len(d) for d in got] == [16, 16, 16]
    _same_detections(got, want)


@pytest.mark.parametrize("queries", [["couch", "dog"], ["tv", "potted plant", "bed", "a b c",
                                                       "sink", "oven", "cup", "bowl", "car"]])
def test_engine_detect_with_a_query_set_matches_jax(owl_engines, queries):
    jbuilt, jeng, tbuilt, teng = owl_engines
    qs = TextQueryResolver(OWLVIT, tbuilt.text_encoder).resolve(queries)
    jqs = JResolver(OWLVIT, jbuilt.text_encoder).resolve(queries)
    np.testing.assert_allclose(qs.embeds, jqs.embeds, **TOL["float32"])
    imgs = [_photo(s, 32, 32) for s in (30, 31)]
    want = jeng.detect([Image.fromarray(a) for a in imgs], qset=jqs)
    got = teng.detect(imgs, qset=qs)
    _same_detections(got, want)
    assert {d["label"] for dets in got for d in dets} <= set(queries)
    assert qs.key in teng._qset_tensors  # the set's device copy, kept per key


def test_query_set_padding_is_invisible(owl_engines):
    _, _, tbuilt, teng = owl_engines
    imgs = [_photo(9, 32, 32)]
    a = teng.detect(imgs, qset=TextQueryResolver(OWLVIT, tbuilt.text_encoder, pad=8)
                    .resolve(["couch", "dog", "tv"]))
    b = teng.detect(imgs, qset=TextQueryResolver(OWLVIT, tbuilt.text_encoder, pad=1)
                    .resolve(["couch", "dog", "tv"]))
    _same_detections(a, b)


def test_query_set_device_copies_are_bounded(monkeypatch, owl_engines):
    _, _, tbuilt, teng = owl_engines
    monkeypatch.setattr(tengine, "QSET_DEVICE_ENTRIES", 2)
    res = TextQueryResolver(OWLVIT, tbuilt.text_encoder)
    keys = [res.resolve([q]).key for q in ("a", "b", "c")]
    for q in ("a", "b", "c"):
        teng.detect([_photo(1, 32, 32)], qset=res.resolve([q]))
    assert list(teng._qset_tensors)[-2:] == keys[1:] and len(teng._qset_tensors) == 2


def test_closed_set_engine_refuses_a_query_set(owl_engines):
    _, _, tbuilt, _ = owl_engines
    qs = TextQueryResolver(OWLVIT, tbuilt.text_encoder).resolve(["couch"])
    engine = InferenceEngine(registry.build_detector("hustvl/yolos-base", tiny=True),
                             device="cpu")
    with pytest.raises(ValueError, match="closed-set family.*per-request `queries`"):
        engine.detect([_photo(1, 32, 48)], qset=qs)


def test_pad_square_engine_matches_jax(owl_params):
    """The OWLv2 path: the host float pad-to-square preprocess, float32
    pixels to the device, sizes reported as the square's."""
    params = owl_params[True]
    jm = JOwl(_cfg(True))
    bank = np.random.default_rng(8).standard_normal((5, 16)).astype(np.float32)
    labels = dict(enumerate(["couch", "dog", "tv", "bed", "sink"]))
    jbuilt = JBuilt(
        model_name=OWLV2, module=jm, params=params,
        preprocess_spec=jpre.PreprocessSpec(mode="pad_square", size=(32, 32),
                                            mean=jpre.CLIP_MEAN, std=jpre.CLIP_STD),
        postprocess="sigmoid_max", id2label=labels, num_top_queries=5,
        apply_kwargs={"query_embeds": bank})
    model = load_from_jax(towl.OwlViTDetector(_cfg(True, "torch")).eval(), params)
    tbuilt = BuiltDetector(
        model_name=OWLV2, module=model,
        preprocess_spec=dataclasses.replace(tpre.OWLV2_SPEC, size=(32, 32)),
        postprocess="sigmoid_max", id2label=labels, num_top_queries=5,
        query_embeds=torch.from_numpy(bank))
    teng = InferenceEngine(tbuilt, batch_buckets=(1, 2, 4), threshold=0.0, device="cpu")
    assert not teng.device_preprocess
    teng.warmup()
    imgs = [_photo(40, 48, 64), _photo(41, 70, 50), _photo(42, 32, 32)]
    want = JEngine(jbuilt, batch_buckets=(1, 2, 4), threshold=0.0).detect(
        [Image.fromarray(a) for a in imgs])
    got = teng.detect(imgs)
    _same_detections(got, want)


def _png_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("owl_images")
    for i in range(3):
        Image.fromarray(_photo(300 + i, 32, 32)).save(root / f"p{i}.png")
    return root


def test_detect_with_queries_matches_the_jax_replica(owl_engines, tmp_path_factory):
    jbuilt, jeng, tbuilt, teng = owl_engines
    os.environ.pop("SPOTTER_TPU_ADMIN_TOKEN", None)
    jeng.threshold, teng.threshold = 0.5, 0.5
    try:
        jdet = JDetector(jeng, JBatcher(jeng, max_delay_ms=20.0), cache=None)
        tdet = AmenitiesDetector(teng, MicroBatcher(teng, max_delay_ms=20.0))
        apps = [jstandalone.make_app(detector=jdet), tstandalone.make_app(detector=tdet)]
        root = _png_dir(tmp_path_factory)

        async def drive():
            static = web.Application()
            static.router.add_static("/img", str(root))
            async with TestServer(static) as img_server:
                urls = [str(img_server.make_url(f"/img/p{i}.png")) for i in range(3)]
                out = []
                for app in apps:
                    async with TestClient(TestServer(app)) as client:
                        bodies = []
                        for extra in ({"queries": ["couch", "dog", "potted plant"]},
                                      {"queries": ["dog", "couch", "potted plant"]}, {}):
                            resp = await client.post("/detect",
                                                     json={"image_urls": urls, **extra})
                            assert resp.status == 200, await resp.text()
                            bodies.append(await resp.json())
                        bodies.append(await (await client.get("/metrics")).json())
                        health = await (await client.get("/healthz")).json()
                        assert health["open_vocab"]["enabled"] is True
                        out.append(bodies)
                return out

        (j_q, j_q2, j_plain, _), (t_q, t_q2, t_plain, t_metrics) = asyncio.run(drive())
    finally:
        jeng.threshold, teng.threshold = 0.0, 0.0
    n_dets = 0
    for jresp, tresp in ((j_q, t_q), (j_q2, t_q2), (j_plain, t_plain)):
        assert tresp["amenities_description"] == jresp["amenities_description"]
        for t_img, j_img in zip(tresp["images"], jresp["images"], strict=True):
            assert [d["label"] for d in t_img["detections"]] == [
                d["label"] for d in j_img["detections"]]
            np.testing.assert_allclose(
                np.asarray([d["box"] for d in t_img["detections"]]).reshape(-1, 4),
                np.asarray([d["box"] for d in j_img["detections"]]).reshape(-1, 4),
                atol=BOX_ATOL)
            n_dets += len(t_img["detections"])
    assert n_dets > 0, "the tiny model kept no detection: nothing was compared"
    q_labels = {d["label"] for img in t_q["images"] for d in img["detections"]}
    assert q_labels and q_labels <= {"couch", "dog", "potted plant"}
    assert (t_metrics["text_cache_misses_total"], t_metrics["text_cache_hits_total"]) == (1, 1)
