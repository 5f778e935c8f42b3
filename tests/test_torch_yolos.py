"""YOLOS: the port (spotter_tpu_torch.models.yolos, its zoo entry, the
softmax postprocess and the engine) against the JAX package on the same
weights.

Flax params are drawn from a numpy seed (tests/torch_parity.py) and carried
across with `convert.from_jax`. Both sides run on the CPU, so the port's
attention takes its plain path (the kernel runs only on CUDA tensors) and
JAX's its einsum path.

Tolerances, each for its reason:
- "float32": atol 1e-5 / rtol 1e-5 on logits and boxes. fp32 on both
  sides, two layers deep, summed in other orders (measured ~5e-7).
- "mixed" (bf16 body): atol 0.05 on logits (|logits| ~ 1.4, where a bf16
  ulp is 2**-7: the two frameworks round at nearly but not exactly the
  same places — the bias add inside the product here, after it in JAX; the
  GELU's tanh form in one fp32 step here, per op in JAX — and two layers
  compound ~3 ulps), atol 0.01 on boxes (a sigmoid in fp32 of a bf16 head
  output of ~1, whose slope is <= 1/4).
- The engine: labels equal, scores within 1e-4, boxes within 1e-3 px at
  the 32x48 spec (tests/test_torch_engine.py's tolerances for fp32 forwards
  through a softmax and a box scale of 48).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from spotter_tpu.engine.engine import BuiltDetector as JBuilt
from spotter_tpu.engine.engine import InferenceEngine as JEngine
from spotter_tpu.models import layers as jl
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.yolos import YolosDetector as JYolos
from spotter_tpu.ops import postprocess as jpost
from spotter_tpu.ops.preprocess import IMAGENET_MEAN as J_MEAN
from spotter_tpu.ops.preprocess import IMAGENET_STD as J_STD
from spotter_tpu.ops.preprocess import PreprocessSpec as JSpec
from spotter_tpu.ops.preprocess import preprocess_image
from spotter_tpu.utils import precision as jprecision
from spotter_tpu_torch.convert.from_jax import load_from_jax, state_dict_from_jax
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import layers as tl
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.configs import YolosConfig
from spotter_tpu_torch.models.yolos import YolosDetector
from spotter_tpu_torch.ops import postprocess as tpost
from spotter_tpu_torch.ops.preprocess import device_rescale_normalize
from spotter_tpu_torch.utils import precision as tprecision
from tests.torch_parity import random_flax_params

MODEL = "hustvl/yolos-base"
TOL = {
    "float32": {"logits": dict(atol=1e-5, rtol=1e-5), "pred_boxes": dict(atol=1e-5, rtol=1e-5)},
    "mixed": {"logits": dict(atol=0.05, rtol=0), "pred_boxes": dict(atol=0.01, rtol=0)},
}


def _pixels(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 32, 48, 3)).astype(np.float32)


def _run_both(monkeypatch, policy, use_mid, seed=3):
    """Both packages' tiny YOLOS, built at their zoo's dtype for `policy`,
    on the same weights and pixels."""
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    jcfg = dataclasses.replace(jzoo.tiny_yolos_config(), use_mid_position_embeddings=use_mid)
    tcfg = dataclasses.replace(tzoo.tiny_yolos_config(), use_mid_position_embeddings=use_mid)
    x = _pixels()
    jmodel = JYolos(jcfg, dtype=jprecision.backbone_dtype())
    params = random_flax_params(jmodel, x[:1], seed=seed)
    jout = jax.jit(jmodel.apply)({"params": params}, x)
    model = load_from_jax(YolosDetector(tcfg, dtype=tprecision.backbone_dtype()).eval(), params)
    with torch.inference_mode():
        tout = model(torch.from_numpy(x))
    return jout, tout, model


@pytest.mark.parametrize("policy", ["float32", "mixed"])
@pytest.mark.parametrize("use_mid", [True, False])
def test_tiny_yolos_matches_jax(monkeypatch, policy, use_mid):
    jout, tout, model = _run_both(monkeypatch, policy, use_mid)
    assert model.dtype == (torch.float32 if policy == "float32" else torch.bfloat16)
    for key in ("logits", "pred_boxes"):
        assert tout[key].dtype == torch.float32
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), **TOL[policy][key])
    assert tout["logits"].shape == (2, 5, 81) and tout["pred_boxes"].shape == (2, 5, 4)


def test_every_yolos_leaf_is_carried_across():
    """Each flax leaf lands on one port tensor with its values, in the
    layout the rules give (dense (in, out) -> (out, in), conv HWIO -> OIHW,
    LayerNorm scale -> weight, tables as they are); none is left over."""
    x = _pixels(1)
    jmodel = JYolos(jzoo.tiny_yolos_config())
    params = random_flax_params(jmodel, x, seed=5)
    model = YolosDetector(tzoo.tiny_yolos_config())
    sd = state_dict_from_jax(params, model)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(sd) == len(model.state_dict())
    seen = set()
    for path, leaf in flat:
        names = [p.key for p in path]
        leaf = np.asarray(leaf)
        *parent, name = names
        if name == "kernel":
            key, want = ".".join(parent + ["weight"]), (leaf.T if leaf.ndim == 2 else
                                                         leaf.transpose(3, 2, 0, 1))
        elif name == "scale":
            key, want = ".".join(parent + ["weight"]), leaf
        else:
            key, want = ".".join(names), leaf
        np.testing.assert_array_equal(sd[key].numpy(), want)
        seen.add(key)
    assert seen == set(model.state_dict())
    assert {"cls_token", "detection_tokens", "position_embeddings", "mid_position_embeddings",
            "patch_projection.weight", "layer1.attention.query.weight",
            "class_labels_classifier.layer2.bias", "layernorm.weight"} <= seen


def test_mixed_body_stores_what_flax_casts():
    """Under a bf16 body the head's dense weights are bf16 (flax casts them
    at use); the QuantDense projections keep fp32 masters (an int8 path
    quantizes the fp32 param) and use their bf16 casts; LayerNorm params,
    the patch conv and the tables stay fp32, as flax keeps and applies them."""
    model = YolosDetector(tzoo.tiny_yolos_config(), dtype=torch.bfloat16)
    dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    assert dtypes["bbox_predictor.layer0.weight"] == torch.bfloat16
    for key in ("layer0.layernorm_before.weight", "layernorm.bias", "patch_projection.weight",
                "patch_projection.bias", "cls_token", "mid_position_embeddings",
                "layer0.attention.key.weight", "layer0.fc2.bias"):
        assert dtypes[key] == torch.float32, key
    w, b = model.layer0.fc2.params_at_dtype()
    assert w.dtype == b.dtype == torch.bfloat16
    assert torch.equal(w, model.layer0.fc2.weight.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_embed_matches_jax(dtype):
    """fp32: atol 1e-5 (48-term fp32 sums in another order); bf16: both
    round pixels and kernel to bf16, sum in fp32 and round once, so within
    one bf16 ulp (rtol 2**-7)."""
    x = np.random.default_rng(7).uniform(-2, 2, (2, 16, 24, 3)).astype(np.float32)
    jmod = jl.PatchEmbed(32, 8, dtype=getattr(jax.numpy, dtype))
    params = random_flax_params(jmod, x, seed=8)
    want = np.asarray(jmod.apply({"params": params}, x), np.float32)
    tmod = load_from_jax(tl.PatchEmbed(3, 32, 8, dtype=getattr(torch, dtype)), params)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 6, 32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2**-8, rtol=2**-7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("ties", [False, True])
def test_softmax_postprocess_matches_jax(ties):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 6, 5)).astype(np.float32)
    if ties:
        logits[0, 0] = [1.0, 3.0, 3.0, 0.0, 5.0]  # tie at 1 and 2; "no object" largest
        logits[1, :, :4] = 0.25  # every real class equal: the first wins
    boxes = rng.uniform(0.1, 0.9, (2, 6, 4)).astype(np.float32)
    sizes = np.asarray([[480, 640], [800, 1344]], np.float32)
    want = jpost.softmax_postprocess(logits, boxes, sizes)
    got = tpost.softmax_postprocess(*map(torch.from_numpy, (logits, boxes, sizes)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-7)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)
    if ties:
        assert got[1][0, 0] == 1 and (got[1][1] == 0).all()


def _photo(seed, h=32, w=48):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx[..., None] / 7.0 + np.arange(3)) * np.cos(yy[..., None] / 5.0)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def test_imagenet_normalization_matches_jax():
    spec = tzoo.build_yolos(MODEL, tiny=True).preprocess_spec
    jspec = JSpec(mode="fixed", size=(32, 48), mean=J_MEAN, std=J_STD)
    assert (spec.mean, spec.std, spec.size) == (J_MEAN, J_STD, (32, 48))
    imgs = [_photo(1), _photo(2)]
    got = device_rescale_normalize(torch.from_numpy(np.stack(imgs)), spec).numpy()
    want = np.stack([preprocess_image(Image.fromarray(a), jspec)[0] for a in imgs])
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def yolos_engines():
    """(JAX engine, port engine) on the same tiny YOLOS weights, threshold 0
    so every detection token's answer is compared."""
    cfg = jzoo.tiny_yolos_config()
    jmodule = JYolos(cfg)
    params = random_flax_params(jmodule, np.zeros((1, 32, 48, 3), np.float32), seed=13)
    jbuilt = JBuilt(
        model_name=MODEL, module=jmodule, params=params,
        preprocess_spec=JSpec(mode="fixed", size=(32, 48), mean=J_MEAN, std=J_STD),
        postprocess="softmax", id2label=cfg.id2label_dict,
        num_top_queries=cfg.num_detection_tokens,
    )
    jeng = JEngine(jbuilt, batch_buckets=(4,), threshold=0.0)
    tbuilt = registry.build_detector(MODEL, tiny=True, params=params)
    teng = InferenceEngine(tbuilt, threshold=0.0, device="cpu")
    return jeng, teng


def test_engine_detect_matches_jax_on_tiny_yolos(yolos_engines):
    jeng, teng = yolos_engines
    imgs = [_photo(s) for s in (20, 21, 22)]
    want = jeng.detect([Image.fromarray(a) for a in imgs])
    got = teng.detect(imgs)
    assert [len(d) for d in got] == [len(d) for d in want] == [5, 5, 5]
    for g_img, w_img in zip(got, want):
        assert [d["label"] for d in g_img] == [d["label"] for d in w_img]
        np.testing.assert_allclose([d["score"] for d in g_img], [d["score"] for d in w_img],
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray([d["box"] for d in g_img]),
                                   np.asarray([d["box"] for d in w_img]), atol=1e-3)


def test_yolos_preset_and_registry():
    assert registry.family_for(MODEL).name == "yolos"
    assert registry.family_for("hustvl/yolos-small").name == "yolos"
    cfg = tzoo.yolos_preset("hustvl/yolos-base")
    assert dataclasses.replace(cfg, id2label=()) == YolosConfig()
    assert cfg.id2label_dict[1] == "person" and cfg.id2label_dict[12] == "N/A"
    assert len(cfg.id2label) == cfg.num_labels == 91
    gh, gw = cfg.grid_hw
    assert 1 + gh * gw + cfg.num_detection_tokens == 4301
    with pytest.raises(ValueError, match="only yolos-base"):
        registry.build_detector("hustvl/yolos-small", tiny=False)


def test_init_yolos_draws_distinct_tokens():
    """Seeded, and the token tables are N(0, 0.02^2), not flax's zeros, so
    the detection tokens are distinct rows."""
    a = tzoo.build_yolos(MODEL, tiny=True, seed=1).module
    b = tzoo.build_yolos(MODEL, tiny=True, seed=1).module
    c = tzoo.build_yolos(MODEL, tiny=True, seed=2).module
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    assert not torch.equal(a.detection_tokens, c.detection_tokens)
    det = a.detection_tokens[0]
    assert torch.cdist(det, det).add(torch.eye(len(det))).min() > 0
    tables = torch.cat([a.position_embeddings.flatten(), a.mid_position_embeddings.flatten()])
    assert abs(tables.std().item() - 0.02) < 0.002
    assert a.layernorm.weight.eq(1).all() and a.layer0.fc1.bias.eq(0).all()


# --- precision policy and the knobs the port does not run -----------------


@pytest.mark.parametrize("policy,dtype", [("mixed", torch.bfloat16), ("bfloat16", torch.bfloat16),
                                          ("float32", torch.float32)])
def test_yolos_builds_its_body_at_the_backbone_dtype(monkeypatch, policy, dtype):
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    built = registry.build_detector(MODEL, tiny=True)
    assert built.module.dtype == dtype
    assert built.module.layer0.fc1.dtype == dtype  # an fp32 master kernel, cast at use
    out = InferenceEngine(built, device="cpu").detect([_photo(3)])
    assert len(out) == 1


@pytest.mark.parametrize("policy", ["mixed", "bfloat16"])
def test_rtdetr_refuses_non_float32_policies(monkeypatch, policy):
    """Formerly a refusal: RT-DETR now builds under "mixed" and "bfloat16"
    (its backbone bf16 under both, the rest bf16 under "bfloat16") and
    serves a photo through the engine, with fp32 outputs."""
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", policy)
    built = registry.build_detector("PekingU/rtdetr_v2_r101vd", tiny=True)
    model = built.module
    compute = torch.bfloat16 if policy == "bfloat16" else torch.float32
    assert model.backbone.stem0.dtype == torch.bfloat16  # (an fp32 master kernel)
    assert model.decoder_layer0.fc1.weight.dtype == compute
    with torch.inference_mode():
        out = model(torch.zeros((1, 64, 64, 3)))
    assert out["logits"].dtype == out["pred_boxes"].dtype == torch.float32
    (dets,) = InferenceEngine(built, device="cpu").detect([_photo(4)])
    assert isinstance(dets, list)


@pytest.mark.parametrize("knob", ["SPOTTER_TPU_INT8", "SPOTTER_TPU_INT8_DENSE",
                                  "SPOTTER_TPU_INT8_ATTN"])
@pytest.mark.parametrize("model_name", [MODEL, "PekingU/rtdetr_v2_r101vd"])
def test_int8_knobs_raise(monkeypatch, knob, model_name):
    """Formerly a refusal: each int8 knob now builds. SPOTTER_TPU_INT8 takes
    RT-DETR's ConvNorm layers to the int8 path (YOLOS has none, so its
    forward stays float), _INT8_DENSE or _INT8_ATTN alone is a no-op (the
    float forward bit for bit), and "0" keeps the float path."""
    from tests.test_torch_int8 import assert_knob_serves

    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 32, 48, 3) if model_name == MODEL else (2, 64, 64, 3)).astype(np.float32))
    assert_knob_serves(monkeypatch, knob, lambda: registry.build_detector(model_name, tiny=True)
                       .module.eval(), lambda m: m(x),
                       quantizes=knob == "SPOTTER_TPU_INT8" and model_name != MODEL)


@pytest.mark.parametrize("backend,wrapper", [("pallas_sep", "msda_sep_sum"),
                                             ("pallas_gather", "msda_hd_gather_sum")])
def test_msda_backends_build_and_run_their_wrappers(monkeypatch, backend, wrapper):
    """SPOTTER_TPU_MSDA=pallas_sep|pallas_gather builds both MSDA families,
    and their forwards go through the backend's own wrapper: on the CPU its
    plain version runs and no launch is counted."""
    from spotter_tpu_torch.ops import msda as tmsda

    monkeypatch.setenv("SPOTTER_TPU_MSDA", backend)
    monkeypatch.setattr(tmsda, "MSDA_BACKEND", backend)
    calls = []
    real = getattr(tmsda, wrapper)
    monkeypatch.setattr(tmsda, wrapper, lambda *a, **k: calls.append(1) or real(*a, **k))
    for name, hw in (("PekingU/rtdetr_v2_r101vd", (64, 64)), ("SenseTime/deformable-detr", (48, 64))):
        built = registry.build_detector(name, tiny=True)
        x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, *hw, 3)).astype(np.float32))
        calls.clear()
        with torch.inference_mode():
            out = built.module(x)
        assert torch.isfinite(out["logits"]).all() and calls, (name, backend)
        assert real.launches == 0


def test_bad_msda_backend_has_the_jax_error_text(monkeypatch):
    from spotter_tpu.ops.msda import msda_backend

    with pytest.raises(ValueError) as want:
        msda_backend("bogus")
    monkeypatch.setenv("SPOTTER_TPU_MSDA", "bogus")
    with pytest.raises(ValueError) as got:
        registry.build_detector("PekingU/rtdetr_v2_r101vd", tiny=True)
    assert str(got.value) == str(want.value)
