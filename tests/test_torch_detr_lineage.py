"""Conditional-DETR and DAB-DETR: the port
(spotter_tpu_torch.models.conditional_detr and .dab_detr) against the JAX
package on the same weights.

Flax params are drawn from a numpy seed (tests/torch_parity.py) and carried
across with `convert.from_jax` (strict: no missing and no unexpected key,
the root query tables, every PReLU's `activation.weight` and each shared
head once); both sides run the same NHWC pixels and pixel mask in fp32 on
the CPU.

Tolerances are the Deformable-DETR ones (tests/test_torch_deformable_detr.py):
boxes atol 2e-4 (DAB's `aux_boxes` too), logits atol 5e-4, both rtol 1e-3,
fp32 on both sides summed in other orders; `attend` alone 1e-5. PReLU is
held exactly; the sine embeddings to one float32 ulp of 1 (2**-23), by
which XLA's CPU sin/cos and PyTorch's differ on a few arguments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import conditional_detr as jcond
from spotter_tpu.models import dab_detr as jdab
from spotter_tpu.models import registry as jregistry
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.layers import PReLU as JPReLU
from spotter_tpu_torch.convert.from_jax import load_from_jax, state_dict_from_jax
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.models import conditional_detr as tcond
from spotter_tpu_torch.models import dab_detr as tdab
from spotter_tpu_torch.models import registry
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.layers import PReLU
from tests.torch_parity import random_flax_params

BOX_ATOL, LOGIT_ATOL, RTOL = 2e-4, 5e-4, 1e-3
SINE_ATOL = 2.0**-23


def _pixels_and_mask(seed):
    """Two 64x64 images, each with its own padded region (pad pixels 0)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (2, 64, 64, 3)).astype(np.float32)
    mask = np.ones((2, 64, 64), np.float32)
    mask[0, :, 40:] = 0
    mask[1, 48:, :] = 0
    return x * mask[..., None], mask


# family -> (JAX detector, port detector, JAX tiny config, port tiny config)
FAMILIES = {
    "conditional": (jcond.ConditionalDetrDetector, tcond.ConditionalDetrDetector,
                    jzoo.tiny_conditional_detr_config, tzoo.tiny_conditional_detr_config),
    "dab": (jdab.DabDetrDetector, tdab.DabDetrDetector, jzoo.tiny_dab_detr_config,
            tzoo.tiny_dab_detr_config),
}
# variants: (family, config overrides)
VARIANTS = {
    "conditional": ("conditional", {}),
    "conditional_3_layers": ("conditional", dict(decoder_layers=3)),
    "conditional_1_layer": ("conditional", dict(decoder_layers=1)),
    "dab": ("dab", {}),
    "dab_keep_query_pos": ("dab", dict(keep_query_pos=True)),
    "dab_1_layer": ("dab", dict(decoder_layers=1)),
}


def _pair(variant, seed):
    family, kw = VARIANTS[variant]
    jcls, tcls, jtiny, ttiny = FAMILIES[family]
    jmodel = jcls(dataclasses.replace(jtiny(), **kw))
    x, mask = _pixels_and_mask(seed)
    params = random_flax_params(jmodel, x[:1], mask[:1], seed=seed + 1)
    return jmodel, tcls(dataclasses.replace(ttiny(), **kw)).eval(), params, x, mask


# each family masked and unmasked; the layer-count and keep_query_pos
# variants once each
PARITY_CASES = [("conditional", True), ("conditional", False), ("dab", True), ("dab", False),
                ("conditional_3_layers", True), ("conditional_1_layer", False),
                ("dab_keep_query_pos", True), ("dab_1_layer", False)]


@pytest.mark.parametrize("variant,masked", PARITY_CASES,
                         ids=[f"{v}-{'mask' if m else 'no_mask'}" for v, m in PARITY_CASES])
def test_tiny_model_matches_jax(variant, masked):
    jmodel, model, params, x, mask = _pair(variant, 1)
    jargs = (x, mask) if masked else (x,)
    jout = jax.jit(jmodel.apply)({"params": params}, *jargs)
    load_from_jax(model, params)
    with torch.inference_mode():
        tout = model(*(torch.from_numpy(a) for a in jargs))
    assert set(tout) == set(jout)
    for key in tout:
        atol = BOX_ATOL if "box" in key else LOGIT_ATOL
        assert tout[key].shape == jout[key].shape, key
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=atol,
                                   rtol=RTOL, err_msg=f"{variant}: {key}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flax_params_load_strictly(variant):
    """Every flax leaf has a port key and every port key a leaf: the root
    query table, each PReLU's `activation.weight`, `ca_qpos_proj` where flax
    has it, and the shared heads once."""
    _, model, params, _, _ = _pair(variant, 2)
    sd = state_dict_from_jax(params, model)
    assert set(sd) == set(model.state_dict())
    cfg = model.config
    layers_with_qpos = {k.split(".")[0] for k in sd if ".ca_qpos_proj." in k}
    first_only = not getattr(cfg, "keep_query_pos", False)
    assert layers_with_qpos == ({"decoder_layer0"} if first_only else
                                {f"decoder_layer{i}" for i in range(cfg.decoder_layers)})
    assert ("query_scale.layer0.weight" in sd) == (cfg.decoder_layers > 1)
    if VARIANTS[variant][0] == "dab":
        prelus = sorted(k for k in sd if k.endswith("activation.weight"))
        assert len(prelus) == cfg.encoder_layers + cfg.decoder_layers
        assert "query_refpoints" in sd and "bbox_predictor.layer2.weight" in sd
        assert not any(k.startswith("decoder_layer") and "bbox" in k for k in sd)
    else:
        assert "query_pos" in sd


def test_query_sine_embedding_matches_jax():
    pos = np.random.default_rng(3).uniform(0, 1, (2, 7, 2)).astype(np.float32)
    want = np.asarray(jcond.query_sine_embedding(jnp.asarray(pos), 32))
    got = tcond.query_sine_embedding(torch.from_numpy(pos), 32).numpy()
    assert got.shape == (2, 7, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=SINE_ATOL)


def test_anchor_sine_embedding_matches_jax():
    boxes = np.random.default_rng(4).uniform(0, 1, (2, 7, 4)).astype(np.float32)
    want = np.asarray(jdab.anchor_sine_embedding(jnp.asarray(boxes), 32))
    got = tdab.anchor_sine_embedding(torch.from_numpy(boxes), 32).numpy()
    assert got.shape == (2, 7, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=SINE_ATOL)


@pytest.mark.parametrize("slope", [0.25, -0.5, 1.7])
def test_prelu_matches_jax_exactly(slope):
    x = np.random.default_rng(5).normal(0, 3, (4, 9)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 1e-30]
    params = {"weight": np.array([slope], np.float32)}
    want = np.asarray(JPReLU().apply({"params": params}, x))
    prelu = load_from_jax(PReLU(), params)
    assert PReLU().weight.tolist() == [0.25]  # flax's constant(0.25) init
    with torch.inference_mode():
        np.testing.assert_array_equal(prelu(torch.from_numpy(x)).numpy(), want)


def test_attend_takes_wider_queries_and_keys():
    """q and k twice as wide as v (the conditional cross-attention), with an
    additive mask: against the JAX `_attend`."""
    rng = np.random.default_rng(6)
    q, k = rng.normal(size=(2, 5, 64)), rng.normal(size=(2, 11, 64))
    v = rng.normal(size=(2, 11, 32))
    mask = np.where(rng.uniform(size=(2, 1, 1, 11)) > 0.3, 0.0, np.finfo(np.float32).min)
    q, k, v, mask = (a.astype(np.float32) for a in (q, k, v, mask))
    want = np.asarray(jcond._attend(q, k, v, 4, mask, jnp.float32))
    got = tcond.attend(*(torch.from_numpy(a) for a in (q, k, v)), 4, torch.from_numpy(mask))
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


NAMES = {
    "microsoft/conditional-detr-resnet-50": "conditional_detr",
    "IDEA-Research/dab-detr-resnet-50": "dab_detr",
    "dab-detr-resnet-50": "dab_detr",
    "conditional-detr-resnet-50": "conditional_detr",
    "facebook/detr-resnet-50": "detr",
}


@pytest.mark.parametrize("name", list(NAMES))
def test_family_resolution_matches_jax(name):
    assert registry.family_for(name).name == NAMES[name] == jregistry.family_for(name).name


@pytest.mark.parametrize("name,family,queries", [
    ("microsoft/conditional-detr-resnet-50", "conditional_detr", 300),
    ("IDEA-Research/dab-detr-resnet-50", "dab_detr", 300),
])
def test_presets_and_builders(name, family, queries, monkeypatch):
    monkeypatch.delenv("SPOTTER_TPU_DTYPE", raising=False)
    preset = tzoo.conditional_detr_preset if family == "conditional_detr" else tzoo.dab_detr_preset
    cfg = preset(name)
    assert cfg.num_queries == queries and cfg.num_labels == 91 and cfg.d_model == 256
    assert cfg.backbone.depths == (3, 4, 6, 3) and cfg.backbone.style == "v1"
    assert cfg.id2label_dict[1] == "person"
    if family == "dab_detr":
        assert (cfg.temperature_height, cfg.temperature_width) == (20.0, 20.0)
        assert cfg.activation_function == "prelu" and not cfg.keep_query_pos
    built = registry.build_detector(name, tiny=True)
    assert built.needs_mask and built.postprocess == "sigmoid_topk"
    assert built.num_top_queries == 9 and built.preprocess_spec == tzoo.TINY_DETR_SPEC
    full = registry.build_detector(name, tiny=False)
    assert full.num_top_queries == 100 and full.preprocess_spec.input_hw == (1333, 1333)
    # formerly a refusal: "bfloat16" builds, every dense and conv at bf16
    monkeypatch.setenv("SPOTTER_TPU_DTYPE", "bfloat16")
    model = registry.build_detector(name, tiny=True).module
    assert model.backbone.stem0.dtype == torch.bfloat16  # (an fp32 master kernel)
    assert model.decoder_layer0.fc1.weight.dtype == torch.bfloat16
    assert model.decoder_layernorm.weight.dtype == torch.float32


@pytest.mark.parametrize("name", ["IDEA-Research/dab-detr-resnet-50-pat3",
                                  "IDEA-Research/dab-detr-resnet-101-pat3",
                                  "IDEA-Research/dab-detr-resnet-50-dc5-pat3",
                                  "microsoft/conditional-detr-resnet-50-dc5"])
def test_refused_checkpoints_raise_with_the_jax_text(name):
    from spotter_tpu.models.configs import DabDetrConfig, check_no_dilation

    hf = type("HF", (), {"dilation": "dc5" in name, "query_dim": 4, "num_patterns": 3})()
    with pytest.raises(ValueError) as jerr:
        check_no_dilation(hf)
        DabDetrConfig.from_hf(hf)
    with pytest.raises(ValueError) as terr:
        registry.build_detector(name, tiny=False)
    assert str(terr.value) == str(jerr.value)


def test_seeded_init_is_deterministic_and_flax_shaped():
    cfg = tzoo.tiny_dab_detr_config()
    a = tzoo.init_dab_detr(tdab.DabDetrDetector(cfg), seed=3).state_dict()
    b = tzoo.init_dab_detr(tdab.DabDetrDetector(cfg), seed=3).state_dict()
    c = tzoo.init_dab_detr(tdab.DabDetrDetector(cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query_refpoints"], c["query_refpoints"])
    assert all(a[k].tolist() == [0.25] for k in a if k.endswith("activation.weight"))
    ccfg = tzoo.tiny_conditional_detr_config()
    d = tzoo.init_conditional_detr(tcond.ConditionalDetrDetector(ccfg), seed=3).state_dict()
    assert abs(d["query_pos"].std().item() - 1.0) < 0.3  # normal(1.0)
    assert torch.count_nonzero(d["class_labels_classifier.bias"]) == 0


@pytest.mark.parametrize("name,family", [("microsoft/conditional-detr-resnet-50", "conditional"),
                                         ("IDEA-Research/dab-detr-resnet-50", "dab")])
def test_engine_detect_matches_jax_engine(name, family):
    """Both families through the engine on the same weights, photos of both
    orientations staged with their mask and a padded batch row: the same
    labels, scores and boxes as the JAX engine's, in each photo's pixels."""
    from PIL import Image

    from spotter_tpu.engine.engine import BuiltDetector as JBuilt
    from spotter_tpu.engine.engine import InferenceEngine as JEngine
    from spotter_tpu.ops import preprocess as jpre

    jcls, _, jtiny, _ = FAMILIES[family]
    jmodel = jcls(jtiny())
    x, mask = _pixels_and_mask(8)
    params = random_flax_params(jmodel, x[:1], mask[:1], seed=9)
    jspec = jpre.PreprocessSpec(mode="shortest_edge", size=(48, 64), mean=jpre.IMAGENET_MEAN,
                                std=jpre.IMAGENET_STD, pad_to=(64, 64))
    jbuilt = JBuilt(model_name=name, module=jmodel, params=params, preprocess_spec=jspec,
                    postprocess="sigmoid_topk", id2label=jmodel.config.id2label_dict,
                    num_top_queries=min(100, jmodel.config.num_queries), needs_mask=True)
    jengine = JEngine(jbuilt, batch_buckets=(1, 4), threshold=0.0)
    engine = InferenceEngine(registry.build_detector(name, tiny=True, params=params),
                             batch_buckets=(1, 4), device="cpu", threshold=0.0)
    rng = np.random.default_rng(7)
    photos = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((48, 64), (64, 48), (48, 64))]
    want = jengine.detect([Image.fromarray(p) for p in photos])
    got = engine.detect(photos)
    for g, w in zip(got, want, strict=True):
        assert len(g) == len(w) > 0
        assert [d["label"] for d in g] == [d["label"] for d in w]
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w], atol=1e-4)
        np.testing.assert_allclose(np.asarray([d["box"] for d in g]),
                                   np.asarray([d["box"] for d in w]), atol=1e-3)
