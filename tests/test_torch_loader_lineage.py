"""The port's local-checkpoint loader against the JAX package's for the DETR
lineage: Deformable-DETR (plain, single-scale, with box refinement and
two-stage), DETR, Table-Transformer, Conditional-DETR and DAB-DETR; their
configs with keys missing, the timm backbone naming, and the refusals.

As in tests/test_torch_loader.py: tiny HF models from a config
(`torch.manual_seed`, BatchNorm statistics drawn), written with
`save_pretrained` (Deformable-DETR with box refinement as
`pytorch_model.bin`: safetensors refuses its shared heads), read by both
loaders (the JAX one's cache under a temporary SPOTTER_TPU_CACHE). Params
must be equal bit for bit and configs field for field; DAB-DETR's forward
from the directory is held to tests/test_rtdetr_parity.py's tolerances
(boxes atol 2e-4, logits atol 5e-4, both rtol 1e-3).
"""

import json

import jax
import numpy as np
import pytest
import torch
from transformers import AutoConfig
from transformers import ConditionalDetrConfig as HFConditionalDetrConfig
from transformers import DabDetrConfig as HFDabDetrConfig
from transformers import DeformableDetrConfig as HFDeformableDetrConfig
from transformers import DetrConfig as HFDetrConfig
from transformers import ResNetConfig as HFResNetConfig
from transformers import TableTransformerConfig
from transformers.models.conditional_detr.modeling_conditional_detr import (
    ConditionalDetrForObjectDetection,
)
from transformers.models.dab_detr.modeling_dab_detr import DabDetrForObjectDetection
from transformers.models.deformable_detr.modeling_deformable_detr import (
    DeformableDetrForObjectDetection,
)
from transformers.models.detr.modeling_detr import DetrForObjectDetection
from transformers.models.table_transformer.modeling_table_transformer import (
    TableTransformerForObjectDetection,
)

from spotter_tpu.convert import loader as jloader
from spotter_tpu.convert.deformable_detr_rules import deformable_detr_rules as jdeformable_rules
from spotter_tpu.convert.detr_rules import detr_rules as jdetr_rules
from spotter_tpu.convert.torch_to_jax import convert_state_dict as jconvert
from spotter_tpu.models import configs as jconfigs
from spotter_tpu.models.dab_detr import DabDetrDetector as JDabDetr
from spotter_tpu_torch.convert import checkpoint_io, loader
from spotter_tpu_torch.convert.hf_config import read_hf_config
from spotter_tpu_torch.models import configs, registry
from tests.test_torch_loader import (
    BOX_ATOL,
    LOGIT_ATOL,
    RTOL,
    assert_params_equal,
    assert_same_config,
    check_config_case,
    config_pair,
    jax_cache,  # noqa: F401  (the autouse JAX cache fixture)
    save,
)


def tiny_backbone(levels: int = 1, layer_type: str = "basic"):
    out = ["stage4"] if levels == 1 else ["stage2", "stage3", "stage4"]
    return HFResNetConfig(embedding_size=8, hidden_sizes=[8, 12, 16, 24], depths=[1, 1, 1, 1],
                          layer_type=layer_type, out_features=out)


_WIDTHS = dict(encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
               decoder_attention_heads=4, encoder_ffn_dim=48, decoder_ffn_dim=48, num_labels=7)
_HF_BACKBONE = dict(use_timm_backbone=False, use_pretrained_backbone=False, backbone=None)


def tiny_deformable(num_feature_levels=4, **kw):
    return HFDeformableDetrConfig(
        **_HF_BACKBONE, backbone_config=tiny_backbone(1 if num_feature_levels == 1 else 3),
        d_model=32, encoder_n_points=3, decoder_n_points=2,
        num_feature_levels=num_feature_levels, num_queries=11, two_stage_num_proposals=9,
        disable_custom_kernels=True, **_WIDTHS, **kw)


def tiny_detr(layer_type="basic"):
    return HFDetrConfig(**_HF_BACKBONE, backbone_config=tiny_backbone(1, layer_type), d_model=32,
                        num_queries=9, **_WIDTHS)


def tiny_table_transformer():
    return TableTransformerConfig(**_HF_BACKBONE, backbone_config=tiny_backbone(), d_model=32,
                                  num_queries=9, **_WIDTHS)


def tiny_conditional():
    return HFConditionalDetrConfig(**_HF_BACKBONE, backbone_config=tiny_backbone(), d_model=32,
                                   num_queries=9, **_WIDTHS)


def tiny_dab(**kw):
    return HFDabDetrConfig(**_HF_BACKBONE, backbone_config=tiny_backbone(), hidden_size=32,
                           num_queries=9, **_WIDTHS, **kw)


# variant -> (family, MODEL_NAME-like directory, HF model class, config factory,
# safetensors?)
VARIANTS = {
    "deformable": ("deformable_detr", "SenseTime/deformable-detr-tiny",
                   DeformableDetrForObjectDetection, tiny_deformable, True),
    "deformable_single_scale": ("deformable_detr", "SenseTime/deformable-detr-single-scale",
                                DeformableDetrForObjectDetection,
                                lambda: tiny_deformable(num_feature_levels=1), True),
    "deformable_box_refine": ("deformable_detr", "SenseTime/deformable-detr-with-box-refine",
                              DeformableDetrForObjectDetection,
                              lambda: tiny_deformable(with_box_refine=True), False),
    "deformable_two_stage": ("deformable_detr",
                             "SenseTime/deformable-detr-with-box-refine-two-stage",
                             DeformableDetrForObjectDetection,
                             lambda: tiny_deformable(with_box_refine=True, two_stage=True),
                             False),
    "detr": ("detr", "facebook/detr-resnet-tiny", DetrForObjectDetection, tiny_detr, True),
    "detr_bottleneck": ("detr", "facebook/detr-resnet-bottleneck", DetrForObjectDetection,
                        lambda: tiny_detr("bottleneck"), True),
    "table_transformer": ("detr", "microsoft/table-transformer-tiny",
                          TableTransformerForObjectDetection, tiny_table_transformer, True),
    "conditional": ("conditional_detr", "microsoft/conditional-detr-tiny",
                    ConditionalDetrForObjectDetection, tiny_conditional, True),
    "dab": ("dab_detr", "IDEA-Research/dab-detr-tiny", DabDetrForObjectDetection, tiny_dab,
            True),
    "dab_keep_query_pos": ("dab_detr", "IDEA-Research/dab-detr-keep", DabDetrForObjectDetection,
                           lambda: tiny_dab(keep_query_pos=True), True),
}
JAX_LOADERS = {"deformable_detr": jloader.load_deformable_detr_from_hf,
               "detr": jloader.load_detr_from_hf,
               "conditional_detr": jloader.load_conditional_detr_from_hf,
               "dab_detr": jloader.load_dab_detr_from_hf}


def saved(tmp_path, variant: str):
    family, name, model_cls, factory, safe = VARIANTS[variant]
    path = tmp_path / name
    save(model_cls, factory(), path, safe)
    return family, path


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lineage_checkpoint_loads_as_jax(tmp_path, variant):
    family, path = saved(tmp_path, variant)
    jcfg, jparams = JAX_LOADERS[family](str(path))
    cfg, params = loader.load_from_hf(family, path)
    assert_same_config(cfg, jcfg)
    assert_params_equal(params, jparams)
    # the registry routes the directory by its name and builds that checkpoint
    built = registry.build_detector(str(path), tiny=False)
    assert registry.family_for(str(path)).name == family
    assert built.module.config == cfg
    assert built.id2label == {i: f"LABEL_{i}" for i in range(7)}


def test_tied_twins_as_the_files_hold_them(tmp_path):
    """DAB-DETR's file keeps the decoder's box head and drops
    `bbox_predictor`; Deformable-DETR without refinement drops the head
    clones past index 0; with refinement the .bin keeps both copies."""
    _, dab = saved(tmp_path, "dab")
    keys = set(checkpoint_io.read_checkpoint(dab))
    assert not any(k.startswith("bbox_predictor.") for k in keys)
    assert "model.decoder.bbox_embed.layers.0.weight" in keys
    _, plain = saved(tmp_path, "deformable")
    keys = set(checkpoint_io.read_checkpoint(plain))
    assert "class_embed.0.weight" in keys and "class_embed.1.weight" not in keys
    _, refine = saved(tmp_path, "deformable_box_refine")
    keys = set(checkpoint_io.read_checkpoint(refine))
    assert {"bbox_embed.1.layers.0.weight", "model.decoder.bbox_embed.1.layers.0.weight"} <= keys


@pytest.mark.parametrize("masked", [False, True])
def test_dab_forward_from_checkpoint_matches_jax(tmp_path, masked):
    """MODEL_NAME=<dir> through the port's zoo against the JAX detector on
    the JAX loader's params, on the same numpy pixels and pixel mask."""
    _, path = saved(tmp_path, "dab")
    jcfg, jparams = jloader.load_dab_detr_from_hf(str(path))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    mask = np.ones((2, 64, 96), np.float32)
    if masked:
        mask[0, :, 80:] = 0
        mask[1, 48:, :] = 0
    jout = jax.jit(JDabDetr(jcfg).apply)({"params": jparams}, x * mask[..., None], mask)
    built = registry.build_detector(str(path), tiny=False)
    with torch.inference_mode():
        tout = built.module(torch.from_numpy(x * mask[..., None]), torch.from_numpy(mask))
    for key in ("pred_boxes", "aux_boxes"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=BOX_ATOL,
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=LOGIT_ATOL, rtol=RTOL)


# --- the config view: every key a from_hf reads, deleted one at a time

_LINEAGE_KEYS = ["num_queries", "encoder_layers", "decoder_layers", "encoder_attention_heads",
                 "decoder_attention_heads", "encoder_ffn_dim", "decoder_ffn_dim",
                 "activation_function", "id2label", "backbone_config", "backbone",
                 "backbone_config.depths", "backbone_config.hidden_sizes",
                 "backbone_config.embedding_size", "backbone_config.layer_type",
                 "backbone_config.hidden_act", "backbone_config.num_channels",
                 "backbone_config.downsample_in_first_stage",
                 "backbone_config.downsample_in_bottleneck", "backbone_config.out_indices",
                 "backbone_config.out_features"]
CONFIG_CASES = {
    "detr": (tiny_detr, jconfigs.DetrConfig, configs.DetrConfig,
             _LINEAGE_KEYS + ["d_model", "dilation"]),
    "table_transformer": (tiny_table_transformer, jconfigs.DetrConfig, configs.DetrConfig,
                          _LINEAGE_KEYS + ["d_model", "dilation"]),
    "conditional": (tiny_conditional, jconfigs.ConditionalDetrConfig,
                    configs.ConditionalDetrConfig, _LINEAGE_KEYS + ["d_model", "dilation"]),
    "deformable": (tiny_deformable, jconfigs.DeformableDetrConfig,
                   configs.DeformableDetrConfig,
                   _LINEAGE_KEYS + ["d_model", "dilation", "position_embedding_type",
                                    "num_feature_levels", "encoder_n_points",
                                    "decoder_n_points", "with_box_refine", "two_stage",
                                    "two_stage_num_proposals"]),
    "dab": (tiny_dab, jconfigs.DabDetrConfig, configs.DabDetrConfig,
            _LINEAGE_KEYS + ["hidden_size", "query_dim", "num_patterns",
                             "normalize_before", "temperature_height", "temperature_width",
                             "keep_query_pos"]),
}


@pytest.mark.parametrize("case,key", [(c, k) for c, v in CONFIG_CASES.items() for k in v[3]])
def test_missing_config_key_takes_the_hf_default(tmp_path, case, key):
    check_config_case(tmp_path, case, key, CONFIG_CASES)


# --- the timm backbone naming (no timm on the CPU box: synthetic arrays)


def timm_checkpoint(tmp_path, config: dict, rules) -> dict:
    """config.json plus model.safetensors holding one distinct synthetic
    array for every key of `rules` (4-D for convs, 2-D for dense layers);
    returns the arrays."""
    rng = np.random.default_rng(0)
    shapes = {"conv": (3, 2, 1, 2), "dense": (3, 2), "vec": (5,)}
    arrays = {key: rng.standard_normal(shapes[kind]).astype(np.float32)
              for _, key, kind in rules.rules}
    (tmp_path / "config.json").write_text(json.dumps(config))
    checkpoint_io.write_safetensors(tmp_path / "model.safetensors",
                                    {k: torch.from_numpy(v) for k, v in arrays.items()})
    return arrays


@pytest.mark.parametrize("family,backbone", [("detr", "resnet18"), ("detr", "resnet50"),
                                              ("deformable_detr", "resnet50")])
def test_timm_naming_converts_as_jax(tmp_path, family, backbone):
    """A timm-backbone checkpoint (every published DETR-lineage one): the
    port reads its config's `backbone` name and converts the timm keys
    (conv1, layer{s}.{b}.conv{k}, downsample) exactly as the JAX package's
    convert_state_dict does."""
    hf = {"detr": tiny_detr, "deformable_detr": tiny_deformable}[family]().to_dict()
    hf.update(use_timm_backbone=True, backbone=backbone, backbone_config=None)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    jcfg = {"detr": jconfigs.DetrConfig, "deformable_detr": jconfigs.DeformableDetrConfig}[
        family].from_hf(AutoConfig.from_pretrained(tmp_path))
    jrules = {"detr": jdetr_rules, "deformable_detr": jdeformable_rules}[family](jcfg, "timm")
    assert any(".layer1.0.conv1.weight" in k for _, k, _ in jrules.rules)
    arrays = timm_checkpoint(tmp_path, hf, jrules)
    cfg, params = loader.load_from_hf(family, tmp_path)
    assert_same_config(cfg, jcfg)
    assert_params_equal(params, jconvert(arrays, jrules, strict=True))


# --- refusals with the JAX package's texts


@pytest.mark.parametrize("case,edit,text", [
    ("detr", {"dilation": True, "use_timm_backbone": True, "backbone": "resnet50",
              "backbone_config": None}, "dilated \\(dc5\\) backbones are not supported"),
    ("deformable", {"dilation": True}, "dilated \\(dc5\\) backbones are not supported"),
    ("dab", {"num_patterns": 3}, "num_patterns > 0 is not supported"),
    ("dab", {"normalize_before": True}, "normalize_before \\(pre-norm\\) DAB-DETR"),
    ("dab", {"activation_function": "relu"}, "Only activation_function='prelu'"),
])
def test_refused_configs_raise_with_the_jax_text(tmp_path, case, edit, text):
    factory, jcls, tcls, _ = CONFIG_CASES[case]
    path = config_pair(tmp_path, factory, None)
    data = json.loads((path / "config.json").read_text())
    data.update(edit)
    (path / "config.json").write_text(json.dumps(data))
    with pytest.raises(ValueError, match=text):
        jcls.from_hf(AutoConfig.from_pretrained(path))
    with pytest.raises(ValueError, match=text):
        tcls.from_hf(read_hf_config(path))


def test_query_dim_refusal_has_the_jax_text(tmp_path):
    """transformers refuses query_dim != 4 in the config class itself, so
    the JAX text is reached through the port's view, which has no such
    check: both from_hf methods raise it."""
    path = config_pair(tmp_path, tiny_dab, None)
    data = json.loads((path / "config.json").read_text())
    data["query_dim"] = 2
    (path / "config.json").write_text(json.dumps(data))
    with pytest.raises(ValueError, match="query dimensions has to be 4"):
        AutoConfig.from_pretrained(path)
    text = "Only query_dim=4 is supported, got 2"
    with pytest.raises(ValueError, match=text):
        jconfigs.DabDetrConfig.from_hf(read_hf_config(path))
    with pytest.raises(ValueError, match=text):
        configs.DabDetrConfig.from_hf(read_hf_config(path))
