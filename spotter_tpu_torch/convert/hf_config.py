"""A checkpoint's `config.json` as the attribute view `from_hf` reads.

The JAX package builds its configs with `config_cls.from_hf(AutoConfig.
from_pretrained(path))`. The port has no `transformers`, so `HFConfig`
gives the same attributes from the file itself, as `from_pretrained` would
set them:

- a key the file has is its value (lists stay lists; `from_hf` tuples them);
- a key it lacks takes the HF config class's default for its `model_type`,
  from `DEFAULTS` (values of transformers 4.57.6, for the keys the
  `from_hf` methods read); a key in neither raises AttributeError, so
  `getattr(hf, key, default)` behaves as on an HF config;
- `id2label` has int keys; without one, `num_labels` (default 2) labels
  `LABEL_i`; `num_labels` is the number of labels;
- `backbone_config`, `text_config` and `vision_config` are views too, of
  the nested dict or of the class's default sub-config; a ResNet's
  `out_indices` follows from its `out_features` (or is the last stage), as
  HF aligns them;
- the DETR-lineage classes' backbone rules: with `use_timm_backbone` false
  and `backbone` None or "resnet50", a missing `backbone_config` is HF's
  ResNet tapped at stage 4, and DETR, Table-Transformer and DAB-DETR set
  `backbone` and `dilation` to None (Conditional- and Deformable-DETR keep
  them); a `backbone` left beside a `backbone_config` raises, as HF's
  config classes refuse it.
"""

import json
from pathlib import Path

CONFIG_FILE = "config.json"

# the ResNet backbones' defaults (ResNetConfig, RTDetrResNetConfig)
_RESNET = dict(
    num_channels=3, embedding_size=64, hidden_sizes=[256, 512, 1024, 2048],
    depths=[3, 4, 6, 3], layer_type="bottleneck", hidden_act="relu",
    downsample_in_first_stage=False, downsample_in_bottleneck=False,
    out_features=None, out_indices=None,
)
_RTDETR = dict(
    use_timm_backbone=False, backbone=None, d_model=256, num_queries=300,
    encoder_hidden_dim=256, encoder_in_channels=[512, 1024, 2048], feat_strides=[8, 16, 32],
    encoder_ffn_dim=1024, encode_proj_layers=[2], encoder_layers=1,
    encoder_attention_heads=8, encoder_activation_function="gelu",
    activation_function="silu", hidden_expansion=1.0, positional_encoding_temperature=10000,
    decoder_ffn_dim=1024, num_feature_levels=3, decoder_n_points=4, decoder_layers=6,
    decoder_attention_heads=8, decoder_activation_function="relu",
    learn_initial_query=False, layer_norm_eps=1e-05, batch_norm_eps=1e-05,
)
_DETR = dict(
    use_timm_backbone=True, backbone="resnet50", dilation=False, d_model=256,
    num_queries=100, encoder_layers=6, decoder_layers=6, encoder_attention_heads=8,
    decoder_attention_heads=8, encoder_ffn_dim=2048, decoder_ffn_dim=2048,
    activation_function="relu", position_embedding_type="sine",
)
_OWL_TEXT = dict(
    vocab_size=49408, hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
    num_attention_heads=8, max_position_embeddings=16, hidden_act="quick_gelu",
    layer_norm_eps=1e-05,
)
_OWL_VISION = dict(
    hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
    hidden_act="quick_gelu", layer_norm_eps=1e-05, image_size=768, num_channels=3,
)

DEFAULTS = {
    "resnet": _RESNET,
    "rt_detr_resnet": _RESNET,
    "rt_detr": _RTDETR,
    "rt_detr_v2": dict(_RTDETR, decoder_offset_scale=0.5, decoder_method="default"),
    "detr": _DETR,
    "table-transformer": _DETR,
    "conditional_detr": dict(_DETR, num_queries=300),
    "deformable_detr": dict(
        _DETR, num_queries=300, encoder_ffn_dim=1024, decoder_ffn_dim=1024,
        num_feature_levels=4, encoder_n_points=4, decoder_n_points=4,
        with_box_refine=False, two_stage=False, two_stage_num_proposals=300,
    ),
    "dab-detr": dict(
        {k: v for k, v in _DETR.items() if k not in ("d_model", "position_embedding_type")},
        num_queries=300, hidden_size=256, activation_function="prelu", query_dim=4,
        num_patterns=0, normalize_before=False, temperature_height=20,
        temperature_width=20, keep_query_pos=False,
    ),
    "yolos": dict(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        intermediate_size=3072, hidden_act="gelu", image_size=[512, 864], patch_size=16,
        num_channels=3, num_detection_tokens=100, use_mid_position_embeddings=True,
        qkv_bias=True, layer_norm_eps=1e-12,
    ),
    "owlvit": dict(projection_dim=512),
    "owlv2": dict(projection_dim=512),
    "owlvit_text_model": _OWL_TEXT,
    "owlv2_text_model": _OWL_TEXT,
    "owlvit_vision_model": dict(_OWL_VISION, patch_size=32),
    "owlv2_vision_model": dict(_OWL_VISION, patch_size=16),
}

# the sub-config each class builds when the file has none: RT-DETR's is
# RTDetrResNetConfig with out_indices [2, 3, 4]; the OWL towers' are their
# classes' defaults
DEFAULT_SUBCONFIGS = {
    ("rt_detr", "backbone_config"): {"model_type": "rt_detr_resnet", "out_indices": [2, 3, 4]},
    ("rt_detr_v2", "backbone_config"): {"model_type": "rt_detr_resnet",
                                        "out_indices": [2, 3, 4]},
    ("owlvit", "text_config"): {"model_type": "owlvit_text_model"},
    ("owlvit", "vision_config"): {"model_type": "owlvit_vision_model"},
    ("owlv2", "text_config"): {"model_type": "owlv2_text_model"},
    ("owlv2", "vision_config"): {"model_type": "owlv2_vision_model"},
}
# the DETR-lineage default backbone: HF's ResNet tapped at stage 4
LINEAGE_BACKBONE = {"model_type": "resnet", "out_features": ["stage4"]}
LINEAGE = ("detr", "table-transformer", "conditional_detr", "deformable_detr", "dab-detr")
# the lineage classes that set `dilation` to None on the HF-backbone path
DILATION_RESET = ("detr", "table-transformer", "dab-detr")


class HFConfig:
    """Attribute view of one (possibly nested) HF config dict."""

    def __init__(self, data: dict, model_type: str | None = None):
        self._data = dict(data)
        self.model_type = model_type or self._data.get("model_type")
        if self.model_type not in DEFAULTS:
            raise ValueError(f"config model_type {self.model_type!r} is none the port reads: "
                             f"{sorted(DEFAULTS)}")
        self._data["model_type"] = self.model_type
        self._derived = self._derive()

    def _derive(self) -> dict:
        data, mt = self._data, self.model_type
        out = {}
        id2label = data.get("id2label")
        if id2label is None:
            id2label = {i: f"LABEL_{i}" for i in range(int(data.get("num_labels", 2)))}
        out["id2label"] = {int(k): v for k, v in id2label.items()}
        out["num_labels"] = len(out["id2label"])
        for sub in ("backbone_config", "text_config", "vision_config"):
            default = DEFAULT_SUBCONFIGS.get((mt, sub))
            nested = data.get(sub)
            if nested is None:
                nested = default
            if nested is not None:
                out[sub] = HFConfig(nested, nested.get("model_type")
                                    or (default or {}).get("model_type"))
        if mt in LINEAGE and not self._get("use_timm_backbone") and \
                self._get("backbone") in (None, "resnet50"):
            if "backbone_config" not in out:
                out["backbone_config"] = HFConfig(LINEAGE_BACKBONE)
            if mt in DILATION_RESET:
                out["backbone"] = out["dilation"] = None
        if out.get("backbone_config") is not None and \
                out.get("backbone", data.get("backbone", DEFAULTS[mt].get("backbone"))):
            # transformers' verify_backbone_config_arguments refuses the pair
            raise ValueError("You can't specify both `backbone` and `backbone_config`.")
        if mt in ("resnet", "rt_detr_resnet"):
            out["out_indices"] = self._out_indices()
        return out

    def _get(self, key: str):
        if key in self._data:
            return self._data[key]
        return DEFAULTS[self.model_type][key]

    def _out_indices(self) -> list[int]:
        """HF's alignment of out_features and out_indices over the stages
        ("stem", "stage1", ...): the indices given, else those of the
        features given, else the last stage."""
        stages = ["stem"] + [f"stage{i}" for i in range(1, len(self._get("depths")) + 1)]
        if self._get("out_indices") is not None:
            return list(self._get("out_indices"))
        if self._get("out_features") is not None:
            return [stages.index(f) for f in self._get("out_features")]
        return [len(stages) - 1]

    def __getattr__(self, key: str):
        if key.startswith("_"):
            raise AttributeError(key)
        if key in self._derived:
            return self._derived[key]
        try:
            return self._get(key)
        except KeyError:
            raise AttributeError(f"{self.model_type} config has no {key!r}") from None


def read_hf_config(directory) -> HFConfig:
    """`directory`/config.json as an HFConfig."""
    return HFConfig(json.loads((Path(directory) / CONFIG_FILE).read_text()))


def is_checkpoint_dir(model_name: str) -> bool:
    """Whether MODEL_NAME names a local directory holding a config.json."""
    return (Path(model_name) / CONFIG_FILE).is_file()
