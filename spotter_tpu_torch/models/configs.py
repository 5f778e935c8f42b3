"""Config dataclasses for the RT-DETR, YOLOS, OWL-ViT, Deformable-DETR and
DETR-lineage families (copy of spotter_tpu.models.configs).

The port keeps its own copy rather than importing the JAX package's module:
`ResNetConfig`, `RTDetrConfig` and their presets, `YolosConfig`, the three
OWL-ViT configs, `DeformableDetrConfig`, `DetrConfig`,
`ConditionalDetrConfig`, `DabDetrConfig` and the timm ResNet table,
unchanged, so a config built on one side means the same model on the other.
Each `from_hf` is the JAX one, with its refusals and texts: it reads a
checkpoint's config (convert/hf_config.py's view of config.json).
`OWL_PRESETS`, `DEFORMABLE_DETR_PRESETS`, `DETR_PRESETS`,
`CONDITIONAL_DETR_PRESETS` and `DAB_DETR_PRESETS` hold the published widths
by name, for a MODEL_NAME that is not a checkpoint directory.
"""

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ResNetConfig:
    """ResNet backbone in two flavors.

    style "d": RT-DETR's "presnet" (deep 3-conv stem, avg-pool downsample
    shortcuts — HF RTDetrResNetBackbone). style "v1": the classic
    torchvision-style ResNet (single 7x7 stem, strided 1x1 projection
    shortcuts — HF ResNetBackbone / timm resnet, the DETR backbone).
    """

    num_channels: int = 3
    embedding_size: int = 64
    hidden_sizes: tuple[int, ...] = (256, 512, 1024, 2048)
    depths: tuple[int, ...] = (3, 4, 6, 3)
    layer_type: str = "bottleneck"  # "basic" | "bottleneck"
    hidden_act: str = "relu"
    downsample_in_first_stage: bool = False
    downsample_in_bottleneck: bool = False
    style: str = "d"  # "d" (RT-DETR ResNet-D) | "v1" (classic / DETR)
    # indices into (stem, stage1, ..., stage4); RT-DETR taps strides 8/16/32
    out_indices: tuple[int, ...] = (2, 3, 4)

    @classmethod
    def from_hf(cls, hf) -> "ResNetConfig":
        return cls(
            num_channels=hf.num_channels,
            embedding_size=hf.embedding_size,
            hidden_sizes=tuple(hf.hidden_sizes),
            depths=tuple(hf.depths),
            layer_type=hf.layer_type,
            hidden_act=hf.hidden_act,
            downsample_in_first_stage=hf.downsample_in_first_stage,
            downsample_in_bottleneck=hf.downsample_in_bottleneck,
            style="v1" if hf.model_type == "resnet" else "d",
            out_indices=tuple(hf.out_indices),
        )


@dataclass(frozen=True)
class RTDetrConfig:
    """RT-DETR / RT-DETRv2 detector (hybrid encoder + deformable decoder)."""

    backbone: ResNetConfig = field(default_factory=ResNetConfig)
    num_labels: int = 80
    d_model: int = 256
    num_queries: int = 300
    # hybrid encoder
    encoder_hidden_dim: int = 256
    encoder_in_channels: tuple[int, ...] = (512, 1024, 2048)
    feat_strides: tuple[int, ...] = (8, 16, 32)
    encoder_ffn_dim: int = 1024
    encode_proj_layers: tuple[int, ...] = (2,)
    encoder_layers: int = 1
    encoder_attention_heads: int = 8
    encoder_activation_function: str = "gelu"
    activation_function: str = "silu"
    hidden_expansion: float = 1.0
    positional_encoding_temperature: float = 10000.0
    csp_num_blocks: int = 3
    # decoder
    decoder_ffn_dim: int = 1024
    num_feature_levels: int = 3
    decoder_n_points: int = 4
    decoder_layers: int = 6
    decoder_attention_heads: int = 8
    decoder_activation_function: str = "relu"
    learn_initial_query: bool = False
    anchor_grid_size: float = 0.05
    # v2-specific deformable-attention semantics (configuration_rt_detr_v2.py)
    decoder_offset_scale: float = 0.5
    decoder_method: str = "default"  # "default" (bilinear) | "discrete"
    version: int = 2
    layer_norm_eps: float = 1e-5
    batch_norm_eps: float = 1e-5
    id2label: tuple[tuple[int, str], ...] = ()

    @property
    def id2label_dict(self) -> dict[int, str]:
        return dict(self.id2label)

    @classmethod
    def from_hf(cls, hf) -> "RTDetrConfig":
        version = 2 if hf.model_type == "rt_detr_v2" else 1
        return cls(
            backbone=ResNetConfig.from_hf(hf.backbone_config),
            num_labels=hf.num_labels,
            d_model=hf.d_model,
            num_queries=hf.num_queries,
            encoder_hidden_dim=hf.encoder_hidden_dim,
            encoder_in_channels=tuple(hf.encoder_in_channels),
            feat_strides=tuple(hf.feat_strides),
            encoder_ffn_dim=hf.encoder_ffn_dim,
            encode_proj_layers=tuple(hf.encode_proj_layers),
            encoder_layers=hf.encoder_layers,
            encoder_attention_heads=hf.encoder_attention_heads,
            encoder_activation_function=hf.encoder_activation_function,
            activation_function=hf.activation_function,
            hidden_expansion=hf.hidden_expansion,
            positional_encoding_temperature=float(hf.positional_encoding_temperature),
            decoder_ffn_dim=hf.decoder_ffn_dim,
            num_feature_levels=hf.num_feature_levels,
            decoder_n_points=hf.decoder_n_points,
            decoder_layers=hf.decoder_layers,
            decoder_attention_heads=hf.decoder_attention_heads,
            decoder_activation_function=hf.decoder_activation_function,
            learn_initial_query=hf.learn_initial_query,
            decoder_offset_scale=getattr(hf, "decoder_offset_scale", 0.5),
            decoder_method=getattr(hf, "decoder_method", "default"),
            version=version,
            layer_norm_eps=hf.layer_norm_eps,
            batch_norm_eps=hf.batch_norm_eps,
            id2label=tuple(sorted((int(k), v) for k, v in hf.id2label.items())),
        )


RESNET_PRESETS = {
    "r18": ResNetConfig(
        embedding_size=64, hidden_sizes=(64, 128, 256, 512), depths=(2, 2, 2, 2),
        layer_type="basic",
    ),
    "r34": ResNetConfig(
        embedding_size=64, hidden_sizes=(64, 128, 256, 512), depths=(3, 4, 6, 3),
        layer_type="basic",
    ),
    "r50": ResNetConfig(),
    "r101": ResNetConfig(depths=(3, 4, 23, 3)),
}

# Published RT-DETRv2 variants (PekingU/rtdetr_v2_*). When loading a checkpoint,
# `from_hf` of the checkpoint's own config takes precedence; presets exist for
# offline/synthetic use.
RTDETR_PRESETS = {
    "rtdetr_v2_r18vd": RTDetrConfig(
        backbone=RESNET_PRESETS["r18"],
        encoder_in_channels=(128, 256, 512),
        decoder_layers=3,
        hidden_expansion=0.5,
    ),
    "rtdetr_v2_r34vd": RTDetrConfig(
        backbone=RESNET_PRESETS["r34"],
        encoder_in_channels=(128, 256, 512),
        decoder_layers=4,
        hidden_expansion=0.5,
    ),
    "rtdetr_v2_r50vd": RTDetrConfig(),
    "rtdetr_v2_r101vd": RTDetrConfig(
        backbone=RESNET_PRESETS["r101"],
        encoder_hidden_dim=384,
        encoder_ffn_dim=2048,
    ),
}


@dataclass(frozen=True)
class YolosConfig:
    """YOLOS (hustvl/yolos-*) — plain ViT with appended detection tokens.
    The defaults are yolos-base."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    image_size: tuple[int, int] = (800, 1344)
    patch_size: int = 16
    num_channels: int = 3
    num_detection_tokens: int = 100
    use_mid_position_embeddings: bool = True
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-12
    num_labels: int = 91
    id2label: tuple[tuple[int, str], ...] = ()

    @property
    def id2label_dict(self) -> dict[int, str]:
        return dict(self.id2label)

    @property
    def grid_hw(self) -> tuple[int, int]:
        return self.image_size[0] // self.patch_size, self.image_size[1] // self.patch_size

    @classmethod
    def from_hf(cls, hf) -> "YolosConfig":
        return cls(
            hidden_size=hf.hidden_size,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            intermediate_size=hf.intermediate_size,
            hidden_act=hf.hidden_act,
            image_size=tuple(hf.image_size),
            patch_size=hf.patch_size,
            num_channels=hf.num_channels,
            num_detection_tokens=hf.num_detection_tokens,
            use_mid_position_embeddings=hf.use_mid_position_embeddings,
            qkv_bias=hf.qkv_bias,
            layer_norm_eps=hf.layer_norm_eps,
            num_labels=hf.num_labels,
            id2label=tuple(sorted((int(k), v) for k, v in hf.id2label.items())),
        )

    @classmethod
    def from_hf(cls, hf) -> "YolosConfig":
        return cls(
            hidden_size=hf.hidden_size,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            intermediate_size=hf.intermediate_size,
            hidden_act=hf.hidden_act,
            image_size=tuple(hf.image_size),
            patch_size=hf.patch_size,
            num_channels=hf.num_channels,
            num_detection_tokens=hf.num_detection_tokens,
            use_mid_position_embeddings=hf.use_mid_position_embeddings,
            qkv_bias=hf.qkv_bias,
            layer_norm_eps=hf.layer_norm_eps,
            num_labels=hf.num_labels,
            id2label=tuple(sorted((int(k), v) for k, v in hf.id2label.items())),
        )


@dataclass(frozen=True)
class OwlViTTextConfig:
    """CLIP-style text tower of OWL-ViT."""

    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 16
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf(cls, hf) -> "OwlViTTextConfig":
        return cls(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            max_position_embeddings=hf.max_position_embeddings,
            hidden_act=hf.hidden_act,
            layer_norm_eps=hf.layer_norm_eps,
        )


@dataclass(frozen=True)
class OwlViTVisionConfig:
    """CLIP-style vision tower of OWL-ViT."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 768
    patch_size: int = 32
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def from_hf(cls, hf) -> "OwlViTVisionConfig":
        return cls(
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            image_size=hf.image_size,
            patch_size=hf.patch_size,
            num_channels=hf.num_channels,
            hidden_act=hf.hidden_act,
            layer_norm_eps=hf.layer_norm_eps,
        )


@dataclass(frozen=True)
class OwlViTConfig:
    """OWL-ViT / OWLv2 open-vocabulary detector (google/owlvit-*, google/owlv2-*).

    OWLv2 is architecturally OWL-ViT plus an objectness head (and a
    pad-to-square preprocess handled by the serving spec); `objectness` is
    therefore the one config switch between the two families.
    """

    text: OwlViTTextConfig = field(default_factory=OwlViTTextConfig)
    vision: OwlViTVisionConfig = field(default_factory=OwlViTVisionConfig)
    projection_dim: int = 512
    objectness: bool = False  # True = OWLv2

    @classmethod
    def from_hf(cls, hf) -> "OwlViTConfig":
        return cls(
            text=OwlViTTextConfig.from_hf(hf.text_config),
            vision=OwlViTVisionConfig.from_hf(hf.vision_config),
            projection_dim=hf.projection_dim,
            objectness=hf.model_type == "owlv2",
        )


# the published base checkpoints' widths (HF OwlViTConfig / Owlv2Config):
# vision ViT-B at 768 wide, text 512 wide, projection 512; OWLv2's
# -ensemble and -finetuned checkpoints share owlv2-base-patch16's shapes
OWL_PRESETS = {
    "owlvit-base-patch32": OwlViTConfig(),
    "owlvit-base-patch16": OwlViTConfig(vision=OwlViTVisionConfig(patch_size=16)),
    "owlv2-base-patch16": OwlViTConfig(
        vision=OwlViTVisionConfig(image_size=960, patch_size=16), objectness=True
    ),
}


@dataclass(frozen=True)
class DeformableDetrConfig:
    """Deformable DETR (SenseTime/deformable-detr*): multiscale deformable
    attention in both the encoder and the decoder, with the plain,
    with-box-refine and two-stage variants. Mirrors HF DeformableDetrConfig;
    the defaults are the published SenseTime/deformable-detr widths."""

    backbone: ResNetConfig = field(
        default_factory=lambda: ResNetConfig(style="v1", out_indices=(2, 3, 4))
    )
    num_labels: int = 91
    d_model: int = 256
    num_queries: int = 300
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 1024
    decoder_ffn_dim: int = 1024
    activation_function: str = "relu"
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    with_box_refine: bool = False
    two_stage: bool = False
    two_stage_num_proposals: int = 300
    positional_encoding_temperature: float = 10000.0
    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm/GroupNorm default
    id2label: tuple[tuple[int, str], ...] = ()

    @property
    def id2label_dict(self) -> dict[int, str]:
        return dict(self.id2label)

    @property
    def num_pred_heads(self) -> int:
        # two-stage keeps one extra head pair for scoring encoder proposals
        return self.decoder_layers + (1 if self.two_stage else 0)

    @classmethod
    def from_hf(cls, hf) -> "DeformableDetrConfig":
        if hf.position_embedding_type != "sine":
            raise ValueError(
                f"Unsupported position_embedding_type {hf.position_embedding_type!r}"
            )
        check_no_dilation(hf)
        if hf.use_timm_backbone:
            out_indices = (2, 3, 4) if hf.num_feature_levels > 1 else (4,)
            backbone = replace(timm_resnet_backbone(hf.backbone), out_indices=out_indices)
        else:
            # the AutoBackbone path taps backbone_config.out_features as-is
            backbone = ResNetConfig.from_hf(hf.backbone_config)
        return cls(
            backbone=backbone,
            num_labels=hf.num_labels,
            d_model=hf.d_model,
            num_queries=hf.num_queries,
            encoder_layers=hf.encoder_layers,
            decoder_layers=hf.decoder_layers,
            encoder_attention_heads=hf.encoder_attention_heads,
            decoder_attention_heads=hf.decoder_attention_heads,
            encoder_ffn_dim=hf.encoder_ffn_dim,
            decoder_ffn_dim=hf.decoder_ffn_dim,
            activation_function=hf.activation_function,
            num_feature_levels=hf.num_feature_levels,
            encoder_n_points=hf.encoder_n_points,
            decoder_n_points=hf.decoder_n_points,
            with_box_refine=hf.with_box_refine,
            two_stage=hf.two_stage,
            two_stage_num_proposals=hf.two_stage_num_proposals,
            id2label=tuple(sorted((int(k), v) for k, v in hf.id2label.items())),
        )


# the published SenseTime/deformable-detr* checkpoints' configs: ResNet-50 at
# strides 8/16/32 plus one extra stride-64 level, 300 queries; the
# single-scale model taps the stride-32 map alone (HF's timm backbone takes
# out_indices (4,) when num_feature_levels is 1)
_DEFORMABLE_DETR = DeformableDetrConfig()
DEFORMABLE_DETR_PRESETS = {
    "deformable-detr": _DEFORMABLE_DETR,
    "deformable-detr-with-box-refine": replace(_DEFORMABLE_DETR, with_box_refine=True),
    "deformable-detr-with-box-refine-two-stage": replace(
        _DEFORMABLE_DETR, with_box_refine=True, two_stage=True
    ),
    "deformable-detr-single-scale": replace(
        _DEFORMABLE_DETR, num_feature_levels=1,
        backbone=ResNetConfig(style="v1", out_indices=(4,)),
    ),
}


@dataclass(frozen=True)
class DetrConfig:
    """DETR (facebook/detr-resnet-*): CNN backbone + vanilla encoder-decoder.
    `pre_norm` selects Table-Transformer (microsoft/table-transformer-*):
    pre-norm layers and a final encoder LayerNorm."""

    backbone: ResNetConfig = field(
        default_factory=lambda: ResNetConfig(style="v1", out_indices=(4,))
    )
    num_labels: int = 91
    d_model: int = 256
    num_queries: int = 100
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    activation_function: str = "relu"
    positional_encoding_temperature: float = 10000.0
    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm default (DETR never overrides)
    pre_norm: bool = False
    id2label: tuple[tuple[int, str], ...] = ()

    @property
    def id2label_dict(self) -> dict[int, str]:
        return dict(self.id2label)

    @classmethod
    def from_hf(cls, hf) -> "DetrConfig":
        check_no_dilation(hf)
        return cls(
            backbone=lineage_backbone(hf),
            num_labels=hf.num_labels,
            d_model=hf.d_model,
            num_queries=hf.num_queries,
            encoder_layers=hf.encoder_layers,
            decoder_layers=hf.decoder_layers,
            encoder_attention_heads=hf.encoder_attention_heads,
            decoder_attention_heads=hf.decoder_attention_heads,
            encoder_ffn_dim=hf.encoder_ffn_dim,
            decoder_ffn_dim=hf.decoder_ffn_dim,
            activation_function=hf.activation_function,
            pre_norm=hf.model_type == "table-transformer",
            id2label=tuple(sorted((int(k), v) for k, v in hf.id2label.items())),
        )


@dataclass(frozen=True)
class ConditionalDetrConfig:
    """Conditional DETR (microsoft/conditional-detr-resnet-*): a DETR encoder
    plus the conditional decoder (content and spatial halves of the
    cross-attention, boxes relative to reference points, focal labels
    without a "no object" class)."""

    backbone: ResNetConfig = field(
        default_factory=lambda: ResNetConfig(style="v1", out_indices=(4,))
    )
    num_labels: int = 91
    d_model: int = 256
    num_queries: int = 300
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    activation_function: str = "relu"
    positional_encoding_temperature: float = 10000.0
    layer_norm_eps: float = 1e-5
    pre_norm: bool = False  # encoder layers are shared with DETR's post-norm
    id2label: tuple[tuple[int, str], ...] = ()

    @property
    def id2label_dict(self) -> dict[int, str]:
        return dict(self.id2label)

    @classmethod
    def from_hf(cls, hf) -> "ConditionalDetrConfig":
        check_no_dilation(hf)
        return cls(
            backbone=lineage_backbone(hf),
            num_labels=hf.num_labels,
            d_model=hf.d_model,
            num_queries=hf.num_queries,
            encoder_layers=hf.encoder_layers,
            decoder_layers=hf.decoder_layers,
            encoder_attention_heads=hf.encoder_attention_heads,
            decoder_attention_heads=hf.decoder_attention_heads,
            encoder_ffn_dim=hf.encoder_ffn_dim,
            decoder_ffn_dim=hf.decoder_ffn_dim,
            activation_function=hf.activation_function,
            id2label=tuple(sorted((int(k), v) for k, v in hf.id2label.items())),
        )


@dataclass(frozen=True)
class DabDetrConfig:
    """DAB-DETR (IDEA-Research/dab-detr-resnet-*): DETR with learned 4D anchor
    queries (x, y, w, h) whose sine embedding conditions the attention,
    refined per decoder layer through a shared box head; learned-PReLU FFNs."""

    backbone: ResNetConfig = field(
        default_factory=lambda: ResNetConfig(style="v1", out_indices=(4,))
    )
    num_labels: int = 91
    d_model: int = 256  # hf "hidden_size"
    num_queries: int = 300
    query_dim: int = 4
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    activation_function: str = "prelu"
    temperature_height: float = 20.0
    temperature_width: float = 20.0
    keep_query_pos: bool = False
    layer_norm_eps: float = 1e-5
    id2label: tuple[tuple[int, str], ...] = ()

    @property
    def id2label_dict(self) -> dict[int, str]:
        return dict(self.id2label)

    @classmethod
    def from_hf(cls, hf) -> "DabDetrConfig":
        check_no_dilation(hf)
        if hf.query_dim != 4:
            raise ValueError(f"Only query_dim=4 is supported, got {hf.query_dim}")
        if getattr(hf, "num_patterns", 0):
            raise ValueError(DAB_PATTERNS_ERROR)
        if getattr(hf, "normalize_before", False):
            raise ValueError("normalize_before (pre-norm) DAB-DETR is not supported")
        if hf.activation_function != "prelu":
            # the model hardcodes the learned-PReLU FFN of the published
            # checkpoints; other activations carry no activation_fn.weight
            raise ValueError(
                f"Only activation_function='prelu' is supported, got "
                f"{hf.activation_function!r}"
            )
        return cls(
            backbone=lineage_backbone(hf),
            num_labels=hf.num_labels,
            d_model=hf.hidden_size,
            num_queries=hf.num_queries,
            query_dim=hf.query_dim,
            encoder_layers=hf.encoder_layers,
            decoder_layers=hf.decoder_layers,
            encoder_attention_heads=hf.encoder_attention_heads,
            decoder_attention_heads=hf.decoder_attention_heads,
            encoder_ffn_dim=hf.encoder_ffn_dim,
            decoder_ffn_dim=hf.decoder_ffn_dim,
            activation_function=hf.activation_function,
            temperature_height=float(hf.temperature_height),
            temperature_width=float(hf.temperature_width),
            keep_query_pos=hf.keep_query_pos,
            id2label=tuple(sorted((int(k), v) for k, v in hf.id2label.items())),
        )


# the JAX package's refusals, with its texts: a dilated (dc5) backbone turns
# stage 4's stride into dilation-2 convs, which the ResNet does not model;
# DAB-DETR's pattern embeddings (-pat3) are not modelled either
DC5_ERROR = "dilated (dc5) backbones are not supported; use the non-dc5 checkpoint"
DAB_PATTERNS_ERROR = "num_patterns > 0 is not supported"


def check_no_dilation(hf) -> None:
    """Refuse a dc5 checkpoint (timm `dilation=True` turns stage 4's stride
    into dilation-2 convs, which the ResNet does not model)."""
    if getattr(hf, "dilation", False):
        raise ValueError(DC5_ERROR)


def lineage_backbone(hf) -> ResNetConfig:
    """A DETR / Table-Transformer / Conditional-DETR / DAB-DETR checkpoint's
    backbone: the timm ResNet it names, or its HF ResNet tapped at its last
    stage (the JAX from_hf methods' shared branch)."""
    if hf.use_timm_backbone:
        return timm_resnet_backbone(hf.backbone)
    return replace(
        ResNetConfig.from_hf(hf.backbone_config),
        out_indices=(len(hf.backbone_config.depths),),
    )

# timm checkpoints name their backbone: facebook/detr-resnet-50/101 and
# microsoft/conditional-detr-resnet-* (bottleneck), microsoft/
# table-transformer-* (resnet18, basic blocks)
_TIMM_RESNET_PRESETS = {
    "resnet18": dict(
        layer_type="basic", depths=(2, 2, 2, 2), hidden_sizes=(64, 128, 256, 512)
    ),
    "resnet34": dict(
        layer_type="basic", depths=(3, 4, 6, 3), hidden_sizes=(64, 128, 256, 512)
    ),
    "resnet50": dict(depths=(3, 4, 6, 3)),
    "resnet101": dict(depths=(3, 4, 23, 3)),
}


def timm_resnet_backbone(name: str) -> ResNetConfig:
    if name not in _TIMM_RESNET_PRESETS:
        raise ValueError(
            f"Unsupported timm backbone {name!r}; known: {sorted(_TIMM_RESNET_PRESETS)}"
        )
    return ResNetConfig(style="v1", out_indices=(4,), **_TIMM_RESNET_PRESETS[name])


# the published checkpoints' configs by name (the 91 COCO labels are added
# by the zoo). The two Table-Transformer presets' values (timm resnet18,
# pre-norm, 15 and 125 queries, and their labels) are from the Hugging Face
# model cards and config.json of microsoft/table-transformer-detection and
# microsoft/table-transformer-structure-recognition.
DETR_PRESETS = {
    "detr-resnet-50": DetrConfig(backbone=timm_resnet_backbone("resnet50")),
    "detr-resnet-101": DetrConfig(backbone=timm_resnet_backbone("resnet101")),
    "table-transformer-detection": DetrConfig(
        backbone=timm_resnet_backbone("resnet18"), pre_norm=True, num_queries=15,
        num_labels=2, id2label=((0, "table"), (1, "table rotated")),
    ),
    "table-transformer-structure-recognition": DetrConfig(
        backbone=timm_resnet_backbone("resnet18"), pre_norm=True, num_queries=125,
        num_labels=6,
        id2label=((0, "table"), (1, "table column"), (2, "table row"),
                  (3, "table column header"), (4, "table projected row header"),
                  (5, "table spanning cell")),
    ),
}
CONDITIONAL_DETR_PRESETS = {
    "conditional-detr-resnet-50": ConditionalDetrConfig(
        backbone=timm_resnet_backbone("resnet50")),
}
DAB_DETR_PRESETS = {
    "dab-detr-resnet-50": DabDetrConfig(backbone=timm_resnet_backbone("resnet50")),
}
