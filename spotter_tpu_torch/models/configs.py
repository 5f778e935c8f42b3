"""Config dataclasses for the RT-DETR family (copy of spotter_tpu.models.configs).

The port keeps its own copy rather than importing the JAX package's module:
`ResNetConfig`, `RTDetrConfig` and their presets, unchanged, so a config
built on one side means the same model on the other.
"""

from dataclasses import dataclass, field


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
