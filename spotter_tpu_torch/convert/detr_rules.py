"""torch->Flax conversion rules for DETR (facebook/detr-resnet-*) and
Table-Transformer (microsoft/table-transformer-*, whose state dict is DETR's
plus a closing encoder LayerNorm — modeling_table_transformer.py is a
pre-norm copy of modeling_detr.py with identical parameter names).
(Copy of spotter_tpu.convert.detr_rules.)

Covers both backbone serializations found in DETR checkpoints:
- HF ResNetBackbone naming (use_timm_backbone=False):
  model.backbone.conv_encoder.model.embedder.embedder.convolution...
- timm resnet naming (the published facebook/detr-resnet-50/101 checkpoints):
  model.backbone.conv_encoder.model.conv1 / layer{1..4}.{b}.conv{1..3} /
  downsample.{0,1}

The transformer half (modeling_detr.py DetrModel/DetrForObjectDetection keys)
is identical either way.
"""

from spotter_tpu_torch.convert.rules import Rules
from spotter_tpu_torch.models.configs import DetrConfig, ResNetConfig

BACKBONE_PREFIX = "model.backbone.conv_encoder.model."


def resnet_v1_hf_rules(cfg: ResNetConfig, flax_prefix, torch_prefix: str) -> Rules:
    """ResNetBackbone (style v1) <- HF modeling_resnet.py state dict."""
    r = Rules()
    p = tuple(flax_prefix)
    t = torch_prefix
    r.conv_norm(
        (*p, "stem0"), f"{t}embedder.embedder.convolution", f"{t}embedder.embedder.normalization"
    )
    in_ch = cfg.embedding_size
    for s, (out_ch, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
        stride = 2 if (s > 0 or cfg.downsample_in_first_stage) else 1
        for b in range(depth):
            tb = f"{t}encoder.stages.{s}.layers.{b}"
            fb = (*p, f"stage{s}_block{b}")
            n_convs = 3 if cfg.layer_type == "bottleneck" else 2
            for k in range(n_convs):
                r.conv_norm(
                    (*fb, f"conv{k}"),
                    f"{tb}.layer.{k}.convolution",
                    f"{tb}.layer.{k}.normalization",
                )
            if b == 0 and (in_ch != out_ch or stride != 1):
                r.conv_norm(
                    (*fb, "shortcut"), f"{tb}.shortcut.convolution", f"{tb}.shortcut.normalization"
                )
        in_ch = out_ch
    return r


def resnet_v1_timm_rules(cfg: ResNetConfig, flax_prefix, torch_prefix: str) -> Rules:
    """ResNetBackbone (style v1) <- timm/torchvision resnet state dict."""
    r = Rules()
    p = tuple(flax_prefix)
    t = torch_prefix
    r.conv_norm((*p, "stem0"), f"{t}conv1", f"{t}bn1")
    in_ch = cfg.embedding_size
    for s, (out_ch, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
        stride = 2 if (s > 0 or cfg.downsample_in_first_stage) else 1
        for b in range(depth):
            tb = f"{t}layer{s + 1}.{b}"
            fb = (*p, f"stage{s}_block{b}")
            n_convs = 3 if cfg.layer_type == "bottleneck" else 2
            for k in range(n_convs):
                r.conv_norm((*fb, f"conv{k}"), f"{tb}.conv{k + 1}", f"{tb}.bn{k + 1}")
            if b == 0 and (in_ch != out_ch or stride != 1):
                r.conv_norm((*fb, "shortcut"), f"{tb}.downsample.0", f"{tb}.downsample.1")
        in_ch = out_ch
    return r


def detr_rules(cfg: DetrConfig, backbone_naming: str = "hf") -> Rules:
    """Full DetrDetector rule table. backbone_naming: "hf" | "timm"."""
    builder = resnet_v1_hf_rules if backbone_naming == "hf" else resnet_v1_timm_rules
    r = builder(cfg.backbone, ("backbone",), BACKBONE_PREFIX)

    r.conv(("input_projection",), "model.input_projection.weight")
    r.add(("input_projection", "bias"), "model.input_projection.bias")
    r.add(("query_pos",), "model.query_position_embeddings.weight")

    for i in range(cfg.encoder_layers):
        f = (f"encoder_layer{i}",)
        t = f"model.encoder.layers.{i}"
        r.attention((*f, "self_attn"), f"{t}.self_attn")
        r.layernorm((*f, "self_attn_layer_norm"), f"{t}.self_attn_layer_norm")
        r.dense((*f, "fc1"), f"{t}.fc1")
        r.dense((*f, "fc2"), f"{t}.fc2")
        r.layernorm((*f, "final_layer_norm"), f"{t}.final_layer_norm")

    for i in range(cfg.decoder_layers):
        f = (f"decoder_layer{i}",)
        t = f"model.decoder.layers.{i}"
        r.attention((*f, "self_attn"), f"{t}.self_attn")
        r.layernorm((*f, "self_attn_layer_norm"), f"{t}.self_attn_layer_norm")
        r.attention((*f, "encoder_attn"), f"{t}.encoder_attn")
        r.layernorm((*f, "encoder_attn_layer_norm"), f"{t}.encoder_attn_layer_norm")
        r.dense((*f, "fc1"), f"{t}.fc1")
        r.dense((*f, "fc2"), f"{t}.fc2")
        r.layernorm((*f, "final_layer_norm"), f"{t}.final_layer_norm")
    r.layernorm(("decoder_layernorm",), "model.decoder.layernorm")
    if cfg.pre_norm:  # Table-Transformer's closing encoder LayerNorm
        r.layernorm(("encoder_layernorm",), "model.encoder.layernorm")

    r.dense(("class_labels_classifier",), "class_labels_classifier")
    r.mlp_head(("bbox_predictor",), "bbox_predictor", 3)
    return r
