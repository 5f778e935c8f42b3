"""torch->Flax conversion rules for Conditional DETR
(microsoft/conditional-detr-resnet-*, HF modeling_conditional_detr.py).
(Copy of spotter_tpu.convert.conditional_detr_rules.)

The encoder/backbone halves reuse DETR's rules (the torch modules are
literal copies); the decoder's q/k/v projections live OUTSIDE the attention
modules (sa_*_proj / ca_*_proj on the layer, only out_proj inside
self_attn/encoder_attn), and ca_qpos_proj exists on layer 0 only
(ConditionalDetrDecoder.__init__ sets it to None on the rest).
"""

from spotter_tpu_torch.convert.detr_rules import (
    BACKBONE_PREFIX,
    resnet_v1_hf_rules,
    resnet_v1_timm_rules,
)
from spotter_tpu_torch.convert.rules import Rules
from spotter_tpu_torch.models.configs import ConditionalDetrConfig


def conditional_detr_rules(
    cfg: ConditionalDetrConfig, backbone_naming: str = "hf"
) -> Rules:
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
        for proj in (
            "sa_qcontent_proj",
            "sa_qpos_proj",
            "sa_kcontent_proj",
            "sa_kpos_proj",
            "sa_v_proj",
            "ca_qcontent_proj",
            "ca_kcontent_proj",
            "ca_kpos_proj",
            "ca_v_proj",
            "ca_qpos_sine_proj",
        ):
            r.dense((*f, proj), f"{t}.{proj}")
        if i == 0:  # removed on all later layers
            r.dense((*f, "ca_qpos_proj"), f"{t}.ca_qpos_proj")
        r.dense((*f, "self_attn_out_proj"), f"{t}.self_attn.out_proj")
        r.dense((*f, "encoder_attn_out_proj"), f"{t}.encoder_attn.out_proj")
        r.layernorm((*f, "self_attn_layer_norm"), f"{t}.self_attn_layer_norm")
        r.layernorm((*f, "encoder_attn_layer_norm"), f"{t}.encoder_attn_layer_norm")
        r.dense((*f, "fc1"), f"{t}.fc1")
        r.dense((*f, "fc2"), f"{t}.fc2")
        r.layernorm((*f, "final_layer_norm"), f"{t}.final_layer_norm")
    r.layernorm(("decoder_layernorm",), "model.decoder.layernorm")
    r.mlp_head(("query_scale",), "model.decoder.query_scale", 2)
    r.mlp_head(("ref_point_head",), "model.decoder.ref_point_head", 2)

    r.dense(("class_labels_classifier",), "class_labels_classifier")
    r.mlp_head(("bbox_predictor",), "bbox_predictor", 3)
    return r
