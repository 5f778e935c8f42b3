"""torch->Flax conversion rules for DAB-DETR (IDEA-Research/dab-detr-resnet-*).
(Copy of spotter_tpu.convert.dab_detr_rules.)

Key layout (modeling_dab_detr.py, DabDetrForObjectDetection): DETR backbone
prefix, `model.input_projection`, `model.query_refpoint_embeddings`, an
encoder with a shared `query_scale` MLP and per-layer PReLU weights, a
conditional-style decoder whose projections live under nested
`self_attn.*` / `cross_attn.*` submodules (`cross_attn_query_pos_proj` only
on layer 0 unless keep_query_pos), the decoder-level `query_scale` /
`ref_point_head` / `ref_anchor_head` MLPs and shared `layernorm`, and the
heads `class_embed` + `bbox_predictor` (tied with model.decoder.bbox_embed).
"""

from spotter_tpu_torch.convert.detr_rules import (
    BACKBONE_PREFIX,
    resnet_v1_hf_rules,
    resnet_v1_timm_rules,
)
from spotter_tpu_torch.convert.rules import Rules
from spotter_tpu_torch.models.configs import DabDetrConfig


def dab_detr_rules(cfg: DabDetrConfig, backbone_naming: str = "hf") -> Rules:
    """Full DabDetrDetector rule table. backbone_naming: "hf" | "timm"."""
    builder = resnet_v1_hf_rules if backbone_naming == "hf" else resnet_v1_timm_rules
    r = builder(cfg.backbone, ("backbone",), BACKBONE_PREFIX)

    r.conv(("input_projection",), "model.input_projection.weight")
    r.add(("input_projection", "bias"), "model.input_projection.bias")
    r.add(("query_refpoints",), "model.query_refpoint_embeddings.weight")

    r.mlp_head(("encoder_query_scale",), "model.encoder.query_scale", 2)
    for i in range(cfg.encoder_layers):
        f = (f"encoder_layer{i}",)
        t = f"model.encoder.layers.{i}"
        r.attention((*f, "self_attn"), f"{t}.self_attn")
        r.layernorm((*f, "self_attn_layer_norm"), f"{t}.self_attn_layer_norm")
        r.add((*f, "activation", "weight"), f"{t}.activation_fn.weight")
        r.dense((*f, "fc1"), f"{t}.fc1")
        r.dense((*f, "fc2"), f"{t}.fc2")
        r.layernorm((*f, "final_layer_norm"), f"{t}.final_layer_norm")

    for i in range(cfg.decoder_layers):
        f = (f"decoder_layer{i}",)
        t = f"model.decoder.layers.{i}"
        sa, ca = f"{t}.self_attn", f"{t}.cross_attn"
        for flax_name, torch_name in (
            ("sa_qcontent_proj", "self_attn_query_content_proj"),
            ("sa_qpos_proj", "self_attn_query_pos_proj"),
            ("sa_kcontent_proj", "self_attn_key_content_proj"),
            ("sa_kpos_proj", "self_attn_key_pos_proj"),
            ("sa_v_proj", "self_attn_value_proj"),
        ):
            r.dense((*f, flax_name), f"{sa}.{torch_name}")
        r.dense((*f, "self_attn_out_proj"), f"{sa}.self_attn.output_proj")
        r.layernorm((*f, "self_attn_layer_norm"), f"{sa}.self_attn_layer_norm")

        for flax_name, torch_name in (
            ("ca_qcontent_proj", "cross_attn_query_content_proj"),
            ("ca_kcontent_proj", "cross_attn_key_content_proj"),
            ("ca_kpos_proj", "cross_attn_key_pos_proj"),
            ("ca_v_proj", "cross_attn_value_proj"),
            ("ca_qpos_sine_proj", "cross_attn_query_pos_sine_proj"),
        ):
            r.dense((*f, flax_name), f"{ca}.{torch_name}")
        if i == 0 or cfg.keep_query_pos:
            r.dense((*f, "ca_qpos_proj"), f"{ca}.cross_attn_query_pos_proj")
        r.dense((*f, "encoder_attn_out_proj"), f"{ca}.cross_attn.output_proj")
        r.layernorm((*f, "encoder_attn_layer_norm"), f"{ca}.cross_attn_layer_norm")

        r.add((*f, "activation", "weight"), f"{t}.mlp.activation_fn.weight")
        r.dense((*f, "fc1"), f"{t}.mlp.fc1")
        r.dense((*f, "fc2"), f"{t}.mlp.fc2")
        r.layernorm((*f, "final_layer_norm"), f"{t}.mlp.final_layer_norm")

    r.mlp_head(("query_scale",), "model.decoder.query_scale", 2)
    r.mlp_head(("ref_point_head",), "model.decoder.ref_point_head", 2)
    r.mlp_head(("ref_anchor_head",), "model.decoder.ref_anchor_head", 2)
    r.layernorm(("decoder_layernorm",), "model.decoder.layernorm")

    r.dense(("class_embed",), "class_embed")
    r.mlp_head(("bbox_predictor",), "bbox_predictor", 3)
    return r
