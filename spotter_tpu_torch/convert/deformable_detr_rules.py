"""torch->Flax conversion rules for Deformable DETR (SenseTime/deformable-detr*).
(Copy of spotter_tpu.convert.deformable_detr_rules.)

Key layout (modeling_deformable_detr.py): the DETR-style backbone prefix
`model.backbone.conv_encoder.model.` (timm naming in the published
checkpoints, HF ResNetBackbone naming when use_timm_backbone=False),
`model.input_proj.{i}.{0,1}` Conv+GroupNorm pairs, `model.level_embed`,
encoder/decoder layers with MSDA projections, and the variant-dependent tail:
`model.query_position_embeddings` + `model.reference_points` (plain / box
refine) or `model.enc_output*` + `model.pos_trans*` (two stage). Heads
`class_embed.{i}` / `bbox_embed.{i}` are tied clones of index 0 unless
with_box_refine, where each index carries distinct weights.
"""

from spotter_tpu_torch.convert.detr_rules import (
    BACKBONE_PREFIX,
    resnet_v1_hf_rules,
    resnet_v1_timm_rules,
)
from spotter_tpu_torch.convert.rules import Rules
from spotter_tpu_torch.models.configs import DeformableDetrConfig


def msda_attention(r: Rules, flax_prefix: tuple[str, ...], torch_prefix: str) -> None:
    for proj in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        r.dense((*flax_prefix, proj), f"{torch_prefix}.{proj}")


def deformable_detr_rules(
    cfg: DeformableDetrConfig, backbone_naming: str = "hf"
) -> Rules:
    """Full DeformableDetrDetector rule table. backbone_naming: "hf" | "timm"."""
    builder = resnet_v1_hf_rules if backbone_naming == "hf" else resnet_v1_timm_rules
    r = builder(cfg.backbone, ("backbone",), BACKBONE_PREFIX)

    for i in range(cfg.num_feature_levels):
        r.conv((f"input_proj{i}_conv",), f"model.input_proj.{i}.0.weight")
        r.add((f"input_proj{i}_conv", "bias"), f"model.input_proj.{i}.0.bias")
        r.layernorm((f"input_proj{i}_norm",), f"model.input_proj.{i}.1")
    r.add(("level_embed",), "model.level_embed")

    for i in range(cfg.encoder_layers):
        f = (f"encoder_layer{i}",)
        t = f"model.encoder.layers.{i}"
        msda_attention(r, (*f, "self_attn"), f"{t}.self_attn")
        r.layernorm((*f, "self_attn_layer_norm"), f"{t}.self_attn_layer_norm")
        r.dense((*f, "fc1"), f"{t}.fc1")
        r.dense((*f, "fc2"), f"{t}.fc2")
        r.layernorm((*f, "final_layer_norm"), f"{t}.final_layer_norm")

    for i in range(cfg.decoder_layers):
        f = (f"decoder_layer{i}",)
        t = f"model.decoder.layers.{i}"
        r.attention((*f, "self_attn"), f"{t}.self_attn")
        r.layernorm((*f, "self_attn_layer_norm"), f"{t}.self_attn_layer_norm")
        msda_attention(r, (*f, "encoder_attn"), f"{t}.encoder_attn")
        r.layernorm((*f, "encoder_attn_layer_norm"), f"{t}.encoder_attn_layer_norm")
        r.dense((*f, "fc1"), f"{t}.fc1")
        r.dense((*f, "fc2"), f"{t}.fc2")
        r.layernorm((*f, "final_layer_norm"), f"{t}.final_layer_norm")

    if cfg.two_stage:
        r.dense(("enc_output",), "model.enc_output")
        r.layernorm(("enc_output_norm",), "model.enc_output_norm")
        r.dense(("pos_trans",), "model.pos_trans")
        r.layernorm(("pos_trans_norm",), "model.pos_trans_norm")
    else:
        r.add(("query_embeddings",), "model.query_position_embeddings.weight")
        r.dense(("reference_points_proj",), "model.reference_points")

    if cfg.with_box_refine:
        for i in range(cfg.num_pred_heads):
            r.dense((f"class_head{i}",), f"class_embed.{i}")
            r.mlp_head((f"bbox_head{i}",), f"bbox_embed.{i}", 3)
    else:
        # tied clones — index 0 carries the weights
        r.dense(("class_head",), "class_embed.0")
        r.mlp_head(("bbox_head",), "bbox_embed.0", 3)
    return r
