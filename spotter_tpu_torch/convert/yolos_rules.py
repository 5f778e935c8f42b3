"""torch->Flax conversion rules for YOLOS (hustvl/yolos-*).
(Copy of spotter_tpu.convert.yolos_rules.)

torch layout (modeling_yolos.py, YolosForObjectDetection): embeddings under
vit.embeddings.*, pre-norm ViT blocks under vit.encoder.layer.{i}.*, optional
vit.encoder.mid_position_embeddings, final vit.layernorm, and the two
YolosMLPPredictionHead heads at the top level.
"""

from spotter_tpu_torch.convert.rules import Rules
from spotter_tpu_torch.models.configs import YolosConfig


def yolos_rules(cfg: YolosConfig) -> Rules:
    r = Rules()
    r.add(("cls_token",), "vit.embeddings.cls_token")
    r.add(("detection_tokens",), "vit.embeddings.detection_tokens")
    r.add(("position_embeddings",), "vit.embeddings.position_embeddings")
    r.conv(("patch_projection",), "vit.embeddings.patch_embeddings.projection.weight")
    r.add(
        ("patch_projection", "bias"), "vit.embeddings.patch_embeddings.projection.bias"
    )
    if cfg.use_mid_position_embeddings:
        r.add(("mid_position_embeddings",), "vit.encoder.mid_position_embeddings")

    for i in range(cfg.num_hidden_layers):
        f = (f"layer{i}",)
        t = f"vit.encoder.layer.{i}"
        r.layernorm((*f, "layernorm_before"), f"{t}.layernorm_before")
        for proj in ("query", "key", "value"):
            r.dense((*f, "attention", proj), f"{t}.attention.attention.{proj}")
        r.dense((*f, "attention", "out"), f"{t}.attention.output.dense")
        r.layernorm((*f, "layernorm_after"), f"{t}.layernorm_after")
        r.dense((*f, "fc1"), f"{t}.intermediate.dense")
        r.dense((*f, "fc2"), f"{t}.output.dense")

    r.layernorm(("layernorm",), "vit.layernorm")
    r.mlp_head(("class_labels_classifier",), "class_labels_classifier", 3)
    r.mlp_head(("bbox_predictor",), "bbox_predictor", 3)
    return r
