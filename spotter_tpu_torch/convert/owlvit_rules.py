"""torch->Flax conversion rules for OWL-ViT (google/owlvit-*) and OWLv2
(google/owlv2-*).
(Copy of spotter_tpu.convert.owlvit_rules.)

torch layout (modeling_owlvit.py / modeling_owlv2.py, *ForObjectDetection):
CLIP towers under {owlvit,owlv2}.text_model.* / .vision_model.*, the text
projection at {owlvit,owlv2}.text_projection, the detection merge LayerNorm at
the top-level `layer_norm`, and class_head / box_head (+ OWLv2's
objectness_head) prediction heads. The contrastive-only pieces
(visual_projection, logit_scale) are not part of the detection path and are
deliberately unmapped.
"""

from spotter_tpu_torch.convert.rules import Rules
from spotter_tpu_torch.models.configs import OwlViTConfig


def _tower_layers(r: Rules, flax_root: tuple, torch_root: str, num_layers: int) -> None:
    for i in range(num_layers):
        f = (*flax_root, f"layer{i}")
        t = f"{torch_root}.encoder.layers.{i}"
        r.layernorm((*f, "layer_norm1"), f"{t}.layer_norm1")
        r.attention((*f, "self_attn"), f"{t}.self_attn")
        r.layernorm((*f, "layer_norm2"), f"{t}.layer_norm2")
        r.dense((*f, "fc1"), f"{t}.mlp.fc1")
        r.dense((*f, "fc2"), f"{t}.mlp.fc2")


def owlvit_rules(cfg: OwlViTConfig) -> Rules:
    p = "owlv2" if cfg.objectness else "owlvit"  # HF base-model prefix
    r = Rules()
    # text tower
    r.add(("text", "token_embedding"), f"{p}.text_model.embeddings.token_embedding.weight")
    r.add(
        ("text", "position_embedding"),
        f"{p}.text_model.embeddings.position_embedding.weight",
    )
    _tower_layers(r, ("text",), f"{p}.text_model", cfg.text.num_hidden_layers)
    r.layernorm(("text", "final_layer_norm"), f"{p}.text_model.final_layer_norm")
    r.add(("text_projection", "kernel"), f"{p}.text_projection.weight", "dense")

    # vision tower
    r.add(("vision", "class_embedding"), f"{p}.vision_model.embeddings.class_embedding")
    r.conv(
        ("vision", "patch_embedding"),
        f"{p}.vision_model.embeddings.patch_embedding.weight",
    )
    r.add(
        ("vision", "position_embedding"),
        f"{p}.vision_model.embeddings.position_embedding.weight",
    )
    r.layernorm(("vision", "pre_layernorm"), f"{p}.vision_model.pre_layernorm")
    _tower_layers(r, ("vision",), f"{p}.vision_model", cfg.vision.num_hidden_layers)
    r.layernorm(("vision", "post_layernorm"), f"{p}.vision_model.post_layernorm")

    # detection heads
    r.layernorm(("merge_layer_norm",), "layer_norm")
    for name in ("dense0", "logit_shift", "logit_scale"):
        r.dense(("class_head", name), f"class_head.{name}")
    for name in ("dense0", "dense1", "dense2"):
        r.dense(("box_head", name), f"box_head.{name}")
    if cfg.objectness:
        for name in ("dense0", "dense1", "dense2"):
            r.dense(("objectness_head", name), f"objectness_head.{name}")
    return r
