"""Conversion rules: HF RTDetr(V2)ForObjectDetection state_dict -> RTDetrDetector params.
(Copy of spotter_tpu.convert.rtdetr_rules.)

Covers every inference-path weight. Training-only extras (denoising class
embedding) are converted when present via `optional` rules.
"""

from spotter_tpu_torch.convert.rules import Rules, resnet_rules
from spotter_tpu_torch.models.configs import RTDetrConfig


def _conv_bn_seq(r: Rules, flax_prefix, torch_prefix: str) -> None:
    """torch nn.Sequential(Conv2d(bias=False), BatchNorm2d) -> our ConvNorm."""
    r.conv((*flax_prefix, "conv"), f"{torch_prefix}.0.weight")
    r.batchnorm((*flax_prefix, "bn"), f"{torch_prefix}.1")


def _conv_norm(r: Rules, flax_prefix, torch_prefix: str) -> None:
    """torch RTDetrConvNormLayer {conv, norm} -> our ConvNorm {conv, bn}."""
    r.conv_norm(flax_prefix, f"{torch_prefix}.conv", f"{torch_prefix}.norm")


def _csp(r: Rules, flax_prefix, torch_prefix: str, cfg: RTDetrConfig) -> None:
    flax_prefix = tuple(flax_prefix)
    _conv_norm(r, (*flax_prefix, "conv1"), f"{torch_prefix}.conv1")
    _conv_norm(r, (*flax_prefix, "conv2"), f"{torch_prefix}.conv2")
    hidden = int(cfg.encoder_hidden_dim * cfg.hidden_expansion)
    if hidden != cfg.encoder_hidden_dim:
        _conv_norm(r, (*flax_prefix, "conv3"), f"{torch_prefix}.conv3")
    for j in range(cfg.csp_num_blocks):
        _conv_norm(
            r, (*flax_prefix, f"bottleneck{j}", "conv1"),
            f"{torch_prefix}.bottlenecks.{j}.conv1",
        )
        _conv_norm(
            r, (*flax_prefix, f"bottleneck{j}", "conv2"),
            f"{torch_prefix}.bottlenecks.{j}.conv2",
        )


def _encoder_layer(r: Rules, flax_prefix, torch_prefix: str) -> None:
    flax_prefix = tuple(flax_prefix)
    r.attention((*flax_prefix, "self_attn"), f"{torch_prefix}.self_attn")
    r.layernorm((*flax_prefix, "self_attn_layer_norm"), f"{torch_prefix}.self_attn_layer_norm")
    r.dense((*flax_prefix, "fc1"), f"{torch_prefix}.fc1")
    r.dense((*flax_prefix, "fc2"), f"{torch_prefix}.fc2")
    r.layernorm((*flax_prefix, "final_layer_norm"), f"{torch_prefix}.final_layer_norm")


def rtdetr_rules(cfg: RTDetrConfig) -> Rules:
    r = Rules()
    # backbone (under model.backbone.model., BN replaced by frozen BN — same keys)
    r.rules.extend(resnet_rules(cfg.backbone, ("backbone",), "model.backbone.model.").rules)

    n_levels = len(cfg.encoder_in_channels)
    for i in range(n_levels):
        _conv_bn_seq(r, (f"enc_proj{i}",), f"model.encoder_input_proj.{i}")

    for i, _ in enumerate(cfg.encode_proj_layers):
        for j in range(cfg.encoder_layers):
            _encoder_layer(r, (f"aifi{i}_layer{j}",), f"model.encoder.encoder.{i}.layers.{j}")

    for i in range(n_levels - 1):
        _conv_norm(r, (f"lateral_conv{i}",), f"model.encoder.lateral_convs.{i}")
        _csp(r, (f"fpn_block{i}",), f"model.encoder.fpn_blocks.{i}", cfg)
        _conv_norm(r, (f"downsample_conv{i}",), f"model.encoder.downsample_convs.{i}")
        _csp(r, (f"pan_block{i}",), f"model.encoder.pan_blocks.{i}", cfg)

    for i in range(cfg.num_feature_levels):
        _conv_bn_seq(r, (f"dec_proj{i}",), f"model.decoder_input_proj.{i}")

    r.dense(("enc_output_dense",), "model.enc_output.0")
    r.layernorm(("enc_output_norm",), "model.enc_output.1")
    r.dense(("enc_score_head",), "model.enc_score_head")
    r.mlp_head(("enc_bbox_head",), "model.enc_bbox_head", 3)
    r.mlp_head(("query_pos_head",), "model.decoder.query_pos_head", 2)

    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}"
        f = f"decoder_layer{i}"
        r.attention((f, "self_attn"), f"{p}.self_attn")
        r.layernorm((f, "self_attn_layer_norm"), f"{p}.self_attn_layer_norm")
        for proj in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            r.dense((f, "encoder_attn", proj), f"{p}.encoder_attn.{proj}")
        r.layernorm((f, "encoder_attn_layer_norm"), f"{p}.encoder_attn_layer_norm")
        r.dense((f, "fc1"), f"{p}.fc1")
        r.dense((f, "fc2"), f"{p}.fc2")
        r.layernorm((f, "final_layer_norm"), f"{p}.final_layer_norm")
        r.dense((f"class_head{i}",), f"class_embed.{i}")
        r.mlp_head((f"bbox_head{i}",), f"bbox_embed.{i}", 3)

    if cfg.learn_initial_query:
        r.add(("query_embed",), "model.weight_embedding.weight")
    return r
