"""DETR and Table-Transformer detectors (port of spotter_tpu.models.detr).

Same architecture and numerics as the flax module, under each precision
policy (the backbone at `backbone_dtype`, its last map cast to `dtype` for
the transformer, the softmaxes and the outputs in fp32): a frozen-BN "v1"
ResNet backbone, mask-aware sine position
embeddings (cumsum over the pixel mask), transformer layers where the
position embeddings are added to queries and keys only (post-norm for
DETR, pre-norm with a closing encoder LayerNorm for Table-Transformer),
zero object queries with a learned `query_pos`, a final decoder LayerNorm,
a `num_labels + 1` class head ("no object" last) and a 3-layer sigmoid box
head.

The encoder always gets an additive pixel mask, all-valid or not
(`finfo(float32).min` on padded tokens, added to the fp32 scores), so its
self-attention takes `MultiHeadAttention`'s materialised path at any
sequence length, as the JAX package's does: at the 1333x1333 bucket it
attends over 42x42 = 1764 tokens, above the attention kernel's cutover,
and launches no hand-written kernel.

Pixels arrive NHWC with an optional (B, H, W) pixel mask (1 = image, 0 =
padding); convolutions run NCHW. Attribute names follow the flax module
names (`input_projection`, `encoder_layer3.self_attn.q_proj`, `query_pos`,
`class_labels_classifier`, ...) so JAX params carry over mechanically.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from spotter_tpu_torch.models.configs import DetrConfig
from spotter_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MLPHead,
    MultiHeadAttention,
    device_table,
    get_activation,
)
from spotter_tpu_torch.models.resnet import ResNetBackbone


def nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """The legacy nearest's source rows, floor(dst * in / out)."""
    return np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)


def nearest_downsample_mask(mask: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch F.interpolate(mode="nearest") on a (B, H, W) mask, with the
    legacy nearest's src = floor(dst * in / out) index tables computed in
    numpy from the static shapes, as the JAX package computes them."""
    _, h_in, w_in = mask.shape
    h_out, w_out = out_hw
    return mask[:, device_table(nearest_index, mask.device, h_out, h_in)][
        :, :, device_table(nearest_index, mask.device, w_out, w_in)]


def dim_t(num_feats: int, temperature: float) -> np.ndarray:
    """The sine tables' denominators, temperature ** (2 * (i // 2) / n), in
    numpy float32 as the JAX package computes them."""
    return temperature ** (2.0 * (np.arange(num_feats, dtype=np.float32) // 2) / num_feats)


def interleave(p: torch.Tensor) -> torch.Tensor:
    """sin of the even features and cos of the odd ones, interleaved."""
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1).reshape(
        *p.shape[:-1], -1)


def sine_position_from_mask(
    mask: torch.Tensor,
    embed_dim: int,
    temperature: float | tuple[float, float] = 10000.0,
) -> torch.Tensor:
    """DetrSinePositionEmbedding(normalize=True): (B, h, w) mask ->
    (B, h, w, 2 * embed_dim), y half then x half; coordinates are the
    1-based cumsum over valid pixels, normalized to [0, 2 pi].
    `temperature` may be a (height, width) pair (DAB-DETR's 20/20)."""
    scale = 2.0 * math.pi
    temp_y, temp_x = (
        temperature if isinstance(temperature, tuple) else (temperature, temperature)
    )
    y = torch.cumsum(mask, dim=1)
    x = torch.cumsum(mask, dim=2)
    y = y / (y[:, -1:, :] + 1e-6) * scale
    x = x / (x[:, :, -1:] + 1e-6) * scale
    dim_y = device_table(dim_t, mask.device, embed_dim, temp_y)
    dim_x = device_table(dim_t, mask.device, embed_dim, temp_x)
    return torch.cat([interleave(y[..., None] / dim_y), interleave(x[..., None] / dim_x)],
                     dim=-1)


def additive_mask(mask_flat: torch.Tensor) -> torch.Tensor:
    """(B, S) token mask -> (B, 1, 1, S) additive fp32 mask: 0 on valid
    tokens, finfo(float32).min on padded ones (HF's
    _prepare_4d_attention_mask, as the JAX package builds it)."""
    return torch.where(mask_flat[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)


def encoder_inputs(backbone: ResNetBackbone, projection: nn.Conv2d, pixel_values: torch.Tensor,
                   pixel_mask: Optional[torch.Tensor], d_model: int, temperature,
                   dtype: torch.dtype = torch.float32):
    """The DETR lineage's encoder inputs: the backbone's last map, cast to
    `dtype`, through the 1x1 projection as (B, S, D) tokens, their sine
    positions (B, S, D) at `dtype` and the additive fp32 mask (B, 1, 1, S).
    Without a pixel mask every pixel is valid, and the mask is still built."""
    b, h, w, _ = pixel_values.shape
    if pixel_mask is None:
        pixel_mask = torch.ones((b, h, w), dtype=torch.float32, device=pixel_values.device)
    pixel_mask = pixel_mask.to(torch.float32)
    feat = backbone(pixel_values.permute(0, 3, 1, 2).contiguous())[-1].to(dtype)
    fh, fw = feat.shape[2], feat.shape[3]
    mask = nearest_downsample_mask(pixel_mask, (fh, fw))
    pos = sine_position_from_mask(mask, d_model // 2, temperature).to(dtype)
    src = projection(feat).flatten(2).transpose(1, 2)
    return src, pos.reshape(b, fh * fw, d_model), additive_mask(mask.reshape(b, fh * fw))


class DetrEncoderLayer(nn.Module):
    """Encoder layer: self-attention + FFN, post-norm (DETR) or pre-norm
    (Table-Transformer) by `config.pre_norm`, at `dtype`."""

    def __init__(self, cfg: DetrConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.pre_norm = cfg.pre_norm
        self.self_attn = MultiHeadAttention(d, cfg.encoder_attention_heads, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.fc1 = Dense(d, cfg.encoder_ffn_dim, dtype=dtype)
        self.fc2 = Dense(cfg.encoder_ffn_dim, d, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, eps, dtype)
        self.activation = get_activation(cfg.activation_function)

    def forward(self, hidden, pos, attn_mask):
        if self.pre_norm:
            hidden = hidden + self.self_attn(self.self_attn_layer_norm(hidden),
                                             position_embeddings=pos, attention_mask=attn_mask)
            return hidden + self.fc2(self.activation(self.fc1(self.final_layer_norm(hidden))))
        attn = self.self_attn(hidden, position_embeddings=pos, attention_mask=attn_mask)
        hidden = self.self_attn_layer_norm(hidden + attn)
        return self.final_layer_norm(hidden + self.fc2(self.activation(self.fc1(hidden))))


class DetrDecoderLayer(nn.Module):
    """Decoder layer: self-attention over the queries + cross-attention to
    the encoder's memory + FFN, post-norm or pre-norm, at `dtype`."""

    def __init__(self, cfg: DetrConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.pre_norm = cfg.pre_norm
        self.self_attn = MultiHeadAttention(d, cfg.decoder_attention_heads, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.encoder_attn = MultiHeadAttention(d, cfg.decoder_attention_heads, dtype=dtype)
        self.encoder_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.fc1 = Dense(d, cfg.decoder_ffn_dim, dtype=dtype)
        self.fc2 = Dense(cfg.decoder_ffn_dim, d, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, eps, dtype)
        self.activation = get_activation(cfg.activation_function)

    def forward(self, queries, query_pos, memory, memory_pos, memory_mask):
        def cross(x):
            return self.encoder_attn(x, position_embeddings=query_pos, key_value_states=memory,
                                     key_position_embeddings=memory_pos,
                                     attention_mask=memory_mask)

        def ffn(x):
            return self.fc2(self.activation(self.fc1(x)))

        if self.pre_norm:
            queries = queries + self.self_attn(self.self_attn_layer_norm(queries),
                                               position_embeddings=query_pos)
            queries = queries + cross(self.encoder_attn_layer_norm(queries))
            return queries + ffn(self.final_layer_norm(queries))
        queries = self.self_attn_layer_norm(
            queries + self.self_attn(queries, position_embeddings=query_pos))
        queries = self.encoder_attn_layer_norm(queries + cross(queries))
        return self.final_layer_norm(queries + ffn(queries))


class DetrDetector(nn.Module):
    """DETR: pixels (B, H, W, 3) NHWC and an optional (B, H, W) pixel mask ->
    logits (B, Q, num_labels + 1), pred_boxes (B, Q, 4) normalized cxcywh,
    both fp32. `dtype` and `backbone_dtype` are the flax module's fields."""

    def __init__(self, config: DetrConfig, dtype: torch.dtype = torch.float32,
                 backbone_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.dtype = dtype
        self.backbone = ResNetBackbone(cfg.backbone, backbone_dtype or dtype)
        self.input_projection = nn.Conv2d(self.backbone.out_channels[-1], d, 1, dtype=dtype)
        for i in range(cfg.encoder_layers):
            setattr(self, f"encoder_layer{i}", DetrEncoderLayer(cfg, dtype))
        if cfg.pre_norm:  # Table-Transformer closes the pre-norm encoder
            self.encoder_layernorm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.query_pos = nn.Parameter(torch.zeros(cfg.num_queries, d))  # fp32; cast at use
        for i in range(cfg.decoder_layers):
            setattr(self, f"decoder_layer{i}", DetrDecoderLayer(cfg, dtype))
        self.decoder_layernorm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.class_labels_classifier = Dense(d, cfg.num_labels + 1, dtype=dtype)
        self.bbox_predictor = MLPHead(d, d, 4, 3, dtype=dtype)

    def forward(
        self, pixel_values: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None
    ) -> dict[str, torch.Tensor]:
        cfg = self.config
        src, pos, attn_mask = encoder_inputs(
            self.backbone, self.input_projection, pixel_values, pixel_mask, cfg.d_model,
            cfg.positional_encoding_temperature, self.dtype)
        for i in range(cfg.encoder_layers):
            src = getattr(self, f"encoder_layer{i}")(src, pos, attn_mask)
        if cfg.pre_norm:
            src = self.encoder_layernorm(src)

        query_pos = self.query_pos[None].expand(src.shape[0], -1, -1).to(self.dtype)
        queries = torch.zeros_like(query_pos)
        for i in range(cfg.decoder_layers):
            queries = getattr(self, f"decoder_layer{i}")(queries, query_pos, src, pos, attn_mask)
        queries = self.decoder_layernorm(queries)
        logits = self.class_labels_classifier(queries)
        boxes = torch.sigmoid(self.bbox_predictor(queries).to(torch.float32))
        return {"logits": logits.to(torch.float32), "pred_boxes": boxes}
