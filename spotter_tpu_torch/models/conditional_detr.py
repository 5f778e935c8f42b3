"""Conditional-DETR detector (port of spotter_tpu.models.conditional_detr).

A DETR encoder (models/detr.py) plus the conditional decoder: each query's
cross-attention concatenates, per head, its content projection with a sine
embedding of its reference point (q and k 2 * d_model wide, v d_model), so
content and spatial matching are decoupled. Boxes are regressed relative
to the sigmoid reference points (inverse-sigmoid add) and the labels are
focal (no "no object" class), served by the sigmoid top-k postprocess.

As in the JAX package, `ca_qpos_proj` exists on decoder layer 0 only, and
`query_scale` is one module shared by layers 1 and up, created only when
there are such layers, so the state-dict keys equal flax's. Every
attention here is on the materialised path (masked encoder, `attend` for
the decoder): no hand-written kernel runs. Precision as in models/detr.py:
the backbone at `backbone_dtype`, the rest at `dtype`, the softmaxes, the
reference points and the outputs in fp32.
"""

import math
from typing import Optional

import torch
from torch import nn

from spotter_tpu_torch.models.configs import ConditionalDetrConfig
from spotter_tpu_torch.models.detr import DetrEncoderLayer, dim_t, encoder_inputs, interleave
from spotter_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MLPHead,
    inverse_sigmoid,
    make_activation,
)
from spotter_tpu_torch.models.resnet import ResNetBackbone


def query_sine_embedding(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sine embedding of normalized (x, y) points, (B, Q, d_model): scale
    2 pi, half the channels for y then x, interleaved sin/cos
    (gen_sine_position_embeddings)."""
    denom = torch.from_numpy(dim_t(d_model // 2, 10000.0)).to(pos.device)
    x = pos[..., 0:1] * (2 * math.pi) / denom
    y = pos[..., 1:2] * (2 * math.pi) / denom
    return torch.cat([interleave(y), interleave(x)], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled-dot attention over projected (B, T, ·) q, k, v split into
    heads; q and k may be wider than v (the conditional cross-attention).
    The mask is added to the scores and the softmax runs in fp32."""
    b, tq, qk_dim = q.shape
    head = qk_dim // num_heads
    v_head = v.shape[-1] // num_heads
    qh = q.reshape(b, tq, num_heads, head) * (head**-0.5)
    kh = k.reshape(b, -1, num_heads, head)
    vh = v.reshape(b, -1, num_heads, v_head)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if attn_mask is not None:
        logits = logits + attn_mask.to(logits.dtype)
    weights = torch.softmax(logits.to(torch.float32), dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
    return out.reshape(b, tq, num_heads * v_head)


def concat_heads(a: torch.Tensor, b: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, D) and (B, T, D) -> (B, T, 2D), each head's slice of `a`
    followed by its slice of `b`."""
    n, t, d = a.shape
    return torch.cat([a.reshape(n, t, heads, d // heads), b.reshape(n, t, heads, d // heads)],
                     dim=-1).reshape(n, t, 2 * d)


class ConditionalDecoderLayer(nn.Module):
    """Decoupled content/position self-attention, the conditional
    cross-attention and an FFN, each post-norm. `has_qpos` (layer 0, or
    every DAB-DETR layer under keep_query_pos) adds the query and key
    positions to the cross-attention's content halves. At `dtype`."""

    def __init__(self, cfg, has_qpos: bool, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.heads = cfg.decoder_attention_heads
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj", "sa_kpos_proj",
                     "sa_v_proj", "self_attn_out_proj", "ca_qcontent_proj", "ca_kcontent_proj",
                     "ca_v_proj", "ca_kpos_proj", "ca_qpos_sine_proj", "encoder_attn_out_proj"):
            setattr(self, name, Dense(d, d, dtype=dtype))
        self.has_qpos = has_qpos
        if has_qpos:
            self.ca_qpos_proj = Dense(d, d, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.encoder_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.fc1 = Dense(d, cfg.decoder_ffn_dim, dtype=dtype)
        # DAB-DETR's PReLU is a module with a weight, as flax names it
        self.activation = make_activation(cfg.activation_function)
        self.fc2 = Dense(cfg.decoder_ffn_dim, d, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, eps, dtype)

    def forward(self, hidden, query_pos, query_sine, memory, memory_pos, memory_mask):
        q = self.sa_qcontent_proj(hidden) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(hidden) + self.sa_kpos_proj(query_pos)
        attn = attend(q, k, self.sa_v_proj(hidden), self.heads)
        hidden = self.self_attn_layer_norm(hidden + self.self_attn_out_proj(attn))

        qc = self.ca_qcontent_proj(hidden)
        kc = self.ca_kcontent_proj(memory)
        v = self.ca_v_proj(memory)
        kpos = self.ca_kpos_proj(memory_pos)
        if self.has_qpos:
            qc = qc + self.ca_qpos_proj(query_pos)
            kc = kc + kpos
        qsine = self.ca_qpos_sine_proj(query_sine)
        cross = attend(concat_heads(qc, qsine, self.heads), concat_heads(kc, kpos, self.heads),
                       v, self.heads, memory_mask)
        hidden = self.encoder_attn_layer_norm(hidden + self.encoder_attn_out_proj(cross))
        ffn = self.fc2(self.activation(self.fc1(hidden)))
        return self.final_layer_norm(hidden + ffn)


class ConditionalDetrDetector(nn.Module):
    """Conditional DETR: pixels (B, H, W, 3) NHWC and an optional pixel mask
    -> logits (B, Q, num_labels), pred_boxes (B, Q, 4) normalized cxcywh,
    both fp32. `dtype` and `backbone_dtype` are the flax module's fields."""

    def __init__(self, config: ConditionalDetrConfig, dtype: torch.dtype = torch.float32,
                 backbone_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.dtype = dtype
        self.backbone = ResNetBackbone(cfg.backbone, backbone_dtype or dtype)
        self.input_projection = nn.Conv2d(self.backbone.out_channels[-1], d, 1, dtype=dtype)
        for i in range(cfg.encoder_layers):
            setattr(self, f"encoder_layer{i}", DetrEncoderLayer(cfg, dtype))
        self.query_pos = nn.Parameter(torch.zeros(cfg.num_queries, d))  # fp32; cast at use
        self.ref_point_head = MLPHead(d, d, 2, 2, dtype=dtype)
        if cfg.decoder_layers > 1:  # used from layer 1 on, so flax has it only then
            self.query_scale = MLPHead(d, d, d, 2, dtype=dtype)
        for i in range(cfg.decoder_layers):
            setattr(self, f"decoder_layer{i}",
                    ConditionalDecoderLayer(cfg, has_qpos=i == 0, dtype=dtype))
        self.decoder_layernorm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.class_labels_classifier = Dense(d, cfg.num_labels, dtype=dtype)
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

        query_pos = self.query_pos[None].expand(src.shape[0], -1, -1).to(self.dtype)
        # reference points from the query embeddings, shared by every layer
        ref = torch.sigmoid(self.ref_point_head(query_pos).to(torch.float32))
        sine_base = query_sine_embedding(ref, cfg.d_model).to(self.dtype)
        hidden = torch.zeros_like(query_pos)
        for i in range(cfg.decoder_layers):
            query_sine = sine_base if i == 0 else sine_base * self.query_scale(hidden)
            hidden = getattr(self, f"decoder_layer{i}")(
                hidden, query_pos, query_sine, src, pos, attn_mask)
        hidden = self.decoder_layernorm(hidden)

        logits = self.class_labels_classifier(hidden)
        delta = self.bbox_predictor(hidden).to(torch.float32)
        boxes = torch.sigmoid(
            torch.cat([delta[..., :2] + inverse_sigmoid(ref), delta[..., 2:]], dim=-1))
        return {"logits": logits.to(torch.float32), "pred_boxes": boxes}
