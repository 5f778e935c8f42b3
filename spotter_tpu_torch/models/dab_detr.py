"""DAB-DETR detector (port of spotter_tpu.models.dab_detr).

Each object query is a learned 4D anchor box (x, y, w, h). Its sine
embedding gives the decoder's query positions (`ref_point_head`); the
cross-attention's spatial half is scaled by a content transform
(`query_scale`) and modulated by the predicted anchor aspect over the
anchor's own size (`ref_anchor_head`); a shared box head refines the
anchors layer by layer, in fp32. The encoder is a post-norm DETR encoder
whose sine position map (temperature 20/20) is rescaled per layer by its own
MLP (`encoder_query_scale`). FFNs use a learned PReLU. Labels are focal,
served by the sigmoid top-k postprocess.

`ref_point_head`, `query_scale`, `ref_anchor_head`, `bbox_predictor` and
`decoder_layernorm` are each one module shared by every layer, as in the
flax module; `ca_qpos_proj` exists on layer 0, or on every layer under
`keep_query_pos`; `query_scale` only when a layer 1 uses it. Every
attention is on the materialised path: no hand-written kernel runs.
Precision as in models/detr.py; the anchors and `ref_anchor_head`'s
sigmoid stay fp32, and `mod_x`/`mod_y` are cast to `dtype` before they
scale the sine halves, as in the flax module.
"""

import math
from typing import Optional

import torch
from torch import nn

from spotter_tpu_torch.models.conditional_detr import ConditionalDecoderLayer
from spotter_tpu_torch.models.configs import DabDetrConfig
from spotter_tpu_torch.models.detr import dim_t, encoder_inputs, interleave
from spotter_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MLPHead,
    MultiHeadAttention,
    PReLU,
    inverse_sigmoid,
)
from spotter_tpu_torch.models.resnet import ResNetBackbone


def anchor_sine_embedding(boxes: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sine embedding of normalized (x, y, w, h) anchors, (B, Q, 2 * d_model):
    scale 2 pi, d_model / 2 channels a coordinate, concatenated [y, x, w, h]."""
    denom = torch.from_numpy(dim_t(d_model // 2, 10000.0)).to(boxes.device)

    def emb(coord):
        return interleave(coord[..., None] * (2 * math.pi) / denom)

    return torch.cat([emb(boxes[..., 1]), emb(boxes[..., 0]), emb(boxes[..., 2]),
                      emb(boxes[..., 3])], dim=-1)


class DabEncoderLayer(nn.Module):
    """Post-norm DETR encoder layer with a learned-PReLU FFN, at `dtype`."""

    def __init__(self, cfg: DabDetrConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MultiHeadAttention(d, cfg.encoder_attention_heads, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.fc1 = Dense(d, cfg.encoder_ffn_dim, dtype=dtype)
        self.activation = PReLU()
        self.fc2 = Dense(cfg.encoder_ffn_dim, d, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, eps, dtype)

    def forward(self, hidden, pos, attn_mask):
        attn = self.self_attn(hidden, position_embeddings=pos, attention_mask=attn_mask)
        hidden = self.self_attn_layer_norm(hidden + attn)
        y = self.fc2(self.activation(self.fc1(hidden)))
        return self.final_layer_norm(hidden + y)


class DabDecoderLayer(ConditionalDecoderLayer):
    """Conditional-DETR's decoder layer with DAB's learned PReLU; the query
    and key positions enter the cross-attention's content halves on the
    first layer, or on every layer under `keep_query_pos`."""

    def __init__(self, cfg: DabDetrConfig, is_first: bool, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(cfg, has_qpos=is_first or cfg.keep_query_pos, dtype=dtype)


class DabDetrDetector(nn.Module):
    """DAB-DETR: pixels (B, H, W, 3) NHWC and an optional pixel mask ->
    logits (B, Q, num_labels), pred_boxes (B, Q, 4) normalized cxcywh, and
    aux_boxes (B, layers, Q, 4), each layer's boxes from its input anchors;
    all fp32. `dtype` and `backbone_dtype` are the flax module's fields."""

    def __init__(self, config: DabDetrConfig, dtype: torch.dtype = torch.float32,
                 backbone_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.dtype = dtype
        self.backbone = ResNetBackbone(cfg.backbone, backbone_dtype or dtype)
        self.input_projection = nn.Conv2d(self.backbone.out_channels[-1], d, 1, dtype=dtype)
        self.encoder_query_scale = MLPHead(d, d, d, 2, dtype=dtype)
        for i in range(cfg.encoder_layers):
            setattr(self, f"encoder_layer{i}", DabEncoderLayer(cfg, dtype))
        # fp32, as flax's param; the anchors stay fp32
        self.query_refpoints = nn.Parameter(torch.zeros(cfg.num_queries, cfg.query_dim))
        self.ref_point_head = MLPHead(2 * d, d, d, 2, dtype=dtype)
        if cfg.decoder_layers > 1:  # used from layer 1 on, so flax has it only then
            self.query_scale = MLPHead(d, d, d, 2, dtype=dtype)
        self.ref_anchor_head = MLPHead(d, d, 2, 2, dtype=dtype)
        self.bbox_predictor = MLPHead(d, d, 4, 3, dtype=dtype)
        self.decoder_layernorm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        for i in range(cfg.decoder_layers):
            setattr(self, f"decoder_layer{i}", DabDecoderLayer(cfg, is_first=i == 0, dtype=dtype))
        self.class_embed = Dense(d, cfg.num_labels, dtype=dtype)

    def forward(
        self, pixel_values: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None
    ) -> dict[str, torch.Tensor]:
        cfg = self.config
        d, half = cfg.d_model, cfg.d_model // 2
        dtype = self.dtype
        src, pos, attn_mask = encoder_inputs(
            self.backbone, self.input_projection, pixel_values, pixel_mask, d,
            (cfg.temperature_height, cfg.temperature_width), dtype)
        # the encoder's sine map is rescaled per layer by a content MLP
        for i in range(cfg.encoder_layers):
            src = getattr(self, f"encoder_layer{i}")(
                src, pos * self.encoder_query_scale(src), attn_mask)

        b = src.shape[0]
        ref = torch.sigmoid(self.query_refpoints)[None].expand(b, -1, -1)
        hidden = torch.zeros((b, cfg.num_queries, d), dtype=src.dtype, device=src.device)
        intermediate, ref_inputs = [], []  # ref_inputs: each layer's input anchors
        for i in range(cfg.decoder_layers):
            ref_inputs.append(ref)
            sine_full = anchor_sine_embedding(ref, d).to(dtype)
            query_pos = self.ref_point_head(sine_full)
            query_sine = sine_full[..., :d]
            if i > 0:
                query_sine = query_sine * self.query_scale(hidden)
            # modulated attention: the x/y sine halves rescaled by the
            # predicted anchor aspect over the current anchor size
            ref_hw = torch.sigmoid(self.ref_anchor_head(hidden).to(torch.float32))
            mod_y = (ref_hw[..., 1] / ref[..., 3])[..., None].to(dtype)
            mod_x = (ref_hw[..., 0] / ref[..., 2])[..., None].to(dtype)
            query_sine = torch.cat([query_sine[..., :half] * mod_y,
                                    query_sine[..., half:] * mod_x], dim=-1)
            hidden = getattr(self, f"decoder_layer{i}")(
                hidden, query_pos, query_sine, src, pos, attn_mask)
            # anchor refinement through the shared box head on the raw
            # hidden; the output boxes use the layernormed hidden
            delta = self.bbox_predictor(hidden).to(torch.float32)
            ref = torch.sigmoid(delta + inverse_sigmoid(ref)).detach()
            intermediate.append(self.decoder_layernorm(hidden))

        logits = self.class_embed(intermediate[-1])
        aux_boxes = [torch.sigmoid(self.bbox_predictor(hid).to(torch.float32) + inverse_sigmoid(r))
                     for hid, r in zip(intermediate, ref_inputs)]
        return {"logits": logits.to(torch.float32), "pred_boxes": aux_boxes[-1],
                "aux_boxes": torch.stack(aux_boxes, dim=1)}
