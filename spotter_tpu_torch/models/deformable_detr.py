"""Deformable DETR detector (port of spotter_tpu.models.deformable_detr).

Same architecture and numerics as the flax module, under each precision
policy (the backbone at `backbone_dtype`, the rest at `dtype`, the
reference boxes and the outputs in fp32): a "v1" ResNet backbone, 1x1 conv + GroupNorm(32) input projections
(extra pyramid levels by 3x3 stride-2 convs), mask-aware sine position
embeddings with the deformable lineage's half-cell shift, and multiscale
deformable attention in both the encoder (every pyramid token is a query)
and the decoder, with the plain, `with_box_refine` and `two_stage`
variants. The sampling runs `ops.msda.deformable_sampling`, whose
SPOTTER_TPU_MSDA backend picks the hand-written CUDA kernel on the card.

Pixels arrive NHWC at `DeformableDetrDetector.forward` with an optional
(B, H, W) pixel mask (1 = image, 0 = padding), as in the JAX package;
convolutions run NCHW. Attribute names follow the flax module names
(`input_proj0_conv`, `encoder_layer2.self_attn.sampling_offsets`,
`class_head3`, ...) so JAX params carry over mechanically. The JAX
package's model-level locality presort of the decoder queries is not done:
it only orders the queries for its TPU kernels' hit tables, and the
decoder is permutation-equivariant over queries.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from spotter_tpu_torch.models.configs import DeformableDetrConfig
from spotter_tpu_torch.models.detr import dim_t, interleave, nearest_downsample_mask
from spotter_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MLPHead,
    MultiHeadAttention,
    device_table,
    get_activation,
    inverse_sigmoid,
)
from spotter_tpu_torch.models.resnet import ResNetBackbone
from spotter_tpu_torch.ops import msda
from spotter_tpu_torch.ops.postprocess import stable_top_k


def sine_position_from_mask_offset(
    mask: torch.Tensor, embed_dim: int, temperature: float = 10000.0
) -> torch.Tensor:
    """DeformableDetrSinePositionEmbedding(normalize=True): (B, h, w) mask ->
    (B, h, w, 2 * embed_dim), y half then x half; coordinates are
    (cumsum - 0.5) / total * 2 pi."""
    scale = 2.0 * math.pi
    y = torch.cumsum(mask, dim=1)
    x = torch.cumsum(mask, dim=2)
    y = (y - 0.5) / (y[:, -1:, :] + 1e-6) * scale
    x = (x - 0.5) / (x[:, :, -1:] + 1e-6) * scale
    denom = device_table(dim_t, mask.device, embed_dim, temperature)
    return torch.cat([interleave(y[..., None] / denom), interleave(x[..., None] / denom)],
                     dim=-1)


def encoder_reference_base(spatial_shapes: tuple[tuple[int, int], ...]) -> np.ndarray:
    """Static (S, 2) xy cell centres, each normalized by its own level's dims."""
    out = []
    for h, w in spatial_shapes:
        gy, gx = np.meshgrid(
            np.linspace(0.5, h - 0.5, h, dtype=np.float32),
            np.linspace(0.5, w - 0.5, w, dtype=np.float32),
            indexing="ij",
        )
        out.append(np.stack([gx / w, gy / h], axis=-1).reshape(h * w, 2))
    return np.concatenate(out, axis=0)


def proposal_position_embedding(
    coord_logits: torch.Tensor, d_model: int, temperature: float = 10000.0
) -> torch.Tensor:
    """get_proposal_pos_embed: (B, K, 4) box logits -> (B, K, 2 * d_model) sines."""
    denom = device_table(dim_t, coord_logits.device, d_model // 2, temperature)
    proposals = torch.sigmoid(coord_logits) * (2.0 * math.pi)
    pos = proposals[..., None] / denom  # (B, K, 4, d_model / 2)
    pos = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1)
    return pos.reshape(*coord_logits.shape[:2], -1)


def _level_of(spatial_shapes: tuple[tuple[int, int], ...]) -> np.ndarray:
    return np.repeat(np.arange(len(spatial_shapes)), [h * w for h, w in spatial_shapes])


def _level_wh(spatial_shapes: tuple[tuple[int, int], ...]) -> np.ndarray:
    """(1, 1, 1, L, 1, 2) per-level (w, h), the 2-coordinate offset normalizer."""
    return np.asarray([[w, h] for h, w in spatial_shapes], np.float32)[None, None, None, :, None, :]


class GroupNorm(nn.GroupNorm):
    """flax's nn.GroupNorm(dtype=...): statistics, scale and bias in fp32
    (fp32 params), the result cast to `dtype`; also over groups of a single
    value (a 1x1 level with one channel per group gives the bias), which
    torch's functional form refuses when the batch is 1."""

    def __init__(self, num_groups: int, num_channels: int, eps: float,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(num_groups, num_channels, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.group_norm(x.to(torch.float32), self.num_groups, self.weight, self.bias,
                             self.eps)
        return y.to(self.dtype)


class MsdaAttention(nn.Module):
    """Multiscale deformable attention (Deformable-DETR semantics).

    Takes both reference layouts of the lineage, per level and already
    valid-ratio scaled, (B, Q, L, 2 | 4): 2-coordinate points (offsets
    normalized by each level's (w, h)) and 4-coordinate boxes (offsets
    scaled by box size / n_points * 0.5). Padded source tokens are zeroed
    in the value by `value_mask` (B, S), 1 = valid."""

    def __init__(self, d_model: int, num_heads: int, num_levels: int, num_points: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.dtype = dtype
        self.value_proj = Dense(d_model, d_model, dtype=dtype)
        self.sampling_offsets = Dense(d_model, num_heads * num_levels * num_points * 2, dtype=dtype)
        self.attention_weights = Dense(d_model, num_heads * num_levels * num_points, dtype=dtype)
        self.output_proj = Dense(d_model, d_model, dtype=dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, Q, D)
        position_embeddings: Optional[torch.Tensor],
        encoder_hidden_states: torch.Tensor,  # (B, S, D)
        reference_points: torch.Tensor,  # (B, Q, L, 2 | 4)
        spatial_shapes: tuple[tuple[int, int], ...],
        value_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, q, _ = hidden_states.shape
        heads, levels, points = self.num_heads, self.num_levels, self.num_points
        hs = hidden_states
        if position_embeddings is not None:
            hs = hs + position_embeddings
        value = self.value_proj(encoder_hidden_states)
        if value_mask is not None:
            value = value * value_mask[..., None].to(value.dtype)
        value = value.reshape(b, value.shape[1], heads, self.d_model // heads)
        offsets = self.sampling_offsets(hs).reshape(b, q, heads, levels, points, 2)
        attn = self.attention_weights(hs).reshape(b, q, heads, levels * points)
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(self.dtype)
        if reference_points.shape[-1] == 2:
            normalizer = device_table(_level_wh, offsets.device, spatial_shapes)
            loc = reference_points[:, :, None, :, None, :] + offsets / normalizer.to(offsets.dtype)
        else:
            ref_xy = reference_points[:, :, None, :, None, :2]
            ref_wh = reference_points[:, :, None, :, None, 2:]
            loc = ref_xy + offsets / points * ref_wh * 0.5
        loc = loc.reshape(b, q, heads, levels * points, 2)
        out = msda.deformable_sampling(value, loc, attn, spatial_shapes, points)
        return self.output_proj(out)


class DeformableEncoderLayer(nn.Module):
    """Post-norm encoder layer: MSDA self-attention + FFN."""

    def __init__(self, cfg: DeformableDetrConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MsdaAttention(
            d, cfg.encoder_attention_heads, cfg.num_feature_levels, cfg.encoder_n_points, dtype)
        self.self_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.fc1 = Dense(d, cfg.encoder_ffn_dim, dtype=dtype)
        self.fc2 = Dense(cfg.encoder_ffn_dim, d, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, eps, dtype)
        self.act = get_activation(cfg.activation_function)

    def forward(self, hidden, pos, reference_points, spatial_shapes, value_mask):
        attn_out = self.self_attn(hidden, pos, hidden, reference_points, spatial_shapes,
                                  value_mask)
        hidden = self.self_attn_layer_norm(hidden + attn_out)
        y = self.fc2(self.act(self.fc1(hidden)))
        return self.final_layer_norm(hidden + y)


class DeformableDecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention + MSDA cross-attention + FFN."""

    def __init__(self, cfg: DeformableDetrConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MultiHeadAttention(d, cfg.decoder_attention_heads, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.encoder_attn = MsdaAttention(
            d, cfg.decoder_attention_heads, cfg.num_feature_levels, cfg.decoder_n_points, dtype)
        self.encoder_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.fc1 = Dense(d, cfg.decoder_ffn_dim, dtype=dtype)
        self.fc2 = Dense(cfg.decoder_ffn_dim, d, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, eps, dtype)
        self.act = get_activation(cfg.activation_function)

    def forward(self, hidden, query_pos, memory, reference_points, spatial_shapes, value_mask):
        attn_out = self.self_attn(hidden, position_embeddings=query_pos)
        hidden = self.self_attn_layer_norm(hidden + attn_out)
        cross = self.encoder_attn(hidden, query_pos, memory, reference_points, spatial_shapes,
                                  value_mask)
        hidden = self.encoder_attn_layer_norm(hidden + cross)
        y = self.fc2(self.act(self.fc1(hidden)))
        return self.final_layer_norm(hidden + y)


class DeformableDetrDetector(nn.Module):
    """Full Deformable-DETR detector: pixels (B, H, W, 3) NHWC and an optional
    (B, H, W) pixel mask -> logits (B, Q, C), pred_boxes (B, Q, 4) normalized
    cxcywh of the valid region, aux_logits/aux_boxes stacked over decoder
    layers, and (two-stage) enc_outputs_class/enc_outputs_coord_logits, all
    fp32. `dtype` and `backbone_dtype` are the flax module's fields."""

    def __init__(self, config: DeformableDetrConfig, dtype: torch.dtype = torch.float32,
                 backbone_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.dtype = dtype
        self.backbone_dtype = backbone_dtype or dtype
        self.backbone = ResNetBackbone(cfg.backbone, self.backbone_dtype)
        chans = self.backbone.out_channels
        for i in range(cfg.num_feature_levels):
            if i < len(chans):
                conv = nn.Conv2d(chans[i], d, 1, dtype=dtype)
            else:
                conv = nn.Conv2d(chans[-1] if i == len(chans) else d, d, 3, stride=2, padding=1,
                                 dtype=dtype)
            setattr(self, f"input_proj{i}_conv", conv)
            setattr(self, f"input_proj{i}_norm", GroupNorm(32, d, cfg.layer_norm_eps, dtype))
        # fp32, as flax's params; cast at use
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, d))
        for i in range(cfg.encoder_layers):
            setattr(self, f"encoder_layer{i}", DeformableEncoderLayer(cfg, dtype))
        if cfg.with_box_refine:
            for i in range(cfg.num_pred_heads):
                setattr(self, f"class_head{i}", Dense(d, cfg.num_labels, dtype=dtype))
                setattr(self, f"bbox_head{i}", MLPHead(d, d, 4, 3, dtype=dtype))
        else:  # one pair shared by every layer (and the proposals)
            self.class_head = Dense(d, cfg.num_labels, dtype=dtype)
            self.bbox_head = MLPHead(d, d, 4, 3, dtype=dtype)
        if cfg.two_stage:
            self.enc_output = Dense(d, d, dtype=dtype)
            self.enc_output_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)
            self.pos_trans = Dense(2 * d, 2 * d, dtype=dtype)
            self.pos_trans_norm = LayerNorm(2 * d, cfg.layer_norm_eps, dtype)
        else:
            self.query_embeddings = nn.Parameter(torch.zeros(cfg.num_queries, 2 * d))
            self.reference_points_proj = Dense(d, 2)  # fp32 under every policy
        for i in range(cfg.decoder_layers):
            setattr(self, f"decoder_layer{i}", DeformableDecoderLayer(cfg, dtype))

    def _heads(self, i: int) -> tuple[nn.Module, nn.Module]:
        if self.config.with_box_refine:
            return getattr(self, f"class_head{i}"), getattr(self, f"bbox_head{i}")
        return self.class_head, self.bbox_head

    def forward(
        self, pixel_values: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None
    ) -> dict[str, torch.Tensor]:
        cfg = self.config
        b, h, w, _ = pixel_values.shape
        full_mask = pixel_mask is None
        if full_mask:
            pixel_mask = torch.ones((b, h, w), dtype=torch.float32, device=pixel_values.device)
        pixel_mask = pixel_mask.to(torch.float32)
        dtype = self.dtype
        features = [f.to(dtype) for f in
                    self.backbone(pixel_values.permute(0, 3, 1, 2).contiguous())]

        sources = []
        for i in range(cfg.num_feature_levels):
            if i < len(features):
                src_in = features[i]
            else:
                src_in = features[-1] if i == len(features) else sources[-1]
            src = getattr(self, f"input_proj{i}_conv")(src_in)
            sources.append(getattr(self, f"input_proj{i}_norm")(src))
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in sources)

        masks = [nearest_downsample_mask(pixel_mask, hw) for hw in spatial_shapes]
        pos_list, src_list, mask_list = [], [], []
        for lvl, (source, mask) in enumerate(zip(sources, masks)):
            sh, sw = spatial_shapes[lvl]
            pos = sine_position_from_mask_offset(
                mask, cfg.d_model // 2, cfg.positional_encoding_temperature).to(dtype)
            pos_list.append(pos.reshape(b, sh * sw, cfg.d_model) + self.level_embed[lvl].to(dtype))
            src_list.append(source.flatten(2).transpose(1, 2))
            mask_list.append(mask.reshape(b, sh * sw))
        source_flatten = torch.cat(src_list, dim=1)
        pos_flatten = torch.cat(pos_list, dim=1)
        mask_flatten = torch.cat(mask_list, dim=1)
        value_mask = None if full_mask else mask_flatten

        # (B, L, 2) valid ratios as (w, h) per level
        valid_ratios = torch.stack([
            torch.stack([m[:, 0, :].sum(dim=1) / sw, m[:, :, 0].sum(dim=1) / sh], dim=-1)
            for m, (sh, sw) in zip(masks, spatial_shapes)
        ], dim=1)

        # encoder: reference points are the cell centres, normalized by their
        # own level's valid extent and projected into every level's
        base = device_table(encoder_reference_base, pixel_values.device, spatial_shapes)
        level_of = device_table(_level_of, pixel_values.device, spatial_shapes)
        own_vr = valid_ratios[:, level_of, :]  # (B, S, 2)
        enc_ref = (base[None] / own_vr)[:, :, None, :] * valid_ratios[:, None]
        hidden = source_flatten
        for i in range(cfg.encoder_layers):
            hidden = getattr(self, f"encoder_layer{i}")(
                hidden, pos_flatten, enc_ref, spatial_shapes, value_mask)
        memory = hidden

        outputs: dict[str, torch.Tensor] = {}
        if cfg.two_stage:
            target, query_pos, ref, enc_class, enc_coord_logits = self._two_stage_queries(
                memory, mask_flatten, spatial_shapes)
            outputs["enc_outputs_class"] = enc_class.to(torch.float32)
            outputs["enc_outputs_coord_logits"] = enc_coord_logits.to(torch.float32)
        else:
            query_pos = self.query_embeddings[None, :, : cfg.d_model].expand(b, -1, -1).to(dtype)
            target = self.query_embeddings[None, :, cfg.d_model:].expand(b, -1, -1).to(dtype)
            ref = torch.sigmoid(self.reference_points_proj(query_pos.to(torch.float32)))

        # decoder, with the reference boxes iterated in fp32
        hq = target
        aux_logits, aux_boxes = [], []
        for i in range(cfg.decoder_layers):
            vr = torch.cat([valid_ratios, valid_ratios], -1) if ref.shape[-1] == 4 else valid_ratios
            ref_input = (ref[:, :, None] * vr[:, None]).to(dtype)
            hq = getattr(self, f"decoder_layer{i}")(
                hq, query_pos, memory, ref_input, spatial_shapes, value_mask)
            class_head, bbox_head = self._heads(i)
            delta = bbox_head(hq).to(torch.float32)
            if cfg.with_box_refine:
                if ref.shape[-1] == 4:
                    new_ref = torch.sigmoid(delta + inverse_sigmoid(ref))
                else:  # the first refinement promotes 2-coordinate refs to boxes
                    new_ref = torch.sigmoid(
                        torch.cat([delta[..., :2] + inverse_sigmoid(ref), delta[..., 2:]], -1))
                aux_boxes.append(new_ref)
                ref = new_ref.detach()
            else:
                box_logits = torch.cat([delta[..., :2] + inverse_sigmoid(ref), delta[..., 2:]], -1)
                aux_boxes.append(torch.sigmoid(box_logits))
            aux_logits.append(class_head(hq).to(torch.float32))

        outputs.update(
            logits=aux_logits[-1],
            pred_boxes=aux_boxes[-1],
            aux_logits=torch.stack(aux_logits, dim=1),
            aux_boxes=torch.stack(aux_boxes, dim=1),
        )
        return outputs

    def _two_stage_queries(self, memory, mask_flatten, spatial_shapes):
        """Encoder proposals -> the top-k object queries (two-stage variant):
        every source position proposes an anchor box (cell centre, wh = 0.05
        * 2^level, in valid-cell units); border and padded positions get +inf
        logits; the extra head pair scores them, and the top
        `two_stage_num_proposals` (lax.top_k's order) seed the decoder."""
        cfg = self.config
        b = memory.shape[0]
        proposals, start = [], 0
        for level, (sh, sw) in enumerate(spatial_shapes):
            mask_l = mask_flatten[:, start:start + sh * sw].reshape(b, sh, sw)
            valid_h = mask_l[:, :, 0].sum(dim=1)
            valid_w = mask_l[:, 0, :].sum(dim=1)
            grid = device_table(_proposal_grid, memory.device, sh, sw)  # (sh, sw, 2)
            scale = torch.stack([valid_w, valid_h], dim=-1)[:, None, None, :]
            grid_n = grid[None] / scale
            wh = torch.full_like(grid_n, 0.05 * (2.0**level))
            proposals.append(torch.cat([grid_n, wh], dim=-1).reshape(b, -1, 4))
            start += sh * sw
        output_proposals = torch.cat(proposals, dim=1).to(torch.float32)
        proposals_valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(
            dim=-1, keepdim=True)
        output_proposals = torch.log(output_proposals / (1.0 - output_proposals))
        keep = proposals_valid & (mask_flatten[..., None] > 0)
        output_proposals = torch.where(keep, output_proposals, torch.inf)

        object_query = self.enc_output_norm(self.enc_output(memory * keep.to(memory.dtype)))
        class_head, bbox_head = self._heads(cfg.decoder_layers)
        enc_class = class_head(object_query)
        enc_coord_logits = bbox_head(object_query).to(torch.float32) + output_proposals
        _, topk_ind = stable_top_k(enc_class[..., 0].to(torch.float32),
                                   cfg.two_stage_num_proposals)
        topk_coords_logits = torch.gather(
            enc_coord_logits, 1, topk_ind[..., None].expand(-1, -1, 4)).detach()
        ref = torch.sigmoid(topk_coords_logits)
        pos_embed = proposal_position_embedding(
            topk_coords_logits, cfg.d_model, cfg.positional_encoding_temperature).to(self.dtype)
        pos_trans = self.pos_trans_norm(self.pos_trans(pos_embed))
        query_pos, target = pos_trans[..., : cfg.d_model], pos_trans[..., cfg.d_model:]
        return target, query_pos, ref, enc_class, enc_coord_logits


def _proposal_grid(sh: int, sw: int) -> np.ndarray:
    """(sh, sw, 2) xy cell centres in cells, the proposals' static grid."""
    gy, gx = np.meshgrid(np.arange(sh, dtype=np.float32), np.arange(sw, dtype=np.float32),
                         indexing="ij")
    return np.stack([gx, gy], axis=-1) + 0.5
