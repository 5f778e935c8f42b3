"""RT-DETR / RT-DETRv2 detector (port of spotter_tpu.models.rtdetr).

Same architecture and numerics as the flax module under the "float32"
policy: ResNet-D backbone, hybrid encoder (AIFI transformer layer on the
stride-32 map, then a CSP-RepVGG FPN/PAN), anchor scoring and top-k query
selection, and the deformable decoder with iterative box refinement. The
decoder's sampling runs `ops.msda.deformable_sampling`, whose gather-sum is
the hand-written CUDA kernel on the card.

Convolutions run NCHW; pixels arrive NHWC at `RTDetrDetector.forward`, as
in the JAX package. Attribute names follow the flax module names
(`enc_proj0`, `aifi0_layer0`, `fpn_block0.bottleneck2`, `decoder_layer3.
encoder_attn.value_proj`, ...) so JAX params carry over mechanically.
RepVGG blocks stay unfused: the JAX package fuses them only under bf16.
"""

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from spotter_tpu_torch.models.configs import RTDetrConfig
from spotter_tpu_torch.models.layers import (
    ConvNorm,
    MLPHead,
    MultiHeadAttention,
    get_activation,
    inverse_sigmoid,
    sincos_2d_position_embedding,
)
from spotter_tpu_torch.models.resnet import ResNetBackbone
from spotter_tpu_torch.ops.msda import deformable_sampling
from spotter_tpu_torch.ops.postprocess import stable_top_k


def generate_anchors(
    spatial_shapes: tuple[tuple[int, int], ...],
    grid_size: float = 0.05,
    eps: float = 1e-2,
) -> tuple[np.ndarray, np.ndarray]:
    """Static anchor logits per multi-level grid cell.

    Returns (anchors_logit (1, S, 4), valid_mask (1, S, 1)) in numpy; invalid
    anchors get float32 max so sigmoid saturates at 1.
    """
    all_anchors = []
    for level, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(
            np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij"
        )
        gxy = np.stack([gx, gy], axis=-1) + 0.5
        gxy[..., 0] /= w
        gxy[..., 1] /= h
        wh = np.ones_like(gxy) * grid_size * (2.0**level)
        all_anchors.append(np.concatenate([gxy, wh], -1).reshape(h * w, 4))
    anchors = np.concatenate(all_anchors, 0)[None]
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdims=True)
    anchors_logit = np.log(anchors / (1 - anchors))
    anchors_logit = np.where(valid, anchors_logit, np.finfo(np.float32).max)
    return anchors_logit.astype(np.float32), valid.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_table(fn, device: torch.device, *args):
    """`fn(*args)`'s numpy array(s) as tensors on `device`, cached per shape.

    The tables depend only on static shapes; copying them to the card on
    every forward would make the host wait for the stream each time. Made
    outside inference mode, so they also serve forwards that track gradients.
    """
    out = fn(*args)
    with torch.inference_mode(False):
        if isinstance(out, tuple):
            return tuple(torch.from_numpy(a).to(device) for a in out)
        return torch.from_numpy(out).to(device)


class EncoderLayer(nn.Module):
    """AIFI transformer encoder layer (post-norm)."""

    def __init__(
        self, embed_dim: int, num_heads: int, ffn_dim: int,
        activation: str = "gelu", eps: float = 1e-5,
    ) -> None:
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=eps)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=eps)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, position_embeddings=pos))
        y = self.fc2(self.act(self.fc1(x)))
        return self.final_layer_norm(x + y)


class RepVggBlock(nn.Module):
    def __init__(self, features: int, activation: str = "silu", eps: float = 1e-5) -> None:
        super().__init__()
        self.conv1 = ConvNorm(features, features, 3, 1, padding=1, eps=eps)
        self.conv2 = ConvNorm(features, features, 1, 1, padding=0, eps=eps)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    """Cross-stage-partial fusion block with RepVGG bottlenecks."""

    def __init__(
        self, in_channels: int, out_channels: int, hidden_channels: int,
        num_blocks: int = 3, activation: str = "silu", eps: float = 1e-5,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.conv1 = ConvNorm(in_channels, hidden_channels, 1, 1, activation=activation, eps=eps)
        for i in range(num_blocks):
            setattr(self, f"bottleneck{i}", RepVggBlock(hidden_channels, activation, eps))
        self.conv2 = ConvNorm(in_channels, hidden_channels, 1, 1, activation=activation, eps=eps)
        self.has_conv3 = hidden_channels != out_channels
        if self.has_conv3:
            self.conv3 = ConvNorm(
                hidden_channels, out_channels, 1, 1, activation=activation, eps=eps
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1 = self.conv1(x)
        for i in range(self.num_blocks):
            h1 = getattr(self, f"bottleneck{i}")(h1)
        y = h1 + self.conv2(x)
        return self.conv3(y) if self.has_conv3 else y


class DeformableAttention(nn.Module):
    """Multiscale deformable cross-attention (RT-DETRv2 semantics), unfused
    prologue: offsets and attention weights come from two dense layers,
    then `deformable_sampling` does the corner prep and the gather-sum.

    Sampling offsets are scaled by 1/n_points, the reference-box size, and
    `offset_scale` (v2); sampling is bilinear ("default") or nearest-integer
    ("discrete") over each level's value map.
    """

    def __init__(
        self, d_model: int, num_heads: int, num_levels: int, num_points: int,
        offset_scale: float = 0.5, method: str = "default",
    ) -> None:
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.offset_scale, self.method = offset_scale, method
        lp = num_levels * num_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, num_heads * lp * 2)
        self.attention_weights = nn.Linear(d_model, num_heads * lp)
        self.output_proj = nn.Linear(d_model, d_model)
        n_points_scale = np.repeat(1.0 / np.asarray([num_points] * num_levels, np.float32), num_points)
        self.register_buffer(
            "n_points_scale",
            torch.from_numpy(n_points_scale.astype(np.float32)).view(1, 1, 1, lp, 1),
            persistent=False,
        )

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, Q, D)
        position_embeddings: Optional[torch.Tensor],
        encoder_hidden_states: torch.Tensor,  # (B, S, D)
        reference_points: torch.Tensor,  # (B, Q, 4) normalized cxcywh
        spatial_shapes: tuple[tuple[int, int], ...],
    ) -> torch.Tensor:
        b, q, _ = hidden_states.shape
        heads, lp = self.num_heads, self.num_levels * self.num_points
        hs = hidden_states
        if position_embeddings is not None:
            hs = hs + position_embeddings
        value = self.value_proj(encoder_hidden_states)
        value = value.reshape(b, value.shape[1], heads, self.d_model // heads)
        offsets = self.sampling_offsets(hs).reshape(b, q, heads, lp, 2)
        attn = self.attention_weights(hs).reshape(b, q, heads, lp)
        attn = torch.softmax(attn.to(torch.float32), dim=-1)
        # v2 offset semantics: offsets * (1/n_points) * ref_wh * offset_scale
        ref_xy = reference_points[:, :, None, None, :2]
        ref_wh = reference_points[:, :, None, None, 2:]
        loc = ref_xy + offsets * self.n_points_scale * ref_wh * self.offset_scale
        out = deformable_sampling(
            value, loc, attn, spatial_shapes, self.num_points, method=self.method
        )
        return self.output_proj(out)


class DecoderLayer(nn.Module):
    def __init__(self, config: RTDetrConfig) -> None:
        super().__init__()
        cfg = config
        eps = cfg.layer_norm_eps
        d = cfg.d_model
        self.self_attn = MultiHeadAttention(d, cfg.decoder_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn = DeformableAttention(
            d, cfg.decoder_attention_heads, cfg.num_feature_levels, cfg.decoder_n_points,
            offset_scale=cfg.decoder_offset_scale, method=cfg.decoder_method,
        )
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)
        self.act = get_activation(cfg.decoder_activation_function)

    def forward(
        self,
        hidden_states: torch.Tensor,
        position_embeddings: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        reference_points: torch.Tensor,
        spatial_shapes: tuple[tuple[int, int], ...],
    ) -> torch.Tensor:
        attn_out = self.self_attn(hidden_states, position_embeddings=position_embeddings)
        h = self.self_attn_layer_norm(hidden_states + attn_out)
        cross = self.encoder_attn(
            h, position_embeddings, encoder_hidden_states, reference_points, spatial_shapes
        )
        h = self.encoder_attn_layer_norm(h + cross)
        y = self.fc2(self.act(self.fc1(h)))
        return self.final_layer_norm(h + y)


class RTDetrDetector(nn.Module):
    """Full RT-DETR(v2) detector: pixels (B, H, W, 3) NHWC -> logits + boxes.

    Returns a dict: logits (B, Q, C), pred_boxes (B, Q, 4) normalized cxcywh,
    aux_logits/aux_boxes stacked over decoder layers, enc_topk_logits/
    enc_topk_bboxes (encoder head at the selected queries), and
    enc_topk_index (B, Q), the flat source positions the queries were
    selected from, in query order.
    """

    def __init__(self, config: RTDetrConfig) -> None:
        super().__init__()
        cfg = self.config = config
        eps = cfg.batch_norm_eps
        hid = cfg.encoder_hidden_dim
        self.backbone = ResNetBackbone(cfg.backbone)
        for i, ch in enumerate(self.backbone.out_channels):
            setattr(self, f"enc_proj{i}", ConvNorm(ch, hid, 1, 1, eps=eps))
        for i, _ in enumerate(cfg.encode_proj_layers):
            for j in range(cfg.encoder_layers):
                setattr(self, f"aifi{i}_layer{j}", EncoderLayer(
                    hid, cfg.encoder_attention_heads, cfg.encoder_ffn_dim,
                    cfg.encoder_activation_function, cfg.layer_norm_eps,
                ))
        hidden_channels = int(hid * cfg.hidden_expansion)
        self.num_stages = num_stages = len(cfg.encoder_in_channels) - 1
        act = cfg.activation_function
        for idx in range(num_stages):
            setattr(self, f"lateral_conv{idx}", ConvNorm(hid, hid, 1, 1, activation=act, eps=eps))
            setattr(self, f"fpn_block{idx}", CSPRepLayer(
                2 * hid, hid, hidden_channels, cfg.csp_num_blocks, act, eps
            ))
        for idx in range(num_stages):
            setattr(self, f"downsample_conv{idx}", ConvNorm(hid, hid, 3, 2, activation=act, eps=eps))
            setattr(self, f"pan_block{idx}", CSPRepLayer(
                2 * hid, hid, hidden_channels, cfg.csp_num_blocks, act, eps
            ))
        d = cfg.d_model
        for i in range(cfg.num_feature_levels):
            if i <= num_stages:
                setattr(self, f"dec_proj{i}", ConvNorm(hid, d, 1, 1, eps=eps))
            else:
                setattr(self, f"dec_proj{i}", ConvNorm(d, d, 3, 2, padding=1, eps=eps))
        self.enc_output_dense = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.enc_score_head = nn.Linear(d, cfg.num_labels)
        self.enc_bbox_head = MLPHead(d, d, 4, 3)
        if cfg.learn_initial_query:
            self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, d))
        # shared across decoder layers, as in the flax module
        self.query_pos_head = MLPHead(4, 2 * d, d, 2)
        for i in range(cfg.decoder_layers):
            setattr(self, f"decoder_layer{i}", DecoderLayer(cfg))
            setattr(self, f"bbox_head{i}", MLPHead(d, d, 4, 3))
            setattr(self, f"class_head{i}", nn.Linear(d, cfg.num_labels))

    def forward(self, pixel_values: torch.Tensor) -> dict[str, torch.Tensor]:
        cfg = self.config
        x = pixel_values.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        feats = self.backbone(x)
        proj = [getattr(self, f"enc_proj{i}")(f) for i, f in enumerate(feats)]

        # --- AIFI: transformer encoder on selected (stride-32) levels ---
        for i, enc_ind in enumerate(cfg.encode_proj_layers):
            b, c, h, w = proj[enc_ind].shape
            src = proj[enc_ind].flatten(2).transpose(1, 2)  # (B, h*w, C), y-major
            pos = _device_table(
                sincos_2d_position_embedding, src.device,
                w, h, cfg.encoder_hidden_dim, cfg.positional_encoding_temperature,
            )
            for j in range(cfg.encoder_layers):
                src = getattr(self, f"aifi{i}_layer{j}")(src, pos)
            proj[enc_ind] = src.transpose(1, 2).reshape(b, c, h, w)

        # --- top-down FPN ---
        fpn = [proj[-1]]
        for idx in range(self.num_stages):
            backbone_fm = proj[self.num_stages - idx - 1]
            top = getattr(self, f"lateral_conv{idx}")(fpn[-1])
            fpn[-1] = top
            up = top.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # 2x nearest
            fpn.append(getattr(self, f"fpn_block{idx}")(torch.cat([up, backbone_fm], dim=1)))
        fpn = fpn[::-1]

        # --- bottom-up PAN ---
        pan = [fpn[0]]
        for idx in range(self.num_stages):
            down = getattr(self, f"downsample_conv{idx}")(pan[-1])
            pan.append(getattr(self, f"pan_block{idx}")(torch.cat([down, fpn[idx + 1]], dim=1)))

        # --- decoder input projection + flatten ---
        sources = [getattr(self, f"dec_proj{i}")(p) for i, p in enumerate(pan)]
        for i in range(len(sources), cfg.num_feature_levels):
            sources.append(getattr(self, f"dec_proj{i}")(sources[-1]))
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in sources)
        b = sources[0].shape[0]
        source_flatten = torch.cat([s.flatten(2).transpose(1, 2) for s in sources], dim=1)

        # --- encoder head: anchor scoring + top-k query selection ---
        anchors, valid_mask = _device_table(
            generate_anchors, source_flatten.device, spatial_shapes, cfg.anchor_grid_size
        )
        memory = valid_mask * source_flatten
        output_memory = self.enc_output_norm(self.enc_output_dense(memory))
        enc_class = self.enc_score_head(output_memory)
        enc_coord_logits = self.enc_bbox_head(output_memory) + anchors
        # lax.top_k order: descending, ties to the lower index
        _, topk_ind = stable_top_k(enc_class.max(-1).values, cfg.num_queries)

        def gather(arr):
            return torch.gather(arr, 1, topk_ind[..., None].expand(-1, -1, arr.shape[-1]))

        reference_logits = gather(enc_coord_logits)
        enc_topk_logits = gather(enc_class)
        enc_topk_bboxes = torch.sigmoid(reference_logits)
        if cfg.learn_initial_query:
            target = self.query_embed[None].expand(b, -1, -1)
        else:
            target = gather(output_memory).detach()

        # --- decoder with iterative refinement (box arithmetic in fp32) ---
        ref = torch.sigmoid(reference_logits.detach().to(torch.float32))
        h = target
        aux_logits, aux_boxes = [], []
        for i in range(cfg.decoder_layers):
            pos = self.query_pos_head(ref)
            h = getattr(self, f"decoder_layer{i}")(h, pos, source_flatten, ref, spatial_shapes)
            box_delta = getattr(self, f"bbox_head{i}")(h)
            new_ref = torch.sigmoid(box_delta.to(torch.float32) + inverse_sigmoid(ref))
            aux_logits.append(getattr(self, f"class_head{i}")(h).to(torch.float32))
            aux_boxes.append(new_ref)
            ref = new_ref.detach()

        return {
            "logits": aux_logits[-1],
            "pred_boxes": aux_boxes[-1],
            "aux_logits": torch.stack(aux_logits, dim=1),
            "aux_boxes": torch.stack(aux_boxes, dim=1),
            "enc_topk_logits": enc_topk_logits.to(torch.float32),
            "enc_topk_bboxes": enc_topk_bboxes.to(torch.float32),
            "enc_topk_index": topk_ind,
        }
