"""RT-DETR / RT-DETRv2 detector (port of spotter_tpu.models.rtdetr).

Same architecture and numerics as the flax module: ResNet-D backbone,
hybrid encoder (AIFI transformer layer on the stride-32 map, then a
CSP-RepVGG FPN/PAN), anchor scoring and top-k query selection, and the
deformable decoder with iterative box refinement. The decoder's sampling
runs `ops.msda.deformable_sampling` (or, under
SPOTTER_TPU_MSDA_PREP=fused, `ops.msda.deformable_sampling_fused`), whose
hand-written CUDA kernels do the work on the card.

Precision follows the flax module's two dtypes: the backbone at
`backbone_dtype` (bf16 under "mixed"), everything after it at `dtype`
(bf16 under "bfloat16"), with the features cast at the boundary; the
attention softmaxes in fp32, the reference boxes iterated in fp32, and
every output fp32. RepVGG blocks fuse under SPOTTER_TPU_REP_FUSE, read as
the JAX package reads it (`rep_fuse_default`): the env var wins, otherwise
a block fuses exactly when it computes in bf16 (the "bfloat16" policy).
Fused and unfused blocks hold the same parameters.

Convolutions run NCHW; pixels arrive NHWC at `RTDetrDetector.forward`, as
in the JAX package. Attribute names follow the flax module names
(`enc_proj0`, `aifi0_layer0`, `fpn_block0.bottleneck2`, `decoder_layer3.
encoder_attn.value_proj`, ...) so JAX params carry over mechanically.
"""

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spotter_tpu_torch.models.configs import RTDetrConfig
from spotter_tpu_torch.models.layers import (
    ConvNorm,
    Dense,
    LayerNorm,
    MLPHead,
    MultiHeadAttention,
    device_table,
    get_activation,
    inverse_sigmoid,
    kept,
    sincos_2d_position_embedding,
)
from spotter_tpu_torch.models.resnet import ResNetBackbone
from spotter_tpu_torch.ops import msda
from spotter_tpu_torch.ops.int8 import quantize_weight_rows
from spotter_tpu_torch.ops.postprocess import stable_top_k
from spotter_tpu_torch.utils.precision import compute_dtype
from spotter_tpu_torch.utils import quant

REP_FUSE_ENV = "SPOTTER_TPU_REP_FUSE"


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


class EncoderLayer(nn.Module):
    """AIFI transformer encoder layer (post-norm), at `dtype`."""

    def __init__(
        self, embed_dim: int, num_heads: int, ffn_dim: int,
        activation: str = "gelu", eps: float = 1e-5, dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(embed_dim, eps, dtype)
        self.fc1 = Dense(embed_dim, ffn_dim, dtype=dtype)
        self.fc2 = Dense(ffn_dim, embed_dim, dtype=dtype)
        self.final_layer_norm = LayerNorm(embed_dim, eps, dtype)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, position_embeddings=pos))
        y = self.fc2(self.act(self.fc1(x)))
        return self.final_layer_norm(x + y)


def rep_fuse_default(dtype: Optional[torch.dtype] = None) -> bool:
    """SPOTTER_TPU_REP_FUSE as the JAX package reads it: a set value wins
    ("0" off, anything else on); unset, fuse exactly when the compute dtype
    is bf16 (`dtype`, else the policy's), so "bfloat16" fuses and "mixed"
    and "float32" do not. Read when a block runs."""
    flag = os.environ.get(REP_FUSE_ENV, "").strip()
    if flag:
        return flag != "0"
    return (dtype or compute_dtype()) == torch.bfloat16


class RepVggBlock(nn.Module):
    """conv3x3+BN + conv1x1+BN, summed, then the activation. Fused
    (`rep_fuse_default`), the same parameters run as one 3x3 convolution:
    kernel w3 * mul3 with w1 * mul1 added at its centre and bias add3 + add1,
    folded in fp32 from the fp32 master kernels and cast to `dtype` once, as
    the JAX package's fused block computes them; with SPOTTER_TPU_INT8 on
    (the channel and batch floors of utils/quant.py) the fused fp32 kernel
    is quantized and the convolution is `quant.int8_conv`, dequantized to
    `dtype`, before the bias. The fused kernel, its cast and its codes are
    kept until a parameter changes (each tensor's version counter) or the
    block moves."""

    def __init__(self, features: int, activation: str = "silu", eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvNorm(features, features, 3, 1, padding=1, eps=eps, dtype=dtype)
        self.conv2 = ConvNorm(features, features, 1, 1, padding=0, eps=eps, dtype=dtype)
        self.act = get_activation(activation)

    def _sources(self) -> tuple:
        sources = [self.conv1.conv.weight, self.conv2.conv.weight]
        for bn in (self.conv1.bn, self.conv2.bn):
            sources += [bn.weight, bn.bias, bn.running_mean, bn.running_var]
        return tuple(sources)

    def fused_fp32(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The fused (kernel (C, C, 3, 3), bias (C,)) in fp32."""

        def fold():
            mul3, add3 = self.conv1.bn.folded()
            mul1, add1 = self.conv2.bn.folded()
            kernel = self.conv1.conv.weight.to(torch.float32) * mul3.view(-1, 1, 1, 1)
            centre = self.conv2.conv.weight.to(torch.float32) * mul1.view(-1, 1, 1, 1)
            kernel[:, :, 1:2, 1:2] += centre
            return kernel, add3 + add1

        return kept(self, "_fused32", self._sources(), fold)

    def fused_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The fused (kernel (C, C, 3, 3), bias (C,)) at `dtype`."""
        return kept(self, "_fused", self._sources(),
                    lambda: tuple(t.to(self.dtype) for t in self.fused_fp32()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if rep_fuse_default(self.dtype):
            kernel, bias = self.fused_params()
            if quant.int8_wanted(x.shape[1], batch=x.shape[0]):
                codes = kept(self, "_quantized", self._sources(),
                             lambda: quantize_weight_rows(self.fused_fp32()[0]), grad=False)
                y = quant.int8_conv(x, codes, 3, 1, 1, self.dtype)
            else:
                y = F.conv2d(x.to(self.dtype), kernel, padding=1)
            return self.act(y + bias.view(1, -1, 1, 1))
        return self.act(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    """Cross-stage-partial fusion block with RepVGG bottlenecks, at `dtype`."""

    def __init__(
        self, in_channels: int, out_channels: int, hidden_channels: int,
        num_blocks: int = 3, activation: str = "silu", eps: float = 1e-5,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.conv1 = ConvNorm(in_channels, hidden_channels, 1, 1, activation=activation, eps=eps,
                              dtype=dtype)
        for i in range(num_blocks):
            setattr(self, f"bottleneck{i}", RepVggBlock(hidden_channels, activation, eps, dtype))
        self.conv2 = ConvNorm(in_channels, hidden_channels, 1, 1, activation=activation, eps=eps,
                              dtype=dtype)
        self.has_conv3 = hidden_channels != out_channels
        if self.has_conv3:
            self.conv3 = ConvNorm(
                hidden_channels, out_channels, 1, 1, activation=activation, eps=eps, dtype=dtype
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1 = self.conv1(x)
        for i in range(self.num_blocks):
            h1 = getattr(self, f"bottleneck{i}")(h1)
        y = h1 + self.conv2(x)
        return self.conv3(y) if self.has_conv3 else y


class DeformableAttention(nn.Module):
    """Multiscale deformable cross-attention (RT-DETRv2 semantics).

    Unfused prologue (SPOTTER_TPU_MSDA_PREP=xla|kernel): offsets and
    attention weights come from two dense layers, then `deformable_sampling`
    does the corner prep and the gather-sum. Fused (=fused, read at forward
    time): the same two layers' parameters go to `deformable_sampling_fused`,
    whose kernel computes the projections, the softmax and the locations, so
    one checkpoint serves both paths.

    Sampling offsets are scaled by 1/n_points, the reference-box size, and
    `offset_scale` (v2); sampling is bilinear ("default") or nearest-integer
    ("discrete") over each level's value map.
    """

    def __init__(
        self, d_model: int, num_heads: int, num_levels: int, num_points: int,
        offset_scale: float = 0.5, method: str = "default", dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.offset_scale, self.method = offset_scale, method
        self.dtype = dtype
        lp = num_levels * num_points
        self.value_proj = Dense(d_model, d_model, dtype=dtype)
        self.sampling_offsets = Dense(d_model, num_heads * lp * 2, dtype=dtype)
        self.attention_weights = Dense(d_model, num_heads * lp, dtype=dtype)
        self.output_proj = Dense(d_model, d_model, dtype=dtype)
        n_points_scale = np.repeat(1.0 / np.asarray([num_points] * num_levels, np.float32), num_points)
        self.register_buffer(  # at the compute dtype, as the flax module's constant
            "n_points_scale",
            torch.from_numpy(n_points_scale.astype(np.float32)).view(1, 1, 1, lp, 1).to(dtype),
            persistent=False,
        )

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, Q, D)
        position_embeddings: Optional[torch.Tensor],
        encoder_hidden_states: torch.Tensor,  # (B, S, D)
        reference_points: torch.Tensor,  # (B, Q, 4) normalized cxcywh, at dtype
        spatial_shapes: tuple[tuple[int, int], ...],
    ) -> torch.Tensor:
        b, q, _ = hidden_states.shape
        heads, lp = self.num_heads, self.num_levels * self.num_points
        hs = hidden_states
        if position_embeddings is not None:
            hs = hs + position_embeddings
        value = self.value_proj(encoder_hidden_states)
        value = value.reshape(b, value.shape[1], heads, self.d_model // heads)
        if msda.msda_prep_fused():
            out = msda.deformable_sampling_fused(
                value, hs, reference_points,
                self.sampling_offsets.weight.t(), self.sampling_offsets.bias,
                self.attention_weights.weight.t(), self.attention_weights.bias,
                spatial_shapes, self.num_points, offset_scale=self.offset_scale,
                method=self.method,
            )
            return self.output_proj(out)
        offsets = self.sampling_offsets(hs).reshape(b, q, heads, lp, 2)
        attn = self.attention_weights(hs).reshape(b, q, heads, lp)
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(self.dtype)
        # v2 offset semantics: offsets * (1/n_points) * ref_wh * offset_scale,
        # in the compute dtype (bf16 locations under "bfloat16")
        ref_xy = reference_points[:, :, None, None, :2]
        ref_wh = reference_points[:, :, None, None, 2:]
        loc = ref_xy + offsets * self.n_points_scale * ref_wh * self.offset_scale
        out = msda.deformable_sampling(
            value, loc, attn, spatial_shapes, self.num_points, method=self.method
        )
        return self.output_proj(out)


class DecoderLayer(nn.Module):
    def __init__(self, config: RTDetrConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        cfg = config
        eps = cfg.layer_norm_eps
        d = cfg.d_model
        self.self_attn = MultiHeadAttention(d, cfg.decoder_attention_heads, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.encoder_attn = DeformableAttention(
            d, cfg.decoder_attention_heads, cfg.num_feature_levels, cfg.decoder_n_points,
            offset_scale=cfg.decoder_offset_scale, method=cfg.decoder_method, dtype=dtype,
        )
        self.encoder_attn_layer_norm = LayerNorm(d, eps, dtype)
        self.fc1 = Dense(d, cfg.decoder_ffn_dim, dtype=dtype)
        self.fc2 = Dense(cfg.decoder_ffn_dim, d, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, eps, dtype)
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
    selected from, in query order; all fp32 (the index int64).

    `dtype` is the compute dtype after the backbone, `backbone_dtype` the
    backbone's (None: `dtype`), as the flax module's fields.
    """

    def __init__(self, config: RTDetrConfig, dtype: torch.dtype = torch.float32,
                 backbone_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.backbone_dtype = backbone_dtype or dtype
        eps = cfg.batch_norm_eps
        hid = cfg.encoder_hidden_dim
        self.backbone = ResNetBackbone(cfg.backbone, self.backbone_dtype)
        for i, ch in enumerate(self.backbone.out_channels):
            setattr(self, f"enc_proj{i}", ConvNorm(ch, hid, 1, 1, eps=eps, dtype=dtype))
        for i, _ in enumerate(cfg.encode_proj_layers):
            for j in range(cfg.encoder_layers):
                setattr(self, f"aifi{i}_layer{j}", EncoderLayer(
                    hid, cfg.encoder_attention_heads, cfg.encoder_ffn_dim,
                    cfg.encoder_activation_function, cfg.layer_norm_eps, dtype,
                ))
        hidden_channels = int(hid * cfg.hidden_expansion)
        self.num_stages = num_stages = len(cfg.encoder_in_channels) - 1
        act = cfg.activation_function
        for idx in range(num_stages):
            setattr(self, f"lateral_conv{idx}",
                    ConvNorm(hid, hid, 1, 1, activation=act, eps=eps, dtype=dtype))
            setattr(self, f"fpn_block{idx}", CSPRepLayer(
                2 * hid, hid, hidden_channels, cfg.csp_num_blocks, act, eps, dtype
            ))
        for idx in range(num_stages):
            setattr(self, f"downsample_conv{idx}",
                    ConvNorm(hid, hid, 3, 2, activation=act, eps=eps, dtype=dtype))
            setattr(self, f"pan_block{idx}", CSPRepLayer(
                2 * hid, hid, hidden_channels, cfg.csp_num_blocks, act, eps, dtype
            ))
        d = cfg.d_model
        for i in range(cfg.num_feature_levels):
            if i <= num_stages:
                setattr(self, f"dec_proj{i}", ConvNorm(hid, d, 1, 1, eps=eps, dtype=dtype))
            else:
                setattr(self, f"dec_proj{i}", ConvNorm(d, d, 3, 2, padding=1, eps=eps, dtype=dtype))
        self.enc_output_dense = Dense(d, d, dtype=dtype)
        self.enc_output_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.enc_score_head = Dense(d, cfg.num_labels, dtype=dtype)
        self.enc_bbox_head = MLPHead(d, d, 4, 3, dtype=dtype)
        if cfg.learn_initial_query:  # fp32, as flax's param; cast at use
            self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, d))
        # shared across decoder layers, as in the flax module
        self.query_pos_head = MLPHead(4, 2 * d, d, 2, dtype=dtype)
        for i in range(cfg.decoder_layers):
            setattr(self, f"decoder_layer{i}", DecoderLayer(cfg, dtype))
            setattr(self, f"bbox_head{i}", MLPHead(d, d, 4, 3, dtype=dtype))
            setattr(self, f"class_head{i}", Dense(d, cfg.num_labels, dtype=dtype))

    def forward(self, pixel_values: torch.Tensor) -> dict[str, torch.Tensor]:
        cfg = self.config
        dtype = self.dtype
        x = pixel_values.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        feats = [f.to(dtype) for f in self.backbone(x)]
        proj = [getattr(self, f"enc_proj{i}")(f) for i, f in enumerate(feats)]

        # --- AIFI: transformer encoder on selected (stride-32) levels ---
        for i, enc_ind in enumerate(cfg.encode_proj_layers):
            b, c, h, w = proj[enc_ind].shape
            src = proj[enc_ind].flatten(2).transpose(1, 2)  # (B, h*w, C), y-major
            pos = device_table(
                sincos_2d_position_embedding, src.device,
                w, h, cfg.encoder_hidden_dim, cfg.positional_encoding_temperature,
            ).to(dtype)
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
        anchors, valid_mask = device_table(
            generate_anchors, source_flatten.device, spatial_shapes, cfg.anchor_grid_size
        )
        anchors, valid_mask = anchors.to(dtype), valid_mask.to(dtype)
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
        enc_topk_bboxes = torch.sigmoid(reference_logits.to(torch.float32))
        if cfg.learn_initial_query:
            target = self.query_embed[None].expand(b, -1, -1).to(dtype)
        else:
            target = gather(output_memory).detach()

        # --- decoder with iterative refinement (box arithmetic in fp32) ---
        ref = torch.sigmoid(reference_logits.detach().to(torch.float32))
        h = target
        aux_logits, aux_boxes = [], []
        for i in range(cfg.decoder_layers):
            ref_c = ref.to(dtype)
            pos = self.query_pos_head(ref_c)
            h = getattr(self, f"decoder_layer{i}")(h, pos, source_flatten, ref_c, spatial_shapes)
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
            "enc_topk_bboxes": enc_topk_bboxes,
            "enc_topk_index": topk_ind,
        }
