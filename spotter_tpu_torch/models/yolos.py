"""YOLOS (hustvl/yolos-*): a plain ViT with appended detection tokens (port
of spotter_tpu.models.yolos).

Patch embedding, [CLS] + patch + detection tokens with one learned position
table, pre-norm ViT layers, optional per-layer "mid" position embeddings
added after every layer but the last, a final LayerNorm, and two 3-layer
MLP heads (classes including "no object", and sigmoid boxes) on the
detection tokens only. Submodules carry their flax names (`query`, `key`,
`value`, `out`, `fc1`, `layernorm_before`, `layer{i}`, ...), so
`convert.from_jax` carries the weights across with its usual rules.

`dtype` is the body's compute dtype: fp32 under the "float32" policy, bf16
under "mixed" and "bfloat16" (models/zoo.py). The heads' logits and the
box sigmoid come out in fp32 either way.

Self-attention of FLASH_ATTN_MIN_SEQ tokens or more on a CUDA tensor (the
yolos-base sequence is 1 + 50*84 + 100 = 4301) runs the attention kernel
with q scaled before the call; elsewhere the scores are materialised and
scaled after q.kᵀ, as the JAX package's plain path does.

The serving spec warp-resizes every image to `image_size`, so the position
tables apply as trained. At another input size (a multiple of the patch)
the patch rows of the position table, and of each mid table, are resized
to the input's patch grid as the JAX package resizes them
(`ops/resize.py`: `jax.image.resize`'s bicubic, Keys a = -0.5, antialiased
when shrinking), in fp32 before the cast; the [CLS] and detection-token rows
stay as trained. The attention then runs over the new sequence length.
"""

import torch
from torch import nn

from spotter_tpu_torch.models.configs import YolosConfig
from spotter_tpu_torch.models.layers import (
    FLASH_ATTN_MIN_SEQ,
    LayerNorm,
    MLPHead,
    PatchEmbed,
    QuantDense,
    flash_attention_enabled,
    flash_self_attention,
    get_activation,
)
from spotter_tpu_torch.ops.resize import resize_table_bicubic


class YolosAttention(nn.Module):
    """ViT-style self-attention (separate query/key/value + output dense)."""

    def __init__(self, config: YolosConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = d // self.heads
        self.query = QuantDense(d, d, bias=config.qkv_bias, dtype=dtype)
        self.key = QuantDense(d, d, bias=config.qkv_bias, dtype=dtype)
        self.value = QuantDense(d, d, bias=config.qkv_bias, dtype=dtype)
        self.out = QuantDense(d, d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = (proj(x).view(b, s, self.heads, self.head_dim)
                   for proj in (self.query, self.key, self.value))
        scale = self.head_dim**-0.5
        if flash_attention_enabled(q) and s >= FLASH_ATTN_MIN_SEQ:
            out = flash_self_attention(q * scale, k, v)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            weights = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(b, s, d))


class YolosLayer(nn.Module):
    """Pre-norm ViT block."""

    def __init__(self, config: YolosConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.layernorm_before = LayerNorm(d, eps, dtype)
        self.attention = YolosAttention(config, dtype)
        self.layernorm_after = LayerNorm(d, eps, dtype)
        self.fc1 = QuantDense(d, config.intermediate_size, dtype=dtype)
        self.fc2 = QuantDense(config.intermediate_size, d, dtype=dtype)
        self.act = get_activation(config.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        return x + self.fc2(self.act(self.fc1(self.layernorm_after(x))))


class YolosDetector(nn.Module):
    """(B, H, W, C) float pixels -> {"logits": (B, T, C+1) fp32,
    "pred_boxes": (B, T, 4) fp32 normalized cxcywh}."""

    def __init__(self, config: YolosConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = config.hidden_size
        gh, gw = config.grid_hw
        tokens = gh * gw + config.num_detection_tokens + 1
        self.patch_projection = PatchEmbed(config.num_channels, d, config.patch_size, dtype)
        # fp32 tables, cast to the compute dtype where they are added (flax
        # keeps them fp32 params and casts at use)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.detection_tokens = nn.Parameter(torch.zeros(1, config.num_detection_tokens, d))
        self.position_embeddings = nn.Parameter(torch.zeros(1, tokens, d))
        if config.use_mid_position_embeddings:
            self.mid_position_embeddings = nn.Parameter(
                torch.zeros(config.num_hidden_layers - 1, 1, tokens, d)
            )
        for i in range(config.num_hidden_layers):
            setattr(self, f"layer{i}", YolosLayer(config, dtype))
        self.layernorm = LayerNorm(d, config.layer_norm_eps, dtype)
        self.class_labels_classifier = MLPHead(d, d, config.num_labels + 1, 3, dtype)
        self.bbox_predictor = MLPHead(d, d, 4, 3, dtype)

    def forward(self, pixel_values: torch.Tensor) -> dict[str, torch.Tensor]:
        cfg = self.config
        b, h, w, _ = pixel_values.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch size {p}")
        grid = (h // p, w // p)
        n_src = cfg.grid_hw[0] * cfg.grid_hw[1]
        dt, t, d = self.dtype, cfg.num_detection_tokens, cfg.hidden_size

        def split_pos(table):
            # JAX's split_pos: [CLS], the patch grid (resized off-native), the
            # detection tokens
            if grid == cfg.grid_hw:
                return table
            return torch.cat([table[:, :1],
                              resize_table_bicubic(table[:, 1:1 + n_src], cfg.grid_hw, grid),
                              table[:, 1 + n_src:]], dim=1)

        x = self.patch_projection(pixel_values)
        x = torch.cat(
            [self.cls_token.to(dt).expand(b, 1, d), x, self.detection_tokens.to(dt).expand(b, t, d)],
            dim=1,
        )
        x = x + split_pos(self.position_embeddings).to(dt)
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layer{i}")(x)
            if cfg.use_mid_position_embeddings and i < cfg.num_hidden_layers - 1:
                x = x + split_pos(self.mid_position_embeddings[i]).to(dt)
        det_out = self.layernorm(x)[:, -t:]
        logits = self.class_labels_classifier(det_out)
        boxes = torch.sigmoid(self.bbox_predictor(det_out).to(torch.float32))
        return {"logits": logits.to(torch.float32), "pred_boxes": boxes}
