"""OWL-ViT / OWLv2 (google/owlvit-*, google/owlv2-*): open-vocabulary
detection conditioned on text queries (port of spotter_tpu.models.owlvit).

CLIP-style vision and text towers, the class-token merge over the patch
features, a text-query class head (cosine logits with a learned per-patch
shift and scale), a box MLP biased toward each patch's grid position, and
for OWLv2 (`config.objectness`) an objectness MLP. Submodules carry their
flax names (`vision`, `text`, `text_projection`, `merge_layer_norm`,
`class_head`, `box_head`, `objectness_head`, `layer{i}`, `self_attn`, ...),
so `convert.from_jax` carries the weights across with its usual rules.

The text tower runs once when the model is built, for the deployment's
vocabulary (models/zoo.py), and again only for a request's own `queries`;
the serving forward is vision-only: `forward(pixels, query_embeds,
query_mask)`.

Dtypes follow the JAX zoo: the vision tower at `vision_dtype` (the
backbone dtype: bf16 under "mixed"), the text tower, the merge LayerNorm
and the heads at `dtype` (the compute dtype). Logits and objectness come out
in fp32, and the box sigmoid is taken in fp32. The vision tower's unmasked
self-attention over FLASH_ATTN_MIN_SEQ tokens or more (OWLv2: 3601) runs
the attention kernel on a CUDA tensor; the class head runs the class-logit
kernel unless SPOTTER_TPU_OWL_FUSED says otherwise (ops/openvocab.py).

The serving specs resize every image to the config's `image_size`, so the
position table applies as trained; another grid would need the JAX
package's bicubic table interpolation, which is not ported and raises.
"""

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spotter_tpu_torch.models.configs import OwlViTConfig, OwlViTTextConfig, OwlViTVisionConfig
from spotter_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadAttention,
    PatchEmbed,
    QuantDense,
    get_activation,
)
from spotter_tpu_torch.ops import openvocab
from spotter_tpu_torch.ops.openvocab import NEG_INF, owl_class_logits


def owlvit_box_bias(grid_h: int, grid_w: int) -> np.ndarray:
    """Per-patch box prior, (grid_h*grid_w, 4) numpy.

    Centers biased to the patch's normalized grid position, sizes to one
    patch, both through an inverse sigmoid with the 1e-4 eps the
    checkpoints were trained with. Row-major over (h, w), matching the patch
    embedding's flatten.
    """
    x = np.arange(1, grid_w + 1, dtype=np.float32) / grid_w
    y = np.arange(1, grid_h + 1, dtype=np.float32) / grid_h
    xx, yy = np.meshgrid(x, y)  # (grid_h, grid_w)
    coords = np.stack([xx, yy], axis=-1).reshape(-1, 2)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    size = np.empty_like(coords)
    size[:, 0] = 1.0 / grid_w
    size[:, 1] = 1.0 / grid_h
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return np.concatenate([coord_bias, size_bias], axis=-1).astype(np.float32)


@functools.cache
def _box_bias_table(grid_h: int, grid_w: int, device: torch.device) -> torch.Tensor:
    """`owlvit_box_bias` as an fp32 tensor on `device`, made once per grid
    and device (a host copy on every forward would make the host wait for
    the stream). Made outside inference mode, so it also serves forwards
    that track gradients. Never evicted: a captured CUDA graph reads it in place."""
    with torch.inference_mode(False):
        return torch.from_numpy(owlvit_box_bias(grid_h, grid_w)).to(device)


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


class OwlViTLayer(nn.Module):
    """Pre-norm CLIP transformer block (ln1 -> attn -> res, ln2 -> mlp -> res)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 hidden_act: str, layer_norm_eps: float, dtype: torch.dtype) -> None:
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.self_attn = MultiHeadAttention(hidden_size, num_heads, dtype=dtype)
        self.layer_norm2 = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.fc1 = QuantDense(hidden_size, intermediate_size, dtype=dtype)
        self.fc2 = QuantDense(intermediate_size, hidden_size, dtype=dtype)
        self.act = get_activation(hidden_act)

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), attention_mask=attention_mask)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


def _layers(cfg, dtype: torch.dtype) -> list[OwlViTLayer]:
    return [
        OwlViTLayer(cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                    cfg.hidden_act, cfg.layer_norm_eps, dtype)
        for _ in range(cfg.num_hidden_layers)
    ]


class OwlViTTextTower(nn.Module):
    """CLIP text transformer -> pooled end-of-text features, (Q, D_text).

    Causal attention plus the padding mask; pooling takes the position of
    the highest token id (CLIP's end-of-text token), the first such
    position in a row, as `jnp.argmax` does.
    """

    def __init__(self, config: OwlViTTextConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.token_embedding = nn.Parameter(torch.zeros(config.vocab_size, config.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(config.max_position_embeddings, config.hidden_size))
        for i, layer in enumerate(_layers(config, dtype)):
            setattr(self, f"layer{i}", layer)
        self.final_layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps, dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, t = input_ids.shape
        ids = input_ids.long()
        x = self.token_embedding[ids].to(self.dtype)
        x = x + self.position_embedding[:t].to(self.dtype)
        # the JAX package's adds, in its order: the causal NEG_INF table, plus
        # the padding NEG_INF per key; where both mask a key the fp32 sum
        # overflows to -inf on both sides
        causal = torch.triu(
            torch.full((t, t), NEG_INF, dtype=torch.float32, device=x.device), diagonal=1)
        mask = causal[None, None]  # (1, 1, T, T)
        if attention_mask is not None:
            pad = torch.where(attention_mask == 0, NEG_INF, 0.0).to(torch.float32)
            mask = mask + pad[:, None, None, :]  # (Q, 1, T, T)
        for i in range(self.config.num_hidden_layers):
            x = getattr(self, f"layer{i}")(x, attention_mask=mask)
        x = self.final_layer_norm(x)
        positions = torch.arange(t, device=ids.device)
        is_max = ids == ids.amax(dim=-1, keepdim=True)
        eot = torch.where(is_max, positions, t).amin(dim=-1)  # first of equal maxima
        return x[torch.arange(q, device=x.device), eot]


class OwlViTVisionTower(nn.Module):
    """CLIP vision transformer -> post-LN token sequence, (B, 1 + P, D_vision)."""

    def __init__(self, config: OwlViTVisionConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        d = config.hidden_size
        self.patch_embedding = PatchEmbed(config.num_channels, d, config.patch_size, dtype,
                                          bias=False)
        # fp32 tables, cast to the compute dtype where they are used (flax
        # keeps them fp32 params and casts at use)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(torch.zeros(config.grid * config.grid + 1, d))
        self.pre_layernorm = LayerNorm(d, config.layer_norm_eps, dtype)
        for i, layer in enumerate(_layers(config, dtype)):
            setattr(self, f"layer{i}", layer)
        self.post_layernorm = LayerNorm(d, config.layer_norm_eps, dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, h, w, _ = pixel_values.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch size {p}")
        if (h // p, w // p) != (cfg.grid, cfg.grid):
            raise ValueError(
                f"input {h}x{w} differs from the trained image size {cfg.image_size}: "
                f"position-table interpolation is not ported"
            )
        dt, d = self.dtype, cfg.hidden_size
        x = self.patch_embedding(pixel_values)
        x = torch.cat([self.class_embedding.to(dt).expand(b, 1, d), x], dim=1)
        x = x + self.position_embedding.to(dt)
        x = self.pre_layernorm(x)
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layer{i}")(x)
        return self.post_layernorm(x)


class OwlViTClassHead(nn.Module):
    """Text-query classifier: cosine logits with a learned per-patch shift
    and scale, NEG_INF for masked queries."""

    def __init__(self, config: OwlViTConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d_vis, d_txt = config.vision.hidden_size, config.text.hidden_size
        self.dense0 = Dense(d_vis, d_txt, dtype=dtype)
        self.logit_shift = Dense(d_vis, 1, dtype=dtype)
        self.logit_scale = Dense(d_vis, 1, dtype=dtype)

    def forward(self, image_feats: torch.Tensor, query_embeds: torch.Tensor,
                query_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        img_cls = self.dense0(image_feats)
        q = _l2_normalize(query_embeds, 1e-6)
        shift = self.logit_shift(image_feats)
        scale = self.logit_scale(image_feats)
        if openvocab.owl_fused_wanted():
            # normalize + cosine product + shift/elu-scale + query mask in
            # one kernel (ops/openvocab.py); the three Denses stay outside
            return owl_class_logits(
                img_cls, q.to(torch.float32).contiguous(), shift[..., 0], scale[..., 0],
                query_mask,
            )
        img_cls = _l2_normalize(img_cls, 1e-6)
        logits = torch.einsum("bpd,qd->bpq", img_cls, q.to(img_cls.dtype))
        scale = F.elu(scale) + 1.0
        logits = (logits + shift) * scale
        if query_mask is not None:
            logits = torch.where(query_mask[None, None, :] == 0, NEG_INF, logits)
        return logits


class OwlViTBoxHead(nn.Module):
    """Box MLP (dense-gelu-dense-gelu-dense) + grid bias + sigmoid in fp32."""

    def __init__(self, config: OwlViTVisionConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        d = config.hidden_size
        self.dense0 = Dense(d, d, dtype=dtype)
        self.dense1 = Dense(d, d, dtype=dtype)
        self.dense2 = Dense(d, 4, dtype=dtype)
        self.act = get_activation("gelu")

    def forward(self, image_feats: torch.Tensor, grid_hw: tuple[int, int]) -> torch.Tensor:
        x = self.act(self.dense0(image_feats))
        x = self.act(self.dense1(x))
        x = self.dense2(x)
        bias = _box_bias_table(*grid_hw, x.device)
        return torch.sigmoid(x.to(torch.float32) + bias)


class ObjectnessHead(nn.Module):
    """OWLv2's objectness predictor: a box-head-shaped MLP -> (B, P) logits
    (HF applies it to detached features; inference has no gradient)."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dense0 = Dense(hidden_size, hidden_size, dtype=dtype)
        self.dense1 = Dense(hidden_size, hidden_size, dtype=dtype)
        self.dense2 = Dense(hidden_size, 1, dtype=dtype)
        self.act = get_activation("gelu")

    def forward(self, image_feats: torch.Tensor) -> torch.Tensor:
        x = self.act(self.dense0(image_feats.detach()))
        x = self.act(self.dense1(x))
        return self.dense2(x)[..., 0]


class OwlViTDetector(nn.Module):
    """OWL-ViT / OWLv2 detector.

    `forward(pixels, query_embeds, query_mask=None)` is the serving forward:
    (B, H, W, C) float pixels and (Q, proj) query embeddings -> {"logits":
    (B, P, Q), "pred_boxes": (B, P, 4) normalized cxcywh, and for OWLv2
    "objectness": (B, P)}, all fp32. `encode_text(input_ids, attention_mask)`
    -> normalized (Q, proj) query embeddings. `detect_with_text` chains both.
    """

    def __init__(self, config: OwlViTConfig, dtype: torch.dtype = torch.float32,
                 vision_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.vision_dtype = vision_dtype or dtype
        self.vision = OwlViTVisionTower(config.vision, dtype=self.vision_dtype)
        self.text = OwlViTTextTower(config.text, dtype=dtype)
        self.text_projection = Dense(config.text.hidden_size, config.projection_dim, bias=False,
                                     dtype=dtype)
        # the detection head's merge LayerNorm (HF: OwlViTForObjectDetection.layer_norm)
        self.merge_layer_norm = LayerNorm(config.vision.hidden_size,
                                          config.vision.layer_norm_eps, dtype)
        self.class_head = OwlViTClassHead(config, dtype=dtype)
        self.box_head = OwlViTBoxHead(config.vision, dtype=dtype)
        if config.objectness:
            self.objectness_head = ObjectnessHead(config.vision.hidden_size, dtype=dtype)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.text_projection(self.text(input_ids, attention_mask))
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def forward(self, pixel_values: torch.Tensor, query_embeds: torch.Tensor,
                query_mask: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
        feats = self.vision(pixel_values)  # (B, 1+P, D)
        image_feats = feats[:, 1:, :] * feats[:, :1, :]  # class-token merge
        image_feats = self.merge_layer_norm(image_feats)
        logits = self.class_head(image_feats, query_embeds, query_mask)
        p = self.config.vision.patch_size
        grid_hw = (pixel_values.shape[1] // p, pixel_values.shape[2] // p)
        out = {"logits": logits.to(torch.float32),
               "pred_boxes": self.box_head(image_feats, grid_hw)}
        if self.config.objectness:
            out["objectness"] = self.objectness_head(image_feats).to(torch.float32)
        return out

    def detect_with_text(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
        return self(pixel_values, self.encode_text(input_ids, attention_mask))
