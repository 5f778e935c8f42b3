"""Model zoo, all seven families (RT-DETR, YOLOS, OWL-ViT, Deformable-DETR,
DETR with Table-Transformer, Conditional-DETR, DAB-DETR): MODEL_NAME ->
BuiltDetector (port of spotter_tpu.models.zoo).

Weights come from one of three sources:
- a MODEL_NAME that names a local directory holding `config.json` and a
  weight file (an HF checkpoint, `save_pretrained`'s layout) builds that
  checkpoint: its config through `from_hf`, its weights through the
  family's rule table (convert/loader.py), its labels from its
  `id2label`. The family still comes from the name (registry.family_for),
  so the directory's path must contain it, as in the JAX package. A
  directory whose weights do not load raises; it never falls back to a
  seeded model;
- otherwise a seeded random init that mirrors flax's initializers
  (`init_rtdetr`, `init_yolos`, `init_owlvit`, `init_deformable_detr`,
  `init_detr`, `init_conditional_detr`, `init_dab_detr`), at the width of
  the preset the name selects;
- or JAX params carried across with `convert.from_jax` (`params=`).
`tiny=True` (or SPOTTER_TPU_TINY=1) builds the zoo's tiny config, as the
JAX package does.

Each build function applies the precision policy (utils/precision.py) as
the JAX zoo does: every family is built at `compute_dtype()` with its
backbone (YOLOS's ViT body, OWL's vision tower) at `backbone_dtype()`. The
seeded init draws fp32 from the seed stream and carried-over params are
cast as they load: into the fp32 masters where flax's param is read at
fp32 by a quantized path (`ConvNorm`, `QuantDense`), else into bf16
weights, so a bf16 model stores what flax casts its fp32 params to at use.
The int8 knobs (utils/quant.py) act when a forward runs. The MSDA families' builders
check SPOTTER_TPU_MSDA and SPOTTER_TPU_MSDA_PRECISION with the JAX
package's error texts; both are read again when a forward runs
(ops/msda.py).
"""

import dataclasses
import os
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from spotter_tpu_torch.convert import loader
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.convert.hf_config import is_checkpoint_dir
from spotter_tpu_torch.convert.tokens import owlvit_tokenize, tiny_tokenize
from spotter_tpu_torch.engine.engine import BuiltDetector
from spotter_tpu_torch.models.coco import coco_id2label_80, coco_id2label_91
from spotter_tpu_torch.models.conditional_detr import ConditionalDetrDetector
from spotter_tpu_torch.models.configs import (
    CONDITIONAL_DETR_PRESETS,
    DAB_DETR_PRESETS,
    DAB_PATTERNS_ERROR,
    DC5_ERROR,
    DEFORMABLE_DETR_PRESETS,
    DETR_PRESETS,
    OWL_PRESETS,
    RTDETR_PRESETS,
    ConditionalDetrConfig,
    DabDetrConfig,
    DeformableDetrConfig,
    DetrConfig,
    OwlViTConfig,
    OwlViTTextConfig,
    OwlViTVisionConfig,
    ResNetConfig,
    RTDetrConfig,
    YolosConfig,
)
from spotter_tpu_torch.models.dab_detr import DabDetrDetector
from spotter_tpu_torch.models.deformable_detr import DeformableDetrDetector
from spotter_tpu_torch.models.detr import DetrDetector
from spotter_tpu_torch.models.layers import FrozenBatchNorm, PReLU, lecun_normal_
from spotter_tpu_torch.models.owlvit import OwlViTDetector
from spotter_tpu_torch.models.registry import ModelFamily, register
from spotter_tpu_torch.models.rtdetr import RTDetrDetector
from spotter_tpu_torch.models.yolos import YolosDetector
from spotter_tpu_torch.ops.msda import (
    MSDA_ENV,
    MSDA_PRECISION_ENV,
    check_msda_backend,
    check_msda_precision,
)
from spotter_tpu_torch.ops.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    DETR_SPEC,
    IMAGENET_MEAN,
    IMAGENET_STD,
    OWLV2_SPEC,
    OWLVIT_SPEC,
    RTDETR_SPEC,
    PreprocessSpec,
)
from spotter_tpu_torch.taxonomy import AMENITIES_MAPPING
from spotter_tpu_torch.utils.precision import backbone_dtype, compute_dtype

TINY_ENV = "SPOTTER_TPU_TINY"


def tiny_rtdetr_config(num_labels: int = 80) -> RTDetrConfig:
    return RTDetrConfig(
        backbone=ResNetConfig(
            embedding_size=16, hidden_sizes=(16, 24, 32, 48), depths=(1, 1, 1, 1),
            layer_type="basic",
        ),
        num_labels=num_labels,
        d_model=32,
        num_queries=30,
        encoder_hidden_dim=32,
        encoder_in_channels=(24, 32, 48),
        encoder_ffn_dim=48,
        decoder_ffn_dim=48,
        encoder_attention_heads=4,
        decoder_attention_heads=4,
        decoder_layers=2,
        decoder_n_points=2,
        id2label=tuple(coco_id2label_80().items()),
    )


def full_width(model_name: str, params: Optional[Mapping], load, preset) -> tuple:
    """(config, params) of a full-width build: the checkpoint's, through
    `load` (a convert.loader function), when MODEL_NAME names a checkpoint
    directory, else the `preset` the name selects with `params` as given. A
    checkpoint brings its own weights, so `params=` beside one raises."""
    if not is_checkpoint_dir(model_name):
        return preset(model_name), params
    if params is not None:
        raise ValueError(f"MODEL_NAME '{model_name}' is a checkpoint directory, which holds "
                         f"its own weights: params= cannot replace them")
    return load(model_name)


def rtdetr_preset(model_name: str) -> RTDetrConfig:
    """The published preset whose name appears in MODEL_NAME, with COCO labels
    (e.g. PekingU/rtdetr_v2_r101vd -> RTDETR_PRESETS["rtdetr_v2_r101vd"])."""
    key = model_name.lower()
    for name, cfg in RTDETR_PRESETS.items():
        if name in key:
            return dataclasses.replace(cfg, id2label=tuple(coco_id2label_80().items()))
    raise ValueError(
        f"MODEL_NAME '{model_name}' names no RT-DETR preset: {sorted(RTDETR_PRESETS)}"
    )


@torch.no_grad()
def _init_flax_layers(model: nn.Module, gen: torch.Generator) -> None:
    """flax's initializers on every conv, dense, LayerNorm, GroupNorm and
    frozen BN of `model`, drawn from `gen` in module order."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            w = torch.empty(module.weight.shape, dtype=torch.float32)
            lecun_normal_(w, fan_in, gen)
            module.weight.copy_(w)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, FrozenBatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)


@torch.no_grad()
def init_rtdetr(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random init from `seed`, mirroring the flax module's initializers:
    lecun-normal conv and dense kernels, zero biases, LayerNorm scale 1,
    identity frozen-BN statistics, normal(1.0) query embeddings. Drawn on
    the CPU from one `torch.Generator` in module order, so the same seed
    gives the same weights whatever device the model later moves to."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    _init_flax_layers(model, gen)
    if isinstance(model, RTDetrDetector) and model.config.learn_initial_query:
        model.query_embed.copy_(torch.randn(model.query_embed.shape, generator=gen))
    return model


def build_rtdetr(
    model_name: str,
    *,
    tiny: Optional[bool] = None,
    seed: int = 0,
    params: Optional[Mapping] = None,
) -> BuiltDetector:
    """RT-DETR family builder, at the policy's two dtypes. The model is
    built on the CPU; the engine moves it to its device."""
    check_msda_backend(os.environ.get(MSDA_ENV, "auto"))
    check_msda_precision(os.environ.get(MSDA_PRECISION_ENV))
    if tiny is None:
        tiny = bool(os.environ.get(TINY_ENV))
    if tiny:
        cfg = tiny_rtdetr_config()
        spec = PreprocessSpec(mode="fixed", size=(64, 64))
    else:
        cfg, params = full_width(model_name, params, loader.load_rtdetr_from_hf, rtdetr_preset)
        spec = RTDETR_SPEC
    model = RTDetrDetector(cfg, dtype=compute_dtype(), backbone_dtype=backbone_dtype()).eval()
    if params is not None:
        load_from_jax(model, params)
    else:
        init_rtdetr(model, seed)
    return BuiltDetector(
        model_name=model_name,
        module=model,
        preprocess_spec=spec,
        postprocess="sigmoid_topk",
        id2label=cfg.id2label_dict,
        num_top_queries=min(300, cfg.num_queries),
    )


def tiny_yolos_config(num_labels: int = 80) -> YolosConfig:
    return YolosConfig(
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=48,
        image_size=(32, 48),
        patch_size=8,
        num_detection_tokens=5,
        num_labels=num_labels,
        id2label=tuple(coco_id2label_80().items()),
    )


def yolos_preset(model_name: str) -> YolosConfig:
    """yolos-base (`YolosConfig()`'s defaults) with the 91 COCO labels. The
    other YOLOS sizes take their widths from a checkpoint's config: a name
    that is not a checkpoint directory raises for them."""
    if "yolos-base" not in model_name.lower():
        raise ValueError(
            f"MODEL_NAME '{model_name}' names no YOLOS preset: only yolos-base (other sizes "
            f"build from a checkpoint directory holding their config.json)"
        )
    return YolosConfig(id2label=tuple(coco_id2label_91().items()))


YOLOS_TOKEN_STD = 0.02  # HF YolosConfig.initializer_range


@torch.no_grad()
def init_yolos(model: YolosDetector, seed: int = 0) -> YolosDetector:
    """Random init from `seed`: flax's initializers (lecun-normal kernels,
    zero biases, LayerNorm scale 1) on every dense, the patch conv and the
    LayerNorms, in module order, as `init_rtdetr` draws them.

    One exception: flax initialises `cls_token`, `detection_tokens`,
    `position_embeddings` and `mid_position_embeddings` to zeros, which
    makes all detection tokens the same row, so every query of a random
    model would predict the same box. Those four are drawn from
    N(0, 0.02^2) instead, from the same generator after the layers, as HF's
    YOLOS init does.
    """
    gen = torch.Generator(device="cpu").manual_seed(seed)
    _init_flax_layers(model, gen)
    for name in ("cls_token", "detection_tokens", "position_embeddings",
                 "mid_position_embeddings"):
        table = getattr(model, name, None)
        if table is not None:
            table.copy_(torch.randn(table.shape, generator=gen) * YOLOS_TOKEN_STD)
    return model


def build_yolos(
    model_name: str,
    *,
    tiny: Optional[bool] = None,
    seed: int = 0,
    params: Optional[Mapping] = None,
) -> BuiltDetector:
    """Builds the YOLOS family. The ViT body runs at the policy's backbone
    dtype (bf16 under "mixed" and "bfloat16"), as the JAX zoo builds it; the
    spec warp-resizes to the config's image size with ImageNet mean/std.
    The model is built on the CPU; the engine moves it to its device."""
    if tiny is None:
        tiny = bool(os.environ.get(TINY_ENV))
    if tiny:
        cfg = tiny_yolos_config()
    else:
        cfg, params = full_width(model_name, params, loader.load_yolos_from_hf, yolos_preset)
    model = YolosDetector(cfg, dtype=backbone_dtype()).eval()
    if params is not None:
        load_from_jax(model, params)
    else:
        init_yolos(model, seed)
    return BuiltDetector(
        model_name=model_name,
        module=model,
        preprocess_spec=PreprocessSpec(
            mode="fixed", size=cfg.image_size, mean=IMAGENET_MEAN, std=IMAGENET_STD
        ),
        postprocess="softmax",
        id2label=cfg.id2label_dict,
        num_top_queries=cfg.num_detection_tokens,
    )


def tiny_owlvit_config() -> OwlViTConfig:
    return OwlViTConfig(
        text=OwlViTTextConfig(
            vocab_size=99, hidden_size=16, intermediate_size=24,
            num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=8,
        ),
        vision=OwlViTVisionConfig(
            hidden_size=20, intermediate_size=28, num_hidden_layers=2,
            num_attention_heads=2, image_size=32, patch_size=8,
        ),
        projection_dim=16,
    )


def owlvit_preset(model_name: str) -> OwlViTConfig:
    """The published base width whose name appears in MODEL_NAME:
    owlvit-base-patch32, owlvit-base-patch16, or owlv2-base-patch16 (and
    its -ensemble and -finetuned checkpoints). The other sizes take their
    widths from a checkpoint's config: a name that is not a checkpoint
    directory raises for them."""
    key = model_name.lower()
    for name, cfg in OWL_PRESETS.items():
        if name in key:
            return cfg
    raise ValueError(
        f"MODEL_NAME '{model_name}' names no OWL-ViT preset: only {sorted(OWL_PRESETS)} "
        f"(other sizes build from a checkpoint directory holding their config.json)"
    )


QUERIES_ENV = "SPOTTER_TPU_TEXT_QUERIES"
PROMPT_TEMPLATE = "a photo of a {}"
OWL_TABLE_STD = 0.02  # flax's normal(0.02) for the token, position and class tables


def owlvit_query_labels() -> list[str]:
    """The deployment's label set: the amenity taxonomy's COCO labels (so
    the AMENITIES_MAPPING filter behaves as with the closed-set detectors),
    or a comma-separated SPOTTER_TPU_TEXT_QUERIES."""
    env = os.environ.get(QUERIES_ENV, "")
    if env.strip():
        labels = [s.strip() for s in env.split(",") if s.strip()]
        if not labels:
            raise ValueError(f"{QUERIES_ENV} is set but contains no labels: {env!r}")
        return labels
    return list(AMENITIES_MAPPING)


@torch.no_grad()
def init_owlvit(model: OwlViTDetector, seed: int = 0) -> OwlViTDetector:
    """Random init from `seed`, mirroring the flax module's initializers:
    lecun-normal dense and patch kernels, zero biases and LayerNorm 1/0 on
    every layer in module order (as `init_rtdetr` draws them), then
    normal(0.02) for the token, position and class tables, from the same
    generator. flax zeroes none of these, so unlike YOLOS nothing differs."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    _init_flax_layers(model, gen)
    for table in (model.text.token_embedding, model.text.position_embedding,
                  model.vision.class_embedding, model.vision.position_embedding):
        table.copy_(torch.randn(table.shape, generator=gen) * OWL_TABLE_STD)
    return model


def build_owlvit(
    model_name: str,
    *,
    tiny: Optional[bool] = None,
    seed: int = 0,
    params: Optional[Mapping] = None,
) -> BuiltDetector:
    """Builds the OWL-ViT family (OWLv2 when the config has objectness).

    The vision tower runs at the policy's backbone dtype and the text tower
    and heads at its compute dtype, as the JAX zoo builds it. The text tower
    runs once here, on the CPU, to encode the deployment's vocabulary
    ("a photo of a {label}"); the engine keeps that bank on its device. The
    returned `text_encoder` encodes a request's own queries on whatever
    device the model then lives on. Full-width builds read the prompts' ids
    from the JAX package's tokenization cache, keyed by MODEL_NAME (a
    checkpoint directory's path too; convert/tokens.py); tiny builds hash
    them. The model is built on the CPU; the engine moves it."""
    if tiny is None:
        tiny = bool(os.environ.get(TINY_ENV))
    labels = owlvit_query_labels()
    if tiny:
        cfg = tiny_owlvit_config()
        spec = PreprocessSpec(mode="fixed", size=(32, 32), mean=CLIP_MEAN, std=CLIP_STD)
    else:
        cfg, params = full_width(model_name, params, loader.load_owlvit_from_hf, owlvit_preset)
        spec = OWLV2_SPEC if cfg.objectness else OWLVIT_SPEC
    t = cfg.text.max_position_embeddings

    def tokenize(prompts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        if tiny:
            return tiny_tokenize(prompts, cfg.text.vocab_size, t)
        return owlvit_tokenize(model_name, prompts, t)

    # the vocabulary's ids before the model: a missing tokenization cache
    # raises before a full-width model is built
    ids, mask = tokenize([PROMPT_TEMPLATE.format(label) for label in labels])
    model = OwlViTDetector(cfg, dtype=compute_dtype(), vision_dtype=backbone_dtype()).eval()
    if params is not None:
        load_from_jax(model, params)
    else:
        init_owlvit(model, seed)

    @torch.inference_mode()
    def encode_ids(ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        device = model.text.token_embedding.device
        embeds = model.encode_text(torch.from_numpy(ids).to(device),
                                   torch.from_numpy(mask).to(device))
        return embeds.to(torch.float32).cpu().numpy()

    def encode_text(queries: list[str]) -> np.ndarray:
        """Query strings -> normalized (Q, proj) float32 embeddings, through
        the same prompt template and text tower as the deployment's
        vocabulary, on the model's current device."""
        return encode_ids(*tokenize([PROMPT_TEMPLATE.format(q) for q in queries]))

    query_embeds = torch.from_numpy(encode_ids(ids, mask))
    return BuiltDetector(
        model_name=model_name,
        module=model,
        preprocess_spec=spec,
        postprocess="sigmoid_max",
        id2label=dict(enumerate(labels)),
        num_top_queries=len(labels),
        query_embeds=query_embeds,
        text_encoder=encode_text,
    )


def tiny_deformable_detr_config(num_labels: int = 80) -> DeformableDetrConfig:
    return DeformableDetrConfig(
        backbone=ResNetConfig(
            embedding_size=8, hidden_sizes=(8, 12, 16, 24), depths=(1, 1, 1, 1),
            layer_type="basic", style="v1", out_indices=(2, 3, 4),
        ),
        num_labels=num_labels,
        d_model=32,
        num_queries=9,
        encoder_layers=1,
        decoder_layers=2,
        encoder_attention_heads=4,
        decoder_attention_heads=4,
        encoder_ffn_dim=48,
        decoder_ffn_dim=48,
        encoder_n_points=2,
        decoder_n_points=2,
        with_box_refine=True,
        id2label=tuple(coco_id2label_80().items()),
    )


# the tiny config's spec: shortest edge 48 (long side at most 64) in a
# 64x64 bucket
TINY_DETR_SPEC = PreprocessSpec(
    mode="shortest_edge", size=(48, 64), mean=IMAGENET_MEAN, std=IMAGENET_STD, pad_to=(64, 64)
)


def deformable_detr_preset(model_name: str) -> DeformableDetrConfig:
    """The published SenseTime/deformable-detr* configuration whose name
    MODEL_NAME ends in (the longest that matches: -with-box-refine-two-stage
    before -with-box-refine), with the 91 COCO labels. The dilated -dc5
    checkpoints raise, as the JAX package refuses a dilated backbone."""
    key = model_name.lower().replace("_", "-").rstrip("/")
    if "dc5" in key:
        raise ValueError(
            f"MODEL_NAME '{model_name}': dilated (dc5) backbones are not supported")
    for name in sorted(DEFORMABLE_DETR_PRESETS, key=len, reverse=True):
        if key.endswith(name):
            return dataclasses.replace(
                DEFORMABLE_DETR_PRESETS[name], id2label=tuple(coco_id2label_91().items()))
    raise ValueError(
        f"MODEL_NAME '{model_name}' names no Deformable-DETR preset: "
        f"{sorted(DEFORMABLE_DETR_PRESETS)}"
    )


@torch.no_grad()
def init_deformable_detr(model: DeformableDetrDetector, seed: int = 0) -> DeformableDetrDetector:
    """Random init from `seed`, mirroring the flax module's initializers:
    lecun-normal conv and dense kernels, zero biases, LayerNorm and
    GroupNorm scale 1, identity frozen-BN statistics (in module order, as
    `init_rtdetr` draws them), then normal(1.0) level embeddings and, without
    two-stage, normal(1.0) query embeddings, from the same generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    _init_flax_layers(model, gen)
    model.level_embed.copy_(torch.randn(model.level_embed.shape, generator=gen))
    if not model.config.two_stage:
        model.query_embeddings.copy_(torch.randn(model.query_embeddings.shape, generator=gen))
    return model


def build_deformable_detr(
    model_name: str,
    *,
    tiny: Optional[bool] = None,
    seed: int = 0,
    params: Optional[Mapping] = None,
) -> BuiltDetector:
    """Deformable-DETR family builder: the shortest-edge spec (the 1333x1333
    bucket with a pixel mask; tiny: 48/64 in 64x64), the sigmoid top-k
    postprocess at HF's top_k = 100, at the policy's two dtypes. The model
    is built on the CPU; the engine moves it to its device."""
    check_msda_backend(os.environ.get(MSDA_ENV, "auto"))
    check_msda_precision(os.environ.get(MSDA_PRECISION_ENV))
    if tiny is None:
        tiny = bool(os.environ.get(TINY_ENV))
    if tiny:
        cfg = tiny_deformable_detr_config()
    else:
        cfg, params = full_width(model_name, params, loader.load_deformable_detr_from_hf,
                                 deformable_detr_preset)
    model = DeformableDetrDetector(
        cfg, dtype=compute_dtype(), backbone_dtype=backbone_dtype()).eval()
    if params is not None:
        load_from_jax(model, params)
    else:
        init_deformable_detr(model, seed)
    return BuiltDetector(
        model_name=model_name,
        module=model,
        preprocess_spec=TINY_DETR_SPEC if tiny else DETR_SPEC,
        postprocess="sigmoid_topk",
        id2label=cfg.id2label_dict,
        num_top_queries=min(100, cfg.num_queries),
        needs_mask=True,
    )


# --- the DETR lineage: DETR with Table-Transformer, Conditional-DETR, DAB-DETR


def _tiny_lineage_kwargs(num_labels: int) -> dict:
    """The JAX zoo's tiny DETR-lineage widths (its three tiny configs share
    them): a 4-stage basic "v1" ResNet of 8-24 channels, d_model 32, 9
    queries, one encoder and two decoder layers of 4 heads."""
    return dict(
        backbone=ResNetConfig(
            embedding_size=8, hidden_sizes=(8, 12, 16, 24), depths=(1, 1, 1, 1),
            layer_type="basic", style="v1", out_indices=(4,),
        ),
        num_labels=num_labels,
        d_model=32,
        num_queries=9,
        encoder_layers=1,
        decoder_layers=2,
        encoder_attention_heads=4,
        decoder_attention_heads=4,
        encoder_ffn_dim=48,
        decoder_ffn_dim=48,
        id2label=tuple(coco_id2label_80().items()),
    )


def tiny_detr_config(num_labels: int = 80) -> DetrConfig:
    return DetrConfig(**_tiny_lineage_kwargs(num_labels))


def tiny_conditional_detr_config(num_labels: int = 80) -> ConditionalDetrConfig:
    return ConditionalDetrConfig(**_tiny_lineage_kwargs(num_labels))


def tiny_dab_detr_config(num_labels: int = 80) -> DabDetrConfig:
    return DabDetrConfig(**_tiny_lineage_kwargs(num_labels))


def _lineage_preset(model_name: str, presets: dict, family: str):
    """The preset whose name MODEL_NAME contains (the longest that matches),
    with the 91 COCO labels unless the preset has its own. Dilated (-dc5)
    checkpoints raise with the JAX package's text."""
    key = model_name.lower().replace("_", "-")
    if "dc5" in key:
        raise ValueError(DC5_ERROR)
    for name in sorted(presets, key=len, reverse=True):
        if name in key:
            cfg = presets[name]
            if cfg.id2label:
                return cfg
            return dataclasses.replace(cfg, id2label=tuple(coco_id2label_91().items()))
    raise ValueError(f"MODEL_NAME '{model_name}' names no {family} preset: {sorted(presets)}")


def detr_preset(model_name: str) -> DetrConfig:
    """facebook/detr-resnet-50 and -101, microsoft/table-transformer-detection
    and -structure-recognition (pre-norm, ResNet-18, their own labels)."""
    return _lineage_preset(model_name, DETR_PRESETS, "DETR")


def conditional_detr_preset(model_name: str) -> ConditionalDetrConfig:
    """microsoft/conditional-detr-resnet-50."""
    return _lineage_preset(model_name, CONDITIONAL_DETR_PRESETS, "Conditional-DETR")


def dab_detr_preset(model_name: str) -> DabDetrConfig:
    """IDEA-Research/dab-detr-resnet-50. The -pat3 checkpoints (pattern
    embeddings) raise with the JAX package's text."""
    key = model_name.lower()
    if "pat3" in key and "dc5" not in key:  # the JAX package refuses dilation first
        raise ValueError(DAB_PATTERNS_ERROR)
    return _lineage_preset(model_name, DAB_DETR_PRESETS, "DAB-DETR")


@torch.no_grad()
def _init_lineage(model: nn.Module, seed: int, table: nn.Parameter) -> nn.Module:
    """flax's initializers on every layer in module order (as `init_rtdetr`
    draws them), then normal(1.0) for the query table, then 0.25 for every
    PReLU slope, from one generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    _init_flax_layers(model, gen)
    table.copy_(torch.randn(table.shape, generator=gen))
    for module in model.modules():
        if isinstance(module, PReLU):
            module.weight.fill_(0.25)
    return model


def init_detr(model: DetrDetector, seed: int = 0) -> DetrDetector:
    """Random init from `seed`: flax's layer initializers, normal(1.0) `query_pos`."""
    return _init_lineage(model, seed, model.query_pos)


def init_conditional_detr(model: ConditionalDetrDetector, seed: int = 0) -> ConditionalDetrDetector:
    """Random init from `seed`: flax's layer initializers, normal(1.0) `query_pos`."""
    return _init_lineage(model, seed, model.query_pos)


def init_dab_detr(model: DabDetrDetector, seed: int = 0) -> DabDetrDetector:
    """Random init from `seed`: flax's layer initializers, normal(1.0)
    `query_refpoints` and 0.25 for each PReLU."""
    return _init_lineage(model, seed, model.query_refpoints)


def _build_lineage(model_name, *, tiny, seed, params, tiny_config, preset, load,
                   detector, init, postprocess, num_top_queries) -> BuiltDetector:
    """A DETR-lineage builder: the shortest-edge spec with a pixel mask (the
    1333x1333 bucket; tiny: 48/64 in 64x64), at the policy's two dtypes.
    The model is built on the CPU; the engine moves it to its device."""
    if tiny is None:
        tiny = bool(os.environ.get(TINY_ENV))
    if tiny:
        cfg = tiny_config()
    else:
        cfg, params = full_width(model_name, params, load, preset)
    model = detector(cfg, dtype=compute_dtype(), backbone_dtype=backbone_dtype()).eval()
    if params is not None:
        load_from_jax(model, params)
    else:
        init(model, seed)
    return BuiltDetector(
        model_name=model_name,
        module=model,
        preprocess_spec=TINY_DETR_SPEC if tiny else DETR_SPEC,
        postprocess=postprocess,
        id2label=cfg.id2label_dict,
        num_top_queries=num_top_queries(cfg),
        needs_mask=True,
    )


def build_detr(model_name: str, *, tiny: Optional[bool] = None, seed: int = 0,
               params: Optional[Mapping] = None) -> BuiltDetector:
    """DETR and Table-Transformer: the softmax postprocess ("no object" last)
    over every query."""
    return _build_lineage(
        model_name, tiny=tiny, seed=seed, params=params,
        tiny_config=tiny_detr_config, preset=detr_preset, load=loader.load_detr_from_hf,
        detector=DetrDetector,
        init=init_detr, postprocess="softmax", num_top_queries=lambda cfg: cfg.num_queries)


def build_conditional_detr(model_name: str, *, tiny: Optional[bool] = None, seed: int = 0,
                           params: Optional[Mapping] = None) -> BuiltDetector:
    """Conditional-DETR: the sigmoid top-k at HF's top_k = 100."""
    return _build_lineage(
        model_name, tiny=tiny, seed=seed, params=params,
        tiny_config=tiny_conditional_detr_config, preset=conditional_detr_preset,
        load=loader.load_conditional_detr_from_hf, detector=ConditionalDetrDetector, init=init_conditional_detr,
        postprocess="sigmoid_topk", num_top_queries=lambda cfg: min(100, cfg.num_queries))


def build_dab_detr(model_name: str, *, tiny: Optional[bool] = None, seed: int = 0,
                   params: Optional[Mapping] = None) -> BuiltDetector:
    """DAB-DETR: the sigmoid top-k at the top_k = 100 of the processor its
    checkpoints pair with (ConditionalDetrImageProcessor)."""
    return _build_lineage(
        model_name, tiny=tiny, seed=seed, params=params,
        tiny_config=tiny_dab_detr_config, preset=dab_detr_preset,
        load=loader.load_dab_detr_from_hf, detector=DabDetrDetector,
        init=init_dab_detr, postprocess="sigmoid_topk",
        num_top_queries=lambda cfg: min(100, cfg.num_queries))


register(ModelFamily(name="rtdetr", matches=("rtdetr", "rt_detr", "rt-detr"), build=build_rtdetr))
register(ModelFamily(name="yolos", matches=("yolos",), build=build_yolos))
register(ModelFamily(
    name="owlvit",  # OWL-ViT and OWLv2 (the same architecture + an objectness head)
    matches=("owlvit", "owl-vit", "owl_vit", "owlv2", "owl-v2", "owl_v2"),
    build=build_owlvit,
))
register(ModelFamily(
    name="deformable_detr", matches=("deformable-detr", "deformable_detr"),
    build=build_deformable_detr,
))
# JAX's match strings; "dab-detr-resnet-50" also contains "detr-resnet", and
# family_for's earliest-start-then-longest rule picks dab_detr for it
register(ModelFamily(
    name="conditional_detr", matches=("conditional-detr", "conditional_detr"),
    build=build_conditional_detr,
))
register(ModelFamily(name="dab_detr", matches=("dab-detr", "dab_detr"), build=build_dab_detr))
register(ModelFamily(
    name="detr",  # plain DETR, and Table-Transformer (a pre-norm DETR)
    matches=("detr-resnet", "detr_resnet", "table-transformer", "table_transformer"),
    build=build_detr,
))
