"""Model zoo, RT-DETR family: MODEL_NAME -> BuiltDetector (port of the
RT-DETR part of spotter_tpu.models.zoo).

Weights are either a seeded random init that mirrors flax's initializers
(`init_rtdetr`), at the width of the preset the name selects, or JAX params
carried across with `convert.from_jax` (`params=`). Loading a local HF
checkpoint is not ported yet. `tiny=True` (or SPOTTER_TPU_TINY=1) builds
the zoo's tiny config at a 64x64 spec, as the JAX package does.
"""

import dataclasses
import os
from typing import Mapping, Optional

import torch
from torch import nn

from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.engine.engine import BuiltDetector
from spotter_tpu_torch.models.coco import coco_id2label_80
from spotter_tpu_torch.models.configs import RTDETR_PRESETS, ResNetConfig, RTDetrConfig
from spotter_tpu_torch.models.layers import FrozenBatchNorm, lecun_normal_
from spotter_tpu_torch.models.registry import ModelFamily, register
from spotter_tpu_torch.models.rtdetr import RTDetrDetector
from spotter_tpu_torch.ops.preprocess import RTDETR_SPEC, PreprocessSpec

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
def init_rtdetr(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random init from `seed`, mirroring the flax module's initializers:
    lecun-normal conv and dense kernels, zero biases, LayerNorm scale 1,
    identity frozen-BN statistics, normal(1.0) query embeddings. Drawn on
    the CPU from one `torch.Generator` in module order, so the same seed
    gives the same weights whatever device the model later moves to."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            w = torch.empty(module.weight.shape, dtype=torch.float32)
            lecun_normal_(w, fan_in, gen)
            module.weight.copy_(w)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, FrozenBatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
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
    """RT-DETR family builder. The model is built on the CPU; the engine
    moves it to its device."""
    if tiny is None:
        tiny = bool(os.environ.get(TINY_ENV))
    if tiny:
        cfg = tiny_rtdetr_config()
        spec = PreprocessSpec(mode="fixed", size=(64, 64))
    else:
        cfg = rtdetr_preset(model_name)
        spec = RTDETR_SPEC
    model = RTDetrDetector(cfg).eval()
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


register(ModelFamily(name="rtdetr", matches=("rtdetr", "rt_detr", "rt-detr"), build=build_rtdetr))
