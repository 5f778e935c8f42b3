"""Write a port model as a Hugging Face checkpoint directory: the fixture
that proves the checkpoint loader (convert/loader.py) without a download.

`write_checkpoint(model, family, directory)` writes what `save_pretrained`
of the matching HF model would write for the weights the family's rule
table reads:

- the weights, by inverting the two steps a load takes: each port tensor
  back to its flax leaf (`convert.from_jax`'s rename and layout, reversed),
  then each flax leaf back to its HF key and layout (the rule table's
  `_transform`, reversed). Every port key must be reached by the table;
- tied twins as `save_pretrained` leaves them: RT-DETR's `class_embed.*` /
  `bbox_embed.*` and DAB-DETR's `bbox_predictor.*` are written under their
  decoder twins' names only; Deformable-DETR with box refinement keeps both
  copies in `pytorch_model.bin` and, as `save_pretrained` does, refuses
  safetensors (the two copies share storage);
- as `model.safetensors` (the port's own writer, convert/checkpoint_io.py),
  as `shards` safetensors files with `model.safetensors.index.json`, or as
  `pytorch_model.bin`;
- `config.json` with the keys the published checkpoint's config carries for
  `from_hf` (its `model_type`, widths, backbone and labels). The
  DETR-lineage backbones that are a timm ResNet (every published one) are
  written as timm's (`use_timm_backbone`, its name, timm's key names);
  others as HF's ResNet.

It is not a serving path.
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from spotter_tpu_torch.convert import checkpoint_io
from spotter_tpu_torch.convert.hf_config import CONFIG_FILE
from spotter_tpu_torch.convert.loader import FAMILIES, TIED, twin_key
from spotter_tpu_torch.convert.rules import Rules
from spotter_tpu_torch.models.configs import (
    _TIMM_RESNET_PRESETS,
    ResNetConfig,
    timm_resnet_backbone,
)


def timm_name(backbone: ResNetConfig) -> str | None:
    """The timm ResNet `backbone` is (at its own taps), or None."""
    for name in _TIMM_RESNET_PRESETS:
        if dataclasses.replace(timm_resnet_backbone(name),
                               out_indices=backbone.out_indices) == backbone:
            return name
    return None


def rule_table(family: str, cfg) -> Rules:
    """The family's rule table for `cfg`, with the backbone naming the
    written config declares (timm's for a timm ResNet)."""
    backbone = getattr(cfg, "backbone", None)
    timm = backbone is not None and timm_name(backbone) is not None
    return FAMILIES[family][1](cfg, SimpleNamespace(use_timm_backbone=timm))


def port_key(flax_path: tuple) -> str:
    """The port's state-dict key of a flax leaf (`from_jax._rename`'s names)."""
    *parent, leaf = flax_path
    leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(leaf, leaf)
    return ".".join((*parent, leaf))


def flax_leaf(flax_path: tuple, value: torch.Tensor) -> torch.Tensor:
    """A port tensor in its flax leaf's layout: a conv kernel OIHW -> HWIO,
    a dense kernel (out, in) -> (in, out) (from_jax's layout, reversed)."""
    if flax_path[-1] == "kernel":
        return value.permute(2, 3, 1, 0) if value.dim() == 4 else value.t()
    return value


def hf_tensor(value: torch.Tensor, kind: str) -> torch.Tensor:
    """A flax leaf in its HF layout: the rule kind's `_transform`, reversed."""
    if kind == "conv":
        return value.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "dense":
        return value.t()
    return value


def hf_state_dict(model: nn.Module, rules: Rules) -> dict[str, torch.Tensor]:
    """The HF tensors `rules` reads, made from `model`'s state dict. Raises
    ValueError when the table and the module disagree on any key."""
    state = model.state_dict()
    out, used = {}, set()
    for flax_path, key, kind in rules.rules:
        name = port_key(flax_path)
        if name not in state:
            raise ValueError(f"rule for {key} names {name}, which the model lacks")
        used.add(name)
        out[key] = hf_tensor(flax_leaf(flax_path, state[name]), kind).contiguous()
    unused = sorted(set(state) - used)
    if unused:
        raise ValueError(f"model keys no rule reads: {unused[:10]} ({len(unused)} total)")
    return out


def saved_tensors(family: str, cfg, tensors: dict, fmt: str) -> dict[str, torch.Tensor]:
    """`tensors` keyed as `save_pretrained` writes them (see the module doc)."""
    if family in ("rtdetr", "dab_detr"):  # the decoder's twin is the copy kept
        return {twin_key(k, TIED[family]) or k: v for k, v in tensors.items()}
    if family == "deformable_detr" and cfg.with_box_refine:
        if fmt != "bin":
            raise ValueError("Deformable-DETR with box refinement shares its heads with the "
                             "decoder; save_pretrained writes it as pytorch_model.bin only")
        twins = ("bbox_embed.", "class_embed.") if cfg.two_stage else ("bbox_embed.",)
        out = dict(tensors)
        for k, v in tensors.items():
            if k.startswith(twins):
                out[twin_key(k, TIED[family])] = v
        return out
    return dict(tensors)


def resnet_config(backbone: ResNetConfig) -> dict:
    """A ResNet's HF backbone config: RTDetrResNetConfig for the "d" style,
    ResNetConfig for "v1"."""
    stages = ["stem"] + [f"stage{i}" for i in range(1, len(backbone.depths) + 1)]
    return {
        "model_type": "rt_detr_resnet" if backbone.style == "d" else "resnet",
        "num_channels": backbone.num_channels, "embedding_size": backbone.embedding_size,
        "hidden_sizes": list(backbone.hidden_sizes), "depths": list(backbone.depths),
        "layer_type": backbone.layer_type, "hidden_act": backbone.hidden_act,
        "downsample_in_first_stage": backbone.downsample_in_first_stage,
        "downsample_in_bottleneck": backbone.downsample_in_bottleneck,
        "out_indices": list(backbone.out_indices),
        "out_features": [stages[i] for i in backbone.out_indices],
    }


def labels(cfg) -> dict:
    id2label = {str(k): v for k, v in cfg.id2label}
    return {"id2label": id2label, "label2id": {v: int(k) for k, v in id2label.items()}}


def _fields(cfg, names) -> dict:
    out = {}
    for name in names:
        value = getattr(cfg, name)
        out[name] = list(value) if isinstance(value, tuple) else value
    return out


def lineage_backbone_config(backbone: ResNetConfig) -> dict:
    name = timm_name(backbone)
    if name is not None:
        return {"use_timm_backbone": True, "backbone": name, "dilation": False}
    return {"use_timm_backbone": False, "backbone": None,
            "backbone_config": resnet_config(backbone)}


_LINEAGE_FIELDS = ("num_queries", "encoder_layers", "decoder_layers", "encoder_attention_heads",
                   "decoder_attention_heads", "encoder_ffn_dim", "decoder_ffn_dim",
                   "activation_function")


def config_json(family: str, cfg) -> dict:
    """The config.json of a checkpoint holding `cfg`."""
    if family == "rtdetr":
        model_type = "rt_detr_v2" if cfg.version == 2 else "rt_detr"
        out = {"model_type": model_type, "use_timm_backbone": False, "backbone": None,
               "backbone_config": resnet_config(cfg.backbone),
               **_fields(cfg, (
                   "d_model", "num_queries", "encoder_hidden_dim", "encoder_in_channels",
                   "feat_strides", "encoder_ffn_dim", "encode_proj_layers", "encoder_layers",
                   "encoder_attention_heads", "encoder_activation_function",
                   "activation_function", "hidden_expansion", "positional_encoding_temperature",
                   "decoder_ffn_dim", "num_feature_levels", "decoder_n_points",
                   "decoder_layers", "decoder_attention_heads", "decoder_activation_function",
                   "learn_initial_query", "layer_norm_eps", "batch_norm_eps")),
               **labels(cfg)}
        if cfg.version == 2:
            out.update(_fields(cfg, ("decoder_offset_scale", "decoder_method")))
        return out
    if family == "yolos":
        return {"model_type": "yolos", **_fields(cfg, (
            "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
            "hidden_act", "image_size", "patch_size", "num_channels", "num_detection_tokens",
            "use_mid_position_embeddings", "qkv_bias", "layer_norm_eps")), **labels(cfg)}
    if family == "owlvit":
        model_type = "owlv2" if cfg.objectness else "owlvit"
        text = dataclasses.asdict(cfg.text)
        vision = dataclasses.asdict(cfg.vision)
        return {"model_type": model_type, "projection_dim": cfg.projection_dim,
                "text_config": {"model_type": f"{model_type}_text_model", **text},
                "vision_config": {"model_type": f"{model_type}_vision_model", **vision}}
    out = lineage_backbone_config(cfg.backbone)
    if family == "deformable_detr":
        out.update(model_type="deformable_detr", d_model=cfg.d_model,
                   position_embedding_type="sine", **_fields(cfg, _LINEAGE_FIELDS + (
                       "num_feature_levels", "encoder_n_points", "decoder_n_points",
                       "with_box_refine", "two_stage", "two_stage_num_proposals")))
    elif family == "detr":
        out.update(model_type="table-transformer" if cfg.pre_norm else "detr",
                   d_model=cfg.d_model, **_fields(cfg, _LINEAGE_FIELDS))
    elif family == "conditional_detr":
        out.update(model_type="conditional_detr", d_model=cfg.d_model,
                   **_fields(cfg, _LINEAGE_FIELDS))
    elif family == "dab_detr":
        out.update(model_type="dab-detr", hidden_size=cfg.d_model, num_patterns=0,
                   normalize_before=False, **_fields(cfg, _LINEAGE_FIELDS + (
                       "query_dim", "temperature_height", "temperature_width",
                       "keep_query_pos")))
    else:
        raise ValueError(f"no checkpoint layout for family {family!r}")
    out.update(labels(cfg))
    return out


def write_checkpoint(model: nn.Module, family: str, directory, fmt: str = "safetensors",
                     shards: int = 1) -> dict:
    """Write `model` (of the registry family `family`) into `directory` as
    an HF checkpoint. Returns {"files", "bytes", "keys"}."""
    cfg = model.config
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tensors = saved_tensors(family, cfg, hf_state_dict(model, rule_table(family, cfg)), fmt)
    (directory / CONFIG_FILE).write_text(
        json.dumps(config_json(family, cfg), indent=2, sort_keys=True))
    files = []
    if fmt == "bin":
        path = directory / checkpoint_io.TORCH_BIN
        torch.save({k: v.detach().cpu() for k, v in tensors.items()}, path)
        files.append(path)
    elif fmt == "safetensors" and shards == 1:
        path = directory / checkpoint_io.SAFETENSORS
        checkpoint_io.write_safetensors(path, tensors, {"format": "pt"})
        files.append(path)
    elif fmt == "safetensors":
        keys = sorted(tensors)
        weight_map = {}
        for i, part in enumerate(np.array_split(np.arange(len(keys)), shards)):
            name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
            chunk = {keys[j]: tensors[keys[j]] for j in part}
            checkpoint_io.write_safetensors(directory / name, chunk, {"format": "pt"})
            weight_map.update(dict.fromkeys(chunk, name))
            files.append(directory / name)
        index = directory / checkpoint_io.SAFETENSORS_INDEX
        index.write_text(json.dumps({"metadata": {}, "weight_map": weight_map}, indent=2))
        files.append(index)
    else:
        raise ValueError(f"unknown checkpoint format {fmt!r}: safetensors or bin")
    files.append(directory / CONFIG_FILE)
    return {"files": [f.name for f in files], "bytes": sum(f.stat().st_size for f in files),
            "keys": len(tensors)}
