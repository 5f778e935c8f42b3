"""A local Hugging Face checkpoint -> (config, flax-named params), for all
seven families (port of spotter_tpu.convert.loader, without its cache).

`load_<family>_from_hf(path)` reads `path`/config.json into the family's
config through its `from_hf` (convert/hf_config.py stands in for
`AutoConfig`), reads the weight file (convert/checkpoint_io.py stands in
for `from_pretrained`), and applies the family's rule table, strictly: a
rule whose key the file holds under neither its own name nor its tied
twin's raises KeyError with the JAX package's text. The params go into a
module with `convert.from_jax.load_from_jax`.

Tied twins: `save_pretrained` writes one copy of a tied weight. The HF
models tie (their `_tied_weights_keys`):
- RT-DETR: `class_embed.*` and `bbox_embed.*` with
  `model.decoder.class_embed.*` and `model.decoder.bbox_embed.*`, and the
  file keeps the decoder's;
- Deformable-DETR with box refinement (and two-stage): the same pairs;
- DAB-DETR: `bbox_predictor.*` with `model.decoder.bbox_embed.*`, and the
  file keeps the decoder's.

`TIED` lists the pairs; a rule's key missing from the file is looked up
under its twin. transformers' load-time renames (`_fix_state_dict_key_on_load`:
`LayerNorm.gamma`/`.beta`, weight-norm `weight_g`/`weight_v`) match no key
of these families' rule tables, so there is nothing to mirror.

Unlike the JAX loader this writes and reads no cache: the JAX cache lets a
serving image drop torch, and the port reads checkpoints with torch.
"""

from spotter_tpu_torch.convert.checkpoint_io import read_checkpoint
from spotter_tpu_torch.convert.conditional_detr_rules import conditional_detr_rules
from spotter_tpu_torch.convert.dab_detr_rules import dab_detr_rules
from spotter_tpu_torch.convert.deformable_detr_rules import deformable_detr_rules
from spotter_tpu_torch.convert.detr_rules import detr_rules
from spotter_tpu_torch.convert.hf_config import HFConfig, read_hf_config
from spotter_tpu_torch.convert.owlvit_rules import owlvit_rules
from spotter_tpu_torch.convert.rtdetr_rules import rtdetr_rules
from spotter_tpu_torch.convert.rules import Rules, convert_state_dict
from spotter_tpu_torch.convert.yolos_rules import yolos_rules
from spotter_tpu_torch.models.configs import (
    ConditionalDetrConfig,
    DabDetrConfig,
    DeformableDetrConfig,
    DetrConfig,
    OwlViTConfig,
    RTDetrConfig,
    YolosConfig,
)

_HEADS = (("class_embed.", "model.decoder.class_embed."),
          ("bbox_embed.", "model.decoder.bbox_embed."))
# family -> (prefix, twin prefix) pairs of weights its HF model ties
TIED = {
    "rtdetr": _HEADS,
    "deformable_detr": _HEADS,
    "dab_detr": (("bbox_predictor.", "model.decoder.bbox_embed."),),
}


def twin_key(key: str, tied) -> str | None:
    """`key` under its tied twin's name, or None if `key` is not tied."""
    for a, b in tied:
        if key.startswith(a):
            return b + key[len(a):]
        if key.startswith(b):
            return a + key[len(b):]
    return None


def resolve_tied(state_dict: dict, rules: Rules, tied) -> dict:
    """`state_dict` plus, for each rule key it lacks whose twin it holds,
    that key bound to the twin's tensor."""
    out = dict(state_dict)
    for _, key, _ in rules.rules:
        twin = twin_key(key, tied)
        if key not in out and twin is not None and twin in out:
            out[key] = out[twin]
    return out


def convert_checkpoint(path, rules: Rules, family: str) -> dict:
    """The weights in `path` through `rules`, tied twins resolved, strictly."""
    state_dict = resolve_tied(read_checkpoint(path), rules, TIED.get(family, ()))
    return convert_state_dict(state_dict, rules, strict=True)


def backbone_naming(hf: HFConfig) -> str:
    """The DETR-lineage rule tables' backbone naming: "timm" for a timm
    backbone (the published checkpoints), else "hf"."""
    return "timm" if hf.use_timm_backbone else "hf"


# the registry's family names -> (config class, rule table of (config, HF
# config view)); DETR's entry serves Table-Transformer too
FAMILIES = {
    "rtdetr": (RTDetrConfig, lambda cfg, hf: rtdetr_rules(cfg)),
    "yolos": (YolosConfig, lambda cfg, hf: yolos_rules(cfg)),
    # the detection path only: visual_projection and logit_scale stay unread
    "owlvit": (OwlViTConfig, lambda cfg, hf: owlvit_rules(cfg)),
    "deformable_detr": (DeformableDetrConfig,
                        lambda cfg, hf: deformable_detr_rules(cfg, backbone_naming(hf))),
    "detr": (DetrConfig, lambda cfg, hf: detr_rules(cfg, backbone_naming(hf))),
    "conditional_detr": (ConditionalDetrConfig,
                         lambda cfg, hf: conditional_detr_rules(cfg, backbone_naming(hf))),
    "dab_detr": (DabDetrConfig, lambda cfg, hf: dab_detr_rules(cfg, backbone_naming(hf))),
}


def read_config(family: str, path):
    """(the family's config, the HF config view) of `path`/config.json."""
    hf = read_hf_config(path)
    return FAMILIES[family][0].from_hf(hf), hf


def load_from_hf(family: str, path) -> tuple:
    """(config, flax-named params) of the `family` checkpoint in `path`."""
    cfg, hf = read_config(family, path)
    return cfg, convert_checkpoint(path, FAMILIES[family][1](cfg, hf), family)


def load_rtdetr_from_hf(path) -> tuple[RTDetrConfig, dict]:
    return load_from_hf("rtdetr", path)


def load_yolos_from_hf(path) -> tuple[YolosConfig, dict]:
    return load_from_hf("yolos", path)


def load_owlvit_from_hf(path) -> tuple[OwlViTConfig, dict]:
    """OWL-ViT and OWLv2."""
    return load_from_hf("owlvit", path)


def load_deformable_detr_from_hf(path) -> tuple[DeformableDetrConfig, dict]:
    return load_from_hf("deformable_detr", path)


def load_detr_from_hf(path) -> tuple[DetrConfig, dict]:
    """DETR and Table-Transformer."""
    return load_from_hf("detr", path)


def load_conditional_detr_from_hf(path) -> tuple[ConditionalDetrConfig, dict]:
    return load_from_hf("conditional_detr", path)


def load_dab_detr_from_hf(path) -> tuple[DabDetrConfig, dict]:
    return load_from_hf("dab_detr", path)
