"""Model registry: MODEL_NAME -> model family (port of spotter_tpu.models.registry).

Families register themselves; lookup is by substring of the HF repo name,
so the same MODEL_NAME values keep working. The port registers all seven
families of the JAX package (models/zoo.py): RT-DETR, YOLOS, OWL-ViT,
Deformable-DETR, DETR (with Table-Transformer), Conditional-DETR and
DAB-DETR, with its match strings.
"""

from dataclasses import dataclass
from typing import Callable

MODEL_REGISTRY: dict[str, "ModelFamily"] = {}


@dataclass(frozen=True)
class ModelFamily:
    """Everything the engine needs to serve one architecture family."""

    name: str
    matches: tuple[str, ...]  # substrings of MODEL_NAME that select this family
    build: Callable  # (model_name, **kwargs) -> BuiltDetector


def register(family: ModelFamily) -> None:
    MODEL_REGISTRY[family.name] = family


def match_score(key: str, matches: tuple[str, ...]):
    """Best (start, -length) score of any pattern inside `key`, or None.

    Lower is better: the pattern that begins earliest in the name wins, and
    among patterns starting at the same offset the longest wins.
    """
    best = None
    for m in matches:
        i = key.find(m)
        if i < 0:
            continue
        score = (i, -len(m))
        if best is None or score < best:
            best = score
    return best


def family_for(model_name: str) -> ModelFamily:
    """Resolve MODEL_NAME to its registered family (most specific match wins)."""
    from spotter_tpu_torch.models import zoo  # noqa: F401  (self-registers families)

    key = model_name.lower()
    best_family, best_score = None, None
    for family in MODEL_REGISTRY.values():
        score = match_score(key, family.matches)
        if score is not None and (best_score is None or score < best_score):
            best_family, best_score = family, score
    if best_family is not None:
        return best_family
    raise ValueError(
        f"MODEL_NAME '{model_name}' does not match any registered family: "
        f"{[f.matches for f in MODEL_REGISTRY.values()]}"
    )


def build_detector(model_name: str, **kwargs):
    """Resolve MODEL_NAME to a built detector (module, specs, labels)."""
    return family_for(model_name).build(model_name, **kwargs)
