"""Token ids for OWL-ViT's text queries, with no tokenizer in the process.

`owlvit_tokenize` reads the JAX package's tokenization cache: the file
`$SPOTTER_TPU_CACHE/<model, "/" -> "--">--v3/tokenized.json` (default cache
`~/.cache/spotter_tpu`), a JSON object mapping each prompt to its CLIP ids
and attention mask, padded to the text tower's length:

    {"a photo of a tv": {"ids": [49406, <body ids>, 49407, 0, ..., 0],
                         "mask": [1, 1, ..., 1, 0, ..., 0]}}

(CLIP's begin- and end-of-text ids, then padding, `max_length` long; the
mask covers begin-of-text through end-of-text.)

A deployment bakes that file when it builds its image (the JAX package's
`owlvit_tokenize` writes it with HF's tokenizer). Where the JAX package
imports `transformers` for a prompt the file lacks, the port raises: it
fetches nothing and has no fallback. `tiny_tokenize` is the tiny build's
hashed pseudo-tokenizer, a copy of the JAX zoo's `_tiny_tokenize`.
"""

import hashlib
import json
import os
from pathlib import Path

import numpy as np

CACHE_ENV = "SPOTTER_TPU_CACHE"
DEFAULT_CACHE = "~/.cache/spotter_tpu"
CACHE_VERSION = "v3"  # the JAX package's cache layout version


def tokenization_path(model_name: str) -> Path:
    """Where the JAX package keeps `model_name`'s tokenization cache."""
    root = Path(os.environ.get(CACHE_ENV, DEFAULT_CACHE)).expanduser()
    return root / f"{model_name.replace('/', '--')}--{CACHE_VERSION}" / "tokenized.json"


def owlvit_tokenize(
    model_name: str, prompts: list[str], max_length: int
) -> tuple[np.ndarray, np.ndarray]:
    """Prompts -> (ids (Q, T) int32, mask (Q, T) int32) from the cache file.

    Raises ValueError naming the file and the prompts it lacks (or that the
    file is missing or unreadable), and when a row is not `max_length` long.
    """
    path = tokenization_path(model_name)
    try:
        table = json.loads(path.read_text())
    except FileNotFoundError:
        raise ValueError(
            f"no tokenization cache at {path}: the port has no tokenizer, so every "
            f"prompt's ids must be baked there ({len(prompts)} prompts asked for)"
        ) from None
    except (OSError, json.JSONDecodeError) as exc:
        raise ValueError(f"unreadable tokenization cache at {path}: {exc}") from None
    missing = [p for p in prompts if p not in table]
    if missing:
        raise ValueError(
            f"tokenization cache {path} has no ids for {missing}: the port has no "
            f"tokenizer, so these prompts must be baked into it"
        )
    ids = np.asarray([table[p]["ids"] for p in prompts], dtype=np.int32)
    mask = np.asarray([table[p]["mask"] for p in prompts], dtype=np.int32)
    if ids.shape != (len(prompts), max_length) or mask.shape != ids.shape:
        raise ValueError(
            f"tokenization cache {path}: expected rows of {max_length} ids and mask "
            f"entries, got {ids.shape} and {mask.shape}"
        )
    return ids, mask


def tiny_tokenize(prompts: list[str], vocab_size: int, t: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic pseudo-tokenizer for the tiny OWL-ViT: each prompt
    hashes to a stable token sequence, so the same query string encodes the
    same way in every process (and in both packages)."""
    rows = []
    for p in prompts:
        seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[:8], "little")
        rng = np.random.default_rng(seed)
        rows.append(rng.integers(1, vocab_size, (t,)))
    ids = np.stack(rows).astype(np.int32)
    return ids, np.ones_like(ids)
