"""HF state dict -> the flax-named param tree the port's modules load (copy
of spotter_tpu.convert.torch_to_jax, numpy only).

A rule maps a flax param path to (HF key, kind):
- "conv":  OIHW -> HWIO transpose
- "dense": (out, in) -> (in, out) transpose
- "vec":   copy (biases, norm stats, embeddings, tables)

Rule tables are built from the model config, so every variant of an
architecture (r18 vs r101, 3 vs 6 decoder layers) comes from one builder.
The tree is what `convert.from_jax.load_from_jax` carries into a module, as
it carries the JAX package's params. One difference from the JAX copy: a
torch tensor is widened to float32 in torch before it becomes numpy, so
F16 and BF16 checkpoints convert too (numpy has no bfloat16); the values
are the same, since the widening is exact.
"""

from typing import Iterable

import numpy as np

FlaxPath = tuple[str, ...]
Rule = tuple[FlaxPath, str, str]


class Rules:
    """Accumulates (flax_path, torch_key, kind) with helpers for common blocks."""

    def __init__(self) -> None:
        self.rules: list[Rule] = []

    def add(self, flax_path: Iterable[str], torch_key: str, kind: str = "vec") -> None:
        self.rules.append((tuple(flax_path), torch_key, kind))

    def conv(self, flax_prefix: Iterable[str], torch_key: str) -> None:
        self.add((*flax_prefix, "kernel"), torch_key, "conv")

    def dense(self, flax_prefix: Iterable[str], torch_prefix: str, bias: bool = True) -> None:
        self.add((*flax_prefix, "kernel"), f"{torch_prefix}.weight", "dense")
        if bias:
            self.add((*flax_prefix, "bias"), f"{torch_prefix}.bias")

    def layernorm(self, flax_prefix: Iterable[str], torch_prefix: str) -> None:
        self.add((*flax_prefix, "scale"), f"{torch_prefix}.weight")
        self.add((*flax_prefix, "bias"), f"{torch_prefix}.bias")

    def batchnorm(self, flax_prefix: Iterable[str], torch_prefix: str) -> None:
        self.add((*flax_prefix, "scale"), f"{torch_prefix}.weight")
        self.add((*flax_prefix, "bias"), f"{torch_prefix}.bias")
        self.add((*flax_prefix, "mean"), f"{torch_prefix}.running_mean")
        self.add((*flax_prefix, "var"), f"{torch_prefix}.running_var")

    def conv_norm(
        self,
        flax_prefix: Iterable[str],
        torch_conv: str,
        torch_bn: str,
    ) -> None:
        """Our ConvNorm module: {conv: {kernel}, bn: {scale, bias, mean, var}}."""
        flax_prefix = tuple(flax_prefix)
        self.conv((*flax_prefix, "conv"), f"{torch_conv}.weight")
        self.batchnorm((*flax_prefix, "bn"), torch_bn)

    def attention(self, flax_prefix: Iterable[str], torch_prefix: str) -> None:
        """MultiHeadAttention with separate q/k/v/out projections."""
        flax_prefix = tuple(flax_prefix)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.dense((*flax_prefix, proj), f"{torch_prefix}.{proj}")

    def mlp_head(self, flax_prefix: Iterable[str], torch_prefix: str, num_layers: int) -> None:
        """MLPHead layers <- torch RTDetr/Detr MLPPredictionHead .layers.{i}."""
        flax_prefix = tuple(flax_prefix)
        for i in range(num_layers):
            self.dense((*flax_prefix, f"layer{i}"), f"{torch_prefix}.layers.{i}")


def _transform(value: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(value, (2, 3, 1, 0))  # OIHW -> HWIO
    if kind == "dense":
        return np.transpose(value)
    if kind == "vec":
        return value
    raise ValueError(f"Unknown rule kind: {kind}")


def convert_state_dict(
    state_dict: dict, rules: Rules, strict: bool = True
) -> dict:
    """Apply rules to a torch state_dict (tensors or numpy arrays) -> nested
    Flax params dict."""
    params: dict = {}
    missing = []
    for flax_path, torch_key, kind in rules.rules:
        if torch_key not in state_dict:
            missing.append(torch_key)
            continue
        value = state_dict[torch_key]
        if hasattr(value, "detach"):  # torch tensor without importing torch
            value = value.detach().cpu().float().numpy()
        value = _transform(np.asarray(value, dtype=np.float32), kind)
        node = params
        for part in flax_path[:-1]:
            node = node.setdefault(part, {})
        node[flax_path[-1]] = value
    if strict and missing:
        raise KeyError(f"torch keys missing from state_dict: {missing[:10]} "
                       f"({len(missing)} total)")
    return params


def resnet_rules(cfg, flax_prefix: FlaxPath, torch_prefix: str) -> Rules:
    """Rules for ResNetBackbone <- HF RTDetrResNetBackbone state dict.

    torch layout (modeling_rt_detr_resnet.py): embedder.embedder.{i} stem convs;
    encoder.stages.{s}.layers.{b}.layer.{k} block convs; shortcut at
    `shortcut` (plain projection) or `shortcut.1` (avg-pool Sequential).
    """
    r = Rules()
    p = tuple(flax_prefix)
    t = torch_prefix
    for i in range(3):
        r.conv_norm(
            (*p, f"stem{i}"),
            f"{t}embedder.embedder.{i}.convolution",
            f"{t}embedder.embedder.{i}.normalization",
        )
    in_ch = cfg.embedding_size
    for s, (out_ch, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
        stride = 2 if (s > 0 or cfg.downsample_in_first_stage) else 1
        for b in range(depth):
            tb = f"{t}encoder.stages.{s}.layers.{b}"
            fb = (*p, f"stage{s}_block{b}")
            n_convs = 3 if cfg.layer_type == "bottleneck" else 2
            for k in range(n_convs):
                r.conv_norm(
                    (*fb, f"conv{k}"),
                    f"{tb}.layer.{k}.convolution",
                    f"{tb}.layer.{k}.normalization",
                )
            if b == 0:
                block_in, block_stride = in_ch, stride
                if cfg.layer_type == "bottleneck":
                    should_project = block_in != out_ch or block_stride != 1
                    if block_stride == 2 and should_project:
                        sc = f"{tb}.shortcut.1"
                    elif should_project:
                        sc = f"{tb}.shortcut"
                    else:
                        sc = None
                else:
                    if block_in != out_ch:
                        sc = f"{tb}.shortcut.1"  # avg-pool Sequential
                    else:
                        sc = f"{tb}.shortcut"  # plain projection (always applied)
                if sc is not None:
                    r.conv_norm(
                        (*fb, "shortcut"), f"{sc}.convolution", f"{sc}.normalization"
                    )
        in_ch = out_ch
    return r
