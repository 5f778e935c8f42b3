"""Shared building blocks (port of spotter_tpu.models.layers, RT-DETR subset).

Convolutions run NCHW inside the port (PyTorch's layout); token tensors
are (B, S, D) as in the JAX package. Each submodule attribute carries its
flax module's name (`conv`, `bn`, `q_proj`, `layer0`, ...), so the weight
carry-over from JAX params (convert/from_jax.py) is a mechanical rename.
"""

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# fp32 policy: GELU is the exact erf form (the JAX package's "auto" takes
# the tanh form only on bf16 tensors, which the port does not run yet)
ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "gelu": F.gelu,
    "silu": F.silu,
    "swish": F.silu,
}


def get_activation(name: Optional[str]) -> Callable:
    if name is None:
        return lambda x: x
    return ACTIVATIONS[name]


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def fold_bn(
    scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen-BN stats folded to one (mul, add) pair."""
    mul = scale * torch.rsqrt(var + eps)
    return mul, bias - mean * mul


class FrozenBatchNorm(nn.Module):
    """Inference-mode batch norm on NCHW: y = (x - mean) / sqrt(var + eps) * weight + bias.

    The four statistics are buffers (flax's scale/bias/mean/var params)."""

    def __init__(self, features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul, add = fold_bn(self.weight, self.bias, self.running_mean, self.running_var, self.eps)
        return x * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1)


class ConvNorm(nn.Module):
    """Conv (no bias) + frozen BN + optional activation, NCHW.

    Conv k, stride s, padding (k-1)//2 unless given, as the RT-DETR lineage's
    ConvNormLayer.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        activation: Optional[str] = None,
        eps: float = 1e-5,
    ) -> None:
        super().__init__()
        pad = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(
            in_features, features, kernel_size, stride=stride, padding=pad, bias=False
        )
        self.bn = FrozenBatchNorm(features, eps)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class MLPHead(nn.Module):
    """DETR-style MLP prediction head: Linear stack with ReLU between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int) -> None:
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            setattr(self, f"layer{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Standard MHA with separate q/k/v/out projections, plain path.

    DETR-lineage peculiarity: position embeddings are added to queries and
    keys only — values come from the un-positioned hidden states. Scores are
    materialised: RT-DETR's sequences (AIFI 400 tokens, decoder 300) stay
    below the JAX package's flash cutover of 1024.
    """

    def __init__(self, embed_dim: int, num_heads: int) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        hidden_states: torch.Tensor,
        position_embeddings: Optional[torch.Tensor] = None,
        key_value_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        key_position_embeddings: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        head_dim = self.embed_dim // self.num_heads
        q_in = hidden_states
        if position_embeddings is not None:
            q_in = hidden_states + position_embeddings
        if key_value_states is None:  # self-attention
            k_in, v_in = q_in, hidden_states
        else:  # cross-attention
            k_in = key_value_states
            if key_position_embeddings is not None:
                k_in = key_value_states + key_position_embeddings
            v_in = key_value_states

        def split(x):  # (B, T, D) -> (B, H, T, hd)
            return x.reshape(*x.shape[:-1], self.num_heads, head_dim).transpose(-3, -2)

        q = split(self.q_proj(q_in)) * (head_dim**-0.5)
        k = split(self.k_proj(k_in))
        v = split(self.v_proj(v_in))
        logits = torch.matmul(q, k.transpose(-1, -2))  # (B, H, Tq, Tk)
        if attention_mask is not None:
            logits = logits + attention_mask.to(logits.dtype)
        weights = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
        out = torch.matmul(weights, v).transpose(-3, -2)  # (B, Tq, H, hd)
        return self.out_proj(out.reshape(*out.shape[:-2], self.embed_dim))


def sincos_2d_position_embedding(
    width: int, height: int, embed_dim: int, temperature: float = 10000.0
) -> np.ndarray:
    """AIFI 2D sin-cos table, (1, W*H, D) — computed in numpy from static shapes.

    Copied verbatim from the JAX package: the grid is built with 'ij'
    indexing over (w, h), so the table runs x-major while the tokens it is
    added to run y-major. That is the checkpoints' convention, kept as is.
    """
    if embed_dim % 4 != 0:
        raise ValueError("embed_dim must be divisible by 4 for 2D sin-cos embeddings")
    grid_w, grid_h = np.meshgrid(
        np.arange(width, dtype=np.float32),
        np.arange(height, dtype=np.float32),
        indexing="ij",
    )
    pos_dim = embed_dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    table = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )
    return table[None].astype(np.float32)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's `lecun_normal()`: a normal of variance 1/fan_in truncated at two
    standard deviations, with the std corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
