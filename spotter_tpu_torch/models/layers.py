"""Shared building blocks (port of spotter_tpu.models.layers, the subset the
ported families use).

Convolutions run NCHW inside the port (PyTorch's layout); token tensors
are (B, S, D) as in the JAX package. Each submodule attribute carries its
flax module's name (`conv`, `bn`, `q_proj`, `layer0`, ...), so the weight
carry-over from JAX params (convert/from_jax.py) is a mechanical rename.

`dtype` on a module is its compute dtype, as in the flax modules: the
ViT body runs bf16 under the "mixed" and "bfloat16" policies (models/zoo.py).

Process-wide knobs, with the JAX package's values and error texts, kept as
module attributes that are read when a forward runs (so a process can
switch them by setting the attribute):

- SPOTTER_TPU_GELU=auto|exact|tanh (`GELU_MODE`): "auto" takes the tanh
  form on bf16 tensors, where its error sits below bf16 rounding, and the
  exact erf form on fp32.
- SPOTTER_TPU_FLASH_ATTN (`FLASH_ATTN_ENABLED`): "0" keeps unmasked
  self-attention of FLASH_ATTN_MIN_SEQ tokens or more on the materialised
  path; otherwise it runs the attention kernel on a CUDA tensor.
- SPOTTER_TPU_FLASH_IMPL=auto|splash|flash (`FLASH_IMPL`): which TPU kernel
  the JAX package takes. Validated and accepted here; both names are the
  same Hopper kernel, whose instantiation follows the tensor's dtype.

The int8 knobs (SPOTTER_TPU_INT8, _INT8_DENSE, _INT8_ATTN and their floors)
live in utils/quant.py. Where flax keeps an fp32 param that a quantized
path reads at fp32 (every `ConvNorm` kernel, every `QuantDense` kernel and
bias), the port keeps it as an fp32 master too, and keeps its cast to the
compute dtype and its quantized codes (`kept`) until it changes.
"""

import functools
import math
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spotter_tpu_torch.ops.attention import flash_attn_bf16, flash_attn_fp32
from spotter_tpu_torch.ops.int8 import (
    QuantizedConvWeight,
    QuantizedWeight,
    quantize_conv_weight,
    quantize_weight_rows,
)
from spotter_tpu_torch.utils import quant


def parse_gelu_mode(raw: str) -> str:
    """The SPOTTER_TPU_GELU value, checked as the JAX package checks it."""
    mode = raw.strip().lower()
    if mode not in ("auto", "exact", "tanh"):
        raise ValueError(f"SPOTTER_TPU_GELU must be auto|exact|tanh, got {mode!r}")
    return mode


def parse_flash_impl(raw: str) -> str:
    """The SPOTTER_TPU_FLASH_IMPL value, checked as the JAX package checks it."""
    impl = raw.strip().lower()
    if impl not in ("auto", "splash", "flash"):
        raise ValueError(f"SPOTTER_TPU_FLASH_IMPL must be auto|splash|flash, got {impl!r}")
    return impl


GELU_MODE = parse_gelu_mode(os.environ.get("SPOTTER_TPU_GELU", "auto"))
# the JAX package's cutover: ViT-detector sequences (yolos-base at 800x1344
# is 4301 tokens) would materialise ~7 GB of fp32 scores per batch-8 forward;
# RT-DETR's 400 (AIFI) and 300 (decoder) tokens stay below it
FLASH_ATTN_MIN_SEQ = 1024
FLASH_ATTN_ENABLED = os.environ.get("SPOTTER_TPU_FLASH_ATTN", "1") != "0"
FLASH_IMPL = parse_flash_impl(os.environ.get("SPOTTER_TPU_FLASH_IMPL", "auto"))


def gelu(x: torch.Tensor) -> torch.Tensor:
    if GELU_MODE == "tanh" or (GELU_MODE == "auto" and x.dtype == torch.bfloat16):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's x * sigmoid(1.702 x), one op at a time at x's dtype, as the
    JAX package writes it (each op rounds to bf16 on a bf16 tensor)."""
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "gelu": gelu,
    "silu": F.silu,
    "swish": F.silu,
    "quick_gelu": quick_gelu,
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


def version_key(*tensors: torch.Tensor) -> Optional[tuple]:
    """What a value derived from `tensors` depends on: their storage, their
    version counters (an in-place change bumps them) and devices. A module
    that keeps such a value recomputes it when the key changes. None when
    one is an inference tensor (made under torch.inference_mode, e.g. a
    module moved to the card there), which has no version counter: the
    value is then recomputed every call, never kept."""
    if any(t.is_inference() for t in tensors):
        return None
    return tuple((t.data_ptr(), t._version, t.device) for t in tensors)


@functools.cache
def device_table(fn: Callable, device: torch.device, *args):
    """`fn(*args)`'s numpy array(s) (a static table: index maps, sine
    denominators, anchors) as tensors on `device`, made once per arguments
    and device. A host copy on every forward would make the host wait for
    the stream, and cannot run inside a CUDA graph's capture; the table is
    never evicted, because a captured graph reads it in place. Made outside
    inference mode, so it also serves forwards that track gradients."""
    out = fn(*args)
    with torch.inference_mode(False):
        if isinstance(out, tuple):
            return tuple(torch.from_numpy(a).to(device) for a in out)
        return torch.from_numpy(out).to(device)


# the attribute names `kept` has stored values under (`kept_entries` reads them)
KEPT_NAMES: set[str] = set()


def kept_entries(root: nn.Module) -> list[tuple[str, tuple]]:
    """Every entry `kept` holds on `root`'s modules now, as (module path and
    name, (key, value, make)). A captured CUDA graph holds on to them: it
    reads their storage on every replay, even after a module keeps a newer
    value. The engine's attestation re-derives each value with its `make`."""
    return [(f"{path}.{name}" if path else name, vars(m)[name])
            for path, m in root.named_modules() for name in sorted(KEPT_NAMES)
            if name in vars(m)]


def kept(module: nn.Module, name: str, sources: tuple, make: Callable, grad: bool = True):
    """`make()`, a value derived from the tensors `sources`, kept on `module`
    as `name` (with its key and `make`) until their `version_key` changes,
    made without autograd and outside inference mode. A value that carries gradients (`grad`: a cast
    or a fold of the params) is not kept in a forward that tracks them
    (grad mode on and a source requiring grad): `make()` then runs in that
    forward, so the gradient reaches the fp32 masters under every policy.
    Quantized codes pass `grad=False`: they carry none (the straight-through
    backward belongs to training and is not ported)."""
    if grad and torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return make()
    key = version_key(*sources)
    cached = getattr(module, name, None)
    if key is None or cached is None or cached[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            cached = (key, make(), make)
        setattr(module, name, cached)
        KEPT_NAMES.add(name)
    return cached[1]


def fold_bn(
    scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen-BN stats folded to one (mul, add) pair."""
    mul = scale * torch.rsqrt(var + eps)
    return mul, bias - mean * mul


class FrozenBatchNorm(nn.Module):
    """Inference-mode batch norm on NCHW: y = (x - mean) / sqrt(var + eps) * weight + bias.

    The four statistics are fp32 buffers (flax's scale/bias/mean/var params),
    folded to one (mul, add) pair in fp32 and cast to `dtype` before they
    meet x, as the flax module does: a bf16 x stays bf16. The folded pair is
    kept until a statistic changes (each buffer's version counter) or the
    module moves: folding anew every forward costs seven launches a layer,
    which at B = 1 (and under the bf16 policies at B = 8 too) is host time
    the card waits for."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The fp32 (mul, add) pair, (C,) each."""
        return fold_bn(self.weight, self.bias, self.running_mean, self.running_var, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = (self.weight, self.bias, self.running_mean, self.running_var)
        mul, add = kept(self, "_folded", stats, lambda: tuple(
            t.to(self.dtype).view(1, -1, 1, 1) for t in self.folded()))  # at dtype, (1, C, 1, 1)
        return (x * mul + add).to(self.dtype)


class ConvNorm(nn.Module):
    """Conv (no bias) + frozen BN + optional activation, NCHW.

    Conv k, stride s, padding (k-1)//2 unless given, as the RT-DETR lineage's
    ConvNormLayer. The kernel is an fp32 master (flax's fp32 param); the
    float convolution runs at `dtype`, input and kernel (its cast kept), so
    a bf16 ConvNorm is a bf16 convolution (on the card, cuDNN's on the
    tensor cores). With SPOTTER_TPU_INT8 on, at least INT8_MIN_CH input
    channels and INT8_MIN_BATCH samples, the convolution is
    `quant.int8_conv` on the kept codes of the fp32 kernel, dequantized to
    `dtype`, feeding the same BN.
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
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel_size, self.stride = kernel_size, stride
        self.pad = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride=stride,
                              padding=self.pad, bias=False)
        self.bn = FrozenBatchNorm(features, eps, dtype)
        self.act = get_activation(activation)

    def kernel_at_dtype(self) -> torch.Tensor:
        w = self.conv.weight
        return kept(self, "_cast", (w,), lambda: w.to(self.dtype))

    def quantized_kernel(self) -> QuantizedConvWeight:
        w = self.conv.weight
        return kept(self, "_quantized", (w,), lambda: quantize_conv_weight(w.to(torch.float32)),
                    grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.int8_wanted(x.shape[1], batch=x.shape[0]):
            y = quant.int8_conv(x, self.quantized_kernel(), self.kernel_size, self.stride,
                                self.pad, self.dtype)
        else:
            y = F.conv2d(x.to(self.dtype), self.kernel_at_dtype(), None, self.stride, self.pad)
        return self.act(self.bn(y))


def flash_attention_enabled(x: torch.Tensor) -> bool:
    """True when long self-attention on `x` may take the attention kernel:
    on a CUDA tensor, unless SPOTTER_TPU_FLASH_ATTN=0. (The JAX package asks
    for the TPU backend here; a CPU tensor always takes the plain path.)"""
    return FLASH_ATTN_ENABLED and x.device.type == "cuda"


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) pre-scaled q, k, v -> (B, S, H, hd) through the
    hand-written attention kernel (ops/attention.py): the bf16
    instantiation on bf16 tensors, the fp32 one otherwise. The JAX
    package's SPOTTER_TPU_FLASH_IMPL picks between two TPU kernels that
    compute this same function; on Hopper both names are this one kernel."""
    if q.dtype == torch.bfloat16:
        return flash_attn_bf16(q, k, v)
    return flash_attn_fp32(q, k, v)


class Dense(nn.Linear):
    """flax's nn.Dense(dtype=...): input and weights at the compute dtype
    (the weights are stored in it, which is flax's cast at use done once),
    bias added in the same product."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, features, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class QuantDense(nn.Linear):
    """flax's QuantDense (the ViT projections, MultiHeadAttention's q/k/v/out):
    fp32 master kernel and bias. The float path is `Dense`'s, on the kept
    casts to `dtype`. With SPOTTER_TPU_INT8 and _INT8_DENSE on, at least
    INT8_MIN_CH input features and INT8_MIN_BATCH samples (`x.shape[0]`), the
    product is `quant.int8_dense` on the kept codes of the fp32 kernel,
    dequantized to `dtype`, and the bias adds after it in `dtype`."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, features, bias=bias)
        self.dtype = dtype

    def params_at_dtype(self) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        w, b = self.weight, self.bias
        sources = (w,) if b is None else (w, b)
        return kept(self, "_cast", sources,
                    lambda: (w.to(self.dtype), None if b is None else b.to(self.dtype)))

    def quantized_kernel(self) -> QuantizedWeight:
        w = self.weight
        return kept(self, "_quantized", (w,), lambda: quantize_weight_rows(w), grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.params_at_dtype()
        if quant.int8_dense_wanted(x.shape[-1], batch=x.shape[0]):
            y = quant.int8_dense(x, self.quantized_kernel(), self.dtype)
            return y if b is None else y + b
        return F.linear(x.to(self.dtype), w, b)


class LayerNorm(nn.LayerNorm):
    """flax's nn.LayerNorm(dtype=...): statistics, scale and bias in fp32
    (fp32 params), the result cast to the compute dtype."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class PatchEmbed(nn.Conv2d):
    """ViT patch embedding: a (P, P) convolution with stride P, (B, H, W, C)
    pixels -> (B, H/P * W/P, D) tokens in row-major patch order, with a bias
    unless `bias=False` (OWL-ViT's has none).

    flax's kernel is (P, P, C, D), HWIO, so the carry-over's HWIO -> OIHW
    rule maps it onto this conv's weight. Under a bf16 compute dtype the
    pixels and the kernel are rounded to bf16 and the products summed in
    fp32 with the fp32 bias, then rounded once, as the JAX rewrite's
    `preferred_element_type=float32` dot does.
    """

    def __init__(self, in_channels: int, features: int, patch_size: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True) -> None:
        super().__init__(in_channels, features, patch_size, stride=patch_size, bias=bias)
        self.dtype = dtype

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = pixels.permute(0, 3, 1, 2).to(self.dtype).to(torch.float32)
        w = self.weight.to(self.dtype).to(torch.float32)
        y = F.conv2d(x, w, self.bias, stride=self.stride)  # (B, D, gh, gw)
        return y.flatten(2).transpose(1, 2).to(self.dtype)


class PReLU(nn.Module):
    """torch nn.PReLU with one learned slope: max(0, x) + a * min(0, x).

    DAB-DETR's FFN activation, the one activation in the zoo with a weight
    (flax leaf `weight`, shape (1,), initialised to 0.25)."""

    def __init__(self) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(min=0) + self.weight.to(x.dtype) * x.clamp(max=0)


def make_activation(name: str) -> Callable:
    """An FFN's activation: a `PReLU` module (learned) for "prelu", else
    the stateless function of that name."""
    return PReLU() if name == "prelu" else get_activation(name)


class MLPHead(nn.Module):
    """DETR-style MLP prediction head: Dense stack with ReLU between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            setattr(self, f"layer{i}", Dense(dims[i], dims[i + 1], dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Standard MHA with separate q/k/v/out projections.

    DETR-lineage peculiarity: position embeddings are added to queries and
    keys only — values come from the un-positioned hidden states. Unmasked
    self-attention over FLASH_ATTN_MIN_SEQ tokens or more on a CUDA tensor
    runs the attention kernel (`flash_self_attention`); everything else
    materialises the scores. RT-DETR's sequences (AIFI 400 tokens, decoder
    300) never reach the cutover; the OWLv2 vision tower's 3601 do. The
    projections are `QuantDense`. Past the attention kernel's branch, with
    SPOTTER_TPU_INT8 and _INT8_ATTN on, a head dim of at least
    INT8_ATTN_MIN_HD and INT8_MIN_BATCH samples, QKᵀ and attn·V are
    `quant.int8_qk` and `quant.int8_av` (per-(sample, head) scales), as in
    the JAX package, where the flash branch comes first too.

    `dtype` is the projections' compute dtype (fp32 by default, RT-DETR's);
    an additive `attention_mask` is cast to the scores' dtype and added to
    them, as the JAX package adds it (the OWL-ViT text tower's causal and
    padding NEG_INF sum to -inf in fp32 on both sides).
    """

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.q_proj = QuantDense(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = QuantDense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = QuantDense(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = QuantDense(embed_dim, embed_dim, dtype=dtype)

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

        def split(x):  # (B, T, D) -> (B, T, H, hd)
            return x.reshape(*x.shape[:-1], self.num_heads, head_dim)

        q = split(self.q_proj(q_in)) * (head_dim**-0.5)
        k = split(self.k_proj(k_in))
        v = split(self.v_proj(v_in))
        if (
            flash_attention_enabled(q)
            and attention_mask is None
            and key_value_states is None
            and q.shape[1] >= FLASH_ATTN_MIN_SEQ
        ):
            out = flash_self_attention(q, k, v)
            return self.out_proj(out.reshape(*out.shape[:-2], self.embed_dim))
        if quant.int8_attn_wanted(head_dim, batch=q.shape[0]):
            logits = quant.int8_qk(q, k)  # (B, H, Tq, Tk) fp32
            if attention_mask is not None:
                logits = logits + attention_mask.to(logits.dtype)
            weights = torch.softmax(logits.to(torch.float32), dim=-1).to(self.dtype)
            out = quant.int8_av(weights, v, self.dtype)  # (B, Tq, H, hd)
            return self.out_proj(out.reshape(*out.shape[:-2], self.embed_dim))
        q, k, v = (t.transpose(-3, -2) for t in (q, k, v))  # (B, H, T, hd)
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
