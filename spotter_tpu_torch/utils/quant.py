"""Symmetric int8 quantization (port of spotter_tpu.utils.quant).

The same three knobs, guards and numerics as the JAX package:

- SPOTTER_TPU_INT8 (`INT8`) quantizes the convolutions of `ConvNorm` and of
  the fused RepVGG block whose input has at least `INT8_MIN_CH` channels;
- SPOTTER_TPU_INT8_DENSE (`INT8_DENSE`) also the `QuantDense` projections
  with at least `INT8_MIN_CH` input features, only together with INT8
  (alone it changes nothing);
- SPOTTER_TPU_INT8_ATTN (`INT8_ATTN`) also `MultiHeadAttention`'s QKᵀ and
  attn·V at a head dim of at least `INT8_ATTN_MIN_HD`, only together with
  INT8;
- SPOTTER_TPU_INT8_MIN_CH (64), _INT8_MIN_BATCH (8) and _INT8_ATTN_MIN_HD
  (32): below the batch floor (`x.shape[0]`) every layer takes its float
  path unchanged.

A knob is on for any value whose strip is not "0". The knobs are read once,
when this module is imported, as the JAX package reads them; a process (or
a test) switches them by setting the module attributes, which the guards
read on every call.

Numerics, bit for bit the JAX package's: per-output-channel weight scales
(over every axis of the port's weight but the first, the output channel),
per-sample activation scales (one global scale for a rank-1 input),
per-(sample, head) attention scales; scale = max(amax, 1e-12) / 127 in fp32,
code = clip(round_half_even(x / scale), -127, 127) with x in fp32 and a true
fp32 division; int32 sums; the dequant `y.float() * (sx * sw)` with the
scale product formed first, then the cast to the output dtype. The weight is
always quantized from its fp32 master, whatever the policy.

The functions here are the plain PyTorch versions, which the tests hold
against the JAX package: products in float64 on the codes, exact since
|sum| <= K * 127**2 < 2**53. The models call `int8_conv`, `int8_dense`,
`int8_qk` and `int8_av`, which run the kernels of ops/int8.py on a CUDA
tensor (the convolution: an amax and an NHWC quantize pass, then `conv_s8`;
the others: a quantize pass, the int8 GEMM, a dequant pass) and their plain
versions on a CPU tensor. The straight-through backward of the JAX
package's custom_vjp belongs to training and is not ported.
"""

import os
from typing import Optional

import torch
import torch.nn.functional as F

from spotter_tpu_torch.ops import int8 as kernels
from spotter_tpu_torch.ops.int8 import codes_of, scale_of


def knob_on(name: str) -> bool:
    """An int8 switch as the JAX package reads it: on unless "0" (or unset)."""
    return os.environ.get(name, "0").strip() != "0"


INT8_ENV = "SPOTTER_TPU_INT8"
INT8_DENSE_ENV = "SPOTTER_TPU_INT8_DENSE"
INT8_ATTN_ENV = "SPOTTER_TPU_INT8_ATTN"
INT8_KNOBS = (INT8_ENV, INT8_DENSE_ENV, INT8_ATTN_ENV)

INT8 = knob_on(INT8_ENV)
INT8_DENSE = knob_on(INT8_DENSE_ENV)
INT8_ATTN = knob_on(INT8_ATTN_ENV)
INT8_MIN_CH = int(os.environ.get("SPOTTER_TPU_INT8_MIN_CH", "64"))
INT8_MIN_BATCH = int(os.environ.get("SPOTTER_TPU_INT8_MIN_BATCH", "8"))
INT8_ATTN_MIN_HD = int(os.environ.get("SPOTTER_TPU_INT8_ATTN_MIN_HD", "32"))

# quantized calls since the counts were last reset, by product (the models'
# int8 sites; each call runs its kernels on a CUDA tensor)
CALLS = {"conv": 0, "dense": 0, "qk": 0, "av": 0}


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def int8_wanted(in_channels: int, batch: Optional[int] = None) -> bool:
    if batch is not None and batch < INT8_MIN_BATCH:
        return False
    return INT8 and in_channels >= INT8_MIN_CH


def int8_dense_wanted(in_features: int, batch: Optional[int] = None) -> bool:
    if batch is not None and batch < INT8_MIN_BATCH:
        return False
    return INT8 and INT8_DENSE and in_features >= INT8_MIN_CH


def int8_attn_wanted(head_dim: int, batch: Optional[int] = None) -> bool:
    if batch is not None and batch < INT8_MIN_BATCH:
        return False
    return INT8 and INT8_ATTN and head_dim >= INT8_ATTN_MIN_HD


# --- plain versions (on ops/int8.py's scale_of and codes_of) --------------------


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, ...) float weight (the port's layout: output channel first) ->
    (int8 codes of w's shape, (N,) fp32 scales), per output channel."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    scale = scale_of(amax)
    return codes_of(wf, scale), scale.reshape(-1)


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample: (int8 codes of x's shape, (B, 1, ..., 1) fp32 scales);
    a rank-1 x takes one global scale."""
    xf = x.to(torch.float32)
    axes = tuple(range(1, x.ndim)) if x.ndim > 1 else (0,)
    scale = scale_of(xf.abs().amax(dim=axes, keepdim=True))
    return codes_of(xf, scale), scale


def quantize_per_head(x: torch.Tensor, head_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One scale per (sample, head): the amax over every axis but 0 and
    `head_axis`, kept as size-1 dims."""
    xf = x.to(torch.float32)
    axes = tuple(a for a in range(x.ndim) if a not in (0, head_axis % x.ndim))
    scale = scale_of(xf.abs().amax(dim=axes, keepdim=True))
    return codes_of(xf, scale), scale


def int8_conv_reference(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """NCHW x, OIHW fp32 weight -> NCHW `out_dtype`: the codes convolved in
    float64 (exact), dequantized per (sample, output channel)."""
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(weight)
    y = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), stride=stride, padding=padding)
    s = sx.view(-1, 1, 1, 1) * sw.view(1, -1, 1, 1)
    return (y.to(torch.float32) * s).to(out_dtype)


def int8_dense_reference(x: torch.Tensor, weight: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """(..., K) x, (N, K) fp32 weight -> (..., N) `out_dtype`, no bias."""
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(weight)
    y = xq.reshape(-1, x.shape[-1]).to(torch.float64) @ wq.to(torch.float64).t()
    y = y.reshape(*x.shape[:-1], weight.shape[0])
    return (y.to(torch.float32) * (sx * sw)).to(out_dtype)


def int8_qk_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, Tq, H, hd) q, (B, Tk, H, hd) k -> (B, H, Tq, Tk) fp32 logits."""
    qq, sq = quantize_per_head(q, 2)
    kq, sk = quantize_per_head(k, 2)
    y = torch.einsum("bqhd,bkhd->bhqk", qq.to(torch.float64), kq.to(torch.float64))
    return y.to(torch.float32) * (sq * sk).transpose(1, 2)


def int8_av_reference(w: torch.Tensor, v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """(B, H, Tq, Tk) weights, (B, Tk, H, hd) v -> (B, Tq, H, hd) `out_dtype`."""
    wq, sw = quantize_per_head(w, 1)
    vq, sv = quantize_per_head(v, 2)
    y = torch.einsum("bhqk,bkhd->bhqd", wq.to(torch.float64), vq.to(torch.float64))
    s = sw * sv.transpose(1, 2)
    return (y.to(torch.float32) * s).transpose(1, 2).to(out_dtype)


# --- the models' entry points -----------------------------------------------------


def int8_conv(x: torch.Tensor, weight: kernels.QuantizedConvWeight, kernel_size: int,
              stride: int, padding: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The quantized convolution of ConvNorm and the fused RepVGG block:
    NCHW x -> NCHW `out_dtype`. `weight` is the layer's kept quantized
    kernel (`kernels.quantize_conv_weight` of its fp32 master, tap-major).
    Kernels: the amax pass, the quantize pass into NHWC codes
    (`nhwc_codes`: one byte a value), then `conv_s8`, which gathers the
    codes in place and dequantizes in its epilogue."""
    if weight.kernel_size != kernel_size:
        raise ValueError(f"int8_conv: a {weight.kernel_size}x{weight.kernel_size} weight "
                         f"for a {kernel_size}x{kernel_size} convolution")
    CALLS["conv"] += 1
    xq, sx = kernels.nhwc_codes(x, kernels.amax_samples(x), weight.c_pad)
    return kernels.conv_s8(xq, weight.codes, sx, weight.scale, kernel_size, stride, padding,
                           out_dtype)


def int8_dense(x: torch.Tensor, weight: kernels.QuantizedWeight,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The quantized projection of QuantDense: (..., K) -> (..., N)
    `out_dtype`, no bias (it adds after, in `out_dtype`)."""
    CALLS["dense"] += 1
    rows = x.shape[1:-1].numel()  # a sample's rows (1 for a rank-1 or rank-2 x)
    xq, sx = kernels.quantize_rows(x.reshape(-1, x.shape[-1]), rows, weight.k_pad)
    y = kernels.int8_gemm_kmajor(xq, weight.codes)
    out = kernels.dequant_rows(y, sx, weight.scale, rows, out_dtype)
    return out.reshape(*x.shape[:-1], weight.codes.shape[0])


def int8_qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Quantized QKᵀ: (B, Tq, H, hd), (B, Tk, H, hd) -> (B, H, Tq, Tk) fp32."""
    CALLS["qk"] += 1
    b, tq, h, _ = q.shape
    qq, sq = kernels.quantize_heads(q, transpose=False)
    kq, sk = kernels.quantize_heads(k, transpose=False)
    y = kernels.int8_gemm_kmajor(qq, kq)  # (B*H, Tq, Tk)
    return kernels.dequant_heads(y, sq, sk, out_dtype=torch.float32).view(b, h, tq, -1)


def int8_av(w: torch.Tensor, v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Quantized attn·V: (B, H, Tq, Tk) weights, (B, Tk, H, hd) v ->
    (B, Tq, H, hd) `out_dtype`."""
    CALLS["av"] += 1
    b, h, tq, tk = w.shape
    vt, sv = kernels.quantize_heads(v, transpose=True)  # (B*H, hd, Tk_pad)
    wq, sw = kernels.quantize_rows(w.reshape(b * h * tq, tk), tq, vt.shape[-1])
    y = kernels.int8_gemm_kmajor(wq.view(b * h, tq, -1), vt)  # (B*H, Tq, hd)
    return kernels.dequant_av(y, sw, sv, b, h, out_dtype)
