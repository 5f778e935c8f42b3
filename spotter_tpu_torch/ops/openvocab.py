"""The open-vocabulary class-logit head of OWL-ViT / OWLv2: the plain version
and the hand-written Hopper kernel that replaces the JAX package's Pallas
kernel (`spotter_tpu.ops.openvocab.pallas_class_logits`).

For each patch row of the class head's dense0 output: divide by its L2
norm plus 1e-6, take the dot product with each pre-normalized query, add
the learned per-patch shift and multiply by elu(scale) + 1; a query whose
mask is 0 gets NEG_INF (float32 min) in every row, so it can never win an
argmax over the real queries. On the card that is one kernel
(`csrc/class_logits.cu`) with a launch counter, `owl_class_logits`; on a
CPU tensor the wrapper runs `class_logits_reference`, the function the JAX
package's interpret mode computes. The TPU kernel's 128-row and 128-lane
padding is TPU tiling and has no counterpart here.

Knob, with the JAX package's values and error text: SPOTTER_TPU_OWL_FUSED
= auto|1|0, kept as the module attribute `OWL_FUSED` and read when a
forward runs (`owl_fused_wanted`):
- auto and 1: the fused head, `owl_class_logits`: the kernel on CUDA
  tensors, the plain version on the CPU (the function the JAX package's
  interpret mode computes);
- 0: the unfused tail (`models/owlvit.py`) on either device.
"""

import ctypes
import functools
import os

import numpy as np
import torch

from spotter_tpu_torch.obs.perf import note_kernel_flops
from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library

NEG_INF = float(np.finfo(np.float32).min)
MAX_TEXT_WIDTH = 1024  # the widest text width the kernel stages the bank for


def parse_owl_fused(raw: str) -> str:
    """The SPOTTER_TPU_OWL_FUSED value, checked as the JAX package checks it."""
    value = raw.strip().lower()
    if value not in ("auto", "1", "0"):
        raise ValueError(f"SPOTTER_TPU_OWL_FUSED must be auto|1|0, got {value!r}")
    return value


OWL_FUSED = parse_owl_fused(os.environ.get("SPOTTER_TPU_OWL_FUSED", "auto"))


def owl_fused_wanted() -> bool:
    """True when the class head should take the fused head: unless the knob
    is 0 (the wrapper picks the kernel or the plain version by device)."""
    return OWL_FUSED != "0"


def class_logits_reference(
    img: torch.Tensor,
    queries: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: img (B, P, Dt) raw dense0 output (fp32 or bf16),
    queries (Q, Dt) pre-normalized, shift and scale (B, P) raw, mask (Q,)
    1 = valid or None -> (B, P, Q) fp32, the math of the JAX package's
    `_class_logits_ref` (elu in its expm1 form, as the TPU kernel writes it)."""
    x = img.to(torch.float32)
    xn = x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + 1e-6)
    logits = torch.einsum("bpd,qd->bpq", xn, queries.to(torch.float32))
    sh = shift.to(torch.float32)[..., None]
    sc_raw = scale.to(torch.float32)[..., None]
    sc = torch.where(sc_raw > 0, sc_raw, torch.expm1(sc_raw)) + 1.0
    out = (logits + sh) * sc
    if mask is None:
        return out
    return torch.where(mask.to(out.device)[None, None, :] == 0, NEG_INF, out)


@functools.cache
def build_class_logits_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library; returns it
    with its build time and nvcc log. The first CUDA call builds it anyway."""
    return bind_class_logits_library(load_kernel_library("class_logits", ("class_logits.cu",)))


def bind_class_logits_library(loaded: KernelLibrary) -> KernelLibrary:
    """Set the C functions' argument types on a loaded build of
    `class_logits.cu` (the served one, or a variant a probe builds)."""
    lib = loaded.lib
    # pointers and the stream as c_void_p, the row count as a 64-bit int:
    # ctypes would otherwise pass Python ints as 32-bit C ints
    args = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for name in ("owl_class_logits_fp32", "owl_class_logits_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.class_logits_error_string.argtypes = [ctypes.c_int]
    lib.class_logits_error_string.restype = ctypes.c_char_p
    return loaded


def _check_inputs(img, queries, shift, scale, mask) -> None:
    """Shape, dtype and device checks (both devices), then the kernel's
    contiguity and alignment needs (CUDA only) before pointers reach C."""
    if img.dim() != 3 or queries.dim() != 2 or queries.shape[1] != img.shape[2]:
        raise ValueError(
            f"owl_class_logits: expected img (B, P, Dt) and queries (Q, Dt), got "
            f"{tuple(img.shape)} and {tuple(queries.shape)}"
        )
    b, p, dt = img.shape
    if shift.shape != (b, p) or scale.shape != (b, p):
        raise ValueError(
            f"owl_class_logits: shift and scale must be {(b, p)}, got "
            f"{tuple(shift.shape)} and {tuple(scale.shape)}"
        )
    if mask is not None and mask.shape != (queries.shape[0],):
        raise ValueError(f"owl_class_logits: mask must be ({queries.shape[0]},), got "
                         f"{tuple(mask.shape)}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"owl_class_logits: img must be float32 or bfloat16, got {img.dtype}")
    if queries.dtype != torch.float32:
        raise TypeError(f"owl_class_logits: queries must be float32, got {queries.dtype}")
    tensors = [("img", img), ("queries", queries), ("shift", shift), ("scale", scale)]
    if mask is not None:
        tensors.append(("mask", mask))
    for name, t in tensors:
        if t.device != img.device:
            raise ValueError(f"owl_class_logits: {name} is on {t.device}, img on {img.device}")
    if img.device.type != "cuda":
        return
    if dt % 4 or dt > MAX_TEXT_WIDTH or not img.is_contiguous() or not queries.is_contiguous():
        raise ValueError(
            f"owl_class_logits: needs contiguous img and queries with Dt a multiple of 4 up to "
            f"{MAX_TEXT_WIDTH}, got Dt = {dt}, strides {img.stride()} and {queries.stride()}"
        )
    if img.data_ptr() % (4 * img.element_size()) or queries.data_ptr() % 16:
        raise ValueError("owl_class_logits: img and queries must start 4-element aligned")
    if img.numel() == 0 or queries.numel() == 0:
        raise ValueError(f"owl_class_logits: empty input {tuple(img.shape)}, "
                         f"{tuple(queries.shape)}")


def owl_class_logits(
    img: torch.Tensor,
    queries: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """img (B, P, Dt) fp32 or bf16, queries (Q, Dt) fp32 pre-normalized,
    shift and scale (B, P), mask (Q,) 1 = valid or None -> (B, P, Q) fp32
    logits, masked columns exactly NEG_INF. Replaces the Pallas kernel of
    `spotter_tpu/ops/openvocab.py:87`. On a CPU tensor: the plain version.
    Every call notes the JAX package's FLOPs for its kernel,
    2·B·Pp·Dt·Qp + 5·B·Pp·(Dt + Qp), patches padded to its 128-row tile and
    queries to its 128 lanes."""
    if img.device.type not in ("cuda", "cpu"):
        raise ValueError(f"owl_class_logits runs on cuda or cpu, not {img.device}")
    _check_inputs(img, queries, shift, scale, mask)
    b, p, dt = img.shape
    pp, qp = -(-p // 128) * 128, -(-queries.shape[0] // 128) * 128
    note_kernel_flops("owl_class_logits", 2 * b * pp * dt * qp + 5 * b * pp * (dt + qp))
    if img.device.type == "cpu":
        return class_logits_reference(img, queries, shift, scale, mask)
    b, p, dt = img.shape
    q = queries.shape[0]
    # the kernel reads fp32 shift/scale and an int32 mask: widening a bf16
    # head's (B, P) outputs is exact, and these are a few KB
    shift = shift.to(torch.float32).contiguous()
    scale = scale.to(torch.float32).contiguous()
    mask_i = None if mask is None else (mask != 0).to(torch.int32).contiguous()
    if img.dtype == torch.bfloat16 and (dt % 8 or img.data_ptr() % 16):
        # TMA reads rows 16-byte aligned and a multiple of 16 bytes apart:
        # such a bf16 img goes as fp32, widened exactly (its TF32 split is
        # then hi = x, lo = 0, as on the bf16 path)
        img = img.to(torch.float32)
    out = torch.empty((b, p, q), dtype=torch.float32, device=img.device)
    lib = build_class_logits_kernel().lib
    fn = lib.owl_class_logits_bf16 if img.dtype == torch.bfloat16 else lib.owl_class_logits_fp32
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        code = fn(
            img.data_ptr(), queries.data_ptr(), shift.data_ptr(), scale.data_ptr(),
            None if mask_i is None else mask_i.data_ptr(), out.data_ptr(), b * p, dt, q,
            stream,
        )
    if code != 0:
        raise RuntimeError(
            f"owl_class_logits launch failed: "
            f"{lib.class_logits_error_string(code).decode()} ({code})"
        )
    owl_class_logits.launches += 1
    return out


owl_class_logits.launches = 0  # kernel launches since the count was last reset
