"""Unmasked self-attention over a long sequence: the plain version and the
hand-written Hopper kernel that replaces the JAX package's two TPU kernels
(`spotter_tpu.models.layers.flash_self_attention`, Pallas flash attention on
fp32 tensors, and `_splash_self_attention`, Pallas splash on bf16 tensors).

Both compute softmax(q·kᵀ)·v over the whole sequence with q pre-scaled by
hd^-0.5, on (B, S, H, hd) tensors, the JAX layout. On the card they are two
kernels of `csrc/attention.cu` with a launch counter each: `flash_attn_fp32`
(CUDA cores, fp32) and `flash_attn_bf16` (tensor cores: wgmma fed by TMA,
fp32 accumulation and softmax). On a CPU tensor each wrapper runs
`self_attention_reference`; on a CUDA tensor it launches its kernel or
raises.
"""

import ctypes
import functools

import torch

from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library

HEAD_DIMS = (64, 128)  # the kernels' instantiations: YOLOS/OWLv2 heads, and 128
STRIDE_BYTES = 16  # strides over (B, S, H) and start addresses: multiples of this


def self_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, S, H, hd) pre-scaled q, k, v -> (B, S, H, hd).

    Materialises the (B, H, S, S) scores in the input dtype, takes the
    softmax in fp32, casts the weights back to the input dtype and returns
    the output in it, as the JAX package's einsum path does.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    weights = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


@functools.cache
def build_attention_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library; returns it
    with its build time and nvcc log. The first CUDA call builds it anyway."""
    loaded = load_kernel_library("attention", ("attention.cu",))
    lib = loaded.lib
    # pointers and the stream as c_void_p, strides as 64-bit ints: ctypes
    # would otherwise pass Python ints as 32-bit C ints
    args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]
    for name in ("flash_attn_fp32", "flash_attn_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return loaded


def _check_inputs(name: str, dtype: torch.dtype, q, k, v) -> None:
    """Device, dtype, shape, stride and alignment checks before pointers reach C."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"{name}: expected q, k, v of one (B, S, H, hd) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: {t_name} must be {dtype}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, q on {q.device}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes hd in {HEAD_DIMS}, got {q.shape[3]}")
    # 16 bytes: the fp32 kernel's vector loads, the bf16 kernel's TMA tensor maps
    multiple = STRIDE_BYTES // q.element_size()
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or any(st % multiple for st in t.stride()[:3])
                or t.data_ptr() % STRIDE_BYTES):
            raise ValueError(
                f"{name}: {t_name} needs unit stride over hd, strides over (B, S, H) that "
                f"are multiples of {multiple} and a {STRIDE_BYTES}-byte aligned start; got "
                f"strides {t.stride()}"
            )


def _cpu_reference(name: str, dtype: torch.dtype, q, k, v) -> torch.Tensor:
    if k.device.type != "cpu" or v.device.type != "cpu":
        raise ValueError(f"{name}: q on the CPU but not k and v")
    if q.dtype != dtype:
        raise TypeError(f"{name}: q must be {dtype}, got {q.dtype}")
    return self_attention_reference(q, k, v)


def _launch(name: str, dtype: torch.dtype, q, k, v) -> torch.Tensor:
    """Launch `name` on the current stream into a new contiguous output;
    raise with the CUDA error string if the launch was refused."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    _check_inputs(name, dtype, q, k, v)
    if q.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}")
    b, s, h, hd = q.shape
    out = torch.empty((b, s, h, hd), dtype=dtype, device=q.device)
    lib = build_attention_kernel().lib
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, hd, *strides,
            stream,
        )
    if code != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.attention_error_string(code).decode()} ({code})"
        )
    return out


def flash_attn_fp32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 (B, S, H, hd) pre-scaled q, k, v -> fp32 (B, S, H, hd). Replaces
    the Pallas flash_attention of `spotter_tpu/models/layers.py:126`."""
    if q.device.type == "cpu":
        return _cpu_reference("flash_attn_fp32", torch.float32, q, k, v)
    out = _launch("flash_attn_fp32", torch.float32, q, k, v)
    flash_attn_fp32.launches += 1
    return out


flash_attn_fp32.launches = 0  # kernel launches since the count was last reset


def flash_attn_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """bf16 (B, S, H, hd) pre-scaled q, k, v -> bf16 (B, S, H, hd), the
    products on the tensor cores with fp32 sums and the softmax in fp32.
    Replaces the Pallas splash kernel of `spotter_tpu/models/layers.py:185`."""
    if q.device.type == "cpu":
        return _cpu_reference("flash_attn_bf16", torch.bfloat16, q, k, v)
    out = _launch("flash_attn_bf16", torch.bfloat16, q, k, v)
    flash_attn_bf16.launches += 1
    return out


flash_attn_bf16.launches = 0
