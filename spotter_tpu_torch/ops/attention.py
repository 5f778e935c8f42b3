"""Unmasked self-attention over a long sequence: the plain version and the
hand-written Hopper kernel that replaces the JAX package's two TPU kernels
(`spotter_tpu.models.layers.flash_self_attention`, Pallas flash attention on
fp32 tensors, and `_splash_self_attention`, Pallas splash on bf16 tensors).

Both compute softmax(q·kᵀ)·v over the whole sequence with q pre-scaled by
hd^-0.5, on (B, S, H, hd) tensors, the JAX layout. On the card they are
kernels of `csrc/attention.cu` on the tensor cores (wgmma fed by TMA, fp32
accumulation and softmax), each with a launch counter: `flash_attn_bf16`,
and `flash_attn_fp32`, which keeps fp32 accuracy by splitting each operand
into two TF32 terms (x = hi + lo) and taking each product in three passes.
Its K/V split pass, `split_kv_tf32`, runs first in every call, with its own
counter, into scratch the wrapper allocates. On a CPU tensor each wrapper
runs its plain version (`self_attention_reference`,
`split_kv_reference`); on a CUDA tensor it launches its kernel or raises.
"""

import ctypes
import functools

import torch

from spotter_tpu_torch.obs.perf import note_kernel_flops
from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library

HEAD_DIMS = (64, 128)  # the kernels' instantiations: YOLOS/OWLv2 heads, and 128
STRIDE_BYTES = 16  # strides over (B, S, H) and start addresses: multiples of this
# Within each group of 8 keys, the split pass stores vᵀ in this key order:
# a TF32 A fragment of 8 keys holds columns t and t + 4 where the score
# accumulator gives a thread keys 2t and 2t + 1, so in this order the scores
# feed P·V from registers as they stand (csrc/attention.cu)
VT_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
VT_KEY_GROUP = len(VT_KEY_ORDER)
TF32_DROP_BITS = 13  # fp32 mantissa bits that TF32 leaves out


def self_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, S, H, hd) pre-scaled q, k, v -> (B, S, H, hd).

    Materialises the (B, H, S, S) scores in the input dtype, takes the
    softmax in fp32, casts the weights back to the input dtype and returns
    the output in it, as the JAX package's einsum path does.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    weights = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, lo), x = hi + lo exactly: hi is x rounded to TF32 to
    nearest with ties away from zero (PTX `cvt.rna.tf32.f32`: the low 13
    mantissa bits cleared), lo the fp32 residue x - hi (at most 12
    significant bits, of which the tensor cores read 11)."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    sign = bits & -(2**31)
    magnitude = (bits & 0x7FFFFFFF) + (1 << (TF32_DROP_BITS - 1))  # half a TF32 ulp
    hi = ((magnitude & -(1 << TF32_DROP_BITS)) | sign).view(torch.float32)
    return hi, x - hi


def split_kv_reference(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain version of `split_kv_tf32`: fp32 (B, S, H, hd) k, v ->
    (k_hi, k_lo) (B*H, S, hd) and (vt_hi, vt_lo) (B*H, hd, S_pad), S_pad = S
    rounded up to 8, vᵀ's keys in VT_KEY_ORDER within each group of 8 and
    zero from S on; each pair from `tf32_split`, all contiguous."""
    b, s, h, hd = k.shape
    s_pad = -(-s // VT_KEY_GROUP) * VT_KEY_GROUP
    k_hi, k_lo = tf32_split(k.permute(0, 2, 1, 3).reshape(b * h, s, hd))
    vt = torch.zeros((b * h, hd, s_pad), dtype=v.dtype, device=v.device)
    vt[:, :, :s] = v.permute(0, 2, 3, 1).reshape(b * h, hd, s)
    order = torch.tensor(VT_KEY_ORDER, device=v.device)
    keys = (torch.arange(0, s_pad, VT_KEY_GROUP, device=v.device)[:, None] + order).reshape(-1)
    vt_hi, vt_lo = tf32_split(vt[:, :, keys])
    return k_hi.contiguous(), k_lo.contiguous(), vt_hi.contiguous(), vt_lo.contiguous()


@functools.cache
def build_attention_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library; returns it
    with its build time and nvcc log. The first CUDA call builds it anyway."""
    loaded = load_kernel_library("attention", ("attention.cu",))
    lib = loaded.lib
    # pointers and the stream as c_void_p, strides as 64-bit ints: ctypes
    # would otherwise pass Python ints as 32-bit C ints
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "flash_attn_bf16": [ptr] * 4 + [i32] * 4 + [i64] * 9 + [ptr],
        "split_kv_tf32": [ptr] * 6 + [i32] * 5 + [i64] * 6 + [ptr],
        "flash_attn_fp32": [ptr] * 6 + [i32] * 5 + [i64] * 3 + [ptr],
    }
    for name, args in signatures.items():
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
    # 16 bytes: the TMA tensor maps, the split pass's vector loads
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


def _call(name: str, device: torch.device, *args) -> None:
    """Launch `name` on the current stream of `device`; raise with the CUDA
    error string if the launch was refused."""
    lib = build_attention_kernel().lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.attention_error_string(code).decode()} ({code})"
        )


def _require_cuda_inputs(name: str, dtype: torch.dtype, q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    _check_inputs(name, dtype, q, k, v)
    if q.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}")


def attention_flops(q: torch.Tensor) -> int:
    """The standard count of self-attention over (B, S, H, hd) q, k and v:
    4·B·H·S²·hd (QKᵀ and P·V), what XLA counts for the JAX side's dots."""
    b, s, h, hd = q.shape
    return 4 * b * h * s * s * hd


def split_kv_tf32(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The fp32 attention kernel's split pass: fp32 (B, S, H, hd) k, v ->
    (k_hi, k_lo, vt_hi, vt_lo) as `split_kv_reference` lays them out. CUDA
    tensors launch `csrc/attention.cu`'s split_kv_tf32 into new scratch;
    CPU tensors take `split_kv_reference`; anything else raises."""
    if k.device.type == "cpu":
        if v.device.type != "cpu":
            raise ValueError("split_kv_tf32: k on the CPU but not v")
        for t_name, t in (("k", k), ("v", v)):
            if t.dtype != torch.float32:
                raise TypeError(f"split_kv_tf32: {t_name} must be torch.float32, got {t.dtype}")
        return split_kv_reference(k, v)
    _require_cuda_inputs("split_kv_tf32", torch.float32, k, k, v)
    b, s, h, hd = k.shape
    s_pad = -(-s // VT_KEY_GROUP) * VT_KEY_GROUP
    k_terms = torch.empty((2, b * h, s, hd), dtype=torch.float32, device=k.device)
    vt_terms = torch.empty((2, b * h, hd, s_pad), dtype=torch.float32, device=k.device)
    terms = (k_terms[0], k_terms[1], vt_terms[0], vt_terms[1])
    strides = [st for t in (k, v) for st in t.stride()[:3]]
    _call("split_kv_tf32", k.device, k.data_ptr(), v.data_ptr(),
          *(t.data_ptr() for t in terms), b, s, h, hd, s_pad, *strides)
    split_kv_tf32.launches += 1
    return terms


split_kv_tf32.launches = 0  # kernel launches since the count was last reset


def flash_attn_fp32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 (B, S, H, hd) pre-scaled q, k, v -> fp32 (B, S, H, hd), the
    products as split TF32 on the tensor cores (fp32-accurate), the sums and
    the softmax in fp32. On the card every call runs `split_kv_tf32` first.
    Replaces the Pallas flash_attention of `spotter_tpu/models/layers.py:126`.
    Every call notes its FLOPs (`attention_flops`)."""
    if q.device.type == "cpu":
        out = _cpu_reference("flash_attn_fp32", torch.float32, q, k, v)
        note_kernel_flops("flash_attn_fp32", attention_flops(q))
        return out
    _require_cuda_inputs("flash_attn_fp32", torch.float32, q, k, v)
    note_kernel_flops("flash_attn_fp32", attention_flops(q))
    b, s, h, hd = q.shape
    terms = split_kv_tf32(k, v)
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    _call("flash_attn_fp32", q.device, q.data_ptr(),
          *(t.data_ptr() for t in terms), out.data_ptr(), b, s, h, hd, terms[2].shape[2],
          *q.stride()[:3])
    flash_attn_fp32.launches += 1
    return out


flash_attn_fp32.launches = 0  # kernel launches since the count was last reset


def flash_attn_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """bf16 (B, S, H, hd) pre-scaled q, k, v -> bf16 (B, S, H, hd), the
    products on the tensor cores with fp32 sums and the softmax in fp32.
    Replaces the Pallas splash kernel of `spotter_tpu/models/layers.py:185`.
    Every call notes its FLOPs (`attention_flops`)."""
    if q.device.type == "cpu":
        out = _cpu_reference("flash_attn_bf16", torch.bfloat16, q, k, v)
        note_kernel_flops("flash_attn_bf16", attention_flops(q))
        return out
    _require_cuda_inputs("flash_attn_bf16", torch.bfloat16, q, k, v)
    note_kernel_flops("flash_attn_bf16", attention_flops(q))
    b, s, h, hd = q.shape
    out = torch.empty((b, s, h, hd), dtype=torch.bfloat16, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    _call("flash_attn_bf16", q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), out.data_ptr(), b, s, h, hd, *strides)
    flash_attn_bf16.launches += 1
    return out


flash_attn_bf16.launches = 0
