"""The int8 kernels of the port: the GEMM (`csrc/int8_gemm.cu`) and the
quantize and dequant passes around it (`csrc/quant.cu`), with their plain
PyTorch versions.

The JAX package computes its int8 quantization (spotter_tpu/utils/quant.py)
with XLA's s8 convolution and dot_general, which fuse the quantize and the
dequant; PyTorch has no int8 convolution or batched int8 matmul on CUDA,
so the port runs hand-written passes around each quantized product:

- `amax_s8`: the exact amax of each scale's group (a memset of the group
  words, then one amax kernel), which every quantize wrapper runs first;
- `quantize_s8` (one counter for its entries `quantize_rows`,
  `quantize_heads`, `quantize_im2col`, `quantize_weight_rows`): the codes,
  written in the GEMM's K-major layout from the amax words, rows padded
  with zero codes to a multiple of 16 (TMA's row pitch; the int32 sums do
  not change);
- `int8_gemm_kmajor`: row 9's wgmma kernel on K-major operands (A (G, M, K),
  Bᵀ (N, K) shared or (G, N, K)), batched over G, any M and N;
- `dequant_s32` (entries `dequant_rows`, `dequant_heads`, `dequant_av`,
  `dequant_nchw`): float(y) * (sa * sb) cast to the output dtype, a
  separate pass (the GEMM's epilogue stays the redesigned kernel's; fusing
  it is a later speed question). The convolution's dequant writes NCHW
  through a shared-memory tile, so the frozen BN that follows sees the
  float path's layout.

`int8_gemm` (B row-major: `transpose_s8`, then the same GEMM) is the
measurement tool's entry (tools/bench_int8.py). Each counter adds one where
its kernel launches (`<wrapper>.launches`; the quantize wrappers add one to
`amax_s8` and one to `quantize_s8`); on a CPU tensor a wrapper computes its
plain version, on a CUDA tensor it launches its kernel or raises.

`scale_of` and `codes_of` are the numeric rule of every plain version here
and in utils/quant.py: scale = max(amax, 1e-12) / 127 by a true fp32
division, code = clip(round_half_even(x / scale), -127, 127).
"""
import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from spotter_tpu_torch.obs.perf import note_kernel_flops
from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library

TILE_MULTIPLE = 16  # M, N and K the tool's entry takes; K the served entry takes
MAX_K = (2**31 - 1) // 128**2  # beyond it an int32 sum of int8 products could overflow
# quantize_s8's output layouts (csrc/quant.cu)
LAYOUT_ROWS, LAYOUT_HEADS, LAYOUT_HEADS_T = 0, 1, 2
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def pad16(n: int) -> int:
    return -(-n // TILE_MULTIPLE) * TILE_MULTIPLE


# --- builds -------------------------------------------------------------------


@functools.cache
def build_int8_gemm_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the GEMM library."""
    loaded = load_kernel_library("int8_gemm", ("int8_gemm.cu",))
    lib = loaded.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.int8_gemm_kmajor_s8s8s32.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
    lib.int8_gemm_kmajor_s8s8s32.restype = i32
    lib.int8_transpose_s8.argtypes = [ptr] * 2 + [i32] * 2 + [ptr]
    lib.int8_transpose_s8.restype = i32
    lib.int8_gemm_empty_launch.argtypes = [ptr]
    lib.int8_gemm_empty_launch.restype = i32
    lib.int8_gemm_error_string.argtypes = [i32]
    lib.int8_gemm_error_string.restype = ctypes.c_char_p
    return loaded


@functools.cache
def build_quant_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the quantize/dequant library."""
    loaded = load_kernel_library("quant", ("quant.cu",))
    lib = loaded.lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for suffix in SUFFIX.values():
        signatures = {
            "amax_s8": [ptr] * 3 + [i32] + [ptr] * 2,
            "quantize_s8": [ptr] * 3 + [i32] * 3 + [ptr] * 4,
            "quantize_im2col_s8": [ptr] * 3 + [i32] * 4 + [ptr] * 4,
            "dequant_rows": [ptr] * 3 + [i64, i32, i64, ptr, ptr],
            "dequant_heads": [ptr] * 3 + [i32, i64, i32, i32, ptr, ptr],
            "dequant_nchw": [ptr] * 3 + [i32, i32, i64, ptr, ptr],
        }
        for name, args in signatures.items():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = args
            fn.restype = i32
    lib.quant_error_string.argtypes = [i32]
    lib.quant_error_string.restype = ctypes.c_char_p
    return loaded


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(name: str, code: int, error_string) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(code).decode()} ({code})")


def _gemm_call(name: str, device: torch.device, *args) -> None:
    lib = build_int8_gemm_kernel().lib
    with torch.cuda.device(device):
        code = getattr(lib, name)(*args, _stream(device))
    _raise_on(name, code, lib.int8_gemm_error_string)


def _quant_call(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    lib = build_quant_kernel().lib
    with torch.cuda.device(device):
        code = getattr(lib, f"{name}_{SUFFIX[dtype]}")(*args, _stream(device))
    _raise_on(name, code, lib.quant_error_string)


def _device_of(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type


# --- the tool's GEMM entry (B row-major) --------------------------------------


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_gemm: expected a (M, K) and b (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_gemm: operands must be int8, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"int8_gemm: a is on {a.device}, b on {b.device}")
    if a.shape[1] > MAX_K:
        raise ValueError(f"int8_gemm: K = {a.shape[1]} > {MAX_K} could overflow int32")


def int8_gemm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a (M, K) int8 @ b (K, N) int8 -> (M, N) int32, exact:
    an int64 product on the CPU, a float64 one on the card (cuBLAS has no
    integer GEMM; every partial sum is an integer below 2**53)."""
    _check_operands(a, b)
    if a.device.type == "cuda":
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)
    return torch.matmul(a.to(torch.int64), b.to(torch.int64)).to(torch.int32)


def _check_kernel_operands(name: str, *tensors: torch.Tensor) -> None:
    """What the tool's entry takes: dims that are positive multiples of 16
    (TMA's 16-byte row strides, the transpose's 16-byte chunks), contiguous
    and 16-byte aligned."""
    dims = [d for t in tensors for d in t.shape]
    if any(d % TILE_MULTIPLE for d in dims) or min(dims) == 0:
        raise ValueError(f"{name}: every dimension must be a positive multiple of "
                         f"{TILE_MULTIPLE}, got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")


def transpose_s8_reference(b: torch.Tensor) -> torch.Tensor:
    """Plain version of the transpose pass: b (K, N) -> (N, K), contiguous."""
    return b.t().contiguous()


def transpose_s8(b: torch.Tensor) -> torch.Tensor:
    """b (K, N) int8 -> bᵀ (N, K) int8, contiguous: the pass that puts B
    K-major for `int8_gemm`'s wgmma. On a CUDA tensor its kernel (K and N
    multiples of 16, contiguous, 16-byte aligned); on a CPU tensor the plain
    version; any other device raises."""
    _device_of("transpose_s8", b)
    if b.dim() != 2 or b.dtype != torch.int8:
        raise TypeError(f"transpose_s8: expected a 2-D int8 tensor, got {b.dtype} "
                        f"{tuple(b.shape)}")
    if b.device.type == "cpu":
        return transpose_s8_reference(b)
    _check_kernel_operands("transpose_s8", b)
    k, n = b.shape
    bt = torch.empty((n, k), dtype=torch.int8, device=b.device)
    _gemm_call("int8_transpose_s8", b.device, b.data_ptr(), bt.data_ptr(), k, n)
    transpose_s8.launches += 1
    return bt


transpose_s8.launches = 0  # kernel launches since the count was last reset


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32, exact, both row-major.
    Replaces the Pallas kernel of `tools/bench_int8.py:142`. On a CUDA tensor
    (M, N, K multiples of 16, contiguous, 16-byte aligned) `transpose_s8` of
    b, then the GEMM kernel on the K-major operands, its launch counted here
    and not on `int8_gemm_kmajor`; on a CPU tensor the plain version; any
    other device raises."""
    _device_of("int8_gemm", a)
    _check_operands(a, b)
    note_kernel_flops("int8_gemm", 2 * a.shape[0] * a.shape[1] * b.shape[1])
    if a.device.type == "cpu":
        return int8_gemm_reference(a, b)
    _check_kernel_operands("int8_gemm", a, b)
    out = _launch_gemm_kmajor(a, transpose_s8(b))
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0  # kernel launches since the count was last reset


def empty_launch() -> None:
    """One launch of an empty kernel on the current stream (the floor)."""
    lib = build_int8_gemm_kernel().lib
    code = lib.int8_gemm_empty_launch(torch.cuda.current_stream().cuda_stream)
    _raise_on("empty launch", code, lib.int8_gemm_error_string)


# --- the served GEMM entry (K-major operands, batched, ragged) -------------------


def int8_gemm_kmajor_reference(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Plain version: a (M, K) or (G, M, K) int8, bt (N, K) or (G, N, K) int8
    -> a @ btᵀ, (M, N) or (G, M, N) int32, exact (int64 on the CPU, float64
    on the card)."""
    wide = torch.int64 if a.device.type == "cpu" else torch.float64
    return torch.matmul(a.to(wide), bt.to(wide).transpose(-1, -2)).to(torch.int32)


def int8_gemm_kmajor(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a (M, K) or (G, M, K) int8 times btᵀ, bt (N, K) (shared by the batch)
    or (G, N, K), int8 -> int32 (M, N) or (G, M, N), exact: the served entry
    of row 9's kernel, both operands K-major as the quantize passes write
    them, K a multiple of 16, any M and N. On a CUDA tensor the kernel
    (contiguous, 16-byte aligned operands); on a CPU tensor the plain
    version; any other device raises. Every call notes its FLOPs, the
    standard 2·M·N·K a product (the count XLA gives the JAX side's dot)."""
    _device_of("int8_gemm_kmajor", a)
    if a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError(f"int8_gemm_kmajor: operands must be int8, got {a.dtype}, {bt.dtype}")
    if a.dim() not in (2, 3) or bt.dim() not in (2, 3) or a.shape[-1] != bt.shape[-1] or (
            bt.dim() == 3 and (a.dim() != 3 or bt.shape[0] != a.shape[0])):
        raise ValueError(f"int8_gemm_kmajor: expected a (G, M, K) and bt (N, K) or (G, N, K), "
                         f"got {tuple(a.shape)} and {tuple(bt.shape)}")
    if a.device != bt.device:
        raise ValueError(f"int8_gemm_kmajor: a is on {a.device}, bt on {bt.device}")
    if a.shape[-1] > MAX_K:
        raise ValueError(f"int8_gemm_kmajor: K = {a.shape[-1]} > {MAX_K} could overflow int32")
    groups = a.shape[0] if a.dim() == 3 else 1
    note_kernel_flops("int8_gemm_kmajor",
                      2 * groups * a.shape[-2] * bt.shape[-2] * a.shape[-1])
    if a.device.type == "cpu":
        return int8_gemm_kmajor_reference(a, bt)
    out = _launch_gemm_kmajor(a, bt)
    int8_gemm_kmajor.launches += 1
    return out


int8_gemm_kmajor.launches = 0


def _launch_gemm_kmajor(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    k = a.shape[-1]
    if k % TILE_MULTIPLE or k == 0 or a.numel() == 0 or bt.numel() == 0:
        raise ValueError(f"int8_gemm_kmajor: K must be a positive multiple of {TILE_MULTIPLE} "
                         f"and M, N positive, got {tuple(a.shape)}, {tuple(bt.shape)}")
    if not (a.is_contiguous() and bt.is_contiguous()) or a.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("int8_gemm_kmajor: operands must be contiguous and 16-byte aligned")
    g = a.shape[0] if a.dim() == 3 else 1
    m, n = a.shape[-2], bt.shape[-2]
    out = torch.empty((*a.shape[:-1], n), dtype=torch.int32, device=a.device)
    _gemm_call("int8_gemm_kmajor_s8s8s32", a.device, a.data_ptr(), bt.data_ptr(),
               out.data_ptr(), g, m, n, k, int(bt.dim() == 3))
    return out


# --- amax_s8 and quantize_s8 -------------------------------------------------------


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in fp32, as the JAX package forms it: a true
    division (a Python-number divisor would let PyTorch's CUDA kernel
    multiply by its reciprocal instead, which differs in the last bit)."""
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)


def codes_of(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(x / scale), -127, 127) as int8, x fp32."""
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def _pad_cols(codes: torch.Tensor, cols_pad: int) -> torch.Tensor:
    return F.pad(codes, (0, cols_pad - codes.shape[-1])).contiguous()


def _check_float(name: str, x: torch.Tensor) -> None:
    if x.dtype not in SUFFIX:
        raise TypeError(f"{name}: takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


class LaunchCount:
    """The launch count of a kernel that several wrappers launch."""

    def __init__(self) -> None:
        self.launches = 0


amax_s8 = LaunchCount()  # the amax pass, every layout
quantize_s8 = LaunchCount()  # the quantize pass, every layout
dequant_s32 = LaunchCount()  # the dequant pass, every layout


def _view_args(sizes, strides):
    return (ctypes.c_longlong * 4)(*sizes), (ctypes.c_longlong * 4)(*strides)


def _launch_amax(x: torch.Tensor, sizes, strides, head_axis: int, groups: int) -> torch.Tensor:
    """The amax pass over a 4-D strided view of x: (groups,) fp32, max |x|
    of each group (group g = i0 * heads + the head index, or i0 alone when
    head_axis is 0), exact."""
    amax = torch.empty((groups,), dtype=torch.float32, device=x.device)
    _quant_call("amax_s8", x.dtype, x.device, x.data_ptr(), *_view_args(sizes, strides),
                head_axis, amax.data_ptr())
    amax_s8.launches += 1
    return amax


def _launch_quantize(x: torch.Tensor, sizes, strides, head_axis: int, layout: int,
                     cols_pad: int, out_shape: tuple, groups: int):
    amax = _launch_amax(x, sizes, strides, head_axis, groups)
    codes = torch.empty(out_shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((groups,), dtype=torch.float32, device=x.device)
    _quant_call("quantize_s8", x.dtype, x.device, x.data_ptr(), *_view_args(sizes, strides),
                head_axis, layout, cols_pad, amax.data_ptr(), codes.data_ptr(), scales.data_ptr())
    quantize_s8.launches += 1
    return codes, scales


def quantize_rows_reference(x: torch.Tensor, rows_per_group: int,
                            cols_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the rows layout: x (M, K) float -> codes (M, cols_pad)
    (zero past K), one fp32 scale per group of `rows_per_group` rows."""
    m, k = x.shape
    xf = x.to(torch.float32).reshape(m // rows_per_group, rows_per_group * k)
    scale = scale_of(xf.abs().amax(dim=1, keepdim=True))
    return _pad_cols(codes_of(xf, scale).reshape(m, k), cols_pad), scale.reshape(-1)


def quantize_rows(x: torch.Tensor, rows_per_group: int,
                  cols_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) fp32 or bf16 (any strides) -> (codes (M, cols_pad) int8,
    scales (M / rows_per_group,) fp32): each group of `rows_per_group`
    consecutive rows takes one scale (a sample's rows, a weight's output
    channel, an attention head's rows)."""
    name = "quantize_rows"
    _device_of(name, x)
    _check_float(name, x)
    m, k = x.shape
    if m % rows_per_group or cols_pad < k or cols_pad % TILE_MULTIPLE:
        raise ValueError(f"{name}: {m} rows in groups of {rows_per_group}, {k} columns "
                         f"padded to {cols_pad}")
    if x.device.type == "cpu":
        return quantize_rows_reference(x, rows_per_group, cols_pad)
    groups = m // rows_per_group
    sizes = (groups, rows_per_group, 1, k)
    strides = (x.stride(0) * rows_per_group, x.stride(0), 0, x.stride(1))
    return _launch_quantize(x, sizes, strides, 0, LAYOUT_ROWS, cols_pad, (m, cols_pad), groups)


def quantize_heads_reference(x: torch.Tensor, transpose: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the heads layouts: x (B, T, H, hd) -> codes (B*H, T,
    hd_pad), or with `transpose` (B*H, hd, T_pad), and (B*H,) fp32 scales."""
    b, t, h, hd = x.shape
    xf = x.to(torch.float32)
    scale = scale_of(xf.abs().amax(dim=(1, 3), keepdim=True))  # (B, 1, H, 1)
    codes = codes_of(xf, scale)
    if transpose:
        codes = _pad_cols(codes.permute(0, 2, 3, 1).reshape(b * h, hd, t), pad16(t))
    else:
        codes = _pad_cols(codes.permute(0, 2, 1, 3).reshape(b * h, t, hd), pad16(hd))
    return codes, scale.reshape(-1)


def quantize_heads(x: torch.Tensor, transpose: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, H, hd) fp32 or bf16 (any strides) -> per-(sample, head)
    codes, head-major: (B*H, T, hd_pad) (Q and K of QKᵀ), or with
    `transpose` (B*H, hd, T_pad) (V of attn·V, K-major over T); and the
    (B*H,) fp32 scales, b-major."""
    name = "quantize_heads"
    _device_of(name, x)
    _check_float(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, T, H, hd), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_heads_reference(x, transpose)
    b, t, h, hd = x.shape
    if transpose:
        layout, shape = LAYOUT_HEADS_T, (b * h, hd, pad16(t))
    else:
        layout, shape = LAYOUT_HEADS, (b * h, t, pad16(hd))
    return _launch_quantize(x, tuple(x.shape), x.stride(), 2, layout, shape[-1], shape, b * h)


def amax_samples_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `amax_samples`."""
    return x.to(torch.float32).abs().amax(dim=tuple(range(1, x.dim())))


def amax_samples(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) fp32 or bf16 (any strides) -> (B,) fp32, max |x| of
    each sample, exact: the amax pass of `quantize_im2col`."""
    name = "amax_samples"
    _device_of(name, x)
    _check_float(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, C, H, W), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return amax_samples_reference(x)
    return _launch_amax(x, tuple(x.shape), x.stride(), 0, x.shape[0])


def _im2col_checks(name: str, x: torch.Tensor, kernel_size: int, k_pad: int) -> None:
    _device_of(name, x)
    _check_float(name, x)
    if x.dim() != 4 or k_pad < x.shape[1] * kernel_size**2 or k_pad % TILE_MULTIPLE:
        raise ValueError(f"{name}: expected NCHW x and k_pad >= C*k*k, a multiple of "
                         f"{TILE_MULTIPLE}; got {tuple(x.shape)}, k {kernel_size}, {k_pad}")


def im2col_codes_reference(x: torch.Tensor, amax: torch.Tensor, kernel_size: int, stride: int,
                           padding: int, k_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `im2col_codes`: the per-sample codes unfolded
    (F.unfold's (c, ky, kx) column order), (B*Ho*Wo, k_pad), and (B,) fp32
    scales."""
    b = x.shape[0]
    scale = scale_of(amax.view(b, 1, 1, 1))
    cols = F.unfold(codes_of(x.to(torch.float32), scale).to(torch.float32), kernel_size,
                    padding=padding, stride=stride)  # (B, K, L), the codes copied exactly
    cols = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
    return _pad_cols(cols, k_pad), scale.reshape(b)


def im2col_codes(x: torch.Tensor, amax: torch.Tensor, kernel_size: int, stride: int,
                 padding: int, k_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """NCHW x fp32 or bf16 (any strides) and its per-sample amax (B,) fp32
    -> (codes (B*Ho*Wo, k_pad) int8, scales (B,) fp32): the quantize pass of
    `quantize_im2col`."""
    name = "im2col_codes"
    _im2col_checks(name, x, kernel_size, k_pad)
    if x.device.type == "cpu":
        return im2col_codes_reference(x, amax, kernel_size, stride, padding, k_pad)
    if amax.shape != (x.shape[0],) or amax.dtype != torch.float32 or not amax.is_contiguous():
        raise ValueError(f"{name}: amax must be ({x.shape[0]},) fp32, contiguous")
    b, _, h, w = x.shape
    ho = (h + 2 * padding - kernel_size) // stride + 1
    wo = (w + 2 * padding - kernel_size) // stride + 1
    codes = torch.empty((b * ho * wo, k_pad), dtype=torch.int8, device=x.device)
    scales = torch.empty((b,), dtype=torch.float32, device=x.device)
    _quant_call("quantize_im2col_s8", x.dtype, x.device, x.data_ptr(),
                *_view_args(x.shape, x.stride()), kernel_size, stride, padding, k_pad,
                amax.data_ptr(), codes.data_ptr(), scales.data_ptr())
    quantize_s8.launches += 1
    return codes, scales


def quantize_im2col_reference(x: torch.Tensor, kernel_size: int, stride: int, padding: int,
                              k_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `quantize_im2col`."""
    return im2col_codes_reference(x, amax_samples_reference(x), kernel_size, stride, padding,
                                  k_pad)


def quantize_im2col(x: torch.Tensor, kernel_size: int, stride: int, padding: int,
                    k_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """NCHW x fp32 or bf16 (any strides) -> (codes (B*Ho*Wo, k_pad) int8,
    per-sample scales (B,) fp32): the im2col matrix of a kernel_size x
    kernel_size convolution (zero padding, stride), column (c, ky, kx) as the
    OIHW weight flattens, zero past C*k*k. `amax_samples`, then
    `im2col_codes`."""
    _im2col_checks("quantize_im2col", x, kernel_size, k_pad)
    return im2col_codes(x, amax_samples(x), kernel_size, stride, padding, k_pad)


@dataclass
class QuantizedWeight:
    """A layer's weight as the GEMM takes it: codes (N, k_pad) int8, K-major
    (a row an output channel, zero past K), and (N,) fp32 scales."""

    codes: torch.Tensor
    scale: torch.Tensor

    @property
    def k_pad(self) -> int:
        return self.codes.shape[1]


def quantize_weight_rows(w: torch.Tensor) -> QuantizedWeight:
    """A weight (N, ...) fp32 (output channel first: OIHW, or (N, K)) ->
    its per-output-channel codes and scales, through the rows layout."""
    flat = w.reshape(w.shape[0], -1)
    codes, scale = quantize_rows(flat, 1, pad16(flat.shape[1]))
    return QuantizedWeight(codes, scale)


# --- dequant_s32 ------------------------------------------------------------------


def _dequant_checks(name: str, y: torch.Tensor, *scales: torch.Tensor,
                    out_dtype: torch.dtype) -> str:
    device = _device_of(name, y)
    if y.dtype != torch.int32 or any(s.dtype != torch.float32 for s in scales):
        raise TypeError(f"{name}: takes int32 y and fp32 scales")
    if out_dtype not in SUFFIX:
        raise TypeError(f"{name}: writes float32 or bfloat16, not {out_dtype}")
    if device == "cuda" and not (y.is_contiguous() and all(s.is_contiguous() for s in scales)):
        raise ValueError(f"{name}: y and the scales must be contiguous")
    return device


def dequant_rows_reference(y, sa, sb, rows_per_group: int, out_dtype) -> torch.Tensor:
    """Plain version of `dequant_rows`."""
    m, n = y.shape
    s = sa.view(-1, 1, 1) * sb.view(1, 1, n)
    return (y.view(-1, rows_per_group, n).to(torch.float32) * s).to(out_dtype).view(m, n)


def dequant_heads_reference(y, sa, sb, out_dtype) -> torch.Tensor:
    """Plain version of `dequant_heads`."""
    return (y.to(torch.float32) * (sa * sb).view(-1, 1, 1)).to(out_dtype)


def dequant_av_reference(y, sa, sb, b: int, h: int, out_dtype) -> torch.Tensor:
    """Plain version of `dequant_av`."""
    out = y.to(torch.float32) * (sa * sb).view(-1, 1, 1)
    return out.view(b, h, *y.shape[1:]).transpose(1, 2).to(out_dtype)


def dequant_nchw_reference(y, sa, sb, b: int, ho: int, wo: int, out_dtype) -> torch.Tensor:
    """Plain version of `dequant_nchw`."""
    n = y.shape[1]
    s = sa.view(-1, 1, 1, 1) * sb.view(1, 1, 1, n)
    out = (y.view(b, ho, wo, n).to(torch.float32) * s).to(out_dtype)
    return out.permute(0, 3, 1, 2).contiguous()


def dequant_rows(y: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, rows_per_group: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """y (M, N) int32 -> float(y) * (sa[m / rows_per_group] * sb[n]), (M, N)
    `out_dtype`: a dense product."""
    if _dequant_checks("dequant_rows", y, sa, sb, out_dtype=out_dtype) == "cpu":
        return dequant_rows_reference(y, sa, sb, rows_per_group, out_dtype)
    m, n = y.shape
    out = torch.empty((m, n), dtype=out_dtype, device=y.device)
    _quant_call("dequant_rows", out_dtype, y.device, y.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                m, n, rows_per_group, out.data_ptr())
    dequant_s32.launches += 1
    return out


def dequant_heads(y: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """y (G, M, N) int32 -> float(y) * (sa[g] * sb[g]), (G, M, N)
    `out_dtype`: QKᵀ's logits."""
    if _dequant_checks("dequant_heads", y, sa, sb, out_dtype=out_dtype) == "cpu":
        return dequant_heads_reference(y, sa, sb, out_dtype)
    g, m, n = y.shape
    out = torch.empty((g, m, n), dtype=out_dtype, device=y.device)
    _quant_call("dequant_heads", out_dtype, y.device, y.data_ptr(), sa.data_ptr(),
                sb.data_ptr(), g, m, n, 0, out.data_ptr())
    dequant_s32.launches += 1
    return out


def dequant_av(y: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, b: int, h: int,
               out_dtype: torch.dtype) -> torch.Tensor:
    """y (B*H, Tq, hd) int32 -> float(y) * (sa[g] * sb[g]) as (B, Tq, H, hd)
    `out_dtype`: attn·V's output in the model's token layout."""
    if _dequant_checks("dequant_av", y, sa, sb, out_dtype=out_dtype) == "cpu":
        return dequant_av_reference(y, sa, sb, b, h, out_dtype)
    g, m, n = y.shape
    out = torch.empty((b, m, h, n), dtype=out_dtype, device=y.device)
    _quant_call("dequant_heads", out_dtype, y.device, y.data_ptr(), sa.data_ptr(),
                sb.data_ptr(), g, m, n, h, out.data_ptr())
    dequant_s32.launches += 1
    return out


def dequant_nchw(y: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, b: int, ho: int, wo: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """y (B*Ho*Wo, N) int32 -> float(y) * (sa[b] * sb[n]) as NCHW (B, N, Ho,
    Wo) `out_dtype`, contiguous: a convolution's output."""
    if _dequant_checks("dequant_nchw", y, sa, sb, out_dtype=out_dtype) == "cpu":
        return dequant_nchw_reference(y, sa, sb, b, ho, wo, out_dtype)
    n = y.shape[1]
    out = torch.empty((b, n, ho, wo), dtype=out_dtype, device=y.device)
    _quant_call("dequant_nchw", out_dtype, y.device, y.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                b, n, ho * wo, out.data_ptr())
    dequant_s32.launches += 1
    return out
