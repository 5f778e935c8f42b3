"""The int8 kernels of the port: the convolution (`csrc/int8_conv.cu`), the
GEMM (`csrc/int8_gemm.cu`) and the quantize and dequant passes around them
(`csrc/quant.cu`), with their plain PyTorch versions.

The JAX package computes its int8 quantization (spotter_tpu/utils/quant.py)
with XLA's s8 convolution and dot_general, which fuse the quantize and the
dequant; PyTorch has no int8 convolution or batched int8 matmul on CUDA,
so the port runs hand-written passes around each quantized product:

- `amax_s8`: each scale's group's amax as partial maxima, (groups, parts)
  fp32, in one launch (no memset, no atomics), which every quantize
  wrapper runs first; max is order-free, so the max of the partials is
  the exact amax;
- `quantize_s8` (one counter for its entries `quantize_rows`,
  `quantize_heads`, `quantize_weight_rows`): the codes, written in the
  GEMM's K-major layout from the partials, rows padded with zero codes to a
  multiple of 16 (TMA's row pitch; the int32 sums do not change); a heads
  call whose (sample, head) group fits a block's shared memory
  (`heads_one_launch`) is one launch of its own kernel, amax and codes
  from one read, and no `amax_s8`;
- `quantize_nhwc_s8` (`nhwc_codes`): the convolution's NHWC codes from
  NCHW x and its amax partials, a streaming transpose through shared
  memory;
- `int8_gemm_kmajor`: row 9's wgmma kernel on K-major operands (A (G, M, K),
  Bᵀ (N, K) shared or (G, N, K)), batched over G, any M and N;
- `dequant_s32` (entries `dequant_rows`, `dequant_heads`, `dequant_av`):
  float(y) * (sa * sb) cast to the output dtype, a separate pass (the
  GEMM's epilogue stays the redesigned kernel's; fusing it is a later
  speed question);
- `conv_s8`: the quantized convolution as one implicit-GEMM kernel on
  wgmma: the NHWC codes of `nhwc_codes` gathered in place, the tap-major
  weight codes of `quantize_conv_weight`, the dequant and the NCHW store
  (the float path's layout, for the frozen BN that follows) in its
  epilogue. The served convolution is `amax_samples`, `nhwc_codes` and
  `conv_s8`.

`int8_gemm` (B row-major: `transpose_s8`, then the same GEMM) is the
measurement tool's entry (tools/bench_int8.py). Each counter adds one where
its kernel launches (`<wrapper>.launches`; the quantize wrappers add one to
`amax_s8` and one to `quantize_s8` or `quantize_nhwc_s8`, a heads call in
one launch one to `quantize_s8` alone; their `paths` count the launches by
the path each took); on a CPU tensor a wrapper computes its plain version,
on a CUDA tensor it launches its kernel or raises.

`scale_of` and `codes_of` are the numeric rule of every plain version here
and in utils/quant.py: scale = max(amax, 1e-12) / 127 by a true fp32
division, code = clip(round_half_even(x / scale), -127, 127).
"""
import collections
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

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
def build_int8_conv_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the convolution library."""
    loaded = load_kernel_library("int8_conv", ("int8_conv.cu",))
    lib = loaded.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in SUFFIX.values():
        fn = getattr(lib, f"conv_s8_{suffix}")
        fn.argtypes = [ptr] * 5 + [i32] * 9 + [ptr]
        fn.restype = i32
    lib.conv_s8_error_string.argtypes = [i32]
    lib.conv_s8_error_string.restype = ctypes.c_char_p
    return loaded


@functools.cache
def build_quant_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the quantize/dequant library."""
    loaded = load_kernel_library("quant", ("quant.cu",))
    lib = loaded.lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for suffix in SUFFIX.values():
        signatures = {
            "amax_s8": [ptr] * 3 + [i32] * 2 + [ptr] * 3,
            "quantize_s8": [ptr] * 3 + [i32] * 3 + [ptr, i32] + [ptr] * 4,
            "quantize_heads_s8": [ptr] * 3 + [i32] * 2 + [ptr] * 3,
            "quantize_nhwc_s8": [ptr] * 3 + [i32, ptr, i32] + [ptr] * 4,
            "dequant_rows": [ptr] * 3 + [i64, i32, i64, ptr, ptr],
            "dequant_heads": [ptr] * 3 + [i32, i64, i32, i32, ptr, ptr],
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
    """The launch count of a kernel that several wrappers launch, and the
    launches by the path each took (`paths`)."""

    def __init__(self) -> None:
        self.launches = 0
        self.paths = collections.Counter()

    def count(self, path: str) -> None:
        self.launches += 1
        self.paths[path] += 1


# the amax pass, every layout; its paths (csrc/quant.cu `amax_pass`): through
# the strides, or 16-byte loads where each group fills one run of memory
amax_s8 = LaunchCount()
AMAX_PATHS = ("general", "fast")
# the quantize passes' kernels (csrc/quant.cu `QuantPath`): the rows kernel
# and the transpose kernel, each with 16-byte loads or a value at a time
# through any strides (`_scalar`), and the one-launch heads kernel
QUANT_PATHS = ("rows", "rows_scalar", "transpose", "transpose_scalar", "group")
quantize_s8 = LaunchCount()  # the rows, heads and heads_t layouts
quantize_nhwc_s8 = LaunchCount()  # the convolution's NHWC codes
dequant_s32 = LaunchCount()  # the dequant pass, every layout
# a (sample, head) group of at most this many bytes is one launch of the
# heads kernel (csrc/quant.cu kHeadsGroupMaxBytes): read once into a
# block's shared memory, its amax and codes from there
HEADS_GROUP_MAX_BYTES = 96 * 1024

AMAX_BLOCKS_PER_SM = 8  # the amax pass's grid: this many 256-thread blocks a multiprocessor
AMAX_MIN_SHARE = 256 * 16  # values a block of the amax pass reads at least, but the last


def amax_parts(size: int, groups: int, multiprocessors: int) -> int:
    """The amax pass's partial maxima a group, each one block's: enough
    blocks to fill the card, but no more than a group's AMAX_MIN_SHARE-value
    shares (a weight's row is one block)."""
    fill = -(-multiprocessors * AMAX_BLOCKS_PER_SM // groups)
    return max(1, min(fill, -(-size // AMAX_MIN_SHARE)))


@functools.cache
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _view_args(sizes, strides):
    return (ctypes.c_longlong * 4)(*sizes), (ctypes.c_longlong * 4)(*strides)


def amax_view(x: torch.Tensor, sizes, strides, head_axis: int, groups: int) -> torch.Tensor:
    """The amax pass over a 4-D strided view of x (a CUDA tensor): (groups,
    parts) fp32 partial maxima of |x| of each group (group g = i0 * heads +
    the head index, or i0 alone when head_axis is 0), whose max over parts
    is the group's amax, exact."""
    size = sizes[0] * sizes[1] * sizes[2] * sizes[3] // groups
    parts = amax_parts(size, groups, _multiprocessors(x.device))
    partials = torch.empty((groups, parts), dtype=torch.float32, device=x.device)
    path = ctypes.c_int(-1)
    _quant_call("amax_s8", x.dtype, x.device, x.data_ptr(), *_view_args(sizes, strides),
                head_axis, parts, partials.data_ptr(), ctypes.byref(path))
    amax_s8.count(AMAX_PATHS[path.value])
    return partials


def quantize_view(x: torch.Tensor, sizes, strides, head_axis: int, layout: int, cols_pad: int,
                  out_shape: tuple, partials: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The quantize pass over the same view (a CUDA tensor), from
    `amax_view`'s partials: codes `out_shape` int8 in `layout`, (groups,)
    fp32 scales."""
    codes = torch.empty(out_shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((partials.shape[0],), dtype=torch.float32, device=x.device)
    path = ctypes.c_int(-1)
    _quant_call("quantize_s8", x.dtype, x.device, x.data_ptr(), *_view_args(sizes, strides),
                head_axis, layout, cols_pad, partials.data_ptr(), partials.shape[1],
                codes.data_ptr(), scales.data_ptr(), ctypes.byref(path))
    quantize_s8.count(QUANT_PATHS[path.value])
    return codes, scales


def _launch_quantize(x: torch.Tensor, sizes, strides, head_axis: int, layout: int,
                     cols_pad: int, out_shape: tuple, groups: int):
    partials = amax_view(x, sizes, strides, head_axis, groups)
    return quantize_view(x, sizes, strides, head_axis, layout, cols_pad, out_shape, partials)


def rows_view(x: torch.Tensor, rows_per_group: int):
    """x (M, K) as the rows layout's 4-D view: (sizes, strides, groups), one
    group of `rows_per_group` rows a scale."""
    m, k = x.shape
    groups = m // rows_per_group
    return ((groups, rows_per_group, 1, k),
            (x.stride(0) * rows_per_group, x.stride(0), 0, x.stride(1)), groups)


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
    sizes, strides, groups = rows_view(x, rows_per_group)
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


def heads_one_launch(t: int, hd: int, dtype: torch.dtype) -> bool:
    """Whether a heads call on (B, t, H, hd) `dtype` is one launch: its
    (sample, head) group of t * hd values, rounded up to 16 bytes, is at
    most HEADS_GROUP_MAX_BYTES. Else it is two: the amax pass, then the
    quantize pass."""
    return pad16(t * hd * torch.finfo(dtype).bits // 8) <= HEADS_GROUP_MAX_BYTES


def quantize_heads(x: torch.Tensor, transpose: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, H, hd) fp32 or bf16 (any strides) -> per-(sample, head)
    codes, head-major: (B*H, T, hd_pad) (Q and K of QKᵀ), or with
    `transpose` (B*H, hd, T_pad) (V of attn·V, K-major over T); and the
    (B*H,) fp32 scales, b-major. On the card one launch where
    `heads_one_launch` says so, else the amax pass and the quantize pass."""
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
    if not heads_one_launch(t, hd, x.dtype):
        return _launch_quantize(x, tuple(x.shape), x.stride(), 2, layout, shape[-1], shape, b * h)
    codes = torch.empty(shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((b * h,), dtype=torch.float32, device=x.device)
    _quant_call("quantize_heads_s8", x.dtype, x.device, x.data_ptr(),
                *_view_args(x.shape, x.stride()), layout, shape[-1], codes.data_ptr(),
                scales.data_ptr())
    quantize_s8.count("group")
    return codes, scales


def amax_samples_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `amax_samples`: one partial a sample, its amax."""
    return x.to(torch.float32).abs().amax(dim=tuple(range(1, x.dim()))).view(-1, 1)


def amax_samples(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) fp32 or bf16 (any strides) -> (B, parts) fp32 partial
    maxima of |x|, whose max over parts is each sample's amax, exact: the
    amax pass of the convolution's quantize (parts is the kernel's grid a
    sample on the card, 1 in the plain version)."""
    name = "amax_samples"
    _device_of(name, x)
    _check_float(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, C, H, W), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return amax_samples_reference(x)
    return amax_view(x, tuple(x.shape), x.stride(), 0, x.shape[0])


def nhwc_codes_reference(x: torch.Tensor, amax: torch.Tensor,
                         c_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `nhwc_codes`: the per-sample codes of x permuted to
    NHWC, zero past C, and the (B,) fp32 scales."""
    b = x.shape[0]
    scale = scale_of(amax.amax(dim=1).view(b, 1, 1, 1))
    codes = codes_of(x.to(torch.float32), scale).permute(0, 2, 3, 1)
    return _pad_cols(codes, c_pad), scale.reshape(b)


def nhwc_codes(x: torch.Tensor, amax: torch.Tensor,
               c_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """NCHW x fp32 or bf16 (any strides) and the amax pass's (B, parts)
    partial maxima of it (`amax_samples`) -> (codes (B, H, W, c_pad) int8,
    zero past C, scales (B,) fp32): the convolution's quantize pass, whose
    codes `conv_s8` takes as they are. On a CUDA tensor its kernel (which
    path served the call: `quantize_nhwc_s8.paths`); on a CPU tensor the
    plain version; any other device raises."""
    name = "nhwc_codes"
    _device_of(name, x)
    _check_float(name, x)
    if x.dim() != 4 or c_pad < x.shape[1] or c_pad % TILE_MULTIPLE:
        raise ValueError(f"{name}: expected NCHW x and c_pad >= C, a multiple of "
                         f"{TILE_MULTIPLE}; got {tuple(x.shape)}, {c_pad}")
    b, _, h, w = x.shape
    if (amax.dtype != torch.float32 or amax.dim() != 2 or amax.shape[0] != b
            or not amax.is_contiguous()):
        raise ValueError(f"{name}: amax must be ({b}, parts) fp32, contiguous")
    if x.device.type == "cpu":
        return nhwc_codes_reference(x, amax, c_pad)
    codes = torch.empty((b, h, w, c_pad), dtype=torch.int8, device=x.device)
    scales = torch.empty((b,), dtype=torch.float32, device=x.device)
    path = ctypes.c_int(-1)
    _quant_call("quantize_nhwc_s8", x.dtype, x.device, x.data_ptr(),
                *_view_args(x.shape, x.stride()), c_pad, amax.data_ptr(), amax.shape[1],
                codes.data_ptr(), scales.data_ptr(), ctypes.byref(path))
    quantize_nhwc_s8.count(QUANT_PATHS[path.value])
    return codes, scales


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


@dataclass
class QuantizedConvWeight(QuantizedWeight):
    """A convolution's weight as `conv_s8` takes it: codes (N, k*k*C_pad)
    int8, tap-major ((ky, kx, c), the channel fastest, zero past C), and
    (N,) fp32 scales."""

    kernel_size: int = 1

    @property
    def c_pad(self) -> int:
        return self.codes.shape[1] // self.kernel_size**2


def quantize_conv_weight(w: torch.Tensor) -> QuantizedConvWeight:
    """An OIHW weight (N, C, k, k) fp32 -> its tap-major codes and
    per-output-channel scales, through the rows layout. The zero channels
    past C change no amax, so the codes are the OIHW codes permuted."""
    n, c, k, _ = w.shape
    taps = F.pad(w.permute(0, 2, 3, 1), (0, pad16(c) - c)).reshape(n, -1)
    codes, scale = quantize_rows(taps, 1, taps.shape[1])
    return QuantizedConvWeight(codes, scale, k)


# --- conv_s8 ------------------------------------------------------------------------

CONV_TILE_NS = (64, 128, 192)  # conv_s8's tile widths in output channels
CONV_TILE_M = 128  # conv_s8's output pixels a block


def conv_tile_n(n: int, m: int, multiprocessors: int) -> int:
    """`conv_s8`'s tile width for N output channels and M output pixels:
    the fewest idle columns, then the widest tile (N = 384: two tiles of
    192), unless that leaves multiprocessors idle and a narrower tile as
    frugal gives more blocks (csp20: 75 blocks of 128 beat 50 of 192)."""
    rank = sorted(CONV_TILE_NS, key=lambda bn: (-(-n // bn) * bn, -bn))
    m_tiles = -(-m // CONV_TILE_M)
    best = rank[0]
    if m_tiles * -(-n // best) < multiprocessors:
        narrower = [bn for bn in rank if bn < best and -(-n // bn) * bn == -(-n // best) * best]
        best = narrower[0] if narrower else best
    return best


def default_tile_n(n: int, m: int, device: torch.device) -> int:
    """The tile width `conv_s8` takes on `device` when none is given."""
    return conv_tile_n(n, m, _multiprocessors(device))


def conv_out_hw(h: int, w: int, kernel_size: int, stride: int, padding: int) -> tuple[int, int]:
    return ((h + 2 * padding - kernel_size) // stride + 1,
            (w + 2 * padding - kernel_size) // stride + 1)


def conv_s8_reference(x: torch.Tensor, w: torch.Tensor, sa: torch.Tensor, sw: torch.Tensor,
                      kernel_size: int, stride: int, padding: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `conv_s8`: the codes convolved in float64, a
    product a tap (exact: |sum| <= K * 127**2 < 2**53), then
    (y.float() * (sa[b] * sw[n])).to(out_dtype), contiguous NCHW."""
    b, h, wd, cp = x.shape
    n, k = w.shape[0], kernel_size
    ho, wo = conv_out_hw(h, wd, k, stride, padding)
    xf = F.pad(x.to(torch.float64), (0, 0, padding, padding, padding, padding))
    wf = w.to(torch.float64).view(n, k, k, cp)
    y = torch.zeros((b * ho * wo, n), dtype=torch.float64, device=x.device)
    for ky in range(k):
        for kx in range(k):
            rows = slice(ky, ky + stride * (ho - 1) + 1, stride)
            cols = slice(kx, kx + stride * (wo - 1) + 1, stride)
            y += xf[:, rows, cols].reshape(-1, cp) @ wf[:, ky, kx].t()
    s = sa.view(-1, 1, 1, 1) * sw.view(1, 1, 1, n)
    out = (y.view(b, ho, wo, n).to(torch.float32) * s).to(out_dtype)
    return out.permute(0, 3, 1, 2).contiguous()


def _conv_checks(x, w, sa, sw, kernel_size: int, stride: int, padding: int, out_dtype) -> None:
    name = "conv_s8"
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name}: codes must be int8, got {x.dtype}, {w.dtype}")
    if sa.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be fp32, got {sa.dtype}, {sw.dtype}")
    if out_dtype not in SUFFIX:
        raise TypeError(f"{name}: writes float32 or bfloat16, not {out_dtype}")
    if x.dim() != 4 or w.dim() != 2 or x.shape[3] % TILE_MULTIPLE or x.shape[3] == 0:
        raise ValueError(f"{name}: expected NHWC codes (B, H, W, C_pad), C_pad a multiple of "
                         f"{TILE_MULTIPLE}, and (N, k*k*C_pad) weight codes; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    k = w.shape[1]
    if k != kernel_size**2 * x.shape[3] or sa.shape != (x.shape[0],) or sw.shape != (w.shape[0],):
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not {kernel_size}x{kernel_size} "
                         f"over {x.shape[3]} channels, or scales {tuple(sa.shape)}, "
                         f"{tuple(sw.shape)} do not fit")
    if k > MAX_K:
        raise ValueError(f"{name}: K = {k} > {MAX_K} could overflow int32")
    if stride < 1 or padding < 0 or min(conv_out_hw(x.shape[1], x.shape[2], kernel_size, stride,
                                                     padding)) < 1:
        raise ValueError(f"{name}: no output at stride {stride}, padding {padding} on "
                         f"{tuple(x.shape)}")
    if len({t.device for t in (x, w, sa, sw)}) != 1:
        raise ValueError(f"{name}: operands on {[str(t.device) for t in (x, w, sa, sw)]}")


def conv_s8(x: torch.Tensor, w: torch.Tensor, sa: torch.Tensor, sw: torch.Tensor,
            kernel_size: int, stride: int, padding: int, out_dtype: torch.dtype,
            tile_n: Optional[int] = None) -> torch.Tensor:
    """The quantized convolution: NHWC codes x (B, H, W, C_pad) int8 and the
    tap-major weight codes w (N, k*k*C_pad) int8 (`quantize_conv_weight`),
    per-sample scales sa (B,) and per-output-channel scales sw (N,) fp32
    -> float(conv) * (sa[b] * sw[n]) as contiguous NCHW (B, N, Ho, Wo)
    `out_dtype`, zero padding, stride. On a CUDA tensor the kernel
    (contiguous, 16-byte aligned operands), `tile_n` output channels a
    tile (default `conv_tile_n`), as many blocks as the card holds at once
    walking the tiles; on a CPU tensor the plain version; any other device
    raises. Every call notes its FLOPs, 2·M·N·K."""
    _device_of("conv_s8", x)
    _conv_checks(x, w, sa, sw, kernel_size, stride, padding, out_dtype)
    b, h, wd, cp = x.shape
    n = w.shape[0]
    ho, wo = conv_out_hw(h, wd, kernel_size, stride, padding)
    note_kernel_flops("conv_s8", 2 * b * ho * wo * n * w.shape[1])
    if x.device.type == "cpu":
        return conv_s8_reference(x, w, sa, sw, kernel_size, stride, padding, out_dtype)
    if tile_n is None:
        tile_n = default_tile_n(n, b * ho * wo, x.device)
    if tile_n not in CONV_TILE_NS:
        raise ValueError(f"conv_s8: tile widths are {CONV_TILE_NS}, not {tile_n}")
    if not all(t.is_contiguous() for t in (x, w, sa, sw)) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv_s8: operands must be contiguous and 16-byte aligned")
    out = torch.empty((b, n, ho, wo), dtype=out_dtype, device=x.device)
    lib = build_int8_conv_kernel().lib
    with torch.cuda.device(x.device):
        code = getattr(lib, f"conv_s8_{SUFFIX[out_dtype]}")(
            x.data_ptr(), w.data_ptr(), sa.data_ptr(), sw.data_ptr(), out.data_ptr(), b, h, wd,
            cp, n, kernel_size, stride, padding, tile_n, _stream(x.device))
    _raise_on("conv_s8", code, lib.conv_s8_error_string)
    conv_s8.launches += 1
    return out


conv_s8.launches = 0  # kernel launches since the count was last reset


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
