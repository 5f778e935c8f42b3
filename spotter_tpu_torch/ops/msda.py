"""Multiscale deformable-attention (MSDA) sampling (port of spotter_tpu.ops.msda).

Two halves, as on the TPU's default path (`SPOTTER_TPU_MSDA_PREP=xla`):

1. Corner prep in plain tensor code (`prepare_msda_gather`): each sample
   point becomes its bilinear corners (or, for method="discrete", its one
   nearest cell) as a global row index into the flat (S, hd) value map of
   its head, with a weight that folds the attention weight, the bilinear
   term and the in-bounds test (align_corners=False, zero padding,
   border-clamped indices carrying weight 0).
2. The weighted row gather-sum (`msda_gather_sum`), which is the kernel:
   hand-written CUDA for Hopper in `csrc/msda.cu`, replacing the TPU's
   `pallas_onehot_sampling_merged`. On a CPU tensor the wrapper runs the
   plain version (`msda_gather_sum_reference`); on a CUDA tensor it
   launches the kernel or raises.

Layouts follow the JAX package at the public function: value (B, S, H, hd),
loc (B, Q, H, LP, 2), attn (B, Q, H, LP), output (B, Q, H*hd).
"""

import ctypes
import functools

import numpy as np
import torch

from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library


def level_offsets(spatial_shapes: tuple[tuple[int, int], ...]) -> np.ndarray:
    sizes = [h * w for h, w in spatial_shapes]
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _level_tables(spatial_shapes, num_points: int, device: torch.device, dtype: torch.dtype):
    """Per-sample level height, width and flat offset, (LP,) each, on `device`.

    Cached per shape and device: building them anew would copy host memory
    to the card three times per decoder layer, and each such pageable copy
    makes the host wait for the stream. Made outside inference mode, so the
    cached tensors also serve forwards that track gradients.
    """
    with torch.inference_mode(False):
        lvl_h = torch.tensor(
            np.repeat([hh for hh, _ in spatial_shapes], num_points), dtype=dtype, device=device
        )
        lvl_w = torch.tensor(
            np.repeat([ww for _, ww in spatial_shapes], num_points), dtype=dtype, device=device
        )
        lvl_off = torch.tensor(
            np.repeat(level_offsets(spatial_shapes), num_points), dtype=torch.int32, device=device
        )
    return lvl_h, lvl_w, lvl_off


def _corner_terms(xs, ys, at, w_const, h_const, method):
    """Corner math of spotter_tpu.ops.msda._corner_terms, on tensors.

    xs/ys/at: (..., LP) normalized sample coords and attention weights;
    w_const/h_const: (LP,) per-sample level dims (float). Returns
    [(idx_level_local int32, weight fp32)] per active corner, each (..., LP).
    """
    if method == "discrete":
        cx = torch.minimum(torch.clamp(torch.floor(xs * w_const + 0.5), min=0), w_const - 1)
        cy = torch.minimum(torch.clamp(torch.floor(ys * h_const + 0.5), min=0), h_const - 1)
        idx0 = (cy * w_const + cx).to(torch.int32)
        return [(idx0, at.to(torch.float32))]
    gx = xs * w_const - 0.5
    gy = ys * h_const - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0).to(torch.float32)
    fy = (gy - y0).to(torch.float32)
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            xc = x0 + dx
            yc = y0 + dy
            valid = (xc >= 0) & (xc <= w_const - 1) & (yc >= 0) & (yc <= h_const - 1)
            wx = fx if dx else 1.0 - fx
            wy = fy if dy else 1.0 - fy
            wgt = torch.where(valid, wx * wy * at.to(torch.float32), 0.0)
            yi = torch.minimum(torch.clamp(yc, min=0), h_const - 1)
            xi = torch.minimum(torch.clamp(xc, min=0), w_const - 1)
            out.append(((yi * w_const + xi).to(torch.int32), wgt))
    return out


def prepare_msda_gather(
    loc: torch.Tensor,  # (B, Q, H, LP, 2) normalized sample points
    attn: torch.Tensor,  # (B, Q, H, LP) softmaxed attention weights
    spatial_shapes: tuple[tuple[int, int], ...],
    num_points: int,
    method: str = "default",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Corner indices + folded weights for `msda_gather_sum`.

    Returns idx (B*H, Q, J) int32, global into the flat unpadded S of each
    head, and w (B*H, Q, J) fp32, with J = LP*4 for "default" (each sample's
    four bilinear corners, adjacent) and J = LP for "discrete".
    """
    if method not in ("default", "discrete"):
        raise ValueError(f"unknown MSDA method {method!r}")
    b, q, h_axis, lp, _ = loc.shape
    if lp != len(spatial_shapes) * num_points:
        raise ValueError(f"LP={lp} != levels {len(spatial_shapes)} x points {num_points}")
    lvl_h, lvl_w, lvl_off = _level_tables(
        tuple(map(tuple, spatial_shapes)), num_points, loc.device, loc.dtype
    )
    loc_t = loc.permute(0, 2, 1, 3, 4)  # (B, H, Q, LP, 2)
    attn_t = attn.permute(0, 2, 1, 3)  # (B, H, Q, LP)
    corners = _corner_terms(loc_t[..., 0], loc_t[..., 1], attn_t, lvl_w, lvl_h, method)
    idx = torch.stack([c + lvl_off for c, _ in corners], dim=-1)  # (B, H, Q, LP, C)
    w = torch.stack([cw for _, cw in corners], dim=-1)
    j = lp * len(corners)
    return (
        idx.reshape(b * h_axis, q, j).contiguous(),
        w.reshape(b * h_axis, q, j).contiguous(),
    )


def msda_gather_sum_reference(
    rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel (port of `_onehot_ref_math`).

    rows (BH, S, hd) f32/bf16; idx (BH, Q, J) int32; w (BH, Q, J) f32 ->
    (BH, Q, hd) fp32: out[bh, q] = sum_j w[bh, q, j] * rows[bh, idx[bh, q, j]],
    with terms whose index lies outside [0, S) skipped, as the kernel does.
    """
    bh, s, hd = rows.shape
    _, q, j = idx.shape
    valid = (idx >= 0) & (idx < s)
    base = torch.arange(bh, device=rows.device).view(bh, 1, 1) * s
    flat = torch.where(valid, idx.long(), 0) + base
    g = rows.reshape(bh * s, hd).index_select(0, flat.reshape(-1)).reshape(bh, q, j, hd)
    wv = torch.where(valid, w.to(torch.float32), 0.0)
    return (g.to(torch.float32) * wv[..., None]).sum(dim=2)


@functools.cache
def build_msda_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library; returns it
    with its build time and nvcc log. The first CUDA call builds it anyway."""
    loaded = load_kernel_library("msda", ("msda.cu",))
    lib = loaded.lib
    # every pointer and the stream as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut the pointers
    args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (lib.msda_gather_sum_f32, lib.msda_gather_sum_bf16):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.msda_error_string.argtypes = [ctypes.c_int]
    lib.msda_error_string.restype = ctypes.c_char_p
    return loaded


def _check_cuda_args(rows, idx, w) -> None:
    dev = rows.device
    if idx.device != dev or w.device != dev:
        raise ValueError(f"rows, idx, w on different devices: {dev}, {idx.device}, {w.device}")
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows must be float32 or bfloat16, got {rows.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if rows.dim() != 3 or idx.dim() != 3 or w.shape != idx.shape:
        raise ValueError(
            f"expected rows (BH, S, hd), idx/w (BH, Q, J); got {tuple(rows.shape)}, "
            f"{tuple(idx.shape)}, {tuple(w.shape)}"
        )
    if idx.shape[0] != rows.shape[0]:
        raise ValueError(f"batch*heads differ: rows {rows.shape[0]}, idx {idx.shape[0]}")
    for name, t in (("rows", rows), ("idx", idx), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} has {t.numel()} elements; the kernel takes < 2**31")


def msda_gather_sum(rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows (BH, S, hd) f32/bf16, idx (BH, Q, J) int32, w (BH, Q, J) f32 ->
    (BH, Q, hd) f32. CUDA tensors launch `csrc/msda.cu`; CPU tensors take
    `msda_gather_sum_reference`; anything else raises."""
    if rows.device.type == "cpu":
        if idx.device.type != "cpu" or w.device.type != "cpu":
            raise ValueError("rows on the CPU but idx/w are not")
        return msda_gather_sum_reference(rows, idx, w)
    if rows.device.type != "cuda":
        raise ValueError(f"msda_gather_sum runs on cuda or cpu, not {rows.device}")
    _check_cuda_args(rows, idx, w)
    bh, s, hd = rows.shape
    _, q, j = idx.shape
    out = torch.empty((bh, q, hd), dtype=torch.float32, device=rows.device)
    if out.numel() == 0 or j == 0:
        return out.zero_()
    lib = build_msda_kernel().lib
    fn = lib.msda_gather_sum_f32 if rows.dtype == torch.float32 else lib.msda_gather_sum_bf16
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = fn(rows.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                  bh, s, hd, q, j, stream)
    if code != 0:
        raise RuntimeError(
            f"msda_gather_sum launch failed: {lib.msda_error_string(code).decode()} ({code})"
        )
    msda_gather_sum.launches += 1
    return out


msda_gather_sum.launches = 0  # kernel launches since the count was last reset


def deformable_sampling(
    value: torch.Tensor,  # (B, S, H, hd)
    loc: torch.Tensor,  # (B, Q, H, LP, 2) in [0, 1]
    attn: torch.Tensor,  # (B, Q, H, LP)
    spatial_shapes: tuple[tuple[int, int], ...],
    num_points: int,
    method: str = "default",
    presorted: bool = False,
) -> torch.Tensor:
    """Full MSDA core: returns (B, Q, H*hd) aggregated values.

    Same signature and result as spotter_tpu.ops.msda.deformable_sampling.
    `presorted` is accepted and ignored: query order only ever mattered to
    the TPU kernel's block-sparse tiling, which the gather kernel has not.
    """
    del presorted
    b, s, h_axis, hd = value.shape
    q = loc.shape[1]
    rows = value.permute(0, 2, 1, 3).reshape(b * h_axis, s, hd).contiguous()
    idx, w = prepare_msda_gather(loc, attn, spatial_shapes, num_points, method)
    out = msda_gather_sum(rows, idx, w)  # (B*H, Q, hd) fp32
    out = out.reshape(b, h_axis, q, hd).permute(0, 2, 1, 3).reshape(b, q, h_axis * hd)
    return out.to(value.dtype)
