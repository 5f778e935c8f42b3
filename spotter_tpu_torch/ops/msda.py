"""Multiscale deformable-attention (MSDA) sampling (port of spotter_tpu.ops.msda).

`SPOTTER_TPU_MSDA_PREP` picks where the corner prep runs, with the JAX
package's values (xla|kernel|fused) and error text; it is read when a
forward runs, so a process can switch it through the module attribute.

- `xla` (default): corner prep in plain tensor code (`prepare_msda_gather`):
  each sample point becomes its bilinear corners (or, for method="discrete",
  its one nearest cell) as a global row index into the flat (S, hd) value
  map of its head, with a weight that folds the attention weight, the
  bilinear term and the in-bounds test (align_corners=False, zero padding,
  border-clamped indices carrying weight 0). The weighted row gather-sum
  (`msda_gather_sum`) is the kernel, replacing the TPU's
  `pallas_onehot_sampling_merged`.
- `kernel`: the corner prep moves into the kernel (`msda_loc_sum`, replacing
  `pallas_onehot_sampling_merged_loc`), which takes raw sample coordinates
  and attention weights.
- `fused`: the model layer calls `deformable_sampling_fused`, whose kernel
  (`msda_fused_sum`, replacing `pallas_msda_fused`) also computes the
  sampling-offset and attention-weight projections, the per-head softmax
  and the location arithmetic.

All three kernels are hand-written CUDA for Hopper in `csrc/msda.cu`. On a
CPU tensor each wrapper runs its plain version (`*_reference`); on a CUDA
tensor it launches the kernel or raises.

Layouts follow the JAX package at the public function: value (B, S, H, hd),
loc (B, Q, H, LP, 2), attn (B, Q, H, LP), output (B, Q, H*hd).
"""

import ctypes
import functools
import os

import numpy as np
import torch

from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library

MSDA_PREP_VALUES = ("xla", "kernel", "fused")


def parse_msda_prep(raw: str) -> str:
    """The SPOTTER_TPU_MSDA_PREP value, checked as the JAX package checks it."""
    prep = raw.strip().lower()
    if prep not in MSDA_PREP_VALUES:
        raise ValueError(
            f"SPOTTER_TPU_MSDA_PREP must be xla|kernel|fused, got {prep!r}"
        )
    return prep


# process-wide, like the JAX knob; read at forward time (not captured at
# construction), so tests and chip_smoke.py switch it by setting this attribute
MSDA_PREP = parse_msda_prep(os.environ.get("SPOTTER_TPU_MSDA_PREP", "xla"))


MSDA_ENV = "SPOTTER_TPU_MSDA"
# backends that select a TPU kernel the port does not have yet
UNPORTED_MSDA_BACKENDS = {
    "pallas_sep": "pallas_sep_sampling, ROADMAP Queue 2 item 5",
    "pallas_gather": "pallas_deformable_sampling, ROADMAP Queue 2 item 6",
}


def check_msda_backend(raw: str) -> str:
    """The SPOTTER_TPU_MSDA value, checked as the JAX package checks it.
    "auto", "xla" and "pallas" run this module's kernels; the two backends
    whose kernels are not ported raise rather than serve another one."""
    name = raw.strip().lower()
    if name not in ("auto", "xla", "pallas", *UNPORTED_MSDA_BACKENDS):
        raise ValueError(
            f"{MSDA_ENV} must be auto|xla|pallas|pallas_sep|pallas_gather, got {name!r}"
        )
    if name in UNPORTED_MSDA_BACKENDS:
        raise ValueError(
            f"{MSDA_ENV}={name} selects a TPU kernel the port does not have yet "
            f"({UNPORTED_MSDA_BACKENDS[name]}); unset it or use auto"
        )
    return name


def msda_prep_fused() -> bool:
    """True when the model layer should route deformable cross-attention
    through `deformable_sampling_fused` (SPOTTER_TPU_MSDA_PREP=fused)."""
    return MSDA_PREP == "fused"


def level_offsets(spatial_shapes: tuple[tuple[int, int], ...]) -> np.ndarray:
    sizes = [h * w for h, w in spatial_shapes]
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def level_tables(spatial_shapes, num_points: int, device: torch.device, dtype: torch.dtype):
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


def _bh_layout(loc: torch.Tensor, attn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """loc (B, Q, H, LP, 2), attn (B, Q, H, LP) -> the kernels' per-(b*h)
    layout: xy (B*H, Q, 2*LP), x lanes then y lanes, and attn (B*H, Q, LP)."""
    b, q, h_axis, lp, _ = loc.shape
    loc_bh = loc.permute(0, 2, 1, 3, 4).reshape(b * h_axis, q, lp, 2)
    xy = torch.cat([loc_bh[..., 0], loc_bh[..., 1]], dim=-1)
    return xy, attn.permute(0, 2, 1, 3).reshape(b * h_axis, q, lp)


def _check_samples(lp: int, spatial_shapes, num_points: int, method: str) -> None:
    if method not in ("default", "discrete"):
        raise ValueError(f"unknown MSDA method {method!r}")
    if lp != len(spatial_shapes) * num_points:
        raise ValueError(f"LP={lp} != levels {len(spatial_shapes)} x points {num_points}")


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
    _check_samples(loc.shape[3], spatial_shapes, num_points, method)
    tables = level_tables(tuple(map(tuple, spatial_shapes)), num_points, loc.device, loc.dtype)
    idx, w = loc_corners(*_bh_layout(loc, attn), *tables, method)
    return idx.contiguous(), w.contiguous()


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


def loc_corners(
    xy: torch.Tensor,  # (BH, Q, 2*LP) f32: x lanes then y lanes, level-major
    attn: torch.Tensor,  # (BH, Q, LP) f32
    level_h: torch.Tensor,  # (LP,) f32 per-sample level height
    level_w: torch.Tensor,  # (LP,) f32 per-sample level width
    level_off: torch.Tensor,  # (LP,) int32 per-sample level offset into S
    method: str = "default",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The loc kernel's corner prep in plain torch (`_corner_terms` on raw
    coordinates): idx (BH, Q, LP*C) int32 global into S and w (BH, Q, LP*C)
    fp32, each sample's C corners adjacent (C = 4, or 1 for "discrete")."""
    lp = attn.shape[-1]
    corners = _corner_terms(xy[..., :lp], xy[..., lp:], attn, level_w, level_h, method)
    idx = torch.stack([c + level_off for c, _ in corners], dim=-1)  # (BH, Q, LP, C)
    w = torch.stack([cw for _, cw in corners], dim=-1)
    bh, q = attn.shape[:2]
    return idx.reshape(bh, q, -1), w.reshape(bh, q, -1)


def msda_loc_reference(
    rows: torch.Tensor,  # (BH, S, hd) f32/bf16
    xy: torch.Tensor,
    attn: torch.Tensor,
    level_h: torch.Tensor,
    level_w: torch.Tensor,
    level_off: torch.Tensor,
    method: str = "default",
) -> torch.Tensor:
    """Plain version of `msda_loc_sum` (port of `_loc_ref`): `loc_corners`,
    then the weighted row gather-sum. Returns (BH, Q, hd) fp32."""
    return msda_gather_sum_reference(
        rows, *loc_corners(xy, attn, level_h, level_w, level_off, method)
    )


def _fma_chain(hs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_d hs[b, q, d] * w[h, d, c] -> (B, H, Q, C) fp32, summed as the
    fused kernel sums it: one fp32 FMA per d, in order d = 0..D-1, from 0.

    Each FMA is emulated in float64, where the product of two floats is
    exact; rounding the float64 sum to float32 then matches the FMA's single
    rounding except when that sum needs more than 53 bits and lands on a
    float32 rounding midpoint. Summing in the kernel's order keeps the
    sample locations equal bit for bit, which the discrete method's
    nearest-cell rounding needs: a location one ulp off can fall in the
    next cell, and the bilinear weights move by the ulp times the level's
    width.
    """
    b, q, d = hs.shape
    hs64, w64 = hs.to(torch.float64), w.to(torch.float64)
    acc = torch.zeros((b, w.shape[0], q, w.shape[2]), dtype=torch.float32, device=hs.device)
    for k in range(d):
        acc = (hs64[:, None, :, k, None] * w64[None, :, None, k, :] + acc).to(torch.float32)
    return acc


def fused_prologue_reference(
    hs: torch.Tensor,  # (B, Q, D)
    w_off_h: torch.Tensor,  # (H, D, 2*LP)
    b_off_h: torch.Tensor,  # (H, 1, 2*LP)
    w_att_h: torch.Tensor,  # (H, D, LP)
    b_att_h: torch.Tensor,  # (H, 1, LP)
    base: torch.Tensor,  # (B, Q, 2*LP)
    scale: torch.Tensor,  # (B, Q, 2*LP)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's prologue (`_fused_ref`'s einsums, summed in the
    kernel's order): xy (B*H, Q, 2*LP) = base + (hs @ w_off + b_off) * scale
    and attn (B*H, Q, LP) = softmax(hs @ w_att + b_att), both fp32."""
    h_axis = w_off_h.shape[0]
    b, q, _ = hs.shape
    lp = w_att_h.shape[-1]
    f32 = torch.float32
    hs32 = hs.to(f32)
    offs = _fma_chain(hs32, w_off_h.to(f32)) + b_off_h.to(f32)[None]
    xy = base[:, None] + offs * scale[:, None]  # (B, H, Q, 2*LP)
    logits = _fma_chain(hs32, w_att_h.to(f32)) + b_att_h.to(f32)[None]
    at = torch.softmax(logits, dim=-1)
    return xy.reshape(b * h_axis, q, 2 * lp), at.reshape(b * h_axis, q, lp)


def msda_fused_reference(
    rows, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale,
    level_h, level_w, level_off, method: str = "default",
) -> torch.Tensor:
    """Plain version of `msda_fused_sum` (port of `_fused_ref`):
    `fused_prologue_reference`, then `msda_loc_reference`. Returns
    (B*H, Q, hd) fp32."""
    xy, at = fused_prologue_reference(hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale)
    return msda_loc_reference(rows, xy, at, level_h, level_w, level_off, method)


@functools.cache
def build_msda_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library; returns it
    with its build time and nvcc log. The first CUDA call builds it anyway."""
    loaded = load_kernel_library("msda", ("msda.cu",))
    lib = loaded.lib
    # every pointer and the stream as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut the pointers
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "msda_gather_sum": [ptr] * 4 + [i32] * 5 + [ptr],
        "msda_loc_sum": [ptr] * 7 + [i32] * 6 + [ptr],
        "msda_fused_sum": [ptr] * 12 + [i32] * 8 + [ptr],
    }
    for name, args in signatures.items():
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    lib.msda_error_string.argtypes = [ctypes.c_int]
    lib.msda_error_string.restype = ctypes.c_char_p
    return loaded


def _check_cuda_tensors(rows: torch.Tensor, **tensors) -> None:
    """Device, dtype, contiguity and size checks before pointers reach C.
    `tensors` maps a name to (tensor, dtype, ndim)."""
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows must be float32 or bfloat16, got {rows.dtype}")
    if rows.dim() != 3:
        raise ValueError(f"expected rows (BH, S, hd), got {tuple(rows.shape)}")
    checked = {"rows": rows}
    for name, (t, dtype, ndim) in tensors.items():
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
        checked[name] = t
    for name, t in checked.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} has {t.numel()} elements; the kernel takes < 2**31")


def _launch(name: str, rows: torch.Tensor, *args) -> None:
    """Call `name`'s f32 or bf16 entry point on the current stream; raise
    with the CUDA error string if the launch was refused."""
    lib = build_msda_kernel().lib
    fn = getattr(lib, f"{name}_{'f32' if rows.dtype == torch.float32 else 'bf16'}")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.msda_error_string(code).decode()} ({code})"
        )


def _require_cpu(name: str, *tensors: torch.Tensor) -> None:
    if any(t.device.type != "cpu" for t in tensors):
        raise ValueError(f"{name}: rows on the CPU but not every other input is")


def _require_cuda(name: str, rows: torch.Tensor) -> None:
    if rows.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {rows.device}")


def _method_code(method: str) -> int:
    if method not in ("default", "discrete"):
        raise ValueError(f"unknown MSDA method {method!r}")
    return int(method == "discrete")


def msda_gather_sum(rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows (BH, S, hd) f32/bf16, idx (BH, Q, J) int32, w (BH, Q, J) f32 ->
    (BH, Q, hd) f32. CUDA tensors launch `csrc/msda.cu`; CPU tensors take
    `msda_gather_sum_reference`; anything else raises."""
    if rows.device.type == "cpu":
        _require_cpu("msda_gather_sum", idx, w)
        return msda_gather_sum_reference(rows, idx, w)
    _require_cuda("msda_gather_sum", rows)
    _check_cuda_tensors(rows, idx=(idx, torch.int32, 3), w=(w, torch.float32, 3))
    if w.shape != idx.shape or idx.shape[0] != rows.shape[0]:
        raise ValueError(
            f"expected rows (BH, S, hd), idx/w (BH, Q, J); got {tuple(rows.shape)}, "
            f"{tuple(idx.shape)}, {tuple(w.shape)}"
        )
    bh, s, hd = rows.shape
    _, q, j = idx.shape
    out = torch.empty((bh, q, hd), dtype=torch.float32, device=rows.device)
    if out.numel() == 0 or j == 0:
        return out.zero_()
    _launch("msda_gather_sum", rows, rows.data_ptr(), idx.data_ptr(), w.data_ptr(),
            out.data_ptr(), bh, s, hd, q, j)
    msda_gather_sum.launches += 1
    return out


msda_gather_sum.launches = 0  # kernel launches since the count was last reset


def _check_level_tables(lp: int, level_h, level_w, level_off) -> None:
    if not 0 < lp <= 32:
        raise ValueError(f"the kernels take 1..32 samples per query-head, got LP={lp}")
    for name, t in (("level_h", level_h), ("level_w", level_w), ("level_off", level_off)):
        if t.shape != (lp,):
            raise ValueError(f"{name} must be ({lp},), got {tuple(t.shape)}")


def msda_loc_sum(
    rows: torch.Tensor,
    xy: torch.Tensor,
    attn: torch.Tensor,
    level_h: torch.Tensor,
    level_w: torch.Tensor,
    level_off: torch.Tensor,
    method: str = "default",
) -> torch.Tensor:
    """MSDA sampling with the corner prep in the kernel.

    rows (BH, S, hd) f32/bf16; xy (BH, Q, 2*LP) f32, x lanes then y lanes,
    level-major; attn (BH, Q, LP) f32; per-sample level tables (LP,) ->
    (BH, Q, hd) f32. CUDA tensors launch `csrc/msda.cu`; CPU tensors take
    `msda_loc_reference`; anything else raises.
    """
    code = _method_code(method)
    if rows.device.type == "cpu":
        _require_cpu("msda_loc_sum", xy, attn, level_h, level_w, level_off)
        return msda_loc_reference(rows, xy, attn, level_h, level_w, level_off, method)
    _require_cuda("msda_loc_sum", rows)
    f32 = torch.float32
    _check_cuda_tensors(
        rows, xy=(xy, f32, 3), attn=(attn, f32, 3), level_h=(level_h, f32, 1),
        level_w=(level_w, f32, 1), level_off=(level_off, torch.int32, 1),
    )
    bh, s, hd = rows.shape
    q, lp = attn.shape[1], attn.shape[2]
    if attn.shape[0] != bh or xy.shape != (bh, q, 2 * lp):
        raise ValueError(
            f"expected xy (BH, Q, 2*LP), attn (BH, Q, LP) with BH={bh}; got "
            f"{tuple(xy.shape)}, {tuple(attn.shape)}"
        )
    _check_level_tables(lp, level_h, level_w, level_off)
    out = torch.empty((bh, q, hd), dtype=f32, device=rows.device)
    if out.numel() == 0:
        return out
    _launch("msda_loc_sum", rows, rows.data_ptr(), xy.data_ptr(), attn.data_ptr(),
            level_h.data_ptr(), level_w.data_ptr(), level_off.data_ptr(), out.data_ptr(),
            bh, s, hd, q, lp, code)
    msda_loc_sum.launches += 1
    return out


msda_loc_sum.launches = 0


def msda_fused_sum(
    rows, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale,
    level_h, level_w, level_off, method: str = "default",
) -> torch.Tensor:
    """MSDA sampling with the projection, softmax and location prologue in
    the kernel.

    rows (B*H, S, hd) f32/bf16; hs (B, Q, D) f32; per-head weights w_off_h
    (H, D, 2*LP), b_off_h (H, 1, 2*LP), w_att_h (H, D, LP), b_att_h
    (H, 1, LP), f32; base/scale (B, Q, 2*LP) f32; per-sample level tables
    (LP,) -> (B*H, Q, hd) f32. CUDA tensors launch `csrc/msda.cu`; CPU
    tensors take `msda_fused_reference`; anything else raises.
    """
    code = _method_code(method)
    args = (rows, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale, level_h, level_w, level_off)
    if rows.device.type == "cpu":
        _require_cpu("msda_fused_sum", *args[1:])
        return msda_fused_reference(*args, method)
    _require_cuda("msda_fused_sum", rows)
    f32 = torch.float32
    _check_cuda_tensors(
        rows, hs=(hs, f32, 3), w_off_h=(w_off_h, f32, 3), b_off_h=(b_off_h, f32, 3),
        w_att_h=(w_att_h, f32, 3), b_att_h=(b_att_h, f32, 3), base=(base, f32, 3),
        scale=(scale, f32, 3), level_h=(level_h, f32, 1), level_w=(level_w, f32, 1),
        level_off=(level_off, torch.int32, 1),
    )
    bh, s, hd = rows.shape
    b, q, d = hs.shape
    h_axis, lp = w_att_h.shape[0], w_att_h.shape[2]
    expected = {
        "rows": (rows.shape[0], b * h_axis),
        "w_off_h": (tuple(w_off_h.shape), (h_axis, d, 2 * lp)),
        "b_off_h": (tuple(b_off_h.shape), (h_axis, 1, 2 * lp)),
        "w_att_h": (tuple(w_att_h.shape), (h_axis, d, lp)),
        "b_att_h": (tuple(b_att_h.shape), (h_axis, 1, lp)),
        "base": (tuple(base.shape), (b, q, 2 * lp)),
        "scale": (tuple(scale.shape), (b, q, 2 * lp)),
    }
    for name, (got, want) in expected.items():
        if got != want:
            raise ValueError(f"{name}: expected {want}, got {got}")
    _check_level_tables(lp, level_h, level_w, level_off)
    out = torch.empty((bh, q, hd), dtype=f32, device=rows.device)
    if out.numel() == 0:
        return out
    _launch("msda_fused_sum", rows, *(t.data_ptr() for t in args), out.data_ptr(),
            b, h_axis, s, hd, q, d, lp, code)
    msda_fused_sum.launches += 1
    return out


msda_fused_sum.launches = 0


def _value_rows(value: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> the kernels' (B*H, S, hd) row layout."""
    b, s, h_axis, hd = value.shape
    return value.permute(0, 2, 1, 3).reshape(b * h_axis, s, hd).contiguous()


def _merge_heads(out: torch.Tensor, b: int, h_axis: int, dtype: torch.dtype) -> torch.Tensor:
    """(B*H, Q, hd) fp32 -> (B, Q, H*hd) in `dtype`."""
    _, q, hd = out.shape
    return out.reshape(b, h_axis, q, hd).permute(0, 2, 1, 3).reshape(b, q, h_axis * hd).to(dtype)


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
    Under SPOTTER_TPU_MSDA_PREP=kernel the corner prep runs inside
    `msda_loc_sum`; otherwise `prepare_msda_gather` feeds `msda_gather_sum`.
    The JAX package takes its loc-prep kernel only where each level tile
    spans whole rows, a TPU tiling condition; the port has no tiles, so the
    loc kernel always applies. `presorted` is accepted and ignored: query
    order only ever mattered to the TPU kernel's block-sparse tiling.
    """
    del presorted
    b, _, h_axis, _ = value.shape
    rows = _value_rows(value)
    if MSDA_PREP == "kernel":
        _check_samples(loc.shape[3], spatial_shapes, num_points, method)
        f32 = torch.float32
        xy, at = _bh_layout(loc, attn)
        tables = level_tables(tuple(map(tuple, spatial_shapes)), num_points, loc.device, f32)
        out = msda_loc_sum(rows, xy.to(f32).contiguous(), at.to(f32).contiguous(), *tables, method)
    else:
        out = msda_gather_sum(rows, *prepare_msda_gather(loc, attn, spatial_shapes, num_points, method))
    return _merge_heads(out, b, h_axis, value.dtype)


def fused_head_weights(
    w_off: torch.Tensor, b_off: torch.Tensor, w_att: torch.Tensor, b_att: torch.Tensor,
    num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-layout projections -> the fused kernel's per-head layout.

    w_off (D, H*LP*2), b_off (H*LP*2,), w_att (D, H*LP), b_att (H*LP,) ->
    w_off_h (H, D, 2*LP) with x lanes then y lanes (level-major points in
    each half, matching the loc kernel's xy), b_off_h (H, 1, 2*LP),
    w_att_h (H, D, LP), b_att_h (H, 1, LP); all contiguous fp32.
    """
    d = w_off.shape[0]
    lp = w_att.shape[1] // num_heads
    f32 = torch.float32
    w_off_h = w_off.reshape(d, num_heads, lp, 2).permute(1, 0, 3, 2).reshape(num_heads, d, 2 * lp)
    b_off_h = b_off.reshape(num_heads, lp, 2).permute(0, 2, 1).reshape(num_heads, 1, 2 * lp)
    w_att_h = w_att.reshape(d, num_heads, lp).permute(1, 0, 2)
    b_att_h = b_att.reshape(num_heads, 1, lp)
    return tuple(t.to(f32).contiguous() for t in (w_off_h, b_off_h, w_att_h, b_att_h))


def fused_anchors(
    reference_points: torch.Tensor, lp: int, num_points: int, offset_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference-point anchors of the fused kernel, per sample lane:
    xy = base + offsets * scale, with base (B, Q, 2*LP) the box centre and
    scale (B, Q, 2*LP) its size times offset_scale / num_points, x lanes
    then y lanes (as the JAX wrapper builds them)."""
    b, q, _ = reference_points.shape
    ref = reference_points.to(torch.float32)
    ps = float(np.float32(offset_scale / num_points))
    base = torch.cat(
        [ref[..., 0:1].expand(b, q, lp), ref[..., 1:2].expand(b, q, lp)], dim=-1
    ).contiguous()
    scale = torch.cat(
        [(ref[..., 2:3] * ps).expand(b, q, lp), (ref[..., 3:4] * ps).expand(b, q, lp)], dim=-1
    ).contiguous()
    return base, scale


def deformable_sampling_fused(
    value: torch.Tensor,  # (B, S, H, hd)
    hs: torch.Tensor,  # (B, Q, D) decoder hidden states (query + pos embed)
    reference_points: torch.Tensor,  # (B, Q, 4) normalized cxcywh
    w_off: torch.Tensor,  # (D, H*LP*2) sampling_offsets Dense kernel
    b_off: torch.Tensor,  # (H*LP*2,)
    w_att: torch.Tensor,  # (D, H*LP) attention_weights Dense kernel
    b_att: torch.Tensor,  # (H*LP,)
    spatial_shapes: tuple[tuple[int, int], ...],
    num_points: int,
    offset_scale: float = 0.5,
    method: str = "default",
    presorted: bool = False,
) -> torch.Tensor:
    """MSDA with the projection/softmax/location prologue fused into the
    kernel (SPOTTER_TPU_MSDA_PREP=fused). Returns (B, Q, H*hd).

    The signature of spotter_tpu.ops.msda.deformable_sampling_fused, less
    its TPU backend and interpret switches. The weights arrive in the Dense
    layout (the model layer keeps its `sampling_offsets`/`attention_weights`
    parameters, so a checkpoint serves both paths) and are re-laid per head
    here. There is no padding of queries: every output row is a real query.
    `presorted` is accepted and ignored, as in `deformable_sampling`.
    """
    del presorted
    b, _, h_axis, _ = value.shape
    lp = len(spatial_shapes) * num_points
    heads = fused_head_weights(w_off, b_off, w_att, b_att, h_axis)
    base, scale = fused_anchors(reference_points, lp, num_points, offset_scale)
    tables = level_tables(tuple(map(tuple, spatial_shapes)), num_points, hs.device, torch.float32)
    out = msda_fused_sum(
        _value_rows(value), hs.to(torch.float32).contiguous(), *heads, base, scale, *tables,
        method,
    )
    return _merge_heads(out, b, h_axis, value.dtype)
