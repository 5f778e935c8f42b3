"""Multiscale deformable-attention (MSDA) sampling (port of spotter_tpu.ops.msda).

`SPOTTER_TPU_MSDA_PREP` picks where the corner prep runs, with the JAX
package's values (xla|kernel|fused) and error text; it is read when a
forward runs, so a process can switch it through the module attribute.

- `xla` (default): corner prep in plain tensor code (`prepare_msda_gather`):
  each sample point becomes its bilinear corners (or, for method="discrete",
  its one nearest cell) as a global row index into the S value rows of its
  head, with a weight that folds the attention weight, the bilinear term
  and the in-bounds test (align_corners=False, zero padding, border-clamped
  indices carrying weight 0). The weighted row gather-sum
  (`msda_gather_sum`) is the kernel, replacing the TPU's
  `pallas_onehot_sampling_merged`.
- `kernel`: the corner prep moves into the kernel (`msda_loc_sum`, replacing
  `pallas_onehot_sampling_merged_loc`), which takes the raw sample
  coordinates and attention weights as the model holds them.
- `fused`: the model layer calls `deformable_sampling_fused`, whose kernel
  (`msda_fused_sum`, replacing `pallas_msda_fused`) also computes the
  sampling-offset and attention-weight projections, the per-head softmax
  and the location arithmetic.

All three kernels are hand-written CUDA for Hopper in `csrc/msda.cu`, on
one walk of the value rows. Each reads the value (B, S, H, hd) in place and
writes (B, Q, H, hd) fp32, so no branch copies the value into a per-head
layout or permutes the output back.

`SPOTTER_TPU_MSDA` picks the sampling backend, with the JAX package's values
(auto|xla|pallas|pallas_sep|pallas_gather) and error text; like the prep
knob it is read when a forward runs, through `MSDA_BACKEND`. "auto", "xla"
and "pallas" run the three kernels above, by the prep setting. The two
others run their own kernels, whatever the prep setting, in the JAX
package's dispatch order:

- `pallas_sep`: separable bilinear sampling, one launch per level
  (`msda_sep_sum`, replacing `pallas_sep_sampling`), on the JAX package's
  query-side operands: 64-query tiles, unclamped corner indices, weights
  with attention and validity folded in, and a per-tile band hit table
  (`sep_level_operands`).
- `pallas_gather`: the lane gather's sample-major idx/w (B, H, 4, LP*Q)
  (`prepare_msda_gather_lanes`), summed in the value's dtype
  (`msda_hd_gather_sum`, replacing `pallas_deformable_sampling`). The TPU
  kernel's value (B, H, hd, S) and output (B, H, hd, Q) lay the spatial
  axis along lanes for Mosaic's gather; the port reads the value rows where
  the model holds them, (B, S, H, hd), and writes (B, Q, H, hd), so the
  backend copies neither.

Both are hand-written CUDA in `csrc/msda_backends.cu`. On a CPU tensor each
wrapper runs its plain version (`*_reference`); on a CUDA tensor it launches
the kernel or raises.

`SPOTTER_TPU_MSDA_PRECISION` is the JAX package's MXU pass count for its
one-hot contraction, read when a forward runs (`msda_precision`, from
`MSDA_PRECISION` and the policy): "highest" sums fp32 products in fp32;
"default" is the TPU's one bf16 pass, which rows 1-4 compute in a one-pass
mode of their own (each kernel's `*_onepass` entry point): both operands of
the contraction rounded to bf16 (round to nearest even), products exact,
sums in fp32. Rows 1-3 round each term's weight and each value element
(the TPU rounds a one-hot entry, the sum of the terms of one query that
land on one source row: the two differ only where two terms of a
(query, head, level) share a row, by at most a bf16 rounding of each of
those weights); row 3 also rounds its prologue's two projections (hidden
states and weights, fp32 sums, the bias added in fp32); row 4 rounds its
x weights and value band before its first dot and each row's point sum
before its 0/1 group-sum dot, as the TPU does. Unset, the knob follows
the policy: "default" under "mixed", "bfloat16" and "bf16", "highest"
otherwise; any other value raises with the JAX package's text. The
explicit SPOTTER_TPU_MSDA=xla backend ignores it, as the JAX package's
row gathers do, and the lane gather (`pallas_gather`) takes none, as its
TPU kernel takes none.

Layouts follow the JAX package at the public function: value (B, S, H, hd),
loc (B, Q, H, LP, 2), attn (B, Q, H, LP), output (B, Q, H*hd). Each
wrapper's plain version (`msda_gather_sum_plain`, `msda_loc_sum_plain`,
`msda_fused_sum_plain`) takes the wrapper's own layouts and runs the ports
of the JAX package's references (`msda_gather_sum_reference`,
`msda_loc_reference`, `msda_fused_reference`), which work on the per-head
rows (B*H, S, hd), through a permute.
"""

import ctypes
import functools
import os

import numpy as np
import torch

from spotter_tpu_torch.obs.perf import note_kernel_flops
from spotter_tpu_torch.utils.cuda_build import KernelLibrary, load_kernel_library
from spotter_tpu_torch.utils.precision import policy_name

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
MSDA_BACKENDS = ("auto", "xla", "pallas", "pallas_sep", "pallas_gather")


def check_msda_backend(raw: str) -> str:
    """The SPOTTER_TPU_MSDA value, checked as the JAX package checks it."""
    name = raw.strip().lower()
    if name not in MSDA_BACKENDS:
        raise ValueError(
            f"{MSDA_ENV} must be auto|xla|pallas|pallas_sep|pallas_gather, got {name!r}"
        )
    return name


# process-wide, read at forward time like MSDA_PREP: tests and chip_smoke.py
# switch the backend by setting this attribute
MSDA_BACKEND = check_msda_backend(os.environ.get(MSDA_ENV, "auto"))


MSDA_PRECISION_ENV = "SPOTTER_TPU_MSDA_PRECISION"
MSDA_PRECISIONS = ("default", "highest")
# the raw env value (None when unset), checked when a forward runs: like the
# two knobs above, tests and callers switch it by setting this attribute
MSDA_PRECISION = os.environ.get(MSDA_PRECISION_ENV)
# the dtype policies under which the unset knob means "default" (the JAX
# package's `_mxu_precision`)
ONE_PASS_POLICIES = ("mixed", "bfloat16", "bf16")


def check_msda_precision(raw: str | None) -> str:
    """The SPOTTER_TPU_MSDA_PRECISION value a forward runs, "default" or
    "highest". Unset (None), it follows SPOTTER_TPU_DTYPE as the JAX
    package's default does; any other value raises with the JAX text."""
    if raw is None:
        return "default" if policy_name() in ONE_PASS_POLICIES else "highest"
    name = raw.strip().lower()
    if name not in MSDA_PRECISIONS:
        raise ValueError(
            f"Unsupported {MSDA_PRECISION_ENV}={name!r}; expected one of ['default', 'highest']"
        )
    return name


def msda_precision() -> str:
    """The precision a forward's MSDA kernels run now."""
    return check_msda_precision(MSDA_PRECISION)


def msda_backend() -> str:
    """The backend a forward runs now ("auto", "xla" and "pallas" all take
    this module's gather-sum, loc and fused kernels), after the forward's
    check of SPOTTER_TPU_MSDA_PRECISION: both sampling entry points ask."""
    check_msda_precision(MSDA_PRECISION)
    return check_msda_backend(MSDA_BACKEND)


def backend_precision(backend: str) -> str:
    """What `backend`'s kernels run: "highest" for the explicit `xla`
    backend (the JAX package's row gathers take no precision), else
    `msda_precision()`."""
    return "highest" if backend == "xla" else msda_precision()


def _check_precision(precision: str) -> None:
    if precision not in MSDA_PRECISIONS:
        raise ValueError(f"precision must be one of {list(MSDA_PRECISIONS)}, got {precision!r}")


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to bf16 (round to nearest even) and back to fp32: one
    operand of the TPU's one bf16 MXU pass."""
    return t.to(torch.bfloat16).to(torch.float32)


def msda_prep_fused() -> bool:
    """True when the model layer should route deformable cross-attention
    through `deformable_sampling_fused` (SPOTTER_TPU_MSDA_PREP=fused)."""
    return MSDA_PREP == "fused"


def level_offsets(spatial_shapes: tuple[tuple[int, int], ...]) -> np.ndarray:
    sizes = [h * w for h, w in spatial_shapes]
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


@functools.cache
def level_tables(spatial_shapes, num_points: int, device: torch.device, dtype: torch.dtype):
    """Per-sample level height, width and flat offset, (LP,) each, on `device`.

    Cached per shape and device: building them anew would copy host memory
    to the card three times per decoder layer, and each such pageable copy
    makes the host wait for the stream. Made outside inference mode, so the
    cached tensors also serve forwards that track gradients. Never evicted: a captured CUDA graph reads it in place.
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
    """loc (B, Q, H, LP, 2), attn (B, Q, H, LP) -> the references' per-(b*h)
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
    # fp32 tables: a bf16 loc's corners are worked out in fp32, as the JAX
    # package's numpy fp32 tables promote them
    tables = level_tables(tuple(map(tuple, spatial_shapes)), num_points, loc.device,
                          torch.float32)
    idx, w = loc_corners(*_bh_layout(loc, attn), *tables, method)
    return idx.contiguous(), w.contiguous()


def msda_gather_sum_reference(
    rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, precision: str = "highest"
) -> torch.Tensor:
    """Plain version of the kernel (port of `_onehot_ref_math`).

    rows (BH, S, hd) f32/bf16; idx (BH, Q, J) int32; w (BH, Q, J) f32 ->
    (BH, Q, hd) fp32: out[bh, q] = sum_j w[bh, q, j] * rows[bh, idx[bh, q, j]],
    with terms whose index lies outside [0, S) skipped, as the kernel does.
    precision="default" rounds each weight and each gathered value to bf16
    first (the one-pass mode; products exact, sums fp32).
    """
    _check_precision(precision)
    bh, s, hd = rows.shape
    _, q, j = idx.shape
    valid = (idx >= 0) & (idx < s)
    base = torch.arange(bh, device=rows.device).view(bh, 1, 1) * s
    flat = torch.where(valid, idx.long(), 0) + base
    g = rows.reshape(bh * s, hd).index_select(0, flat.reshape(-1)).reshape(bh, q, j, hd)
    g = g.to(torch.float32)
    wv = torch.where(valid, w.to(torch.float32), 0.0)
    if precision == "default":
        g, wv = bf16_round(g), bf16_round(wv)
    return (g * wv[..., None]).sum(dim=2)


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
    precision: str = "highest",
) -> torch.Tensor:
    """Port of `_loc_ref`: `loc_corners`, then the weighted row gather-sum.
    Returns (BH, Q, hd) fp32."""
    return msda_gather_sum_reference(
        rows, *loc_corners(xy, attn, level_h, level_w, level_off, method), precision
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
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's prologue (`_fused_ref`'s einsums, summed in the
    kernel's order): xy (B*H, Q, 2*LP) = base + (hs @ w_off + b_off) * scale
    and attn (B*H, Q, LP) = softmax(hs @ w_att + b_att), both fp32.
    precision="default" rounds hs and the two weights to bf16 first (their
    products are then exact; sums and the bias stay fp32)."""
    _check_precision(precision)
    h_axis = w_off_h.shape[0]
    b, q, _ = hs.shape
    lp = w_att_h.shape[-1]
    f32 = torch.float32
    hs32, w_off32, w_att32 = hs.to(f32), w_off_h.to(f32), w_att_h.to(f32)
    if precision == "default":
        hs32, w_off32, w_att32 = bf16_round(hs32), bf16_round(w_off32), bf16_round(w_att32)
    offs = _fma_chain(hs32, w_off32) + b_off_h.to(f32)[None]
    xy = base[:, None] + offs * scale[:, None]  # (B, H, Q, 2*LP)
    logits = _fma_chain(hs32, w_att32) + b_att_h.to(f32)[None]
    at = torch.softmax(logits, dim=-1)
    return xy.reshape(b * h_axis, q, 2 * lp), at.reshape(b * h_axis, q, lp)


def msda_fused_reference(
    rows, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale,
    level_h, level_w, level_off, method: str = "default", precision: str = "highest",
) -> torch.Tensor:
    """Port of `_fused_ref`: `fused_prologue_reference`, then
    `msda_loc_reference`. rows (B*H, S, hd) -> (B*H, Q, hd) fp32."""
    xy, at = fused_prologue_reference(hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale,
                                      precision)
    return msda_loc_reference(rows, xy, at, level_h, level_w, level_off, method, precision)


def _value_rows(value: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> the references' per-head rows (B*H, S, hd)."""
    b, s, h_axis, hd = value.shape
    return value.permute(0, 2, 1, 3).reshape(b * h_axis, s, hd).contiguous()


def _heads_out(out: torch.Tensor, b: int, h_axis: int) -> torch.Tensor:
    """(B*H, Q, hd) -> the model's (B, Q, H, hd)."""
    _, q, hd = out.shape
    return out.reshape(b, h_axis, q, hd).permute(0, 2, 1, 3).contiguous()


def msda_gather_sum_plain(
    value: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, precision: str = "highest"
) -> torch.Tensor:
    """Plain version of `msda_gather_sum` on its layouts: value (B, S, H, hd),
    idx/w (B*H, Q, J) -> (B, Q, H, hd) fp32, through
    `msda_gather_sum_reference` on the per-head rows."""
    b, _, h_axis, _ = value.shape
    return _heads_out(msda_gather_sum_reference(_value_rows(value), idx, w, precision), b,
                      h_axis)


def msda_loc_sum_plain(
    value: torch.Tensor, loc: torch.Tensor, attn: torch.Tensor,
    level_h: torch.Tensor, level_w: torch.Tensor, level_off: torch.Tensor,
    method: str = "default", precision: str = "highest",
) -> torch.Tensor:
    """Plain version of `msda_loc_sum` on its layouts: value (B, S, H, hd),
    loc (B, Q, H, LP, 2), attn (B, Q, H, LP) -> (B, Q, H, hd) fp32, through
    `msda_loc_reference` on the per-head rows."""
    b, _, h_axis, _ = value.shape
    out = msda_loc_reference(_value_rows(value), *_bh_layout(loc, attn), level_h, level_w,
                             level_off, method, precision)
    return _heads_out(out, b, h_axis)


def msda_fused_sum_plain(
    value, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale,
    level_h, level_w, level_off, method: str = "default", precision: str = "highest",
) -> torch.Tensor:
    """Plain version of `msda_fused_sum` on its layouts: value (B, S, H, hd)
    -> (B, Q, H, hd) fp32, through `msda_fused_reference` on the per-head
    rows."""
    b, _, h_axis, _ = value.shape
    out = msda_fused_reference(_value_rows(value), hs, w_off_h, b_off_h, w_att_h, b_att_h, base,
                               scale, level_h, level_w, level_off, method, precision)
    return _heads_out(out, b, h_axis)


@functools.cache
def build_msda_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the kernel library; returns it
    with its build time and nvcc log. The first CUDA call builds it anyway."""
    return bind_msda_library(load_kernel_library("msda", ("msda.cu",)))


def bind_msda_library(loaded: KernelLibrary) -> KernelLibrary:
    """Set the ctypes signatures of `csrc/msda.cu`'s C entries on a loaded
    build of it (this module's, or a variant a probe builds)."""
    lib = loaded.lib
    # every pointer and the stream as c_void_p: ctypes would otherwise pass
    # Python ints as 32-bit C ints and cut the pointers
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "msda_gather_sum": [ptr] * 4 + [i32] * 6 + [ptr],
        "msda_loc_sum": [ptr] * 7 + [i32] * 7 + [ptr],
        "msda_fused_sum": [ptr] * 12 + [i32] * 8 + [ptr],
    }
    _bind_entries(lib, signatures)
    return loaded


def _bind_entries(lib, signatures: dict) -> None:
    """Set the ctypes signatures of each kernel's four C entries (f32 and
    bf16 rows, "highest" and the one-pass "default" mode) and of
    msda_error_string."""
    for name, args in signatures.items():
        for suffix in ("f32", "bf16", "f32_onepass", "bf16_onepass"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    lib.msda_error_string.argtypes = [ctypes.c_int]
    lib.msda_error_string.restype = ctypes.c_char_p


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


def _check_value(name: str, value: torch.Tensor, **tensors) -> None:
    """`_check_cuda_tensors` for a kernel that reads the value (B, S, H, hd)
    in place: it must be contiguous, with its rows as (B, S*H, hd)."""
    if value.dim() != 4 or not value.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous value (B, S, H, hd), got {tuple(value.shape)}")
    b, s, h_axis, hd = value.shape
    _check_cuda_tensors(value.view(b, s * h_axis, hd), **tensors)


def _launch(name: str, rows: torch.Tensor, *args, build=None, precision: str = "highest") -> None:
    """Call `name`'s f32 or bf16 entry point (by `rows`' dtype; its one-pass
    form under precision="default") in the library `build` returns (this
    module's first one by default) on the current stream; raise with the
    CUDA error string if the launch was refused."""
    _check_precision(precision)
    lib = (build or build_msda_kernel)().lib
    suffix = "f32" if rows.dtype == torch.float32 else "bf16"
    fn = getattr(lib, f"{name}_{suffix}{'_onepass' if precision == 'default' else ''}")
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


# samples a query-head the three kernels take (the fused kernel's softmax
# gives each a lane of a warp), and the terms msda_gather_sum stages for it
MSDA_MAX_SAMPLES = 32
MSDA_MAX_TERMS = 4 * MSDA_MAX_SAMPLES


# the JAX package's default tiles (SPOTTER_TPU_MSDA_QTILE, _STILE), which
# its one-hot kernels' FLOPs formula counts in
ONEHOT_Q_TILE = 64
ONEHOT_S_TILE = 640


def onehot_flops(bh: int, q: int, hd: int, spatial_shapes, jc: int) -> int:
    """The analytic FLOPs the JAX package notes for its merged one-hot
    kernels (`spotter_tpu/ops/msda.py` `pallas_onehot_sampling_merged` and
    `_loc`): per level, 2·BH·spans·(Qp·tile·hd + jc·Qp·tile), Qp the query
    count padded to its query tile, each level's span padded to its source
    tile, jc the corner terms a level takes. A dense one-hot product's
    count: the port's kernels gather instead, and do far less."""
    qp = -(-q // ONEHOT_Q_TILE) * ONEHOT_Q_TILE
    return sum(2 * bh * (-(-(lh * lw) // ONEHOT_S_TILE)) * (qp * ONEHOT_S_TILE * hd
                                                          + jc * qp * ONEHOT_S_TILE)
               for lh, lw in spatial_shapes)


def msda_gather_sum(value: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """value (B, S, H, hd) f32/bf16, read in place; idx (B*H, Q, J) int32,
    global row indices into S from `prepare_msda_gather`; w (B*H, Q, J) f32
    -> (B, Q, H, hd) f32, in `precision` ("highest", or the one-pass
    "default"). CUDA tensors launch `csrc/msda.cu` (J <= 128); CPU tensors
    take `msda_gather_sum_plain`; anything else raises. (The FLOPs of a
    call depend on the value's levels, which only the caller knows:
    `deformable_sampling` notes them.)"""
    _check_precision(precision)
    if value.device.type == "cpu":
        _require_cpu("msda_gather_sum", idx, w)
        return msda_gather_sum_plain(value, idx, w, precision)
    _require_cuda("msda_gather_sum", value)
    _check_value("msda_gather_sum", value, idx=(idx, torch.int32, 3), w=(w, torch.float32, 3))
    b, s, h_axis, hd = value.shape
    bh, q, j = idx.shape
    if w.shape != idx.shape or bh != b * h_axis or not 0 < j <= MSDA_MAX_TERMS:
        raise ValueError(
            f"expected idx/w (B*H, Q, J) with B*H={b * h_axis}, 0 < J <= {MSDA_MAX_TERMS}; "
            f"got {tuple(idx.shape)}, {tuple(w.shape)}"
        )
    out = torch.empty((b, q, h_axis, hd), dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out
    _launch("msda_gather_sum", value, value.data_ptr(), idx.data_ptr(), w.data_ptr(),
            out.data_ptr(), b, h_axis, s, hd, q, j, precision=precision)
    msda_gather_sum.launches += 1
    return out


msda_gather_sum.launches = 0  # kernel launches since the count was last reset


def _check_level_tables(lp: int, level_h, level_w, level_off) -> None:
    if not 0 < lp <= MSDA_MAX_SAMPLES:
        raise ValueError(
            f"the kernels take 1..{MSDA_MAX_SAMPLES} samples per query-head, got LP={lp}")
    for name, t in (("level_h", level_h), ("level_w", level_w), ("level_off", level_off)):
        if t.shape != (lp,):
            raise ValueError(f"{name} must be ({lp},), got {tuple(t.shape)}")


def msda_loc_sum(
    value: torch.Tensor,
    loc: torch.Tensor,
    attn: torch.Tensor,
    level_h: torch.Tensor,
    level_w: torch.Tensor,
    level_off: torch.Tensor,
    method: str = "default",
    precision: str = "highest",
) -> torch.Tensor:
    """MSDA sampling with the corner prep in the kernel.

    value (B, S, H, hd) f32/bf16; loc (B, Q, H, LP, 2) f32 normalized
    sample points, level-major; attn (B, Q, H, LP) f32; per-sample level
    tables (LP,) -> (B, Q, H, hd) f32, in `precision`. All read in place.
    CUDA tensors launch `csrc/msda.cu`; CPU tensors take
    `msda_loc_sum_plain`; anything else raises (`deformable_sampling`
    notes its FLOPs).
    """
    code = _method_code(method)
    _check_precision(precision)
    if value.device.type == "cpu":
        _require_cpu("msda_loc_sum", loc, attn, level_h, level_w, level_off)
        return msda_loc_sum_plain(value, loc, attn, level_h, level_w, level_off, method,
                                  precision)
    _require_cuda("msda_loc_sum", value)
    f32 = torch.float32
    _check_value(
        "msda_loc_sum", value, loc=(loc, f32, 5), attn=(attn, f32, 4),
        level_h=(level_h, f32, 1), level_w=(level_w, f32, 1),
        level_off=(level_off, torch.int32, 1),
    )
    b, s, h_axis, hd = value.shape
    q, lp = attn.shape[1], attn.shape[3]
    if attn.shape != (b, q, h_axis, lp) or loc.shape != (b, q, h_axis, lp, 2):
        raise ValueError(
            f"expected loc (B, Q, H, LP, 2), attn (B, Q, H, LP) with B={b}, H={h_axis}; got "
            f"{tuple(loc.shape)}, {tuple(attn.shape)}"
        )
    if loc.data_ptr() % 8:
        raise ValueError("loc must start 8-byte aligned: the kernel reads it as float2")
    _check_level_tables(lp, level_h, level_w, level_off)
    out = torch.empty((b, q, h_axis, hd), dtype=f32, device=value.device)
    if out.numel() == 0:
        return out
    _launch("msda_loc_sum", value, value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            level_h.data_ptr(), level_w.data_ptr(), level_off.data_ptr(), out.data_ptr(),
            b, h_axis, s, hd, q, lp, code, precision=precision)
    msda_loc_sum.launches += 1
    return out


msda_loc_sum.launches = 0


def msda_fused_sum(
    value, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale,
    level_h, level_w, level_off, method: str = "default", precision: str = "highest",
) -> torch.Tensor:
    """MSDA sampling with the projection, softmax and location prologue in
    the kernel.

    value (B, S, H, hd) f32/bf16, read in place; hs (B, Q, D) f32; per-head
    weights w_off_h (H, D, 2*LP), b_off_h (H, 1, 2*LP), w_att_h (H, D, LP),
    b_att_h (H, 1, LP), f32; base/scale (B, Q, 2*LP) f32; per-sample level
    tables (LP,) -> (B, Q, H, hd) f32, in `precision`. CUDA tensors launch
    `csrc/msda.cu`; CPU tensors take `msda_fused_sum_plain`; anything else
    raises (`deformable_sampling_fused` notes its FLOPs).
    """
    code = _method_code(method)
    _check_precision(precision)
    args = (value, hs, w_off_h, b_off_h, w_att_h, b_att_h, base, scale, level_h, level_w,
            level_off)
    if value.device.type == "cpu":
        _require_cpu("msda_fused_sum", *args[1:])
        return msda_fused_sum_plain(*args, method, precision)
    _require_cuda("msda_fused_sum", value)
    f32 = torch.float32
    _check_value(
        "msda_fused_sum", value, hs=(hs, f32, 3), w_off_h=(w_off_h, f32, 3),
        b_off_h=(b_off_h, f32, 3), w_att_h=(w_att_h, f32, 3), b_att_h=(b_att_h, f32, 3),
        base=(base, f32, 3), scale=(scale, f32, 3), level_h=(level_h, f32, 1),
        level_w=(level_w, f32, 1), level_off=(level_off, torch.int32, 1),
    )
    b, s, h_axis, hd = value.shape
    q, d = hs.shape[1], hs.shape[2]
    lp = w_att_h.shape[2]
    expected = {
        "hs": (tuple(hs.shape), (b, q, d)),
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
    out = torch.empty((b, q, h_axis, hd), dtype=f32, device=value.device)
    if out.numel() == 0:
        return out
    _launch("msda_fused_sum", value, *(t.data_ptr() for t in args), out.data_ptr(),
            b, h_axis, s, hd, q, d, lp, code, precision=precision)
    msda_fused_sum.launches += 1
    return out


msda_fused_sum.launches = 0


# --- the opt-in backends: pallas_sep and pallas_gather ----------------------

SEP_Q_TILE = 64  # the JAX package's Q_TILE: queries per tile of the hit table
SEP_R_BAND = 8  # rows per band when W <= 128; wider maps halve it
SEP_PAD_INDEX = -7  # x0/y0 of a pad query: outside every level and every band


def sep_band_rows(lw: int) -> int:
    """Rows per band of a level `lw` wide (`_sep_level_dispatch`'s geometry)."""
    return SEP_R_BAND if lw <= 128 else max(1, SEP_R_BAND // 2)


def sep_level_operands(
    loc_l: torch.Tensor,  # (B, Q, H, P, 2) this level's sample points in [0, 1]
    attn_l: torch.Tensor,  # (B, Q, H, P)
    lh: int,
    lw: int,
    method: str = "default",
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, int]:
    """The separable kernel's operands for one level, as the JAX package's
    `_sep_level_dispatch` builds them for `pallas_sep_sampling`.

    Returns ((xi, xw0, xw1, yi, yw0, yw1), mask, r_band): xi/yi (BH,
    n_qt*P*64, 1) int32 are the unclamped level-local x0/y0, point-major in
    each 64-query tile, pad queries at SEP_PAD_INDEX; xw0/xw1/yw0/yw1 the
    fp32 corner-pair weights in the same layout, attention folded into the
    x pair and validity folded in by zeroing ("discrete": the one nearest
    cell, clamped, weight attn on the x0/y0 pair); mask (BH, n_qt, n_bands)
    int32 marks the row bands of r_band rows each that some corner of the
    tile reaches with a non-zero y-weight.
    """
    if method not in ("default", "discrete"):
        raise ValueError(f"unknown MSDA method {method!r}")
    b, q, h_axis, pts, _ = loc_l.shape
    bh = b * h_axis
    n_qt = -(-q // SEP_Q_TILE)
    qp = n_qt * SEP_Q_TILE
    r_band = sep_band_rows(lw)
    n_bands = -(-lh // r_band)
    attn_f = attn_l.to(torch.float32)
    x, y = loc_l[..., 0], loc_l[..., 1]
    if method == "discrete":
        x0 = torch.clamp(torch.floor(x * lw + 0.5), min=0).clamp(max=lw - 1)
        y0 = torch.clamp(torch.floor(y * lh + 0.5), min=0).clamp(max=lh - 1)
        xw0, xw1 = attn_f, torch.zeros_like(attn_f)
        yw0, yw1 = torch.ones_like(attn_f), torch.zeros_like(attn_f)
    else:
        gx = x * lw - 0.5
        gy = y * lh - 0.5
        x0 = torch.floor(gx)
        y0 = torch.floor(gy)
        fx = (gx - x0).to(torch.float32)
        fy = (gy - y0).to(torch.float32)
        vx0 = ((x0 >= 0) & (x0 <= lw - 1)).to(torch.float32)
        vx1 = (x0 + 1 <= lw - 1).to(torch.float32) * (x0 + 1 >= 0)
        vy0 = ((y0 >= 0) & (y0 <= lh - 1)).to(torch.float32)
        vy1 = (y0 + 1 <= lh - 1).to(torch.float32) * (y0 + 1 >= 0)
        xw0 = (1.0 - fx) * vx0 * attn_f
        xw1 = fx * vx1 * attn_f
        yw0 = (1.0 - fy) * vy0
        yw1 = fy * vy1

    def stack(a: torch.Tensor, pad_value=0) -> torch.Tensor:
        a = a.permute(0, 2, 1, 3).reshape(bh, q, pts)
        if qp != q:
            a = torch.nn.functional.pad(a, (0, 0, 0, qp - q), value=pad_value)
        return a.reshape(bh, n_qt, SEP_Q_TILE, pts).permute(0, 1, 3, 2).reshape(
            bh, n_qt * pts * SEP_Q_TILE, 1).contiguous()

    xi = stack(x0.to(torch.int32), SEP_PAD_INDEX)
    yi = stack(y0.to(torch.int32), SEP_PAD_INDEX)
    operands = (xi, stack(xw0), stack(xw1), yi, stack(yw0), stack(yw1))
    # the y-only hit table: a corner row counts where its y-weight can be
    # non-zero (floor division, so a negative row is never a band)
    bands = torch.cat([
        torch.where(operands[4] > 0, torch.div(yi, r_band, rounding_mode="floor"), -1),
        torch.where(operands[5] > 0, torch.div(yi + 1, r_band, rounding_mode="floor"), -1),
    ], dim=-1).reshape(bh, n_qt, -1)
    mask = torch.zeros((bh, n_qt, n_bands + 1), dtype=torch.int32, device=loc_l.device)
    mask.scatter_(2, (bands + 1).long(), 1)
    return operands, mask[..., 1:].contiguous(), r_band


def msda_sep_reference(
    rows: torch.Tensor,  # (BH, lh*lw, hd) this level's value rows, row-major
    xi: torch.Tensor, xw0: torch.Tensor, xw1: torch.Tensor,
    yi: torch.Tensor, yw0: torch.Tensor, yw1: torch.Tensor,
    mask: torch.Tensor,  # (BH, n_qt, n_bands) int32
    level_hw: tuple[int, int],
    r_band: int,
    n_points: int,
    precision: str = "highest",
) -> torch.Tensor:
    """Plain version of `msda_sep_sum`, `pallas_sep_sampling`'s function on
    gathers: out[bh, q] = sum over points p, rows y0 + dy and columns
    x0 + dx (dy, dx in {0, 1}) of xw_dx * V[y, x] * yw_dy, where a row counts
    only inside the level and inside a band whose mask bit is set, and a
    column only inside the level. Returns (BH, n_qt*64, hd) fp32; pad
    queries come out 0.

    precision="default" is the TPU's two bf16 passes: per point and row,
    g = bf16(xw0) * bf16(V[y, x0]) + bf16(xw1) * bf16(V[y, x0 + 1]) (products
    exact, one fp32 sum), times yw in fp32; the points' terms of each row
    summed in fp32 in point order, that sum rounded to bf16, and the rows
    summed in fp32 (`_sep_one_pass`)."""
    _check_precision(precision)
    lh, lw = level_hw
    bh, _, hd = rows.shape
    n_qt, n_bands = mask.shape[1], mask.shape[2]
    nq = n_qt * SEP_Q_TILE

    def unstack(a):  # (BH, n_qt*P*64, 1) -> (BH, P, n_qt*64)
        return a.reshape(bh, n_qt, n_points, SEP_Q_TILE).permute(0, 2, 1, 3).reshape(
            bh, n_points, nq)

    xi_u, yi_u = unstack(xi).long(), unstack(yi).long()
    xw = (unstack(xw0).to(torch.float32), unstack(xw1).to(torch.float32))
    yw = (unstack(yw0).to(torch.float32), unstack(yw1).to(torch.float32))
    tile = torch.arange(nq, device=rows.device) // SEP_Q_TILE  # (n_qt*64,)
    band_on = mask.ne(0)
    bh_idx = torch.arange(bh, device=rows.device).view(bh, 1, 1)

    def corner(y, row_on, dx):  # (BH, P, nq, hd) values of column x0 + dx, 0 where off
        x = xi_u + dx
        valid = row_on & (x >= 0) & (x < lw)
        flat = torch.where(valid, y * lw + x, 0) + bh_idx * (lh * lw)
        g = rows.reshape(bh * lh * lw, hd).index_select(0, flat.reshape(-1))
        g = g.reshape(bh, n_points, nq, hd).to(torch.float32)
        return torch.where(valid[..., None], g, 0.0)

    def row_on_of(y):
        band = torch.div(y, r_band, rounding_mode="floor").clamp(0, n_bands - 1)
        return (y >= 0) & (y < lh) & band_on[bh_idx, tile.view(1, 1, nq), band]

    if precision == "default":
        return _sep_one_pass(corner, row_on_of, xw, yw, yi_u, (bh, nq, hd))
    out = torch.zeros((bh, nq, hd), dtype=torch.float32, device=rows.device)
    for dy in (0, 1):
        y = yi_u + dy
        row_on = row_on_of(y)
        for dx in (0, 1):
            term = corner(y, row_on, dx) * xw[dx][..., None] * torch.where(
                row_on, yw[dy], 0.0)[..., None]
            out += term.sum(dim=1)
    return out


def _sep_one_pass(corner, row_on_of, xw, yw, yi_u, out_shape) -> torch.Tensor:
    """`msda_sep_reference`'s "default" mode. The 2P candidate rows of a
    query, (p, dy) in order, each carry m = fp32(g * yw) with g the x-dot of
    that row (bf16 operands, products exact, one fp32 sum). A candidate whose
    row no earlier candidate has takes the fp32 sum, in order, of its own m
    and every later candidate's m on the same row, rounds it to bf16 and adds
    it to the output; a candidate whose row came earlier adds nothing. That
    is the TPU's per-row point sum `acc` and its rounding before the group-sum
    dot, with rows that no point hits contributing 0, as they do there."""
    n_points = yi_u.shape[1]
    xr = (bf16_round(xw[0]), bf16_round(xw[1]))
    cands = []  # (row, m) per (p, dy), rows (BH, nq), m (BH, nq, hd)
    for dy in (0, 1):
        y = yi_u + dy
        row_on = row_on_of(y)
        g = (bf16_round(corner(y, row_on, 0)) * xr[0][..., None]
             + bf16_round(corner(y, row_on, 1)) * xr[1][..., None])
        m = g * torch.where(row_on, yw[dy], 0.0)[..., None]
        cands.append((y, m))
    order = [(cands[dy][0][:, p], cands[dy][1][:, p]) for p in range(n_points) for dy in (0, 1)]
    out = torch.zeros(out_shape, dtype=torch.float32, device=yi_u.device)
    for c, (row, m) in enumerate(order):
        first = torch.ones_like(row, dtype=torch.bool)
        for row_e, _ in order[:c]:
            first &= row_e != row
        acc = m
        for row_l, m_l in order[c + 1:]:
            acc = acc + torch.where((row_l == row)[..., None], m_l, 0.0)
        out = out + torch.where(first[..., None], bf16_round(acc), 0.0)
    return out


def prepare_msda_gather_lanes(
    loc: torch.Tensor,  # (B, Q, H, LP, 2) normalized sample points
    attn: torch.Tensor,  # (B, Q, H, LP)
    spatial_shapes: tuple[tuple[int, int], ...],
    num_points: int,
    method: str = "default",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Corner indices and weights in the lane-gather layout, as the JAX
    package's `prepare_msda_gather` gives them: idx (B, H, 4, LP*Q) int32
    global into S and w (B, H, 4, LP*Q) fp32, sample-major (sample j's Q
    queries contiguous), the corner slots in (0,0), (0,1), (1,0), (1,1) order;
    "discrete" fills slot 0 and leaves three slots of index 0 and weight 0."""
    b, q, h_axis, lp, _ = loc.shape
    _check_samples(lp, spatial_shapes, num_points, method)
    lvl_h, lvl_w, lvl_off = level_tables(
        tuple(map(tuple, spatial_shapes)), num_points, loc.device, torch.float32)
    loc_t = loc.permute(0, 2, 3, 1, 4)  # (B, H, LP, Q, 2)
    corners = _corner_terms(
        loc_t[..., 0], loc_t[..., 1], attn.permute(0, 2, 3, 1),
        lvl_w.view(lp, 1), lvl_h.view(lp, 1), method,
    )
    while len(corners) < 4:
        corners.append((torch.zeros_like(corners[0][0]), torch.zeros_like(corners[0][1])))
    idx = torch.stack([lvl_off.view(lp, 1) + c for c, _ in corners], dim=2)
    w = torch.stack([cw for _, cw in corners], dim=2)
    return idx.reshape(b, h_axis, 4, lp * q).contiguous(), w.reshape(b, h_axis, 4, lp * q).contiguous()


def msda_hd_gather_reference(
    value: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, lp: int, q: int
) -> torch.Tensor:
    """Plain version of `msda_hd_gather_sum` (`_gather_weighted_sum`'s
    function, in its kernel's order): value (B, S, H, hd), idx/w (B, H, 4,
    LP*Q) -> (B, Q, H, hd) in value's dtype, each sample's four corner
    products g * w summed in slot order, then the LP samples in order, all in
    value's dtype. A term whose index lies outside [0, S) is skipped."""
    b, s, h_axis, hd = value.shape
    out = torch.zeros((b, q, h_axis, hd), dtype=value.dtype, device=value.device)
    for j in range(lp):
        acc = torch.zeros_like(out)
        for c in range(4):
            ids = idx[:, :, c, j * q:(j + 1) * q].transpose(1, 2)  # (B, Q, H)
            valid = (ids >= 0) & (ids < s)
            g = torch.gather(value, 1, torch.where(valid, ids, 0).long()[..., None].expand(
                b, q, h_axis, hd))
            wc = torch.where(valid, w[:, :, c, j * q:(j + 1) * q].transpose(1, 2), 0.0)
            acc = acc + g * wc.to(value.dtype)[..., None]
        out = out + acc
    return out


@functools.cache
def build_msda_backends_kernel() -> KernelLibrary:
    """Build (first call only), load and bind the sep and lane-gather kernel
    library; returns it with its build time and nvcc log."""
    loaded = load_kernel_library("msda_backends", ("msda_backends.cu",))
    lib = loaded.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _bind_entries(lib, {"msda_sep_sum": [ptr] * 9 + [i32] * 8 + [ptr]})
    for suffix in ("f32", "bf16"):  # the lane gather takes no precision
        fn = getattr(lib, f"msda_hd_gather_sum_{suffix}")
        fn.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        fn.restype = ctypes.c_int
    return loaded


def msda_sep_sum(
    rows: torch.Tensor,
    xi: torch.Tensor, xw0: torch.Tensor, xw1: torch.Tensor,
    yi: torch.Tensor, yw0: torch.Tensor, yw1: torch.Tensor,
    mask: torch.Tensor,
    level_hw: tuple[int, int],
    r_band: int,
    n_points: int,
    precision: str = "highest",
) -> torch.Tensor:
    """Separable bilinear sampling over one level.

    rows (BH, lh*lw, hd) f32/bf16, the level's value rows row-major (the
    JAX kernel's (W, R*hd) band transpose exists for its MXU dot and is not
    taken); xi/yi (BH, n_qt*P*64, 1) int32 and xw0/xw1/yw0/yw1 of the same
    shape fp32, from `sep_level_operands`; mask (BH, n_qt, n_bands) int32 ->
    (BH, n_qt*64, hd) fp32, in `precision`. CUDA tensors launch
    `csrc/msda_backends.cu`; CPU tensors take `msda_sep_reference`;
    anything else raises. Every call notes the JAX package's FLOPs for
    `pallas_sep_sampling`: 2·BH·bands·(n_qt·P·64·W·R·hd + Qp·R·hd·hd).
    """
    ops = (xi, xw0, xw1, yi, yw0, yw1)
    _check_precision(precision)
    if rows.device.type == "cpu":
        _require_cpu("msda_sep_sum", *ops, mask)
        out = msda_sep_reference(rows, *ops, mask, level_hw, r_band, n_points, precision)
        _note_sep_flops(rows, mask, level_hw, r_band, n_points)
        return out
    _require_cuda("msda_sep_sum", rows)
    f32, i32 = torch.float32, torch.int32
    _check_cuda_tensors(
        rows, xi=(xi, i32, 3), xw0=(xw0, f32, 3), xw1=(xw1, f32, 3), yi=(yi, i32, 3),
        yw0=(yw0, f32, 3), yw1=(yw1, f32, 3), mask=(mask, i32, 3),
    )
    lh, lw = level_hw
    bh, s, hd = rows.shape
    n_qt, n_bands = mask.shape[1], mask.shape[2]
    want = (bh, n_qt * n_points * SEP_Q_TILE, 1)
    if s != lh * lw or r_band < 1 or n_bands != -(-lh // r_band) or mask.shape[0] != bh or any(
            tuple(t.shape) != want for t in ops):
        raise ValueError(
            f"expected rows (BH, {lh}*{lw}, hd), operands {want}, mask (BH, n_qt, "
            f"ceil({lh}/{r_band})); got {tuple(rows.shape)}, "
            f"{[tuple(t.shape) for t in ops]}, {tuple(mask.shape)}"
        )
    _note_sep_flops(rows, mask, level_hw, r_band, n_points)
    out = torch.empty((bh, n_qt * SEP_Q_TILE, hd), dtype=f32, device=rows.device)
    if out.numel() == 0:
        return out
    _launch("msda_sep_sum", rows, rows.data_ptr(), *(t.data_ptr() for t in ops),
            mask.data_ptr(), out.data_ptr(), bh, n_qt, n_points, lh, lw, hd, r_band, n_bands,
            build=build_msda_backends_kernel, precision=precision)
    msda_sep_sum.launches += 1
    return out


msda_sep_sum.launches = 0


def _note_sep_flops(rows, mask, level_hw, r_band: int, n_points: int) -> None:
    bh, hd = rows.shape[0], rows.shape[2]
    n_qt, rhd = mask.shape[1], r_band * hd
    note_kernel_flops("msda_sep_sum", 2 * bh * mask.shape[2] * (
        n_qt * n_points * SEP_Q_TILE * level_hw[1] * rhd + n_qt * SEP_Q_TILE * rhd * hd))


def msda_hd_gather_sum(
    value: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, lp: int, q: int
) -> torch.Tensor:
    """Lane-gather sampling: value (B, S, H, hd) f32/bf16, read in place,
    idx (B, H, 4, LP*Q) int32, w (B, H, 4, LP*Q) fp32 from
    `prepare_msda_gather_lanes` -> (B, Q, H, hd) in value's dtype, which is
    also the dtype it sums in. CUDA tensors launch `csrc/msda_backends.cu`;
    CPU tensors take `msda_hd_gather_reference`; anything else raises."""
    if value.device.type == "cpu":
        _require_cpu("msda_hd_gather_sum", idx, w)
        return msda_hd_gather_reference(value, idx, w, lp, q)
    _require_cuda("msda_hd_gather_sum", value)
    _check_value("msda_hd_gather_sum", value, idx=(idx, torch.int32, 4),
                 w=(w, torch.float32, 4))
    b, s, h_axis, hd = value.shape
    if idx.shape != (b, h_axis, 4, lp * q) or w.shape != idx.shape:
        raise ValueError(
            f"expected idx/w ({b}, {h_axis}, 4, {lp}*{q}); got {tuple(idx.shape)}, "
            f"{tuple(w.shape)}"
        )
    out = torch.empty((b, q, h_axis, hd), dtype=value.dtype, device=value.device)
    if out.numel() == 0 or lp == 0:
        return out.zero_()
    _launch("msda_hd_gather_sum", value, value.data_ptr(), idx.data_ptr(), w.data_ptr(),
            out.data_ptr(), b, h_axis, s, hd, q, lp, build=build_msda_backends_kernel)
    msda_hd_gather_sum.launches += 1
    return out


msda_hd_gather_sum.launches = 0


def _sep_sampling(value, loc, attn, spatial_shapes, num_points, method,
                  precision: str = "highest") -> torch.Tensor:
    """The pallas_sep path: one `msda_sep_sum` per level, summed in level
    order -> (B*H, Q, hd) fp32."""
    b, s, h_axis, hd = value.shape
    q, lp = loc.shape[1], loc.shape[3]
    _check_samples(lp, spatial_shapes, num_points, method)
    rows_all = _value_rows(value)
    offs = level_offsets(spatial_shapes)
    out = None
    for lvl, (lh, lw) in enumerate(spatial_shapes):
        pts = slice(lvl * num_points, (lvl + 1) * num_points)
        operands, mask, r_band = sep_level_operands(
            loc[:, :, :, pts], attn[:, :, :, pts], lh, lw, method)
        rows_l = rows_all[:, offs[lvl]:offs[lvl] + lh * lw].contiguous()
        part = msda_sep_sum(rows_l, *operands, mask, (lh, lw), r_band, num_points,
                            precision)[:, :q]
        out = part if out is None else out + part
    return out


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

    Same signature and result as spotter_tpu.ops.msda.deformable_sampling,
    dispatched in its order: SPOTTER_TPU_MSDA=pallas_sep runs `msda_sep_sum`
    per level and =pallas_gather `msda_hd_gather_sum`, whatever the prep
    setting; otherwise SPOTTER_TPU_MSDA_PREP=kernel runs the corner prep
    inside `msda_loc_sum`, and the rest feeds `prepare_msda_gather` to
    `msda_gather_sum`. Each kernel but the lane gather runs the forward's
    precision (`backend_precision`). Every branch but pallas_sep hands its kernel the
    value, loc and attn as they are (`contiguous()` copies only for a
    caller whose tensors are not) and gets (B, Q, H, hd) back, whose
    reshape to (B, Q, H*hd) is a view. The JAX package takes its loc-prep
    kernel only where each level tile spans whole rows, a TPU tiling
    condition; the port has no tiles, so the loc kernel always applies. `presorted` is accepted and
    ignored, and the JAX package's in-op locality sort of the pallas and
    pallas_sep backends is not done: query order only decides which source
    tiles or row bands a TPU tile's hit table marks, never a query's value.
    """
    del presorted
    b, _, h_axis, hd = value.shape
    q, lp = loc.shape[1], loc.shape[3]
    backend = msda_backend()
    precision = backend_precision(backend)
    if backend == "pallas_sep":
        out = _heads_out(_sep_sampling(value, loc, attn, spatial_shapes, num_points, method,
                                       precision), b, h_axis)
    elif backend == "pallas_gather":
        idx, w = prepare_msda_gather_lanes(loc, attn, spatial_shapes, num_points, method)
        out = msda_hd_gather_sum(value.contiguous(), idx, w, lp, q)
    elif MSDA_PREP == "kernel":
        _check_samples(lp, spatial_shapes, num_points, method)
        f32 = torch.float32
        tables = level_tables(tuple(map(tuple, spatial_shapes)), num_points, loc.device, f32)
        note_kernel_flops("msda_loc_sum", onehot_flops(
            b * h_axis, q, hd, spatial_shapes, (1 if method == "discrete" else 4) * num_points))
        out = msda_loc_sum(value.contiguous(), loc.to(f32).contiguous(),
                           attn.to(f32).contiguous(), *tables, method, precision)
    else:
        # the JAX package stages four corners a sample whatever the method
        note_kernel_flops("msda_gather_sum",
                          onehot_flops(b * h_axis, q, hd, spatial_shapes, 4 * num_points))
        out = msda_gather_sum(
            value.contiguous(), *prepare_msda_gather(loc, attn, spatial_shapes, num_points, method),
            precision)
    return out.reshape(b, q, h_axis * hd).to(value.dtype)


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
    its TPU backend and interpret switches. Under SPOTTER_TPU_MSDA=pallas_sep
    or =pallas_gather it takes the JAX package's fallback: the einsum
    prologue, then `deformable_sampling` with that backend's kernel. The weights arrive in the Dense
    layout (the model layer keeps its `sampling_offsets`/`attention_weights`
    parameters, so a checkpoint serves both paths) and are re-laid per head
    here. There is no padding of queries: every output row is a real query.
    `presorted` is accepted and ignored, as in `deformable_sampling`.
    """
    b, _, h_axis, hd = value.shape
    q = hs.shape[1]
    lp = len(spatial_shapes) * num_points
    heads = fused_head_weights(w_off, b_off, w_att, b_att, h_axis)
    base, scale = fused_anchors(reference_points, lp, num_points, offset_scale)
    backend = msda_backend()
    if backend in ("pallas_sep", "pallas_gather"):
        # the JAX package's fallback: the prologue in plain tensor code, then
        # whatever core the backend names
        hs32 = hs.to(torch.float32)
        w_off_h, b_off_h, w_att_h, b_att_h = heads
        offs = torch.einsum("bqd,hdl->bqhl", hs32, w_off_h) + b_off_h[:, 0][None, None]
        xy = base[:, :, None, :] + offs * scale[:, :, None, :]
        logits = torch.einsum("bqd,hdl->bqhl", hs32, w_att_h) + b_att_h[:, 0][None, None]
        attn = torch.softmax(logits, dim=-1)
        loc = torch.stack([xy[..., :lp], xy[..., lp:]], dim=-1)
        return deformable_sampling(value, loc, attn.to(value.dtype), spatial_shapes,
                                   num_points, method=method, presorted=presorted)
    del presorted
    tables = level_tables(tuple(map(tuple, spatial_shapes)), num_points, hs.device, torch.float32)
    # the prologue's three projections, then the one-hot core
    qp = -(-q // ONEHOT_Q_TILE) * ONEHOT_Q_TILE
    note_kernel_flops("msda_fused_sum", 2 * b * h_axis * qp * hs.shape[2] * 3 * lp + onehot_flops(
        b * h_axis, q, hd, spatial_shapes, (1 if method == "discrete" else 4) * num_points))
    out = msda_fused_sum(
        value.contiguous(), hs.to(torch.float32).contiguous(), *heads, base, scale, *tables,
        method, backend_precision(backend),
    )
    return out.reshape(b, q, h_axis * hd).to(value.dtype)
