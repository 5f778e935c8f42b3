"""Bicubic resize of position tables, as `jax.image.resize(..., "bicubic")`
computes it (port of what spotter_tpu.models.yolos and .owlvit call).

JAX's resize is separable: for each axis whose size changes it builds a
weight matrix (`jax._src.image.scale.compute_weight_mat`) and contracts the
input with it, at HIGHEST precision. The kernel is Keys' cubic with
a = -0.5; sample positions use half-pixel centres; when downscaling the
kernel is widened by 1/scale (antialiasing); each output's weights are
normalised to sum to one, and an output whose sample falls outside the
input is zero. That is not `F.interpolate(mode="bicubic")`, which uses
a = -0.75, clamps at the border and never antialiases.

The weights depend only on the two sizes, so they are made once per
(input size, output size, device) and kept (never evicted): a captured
CUDA graph reads them in place, and the eager forward that runs before
each capture makes them. Plain PyTorch, not a kernel: the JAX version is
XLA's, not Pallas.
"""

import functools

import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at |distance| `x`, in JAX's form."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def bicubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of one axis, JAX's
    `compute_weight_mat` for the cubic kernel with antialiasing, scale
    out/in and no translation, computed in fp32 as JAX computes them."""
    scale = torch.tensor(out_size / in_size, dtype=torch.float32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@functools.cache
def _weight_table(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`bicubic_weights` on `device`, made once outside inference mode (so it
    also serves forwards that track gradients) and never evicted."""
    with torch.inference_mode(False):
        return bicubic_weights(in_size, out_size).to(device)


def resize_table_bicubic(table: torch.Tensor, src_hw: tuple[int, int],
                         dst_hw: tuple[int, int]) -> torch.Tensor:
    """(..., src_h * src_w, D) table -> (..., dst_h * dst_w, D): the rows read
    as a (src_h, src_w) grid and resized to (dst_h, dst_w) as
    `jax.image.resize(grid, (..., dst_h, dst_w, D), "bicubic")` does; the
    table's dtype is kept. An axis whose size does not change is not
    touched, and equal sizes return `table` itself."""
    src_hw, dst_hw = tuple(src_hw), tuple(dst_hw)
    if src_hw == dst_hw:
        return table
    lead, d = table.shape[:-2], table.shape[-1]
    grid = table.reshape(*lead, *src_hw, d)
    if src_hw[0] != dst_hw[0]:
        w = _weight_table(src_hw[0], dst_hw[0], table.device).to(table.dtype)
        grid = torch.einsum("...hwd,hH->...Hwd", grid, w)
    if src_hw[1] != dst_hw[1]:
        w = _weight_table(src_hw[1], dst_hw[1], table.device).to(table.dtype)
        grid = torch.einsum("...hwd,wW->...hWd", grid, w)
    return grid.reshape(*lead, dst_hw[0] * dst_hw[1], d)
