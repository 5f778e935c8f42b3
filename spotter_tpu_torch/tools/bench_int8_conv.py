"""The int8 convolution on the card at the model's shapes (counterpart of
tools/bench_int8_conv.py).

The JAX tool times XLA's bf16 and int8 `conv_general_dilated` at the seven
shapes that dominate the RT-DETRv2-R101 forward (the CSP RepVGG 3x3 convs
at 384 channels on 80², 40² and 20²; the backbone's 3x3 at 160²x64, 80²x128
and 40²x256; a 1x1 projection 40² 256 -> 1024; B = 8, stride 1, "SAME"
padding). Here the same seven, through the port's int8 conv path,
utils/quant.py's `int8_conv` (three kernels): `amax_samples`, `nhwc_codes`
(the NHWC codes, one byte a value) and `conv_s8` on the layer's kept
tap-major weight codes (`quantize_conv_weight`), which gathers the codes
in place and dequantizes in its epilogue.

Per shape:

- each kernel against its plain version on the same card inputs: the amax,
  codes and scales exact, the outputs bit equal; the route whole bit equal
  to its kernels' output;
- each kernel's time (CUDA events, a cold L2) and its bound (bytes or
  operations, whichever takes longer); the plain versions' times;
- on the card, `conv_s8` at each of its tile widths;
- the route's time beside cuDNN's bf16 convolution of the same operands
  (`F.conv2d`), and the amax pass's beside
  `torch.linalg.vector_norm(x, inf)` over each sample: yardsticks only, the
  port never calls them on an int8 path.

Each conv case records which path of the amax and NHWC passes served it
(`fast` or `general` for the amax; `transpose`, `transpose_scalar`, `rows`
or `rows_scalar` for the NHWC codes), the amax's partials a sample and
`conv_s8`'s tile width. MAIN_SHAPE runs in float32 too (the `float32` +
INT8 path). The NHWC entry and the route are held exact at the COVERAGE
list (ragged H*W, C not a multiple of 16 or wider than a tile, c_pad past
C, kernel sizes 1, 3 and 7 at strides 1 and 2, NCHW and channels-last
inputs, fp32 and bf16), `conv_s8` at every SERVED_CONVS shape (the seven
families' quantized convolutions) in fp32 and bf16, and the heads and
heads_t entries at HEADS_COVERAGE (B = 1 and 8, T not a multiple of 16,
hd 32 and 64, groups at, just below and just above the one-launch limit,
contiguous, packed and unaligned views).

Two more cases put the GEMM and the passes at the served paths' other
shapes: a dense projection at YOLOS-base's M = 8 x 4301 = 34,408 rows
(ragged), 768 -> 3072, beside `torch._int_mm` (cuBLASLt's int8 GEMM, B
column-major, the faster layout), and the attention products at RT-DETR's
decoder (B·H 64, Tq = Tk = 300, hd 32: QKᵀ and attn·V, batched); on the
card the dense case times the amax pass and the `rows` quantize entry
apart, with the dense dequant, and the attention case each heads wrapper
call whole (`heads` and `heads_t`: one launch at this shape), beside their
bounds and the entries' plain versions.

    python -m spotter_tpu_torch.tools.bench_int8_conv [--iters 10] [--seed 0]
        [--shapes csp80,bb_s1] [--device cpu] [--out build/bench_int8_conv.json]

`--shapes` runs only the named conv shapes (the float32 case among them if
MAIN_SHAPE is named), without the coverage and served lists and the dense
and attention cases. Runs on cuda unless --device cpu is given (then the
wrappers take their plain versions, every time is a host-clock CPU time,
and --shapes should name small ones). Prints one JSON line per case and
writes the record.
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from spotter_tpu_torch.ops import int8
from spotter_tpu_torch.tools.timing import (
    PEAK_BYTES_PER_S,
    PEAK_INT8_OPS,
    device_record,
    l2_flush_buffer,
    ms_key,
    resolve_device,
    time_ms,
)
from spotter_tpu_torch.utils import quant

REPO = Path(__file__).resolve().parents[2]
# (name, B, H, W, Cin, Cout, k, stride): the JAX tool's seven
SHAPES = (
    ("csp80", 8, 80, 80, 384, 384, 3, 1),
    ("csp40", 8, 40, 40, 384, 384, 3, 1),
    ("csp20", 8, 20, 20, 384, 384, 3, 1),
    ("bb_s1", 8, 160, 160, 64, 64, 3, 1),
    ("bb_s2", 8, 80, 80, 128, 128, 3, 1),
    ("bb_s3", 8, 40, 40, 256, 256, 3, 1),
    ("bb_p3", 8, 40, 40, 256, 1024, 1, 1),
)
MAIN_SHAPE = "csp80"  # the case the kernels line reports for the quantize and dequant passes
DENSE_SHAPE = (8, 4301, 768, 3072)  # YOLOS-base fc1 at B = 8: (B, T, K, N)
ATTN_SHAPE = (8, 300, 8, 32)  # RT-DETR decoder self-attention: (B, T, H, hd)
# the NHWC entry's coverage list: (x NCHW, the conv's k, stride, padding,
# c_pad past pad16(C)), each in fp32 and bf16, NCHW and channels-last: H*W
# ragged against the tile and the 16-byte run, C under 16, not a multiple
# of 16, and wider than a 64-channel tile
COVERAGE = (
    ((8, 64, 40, 40), 3, 1, 1, 0),
    ((2, 64, 33, 31), 3, 2, 1, 0),
    ((3, 72, 17, 9), 1, 1, 0, 0),
    ((2, 3, 30, 30), 7, 2, 3, 0),
    ((2, 20, 19, 23), 3, 1, 1, 32),
    ((2, 40, 21, 18), 1, 2, 0, 16),
    ((1, 24, 15, 13), 7, 1, 3, 0),
    ((2, 20, 19, 24), 3, 1, 1, 32),
    ((2, 136, 22, 16), 3, 2, 1, 0),
    ((2, 200, 10, 24), 1, 1, 0, 16),
    ((8, 384, 20, 20), 7, 2, 3, 0),
)
# the heads entries' coverage list: (B, T, H, hd), each in fp32 and bf16,
# in both layouts, as a contiguous tensor, a packed q/k/v slice (aligned
# strides) and an unaligned view: RT-DETR's decoder and AIFI, B = 1 with T
# ragged, and groups at the one-launch limit in fp32 (768 x 32 x 4 bytes),
# just above it, and above it in bf16 too
HEADS_COVERAGE = ((8, 300, 8, 32), (8, 400, 8, 32), (1, 17, 3, 64), (2, 768, 2, 32),
                  (2, 769, 2, 32), (2, 1537, 2, 32))
HEADS_VIEWS = ("contiguous", "packed", "unaligned")
# every quantized convolution (C, N, k, stride, padding) of the seven
# families at full width (RT-DETRv2-R101 under each policy, the ResNet-50
# backbones and input projections of Deformable-DETR and the DETR lineage;
# YOLOS and the OWL models quantize no convolution), from a walk of their
# module trees with utils/quant.py's channel floor; conv_s8 is held exact at
# each, on SERVED_HW inputs at the batch floor
SERVED_CONVS = (
    (64, 64, 1, 1, 0), (64, 64, 3, 1, 1), (64, 256, 1, 1, 0), (128, 128, 3, 1, 1),
    (128, 128, 3, 2, 1), (128, 512, 1, 1, 0), (256, 64, 1, 1, 0), (256, 128, 1, 1, 0),
    (256, 256, 3, 1, 1), (256, 256, 3, 2, 1), (256, 512, 1, 1, 0), (256, 512, 1, 2, 0),
    (256, 1024, 1, 1, 0), (384, 256, 1, 1, 0), (384, 384, 1, 1, 0), (384, 384, 3, 1, 1),
    (384, 384, 3, 2, 1), (512, 128, 1, 1, 0), (512, 256, 1, 1, 0), (512, 384, 1, 1, 0),
    (512, 512, 3, 1, 1), (512, 512, 3, 2, 1), (512, 1024, 1, 1, 0), (512, 1024, 1, 2, 0),
    (512, 2048, 1, 1, 0), (768, 384, 1, 1, 0), (1024, 256, 1, 1, 0), (1024, 384, 1, 1, 0),
    (1024, 512, 1, 1, 0), (1024, 2048, 1, 1, 0), (1024, 2048, 1, 2, 0), (2048, 384, 1, 1, 0),
    (2048, 512, 1, 1, 0),
)
SERVED_HW = (8, 21, 17)  # B at the batch floor; H x W odd, so tiles straddle samples


def bound(nbytes: float, ops: float) -> dict:
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def _equal(a, b) -> bool:
    return bool(torch.equal(a, b))


def _paths(before: dict, device) -> dict:
    """The path of each pass that served the calls since `before` (the
    kernels' path counts), or "plain" on the CPU."""
    if device.type != "cuda":
        return {name: "plain" for name in before}
    return {name: ",".join(sorted(getattr(int8, name).paths - n)) for name, n in before.items()
            if getattr(int8, name).paths != n}


def _path_counts() -> dict:
    return {name: getattr(int8, name).paths.copy()
            for name in ("amax_s8", "quantize_s8", "quantize_nhwc_s8")}


def _tile_n(n: int, m: int, device):
    """The tile width conv_s8 takes at N, M on the card, or "plain"."""
    return int8.default_tile_n(n, m, device) if device.type == "cuda" else "plain"


def _weights(rng, cin: int, cout: int, k: int, device):
    wt = torch.from_numpy((rng.standard_normal((cout, cin, k, k), dtype=np.float32)
                           / np.sqrt(cin * k * k)).astype(np.float32)).to(device)
    return wt, int8.quantize_conv_weight(wt)


def _tap_codes_exact(qc, wt) -> bool:
    """The tap-major weight codes and scales against utils/quant.py's
    OIHW codes, permuted and zero past C."""
    codes, scale = quant.quantize_weight(wt)
    cout, cin, k, _ = wt.shape
    want = F.pad(codes.permute(0, 2, 3, 1), (0, qc.c_pad - cin)).reshape(cout, -1)
    return _equal(qc.codes, want) and _equal(qc.scale, scale)


def conv_case(shape, dtype, seed: int, iters: int, device, flush, calls: dict) -> dict:
    """One of the seven shapes in `dtype`: each kernel of the route exact
    against its plain version on the card's inputs, the route whole bit
    equal to its kernels' output; times and bounds; cuDNN's bf16 conv
    beside."""
    name, b, h, w, cin, cout, k, stride = shape
    pad = (k - 1) // 2  # "SAME" at stride 1
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w), dtype=np.float32)).to(device)
    x = x.to(dtype)
    wt, qc = _weights(rng, cin, cout, k, device)
    ho, wo = int8.conv_out_hw(h, w, k, stride, pad)

    def amax():
        calls["amax_s8"] += 1
        return int8.amax_samples(x)

    def quantize():
        calls["quantize_nhwc_s8"] += 1
        return int8.nhwc_codes(x, ax, qc.c_pad)

    def conv():
        calls["conv_s8"] += 1
        return int8.conv_s8(nhwc, qc.codes, sx, qc.scale, k, stride, pad, dtype)

    def path():  # the served route, three kernels
        calls["amax_s8"] += 1
        calls["quantize_nhwc_s8"] += 1
        calls["conv_s8"] += 1
        return quant.int8_conv(x, qc, k, stride, pad, dtype)

    calls["amax_s8"] += 1  # the weight's codes above
    calls["quantize_s8"] += 1
    before = _path_counts()
    ax = amax()
    want_ax = int8.amax_samples_reference(x)
    nhwc, sx = quantize()
    paths = _paths(before, device)
    want_nhwc, want_sx = int8.nhwc_codes_reference(x, ax, qc.c_pad)
    out = conv()
    want_out = int8.conv_s8_reference(nhwc, qc.codes, sx, qc.scale, k, stride, pad, dtype)
    rec = {
        "part": "conv", "shape": name, "dtype": str(dtype).removeprefix("torch."), "b": b,
        "h": h, "w": w, "cin": cin, "cout": cout, "k": k, "stride": stride,
        "c_pad": qc.c_pad, "amax_parts": ax.shape[1],
        "paths": paths, "conv_s8_tile_n": _tile_n(cout, b * ho * wo, device),
        "amax_exact": _equal(ax.amax(1), want_ax.amax(1)),
        "nhwc_codes_exact": _equal(nhwc, want_nhwc) and _equal(sx, want_sx),
        "weight_codes_exact": _tap_codes_exact(qc, wt),
        "conv_s8_bit_equal": _equal(out, want_out),
        "route_bit_equal": _equal(path(), out),
    }
    rec["exact"] = all(rec[key] for key in (
        "amax_exact", "nhwc_codes_exact", "weight_codes_exact", "conv_s8_bit_equal",
        "route_bit_equal"))
    del want_nhwc, want_out
    ops = 2 * b * ho * wo * cout * cin * k * k
    x_bytes, part_bytes = x.numel() * x.element_size(), ax.numel() * 4
    nhwc_bytes, out_bytes = nhwc.numel(), out.numel() * out.element_size()
    rec["bounds"] = {
        "amax_s8": bound(x_bytes + part_bytes, 0),
        "quantize_nhwc_s8": bound(x_bytes + part_bytes + b * 4 + nhwc_bytes, 0),
        "conv_s8": bound(nhwc_bytes + qc.codes.numel() + (b + cout) * 4 + out_bytes, ops),
        "path": bound(x_bytes + qc.codes.numel() + out_bytes, ops),
    }
    xbf, wbf = x.to(torch.bfloat16), wt.to(torch.bfloat16)
    times = {
        "amax_s8": time_ms(amax, iters, device, flush),
        "quantize_nhwc_s8": time_ms(quantize, iters, device, flush),
        "conv_s8": time_ms(conv, iters, device, flush),
        "path": time_ms(path, iters, device, flush),
        "plain_amax_s8": time_ms(lambda: int8.amax_samples_reference(x), 2, device, flush),
        "plain_quantize_nhwc_s8": time_ms(
            lambda: int8.nhwc_codes_reference(x, ax, qc.c_pad), 2, device, flush),
        "plain_conv_s8": time_ms(
            lambda: int8.conv_s8_reference(nhwc, qc.codes, sx, qc.scale, k, stride, pad, dtype),
            2, device, flush),
        "library_cudnn_bf16": time_ms(lambda: F.conv2d(xbf, wbf, None, stride, pad), iters,
                                      device, flush),
        "library_vector_norm": time_ms(
            lambda: torch.linalg.vector_norm(x, float("inf"), dim=(1, 2, 3)), iters, device,
            flush),
    }
    if device.type == "cuda":  # conv_s8 at each tile width
        for tile_n in int8.CONV_TILE_NS:
            times[f"conv_s8_tile{tile_n}"] = time_ms(
                lambda: int8.conv_s8(nhwc, qc.codes, sx, qc.scale, k, stride, pad, dtype,
                                     tile_n=tile_n), iters, device, flush)
        calls["conv_s8"] += len(int8.CONV_TILE_NS) * (iters + 3)  # cuda_time_ms's warmup
    rec.update({ms_key(key, device): value for key, value in times.items()})
    return rec


def served_case(shape, dtype, seed: int, device, calls: dict) -> dict:
    """`conv_s8` at one SERVED_CONVS shape on SERVED_HW inputs, through the
    served route's passes: the NHWC codes and the output bit equal to the
    plain versions on the same card inputs."""
    cin, cout, k, stride, pad = shape
    b, h, w = SERVED_HW
    rng = np.random.default_rng(seed + sum(shape))
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w), dtype=np.float32)).to(device)
    x = x.to(dtype)
    wt, qc = _weights(rng, cin, cout, k, device)
    calls["amax_s8"] += 2  # the weight's codes, and x's
    calls["quantize_s8"] += 1
    calls["quantize_nhwc_s8"] += 1
    calls["conv_s8"] += 1
    ax = int8.amax_samples(x)
    nhwc, sx = int8.nhwc_codes(x, ax, qc.c_pad)
    want_nhwc, want_sx = int8.nhwc_codes_reference(x, ax, qc.c_pad)
    out = int8.conv_s8(nhwc, qc.codes, sx, qc.scale, k, stride, pad, dtype)
    want = int8.conv_s8_reference(nhwc, qc.codes, sx, qc.scale, k, stride, pad, dtype)
    rec = {"part": "served", "cin": cin, "cout": cout, "k": k, "stride": stride, "pad": pad,
           "x": [b, cin, h, w], "dtype": str(dtype).removeprefix("torch."),
           "conv_s8_tile_n": _tile_n(cout, out.shape[0] * out.shape[2] * out.shape[3], device),
           "nhwc_codes_exact": _equal(nhwc, want_nhwc) and _equal(sx, want_sx),
           "weight_codes_exact": _tap_codes_exact(qc, wt),
           "conv_s8_bit_equal": _equal(out, want)}
    rec["exact"] = (rec["nhwc_codes_exact"] and rec["weight_codes_exact"]
                    and rec["conv_s8_bit_equal"])
    return rec


def coverage_case(shape, k: int, stride: int, pad: int, dtype, channels_last: bool,
                  extra_pad: int, seed: int, device, calls: dict) -> dict:
    """The NHWC entry at one shape of its coverage list: the amax and the
    codes (c_pad past pad16(C) by `extra_pad`) and scales exact against the
    plain versions, and the route at the conv's k, stride and padding bit
    equal to `conv_s8`'s plain version on the plain codes."""
    rng = np.random.default_rng(seed + sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device).to(dtype)
    x[0, :, : shape[2] // 2] = 0.0  # zeros beside the values, as a ReLU's output has
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    c_pad = int8.pad16(shape[1]) + extra_pad
    wt, qc = _weights(rng, shape[1], 24, k, device)
    calls["amax_s8"] += 3  # x's twice, the weight's once
    calls["quantize_s8"] += 1
    calls["quantize_nhwc_s8"] += 2
    calls["conv_s8"] += 1
    before = _path_counts()
    ax = int8.amax_samples(x)
    codes, sx = int8.nhwc_codes(x, ax, c_pad)
    paths = _paths(before, device)
    want_codes, want_sx = int8.nhwc_codes_reference(x, int8.amax_samples_reference(x), c_pad)
    got = quant.int8_conv(x, qc, k, stride, pad, dtype)
    want_nhwc, want_sa = int8.nhwc_codes_reference(x, int8.amax_samples_reference(x), qc.c_pad)
    want = int8.conv_s8_reference(want_nhwc, qc.codes, want_sa, qc.scale, k, stride, pad, dtype)
    rec = {"part": "coverage", "x": list(shape), "k": k, "stride": stride, "pad": pad,
           "c_pad": c_pad, "dtype": str(dtype).removeprefix("torch."),
           "channels_last": channels_last, "paths": paths,
           "amax_exact": _equal(ax.amax(1), int8.amax_samples_reference(x).amax(1)),
           "codes_exact": _equal(codes, want_codes) and _equal(sx, want_sx),
           "route_bit_equal": _equal(got, want)}
    rec["exact"] = rec["amax_exact"] and rec["codes_exact"] and rec["route_bit_equal"]
    return rec


def heads_view(shape, dtype, view: str, rng, device) -> torch.Tensor:
    """x (B, T, H, hd) as a contiguous tensor, as the first of a packed
    (B, T, 3, H, hd) q/k/v (strides past the row, 16-byte aligned), or as
    the first hd values of (B, T, H, hd + 1) (no stride but hd's a whole
    number of 16-byte units)."""
    b, t, h, hd = shape
    if view == "contiguous":
        full, index = (b, t, h, hd), (...,)
    elif view == "packed":
        full, index = (b, t, 3, h, hd), (slice(None), slice(None), 0)
    else:
        full, index = (b, t, h, hd + 1), (..., slice(0, hd))
    x = torch.from_numpy(rng.standard_normal(full, dtype=np.float32)).to(device).to(dtype)
    return x[index]


def heads_case(shape, dtype, view: str, seed: int, device, calls: dict) -> dict:
    """The heads and heads_t entries at one HEADS_COVERAGE shape and view:
    codes and scales exact against the plain version, each call one launch
    or two as `int8.heads_one_launch` says."""
    b, t, h, hd = shape
    x = heads_view(shape, dtype, view, np.random.default_rng(seed + sum(shape)), device)
    one = int8.heads_one_launch(t, hd, dtype)
    rec = {"part": "heads", "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "view": view, "one_launch": one, "exact": True}
    before = _path_counts()
    for transpose in (False, True):
        calls["amax_s8"] += 0 if one else 1
        calls["quantize_s8"] += 1
        codes, scales = int8.quantize_heads(x, transpose)
        want_codes, want_scales = int8.quantize_heads_reference(x, transpose)
        rec["exact"] &= _equal(codes, want_codes) and _equal(scales, want_scales)
    rec["paths"] = _paths(before, device)
    return rec


def dense_case(seed: int, iters: int, device, flush, calls: dict) -> dict:
    """The dense product at YOLOS-base's fc1 (M ragged): quantize (rows),
    the GEMM, dequant (rows), exact; each pass timed beside its bound; the
    GEMM beside torch._int_mm."""
    b, t, kdim, n = DENSE_SHAPE
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((b * t, kdim), dtype=np.float32)).to(device)
    x = x.to(torch.bfloat16)
    wt = torch.from_numpy(rng.standard_normal((n, kdim), dtype=np.float32)).to(device)
    calls["amax_s8"] += 2
    calls["quantize_s8"] += 2
    qw = int8.quantize_weight_rows(wt)
    codes, sx = int8.quantize_rows(x, t, qw.k_pad)
    want_codes, want_sx = int8.quantize_rows_reference(x, t, qw.k_pad)
    calls["int8_gemm_kmajor"] += 1
    y = int8.int8_gemm_kmajor(codes, qw.codes)
    calls["dequant_s32"] += 1
    out = int8.dequant_rows(y, sx, qw.scale, t, torch.bfloat16)
    want_out = int8.dequant_rows_reference(y, sx, qw.scale, t, torch.bfloat16)
    m = b * t
    rec = {"part": "dense", "m": m, "k": kdim, "n": n,
           "codes_exact": _equal(codes, want_codes) and _equal(sx, want_sx),
           "gemm_exact": _equal(y, int8.int8_gemm_kmajor_reference(codes, qw.codes)),
           "dequant_bit_equal": _equal(out, want_out)}
    ops = 2 * m * n * kdim
    parts = 1
    times = {}
    if device.type == "cuda":  # the two passes apart, through the wrappers' own views
        sizes, strides, groups = int8.rows_view(x, t)
        calls["amax_s8"] += 1
        calls["quantize_s8"] += 1
        before = _path_counts()
        partials = int8.amax_view(x, sizes, strides, 0, groups)
        int8.quantize_view(x, sizes, strides, 0, int8.LAYOUT_ROWS, qw.k_pad, (m, qw.k_pad),
                           partials)
        rec["paths"] = _paths(before, device)
        parts = partials.shape[1]
        rec["amax_exact"] = _equal(partials.amax(1),
                                   x.float().abs().view(groups, -1).amax(1))

        def amax():
            calls["amax_s8"] += 1
            return int8.amax_view(x, sizes, strides, 0, groups)

        def quantize():
            calls["quantize_s8"] += 1
            return int8.quantize_view(x, sizes, strides, 0, int8.LAYOUT_ROWS, qw.k_pad,
                                      (m, qw.k_pad), partials)

        times["amax_s8"] = time_ms(amax, iters, device, flush)
        times["quantize_s8_rows"] = time_ms(quantize, iters, device, flush)
        times["library_int_mm"] = time_ms(lambda: torch._int_mm(codes, qw.codes.t()), iters,
                                          device, flush)
        rec["library_exact"] = _equal(torch._int_mm(codes, qw.codes.t()), y)
    else:  # the wrapper whole, its plain version here
        def quantize_rows():
            calls["amax_s8"] += 1
            calls["quantize_s8"] += 1
            return int8.quantize_rows(x, t, qw.k_pad)

        times["quantize_s8_rows"] = time_ms(quantize_rows, iters, device, flush)
    times["plain_quantize_s8_rows"] = time_ms(
        lambda: int8.quantize_rows_reference(x, t, qw.k_pad), 2, device, flush)
    rec["exact"] = (rec["codes_exact"] and rec["gemm_exact"] and rec["dequant_bit_equal"]
                    and rec.get("amax_exact", True))
    x_bytes = m * kdim * 2
    rec["bounds"] = {"amax_s8": bound(x_bytes + b * parts * 4, 0),
                     "quantize_s8_rows": bound(x_bytes + b * parts * 4 + b * 4 + m * qw.k_pad,
                                               0),
                     "int8_gemm_kmajor": bound(m * kdim + n * kdim + m * n * 4, ops),
                     "dequant_s32_rows": bound(m * n * 4 + m * n * 2, 0)}

    def gemm():
        calls["int8_gemm_kmajor"] += 1
        return int8.int8_gemm_kmajor(codes, qw.codes)

    def dequant():
        calls["dequant_s32"] += 1
        return int8.dequant_rows(y, sx, qw.scale, t, torch.bfloat16)

    times["int8_gemm_kmajor"] = time_ms(gemm, iters, device, flush)
    times["dequant_s32_rows"] = time_ms(dequant, iters, device, flush)
    times["plain_dequant_s32_rows"] = time_ms(
        lambda: int8.dequant_rows_reference(y, sx, qw.scale, t, torch.bfloat16), 2, device,
        flush)
    times["plain_int8_gemm_kmajor"] = time_ms(
        lambda: int8.int8_gemm_kmajor_reference(codes, qw.codes), 2, device, flush)
    rec.update({ms_key(key, device): value for key, value in times.items()})
    return rec


def attention_case(seed: int, iters: int, device, flush, calls: dict) -> dict:
    """QKᵀ and attn·V at RT-DETR's decoder, batched over B·H: each pass and
    the GEMM exact against their plain versions; on the card the amax pass
    over V's heads exact (the general path, which the two-launch heads
    calls take), and each heads wrapper call whole (one launch here) timed
    beside its bound."""
    b, t, h, hd = ATTN_SHAPE
    rng = np.random.default_rng(seed + 2)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, hd), dtype=np.float32))
               .to(device) for _ in range(3))
    one = int8.heads_one_launch(t, hd, v.dtype)
    rec = {"part": "attention", "b": b, "t": t, "h": h, "hd": hd, "heads_one_launch": one}
    logits = quant.int8_qk(q, k)
    w = torch.softmax(logits, -1)
    out = quant.int8_av(w, v, torch.float32)
    # the plain versions on the same card tensors (utils/quant.py's, which the
    # CPU tests hold bit equal to the JAX package's)
    rec["qk_exact"] = _equal(logits, quant.int8_qk_reference(q, k))
    rec["av_exact"] = _equal(out, quant.int8_av_reference(w, v, torch.float32))
    codes_ok = True
    for transpose in (False, True):
        got, s = int8.quantize_heads(v, transpose)
        ref = int8.quantize_heads_reference(v, transpose)
        codes_ok &= _equal(got, ref[0]) and _equal(s, ref[1])
    rec["codes_exact"] = codes_ok
    # heads calls: q, k, v, and v twice above; the attention weights' rows
    calls["amax_s8"] += 1 + (0 if one else 5)
    calls["quantize_s8"] += 6
    calls["int8_gemm_kmajor"] += 2
    calls["dequant_s32"] += 2
    if device.type == "cuda":
        calls["amax_s8"] += 1
        before = _path_counts()
        partials = int8.amax_view(v, tuple(v.shape), v.stride(), 2, b * h)
        rec["paths"] = _paths(before, device)
        rec["amax_parts"] = partials.shape[1]
        rec["amax_exact"] = _equal(partials.amax(1),
                                   v.abs().amax(dim=(1, 3)).reshape(-1))

        def heads(transpose):
            def call():
                calls["amax_s8"] += 0 if one else 1
                calls["quantize_s8"] += 1
                return int8.quantize_heads(v, transpose)
            return call

        times = {"quantize_s8_heads": time_ms(heads(False), iters, device, flush),
                 "quantize_s8_heads_t": time_ms(heads(True), iters, device, flush),
                 "plain_quantize_s8_heads": time_ms(
                     lambda: int8.quantize_heads_reference(v, False), 2, device, flush),
                 "plain_quantize_s8_heads_t": time_ms(
                     lambda: int8.quantize_heads_reference(v, True), 2, device, flush)}
        rec.update({ms_key(key, device): value for key, value in times.items()})
        v_bytes, scale_bytes = v.numel() * 4, b * h * 4
        rec["bounds"] = {
            "quantize_s8_heads": bound(v_bytes + scale_bytes + b * h * t * int8.pad16(hd), 0),
            "quantize_s8_heads_t": bound(v_bytes + scale_bytes + b * h * hd * int8.pad16(t), 0)}
    rec["exact"] = (rec["qk_exact"] and rec["av_exact"] and codes_ok
                    and rec.get("amax_exact", True))
    return rec


def run(args) -> dict:
    device = resolve_device(args.device)
    flush = l2_flush_buffer(device) if device.type == "cuda" else None
    calls = {"amax_s8": 0, "quantize_s8": 0, "quantize_nhwc_s8": 0, "int8_gemm_kmajor": 0,
             "dequant_s32": 0, "conv_s8": 0}
    record = {"tool": "bench_int8_conv", **device_record(device), "seed": args.seed, "cases": []}

    def emit(rec):
        record["cases"].append(rec)
        print(json.dumps(rec), flush=True)

    shapes = [s for s in SHAPES if not args.shapes or s[0] in args.shapes]
    for shape in shapes:
        emit(conv_case(shape, torch.bfloat16, args.seed, args.iters, device, flush, calls))
    for shape in shapes:
        if shape[0] == MAIN_SHAPE:
            emit(conv_case(shape, torch.float32, args.seed, args.iters, device, flush, calls))
    if not args.shapes:
        for xshape, k, stride, pad, extra in COVERAGE:
            for dtype in (torch.float32, torch.bfloat16):
                for channels_last in (False, True):
                    emit(coverage_case(xshape, k, stride, pad, dtype, channels_last, extra,
                                       args.seed, device, calls))
        for shape in SERVED_CONVS:
            for dtype in (torch.float32, torch.bfloat16):
                emit(served_case(shape, dtype, args.seed, device, calls))
        for shape in HEADS_COVERAGE:
            for dtype in (torch.float32, torch.bfloat16):
                for view in HEADS_VIEWS:
                    emit(heads_case(shape, dtype, view, args.seed, device, calls))
        emit(dense_case(args.seed, args.iters, device, flush, calls))
        emit(attention_case(args.seed, args.iters, device, flush, calls))
    record["calls"] = calls  # the wrappers' calls: on the card, their launches
    return record


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="", type=lambda s: [v for v in s.split(",") if v],
                    help="names of SHAPES to run (default: all, the coverage, served and "
                         "heads lists, and the dense and attention cases)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(REPO / "build" / "bench_int8_conv.json"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    record = run(args)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
