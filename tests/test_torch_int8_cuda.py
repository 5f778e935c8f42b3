"""The int8 path's kernels on the card (ops/int8.py: the amax and quantize
passes of csrc/quant.cu, the convolution of csrc/int8_conv.cu, the K-major
entry of csrc/int8_gemm.cu, the dequant passes),
each against its plain version on the same inputs: amax, codes and scales exact,
int32 products exact, dequantized outputs bit equal (the same fp32 product
of the same int32 and scales, rounded once to the output dtype); and
utils/quant.py's four products through them against their runs on the
CPU; the amax pass's partials and the NHWC pass at its coverage list and
at the model's shapes, the heads entries at theirs, on either side of the
one-launch limit, their launches (no memset) and a CUDA graph of the
quantized convolution. This file imports
torch and the port only, so it runs on a machine with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_int8_cuda.py
"""

import numpy as np
import pytest
import torch

from spotter_tpu_torch.ops import int8 as tint8
from spotter_tpu_torch.tools.bench_int8_conv import (
    COVERAGE,
    HEADS_VIEWS,
    SERVED_CONVS,
    SERVED_HW,
    SHAPES,
    heads_view,
)
from spotter_tpu_torch.utils import quant as tquant


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,stride,pad", [((8, 64, 40, 40), 3, 1, 1),
                                                ((2, 64, 33, 31), 3, 2, 1),
                                                ((3, 72, 17, 9), 1, 1, 0),
                                                ((2, 3, 30, 30), 7, 2, 3)])
def test_conv_route_is_exact_on_the_card(dtype, shape, k, stride, pad):
    """Amax and NHWC codes exact, conv_s8 bit equal, each kernel against its
    plain version on the same card inputs, and the route whole against its
    run on the CPU; one amax and one NHWC launch a call; a channels-last
    input gives the same codes."""
    dev = _card()
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((24, shape[1], k, k)).astype(np.float32))
    qc_cpu = tint8.quantize_conv_weight(w)
    qc = tint8.quantize_conv_weight(w.to(dev))
    assert torch.equal(qc.codes.cpu(), qc_cpu.codes) and torch.equal(qc.scale.cpu(), qc_cpu.scale)
    assert torch.equal(tint8.amax_samples(x.to(dev)).amax(1).cpu(), tint8.amax_samples(x).amax(1))
    before = (tint8.amax_s8.launches, tint8.quantize_nhwc_s8.launches)
    codes, sx = tint8.nhwc_codes(x.to(dev), tint8.amax_samples(x.to(dev)), qc.c_pad)
    assert (tint8.amax_s8.launches, tint8.quantize_nhwc_s8.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want_codes, want_sx = tint8.nhwc_codes(x, tint8.amax_samples(x), qc.c_pad)
    assert torch.equal(codes.cpu(), want_codes) and torch.equal(sx.cpu(), want_sx)
    out = tint8.conv_s8(codes, qc.codes, sx, qc.scale, k, stride, pad, dtype)
    assert torch.equal(out.cpu(), tint8.conv_s8(want_codes, qc_cpu.codes, want_sx, qc_cpu.scale,
                                                k, stride, pad, dtype))
    assert torch.equal(tquant.int8_conv(x.to(dev), qc, k, stride, pad, dtype), out)
    # a channels-last input reads along its channels
    cl = x.to(dev).contiguous(memory_format=torch.channels_last)
    assert torch.equal(tint8.nhwc_codes(cl, tint8.amax_samples(cl), qc.c_pad)[0], codes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(34408, 768, 768), (37, 40, 13), (1, 16, 1)])
def test_dense_path_is_exact_on_the_card(dtype, m, k, n):
    dev = _card()
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    rows = m // 8 if m % 8 == 0 else 1
    qw = tint8.quantize_weight_rows(w.to(dev))
    codes, sx = tint8.quantize_rows(x.to(dev), rows, qw.k_pad)
    want_codes, want_sx = tint8.quantize_rows(x, rows, qw.k_pad)
    assert torch.equal(codes.cpu(), want_codes) and torch.equal(sx.cpu(), want_sx)
    y = tint8.int8_gemm_kmajor(codes, qw.codes)
    assert torch.equal(y.cpu(), tint8.int8_gemm_kmajor(want_codes, qw.codes.cpu()))
    out = tint8.dequant_rows(y, sx, qw.scale, rows, dtype)
    assert torch.equal(out.cpu(), tint8.dequant_rows(y.cpu(), want_sx, qw.scale.cpu(), rows,
                                                     dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd", [(8, 300, 8, 32), (2, 17, 3, 64)])
def test_attention_path_is_exact_on_the_card(dtype, b, t, h, hd):
    dev = _card()
    rng = np.random.default_rng(b * t)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, hd)).astype(np.float32)).to(dtype)
               for _ in range(3))
    logits = tquant.int8_qk(q.to(dev), k.to(dev))
    assert torch.equal(logits.cpu(), tquant.int8_qk(q, k))
    w = torch.softmax(logits.cpu(), -1).to(dtype)
    got = tquant.int8_av(w.to(dev), v.to(dev), dtype)
    assert torch.equal(got.cpu(), tquant.int8_av(w, v, dtype))
    for transpose in (False, True):
        codes, s = tint8.quantize_heads(v.to(dev), transpose)
        want = tint8.quantize_heads(v, transpose)
        assert torch.equal(codes.cpu(), want[0]) and torch.equal(s.cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,n,k,batched", [(1, 34408, 768, 768, False),
                                             (64, 300, 300, 32, True),
                                             (64, 300, 32, 304, True),
                                             (3, 1, 7, 16, True),
                                             (2, 129, 257, 48, False)])
def test_int8_gemm_kmajor_is_exact_on_the_card(g, m, n, k, batched):
    """Ragged M and N (odd N too), a B operand shared by the batch or one a
    batch entry: exact against the float64 product."""
    dev = _card()
    rng = np.random.default_rng(g + m + n + k)
    a = torch.from_numpy(rng.integers(-127, 128, (g, m, k), dtype=np.int8)).to(dev)
    bt = torch.from_numpy(rng.integers(-127, 128, (g, n, k) if batched else (n, k),
                                       dtype=np.int8)).to(dev)
    before = tint8.int8_gemm_kmajor.launches
    got = tint8.int8_gemm_kmajor(a, bt)
    assert tint8.int8_gemm_kmajor.launches == before + 1
    assert got.shape == (g, m, n) and torch.equal(got, tint8.int8_gemm_kmajor_reference(a, bt))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(64, 48, 32), (4096, 4096, 4096)])
def test_tool_gemm_is_the_transpose_then_the_kmajor_kernel(m, n, k):
    """`int8_gemm` (B row-major): exact against its plain version; its GEMM
    launch counts on `int8_gemm`, its transpose on `transpose_s8`, nothing
    on `int8_gemm_kmajor`."""
    dev = _card()
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
    counters = (tint8.int8_gemm, tint8.transpose_s8, tint8.int8_gemm_kmajor)
    before = [c.launches for c in counters]
    got = tint8.int8_gemm(a, b)
    assert [c.launches - n0 for c, n0 in zip(counters, before)] == [1, 1, 0]
    assert torch.equal(got, tint8.int8_gemm_reference(a, b))
    with pytest.raises(ValueError, match="multiple of 16"):
        tint8.int8_gemm(a[:40], b)


@pytest.mark.cuda
def test_int8_gemm_sass_is_wgmma_and_wrappers_raise_on_bad_card_inputs():
    """The GEMM's SASS shows IGMMA and no IMMA; on a CUDA tensor a wrapper
    never takes its plain version: inputs the kernel cannot take raise."""
    from spotter_tpu_torch.tools import bench_int8

    dev = _card()
    assert bench_int8.sass_evidence(dev)["verdict"] == bench_int8.SASS_WGMMA_VERDICT
    a = torch.zeros((4, 24), dtype=torch.int8, device=dev)  # K not a multiple of 16
    with pytest.raises(ValueError, match="multiple of 16"):
        tint8.int8_gemm_kmajor(a, a)
    x = torch.zeros((2, 8, 5, 5), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tint8.nhwc_codes(x, torch.ones((2, 1), device=dev), 16)
    with pytest.raises(ValueError, match="c_pad"):
        tint8.nhwc_codes(x.float(), torch.ones((2, 1), device=dev), 8)


# the NHWC entry's coverage list (tools/bench_int8_conv.py COVERAGE), then
# csp80 and bb_s1, the RT-DETRv2-R101 shapes at B = 8
NHWC_CASES = list(COVERAGE) + [((8, 384, 80, 80), 3, 1, 1, 0),
                               ((8, 64, 160, 160), 3, 1, 1, 0)]


def nhwc_path(shape, dtype, channels_last: bool) -> str:
    """The kernel csrc/quant.cu picks for the NHWC codes: the rows kernel
    for a channels-last input, with 16-byte loads where its pixel rows are
    16-byte aligned; the transpose kernel with 16-byte loads where each
    channel's plane and each sample are whole 16-byte runs, else a value
    at a time."""
    size = torch.finfo(dtype).bits // 8
    b, c, h, w = shape
    if channels_last:
        return "rows" if c * size % 16 == 0 else "rows_scalar"
    aligned = all(s * size % 16 == 0 for s in (h * w, c * h * w))
    return "transpose" if aligned else "transpose_scalar"


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,stride,pad,extra", NHWC_CASES)
def test_amax_and_nhwc_passes_are_exact_on_the_card(shape, k, stride, pad, extra, dtype,
                                                    channels_last):
    """The amax pass's partials reduce to each sample's max |x| and the
    NHWC pass's codes and scales equal the plain version's; one launch
    each, the amax on its fast path (a dense sample in either layout), the
    NHWC codes on the kernel `nhwc_path` names."""
    dev = _card()
    rng = np.random.default_rng(sum(shape) + k)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)
    x[0, :, : shape[2] // 2] = 0.0  # zeros beside the values, as a ReLU's output has
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    c_pad = tint8.pad16(shape[1]) + extra
    counters = (tint8.amax_s8, tint8.quantize_nhwc_s8)
    before = [(c.launches, c.paths.copy()) for c in counters]
    partials = tint8.amax_samples(x)
    codes, scales = tint8.nhwc_codes(x, partials, c_pad)
    path = nhwc_path(shape, dtype, channels_last)
    assert [(c.launches - n, dict(c.paths - p)) for c, (n, p) in zip(counters, before)] == [
        (1, {"fast": 1}), (1, {path: 1})]
    assert partials.shape[0] == shape[0] and partials.dtype == torch.float32
    assert torch.equal(partials.amax(1), tint8.amax_samples_reference(x).amax(1))
    want_codes, want_scales = tint8.nhwc_codes_reference(x, tint8.amax_samples_reference(x),
                                                         c_pad)
    assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nhwc_pass_takes_any_strides_on_the_card(dtype):
    """A view whose pixels are at no one stride (a crop of W, a transpose of
    H and W) takes the rows kernel through its strides; one with H = 1 the
    transpose kernel (its planes still 16-byte runs); all exact."""
    dev = _card()
    x = torch.randn((3, 40, 9, 24), device=dev).to(dtype)
    for view, path in ((x[..., 3:20], "rows_scalar"), (x[:, :, :1], "transpose"),
                       (x.permute(0, 1, 3, 2), "rows_scalar")):
        before = tint8.quantize_nhwc_s8.paths.copy()
        codes, scales = tint8.nhwc_codes(view, tint8.amax_samples(view), 48)
        assert dict(tint8.quantize_nhwc_s8.paths - before) == {path: 1}
        want = tint8.nhwc_codes_reference(view, tint8.amax_samples_reference(view), 48)
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])


@pytest.mark.cuda
def test_nhwc_codes_take_every_bf16_value_exactly():
    """Every finite bf16 value at several scales, and fp32 values on and
    around the k + 0.5 steps of the scale: the kernel's IEEE division,
    rint and clip give the plain version's code for each."""
    dev = _card()
    bits = torch.arange(0, 2**16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    finite = bits[torch.isfinite(bits.float())]
    pad = (-finite.numel()) % 64
    plane = torch.cat([finite, finite[:pad]]).view(1, 64, 1, -1)
    for amax in (1e-30, 1e-3, 1.0, 3.0e4, 3.3e38):
        x = torch.cat([plane, plane.flip(-1)]).to(dev)
        partials = torch.full((2, 1), amax, device=dev)
        codes, scales = tint8.nhwc_codes(x, partials, 64)
        want = tint8.nhwc_codes_reference(x, partials, 64)
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1]), amax
    scale = tint8.scale_of(torch.tensor([31.75]))  # 0.25: x / scale lands on halves
    steps = (torch.arange(-127, 128, dtype=torch.float32) + 0.5) * scale
    near = torch.cat([steps, torch.nextafter(steps, steps + 1), torch.nextafter(steps, steps - 1)])
    x = near.repeat(16).view(1, 16, 1, -1).to(dev)
    partials = torch.full((1, 1), 31.75, device=dev)
    codes, _ = tint8.nhwc_codes(x, partials, 16)
    assert torch.equal(codes, tint8.nhwc_codes_reference(x, partials, 16)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,rows", [((34408, 768), 4301), ((3072, 768), 1), ((37, 40), 1)])
def test_amax_pass_on_rows_is_exact_and_fast(dtype, shape, rows):
    """The rows view (a sample's rows, or a weight's row, a group): the
    contiguous fast path, the general one where a group's rows have gaps;
    the partials reduce to each group's max |x|."""
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(shape).astype(np.float32))
    x = x.to(dev).to(dtype)
    sizes, strides, groups = tint8.rows_view(x, rows)
    general = tint8.amax_s8.paths["general"]
    partials = tint8.amax_view(x, sizes, strides, 0, groups)
    assert tint8.amax_s8.paths["general"] == general
    assert torch.equal(partials.amax(1), x.float().abs().view(groups, -1).amax(1))
    # an odd offset: the run's unaligned ends go through block 0
    y = x.reshape(-1)[1:1 + groups * ((x.numel() - 1) // groups)].view(groups, -1)
    sizes, strides, _ = tint8.rows_view(y, 1)
    assert torch.equal(tint8.amax_view(y, sizes, strides, 0, groups).amax(1),
                       y.float().abs().amax(1))
    assert tint8.amax_s8.paths["general"] == general
    # a row pitch past K: a group of several rows is not one run (general)
    if rows > 1 and shape[1] > 8:
        z = x[:, : shape[1] - 8]
        sizes, strides, _ = tint8.rows_view(z, rows)
        assert torch.equal(tint8.amax_view(z, sizes, strides, 0, groups).amax(1),
                           z.float().abs().reshape(groups, -1).amax(1))
        assert tint8.amax_s8.paths["general"] == general + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hd", [(8, 300, 8, 32), (2, 17, 3, 64)])
def test_amax_pass_on_heads_takes_the_general_path(b, t, h, hd):
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(t).standard_normal((b, t, h, hd))
                         .astype(np.float32)).to(dev)
    general = tint8.amax_s8.paths["general"]
    partials = tint8.amax_view(x, tuple(x.shape), x.stride(), 2, b * h)
    assert tint8.amax_s8.paths["general"] == general + 1
    assert torch.equal(partials.amax(1), x.abs().amax(dim=(1, 3)).reshape(-1))


def _device_kernels(fn) -> list:
    """The names of the device events of one call of `fn` (after a warm
    call), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_nhwc_quantize_is_two_kernels_and_no_memset():
    """A torch.profiler trace of the amax and NHWC passes at csp80: the amax
    kernel and the transpose kernel, nothing else on the device (no
    memset)."""
    dev = _card()
    x = torch.randn((8, 384, 80, 80), device=dev, dtype=torch.bfloat16)
    names = _device_kernels(lambda: tint8.nhwc_codes(x, tint8.amax_samples(x), 384))
    assert not any("memset" in n.lower() for n in names), names
    assert len(names) == 2 and "amax_contiguous_kernel" in names[0], names
    assert "quantize_transpose_kernel" in names[1], names


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def test_fitting_heads_call_is_one_kernel_and_no_memset(transpose):
    """One quantize_heads at RT-DETR's decoder V (8, 300, 8, 32) fp32: one
    launch of the one-launch heads kernel, nothing else on the device."""
    dev = _card()
    v = torch.randn((8, 300, 8, 32), device=dev)
    assert tint8.heads_one_launch(300, 32, torch.float32)
    before = (tint8.amax_s8.launches, tint8.quantize_s8.launches)
    names = _device_kernels(lambda: tint8.quantize_heads(v, transpose))
    assert (tint8.amax_s8.launches, tint8.quantize_s8.launches) == (before[0], before[1] + 2)
    assert len(names) == 1 and "quantize_heads_group_kernel" in names[0], names


# (B, T, H, hd): RT-DETR's decoder, B = 1 with T ragged, hd 64, and fp32
# groups at the one-launch limit (768 x 32 x 4 bytes) and just above it
HEADS_CASES = [(8, 300, 8, 32), (1, 17, 3, 64), (8, 45, 4, 64), (2, 768, 2, 32),
               (2, 769, 2, 32), (1, 1537, 2, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("view", HEADS_VIEWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HEADS_CASES)
def test_heads_entries_are_exact_on_the_card(shape, dtype, view):
    """Both layouts, codes and scales equal to the plain version's, in one
    launch or two as `heads_one_launch` says, on contiguous, packed and
    unaligned views."""
    dev = _card()
    b, t, h, hd = shape
    x = heads_view(shape, dtype, view, np.random.default_rng(t + hd), dev)
    x[0, : t // 3] = 0.0
    one = tint8.heads_one_launch(t, hd, dtype)
    for transpose in (False, True):
        before = (tint8.amax_s8.launches, tint8.quantize_s8.launches)
        codes, scales = tint8.quantize_heads(x, transpose)
        assert (tint8.amax_s8.launches - before[0], tint8.quantize_s8.launches - before[1]) == (
            0 if one else 1, 1)
        want = tint8.quantize_heads_reference(x, transpose)
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_entry_takes_views_on_the_card(dtype):
    """The rows entry on a row pitch past K (16-byte loads), rows at an odd
    offset and a transposed view (a value at a time, through the strides),
    a ragged K: each exact."""
    dev = _card()
    x = torch.randn((96, 88), device=dev).to(dtype)
    for view, rows, path in ((x[:, :72], 12, "rows"), (x[:, 1:41], 8, "rows_scalar"),
                             (x.t(), 11, "rows_scalar"), (x[:, :37], 1, "rows")):
        before = tint8.quantize_s8.paths.copy()
        codes, scales = tint8.quantize_rows(view, rows, tint8.pad16(view.shape[1]))
        assert dict(tint8.quantize_s8.paths - before) == {path: 1}, path
        want = tint8.quantize_rows_reference(view, rows, tint8.pad16(view.shape[1]))
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_graph_replay_is_bit_equal_to_eager(dtype):
    """utils/quant.py's `int8_conv` captured in a CUDA graph: each replay on
    new inputs copied into the captured one equals the eager call bit for
    bit; two graphs of the same call replayed back to back on two streams
    keep their own buffers."""
    dev = _card()
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((96, 64, 3, 3)).astype(np.float32)).to(dev)
    qw = tint8.quantize_conv_weight(w)
    xs = [torch.from_numpy(rng.standard_normal((8, 64, 40, 40)).astype(np.float32))
          .to(dev).to(dtype) for _ in range(3)]
    static = [xs[0].clone(), xs[0].clone()]
    graphs, outs = [], []
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(2):
            tquant.int8_conv(static[i], qw, 3, 1, 1, dtype)  # warm the allocator
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                outs.append(tquant.int8_conv(static[i], qw, 3, 1, 1, dtype))
            graphs.append(graph)
    torch.cuda.current_stream().wait_stream(stream)
    side = torch.cuda.Stream()
    for x in xs[1:]:
        static[0].copy_(x)
        static[1].copy_(xs[0] if x is xs[1] else xs[1])
        torch.cuda.synchronize()
        graphs[0].replay()
        with torch.cuda.stream(side):
            graphs[1].replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[0], tquant.int8_conv(x, qw, 3, 1, 1, dtype))
        assert torch.equal(outs[1], tquant.int8_conv(static[1], qw, 3, 1, 1, dtype))


# --- conv_s8 ------------------------------------------------------------------------


def _conv_operands(dev, b, cin, h, w, cout, k, dtype, seed):
    """NCHW x at `dtype` through the served route's passes (amax, the NHWC
    quantize), and the tap-major weight: (nhwc codes, sa, weight, x, the
    fp32 OIHW weight)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(np.float32)).to(dev)
    wt = torch.from_numpy((rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k))
                          .astype(np.float32)).to(dev)
    qc = tint8.quantize_conv_weight(wt)
    x = x.to(dtype)
    codes, sa = tint8.nhwc_codes(x, tint8.amax_samples(x), qc.c_pad)
    return codes, sa, qc, x, wt


def _conv_exact(nhwc, sa, qc, stride, pad, dtype, tile_n=None) -> bool:
    k = qc.kernel_size
    got = tint8.conv_s8(nhwc, qc.codes, sa, qc.scale, k, stride, pad, dtype, tile_n=tile_n)
    want = tint8.conv_s8_reference(nhwc, qc.codes, sa, qc.scale, k, stride, pad, dtype)
    return got.dtype == dtype and got.is_contiguous() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_conv_s8_is_bit_equal_at_the_probe_shapes(shape, dtype):
    """The JAX probe's seven shapes at B = 8, through each tile width: bit
    equal to the plain version on the same card codes; the route whole bit
    equal to utils/quant.py's plain convolution of the fp32 weight."""
    dev = _card()
    _, b, h, w, cin, cout, k, stride = shape
    pad = (k - 1) // 2
    nhwc, sa, qc, x, wt = _conv_operands(dev, b, cin, h, w, cout, k, dtype, sum(shape[1:]))
    for tile_n in (None, *tint8.CONV_TILE_NS):
        assert _conv_exact(nhwc, sa, qc, stride, pad, dtype, tile_n), tile_n
    assert torch.equal(tquant.int8_conv(x, qc, k, stride, pad, dtype),
                       tquant.int8_conv_reference(x, wt, stride, pad, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SERVED_CONVS, ids=[str(s) for s in SERVED_CONVS])
def test_conv_s8_is_bit_equal_at_every_served_conv(shape, dtype):
    """Every quantized convolution the seven families run (C, N, k, stride,
    padding) on SERVED_HW inputs: 21 x 17 pixels a sample, so tiles
    straddle samples and Ho*Wo is no multiple of the 16-byte run."""
    dev = _card()
    cin, cout, k, stride, pad = shape
    b, h, w = SERVED_HW
    nhwc, sa, qc, _, _ = _conv_operands(dev, b, cin, h, w, cout, k, dtype, sum(shape))
    assert _conv_exact(nhwc, sa, qc, stride, pad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,h,w,cout,k,stride,pad", [
    (2, 64, 16, 12, 64, 3, 1, 1),   # C_pad 64: two taps in one 128-byte K step
    (3, 48, 9, 7, 40, 3, 2, 1),     # C_pad 48, ragged N, tiles across three samples
    (2, 16, 33, 31, 24, 3, 1, 0),   # C_pad 16: eight taps a K step, no padding
    (5, 80, 8, 8, 200, 1, 1, 0),    # 64 pixels a sample: a tile holds two samples
    (1, 32, 40, 24, 72, 3, 2, 1),   # one sample, K = 288 not a multiple of 128
])
def test_conv_s8_edges_are_bit_equal(b, cin, h, w, cout, k, stride, pad, dtype):
    """Each tile width. (The persistent grid's walk of many tiles through
    one ring is held at the served shapes, hundreds of tiles a call.)"""
    dev = _card()
    nhwc, sa, qc, _, _ = _conv_operands(dev, b, cin, h, w, cout, k, dtype, b * cin + h)
    for tile_n in tint8.CONV_TILE_NS:
        assert _conv_exact(nhwc, sa, qc, stride, pad, dtype, tile_n), tile_n


@pytest.mark.cuda
def test_conv_s8_sass_is_wgmma_and_int8_conv_is_three_kernels():
    """conv_s8's SASS shows IGMMA in every instantiation and no IMMA; one
    utils/quant.int8_conv at csp80 counts the amax, the NHWC quantize and
    conv_s8 once each, and two of them show only those kernels in a
    torch.profiler trace (no memset; the trace may miss its first kernel);
    a CUDA tensor the kernel cannot take raises."""
    from torch.profiler import ProfilerActivity, profile

    from spotter_tpu_torch.tools import bench_int8

    dev = _card()
    sass = bench_int8.sass_evidence(dev, "conv_s8")
    assert sass["verdict"] == bench_int8.SASS_WGMMA_VERDICT and sass["functions"] == 6, sass
    x = torch.randn((8, 384, 80, 80), device=dev, dtype=torch.bfloat16)
    qc = tint8.quantize_conv_weight(torch.randn((384, 384, 3, 3), device=dev))
    tquant.int8_conv(x, qc, 3, 1, 1, torch.bfloat16)
    torch.cuda.synchronize()
    before = (tint8.amax_s8.launches, tint8.quantize_nhwc_s8.launches, tint8.conv_s8.launches,
              tint8.int8_gemm_kmajor.launches, tint8.dequant_s32.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tquant.int8_conv(x, qc, 3, 1, 1, torch.bfloat16)
        torch.cuda.synchronize()
    after = (tint8.amax_s8.launches, tint8.quantize_nhwc_s8.launches, tint8.conv_s8.launches,
             tint8.int8_gemm_kmajor.launches, tint8.dequant_s32.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 0, 0]
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = ("amax_contiguous_kernel", "quantize_transpose_kernel", "conv_s8_kernel")
    assert all(any(kind in n for kind in kinds) for n in names), names
    assert 5 <= len(names) <= 6 and "conv_s8_kernel" in names[-1], names
    nhwc = torch.zeros((2, 5, 5, 32), dtype=torch.int8, device=dev)
    w = torch.zeros((8, 9 * 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="tile widths"):
        tint8.conv_s8(nhwc, w, torch.ones(2, device=dev), torch.ones(8, device=dev), 3, 1, 1,
                      torch.float32, tile_n=96)
    with pytest.raises(ValueError, match="contiguous"):
        tint8.conv_s8(nhwc.transpose(1, 2), w, torch.ones(2, device=dev),
                      torch.ones(8, device=dev), 3, 1, 1, torch.float32)
