"""The int8 path's kernels on the card (ops/int8.py: the amax and quantize
passes of csrc/quant.cu, the K-major entry of csrc/int8_gemm.cu, the dequant passes),
each against its plain version on the same inputs: amax, codes and scales exact,
int32 products exact, dequantized outputs bit equal (the same fp32 product
of the same int32 and scales, rounded once to the output dtype); and
utils/quant.py's four products through them against their runs on the
CPU. This file imports torch and the port only, so it runs on a machine
with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_int8_cuda.py
"""

import numpy as np
import pytest
import torch

from spotter_tpu_torch.ops import int8 as tint8
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
def test_im2col_conv_path_is_exact_on_the_card(dtype, shape, k, stride, pad):
    """Amax and codes exact, int32 products exact, dequant (NCHW) bit equal,
    each kernel against its plain version on the same card inputs; one amax
    and one quantize launch a call."""
    dev = _card()
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((24, shape[1], k, k)).astype(np.float32))
    qw_cpu = tint8.quantize_weight_rows(w)
    qw = tint8.quantize_weight_rows(w.to(dev))
    assert torch.equal(qw.codes.cpu(), qw_cpu.codes) and torch.equal(qw.scale.cpu(), qw_cpu.scale)
    assert torch.equal(tint8.amax_samples(x.to(dev)).cpu(), tint8.amax_samples(x))
    before = (tint8.amax_s8.launches, tint8.quantize_s8.launches)
    codes, sx = tint8.quantize_im2col(x.to(dev), k, stride, pad, qw.k_pad)
    assert (tint8.amax_s8.launches, tint8.quantize_s8.launches) == (before[0] + 1, before[1] + 1)
    want_codes, want_sx = tint8.quantize_im2col(x, k, stride, pad, qw.k_pad)
    assert torch.equal(codes.cpu(), want_codes) and torch.equal(sx.cpu(), want_sx)
    y = tint8.int8_gemm_kmajor(codes, qw.codes)
    assert torch.equal(y.cpu(), tint8.int8_gemm_kmajor(want_codes, qw_cpu.codes))
    b, _, h, wd = shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    out = tint8.dequant_nchw(y, sx, qw.scale, b, ho, wo, dtype)
    assert torch.equal(out.cpu(), tint8.dequant_nchw(y.cpu(), want_sx, qw_cpu.scale, b, ho, wo,
                                                     dtype))
    # a channels-last input reads through its strides
    cl = x.to(dev).contiguous(memory_format=torch.channels_last)
    assert torch.equal(tint8.quantize_im2col(cl, k, stride, pad, qw.k_pad)[0], codes)


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
        tint8.quantize_im2col(x, 3, 1, 1, 80)
