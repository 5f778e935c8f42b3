"""The int8 convolution's passes in the port (ops/int8.py: the amax pass's
partial maxima, the im2col quantize pass, the K-major GEMM, the NCHW
dequant) against the JAX package's int8 convolution
(spotter_tpu/utils/quant.py: `quantize_activation`, then XLA's s8
`conv_general_dilated` with int32 sums, then the scales), on the CPU at the
im2col entry's coverage list: ragged tiles, C not a multiple of 16, k_pad
past K, kernel sizes 1, 3 and 7 at strides 1 and 2, NCHW and channels-last
inputs, fp32 and bf16. Here the wrappers take their plain versions; the
kernels are held to the same plain versions on the card
(tests/test_torch_int8_cuda.py).

Tolerances: none. Codes and scales are equal, the int32 products exact and
the dequantized outputs bit equal (the same fp32 product of the same int32
and scales, rounded once to the output dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spotter_tpu.utils import quant as jquant
from spotter_tpu_torch.ops import int8 as tint8
from spotter_tpu_torch.tools.bench_int8_conv import COVERAGE
from spotter_tpu_torch.utils import quant as tquant

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
COUT = 12


def _input(rng, shape):
    """Normal values with a band of zeros (a ReLU's output has them), the
    last sample all zero when there are two or more (the scale's 1e-12
    floor), and values on k + 0.5 steps of the first sample's scale (round
    half to even decides them)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[:, :, : shape[2] // 3] = 0.0
    if shape[0] > 1:
        x[-1] = 0.0
    flat = x[0].reshape(-1)
    flat[:] = np.round(flat * 4) / 4
    flat[0] = 127 / 4  # amax 31.75, so scale 0.25 and x / scale lands on halves
    flat[1:6] = np.array([0.125, 0.375, -0.625, 2.625, -3.125])
    return x


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,stride,pad,extra", COVERAGE)
def test_conv_passes_equal_jax_int8_conv(shape, k, stride, pad, extra, dtype, channels_last):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape) + 10 * k + stride)
    x = _input(rng, shape)
    w = (rng.standard_normal((k, k, shape[1], COUT)) / np.sqrt(k * k * shape[1])).astype(
        np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jd)
    padding = [(pad, pad), (pad, pad)]
    xq, sx = jquant.quantize_activation(xj)
    wq, _ = jquant.quantize_weight(jnp.asarray(w))
    y = jax.lax.conv_general_dilated(xq, wq, (stride, stride), padding,
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     preferred_element_type=jnp.int32)
    want = _np(jquant.int8_conv(xj, jnp.asarray(w), (stride, stride), padding, jd))

    xt = torch.from_numpy(x).to(td)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # OIHW
    kdim = shape[1] * k * k
    k_pad = tint8.pad16(kdim) + extra
    codes, scales = tint8.quantize_im2col(xt, k, stride, pad, k_pad)
    # the codes: JAX's quantized activation unfolded in the OIHW weight's
    # (c, ky, kx) order, zero past K; the per-sample scales
    unfolded = F.unfold(torch.from_numpy(np.array(xq).transpose(0, 3, 1, 2)).double(), k,
                        padding=pad, stride=stride).transpose(1, 2).reshape(-1, kdim)
    assert codes.shape == (unfolded.shape[0], k_pad) and codes.dtype == torch.int8
    np.testing.assert_array_equal(codes[:, :kdim].numpy(), unfolded.to(torch.int8).numpy())
    assert (codes[:, kdim:] == 0).all()
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sx).reshape(-1))
    # the int32 product, exact, on the layer's kept weight codes
    qw = tint8.quantize_weight_rows(wt)
    wcodes = F.pad(qw.codes, (0, k_pad - qw.k_pad))
    yt = tint8.int8_gemm_kmajor(codes, wcodes)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(y).reshape(-1, COUT))
    # the dequantized output, NCHW, bit equal
    ho, wo = np.asarray(y).shape[1:3]
    out = tint8.dequant_nchw(yt, scales, qw.scale, shape[0], ho, wo, td)
    assert out.dtype == td and out.is_contiguous()
    np.testing.assert_array_equal(_np(out), want.transpose(0, 3, 1, 2))
    # and the models' entry (the amax, the NHWC quantize and conv_s8), bit equal too
    np.testing.assert_array_equal(_np(tquant.int8_conv(xt, tint8.quantize_conv_weight(wt), k,
                                                       stride, pad, td)),
                                  want.transpose(0, 3, 1, 2))


def _partials(x: np.ndarray, parts: int, threads: int = 256) -> np.ndarray:
    """Each sample's max |x| as `parts` partial maxima, shared out as the
    amax kernel shares a group: block j takes values j*threads + t +
    i*parts*threads."""
    flat = np.abs(x.reshape(x.shape[0], -1).astype(np.float32))
    owner = (np.arange(flat.shape[1]) // threads) % parts
    out = np.zeros((x.shape[0], parts), np.float32)
    for j in range(parts):
        mine = flat[:, owner == j]
        if mine.size:
            out[:, j] = mine.max(axis=1)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", [1, 3, 132])
def test_amax_partials_reduce_to_jax_amax_and_keep_the_codes(dtype, parts):
    """The amax pass's contract: (B, parts) partial maxima whose max over
    parts is each sample's max |x| (JAX's amax, exact), and the im2col pass
    takes them to the same codes and scales as the plain amax."""
    jd, td = DTYPES[dtype]
    x = _input(np.random.default_rng(parts), (3, 20, 19, 24))
    xt = torch.from_numpy(x).to(td)
    got = torch.from_numpy(_partials(xt.float().numpy(), parts))
    jamax = jnp.max(jnp.abs(jnp.asarray(x).astype(jd).astype(jnp.float32)), axis=(1, 2, 3))
    np.testing.assert_array_equal(got.amax(1).numpy(), np.asarray(jamax))
    np.testing.assert_array_equal(tint8.amax_samples(xt).amax(1).numpy(), np.asarray(jamax))
    codes, scales = tint8.im2col_codes(xt, got, 3, 1, 1, 192)
    want_codes, want_scales = tint8.quantize_im2col(xt, 3, 1, 1, 192)
    assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales)


@pytest.mark.parametrize("size,groups,want", [
    (384 * 80 * 80, 8, 132),  # csp80: 8 blocks an SM of 132
    (64 * 160 * 160, 8, 132),  # bb_s1
    (768, 3072, 1),  # a weight's row: one block
    (300 * 32, 64, 3),  # an attention head: no more blocks than 4096-value shares
    (4301 * 768, 8, 132),  # YOLOS-base's fc1 activations
    (5, 1, 1),
])
def test_amax_parts_fill_the_card_and_starve_no_block(size, groups, want):
    parts = tint8.amax_parts(size, groups, 132)
    assert parts == want
    assert groups * parts <= max(groups, 132 * tint8.AMAX_BLOCKS_PER_SM)
    assert (parts - 1) * tint8.AMAX_MIN_SHARE < size  # no block without a full share


def test_rows_view_is_a_group_of_rows_a_scale():
    """The rows layout's 4-D view, which the card's amax and quantize
    passes read: (groups, rows a group, 1, K) through the matrix's strides,
    a row pitch past K included."""
    m = torch.zeros((12, 48))[:, :40]
    assert tint8.rows_view(m, 4) == ((3, 4, 1, 40), (192, 48, 0, 1), 3)
    assert tint8.rows_view(m, 1) == ((12, 1, 1, 40), (48, 48, 0, 1), 12)
    assert tint8.AMAX_PATHS == ("general", "fast")
    assert tint8.IM2COL_PATHS == ("general", "along_x", "async")


def test_im2col_kernel_sizes_are_checked_only_on_the_card():
    """The plain version takes any kernel size; the card's wrapper raises
    on one the kernel has no tile for, before it launches anything (the
    card's side: tests/test_torch_int8_cuda.py)."""
    x = torch.from_numpy(_input(np.random.default_rng(5), (2, 4, 9, 9)))
    codes, _ = tint8.quantize_im2col(x, 5, 1, 2, 112)
    want = F.unfold(tquant.quantize_activation(x)[0].double(), 5, padding=2).transpose(1, 2)
    np.testing.assert_array_equal(codes[:, :100].numpy(),
                                  want.reshape(-1, 100).to(torch.int8).numpy())
    assert tint8.IM2COL_KERNEL_SIZES == (1, 3, 7) and tint8.IM2COL_STRIDES == (1, 2)
