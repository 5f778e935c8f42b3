"""The int8 quantize passes in the port (ops/int8.py: the amax pass's
partial maxima, the NHWC quantize pass of the convolution, the heads
entries' one-launch rule) against the JAX package's int8 quantization
(spotter_tpu/utils/quant.py: `quantize_activation`, then XLA's s8
`conv_general_dilated` with int32 sums, then the scales), on the CPU at the
NHWC entry's coverage list: ragged H*W, C not a multiple of 16 or wider
than a 64-channel tile, c_pad past C, NCHW and channels-last inputs, fp32
and bf16, with the served route (`int8_conv`: amax, NHWC codes, conv_s8)
at kernel sizes 1, 3 and 7, strides 1 and 2. Here the wrappers take their
plain versions; the kernels are held to the same plain versions on the
card (tests/test_torch_int8_cuda.py).

Tolerances: none. Codes and scales are equal and the dequantized outputs
bit equal (the same fp32 product of the same int32 and scales, rounded once
to the output dtype).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    want = _np(jquant.int8_conv(xj, jnp.asarray(w), (stride, stride), padding, jd))

    xt = torch.from_numpy(x).to(td)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # OIHW
    c = shape[1]
    c_pad = tint8.pad16(c) + extra
    codes, scales = tint8.nhwc_codes(xt, tint8.amax_samples(xt), c_pad)
    # the codes: JAX's own NHWC quantized activation, zero past C; the
    # per-sample scales
    assert codes.shape == (*xq.shape[:3], c_pad) and codes.dtype == torch.int8
    assert codes.is_contiguous()
    np.testing.assert_array_equal(codes[..., :c].numpy(), np.asarray(xq))
    assert (codes[..., c:] == 0).all()
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sx).reshape(-1))
    # and the models' entry (the amax, the NHWC quantize and conv_s8), NCHW,
    # bit equal
    out = tquant.int8_conv(xt, tint8.quantize_conv_weight(wt), k, stride, pad, td)
    assert out.dtype == td and out.is_contiguous()
    np.testing.assert_array_equal(_np(out), want.transpose(0, 3, 1, 2))


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
    parts is each sample's max |x| (JAX's amax, exact), and the NHWC pass
    takes them to the same codes and scales as the plain amax."""
    jd, td = DTYPES[dtype]
    x = _input(np.random.default_rng(parts), (3, 20, 19, 24))
    xt = torch.from_numpy(x).to(td)
    got = torch.from_numpy(_partials(xt.float().numpy(), parts))
    jamax = jnp.max(jnp.abs(jnp.asarray(x).astype(jd).astype(jnp.float32)), axis=(1, 2, 3))
    np.testing.assert_array_equal(got.amax(1).numpy(), np.asarray(jamax))
    np.testing.assert_array_equal(tint8.amax_samples(xt).amax(1).numpy(), np.asarray(jamax))
    codes, scales = tint8.nhwc_codes(xt, got, 48)
    want_codes, want_scales = tint8.nhwc_codes(xt, tint8.amax_samples(xt), 48)
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
    assert tint8.QUANT_PATHS == ("rows", "rows_scalar", "transpose", "transpose_scalar", "group")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("parts", [1, 5])
def test_nhwc_plain_version_equals_jax_quantize_activation(dtype, channels_last, parts):
    """`nhwc_codes_reference` from any (B, parts) partials whose max is each
    sample's amax: JAX's NHWC codes and scales, bit equal, with an all-zero
    sample (the 1e-12 floor) and values on k + 0.5 steps; zero past C."""
    jd, td = DTYPES[dtype]
    x = _input(np.random.default_rng(parts + 7), (3, 20, 9, 11))
    xq, sx = jquant.quantize_activation(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jd))
    xt = torch.from_numpy(x).to(td)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    partials = torch.from_numpy(_partials(xt.float().numpy(), parts))
    codes, scales = tint8.nhwc_codes_reference(xt, partials, 48)
    assert codes.shape == (3, 9, 11, 48) and codes.is_contiguous()
    np.testing.assert_array_equal(codes[..., :20].numpy(), np.asarray(xq))
    assert (codes[..., 20:] == 0).all()
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sx).reshape(-1))
    assert scales[-1] == np.float32(1e-12) / np.float32(127)  # the all-zero sample


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 17, 3, 64), (2, 45, 4, 32)])
def test_heads_plain_version_equals_jax_quantize_per_head(shape, dtype, transpose):
    """The heads and heads_t layouts' plain version (what the one-launch
    kernel and the two-launch passes are held to on the card): JAX's
    per-(sample, head) codes, head-major, and its scales, bit equal."""
    jd, td = DTYPES[dtype]
    x = _input(np.random.default_rng(sum(shape)), shape)
    jq, js = jquant.quantize_per_head(jnp.asarray(x).astype(jd), 2)
    codes, scales = tint8.quantize_heads(torch.from_numpy(x).to(td), transpose)
    b, t, h, hd = shape
    want = np.asarray(jq).transpose(0, 2, 3, 1) if transpose else np.asarray(jq).transpose(
        0, 2, 1, 3)
    want = want.reshape(b * h, *want.shape[2:])
    n = want.shape[-1]
    np.testing.assert_array_equal(codes[..., :n].numpy(), want)
    assert codes.shape[-1] == tint8.pad16(n) and (codes[..., n:] == 0).all()
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js).reshape(-1))


@pytest.mark.parametrize("t,hd,dtype,want", [
    (300, 32, torch.float32, True),  # RT-DETR's decoder: 38,400 bytes
    (400, 32, torch.float32, True),  # its AIFI encoder layer
    (768, 32, torch.float32, True),  # 98,304 bytes: the limit itself
    (769, 32, torch.float32, False),  # just above it
    (1536, 32, torch.bfloat16, True),
    (1537, 32, torch.bfloat16, False),
    (4301, 64, torch.bfloat16, False),  # YOLOS-base's sequence: two launches
    (3, 5, torch.float32, True),  # 60 bytes, held as 64
])
def test_heads_one_launch_rule(t, hd, dtype, want):
    """A heads call is one launch where its (sample, head) group, rounded
    up to 16 bytes, fits HEADS_GROUP_MAX_BYTES, the kernel's own limit."""
    assert tint8.heads_one_launch(t, hd, dtype) is want
    source = (Path(tint8.__file__).parents[1] / "csrc" / "quant.cu").read_text()
    assert f"kHeadsGroupMaxBytes = {tint8.HEADS_GROUP_MAX_BYTES // 1024} * 1024;" in source
