"""The int8 convolution of the port (ops/int8.py `conv_s8`, its plain version
and the tap-major weight codes) against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through
spotter_tpu/utils/quant.py (`quantize_weight`, `quantize_activation`,
`_int8_conv_core`) and through the port: the tap-major weight codes equal
JAX's HWIO codes permuted, `conv_s8_reference` on JAX's own codes equals
`_int8_conv_core` bit for bit (tolerance 0: the int32 sums are exact and
the dequant is the same fp32 product), and `utils/quant.int8_conv`, which
takes the NHWC quantize pass and `conv_s8`, equals the JAX function. The
card runs the kernel against the same plain version
(tests/test_torch_int8_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from spotter_tpu.utils import quant as jquant
from spotter_tpu_torch.ops import int8 as tint8
from spotter_tpu_torch.utils import quant as tquant

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (C, k, stride, padding): kernels 1 and 3, strides 1 and 2, paddings 0 and
# 1, C from 16 to 72 (40 and 72 not multiples of 16: C_pad 48 and 80; 64
# puts two taps in one 128-byte K step)
CASES = [(16, 1, 1, 0), (72, 1, 2, 0), (40, 3, 1, 1), (64, 3, 2, 1), (24, 3, 1, 0),
         (32, 1, 1, 1)]
B, H, W, N = 3, 11, 9, 20  # Ho*Wo is no multiple of a tile (128 pixels, 16-byte runs)


def _inputs(seed: int, c: int, k: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, c)).astype(np.float32)  # NHWC, as the JAX side takes it
    x[0, 0, 0, 0] = 127 / 4  # amax 31.75: x / scale lands on halves below
    x[0, 0, 0, 1:4] = [0.125, -0.375, 2.625]
    w = (rng.standard_normal((k, k, c, N)) / np.sqrt(k * k * c)).astype(np.float32)  # HWIO
    w[..., 1] = 0.0  # an all-zero output channel
    return x, w


def _oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _tap_major(wq: np.ndarray) -> torch.Tensor:
    """JAX's HWIO codes as the port's tap-major rows: (N, k*k*C_pad), the
    channel fastest, zero past C."""
    k, _, c, n = wq.shape
    t = torch.from_numpy(np.array(wq).transpose(3, 0, 1, 2).copy())
    return F.pad(t, (0, tint8.pad16(c) - c)).reshape(n, -1)


@pytest.mark.parametrize("c,k", [(16, 1), (40, 3), (72, 3), (64, 1)])
def test_tap_major_weight_codes_are_jax_codes_permuted(c, k):
    _, w = _inputs(c + k, c, k)
    wq, sw = jquant.quantize_weight(jnp.asarray(w))
    qc = tint8.quantize_conv_weight(_oihw(w))
    assert qc.kernel_size == k and qc.c_pad == tint8.pad16(c)
    assert qc.codes.dtype == torch.int8 and qc.codes.shape == (N, k * k * qc.c_pad)
    np.testing.assert_array_equal(qc.codes.numpy(), _tap_major(np.asarray(wq)).numpy())
    np.testing.assert_array_equal(qc.scale.numpy(), np.asarray(sw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,k,stride,pad", CASES)
def test_conv_s8_reference_on_jax_codes_is_bit_equal_to_jax(c, k, stride, pad, dtype):
    jd, td = DTYPES[dtype]
    x, w = _inputs(10 * c + k + stride, c, k)
    xj = jnp.asarray(x).astype(jd)
    padding = ((pad, pad), (pad, pad))
    want = np.asarray(jquant._int8_conv_core(xj, jnp.asarray(w), (stride, stride), padding)
                      .astype(jd).astype(jnp.float32)).transpose(0, 3, 1, 2)
    xq, sx = jquant.quantize_activation(xj)
    wq, sw = jquant.quantize_weight(jnp.asarray(w))
    nhwc = F.pad(torch.from_numpy(np.array(xq)), (0, tint8.pad16(c) - c))
    got = tint8.conv_s8_reference(nhwc, _tap_major(np.asarray(wq)),
                                  torch.from_numpy(np.asarray(sx).reshape(-1)),
                                  torch.from_numpy(np.asarray(sw)), k, stride, pad, td)
    assert got.dtype == td and got.is_contiguous() and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper takes the plain version on a CPU tensor, and counts no launch
    launches = tint8.conv_s8.launches
    again = tint8.conv_s8(nhwc, _tap_major(np.asarray(wq)),
                          torch.from_numpy(np.asarray(sx).reshape(-1)),
                          torch.from_numpy(np.asarray(sw)), k, stride, pad, td)
    assert torch.equal(again, got) and tint8.conv_s8.launches == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,k,stride,pad", CASES[:4])
def test_int8_conv_route_is_bit_equal_to_jax(c, k, stride, pad, dtype):
    """utils/quant.int8_conv on NCHW input and the tap-major weight: the
    amax, the NHWC quantize pass and conv_s8, each on its plain version."""
    jd, td = DTYPES[dtype]
    x, w = _inputs(7 * c + k, c, k)
    want = np.asarray(jquant.int8_conv(jnp.asarray(x).astype(jd), jnp.asarray(w),
                                       (stride, stride), ((pad, pad), (pad, pad)), jd)
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(td)
    qc = tint8.quantize_conv_weight(_oihw(w))
    got = tquant.int8_conv(xt, qc, k, stride, pad, td)
    assert got.dtype == td and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want.transpose(0, 3, 1, 2))
    with pytest.raises(ValueError, match="weight for a"):
        tquant.int8_conv(xt, qc, k + 2, stride, pad, td)


def test_conv_tile_width_follows_waste_then_fill():
    sms = 132
    assert tint8.conv_tile_n(384, 51200, sms) == 192  # csp80: two tiles of 192
    assert tint8.conv_tile_n(384, 3200, sms) == 128  # csp20: 75 blocks of 128 beat 50 of 192
    assert tint8.conv_tile_n(64, 204800, sms) == 64  # bb_s1
    assert tint8.conv_tile_n(256, 12800, sms) == 128  # no waste at 128 or 64: the wider
    assert tint8.conv_tile_n(1024, 12800, sms) == 128
    assert tint8.conv_tile_n(40, 100, sms) == 64
    assert all(tint8.conv_tile_n(n, m, sms) in tint8.CONV_TILE_NS
               for n in (8, 64, 96, 200, 384, 2048) for m in (1, 1000, 10**6))


def test_conv_s8_checks_its_operands():
    x = torch.zeros((2, 5, 5, 32), dtype=torch.int8)
    w = torch.zeros((8, 9 * 32), dtype=torch.int8)
    sa, sw = torch.ones(2), torch.ones(8)
    assert tint8.conv_s8(x, w, sa, sw, 3, 1, 1, torch.float32).shape == (2, 8, 5, 5)
    with pytest.raises(ValueError, match="multiple of 16"):
        tint8.conv_s8(x[..., :24], w, sa, sw, 3, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="is not 1x1"):
        tint8.conv_s8(x, w, sa, sw, 1, 1, 0, torch.float32)
    with pytest.raises(TypeError, match="int8"):
        tint8.conv_s8(x.float(), w, sa, sw, 3, 1, 1, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tint8.conv_s8(x, w, sa, sw, 3, 1, 1, torch.float16)
    with pytest.raises(ValueError, match="no output"):
        tint8.conv_s8(x, w, sa, sw, 3, 1, -1, torch.float32)
