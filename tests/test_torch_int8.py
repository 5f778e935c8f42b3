"""int8 quantization in the port (spotter_tpu_torch/utils/quant.py and the
kernels' wrappers in ops/int8.py) against the JAX package's
spotter_tpu/utils/quant.py, on the CPU at small sizes.

Both sides run with SPOTTER_TPU_INT8_MIN_CH = 8 and _MIN_BATCH = 1 (as
tests/test_quant.py sets them), set as module attributes on both, since
both read their knobs at import; the JAX modules run eagerly.

Tolerances, all measured here:

- codes and scales: bit equal, including an all-zero sample (the 1e-12
  floor), values on k + 0.5 (round half to even), a rank-1 input and bf16
  input;
- the int32 products: equal; the dequantized fp32 outputs of the conv,
  dense, QKᵀ and attn·V: bit equal (the same fp32 product of the same int32
  and the same scales); at bf16 output, bit equal too (one rounding of the
  same fp32 value);
- ConvNorm, QuantDense, MultiHeadAttention and RepVggBlock (fused and
  unfused) with the knobs on, under fp32 and bf16: bit equal to the JAX
  modules run eagerly, except where a float op differs by an ulp upstream
  of a quantize (stated per test);
- with the knobs unset, INT8_DENSE or INT8_ATTN alone, or the batch below
  its floor: bit identical to the float path.

The kernels' own checks on the card are in tests/test_torch_int8_cuda.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from spotter_tpu.models import layers as jl
from spotter_tpu.models import rtdetr as jrtdetr
from spotter_tpu.utils import quant as jquant
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models import layers as tl
from spotter_tpu_torch.models import rtdetr as trtdetr
from spotter_tpu_torch.ops import int8 as tint8
from spotter_tpu_torch.utils import quant as tquant
from tests.torch_parity import random_flax_params

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def set_knobs(monkeypatch, int8=True, dense=True, attn=True, min_ch=8, min_batch=1, min_hd=4):
    """The int8 knobs on both packages' modules."""
    for mod in (jquant, tquant):
        monkeypatch.setattr(mod, "INT8", int8)
        monkeypatch.setattr(mod, "INT8_DENSE", dense)
        monkeypatch.setattr(mod, "INT8_ATTN", attn)
        monkeypatch.setattr(mod, "INT8_MIN_CH", min_ch)
        monkeypatch.setattr(mod, "INT8_MIN_BATCH", min_batch)
        monkeypatch.setattr(mod, "INT8_ATTN_MIN_HD", min_hd)


def knobs_from_env(monkeypatch, min_ch=8, min_batch=1, min_hd=4):
    """The port's switches as a process started with this environment reads
    them (at import), with floors the tiny models reach."""
    for attr, env in (("INT8", tquant.INT8_ENV), ("INT8_DENSE", tquant.INT8_DENSE_ENV),
                      ("INT8_ATTN", tquant.INT8_ATTN_ENV)):
        monkeypatch.setattr(tquant, attr, tquant.knob_on(env))
    monkeypatch.setattr(tquant, "INT8_MIN_CH", min_ch)
    monkeypatch.setattr(tquant, "INT8_MIN_BATCH", min_batch)
    monkeypatch.setattr(tquant, "INT8_ATTN_MIN_HD", min_hd)


def assert_knob_serves(monkeypatch, knob, build, forward, quantizes):
    """`knob`=1 builds and its forward takes the int8 path (`quantizes`: the
    conv path for SPOTTER_TPU_INT8 on a model with ConvNorm layers) or, for
    a knob that is a no-op on its own, the float path bit for bit; "0"
    builds the float model, which quantizes nothing. Returns the calls."""
    monkeypatch.setenv(knob, "1")
    knobs_from_env(monkeypatch)
    tquant.reset_calls()
    with torch.inference_mode():
        on = forward(build())
    calls = dict(tquant.CALLS)
    monkeypatch.setenv(knob, "0")  # the JAX package's "off"
    knobs_from_env(monkeypatch)
    tquant.reset_calls()
    with torch.inference_mode():
        off = forward(build())
    assert tquant.CALLS == {"conv": 0, "dense": 0, "qk": 0, "av": 0}
    if quantizes:
        assert calls["conv"] > 0 and calls["dense"] == calls["qk"] == calls["av"] == 0, calls
    else:
        assert calls == {"conv": 0, "dense": 0, "qk": 0, "av": 0}, calls
        for key in off:
            assert torch.equal(on[key], off[key]), key
    return calls


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else \
        x.float().numpy()


def assert_within_ulps(got, want, dtype, ulps):
    """|got - want| within `ulps` units in the last place of the largest
    |want| at `dtype` (fp32: 2**-23 of its power of two; bf16: 2**-7)."""
    bits = 23 if dtype in ("float32", torch.float32) else 7
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - bits)
    err = float(np.abs(got - want).max())
    assert err <= ulps * ulp, (err, ulps * ulp)
    return err / ulp


def _edge_input(rng, shape):
    """Normal values, an all-zero sample, and values on k + 0.5 steps of the
    sample's scale (round half to even decides them)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[1] = 0.0
    if shape[0] > 2:
        flat = x[2].reshape(-1)
        flat[:] = np.round(flat * 4) / 4
        flat[0] = 127 / 4  # amax 31.75, so scale 0.25 and x / scale lands on halves
        flat[1:6] = np.array([0.125, 0.375, -0.625, 2.625, -3.125])
    return x


# --- the quantize functions ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 5, 7, 3), (3, 40), (17,)])
def test_quantize_activation_is_bit_equal_to_jax(dtype, shape):
    jd, td = DTYPES[dtype]
    x = _edge_input(np.random.default_rng(0), shape) if len(shape) > 1 else \
        np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jq, js = jquant.quantize_activation(jnp.asarray(x).astype(jd))
    tq, ts = tquant.quantize_activation(torch.from_numpy(x).to(td))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if len(shape) > 1:
        assert ts[1].item() == np.float32(1e-12) / np.float32(127)  # the all-zero sample
        assert (tq[1] == 0).all()
    if shape[0] > 2 and len(shape) > 1:  # halves round to even
        assert tq[2].reshape(-1)[1:6].tolist() == [0, 2, -2, 10, -12]


@pytest.mark.parametrize("shape", [(3, 3, 12, 5), (7, 9)])
def test_quantize_weight_is_bit_equal_to_jax(shape):
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    w[..., 1] = 0.0  # an all-zero output channel
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    port = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T  # output channel first
    tq, ts = tquant.quantize_weight(torch.from_numpy(np.ascontiguousarray(port)))
    want = np.asarray(jq).transpose(3, 2, 0, 1) if w.ndim == 4 else np.asarray(jq).T
    np.testing.assert_array_equal(tq.numpy(), want)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    q = tint8.quantize_weight_rows(torch.from_numpy(np.ascontiguousarray(port)))
    np.testing.assert_array_equal(q.codes[:, :want[0].size].numpy(), want.reshape(len(want), -1))
    assert q.k_pad % 16 == 0 and (q.codes[:, want[0].size:] == 0).all()
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_axis", [1, 2])
def test_quantize_per_head_is_bit_equal_to_jax(dtype, head_axis):
    jd, td = DTYPES[dtype]
    x = _edge_input(np.random.default_rng(3), (3, 6, 4, 8))
    jq, js = jquant.quantize_per_head(jnp.asarray(x).astype(jd), head_axis)
    tq, ts = tquant.quantize_per_head(torch.from_numpy(x).to(td), head_axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --- the products -----------------------------------------------------------------


CONVS = [(1, 1, 0), (3, 1, 1), (3, 2, 1), (1, 2, 0), (7, 2, 3)]  # (k, stride, padding)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", CONVS)
def test_int8_conv_is_bit_equal_to_jax(dtype, k, stride, pad):
    """Strides 1 and 2, kernels 1, 3 and 7 at the paddings the models use:
    the int32 products equal, the dequantized output bit equal, through the
    plain reference and through the kernels' wrappers (their plain versions
    on the CPU)."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(k * 10 + stride)
    x = _edge_input(rng, (3, 12, 11, 9))
    w = (rng.standard_normal((k, k, 12, 10)) / np.sqrt(k * k * 12)).astype(np.float32)
    want = jquant.int8_conv(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jd), jnp.asarray(w),
                            (stride, stride), [(pad, pad), (pad, pad)], jd)
    want = _np(want).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).to(td)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    ref = tquant.int8_conv_reference(xt, wt, stride, pad, td)
    got = tquant.int8_conv(xt, tint8.quantize_conv_weight(wt), k, stride, pad, td)
    assert got.dtype == td and got.is_contiguous()
    np.testing.assert_array_equal(_np(ref), want)
    np.testing.assert_array_equal(_np(got), want)
    # the int32 product itself
    xq, _ = jquant.quantize_activation(jnp.asarray(x.transpose(0, 2, 3, 1)))
    wq, _ = jquant.quantize_weight(jnp.asarray(w))
    import jax

    y = jax.lax.conv_general_dilated(xq, wq, (stride, stride), [(pad, pad), (pad, pad)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     preferred_element_type=jnp.int32)
    x32 = torch.from_numpy(x)
    nhwc, sx = tint8.nhwc_codes(x32, tint8.amax_samples(x32), 16)
    np.testing.assert_array_equal(nhwc[..., :12].numpy(), np.asarray(xq))
    # conv_s8's plain version on the NHWC codes, at unit scales: the int32 product
    qc = tint8.quantize_conv_weight(wt)
    ones = torch.ones(3), torch.ones(10)
    yt = tint8.conv_s8_reference(nhwc, qc.codes, *ones, k, stride, pad, torch.float32)
    np.testing.assert_array_equal(yt.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 24), (4, 40)])
def test_int8_dense_is_bit_equal_to_jax(dtype, shape):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x = _edge_input(rng, shape)
    w = (rng.standard_normal((shape[-1], 13)) / np.sqrt(shape[-1])).astype(np.float32)
    want = _np(jquant.int8_dense(jnp.asarray(x).astype(jd), jnp.asarray(w), jd))
    xt = torch.from_numpy(x).to(td)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    np.testing.assert_array_equal(_np(tquant.int8_dense_reference(xt, wt, td)), want)
    got = tquant.int8_dense(xt, tint8.quantize_weight_rows(wt), td)
    assert got.shape == (*shape[:-1], 13) and got.dtype == td
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_attention_products_are_bit_equal_to_jax(dtype):
    """QKᵀ (fp32 out) and attn·V (`dtype` out) at Tq != Tk, ragged lengths."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(5)
    q = _edge_input(rng, (3, 7, 2, 8))
    k = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    jlog = jquant.int8_qk(jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd))
    tlog = tquant.int8_qk(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td))
    assert tlog.dtype == torch.float32 and tlog.shape == (3, 2, 7, 9)
    np.testing.assert_array_equal(tlog.numpy(), np.asarray(jlog))
    np.testing.assert_array_equal(
        tquant.int8_qk_reference(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td)).numpy(),
        np.asarray(jlog))
    w = np.asarray(jnp.asarray(np.asarray(jlog)).astype(jd).astype(jnp.float32))
    w = np.exp(w - w.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    jav = _np(jquant.int8_av(jnp.asarray(w).astype(jd), jnp.asarray(v).astype(jd), jd))
    tav = tquant.int8_av(torch.from_numpy(w).to(td), torch.from_numpy(v).to(td), td)
    assert tav.dtype == td and tav.shape == (3, 7, 2, 8)
    np.testing.assert_array_equal(_np(tav), jav)
    np.testing.assert_array_equal(
        _np(tquant.int8_av_reference(torch.from_numpy(w).to(td), torch.from_numpy(v).to(td), td)),
        jav)


# --- quantize_s8's layouts in their plain form -----------------------------------------


def test_nhwc_layout_is_the_codes_permuted():
    x = torch.from_numpy(_edge_input(np.random.default_rng(6), (3, 5, 9, 8)))
    codes, scales = tint8.nhwc_codes(x, tint8.amax_samples(x), 48)
    xq, sx = tquant.quantize_activation(x)
    assert codes.shape == (3, 9, 8, 48) and codes.dtype == torch.int8 and codes.is_contiguous()
    np.testing.assert_array_equal(codes[..., :5].numpy(), xq.permute(0, 2, 3, 1).numpy())
    assert (codes[..., 5:] == 0).all()
    np.testing.assert_array_equal(scales.numpy(), sx.reshape(-1).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nhwc_codes_is_the_amax_pass_then_the_codes(dtype):
    """`amax_samples` (the amax kernel's plain form) is each sample's max
    |x|, as one partial maximum a sample; `nhwc_codes` from any partials
    whose max is that amax gives the same codes and scales; the numeric rule
    is one, shared by utils/quant.py."""
    x = torch.from_numpy(_edge_input(np.random.default_rng(16), (3, 4, 6, 5))).to(dtype)
    amax = tint8.amax_samples(x)
    assert amax.dtype == torch.float32 and amax.shape == (3, 1)
    assert torch.equal(amax.amax(1), x.float().abs().reshape(3, -1).amax(1))
    assert amax[1, 0] == 0  # the all-zero sample: the scale takes the 1e-12 floor
    codes, scales = tint8.nhwc_codes(x, amax, 16)
    split = torch.cat([amax, amax / 2, torch.zeros_like(amax)], dim=1)  # three partials a sample
    assert all(torch.equal(a, b) for a, b in zip(tint8.nhwc_codes(x, split, 16), (codes, scales)))
    xq, sx = tquant.quantize_activation(x)
    assert torch.equal(codes[..., :4], xq.permute(0, 2, 3, 1)) and torch.equal(scales, sx.view(-1))
    assert tquant.scale_of is tint8.scale_of and tquant.codes_of is tint8.codes_of


def test_rows_and_heads_layouts():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_edge_input(rng, (3, 4, 5, 6)))
    # rows: a sample's 4 * 5 rows share a scale, K padded 6 -> 16
    codes, scales = tint8.quantize_rows(x.reshape(60, 6), 20, 16)
    xq, sx = tquant.quantize_activation(x)
    np.testing.assert_array_equal(codes[:, :6].numpy(), xq.reshape(60, 6).numpy())
    assert (codes[:, 6:] == 0).all() and torch.equal(scales, sx.reshape(-1))
    # heads and heads_t: per (sample, head) of (B, T, H, hd)
    hq, hs = tquant.quantize_per_head(x, 2)
    codes, scales = tint8.quantize_heads(x, transpose=False)
    assert codes.shape == (15, 4, 16)
    np.testing.assert_array_equal(codes[..., :6].numpy(),
                                  hq.permute(0, 2, 1, 3).reshape(15, 4, 6).numpy())
    assert torch.equal(scales, hs.reshape(-1))
    codes, scales = tint8.quantize_heads(x, transpose=True)
    assert codes.shape == (15, 6, 16) and (codes[..., 4:] == 0).all()
    np.testing.assert_array_equal(codes[..., :4].numpy(),
                                  hq.permute(0, 2, 3, 1).reshape(15, 6, 4).numpy())


def test_gemm_kmajor_and_dequant_plain_versions():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.integers(-127, 128, (2, 5, 32), dtype=np.int8))
    bt = torch.from_numpy(rng.integers(-127, 128, (7, 32), dtype=np.int8))
    want = torch.einsum("gmk,nk->gmn", a.long(), bt.long())
    assert torch.equal(tint8.int8_gemm_kmajor(a, bt), want.int())
    btb = torch.from_numpy(rng.integers(-127, 128, (2, 7, 32), dtype=np.int8))
    assert torch.equal(tint8.int8_gemm_kmajor(a, btb),
                       torch.einsum("gmk,gnk->gmn", a.long(), btb.long()).int())
    with pytest.raises(ValueError, match="expected a"):
        tint8.int8_gemm_kmajor(a[0], btb)
    y = want.int()
    sa, sb = torch.rand(2), torch.rand(7)
    got = tint8.dequant_rows(y.reshape(10, 7), sa, sb, 5, torch.float32)
    want = (y.float() * (sa.view(2, 1, 1) * sb)).reshape(10, 7)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(TypeError, match="int32"):
        tint8.dequant_rows(y.float(), sa, sb, 1, torch.float32)


# --- the layers -------------------------------------------------------------------


def _apply(module, params, *args):
    return module.apply({"params": params}, *args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_convnorm_int8_matches_jax(monkeypatch, dtype, k, stride):
    set_knobs(monkeypatch)
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(9).standard_normal((2, 9, 10, 16)).astype(np.float32)
    jm = jl.ConvNorm(12, k, stride, activation="silu", dtype=jd)
    params = random_flax_params(jm, x[:1], seed=1)
    want = _np(_apply(jm, params, jnp.asarray(x).astype(jd))).transpose(0, 3, 1, 2)
    tm = load_from_jax(tl.ConvNorm(16, 12, k, stride, activation="silu", dtype=td), params)
    assert tm.conv.weight.dtype == torch.float32  # the fp32 master
    with torch.inference_mode():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(td))
    assert got.dtype == td
    assert_within_ulps(_np(got), want, dtype, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_quant_dense_int8_matches_jax(monkeypatch, dtype, bias):
    set_knobs(monkeypatch)
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(10).standard_normal((3, 5, 24)).astype(np.float32)
    jm = jl.QuantDense(20, use_bias=bias, dtype=jd)
    params = random_flax_params(jm, x[:1], seed=2)
    want = _np(_apply(jm, params, jnp.asarray(x).astype(jd)))
    tm = load_from_jax(tl.QuantDense(24, 20, bias=bias, dtype=td), params)
    assert tm.weight.dtype == torch.float32
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).to(td))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_int8_matches_jax(monkeypatch, dtype, cross):
    """Projections, QKᵀ and attn·V all quantized, with position embeddings
    and (cross-attention) a mask. fp32: bit equal. bf16: the logits' add of
    the mask and the softmax are XLA's and PyTorch's (the softmax's exp
    differs by an ulp on some entries, which can move an attention code by
    one step): within 2 bf16 ulps of the largest output."""
    set_knobs(monkeypatch)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    pos = rng.standard_normal((2, 6, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 16)).astype(np.float32) if cross else None
    mask = (np.where(rng.uniform(size=(2, 1, 1, 9)) < 0.2, -1e9, 0.0).astype(np.float32)
            if cross else None)
    jm = jl.MultiHeadAttention(16, 2, dtype=jd)
    jargs = [jnp.asarray(x).astype(jd), jnp.asarray(pos).astype(jd)]
    if cross:
        jargs += [jnp.asarray(kv).astype(jd), jnp.asarray(mask)]
    params = random_flax_params(jm, *[a[:1] for a in jargs], seed=3)
    want = _np(_apply(jm, params, *jargs))
    tm = load_from_jax(tl.MultiHeadAttention(16, 2, dtype=td), params)
    targs = [torch.from_numpy(x).to(td), torch.from_numpy(pos).to(td)]
    if cross:
        targs += [torch.from_numpy(kv).to(td), torch.from_numpy(mask)]
    tquant.reset_calls()
    with torch.inference_mode():
        got = _np(tm(*targs))
    assert tquant.CALLS == {"conv": 0, "dense": 4, "qk": 1, "av": 1}
    assert_within_ulps(got, want, dtype, 2)


def _repvgg(monkeypatch, dtype, fuse, x):
    jd, td = DTYPES[dtype]
    monkeypatch.setattr(jrtdetr, "REP_FUSE", fuse)
    monkeypatch.setenv(trtdetr.REP_FUSE_ENV, "1" if fuse else "0")
    jm = jrtdetr.RepVggBlock(16, dtype=jd)
    params = random_flax_params(jm, x[:1], seed=4)
    want = _np(_apply(jm, params, jnp.asarray(x).astype(jd))).transpose(0, 3, 1, 2)
    tm = load_from_jax(trtdetr.RepVggBlock(16, dtype=td), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(td))
    return want, got, tm, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", [True, False])
def test_repvgg_block_int8_matches_jax(monkeypatch, dtype, fuse):
    set_knobs(monkeypatch)
    x = np.random.default_rng(12).standard_normal((2, 8, 7, 16)).astype(np.float32)
    tquant.reset_calls()
    want, got, _, _ = _repvgg(monkeypatch, dtype, fuse, x)
    assert tquant.CALLS["conv"] == (1 if fuse else 2)
    assert_within_ulps(_np(got), want, dtype, 2)


def test_fused_repvgg_kernel_under_bfloat16_is_folded_from_the_fp32_params(monkeypatch):
    """The fused kernel under bfloat16 equals the JAX package's bit for bit:
    bf16(w * mul) from the fp32 param, not bf16(bf16(w) * mul)."""
    x = np.random.default_rng(13).standard_normal((2, 8, 7, 16)).astype(np.float32)
    monkeypatch.setattr(jrtdetr, "REP_FUSE", True)
    jm = jrtdetr.RepVggBlock(16, dtype=jnp.bfloat16)
    params = random_flax_params(jm, jnp.asarray(x[:1]).astype(jnp.bfloat16), seed=4)
    w3, b3 = jl.ConvNormParams(16, 3, 16).apply({"params": params["conv1"]})
    w1, b1 = jl.ConvNormParams(16, 1, 16).apply({"params": params["conv2"]})
    jk = np.asarray(w3.at[1:2, 1:2].add(w1).astype(jnp.bfloat16).astype(jnp.float32))
    jb = np.asarray((b3 + b1).astype(jnp.bfloat16).astype(jnp.float32))
    tm = load_from_jax(trtdetr.RepVggBlock(16, dtype=torch.bfloat16), params)
    with torch.no_grad():  # the values as an inference forward keeps them
        kernel, bias = tm.fused_params()
        wf = tm.fused_fp32()[0]
    assert kernel.dtype == torch.bfloat16
    np.testing.assert_array_equal(kernel.float().numpy(), jk.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(bias.float().numpy(), jb)
    # the folded fp32 kernel is the JAX package's wf, within the fp32 ulp by
    # which XLA's CPU rsqrt and PyTorch's differ on about a third of the BN
    # variances (the fold's scale * rsqrt(var + eps))
    jwf = np.asarray(w3.at[1:2, 1:2].add(w1)).transpose(3, 2, 0, 1)
    assert_within_ulps(wf.numpy(), jwf, "float32", 2)


# --- the guards: knobs unset, alone, or below a floor, leave the float path ------------


def _float_outputs(monkeypatch, build_and_run):
    set_knobs(monkeypatch, int8=False, dense=False, attn=False)
    return build_and_run()


def _mha_run(dtype="float32", b=2, hd_heads=2):
    rng = np.random.default_rng(14)
    torch.manual_seed(0)
    tm = tl.MultiHeadAttention(16, hd_heads, dtype=DTYPES[dtype][1]).eval()
    for p in tm.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.from_numpy(rng.standard_normal((b, 6, 16)).astype(np.float32))
    with torch.inference_mode():
        return tm(x), tm


@pytest.mark.parametrize("knobs", [
    dict(int8=False, dense=False, attn=False),  # everything unset
    dict(int8=False, dense=True, attn=False),  # INT8_DENSE alone
    dict(int8=False, dense=False, attn=True),  # INT8_ATTN alone
    dict(int8=True, dense=True, attn=True, min_batch=3),  # batch 2 below the floor
    dict(int8=True, dense=True, attn=True, min_ch=17, min_hd=9),  # widths below the floors
])
def test_guards_leave_the_float_path_bit_identical(monkeypatch, knobs):
    set_knobs(monkeypatch, int8=False, dense=False, attn=False)
    ref, _ = _mha_run()
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((2, 16, 6, 5)).astype(np.float32))
    conv = tl.ConvNorm(16, 8, 3).eval()
    torch.nn.init.normal_(conv.conv.weight)
    with torch.inference_mode():
        conv_ref = conv(x)
    set_knobs(monkeypatch, **knobs)
    tquant.reset_calls()
    got, _ = _mha_run()
    with torch.inference_mode():
        conv_got = conv(x)
    assert tquant.CALLS == {"conv": 0, "dense": 0, "qk": 0, "av": 0}
    assert torch.equal(got, ref) and torch.equal(conv_got, conv_ref)


@pytest.mark.parametrize("edge", ["min_batch", "min_ch", "min_hd"])
def test_guard_edges_are_inclusive(monkeypatch, edge):
    """A floor equal to the batch, the channels or the head dim quantizes;
    one past it does not (the JAX package's >= comparisons)."""
    at = dict(min_batch=dict(min_batch=2), min_ch=dict(min_ch=16), min_hd=dict(min_hd=8))[edge]
    past = {k: v + 1 for k, v in at.items()}
    for setting, quantized in ((at, True), (past, False)):
        set_knobs(monkeypatch, **setting)
        tquant.reset_calls()
        _mha_run()
        calls = dict(tquant.CALLS)
        if edge == "min_hd":
            assert calls["dense"] == 4 and calls["qk"] == int(quantized)
        else:
            assert calls["dense"] == 4 * int(quantized)
        for fn, width in (("int8_wanted", 16), ("int8_dense_wanted", 16), ("int8_attn_wanted", 8)):
            assert getattr(jquant, fn)(width, batch=2) == getattr(tquant, fn)(width, batch=2)


def test_weights_are_quantized_once_and_kept(monkeypatch):
    set_knobs(monkeypatch)
    _, tm = _mha_run()
    first = tm.q_proj.quantized_kernel()
    assert tm.q_proj.quantized_kernel() is first
    with torch.no_grad():
        tm.q_proj.weight.mul_(2.0)  # an in-place change bumps the version counter
    again = tm.q_proj.quantized_kernel()
    assert again is not first and torch.equal(again.codes, first.codes)
    assert torch.equal(again.scale, first.scale * 2)


def _grad_cases():
    x = torch.from_numpy(np.random.default_rng(17).standard_normal((2, 16, 5, 5))
                         .astype(np.float32))
    return {
        "conv_norm": (lambda: tl.ConvNorm(16, 8, 3, dtype=torch.bfloat16), x,
                      lambda m: [m.conv.weight],
                      lambda m, w: F.conv2d(x.bfloat16(), w[0].bfloat16(), None, 1, 1)),
        "quant_dense": (lambda: tl.QuantDense(16, 8, dtype=torch.bfloat16),
                        x[:, :, 0].transpose(1, 2), lambda m: [m.weight, m.bias],
                        lambda m, w: F.linear(x[:, :, 0].transpose(1, 2).bfloat16(),
                                              w[0].bfloat16(), w[1].bfloat16())),
        "repvgg_fused": (lambda: trtdetr.RepVggBlock(16, dtype=torch.bfloat16), x,
                         lambda m: [m.conv1.conv.weight, m.conv2.conv.weight], None),
    }


@pytest.mark.parametrize("case", ["conv_norm", "quant_dense", "repvgg_fused"])
def test_bf16_casts_pass_gradients_to_the_fp32_masters(monkeypatch, case):
    """Under a bf16 policy the kept casts and the fused fold are not kept in
    a forward that tracks gradients: the gradient reaches the fp32 masters,
    equal to the gradient through the cast made in the forward; under
    no_grad the cast is kept (made once)."""
    monkeypatch.setenv(trtdetr.REP_FUSE_ENV, "1")
    build, x, params, direct = _grad_cases()[case]
    torch.manual_seed(18)
    module = build()
    for p in module.parameters():
        p.data.normal_()
    module(x).float().square().sum().backward()
    grads = [p.grad for p in params(module)]
    assert all(g is not None and g.dtype == torch.float32 and g.abs().sum() > 0 for g in grads)
    if direct is not None:
        leaves = [p.detach().clone().requires_grad_() for p in params(module)]
        y = direct(module, leaves)
        if case == "conv_norm":
            y = module.act(module.bn(y))
        y.float().square().sum().backward()
        for g, leaf in zip(grads, leaves):
            assert torch.equal(g, leaf.grad)
    with torch.no_grad():
        module(x)
        kept_value = module.__dict__.get("_fused" if case == "repvgg_fused" else "_cast")
        assert kept_value is not None
        module(x)
        again = module.__dict__.get("_fused" if case == "repvgg_fused" else "_cast")
        assert again is kept_value


def test_knob_values_read_as_the_jax_package_reads_them(monkeypatch):
    for raw, on in (("1", True), (" 0 ", False), ("true", True), ("", True), ("00", True)):
        monkeypatch.setenv("SPOTTER_TPU_INT8", raw)
        assert tquant.knob_on("SPOTTER_TPU_INT8") == (raw.strip() != "0")
    monkeypatch.delenv("SPOTTER_TPU_INT8")
    assert not tquant.knob_on("SPOTTER_TPU_INT8")


# --- the wrappers' device rules --------------------------------------------------------


def test_wrappers_take_the_plain_version_on_the_cpu_and_raise_elsewhere(monkeypatch):
    builds = []
    monkeypatch.setattr(tint8, "build_quant_kernel", lambda: builds.append(1))
    monkeypatch.setattr(tint8, "build_int8_gemm_kernel", lambda: builds.append(1))
    monkeypatch.setattr(tint8, "build_int8_conv_kernel", lambda: builds.append(1))
    x = torch.ones((2, 3, 4, 16))
    counters = (tint8.amax_s8, tint8.quantize_s8, tint8.quantize_nhwc_s8, tint8.int8_gemm_kmajor,
                tint8.dequant_s32, tint8.conv_s8)
    before = [c.launches for c in counters]
    codes, s = tint8.quantize_heads(x, transpose=False)
    tint8.dequant_heads(tint8.int8_gemm_kmajor(codes, codes), s, s, torch.float32)
    tint8.nhwc_codes(x, tint8.amax_samples(x), 16)
    qc = tint8.quantize_conv_weight(torch.ones((5, 3, 3, 3)))
    nhwc = torch.ones((2, 4, 16, 16), dtype=torch.int8)
    tint8.conv_s8(nhwc, qc.codes, s[:2], qc.scale, 3, 1, 1, torch.float32)
    assert builds == [] and before == [c.launches for c in counters]
    meta = x.to("meta")
    for call in (lambda: tint8.quantize_heads(meta, transpose=True),
                 lambda: tint8.quantize_rows(meta.reshape(-1, 16), 1, 16),
                 lambda: tint8.nhwc_codes(meta, torch.ones((2, 1), device="meta"), 16),
                 lambda: tint8.amax_samples(meta),
                 lambda: tint8.int8_gemm_kmajor(codes.to("meta"), codes.to("meta")),
                 lambda: tint8.conv_s8(nhwc.to("meta"), qc.codes.to("meta"), s[:2].to("meta"),
                                       qc.scale.to("meta"), 3, 1, 1, torch.float32),
                 lambda: tint8.dequant_rows(torch.ones((2, 2), dtype=torch.int32,
                                                       device="meta"), s, s, 1, torch.float32)):
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            call()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tint8.quantize_rows(x.reshape(-1, 16).double(), 1, 16)
