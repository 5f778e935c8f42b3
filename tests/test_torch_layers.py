"""Building blocks: spotter_tpu_torch.models.layers against spotter_tpu.models.layers.

Flax params come from a numpy seed (tests/torch_parity.py) and are carried
across with `convert.from_jax`; inputs are numpy too. The port's convs run
NCHW, so conv inputs and outputs are transposed at the boundary.

Tolerance atol 1e-5, rtol 1e-5 (the position table exactly): fp32 on both
sides, one layer deep, summed in another order.
"""

import jax
import numpy as np
import pytest
import torch

from spotter_tpu.models import layers as jl
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models import layers as tl
from tests.torch_parity import random_flax_params


@pytest.mark.parametrize(
    "k,stride,padding,act",
    [(3, 1, None, "relu"), (3, 2, None, "silu"), (1, 1, None, None), (3, 2, 1, None)],
)
def test_conv_norm_matches_jax(k, stride, padding, act):
    x = np.random.default_rng(0).standard_normal((2, 9, 11, 5)).astype(np.float32)
    jmod = jl.ConvNorm(7, k, stride, padding=padding, activation=act)
    params = random_flax_params(jmod, x, seed=1)
    want = np.asarray(jmod.apply({"params": params}, x))
    tmod = load_from_jax(tl.ConvNorm(5, 7, k, stride, padding=padding, activation=act), params)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["self_pos", "self_plain", "cross_masked"])
def test_multi_head_attention_matches_jax(mode):
    rng = np.random.default_rng(2)
    b, tq, tk, d, heads = 2, 6, 9, 16, 4
    h = rng.standard_normal((b, tq, d)).astype(np.float32)
    kwargs = {}
    if mode == "self_pos":
        kwargs["position_embeddings"] = rng.standard_normal((1, tq, d)).astype(np.float32)
    if mode == "cross_masked":
        kwargs["key_value_states"] = rng.standard_normal((b, tk, d)).astype(np.float32)
        kwargs["key_position_embeddings"] = rng.standard_normal((b, tk, d)).astype(np.float32)
        mask = np.where(rng.uniform(size=(b, 1, tq, tk)) < 0.3, -1e9, 0.0)
        kwargs["attention_mask"] = mask.astype(np.float32)
    jmod = jl.MultiHeadAttention(d, heads)
    params = random_flax_params(jmod, h, None, kwargs.get("key_value_states"), seed=3)
    want = np.asarray(jmod.apply({"params": params}, h, **kwargs))
    tmod = load_from_jax(tl.MultiHeadAttention(d, heads), params)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(h), **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_mlp_head_matches_jax(num_layers):
    x = np.random.default_rng(4).standard_normal((2, 5, 12)).astype(np.float32)
    jmod = jl.MLPHead(20, 4, num_layers)
    params = random_flax_params(jmod, x, seed=5)
    want = np.asarray(jmod.apply({"params": params}, x))
    tmod = load_from_jax(tl.MLPHead(12, 20, 4, num_layers), params)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("wh", [(20, 20), (5, 3), (8, 12)])
def test_sincos_2d_position_embedding_matches_jax(wh):
    w, h = wh
    np.testing.assert_array_equal(
        tl.sincos_2d_position_embedding(w, h, 32, 10000.0),
        jl.sincos_2d_position_embedding(w, h, 32, 10000.0),
    )


def test_inverse_sigmoid_and_fold_bn_match_jax():
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(-0.1, 1.1, 50), [0.0, 1.0, 1e-7]]).astype(np.float32)
    np.testing.assert_allclose(
        tl.inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jl.inverse_sigmoid(jax.numpy.asarray(x))), atol=1e-5, rtol=1e-6,
    )
    stats = [rng.uniform(0.5, 1.5, 8).astype(np.float32) for _ in range(4)]
    for got, want in zip(
        tl.fold_bn(*map(torch.from_numpy, stats), 1e-5), jl.fold_bn(*stats, 1e-5)
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
