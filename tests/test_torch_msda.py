"""MSDA sampling: the port (spotter_tpu_torch.ops.msda) against the JAX package.

Same inputs, made from a numpy seed, go through JAX `deformable_sampling`
(the "xla" backend and the interpret-mode "pallas" backend, whose kernel is
`pallas_onehot_sampling_merged`) and through the port's plain path, which
is what the port's wrapper runs for a CPU tensor. Shapes are
tests/test_msda.py's.

Tolerance: atol 1e-5. Both sides sum the same fp32 products of weights in
[0, 1] and standard-normal values, in another order, over at most 48 terms.

The CUDA kernel itself runs only on the card; the last test here is marked
`cuda` and skips without one (chip_smoke.py holds the kernel against its
plain version at the model's shapes).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spotter_tpu.ops import msda as jmsda
from spotter_tpu_torch.ops import msda as tmsda

SHAPES = ((8, 8), (4, 4), (2, 2))
B, Q, H, HD, P = 2, 7, 4, 8, 3
LP = len(SHAPES) * P
S = sum(h * w for h, w in SHAPES)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    # mostly inside [0, 1], some outside to exercise zero padding / clamping
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, LP, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Q, H, LP)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attn.astype(np.float32)


@pytest.mark.parametrize("method", ["default", "discrete"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_deformable_sampling_matches_jax(method, backend):
    value, loc, attn = _inputs(3 if method == "default" else 4)
    ref = jmsda.deformable_sampling(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn), SHAPES, P,
        method=method, backend=backend, interpret=backend == "pallas",
    )
    got = tmsda.deformable_sampling(
        torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attn),
        SHAPES, P, method=method,
    )
    assert got.shape == (B, Q, H * HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("method", ["default", "discrete"])
def test_corner_prep_matches_jax(method):
    """Same corner cells and weights as the JAX prep, up to layout: JAX
    gives (B, H, 4, LP*Q) with zero slots for discrete; the port gives
    (B*H, Q, LP*corners)."""
    _, loc, attn = _inputs(5)
    jidx, jw = jmsda.prepare_msda_gather(
        jnp.asarray(loc.transpose(0, 2, 3, 1, 4)), jnp.asarray(attn.transpose(0, 2, 3, 1)),
        SHAPES, P, method,
    )
    tidx, tw = tmsda.prepare_msda_gather(
        torch.from_numpy(loc), torch.from_numpy(attn), SHAPES, P, method
    )
    n_c = 4 if method == "default" else 1
    # JAX (B, H, 4, LP, Q) -> (B*H, Q, LP, corners)
    jidx = np.asarray(jidx).reshape(B, H, 4, LP, Q)[:, :, :n_c].transpose(0, 1, 4, 3, 2)
    jw = np.asarray(jw).reshape(B, H, 4, LP, Q)[:, :, :n_c].transpose(0, 1, 4, 3, 2)
    assert tidx.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), jidx.reshape(B * H, Q, LP * n_c))
    np.testing.assert_allclose(tw.numpy(), jw.reshape(B * H, Q, LP * n_c), atol=1e-7)


@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
def test_gather_sum_reference_matches_onehot_ref_math(rows_dtype):
    rng = np.random.default_rng(6)
    bh, j = B * H, 4 * LP
    rows = rng.standard_normal((bh, S, HD)).astype(np.float32)
    idx = rng.integers(0, S, (bh, Q, j)).astype(np.int32)
    w = rng.uniform(0, 1, (bh, Q, j)).astype(np.float32)
    jrows = jnp.asarray(rows).astype(getattr(jnp, rows_dtype))
    ref = jmsda._onehot_ref_math(jrows, jnp.asarray(idx), jnp.asarray(w))
    trows = torch.from_numpy(rows).to(getattr(torch, rows_dtype))
    got = tmsda.msda_gather_sum_reference(trows, torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_gather_sum_skips_out_of_range_indices():
    """An index outside [0, S) contributes nothing, whatever its weight."""
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.standard_normal((2, 5, 4)).astype(np.float32))
    idx = torch.tensor([[[0, -1, 5, 99]], [[4, 4, -7, 2]]], dtype=torch.int32)
    w = torch.tensor([[[0.5, 9.0, 9.0, 9.0]], [[0.25, 0.5, 9.0, 1.0]]])
    got = tmsda.msda_gather_sum(rows, idx, w)
    want = torch.stack([0.5 * rows[0, 0], 0.75 * rows[1, 4] + rows[1, 2]])[:, None]
    torch.testing.assert_close(got, want)


def test_cpu_wrapper_launches_nothing():
    value, loc, attn = _inputs(8)
    before = tmsda.msda_gather_sum.launches
    tmsda.deformable_sampling(
        torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attn), SHAPES, P
    )
    assert tmsda.msda_gather_sum.launches == before


def test_wrapper_rejects_mixed_devices():
    rows = torch.zeros((1, 4, 2))
    idx = torch.zeros((1, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tmsda.msda_gather_sum(rows, idx, torch.zeros((1, 1, 1)))
    with pytest.raises(ValueError):
        tmsda.msda_gather_sum(rows.to("meta"), idx, torch.zeros((1, 1, 1), device="meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    value, loc, attn = _inputs(9)
    dev = torch.device("cuda")
    before = tmsda.msda_gather_sum.launches
    for method in ("default", "discrete"):
        got = tmsda.deformable_sampling(
            torch.from_numpy(value).to(dev), torch.from_numpy(loc).to(dev),
            torch.from_numpy(attn).to(dev), SHAPES, P, method=method,
        )
        want = tmsda.deformable_sampling(
            torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attn),
            SHAPES, P, method=method,
        )
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    assert tmsda.msda_gather_sum.launches == before + 2
