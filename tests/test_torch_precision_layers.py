"""The precision policies' building blocks against their flax modules, and
the RepVGG fusion (SPOTTER_TPU_REP_FUSE).

Each layer runs at the dtype the policy gives its place in the model:
`FrozenBatchNorm` and `ConvNorm` are backbone layers (bf16 under "mixed"
and "bfloat16"), `RepVggBlock` and `CSPRepLayer` encoder layers (fp32
under "mixed", bf16 under "bfloat16"), on the same params (numpy-seeded,
tests/torch_parity.py) and the same inputs, both sides on the CPU.
Tolerances, in bf16 ulps of the largest output (2**(floor(log2 max) - 7)):

- `FrozenBatchNorm`, `ConvNorm`: 1 ulp. XLA's CPU fusion may keep the BN
  multiply-add in fp32 and round once, where PyTorch rounds the product
  and the sum (measured: 0).
- `RepVggBlock`: 2 ulps (two convolutions, a sum and the activation, each
  rounded on the port's side; measured 1).
- `CSPRepLayer`: 4 ulps (two blocks deep; measured 2.5).
- fp32 places (the encoder under "mixed"): atol 1e-5 of the largest
  output, as tests/test_rep_fuse.py.

The fused block against the unfused one under fp32: atol 1e-5 of the
largest output (tests/test_rep_fuse.py's bound: reassociation only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import layers as jlayers
from spotter_tpu.models import rtdetr as jrtdetr
from spotter_tpu.utils.precision import DTYPE_ENV
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models import layers as tlayers
from spotter_tpu_torch.models import rtdetr as trtdetr
from tests.torch_parity import random_flax_params

POLICY_DTYPES = {  # policy -> (backbone, encoder) dtypes, JAX and torch
    "mixed": ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)),
    "bfloat16": ((jnp.bfloat16, torch.bfloat16), (jnp.bfloat16, torch.bfloat16)),
}


def bf16_ulp(max_abs: float) -> float:
    return 2.0 ** (np.floor(np.log2(max_abs)) - 7)


def _run(jmodule, tmodule, jdtype, tdtype, seed=0, shape=(2, 12, 12, 16)):
    """(flax out, port out) as fp32 NHWC numpy on one seeded input, the
    input given at the layer's dtype to both."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xin = jnp.asarray(x, jdtype)
    params = random_flax_params(jmodule, xin, seed=seed + 1)
    jy = np.asarray(jmodule.apply({"params": params}, xin), np.float32)
    load_from_jax(tmodule, params)
    with torch.no_grad():
        ty = tmodule(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdtype)).float()
    return jy, ty.permute(0, 2, 3, 1).numpy(), tmodule


def _check(jy, ty, ulps, dtype):
    scale = float(np.abs(jy).max())
    atol = ulps * bf16_ulp(scale) if dtype == torch.bfloat16 else 1e-5 * max(scale, 1.0)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=atol)


@pytest.mark.parametrize("policy", list(POLICY_DTYPES))
def test_frozen_batch_norm_matches_flax(policy):
    (jdt, tdt), _ = POLICY_DTYPES[policy]
    jy, ty, module = _run(jlayers.FrozenBatchNorm(16, dtype=jdt),
                          tlayers.FrozenBatchNorm(16, dtype=tdt), jdt, tdt)
    assert module.weight.dtype == torch.float32  # the statistics stay fp32 buffers
    _check(jy, ty, 1, tdt)


@pytest.mark.parametrize("policy", list(POLICY_DTYPES))
@pytest.mark.parametrize("kernel,stride", [(3, 2), (1, 1)])
def test_conv_norm_matches_flax(policy, kernel, stride):
    (jdt, tdt), _ = POLICY_DTYPES[policy]
    jy, ty, module = _run(jlayers.ConvNorm(24, kernel, stride, activation="relu", dtype=jdt),
                          tlayers.ConvNorm(16, 24, kernel, stride, activation="relu", dtype=tdt),
                          jdt, tdt)
    assert module.dtype == tdt and module.conv.weight.dtype == torch.float32  # fp32 master
    _check(jy, ty, 1, tdt)


@pytest.mark.parametrize("policy", list(POLICY_DTYPES))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_repvgg_block_matches_flax(monkeypatch, policy, fused):
    _, (jdt, tdt) = POLICY_DTYPES[policy]
    monkeypatch.setattr(jrtdetr, "REP_FUSE", fused)
    monkeypatch.setenv("SPOTTER_TPU_REP_FUSE", "1" if fused else "0")
    jy, ty, _ = _run(jrtdetr.RepVggBlock(16, dtype=jdt), trtdetr.RepVggBlock(16, dtype=tdt),
                     jdt, tdt)
    _check(jy, ty, 2, tdt)


@pytest.mark.parametrize("policy", list(POLICY_DTYPES))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_csp_rep_layer_matches_flax(monkeypatch, policy, fused):
    _, (jdt, tdt) = POLICY_DTYPES[policy]
    monkeypatch.setattr(jrtdetr, "REP_FUSE", fused)
    monkeypatch.setenv("SPOTTER_TPU_REP_FUSE", "1" if fused else "0")
    jy, ty, _ = _run(jrtdetr.CSPRepLayer(24, 16, 2, dtype=jdt),
                     trtdetr.CSPRepLayer(16, 24, 16, 2, dtype=tdt), jdt, tdt)
    _check(jy, ty, 4, tdt)


def test_fused_repvgg_equals_unfused_under_float32(monkeypatch):
    """One parameter set, both forms, fp32: equal up to reassociation. The
    fused kernel is kept until a parameter changes in place."""
    block = trtdetr.CSPRepLayer(32, 48, 32, 3).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in block.state_dict().items():
            vals = torch.randn(t.shape, generator=gen) * 0.5
            t.copy_(vals.abs() + 0.5 if t.dim() == 1 else vals)
    x = torch.randn((2, 32, 16, 16), generator=gen)
    with torch.no_grad():
        monkeypatch.setenv("SPOTTER_TPU_REP_FUSE", "0")
        unfused = block(x)
        monkeypatch.setenv("SPOTTER_TPU_REP_FUSE", "1")
        fused = block(x)
        scale = unfused.abs().max().item()
        torch.testing.assert_close(fused, unfused, rtol=0, atol=1e-5 * max(scale, 1.0))
        block.bottleneck0.conv2.bn.weight.mul_(2.0)  # an in-place change refuses the cache
        monkeypatch.setenv("SPOTTER_TPU_REP_FUSE", "0")
        unfused2 = block(x)
        monkeypatch.setenv("SPOTTER_TPU_REP_FUSE", "1")
        torch.testing.assert_close(block(x), unfused2, rtol=0, atol=1e-5 * max(scale, 1.0))
    assert not torch.equal(unfused, unfused2)


def test_fused_and_unfused_blocks_hold_the_same_state_dict(monkeypatch):
    monkeypatch.setenv("SPOTTER_TPU_REP_FUSE", "1")
    block = trtdetr.RepVggBlock(8, dtype=torch.bfloat16)
    with torch.no_grad():
        block(torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16))
    assert set(block.state_dict()) == {
        f"conv{i}.{p}" for i in (1, 2) for p in (
            "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")}


@pytest.mark.parametrize("dtype_env,fuse_env", [
    ("bfloat16", None), ("float32", None), ("mixed", None), (None, None), ("bf16", None),
    ("mixed", "1"), ("bfloat16", "0"), ("float32", "yes"),
])
def test_rep_fuse_default_follows_policy(monkeypatch, dtype_env, fuse_env):
    """The JAX package's table (tests/test_rep_fuse.py): the env var wins,
    else fuse exactly under a bf16 compute dtype ("bfloat16"; "mixed" keeps
    the encoder fp32). The port reads it per block from the block's dtype,
    which the zoo takes from the same policy."""
    for name, val in ((DTYPE_ENV, dtype_env), ("SPOTTER_TPU_REP_FUSE", fuse_env)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    want = jrtdetr._rep_fuse_default()
    assert trtdetr.rep_fuse_default() is want
    from spotter_tpu_torch.utils.precision import compute_dtype

    assert trtdetr.rep_fuse_default(compute_dtype()) is want


def test_use_exact_float32_sets_the_three_switches(monkeypatch):
    """The engine's switches on every card: no TF32 in fp32 matmuls or
    convolutions, and bf16 matmuls summed in fp32 (no reduced-precision
    reductions), as the JAX package's policies compute."""
    from spotter_tpu_torch.utils.precision import use_exact_float32

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    for mod, flag in ((matmul, "allow_tf32"), (cudnn, "allow_tf32"),
                      (matmul, "allow_bf16_reduced_precision_reduction")):
        monkeypatch.setattr(mod, flag, True)
    use_exact_float32()
    assert not matmul.allow_tf32 and not cudnn.allow_tf32
    assert not matmul.allow_bf16_reduced_precision_reduction


def test_folded_pairs_follow_modules_moved_under_inference_mode():
    """A module whose buffers were made under torch.inference_mode (moved to
    a device there) has no version counters: the folded BN pair and the
    fused RepVGG kernel are then recomputed every call, and still right."""
    block = trtdetr.RepVggBlock(8).eval()
    x = torch.randn((1, 8, 6, 6), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = block.conv1(x) + block.conv2(x)
    with torch.inference_mode():
        moved = block.to(torch.float64).to(torch.float32)  # new (inference) buffers
        assert moved.conv1.bn.weight.is_inference()
        first = moved.conv1(x)
        got = first + moved.conv2(x)
        moved.conv1.bn.weight.mul_(2.0)
        again = moved.conv1(x)
    torch.testing.assert_close(got, want)
    assert moved.conv1.bn._folded[0] is None
    assert not torch.equal(again, first)
