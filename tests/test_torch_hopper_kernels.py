"""The port's two tensor-core kernels on the card: the bf16 attention kernel
(`ops.attention.flash_attn_bf16`, wgmma fed by TMA) and the int8 GEMM
(`tools.bench_int8.int8_gemm`, a transpose pass, then wgmma fed by TMA),
each against its plain version; and, on the CPU, the transpose pass's plain
path, the GEMM's input checks and the bf16-P rounding study
(`tools.attention_rounding`) behind the attention kernel's split P.

This file imports torch and the port only, so the `cuda` tests run on a
machine with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_hopper_kernels.py

bf16 attention: against the plain version run in fp32 on the same bf16
inputs and rounded to bf16, within 2**-8 of the largest output (one bf16
ulp). The kernel sums in fp32 and rounds its output once; its P is two bf16
terms (P = P_hi + P_lo), so it sits about one output rounding away from fp32
arithmetic. The int8 GEMM and the transpose are exact.
"""

import numpy as np
import pytest
import torch

from spotter_tpu_torch.ops import attention as tattn
from spotter_tpu_torch.tools import bench_int8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _qkv(b, s, h, hd, device, seed=0, logit_scale=2.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, hd)) * logit_scale * hd**-0.5).astype(np.float32)
    k = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return [torch.from_numpy(a).to(device).to(torch.bfloat16) for a in (q, k, v)]


def _bf16_attention_error(shape):
    q, k, v = _qkv(*shape, _card())
    got = tattn.flash_attn_bf16(q, k, v)
    want = tattn.self_attention_reference(q.float(), k.float(), v.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    return err, 2**-8 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4301, 12, 64), (2, 4301, 12, 64), (1, 3601, 12, 64),
                                   (2, 3601, 12, 64)])
def test_flash_attn_bf16_at_the_served_shapes(shape):
    """yolos-base (S = 4301) and OWLv2 (S = 3601), 12 heads of 64."""
    err, atol = _bf16_attention_error(shape)
    assert err <= atol, (shape, err, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1025, 12, 64), (2, 1025, 2, 128), (1, 1100, 2, 128),
                                   (2, 4301, 6, 128)])
def test_flash_attn_bf16_partial_tiles_and_hd_128(shape):
    """S = 1025: one real key and one real query row in the last tiles."""
    err, atol = _bf16_attention_error(shape)
    assert err <= atol, (shape, err, atol)


@pytest.mark.cuda
def test_flash_attn_bf16_takes_views_of_a_qkv_projection():
    """(B, S, H, hd) views of a (B, S, 3, H, hd) projection, as the ViT layers
    pass them: strides (S * 3H * hd, 3H * hd, hd)."""
    device = _card()
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 1100, 3, 4, 64)).astype(np.float32) * 0.25)
    qkv = qkv.to(device).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = tattn.flash_attn_bf16(q, k, v)
    want = tattn.self_attention_reference(q.float(), k.float(), v.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2**-8 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("mnk", [(16, 48, 32), (4000, 4000, 4000), (144, 4096, 272)])
def test_int8_gemm_is_exact_on_the_card(mnk):
    m, n, k = mnk
    device = _card()
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(device)
    b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(device)
    before = bench_int8.int8_gemm.launches
    got = bench_int8.int8_gemm(a, b)
    want = bench_int8.int8_gemm_reference(a, b)
    assert torch.equal(bench_int8.transpose_s8(b), b.t().contiguous())
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bench_int8.int8_gemm.launches == before + 1


def test_transpose_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    b_np = rng.integers(-128, 128, (48, 32), dtype=np.int8)
    before = bench_int8.transpose_s8.launches
    got = bench_int8.transpose_s8(torch.from_numpy(b_np))
    assert got.is_contiguous() and np.array_equal(got.numpy(), b_np.T)
    assert bench_int8.transpose_s8.launches == before
    with pytest.raises(TypeError, match="int8"):
        bench_int8.transpose_s8(torch.zeros((16, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        bench_int8.transpose_s8(torch.zeros((16, 16), dtype=torch.int8, device="meta"))


@pytest.mark.parametrize("shapes", [[(16, 40)], [(16, 32), (24, 16)], [(0, 16)]])
def test_gemm_kernel_input_checks_want_multiples_of_16(shapes):
    tensors = [torch.zeros(s, dtype=torch.int8) for s in shapes]
    with pytest.raises(ValueError, match="multiple of 16"):
        bench_int8._check_kernel_operands("int8_gemm", *tensors)


def test_gemm_kernel_input_checks_want_contiguous_aligned_operands():
    bench_int8._check_kernel_operands("int8_gemm", torch.zeros((32, 16), dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        bench_int8._check_kernel_operands("int8_gemm",
                                          torch.zeros((32, 32), dtype=torch.int8)[:, :16])
    offset = torch.zeros(32 * 16 + 8, dtype=torch.int8)[8:].view(32, 16)  # 8 bytes in
    with pytest.raises(ValueError, match="16-byte aligned"):
        bench_int8._check_kernel_operands("int8_gemm", offset)


def test_attention_rounding_splitting_p_cuts_the_error():
    """The design check behind the bf16 kernel's split P, at a small shape:
    P as two bf16 terms stays closer to the exact softmax than one term."""
    from spotter_tpu_torch.tools import attention_rounding

    rec = attention_rounding.shape_errors((1, 200, 2, 64), seed=0, tile=64)
    assert rec["split_err_of_max_out"] < rec["single_err_of_max_out"] <= 2 * rec["gate"]
