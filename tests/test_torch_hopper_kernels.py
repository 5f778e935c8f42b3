"""The port's kernels redesigned for the H100, on the card: the bf16 and
fp32 attention kernels (`ops.attention.flash_attn_bf16`, and
`flash_attn_fp32` with its K/V split pass `split_kv_tf32`: wgmma fed by
TMA), the int8 GEMM (`tools.bench_int8.int8_gemm`, a transpose pass, then
wgmma fed by TMA), the separable MSDA sampling kernel
(`ops.msda.msda_sep_sum`), the lane-gather kernel (`msda_hd_gather_sum`,
reading the value rows in place), and the three kernels of one walk that
read the value (B, S, H, hd) in place: the gather-sum (`msda_gather_sum`),
the loc kernel (`msda_loc_sum`, loc and attn read in place too) and the
fused kernel (`msda_fused_sum`, a register-blocked prologue), each against
its plain version (the loc and gather-sum kernels also against each other,
bit for bit); the class-logit kernel (`ops.openvocab.owl_class_logits`,
split-TF32 wgmma fed by TMA; repeated launches bit equal) and the one-hot
tile probe (`tools.bench_pack_probe.pack_tile`, all eight variants bit for
bit, the fp32 base and hoist with no select in their SASS, the base variants
reading idx and w in every chain); and, on the CPU, the fused
wrapper's plain path, the transpose and split passes' plain paths, the
GEMM's input checks, the fp32 kernel's key order, the class-logit kernel's
column order, and the rounding studies (`tools.attention_rounding`,
`tools.class_logits_rounding`) behind the bf16 kernel's split P and the
split TF32 of the fp32 attention and class-logit kernels.

This file imports torch and the port only, so the `cuda` tests run on a
machine with a card and no JAX:

    python -m pytest -m cuda tests/test_torch_hopper_kernels.py

bf16 attention: against the plain version run in fp32 on the same bf16
inputs and rounded to bf16, within 2**-8 of the largest output (one bf16
ulp). The kernel sums in fp32 and rounds its output once; its P is two bf16
terms (P = P_hi + P_lo), so it sits about one output rounding away from fp32
arithmetic. fp32 attention: against float64 arithmetic on the same inputs,
within 2e-5 of the largest output, the fp32 gate of chip_smoke.py; its
products are split TF32 (~2**-21 relative), its sums fp32. The int8 GEMM,
the transpose and the split pass are exact. The sep kernel: within 1e-5,
the MSDA gate (sums of at most 16 weighted standard-normal values in
fp32, in the plain version's order). The gather-sum and loc kernels: within
1e-5 in fp32 and one bf16 ulp of the largest output for bf16 rows (both
sides sum the same fp32 products of up to 128 terms in another order). The lane gather sums in the value's
dtype in its plain version's order: equal bit for bit in fp32, within one
bf16 ulp of the largest output in bf16. The fused kernel: within 1e-5 under
both methods; its prologue sums as the plain version does, so the discrete
method's nearest cells agree and every row is compared. The class-logit
kernel: within 1e-5 of the largest unmasked logit (chip_smoke.py's gate;
two TF32 terms of each operand put it ~3e-7 away), masked columns NEG_INF bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from spotter_tpu_torch.ops import attention as tattn
from spotter_tpu_torch.ops import msda as tmsda
from spotter_tpu_torch.ops import openvocab
from spotter_tpu_torch.tools import (
    attention_rounding,
    bench_int8,
    bench_pack_probe,
    class_logits_rounding,
)


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
    rec = attention_rounding.shape_errors((1, 200, 2, 64), seed=0, tile=64)
    assert rec["split_err_of_max_out"] < rec["single_err_of_max_out"] <= 2 * rec["gate"]


# --- fp32 attention: split TF32 ------------------------------------------------

FP32_RTOL = 2e-5  # of the largest output: chip_smoke.py's fp32 gate


def _qkv32(b, s, h, hd, device, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, hd)) * 2.0 * hd**-0.5).astype(np.float32)
    k = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, k, v)]


def _fp32_attention_error(q, k, v):
    before = (tattn.flash_attn_fp32.launches, tattn.split_kv_tf32.launches)
    got = tattn.flash_attn_fp32(q, k, v)
    want = tattn.self_attention_reference(q.double(), k.double(), v.double())
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape and got.is_contiguous()
    assert (tattn.flash_attn_fp32.launches, tattn.split_kv_tf32.launches) == (
        before[0] + 1, before[1] + 1)
    err = (got.double() - want).abs().max().item()
    return err, FP32_RTOL * want.abs().max().item()


@pytest.mark.parametrize("shape", [(1, 200, 2, 64), (1, 130, 1, 128)])
def test_attention_rounding_fp32_needs_three_tf32_terms(shape):
    """The design check behind the fp32 kernel's split: three TF32 passes in
    both products stay under half the fp32 gate, and one term in each fails
    it visibly (as does any combination with fewer than three)."""
    rec = attention_rounding.fp32_shape_errors(shape, seed=0)
    assert rec["cheapest_under_half_gate"] == [3, 3]
    assert rec["qk3_pv3_err_of_max_out"] < rec["gate"] / 2
    assert rec["qk1_pv1_err_of_max_out"] > 5 * rec["gate"]
    assert all(rec[f"qk{a}_pv{b}_err_of_max_out"] > rec["gate"] / 2
               for a in (1, 2, 3) for b in (1, 2, 3) if (a, b) != (3, 3))


def test_tf32_split_rounds_to_nearest_ties_away_and_rebuilds_exactly():
    """hi is cvt.rna.tf32.f32 (the low 13 bits cleared, ties away from zero)
    and hi + lo is x, bit for bit."""
    ulp = 2.0**-10  # of TF32 in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23, 1 + 1.5 * ulp,
                      3.0e-30, -7.25, 0.0], dtype=torch.float32)
    hi, lo = tattn.tf32_split(x)
    want_hi = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp]
    assert hi[:4].tolist() == want_hi
    assert hi[5].item() == -7.25 and lo[5].item() == 0.0 and hi[6].item() == 0.0
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096))
                         .astype(np.float32))
    hi, lo = tattn.tf32_split(x)
    assert not (hi.view(torch.int32) & ((1 << tattn.TF32_DROP_BITS) - 1)).any()
    assert torch.equal(hi + lo, x)
    assert ((lo.abs() <= x.abs() * 2.0**-11)).all()
    with pytest.raises(TypeError, match="float32"):
        tattn.tf32_split(x.double())


@pytest.mark.parametrize("shape", [(2, 13, 3, 64), (1, 40, 2, 128)])
def test_split_pass_plain_version_rebuilds_k_and_permuted_v(shape):
    """The split pass's plain version (the wrapper's CPU path, which counts
    no launch): k_hi + k_lo is k (B*H, S, hd) bit for bit; vᵀ_hi + vᵀ_lo is
    vᵀ with the keys of each group of 8 in VT_KEY_ORDER, zero past S."""
    b, s, h, hd = shape
    _, k, v = _qkv32(*shape, "cpu", seed=5)
    before = tattn.split_kv_tf32.launches
    k_hi, k_lo, vt_hi, vt_lo = tattn.split_kv_tf32(k, v)
    assert tattn.split_kv_tf32.launches == before
    s_pad = -(-s // 8) * 8
    assert k_hi.shape == (b * h, s, hd) and vt_hi.shape == (b * h, hd, s_pad)
    assert all(t.is_contiguous() for t in (k_hi, k_lo, vt_hi, vt_lo))
    assert torch.equal(k_hi + k_lo, k.permute(0, 2, 1, 3).reshape(b * h, s, hd))
    vt = (vt_hi + vt_lo).reshape(b, h, hd, s_pad)
    for pos in range(s_pad):
        key = pos // 8 * 8 + tattn.VT_KEY_ORDER[pos % 8]
        want = v[:, key].permute(1, 2, 0) if key < s else torch.zeros(h, hd, b)
        assert torch.equal(vt[:, :, :, pos].permute(1, 2, 0), want), pos
    with pytest.raises(TypeError, match="float32"):
        tattn.split_kv_tf32(k, v.double())
    with pytest.raises(ValueError, match="not v"):
        tattn.split_kv_tf32(k, v.to("meta"))


def test_attention_through_the_split_terms_in_vt_key_order_equals_plain():
    """The kernel's bookkeeping replayed on the CPU: scores from k's terms,
    the softmax, P with its keys of each group of 8 taken in VT_KEY_ORDER
    (as a thread's accumulator columns 2t, 2t + 1 become A-fragment columns
    t, t + 4), times vᵀ's terms, equals plain attention (both in float64:
    the terms rebuild k and v exactly); P in the natural key order against
    the same vᵀ does not."""
    b, s, h, hd = 1, 45, 2, 64
    q, k, v = _qkv32(b, s, h, hd, "cpu", seed=6)
    k_hi, k_lo, vt_hi, vt_lo = tattn.split_kv_reference(k, v)
    s_pad = vt_hi.shape[-1]
    keys = torch.tensor([p // 8 * 8 + tattn.VT_KEY_ORDER[p % 8] for p in range(s_pad)])
    q64, k64, v64 = (t.permute(0, 2, 1, 3).reshape(b * h, s, hd).double() for t in (q, k, v))
    want = torch.softmax(q64 @ k64.transpose(1, 2), -1) @ v64
    scores = q64 @ (k_hi + k_lo).double().transpose(1, 2)
    p = torch.nn.functional.pad(torch.softmax(scores, -1), (0, s_pad - s))  # keys past S: 0
    vt = (vt_hi + vt_lo).double()
    got = p[:, :, keys] @ vt.transpose(1, 2)
    assert (got - want).abs().max().item() <= 1e-12
    unordered = p @ vt.transpose(1, 2)
    assert (unordered - want).abs().max().item() > 1e-2


def test_fp32_wrapper_cpu_path_is_the_plain_version():
    q, k, v = _qkv32(1, 30, 2, 64, "cpu", seed=7)
    before = (tattn.flash_attn_fp32.launches, tattn.split_kv_tf32.launches)
    got = tattn.flash_attn_fp32(q, k, v)
    assert torch.equal(got, tattn.self_attention_reference(q, k, v))
    assert (tattn.flash_attn_fp32.launches, tattn.split_kv_tf32.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4301, 12, 64), (2, 4301, 12, 64), (1, 3601, 12, 64),
                                   (2, 3601, 12, 64)])
def test_flash_attn_fp32_at_the_served_shapes(shape):
    """yolos-base (S = 4301) and OWLv2 (S = 3601), 12 heads of 64."""
    err, atol = _fp32_attention_error(*_qkv32(*shape, _card()))
    assert err <= atol, (shape, err, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1025, 12, 64), (1, 1100, 2, 128), (2, 1025, 2, 128)])
def test_flash_attn_fp32_partial_tiles_and_hd_128(shape):
    """S = 1025: one real key and one real query row in the last tiles."""
    err, atol = _fp32_attention_error(*_qkv32(*shape, _card()))
    assert err <= atol, (shape, err, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attn_fp32_takes_views_of_a_qkv_projection(hd):
    """(B, S, H, hd) views of a (B, S, 3, H, hd) projection, as the ViT layers
    pass them: strides (S * 3H * hd, 3H * hd, hd)."""
    rng = np.random.default_rng(8)
    qkv = torch.from_numpy(rng.standard_normal((2, 1100, 3, 4, hd)).astype(np.float32) * 0.25)
    qkv = qkv.to(_card())
    err, atol = _fp32_attention_error(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    assert err <= atol, (hd, err, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1025, 3, 64), (1, 4301, 12, 64), (1, 1100, 2, 128)])
def test_split_pass_equals_its_plain_version_on_the_card(shape):
    device = _card()
    _, k, v = _qkv32(*shape, device, seed=9)
    qkv = torch.stack([k, k, v], dim=2)  # views with a projection's strides too
    for kk, vv in ((k, v), (qkv[:, :, 0], qkv[:, :, 2])):
        got = tattn.split_kv_tf32(kk, vv)
        want = tattn.split_kv_reference(kk, vv)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)


# --- msda_sep_sum, redesigned ----------------------------------------------------

def _sep_level(lh, lw, q, b, h, hd, points, seed, method="default", encoder=False):
    """One level's rows and sep operands; encoder-like queries sample around
    their own cells (row-major over the level), others anywhere in [-0.2, 1.2]."""
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.standard_normal((b * h, lh * lw, hd)).astype(np.float32))
    if encoder:
        iy, ix = np.divmod(np.arange(q) % (lh * lw), lw)
        ref = np.stack([(ix + 0.5) / lw, (iy + 0.5) / lh], -1)[None, :, None, None, :]
        loc = ref + 0.02 * rng.standard_normal((b, q, h, points, 2))
    else:
        loc = rng.uniform(-0.2, 1.2, (b, q, h, points, 2))
    logits = rng.standard_normal((b, q, h, points))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    loc_t, attn_t = (torch.from_numpy(a.astype(np.float32)) for a in (loc, attn))
    ops, mask, r_band = tmsda.sep_level_operands(loc_t, attn_t, lh, lw, method)
    return rows, ops, mask, r_band


def _sep_on_card(rows, ops, mask, r_band, hw, points, rows_dtype=torch.float32):
    dev = _card()
    rows = rows.to(rows_dtype)
    before = tmsda.msda_sep_sum.launches
    got = tmsda.msda_sep_sum(rows.to(dev), *(o.to(dev) for o in ops), mask.to(dev), hw, r_band,
                             points)
    want = tmsda.msda_sep_reference(rows, *ops, mask, hw, r_band, points)
    torch.cuda.synchronize()
    assert tmsda.msda_sep_sum.launches == before + 1
    return (got.cpu() - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 32, 6])
@pytest.mark.parametrize("lw", [11, 130])
@pytest.mark.parametrize("points", [3, 4, 5])
def test_sep_kernel_odd_shapes_on_card(hd, lw, points):
    """Partial tiles (Q = 70), fewer or more points than the kernel loads at
    once (4), hd a multiple of 4 or not (scalar loads), 4-row bands (W > 128),
    half the hit table's bits cleared (which must still change the output)."""
    rows, ops, mask, r_band = _sep_level(9, lw, 70, 2, 2, hd, points, seed=hd + lw + points)
    hw = (9, lw)
    assert _sep_on_card(rows, ops, mask, r_band, hw, points) <= 1e-5
    cleared = mask * torch.from_numpy(
        (np.random.default_rng(14).uniform(size=mask.shape) < 0.5).astype(np.int32))
    assert _sep_on_card(rows, ops, cleared, r_band, hw, points) <= 1e-5
    full = tmsda.msda_sep_reference(rows, *ops, mask, hw, r_band, points)
    dropped = tmsda.msda_sep_reference(rows, *ops, cleared, hw, r_band, points)
    assert (full - dropped).abs().max().item() > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
def test_sep_kernel_at_a_deformable_detr_encoder_level_on_card(rows_dtype):
    """Deformable-DETR's third encoder level at the 1333x1333 bucket (42 x 42,
    8 heads of 32, 4 points), 1,800 queries (not a multiple of 64) sampling
    around their own cells, fp32 and bf16 rows."""
    lh = lw = 42
    rows, ops, mask, r_band = _sep_level(lh, lw, 1800, 1, 8, 32, 4, seed=16, encoder=True)
    assert _sep_on_card(rows, ops, mask, r_band, (lh, lw), 4, rows_dtype) <= 1e-5


# --- msda_hd_gather_sum and msda_fused_sum, redesigned --------------------------

# Deformable-DETR's levels at the 1333x1333 bucket (37,150 tokens) and
# RT-DETR's decoder levels at 640x640 (8,400)
DDETR_LEVELS = ((167, 167), (84, 84), (42, 42), (21, 21))
RTDETR_LEVELS = ((80, 80), (40, 40), (20, 20))


def _samples(levels, q, h, points, rng, b=1, spread=0.05):
    """(B, Q, H, LP, 2) sample points and softmaxed (B, Q, H, LP) attention:
    Q equal to the token count samples as an encoder does (each token around
    its own cell, tokens level-major and row-major), other Q anywhere in
    [-spread, 1 + spread]."""
    lp = len(levels) * points
    if q == sum(a * b for a, b in levels):
        cells = []
        for lh, lw in levels:
            iy, ix = np.divmod(np.arange(lh * lw), lw)
            cells.append(np.stack([(ix + 0.5) / lw, (iy + 0.5) / lh], -1))
        ref = np.concatenate(cells)[None, :, None, None, :]
        loc = ref + 0.02 * rng.standard_normal((b, q, h, lp, 2))
    else:
        loc = rng.uniform(-spread, 1 + spread, (b, q, h, lp, 2))
    logits = rng.standard_normal((b, q, h, lp))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (torch.from_numpy(a.astype(np.float32)) for a in (loc, attn))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [24, 32, 64])
@pytest.mark.parametrize("q", [300, 37150])
def test_hd_gather_kernel_reads_value_rows_in_place_on_card(q, hd, dtype):
    """B = 1, Deformable-DETR's levels, 8 heads of 4 points a level: its
    decoder's 300 queries and its encoder's 37,150 (neither a multiple of
    the 64-query tile), value (B, S, H, hd) in fp32 and bf16."""
    dev = _card()
    rng = np.random.default_rng(q + hd)
    s, h, points = sum(a * b for a, b in DDETR_LEVELS), 8, 4
    lp = len(DDETR_LEVELS) * points
    loc, attn = _samples(DDETR_LEVELS, q, h, points, rng)
    idx, w = (t.to(dev) for t in tmsda.prepare_msda_gather_lanes(loc, attn, DDETR_LEVELS, points))
    value = torch.from_numpy(rng.standard_normal((1, s, h, hd)).astype(np.float32)).to(dev, dtype)
    before = tmsda.msda_hd_gather_sum.launches
    got = tmsda.msda_hd_gather_sum(value, idx, w, lp, q)
    want = tmsda.msda_hd_gather_reference(value, idx, w, lp, q)
    torch.cuda.synchronize()
    assert tmsda.msda_hd_gather_sum.launches == before + 1
    assert got.shape == (1, q, h, hd) and got.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(got, want), (got - want).abs().max().item()
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0**-7 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hd_gather_kernel_skips_planted_bad_indices_and_zero_weights_on_card(dtype):
    """Indices S + 3 and -5 and zero weights planted through idx/w (Q = 300,
    hd = 32): the kernel loads none of those rows, so it equals the plain
    version bit for bit, and equals the sum with the bad terms pointed at
    row 0 with weight 0."""
    dev = _card()
    rng = np.random.default_rng(31)
    q, hd, s, h, points = 300, 32, sum(a * b for a, b in DDETR_LEVELS), 8, 4
    lp = len(DDETR_LEVELS) * points
    loc, attn = _samples(DDETR_LEVELS, q, h, points, rng)
    idx, w = (t.to(dev) for t in tmsda.prepare_msda_gather_lanes(loc, attn, DDETR_LEVELS, points))
    idx.view(-1)[::7] = s + 3
    idx.view(-1)[3::11] = -5
    w.view(-1)[5::13] = 0.0
    off = (idx < 0) | (idx >= s)
    value = torch.from_numpy(rng.standard_normal((1, s, h, hd)).astype(np.float32)).to(dev, dtype)
    got = tmsda.msda_hd_gather_sum(value, idx, w, lp, q)
    want = tmsda.msda_hd_gather_reference(value, idx, w, lp, q)
    cleared = tmsda.msda_hd_gather_sum(value, torch.where(off, 0, idx),
                                       torch.where(off, 0.0, w), lp, q)
    torch.cuda.synchronize()
    assert torch.equal(got, cleared)
    if dtype == torch.float32:
        assert torch.equal(got, want), (got - want).abs().max().item()
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0**-7 * want.float().abs().max().item(), err


def _fused_operands(q, hd, seed, rows_dtype=torch.float32, h=8, points=4, d=256):
    """RT-DETR decoder operands at B = 1: the value (1, S, H, hd), hidden
    states (1, Q, D), per-head projections, anchors and level tables."""
    dev = _card()
    rng = np.random.default_rng(seed)
    s = sum(a * b for a, b in RTDETR_LEVELS)
    lp = len(RTDETR_LEVELS) * points

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    value = randn(1, s, h, hd).to(rows_dtype)
    hs = randn(1, q, d)
    ref = torch.from_numpy(np.concatenate(
        [rng.uniform(0.05, 0.95, (1, q, 2)), rng.uniform(0.05, 0.5, (1, q, 2))], -1
    ).astype(np.float32)).to(dev)
    heads = tmsda.fused_head_weights(randn(d, h * lp * 2, scale=d**-0.5), randn(h * lp * 2, scale=0.1),
                                     randn(d, h * lp, scale=d**-0.5), randn(h * lp, scale=0.1), h)
    base, scale = tmsda.fused_anchors(ref, lp, points, 0.5)
    tables = tmsda.level_tables(RTDETR_LEVELS, points, dev, torch.float32)
    return (value, hs, *heads, base, scale, *tables)


def _fused_error(args, method):
    before = tmsda.msda_fused_sum.launches
    got = tmsda.msda_fused_sum(*args, method)
    want = tmsda.msda_fused_sum_plain(*args, method)
    torch.cuda.synchronize()
    assert tmsda.msda_fused_sum.launches == before + 1
    assert got.shape == want.shape
    return (got - want).abs().max().item()  # every row, discrete included


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["default", "discrete"])
@pytest.mark.parametrize("hd", [24, 32, 64])
@pytest.mark.parametrize("q", [300, 37150])
def test_fused_kernel_on_card(q, hd, method):
    """RT-DETR's decoder sampling at B = 1 (D = 256, 8 heads, LP = 12),
    Q = 300 and 37,150 (ragged last tiles), hd 24, 32 and 64."""
    assert _fused_error(_fused_operands(q, hd, seed=q + hd), method) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_fused_kernel_bf16_rows_on_card(method):
    args = _fused_operands(300, 32, seed=5, rows_dtype=torch.bfloat16)
    assert _fused_error(args, method) <= 1e-5


def _tiny_fused_args(lp_points=2, seed=7):
    rng = np.random.default_rng(seed)
    h, d, q, s, hd = 2, 16, 9, 30, 8
    points = lp_points
    value = torch.from_numpy(rng.standard_normal((1, s, h, hd)).astype(np.float32))
    hs = torch.from_numpy(rng.standard_normal((1, q, d)).astype(np.float32))
    ref = torch.from_numpy(rng.uniform(0.1, 0.9, (1, q, 4)).astype(np.float32))
    heads = tmsda.fused_head_weights(
        *(torch.from_numpy(rng.standard_normal(sh).astype(np.float32) * 0.2)
          for sh in ((d, h * points * 2), (h * points * 2,), (d, h * points), (h * points,))), h)
    base, scale = tmsda.fused_anchors(ref, points, points, 0.5)
    tables = tmsda.level_tables(((5, 6),), points, torch.device("cpu"), torch.float32)
    return (value, hs, *heads, base, scale, *tables)


@pytest.mark.parametrize("lp_points", [1, 2])
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_fused_wrapper_cpu_path_is_the_plain_version(method, lp_points):
    """A CPU tensor takes the plain version and counts no launch."""
    args = _tiny_fused_args(lp_points)
    before = tmsda.msda_fused_sum.launches
    got = tmsda.msda_fused_sum(*args, method)
    assert got.shape == (1, 9, 2, 8)
    assert torch.equal(got, tmsda.msda_fused_sum_plain(*args, method))
    assert tmsda.msda_fused_sum.launches == before


# --- msda_gather_sum and msda_loc_sum: one walk with msda_fused_sum -----------

# (hd, Q, levels, points a level, heads): every hd of 6 (scalar path), 8, 24,
# 32 and 64, Q of 1, 33 (a ragged 32-query tile), 300 and 37,150 (the
# Deformable-DETR encoder), LP = levels x points of 1, 12, 16 and 32
WALK_CASES = [
    (6, 1, ((5, 7),), 1, 2),
    (8, 33, RTDETR_LEVELS, 4, 3),
    (24, 300, DDETR_LEVELS, 4, 8),
    (32, 37150, DDETR_LEVELS, 4, 8),
    (64, 300, DDETR_LEVELS, 8, 2),
    (32, 33, DDETR_LEVELS, 8, 8),
]


def _walk_operands(hd, q, levels, points, h, dtype, method, b=2, seed=0):
    """The value (B, S, H, hd) in `dtype`, loc/attn as the model holds them
    (a quarter of the samples outside [0, 1]: out-of-range corners), the
    level tables, and idx/w (B*H, Q, J) from the corner prep with indices
    S + 3 and -5 planted (the kernel must skip them)."""
    dev = _card()
    rng = np.random.default_rng(seed + hd + q)
    s = sum(a * c for a, c in levels)
    loc, attn = _samples(levels, q, h, points, rng, b=b, spread=0.3)
    loc, attn = loc.to(dev), attn.to(dev)
    value = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32)).to(dev, dtype)
    tables = tmsda.level_tables(levels, points, dev, torch.float32)
    idx, w = tmsda.prepare_msda_gather(loc, attn, levels, points, method)
    idx.view(-1)[::7] = s + 3
    idx.view(-1)[3::11] = -5
    return value, loc, attn, tables, idx, w


def _walk_tolerance(want, dtype):
    """1e-5 in fp32; one bf16 ulp of the largest output for bf16 rows."""
    return 1e-5 if dtype == torch.float32 else 2.0**-8 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["default", "discrete"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,q,levels,points,h", WALK_CASES)
def test_gather_and_loc_kernels_read_the_model_layout_on_card(hd, q, levels, points, h, dtype,
                                                              method):
    """Rows 1 and 2 against their plain versions at B = 2 (the value, loc and
    attn read in place, the output (B, Q, H, hd)), one launch each."""
    value, loc, attn, tables, idx, w = _walk_operands(hd, q, levels, points, h, dtype, method)
    before = (tmsda.msda_gather_sum.launches, tmsda.msda_loc_sum.launches)
    got_g = tmsda.msda_gather_sum(value, idx, w)
    got_l = tmsda.msda_loc_sum(value, loc, attn, *tables, method)
    cpu = [t.cpu() for t in (value, loc, attn, *tables, idx, w)]
    want_g = tmsda.msda_gather_sum_plain(cpu[0], *cpu[6:])
    want_l = tmsda.msda_loc_sum_plain(*cpu[:6], method)
    torch.cuda.synchronize()
    assert (tmsda.msda_gather_sum.launches, tmsda.msda_loc_sum.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    for got, want in ((got_g, want_g), (got_l, want_l)):
        assert got.shape == (2, q, h, hd) and got.dtype == torch.float32
        err = (got.cpu() - want).abs().max().item()
        assert err <= _walk_tolerance(want, dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_loc_kernel_equals_gather_kernel_bit_for_bit_on_card(method):
    """On one set of samples (RT-DETR's decoder levels, B = 2, 8 heads of 32)
    the loc kernel's corners are the corner prep's, and both kernels walk
    them alike: equal outputs in fp32, bit for bit."""
    value, loc, attn, tables, _, _ = _walk_operands(32, 300, RTDETR_LEVELS, 4, 8,
                                                    torch.float32, method)
    idx, w = tmsda.prepare_msda_gather(loc, attn, RTDETR_LEVELS, 4, method)
    got_l = tmsda.msda_loc_sum(value, loc, attn, *tables, method)
    got_g = tmsda.msda_gather_sum(value, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(got_l, got_g), (got_l - got_g).abs().max().item()


# --- owl_class_logits: split TF32 on the tensor cores, fed by TMA -------------

CLASS_LOGITS_RTOL = 1e-5  # of the largest unmasked logit: chip_smoke.py's gate


def _class_logits_args(b, p, dt, q, n_masked, dtype, device, seed=0):
    img, bank, shift, scale = class_logits_rounding.logit_inputs((b, p, dt, q), seed, dtype)
    mask = None
    if n_masked:
        mask = torch.ones(q, dtype=torch.int32)
        mask[q - n_masked:] = 0
    return [None if t is None else t.to(device) for t in (img, bank, shift, scale, mask)]


def _class_logits_check(args, n_masked):
    """The kernel against its plain version on the same inputs: within the
    gate on the unmasked columns, masked columns NEG_INF bit for bit, one
    launch."""
    q = args[1].shape[0]
    before = openvocab.owl_class_logits.launches
    got = openvocab.owl_class_logits(*args)
    want = openvocab.class_logits_reference(*args)
    torch.cuda.synchronize()
    assert openvocab.owl_class_logits.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    real = slice(0, q - n_masked)
    err = (got[..., real] - want[..., real]).abs().max().item()
    atol = CLASS_LOGITS_RTOL * want[..., real].abs().max().item()
    assert err <= atol, (err, atol)
    assert (got[..., q - n_masked:] == openvocab.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt", [512, 100])
@pytest.mark.parametrize("q,n_masked", [(22, 0), (24, 2), (160, 0)])
@pytest.mark.parametrize("p", [3600, 576])
@pytest.mark.parametrize("b", [1, 8])
def test_owl_class_logits_on_card(b, p, q, n_masked, dt, dtype):
    """OWLv2 (P = 3600) and OWL-ViT B/32 (576) at B = 1 and 8: 56.25 tiles of
    64 rows at B = 1, fewer tiles than SMs at P = 576; the default
    vocabulary, a request's 24 with 2 masked, 160 (query tiles of 40); the
    text width 512 and 100 (a partial slab; bf16 rows 200 bytes apart, so
    the wrapper widens them to fp32 for TMA)."""
    _class_logits_check(_class_logits_args(b, p, dt, q, n_masked, dtype, _card()), n_masked)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt,q,n_masked", [(520, 22, 0), (1024, 22, 3), (1024, 160, 0),
                                           (256, 5, 1), (4, 41, 0)])
def test_owl_class_logits_query_tiles_and_widths_on_card(dt, q, n_masked, dtype):
    """Dt 520 (bf16 by TMA, a partial 64-column slab; fp32 an odd slab
    count), 1024 (the narrower query tiles that fit beside the ring), 4;
    Q 5 (one tile of 8) and 41 (two tiles of 40, the second of 1 query);
    577 rows (a ragged last tile)."""
    _class_logits_check(_class_logits_args(1, 577, dt, q, n_masked, dtype, _card()), n_masked)


@pytest.mark.cuda
def test_owl_class_logits_bf16_off_16_byte_alignment_on_card():
    """A bf16 img that starts 8 bytes past a 16-byte boundary (the wrapper
    takes 8-byte aligned bf16): widened to fp32 for TMA, same logits."""
    args = _class_logits_args(2, 300, 512, 22, 2, torch.bfloat16, _card())
    flat = torch.empty(args[0].numel() + 4, dtype=torch.bfloat16, device=args[0].device)
    img = flat[4:].view(args[0].shape)
    img.copy_(args[0])
    assert img.data_ptr() % 16 == 8
    _class_logits_check([img, *args[1:]], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_owl_class_logits_repeated_launches_agree_on_card(dtype):
    """The ring's stages are read by LDS and refilled by TMA: without the
    proxy fence before a stage's release, TMA overwrote stages under the
    reads now and then (wrong rows). At the shape that showed it (B = 8,
    P = 3600, Dt 512, Q = 160 in four query tiles, so img streams four
    times) 30 launches each equal the first bit for bit, and the first is
    the plain version within the gate."""
    args = _class_logits_args(8, 3600, 512, 160, 0, dtype, _card(), seed=5)
    _class_logits_check(args, 0)
    first = openvocab.owl_class_logits(*args)
    want = openvocab.class_logits_reference(*args)
    err = (first - want).abs().max().item()
    assert err <= CLASS_LOGITS_RTOL * want.abs().max().item(), err
    wrong = []
    for trial in range(30):
        got = openvocab.owl_class_logits(*args)
        if not torch.equal(got, first):
            wrong.append((trial, int((got != first).any(dim=-1).sum().item())))
    torch.cuda.synchronize()
    assert not wrong, wrong  # (trial, rows that differ)


@pytest.mark.cuda
def test_class_logits_probe_runs_on_card(tmp_path):
    """The probe's cases, each with its three times, into its record."""
    from spotter_tpu_torch.tools import class_logits_probe

    _card()
    out = tmp_path / "probe.json"
    assert class_logits_probe.main(["--iters", "2", "--out", str(out)]) == 0
    cases = json.loads(out.read_text())["cases"]
    assert len(cases) == len(class_logits_probe.CASES)
    for case in cases:
        assert all(case[k] > 0 for k in ("kernel_ms", "kernel_clean_l2_ms",
                                         "torch_sum_clean_l2_ms")), case


def test_class_logits_kstep_order_is_a_permutation_and_keeps_the_product():
    """The kernel's k-step column order covers every column of the padded
    width once, so the bank permuted as the A fragments read img gives the
    same product (float64, both widths)."""
    rng = np.random.default_rng(2)
    for dt, width in ((100, 32), (512, 32), (520, 64), (100, 64)):
        order = class_logits_rounding.kstep_columns(dt, width)
        pad = -(-dt // width) * width
        assert sorted(order.tolist()) == list(range(pad))
        x = torch.from_numpy(rng.standard_normal((5, pad)))
        y = torch.from_numpy(rng.standard_normal((3, pad)))
        assert torch.allclose(x[:, order] @ y[:, order].T, x @ y.T, rtol=0, atol=1e-12)
    # k-step 0 of an fp32 slab: A columns t and t + 4 are lane t's first two
    assert class_logits_rounding.kstep_columns(32, 32)[:8].tolist() == [0, 8, 16, 24, 1, 9, 17,
                                                                        25]


@pytest.mark.parametrize("shape", [(1, 300, 512, 22), (2, 64, 100, 41)])
def test_class_logits_rounding_needs_both_tf32_terms_for_fp32(shape):
    """The design check behind the kernel's split: fp32 img against the bank,
    both as two TF32 terms (the bank's as one B operand of hi and lo rows),
    stays far under the gate with the accumulators truncated; one term of
    each fails it. bf16 img is exact in TF32, so A's lo term adds nothing."""
    rec = class_logits_rounding.shape_errors(shape, seed=0)
    assert rec["a2_b2_err_of_max_logit"] < rec["gate"] / 10
    assert rec["a1_b1_err_of_max_logit"] > rec["gate"]
    bf16 = class_logits_rounding.shape_errors(shape, seed=0, img_dtype=torch.bfloat16)
    assert bf16["a1_b2_err_of_max_logit"] == bf16["a2_b2_err_of_max_logit"] < bf16["gate"] / 10


def test_class_logits_emulation_with_a_mask_is_the_plain_version_within_the_gate():
    img, bank, shift, scale, mask = _class_logits_args(2, 70, 100, 9, 3, torch.float32, "cpu",
                                                       seed=3)
    got = class_logits_rounding.split_tf32_logits(img, bank, shift, scale, mask)
    want = openvocab.class_logits_reference(img, bank, shift, scale, mask)
    assert (got[..., 6:] == openvocab.NEG_INF).all() and (want[..., 6:] == openvocab.NEG_INF).all()
    err = (got[..., :6] - want[..., :6]).abs().max().item()
    assert err <= CLASS_LOGITS_RTOL * want[..., :6].abs().max().item()


# --- pack_tile: a compare into a predicate and an add under it -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [1, 16])
@pytest.mark.parametrize("variant", list(bench_pack_probe.VARIANTS))
def test_pack_tile_variants_are_bit_equal_on_card(variant, bh):
    idx, w = bench_pack_probe.probe_inputs(bh, seed=bh, device=_card())
    before = bench_pack_probe.pack_tile.launches
    got = bench_pack_probe.pack_tile(idx, w, variant)
    want = bench_pack_probe.pack_tile_reference(idx, w, variant)
    torch.cuda.synchronize()
    assert bench_pack_probe.pack_tile.launches == before + 1
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
def test_pack_tile_fp32_base_and_hoist_issue_no_select_on_card():
    """The fp32 base and hoist chains are ISETP and a predicated FADD: no
    FSEL past a chain's first element (where ptxas folds the add onto the
    +0 that `oh` starts from into a select of w or 0), about two
    instructions a chain element besides base's shared-memory reads."""
    _card()
    sass = bench_pack_probe.sass_counts()
    for variant in bench_pack_probe.NO_SELECT_VARIANTS:
        rec = sass[variant]
        chain_elements = rec["chains"] * bench_pack_probe.JC
        assert rec["fsel"] <= rec["chains"], (variant, rec)
        assert (rec["instructions"] - rec["lds"]) / chain_elements < 2.5, (variant, rec)


@pytest.mark.cuda
def test_pack_tile_base_reads_idx_and_w_in_every_chain_on_card():
    """base reads idx[j] and w[j] from shared memory at every chain element
    (one LDS for each k and j), hoist once before its chains: the two do
    not compile to one program."""
    _card()
    sass = bench_pack_probe.sass_counts()
    per_chain = bench_pack_probe.REPS * bench_pack_probe.JC
    for base in bench_pack_probe.CHAIN_READ_VARIANTS:
        hoist = base.replace("base", "hoist")
        assert sass[base]["lds"] >= per_chain, (base, sass[base])
        assert sass[hoist]["lds"] < per_chain, (hoist, sass[hoist])
