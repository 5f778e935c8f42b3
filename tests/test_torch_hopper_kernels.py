"""The port's kernels redesigned for the H100, on the card: the bf16 and
fp32 attention kernels (`ops.attention.flash_attn_bf16`, and
`flash_attn_fp32` with its K/V split pass `split_kv_tf32`: wgmma fed by
TMA), the int8 GEMM (`tools.bench_int8.int8_gemm`, a transpose pass, then
wgmma fed by TMA), the separable MSDA sampling kernel
(`ops.msda.msda_sep_sum`), the lane-gather kernel (`msda_hd_gather_sum`,
reading the value rows in place) and the fused MSDA kernel
(`msda_fused_sum`, a register-blocked prologue), each against its plain
version; and, on the CPU, the fused wrapper's plain path, the transpose and split passes' plain paths, the GEMM's input checks, the
fp32 kernel's key order, and the rounding studies
(`tools.attention_rounding`) behind the bf16 kernel's split P and the fp32
kernel's split TF32.

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
fp32, in the plain version's order). The lane gather sums in the value's
dtype in its plain version's order: equal bit for bit in fp32, within one
bf16 ulp of the largest output in bf16. The fused kernel: within 1e-5 under
both methods; its prologue sums as the plain version does, so the discrete
method's nearest cells agree and every row is compared.
"""

import numpy as np
import pytest
import torch

from spotter_tpu_torch.ops import attention as tattn
from spotter_tpu_torch.ops import msda as tmsda
from spotter_tpu_torch.tools import attention_rounding, bench_int8


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


def _samples(levels, q, h, points, rng):
    """(1, Q, H, LP, 2) sample points and softmaxed (1, Q, H, LP) attention:
    Q equal to the token count samples as an encoder does (each token around
    its own cell, tokens level-major and row-major), other Q anywhere in
    [-0.05, 1.05]."""
    lp = len(levels) * points
    if q == sum(a * b for a, b in levels):
        cells = []
        for lh, lw in levels:
            iy, ix = np.divmod(np.arange(lh * lw), lw)
            cells.append(np.stack([(ix + 0.5) / lw, (iy + 0.5) / lh], -1))
        ref = np.concatenate(cells)[None, :, None, None, :]
        loc = ref + 0.02 * rng.standard_normal((1, q, h, lp, 2))
    else:
        loc = rng.uniform(-0.05, 1.05, (1, q, h, lp, 2))
    logits = rng.standard_normal((1, q, h, lp))
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
    """RT-DETR decoder operands at B = 1: value rows (H, S, hd), hidden
    states (1, Q, D), per-head projections, anchors and level tables."""
    dev = _card()
    rng = np.random.default_rng(seed)
    s = sum(a * b for a, b in RTDETR_LEVELS)
    lp = len(RTDETR_LEVELS) * points

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    rows = randn(h, s, hd).to(rows_dtype)
    hs = randn(1, q, d)
    ref = torch.from_numpy(np.concatenate(
        [rng.uniform(0.05, 0.95, (1, q, 2)), rng.uniform(0.05, 0.5, (1, q, 2))], -1
    ).astype(np.float32)).to(dev)
    heads = tmsda.fused_head_weights(randn(d, h * lp * 2, scale=d**-0.5), randn(h * lp * 2, scale=0.1),
                                     randn(d, h * lp, scale=d**-0.5), randn(h * lp, scale=0.1), h)
    base, scale = tmsda.fused_anchors(ref, lp, points, 0.5)
    tables = tmsda.level_tables(RTDETR_LEVELS, points, dev, torch.float32)
    return (rows, hs, *heads, base, scale, *tables)


def _fused_error(args, method, **kw):
    before = tmsda.msda_fused_sum.launches
    got = tmsda.msda_fused_sum(*args, method, **kw)
    want = tmsda.msda_fused_reference(*args, method)
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
    rows = torch.from_numpy(rng.standard_normal((h, s, hd)).astype(np.float32))
    hs = torch.from_numpy(rng.standard_normal((1, q, d)).astype(np.float32))
    ref = torch.from_numpy(rng.uniform(0.1, 0.9, (1, q, 4)).astype(np.float32))
    heads = tmsda.fused_head_weights(
        *(torch.from_numpy(rng.standard_normal(sh).astype(np.float32) * 0.2)
          for sh in ((d, h * points * 2), (h * points * 2,), (d, h * points), (h * points,))), h)
    base, scale = tmsda.fused_anchors(ref, points, points, 0.5)
    tables = tmsda.level_tables(((5, 6),), points, torch.device("cpu"), torch.float32)
    return (rows, hs, *heads, base, scale, *tables)


@pytest.mark.parametrize("lp_points", [1, 2])
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_fused_wrapper_cpu_path_is_the_plain_version(method, lp_points):
    """A CPU tensor takes the plain version and counts no launch."""
    args = _tiny_fused_args(lp_points)
    before = tmsda.msda_fused_sum.launches
    got = tmsda.msda_fused_sum(*args, method)
    assert got.shape == (2, 9, 8)
    assert torch.equal(got, tmsda.msda_fused_reference(*args, method))
    assert tmsda.msda_fused_sum.launches == before
