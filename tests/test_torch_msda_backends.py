"""The opt-in MSDA backends, SPOTTER_TPU_MSDA=pallas_sep and =pallas_gather:
the port's plain versions and routing against the JAX package.

Inputs come from a numpy seed. The separable operands are the port's
(`sep_level_operands`); they go through JAX's `_sep_ref_math` (its dense
one-hot reference) and `pallas_sep_sampling(interpret=True)` (the TPU kernel
in interpret mode) and through the port's `msda_sep_reference`, the plain
version its wrapper runs on a CPU tensor. The JAX functions take the band
transpose (BH, n_bands, W, R*hd) of the level's rows, which the test builds;
the port's kernel reads the rows as they are.

Tolerance: atol 1e-5 in fp32 (the acceptance gate), on sums of at most 48
products of weights in [0, 1] and standard-normal values, summed in other
orders on the two sides. The lane-gather plain version is held to 1e-6:
it sums in the order of `_gather_weighted_sum`'s corner loop. It takes the
value (B, S, H, hd) where the model holds it and returns (B, Q, H, hd); the
JAX functions take vt (B, H, hd, S) and return (B, H, hd, Q), so the test
side transposes both, as `_gather_weighted_sum` transposes the other way.

The CUDA kernels run only on the card: the tests marked `cuda` skip here
(chip_smoke.py holds both kernels against their plain versions at the
models' shapes).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.models import rtdetr as jrtdetr
from spotter_tpu.models import zoo as jzoo
from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
from spotter_tpu.ops import msda as jmsda
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models import zoo as tzoo
from spotter_tpu_torch.models.rtdetr import RTDetrDetector
from spotter_tpu_torch.ops import msda as tmsda
from tests.torch_parity import random_flax_params

# a level wider than 128 takes 4-row bands; Q = 70 leaves a partial 64-tile
SHAPES = ((9, 11), (5, 6), (3, 130))
B, Q, H, HD, P = 2, 70, 2, 8, 3
LP = len(SHAPES) * P
S = sum(h * w for h, w in SHAPES)
ATOL = 1e-5
BACKENDS = ("pallas_sep", "pallas_gather")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    # mostly inside [0, 1], some outside: zero padding and clamping
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, LP, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Q, H, LP))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attn.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _level(value, loc, attn, lvl):
    """Level `lvl`'s rows (BH, lh*lw, hd), points and attention."""
    offs = tmsda.level_offsets(SHAPES)
    lh, lw = SHAPES[lvl]
    rows = value.transpose(0, 2, 1, 3).reshape(B * H, S, HD)[:, offs[lvl]:offs[lvl] + lh * lw]
    pts = slice(lvl * P, (lvl + 1) * P)
    return np.ascontiguousarray(rows), loc[:, :, :, pts], attn[:, :, :, pts]


def _band_rows(rows, lh, lw, r_band):
    """(BH, lh*lw, hd) -> the JAX kernel's (BH, n_bands, W, R*hd) band transpose."""
    n_bands = -(-lh // r_band)
    v = rows.reshape(B * H, lh, lw, HD)
    v = np.pad(v, ((0, 0), (0, n_bands * r_band - lh), (0, 0), (0, 0)))
    v = v.reshape(B * H, n_bands, r_band, lw, HD).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(v.reshape(B * H, n_bands, lw, r_band * HD))


def _sep_case(seed, lvl, method):
    value, loc, attn = _inputs(seed)
    rows, loc_l, attn_l = _level(value, loc, attn, lvl)
    lh, lw = SHAPES[lvl]
    operands, mask, r_band = tmsda.sep_level_operands(*_t(loc_l, attn_l), lh, lw, method)
    return rows, operands, mask, r_band, (lh, lw)


@pytest.mark.parametrize("lvl", [0, 2])
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_sep_reference_matches_jax_ref_math(method, lvl):
    rows, ops, mask, r_band, (lh, lw) = _sep_case(1, lvl, method)
    assert r_band == (8 if lw <= 128 else 4)
    assert mask.shape == (B * H, 2, -(-lh // r_band)) and mask.dtype == torch.int32
    got = tmsda.msda_sep_sum(torch.from_numpy(rows), *ops, mask, (lh, lw), r_band, P)
    want = jmsda._sep_ref_math(
        jnp.asarray(_band_rows(rows, lh, lw, r_band)), *(jnp.asarray(o.numpy()) for o in ops),
        r_band, P,
    )
    assert got.shape == (B * H, 128, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[:, Q:].any(), "a pad query sampled something"


@pytest.mark.parametrize("cleared", [False, True], ids=["hit_table", "cleared_bits"])
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_sep_reference_matches_interpret_kernel(method, cleared):
    """Against the TPU kernel itself, on the same hit table; with some bits
    cleared, both must drop exactly those bands' rows."""
    rows, ops, mask, r_band, (lh, lw) = _sep_case(2, 0, method)
    if cleared:
        keep = np.random.default_rng(3).uniform(size=mask.shape) < 0.5
        mask = mask * torch.from_numpy(keep.astype(np.int32))
    got = tmsda.msda_sep_sum(torch.from_numpy(rows), *ops, mask, (lh, lw), r_band, P)
    want = jmsda.pallas_sep_sampling(
        jnp.asarray(_band_rows(rows, lh, lw, r_band)), *(jnp.asarray(o.numpy()) for o in ops),
        jnp.asarray(mask.numpy()), lw, r_band, P, True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if cleared:  # the cleared bits matter: the full table gives another result
        _, _, full, _, _ = _sep_case(2, 0, method)
        assert not np.allclose(
            got.numpy(), tmsda.msda_sep_reference(torch.from_numpy(rows), *ops, full, (lh, lw),
                                                  r_band, P).numpy(), atol=ATOL)


@pytest.mark.parametrize("method", ["default", "discrete"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_deformable_sampling_matches_jax(monkeypatch, backend, method):
    value, loc, attn = _inputs(4 if method == "default" else 5)
    want = jmsda.deformable_sampling(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn), SHAPES, P,
        method=method, backend=backend, interpret=True,
    )
    monkeypatch.setattr(tmsda, "MSDA_BACKEND", backend)
    got = tmsda.deformable_sampling(*_t(value, loc, attn), SHAPES, P, method=method)
    assert got.shape == (B, Q, H * HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _vt(value):
    """(B, S, H, hd) -> the TPU kernel's vt (B, H, hd, S)."""
    return np.ascontiguousarray(np.asarray(value).transpose(0, 2, 3, 1))


def _from_lanes(out):
    """The JAX kernel's (B, H, hd, Q) -> the port's (B, Q, H, hd)."""
    return np.asarray(out, np.float32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("method", ["default", "discrete"])
def test_lane_gather_prep_and_reference_match_jax(method):
    value, loc, attn = _inputs(6)
    jidx, jw = jmsda.prepare_msda_gather(
        jnp.asarray(loc.transpose(0, 2, 3, 1, 4)), jnp.asarray(attn.transpose(0, 2, 3, 1)),
        SHAPES, P, method,
    )
    idx, w = tmsda.prepare_msda_gather_lanes(*_t(loc, attn), SHAPES, P, method)
    assert idx.shape == (B, H, 4, LP * Q) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
    want = jmsda._gather_weighted_sum(jnp.asarray(_vt(value)), jidx, jw, LP, Q)
    got = tmsda.msda_hd_gather_sum(torch.from_numpy(value), idx, w, LP, Q)
    assert got.shape == (B, Q, H, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _from_lanes(want), atol=1e-6)


def _bf16_ulp_atol(want) -> float:
    """One bf16 ulp of the largest output: the two sides may round a product
    or a partial sum on either side of a tie."""
    return 2.0**-7 * float(np.abs(np.asarray(want, np.float32)).max())


def test_lane_gather_sums_in_the_value_dtype():
    """bf16 values: the corner products and both sums round to bf16, as the
    TPU kernel accumulates (its interpret mode on the same operands)."""
    value, loc, attn = _inputs(7)
    idx, w = tmsda.prepare_msda_gather_lanes(*_t(loc, attn), SHAPES, P)
    value = torch.from_numpy(value).to(torch.bfloat16)
    got = tmsda.msda_hd_gather_sum(value, idx, w, LP, Q)
    want = jmsda.pallas_deformable_sampling(
        jnp.asarray(_vt(value.float().numpy())).astype(jnp.bfloat16), jnp.asarray(idx.numpy()),
        jnp.asarray(w.numpy()), LP, Q, True,
    )
    assert got.dtype == torch.bfloat16 and got.shape == (B, Q, H, HD)
    np.testing.assert_allclose(got.float().numpy(), _from_lanes(want), atol=_bf16_ulp_atol(want))


def _lane_case(seed, q, hd, method="default"):
    """Value (B, S, H, hd) and the lane prep of Q queries."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, q, H, LP, 2)).astype(np.float32)
    logits = rng.standard_normal((B, q, H, LP))
    attn = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    idx, w = tmsda.prepare_msda_gather_lanes(*_t(loc, attn), SHAPES, P, method)
    return value, idx, w


@pytest.mark.parametrize("method", ["default", "discrete"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_gather_reference_matches_interpret_kernel(dtype, method):
    """The plain version against the TPU kernel itself in interpret mode, vt
    made on the test side: fp32 to 1e-6 (the same order), bf16 to one ulp."""
    value, idx, w = _lane_case(20, Q, HD, method)
    tvalue = torch.from_numpy(value).to(getattr(torch, dtype))
    got = tmsda.msda_hd_gather_reference(tvalue, idx, w, LP, Q)
    want = jmsda.pallas_deformable_sampling(
        jnp.asarray(_vt(tvalue.float().numpy())).astype(getattr(jnp, dtype)),
        jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()), LP, Q, True,
    )
    assert got.dtype == tvalue.dtype and got.shape == (B, Q, H, HD)
    atol = 1e-6 if dtype == "float32" else _bf16_ulp_atol(want)
    np.testing.assert_allclose(got.float().numpy(), _from_lanes(want), atol=atol)


def test_lane_gather_skips_bad_indices_and_zero_weights():
    """On the CPU wrapper path (the plain version) an index outside [0, S)
    adds nothing, and neither does a zero weight: the sum equals the one
    with those terms pointed at row 0 with weight 0, bit for bit, and
    differs from the one that counts them. The kernel's own handling of the
    same planted terms is a `cuda` test of test_torch_hopper_kernels.py."""
    value, idx, w = _lane_case(21, Q, HD)
    bad = idx.clone()
    bad.view(-1)[::7] = S + 3
    bad.view(-1)[3::11] = -5
    w0 = w.clone()
    w0.view(-1)[5::13] = 0.0
    off = (bad < 0) | (bad >= S)
    tvalue = torch.from_numpy(value)
    got = tmsda.msda_hd_gather_sum(tvalue, bad, w0, LP, Q)
    want = tmsda.msda_hd_gather_reference(
        tvalue, torch.where(off, 0, bad), torch.where(off, 0.0, w0), LP, Q)
    assert torch.equal(got, want)
    counted = tmsda.msda_hd_gather_reference(tvalue, torch.where(off, 0, bad), w0, LP, Q)
    assert not torch.allclose(got, counted, atol=ATOL)


@pytest.mark.parametrize("hd", [24, 64])
def test_lane_gather_ragged_queries_and_other_widths(hd):
    """Q = 37 and 70 (neither a multiple of the kernel's 64-query tile) at
    hd 24 and 64, against `_gather_weighted_sum`."""
    for q in (37, 70):
        value, idx, w = _lane_case(22 + hd + q, q, hd)
        got = tmsda.msda_hd_gather_sum(torch.from_numpy(value), idx, w, LP, q)
        want = jmsda._gather_weighted_sum(
            jnp.asarray(_vt(value)), jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()), LP, q)
        assert got.shape == (B, q, H, hd)
        np.testing.assert_allclose(got.numpy(), _from_lanes(want), atol=1e-6)


@pytest.mark.parametrize("method", ["default", "discrete"])
def test_gather_branch_reads_the_value_in_place(monkeypatch, method):
    """SPOTTER_TPU_MSDA=pallas_gather hands the wrapper the model's value
    tensor itself (no permute copy) and returns a view of its output; the
    result equals the JAX op's."""
    value, loc, attn = _inputs(23)
    seen = []
    real = tmsda.msda_hd_gather_sum

    def spy(v, *args):
        out = real(v, *args)
        seen.append((v, out))
        return out

    monkeypatch.setattr(tmsda, "MSDA_BACKEND", "pallas_gather")
    monkeypatch.setattr(tmsda, "msda_hd_gather_sum", spy)
    tvalue, tloc, tattn = _t(value, loc, attn)
    got = tmsda.deformable_sampling(tvalue, tloc, tattn, SHAPES, P, method=method)
    (v, out), = seen
    assert v is tvalue
    assert got.data_ptr() == out.data_ptr() and got.shape == (B, Q, H * HD)
    want = jmsda.deformable_sampling(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn), SHAPES, P,
        method=method, backend="pallas_gather", interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_prep_falls_back_as_jax_does(monkeypatch, backend):
    """PREP=fused under pallas_sep / pallas_gather: the einsum prologue, then
    the backend's own kernel (never msda_fused_sum), as the JAX package's
    deformable_sampling_fused with that backend."""
    rng = np.random.default_rng(8)
    d = 16
    value, _, _ = _inputs(8)
    hs = rng.standard_normal((B, Q, d)).astype(np.float32)
    ref = np.concatenate([rng.uniform(0.1, 0.9, (B, Q, 2)), rng.uniform(0.05, 0.5, (B, Q, 2))],
                         -1).astype(np.float32)
    w_off = (rng.standard_normal((d, H * LP * 2)) / 4).astype(np.float32)
    b_off = (0.1 * rng.standard_normal(H * LP * 2)).astype(np.float32)
    w_att = (rng.standard_normal((d, H * LP)) / 4).astype(np.float32)
    b_att = (0.1 * rng.standard_normal(H * LP)).astype(np.float32)
    args = (value, hs, ref, w_off, b_off, w_att, b_att)
    want = jmsda.deformable_sampling_fused(
        *map(jnp.asarray, args), SHAPES, P, backend=backend, interpret=True)
    monkeypatch.setattr(tmsda, "MSDA_BACKEND", backend)
    monkeypatch.setattr(tmsda, "MSDA_PREP", "fused")
    calls = _count_wrappers(monkeypatch)
    got = tmsda.deformable_sampling_fused(*_t(*args), SHAPES, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(calls) == {WRAPPER[backend]}, calls


WRAPPER = {"pallas_sep": "msda_sep_sum", "pallas_gather": "msda_hd_gather_sum"}
WRAPPERS = ("msda_gather_sum", "msda_loc_sum", "msda_fused_sum", "msda_sep_sum",
            "msda_hd_gather_sum")


def _count_wrappers(monkeypatch) -> list:
    """Patch every MSDA wrapper to record its name, then run the real one."""
    calls = []
    for name in WRAPPERS:
        real = getattr(tmsda, name)
        monkeypatch.setattr(
            tmsda, name, lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    return calls


@pytest.mark.parametrize("prep", ["xla", "kernel", "fused"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_takes_its_kernel_under_every_prep(monkeypatch, backend, prep):
    """The JAX dispatch order: pallas_sep and pallas_gather are tested before
    the prep setting, so each runs its own wrapper under xla, kernel and
    fused alike (sep once per level, gather once per op)."""
    _, tcfg = _rtdetr_configs()
    model = RTDetrDetector(tcfg).eval()
    x = torch.from_numpy(np.random.default_rng(9).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    monkeypatch.setattr(tmsda, "MSDA_BACKEND", backend)
    monkeypatch.setattr(tmsda, "MSDA_PREP", prep)
    calls = _count_wrappers(monkeypatch)
    with torch.inference_mode():
        model(x)
    per_op = tcfg.num_feature_levels if backend == "pallas_sep" else 1
    assert calls == [WRAPPER[backend]] * (per_op * tcfg.decoder_layers), calls


def _rtdetr_configs(method="default"):
    return (dataclasses.replace(jzoo.tiny_rtdetr_config(), decoder_method=method),
            dataclasses.replace(tzoo.tiny_rtdetr_config(), decoder_method=method))


@pytest.mark.parametrize("method", ["default", "discrete"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_tiny_rtdetr_matches_jax_under_backend(monkeypatch, backend, method):
    """The whole tiny RT-DETRv2 under each backend against the JAX package
    under the same backend (interpret mode), at tests/test_rtdetr_parity.py's
    tolerances."""
    jcfg, tcfg = _rtdetr_configs(method)
    jmodel = JRTDetr(jcfg)
    x = np.random.default_rng(10).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    params = random_flax_params(jmodel, x[:1], seed=10)
    monkeypatch.setenv("SPOTTER_TPU_MSDA", backend)
    # the JAX model's TPU kernels run here in interpret mode
    monkeypatch.setattr(jrtdetr, "deformable_sampling",
                        functools.partial(jmsda.deformable_sampling, interpret=True))
    jout = jmodel.apply({"params": params}, x)
    monkeypatch.setattr(tmsda, "MSDA_BACKEND", backend)
    model = load_from_jax(RTDetrDetector(tcfg).eval(), params)
    before = {name: getattr(tmsda, name).launches for name in WRAPPERS}
    with torch.inference_mode():
        tout = model(torch.from_numpy(x))
    assert before == {name: getattr(tmsda, name).launches for name in WRAPPERS}, (
        "a CPU forward counted a kernel launch")
    for key, atol in (("pred_boxes", 2e-4), ("logits", 5e-4), ("aux_boxes", 2e-4)):
        np.testing.assert_allclose(
            tout[key].numpy(), np.asarray(jout[key]), atol=atol, rtol=1e-3, err_msg=key)


def test_bad_backend_attribute_raises_the_jax_text_at_forward(monkeypatch):
    value, loc, attn = _t(*_inputs(11))
    with pytest.raises(ValueError) as want:
        jmsda.msda_backend("bogus")
    monkeypatch.setattr(tmsda, "MSDA_BACKEND", "bogus")
    with pytest.raises(ValueError) as got:
        tmsda.deformable_sampling(value, loc, attn, SHAPES, P)
    assert str(got.value) == str(want.value)
    assert tmsda.check_msda_backend(" Pallas_Sep ") == "pallas_sep"


def test_wrappers_reject_bad_inputs():
    rows, ops, mask, r_band, hw = _sep_case(12, 0, "default")
    rows = torch.from_numpy(rows)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmsda.msda_sep_sum(rows.to("meta"), *ops, mask, hw, r_band, P)
    with pytest.raises(ValueError, match="not every other input"):
        tmsda.msda_sep_sum(rows, *ops[:-1], ops[-1].to("meta"), mask, hw, r_band, P)
    value, loc, attn = _inputs(12)
    idx, w = tmsda.prepare_msda_gather_lanes(*_t(loc, attn), SHAPES, P)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmsda.msda_hd_gather_sum(torch.from_numpy(value).to("meta"), idx, w, LP, Q)
    with pytest.raises(ValueError, match="method"):
        tmsda.sep_level_operands(*_t(loc[..., :P, :], attn[..., :P]), 9, 11, "nearest")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cleared", [False, True])
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_sep_kernel_matches_plain_version_on_card(method, cleared):
    dev = _cuda()
    rows, ops, mask, r_band, hw = _sep_case(13, 0, method)
    if cleared:
        mask = mask * torch.from_numpy(
            (np.random.default_rng(14).uniform(size=mask.shape) < 0.5).astype(np.int32))
    rows = torch.from_numpy(rows)
    before = tmsda.msda_sep_sum.launches
    got = tmsda.msda_sep_sum(rows.to(dev), *(o.to(dev) for o in ops), mask.to(dev), hw,
                             r_band, P)
    want = tmsda.msda_sep_reference(rows, *ops, mask, hw, r_band, P)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)
    assert tmsda.msda_sep_sum.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_hd_gather_kernel_matches_plain_version_on_card(method):
    dev = _cuda()
    value, loc, attn = _inputs(15)
    idx, w = tmsda.prepare_msda_gather_lanes(*_t(loc, attn), SHAPES, P, method)
    tvalue = torch.from_numpy(value)
    before = tmsda.msda_hd_gather_sum.launches
    got = tmsda.msda_hd_gather_sum(tvalue.to(dev), idx.to(dev), w.to(dev), LP, Q)
    want = tmsda.msda_hd_gather_reference(tvalue, idx, w, LP, Q)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)
    assert tmsda.msda_hd_gather_sum.launches == before + 1


@pytest.mark.cuda
def test_sep_kernel_at_a_full_deformable_detr_encoder_level_on_card():
    """One whole level of Deformable-DETR's encoder at the 1333x1333 bucket:
    the 84 x 84 level, 8 heads of 32, 4 points, its 7,056 tokens (not a
    multiple of 64) each sampling around its own cell, as the encoder's
    queries do."""
    dev = _cuda()
    lh = lw = 84
    q, h, hd, pts = lh * lw, 8, 32, 4
    rng = np.random.default_rng(17)
    rows = torch.from_numpy(rng.standard_normal((h, q, hd)).astype(np.float32))
    iy, ix = np.divmod(np.arange(q), lw)
    ref = np.stack([(ix + 0.5) / lw, (iy + 0.5) / lh], -1)[None, :, None, None, :]
    loc = (ref + 0.02 * rng.standard_normal((1, q, h, pts, 2))).astype(np.float32)
    logits = rng.standard_normal((1, q, h, pts))
    attn = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    ops, mask, r_band = tmsda.sep_level_operands(*_t(loc, attn), lh, lw)
    got = tmsda.msda_sep_sum(rows.to(dev), *(o.to(dev) for o in ops), mask.to(dev), (lh, lw),
                             r_band, pts)
    want = tmsda.msda_sep_reference(rows, *ops, mask, (lh, lw), r_band, pts)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)
