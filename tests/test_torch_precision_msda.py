"""SPOTTER_TPU_MSDA_PRECISION: the port's one-pass ("default") mode of MSDA
rows 1-4, and the knob as the JAX package reads it.

"default" is the TPU's one bf16 MXU pass: both operands of the one-hot
contraction rounded to bf16 (round to nearest even), products exact, sums
in fp32. XLA on the CPU ignores `Precision.DEFAULT`, so the JAX package's
CPU runs cannot show that rounding; the oracles here are built in the test:

- rows 1-3: a dense (Q, S) one-hot per (b, h) in numpy from the JAX
  package's own corner prep (`spotter_tpu.ops.msda.prepare_msda_gather`),
  each entry (the fp32 sum of one query's weights on one row) and each
  value element rounded to bf16, summed in float64. The port's kernels
  round each term's weight instead, so they differ from it only where two
  terms of one (query, head) land on one row, by at most
  2 * 2**-8 * (sum of those terms' |w|) * |bf16 value| (a bf16 rounding of
  each weight and of their sum); elsewhere only by fp32 summation,
  J * 2**-24 * sum |w v|. The tests assert both bounds and that collisions
  do occur.
- row 4: the separable kernel's band math as `pallas_sep_sampling` does it,
  in numpy: per band the x one-hot (Q*P, W) and the value band (W, R*hd)
  rounded to bf16 and multiplied in float64 (two non-zero products, so the
  fp32 result is that sum rounded once), times the y weight in fp32, summed
  over points in fp32, that sum rounded to bf16, then the 0/1 group-sum over
  the band's rows in float64. The port's plain version groups the same
  terms by row and sums in the same order: atol 1e-6 of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.ops import msda as jmsda
from spotter_tpu_torch.ops import msda

SHAPES = ((6, 7), (3, 4), (2, 2))
POINTS = 3
LP = len(SHAPES) * POINTS
S = sum(h * w for h, w in SHAPES)
B, H, HD, Q = 2, 2, 8, 40
U = 2.0**-8  # bf16's unit roundoff


def bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32),
                      np.float64)


def _inputs(seed, rows_dtype=torch.float32, shapes=SHAPES, points=POINTS):
    rng = np.random.default_rng(seed)
    lp = len(shapes) * points
    value = rng.standard_normal((B, sum(h * w for h, w in shapes), H, HD)).astype(np.float32)
    # sample points spread over each level, a few outside [0, 1]; narrow
    # offsets around a per-query centre so that terms share rows
    centre = rng.uniform(0.1, 0.9, (B, Q, 1, 1, 2))
    loc = (centre + rng.normal(0, 0.08, (B, Q, H, lp, 2))).astype(np.float32)
    attn = rng.standard_normal((B, Q, H, lp)).astype(np.float32)
    attn = np.exp(attn) / np.exp(attn).sum(-1, keepdims=True)
    tval = torch.from_numpy(value).to(rows_dtype)
    return tval, loc, attn.astype(np.float32)


def _jax_corners(loc, attn, shapes=SHAPES, points=POINTS):
    """The JAX package's corner prep: idx/w (B, H, 4, LP*Q) -> per-query
    terms (B, H, Q, 4*LP)."""
    lp = loc.shape[3]
    idx, w = jmsda.prepare_msda_gather(
        jnp.asarray(loc).transpose(0, 2, 3, 1, 4), jnp.asarray(attn).transpose(0, 2, 3, 1),
        shapes, points)
    idx = np.asarray(idx).reshape(B, H, 4, lp, Q).transpose(0, 1, 4, 2, 3).reshape(B, H, Q, -1)
    w = np.asarray(w).reshape(B, H, 4, lp, Q).transpose(0, 1, 4, 2, 3).reshape(B, H, Q, -1)
    return idx, w


def _one_hot_oracle(value, idx, w):
    """Dense one-hot contraction in the TPU's one pass: out (B, Q, H, hd)
    float64, plus the per-output collision bound and fp32 noise bound."""
    v = value.to(torch.float32).numpy()
    n_rows = v.shape[1]
    out = np.zeros((B, Q, H, HD))
    coll = np.zeros((B, Q, H, HD))
    noise = np.zeros((B, Q, H, HD))
    for b in range(B):
        for h in range(H):
            rows = bf16(v[b, :, h])  # (S, hd)
            for q in range(Q):
                oh = np.zeros(n_rows, np.float32)
                for s_, wt in zip(idx[b, h, q], w[b, h, q]):
                    if wt != 0:
                        oh[s_] = np.float32(oh[s_] + np.float32(wt))
                out[b, q, h] = bf16(oh) @ rows
                ids, counts = np.unique(idx[b, h, q][w[b, h, q] != 0], return_counts=True)
                for s_, n in zip(ids, counts):
                    if n > 1:
                        wsum = np.abs(w[b, h, q][(idx[b, h, q] == s_)]).sum()
                        coll[b, q, h] += 2 * U * wsum * np.abs(rows[s_]) * (1 + 2 * U)
                noise[b, q, h] = idx.shape[-1] * 2.0**-24 * (np.abs(w[b, h, q])[:, None]
                                                              * np.abs(rows[idx[b, h, q]])).sum(0)
    return out, coll, noise


def _assert_within(got, out, coll, noise):
    gap = np.abs(got.astype(np.float64) - out)
    assert (gap <= coll + noise + 1e-12).all(), float((gap - coll - noise).max())
    assert (coll > 0).any()  # terms do share rows at these shapes


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_sum_default_against_the_one_hot_oracle(rows_dtype):
    """Row 1's plain version in "default" mode, on the JAX package's corner
    prep, against the dense one-hot oracle (module docstring: the bounds)."""
    value, loc, attn = _inputs(0, rows_dtype)
    idx, w = msda.prepare_msda_gather(torch.from_numpy(loc), torch.from_numpy(attn), SHAPES,
                                      POINTS)
    jidx, jw = _jax_corners(loc, attn)
    # the same terms: the port keeps each sample's four corners adjacent
    def corner_major(t):
        return t.numpy().reshape(B, H, Q, LP, 4).transpose(0, 1, 2, 4, 3).reshape(B, H, Q, -1)

    np.testing.assert_array_equal(corner_major(idx), jidx)
    np.testing.assert_array_equal(corner_major(w), jw)
    got = msda.msda_gather_sum(value, idx, w, precision="default").numpy()
    _assert_within(got, *_one_hot_oracle(value, jidx, jw))
    highest = msda.msda_gather_sum(value, idx, w).numpy()
    assert np.abs(highest - got).max() > 0  # the mode rounds something


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_without_shared_rows_the_one_pass_equals_the_oracle(rows_dtype):
    """One level and one point: a sample's four bilinear corners are four
    cells, so no two terms of a query share a row, and rows 1 and 2 in
    "default" mode equal the TPU's one pass up to fp32 summation."""
    shapes, points = ((6, 7),), 1
    value, loc, attn = _inputs(5, rows_dtype, shapes, points)
    idx, w = msda.prepare_msda_gather(torch.from_numpy(loc), torch.from_numpy(attn), shapes,
                                      points)
    tables = msda.level_tables(shapes, points, torch.device("cpu"), torch.float32)
    out, coll, noise = _one_hot_oracle(value, *_jax_corners(loc, attn, shapes, points))
    assert not coll.any()
    for got in (msda.msda_gather_sum(value, idx, w, precision="default"),
                msda.msda_loc_sum(value, torch.from_numpy(loc), torch.from_numpy(attn), *tables,
                                  precision="default")):
        assert (np.abs(got.numpy().astype(np.float64) - out) <= noise + 1e-12).all()


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_loc_sum_default_against_the_one_hot_oracle(rows_dtype):
    """Row 2's plain version (corner prep inside) in "default" mode against
    the same oracle on the JAX package's corners."""
    value, loc, attn = _inputs(1, rows_dtype)
    tables = msda.level_tables(SHAPES, POINTS, torch.device("cpu"), torch.float32)
    got = msda.msda_loc_sum(value, torch.from_numpy(loc), torch.from_numpy(attn), *tables,
                            precision="default").numpy()
    _assert_within(got, *_one_hot_oracle(value, *_jax_corners(loc, attn)))


def test_fused_sum_default_against_the_oracle():
    """Row 3 in "default" mode: the prologue's two projections with hs and
    the weights rounded to bf16 (products exact: the float64 einsum rounded
    once to fp32 is within 2 fp32 ulps of the kernel-order FMA chain), the
    bias in fp32; then the core against the one-hot oracle on those
    locations through the JAX package's corner prep."""
    rng = np.random.default_rng(2)
    d = 16
    value, _, _ = _inputs(2)
    hs = rng.standard_normal((B, Q, d)).astype(np.float32)
    w_off = (rng.standard_normal((d, H * LP * 2)) * d**-0.5).astype(np.float32)
    b_off = (rng.standard_normal(H * LP * 2) * 0.1).astype(np.float32)
    w_att = (rng.standard_normal((d, H * LP)) * d**-0.5).astype(np.float32)
    b_att = (rng.standard_normal(H * LP) * 0.1).astype(np.float32)
    ref = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)), rng.uniform(0.05, 0.3, (B, Q, 2))],
                         -1).astype(np.float32)
    heads = msda.fused_head_weights(*map(torch.from_numpy, (w_off, b_off, w_att, b_att)), H)
    base, scale = msda.fused_anchors(torch.from_numpy(ref), LP, POINTS, 0.5)
    tables = msda.level_tables(SHAPES, POINTS, torch.device("cpu"), torch.float32)
    xy, at = msda.fused_prologue_reference(torch.from_numpy(hs), *heads, base, scale, "default")
    # prologue oracle in float64 from the rounded operands
    offs = np.einsum("bqd,hdl->bhql", bf16(hs), bf16(heads[0].numpy())) + heads[1].numpy()[None]
    logits = np.einsum("bqd,hdl->bhql", bf16(hs), bf16(heads[2].numpy())) + heads[3].numpy()[None]
    xy_o = base.numpy()[:, None] + offs.astype(np.float32) * scale.numpy()[:, None]
    at_o = np.exp(logits - logits.max(-1, keepdims=True))
    at_o /= at_o.sum(-1, keepdims=True)
    np.testing.assert_allclose(xy.numpy().reshape(xy_o.shape), xy_o, rtol=0, atol=1e-6)
    np.testing.assert_allclose(at.numpy().reshape(at_o.shape), at_o, rtol=0, atol=1e-6)
    got = msda.msda_fused_sum(value, torch.from_numpy(hs), *heads, base, scale, *tables,
                              precision="default").numpy()
    loc = xy.numpy().reshape(B, H, Q, 2, LP).transpose(0, 2, 1, 4, 3)
    att = at.numpy().reshape(B, H, Q, LP).transpose(0, 2, 1, 3)
    _assert_within(got, *_one_hot_oracle(value, *_jax_corners(loc, att)))
    # and it is row 2 on the prologue's locations, term for term
    loc_sum = msda.msda_loc_sum(value, torch.from_numpy(np.ascontiguousarray(loc)),
                                torch.from_numpy(np.ascontiguousarray(att)), *tables,
                                precision="default")
    assert torch.equal(torch.from_numpy(got), loc_sum)


def _sep_band_oracle(rows, ops, mask, hw, r_band, n_points):
    """pallas_sep_sampling's band math in one bf16 pass, numpy."""
    lh, lw = hw
    xi, xw0, xw1, yi, yw0, yw1 = (o.numpy().reshape(o.shape[0], -1) for o in ops)
    mask = mask.numpy()
    bh, n_qt, n_bands = mask.shape
    hd = rows.shape[-1]
    v = rows.to(torch.float32).numpy().reshape(bh, lh, lw, hd)
    v = np.pad(v, ((0, 0), (0, n_bands * r_band - lh), (0, 0), (0, 0)))
    out = np.zeros((bh, n_qt * 64, hd))
    cx = np.arange(lw)
    for i in range(bh):
        for t in range(n_qt):
            sl = slice(t * n_points * 64, (t + 1) * n_points * 64)
            x0, y0 = xi[i, sl][:, None], yi[i, sl][:, None]
            wx = (np.where(cx == x0, xw0[i, sl][:, None], 0.0)
                  + np.where(cx == x0 + 1, xw1[i, sl][:, None], 0.0)).astype(np.float32)
            for nb in range(n_bands):
                if not mask[i, t, nb]:
                    continue
                band = v[i, nb * r_band:(nb + 1) * r_band]  # (R, W, hd)
                g = np.einsum("pw,rwd->prd", bf16(wx), bf16(band)).astype(np.float32)
                r = nb * r_band + np.arange(r_band)
                wy = (np.where(r == y0, yw0[i, sl][:, None], 0.0)
                      + np.where(r == y0 + 1, yw1[i, sl][:, None], 0.0)).astype(np.float32)
                m = (g * wy[..., None]).astype(np.float32).reshape(n_points, 64, r_band, hd)
                acc = m[0]
                for p in range(1, n_points):
                    acc = (acc + m[p]).astype(np.float32)
                out[i, t * 64:(t + 1) * 64] += bf16(acc).sum(1)
    return out


@pytest.mark.parametrize("method", ["default", "discrete"])
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sep_default_against_the_band_oracle(method, rows_dtype):
    """Row 4's plain version in "default" mode against the band math with
    its two roundings (module docstring), level by level, with half the hit
    table's bits cleared on one level."""
    value, loc, attn = _inputs(3, rows_dtype)
    rows_all = value.permute(0, 2, 1, 3).reshape(B * H, S, HD)
    offs = msda.level_offsets(SHAPES)
    gen = np.random.default_rng(7)
    for lvl, (lh, lw) in enumerate(SHAPES):
        pts = slice(lvl * POINTS, (lvl + 1) * POINTS)
        ops, mask, r_band = msda.sep_level_operands(
            torch.from_numpy(loc[:, :, :, pts]), torch.from_numpy(attn[:, :, :, pts]), lh, lw,
            method)
        if lvl == 0:
            mask = mask * torch.from_numpy((gen.uniform(size=tuple(mask.shape)) < 0.5)
                                           .astype(np.int32))
        rows = rows_all[:, offs[lvl]:offs[lvl] + lh * lw].contiguous()
        got = msda.msda_sep_sum(rows, *ops, mask, (lh, lw), r_band, POINTS, "default").numpy()
        want = _sep_band_oracle(rows, ops, mask, (lh, lw), r_band, POINTS)
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale, err_msg=f"level {lvl}")
        highest = msda.msda_sep_sum(rows, *ops, mask, (lh, lw), r_band, POINTS).numpy()
        assert np.abs(highest - got).max() > 0


@pytest.mark.parametrize("policy,raw,want", [
    (None, None, "highest"), ("float32", None, "highest"), ("fp32", None, "highest"),
    ("mixed", None, "default"), ("bfloat16", None, "default"), ("bf16", None, "default"),
    ("mixed", "highest", "highest"), ("float32", "default", "default"),
    ("float32", " DEFAULT ", "default"),
])
def test_precision_follows_the_policy_as_the_jax_package(monkeypatch, policy, raw, want):
    """Unset, SPOTTER_TPU_MSDA_PRECISION follows SPOTTER_TPU_DTYPE; a set
    value wins. The JAX package's `_mxu_precision` reads the same table."""
    for name, val in (("SPOTTER_TPU_DTYPE", policy), ("SPOTTER_TPU_MSDA_PRECISION", raw)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    monkeypatch.setattr(msda, "MSDA_PRECISION", raw)
    assert msda.msda_precision() == want
    jax_name = {jax.lax.Precision.HIGHEST: "highest", jax.lax.Precision.DEFAULT: "default"}
    assert jax_name[jmsda._mxu_precision()] == want


@pytest.mark.parametrize("backend,prep,wrapper,want", [
    ("auto", "xla", "msda_gather_sum", "default"),
    ("pallas", "kernel", "msda_loc_sum", "default"),
    ("auto", "fused", "msda_fused_sum", "default"),
    ("pallas_sep", "xla", "msda_sep_sum", "default"),
    ("xla", "xla", "msda_gather_sum", "highest"),
    ("xla", "fused", "msda_fused_sum", "highest"),
])
def test_each_backend_passes_the_forward_precision(monkeypatch, backend, prep, wrapper, want):
    """A tiny RT-DETR forward under SPOTTER_TPU_MSDA_PRECISION=default hands
    "default" to the kernel its backend and prep run, every layer; the
    explicit `xla` backend ignores the knob, as the JAX package's row
    gathers do."""
    from spotter_tpu_torch.models import registry

    monkeypatch.setattr(msda, "MSDA_PRECISION", "default")
    monkeypatch.setattr(msda, "MSDA_BACKEND", backend)
    monkeypatch.setattr(msda, "MSDA_PREP", prep)
    seen = []
    real = getattr(msda, wrapper)

    def spy(*args, **kwargs):
        seen.append(kwargs.get("precision", args[-1]))
        return real(*args, **kwargs)

    monkeypatch.setattr(msda, wrapper, spy)
    built = registry.build_detector("PekingU/rtdetr_v2_r101vd", tiny=True)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        built.module(x)
    layers = built.module.config.decoder_layers
    levels = built.module.config.num_feature_levels
    assert seen == [want] * (layers * (levels if backend == "pallas_sep" else 1))


def test_lane_gather_takes_no_precision(monkeypatch):
    """pallas_gather's kernel sums in the value's dtype with no precision,
    as its TPU kernel: its wrapper has no precision argument."""
    import inspect

    assert "precision" not in inspect.signature(msda.msda_hd_gather_sum).parameters
    assert "precision" in inspect.signature(msda.msda_sep_sum).parameters
    with pytest.raises(ValueError, match="precision must be one of"):
        msda.msda_gather_sum(torch.zeros(1, 4, 1, 4), torch.zeros(1, 1, 4, dtype=torch.int32),
                             torch.zeros(1, 1, 4), precision="bogus")



@pytest.mark.parametrize("prep", ["xla", "kernel", "fused"])
def test_tiny_rtdetr_with_default_precision_matches_jax(monkeypatch, prep):
    """A whole tiny RT-DETR (float32 policy) with SPOTTER_TPU_MSDA_PRECISION=
    default under each prep, against the JAX module (whose CPU path runs
    fp32): only the decoder's sampling rounds, weights and values to bf16
    (2**-8 relative a sampled value), so the encoder's query selection is
    the same and the outputs stay within the "mixed" bounds of
    tests/test_torch_precision_models.py: logits 1 % of the largest, boxes
    3e-3 (measured below a third of each). `kernel` runs `xla`'s terms and
    agrees with it to fp32 summation (1e-5); `fused` also rounds its
    prologue's projections (row 3's one pass), so it only shares the bounds."""
    import dataclasses

    from spotter_tpu.models import zoo as jzoo
    from spotter_tpu.models.rtdetr import RTDetrDetector as JRTDetr
    from spotter_tpu_torch.convert.from_jax import load_from_jax
    from spotter_tpu_torch.models import zoo as tzoo
    from spotter_tpu_torch.models.rtdetr import RTDetrDetector
    from tests.torch_parity import random_flax_params

    monkeypatch.delenv("SPOTTER_TPU_DTYPE", raising=False)
    monkeypatch.setattr(msda, "MSDA_PRECISION", "default")
    jcfg, tcfg = jzoo.tiny_rtdetr_config(), tzoo.tiny_rtdetr_config()
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    params = random_flax_params(JRTDetr(jcfg), x[:1], seed=0)
    jout = jax.jit(JRTDetr(jcfg).apply)({"params": params}, x)
    model = load_from_jax(RTDetrDetector(tcfg).eval(), params)
    outs = {}
    for p in ("xla", prep):
        monkeypatch.setattr(msda, "MSDA_PREP", p)
        with torch.inference_mode():
            outs[p] = model(torch.from_numpy(x))
    out = outs[prep]
    logits = np.asarray(jout["logits"])
    assert np.abs(out["logits"].numpy() - logits).max() <= 1e-2 * np.abs(logits).max()
    assert np.abs(out["pred_boxes"].numpy() - np.asarray(jout["pred_boxes"])).max() <= 3e-3
    np.testing.assert_array_equal(out["enc_topk_index"].numpy(),
                                  outs["xla"]["enc_topk_index"].numpy())
    if prep != "fused":
        for key in ("logits", "pred_boxes"):
            np.testing.assert_allclose(out[key].numpy(), outs["xla"][key].numpy(), rtol=0,
                                       atol=1e-5)
    monkeypatch.setattr(msda, "MSDA_PRECISION", "highest")
    with torch.inference_mode():
        highest = model(torch.from_numpy(x))
    assert not torch.equal(highest["logits"], out["logits"])  # the mode took effect
