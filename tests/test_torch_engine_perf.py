"""The port's device-efficiency ledger (`spotter_tpu_torch/obs/perf.py`) and
the kernels' FLOPs notes, held against the JAX package.

- `PerfLedger` and `CompileLedger` snapshots equal the JAX package's
  `spotter_tpu.obs.perf` snapshots under the same record sequence and a
  fake clock: with traffic, with none (every gauge present and NaN-free),
  and the recompile-storm warning's text.
- `HbmSampler` on a CPU device keeps a zeroed row, never NaN.
- Each hand-written kernel's wrapper notes the FLOPs the JAX package notes
  for its Pallas counterpart on the same shapes (taken from a trace of the
  JAX function, `jax.eval_shape`, so no kernel runs), and the attention and
  int8 GEMM wrappers the standard counts.
"""

import json
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotter_tpu.obs import perf as jperf
from spotter_tpu.ops import msda as jmsda
from spotter_tpu.ops import openvocab as jopenvocab
from spotter_tpu_torch.obs import perf as tperf
from spotter_tpu_torch.ops import attention, int8, msda, openvocab


class FakeClock:
    """Stands in for the `time` module of both ledgers."""

    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        return 1.7e9 + self.now


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(jperf, "time", fake)
    monkeypatch.setattr(tperf, "time", fake)
    monkeypatch.setenv("SPOTTER_TPU_PEAK_TFLOPS", "123.5")
    return fake


def drive(mod, clock) -> dict:
    """One record sequence through a ledger of `mod`; its debug snapshot."""
    ledger = mod.PerfLedger(window_s=30.0, enabled=True, top_k=3)
    ledger.set_device_info("some device", 1)
    for i, (dev_s, batch, flops) in enumerate(
            [(0.012, 8, 3.5e12), (0.004, 1, 4.4e11), (0.02, 8, 3.5e12), (0.001, 2, None)]):
        clock.now += 0.25
        if ledger.compiles.record_dispatch(f"u8:{batch}x640x640"):
            ledger.compiles.record_compile(f"u8:{batch}x640x640", 0.5 + i,
                                           "warmup" if i < 2 else "traffic")
        ledger.record_dispatch(device_s=dev_s, batch=batch, padded_px=batch * 640 * 640,
                               valid_px=(batch - 1) * 640 * 640 + 100, flops=flops,
                               trace_id=f"t{i}", shape=f"u8:{batch}x640x640")
        ledger.slo.good(batch)
    ledger.slo.bad(2)
    ledger.set_hbm("0", {"bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 80})
    ledger.ensure_hbm_device("1")
    assert ledger.flops_for("k", lambda: 2.0e9) == ledger.flops_for("k") == 2.0e9
    assert ledger.flops_for("bad", lambda: float("nan")) is None
    clock.now += 1.0
    return ledger.debug_snapshot()


def test_perf_ledger_snapshot_equals_the_jax_ledgers(clock):
    want = drive(jperf, clock)
    clock.now = 1000.0
    got = drive(tperf, clock)
    assert got == want
    assert got["compiles_total"] == 3 and got["program_cache_hits_total"] == 1
    assert got["peak_tflops"] == 123.5 and got["mfu_pct"] > 0


def test_zero_traffic_snapshots_are_equal_and_nan_free(clock, monkeypatch):
    monkeypatch.delenv("SPOTTER_TPU_PEAK_TFLOPS")
    want = jperf.PerfLedger(enabled=True).snapshot()
    got = tperf.PerfLedger(enabled=True).snapshot()
    assert got == want
    text = json.dumps(got)
    assert "NaN" not in text and "Infinity" not in text
    assert got["mfu_pct"] == got["device_duty_cycle_pct"] == 0.0


def test_peak_table_knows_the_h100_and_the_override_wins(monkeypatch):
    monkeypatch.delenv("SPOTTER_TPU_PEAK_TFLOPS", raising=False)
    assert tperf.peak_tflops_for("NVIDIA H100 80GB HBM3") == 989.0
    assert tperf.peak_tflops_for("cpu") == jperf.peak_tflops_for("cpu")
    assert tperf.peak_tflops_for("some new card") is None
    monkeypatch.setenv("SPOTTER_TPU_PEAK_TFLOPS", "700")
    assert tperf.peak_tflops_for("NVIDIA H100 80GB HBM3") == 700.0


def test_compile_storm_warning_has_the_jax_text(clock, caplog):
    messages = []
    for mod in (jperf, tperf):
        caplog.clear()
        ledger = mod.CompileLedger(storm_threshold=2)
        with caplog.at_level(logging.WARNING):
            for i in range(4):
                clock.now += 1.0
                ledger.record_compile(f"u8:{i}x64x64", 0.1, "traffic")
        messages.append([r.getMessage() for r in caplog.records])
        clock.now = 1000.0
    assert messages[0] == messages[1] and len(messages[0]) == 1
    assert "recompile storm" in messages[1][0]


def test_combine_flops_follows_the_jax_rule():
    for counted, noted in [(None, None), (0, 5.0), (10.0, 4.0), (3.0, 4.0), (float("nan"), 2.0),
                           (5.0, None)]:
        assert tperf.combine_flops(counted, noted) == jperf.combine_flops(counted, noted)


def test_hbm_sampler_on_the_cpu_keeps_a_zeroed_row():
    ledger = tperf.PerfLedger(enabled=True)
    assert tperf.device_memory_stats(torch.device("cpu")) is None
    assert tperf.sample_hbm_once(lambda: [torch.device("cpu")], ledger) == 0
    snap = ledger.snapshot()
    assert snap["hbm_per_device"] == {"0": {"bytes_in_use": 0, "peak_bytes": 0,
                                            "limit_bytes": 0}}
    assert all(math.isfinite(snap[k]) for k in ("hbm_bytes_in_use", "hbm_limit_bytes"))
    sampler = tperf.HbmSampler(lambda: [torch.device("cpu")], ledger, interval_s=0.01)
    assert sampler.start()
    sampler.stop()


# --- the kernels' FLOPs notes ---------------------------------------------------

SHAPES = ((8, 8), (4, 4), (2, 2))  # S = 84; every level divides the JAX source tile
B, Q, H, HD, P = 2, 70, 2, 8, 2


def _msda_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in SHAPES)
    lp = len(SHAPES) * P
    value = rng.standard_normal((B, s, H, HD)).astype(np.float32)
    loc = rng.uniform(0.02, 0.98, (B, Q, H, lp, 2)).astype(np.float32)
    attn = rng.uniform(0.0, 1.0, (B, Q, H, lp)).astype(np.float32)
    return value, loc, attn


def _jax_note(fn, *args) -> dict:
    with jperf.collect_kernel_flops() as noted:
        jax.eval_shape(fn, *args)
    return noted


def _port_note(fn, *args) -> dict:
    with tperf.collect_kernel_flops() as noted:
        fn(*args)
    return noted


@pytest.mark.parametrize("prep,jax_name,port_name", [
    ("xla", "msda_onehot_merged", "msda_gather_sum"),
    ("kernel", "msda_onehot_merged_loc", "msda_loc_sum"),
])
@pytest.mark.parametrize("method", ["default", "discrete"])
def test_msda_notes_equal_the_jax_notes(monkeypatch, prep, jax_name, port_name, method):
    monkeypatch.setattr(jmsda, "MSDA_PREP", prep)
    monkeypatch.setattr(msda, "MSDA_PREP", prep)
    monkeypatch.setattr(msda, "MSDA_BACKEND", "auto")
    value, loc, attn = _msda_inputs()
    want = _jax_note(lambda v, l, a: jmsda.deformable_sampling(
        v, l, a, SHAPES, P, method=method, backend="pallas", interpret=True), value, loc, attn)
    got = _port_note(lambda v, l, a: msda.deformable_sampling(
        v, l, a, SHAPES, P, method=method), *map(torch.from_numpy, (value, loc, attn)))
    assert want[jax_name] > 0
    assert got[port_name] == want[jax_name] == got["__total__"]


def test_sep_notes_equal_the_jax_notes(monkeypatch):
    monkeypatch.setattr(msda, "MSDA_BACKEND", "pallas_sep")
    value, loc, attn = _msda_inputs(1)
    want = _jax_note(lambda v, l, a: jmsda.deformable_sampling(
        v, l, a, SHAPES, P, backend="pallas_sep", interpret=True), value, loc, attn)
    got = _port_note(lambda v, l, a: msda.deformable_sampling(v, l, a, SHAPES, P),
                     *map(torch.from_numpy, (value, loc, attn)))
    assert got["msda_sep_sum"] == want["msda_sep_band"] > 0


def test_fused_notes_equal_the_jax_notes(monkeypatch):
    monkeypatch.setattr(msda, "MSDA_BACKEND", "auto")
    rng = np.random.default_rng(2)
    value, _, _ = _msda_inputs(2)
    d, lp = 16, len(SHAPES) * P
    hs = rng.standard_normal((B, Q, d)).astype(np.float32)
    ref = rng.uniform(0.2, 0.8, (B, Q, 4)).astype(np.float32)
    w_off = rng.standard_normal((d, H * lp * 2)).astype(np.float32) * 0.1
    b_off = rng.standard_normal((H * lp * 2,)).astype(np.float32) * 0.1
    w_att = rng.standard_normal((d, H * lp)).astype(np.float32)
    b_att = rng.standard_normal((H * lp,)).astype(np.float32)
    args = (value, hs, ref, w_off, b_off, w_att, b_att)
    want = _jax_note(lambda *a: jmsda.deformable_sampling_fused(
        *a, SHAPES, P, backend="pallas", interpret=True), *args)
    got = _port_note(lambda *a: msda.deformable_sampling_fused(*a, SHAPES, P),
                     *map(torch.from_numpy, args))
    assert got["msda_fused_sum"] == want["msda_fused"] > 0


@pytest.mark.parametrize("q", [3, 130])
def test_class_logit_note_equals_the_jax_note(q):
    rng = np.random.default_rng(q)
    b, p, dt = 2, 150, 16
    img = rng.standard_normal((b, p, dt)).astype(np.float32)
    queries = rng.standard_normal((q, dt)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    shift = rng.standard_normal((b, p)).astype(np.float32)
    scale = rng.standard_normal((b, p)).astype(np.float32)
    want = _jax_note(lambda *a: jopenvocab.fused_class_logits(*a, None, interpret=True),
                     img, queries, shift, scale)
    got = _port_note(openvocab.owl_class_logits, *map(torch.from_numpy,
                                                       (img, queries, shift, scale)))
    assert got["owl_class_logits"] == want["owl_class_logits"] > 0


def test_attention_and_int8_gemm_note_the_standard_counts():
    """The JAX side's attention and int8 products are XLA dots, which XLA
    counts as 2·M·N·K each; the port's wrappers note the same."""
    b, s, h, hd = 1, 40, 2, 64
    q = torch.randn(b, s, h, hd)
    noted = _port_note(attention.flash_attn_fp32, q, q, q)
    assert noted["flash_attn_fp32"] == 4 * b * h * s * s * hd
    noted = _port_note(attention.flash_attn_bf16, *(q.to(torch.bfloat16),) * 3)
    assert noted["flash_attn_bf16"] == 4 * b * h * s * s * hd
    # XLA's own count for one of the two products the formula sums
    qk = jax.jit(lambda x, y: jnp.einsum("bqhd,bkhd->bhqk", x, y)).lower(
        *(jax.ShapeDtypeStruct((b, s, h, hd), jnp.float32),) * 2).cost_analysis()
    qk = qk[0] if isinstance(qk, (list, tuple)) else qk
    assert noted["flash_attn_bf16"] == 2 * qk["flops"]
    a = torch.randint(-127, 128, (3, 48, 32), dtype=torch.int8)
    bt = torch.randint(-127, 128, (24, 32), dtype=torch.int8)
    assert _port_note(int8.int8_gemm_kmajor, a, bt)["int8_gemm_kmajor"] == 2 * 3 * 48 * 24 * 32
    assert _port_note(int8.int8_gemm, a[0], bt.T.contiguous())["int8_gemm"] == 2 * 48 * 24 * 32
